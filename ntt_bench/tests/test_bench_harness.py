"""The harness on the CPU at small sizes: a sound run is correct; the control
and each fault a cell can have, planted under the timed path, make `correct`
false; the floors and the seeded inputs are pinned; the command refuses to
run without a card or without the program, and loads no JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ntt_bench import harness, spec
from ntt_bench.control import control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 33 + 17  # wider than 32 bits, as the driver's seeds are


def small(workload: str, **traffic) -> spec.Spec:
    """The cell at a size a test run holds: n = 2048, a few key rows."""
    cell = spec.load(ROOT, workload)
    config = {**cell.config, "n": 2048}
    if "lwe_dimension" in config:
        config["lwe_dimension"] = 5
    base = {"batch": 2, "pool": 3, "check_calls": 3, "trace_calls": 2}
    return dataclasses.replace(cell, config=config, traffic={**cell.traffic, **base, **traffic})


def run(cell, seconds=0.2, traced=False, **kw) -> dict:
    return harness.run_cell(cell, SEED, seconds, traced, "cpu", time.perf_counter(), **kw)


NATIVE, PBS = "native64-n16384-b256", "pbs-n2048-b4096"


@pytest.mark.parametrize("workload", [NATIVE, PBS])
def test_a_sound_run_is_correct(workload):
    r = run(small(workload))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"products_per_s", "call_ms_p95", "setup_s"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", [NATIVE, PBS])
def test_a_traced_run_reads_the_host_layers(workload):
    r = run(small(workload), traced=True)
    assert r["correct"]
    # no device here: the device readers return nothing and are left out
    assert set(r["metrics"]) == {"host_ms_per_call", "aten_ops_per_call"}
    assert r["metrics"]["aten_ops_per_call"]["value"] > 10
    assert list(r)[-1] == "checks" and "breakdown" in r


@pytest.mark.parametrize("workload", [NATIVE, PBS])
def test_the_control_fails(workload):
    r = run(small(workload), patch=control)
    assert not r["correct"] and r["checks"]["mismatched_coeffs"]["value"] > 0
    if workload == PBS:
        assert r["checks"]["mismatched_final_coeffs"]["value"] > 0


def _altered(work):
    """An answer altered where it is produced: one bit of one coefficient."""
    call = work.port_call

    def broken(*args):
        out = call(*args)
        first = out[0] if isinstance(out, tuple) else out
        first.view(torch.int32).view(-1)[0] ^= 1
        return out
    work.port_call = broken


def _half_batch(work):
    """Half of the batch left out: the second half never computed."""
    call = work.port_call

    def broken(*args):
        out = call(*args)
        if isinstance(out, tuple):  # products: the second half never written
            for t in out:
                t[t.shape[0] // 2:] = 0
        else:  # accumulators: the second half left as it came in
            out[out.shape[0] // 2:] = args[-1][out.shape[0] // 2:]
        return out
    work.port_call = broken


def _state_unchanged(work):
    """The step returns the accumulator it was given."""
    work.port_call = lambda digits, row, acc: acc


FAULTS = [(NATIVE, _altered), (NATIVE, _half_batch),
          (PBS, _altered), (PBS, _half_batch), (PBS, _state_unchanged)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_fault_under_the_timed_path_is_caught(workload, fault):
    r = run(small(workload), patch=fault)
    assert not r["correct"] and r["checks"]["mismatched_coeffs"]["value"] > 0


def test_one_unsampled_pbs_step_altered_is_caught_from_the_first_accumulator():
    """Only the last call is sampled; a middle step's answer is altered, and
    every later step computes soundly from it: the per-step check passes,
    the check of the last accumulator from the first one fails."""
    def one_step(work):
        call, seen = work.port_call, []

        def broken(digits, row, acc):
            out = call(digits, row, acc)
            seen.append(row)
            if len(seen) == 4:  # two warm-up calls, then the window's second step
                out.view(torch.int32).view(-1)[5] ^= 1
            return out
        work.port_call = broken
    r = run(small(PBS, check_calls=0), seconds=0.5, patch=one_step)
    assert r["attempted"] >= 3 and not r["correct"]
    assert r["checks"]["mismatched_coeffs"]["value"] == 0
    assert r["checks"]["mismatched_final_coeffs"]["value"] > 0


def test_a_call_that_raises_fails_the_run():
    def raising(work):
        def broken(*args):
            raise RuntimeError("planted")
        work.port_call = broken
        work.warm = lambda: None
    r = run(small(NATIVE), patch=raising)
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1


def test_floors_are_pinned():
    native = spec.load_module("entries", "native64_polymul")
    pbs = spec.load_module("entries", "pbs_external_product")
    assert native.floor_bytes(8, 16384) == 24 * 8 * 16384 == 3_145_728
    assert native.floor_bytes(256, 16384) == 100_663_296
    assert pbs.floor_bytes(1, 2048) == 48 * 2048 + 32 * 2048 == 163_840
    assert pbs.floor_bytes(4096, 2048) == 48 * 4096 * 2048 + 32 * 2048 == 402_718_720


@pytest.mark.parametrize("workload", [NATIVE, PBS])
def test_seeded_inputs_repeat(workload):
    cell = small(workload)
    entry = spec.load_module("entries", cell.config["entry"])
    a, b, c = (entry.Workload(cell.config, cell.traffic, s, "cpu") for s in (SEED, SEED, SEED + 1))
    fields = ["words"] if workload == NATIVE else ["digits", "acc", "key"]
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert not torch.equal(getattr(a, f), getattr(c, f))
    if workload == PBS:
        for x, y, z in zip(a.key_standard() + a.inputs()[1], b.key_standard() + b.inputs()[1],
                           c.key_standard() + c.inputs()[1]):
            assert torch.equal(x, y) and not torch.equal(x, z)
        assert torch.equal(a.inputs()[0], b.inputs()[0])


def test_reservoir_is_drawn_from_the_seed():
    picks = []
    for _ in range(2):
        r = harness.Reservoir(3, 5)
        for i in range(100):
            r.offer(i)
        picks.append(r.items)
    assert picks[0] == picks[1] and len(set(picks[0])) == 3


def _cli(cwd, *args, env=None):
    return subprocess.run([sys.executable, "ntt_bench/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_the_command_needs_a_card():
    out = _cli(ROOT, "--workload", NATIVE, "--seed", str(SEED), "--seconds", "1", "--trace", "0",
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and ntt_bench/, the
    command exits non-zero and prints no result."""
    shutil.copytree(os.path.join(ROOT, "ntt_bench"), tmp_path / "ntt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, "--workload", NATIVE, "--seed", "1", "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "concrete_ntt_tpu_torch" in out.stderr


def test_nothing_the_command_imports_is_jax():
    """The modules run.py loads, the entries, the readers and the program:
    no top-level module named jax, jaxlib, flax or concrete_ntt_tpu (the
    part before the first dot compared whole)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import runpy, importlib\n"
        "from ntt_bench import harness, spec, trace\n"
        "importlib.import_module('concrete_ntt_tpu_torch')\n"
        f"bench = json.load(open({os.path.join(ROOT, 'BENCHMARK.json')!r}))\n"
        "for w in bench['workloads']:\n"
        "    cell = spec.load(" + repr(ROOT) + ", w['name'])\n"
        "    spec.load_module('entries', cell.config['entry'])\n"
        "    for m in cell.end_to_end + cell.per_layer:\n"
        "        spec.load_module('metrics', m['name'])\n"
        "import concrete_ntt_tpu_torch.native64, concrete_ntt_tpu_torch.prime64\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    found, tops = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "concrete_ntt_tpu_torch" in tops and not {"jax", "jaxlib", "flax", "concrete_ntt_tpu"} & set(tops)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "concrete_ntt_tpu_torchlike", sys)
    assert "concrete_ntt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "concrete_ntt_tpu.fake", sys)
    assert "concrete_ntt_tpu" in harness.forbidden_modules()
