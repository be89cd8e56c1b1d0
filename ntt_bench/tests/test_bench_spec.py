"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and metric loads, names keep to the contract's characters, and a new cell
is found by name from files added beside the existing ones."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ntt_bench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "ntt_bench/run.py"] and b["paths"] == ["ntt_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in b[key]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in b["configs"] + b["workloads"]] + [c["source"] for c in b["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(b)) < 64 * 1024


def test_bounds_and_metric_roles():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert {"products_per_s", "call_ms_p95", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads(workload):
    cell = spec.load(ROOT, workload)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"products_per_s", "call_ms_p95", "setup_s"}
    assert cell.per_layer
    entry = spec.load_module("entries", cell.config["entry"])
    assert hasattr(entry, "Workload") and hasattr(entry, "floor_bytes")
    for key in ("batch", "pool", "check_calls", "trace_calls"):
        assert int(cell.traffic[key]) >= 1
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]])
def test_every_config_loads(config):
    entry = next(c for c in bench()["configs"] if c["name"] == config)
    assert entry["file"].startswith("ntt_bench/configs/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["assumed"] and cfg["guarantee"]


def test_kernel_names_are_the_ports_globals():
    names = spec.kernel_names()
    src = os.path.join(ROOT, "concrete_ntt_tpu_torch", "csrc")
    found = set()
    for fname in os.listdir(src):
        with open(os.path.join(src, fname)) as f:
            text = f.read()
        for part in text.split("__global__")[1:]:
            head = part.split("{")[0]
            while "__launch_bounds__" in head:  # drop it with its nested parentheses
                start = head.index("__launch_bounds__")
                depth, k = 0, head.index("(", start)
                while True:
                    depth += {"(": 1, ")": -1}.get(head[k], 0)
                    k += 1
                    if depth == 0:
                        break
                head = head[:start] + head[k:]
            found.add(re.search(r"([A-Za-z_]\w*)\s*\(", head).group(1))
    assert names == found


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell added as files (a traffic mix, a configuration) and entries in
    BENCHMARK.json, with no existing file of ntt_bench/ edited, loads and
    runs on the CPU at a small size."""
    shutil.copytree(os.path.join(ROOT, "ntt_bench"), tmp_path / "ntt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: (tmp_path / "ntt_bench" / p).read_bytes()
              for p in ("spec.py", "harness.py", "run.py")}
    with open(os.path.join(ROOT, "ntt_bench", "configs", "native64_plan32_n16384.json")) as f:
        cfg = json.load(f)
    cfg.update(name="native64_plan32_n2048", n=2048)
    (tmp_path / "ntt_bench" / "configs" / "native64_plan32_n2048.json").write_text(json.dumps(cfg))
    (tmp_path / "ntt_bench" / "traffic" / "closed-b2.json").write_text(json.dumps(
        {"loop": "closed", "callers": 1, "batch": 2, "pool": 2, "check_calls": 2, "trace_calls": 2}))
    b = bench()
    b["configs"].append({"name": cfg["name"], "source": cfg["source"], "reduced": [],
                         "file": "ntt_bench/configs/native64_plan32_n2048.json", "why": "test"})
    b["workloads"].append({"name": "native64-n2048-b2", "config": cfg["name"],
                           "traffic": "closed-b2", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "from ntt_bench import harness, spec\n"
        f"assert spec.BENCH_DIR == {str(tmp_path / 'ntt_bench')!r}\n"
        f"cell = spec.load({str(tmp_path)!r}, 'native64-n2048-b2')\n"
        "r = harness.run_cell(cell, 2**33 + 1, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(r))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"products_per_s", "call_ms_p95", "setup_s"}
    assert before == {p: (tmp_path / "ntt_bench" / p).read_bytes() for p in before}
