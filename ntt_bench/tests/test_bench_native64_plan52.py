"""The cell `native64-plan52-n16384-b256` on the CPU at small n: the entry's
sound run is correct and its float64 control and planted faults (a flipped
output word, a wrong digit of the 50-bit lift) are not; the entry is the
native64 entry with Plan52 in Plan32's place; the two readers of the Plan52
lift's spans sum the spans under the counted roots, nested ones once, and
read nothing from a port that records no such spans."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from concrete_ntt_tpu_torch.ops import crt
from concrete_ntt_tpu_torch.tables import PRIMES52
from concrete_ntt_tpu_torch.utils import profiling
from ntt_bench import harness, spec
from ntt_bench.control import control
from ntt_bench.tests.test_bench_harness import ROOT, SEED, _altered, _half_batch, run
from ntt_bench.tests.test_bench_native128 import LiftBuffer
from ntt_bench.tests.test_bench_spans import Buffer

CELL = "native64-plan52-n16384-b256"
READERS = {"plan52_lift_digits_device_ms": "lift_digits",
           "plan52_lift_limbs_device_ms": "lift_limbs"}


def small(n: int = 2048, **traffic) -> spec.Spec:
    """The cell at a size a test run holds: n = 2048 (the K7 route's
    smallest n) or 64 (each channel's plan), over the configured primes."""
    cell = spec.load(ROOT, CELL)
    base = {"batch": 2, "pool": 3, "check_calls": 3, "trace_calls": 2}
    return dataclasses.replace(cell, config={**cell.config, "n": n},
                               traffic={**cell.traffic, **base, **traffic})


def test_the_cell_is_native64_plan52_at_2_14():
    cell = spec.load(ROOT, CELL)
    assert (cell.config["n"], cell.config["width"]) == (1 << 14, 64)
    assert cell.config["primes"] == list(PRIMES52[:3])
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert {k: cell.traffic[k] for k in ("batch", "pool", "check_calls", "trace_calls")} == {
        "batch": 256, "pool": 4, "check_calls": 2, "trace_calls": 8}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    entry = spec.load_module("entries", cell.config["entry"])
    assert entry.floor_bytes(256, 1 << 14) == 24 * 256 * (1 << 14)


def test_the_entry_is_the_native64_entry_on_plan52():
    """Only the set-up is its own: the pool, the call order, the check and
    the control are the native64 entry's, and a seed draws the same words."""
    cell = small()
    mine = spec.load_module("entries", cell.config["entry"])
    assert [k for k in vars(mine.Workload) if not k.startswith("__")] == []
    assert mine.Workload.__mro__[1].__module__ == "ntt_bench_entries_native64_polymul"
    work = mine.Workload(cell.config, cell.traffic, SEED, "cpu")
    assert type(work.plan).__name__ == "Plan52" and work.port_call == work.plan.negacyclic_polymul
    base = spec.load_module("entries", "native64_polymul")
    plan32 = {**spec.load(ROOT, "native64-n16384-b256").config, "n": 2048}
    assert torch.equal(work.words, base.Workload(plan32, cell.traffic, SEED, "cpu").words)
    with pytest.raises(RuntimeError, match="configured primes"):
        mine.Workload({**cell.config, "primes": plan32["primes"]}, cell.traffic, SEED, "cpu")


@pytest.mark.parametrize("n", [64, 2048])
def test_a_sound_run_is_correct(n):
    r = run(small(n))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"products_per_s", "call_ms_p95", "setup_s"}
    assert set(r["checks"]) == {"mismatched_coeffs", "unchecked_calls", "failed_calls"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


def test_the_check_compares_every_coefficient_of_the_sampled_calls():
    cell = small()
    entry = spec.load_module("entries", cell.config["entry"])
    work = entry.Workload(cell.config, cell.traffic, SEED, "cpu")
    records = [work.call(i) for i in (0, 4, 5)]
    assert work.check(records) == {"compared": 3 * 2 * 2048, "unchecked": 0,
                                   "checks": {"mismatched_coeffs": 0}}
    assert work.check(records + [(6, ("not", "a", "product"))])["unchecked"] == 1


def test_a_traced_run_reads_nothing_of_the_lift_on_the_cpu():
    """No device here: the span readers return nothing and are left out."""
    r = run(small(), traced=True)
    assert r["correct"] and r["metrics"] == {} and "breakdown" in r


@pytest.mark.parametrize("patch", [control, _altered, _half_batch],
                         ids=["control", "altered", "half_batch"])
def test_the_control_and_planted_faults_fail(patch):
    r = run(small(), patch=patch)
    assert not r["correct"] and r["checks"]["mismatched_coeffs"]["value"] > 0


def test_a_wrong_lift_digit_is_caught(monkeypatch):
    """v1 of the first coefficient with its low bit flipped inside
    `rec_from3_p50_u64`, under the timed path: the check sees it."""
    p1 = PRIMES52[1]
    mul = crt._mul_mod64

    def wrong(b_pair, a_const, p):
        lo, hi = mul(b_pair, a_const, p)
        if p == p1 and lo.dim() == 2:  # the digit v1 of [B, n] carriers
            lo = lo.clone()
            lo.view(-1)[0] ^= 1
        return lo, hi
    monkeypatch.setattr(crt, "_mul_mod64", wrong)
    r = run(small())
    assert not r["correct"] and r["checks"]["mismatched_coeffs"]["value"] > 0


# -- the readers of the lift's own spans -------------------------------------


@pytest.fixture
def buffer(monkeypatch):
    buf = LiftBuffer()
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [dict(r) for r in buf.records])
    return buf


def _two_counted(buf, nested=False):
    buf.call(scale=100.0, launches=30, host=False)  # the first profiled call: left out
    buf.call(scale=1.0, launches=3, nested=nested)
    buf.call(scale=1.0, launches=3, nested=nested)
    return buf.window(calls=2)


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_each_lift_reader_gives_its_per_call_value(buffer, name, nested):
    win = _two_counted(buffer, nested)
    assert spec.load_module("metrics", name).read(win) == LiftBuffer.LIFT[READERS[name]]
    lift = spec.load_module("metrics", "lift_device_ms").read(win)
    assert lift == Buffer.BASE["lift"] and sum(LiftBuffer.LIFT.values()) <= lift


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_lift_reader_reads_nothing_without_its_spans(buffer, monkeypatch, name):
    reader = spec.load_module("metrics", name)
    win = _two_counted(buffer)
    assert reader.read(harness.Window(setup_s=0.0)) is None  # no profile
    plain = Buffer()  # a port whose lift records no child spans (the parent commit's Plan52)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [dict(r) for r in plain.records])
    plain.call(scale=100.0, launches=30, host=False)
    plain.call(scale=1.0, launches=3)
    plain.call(scale=1.0, launches=3)
    assert reader.read(plain.window(calls=2)) is None
    monkeypatch.delattr(profiling, "recorded_spans")  # a port without spans
    assert reader.read(win) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_missing_device_time_reads_nothing(buffer, name):
    win = _two_counted(buffer)
    for r in buffer.records:
        r["device_ms"] = None
    assert spec.load_module("metrics", name).read(win) is None
