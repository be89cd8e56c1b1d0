"""The cell `native128-n65536-b64` on the CPU at n = 64: the entry's sound run
is correct and its float64 control and planted faults are not; the u128
reference is the bigint oracle's wrapping product and agrees with the port's
plain path; the two readers of the lift's own spans sum the spans under the
counted roots, nested ones once, and read nothing from a port that records
no such spans."""

from __future__ import annotations

import dataclasses
import random

import pytest
import torch

from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping
from concrete_ntt_tpu_torch.tables import native_channel_primes
from concrete_ntt_tpu_torch.utils import profiling
from ntt_bench import harness, spec
from ntt_bench.control import control
from ntt_bench.reference import exact, float64_u128, products_u128
from ntt_bench.tests.test_bench_harness import ROOT, SEED, _altered, _half_batch, run
from ntt_bench.tests.test_bench_spans import Buffer

CELL = "native128-n65536-b64"
READERS = {"lift_digits_device_ms": "lift_digits", "lift_limbs_device_ms": "lift_limbs"}
MASK128 = (1 << 128) - 1


def small(n: int = 64, **traffic) -> spec.Spec:
    """The cell at a size a test run holds: n = 64 over the ten primes the
    port takes there (the 2^16 primes are another set)."""
    cell = spec.load(ROOT, CELL)
    config = {**cell.config, "n": n, "primes": list(native_channel_primes(10, n))}
    base = {"batch": 2, "pool": 3, "check_calls": 3, "trace_calls": 2}
    return dataclasses.replace(cell, config=config, traffic={**cell.traffic, **base, **traffic})


def test_the_cell_is_native128_plan32_at_2_16():
    cell = spec.load(ROOT, CELL)
    assert (cell.config["n"], cell.config["width"]) == (1 << 16, 128)
    assert cell.config["primes"] == list(native_channel_primes(10, 1 << 16))
    assert {k: cell.traffic[k] for k in ("batch", "pool", "check_calls", "trace_calls")} == {
        "batch": 64, "pool": 4, "check_calls": 2, "trace_calls": 4}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    entry = spec.load_module("entries", cell.config["entry"])
    assert entry.floor_bytes(64, 1 << 16) == 48 * 64 * (1 << 16)


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
    assert work.check(records) == {"compared": 3 * 2 * 64, "unchecked": 0,
                                   "checks": {"mismatched_coeffs": 0}}
    assert work.check(records + [(6, ("not", "a", "product", "!"))])["unchecked"] == 1


def test_a_traced_run_reads_nothing_of_the_lift_on_the_cpu():
    """No device here: the span readers return nothing and are left out."""
    r = run(small(), traced=True)
    assert r["correct"] and r["metrics"] == {} and "breakdown" in r


@pytest.mark.parametrize("patch", [control, _altered, _half_batch],
                         ids=["control", "altered", "half_batch"])
def test_the_control_and_planted_faults_fail(patch):
    r = run(small(), patch=patch)
    assert not r["correct"] and r["checks"]["mismatched_coeffs"]["value"] > 0


def _words(rows) -> list:
    return [torch.tensor([[(v >> (32 * j)) & 0xFFFFFFFF for v in r] for r in rows], dtype=torch.int64)
            for j in range(4)]


def _ints(words) -> list:
    return [[sum(int(w[r, k]) << (32 * j) for j, w in enumerate(words)) for k in range(words[0].shape[1])]
            for r in range(words[0].shape[0])]


@pytest.mark.parametrize("n", [2, 16, 64])
def test_polymul_u128_is_the_oracles_wrapping_product(n):
    rng = random.Random(128 + n)
    a = [[rng.getrandbits(128) for _ in range(n)] for _ in range(3)]
    b = [[rng.getrandbits(128) for _ in range(n)] for _ in range(3)]
    a[0] = b[0] = [MASK128] * n  # the largest coefficients: the widest sums
    a[1] = [0 if k % 2 else MASK128 for k in range(n)]
    got = _ints(products_u128.polymul_u128(_words(a), _words(b)))
    assert got == [negacyclic_convolution_wrapping(x, y, 128) for x, y in zip(a, b)]


def test_polymul_u128_agrees_with_the_ports_plain_path():
    from concrete_ntt_tpu_torch import native128

    gen = torch.Generator().manual_seed(11)
    for n in (64, 2048):
        plan = native128.Plan32.try_new(n, device="cpu")
        w = torch.randint(-2 ** 31, 2 ** 31, (8, 2, n), dtype=torch.int32, generator=gen).view(torch.uint32)
        got = plan.negacyclic_polymul(tuple(w[:4]), tuple(w[4:]))
        want = products_u128.polymul_u128([exact.u32_to_i64(x) for x in w[:4]],
                                          [exact.u32_to_i64(x) for x in w[4:]])
        assert all(torch.equal(exact.u32_to_i64(g), x) for g, x in zip(got, want, strict=True))


def test_the_float64_control_is_wrong_where_the_reference_is_right():
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 2 ** 32, (2, 4, 3, 256), generator=gen)
    ref = products_u128.polymul_u128(list(x[0]), list(x[1]))
    ctl = float64_u128.polymul_u128(list(x[0]), list(x[1]))
    assert all(0 <= int(c.min()) and int(c.max()) < 2 ** 32 for c in ctl)
    bad = torch.zeros_like(ref[0], dtype=torch.bool)
    for r, c in zip(ref, ctl):
        bad |= r != c
    assert int(bad.sum()) > 3 * 256 * 0.99


# -- the readers of the lift's own spans -------------------------------------


class LiftBuffer(Buffer):
    """`Buffer`'s calls with the u128 lift's two spans inside `ntt.lift`;
    with `nested`, a second digits span inside the first (a stage inside
    its own stage counts once, in the outer one)."""

    LIFT = {"lift_digits": 5.0, "lift_limbs": 2.5}

    def call(self, scale: float, launches: int, host: bool = True, nested: bool = False):
        super().call(scale, launches, host)
        lift = next(r for r in reversed(self.records) if r["stage"] == "lift")
        root = lift["root"]
        for stage, ms in self.LIFT.items():
            i = self._rec(f"ntt.{stage}", stage, lift["index"], root, ms * scale)
            if nested and stage == "lift_digits":
                self._rec("ntt.lift_digits", stage, i, root, 1.0 * scale)


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
    value = spec.load_module("metrics", name).read(win)
    assert value == LiftBuffer.LIFT[READERS[name]]
    # children of `ntt.lift`: the stage reader of the lift leaves them out, and their sum fits in it
    lift = spec.load_module("metrics", "lift_device_ms").read(win)
    assert lift == Buffer.BASE["lift"] and sum(LiftBuffer.LIFT.values()) <= lift


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_lift_reader_reads_nothing_without_its_spans(buffer, monkeypatch, name):
    reader = spec.load_module("metrics", name)
    win = _two_counted(buffer)
    assert reader.read(harness.Window(setup_s=0.0)) is None  # no profile
    plain = Buffer()  # a port whose lift records no child spans (the parent commit's)
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
