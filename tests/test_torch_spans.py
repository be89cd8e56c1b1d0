"""The port's spans (`utils/profiling.span`, `root_span`, `recorded_spans`).

Outside a profiler session a span is one shared object that does nothing: no
record, no CUDA event, no profiler call, no allocation. Inside one, the
plans' calls record their stage trees (marshal, transform, pointwise, lift;
inside native128's and native64 Plan52's lifts their Garner digits and their
limb arithmetic) in the order the work runs, with parents and roots, each
name on the profiler's timeline, the same outputs as with tracing off, a bounded buffer, and each
top-level call's kernel launches from the registered counters. The card tests (marked `cuda`) read each stage's device time.

The file imports only the port (no JAX), so its card tests run on a GPU
machine without JAX:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import importlib
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from concrete_ntt_tpu_torch import native64, native128, prime64
from concrete_ntt_tpu_torch.ops import (
    butterfly32_cuda, crt_cuda, mxu32_cuda, mxu64_cuda, pointwise_cuda)
from concrete_ntt_tpu_torch.tables import GOLDILOCKS
from concrete_ntt_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _u32(seed: int, shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32))


def _native(n: int, device="cpu"):
    """A native64 Plan32 polymul of B = 2 planar operands."""
    plan = native64.Plan32.try_new(n, device=device)
    lhs = tuple(_u32(1 + i, (2, n)).to(device) for i in range(2))
    rhs = tuple(_u32(3 + i, (2, n)).to(device) for i in range(2))
    return lambda: plan.negacyclic_polymul(lhs, rhs)


def _native128(n: int, device="cpu"):
    """A native128 Plan32 polymul of B = 2 planar u128 operands (the u128
    lift, `ops/crt.py::rec_u128_from10`, with its two stage spans)."""
    plan = native128.Plan32.try_new(n, device=device)
    lhs = tuple(_u32(7 + i, (2, n)).to(device) for i in range(4))
    rhs = tuple(_u32(11 + i, (2, n)).to(device) for i in range(4))
    return lambda: plan.negacyclic_polymul(lhs, rhs)


def _plan52(n: int, device="cpu", inv: bool = False):
    """A native64 Plan52 polymul of B = 2 planar operands (K7a x2, K7d and
    the 50-bit Garner lift, `ops/crt.py::rec_from3_p50_u64`, with its two
    stage spans); with `inv`, the plan's inverse of their forward (made
    before the call)."""
    plan = native64.Plan52.try_new(n, device=device)
    lhs = tuple(_u32(15 + i, (2, n)).to(device) for i in range(2))
    rhs = tuple(_u32(17 + i, (2, n)).to(device) for i in range(2))
    if inv:
        ntt = plan.fwd(lhs)
        return lambda: plan.inv(ntt)
    return lambda: plan.negacyclic_polymul(lhs, rhs)


def _below_goldilocks(seed: int, shape) -> torch.Tensor:
    """u64 limb pairs [..., 2] of values below 2^64 - 2^32 + 1."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    hi = rng.integers(0, (1 << 32) - 1, shape, dtype=np.uint32)
    return torch.from_numpy(np.stack([lo, hi], axis=-1))


def _goldilocks(device="cpu"):
    """One external-product-like step: fwd, mul_accumulate, inv."""
    plan = prime64.Plan.new(2048, GOLDILOCKS, device=device)
    x = _below_goldilocks(5, (2, 2048)).to(device)
    key = plan.fwd(_below_goldilocks(6, (2048,)).to(device))

    def step():
        f = plan.fwd(x)
        return plan.inv(plan.mul_accumulate(f, f, key))
    return step


MARSHAL, TRANSFORM, POINTWISE, LIFT, LIFT_DIGITS, LIFT_LIMBS = (
    f"ntt.{s}" for s in profiling.STAGES)
_STAGED = [MARSHAL, TRANSFORM, MARSHAL]

# (depth, name) of each span in the order it opens
TREES = {
    "native64-k1": (lambda: _native(2048), [
        (0, "ntt.native64.negacyclic_polymul"), (1, MARSHAL), (1, TRANSFORM),
        (1, TRANSFORM), (1, POINTWISE), (1, TRANSFORM), (1, LIFT), (1, MARSHAL)]),
    "native64-per-channel": (lambda: _native(1024), [
        (0, "ntt.native64.negacyclic_polymul"), (1, MARSHAL),
        *[(1, TRANSFORM), *[(2, "ntt.prime32.fwd"), (3, MARSHAL), (3, TRANSFORM)] * 5] * 2,
        (1, POINTWISE), *[(2, "ntt.prime32.mul_assign_normalize"), (3, POINTWISE)] * 5,
        (1, TRANSFORM), *[(2, "ntt.prime32.inv"), (3, MARSHAL), (3, TRANSFORM)] * 5,
        (1, LIFT), (1, MARSHAL)]),
    "native128-k1": (lambda: _native128(2048), [
        (0, "ntt.native128.negacyclic_polymul"), (1, MARSHAL), (1, TRANSFORM),
        (1, TRANSFORM), (1, POINTWISE), (1, TRANSFORM),
        (1, LIFT), (2, LIFT_DIGITS), (2, LIFT_LIMBS), (1, MARSHAL)]),
    "native64-plan52-k7": (lambda: _plan52(2048), [
        (0, "ntt.native64.negacyclic_polymul"), (1, MARSHAL), (1, TRANSFORM),
        (1, TRANSFORM), (1, TRANSFORM), (1, LIFT), (2, LIFT_DIGITS), (2, LIFT_LIMBS),
        (1, MARSHAL)]),
    "native64-plan52-inv": (lambda: _plan52(2048, inv=True), [
        (0, "ntt.native64.inv"), (1, MARSHAL), (1, TRANSFORM), *[(2, TRANSFORM)] * 3,
        (1, LIFT), (2, LIFT_DIGITS), (2, LIFT_LIMBS), (1, MARSHAL)]),
    "prime64-goldilocks": (_goldilocks, [
        (0, "ntt.prime64.fwd"), *[(1, s) for s in _STAGED],
        (0, "ntt.prime64.mul_accumulate"), (1, MARSHAL), (1, POINTWISE), (1, MARSHAL),
        (0, "ntt.prime64.inv"), *[(1, s) for s in _STAGED]]),
}


def _traced(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    return out, prof, profiling.recorded_spans()


def _depths(records) -> list:
    depth = {}
    for r in records:
        depth[r["index"]] = 0 if r["parent"] is None else depth[r["parent"]] + 1
    return [(depth[r["index"]], r["name"]) for r in records]


def _flat(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


# -- tracing off ------------------------------------------------------------


def test_off_path_is_the_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the off path made a profiler or CUDA call")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span(MARSHAL, "marshal")
    assert first is profiling.span(LIFT, "lift") is profiling._OFF
    with first as sp:
        sp.io(torch.zeros(4))
    _native(2048)()
    _goldilocks()()
    assert profiling.recorded_spans() == []


def _peak_bytes(make, k: int = 1000) -> int:
    """tracemalloc's peak over k span sites whose span `make()` returns."""
    tracemalloc.start()
    try:
        for _ in range(k):
            with make() as sp:
                sp.io()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_off_path_allocates_nothing():
    """A site costs what a site given the shared object costs (the loop's
    own integers): `span` allocates nothing of its own."""
    _peak_bytes(lambda: profiling.span(TRANSFORM, "transform"), 10)
    bare = _peak_bytes(lambda: profiling._OFF)
    assert _peak_bytes(lambda: profiling.span(TRANSFORM, "transform")) <= bare


# -- tracing on (CPU) -------------------------------------------------------


@pytest.mark.parametrize("case", sorted(TREES))
def test_span_tree(case):
    make, want = TREES[case]
    _, prof, records = _traced(make())
    assert _depths(records) == want
    roots = [r for r in records if r["parent"] is None]
    for r in records:  # the spans of one top-level call share its index
        assert r["root"] in {x["index"] for x in roots}
        assert r["stage"] == (r["name"][4:] if r["name"][4:] in profiling.STAGES else None)
        # events only where CUDA is initialised (a card test may have run first)
        assert (r["device_ms"] is None) == (not torch.cuda.is_initialized())
    assert all(r["nbytes"] > 0 for r in records if r["stage"] is not None)
    names = {ev.name for ev in prof.events()}
    assert {r["name"] for r in records} <= names


@pytest.mark.parametrize("case", sorted(TREES))
def test_outputs_equal_with_tracing_on_and_off(case):
    run = TREES[case][0]()
    off = _flat(run())
    on, _, records = _traced(run)
    assert records
    assert all(torch.equal(a, b) for a, b in zip(_flat(on), off, strict=True))


def test_nbytes_are_the_stages_logical_bytes():
    _, _, records = _traced(_native(2048))
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r["nbytes"])
    b, n, k = 2, 2048, 5
    assert by_name[POINTWISE] == [3 * k * b * n * 4]            # fl, fr in; product out
    assert by_name[LIFT] == [k * b * n * 4 + 2 * b * n * 4]     # residues in; (lo, hi) out
    assert by_name[TRANSFORM] == [2 * b * n * 4 + k * b * n * 4] * 2 + [2 * k * b * n * 4]


def test_u128_lift_spans_hold_their_logical_bytes():
    """Inside `ntt.lift`, the digits span counts the ten int64 residue
    carriers in, the five pair digits (limb pairs) and the bool sign out;
    the limbs span the digits and sign in, the four int64 limbs out."""
    _, _, records = _traced(_native128(64))
    lift, digits, limbs = (next(r for r in records if r["name"] == name)
                           for name in (LIFT, LIFT_DIGITS, LIFT_LIMBS))
    assert digits["parent"] == limbs["parent"] == lift["index"]
    assert (digits["stage"], limbs["stage"]) == ("lift_digits", "lift_limbs")
    bn = 2 * 64
    assert digits["nbytes"] == 10 * bn * 8 + 5 * 2 * bn * 8 + bn
    assert limbs["nbytes"] == 5 * 2 * bn * 8 + bn + 4 * bn * 8
    assert lift["nbytes"] == 10 * bn * 4 + 4 * bn * 4  # residues in; four u32 planes out


@pytest.mark.parametrize("inv", [False, True], ids=["polymul", "inv"])
def test_plan52_lift_spans_hold_their_logical_bytes(inv):
    """Inside `ntt.lift`, once each: the digits span counts the three int64
    residue pairs in, the digits v1 and v2 (limb pairs) and the bool sign
    out; the limbs span v0, v1, v2 and the sign in, the int64 pair out."""
    _, _, records = _traced(_plan52(64, inv=inv))
    lift, = (r for r in records if r["name"] == LIFT)
    digits, = (r for r in records if r["name"] == LIFT_DIGITS)
    limbs, = (r for r in records if r["name"] == LIFT_LIMBS)
    assert digits["parent"] == limbs["parent"] == lift["index"]
    assert (digits["stage"], limbs["stage"]) == ("lift_digits", "lift_limbs")
    bn = 2 * 64
    assert digits["nbytes"] == 3 * 2 * bn * 8 + 2 * 2 * bn * 8 + bn
    assert limbs["nbytes"] == 3 * 2 * bn * 8 + bn + 2 * bn * 8
    assert lift["nbytes"] == 2 * 3 * bn * 4 + 2 * bn * 4  # residue pairs in; (lo, hi) out


def test_u128_lift_records_nothing_with_tracing_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the off path made a profiler or CUDA call")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    _native128(64)()
    assert profiling.recorded_spans() == []


def test_the_buffer_keeps_the_newest_spans():
    extra = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.MAX_SPANS + extra):
            with profiling.span(MARSHAL, "marshal"):
                pass
    records = profiling.recorded_spans()
    assert len(records) == profiling.MAX_SPANS
    assert records[-1]["index"] - records[0]["index"] == profiling.MAX_SPANS - 1


def test_a_span_that_raises_closes():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span(TRANSFORM, "transform"):
                raise ValueError("planted")
        with profiling.span(LIFT, "lift"):
            pass
    first, second = profiling.recorded_spans()
    assert first["parent"] is None and second["parent"] is None  # both top-level


def test_launches_come_from_the_registered_counters(monkeypatch):
    counters = (mxu32_cuda.LAUNCHES, mxu64_cuda.LAUNCHES, butterfly32_cuda.LAUNCHES,
                crt_cuda.LAUNCHES, pointwise_cuda.LAUNCHES)
    for counter in counters:
        assert any(c is counter for c, *_ in profiling._counters.values())
    keys = {"rec_u64_from5": "lift_u64_from5", "mont_mul32_plain": "pointwise_mont32"}
    for module, name in ((mxu32_cuda, "fwd_wide_multi"), (mxu32_cuda, "inv_multi"),
                         (crt_cuda, "rec_u64_from5"), (pointwise_cuda, "mont_mul32_plain")):
        plain = getattr(module, name)
        key = keys.get(name, name)

        def counted(*args, _plain=plain, _module=module, _key=key, **kwargs):
            _module.LAUNCHES[_key] += 1
            return _plain(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    before = {**mxu32_cuda.LAUNCHES, **crt_cuda.LAUNCHES, **pointwise_cuda.LAUNCHES}
    _, _, records = _traced(_native(2048))
    root, *rest = records
    assert root["launches"] == 5  # K1a twice, the product, K1b, the lift
    assert all(r["launches"] is None for r in rest)
    assert mxu32_cuda.LAUNCHES["fwd_wide_multi"] == before["fwd_wide_multi"] + 2
    assert mxu32_cuda.LAUNCHES["inv_multi"] == before["inv_multi"] + 1
    assert crt_cuda.LAUNCHES["lift_u64_from5"] == before["lift_u64_from5"] + 1
    assert pointwise_cuda.LAUNCHES["pointwise_mont32"] == before["pointwise_mont32"] + 1


KERNEL_MODULES = sorted(
    name[:-3] for name in os.listdir(os.path.dirname(mxu32_cuda.__file__))
    if name.endswith("_cuda.py"))


def _registered() -> list:
    """Every kernel module imported (each registers its counters then); their
    (LAUNCHES, TILE_LAUNCHES, prefix) registrations."""
    for name in KERNEL_MODULES:
        importlib.import_module(f"concrete_ntt_tpu_torch.ops.{name}")
    return list(profiling._counters.values())


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_every_kernel_module_registers_its_counters(name):
    module = importlib.import_module(f"concrete_ntt_tpu_torch.ops.{name}")
    launches, tiles, _ = profiling._counters[module.__name__]
    assert launches is module.LAUNCHES
    assert tiles is getattr(module, "TILE_LAUNCHES", None)


def test_reset_launches_zeroes_every_counter():
    for launches, tiles, _ in _registered():
        for key in launches:
            launches[key] += 3
        if tiles is not None:
            tiles[("probe", 0)] = 1
    profiling.reset_launches()
    for launches, tiles, _ in profiling._counters.values():
        assert not any(launches.values())
        assert not tiles
    assert not any(profiling.launch_counts().values()) and not profiling.tile_counts()


def test_launch_counts_give_each_counter_its_own_key():
    """One name a counter, by a fixed rule: a module's keys with its
    registered prefix (K4's `butterfly32_`), beside K2's own `fwd` / `inv`;
    the counts by tile code apart, by `tile_counts`."""
    counts = profiling.launch_counts()
    assert len(counts) == sum(len(launches) for launches, *_ in _registered())
    assert all(isinstance(k, str) for k in profiling.launch_counts())
    assert {"fwd", "inv", "butterfly32_fwd", "butterfly32_inv"} <= set(profiling.launch_counts())
    profiling.reset_launches()
    try:
        butterfly32_cuda.LAUNCHES["fwd"] += 2
        mxu32_cuda.LAUNCHES["fwd"] += 1
        mxu32_cuda.TILE_LAUNCHES[("fwd_hyb", 1, 2)] = 5
        mxu64_cuda.TILE_LAUNCHES[("pass_matmod64_multi", 1)] = 4
        moved = {k: v for k, v in profiling.launch_counts().items() if v}
        assert moved == {"butterfly32_fwd": 2, "fwd": 1}
        assert profiling.tile_counts() == {("fwd_hyb", 1, 2): 5, ("pass_matmod64_multi", 1): 4}
    finally:
        profiling.reset_launches()


def test_a_name_two_modules_give_raises():
    """A new kernel module whose counter shares a name with another's is
    refused at the read, not renamed."""
    _registered()
    profiling.register_launches("probe_cuda", {"inv_multi": 0})
    try:
        with pytest.raises(RuntimeError, match="'inv_multi' of probe_cuda"):
            profiling.launch_counts()
    finally:
        del profiling._counters["probe_cuda"]
    profiling.launch_counts()


def test_root_span_launches_ignore_the_counts_by_tile(monkeypatch):
    """A top-level span's `launches` sums LAUNCHES alone: a launch that is
    also counted by its tile codes counts once."""
    plain = mxu32_cuda.fwd_wide_multi

    def counted(*args, **kwargs):
        mxu32_cuda.LAUNCHES["fwd_wide_multi"] += 1
        key = ("fwd_wide_multi", 0, 0)
        mxu32_cuda.TILE_LAUNCHES[key] = mxu32_cuda.TILE_LAUNCHES.get(key, 0) + 1
        return plain(*args, **kwargs)
    monkeypatch.setattr(mxu32_cuda, "fwd_wide_multi", counted)
    try:
        _, _, records = _traced(_native(2048))
        assert records[0]["parent"] is None and records[0]["launches"] == 2  # K1a twice
        assert mxu32_cuda.TILE_LAUNCHES[("fwd_wide_multi", 0, 0)] >= 2
    finally:
        profiling.reset_launches()


def test_root_span_keeps_the_method_name_and_doc():
    method = native64.Plan32.negacyclic_polymul
    assert method.__name__ == "negacyclic_polymul"
    assert "Wrapping negacyclic product" in method.__doc__


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"


CARD_CASES = {"native64-k1": lambda dev: _native(1 << 14, dev),
              "native128-k1": lambda dev: _native128(1 << 16, dev),
              "native64-plan52-k7": lambda dev: _plan52(1 << 14, dev),
              "prime64-goldilocks": _goldilocks}
# a root's launches: K1a x2, the pointwise product, K1b and native64's lift
# kernel; K1a-W4 x2, the product, K1b and the two lift kernels; K7a x2 and
# K7d (Plan52's lift launches nothing); a K5 fwd or inv, or none
CARD_LAUNCHES = {"native64-k1": {5}, "native128-k1": {6}, "native64-plan52-k7": {3},
                 "prime64-goldilocks": {1, 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_stage_times(case, cuda_device):
    run = CARD_CASES[case](cuda_device)
    run()  # tables and libraries built outside the session
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run()
    records = profiling.recorded_spans()
    children = {}
    for r in records:
        assert r["device_ms"] is not None and r["device_ms"] > 0, r
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append(r["device_ms"])
    for r in records:
        kids = children.get(r["index"], [])
        # CUDA events resolve 0.5 us: one half-step of slack a child
        assert sum(kids) <= r["device_ms"] + 0.0005 * len(kids), r
    assert {r["launches"] for r in records if r["parent"] is None} == CARD_LAUNCHES[case]
