"""The port's spans (`utils/profiling.span`, `root_span`, `recorded_spans`).

Outside a profiler session a span is one shared object that does nothing: no
record, no CUDA event, no profiler call, no allocation. Inside one, the
plans' calls record their stage trees (marshal, transform, pointwise, lift)
in the order the work runs, with parents and roots, each name on the
profiler's timeline, the same outputs as with tracing off, a bounded
buffer, and each top-level call's kernel launches from the registered
counters. The card tests (marked `cuda`) read each stage's device time.

The file imports only the port (no JAX), so its card tests run on a GPU
machine without JAX:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from concrete_ntt_tpu_torch import native64, prime64
from concrete_ntt_tpu_torch.ops import butterfly32_cuda, mxu32_cuda, mxu64_cuda
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


MARSHAL, TRANSFORM, POINTWISE, LIFT = (f"ntt.{s}" for s in profiling.STAGES)
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
    for counter in (mxu32_cuda.LAUNCHES, mxu64_cuda.LAUNCHES, butterfly32_cuda.LAUNCHES):
        assert any(c is counter for c in profiling._counters)
    for name in ("fwd_wide_multi", "inv_multi"):
        plain = getattr(mxu32_cuda, name)

        def counted(*args, _plain=plain, _name=name, **kwargs):
            mxu32_cuda.LAUNCHES[_name] += 1
            return _plain(*args, **kwargs)
        monkeypatch.setattr(mxu32_cuda, name, counted)
    before = dict(mxu32_cuda.LAUNCHES)
    _, _, records = _traced(_native(2048))
    root, *rest = records
    assert root["launches"] == 3  # K1a twice, K1b once
    assert all(r["launches"] is None for r in rest)
    assert mxu32_cuda.LAUNCHES["fwd_wide_multi"] == before["fwd_wide_multi"] + 2
    assert mxu32_cuda.LAUNCHES["inv_multi"] == before["inv_multi"] + 1


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
              "prime64-goldilocks": _goldilocks}


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
    assert {r["launches"] for r in records if r["parent"] is None} == (
        {3} if case.startswith("native64") else {1, 0})
