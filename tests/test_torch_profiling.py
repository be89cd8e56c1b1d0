"""Port utils/profiling.py vs concrete_ntt_tpu.utils.profiling: the
roofline's byte and MAC counts equal the JAX package's, the peaks are the
H100 SXM data-sheet figures, `chain_time` on CPU tensors (eager chains)
gives a positive time that grows with the step's work and raises on a
non-positive difference, `trace` writes a Chrome trace; and the stacked
polymul's factored pointwise stage (`ntt_dispatch.pointwise_mont32`) plus
the inverse's plain twin equal `try_polymul32_stacked`'s plain path."""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu.utils import profiling as jprof
from concrete_ntt_tpu_torch import native64
from concrete_ntt_tpu_torch.ops import mxu32_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("planes", [(4, 4), (8, 4), (16, 4), (8, 5), (4, 5)])
@pytest.mark.parametrize("n", [1 << 10, 1 << 11, 1 << 14, 1 << 15, 1 << 16, 1 << 17])
def test_roofline_counts_match_jax(n, planes):
    for batch in (1, 8, 40):
        got = tprof.mxu_transform_roofline(n, batch, 1e-3, *planes)
        want = jprof.mxu_transform_roofline(n, batch, 1e-3, *planes)
        assert (got.hbm_bytes, got.mxu_macs) == (want.hbm_bytes, want.mxu_macs)


def test_peaks_are_the_h100_figures():
    assert tprof.HBM_BYTES_PER_S == 3.35e12
    assert tprof.INT8_OPS_PER_S == 1979e12
    assert tprof.CORE_OPS_PER_S == 67e12
    r = tprof.Roofline(seconds=1.0, hbm_bytes=int(3.35e12), mxu_macs=int(1979e12 / 4))
    assert r.hbm_util == pytest.approx(1.0) and r.mxu_util == pytest.approx(0.5)
    assert r.share == pytest.approx(1.0)
    assert r.hbm_gbs == pytest.approx(3350.0) and r.mxu_tops == pytest.approx(989.5)


def _matmul_step(size):
    m = torch.randn(size, size, dtype=torch.float64) / size

    def step(carry):
        (x,) = carry
        return (x @ m,)

    return step, (torch.randn(size, size, dtype=torch.float64),)


def test_chain_time_cpu_grows_with_work():
    small = tprof.chain_time(*_matmul_step(16), length=8, reps=3)
    large = tprof.chain_time(*_matmul_step(384), length=8, reps=3)
    assert 0 < small < large < 10 and np.isfinite(large)


def test_chain_time_raises_on_non_positive_difference(monkeypatch):
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: 1.0)  # a clock that never moves
    with pytest.raises(RuntimeError, match="non-monotone"):
        tprof.chain_time(*_matmul_step(4), length=4, reps=2)


def test_chain_time_rejects_a_step_that_changes_shapes():
    with pytest.raises(ValueError, match="same shapes"):
        tprof.chain_time(lambda c: (c[0][:1],), (torch.zeros(4, 4),), length=2, reps=1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_pointwise_stage_plus_inverse_equals_stacked_polymul():
    n, b = 1 << 11, 2
    plan = native64.Plan32.try_new(n, device="cpu")
    rng = np.random.default_rng(7)
    ops = [torch.from_numpy(rng.integers(0, 1 << 32, (b, n), dtype=np.uint32)) for _ in range(4)]
    want = ntt_dispatch.try_polymul32_stacked(ops[:2], ops[2:], plan.plans)
    fl = mxu32_cuda.fwd_wide_multi_plain(tuple(ops[:2]), plan.primes)
    fr = mxu32_cuda.fwd_wide_multi_plain(tuple(ops[2:]), plan.primes)
    t = ntt_dispatch.pointwise_mont32(fl, fr, plan.primes)
    got = mxu32_cuda.inv_multi_plain(t, plan.primes,
                                     ntt_dispatch._pointwise_scales(n, plan.primes))
    assert got.dtype == torch.uint32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
