"""The port's `prime64.Plan` against the JAX package's plan, in the five
regime primes (Goldilocks, a 50-bit Plan52 prime, the largest NTT primes
below 2^62, 2^63 and 2^64), through the stage engine (n = 64), the
four-step's plain twin (n = 2048) and the stage-split hybrid's plain twin
(n = 2^16), and against the schoolbook oracle. Inputs from a numpy seed;
tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu import prime64 as jp64
from concrete_ntt_tpu_torch import prime64 as tp64
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_mod
from concrete_ntt_tpu_torch.ops import mxu64_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

REGIMES = {
    "goldilocks": GOLDILOCKS,
    "p50": PRIMES52[0],
    "p63": _lp(1 << 15, 1, 1 << 62, 1 << 63),
    "p64": _lp(1 << 15, 1, 1 << 63, (1 << 64) - 1),
    "p62": _lp(1 << 16, 1, 1 << 61, 1 << 62),
}


def _vals(rng, p, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(p)


def _limbs(v):
    return torch.from_numpy(np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                      (v >> np.uint64(32)).astype(np.uint32)], axis=-1))


@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_plan_matches_jax(rng, regime, n):
    p = REGIMES[regime]
    tplan, jplan = tp64.Plan.new(n, p, device="cpu"), jp64.Plan.new(n, p)
    assert (tplan.variant, tplan.n_inv) == (jplan.variant, jplan.n_inv)
    assert ntt_dispatch.tier64(n, p, "cpu") == ("K5" if n == 2048 else "stage")
    a, b, c = (_vals(rng, p, (2, n)) for _ in range(3))
    np.testing.assert_array_equal(tplan.fwd(a), jplan.fwd(a))
    np.testing.assert_array_equal(tplan.inv(a), jplan.inv(a))
    np.testing.assert_array_equal(tplan.mul_assign_normalize(a, b), jplan.mul_assign_normalize(a, b))
    np.testing.assert_array_equal(tplan.normalize(a), jplan.normalize(a))
    np.testing.assert_array_equal(tplan.mul_accumulate(c, a, b), jplan.mul_accumulate(c, a, b))
    got = tplan.negacyclic_polymul(a, b)
    np.testing.assert_array_equal(got, jplan.negacyclic_polymul(a, b))
    nx = np.array([int(v) * n % p for v in a[0]], dtype=np.uint64)
    np.testing.assert_array_equal(tplan.inv(tplan.fwd(a))[0], nx)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_polymul_matches_golden(rng, regime):
    p, n = REGIMES[regime], 32
    a, b = _vals(rng, p, (3, n)), _vals(rng, p, (3, n))
    got = tp64.Plan.new(n, p, device="cpu").negacyclic_polymul(a, b)
    for i in range(3):
        assert got[i].tolist() == negacyclic_convolution_mod(a[i].tolist(), b[i].tolist(), p)


def test_four_step_route_matches_stage_engine(rng):
    """At n = 2048 the plan takes K5's plain twin; the stage engine on the
    same input gives the same canonical values."""
    p, n = PRIMES52[1], 2048
    plan = tp64.Plan.new(n, p, device="cpu")
    x = _limbs(_vals(rng, p, (2, n)))
    lo, hi = x[..., 0].contiguous(), x[..., 1].contiguous()
    for direction, fn in (("fwd", plan.fwd_pair), ("inv", plan.inv_pair)):
        got, want = fn(lo, hi), plan._stage_engine(lo, hi, direction)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert mxu64_cuda.LAUNCHES == dict.fromkeys(mxu64_cuda.LAUNCHES, 0)


def test_tables_match_jax():
    for p in REGIMES.values():
        t, j = tp64._tables(2048, p), jp64._tables(2048, p)
        assert t.keys() == j.keys()
        for k in j:
            for a, b in zip(t[k], j[k]):
                assert a.dtype == b.dtype == np.uint32
                np.testing.assert_array_equal(a, b)
    assert tp64.Solinas == jp64.Solinas == GOLDILOCKS


def test_formats_and_validation(rng):
    p, n = PRIMES52[0], 64
    plan = tp64.Plan.new(n, p, device="cpu")
    a = _vals(rng, p, (2, 3, n))
    out = plan.fwd(_limbs(a))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 3, n, 2) and out.dtype == torch.uint32
    np.testing.assert_array_equal(
        out[..., 0].numpy().astype(np.uint64) | (out[..., 1].numpy().astype(np.uint64) << np.uint64(32)),
        plan.fwd(a))
    with pytest.raises(TypeError):
        plan.fwd(a.astype(np.int64))
    with pytest.raises(ValueError, match="n=64"):
        plan.fwd(a[..., :32])
    assert tp64.Plan.try_new(3, p) is None and tp64.Plan.try_new(n, p + 2) is None
    assert tp64.Plan.try_new(1 << 20, p) is None and jp64.Plan.try_new(1 << 20, p) is None
    assert tp64.Plan.try_new(n, p) is not None


def test_device_rule(rng):
    """The card is the default device: a default-constructed plan given
    numpy input raises where there is no GPU and never computes on the CPU;
    a CPU tensor computes on the CPU whatever the plan's device."""
    p, n = PRIMES52[0], 64
    plan = tp64.Plan.new(n, p)
    assert plan.device == "cuda" and tp64.Plan.new(n, p, device="cpu").device == "cpu"
    a = _vals(rng, p, (2, n))
    if not torch.cuda.is_available():
        for call in (plan.fwd, plan.inv, plan.normalize, lambda v: plan.negacyclic_polymul(v, v)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call(a)
    got = plan.fwd(_limbs(a))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), tp64.Plan.new(n, p, device="cpu").fwd(_limbs(a)).numpy())
    # the tier is one for every device, at every n: above 2^15 the hybrid
    big = tp64.Plan.try_new(1 << 16, GOLDILOCKS)
    for n in (64, 1024, 2048, 1 << 15, big.n, 1 << 17):
        for q in (GOLDILOCKS, 65537):
            assert ntt_dispatch.tier64(n, q, "cpu") == ntt_dispatch.tier64(n, q, "cuda")
    assert ntt_dispatch.tier64(big.n, big.p, "cuda") == "K5h"
    assert ntt_dispatch.tier64(1 << 15, big.p, "cuda") == "K5"
    assert ntt_dispatch.tier64(big.n, 65537, "cpu") == "stage"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            big.fwd(np.zeros((1, big.n), dtype=np.uint64))


@pytest.fixture
def jax_mxu(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_ENGINE", "mxu")


@pytest.mark.parametrize("regime", ["goldilocks", "p62"])
def test_hybrid_plan_matches_jax_and_stage_engine(rng, jax_mxu, regime):
    """`Plan(2^16, p)` takes the stage-split hybrid (tier "K5h", its plain
    twin here): fwd, inv and the polymul at B = 1 equal the JAX plan's with
    its matmul engine (which takes its hybrid above 2^14) and the port's own
    stage engine."""
    n = 1 << 16
    p = GOLDILOCKS if regime == "goldilocks" else _lp(2 * n, 1, 1 << 61, 1 << 62)
    tplan, jplan = tp64.Plan.new(n, p, device="cpu"), jp64.Plan.new(n, p)
    assert ntt_dispatch.tier64(n, p, "cpu") == "K5h"
    a, b = _vals(rng, p, (1, n)), _vals(rng, p, (1, n))
    fwd = tplan.fwd(a)
    np.testing.assert_array_equal(fwd, jplan.fwd(a))
    np.testing.assert_array_equal(tplan.inv(a), jplan.inv(a))
    np.testing.assert_array_equal(tplan.negacyclic_polymul(a, b), jplan.negacyclic_polymul(a, b))
    x = _limbs(a)
    lo, hi = x[..., 0].contiguous(), x[..., 1].contiguous()
    for direction, fn in (("fwd", tplan.fwd_pair), ("inv", tplan.inv_pair)):
        for g, w in zip(fn(lo, hi), tplan._stage_engine(lo, hi, direction)):
            assert torch.equal(g, w)
    assert mxu64_cuda.LAUNCHES == dict.fromkeys(mxu64_cuda.LAUNCHES, 0)
