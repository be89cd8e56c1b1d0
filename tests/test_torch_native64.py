"""The port's native64 Plan32 slice as a whole vs the JAX package.

Same numpy inputs go through `concrete_ntt_tpu.native64.Plan32` and
`concrete_ntt_tpu_torch.native64.Plan32` (CPU tensors: the plain twins of
K1a / K1b); results must be equal exactly, in every input format. A row is
also held against the numpy wrapping oracle. The slice on the card, through
the kernels, is tested in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu import native64 as jn64
from concrete_ntt_tpu import prime32 as jp32
from concrete_ntt_tpu_torch import native64 as tn64
from concrete_ntt_tpu_torch import prime32 as tp32
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping_np
from concrete_ntt_tpu_torch.ops.u32 import np_u64_to_limbs

SHAPES = [(1 << 11, 3), (1 << 14, 2)]


def _plans(n):
    return tn64.Plan32.try_new(n, device="cpu"), jn64.Plan32.try_new(n)


def _values(rng, b, n, binary=False):
    if binary:
        return rng.integers(0, 2, (b, n), dtype=np.uint64)
    return rng.integers(0, 1 << 64, (b, n), dtype=np.uint64)


def _as_format(x, fmt, lib):
    """u64 numpy values in the package's `fmt`: planar / np64 / limbs."""
    if fmt == "np64":
        return x
    limbs = np_u64_to_limbs(x)
    if lib == "jax":
        if fmt == "planar":
            return (jnp.asarray(limbs[..., 0]), jnp.asarray(limbs[..., 1]))
        return jnp.asarray(limbs)
    if fmt == "planar":
        return (torch.from_numpy(limbs[..., 0].copy()), torch.from_numpy(limbs[..., 1].copy()))
    return torch.from_numpy(limbs)


def _to_u64(out, fmt):
    if fmt == "np64":
        return np.asarray(out)
    if fmt == "planar":
        lo, hi = (np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o) for o in out)
        limbs = np.stack([lo, hi], axis=-1)
    else:
        limbs = np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)
    return limbs[..., 0].astype(np.uint64) | (limbs[..., 1].astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("fmt", ["planar", "np64", "limbs"])
@pytest.mark.parametrize("n,b", SHAPES)
def test_polymul_matches_jax(rng, n, b, fmt):
    tplan, jplan = _plans(n)
    lhs, rhs = _values(rng, b, n), _values(rng, b, n)
    got = tplan.negacyclic_polymul(_as_format(lhs, fmt, "torch"), _as_format(rhs, fmt, "torch"))
    want = jplan.negacyclic_polymul(_as_format(lhs, fmt, "jax"), _as_format(rhs, fmt, "jax"))
    if fmt == "planar":
        assert isinstance(got, tuple) and all(g.dtype == torch.uint32 for g in got)
    elif fmt == "limbs":
        assert got.shape == (b, n, 2) and got.dtype == torch.uint32
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    g64, w64 = _to_u64(got, fmt), _to_u64(want, fmt)
    assert g64.shape == (b, n)
    np.testing.assert_array_equal(g64, w64)
    if n == SHAPES[0][0]:
        np.testing.assert_array_equal(g64[0], negacyclic_convolution_wrapping_np(lhs[0], rhs[0]))


@pytest.mark.parametrize("n,b", SHAPES)
def test_polymul_rhs_binary_matches_jax(rng, n, b):
    tplan, jplan = _plans(n)
    lhs, rhs = _values(rng, b, n), _values(rng, b, n, binary=True)
    got = tplan.negacyclic_polymul(lhs, rhs, rhs_binary=True)
    want = jplan.negacyclic_polymul(lhs, rhs, rhs_binary=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, tplan.negacyclic_polymul(lhs, rhs))


@pytest.mark.parametrize("n,b", SHAPES)
def test_fwd_inv_match_jax(rng, n, b):
    tplan, jplan = _plans(n)
    x = _values(rng, b, n)
    got = tplan.fwd(x)
    want = np.asarray(jplan.fwd(x))
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape == (5, b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # unnormalized inverse of canonical residues (the reference's stage
    # engine, which JAX runs on the CPU, takes residues in [0, p))
    r = np.stack([rng.integers(0, p, (b, n), dtype=np.uint32) for p in tplan.primes])
    r[:, 0] = want[:, 0]
    for fmt in ("limbs", "planar", "np64"):
        got_i = tplan.inv(torch.from_numpy(r), out_format=fmt)
        want_i = jplan.inv(jnp.asarray(r), out_format=fmt)
        np.testing.assert_array_equal(_to_u64(got_i, fmt), _to_u64(want_i, fmt))


def test_out_of_range_sizes_raise(rng):
    """Below 2^11 there is no channel route and the plan runs each channel's
    prime32 plan, like the reference; above 2^15, up to 2^17, the channel
    grid serves CPU tensors and the card alike (the card case is in
    tests/test_torch_cuda.py); above 2^17 there is no plan."""
    plan, jplan = tn64.Plan32.try_new(1024, device="cpu"), jn64.Plan32.try_new(1024)
    assert plan is not None and plan.primes == jplan.primes
    x, y = _values(rng, 2, 1024), _values(rng, 2, 1024)
    got = plan.negacyclic_polymul(x, y)
    np.testing.assert_array_equal(got, np.asarray(jplan.negacyclic_polymul(x, y)))
    np.testing.assert_array_equal(got[0], negacyclic_convolution_wrapping_np(x[0], y[0]))
    np.testing.assert_array_equal(plan.fwd(x).numpy(), np.asarray(jplan.fwd(x)))
    p52, jp52 = tn64.Plan52.try_new(1024, device="cpu"), jn64.Plan52.try_new(1024)
    np.testing.assert_array_equal(p52.negacyclic_polymul(x, y), got)
    np.testing.assert_array_equal(p52.fwd(x).numpy(), np.asarray(jp52.fwd(x)))
    big, jbig = tn64.Plan32.try_new(1 << 16, device="cpu"), jn64.Plan32.try_new(1 << 16)
    z = _values(rng, 1, 1 << 16)
    np.testing.assert_array_equal(big.fwd(z).numpy(), np.asarray(jbig.fwd(z)))
    assert big._route32() == "K1"  # the channel grid, on the CPU as on the card
    assert tn64.Plan32.try_new(1 << 18) is None


@pytest.mark.parametrize("n,p", [(1024, 0x3F5A0001), (8, 17), (16, 17), (6, 13), (4, 15),
                                 (2, 4293918721), (64, 2147483777)])
def test_prime32_plan_construction_matches_jax(n, p):
    tp, jp = tp32.Plan.try_new(n, p, device="cpu"), jp32.Plan.try_new(n, p)
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert (tp.variant, tp.p_neginv, tp.n_inv) == (jp.variant, jp.p_neginv, jp.n_inv)


def test_plan_accessors():
    tplan, jplan = _plans(1 << 11)
    assert tplan.primes == jplan.primes and tplan.width == 64
    assert [tplan.ntt(i).p for i in range(5)] == [
        tplan.ntt_0().p, tplan.ntt_1().p, tplan.ntt_2().p, tplan.ntt_3().p, tplan.ntt_4().p
    ] == list(jplan.primes)
