"""The port's `native64.Plan52` (three 50-bit prime64 channels) against the
JAX package's Plan52, against the port's Plan32 (both compute the wrapping
product mod 2^64) and against the numpy wrapping oracle; residues crossing
the two packages; the Plan52 channel routes. Inputs from a numpy seed;
tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu import native64 as jn64
from concrete_ntt_tpu.golden.polymul import negacyclic_convolution_wrapping
from concrete_ntt_tpu.ops.u32 import limbs_to_np_u64
from concrete_ntt_tpu_torch import native64 as tn64
from concrete_ntt_tpu_torch.ops import mxu64_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp


def _values(rng, b, n):
    v = rng.integers(0, 1 << 64, (b, n), dtype=np.uint64)
    v[0, :4] = (0, 1, (1 << 64) - 1, 1 << 63)
    return v


def _planar(v):
    return (torch.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            torch.from_numpy((v >> np.uint64(32)).astype(np.uint32)))


def _limbs(v):
    return torch.stack(_planar(v), dim=-1)


@pytest.mark.parametrize("n,b", [(64, 3), (2048, 3), (1 << 14, 2)])
def test_polymul_matches_jax_plan32_and_oracle(rng, n, b):
    tplan, jplan = tn64.Plan52.try_new(n, device="cpu"), jn64.Plan52.try_new(n)
    assert tplan.primes == jplan.primes == PRIMES52[:3] and tplan.tier == "plan52"
    a, c = _values(rng, b, n), _values(rng, b, n)
    got = tplan.negacyclic_polymul(a, c)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, jplan.negacyclic_polymul(a, c))
    if n >= 2048:  # Plan32 serves 2^11 <= n <= 2^15
        np.testing.assert_array_equal(
            got, tn64.Plan32.try_new(n, device="cpu").negacyclic_polymul(a, c))
    if n <= 2048:
        assert got[0].tolist() == negacyclic_convolution_wrapping(a[0].tolist(), c[0].tolist(), 64)
    # the three input formats give the same product, each in its own format
    planar = tplan.negacyclic_polymul(_planar(a), _planar(c))
    assert isinstance(planar, tuple) and planar[0].shape == (b, n)
    limbs = tplan.negacyclic_polymul(_limbs(a), _limbs(c))
    assert limbs.shape == (b, n, 2)
    np.testing.assert_array_equal(limbs_to_np_u64(torch.stack(planar, -1).numpy()), got)
    np.testing.assert_array_equal(limbs_to_np_u64(limbs.numpy()), got)
    np.testing.assert_array_equal(tplan.negacyclic_polymul(a, c & np.uint64(1), rhs_binary=True),
                                  jplan.negacyclic_polymul(a, c & np.uint64(1), rhs_binary=True))


@pytest.mark.parametrize("n,b", [(64, 2), (2048, 3)])
def test_fwd_inv_match_jax_and_cross(rng, n, b):
    """fwd residues [k, B, n, 2] equal the JAX plan's; the JAX plan's
    residues (as numpy) fed to the port's inv give the JAX result."""
    tplan, jplan = tn64.Plan52.try_new(n, device="cpu"), jn64.Plan52.try_new(n)
    a = _values(rng, b, n)
    jres = np.asarray(jplan.fwd(a))
    tres = tplan.fwd(a)
    assert tres.dtype == torch.uint32 and tuple(tres.shape) == (3, b, n, 2)
    np.testing.assert_array_equal(tres.numpy(), jres)
    want = limbs_to_np_u64(np.asarray(jplan.inv(jres)))
    np.testing.assert_array_equal(tplan.inv(jres, out_format="np64"), want)
    np.testing.assert_array_equal(tplan.inv(tres, out_format="np64"), want)
    np.testing.assert_array_equal(want, a * np.uint64(n))  # unnormalized: n·x wrapping
    out = tplan.inv(tres)
    assert out.shape == (b, n, 2)
    with pytest.raises(ValueError, match="residues"):
        tplan.inv(tres[:2])
    with pytest.raises(ValueError, match="residues"):
        tplan.inv(tres[..., 0])


def test_channel_routes():
    p63 = _lp(1 << 15, 1, 1 << 62, 1 << 63)
    assert ntt_dispatch.route64(1 << 14, PRIMES52[:3]) == "K7"
    assert ntt_dispatch.route64(2048, PRIMES52[:3]) == "K7"
    assert ntt_dispatch.route64(1 << 14, (PRIMES52[0], p63)) == "K5"
    assert ntt_dispatch.route64(1 << 14, (GOLDILOCKS,)) == "K5"
    assert ntt_dispatch.route64(1024, PRIMES52[:3]) is None
    assert ntt_dispatch.route64(1 << 16, PRIMES52[:3]) == "K7h"  # the channel-grid hybrid
    assert ntt_dispatch.route64(1 << 16, (PRIMES52[0], p63)) == "K5h"
    assert ntt_dispatch.route64(1 << 16, ((1 << 32) + 15,)) is None
    assert ntt_dispatch.route64(2048, ((1 << 32) + 15,)) is None


def test_k5_route_matches_k7_route(rng, monkeypatch):
    """The per-channel route (K5's plain twin and a plain Montgomery
    product) gives the channel grid's result."""
    n, b = 2048, 2
    plan = tn64.Plan52.try_new(n, device="cpu")
    a, c = _values(rng, b, n), _values(rng, b, n)
    want = plan.negacyclic_polymul(a, c)
    monkeypatch.setattr(ntt_dispatch.mxu64, "multi_applicable", lambda n, primes: False)
    assert ntt_dispatch.route64(n, plan.primes) == "K5"
    np.testing.assert_array_equal(plan.negacyclic_polymul(a, c), want)
    monkeypatch.setattr(ntt_dispatch, "route64", lambda n, primes: None)
    np.testing.assert_array_equal(plan.negacyclic_polymul(a, c), want)
    np.testing.assert_array_equal(plan.fwd(a).numpy(), np.asarray(jn64.Plan52.try_new(n).fwd(a)))
    assert mxu64_cuda.LAUNCHES == dict.fromkeys(mxu64_cuda.LAUNCHES, 0)


def test_device_rule_and_accessors(rng):
    plan = tn64.Plan52.try_new(64)
    assert plan.device == "cuda" and all(pl.device == "cuda" for pl in plan.plans)
    assert [plan.ntt(i).p for i in range(3)] == [plan.ntt_0().p, plan.ntt_1().p,
                                                 plan.ntt_2().p] == list(PRIMES52[:3])
    a = _values(rng, 2, 64)
    if not torch.cuda.is_available():
        for p_ in (plan, tn64.Plan32.try_new(2048)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                p_.negacyclic_polymul(np.resize(a, (2, p_.n)), np.resize(a, (2, p_.n)))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            plan.fwd(a)
    got = plan.negacyclic_polymul(_planar(a), _planar(a))  # CPU tensors compute on the CPU
    assert got[0].device.type == "cpu"
    cpu = tn64.Plan52.try_new(64, device="cpu").negacyclic_polymul(a, a)
    np.testing.assert_array_equal(limbs_to_np_u64(torch.stack(got, -1).numpy()), cpu)
    assert tn64.Plan52.try_new(1 << 20) is None and jn64.Plan52.try_new(1 << 20) is None
