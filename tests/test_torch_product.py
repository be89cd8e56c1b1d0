"""The port's product plan (concrete_ntt_tpu_torch/product.py) vs the JAX
package's (concrete_ntt_tpu/product.py), on the CPU.

Same seeded numpy inputs through both plans: the channel mixes of
tests/test_product.py without a factor >= 2^32 at n = 64 (the generic path
of both packages), and at n = 2048 a 30-bit pair (the port's channel-grid
route, K1a-K1d's plain twins) and a pair of primes above 2^31 (the
per-channel four-step route, K2's plain twins); the JAX package runs its
CPU path (prime32 plans per channel). Replace, Accumulate, Bounded, the
elementwise ops, a PBS-shaped composite with preloaded NTT-domain operands
carried between the packages, and validation. Tolerance: exact equality
everywhere (integer arithmetic); row 0 also against the bigint schoolbook
oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu import product as J
from concrete_ntt_tpu_torch import product as T
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_mod
from concrete_ntt_tpu_torch.ops import mxu32_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.tables import PRIMES32
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64

N, N_MID = 64, 2048
BOUND = 1 << 20


def _two_primes(n, lo, hi):
    """The two largest primes p ≡ 1 (mod 2n) in [lo, hi], ascending."""
    p = largest_prime_in_arithmetic_progression64(2 * n, 1, lo, hi)
    q = largest_prime_in_arithmetic_progression64(2 * n, 1, lo, p - 1)
    return [q, p]


def _p15(n):
    out, hi = [], (1 << 15) - 1
    while len(out) < 4:
        out.append(largest_prime_in_arithmetic_progression64(2 * n, 1, 1 << 10, hi))
        hi = out[-1] - 1
    return sorted(out)


P30 = [PRIMES32[0], PRIMES32[1]]
MIXES = {
    "u32x1": [PRIMES32[0]],
    "u30x2": P30,
    "u32x2": _two_primes(N, 1 << 31, (1 << 32) - 1),
    "u32x4": _p15(N),
}
MID = {"K1": P30, "K2": _two_primes(N_MID, 1 << 31, (1 << 32) - 1)}


def _plans(n, factors):
    m = int(np.prod([int(f) for f in factors], dtype=object))
    return J.Plan.new(n, m, factors), T.Plan.new(n, m, factors, device="cpu"), m


def _rand_mod(rng, m, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(m)


def _centred(rng, m, shape):
    signed = rng.integers(-(BOUND // 2), BOUND // 2, shape)
    return np.array([int(v) % m for v in signed.ravel()], dtype=np.uint64).reshape(shape)


def _conv_row0(a, b, m, acc=None):
    conv = negacyclic_convolution_mod(a[0].tolist(), b[0].tolist(), m)
    return conv if acc is None else [(int(c) + x) % m for c, x in zip(acc[0], conv)]


@pytest.mark.parametrize("mix", list(MIXES))
def test_roundtrip_matches_jax(rng, mix):
    jp, tp, m = _plans(N, MIXES[mix])
    x = _rand_mod(rng, m, (3, N))
    dom = tp.fwd(x)
    jdom = jp.fwd(x)
    np.testing.assert_array_equal(dom.res32.numpy(), np.asarray(jdom.res32))
    back = tp.inv(tp.normalize(dom))
    np.testing.assert_array_equal(back, np.asarray(jp.inv(jp.normalize(jdom))))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("mode", [T.REPLACE, T.ACCUMULATE])
@pytest.mark.parametrize("mix", list(MIXES))
def test_polymul_matches_jax_and_oracle(rng, mix, mode):
    jp, tp, m = _plans(N, MIXES[mix])
    a, b, c = (_rand_mod(rng, m, (2, N)) for _ in range(3))
    std = c if mode == T.ACCUMULATE else None
    got = tp.negacyclic_polymul(a, b, mode=mode, standard=std)
    want = jp.negacyclic_polymul(a, b, mode=mode, standard=std)
    assert got.dtype == np.uint64 and got.shape == (2, N)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0].tolist() == _conv_row0(a, b, m, std)


@pytest.mark.parametrize("mix", ["u30x2", "u32x2"])
def test_bounded_matches_jax_and_generic(rng, mix):
    jp, tp, m = _plans(N, MIXES[mix])
    x, rhs = _centred(rng, m, (2, N)), _rand_mod(rng, m, (2, N))
    dom_b = tp.fwd(x, T.bounded(BOUND))
    np.testing.assert_array_equal(dom_b.res32.numpy(), tp.fwd(x).res32.numpy())
    np.testing.assert_array_equal(dom_b.res32.numpy(),
                                  np.asarray(jp.fwd(x, J.bounded(BOUND)).res32))
    got = tp.negacyclic_polymul(x, rhs, lhs_fwd_mode=T.bounded(BOUND))
    np.testing.assert_array_equal(
        got, np.asarray(jp.negacyclic_polymul(x, rhs, lhs_fwd_mode=J.bounded(BOUND))))
    assert got[0].tolist() == _conv_row0(x, rhs, m)


@pytest.mark.parametrize("mix", list(MIXES))
def test_elementwise_ops_match_jax(rng, mix):
    jp, tp, m = _plans(N, MIXES[mix])
    a, b, c = (_rand_mod(rng, m, (2, N)) for _ in range(3))
    ta, tb, tc = tp.fwd(a), tp.fwd(b), tp.fwd(c)
    ja, jb, jc = jp.fwd(a), jp.fwd(b), jp.fwd(c)
    pairs = [
        (tp.mul_assign_normalize(ta, tb), jp.mul_assign_normalize(ja, jb)),
        (tp.normalize(tc), jp.normalize(jc)),
        (tp.mul_accumulate(tc, ta, tb), jp.mul_accumulate(jc, ja, jb)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.res32.numpy(), np.asarray(want.res32))
    acc = tp.mul_accumulate(tp.mul_assign_normalize(ta, tb), tp.normalize(tc), tp.fwd(a))
    got = tp.inv(acc, mode=T.ACCUMULATE, standard=b)
    conv = [(x + y) % m for x, y in zip(_conv_row0(a, b, m), _conv_row0(c, a, m))]
    assert got[0].tolist() == [(int(s) + v) % m for s, v in zip(b[0], conv)]


@pytest.mark.parametrize("route", list(MID))
def test_channel_routes_match_jax(rng, route):
    """n = 2048: the port's channel routes (plain twins of K1a-K1d, or of
    K2 per channel) against the JAX package's CPU path, every mode."""
    jp, tp, m = _plans(N_MID, MID[route])
    assert ntt_dispatch.route32(N_MID, tp.primes32) == route
    a, b, c = (_rand_mod(rng, m, (2, N_MID)) for _ in range(3))
    x = _centred(rng, m, (2, N_MID))
    for mode, std, lhs, fm in [(T.REPLACE, None, a, T.GENERIC), (T.ACCUMULATE, c, a, T.GENERIC),
                               (T.ACCUMULATE, c, x, ("bounded", BOUND))]:
        got = tp.negacyclic_polymul(lhs, b, mode=mode, standard=std, lhs_fwd_mode=fm)
        want = jp.negacyclic_polymul(lhs, b, mode=mode, standard=std, lhs_fwd_mode=fm)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{mode} {fm}")
    dom = tp.fwd(x, T.bounded(BOUND))
    np.testing.assert_array_equal(dom.res32.numpy(),
                                  np.asarray(jp.fwd(x, J.bounded(BOUND)).res32))
    np.testing.assert_array_equal(tp.inv(dom), np.asarray(jp.inv(jp.fwd(x))))


def test_fused_path_reaches_k1c_k1d_on_cpu(rng, monkeypatch):
    """The CPU takes the card's route: the K1 polymul calls K1a/K1c and
    K1d's wrappers (here their plain twins), the generic n = 64 path none."""
    calls = []
    for name in ("fwd_wide_multi", "fwd_multi_perchannel", "pointwise_inv_multi", "inv_multi"):
        orig = getattr(mxu32_cuda, name)
        monkeypatch.setattr(mxu32_cuda, name,
                            lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    _, tp, m = _plans(N_MID, P30)
    a, b = _centred(rng, m, (1, N_MID)), _rand_mod(rng, m, (1, N_MID))
    tp.negacyclic_polymul(a, b)
    assert calls == ["fwd_wide_multi", "fwd_wide_multi", "pointwise_inv_multi"]
    calls.clear()
    tp.inv(tp.fwd(a, T.bounded(BOUND)))
    tp.negacyclic_polymul(a, b, lhs_fwd_mode=T.bounded(BOUND))
    assert calls == ["fwd_multi_perchannel", "inv_multi", "fwd_multi_perchannel",
                     "fwd_wide_multi", "pointwise_inv_multi"]
    calls.clear()
    _, small, m = _plans(N, P30)
    small.negacyclic_polymul(_rand_mod(rng, m, (1, N)), _rand_mod(rng, m, (1, N)))
    assert calls == []


@pytest.mark.parametrize("n", [N, N_MID])
def test_pbs_composite_matches_jax(rng, n):
    """One Bounded fwd per term, K = 4 mul_accumulate terms against
    preloaded NTT-domain operands (made by the JAX plan, carried over with
    NttDomain.from_numpy), one inv(ACCUMULATE)."""
    jp, tp, m = _plans(n, P30)
    k, b = 4, 2
    keys = [_rand_mod(rng, m, (b, n)) for _ in range(k)]
    digits = [_centred(rng, m, (b, n)) for _ in range(k)]
    acc0 = _rand_mod(rng, m, (b, n))
    pre_j = [jp.normalize(jp.fwd(key)) for key in keys]
    pre_t = [T.NttDomain.from_numpy(np.asarray(d.res32), device="cpu") for d in pre_j]
    zeros = np.zeros((2, b, n), dtype=np.uint32)
    acc_t, acc_j = T.NttDomain.from_numpy(zeros, device="cpu"), J.NttDomain(jnp.asarray(zeros), None)
    for d, pt, pj in zip(digits, pre_t, pre_j):
        acc_t = tp.mul_accumulate(acc_t, tp.fwd(d, T.bounded(BOUND)), pt)
        acc_j = jp.mul_accumulate(acc_j, jp.fwd(d, J.bounded(BOUND)), pj)
    got = tp.inv(acc_t, mode=T.ACCUMULATE, standard=acc0)
    np.testing.assert_array_equal(got, np.asarray(jp.inv(acc_j, mode=J.ACCUMULATE, standard=acc0)))
    if n == N:
        want = [int(v) for v in acc0[0]]
        for d, key in zip(digits, keys):
            want = [(w + c) % m for w, c in zip(want, _conv_row0(d, key, m))]
        assert got[0].tolist() == want


def test_ntt_domain_crosses_packages(rng):
    jp, tp, m = _plans(N_MID, P30)
    x = _rand_mod(rng, m, (2, N_MID))
    jdom = jp.fwd(x)
    res32, res64 = T.NttDomain.from_numpy(np.asarray(jdom.res32), device="cpu").numpy()
    assert res64 is None and res32.dtype == np.uint32
    np.testing.assert_array_equal(
        tp.inv(T.NttDomain.from_numpy(res32, device="cpu")), np.asarray(jp.inv(jdom)))
    back = J.NttDomain(jnp.asarray(tp.fwd(x).numpy()[0]), None)
    np.testing.assert_array_equal(np.asarray(jp.inv(back)), tp.inv(tp.fwd(x)))
    with pytest.raises(TypeError):
        T.NttDomain.from_numpy(res32.astype(np.int64))


def test_formats_follow_jax(rng):
    """numpy uint64 in -> numpy out; uint32 [..., n, 2] limbs in -> a limb
    tensor out (Replace); in Accumulate `standard`'s format decides; inv
    defaults to numpy."""
    _, tp, m = _plans(N_MID, P30)
    a, b, c = (_rand_mod(rng, m, (3, N_MID)) for _ in range(3))
    limbs = lambda v: torch.from_numpy(np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                                 (v >> np.uint64(32)).astype(np.uint32)], -1))
    want = tp.negacyclic_polymul(a, b)
    got = tp.negacyclic_polymul(limbs(a), limbs(b))
    assert isinstance(got, torch.Tensor) and got.shape == (3, N_MID, 2)
    np.testing.assert_array_equal(got.numpy(), limbs(want).numpy())
    acc = tp.negacyclic_polymul(limbs(a), limbs(b), mode=T.ACCUMULATE, standard=c)
    assert isinstance(acc, np.ndarray) and acc.dtype == np.uint64
    dom = tp.fwd(limbs(a)[None])
    assert dom.res32.shape == (2, 1, 3, N_MID)
    assert isinstance(tp.inv(dom), np.ndarray) and tp.inv(dom).shape == (1, 3, N_MID)
    with pytest.raises(TypeError):
        tp.fwd(a.astype(np.int64))
    with pytest.raises(ValueError, match="n=2048"):
        tp.fwd(a[:, :64])
    with pytest.raises(ValueError, match="standard"):
        tp.inv(dom, mode=T.ACCUMULATE)


def test_validation_matches_jax():
    p0, p1 = P30
    cases = [(15, [3, 5]), (p0 * p1, [p1, p0]), (p0 * p0, [p0, p0]), (p0 * p1 + 1, [p0, p1]),
             (p0, [1, p0]), (p0 * 4, [2, 2, p0])]
    for modulus, factors in cases:
        tp, jp = T.Plan.try_new(N, modulus, factors, device="cpu"), J.Plan.try_new(N, modulus, factors)
        assert (tp is None) == (jp is None), (modulus, factors)
        if tp is not None:
            assert tp.factors == jp.factors
    assert T.Plan.try_new(N, p0, [1, p0]).factors == (p0,)
    assert T.Plan.try_new(N, p0, [1, p0]).device == "cuda"  # the card is the default


def test_prime64_factor_raises(rng):
    """A factor >= 2^32 is a prime64 channel now (it raised NotImplementedError
    before the prime64 plan was ported): the plan builds and equals the JAX
    package's. What still raises: a plan on the default device (the card)
    given numpy input where there is no GPU."""
    p33 = largest_prime_in_arithmetic_progression64(2 * N, 1, 1 << 32, (1 << 33) - 1)
    p15 = _p15(N)[:2]
    factors = [*p15, p33]
    m = p15[0] * p15[1] * p33
    tp, jp = T.Plan.new(N, m, factors, device="cpu"), J.Plan.new(N, m, factors)
    assert tp.primes32 == tuple(p15) and tp.primes64 == (p33,)
    a, b = _rand_mod(rng, m, (2, N)), _rand_mod(rng, m, (2, N))
    np.testing.assert_array_equal(tp.negacyclic_polymul(a, b), jp.negacyclic_polymul(a, b))
    dom = T.NttDomain.from_numpy(np.zeros((2, N), np.uint32), np.zeros((1, N, 2), np.uint32),
                                 device="cpu")
    assert dom.res64.shape == (1, N, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.Plan.new(N, m, factors).negacyclic_polymul(a, b)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.NttDomain.from_numpy(np.zeros((2, N), np.uint32))


def _mix64(n, mix):
    """Factor sets with prime64 channels: one u64 prime alone, a u32 and a
    u64 prime, two primes below 2^15.5 and a 33-bit one."""
    lp = largest_prime_in_arithmetic_progression64
    if mix == "u64x1":
        return (lp(2 * n, 1, 1 << 40, 1 << 41),)
    if mix == "u30+u64":
        return (lp(2 * n, 1, 1 << 29, 1 << 30), lp(2 * n, 1, 1 << 33, 1 << 34))
    small = lp(2 * n, 1, 1 << 10, 46340)
    return (lp(2 * n, 1, 1 << 10, small - 1), small, lp(2 * n, 1, 1 << 32, (1 << 33) - 1))


@pytest.mark.parametrize("n", [N, N_MID])
@pytest.mark.parametrize("mix", ["u64x1", "u30+u64", "u15x2+u33"])
def test_prime64_channels_match_jax(rng, mix, n):
    """Plans with u64 factors: fwd (res32 and res64), inv in both modes, the
    elementwise ops, the polymul and a Bounded request (Generic there), all
    against the JAX plan; the NTT domain crosses the packages with res64."""
    factors = _mix64(n, mix)
    jp, tp, m = _plans(n, factors)
    assert tp.primes64 == jp.primes64 and tp.primes32 == jp.primes32
    a, b, c = (_rand_mod(rng, m, (2, n)) for _ in range(3))
    jd, td = jp.fwd(a), tp.fwd(a)
    for got, want in zip(td.numpy(), (jd.res32, jd.res64)):
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, np.asarray(want))
    crossed = T.NttDomain.from_numpy(*(None if r is None else np.asarray(r)
                                       for r in (jd.res32, jd.res64)), device="cpu")
    np.testing.assert_array_equal(tp.inv(crossed), jp.inv(jd))
    np.testing.assert_array_equal(tp.inv(td, mode=T.ACCUMULATE, standard=c),
                                  jp.inv(jd, mode=J.ACCUMULATE, standard=c))
    np.testing.assert_array_equal(tp.inv(td)[0], [int(v) * n % m for v in a[0]])
    jd2, td2 = jp.fwd(b), tp.fwd(b)
    np.testing.assert_array_equal(
        tp.inv(tp.mul_accumulate(td, td2, tp.normalize(td))),
        jp.inv(jp.mul_accumulate(jd, jd2, jp.normalize(jd))))
    for kw_t, kw_j in (({}, {}), ({"mode": T.ACCUMULATE, "standard": c},
                                  {"mode": J.ACCUMULATE, "standard": c})):
        np.testing.assert_array_equal(
            tp.negacyclic_polymul(a, b, lhs_fwd_mode=T.bounded(1 << 10), **kw_t),
            jp.negacyclic_polymul(a, b, lhs_fwd_mode=J.bounded(1 << 10), **kw_j))
    if n == N:
        assert tp.negacyclic_polymul(a, b)[0].tolist() == _conv_row0(a, b, m)


def test_prime64_channel_takes_the_hybrid_at_2pow16(rng):
    """At n = 2^16 a u64 factor's channel runs the stage-split hybrid (tier
    "K5h": its plain twin here) through `prime64.Plan`; the plan with a u32
    and a u64 factor equals the JAX plan's at B = 1."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch

    n = 1 << 16
    factors = _mix64(n, "u30+u64")
    jp, tp, m = _plans(n, factors)
    assert tp.primes64 == (factors[1],) and ntt_dispatch.tier64(n, factors[1], "cpu") == "K5h"
    a, b = (_rand_mod(rng, m, (1, n)) for _ in range(2))
    np.testing.assert_array_equal(tp.negacyclic_polymul(a, b), jp.negacyclic_polymul(a, b))
    np.testing.assert_array_equal(tp.inv(tp.fwd(a))[0], [int(v) * n % m for v in a[0]])


def test_ntt_size_matches_jax():
    jp, tp, _ = _plans(N, P30)
    assert tp.ntt_size() == jp.ntt_size() == N
