"""K5, K6, K7a and K7d of the port (ops/mxu64_cuda.py, ops/mxu64.py) vs the
JAX package.

On the CPU the wrappers run their plain torch twins. These are held against
the JAX Pallas kernels run in interpret mode (the fixture of
tests/test_pallas_interpret.py): the whole-transform kernel
`mxu64_pallas.fwd/inv` (K5), the pass kernel `pass_matmod64` (K6) and the
channel-grid kernels `fwd_multi` / `pointwise_inv_multi` (K7a, K7d); and
against the XLA engine `mxu64.fwd/inv(scale)` in all five prime regimes. The
packed-plane layout the CUDA kernel reads is checked by a numpy dp4a
emulation with 7, 8 and 9 matrix digit planes and the 7-plane operand diet;
the kernels themselves run in tests/test_torch_cuda.py. Tolerance: exact
equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu64 as jmx
from concrete_ntt_tpu.ops import mxu64_pallas as jpal
from concrete_ntt_tpu_torch.ops import cuda_build
from concrete_ntt_tpu_torch.ops import mxu64 as tmx
from concrete_ntt_tpu_torch.ops import mxu64_cuda as tcu
from concrete_ntt_tpu_torch.ops import u32 as tu
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

N_BIG = 1 << 14
REGIMES = {
    "goldilocks": GOLDILOCKS,
    "p50": PRIMES52[0],
    "p63": _lp(2 * N_BIG, 1, 1 << 62, 1 << 63),
    "p64": _lp(2 * N_BIG, 1, 1 << 63, (1 << 64) - 1),
    "p62": _lp(1 << 16, 1, 1 << 61, 1 << 62),
}
P3 = PRIMES52[:3]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 64, p) % p


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _pair(rng, shape):
    return _u32(rng, shape), _u32(rng, shape)


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _same(got, want, shape):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32 and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_regime_table():
    """The five regime primes cover four epilogue regimes and every plane
    count the kernels are built for at these sizes."""
    got = {k: (tcu.mode(p), tmx._n_dplanes(p), tmx._n_eplanes_lazy(p)) for k, p in REGIMES.items()}
    assert got == {"goldilocks": (3, 9, 8), "p50": (0, 7, 7), "p63": (1, 8, 8),
                   "p64": (2, 9, 8), "p62": (0, 8, 8)}
    for p in REGIMES.values():
        assert (tmx._n_dplanes(p), tmx._n_eplanes_lazy(p), tmx._scale_mode(p)) == (
            jmx._n_dplanes(p), jmx._n_eplanes_lazy(p), jmx._scale_mode(p))
        assert tmx.applicable(2048, p) and jmx.applicable(2048, p)
    assert tcu.mode((1 << 63) + 29 * (1 << 20) + 1) == 2
    assert not tmx.applicable(1024, GOLDILOCKS) and not tmx.applicable(2048, (1 << 33) - 9)
    assert tmx.multi_applicable(N_BIG, P3) and jpal.multi_applicable(N_BIG, P3)
    assert not tmx.multi_applicable(N_BIG, (PRIMES52[0], REGIMES["p62"]))  # 7 vs 8 planes
    assert not tmx.multi_applicable(N_BIG, (REGIMES["p63"],))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_k5_plain_matches_xla_engine(rng, regime):
    """fwd, inv unscaled and scaled against `mxu64.fwd/inv` at n = 2048, on
    full-range u32 limbs (any u64 representatives)."""
    p, n, b = REGIMES[regime], 2048, 3
    x = _pair(rng, (b, n))
    _same(tcu.fwd(_t(x), n=n, p=p), jmx.fwd(_j(x), n=n, p=p), (b, n))
    for s in (1, _scale(n, p)):
        _same(tcu.inv(_t(x), n=n, p=p, scale=s), jmx.inv(_j(x), n=n, p=p, scale=s), (b, n))


@pytest.mark.parametrize("regime", ["goldilocks", "p50"])
def test_k5_plain_matches_pallas_interpret(rng, interpret, regime):
    p, b = REGIMES[regime], 2
    x = _pair(rng, (b, N_BIG))
    _same(tcu.fwd(_t(x), n=N_BIG, p=p), jpal.fwd(_j(x), n=N_BIG, p=p), (b, N_BIG))
    s = _scale(N_BIG, p)
    _same(tcu.inv(_t(x), n=N_BIG, p=p, scale=s), jpal.inv(_j(x), n=N_BIG, p=p, scale=s),
          (b, N_BIG))


@pytest.mark.parametrize("regime", ["goldilocks", "p50", "p63"])
def test_k6_plain_matches_pallas_interpret(rng, interpret, regime):
    """One pass at n = 4096: A scaled (whole and a rank-local row slice), F
    canonical on mid-pass values, G scaled, Ainv plain and scaled."""
    p, n, b = REGIMES[regime], 4096, 3
    tbl = tmx._tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    mid = _pair(rng, (b, n1, n2))
    if tbl["scale_mode"] == "shoup":  # mid-pass operands are below 4p (the plane diet)
        v = rng.integers(0, 4 * p, (b, n1, n2), dtype=np.uint64)
        mid = ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32))
    cases = [
        ("A", _pair(rng, (b, n2, n1)), tbl["d"], 1),
        ("A", _pair(rng, (b, n2 // 2, n1)), tuple(t[n2 // 4: n2 // 4 + n2 // 2] for t in tbl["d"]), 1),
        ("F", mid, (), 1),
        ("G", _pair(rng, (b, n1, n2)), tbl["e"], 1),
        ("Ainv", tuple(a.transpose(0, 2, 1).copy() for a in mid), (), 1),
        ("Ainv", tuple(a.transpose(0, 2, 1).copy() for a in mid), (), _scale(n, p)),
    ]
    for which, x, dg, s in cases:
        got = tcu.pass_matmod64(_t(x), n=n, p=p, which=which, diag_slices=dg, scale=s)
        want = jpal.pass_matmod64(_j(x), n=n, p=p, which=which,
                                  mont_slices=tuple(jnp.asarray(d) for d in dg), scale=s)
        _same(got, want, x[0].shape[:2] + (n2 if which in ("F", "G") else n1,))


@pytest.mark.parametrize("b", [8, 3])
def test_k7a_plain_matches_pallas_interpret(rng, interpret, b):
    x = _pair(rng, (b, N_BIG))
    _same(tcu.fwd_multi(_t(x), P3), jpal.fwd_multi(_j(x), P3), (3, b, N_BIG))


def _full_range_operands(rng, b):
    fl, fr = _pair(rng, (3, b, N_BIG)), _pair(rng, (3, b, N_BIG))
    for a in (*fl, *fr):
        a[:, 0, :8] = 0xFFFFFFFF  # (2^64 - 1)^2: T_hi + mulhi(m, p) + carry passes 2^64
    return fl, fr


@pytest.mark.parametrize("b", [8, 3])
def test_k7d_plain_matches_pallas_interpret(rng, interpret, b):
    """Full-range u64 operands: the Montgomery product lands in [p, 2p) and
    beyond for 50-bit primes, and the REDC sum overflows for some pairs."""
    fl, fr = _full_range_operands(rng, b)
    scales = tuple(_scale(N_BIG, p) for p in P3)
    got = tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales)
    want = jpal.pointwise_inv_multi(_j(fl), _j(fr), P3, scales)
    _same(got, want, (3, b, N_BIG))


def test_k7d_needs_the_overflow_branch(rng, monkeypatch):
    """A copy of the twin's Montgomery product with the overflow branch
    dropped (one conditional subtract only) gives another bit pattern on
    full-range operands, at n = 2048 against the XLA route."""
    n, b = 2048, 2
    fl, fr = _pair(rng, (3, b, n)), _pair(rng, (3, b, n))
    for a in (*fl, *fr):
        a[:, 0, :8] = 0xFFFFFFFF
    scales = tuple(_scale(n, p) for p in P3)

    def want():
        outs = []
        for ch, p in enumerate(P3):
            prod = jmx.mont_mul64(_j((fl[0][ch], fl[1][ch])), _j((fr[0][ch], fr[1][ch])), p,
                                  jmx.mont_neginv64(p))
            outs.append(jmx.inv(prod, n=n, p=p, scale=scales[ch]))
        return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(2))

    ref = want()
    _same(tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales), ref, (3, b, n))

    def no_overflow(a, b_, sc):
        l0, l1, l2, l3 = tu.mulwide64(a, b_)
        m = tu.mullo64((l0, l1), tu.const64_like(sc["p_neginv"]))
        mp_hi = tu.mulhi64(m, tu.const64_like(sc["p"]))
        s = tu.add64(tu.add64((l2, l3), mp_hi), (((l0 != 0) | (l1 != 0)).to(torch.int64), 0))
        return tu.cond_sub64(s, sc["p"])

    monkeypatch.setattr(tmx, "_sc_mont_mul64", no_overflow)
    bad = tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales)
    assert any(not np.array_equal(g.numpy(), w) for g, w in zip(bad, ref))


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("which", ["A", "F"])
def test_packed_planes_dp4a_emulation(rng, regime, which):
    """The word layout `pack_planes64` gives the kernel: one __dp4a of the
    operand word (v ^ 0x80808080) against a plane word sums the four digit
    products of that value, for 7, 8 and 9 matrix planes; F of a 50-bit
    prime has 7 operand planes, padded with a zero eighth row."""
    p, n, b = REGIMES[regime], 2048, 2
    tbl = tmx._tables(n, p)
    planes, cvec = tbl[which]
    k = tbl["n1"] if which == "A" else tbl["n2"]
    n_e = planes.shape[0] // k
    assert n_e == (8 if which == "A" else tmx._n_eplanes_lazy(p))
    words = tcu.pack_planes64(planes[None], k)[0]  # [2k, D*O] int32
    assert words.shape == (2 * k, planes.shape[1]) and words.dtype == np.int32
    bound = 4 * p if (which == "F" and n_e == 7) else 1 << 64
    v = rng.integers(0, min(bound, (1 << 64) - 1), (b, k), dtype=np.uint64, endpoint=True)
    limbs = ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32))
    xw = np.concatenate([a ^ np.uint32(0x80808080) for a in limbs], axis=1)  # [b, 2k]
    xb = xw.view(np.int8).reshape(b, 2 * k, 4).astype(np.int64)
    wb = words.view(np.int8).reshape(2 * k, -1, 4).astype(np.int64)
    acc = np.einsum("bke,koe->bo", xb, wb)
    carriers = tuple(torch.from_numpy(a.astype(np.int64)) for a in limbs)
    ref = torch._int_mm(tmx._digit_cat(carriers, n_e), torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(acc, ref)
    np.testing.assert_array_equal(ref, np.asarray(jmx._dot(jmx._digit_cat(
        tuple(jnp.asarray(a) for a in limbs), n_e), jnp.asarray(planes))))


def test_scalar_record(rng):
    for p in REGIMES.values():
        rec = tcu.scalar_record(2048, p)
        assert rec.dtype == np.uint32 and rec.shape == (16,)
        u64 = rec.view(np.uint64)
        c64 = (1 << 64) % p
        assert [int(v) for v in u64[:6]] == [p, c64, (c64 << 64) // p, tu.mont_neginv64(p),
                                             (1 << 64) // p, (2 * p) % (1 << 64)]
        assert int(u64[6]) == ((c64 << 64) % p if p >= (1 << 63) else 0) and int(u64[7]) == 0
        assert list(rec[:12]) == [w & 0xFFFFFFFF for w in jpal._scal_vec64(2048, p)]


def test_wrappers_check_operands(rng):
    p = PRIMES52[0]
    x = _t(_pair(rng, (2, 2048)))
    with pytest.raises(ValueError, match="limb pair"):
        tcu.fwd(x[:1], n=2048, p=p)
    with pytest.raises(ValueError, match="n=4096"):
        tcu.fwd(x, n=4096, p=p)
    with pytest.raises(TypeError, match="uint32"):
        tcu.inv(tuple(a.to(torch.int64) for a in x), n=2048, p=p)
    with pytest.raises(ValueError, match="no route"):
        tcu.fwd(tuple(a.to("meta") for a in x), n=2048, p=p)
    with pytest.raises(NotImplementedError, match="stage engine"):
        tcu.fwd(_t(_pair(rng, (1, 1024))), n=1024, p=p)
    with pytest.raises(NotImplementedError, match="stage-split hybrid"):
        tcu.fwd(_t(_pair(rng, (1, 1 << 16))), n=1 << 16, p=p)
    with pytest.raises(NotImplementedError, match="2\\^33"):
        tcu.fwd(x, n=2048, p=(1 << 32) + 15)
    with pytest.raises(NotImplementedError, match="channel-grid"):
        tcu.fwd_multi(x, (p, REGIMES["p63"]))
    with pytest.raises(ValueError, match="which"):
        tcu.pass_matmod64(_t(_pair(rng, (1, 64, 32))), n=2048, p=p, which="B")
    fl = _t(_pair(rng, (3, 1, 2048)))
    with pytest.raises(ValueError, match="scales"):
        tcu.pointwise_inv_multi(fl, fl, P3, (1, 1))
    with pytest.raises(ValueError, match="channels"):
        tcu.pointwise_inv_multi(fl, fl, P3[:2], (1, 1))
    before = dict(tcu.LAUNCHES)
    tcu.fwd(x, n=2048, p=p)
    tcu.fwd_multi(x, P3)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing
    assert {"mxu64_pass", "mxu64_multi"} <= set(cuda_build.SOURCES)


# -- the u128 operand of K5: four limbs, 16 operand digit planes -----------------


@pytest.mark.parametrize("regime", list(REGIMES))
def test_k5_u128_plain_matches_xla_engine(rng, regime):
    """K5 `fwd` with the four limbs of a u128 operand (full-range u32 limbs,
    all-ones in front) against the JAX `mxu64.fwd` with four limbs at
    n = 2048: the transform of value mod p. The table build's accumulator
    assertion holds in every regime at 16 operand planes (16 * n1 <= 2048
    rows at the sizes K5 serves), so no regime raises."""
    p, n, b = REGIMES[regime], 2048, 3
    limbs = tuple(_u32(rng, (b, n)) for _ in range(4))
    for a in limbs:
        a[0, :4] = 0xFFFFFFFF
    planes, cvec = tmx._wide_col_planes(n, p, 4)
    jplanes, jcvec = jmx._wide_col_planes(n, p, 4)
    n1 = tmx.four_step_factors(n)[0]
    assert planes.shape == (16 * n1, tmx._n_dplanes(p) * n1)
    np.testing.assert_array_equal(planes, jplanes)
    np.testing.assert_array_equal(cvec, jcvec)
    before = dict(tcu.LAUNCHES)
    got = tcu.fwd(_t(limbs), n=n, p=p)
    assert tcu.LAUNCHES == before and "fwd64_u128" in tcu.LAUNCHES  # the CPU launches nothing
    _same(got, jmx.fwd(_j(limbs), n=n, p=p), (b, n))
    # == the two-limb transform of the residue
    v = sum(a.astype(object) << (32 * k) for k, a in enumerate(limbs)) % p
    res = ((v & 0xFFFFFFFF).astype(np.uint32), (v >> 32).astype(np.uint32))
    _same(got, tcu.fwd(_t(res), n=n, p=p), (b, n))


def test_k5_u128_wrapper_checks_operands(rng):
    p, n = REGIMES["p50"], 2048
    limbs = _t(tuple(_u32(rng, (2, n)) for _ in range(4)))
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        tcu.fwd(limbs[:3], n=n, p=p)
    with pytest.raises(ValueError):
        tcu.fwd(limbs, n=4096, p=p)
    with pytest.raises(NotImplementedError):
        tcu.fwd(_t(tuple(_u32(rng, (2, 1024)) for _ in range(4))), n=1024, p=p)
