"""The port's 32-bit stage-split hybrid (the 32-bit half of ops/stagesplit.py,
and the block tables of ops/mxu32_cuda.py) vs the JAX package.

On the CPU every wrapper runs its plain torch twin. These are held against
the JAX package's `ops/stagesplit.py` (its XLA engine `fwd32` / `inv32`, and
its Pallas tier `fwd32_fused` / `inv32_fused` and the four `*_hybrid32`
functions over the `hyb=` kernels of `mxu32_pallas.py` in interpret mode) and
against the port's own direct four-step, in the three prime32 regimes (p below
2^30, 2^31 and 2^32), at split depths 1 and 2, on full-range u32 operands.
Inputs from a numpy seed; tolerance: exact equality everywhere (these are
exact integer transforms). The kernels themselves run in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32_pallas as jpal
from concrete_ntt_tpu.ops import stagesplit as jss
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.ops import ntt_dispatch, stagesplit as tss
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as lpap

SIZES = [(512, 256), (512, 128), (1024, 256)]  # tests/test_stagesplit.py's shapes
TAGS = ["lt30", "lt31", "generic"]
N_BIG, N_H = 1 << 15, 1 << 14
P3 = PRIMES[:3]


def _regime_prime(n, tag):
    lo = {"lt30": 29, "lt31": 30, "generic": 31}[tag]
    return lpap(2 * n, 1, 1 << lo, 1 << (lo + 1))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    assert got.dtype == torch.uint32 and tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_same(port, ref, path="tables"):
    """Recursive equality of dicts / tuples / arrays / scalars."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), path
        for k in ref:
            _assert_same(port[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray) and port.dtype == ref.dtype, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref, path


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n,n_h", SIZES)
def test_tables_match_jax(n, n_h, tag):
    """The per-block operator set built for a 32-bit prime (every assertion
    of `_extract_blocks` runs in the build), each block's table dict, the
    stage twiddle tables, A_inv,b times a scale and the wide A_b."""
    p = _regime_prime(n, tag)
    _assert_same(tss._build_hybrid_ops(n, p, n_h), jss._hybrid_ops(n, p, n_h), "built")
    tdv, jdv = tss._dev32(n, p, n_h), jss._dev32(n, p, n_h)
    assert tdv["l"] == jdv["l"] == (n // n_h).bit_length() - 1
    assert len(tdv["blocks"]) == n // n_h
    _assert_same(tdv["blocks"], jdv["blocks"], "blocks")
    _assert_same(tdv["fwd_tw"], jdv["fwd_tw"], "fwd_tw")
    _assert_same(tdv["inv_tw"], jdv["inv_tw"], "inv_tw")
    assert {k: int(v) for k, v in tdv["sc"].items()} == {k: int(v) for k, v in jdv["sc"].items()}
    assert tdv["sc"]["mont"] == (p >= 1 << 31)
    s = _scale(n, p)
    _assert_same(tss._scaled_ainv_blocks32(n, p, n_h, s), jss._scaled_ainv_blocks32(n, p, n_h, s))
    blk = n // n_h - 1
    _assert_same(tss._wide_block_planes32(n, p, n_h, blk, 2),
                 jss._wide_block_planes32(n, p, n_h, blk, 2), "wide A_b")
    if tag == "lt30":
        tw, jw = tss._dev32w(n, p, n_h), jss._dev32w(n, p, n_h)
        _assert_same(tw["fwd_tw"], jw["fwd_tw"], "wide prefix twiddles")
        assert tuple(int(v) for v in tw["sc"]["c64"]) == tuple(int(v) for v in jw["sc"]["c64"])


BOUNDARY_PRIMES = [
    1073479681,  # below 2^30: c32 = 2^32 mod p = 4 * 2^30 - 3p, small
    2147352577,  # below 2^31: c32 near 2^18
    4293918721,  # above 2^31: c32 = 2^32 - p
    67043329,    # a small prime: large quotient 2^32 / p
]


@pytest.mark.parametrize("p", BOUNDARY_PRIMES)
def test_rep_safe_add_sub32_boundary_grid(p):
    """`_add_rep32` / `_sub_rep32` on the exhaustive boundary grid: the same
    bit pattern as the JAX functions (the block kernel digit-splits it), and
    the right residue against Python integers."""
    c32 = (1 << 32) % p
    M = (1 << 32) - 1
    boundary = [0, 1, c32 - 1, c32, c32 + 1, p - 1, p, p + 1, 2 * p - 1, 2 * p,
                M - c32 - 1, M - c32, M - c32 + 1, M - 1, M]
    boundary = sorted({v & M for v in boundary})
    a = np.array([x for x in boundary for _ in boundary], dtype=np.uint32)
    b = np.array([y for _ in boundary for y in boundary], dtype=np.uint32)
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    got_add, got_sub = tss._add_rep32(ta, tb, c32), tss._sub_rep32(ta, tb, c32)
    for g in (got_add, got_sub):
        assert g.dtype == torch.int64 and int(g.min()) >= 0 and int(g.max()) < 1 << 32
    want_add = np.asarray(jss._add_rep32(jnp.asarray(a), jnp.asarray(b), np.uint32(c32)))
    want_sub = np.asarray(jss._sub_rep32(jnp.asarray(a), jnp.asarray(b), np.uint32(c32)))
    np.testing.assert_array_equal(got_add.numpy(), want_add)
    np.testing.assert_array_equal(got_sub.numpy(), want_sub)
    for i in range(len(a)):
        assert int(got_add[i]) % p == (int(a[i]) + int(b[i])) % p
        assert int(got_sub[i]) % p == (int(a[i]) - int(b[i])) % p


@pytest.mark.parametrize("tag", TAGS)
def test_one_stage_matches_jax(rng, tag):
    """`_stage_fwd32` on full-range u32 inputs (with the boundary values in
    front) and `_stage_inv32` on canonical inputs, stages 0 and 1, in the
    Shoup and Montgomery branches."""
    n, n_h, b = 1024, 256, 3
    p = _regime_prime(n, tag)
    tdv, jdv = tss._dev32(n, p, n_h), jss._dev32(n, p, n_h)
    x = _u32(rng, (b, n))
    edge = np.array([0, 1, p - 1, p, p + 1, (1 << 32) - 1, (1 << 32) - p], dtype=np.uint64)
    x[0, :7], x[0, n // 2:n // 2 + 7] = edge.astype(np.uint32), edge[::-1].astype(np.uint32)
    canon = rng.integers(0, p, (b, n), dtype=np.uint32)
    canon[0, :2], canon[0, n // 2:n // 2 + 2] = (0, p - 1), (p - 1, 0)
    for s in range(2):
        got = tss._stage_fwd32(torch.from_numpy(x.astype(np.int64)), tdv["fwd_tw"][s], tdv["sc"])
        want = jss._stage_fwd32(jnp.asarray(x), jdv["fwd_tw"][s], jdv["sc"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = tss._stage_inv32(torch.from_numpy(canon.astype(np.int64)), tdv["inv_tw"][s],
                               tdv["sc"])
        want = jss._stage_inv32(jnp.asarray(canon), jdv["inv_tw"][s], jdv["sc"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.max()) < p  # canonical out


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n,n_h", SIZES)
def test_hybrid_matches_jax_and_direct(rng, n, n_h, tag):
    """fwd32, inv32 and inv32 with n^-1 * 2^32 folded in: the JAX hybrid's
    bits, and the port's direct four-step's, on any-u32 operands."""
    p = _regime_prime(n, tag)
    x = _u32(rng, (2, n))
    got = tss.fwd32(_t(x), n=n, p=p, n_h=n_h)
    _same(got, jss.fwd32(x, n=n, p=p, n_h=n_h))
    _same(got, tmx.fwd(_t(x), n=n, p=p))
    for s in (1, _scale(n, p)):
        got = tss.inv32(_t(x), n=n, p=p, scale=s, n_h=n_h)
        _same(got, jss.inv32(x, n=n, p=p, scale=s, n_h=n_h))
        _same(got, tmx.inv(_t(x), n=n, p=p, scale=s))


def test_hybrid_roundtrip_is_n_times_x(rng):
    n, n_h = 1024, 256
    p = _regime_prime(n, "generic")
    x = rng.integers(0, p, (2, n), dtype=np.uint32)
    want = (x.astype(np.uint64) * np.uint64(n) % np.uint64(p)).astype(np.uint32)
    y = tss.inv32(tss.fwd32(_t(x), n=n, p=p, n_h=n_h), n=n, p=p, n_h=n_h)
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("tag", ["lt30", "generic"])
def test_k2_block_tables_plain_match_pallas_interpret(rng, interpret, tag):
    """The plain twin of K2 with block tables (all blocks of [B, 2^15] at
    once) against the JAX kernel `mxu32_pallas.fwd / inv(hyb=(n, i))` run per
    block in interpret mode, and the engines built on it."""
    p, b = _regime_prime(N_BIG, tag), 2
    x = _u32(rng, (b, N_BIG))
    s = _scale(N_BIG, p)
    before = dict(tcu.LAUNCHES)
    got_f = tcu.fwd_hyb(_t(x), n=N_BIG, p=p, n_h=N_H)
    got_i = tcu.inv_hyb(_t(x), n=N_BIG, p=p, n_h=N_H, scale=s)
    for i in range(N_BIG // N_H):
        blk = jnp.asarray(x[:, i * N_H:(i + 1) * N_H])
        _same(got_f[:, i * N_H:(i + 1) * N_H], jpal.fwd(blk, n=N_H, p=p, hyb=(N_BIG, i)))
        _same(got_i[:, i * N_H:(i + 1) * N_H],
              jpal.inv(blk, n=N_H, p=p, scale=s, hyb=(N_BIG, i)))
    fused = tss.engine32_fused.fwd(_t(x), n=N_BIG, p=p)
    _same(fused, jss.fwd32_fused(x, n=N_BIG, p=p))
    _same(fused, tss.engine32_xla.fwd(_t(x), n=N_BIG, p=p))
    _same(fused, tcu.fwd(_t(x), n=N_BIG, p=p))
    fused = tss.engine32_fused.inv(_t(x), n=N_BIG, p=p, scale=s)
    _same(fused, jss.inv32_fused(x, n=N_BIG, p=p, scale=s))
    _same(fused, tcu.inv(_t(x), n=N_BIG, p=p, scale=s))
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


def _full_range_operands(rng, b, n):
    fl, fr = _u32(rng, (3, b, n)), _u32(rng, (3, b, n))
    fl[:, 0, :8] = fr[:, 0, :8] = 0xFFFFFFFF  # (2^32 - 1)^2: the REDC sum passes 2^32
    return fl, fr


def test_channel_hybrid32_matches_jax_and_direct(rng, interpret):
    """The four channel-grid hybrid functions against the JAX ones
    (interpret mode: K1c / K1b / K1d with `hyb=`) and against the direct
    routes at 2^15."""
    b = 2
    lo, hi = _u32(rng, (b, N_BIG)), _u32(rng, (b, N_BIG))
    assert tss.multi_hybrid_applicable32(N_BIG, P3) and jss.multi_hybrid_applicable32(N_BIG, P3)
    assert not tss.multi_hybrid_applicable32(N_H, P3)
    assert not tss.multi_hybrid_applicable32(N_BIG, (P3[0], 2147352577))
    for limbs in ((lo,), (lo, hi)):
        got = tss.fwd_wide_multi_hybrid32(tuple(map(_t, limbs)), P3, n=N_BIG)
        _same(got, jss.fwd_wide_multi_hybrid32(limbs, P3, n=N_BIG))
        _same(got, tcu.fwd_wide_multi(tuple(map(_t, limbs)), P3))
    with pytest.raises(NotImplementedError, match="direct path"):
        tss.fwd_wide_multi_hybrid32(tuple(map(_t, (lo, hi, lo, hi))), P3, n=N_BIG)
    fl, fr = _full_range_operands(rng, b, N_BIG)
    scales = tuple(_scale(N_BIG, p) for p in P3)
    got = tss.fwd_perchannel_multi_hybrid32(_t(fl), P3, n=N_BIG)
    _same(got, jss.fwd_perchannel_multi_hybrid32(fl, P3, n=N_BIG))
    _same(got, tcu.fwd_multi_perchannel(_t(fl), P3))
    got = tss.inv_multi_hybrid32(_t(fl), P3, scales, n=N_BIG)
    _same(got, jss.inv_multi_hybrid32(fl, P3, scales, n=N_BIG))
    _same(got, tcu.inv_multi(_t(fl), P3, scales))
    got = tss.pointwise_inv_multi_hybrid32(_t(fl), _t(fr), P3, scales, n=N_BIG)
    _same(got, jss.pointwise_inv_multi_hybrid32(fl, fr, P3, scales, n=N_BIG))
    _same(got, tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales))


@pytest.mark.parametrize("n_limbs", [1, 2])
def test_multi_tables_block_axis(n_limbs):
    """`_multi_tables(n_h, primes, n_limbs, scales, hyb=n)` stacks the JAX
    tables of each block `hyb=(n, i)` on a block axis where they differ per
    block and keeps one copy of F and G; the kernel's flat layout indexes
    them by z = channel * nb + block."""
    n, n_h = 4096, 2048
    scales = tuple(_scale(n, p) for p in P3)
    tabs = tcu._multi_tables(n_h, P3, n_limbs, scales, hyb=n)
    nb = n // n_h
    for i in range(nb):
        ref = jpal._multi_tables(n_h, P3, n_limbs, scales, hyb=(n, i))
        assert (tabs["n1"], tabs["n2"]) == (ref["n1"], ref["n2"])
        for direction, per_block in (("fwd", (True, True, False, False)),
                                     ("inv", (False, False, True, True))):
            *mats, diag = tabs[direction]
            *rmats, rdiag = ref[direction]
            for m, r, blocked in zip(mats, rmats, per_block):
                np.testing.assert_array_equal(m[:, i] if blocked else m, r)
            for d, r in zip(diag, rdiag):
                np.testing.assert_array_equal(d[:, i], r)
    kt = tcu._kernel_tables(n_h, P3, n_limbs, scales, "fwd", "cpu", n)
    n1, n2 = tabs["n1"], tabs["n2"]
    # K-major tiles of the GEMM pass: [z][output tile][stage of 32 words][4 * 32 * 32]
    assert kt["planes1"].shape == (3 * nb, n1 // 32, n_limbs * n1 // 32, 4 * 32 * 32)
    assert kt["planes2"].shape == (3, n2 // 32, n2 // 32, 4 * 32 * 32)
    assert kt["diag"].shape == (3 * nb, 4, n2, n1)
    z = 2 * nb + 1  # channel 2, block 1
    np.testing.assert_array_equal(kt["cvec1"][z].numpy(), tabs["fwd"][1][2, 1])
    np.testing.assert_array_equal(kt["diag"][z, 3].numpy().view(np.uint32), tabs["fwd"][4][3][2, 1])


def test_routes_and_checks(rng):
    """No route takes the 32-bit hybrid: at 2^16 and 2^17 the tiers are the
    direct kernels on every device; the block-table wrappers raise outside
    their range on the CPU as on the card."""
    p = _regime_prime(1 << 17, "lt30")
    for n in (1 << 16, 1 << 17):
        assert tss.applicable32(n, p, "lt30") and jss.applicable32(n, p, "lt30")
        assert ntt_dispatch.tier32(n, p, "lt30") == "K2"
        assert ntt_dispatch.route32(n, (p,)) == "K1"
        assert ntt_dispatch.route32(n, (p, 2147352577)) == "K2"
    assert ntt_dispatch.route32(1 << 18, (p,)) is None
    assert not tss.applicable32(N_H, p, "lt30") and not tss.applicable32(1 << 16, 65537, "lt30")
    x = _t(_u32(rng, (1, 4096)))
    with pytest.raises(NotImplementedError, match="2\\^11"):
        tcu.fwd_hyb(x, n=4096, p=p, n_h=1024)
    with pytest.raises(NotImplementedError, match="parent size"):
        tcu.fwd_hyb(x, n=4096, p=p, n_h=4096)
    with pytest.raises(ValueError, match="n=8192"):
        tcu.inv_hyb(x, n=8192, p=p, n_h=2048)
    x3 = _t(_u32(rng, (3, 1, 4096)))
    with pytest.raises(NotImplementedError, match="parent size"):
        tcu.inv_multi(x3, P3, (1, 1, 1), n_h=4096)
    with pytest.raises(NotImplementedError, match="30-bit"):
        tcu.fwd_multi_perchannel(x3, (P3[0], P3[1], 2147352577), n_h=2048)
    assert set(tcu.LAUNCHES) >= {"fwd_hyb", "inv_hyb", "inv_multi_hyb",
                                 "fwd_multi_perchannel_hyb", "pointwise_inv_multi_hyb",
                                 "inv_multi_presplit"}
