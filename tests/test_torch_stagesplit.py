"""The port's 64-bit stage-split hybrid (ops/stagesplit.py, and the block
tables of ops/mxu64.py / ops/mxu64_cuda.py) vs the JAX package.

On the CPU every wrapper runs its plain torch twin. These are held against
the JAX package's `ops/stagesplit.py` (its XLA engine, and its Pallas tier
and the `hyb=` kernels of `mxu64_pallas.py` in interpret mode) and against
the port's own direct four-step, in the five prime regimes (a 50-bit prime,
primes below 2^62, 2^63 and 2^64, Goldilocks), at split depths 1 and 2, on
full-range u64 operands. Inputs from a numpy seed; tolerance: exact equality
everywhere (these are exact integer transforms). The kernels themselves run
in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu64 as jmx
from concrete_ntt_tpu.ops import mxu64_pallas as jpal
from concrete_ntt_tpu.ops import stagesplit as jss
from concrete_ntt_tpu.ops import u32 as ju
from concrete_ntt_tpu_torch.ops import mxu64 as tmx
from concrete_ntt_tpu_torch.ops import mxu64_cuda as tcu
from concrete_ntt_tpu_torch.ops import ntt_dispatch, stagesplit as tss
from concrete_ntt_tpu_torch.ops import u32 as tu
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as lpap

SIZES = [(512, 256), (512, 128), (1024, 256)]
TAGS = ["p50", "p62", "p63", "gl", "p64"]
N_BIG, N_H = 1 << 15, 1 << 14
P3 = PRIMES52[:3]


def _regime_prime(n, tag):
    return {
        "p50": lambda: lpap(2 * n, 1, 0, 1 << 50),
        "p62": lambda: lpap(2 * n, 1, 1 << 61, 1 << 62),
        "p63": lambda: lpap(2 * n, 1, 1 << 62, 1 << 63),
        "gl": lambda: GOLDILOCKS,
        "p64": lambda: lpap(2 * n, 1, 1 << 63, (1 << 64) - 1),
    }[tag]()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 64, p) % p


def _pair(rng, shape):
    """Full-range u64 values as a (lo, hi) pair of numpy uint32 arrays."""
    return tuple(rng.integers(0, 1 << 32, shape, dtype=np.uint32) for _ in range(2))


def _split(v):
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32))


def _join(pair):
    lo, hi = (np.asarray(a).astype(np.uint64) for a in pair)
    return lo | (hi << np.uint64(32))


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _c(pair):
    """numpy uint32 pair -> the port's int64 carriers."""
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in pair)


def _same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32 and tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
    """Every array of the per-block operator set, of each block's table
    dict, of the stage twiddle tables, and of A_inv,b times a scale."""
    p = _regime_prime(n, tag)
    _assert_same(tss._hybrid_ops(n, p, n_h), jss._hybrid_ops(n, p, n_h), "hybrid_ops")
    _assert_same(tss._build_hybrid_ops(n, p, n_h), jss._hybrid_ops(n, p, n_h), "built")
    tdv, jdv = tss._dev64(n, p, n_h), jss._dev64(n, p, n_h)
    assert tdv["l"] == jdv["l"] == (n // n_h).bit_length() - 1
    assert len(tdv["blocks"]) == n // n_h
    _assert_same(tdv["blocks"], jdv["blocks"], "blocks")
    _assert_same(tdv["fwd_tw"], jdv["fwd_tw"], "fwd_tw")
    _assert_same(tdv["inv_tw"], jdv["inv_tw"], "inv_tw")
    assert (tdv["sc"]["p"], tdv["sc"]["mont"], tdv["sc"]["neginv"]) == (
        jdv["sc"]["p"], jdv["sc"]["mont"], jdv["sc"]["neginv"])
    assert tdv["sc"]["mont"] == (p >= 1 << 62)  # Goldilocks takes the Montgomery branch
    assert tuple(int(v) for v in tdv["sc"]["c64"]) == tuple(int(v) for v in jdv["sc"]["c64"])
    s = _scale(n, p)
    _assert_same(tss._scaled_ainv_blocks64(n, p, n_h, s), jss._scaled_ainv_blocks64(n, p, n_h, s))


def test_parent_operators_take_n1(rng):
    """`_build_operators(n, p, n1)` with the hybrid's n1 = 2^l · n1_h equals
    the JAX package's, and its row diagonals slice into the blocks'."""
    n, n_h, p = 1024, 256, _regime_prime(1024, "p62")
    n1h = tmx.four_step_factors(n_h)[0]
    par = tmx._build_operators(n, p, n1=4 * n1h)
    _assert_same(par, jmx._build_operators(n, p, n1=4 * n1h), "parent")
    ops = tss._hybrid_ops(n, p, n_h)
    for b in range(4):
        np.testing.assert_array_equal(ops[f"d{b}"], par["d"][b * n1h:(b + 1) * n1h])
        np.testing.assert_array_equal(ops[f"e{b}"], par["e"][b * n1h:(b + 1) * n1h])
    assert tss.applicable64(1 << 16, p) and jss.applicable64(1 << 16, p)
    assert not tss.applicable64(1 << 14, p) and not tss.applicable64(1 << 16, (1 << 33) - 9)
    assert tss.N_H == jss.N_H == N_H


def test_extract_blocks_rejects_a_wrong_matrix():
    """The factorization proof is live: one corrupted entry of the parent
    column operator makes `_extract_blocks` raise."""
    from concrete_ntt_tpu_torch.golden.ntt import negacyclic_twiddles

    n, n_h, p = 512, 128, _regime_prime(512, "p50")
    n1h = tmx.four_step_factors(n_h)[0]
    par = tmx._build_operators(n, p, n1=4 * n1h)
    Mf, Mi = tss._cross_mats(2, *negacyclic_twiddles(p, n), p)
    assert len(tss._extract_blocks(par["A"], Mf, n1h, p, "fwd", "row")) == 4
    assert len(tss._extract_blocks(par["Ainv"], Mi, n1h, p, "inv", "col")) == 4
    for name, M, side in (("A", Mf, "row"), ("Ainv", Mi, "col")):
        bad = par[name].copy()
        bad[3 * n1h + 1, n1h + 2] = (int(bad[3 * n1h + 1, n1h + 2]) + 1) % p
        with pytest.raises(AssertionError, match="factorization fails at block"):
            tss._extract_blocks(bad, M, n1h, p, "bad", side)


BOUNDARY_PRIMES = [
    (1 << 64) - (1 << 32) + 1,  # gl: c64 = 2^32 - 1, second wrap about 2^-32 on random data
    1125899904679937,           # about 2^50
    (1 << 62) - 57,             # large c64
    (1 << 63) + 29,             # p > 2^63 (c64 = 2^64 - p)
]


@pytest.mark.parametrize("p", BOUNDARY_PRIMES)
def test_rep_safe_add_sub64_boundary_grid(p):
    """`_add_rep64` / `_sub_rep64` on the exhaustive boundary grid: the same
    bit pattern as the JAX functions (the block kernel digit-splits it), and
    the right residue against Python integers."""
    c64i = (1 << 64) % p
    M = (1 << 64) - 1
    boundary = [0, 1, c64i - 1, c64i, c64i + 1, p - 1, p, p + 1,
                M - c64i - 1, M - c64i, M - c64i + 1, M - 1, M]
    boundary = sorted({v & M for v in boundary})
    a = np.array([x for x in boundary for _ in boundary], dtype=np.uint64)
    b = np.array([y for _ in boundary for y in boundary], dtype=np.uint64)
    ta, tb, c64 = _c(_split(a)), _c(_split(b)), tu.const64_like(c64i)
    got_add, got_sub = tss._add_rep64(ta, tb, c64), tss._sub_rep64(ta, tb, c64)
    for g in (*got_add, *got_sub):
        assert g.dtype == torch.int64 and int(g.min()) >= 0 and int(g.max()) < 1 << 32
    jc64 = ju.const64_like(c64i)
    want_add = _join(jss._add_rep64(_j(_split(a)), _j(_split(b)), jc64))
    want_sub = _join(jss._sub_rep64(_j(_split(a)), _j(_split(b)), jc64))
    add, sub = _join([g.numpy() for g in got_add]), _join([g.numpy() for g in got_sub])
    np.testing.assert_array_equal(add, want_add)
    np.testing.assert_array_equal(sub, want_sub)
    for i in range(len(a)):
        assert int(add[i]) % p == (int(a[i]) + int(b[i])) % p
        assert int(sub[i]) % p == (int(a[i]) - int(b[i])) % p


@pytest.mark.parametrize("tag", ["p50", "p62", "p63", "gl", "p64"])
def test_one_stage_matches_jax(rng, tag):
    """`_stage_fwd64` on full-range u64 inputs and `_stage_inv64` on
    canonical inputs, stages 0 and 1, in the shoup and mont branches."""
    n, n_h, b = 1024, 256, 3
    p = _regime_prime(n, tag)
    tdv, jdv = tss._dev64(n, p, n_h), jss._dev64(n, p, n_h)
    x = _pair(rng, (b, n))
    canon = _split(rng.integers(0, 1 << 64, (b, n), dtype=np.uint64) % np.uint64(p))
    for s in range(2):
        got = tss._stage_fwd64(_c(x), tdv["fwd_tw"][s], tdv["sc"])
        want = jss._stage_fwd64(_j(x), jdv["fwd_tw"][s], jdv["sc"])
        np.testing.assert_array_equal(_join([g.numpy() for g in got]), _join(want))
        got = tss._stage_inv64(_c(canon), tdv["inv_tw"][s], tdv["sc"])
        want = jss._stage_inv64(_j(canon), jdv["inv_tw"][s], jdv["sc"])
        out = _join([g.numpy() for g in got])
        np.testing.assert_array_equal(out, _join(want))
        assert int(out.max()) < p  # canonical out


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n,n_h", SIZES)
def test_hybrid_matches_jax_and_direct(rng, n, n_h, tag):
    """fwd64, inv64 and inv64 with n^-1 · 2^64 folded in: the JAX hybrid's
    bits, and the port's direct four-step's, on any-u64 operands."""
    p = _regime_prime(n, tag)
    x = _pair(rng, (2, n))
    _same(tss.fwd64(_t(x), n=n, p=p, n_h=n_h), jss.fwd64(_j(x), n=n, p=p, n_h=n_h))
    _same(tss.fwd64(_t(x), n=n, p=p, n_h=n_h), tmx.fwd(_t(x), n=n, p=p))
    for s in (1, _scale(n, p)):
        got = tss.inv64(_t(x), n=n, p=p, scale=s, n_h=n_h)
        _same(got, jss.inv64(_j(x), n=n, p=p, scale=s, n_h=n_h))
        _same(got, tmx.inv(_t(x), n=n, p=p, scale=s))


def test_hybrid_roundtrip_is_n_times_x(rng):
    n, n_h = 1024, 256
    p = _regime_prime(n, "p50")
    x = rng.integers(0, p, (2, n), dtype=np.uint64)
    y = tss.inv64(tss.fwd64(_t(_split(x)), n=n, p=p, n_h=n_h), n=n, p=p, n_h=n_h)
    want = (x.astype(object) * n % p).astype(np.uint64)
    np.testing.assert_array_equal(_join([a.numpy() for a in y]), want)


@pytest.fixture(scope="module")
def p50_big():
    return _regime_prime(N_BIG, "p50")


def test_k5h_plain_matches_pallas_interpret_per_block(rng, interpret, p50_big):
    """The plain twin of K5 with block tables (all blocks of [B, 2^15] at
    once) against the JAX kernel `mxu64_pallas.fwd / inv(hyb=(n, i))` run
    per block in interpret mode, and the engines built on it."""
    p, b = p50_big, 2
    x = _pair(rng, (b, N_BIG))
    s = _scale(N_BIG, p)
    before = dict(tcu.LAUNCHES)
    got_f = tcu.fwd_hyb(_t(x), n=N_BIG, p=p, n_h=N_H)
    got_i = tcu.inv_hyb(_t(x), n=N_BIG, p=p, n_h=N_H, scale=s)
    for i in range(N_BIG // N_H):
        blk = tuple(a[:, i * N_H:(i + 1) * N_H] for a in x)
        _same(tuple(g[:, i * N_H:(i + 1) * N_H] for g in got_f),
              jpal.fwd(_j(blk), n=N_H, p=p, hyb=(N_BIG, i)))
        _same(tuple(g[:, i * N_H:(i + 1) * N_H] for g in got_i),
              jpal.inv(_j(blk), n=N_H, p=p, scale=s, hyb=(N_BIG, i)))
    # the engines: the kernel tier and the plain tier agree with the JAX
    # Pallas tier and with the direct four-step at 2^15
    fused = tss.engine64_fused.fwd(_t(x), n=N_BIG, p=p)
    _same(fused, jss.fwd64_fused(_j(x), n=N_BIG, p=p))
    _same(fused, tss.engine64_xla.fwd(_t(x), n=N_BIG, p=p))
    _same(fused, tcu.fwd(_t(x), n=N_BIG, p=p))
    fused = tss.engine64_fused.inv(_t(x), n=N_BIG, p=p, scale=s)
    _same(fused, jss.inv64_fused(_j(x), n=N_BIG, p=p, scale=s))
    _same(fused, tcu.inv(_t(x), n=N_BIG, p=p, scale=s))
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize("b", [2, 3])
def test_k7b_k7c_plain_match_pallas_interpret(rng, interpret, b):
    """The direct entries (no block tables) at n = 2^11."""
    n = 1 << 11
    x = _pair(rng, (3, b, n))
    _same(tcu.fwd_multi_perchannel64(*_t(x), P3), jpal.fwd_multi_perchannel64(*_j(x), P3))
    for scales in ((1, 1, 1), tuple(_scale(n, p) for p in P3)):
        _same(tcu.inv_multi(*_t(x), P3, scales), jpal.inv_multi(*_j(x), P3, scales))
    want = [tcu.fwd((torch.from_numpy(x[0][c]), torch.from_numpy(x[1][c])), n=n, p=p)
            for c, p in enumerate(P3)]
    got = tcu.fwd_multi_perchannel64(*_t(x), P3)
    for c in range(3):
        assert torch.equal(got[0][c], want[c][0]) and torch.equal(got[1][c], want[c][1])


def _full_range_operands(rng, b, n):
    fl, fr = _pair(rng, (3, b, n)), _pair(rng, (3, b, n))
    for a in (*fl, *fr):
        a[:, 0, :8] = 0xFFFFFFFF  # (2^64 - 1)^2: the REDC sum passes 2^64
    return fl, fr


def test_k7_block_tables_plain_match_pallas_interpret(rng, interpret):
    """K7c, K7b and K7d with block tables at n = 2^15: all blocks at once
    against the JAX kernels with `hyb=(n, i)` per block."""
    b = 2
    fl, fr = _full_range_operands(rng, b, N_BIG)
    scales = tuple(_scale(N_BIG, p) for p in P3)
    got_c = tcu.fwd_multi_perchannel64(*_t(fl), P3, n_h=N_H)
    got_b = tcu.inv_multi(*_t(fl), P3, scales, n_h=N_H)
    got_d = tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales, n_h=N_H)
    for i in range(N_BIG // N_H):
        cut = lambda pair: tuple(np.ascontiguousarray(a[..., i * N_H:(i + 1) * N_H]) for a in pair)
        part = lambda got: tuple(g[..., i * N_H:(i + 1) * N_H] for g in got)
        hyb = (N_BIG, i)
        _same(part(got_c), jpal.fwd_multi_perchannel64(*_j(cut(fl)), P3, hyb=hyb))
        _same(part(got_b), jpal.inv_multi(*_j(cut(fl)), P3, scales, hyb=hyb))
        _same(part(got_d), jpal.pointwise_inv_multi(_j(cut(fl)), _j(cut(fr)), P3, scales, hyb=hyb))


def test_channel_hybrid64_matches_jax_and_direct(rng, interpret):
    """The three channel-grid hybrid functions against the JAX ones
    (interpret mode) and against the direct routes at 2^15."""
    b = 2
    x = _pair(rng, (b, N_BIG))
    assert tss.multi_hybrid_applicable64(N_BIG, P3) and jss.multi_hybrid_applicable64(N_BIG, P3)
    assert not tss.multi_hybrid_applicable64(N_H, P3)
    got = tss.fwd_multi_hybrid64(_t(x), P3, n=N_BIG)
    _same(got, jss.fwd_multi_hybrid64(_j(x), P3, n=N_BIG))
    _same(got, tcu.fwd_multi(_t(x), P3))
    fl, fr = _full_range_operands(rng, b, N_BIG)
    scales = tuple(_scale(N_BIG, p) for p in P3)
    got = tss.pointwise_inv_multi_hybrid64(_t(fl), _t(fr), P3, scales, n=N_BIG)
    _same(got, jss.pointwise_inv_multi_hybrid64(_j(fl), _j(fr), P3, scales, n=N_BIG))
    _same(got, tcu.pointwise_inv_multi(_t(fl), _t(fr), P3, scales))
    got = tss.inv_multi_hybrid64(*_t(fl), P3, scales, n=N_BIG)
    _same(got, jss.inv_multi_hybrid64(*_j(fl), P3, scales, n=N_BIG))
    _same(got, tcu.inv_multi(*_t(fl), P3, scales))


def test_multi_tables64_block_axis():
    """`_multi_tables64(n_h, primes, scales, hyb=n)` stacks the JAX tables of
    each block `hyb=(n, i)` on a block axis where they differ per block and
    keeps one copy of F, G and the scalars."""
    scales = tuple(_scale(N_BIG, p) for p in P3)
    tabs = tmx._multi_tables64(N_H, P3, scales, hyb=N_BIG)
    for i in range(N_BIG // N_H):
        ref = jpal._multi_tables64(N_H, P3, scales, hyb=(N_BIG, i))
        assert (tabs["n1"], tabs["n2"]) == (ref["n1"], ref["n2"])
        np.testing.assert_array_equal(tabs["scalars"], ref["scalars"])
        for direction, per_block in (("fwd", (True, True, False, False)),
                                     ("inv", (False, False, True, True))):
            *mats, diag = tabs[direction]
            *rmats, rdiag = ref[direction]
            for m, r, blocked in zip(mats, rmats, per_block):
                np.testing.assert_array_equal(m[:, i] if blocked else m, r)
            for d, r in zip(diag, rdiag):
                np.testing.assert_array_equal(d[:, i], r)


def test_routes_and_checks(rng):
    """Above 2^15 the single-prime tier is the hybrid and the channel route
    the channel-grid hybrid, on every device alike; the wrappers raise
    outside their range on the CPU as on the card."""
    p62 = _regime_prime(1 << 17, "p62")
    for n in (1 << 16, 1 << 17, 1 << 18):
        for p in (GOLDILOCKS, p62):
            assert ntt_dispatch.tier64(n, p, "cpu") == ntt_dispatch.tier64(n, p, "cuda") == "K5h"
        assert ntt_dispatch.tier64(n, 65537, "cuda") == "stage"  # p <= 2^33: the stage engine
    assert ntt_dispatch.route64(1 << 16, P3) == "K7h"
    assert ntt_dispatch.route64(1 << 16, (GOLDILOCKS, p62)) == "K5h"
    assert ntt_dispatch.route64(1 << 16, (65537,)) is None
    x = _t(_pair(rng, (1, 4096)))
    with pytest.raises(NotImplementedError, match="2\\^11"):
        tcu.fwd_hyb(x, n=4096, p=p62, n_h=1024)
    with pytest.raises(NotImplementedError, match="parent size"):
        tcu.fwd_hyb(x, n=4096, p=p62, n_h=4096)
    with pytest.raises(ValueError, match="n=8192"):
        tcu.inv_hyb(x, n=8192, p=p62, n_h=2048)
    x3 = _t(_pair(rng, (3, 1, 4096)))
    with pytest.raises(NotImplementedError, match="parent size"):
        tcu.inv_multi(*x3, P3, (1, 1, 1), n_h=4096)
    with pytest.raises(ValueError, match="channels"):
        tcu.fwd_multi_perchannel64(*x3, P3[:2])
    with pytest.raises(ValueError, match="scales"):
        tcu.inv_multi(*x3, P3, (1, 1))
    assert set(tcu.LAUNCHES) >= {"fwd64_hyb", "inv64_hyb", "fwd_multi_perchannel64", "inv_multi64",
                                 "fwd_multi_perchannel64_hyb", "inv_multi64_hyb",
                                 "pointwise_inv_multi64_hyb"}
