"""The prime32 butterflies, stage engine and butterfly kernel K4 of the port
(ops/butterflies32.py, ops/engine.py, ops/butterfly32_cuda.py) vs the JAX
package.

Each butterfly is held against the JAX one on edge values of its regime
(0, 1, p - 1, p, 2p - 1, 4p - 1 where it fits in u32, 2^32 - 1); the stage
engine against the JAX engine; K4's plain twin (the route of a CPU tensor)
against the JAX Pallas kernel `pallas32.try_fwd/try_inv` in interpret mode,
the fixture of tests/test_pallas_interpret.py. The kernel itself runs in
tests/test_torch_cuda.py; here a model of its schedule (`_k4_model`: the
column stages of a cluster, the exchange into the blocks' slices, the
rounds of 2, 3 or 4 stages in registers, with the kernel's index and
twiddle arithmetic) is held against the stage engine and the JAX package in
every regime, at every cluster size a block size allows, and its
shared-memory swizzle against the banks. Tolerance: exact equality
(modular integers).
"""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu import prime32 as jp32
from concrete_ntt_tpu.ops import butterflies32 as jbf
from concrete_ntt_tpu.ops import engine as jeng
from concrete_ntt_tpu.ops import pallas32 as jpal32
from concrete_ntt_tpu_torch import prime32 as tp32
from concrete_ntt_tpu_torch.ops import butterflies32 as tbf
from concrete_ntt_tpu_torch.ops import butterfly32_cuda as tcu4
from concrete_ntt_tpu_torch.ops import engine as teng
from concrete_ntt_tpu_torch.ops import mxu32_cuda
from concrete_ntt_tpu_torch.ops import ntt_dispatch
from concrete_ntt_tpu_torch.ops.u32 import mont_neginv, to_i64, to_u32
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

REGIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
MAKERS = {
    ("fwd", "lt30"): "make_fwd_lt30",
    ("inv", "lt30"): "make_inv_lt30",
    ("fwd", "lt31"): "make_fwd_lt31",
    ("inv", "lt31"): "make_inv_lt31",
    ("fwd", "generic"): "make_fwd_generic32",
    ("inv", "generic"): "make_inv_generic32",
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _edges(p: int) -> np.ndarray:
    vals = {0, 1, p - 1, p, 2 * p - 1, 4 * p - 1, (1 << 32) - 1}
    return np.array(sorted(v for v in vals if v < (1 << 32)), dtype=np.uint32)


def _make(module, direction, variant, p):
    fn = getattr(module, MAKERS[(direction, variant)])
    return fn(p, mont_neginv(p)) if variant == "generic" else fn(p)


def _twiddles(rng, p, variant):
    """A few twiddles (edge ones included) and their companion tables."""
    w = np.array([1, 2, p - 1, *rng.integers(0, p, 5)], dtype=np.uint64)
    if variant == "generic":
        return ((w << np.uint64(32)) % np.uint64(p)).astype(np.uint32), None
    return w.astype(np.uint32), ((w << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


@pytest.mark.parametrize("last", [False, True], ids=["stage", "last"])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_butterfly_matches_jax_on_edges(rng, variant, direction, last):
    p = REGIMES[variant]
    e = _edges(p)
    w, ws = _twiddles(rng, p, variant)
    grid = np.array(list(itertools.product(range(len(e)), range(len(e)), range(len(w)))))
    x0, x1, wi = e[grid[:, 0]], e[grid[:, 1]], grid[:, 2]
    wparts = (w[wi],) if ws is None else (w[wi], ws[wi])
    jb = _make(jbf, direction, variant, p)[int(last)]
    tb = _make(tbf, direction, variant, p)[int(last)]
    (jy0,), (jy1,) = jb((jnp.asarray(x0),), (jnp.asarray(x1),), tuple(map(jnp.asarray, wparts)))
    t = lambda a: to_i64(torch.from_numpy(a))
    (ty0,), (ty1,) = tb((t(x0),), (t(x1),), tuple(t(a) for a in wparts))
    np.testing.assert_array_equal(to_u32(ty0).numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(to_u32(ty1).numpy(), np.asarray(jy1))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_stage_engine_matches_jax(rng, variant, direction):
    """A sub-range of stages (the sharded seam) and the whole transform."""
    p, n = REGIMES[variant], 64
    tbl = jp32._tables(n, p)
    names = ("twid",) if variant == "generic" else ("twid", "twid_shoup")
    if direction == "inv":
        names = tuple("inv_" + k for k in names)
    x = rng.integers(0, p, (3, n), dtype=np.uint32)
    jb = _make(jbf, direction, variant, p)
    tb = _make(tbf, direction, variant, p)
    jrun = jeng.fwd_stages if direction == "fwd" else jeng.inv_stages
    trun = teng.fwd_stages if direction == "fwd" else teng.inv_stages
    jtw = tuple(jnp.asarray(tbl[k]) for k in names)
    ttw = tuple(to_i64(torch.from_numpy(tbl[k])) for k in names)
    span = {"first_stage": 2, "last_stage": 5} if direction == "fwd" else {
        "first_stage": 5, "last_stage": 2}
    for kw in ({}, span):
        want = jrun((jnp.asarray(x),), jtw, *jb, **kw)[0]
        got = trun((to_i64(torch.from_numpy(x)),), ttw, *tb, **kw)[0]
        np.testing.assert_array_equal(to_u32(got).numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_k4_plain_matches_pallas_interpret(rng, interpret, variant, n):
    p = REGIMES[variant]
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    kw = dict(p=p, variant=variant, p_neginv=tplan.p_neginv)
    x = rng.integers(0, p, (9, n), dtype=np.uint32)  # 9: not a multiple of the TPU's 8 rows
    for t_fn, j_fn in ((tcu4.try_fwd, jpal32.try_fwd), (tcu4.try_inv, jpal32.try_inv)):
        want = j_fn(jnp.asarray(x), jplan._tbl, **kw)
        assert want is not None
        got = t_fn(torch.from_numpy(x), tplan._tbl, **kw)
        assert got.dtype == torch.uint32 and got.shape == (9, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k4_plain_serves_below_the_tpu_floor(rng):
    """n < 256 (the TPU kernel's floor) and p < 2^26: the plain twin is the
    stage engine, equal to the JAX XLA path."""
    p = 67043329
    for n in (2, 8, 128):
        tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
        x = rng.integers(0, p, (5, n), dtype=np.uint32)
        kw = dict(p=p, variant="lt30", p_neginv=tplan.p_neginv)
        got = tcu4.try_fwd(torch.from_numpy(x), tplan._tbl, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jplan.fwd(x)))
        got = tcu4.try_inv(torch.from_numpy(x), tplan._tbl, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jplan.inv(x)))


def test_k4_routes_by_device_and_range(rng):
    p, n = REGIMES["lt31"], 256
    plan = tp32.Plan.new(n, p, device="cpu")
    kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
    x = torch.from_numpy(rng.integers(0, p, (2, n), dtype=np.uint32))
    with pytest.raises(ValueError, match="no route"):
        tcu4.try_fwd(x.to("meta"), plan._tbl, **kw)
    with pytest.raises(TypeError):
        tcu4.try_fwd(x.to(torch.int64), plan._tbl, **kw)
    with pytest.raises(NotImplementedError, match="stage engine"):  # tier32's route there
        tcu4.check_range(1 << 18, "lt31")
    tcu4.check_range(2, "generic")
    tcu4.check_range(1 << 15, "lt30")
    tcu4.check_range(1 << 17, "lt30")  # a cluster of blocks a polynomial
    before = dict(tcu4.LAUNCHES)
    tcu4.try_fwd(x, plan._tbl, **kw)
    assert tcu4.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize(
    "n,p,cpu,cuda",
    [
        (1 << 14, REGIMES["lt30"], "K2", "K2"),
        (1 << 15, REGIMES["generic"], "K2", "K2"),
        (4096, REGIMES["lt31"], "K2", "K2"),
        (2048, REGIMES["generic"], "K2", "K2"),
        (1024, REGIMES["lt30"], "K4", "K4"),
        (1 << 14, 67043329, "K4", "K4"),
        (1 << 16, REGIMES["lt30"], "K2", "K2"),
        (1 << 17, REGIMES["generic"], "K2", "K2"),
        (1 << 16, 67043329, "K4", "K4"),
        (1 << 17, _lp(1 << 18, 1, 0, 1 << 26), "K4", "K4"),
        (1 << 18, REGIMES["lt30"], "stage", "stage"),
        (1 << 18, _lp(1 << 19, 1, 0, 1 << 26), "stage", "stage"),
    ],
)
def test_tier_choice(n, p, cpu, cuda):
    """K2 for 2^11 <= n <= 2^17 (p >= 2^26; the TPU's two-pass tier below
    2^14 is K2 here), else K4 up to 2^17 (where the reference's kernel stops
    at 2^15 and its XLA stage engine takes over) and the stage engine above
    it (K4 itself raises there on the card): the CPU and the card take the
    same tier at every row."""
    variant = tp32._variant(p)
    # the tier is a function of (n, p) alone: no device enters the decision
    assert list(inspect.signature(ntt_dispatch.tier32).parameters) == ["n", "p", "variant"]
    assert ntt_dispatch.tier32(n, p, variant) == cpu == cuda
    if cuda == "K2":
        mxu32_cuda.check_single_range(n, p)
    elif n > tcu4.MAX_N:
        with pytest.raises(NotImplementedError, match="K4"):
            tcu4.check_range(n, variant)


# ---------------------------------------------------------------------------
# A model of K4's schedule (csrc/butterfly32.cu)
# ---------------------------------------------------------------------------

RADIX_LOGS = (2, 3)  # stages a round of the kernel runs in registers (it takes up to 3)


def _run_stages(v, s0, hb, mult, k, bfs, tw, fwd, last_s):
    """run_stages: stages s0 .. s0 + k - 1 on v [blocks, 2^k, groups] (value
    u of a group along axis 1), twiddle (mult << s) + (hb << a) + blk."""
    bf, last_bf = bfs
    for aa in range(k):
        a = aa if fwd else k - 1 - aa
        s, h = s0 + a, (1 << k) >> (a + 1)
        for blk in range(1 << a):
            idx = (mult << s) + (hb << a) + blk
            w = tuple(t[idx] for t in tw)
            for j in range(h):
                u0, u1 = 2 * h * blk + j, 2 * h * blk + j + h
                (y0,), (y1,) = (last_bf if s == last_s else bf)((v[:, u0],), (v[:, u1],), w)
                v[:, u0], v[:, u1] = y0, y1


def _segment_stages(buf, log2l, mult, bfs, tw, fwd, last_s, radix_log):
    """segment_stages: every local stage of the segments of 2^log2l values
    of buf [blocks, e], in the kernel's rounds (at most radix_log stages, as
    even as they split; the inverse mirrored); mult [blocks, 1]."""
    e = buf.shape[1]
    rounds = -(-log2l // radix_log)
    done = 0
    for i in range(rounds):
        k = -(-(log2l - done) // (rounds - i))
        s0 = done if fwd else log2l - done - k
        log_s = log2l - s0 - k
        gi = torch.arange(e >> k)
        hi = gi >> log_s
        base = (hi << (log_s + k)) | (gi & ((1 << log_s) - 1))
        idx = base[None, :] + (torch.arange(1 << k) << log_s)[:, None]  # [2^k, groups]
        v = buf[:, idx]
        _run_stages(v, s0, hi & ((1 << s0) - 1), mult, k, bfs, tw, fwd, last_s)
        buf[:, idx] = v
        done += k


def _k4_model(x, tbl, *, p, variant, direction, c, radix_log):
    """K4's schedule in torch on a CPU tensor [B, n]: c = 1, a block of
    1024 / n whole polynomials (zeros past the batch) or one; c > 1, the
    cluster of c blocks of a polynomial: forward, block r's columns
    r * n/c^2 + jj (value k at k * n/c + column) through the first log2 c
    stages in registers, value k into block k's slice at the column, then
    the slice's stages with twiddle multiplier c + r; inverse, the mirror."""
    b, n = x.shape
    fwd = direction == "fwd"
    bfs = tbf.make(p, variant, mont_neginv(p), direction)
    tw = tuple(to_i64(torch.from_numpy(a)) for a in tcu4._twiddles(tbl, variant, direction))
    log2n, log2c = n.bit_length() - 1, c.bit_length() - 1
    xi = to_i64(x)
    if c == 1:
        ppb = max(1, 1024 // n)
        blocks = -(-b // ppb)
        buf = torch.zeros(blocks * ppb, n, dtype=torch.int64)
        buf[:b] = xi
        buf = buf.reshape(blocks, ppb * n)
        ones = torch.ones(blocks, 1, dtype=torch.int64)
        _segment_stages(buf, log2n, ones, bfs, tw, fwd, log2n - 1 if fwd else 0, radix_log)
        return to_u32(buf.reshape(-1, n)[:b])
    log2l = log2n - log2c
    log2w = log2l - log2c
    mult = (c + torch.arange(c, dtype=torch.int64)).repeat(b)[:, None]  # block b * c + r
    rows = torch.arange(b)[:, None, None]
    ks = (torch.arange(c) << log2l)[None, :, None]
    zero = torch.zeros(1, dtype=torch.int64)
    one = torch.ones(b, 1, dtype=torch.int64)
    if fwd:
        buf = torch.zeros(b, c, 1 << log2l, dtype=torch.int64)  # block r of polynomial b: [b, r]
        for r in range(c):
            col = (r << log2w) + torch.arange(1 << log2w)
            v = xi[rows, ks + col[None, None, :]]  # [b, value k, column]
            _run_stages(v, 0, zero, one, log2c, bfs, tw, True, -1)
            buf[:, :, col] = v  # value k into block k's slice
        buf = buf.reshape(b * c, -1)
        _segment_stages(buf, log2l, mult, bfs, tw, True, log2l - 1, radix_log)
        return to_u32(buf.reshape(b, n))
    buf = xi.reshape(b * c, -1).clone()
    _segment_stages(buf, log2l, mult, bfs, tw, False, -1, radix_log)
    buf = buf.reshape(b, c, -1)
    out = torch.empty(b, n, dtype=torch.int64)
    for r in range(c):
        col = (r << log2w) + torch.arange(1 << log2w)
        v = buf[:, :, col]  # value k from block k's slice
        _run_stages(v, 0, zero, one, log2c, bfs, tw, False, 0)
        out[rows, ks + col[None, None, :]] = v
    return to_u32(out)


def _clusters(n):
    """Every cluster size the kernel takes at n: n / c between 2^8 and 2^15
    values a block (c = 1 up to 2^15, whole polynomials below 2^10)."""
    return [c for c in (1, 2, 4, 8)
            if (c == 1 and n <= 1 << 15) or (c > 1 and 1 << 8 <= n // c <= 1 << 15)]


@pytest.mark.parametrize("n", [2, 32, 1024, 2048, 4096, 1 << 14, 1 << 15])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_k4_schedule_model_matches_the_stage_engine(rng, variant, n):
    """Every cluster size the kernel takes at n, both directions, any u32
    input (the lazy ranges' wrap included); below 2^14 a batch of 3 (ragged
    against the 1024 / n polynomials a block below 1024) and rounds of up to
    2 and 3 stages, from 2^14 one polynomial and the kernel's rounds
    (`radix_log`)."""
    p = REGIMES[variant]
    tbl = tp32._tables(n, p)
    big = n >= 1 << 14
    x = torch.from_numpy(rng.integers(0, 1 << 32, (1 if big else 3, n), dtype=np.uint32))
    kw = dict(p=p, variant=variant, p_neginv=mont_neginv(p))
    want = {"fwd": tcu4.fwd_plain(x, tbl, **kw), "inv": tcu4.inv_plain(x, tbl, **kw)}
    for c in _clusters(n):
        logs = (tcu4.radix_log(n // c if c > 1 else max(n, 1024)),) if big else RADIX_LOGS
        for direction, w in want.items():
            for radix_log in logs:
                got = _k4_model(x, tbl, p=p, variant=variant, direction=direction, c=c,
                                radix_log=radix_log)
                np.testing.assert_array_equal(got.numpy(), w.numpy(),
                                              err_msg=f"{direction} c={c} radix 2^{radix_log}")


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_k4_schedule_model_matches_pallas_interpret(rng, interpret, variant, n):
    """The model at the kernel's cluster size and rounds for B = 16 (4 and 8
    blocks a polynomial, rounds of 2 stages) against the JAX Pallas kernel
    in interpret mode."""
    p = REGIMES[variant]
    jplan = jp32.Plan.new(n, p)
    x = rng.integers(0, p, (9, n), dtype=np.uint32)
    c = tcu4.cluster_size(n, 16)
    assert c == (4 if n == 1024 else 8)
    for direction, j_fn in (("fwd", jpal32.try_fwd), ("inv", jpal32.try_inv)):
        want = j_fn(jnp.asarray(x), jplan._tbl, p=p, variant=variant, p_neginv=jplan.p_neginv)
        got = _k4_model(torch.from_numpy(x), tp32._tables(n, p), p=p, variant=variant,
                        direction=direction, c=c, radix_log=tcu4.radix_log(n // c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=direction)


@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
def test_k4_schedule_model_above_2_15_matches_jax_plan(rng, n):
    """Where K4 newly serves a prime below 2^26 (above 2^15, clusters of 2
    to 8 blocks), B = 1, against the JAX plan (its XLA stage engine)."""
    p = _lp(1 << 18, 1, 0, 1 << 26)
    jplan = jp32.Plan.new(n, p)
    x = rng.integers(0, p, (1, n), dtype=np.uint32)
    want = {"fwd": np.asarray(jplan.fwd(x)), "inv": np.asarray(jplan.inv(x))}
    for c in _clusters(n):
        for direction, w in want.items():
            got = _k4_model(torch.from_numpy(x), tp32._tables(n, p), p=p, variant="lt30",
                            direction=direction, c=c, radix_log=tcu4.radix_log(n // c))
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{direction} c={c}")


def test_k4_cluster_size():
    """B * c reaches the card's 132 SMs where the block size allows: c = 8
    at B = 16 from 2^11 up, fewer blocks for large batches, never a block of
    more than 2^15 values or (in a cluster) fewer than 2^8; rounds of two
    stages up to 1024 values a block, three above."""
    assert [tcu4.cluster_size(n, 16) for n in (256, 512, 1024, 2048, 1 << 14, 1 << 17)] == [
        1, 2, 4, 8, 8, 8]
    assert [tcu4.radix_log(e) for e in (256, 1024, 2048, 1 << 15)] == [2, 2, 3, 3]
    assert tcu4.cluster_size(1 << 14, 132) == 1 and tcu4.cluster_size(1 << 14, 40) == 4
    assert tcu4.cluster_size(1 << 14, 80) == 2 and tcu4.cluster_size(512, 9) == 2
    assert tcu4.cluster_size(1 << 17, 1000) == 4 and tcu4.cluster_size(1 << 16, 1000) == 2
    for n in (1 << k for k in range(1, 18)):
        for b in (1, 9, 16, 33, 132, 1000):
            c = tcu4.cluster_size(n, b)
            assert c in _clusters(n) and (c == 8 or b * c >= 132 or c == max(_clusters(n)))


def test_k4_shared_memory_swizzle_spreads_rounds_over_banks():
    """The kernel's word of value i is i ^ ((i >> 3) & 31) (`swz`): a
    permutation of each 256 words; in every round the split gives (log2 of a
    block's values 1 .. 15, rounds of up to 2 or 3 stages), 32
    consecutive groups (values 2^log_s apart) read each value with at most
    two lanes on a bank, and 32 consecutive values (the copies in and out)
    on 32 banks; without it 8 values in a row would put 8 lanes on a bank."""
    swz = lambda i: i ^ ((i >> 3) & 31)  # noqa: E731
    assert sorted(swz(np.arange(1 << 15))) == list(range(1 << 15))
    gi = np.arange(32)
    worst = lambda words: np.bincount(words % 32, minlength=32).max()  # noqa: E731
    rounds = set()
    for rl in RADIX_LOGS:
        for log2l in range(1, 16):
            n_rounds, done = -(-log2l // rl), 0
            for i in range(n_rounds):
                k = -(-(log2l - done) // (n_rounds - i))
                rounds.add((log2l - done - k, k))  # (log_s, k) of the forward round at s0 = done
                done += k
    for log_s, k in sorted(rounds):
        base = ((gi >> log_s) << (log_s + k)) | (gi & ((1 << log_s) - 1))
        for u in range(1 << k):
            assert worst(swz(base + (u << log_s))) <= 2, (log_s, k, u)
    assert worst(8 * gi) == 8 and worst(swz(8 * gi)) <= 2
    assert all(worst(swz(gi + o)) == 1 for o in (0, 32, 4096))
