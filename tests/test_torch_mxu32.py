"""K1a-K1d, K2 and K3 of the port (ops/mxu32_cuda.py, ops/mxu32.py) vs the
JAX package.

On the CPU the wrappers run their plain torch twins. These are held against
the JAX Pallas kernels run in interpret mode (the fixture of
tests/test_pallas_interpret.py): the channel-grid kernels (K1), the
whole-transform kernel `mxu32_pallas.fwd/fwd_wide/inv` (K2, whose entries
`passes_engine` also names at mid sizes) and the pass kernel `pass_matmod`
(K3); and against the
single-channel XLA engine. The packed-plane layout the CUDA kernel reads is
checked by a numpy dp4a emulation, with four and five matrix digit planes;
the kernels themselves run in tests/test_torch_cuda.py. The four-limb
(u128) operand of K1a, K2's `fwd_wide` and K3's A pass has its own cases,
with the accumulator proof at its widest contraction. Tolerance: exact
equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import mxu32_pallas as jpal
from concrete_ntt_tpu_torch.ops import cuda_build
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.ops.u32 import mont_neginv
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.tables import NATIVE128_PRIMES as PRIMES10
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64

N_BIG = 1 << 14
BENCH = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("case", ["fwd1", "fwd2", "inv", "inv_scaled"])
def test_multi_plain_matches_pallas_interpret(rng, interpret, case, b):
    if case.startswith("fwd"):
        limbs = tuple(_u32(rng, (b, N_BIG)) for _ in range(int(case[-1])))
        got = tcu.fwd_wide_multi(tuple(map(torch.from_numpy, limbs)), PRIMES)
        want = jpal.fwd_wide_multi(tuple(map(jnp.asarray, limbs)), PRIMES)
    else:
        x = _u32(rng, (len(PRIMES), b, N_BIG))
        scales = tuple(
            _scale(N_BIG, p) if case == "inv_scaled" else 1 for p in PRIMES
        )
        got = tcu.inv_multi(torch.from_numpy(x), PRIMES, scales)
        want = jpal.inv_multi(jnp.asarray(x), PRIMES, scales)
    assert got.dtype == torch.uint32 and got.shape == (len(PRIMES), b, N_BIG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _redc_overflows(a, b, p):
    """Where hi + mulhi(m, p) + carry of REDC(a*b) passes 2^32 (numpy)."""
    ab = a.astype(np.uint64) * b.astype(np.uint64)
    lo = ab & np.uint64(0xFFFFFFFF)
    m = (lo * np.uint64(mont_neginv(p))) & np.uint64(0xFFFFFFFF)
    t = (ab >> np.uint64(32)) + ((m * np.uint64(p)) >> np.uint64(32)) + (lo != 0)
    return t >= np.uint64(1 << 32)


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("case", ["perchannel1", "perchannel2", "pointwise"])
def test_k1c_k1d_plain_matches_pallas_interpret(rng, interpret, case, b):
    """K1c (1 and 2 limbs) and K1d's plain twins against the JAX Pallas
    kernels in interpret mode, two channels at n = 2^14. K1d gets
    full-range u32 operands, among them pairs whose REDC sum overflows u32
    (the overflow `_sc_mont_mul` tracks and the masked stacked sum drops)."""
    primes = PRIMES[:2]
    t = torch.from_numpy
    if case.startswith("perchannel"):
        xs = tuple(_u32(rng, (2, b, N_BIG)) for _ in range(int(case[-1])))
        if len(xs) == 1:
            got = tcu.fwd_multi_perchannel(t(xs[0]), primes)
            want = jpal.fwd_multi_perchannel(jnp.asarray(xs[0]), primes)
        else:
            got = tcu.fwd_wide_multi_perchannel(*map(t, xs), primes)
            want = jpal.fwd_wide_multi_perchannel(*map(jnp.asarray, xs), primes)
    else:
        fl, fr = _u32(rng, (2, b, N_BIG)), _u32(rng, (2, b, N_BIG))
        fl[:, 0, :8] = fr[:, 0, :8] = 0xFFFFFFFF
        assert all(_redc_overflows(fl[c], fr[c], p).any() for c, p in enumerate(primes))
        scales = tuple(_scale(N_BIG, p) for p in primes)
        got = tcu.pointwise_inv_multi(t(fl), t(fr), primes, scales)
        want = jpal.pointwise_inv_multi(jnp.asarray(fl), jnp.asarray(fr), primes, scales)
    assert got.dtype == torch.uint32 and got.shape == (2, b, N_BIG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k1c_k1d_wrappers_check_operands(rng):
    primes = PRIMES[:2]
    x = torch.from_numpy(_u32(rng, (2, 3, 2048)))
    with pytest.raises(ValueError, match="channels"):
        tcu.fwd_multi_perchannel(x[:1], primes)
    with pytest.raises(ValueError, match="no route"):
        tcu.pointwise_inv_multi(x.to("meta"), x.to("meta"), primes, (1, 1))
    with pytest.raises(ValueError, match="scales"):
        tcu.pointwise_inv_multi(x, x, primes, (1,))
    with pytest.raises(ValueError, match="one shape"):
        tcu.fwd_wide_multi_perchannel(x, x[:, :2], primes)
    with pytest.raises(NotImplementedError, match="powers of two in \\[2\\^11, 2\\^17\\]"):
        tcu.fwd_multi_perchannel(x[..., :1024], primes)
    before = dict(tcu.LAUNCHES)
    tcu.fwd_multi_perchannel(x, primes)
    tcu.pointwise_inv_multi(x, x, primes, (1, 1))
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


def _prime(n, lo, hi):
    return largest_prime_in_arithmetic_progression64(2 * n, 1, lo, hi)


@pytest.mark.parametrize(
    "p",
    [PRIMES[2], _prime(2048, 1 << 30, 1 << 31), _prime(2048, 1 << 31, (1 << 32) - 1)],
    ids=["lt30", "lt31", "generic"],
)
@pytest.mark.parametrize("case", ["fwd1", "fwd2", "inv", "inv_scaled"])
def test_single_channel_plain_matches_xla(rng, case, p):
    n = 2048
    if case.startswith("fwd"):
        limbs = tuple(_u32(rng, (3, n)) for _ in range(int(case[-1])))
        if len(limbs) == 1:
            got = tmx.fwd(torch.from_numpy(limbs[0]), n=n, p=p)
            want = jmx.fwd(jnp.asarray(limbs[0]), n=n, p=p)
        else:
            got = tmx.fwd_wide(tuple(map(torch.from_numpy, limbs)), n=n, p=p)
            want = jmx.fwd_wide(tuple(map(jnp.asarray, limbs)), n=n, p=p)
    else:
        x = _u32(rng, (3, n))
        s = _scale(n, p) if case == "inv_scaled" else 1
        got = tmx.inv(torch.from_numpy(x), n=n, p=p, scale=s)
        want = jmx.inv(jnp.asarray(x), n=n, p=p, scale=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_limbs", [1, 2, 4])
def test_packed_planes_dp4a_emulation(rng, n_limbs):
    """The packed plane words the kernel reads, contracted four digits per
    dp4a against (v ^ 0x80808080), equal the int8 digit-plane product."""
    n = 2048
    tabs = tcu._multi_tables(n, PRIMES, n_limbs, (1,) * len(PRIMES))
    planes = tabs["fwd"][0]  # [C, 4*L*n1, 4*n1]
    n1 = tabs["n1"]
    words = tcu.pack_planes(planes, n1)
    assert words.shape == (len(PRIMES), n_limbs * n1, 4 * n1) and words.dtype == np.int32
    x = _u32(rng, (7, n_limbs * n1))  # rows of limb-major operand values
    xb = (x ^ np.uint32(0x80808080)).view(np.int8).reshape(7, n_limbs * n1, 4)
    wb = words.view(np.int8).reshape(len(PRIMES), n_limbs * n1, 4 * n1, 4)
    dp4a = np.einsum("rke,ckoe->cro", xb.astype(np.int64), wb.astype(np.int64))
    digits = tmx._digit_cat(
        tuple(torch.from_numpy(x[:, l * n1:(l + 1) * n1].astype(np.int64)) for l in range(n_limbs))
    )
    for c in range(len(PRIMES)):
        ref = torch._int_mm(digits, torch.from_numpy(planes[c])).numpy()
        np.testing.assert_array_equal(dp4a[c], ref)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "_BUILD", str(tmp_path / "kernels"))
    monkeypatch.setattr(cuda_build, "_NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("mxu32_multi")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcu._lib()
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_wrappers_route_by_device_and_range(rng):
    x = torch.from_numpy(_u32(rng, (2, 2048)))
    with pytest.raises(ValueError, match="no route"):
        tcu.fwd_wide_multi((x.to("meta"),), PRIMES)
    with pytest.raises(ValueError, match="no route"):
        tcu.inv_multi(torch.stack([x] * len(PRIMES)).to("meta"), PRIMES, (1,) * len(PRIMES))
    with pytest.raises(TypeError):
        tcu.fwd_wide_multi((x.to(torch.int64),), PRIMES)
    small = torch.from_numpy(_u32(rng, (2, 1024)))
    with pytest.raises(NotImplementedError, match="powers of two in \\[2\\^11, 2\\^17\\]"):
        tcu.fwd_wide_multi((small,), PRIMES)
    with pytest.raises(NotImplementedError, match="3 operand limbs"):
        tcu.fwd_wide_multi((x, x, x), PRIMES)
    tcu._check_n_limbs(2048, 4, "kernels")  # a u128 operand is served
    assert tcu.fwd_wide_multi((x, x, x, x), PRIMES).shape == (len(PRIMES), 2, 2048)
    with pytest.raises(NotImplementedError, match="30-bit channel primes"):
        tcu.fwd_wide_multi((x,), (4293918721,))
    before = dict(tcu.LAUNCHES)
    tcu.fwd_wide_multi((x,), PRIMES)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("regime", list(BENCH))
def test_pass_matmod_plain_matches_pallas_interpret(rng, interpret, regime, n):
    """K3's plain twin: every `which`, scaled and canonical, 2 limbs, a
    row slice with rank-local diagonal rows."""
    p, b = BENCH[regime], 3
    tbl = jmx._mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d, e = tbl["d"], tbl["e"]
    sc = _scale(n, p)
    cases = [
        ("A", (b, n2, n1), 1, d, 1), ("A", (b, n2, n1), 2, d, 1),
        ("F", (b, n1, n2), 1, (), 1), ("G", (b, n1, n2), 1, e, 1),
        ("Ainv", (b, n2, n1), 1, (), 1), ("Ainv", (b, n2, n1), 1, (), sc),
        ("A", (b, n2 // 4, n1), 1, tuple(a[n2 // 2: n2 // 2 + n2 // 4] for a in d), 1),
    ]
    for which, shape, nl, dg, s in cases:
        xs = tuple(_u32(rng, shape) for _ in range(nl))
        kw = dict(n=n, p=p, which=which, n_limbs=nl, scale=s)
        got = tcu.pass_matmod(tuple(map(torch.from_numpy, xs)) if nl > 1 else torch.from_numpy(xs[0]),
                              diag_slices=dg, **kw)
        want = jpal.pass_matmod(tuple(map(jnp.asarray, xs)) if nl > 1 else jnp.asarray(xs[0]),
                                diag_slices=tuple(map(jnp.asarray, dg)), **kw)
        assert got.dtype == torch.uint32 and got.shape == shape, which
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{which} {nl} {s}")
        assert len(dg) in (0, 2 if regime == "generic" else 4)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("regime", list(BENCH))
def test_passes_engine_plain_matches_pallas_interpret(rng, interpret, regime, n):
    p, b = BENCH[regime], 3
    x, x2 = _u32(rng, (b, n)), _u32(rng, (b, n))
    eng, jeng = tcu.passes_engine, jpal.passes_engine
    t = torch.from_numpy
    pairs = [
        (eng.fwd(t(x), n=n, p=p), jeng.fwd(jnp.asarray(x), n=n, p=p)),
        (eng.fwd_wide((t(x), t(x2)), n=n, p=p),
         jeng.fwd_wide((jnp.asarray(x), jnp.asarray(x2)), n=n, p=p)),
        (eng.inv(t(x), n=n, p=p), jeng.inv(jnp.asarray(x), n=n, p=p)),
        (eng.inv(t(x), n=n, p=p, scale=_scale(n, p)),
         jeng.inv(jnp.asarray(x), n=n, p=p, scale=_scale(n, p))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"case {i}")


@pytest.mark.parametrize("regime", list(BENCH))
@pytest.mark.parametrize("case", ["fwd", "fwd_wide", "inv_scaled"])
def test_k2_plain_matches_pallas_interpret(rng, interpret, case, regime):
    """K2's plain twin against the JAX whole-transform kernel in interpret
    mode, at n = 2^14, B = 2, in the three regimes."""
    p, b = BENCH[regime], 2
    xs = tuple(_u32(rng, (b, N_BIG)) for _ in range(2))
    t = torch.from_numpy
    if case == "fwd":
        got = tcu.fwd(t(xs[0]), n=N_BIG, p=p)
        want = jpal.fwd(jnp.asarray(xs[0]), n=N_BIG, p=p)
    elif case == "fwd_wide":
        got = tcu.fwd_wide(tuple(map(t, xs)), n=N_BIG, p=p)
        want = jpal.fwd_wide(tuple(map(jnp.asarray, xs)), n=N_BIG, p=p)
    else:
        s = _scale(N_BIG, p)
        got = tcu.inv(t(xs[0]), n=N_BIG, p=p, scale=s)
        want = jpal.inv(jnp.asarray(xs[0]), n=N_BIG, p=p, scale=s)
    assert got.dtype == torch.uint32 and got.shape == (b, N_BIG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tile_words(tiles: np.ndarray, n_d: int) -> np.ndarray:
    """The plane words [k, n_d * o] of `pack_planes` from the K-major tiles
    [o / 32, k / 32, n_d * 32 * 32] of `pack_planes_kmajor` (digit, 8-row
    group, 16-byte chunk, row, word)."""
    n_ot, nk = tiles.shape[:2]
    w = tiles.reshape(n_ot, nk, n_d, 4, 8, 8, 4).transpose(1, 4, 6, 2, 0, 3, 5)
    return w.reshape(nk * 32, n_d * n_ot * 32)


@pytest.mark.parametrize("regime", ["lt31", "generic"])
def test_packed_planes_dp4a_emulation_single(rng, regime):
    """The K2/K3 plane words (five digit planes for 4293918721) contracted
    by a numpy dp4a equal the int8 digit-plane product."""
    p, n = BENCH[regime], 2048
    tabs = tcu._pass_tables(n, p, "F", 1, 1, "cpu")
    planes, _ = tmx._mxu_tables(n, p)["F"]
    k, o, n_d = tabs["k"], tabs["o"], tabs["n_d"]
    assert n_d == (5 if regime == "generic" else 4)
    tiles = tabs["planes"].numpy()  # the K-major tiles of pack_planes_kmajor
    assert tiles.shape == (1, o // 32, k // 32, n_d * 32 * 32) and tiles.dtype == np.int32
    words = _tile_words(tiles[0], n_d)
    assert words.shape == (k, n_d * o)
    x = _u32(rng, (5, k))
    xb = (x ^ np.uint32(0x80808080)).view(np.int8).reshape(5, k, 4)
    wb = np.ascontiguousarray(words).view(np.int8).reshape(k, n_d * o, 4)
    dp4a = np.einsum("rke,koe->ro", xb.astype(np.int64), wb.astype(np.int64))
    ref = torch._int_mm(tmx._digit_cat(torch.from_numpy(x.astype(np.int64))),
                        torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(dp4a, ref)


def test_single_wrappers_check_shapes(rng):
    p, n = BENCH["lt31"], 2048
    x = torch.from_numpy(_u32(rng, (2, n)))
    with pytest.raises(ValueError, match="n=4096"):
        tcu.fwd(x, n=4096, p=p)
    with pytest.raises(ValueError, match="no route"):
        tcu.inv(x.to("meta"), n=n, p=p)
    with pytest.raises(ValueError, match="which"):
        tcu.pass_matmod(x.reshape(2, 32, 64), n=n, p=p, which="B")
    with pytest.raises(ValueError, match="n_limbs"):
        tcu.pass_matmod(x.reshape(2, 32, 64), n=n, p=p, which="A", n_limbs=2)
    with pytest.raises(NotImplementedError, match="powers of two in \\[2\\^11, 2\\^17\\]"):
        tcu.fwd(torch.from_numpy(_u32(rng, (2, 1024))), n=1024, p=p)
    eng = tcu.passes_engine
    assert (eng.fwd, eng.fwd_wide, eng.inv) == (tcu.fwd, tcu.fwd_wide, tcu.inv)
    before = dict(tcu.LAUNCHES)
    tcu.passes_engine.fwd(x, n=n, p=p)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


# -- the u128 operand: four limbs, 16 operand digit planes ----------------------


@pytest.mark.parametrize("channels", [10, 5])
def test_k1a_u128_plain_matches_pallas_interpret(rng, interpret, channels):
    """K1a's plain twin with four limbs over the native128 (10) and
    native_binary128 (5) channel sets at n = 2^11, full-range u128 operands,
    against the JAX Pallas kernel in interpret mode and against the
    single-channel XLA engine."""
    n, b, primes = 2048, 3, PRIMES10[:channels]
    limbs = tuple(_u32(rng, (b, n)) for _ in range(4))
    limbs[3][0, :4] = limbs[2][0, :4] = limbs[1][0, :4] = limbs[0][0, :4] = 0xFFFFFFFF
    before = dict(tcu.LAUNCHES)
    got = tcu.fwd_wide_multi(tuple(map(torch.from_numpy, limbs)), primes)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing
    assert got.dtype == torch.uint32 and got.shape == (channels, b, n)
    want = jpal.fwd_wide_multi(tuple(map(jnp.asarray, limbs)), primes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for c in (0, channels - 1):
        xla = jmx.fwd_wide(tuple(map(jnp.asarray, limbs)), n=n, p=primes[c])
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(xla))


@pytest.mark.parametrize("regime", list(BENCH))
def test_k2_k3_u128_plain_matches_pallas_interpret(rng, interpret, regime):
    """K2 `fwd_wide` and K3 `which="A"` with four limbs in the three bench
    primes at n = 2^11, against the JAX kernels in interpret mode and
    `mxu32.fwd_wide`."""
    p, n, b = BENCH[regime], 2048, 2
    t = torch.from_numpy
    limbs = tuple(_u32(rng, (b, n)) for _ in range(4))
    got = tcu.fwd_wide(tuple(map(t, limbs)), n=n, p=p)
    want = jpal.passes_engine.fwd_wide(tuple(map(jnp.asarray, limbs)), n=n, p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xla = jmx.fwd_wide(tuple(map(jnp.asarray, limbs)), n=n, p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), tmx.fwd_wide(tuple(map(t, limbs)), n=n, p=p).numpy())
    tbl = jmx._mxu_tables(n, p)
    xs = tuple(_u32(rng, (b, tbl["n2"], tbl["n1"])) for _ in range(4))
    kw = dict(n=n, p=p, which="A", n_limbs=4)
    got = tcu.pass_matmod(tuple(map(t, xs)), diag_slices=tbl["d"], **kw)
    want = jpal.pass_matmod(tuple(map(jnp.asarray, xs)),
                            diag_slices=tuple(map(jnp.asarray, tbl["d"])), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="3 operand limbs"):
        tcu.pass_matmod(tuple(map(t, xs[:3])), n=n, p=p, which="A", n_limbs=3)


@pytest.mark.parametrize("n,primes", [
    (1 << 11, PRIMES10), (1 << 14, PRIMES10), (1 << 15, (PRIMES10[0], PRIMES10[9])),
    pytest.param(1 << 15, PRIMES10, marks=pytest.mark.slow),  # 6 s of operators a prime
], ids=["2048", "16384", "32768-two", "32768-all"])
def test_accumulator_exact_with_four_limbs(n, primes):
    """The int8 accumulators stay exact at the widest contraction, 16 operand
    planes x n1 (2048 of the 4096 the proof allows), for the ten channel
    primes: `_wide_col_planes` asserts it at the build, and the proof is run
    again here on what it returned; the planes equal the JAX package's."""
    n1, _ = tmx.four_step_factors(n)
    for p in primes:
        planes, cvec = tmx._wide_col_planes(n, p, 4)
        assert planes.shape == (16 * n1, 4 * n1) and 16 * n1 <= 4096
        tmx.assert_accumulator_exact(planes, cvec)
    jplanes, jcvec = jmx._wide_col_planes(n, PRIMES10[-1], 4)
    np.testing.assert_array_equal(planes, jplanes)
    np.testing.assert_array_equal(cvec, jcvec)
    bad = np.full((1 << 14, planes.shape[1]), 127, dtype=np.int8)  # past the edge
    with pytest.raises(AssertionError, match="may wrap"):
        tmx.assert_accumulator_exact(bad, cvec)


# -- n = 2^16 and 2^17: the C++ operator build, the proof's edge, K2 plain, K1e ----

# the three prime32 regimes with 2^18 | p - 1: NTT primes up to n = 2^17
BIG = {
    "lt30": largest_prime_in_arithmetic_progression64(1 << 18, 1, 1 << 29, 1 << 30),
    "lt31": largest_prime_in_arithmetic_progression64(1 << 18, 1, 1 << 30, 1 << 31),
    "generic": largest_prime_in_arithmetic_progression64(1 << 18, 1, 1 << 31, 1 << 32),
}
N16 = 1 << 16


def _same_ops(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("regime", list(BIG))
@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_cpp_operators_match_numpy_build(n, regime):
    """The six operators from the C++ build (what the package uses) are the
    numpy stage engine's (the JAX package's own build) bit for bit, so the
    table cache's format is unchanged."""
    p = BIG[regime]
    _same_ops(tmx._build_operators(n, p), tmx._build_operators_numpy(n, p))


def test_operators_and_k2_plain_match_jax_at_2_16(rng):
    """At n = 2^16 (n1 = n2 = 256): the C++-built operators equal the JAX
    package's, and K2's plain twin (fwd, fwd_wide with four limbs: the 4096
    contraction, inv scaled) equals the JAX XLA engine on any-u32 operands."""
    p, b = BIG["lt31"], 2
    assert tmx.applicable(N16, p, "lt31") and tmx.four_step_factors(N16) == (256, 256)
    _same_ops(tmx._build_operators(N16, p), jmx._operators(N16, p))
    t = torch.from_numpy
    limbs = tuple(_u32(rng, (b, N16)) for _ in range(4))
    before = dict(tcu.LAUNCHES)
    got = tcu.fwd(t(limbs[0]), n=N16, p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmx.fwd(jnp.asarray(limbs[0]), n=N16, p=p)))
    got = tcu.fwd_wide(tuple(map(t, limbs)), n=N16, p=p)
    want = jmx.fwd_wide(tuple(map(jnp.asarray, limbs)), n=N16, p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = _scale(N16, p)
    got = tcu.inv(t(limbs[1]), n=N16, p=p, scale=s)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmx.inv(jnp.asarray(limbs[1]), n=N16, p=p, scale=s)))
    assert tcu.LAUNCHES == before  # the CPU route launches nothing


def _edge_primes():
    from concrete_ntt_tpu_torch.tables import primes32_ext

    return tuple(primes32_ext()) + tuple(BIG.values())


@pytest.mark.parametrize("n,which", [
    (N16, slice(None)), (1 << 17, slice(0, 13, 4)),
    pytest.param(1 << 17, slice(None), marks=pytest.mark.slow),  # 5 s of operators a prime
], ids=["65536-all", "131072-four", "131072-all"])
def test_accumulator_exact_at_the_proof_edge(n, which):
    """n1 = 256 with the four limbs of a u128 operand is the widest
    contraction the int32 accumulators are proven for, 16 x 256 = 4096 rows:
    the build's assertion holds for the ten channel primes of the sizes above
    2^15 and for the three regime primes with 2^18 | p - 1, and the proof is
    run again here on the planes it returned."""
    primes = _edge_primes()
    assert len(primes) == 13
    for p in primes[which]:
        assert tmx.applicable(n, p, "generic" if p >= 1 << 31 else "lt31")
        planes, cvec = tmx._wide_col_planes(n, p, 4)
        assert planes.shape[0] == 4096 and planes.dtype == np.int8
        tmx.assert_accumulator_exact(planes, cvec)
        tmx._operators.cache_clear(), tmx._wide_col_planes.cache_clear()  # 4 MiB a prime


def test_ranges_reach_2_17():
    from concrete_ntt_tpu_torch.tables import primes32_ext

    assert (tcu.MIN_N, tcu.MAX_N) == (1 << 11, 1 << 17)
    ext = primes32_ext()
    for n in (N16, 1 << 17):
        tcu.check_range(n, ext, 4)
        tcu.check_single_range(n, BIG["generic"], 4)
    with pytest.raises(NotImplementedError, match="2\\^17"):
        tcu.check_range(1 << 18, ext)
    with pytest.raises(NotImplementedError, match="K4"):
        tcu.check_single_range(N16, 67043329)


@pytest.mark.parametrize("n,b", [(2048, 5), (N_BIG, 2)])
def test_k1e_presplit_plain_matches_pallas_interpret(rng, interpret, n, b):
    """`digit_planes32` gives the JAX function's int8 planes, and K1e's plain
    twin on them the bits of the JAX presplit kernel (interpret mode) and of
    K1b on the values themselves."""
    primes = PRIMES[:3]
    scales = tuple(_scale(n, p) for p in primes)
    x = _u32(rng, (3, b, n))
    x[:, 0, :4] = (0, 0x80, 0xFFFFFFFF, 0x7F7F7F7F)
    xd = tcu.digit_planes32(torch.from_numpy(x))
    n1, n2 = tmx.four_step_factors(n)
    assert xd.dtype == torch.int8 and tuple(xd.shape) == (3, b, n1, 4 * n2)
    jd = jpal.digit_planes32(jnp.asarray(x))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tcu._planes_to_u32(xd).numpy(), x)
    before = dict(tcu.LAUNCHES)
    got = tcu.inv_multi_presplit(xd, primes, scales)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing
    assert got.dtype == torch.uint32 and tuple(got.shape) == (3, b, n)
    np.testing.assert_array_equal(got.numpy(), tcu.inv_multi(torch.from_numpy(x), primes, scales).numpy())
    if n == N_BIG:  # the size the JAX channel grid serves
        want = jpal.inv_multi_presplit(jd, primes, scales)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="int8"):
        tcu.inv_multi_presplit(torch.from_numpy(x), primes, scales)
    with pytest.raises(ValueError, match="four-step"):
        tcu.inv_multi_presplit(xd.reshape(3, b, n1 // 2, 8 * n2), primes, scales)


def test_k1e_plane_pointer_checks(rng):
    """K1e's kernel copies its planes in 16-byte chunks: the pointer check
    of its wrapper (`_ptrs16`, on the card's path) refuses a plane tensor
    that is not contiguous or starts off a 16-byte boundary and names it,
    so a sliced operand raises instead of being misread."""
    x = torch.from_numpy(_u32(rng, (2, 3, 2048)))
    xd = tcu.digit_planes32(x)
    assert xd.is_contiguous() and xd.data_ptr() % 16 == 0
    tcu._ptrs16(xd, names="xd")
    with pytest.raises(ValueError, match="contiguous"):
        tcu._ptrs16(xd[..., :64], names="xd")
    buf = torch.empty(xd.numel() + 1, dtype=torch.int8)
    off = buf[1:].view(xd.shape)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="xd must start on a 16-byte boundary"):
        tcu._ptrs16(off, names="xd")


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_k2h_launch_tables_follow_the_codes(direction):
    """K2 with block tables packs its tables for the outputs of the codes
    `k2h_tiles` picks, in launch order, and the cache keys on them: the
    per-block and the shared pass's planes have one tile per 16, 32 or 64
    outputs as the code says (n = 2^14, n_h = 2^13, two blocks)."""
    n, n_h, p = 1 << 14, 1 << 13, PRIMES[0]
    for tiles in ((1, 1), (0, 3), (2, 0)):
        outs = tuple(tcu.TILES[t][1] for t in tiles)
        t = tcu._hyb_tables(n, p, n_h, 1, direction, "cpu", outs)
        o_blk, o_sh = outs if direction == "fwd" else outs[::-1]
        n1, n2 = tmx.four_step_factors(n_h)
        assert t["planes_blk"].shape[:2] == (n // n_h, n1 // o_blk)
        assert t["planes_sh"].shape[:2] == (1, n2 // o_sh)
    assert tcu.k2h_tiles(1, n, n_h, direction) == (1, 1)
