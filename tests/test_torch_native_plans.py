"""The port's other native plans vs the JAX package, on the CPU.

The eight plan classes beside native64's (native32, native_binary32,
native_binary64 in both tiers; native128, native_binary128 Plan32) get the
same numpy-seeded inputs as their JAX twins, in every input format their
width has, at one size below 2^11 (the per-channel route: explicit split,
each channel's prime plan, the lift) and at n = 2^11 (the channel routes:
the plain twins of K1a / K1b, K7a / K7d / K5). Results must be equal exactly
(tolerance 0), and at n <= 256 equal to the wrapping oracle in Python
integers. On the card the same plans run through the kernels in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import concrete_ntt_tpu as jpkg
import concrete_ntt_tpu_torch as tpkg
from concrete_ntt_tpu_torch.golden.polymul import (
    negacyclic_coefficients_wrapping,
    negacyclic_convolution_wrapping,
)
from concrete_ntt_tpu_torch.ops import butterfly32_cuda, mxu32_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.utils import profiling

# (module, tier, width, channels)
PLANS = [
    ("native32", "Plan32", 32, 3),
    ("native32", "Plan52", 32, 2),
    ("native_binary32", "Plan32", 32, 2),
    ("native_binary32", "Plan52", 32, 1),
    ("native_binary64", "Plan32", 64, 3),
    ("native_binary64", "Plan52", 64, 2),
    ("native128", "Plan32", 128, 10),
    ("native_binary128", "Plan32", 128, 5),
]
IDS = [f"{m}-{t}" for m, t, _, _ in PLANS]
FORMATS = {32: ("u32",), 64: ("np64", "limbs", "planar"), 128: ("py128", "limbs", "planar")}
SIZES = [256, 1 << 11]  # the per-channel route, the channel routes
CASES = [(*plan, fmt) for plan in PLANS for fmt in FORMATS[plan[2]]]
CASE_IDS = [f"{m}-{t}-{fmt}" for m, t, _, _, fmt in CASES]


def _plans(module, tier, n):
    tplan = getattr(getattr(tpkg, module), tier).try_new(n, device="cpu")
    jplan = getattr(getattr(jpkg, module), tier).try_new(n)
    assert tplan is not None and jplan is not None
    return tplan, jplan


def _limbs(rng, width, shape, binary=False):
    """Random values of `width` bits as a uint32 limb array [..., width / 32]
    ({0, 1} values for the binary operand)."""
    nl = width // 32
    if binary:
        out = np.zeros((*shape, nl), dtype=np.uint32)
        out[..., 0] = rng.integers(0, 2, shape, dtype=np.uint32)
        return out
    return rng.integers(0, 1 << 32, (*shape, nl), dtype=np.uint32)


def _ints(limbs):
    """[..., nl] uint32 limbs -> object array of Python ints [...]."""
    out = np.zeros(limbs.shape[:-1], dtype=object)
    for k in range(limbs.shape[-1]):
        out = out + (limbs[..., k].astype(object) << (32 * k))
    return out


def _arg(limbs, fmt, lib):
    """A limb array in the package's input format `fmt`."""
    conv = jnp.asarray if lib == "jax" else (lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    if fmt == "u32":
        return conv(limbs[..., 0])
    if fmt == "np64":
        return limbs[..., 0].astype(np.uint64) | (limbs[..., 1].astype(np.uint64) << np.uint64(32))
    if fmt == "py128":
        return [int(v) for v in _ints(limbs).reshape(-1)]
    if fmt == "planar":
        return tuple(conv(limbs[..., k]) for k in range(limbs.shape[-1]))
    return conv(limbs)


def _out_ints(out, fmt, shape):
    """A result in format `fmt` -> object array of Python ints of `shape`."""
    host = lambda a: np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    if fmt == "py128":
        return np.array(out, dtype=object).reshape(shape)
    if fmt in ("u32", "np64"):
        return host(out).astype(object).reshape(shape)
    limbs = np.stack([host(o) for o in out], axis=-1) if fmt == "planar" else host(out)
    return _ints(limbs).reshape(shape)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("module,tier,width,k,fmt", CASES, ids=CASE_IDS)
def test_polymul_matches_jax(rng, module, tier, width, k, fmt, n):
    tplan, jplan = _plans(module, tier, n)
    lead = () if fmt == "py128" else (2,)  # py128 is one polynomial, a flat list
    lhs = _limbs(rng, width, (*lead, n))
    rhs = _limbs(rng, width, (*lead, n), binary="binary" in module)
    got = tplan.negacyclic_polymul(_arg(lhs, fmt, "torch"), _arg(rhs, fmt, "torch"))
    want = jplan.negacyclic_polymul(_arg(lhs, fmt, "jax"), _arg(rhs, fmt, "jax"))
    if fmt == "planar":
        assert isinstance(got, tuple) and len(got) == width // 32
        assert all(g.dtype == torch.uint32 and tuple(g.shape) == (*lead, n) for g in got)
    elif fmt == "limbs":
        assert got.dtype == torch.uint32 and tuple(got.shape) == (*lead, n, width // 32)
    elif fmt == "u32":
        assert got.dtype == torch.uint32 and tuple(got.shape) == (*lead, n)
    elif fmt == "np64":
        assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    else:
        assert isinstance(got, list) and len(got) == n
    g, w = _out_ints(got, fmt, (*lead, n)), _out_ints(want, fmt, (*lead, n))
    assert (g == w).all()
    a, b = _ints(lhs).reshape(-1, n)[0], _ints(rhs).reshape(-1, n)[0]
    if n <= 256:
        assert list(g.reshape(-1, n)[0]) == negacyclic_convolution_wrapping(a, b, width)
    else:
        ks = (0, 1, n // 3, n - 1)
        assert [g.reshape(-1, n)[0][i] for i in ks] == negacyclic_coefficients_wrapping(
            a, b, ks, width)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("module,tier,width,k", PLANS, ids=IDS)
def test_fwd_fwd_binary_inv_match_jax(rng, module, tier, width, k, n):
    tplan, jplan = _plans(module, tier, n)
    assert tplan.primes == jplan.primes and tplan.width == jplan.width == width
    fmt = "u32" if width == 32 else "limbs"
    x, bits = _limbs(rng, width, (2, n)), _limbs(rng, width, (2, n), binary=True)
    trail = (n,) if tier == "Plan32" else (n, 2)
    for name, v in (("fwd", x), ("fwd_binary", bits)):
        got = getattr(tplan, name)(_arg(v, fmt, "torch"))
        want = np.asarray(getattr(jplan, name)(_arg(v, fmt, "jax")))
        assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape == (k, 2, *trail)
        np.testing.assert_array_equal(got.numpy(), want)
    # the unnormalized inverse of canonical residues, in every output format
    f = np.asarray(jplan.fwd(_arg(x, fmt, "jax")))
    for out_fmt in (None, *(f for f in FORMATS[width] if f != "py128")):
        got_i = tplan.inv(torch.from_numpy(f.copy()), out_format=out_fmt)
        want_i = jplan.inv(jnp.asarray(f), out_format=out_fmt)
        shown = out_fmt or fmt
        assert (_out_ints(got_i, shown, (2, n)) == _out_ints(want_i, shown, (2, n))).all()
    # inv(fwd(x)) == n·x, wrapping
    nx = (_ints(x) * n) & ((1 << width) - 1)
    assert (_out_ints(tplan.inv(tplan.fwd(_arg(x, fmt, "torch"))), fmt, (2, n)) == nx).all()


def test_py128_inverse_of_one_polynomial(rng):
    n = 256
    tplan, jplan = _plans("native128", "Plan32", n)
    vals = [int(v) for v in _ints(_limbs(rng, 128, (n,)))]
    f = tplan.fwd(vals)
    assert tuple(f.shape) == (10, n)
    got = tplan.inv(f, out_format="py128")
    assert got == jplan.inv(jnp.asarray(f.numpy()), out_format="py128")
    assert got == [(v * n) & ((1 << 128) - 1) for v in vals]


@pytest.mark.parametrize("module,tier,width,k", PLANS, ids=IDS)
def test_routes_and_launch_free_cpu(rng, module, tier, width, k):
    """Below 2^11 a plan32 tier has no channel route and still computes; at
    2^11 it takes K1. No CPU call launches a kernel."""
    small, _ = _plans(module, tier, 256)
    big, _ = _plans(module, tier, 1 << 11)
    if tier == "Plan32":
        assert ntt_dispatch.route32(256, small.primes) is None
        assert ntt_dispatch.route32(1 << 11, big.primes) == "K1"
    else:
        assert ntt_dispatch.route64(256, small.primes) is None
        assert ntt_dispatch.route64(1 << 11, big.primes) in ("K7", "K5")
    profiling.reset_launches()
    fmt = "u32" if width == 32 else "limbs"
    x = _arg(_limbs(rng, width, (1, 256)), fmt, "torch")
    small.negacyclic_polymul(x, _arg(_limbs(rng, width, (1, 256), binary=True), fmt, "torch"))
    assert not any(mxu32_cuda.LAUNCHES.values()) and not any(butterfly32_cuda.LAUNCHES.values())


@pytest.mark.parametrize("module,tier,width,k", PLANS, ids=IDS)
def test_accessors_and_defaults(module, tier, width, k):
    tplan, jplan = _plans(module, tier, 64)
    assert [getattr(tplan, f"ntt_{i}")().p for i in range(k)] == list(jplan.primes)
    assert [tplan.ntt(i).p for i in range(k)] == list(tplan.primes)
    assert not hasattr(tplan, f"ntt_{k}")
    import inspect

    default = inspect.signature(tplan.negacyclic_polymul).parameters["rhs_binary"].default
    assert default is ("binary" in module)
    assert getattr(getattr(tpkg, module), tier).try_new(1 << 18, device="cpu") is None


def test_marshalling_errors():
    p128 = tpkg.native128.Plan32.try_new(64, device="cpu")
    p32 = tpkg.native32.Plan32.try_new(64, device="cpu")
    z = torch.zeros((64,), dtype=torch.uint32)
    with pytest.raises(TypeError):
        p32.fwd(torch.zeros((64,), dtype=torch.int32))
    with pytest.raises(TypeError):
        p32.fwd(torch.zeros((32,), dtype=torch.uint32))
    with pytest.raises(TypeError):
        p128.fwd(torch.zeros((64, 2), dtype=torch.uint32))
    with pytest.raises(TypeError):
        p128.fwd((z, z, z, z.to(torch.int32)))
    with pytest.raises(ValueError):
        p128.fwd([1, 2, 3])  # a py128 list must hold n values
    with pytest.raises(ValueError):
        p128.inv(torch.zeros((5, 64), dtype=torch.uint32))
    # the reference has no Plan52 tier at width 128
    assert not hasattr(tpkg.native128, "Plan52") and not hasattr(tpkg.native_binary128, "Plan52")
    import dataclasses

    odd = dataclasses.replace(tpkg.native64.Plan52.try_new(64, device="cpu"), width=128)
    with pytest.raises(NotImplementedError, match="width 128"):
        odd._split((z[None],) * 4)


@pytest.mark.slow
@pytest.mark.parametrize("module,tier,width,k", PLANS, ids=IDS)
def test_polymul_matches_jax_at_main_size(rng, module, tier, width, k):
    n = 1 << 14
    tplan, jplan = _plans(module, tier, n)
    fmt = "u32" if width == 32 else "planar"
    lhs = _limbs(rng, width, (2, n))
    rhs = _limbs(rng, width, (2, n), binary="binary" in module)
    got = tplan.negacyclic_polymul(_arg(lhs, fmt, "torch"), _arg(rhs, fmt, "torch"))
    want = jplan.negacyclic_polymul(_arg(lhs, fmt, "jax"), _arg(rhs, fmt, "jax"))
    assert (_out_ints(got, fmt, (2, n)) == _out_ints(want, fmt, (2, n))).all()


@pytest.mark.parametrize("module,width,n", [
    ("native_binary32", 32, 1 << 16),
    pytest.param("native64", 64, 1 << 17, marks=pytest.mark.slow),  # five primes' tables
    pytest.param("native128", 128, 1 << 16, marks=pytest.mark.slow),  # ten primes' tables
], ids=["native_binary32-2^16", "native64-2^17", "native128-2^16"])
def test_plan32_above_2_15_matches_jax(rng, module, width, n):
    """Above 2^15 the Plan32 tiers keep the channel grid (K1a / K1b, the ten
    30-bit primes with 2^18 | p - 1) on the CPU as on the card: the plain
    twins against the JAX plan, and four coefficients against the oracle."""
    tplan, jplan = _plans(module, "Plan32", n)
    assert tplan.primes == jplan.primes and ntt_dispatch.route32(n, tplan.primes) == "K1"
    fmt = "u32" if width == 32 else "planar"
    lhs = _limbs(rng, width, (1, n))
    rhs = _limbs(rng, width, (1, n), binary="binary" in module)
    before = dict(mxu32_cuda.LAUNCHES)
    got = tplan.negacyclic_polymul(_arg(lhs, fmt, "torch"), _arg(rhs, fmt, "torch"))
    assert mxu32_cuda.LAUNCHES == before  # the CPU route launches nothing
    want = jplan.negacyclic_polymul(_arg(lhs, fmt, "jax"), _arg(rhs, fmt, "jax"))
    g = _out_ints(got, fmt, (1, n))
    assert (g == _out_ints(want, fmt, (1, n))).all()
    ks = (0, 1, n // 3, n - 1)
    assert [g[0][i] for i in ks] == negacyclic_coefficients_wrapping(
        _ints(lhs)[0], _ints(rhs)[0], ks, width)
    f = tplan.fwd(_arg(lhs, fmt, "torch"))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jplan.fwd(_arg(lhs, fmt, "jax"))))
