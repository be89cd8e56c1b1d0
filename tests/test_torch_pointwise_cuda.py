"""The native Plan32 polymul's pointwise Montgomery product as a kernel
(`ops/pointwise_cuda.py`, `csrc/mont32_pointwise.cu`).

On the CPU: the plain twin equals a Python-int model of K1d's REDC
(`csrc/mont32.cuh` mont_mul: the 64-bit sum hi + mulhi(m, p) + carry, one
conditional subtract) on every prime of native64's five and native128's ten
channels, both prime families, over a boundary grid of operands (0, 1,
p - 1, p, 2^30 - 1, 2^31, 2^32 - 1) and random full-range and canonical
ones: congruent to a·b·2^-32 mod p and below 2^32 always, canonical where
a·b < p·2^32. The native64 and native128 Plan32 polymuls stay the golden
products bit for bit, and K1b gives the same bits from the canonical
product as from the unsubtracted one the stage returned before the kernel.
The wrapper's refusals, its constants' layout, its launch counter, and the
dispatcher's route by device.

On the card (marked `cuda`, skipped without one): the kernel against its
plain twin at the two cells' shapes, at C = 1 .. 10 for n = 2^11 .. 2^17
with B = 1 and 3, on full-range operands, on counts that are not a multiple
of 4 and on misaligned bases (the scalar instance); one launch a native64
and a native128 polymul. The file imports no JAX:

    python -m pytest tests/test_torch_pointwise_cuda.py --noconftest -q
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import native64, native128
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping_np
from concrete_ntt_tpu_torch.golden.polymul_u128 import negacyclic_polymul_u128
from concrete_ntt_tpu_torch.ops import cuda_build, mxu32_cuda, ntt_dispatch, pointwise_cuda
from concrete_ntt_tpu_torch.ops.u32 import (
    MASK32, mont_neginv, mulhi_u32, mullo_u32, mulwide_u32, to_i64, to_u32)
from concrete_ntt_tpu_torch.tables import native_channel_primes
from concrete_ntt_tpu_torch.utils import profiling

FAMILIES = {"native64": native_channel_primes(5, 1 << 15),
            "native64-ext": native_channel_primes(5, 1 << 17),
            "native128": native_channel_primes(10, 1 << 15),
            "native128-ext": native_channel_primes(10, 1 << 17)}
KINDS = ("boundary", "full-range", "canonical")


def _model(a: int, b: int, p: int) -> int:
    """mont32.cuh mont_mul on Python ints."""
    ab = a * b
    lo = ab & MASK32
    m = (lo * mont_neginv(p)) & MASK32
    s = (ab >> 32) + ((m * p) >> 32) + (lo != 0)
    assert (ab + m * p) % (1 << 32) == 0 and s == (ab + m * p) >> 32  # the exact REDC value
    return s - p if s >= p else s


def _operands(primes, kind: str, rng) -> tuple:
    """uint32 [C, 1, m] operand pairs of one kind for every channel."""
    if kind == "boundary":
        cols = []
        for p in primes:
            edge = [0, 1, p - 1, p, (1 << 30) - 1, 1 << 31, MASK32]
            cols.append([(x, y) for x in edge for y in edge])
    else:
        top = (lambda p: 1 << 32) if kind == "full-range" else (lambda p: p)
        cols = [list(zip(rng.integers(0, top(p), 512, dtype=np.uint64).tolist(),
                         rng.integers(0, top(p), 512, dtype=np.uint64).tolist()))
                for p in primes]
    a = np.array([[x for x, _ in c] for c in cols], dtype=np.uint32)[:, None, :]
    b = np.array([[y for _, y in c] for c in cols], dtype=np.uint32)[:, None, :]
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_twin_is_k1ds_redc(family, kind):
    primes = FAMILIES[family]
    a, b = _operands(primes, kind, np.random.default_rng(len(family) + len(kind)))
    got = pointwise_cuda.mont_mul32_plain(a, b, primes)
    assert got.dtype == torch.uint32 and got.shape == a.shape
    got_i, a_i, b_i = (to_i64(t).tolist() for t in (got, a, b))
    for c, p in enumerate(primes):
        r2inv = pow(1 << 32, -1, p)
        for x, y, r in zip(a_i[c][0], b_i[c][0], got_i[c][0]):
            assert r == _model(x, y, p), (p, x, y)
            assert r < 1 << 32 and r % p == x * y * r2inv % p, (p, x, y)
            if x * y < p << 32:
                assert r < p, (p, x, y)
    if kind == "canonical":
        assert all(r < p for c, p in enumerate(primes) for r in got_i[c][0])


def test_dispatch_routes_cpu_residues_to_the_plain_twin():
    """`ntt_dispatch.pointwise_mont32` on CPU tensors is the plain twin and
    launches nothing."""
    primes = FAMILIES["native64"]
    a, b = _operands(primes, "full-range", np.random.default_rng(3))
    profiling.reset_launches()
    assert torch.equal(ntt_dispatch.pointwise_mont32(a, b, primes),
                       pointwise_cuda.mont_mul32_plain(a, b, primes))
    assert pointwise_cuda.LAUNCHES == {"pointwise_mont32": 0}


def _u64(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


def _u128(seed: int, batch: int, n: int) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(-(1 << 31), 1 << 31, (batch, n), dtype=torch.int32,
                               generator=gen).view(torch.uint32) for _ in range(4))


@pytest.mark.parametrize("n", [2048, 4096])
def test_native64_plan32_polymul_is_the_golden_product(n):
    plan = native64.Plan32.try_new(n, device="cpu")
    assert ntt_dispatch.route32(n, plan.primes) == "K1"
    rng = np.random.default_rng(n)
    a, b = _u64(rng, (2, n)), _u64(rng, (2, n))
    a[0, :4], b[0, :4] = (1 << 64) - 1, (1 << 64) - 1
    got = plan.negacyclic_polymul(a, b)
    for i in range(2):
        np.testing.assert_array_equal(got[i], negacyclic_convolution_wrapping_np(a[i], b[i]))


@pytest.mark.parametrize("n", [2048, 4096])
def test_native128_plan32_polymul_is_the_golden_product(n):
    plan = native128.Plan32.try_new(n, device="cpu")
    assert ntt_dispatch.route32(n, plan.primes) == "K1"
    lhs, rhs = _u128(n, 2, n), _u128(n + 1, 2, n)
    got = plan.negacyclic_polymul(lhs, rhs)
    want = negacyclic_polymul_u128(lhs, rhs)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def _unsubtracted(fl, fr, primes) -> torch.Tensor:
    """The stage's form before the kernel: hi + mulhi(m, p) + carry mod 2^32,
    in [0, 2p) for canonical operands, no subtract."""
    a, b = to_i64(fl), to_i64(fr)
    pv = torch.tensor(primes, dtype=torch.int64).reshape(-1, 1, 1)
    nv = torch.tensor([mont_neginv(p) for p in primes], dtype=torch.int64).reshape(-1, 1, 1)
    lo, hi = mulwide_u32(a, b)
    m = mullo_u32(lo, nv)
    return to_u32((hi + mulhi_u32(m, pv) + (lo != 0).to(lo.dtype)) & MASK32)


@pytest.mark.parametrize("family,n", [("native64", 2048), ("native128", 2048),
                                      ("native64-ext", 1 << 16)])
def test_k1b_gives_the_same_bits_from_either_representative(family, n):
    """The scaled inverse of the canonical product equals that of the
    unsubtracted [0, 2p) one, so the polymul's output did not change."""
    primes = FAMILIES[family]
    b = 2 if n <= 4096 else 1
    gen = torch.Generator().manual_seed(n + len(primes))
    fl, fr = (torch.stack([torch.randint(0, p, (b, n), generator=gen) for p in primes])
              .to(torch.uint32) for _ in range(2))
    new = pointwise_cuda.mont_mul32_plain(fl, fr, primes)
    old = _unsubtracted(fl, fr, primes)
    assert not torch.equal(new, old) and bool((to_i64(new) < torch.tensor(
        primes).reshape(-1, 1, 1)).all())
    scales = ntt_dispatch._pointwise_scales(n, primes)
    assert torch.equal(mxu32_cuda.inv_multi_plain(new, primes, scales),
                       mxu32_cuda.inv_multi_plain(old, primes, scales))


def _good(shape=(5, 2, 8)) -> torch.Tensor:
    return to_u32(torch.randint(0, 1 << 29, shape, dtype=torch.int64))


P5 = FAMILIES["native64"]


@pytest.mark.parametrize("make,err,match", [
    (lambda: (_good(), _good(), P5), ValueError, "CUDA tensors"),
    (lambda: (to_i64(_good()), _good(), P5), TypeError, "uint32"),
    (lambda: (_good(), _good().view(torch.int32), P5), TypeError, "uint32"),
    (lambda: (_good().numpy(), _good(), P5), TypeError, "uint32"),
    (lambda: (_good((4, 2, 8)), _good((4, 2, 8)), P5), ValueError, "\\[5, B, n\\]"),
    (lambda: (_good((5, 16)), _good((5, 16)), P5), ValueError, "\\[5, B, n\\]"),
    (lambda: (_good(), _good((5, 2, 16)), P5), ValueError, "\\[5, B, n\\]"),
    (lambda: (_good((5, 2, 8, 1)), _good((5, 2, 8, 1)), P5), ValueError, "\\[5, B, n\\]"),
    (lambda: (_good((2, 2, 8)), _good((2, 2, 8)), (4, 5)), ValueError, "odd primes"),
    (lambda: (_good((2, 2, 8)), _good((2, 2, 8)), (3, 1 << 32 | 1)), ValueError, "odd primes"),
    (lambda: (_good((17, 1, 8)), _good((17, 1, 8)), P5 * 3 + P5[:2]), ValueError, "1 to 16"),
    (lambda: (_good((0, 1, 8)), _good((0, 1, 8)), ()), ValueError, "1 to 16"),
], ids=["cpu", "int64", "int32", "numpy", "four-channels", "two-dim", "shapes-differ",
        "four-dim", "even-prime", "above-2^32", "seventeen-channels", "no-channel"])
def test_wrapper_refuses(make, err, match):
    fl, fr, primes = make()
    with pytest.raises(err, match=match):
        pointwise_cuda.mont_mul32(fl, fr, primes)
    if match != "CUDA tensors":  # the plain twin takes the same operands
        with pytest.raises(err, match=match):
            pointwise_cuda.mont_mul32_plain(fl, fr, primes)


def test_constants_layout_matches_the_kernel_struct():
    """Sixteen u32 primes then sixteen u32 -p^-1, 128 bytes: the kernel's
    Mont32Consts; zero past the last channel; one record a primes tuple."""
    assert [f for f, _ in pointwise_cuda.Mont32Consts._fields_] == ["p", "p_neginv"]
    assert ctypes.sizeof(pointwise_cuda.Mont32Consts) == 128
    primes = FAMILIES["native128-ext"]
    c = pointwise_cuda.mont32_constants(primes)
    assert c is pointwise_cuda.mont32_constants(tuple(primes))
    assert list(c.p) == [*primes] + [0] * 6
    assert all((p * q + 1) % (1 << 32) == 0 for p, q in zip(primes, c.p_neginv))
    assert list(c.p_neginv)[10:] == [0] * 6


def test_the_kernel_shares_k1ds_mont_mul():
    """One definition of the device REDC (`csrc/mont32.cuh`), included by
    the GEMM pass header and by the kernel; the kernel is built as a source
    of its own."""
    src = lambda name: open(os.path.join(cuda_build.CSRC, name)).read()
    assert src("mont32.cuh").count("uint32_t mont_mul(") == 1
    for name in ("matmod_pass.cuh", "mont32_pointwise.cu"):
        assert '#include "mont32.cuh"' in src(name) and "uint32_t mont_mul(" not in src(name)
    assert "mont32_pointwise" in cuda_build.SOURCES


def test_launch_counter_is_registered_and_resets():
    assert profiling._counters[pointwise_cuda.__name__][0] is pointwise_cuda.LAUNCHES
    assert "pointwise_mont32" in profiling.launch_counts()
    pointwise_cuda.LAUNCHES["pointwise_mont32"] = 3
    profiling.reset_launches()
    assert pointwise_cuda.LAUNCHES == {"pointwise_mont32": 0}


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _card_words(shape, seed: int, dev) -> torch.Tensor:
    """Full-range uint32 words made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev,
                         dtype=torch.int32).view(torch.uint32)


def _on_card_equal(fl, fr, primes):
    """The kernel against its plain twin on the same operands, one launch."""
    before = pointwise_cuda.LAUNCHES["pointwise_mont32"]
    got = pointwise_cuda.mont_mul32(fl, fr, primes)
    torch.cuda.synchronize()
    assert pointwise_cuda.LAUNCHES["pointwise_mont32"] == before + 1
    assert got.device == fl.device and got.shape == fl.shape and got.dtype == torch.uint32
    assert torch.equal(got.cpu(), pointwise_cuda.mont_mul32_plain(fl.cpu(), fr.cpu(), primes))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", [(f, k) for f in FAMILIES for k in KINDS])
def test_kernel_matches_plain_on_card(cuda_device, family, kind):
    primes = FAMILIES[family]
    a, b = _operands(primes, kind, np.random.default_rng(len(family) + len(kind)))
    got = _on_card_equal(a.to(cuda_device), b.to(cuda_device), primes)
    assert torch.equal(got.cpu(), pointwise_cuda.mont_mul32_plain(a, b, primes))


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,n", [(5, 256, 1 << 14), (10, 64, 1 << 16)],
                         ids=["native64-cell", "native128-cell"])
def test_kernel_matches_plain_at_the_cells_shapes_on_card(cuda_device, c, b, n):
    primes = native_channel_primes(c, n)
    fl, fr = _card_words((c, b, n), n + c, cuda_device), _card_words((c, b, n), n - c, cuda_device)
    _on_card_equal(fl, fr, primes)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << k for k in range(11, 18)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c", range(1, 11))
def test_kernel_matches_plain_at_plan_shapes_on_card(cuda_device, c, b, n):
    primes = native_channel_primes(c, n)
    fl, fr = _card_words((c, b, n), c * n + b, cuda_device), _card_words((c, b, n), c + n,
                                                                          cuda_device)
    _on_card_equal(fl, fr, primes)


@pytest.mark.cuda
@pytest.mark.parametrize("count,offset", [(6, 0), (7, 0), (1021, 0), (8, 1), (4096, 3), (2, 0)])
def test_scalar_instance_on_card(cuda_device, count, offset):
    """Counts that are not a multiple of 4, and operands that start 4 or 12
    bytes past a 16-byte boundary, take the scalar instance."""
    primes = FAMILIES["native64"]
    flat_l = _card_words((5 * count + offset,), count, cuda_device)
    flat_r = _card_words((5 * count + offset,), count + 1, cuda_device)
    fl, fr = (t[offset:].view(5, 1, count) for t in (flat_l, flat_r))
    assert fl.is_contiguous() and (fl.data_ptr() % 16 != 0) == (offset != 0)
    _on_card_equal(fl, fr, primes)


@pytest.mark.cuda
def test_kernel_refuses_strided_operands_on_card(cuda_device):
    primes = FAMILIES["native64"]
    fl = _card_words((5, 2, 16), 1, cuda_device)
    before = dict(pointwise_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        pointwise_cuda.mont_mul32(fl[:, :, ::2], fl[:, :, ::2], primes)
    with pytest.raises(ValueError, match="on cuda:0 and cpu"):
        pointwise_cuda.mont_mul32(fl, fl.cpu(), primes)
    assert pointwise_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("module", [native64, native128], ids=["native64", "native128"])
def test_plan32_polymul_launches_the_product_once_on_card(cuda_device, module):
    """A native64 / native128 Plan32 polymul on the card launches the
    product once, 5 / 6 launches in all, and gives the CPU plain path's
    bits."""
    n = 1 << 12
    plan = module.Plan32.try_new(n, device="cuda")
    if module is native64:  # numpy operands go to the plan's device
        rng = np.random.default_rng(5)
        a, b = _u64(rng, (4, n)), _u64(rng, (4, n))
        card_a, card_b = a, b
    else:  # planar tensors compute where they lie
        a, b = _u128(5, 4, n), _u128(6, 4, n)
        card_a, card_b = (tuple(t.to(cuda_device) for t in x) for x in (a, b))
    profiling.reset_launches()
    got = plan.negacyclic_polymul(card_a, card_b)
    counts = {k: v for k, v in profiling.launch_counts().items() if v}
    assert counts["pointwise_mont32"] == 1
    assert sum(counts.values()) == (5 if module is native64 else 6), counts
    want = module.Plan32.try_new(n, device="cpu").negacyclic_polymul(a, b)
    if module is native64:
        np.testing.assert_array_equal(got, want)
    else:
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want, strict=True))
