"""The native64 Plan32 lift kernel (`ops/crt_cuda.py`, `csrc/crt_lift.cu`).

On the CPU: the wrapper's plain twin equals the int64 chain of
`ops/crt.py` rec_u64_from5 bit for bit, and so does a Python-int model of
the kernel's arithmetic on the constants the wrapper hands it, both also
against the value the reference's digit rule gives, for both prime families
(n <= 2^15 and the 2^18 | p - 1 family above): random residues, the sign
edge (top digit P34 // 2 and P34 // 2 + 1), the hairline just above M / 2
where the digit rule and the explicit CRT part, and residues 0 and p - 1.
The wrapper's refusals, its launch counter, and the plans: `native64.Plan32`
lifts through it, to the bits of the plain chain; the other native families
but native128 (whose kernels tests/test_torch_crt128_cuda.py holds) and the
sharded route's `_reconstruct` keep the chain.

On the card (marked `cuda`, skipped without one): the kernel against its
plain twin on the same cases, on counts that are not a multiple of 4 and on
a misaligned base (the scalar instance), at B = 1, 3, 16 for n = 2^11 ...
2^17, and at the north-star cell's (256, 2^14). The file imports no JAX:

    python -m pytest tests/test_torch_crt_cuda.py --noconftest -q
"""

import ctypes

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import native32, native64, native_binary64, native_binary128
from concrete_ntt_tpu_torch._native_common import NativePlanBase
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping_np
from concrete_ntt_tpu_torch.ops import crt, crt_cuda
from concrete_ntt_tpu_torch.ops.u32 import to_i64, to_u32
from concrete_ntt_tpu_torch.tables import native_channel_primes
from concrete_ntt_tpu_torch.utils import profiling

MASK32, MASK64 = (1 << 32) - 1, (1 << 64) - 1
FAMILIES = {"n<=2^15": native_channel_primes(5, 1 << 15),
            "n>2^15": native_channel_primes(5, 1 << 17)}
KINDS = ("random", "sign_edge", "hairline", "zero_and_pmax")


def _moduli(primes):
    p0, p1, p2, p3, p4 = primes
    m = p0 * p1 * p2 * p3 * p4
    return m, p0 * p1 * p2, p3 * p4  # M, the prefix below the top digit, P34


def _crt(res, primes) -> int:
    """The value in [0, M) with residues `res`."""
    m = _moduli(primes)[0]
    return sum(r * (m // p) * pow(m // p, -1, p) for r, p in zip(res, primes)) % m


def _values(primes, kind, rng) -> list:
    """Values in [0, M) of one kind (Python ints)."""
    m, prefix, p34 = _moduli(primes)
    if kind == "random":
        return [int.from_bytes(rng.bytes(24), "little") % m for _ in range(1021)]
    if kind == "sign_edge":  # the top digit on both sides of the rule, and its ends
        tops = [p34 // 2, p34 // 2 + 1, 0, p34 - 1]
        return [tops[i % 4] * prefix + int.from_bytes(rng.bytes(16), "little") % prefix
                for i in range(64)] + [t * prefix + low for t in tops for low in (0, prefix - 1)]
    if kind == "hairline":  # above M / 2, positive by the digit rule
        top = prefix * (p34 // 2 + 1) - 1  # its last value
        return [m // 2 + 1, m // 2 + 2, top - 1, top] + [
            m // 2 + 1 + int.from_bytes(rng.bytes(16), "little") % (top - m // 2) for _ in range(60)]
    # every channel 0 or p - 1 (all 32 combinations), and one channel p - 1
    combos = [[(p - 1) * ((mask >> i) & 1) for i, p in enumerate(primes)] for mask in range(32)]
    combos += [[(p - 1) if i == j else 0 for i, p in enumerate(primes)] for j in range(5)]
    return [_crt(c, primes) for c in combos]


def _residues(values, primes) -> torch.Tensor:
    """uint32 [5, 1, len(values)] residues of the values."""
    cols = np.array([[v % p for v in values] for p in primes], dtype=np.uint32)
    return torch.from_numpy(cols).reshape(5, 1, len(values))


def _want(values, primes) -> list:
    """The reference's signed lift: negative where the top Garner digit
    exceeds P34 / 2, as u64."""
    m, prefix, p34 = _moduli(primes)
    return [(v - m if v // prefix > p34 // 2 else v) & MASK64 for v in values]


def _ints(lo, hi) -> list:
    lo, hi = (t.cpu().numpy().astype(np.uint64).ravel() for t in (lo, hi))
    return [int(a) | int(b) << 32 for a, b in zip(lo, hi)]


def _chain(residues, primes) -> tuple:
    mods = to_i64(residues)
    lo, hi = crt.rec_u64_from5([mods[i] for i in range(5)], primes)
    return to_u32(lo), to_u32(hi)


def _kernel_model(ms, c) -> int:
    """csrc/crt_lift.cu lift1 on Python ints: every u32 / u64 wrap of the
    kernel, on the constants the wrapper passes it."""
    def shoup32(z, w, w_sh, p):
        t = (z * w - ((z * w_sh) >> 32) * p) & MASK32
        return t - p if t >= p else t

    def shoup64(z, w, w_sh, p):
        t = (z * w - ((z * w_sh) >> 64) * p) & MASK64
        return t - p if t >= p else t

    m0, m1, m2, m3, m4 = ms
    mod12 = shoup32((2 * c.p2 + m2 - m1) & MASK32, c.inv12, c.inv12_sh, c.p2) * c.p1 + m1
    mod34 = shoup32((2 * c.p4 + m4 - m3) & MASK32, c.inv34, c.inv34_sh, c.p4) * c.p3 + m3
    v12 = shoup64((mod12 - m0 + 2 * c.p12) & MASK64, c.c12, c.c12_sh, c.p12)
    partial = m0 + shoup64(v12, c.a34, c.a34_sh, c.p34)
    v34 = shoup64((mod34 - partial + 2 * c.p34) & MASK64, c.c34, c.c34_sh, c.p34)
    pos = (m0 + v12 * c.p0 + v34 * c.k12) & MASK64
    return (pos - c.m) & MASK64 if v34 >= c.half34 else pos


CASES = [(f, k) for f in FAMILIES for k in KINDS]


@pytest.mark.parametrize("family,kind", CASES)
def test_plain_twin_equals_the_chain_and_the_digit_rule(family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(len(kind)))
    res = _residues(values, primes)
    lo, hi = crt_cuda.rec_u64_from5(res, primes)
    assert lo.dtype == hi.dtype == torch.uint32 and lo.shape == hi.shape == (1, len(values))
    clo, chi = _chain(res, primes)
    assert torch.equal(lo, clo) and torch.equal(hi, chi)
    assert _ints(lo, hi) == _want(values, primes)


@pytest.mark.parametrize("family,kind", CASES)
def test_kernel_model_equals_the_chain(family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(1 + len(kind)))
    consts = crt_cuda.lift_constants(primes)
    got = [_kernel_model([v % p for p in primes], consts) for v in values]
    assert got == _ints(*_chain(_residues(values, primes), primes)) == _want(values, primes)


def test_kernel_model_equals_the_chain_on_any_u32_words():
    """Words at or above p (no channel returns them) wrap in the kernel as in
    the chain: the bits agree on any uint32 input."""
    primes = FAMILIES["n<=2^15"]
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (5, 1, 512), dtype=np.uint32)
    words[:, 0, :8] = 0xFFFFFFFF
    res = torch.from_numpy(words)
    consts = crt_cuda.lift_constants(primes)
    got = [_kernel_model([int(words[c, 0, i]) for c in range(5)], consts) for i in range(512)]
    assert got == _ints(*_chain(res, primes)) == _ints(*crt_cuda.rec_u64_from5(res, primes))


def test_constants_layout_matches_the_kernel_struct():
    """Eleven u64 then nine u32 fields, 128 bytes: csrc/crt_lift.cu's
    Lift5Consts; one cached record per primes tuple."""
    fields = [name for name, _ in crt_cuda.Lift5Consts._fields_]
    assert fields[:11] == ["p12", "p34", "c12", "c12_sh", "a34", "a34_sh", "c34", "c34_sh",
                           "half34", "k12", "m"]
    assert fields[11:] == ["p0", "p1", "p2", "p3", "p4", "inv12", "inv12_sh", "inv34", "inv34_sh"]
    assert ctypes.sizeof(crt_cuda.Lift5Consts) == 128
    primes = FAMILIES["n>2^15"]
    assert crt_cuda.lift_constants(primes) is crt_cuda.lift_constants(tuple(primes))
    c = crt_cuda.lift_constants(primes)
    assert (c.p0, c.p1, c.p2, c.p3, c.p4) == primes
    assert c.c12 < c.p12 and c.a34 < c.p34 and c.c34 < c.p34 and c.inv12 < c.p2


@pytest.mark.parametrize("primes", [(3, 5, 7, 11), (2147483659, 3, 5, 7, 11), (4, 5, 7, 11, 13)],
                         ids=["four", "above-2^31", "even"])
def test_lift_constants_refuse_other_primes(primes):
    with pytest.raises(ValueError, match="five odd primes below 2\\^31"):
        crt_cuda.lift_constants(primes)


def _good(shape=(5, 2, 8)) -> torch.Tensor:
    primes = FAMILIES["n<=2^15"]
    vals = torch.randint(0, min(primes), shape, dtype=torch.int64)
    return to_u32(vals)


@pytest.mark.parametrize("bad,err,match", [
    (lambda: to_i64(_good()), TypeError, "uint32"),
    (lambda: _good().view(torch.int32), TypeError, "uint32"),
    (lambda: _good((4, 2, 8)), ValueError, "\\[5, \\.\\.\\., n\\]"),
    (lambda: _good((6, 2, 8)), ValueError, "\\[5, \\.\\.\\., n\\]"),
    (lambda: _good((5,)), ValueError, "\\[5, \\.\\.\\., n\\]"),
    (lambda: _good((5, 8, 2)).transpose(1, 2), ValueError, "contiguous"),
    (lambda: _good((5, 2, 16))[:, :, ::2], ValueError, "contiguous"),
], ids=["int64", "int32", "four-channels", "six-channels", "one-dim", "transposed", "strided"])
def test_wrapper_refuses(bad, err, match):
    with pytest.raises(err, match=match):
        crt_cuda.rec_u64_from5(bad(), FAMILIES["n<=2^15"])


def test_launch_counter_is_registered_and_resets():
    assert profiling._counters[crt_cuda.__name__][0] is crt_cuda.LAUNCHES
    assert list(crt_cuda.LAUNCHES) == ["lift_u64_from5", "lift_u128_digits", "lift_u128_limbs"]
    crt_cuda.LAUNCHES["lift_u64_from5"] = 5
    profiling.reset_launches()
    assert crt_cuda.LAUNCHES == dict.fromkeys(crt_cuda.LAUNCHES, 0)
    crt_cuda.rec_u64_from5(_good(), FAMILIES["n<=2^15"])  # the plain twin: no launch
    assert crt_cuda.LAUNCHES == dict.fromkeys(crt_cuda.LAUNCHES, 0)


def _u64(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_plan32_lifts_through_the_wrapper_to_the_chains_bits(monkeypatch, n):
    """native64.Plan32's polymul and inv call crt_cuda.rec_u64_from5 once
    each, through `_lift_parts`, and return what the base class's plain
    chain returns; the polymul is the wrapping product."""
    plan = native64.Plan32.try_new(n, device="cpu")
    rng = np.random.default_rng(n)
    a, b = _u64(rng, (3, n)), _u64(rng, (3, n))
    calls = []
    real = crt_cuda.rec_u64_from5

    def counted(residues, primes):
        calls.append(tuple(residues.shape))
        return real(residues, primes)

    monkeypatch.setattr(crt_cuda, "rec_u64_from5", counted)
    prod = plan.negacyclic_polymul(a, b)
    ntt = plan.fwd(a)
    back = plan.inv(ntt)
    assert calls == [(5, 3, n), (5, 3, n)]
    for i in range(3):
        np.testing.assert_array_equal(prod[i], negacyclic_convolution_wrapping_np(a[i], b[i]))
    monkeypatch.setattr(native64.Plan32, "_lift_parts", NativePlanBase._lift_parts)
    np.testing.assert_array_equal(plan.negacyclic_polymul(a, b), prod)
    assert torch.equal(plan.inv(ntt), back)
    assert len(calls) == 2


@pytest.mark.parametrize("module,n", [(native32, 2048), (native_binary64, 1024),
                                      (native_binary128, 2048), (native64, 2048)],
                         ids=["native32", "native_binary64", "native_binary128",
                              "native64.Plan52"])
def test_other_families_keep_the_chain(monkeypatch, module, n):
    """No other plan class overrides `_lift_parts` or reaches a lift
    kernel's wrapper (native128.Plan32 lifts through its own kernels:
    tests/test_torch_crt128_cuda.py)."""
    cls = module.Plan52 if module is native64 else module.Plan32
    assert cls._lift_parts is NativePlanBase._lift_parts

    def refuse(*args):
        raise AssertionError("a lift kernel's wrapper was called")

    monkeypatch.setattr(crt_cuda, "rec_u64_from5", refuse)
    monkeypatch.setattr(crt_cuda, "rec_u128_from10", refuse)
    plan = cls.try_new(n, device="cpu")
    rng = np.random.default_rng(3)
    if module is native32:
        x = rng.integers(0, 1 << 32, (2, n), dtype=np.uint32)
    elif module is native_binary128:
        x = torch.from_numpy(rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32))
    else:
        x = _u64(rng, (2, n))
    plan.negacyclic_polymul(x, x)


def test_reconstruct_keeps_the_int64_contract():
    """`_reconstruct`, which the sharded route (parallel/channels.py) calls
    on int64 carriers, still returns int64 carriers from ops/crt.py."""
    plan = native64.Plan32.try_new(2048, device="cpu")
    primes = plan.primes
    values = _values(primes, "sign_edge", np.random.default_rng(11))
    res = _residues(values, primes)
    mods = to_i64(res)
    lo, hi = plan._reconstruct([mods[i] for i in range(5)])
    assert lo.dtype == hi.dtype == torch.int64
    assert _ints(to_u32(lo), to_u32(hi)) == _want(values, primes)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _on_card_equal(res, primes):
    """The kernel against its plain twin on the same residues, one launch."""
    before = crt_cuda.LAUNCHES["lift_u64_from5"]
    lo, hi = crt_cuda.rec_u64_from5(res, primes)
    torch.cuda.synchronize()
    assert crt_cuda.LAUNCHES["lift_u64_from5"] == before + 1
    assert lo.device.type == "cuda" and lo.shape == res.shape[1:]
    plo, phi = crt_cuda.rec_u64_from5_plain(res, primes)
    assert torch.equal(lo.cpu(), plo.cpu()) and torch.equal(hi.cpu(), phi.cpu())
    return lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", CASES)
def test_kernel_matches_plain_on_card(cuda_device, family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(len(kind)))
    lo, hi = _on_card_equal(_residues(values, primes).to(cuda_device), primes)
    assert _ints(lo, hi) == _want(values, primes)


@pytest.mark.cuda
@pytest.mark.parametrize("count,offset", [(6, 0), (7, 0), (1021, 0), (8, 1), (4096, 3), (2, 0)])
def test_scalar_instance_on_card(cuda_device, count, offset):
    """Counts that are not a multiple of 4, and residues that start 4 or 12
    bytes past a 16-byte boundary, take the scalar instance."""
    primes = FAMILIES["n<=2^15"]
    rng = np.random.default_rng(count + offset)
    flat = torch.from_numpy(rng.integers(0, min(primes), 5 * count + offset,
                                         dtype=np.uint32)).to(cuda_device)
    res = flat[offset:].view(5, 1, count)
    assert res.is_contiguous() and (res.data_ptr() % 16 != 0) == (offset != 0)
    _on_card_equal(res, primes)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << k for k in range(11, 18)])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_kernel_matches_plain_at_plan_shapes_on_card(cuda_device, b, n):
    primes = native_channel_primes(5, n)
    rng = np.random.default_rng(b * n)
    res = torch.from_numpy(np.stack([rng.integers(0, p, (b, n), dtype=np.uint32)
                                     for p in primes])).to(cuda_device)
    _on_card_equal(res, primes)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_cell_shape_on_card(cuda_device):
    """The north-star cell's (B, n) = (256, 2^14), residues from the card."""
    primes = native_channel_primes(5, 1 << 14)
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    res = torch.stack([torch.randint(0, p, (256, 1 << 14), generator=gen, device=cuda_device,
                                     dtype=torch.int64) for p in primes]).to(torch.int32)
    _on_card_equal(res.view(torch.uint32), primes)


@pytest.mark.cuda
def test_plan32_polymul_launches_the_lift_on_card(cuda_device):
    """A native64 Plan32 polymul on the card launches the lift once and
    gives the CPU plain path's bits."""
    n = 1 << 12
    rng = np.random.default_rng(5)
    a, b = _u64(rng, (4, n)), _u64(rng, (4, n))
    plan = native64.Plan32.try_new(n, device="cuda")
    before = crt_cuda.LAUNCHES["lift_u64_from5"]
    got = plan.negacyclic_polymul(a, b)
    assert crt_cuda.LAUNCHES["lift_u64_from5"] == before + 1
    np.testing.assert_array_equal(got, native64.Plan32.try_new(n, device="cpu")
                                  .negacyclic_polymul(a, b))
