"""The native128 Plan32 lift kernels (`ops/crt_cuda.py::rec_u128_from10`,
`csrc/crt_lift128.cu`: the digits, then the limbs).

On the CPU: the wrapper's plain twin equals the int64 chain of
`ops/crt.py` rec_u128_from10 bit for bit, and so does a Python-int model of
both kernels' arithmetic on the constants the wrapper hands them (the
digits against the chain's `_pair_digits_from10`, the limbs against its
limbs), both also against the value the reference's digit rule gives, for
both ten-prime families (n <= 2^15 and the 2^18 | p - 1 family above):
random residues, the sign edge (top digit P89 // 2 and P89 // 2 + 1), the
hairline just above M / 2 where the digit rule and the explicit CRT part,
and residues 0 and p - 1; the model on any uint32 words; the constants'
layout against the kernels' struct; the wrapper's refusals, its launch
counter, and the plans: `native128.Plan32` lifts through it to the bits of
the plain chain, and its `_reconstruct` keeps int64 carriers.

On the card (marked `cuda`, skipped without one): the kernels against their
plain twin on the same cases, on counts that are not a multiple of 4 and on
misaligned bases (the scalar instances), at B = 1, 3, 16 for n = 2^11 ...
2^17, at the cell `native128-n65536-b64`'s (64, 2^16), and one native128
polymul launching each kernel once inside its two lift spans. The file
imports no JAX:

    python -m pytest tests/test_torch_crt128_cuda.py --noconftest -q
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import native128
from concrete_ntt_tpu_torch._native_common import NativePlanBase
from concrete_ntt_tpu_torch.golden.polymul_u128 import negacyclic_polymul_u128
from concrete_ntt_tpu_torch.ops import crt, crt_cuda
from concrete_ntt_tpu_torch.ops.u32 import to_i64, to_u32
from concrete_ntt_tpu_torch.tables import native_channel_primes
from concrete_ntt_tpu_torch.utils import profiling

MASK32, MASK64, MASK128 = (1 << 32) - 1, (1 << 64) - 1, (1 << 128) - 1
FAMILIES = {"n<=2^15": native_channel_primes(10, 1 << 15),
            "n>2^15": native_channel_primes(10, 1 << 16)}
KINDS = ("random", "sign_edge", "hairline", "zero_and_pmax")
CASES = [(f, k) for f in FAMILIES for k in KINDS]
SOURCE = os.path.join(crt_cuda.cuda_build.CSRC, "crt_lift128.cu")


def _moduli(primes):
    pair = [primes[2 * i] * primes[2 * i + 1] for i in range(5)]
    prefix = pair[0] * pair[1] * pair[2] * pair[3]
    return prefix * pair[4], prefix, pair[4]  # M, the prefix below the top digit, P89


def _crt(res, primes) -> int:
    """The value in [0, M) with residues `res`."""
    m = _moduli(primes)[0]
    return sum(r * (m // p) * pow(m // p, -1, p) for r, p in zip(res, primes)) % m


def _rand(rng, below: int) -> int:
    return int.from_bytes(rng.bytes(48), "little") % below


def _values(primes, kind, rng) -> list:
    """Values in [0, M) of one kind (Python ints)."""
    m, prefix, p89 = _moduli(primes)
    if kind == "random":
        return [_rand(rng, m) for _ in range(1021)]
    if kind == "sign_edge":  # the top digit on both sides of the rule, and its ends
        tops = [p89 // 2, p89 // 2 + 1, 0, p89 - 1]
        return [tops[i % 4] * prefix + _rand(rng, prefix) for i in range(64)] + [
            t * prefix + low for t in tops for low in (0, prefix - 1)]
    if kind == "hairline":  # above M / 2, positive by the digit rule
        top = prefix * (p89 // 2 + 1) - 1  # its last value
        return [m // 2 + 1, m // 2 + 2, top - 1, top] + [
            m // 2 + 1 + _rand(rng, top - m // 2) for _ in range(60)]
    # every channel 0 or p - 1 (all 1,024 combinations), and one channel p - 1
    combos = [[(p - 1) * ((mask >> i) & 1) for i, p in enumerate(primes)] for mask in range(1024)]
    combos += [[(p - 1) if i == j else 0 for i, p in enumerate(primes)] for j in range(10)]
    return [_crt(c, primes) for c in combos]


def _residues(values, primes) -> torch.Tensor:
    """uint32 [10, 1, len(values)] residues of the values."""
    cols = np.array([[v % p for v in values] for p in primes], dtype=np.uint32)
    return torch.from_numpy(cols).reshape(10, 1, len(values))


def _want(values, primes) -> list:
    """The reference's signed lift: negative where the top Garner digit
    exceeds P89 / 2, as u128."""
    m, prefix, p89 = _moduli(primes)
    return [(v - m if v // prefix > p89 // 2 else v) & MASK128 for v in values]


def _ints(limbs) -> list:
    cols = [t.cpu().numpy().astype(np.uint64).ravel() for t in limbs]
    return [sum(int(c[i]) << (32 * k) for k, c in enumerate(cols)) for i in range(len(cols[0]))]


def _chain(residues, primes) -> tuple:
    mods = to_i64(residues)
    return tuple(to_u32(v) for v in crt.rec_u128_from10([mods[i] for i in range(10)], primes))


def _chain_digits(residues, primes) -> list:
    """The chain's five digits a coefficient, as Python ints."""
    mods = to_i64(residues)
    digits, _, _ = crt._pair_digits_from10([mods[i] for i in range(10)], primes)
    lo_hi = [(lo.numpy().ravel(), hi.numpy().ravel()) for lo, hi in digits]
    return [[int(lo[i]) | int(hi[i]) << 32 for lo, hi in lo_hi] for i in range(len(lo_hi[0][0]))]


def _shoup(z, w, w_sh, p, bits):
    mask = (1 << bits) - 1
    t = (z * w - ((z * w_sh) >> bits) * p) & mask
    return t - p if t >= p else t


def _digits_model(ms, c) -> list:
    """csrc/crt_lift128.cu digits10 on Python ints: every u32 / u64 wrap of
    the kernel, on the constants the wrapper passes it."""
    pair = []
    for i in range(5):
        lo, p_hi = ms[2 * i], c.p[2 * i + 1]
        v = _shoup((2 * p_hi + ms[2 * i + 1] - lo) & MASK32, c.inv[i], c.inv_sh[i], p_hi, 32)
        pair.append(v * c.p[2 * i] + lo)
    d = [pair[0]]
    for i in range(1, 5):
        acc = d[i - 1]
        for j in range(i - 2, -1, -1):
            k = (i - 1) * (i - 2) // 2 + (i - 2 - j)
            acc = (d[j] + _shoup(acc, c.horner[k], c.horner_sh[k], c.pp[i], 64)) & MASK64
        d.append(_shoup((pair[i] - acc + 2 * c.pp[i]) & MASK64, c.phi[i - 1], c.phi_sh[i - 1],
                        c.pp[i], 64))
    return d


def _limbs_model(d, c) -> int:
    """csrc/crt_lift128.cu limbs10 on Python ints, two u64 halves."""
    lo, hi = d[0], 0
    for i in range(1, 5):
        plo = (d[i] * c.pref_lo[i - 1]) & MASK64
        lo = (lo + plo) & MASK64
        hi = (hi + ((d[i] * c.pref_lo[i - 1]) >> 64) + d[i] * c.pref_hi[i - 1]
              + (lo < plo)) & MASK64
    if d[4] >= c.half:
        hi = (hi - c.m_hi - (lo < c.m_lo)) & MASK64
        lo = (lo - c.m_lo) & MASK64
    return lo | hi << 64


@pytest.mark.parametrize("family,kind", CASES)
def test_plain_twin_equals_the_chain_and_the_digit_rule(family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(len(kind)))
    res = _residues(values, primes)
    limbs = crt_cuda.rec_u128_from10(res, primes)
    assert len(limbs) == 4
    assert all(t.dtype == torch.uint32 and t.shape == (1, len(values)) for t in limbs)
    assert all(torch.equal(a, b) for a, b in zip(limbs, _chain(res, primes)))
    assert _ints(limbs) == _want(values, primes)


@pytest.mark.parametrize("family,kind", CASES)
def test_kernel_model_equals_the_chain(family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(1 + len(kind)))
    res = _residues(values, primes)
    consts = crt_cuda.lift10_constants(primes)
    digits = [_digits_model([v % p for p in primes], consts) for v in values]
    assert digits == _chain_digits(res, primes)
    got = [_limbs_model(d, consts) for d in digits]
    assert got == _ints(_chain(res, primes)) == _want(values, primes)


def test_kernel_model_equals_the_chain_on_any_u32_words():
    """Words at or above p (no channel returns them) wrap in the kernels as
    in the chain: the bits agree on any uint32 input."""
    primes = FAMILIES["n<=2^15"]
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (10, 1, 512), dtype=np.uint32)
    words[:, 0, :8] = 0xFFFFFFFF
    words[::2, 0, 8:16] = 0xFFFFFFFF  # one channel of each pair at the top
    res = torch.from_numpy(words)
    consts = crt_cuda.lift10_constants(primes)
    digits = [_digits_model([int(words[c, 0, i]) for c in range(10)], consts)
              for i in range(512)]
    assert digits == _chain_digits(res, primes)
    got = [_limbs_model(d, consts) for d in digits]
    assert got == _ints(_chain(res, primes)) == _ints(crt_cuda.rec_u128_from10(res, primes))


def _struct_fields(source: str) -> list:
    """(name, bits, count) of each field of the .cu's Lift10Consts."""
    with open(source) as f:
        body = re.search(r"struct Lift10Consts \{(.*?)\};", f.read(), re.S).group(1)
    out = []
    for bits, names in re.findall(r"uint(\d+)_t ([^;]+);", body):
        for decl in names.split(","):
            name, _, count = decl.strip().partition("[")
            out.append((name, int(bits), int(count.rstrip("]")) if count else 1))
    return out


def test_constants_layout_matches_the_kernel_struct():
    """The ctypes record has csrc/crt_lift128.cu's Lift10Consts fields in its
    order, widths and array lengths (36 u64 then 20 u32: 368 bytes); one
    cached record per primes tuple."""
    fields = []
    for name, ctype in crt_cuda.Lift10Consts._fields_:
        count = getattr(ctype, "_length_", 1)
        fields.append((name, 8 * ctypes.sizeof(ctype) // count, count))
    assert fields == _struct_fields(SOURCE)
    assert ctypes.sizeof(crt_cuda.Lift10Consts) == 368
    primes = FAMILIES["n>2^15"]
    assert crt_cuda.lift10_constants(primes) is crt_cuda.lift10_constants(tuple(primes))
    c = crt_cuda.lift10_constants(primes)
    assert tuple(c.p) == primes
    assert list(c.pp) == [primes[2 * i] * primes[2 * i + 1] for i in range(5)]
    assert all(c.phi[i] < c.pp[i + 1] for i in range(4)) and c.half == c.pp[4] // 2 + 1


LOW = FAMILIES["n<=2^15"]


@pytest.mark.parametrize("primes", [LOW[:9], (2147483659,) + LOW[1:], (4,) + LOW[1:]],
                         ids=["nine", "above-2^31", "even"])
def test_lift10_constants_refuse_other_primes(primes):
    with pytest.raises(ValueError, match="ten odd primes below 2\\^31"):
        crt_cuda.lift10_constants(primes)


def _good(shape=(10, 2, 8)) -> torch.Tensor:
    primes = FAMILIES["n<=2^15"]
    return to_u32(torch.randint(0, min(primes), shape, dtype=torch.int64))


@pytest.mark.parametrize("bad,err,match", [
    (lambda: to_i64(_good()), TypeError, "uint32"),
    (lambda: _good().view(torch.int32), TypeError, "uint32"),
    (lambda: _good((9, 2, 8)), ValueError, "\\[10, \\.\\.\\., n\\]"),
    (lambda: _good((11, 2, 8)), ValueError, "\\[10, \\.\\.\\., n\\]"),
    (lambda: _good((10,)), ValueError, "\\[10, \\.\\.\\., n\\]"),
    (lambda: _good((10, 8, 2)).transpose(1, 2), ValueError, "contiguous"),
    (lambda: _good((10, 2, 16))[:, :, ::2], ValueError, "contiguous"),
], ids=["int64", "int32", "nine-channels", "eleven-channels", "one-dim", "transposed", "strided"])
def test_wrapper_refuses(bad, err, match):
    with pytest.raises(err, match=match):
        crt_cuda.rec_u128_from10(bad(), FAMILIES["n<=2^15"])


def test_wrapper_refuses_other_primes():
    with pytest.raises(ValueError, match="ten odd primes"):
        crt_cuda.rec_u128_from10(_good(), FAMILIES["n<=2^15"][:9] + (4,))


def test_launch_counter_keys_and_reset():
    """Two keys, one a kernel; registered with utils/profiling; the plain
    twin launches nothing."""
    assert profiling._counters[crt_cuda.__name__][0] is crt_cuda.LAUNCHES
    assert [k for k in crt_cuda.LAUNCHES if k.startswith("lift_u128")] == [
        "lift_u128_digits", "lift_u128_limbs"]
    crt_cuda.LAUNCHES["lift_u128_digits"] = 3
    crt_cuda.LAUNCHES["lift_u128_limbs"] = 4
    profiling.reset_launches()
    assert not any(crt_cuda.LAUNCHES.values())
    crt_cuda.rec_u128_from10(_good(), FAMILIES["n<=2^15"])
    assert not any(crt_cuda.LAUNCHES.values())


def _u128_planes(rng, shape) -> tuple:
    return tuple(torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32))
                 for _ in range(4))


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_plan32_lifts_through_the_wrapper_to_the_chains_bits(monkeypatch, n):
    """native128.Plan32's polymul and inv call crt_cuda.rec_u128_from10 once
    each, through `_lift_parts`, and return what the base class's plain
    chain returns; the polymul is the wrapping u128 product. (n = 2048 is
    the channel route, the others the per-channel route.)"""
    plan = native128.Plan32.try_new(n, device="cpu")
    rng = np.random.default_rng(n)
    a, b = _u128_planes(rng, (2, n)), _u128_planes(rng, (2, n))
    calls = []
    real = crt_cuda.rec_u128_from10

    def counted(residues, primes):
        calls.append(tuple(residues.shape))
        return real(residues, primes)

    monkeypatch.setattr(crt_cuda, "rec_u128_from10", counted)
    prod = plan.negacyclic_polymul(a, b)
    ntt = plan.fwd(a)
    back = plan.inv(ntt, out_format="planar")
    assert calls == [(10, 2, n), (10, 2, n)]
    assert all(torch.equal(x, y) for x, y in zip(prod, negacyclic_polymul_u128(a, b)))
    monkeypatch.setattr(native128.Plan32, "_lift_parts", NativePlanBase._lift_parts)
    assert all(torch.equal(x, y) for x, y in zip(plan.negacyclic_polymul(a, b), prod))
    assert all(torch.equal(x, y) for x, y in zip(plan.inv(ntt, out_format="planar"), back))
    assert len(calls) == 2


def test_reconstruct_keeps_the_int64_contract():
    """`_reconstruct`, which the sharded route (parallel/channels.py) calls
    on int64 carriers, still returns int64 carriers from ops/crt.py."""
    plan = native128.Plan32.try_new(2048, device="cpu")
    primes = plan.primes
    values = _values(primes, "sign_edge", np.random.default_rng(11))
    mods = to_i64(_residues(values, primes))
    limbs = plan._reconstruct([mods[i] for i in range(10)])
    assert len(limbs) == 4 and all(t.dtype == torch.int64 for t in limbs)
    assert _ints([to_u32(t) for t in limbs]) == _want(values, primes)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _on_card_equal(res, primes):
    """The kernels against their plain twin on the same residues, one launch
    each."""
    before = dict(crt_cuda.LAUNCHES)
    limbs = crt_cuda.rec_u128_from10(res, primes)
    torch.cuda.synchronize()
    assert crt_cuda.LAUNCHES == {**before, "lift_u128_digits": before["lift_u128_digits"] + 1,
                                 "lift_u128_limbs": before["lift_u128_limbs"] + 1}
    assert all(t.device.type == "cuda" and t.shape == res.shape[1:] for t in limbs)
    plain = crt_cuda.rec_u128_from10_plain(res, primes)
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(limbs, plain))
    return limbs


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", CASES)
def test_kernels_match_plain_on_card(cuda_device, family, kind):
    primes = FAMILIES[family]
    values = _values(primes, kind, np.random.default_rng(len(kind)))
    limbs = _on_card_equal(_residues(values, primes).to(cuda_device), primes)
    assert _ints(limbs) == _want(values, primes)


@pytest.mark.cuda
def test_kernels_match_plain_on_any_u32_words_on_card(cuda_device):
    primes = FAMILIES["n>2^15"]
    words = np.random.default_rng(9).integers(0, 1 << 32, (10, 3, 1024), dtype=np.uint32)
    words[:, 0, :16] = 0xFFFFFFFF
    _on_card_equal(torch.from_numpy(words).to(cuda_device), primes)


@pytest.mark.cuda
@pytest.mark.parametrize("count,offset", [(6, 0), (7, 0), (1021, 0), (8, 1), (4096, 3), (2, 0),
                                          (1021, 2)])
def test_scalar_instances_on_card(cuda_device, count, offset):
    """Counts that are not a multiple of 4 take both scalar instances;
    residues that start 4 to 12 bytes past a 16-byte boundary take the
    digits kernel's."""
    primes = FAMILIES["n<=2^15"]
    rng = np.random.default_rng(count + offset)
    flat = torch.from_numpy(rng.integers(0, min(primes), 10 * count + offset,
                                         dtype=np.uint32)).to(cuda_device)
    res = flat[offset:].view(10, 1, count)
    assert res.is_contiguous() and (res.data_ptr() % 16 != 0) == (offset != 0)
    _on_card_equal(res, primes)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_limbs_kernel_on_a_misaligned_base_on_card(cuda_device, offset):
    """Digit planes 8 or 24 bytes past a 16-byte boundary (no wrapper call
    makes them) take the limbs kernel's scalar instance, to the vector
    instance's bits."""
    primes = FAMILIES["n<=2^15"]
    consts = crt_cuda.lift10_constants(primes)
    rng = np.random.default_rng(offset)
    res = torch.from_numpy(rng.integers(0, min(primes), (10, 2, 1024),
                                        dtype=np.uint32)).to(cuda_device)
    want = crt_cuda.rec_u128_from10(res, primes)
    flat = torch.empty(5 * 2 * 1024 + offset, dtype=torch.uint64, device=cuda_device)
    digits = flat[offset:].view(5, 2, 1024)
    crt_cuda._launch128("digits", res, digits, consts)
    limbs = torch.empty((4, 2, 1024), dtype=torch.uint32, device=cuda_device)
    crt_cuda._launch128("limbs", digits, limbs, consts)
    torch.cuda.synchronize()
    assert digits.data_ptr() % 16 != 0
    assert all(torch.equal(a, b) for a, b in zip(limbs, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << k for k in range(11, 18)])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_kernels_match_plain_at_plan_shapes_on_card(cuda_device, b, n):
    primes = native_channel_primes(10, n)
    rng = np.random.default_rng(b * n)
    res = torch.from_numpy(np.stack([rng.integers(0, p, (b, n), dtype=np.uint32)
                                     for p in primes])).to(cuda_device)
    _on_card_equal(res, primes)


@pytest.mark.cuda
def test_kernels_match_plain_at_the_cell_shape_on_card(cuda_device):
    """The cell native128-n65536-b64's (B, n) = (64, 2^16), residues from the
    card."""
    primes = native_channel_primes(10, 1 << 16)
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    res = torch.stack([torch.randint(0, p, (64, 1 << 16), generator=gen, device=cuda_device,
                                     dtype=torch.int64) for p in primes]).to(torch.int32)
    _on_card_equal(res.view(torch.uint32), primes)


@pytest.mark.cuda
def test_plan32_polymul_launches_the_lift_kernels_in_their_spans_on_card(cuda_device):
    """A native128 Plan32 polymul on the card launches each lift kernel once,
    inside `ntt.lift_digits` and `ntt.lift_limbs` under `ntt.lift`, and
    gives the CPU plain path's bits."""
    from torch.profiler import ProfilerActivity, profile

    n = 1 << 12
    rng = np.random.default_rng(5)
    a, b = _u128_planes(rng, (4, n)), _u128_planes(rng, (4, n))
    plan = native128.Plan32.try_new(n, device="cuda")
    on_card = [tuple(t.to(cuda_device) for t in x) for x in (a, b)]
    plan.negacyclic_polymul(*on_card)  # tables and libraries built outside the session
    torch.cuda.synchronize()
    before = dict(crt_cuda.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = plan.negacyclic_polymul(*on_card)
    records = profiling.recorded_spans()
    assert crt_cuda.LAUNCHES["lift_u128_digits"] == before["lift_u128_digits"] + 1
    assert crt_cuda.LAUNCHES["lift_u128_limbs"] == before["lift_u128_limbs"] + 1
    by_name = {r["name"]: r for r in records}
    lift = by_name["ntt.lift"]
    for name, nbytes in (("ntt.lift_digits", 80 * 4 * n), ("ntt.lift_limbs", 56 * 4 * n)):
        r = by_name[name]
        assert r["parent"] == lift["index"] and r["nbytes"] == nbytes
        assert r["device_ms"] is not None and 0 < r["device_ms"] <= lift["device_ms"]
    root = next(r for r in records if r["parent"] is None)
    assert root["launches"] == 6  # K1a-W4 x2, the pointwise product, K1b, the two lift kernels
    want = native128.Plan32.try_new(n, device="cpu").negacyclic_polymul(a, b)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
