"""Port ops/u32.py (torch, int64 carriers) vs concrete_ntt_tpu.ops.u32 (JAX).

Same inputs, made by a seeded numpy generator plus the edges 0, 1, p-1, p,
2^31 and 2^32-1, go through both packages; results must be equal exactly
(all arithmetic is integer).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import u32 as J
from concrete_ntt_tpu_torch.ops import u32 as T

P30 = 0x3F5A0001  # native64 channel prime P0
P32 = 4293918721  # generic-regime 32-bit prime (Montgomery needs odd p)


def _edges(p):
    return np.array([0, 1, p - 1, p, 1 << 31, (1 << 32) - 1], dtype=np.uint32)


def _operands(rng, p, k):
    """k u32 operand arrays: random values plus every pair of edge values."""
    e = _edges(p)
    grid = np.stack(np.meshgrid(*([e] * min(k, 2)), indexing="ij"), -1).reshape(-1, min(k, 2))
    rand = rng.integers(0, 1 << 32, (4096, k), dtype=np.uint32)
    cols = [np.concatenate([grid[:, i % grid.shape[1]], rand[:, i]]) for i in range(k)]
    return cols


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _eq(port, ref):
    if isinstance(ref, tuple):
        assert len(port) == len(ref)
        for x, y in zip(port, ref):
            _eq(x, y)
        return
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port),
        np.asarray(ref).astype(np.int64),
    )


def _shoup(w, p):
    return w, (w << 32) // p


CASES32 = {
    "mulhi_u32": (2, lambda m, a, b, p: m.mulhi_u32(a, b)),
    "mulwide_u32": (2, lambda m, a, b, p: m.mulwide_u32(a, b)),
    "cond_sub": (1, lambda m, a, p: m.cond_sub(a, p if m is T else np.uint32(p))),
    "add_mod": (2, lambda m, a, b, p: m.add_mod(a, b, p)),
    "sub_mod": (2, lambda m, a, b, p: m.sub_mod(a, b, p)),
    "shoup_mul_lazy": (1, lambda m, a, p: m.shoup_mul_lazy(a, *_c(m, _shoup(123456789 % p, p)), p)),
    "shoup_mul": (1, lambda m, a, p: m.shoup_mul(a, *_c(m, _shoup(p - 2, p)), p)),
    "mont_mul": (2, lambda m, a, b, p: m.mont_mul(a, b, p, m.mont_neginv(p))),
    "reduce_u32_mod": (1, lambda m, a, p: m.reduce_u32_mod(a, p, (1 << 32) // p)),
}


def _c(m, consts):
    return consts if m is T else tuple(np.uint32(c) for c in consts)


_SHOUP_ONLY = ("shoup_mul_lazy", "shoup_mul", "reduce_u32_mod")  # need p < 2^31


@pytest.mark.parametrize(
    "name,p",
    [(nm, p) for nm in sorted(CASES32) for p in (P30, P32)
     if p < (1 << 31) or nm not in _SHOUP_ONLY],
)
def test_u32_helpers_match_jax(rng, name, p):
    k, fn = CASES32[name]
    cols = _operands(rng, p, k)
    _eq(fn(T, *map(_t, cols), p), fn(J, *map(_j, cols), p))


def test_mullo_matches_wrapping_multiply(rng):
    a, b = _operands(rng, P30, 2)
    _eq(T.mullo_u32(_t(a), _t(b)), _j(a) * _j(b))


def _pairs(rng, k):
    """k u64 limb-pair operands with edge limbs."""
    out = []
    for i in range(k):
        lo, hi = _operands(rng, P30, 2)
        out.append((np.roll(lo, i), np.roll(hi, 3 * i)))
    return out


CASES64 = {
    "add64": (2, lambda m, a, b: m.add64(a, b)),
    "sub64": (2, lambda m, a, b: m.sub64(a, b)),
    "geq64": (2, lambda m, a, b: m.geq64(a, b)),
    "mullo64": (2, lambda m, a, b: m.mullo64(a, b)),
    "mulwide64": (2, lambda m, a, b: m.mulwide64(a, b)),
    "mulhi64": (2, lambda m, a, b: m.mulhi64(a, b)),
    "cond_sub64": (1, lambda m, a: m.cond_sub64(a, (P30 * 0x3F5D0001) << 2)),
    "shoup_mul_lazy64": (1, lambda m, a: m.shoup_mul_lazy64(
        a, m.const64_like(_W64), m.const64_like((_W64 << 64) // _P60), _P60)),
}
_P60 = 0x3F5A0001 * 0x3F5D0001  # a two-prime product, as rec_u64_from5 uses
_W64 = 0x123456789ABCD % _P60
CASES64.update({
    "mul64_u32": (1, lambda m, a: tuple(
        x for b32 in (0, 1, P30, (1 << 32) - 1) for x in m.mul64_u32(a, _c(m, (b32,))[0]))),
    "add64c": (2, lambda m, a, b: m.add64c(a, b)),
    "sub64b": (2, lambda m, a, b: m.sub64b(a, b)),
})


@pytest.mark.parametrize("name", sorted(CASES64))
def test_u64_limb_helpers_match_jax(rng, name):
    k, fn = CASES64[name]
    pairs = _pairs(rng, k)
    port = fn(T, *[(_t(lo), _t(hi)) for lo, hi in pairs])
    ref = fn(J, *[(_j(lo), _j(hi)) for lo, hi in pairs])
    _eq(port, ref)


# product-plan moduli: two 30-bit primes, a 31-bit and a 32-bit prime (as
# the product plan's 2^14 cells), and the largest prime below 2^64
MODULI64 = (_P60, 2147352577 * 4293918721, (1 << 64) - 59)


@pytest.mark.parametrize("p", MODULI64)
@pytest.mark.parametrize("name", ["add_mod64", "sub_mod64"])
def test_mod64_helpers_match_jax(rng, name, p):
    """Operands in [0, p): every pair of the edges 0, 1, 2^32 - 1, 2^32,
    p/2, p - 2, p - 1, plus random pairs; the largest modulus makes the
    add carry out of 64 bits."""
    edges = [0, 1, (1 << 32) - 1, 1 << 32, p // 2, p - 2, p - 1]
    a = [x for x in edges for _ in edges] + [int(v) % p for v in rng.integers(0, 1 << 64, 2048, dtype=np.uint64)]
    b = edges * len(edges) + [int(v) % p for v in rng.integers(0, 1 << 64, 2048, dtype=np.uint64)]
    pair = lambda vals: (np.array([v & 0xFFFFFFFF for v in vals], dtype=np.uint32),
                         np.array([v >> 32 for v in vals], dtype=np.uint32))
    (alo, ahi), (blo, bhi) = pair(a), pair(b)
    got = getattr(T, name)((_t(alo), _t(ahi)), (_t(blo), _t(bhi)), p)
    want = getattr(J, name)((_j(alo), _j(ahi)), (_j(blo), _j(bhi)), p)
    _eq(got, want)
    op = (lambda x, y: (x + y) % p) if name == "add_mod64" else (lambda x, y: (x - y) % p)
    vals = [int(lo) | int(hi) << 32 for lo, hi in zip(*(g.numpy() for g in got))]
    assert vals == [op(x, y) for x, y in zip(a, b)]


def test_numpy_limb_helpers_match_jax(rng):
    x = rng.integers(0, 1 << 64, (3, 17), dtype=np.uint64)
    limbs = T.np_u64_to_limbs(x)
    np.testing.assert_array_equal(limbs, J.np_u64_to_limbs(x))
    np.testing.assert_array_equal(T.limbs_to_np_u64(limbs), x)
    vals = [int(v) << 64 | int(w) for v, w in zip(x.ravel(), x.ravel()[::-1])]
    l128 = T.np_u128_to_limbs(vals)
    np.testing.assert_array_equal(l128, J.np_u128_to_limbs(vals))
    assert T.limbs_to_py_u128(l128) == J.limbs_to_py_u128(l128) == vals


def test_uint32_carrier_roundtrip(rng):
    x = np.concatenate([_edges(P30), rng.integers(0, 1 << 32, 1000, dtype=np.uint32)])
    c = T.to_i64(torch.from_numpy(x))
    assert c.dtype == torch.int64 and int(c.min()) >= 0
    np.testing.assert_array_equal(c.numpy(), x.astype(np.int64))
    back = T.to_u32(c)
    assert back.dtype == torch.uint32
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(TypeError):
        T.to_i64(c)


# -- the N-limb helpers of the u128 lifts ----------------------------------------


def _limb_operands(rng, n_limbs, count=2048):
    """[count, n_limbs] uint32 limbs: random rows after rows of edge limbs
    (all ones, all zeros, a lone top bit, a lone low bit)."""
    x = rng.integers(0, 1 << 32, (count, n_limbs), dtype=np.uint32)
    x[0], x[1] = 0xFFFFFFFF, 0
    x[2], x[3] = 0, 0
    x[2, -1], x[3, 0] = 1 << 31, 1
    return x


def _to_ints(limbs):
    """Tuple of limb arrays (or carriers) -> list of Python ints."""
    cols = [np.asarray(c.numpy() if isinstance(c, torch.Tensor) else c).astype(object)
            for c in limbs]
    return list(sum(c << (32 * k) for k, c in enumerate(cols)))


@pytest.mark.parametrize("name", ["add_limbs", "sub_limbs", "mullo_limbs_4x4", "mullo_limbs_2x4",
                                  "mullo_limbs_const", "select_limbs"])
def test_n_limb_helpers_match_python_ints_and_jax(rng, name):
    mask = (1 << 128) - 1
    a, b = _limb_operands(rng, 4), np.roll(_limb_operands(rng, 4), 2, axis=0)
    cols = lambda x, k=4: [x[:, i] for i in range(k)]
    ta, tb = tuple(map(_t, cols(a))), tuple(map(_t, cols(b)))
    ja, jb = tuple(map(_j, cols(a))), tuple(map(_j, cols(b)))
    ia, ib = _to_ints(cols(a)), _to_ints(cols(b))
    if name == "add_limbs":
        port, ref = T.add_limbs(ta, tb), J.add_limbs(ja, jb)
        want = [(x + y) & mask for x, y in zip(ia, ib)]
    elif name == "sub_limbs":
        port, ref = T.sub_limbs(ta, tb), J.sub_limbs(ja, jb)
        want = [(x - y) & mask for x, y in zip(ia, ib)]
    elif name == "mullo_limbs_4x4":
        port, ref = T.mullo_limbs(ta, tb, 4), J.mullo_limbs(ja, jb, 4)
        want = [(x * y) & mask for x, y in zip(ia, ib)]
    elif name == "mullo_limbs_2x4":  # a u64 digit times a u128 constant's limbs
        port, ref = T.mullo_limbs(ta[:2], tb, 4), J.mullo_limbs(ja[:2], jb, 4)
        want = [((x & ((1 << 64) - 1)) * y) & mask for x, y in zip(ia, ib)]
    elif name == "mullo_limbs_const":  # Python-int limbs, a zero limb among them
        c = 0x3F5A0001 * 0x3F5D0001 * 0x3F760001
        assert T.const_limbs(c, 4)[3] == 0 and T.const_limbs(c, 4) == tuple(
            int(v) for v in J.const_limbs(c, 4))
        port, ref = T.mullo_limbs(ta[:2], T.const_limbs(c, 4), 4), J.mullo_limbs(
            ja[:2], J.const_limbs(c, 4), 4)
        want = [((x & ((1 << 64) - 1)) * c) & mask for x in ia]
    else:
        cond = (a[:, 0] & 1).astype(bool)
        port = T.select_limbs(torch.from_numpy(cond), ta, tb)
        ref = J.select_limbs(_j(cond), ja, jb)
        want = [x if c else y for c, x, y in zip(cond, ia, ib)]
    assert len(port) == 4
    _eq(port, ref)
    assert _to_ints(port) == want


@pytest.mark.parametrize("p", [P30, P32, (1 << 64) - (1 << 32) + 1])
def test_to_mont_matches_jax(p):
    for x in (0, 1, p - 1, p // 2, 0x12345678):
        assert T.to_mont(x, p) == J.to_mont(x, p) == (x << 32) % p


@pytest.mark.parametrize("k", [1, 2, 4])
def test_geq_limbs_matches_jax_and_python_ints(rng, k):
    """a >= b on k-limb tuples: random values, each limb's edges, equal
    values, and a Python-int constant on the right."""
    a = _limb_operands(rng, k)
    b = np.concatenate([a[:64], np.roll(a, 3, axis=0)[64:]])  # equal rows first
    b[64:128, -1] = a[64:128, -1]  # equal top limbs: the lower limbs decide
    cols = lambda x: [x[:, i] for i in range(k)]
    port = T.geq_limbs(tuple(map(_t, cols(a))), tuple(map(_t, cols(b))))
    ref = J.geq_limbs(tuple(map(_j, cols(a))), tuple(map(_j, cols(b))))
    want = [x >= y for x, y in zip(_to_ints(cols(a)), _to_ints(cols(b)))]
    assert port.tolist() == np.asarray(ref).tolist() == want
    c = (1 << (32 * k - 1)) + 5
    port_c = T.geq_limbs(tuple(map(_t, cols(a))), T.const_limbs(c, k))
    assert port_c.tolist() == [x >= c for x in _to_ints(cols(a))]
