"""The 64-bit half of the port's ops/u32.py, ops/butterflies64.py and the
Plan52 pieces of ops/crt.py against the JAX package, on full-range operands
made from a numpy seed. Tolerance: exact equality everywhere.

The port holds u32 values in int64 carriers; the JAX code in uint32 arrays.
Both see the same bit patterns, among them the pairs that overflow the REDC
sum of `mont_mul64` and that borrow / carry in `gl_reduce128_lazy`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import butterflies64 as jbf
from concrete_ntt_tpu.ops import crt as jcrt
from concrete_ntt_tpu.ops import u32 as J
from concrete_ntt_tpu_torch.ops import butterflies64 as tbf
from concrete_ntt_tpu_torch.ops import crt as tcrt
from concrete_ntt_tpu_torch.ops import u32 as T
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

N = 4096
P62 = _lp(1 << 16, 1, 1 << 61, 1 << 62)
P63 = _lp(1 << 15, 1, 1 << 62, 1 << 63)
P64 = _lp(1 << 15, 1, 1 << 63, (1 << 64) - 1)
MODULI = {"p50": PRIMES52[0], "p62": P62, "p63": P63, "p64": P64, "goldilocks": GOLDILOCKS}
EDGES = np.array([0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0x7FFFFFFF], dtype=np.uint32)


def _u32(rng, n=N):
    a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    a[: len(EDGES)] = EDGES
    return a


def _pair(rng, n=N):
    lo, hi = _u32(rng, n), _u32(rng, n)
    hi[len(EDGES): 2 * len(EDGES)] = 0xFFFFFFFF  # all-ones and near-2^64 values
    lo[len(EDGES): 2 * len(EDGES)] = EDGES
    return lo, hi


def _below(rng, p, n=N):
    v = rng.integers(0, 1 << 64, n, dtype=np.uint64) % np.uint64(p)
    v[:2] = (0, p - 1)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def _t(pair):
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and int(g.min()) >= 0 and int(g.max()) < (1 << 32)
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def _u64(pair):
    return pair[0].astype(np.uint64) | (pair[1].astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("name", list(MODULI))
def test_mont_mul64_matches_jax_on_any_u64(rng, name):
    """Two arbitrary u64 operands: the REDC sum overflows for some pairs and
    the result may land in [p, 2p); both show up in the sample."""
    p = MODULI[name]
    assert T.mont_neginv64(p) == J.mont_neginv64(p)
    ninv = T.mont_neginv64(p)
    a, b = _pair(rng), _pair(rng)
    want = J.mont_mul64(_j(a), _j(b), p, ninv)
    _same(T.mont_mul64(_t(a), _t(b), p, ninv), want)
    big = (np.full(8, 0xFFFFFFFF, np.uint32),) * 2
    t_hi = (int(_u64(big)[0]) ** 2) >> 64
    assert t_hi + p > (1 << 64) or p < (1 << 63)  # (2^64-1)^2: the sum overflows for large p
    _same(T.mont_mul64(_t(big), _t(big), p, ninv), J.mont_mul64(_j(big), _j(big), p, ninv))
    if p < (1 << 62):
        assert (_u64(tuple(np.asarray(w) for w in want)) >= np.uint64(p)).any()
    # one canonical operand: canonical result
    c = _below(rng, p)
    got = T.mont_mul64(_t(a), _t(c), p, ninv)
    _same(got, J.mont_mul64(_j(a), _j(c), p, ninv))
    r = _u64(tuple(g.numpy().astype(np.uint32) for g in got))
    assert (r < np.uint64(p)).all()
    assert int(r[7]) == int(_u64(a)[7]) * int(_u64(c)[7]) * pow(1 << 64, -1, p) % p


@pytest.mark.parametrize("name", ["p50", "p62", "p63"])
def test_shoup_mul_u32_lazy64_matches_jax(rng, name):
    p = MODULI[name]
    z = _u32(rng)
    w = _below(rng, p)
    sh = [(int(v) << 64) // p for v in _u64(w)]
    wsh = (np.array([v & 0xFFFFFFFF for v in sh], dtype=np.uint32),
           np.array([v >> 32 for v in sh], dtype=np.uint32))
    got = T.shoup_mul_u32_lazy64(torch.from_numpy(z.astype(np.int64)), _t(w), _t(wsh), p)
    _same(got, J.shoup_mul_u32_lazy64(jnp.asarray(z), _j(w), _j(wsh), p))
    # scalar (Python int) multiplicands, as the top-limb fold passes them
    c = (1 << 64) % p
    csh = (c << 64) // p
    got = T.shoup_mul_u32_lazy64(torch.from_numpy(z.astype(np.int64)), T.const64_like(c),
                                 T.const64_like(csh), p)
    _same(got, J.shoup_mul_u32_lazy64(jnp.asarray(z), J.const64_like(c), J.const64_like(csh), p))
    r = _u64(tuple(g.numpy().astype(np.uint32) for g in got))
    assert all(int(v) % p == int(x) * c % p and int(v) < 2 * p for v, x in zip(r[:64], z[:64]))


def test_goldilocks_reduction_matches_jax(rng):
    ls = [_u32(rng) for _ in range(4)]
    # force the borrow of lo64 - l3 and the carry of t0 + t1
    ls[0][:64], ls[1][:64], ls[3][:64] = 0, 0, 0xFFFFFFFF
    ls[0][64:128], ls[1][64:128], ls[2][64:128], ls[3][64:128] = 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0
    tl = [torch.from_numpy(a.astype(np.int64)) for a in ls]
    jl = [jnp.asarray(a) for a in ls]
    _same(T.gl_reduce128_lazy(*tl), J.gl_reduce128_lazy(*jl))
    got = T.gl_reduce128(*tl)
    _same(got, J.gl_reduce128(*jl))
    r = _u64(tuple(g.numpy().astype(np.uint32) for g in got))
    for i in (0, 1, 64, 65, 200):
        v = sum(int(ls[k][i]) << (32 * k) for k in range(4))
        assert int(r[i]) == v % GOLDILOCKS
    assert T.GOLDILOCKS_P == J.GOLDILOCKS_P == GOLDILOCKS


def test_goldilocks_field_ops_match_jax(rng):
    a, b = _pair(rng), _pair(rng)
    _same(T.gl_mul_lazy(_t(a), _t(b)), J.gl_mul_lazy(_j(a), _j(b)))
    _same(T.gl_mul(_t(a), _t(b)), J.gl_mul(_j(a), _j(b)))
    x, y = _below(rng, GOLDILOCKS), _below(rng, GOLDILOCKS)
    _same(T.gl_add(_t(x), _t(y)), J.gl_add(_j(x), _j(y)))
    _same(T.gl_sub(_t(x), _t(y)), J.gl_sub(_j(x), _j(y)))
    # Python-int constants broadcast like arrays
    _same(T.gl_mul(_t(a), T.const64_like(12345678901234567)),
          J.gl_mul(_j(a), J.const64_like(12345678901234567)))


def _twiddles(rng, p, n, shoup):
    w = _below(rng, p, n)
    if not shoup:
        return w
    sh = [(int(v) << 64) // p for v in _u64(w)]
    return w + (np.array([v & 0xFFFFFFFF for v in sh], dtype=np.uint32),
                np.array([v >> 32 for v in sh], dtype=np.uint32))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("regime", ["shoup62", "shoup63", "goldilocks", "generic"])
def test_butterflies64_match_jax(rng, regime, direction):
    """Every butterfly and last butterfly on any-u64 inputs (beyond the
    regime's lazy bounds too: the bit patterns must still agree)."""
    p = {"shoup62": PRIMES52[0], "shoup63": P63, "goldilocks": GOLDILOCKS, "generic": P64}[regime]
    args = () if regime == "goldilocks" else (p,)
    if regime == "generic":
        args = (p, T.mont_neginv64(p))
    tmake = getattr(tbf, f"make_{direction}_{regime}{'64' if regime == 'generic' else ''}")
    jmake = getattr(jbf, f"make_{direction}_{regime}{'64' if regime == 'generic' else ''}")
    w = _twiddles(rng, p, 512, regime.startswith("shoup"))
    for x0, x1 in ((_pair(rng, 512), _pair(rng, 512)), (_below(rng, p, 512), _below(rng, p, 512))):
        for tb, jb in zip(tmake(*args), jmake(*args)):
            got = tb(_t(x0), _t(x1), _t(w))
            want = jb(_j(x0), _j(x1), _j(w))
            for g, wv in zip(got, want):
                _same(g, wv)


def test_plan52_split_and_lift_match_jax(rng):
    primes = PRIMES52[:3]
    lo, hi = _pair(rng)
    got = tcrt.split_u64_to_p50(*_t((lo, hi)), primes)
    want = jcrt.split_u64_to_p50(jnp.asarray(lo), jnp.asarray(hi), primes)
    for g, w, p in zip(got, want, primes):
        _same(g, w)
        assert int(_u64(tuple(a.numpy().astype(np.uint32) for a in g))[9]) == int(_u64((lo, hi))[9]) % p
    mods = [_below(rng, p) for p in primes]
    _same(tcrt.rec_from3_p50_u64([_t(m) for m in mods], primes),
          jcrt.rec_from3_p50_u64([_j(m) for m in mods], primes))
    # a known signed value survives split -> lift
    vals = np.array([0, 1, (1 << 64) - 1, 1 << 63, 0x0123456789ABCDEF], dtype=np.uint64)
    signed = [int(v) - (1 << 64) if int(v) >= (1 << 63) else int(v) for v in vals]
    res = [tuple(torch.tensor([(s % p) >> (32 * k) & 0xFFFFFFFF for s in signed]) for k in range(2))
           for p in primes]
    back = tcrt.rec_from3_p50_u64(res, primes)
    assert [int(a) | (int(b) << 32) for a, b in zip(*back)] == [int(v) for v in vals]
