"""Port ops/crt.py vs concrete_ntt_tpu.ops.crt: every residue split and every
signed lift of the native plans, exact equality on the same numpy inputs;
each lift also against the golden explicit-CRT lift (golden/crt.py) at
negative values and at the two edges of its signed range, and at the
hairline above M/2 where the reference's digit rule and the explicit CRT
part ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import crt as jcrt
from concrete_ntt_tpu_torch.ops import crt as tcrt
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops.u32 import to_i64, to_u32
from concrete_ntt_tpu_torch.golden import crt as gcrt
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.tables import PRIMES32, PRIMES52

MASK64 = (1 << 64) - 1


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _residues_with_v34(rng, v34_values, size=64):
    """Residues of X = v0 + v12·P0 + v34·P0·P12 for random v0, v12 and the
    given top Garner digits v34, plus the expected signed wrapping lift."""
    p0, p1, p2, p3, p4 = PRIMES
    p12, p34 = p1 * p2, p3 * p4
    xs, want = [], []
    for i in range(size):
        v0 = int(rng.integers(0, p0))
        v12 = int(rng.integers(0, p12))
        v34 = v34_values[i % len(v34_values)]
        x = v0 + v12 * p0 + v34 * p0 * p12
        xs.append(x)
        signed = x - p0 * p12 * p34 if v34 > p34 // 2 else x
        want.append(signed & MASK64)
    mods = [np.array([x % p for x in xs], dtype=np.uint32) for p in PRIMES]
    return mods, np.array(want, dtype=np.uint64)


@pytest.mark.parametrize("kind", ["random", "sign_edge"])
def test_rec_u64_from5_matches_jax(rng, kind):
    p34 = PRIMES[3] * PRIMES[4]
    if kind == "random":
        mods = [rng.integers(0, p, 4096, dtype=np.uint32) for p in PRIMES]
        want = None
    else:  # the sign rule sits between v34 = P34//2 and P34//2 + 1 (crt.py:227)
        mods, want = _residues_with_v34(rng, [p34 // 2, p34 // 2 + 1, 0, p34 - 1])
    lo, hi = tcrt.rec_u64_from5([_t(m) for m in mods], PRIMES)
    jlo, jhi = jcrt.rec_u64_from5([jnp.asarray(m) for m in mods], PRIMES)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    if want is not None:
        got = lo.numpy().astype(np.uint64) | (hi.numpy().astype(np.uint64) << np.uint64(32))
        np.testing.assert_array_equal(got, want)


def test_split_u64_matches_jax(rng):
    lo, hi = (rng.integers(0, 1 << 32, 4096, dtype=np.uint32) for _ in range(2))
    lo[:4], hi[:4] = [0, 1, 0xFFFFFFFF, 0], [0, 0xFFFFFFFF, 0xFFFFFFFF, 1]
    port = tcrt.split_u64(_t(lo), _t(hi), PRIMES)
    ref = jcrt.split_u64(jnp.asarray(lo), jnp.asarray(hi), PRIMES)
    want = (lo.astype(object) + (hi.astype(object) << 32))
    for p, a, b in zip(PRIMES, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        np.testing.assert_array_equal(a.numpy(), (want % p).astype(np.int64))


def test_folded_split_equals_explicit_split(rng):
    """K1a's plain twin folds `value % p` into the column matmul; an explicit
    split_u64 followed by the one-limb transform gives the same residues."""
    n = 2048
    lo, hi = (rng.integers(0, 1 << 32, (2, n), dtype=np.uint32) for _ in range(2))
    tl, th = torch.from_numpy(lo), torch.from_numpy(hi)
    for p, r in zip(PRIMES, tcrt.split_u64(to_i64(tl), to_i64(th), PRIMES)):
        folded = tmx.fwd_wide((tl, th), n=n, p=p)
        explicit = tmx.fwd(to_u32(r), n=n, p=p)
        np.testing.assert_array_equal(folded.numpy(), explicit.numpy())


# -- the other splits and lifts ----------------------------------------------------


def test_split_u32_and_u128_match_jax(rng):
    limbs = [rng.integers(0, 1 << 32, 4096, dtype=np.uint32) for _ in range(4)]
    for i, edge in enumerate([0, 1, 0xFFFFFFFF, PRIMES32[0], PRIMES32[9], 2 * PRIMES32[9]]):
        for limb in limbs:
            limb[i] = edge
    limbs[0][6:10], limbs[3][6:10] = [0, 0xFFFFFFFF, 1, 0], [0xFFFFFFFF, 0, 0, 1]
    port = tcrt.split_u32(_t(limbs[0]), PRIMES32[:3])
    ref = jcrt.split_u32(jnp.asarray(limbs[0]), PRIMES32[:3])
    for p, a, b in zip(PRIMES32, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        np.testing.assert_array_equal(a.numpy(), limbs[0].astype(np.int64) % p)
    port = tcrt.split_u128(tuple(map(_t, limbs)), PRIMES32)
    ref = jcrt.split_u128(tuple(map(jnp.asarray, limbs)), PRIMES32)
    value = sum(limb.astype(object) << (32 * k) for k, limb in enumerate(limbs))
    assert gcrt.residues(value[:8], PRIMES32[:2]) == [[int(v) % p for v in value[:8]]
                                                      for p in PRIMES32[:2]]
    for p, a, b in zip(PRIMES32, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        np.testing.assert_array_equal(a.numpy(), (value % p).astype(np.int64))


# name -> (primes, how many of the last primes form the top Garner digit, bits)
LIFTS = {
    "rec_u32_from3": (PRIMES32[:3], 1, 32),
    "rec_u32_from2": (PRIMES32[:2], 1, 32),
    "rec_u64_from3": (PRIMES32[:3], 1, 64),
    "rec_u64_from5": (PRIMES32[:5], 2, 64),
    "rec_u128_from5": (PRIMES32[:5], 2, 128),
    "rec_u128_from10": (PRIMES32[:10], 2, 128),
    "rec_from1_p50_u32": (PRIMES52[:1], 1, 32),
    "rec_from2_p50_u32": (PRIMES52[:2], 1, 32),
    "rec_from2_p50_u64": (PRIMES52[:2], 1, 64),
    "rec_from3_p50_u64": (PRIMES52[:3], 1, 64),
}


def _lift_both(name, values):
    """The port's and the JAX package's lift of the residues of `values`
    (Python ints in [0, M)), each as a list of Python ints."""
    primes = LIFTS[name][0]
    cols = [np.array([v % p for v in values], dtype=np.uint64) for p in primes]
    if primes[0] > 1 << 32:  # Plan52 residues are limb pairs
        lo = [(c & np.uint64(0xFFFFFFFF)).astype(np.uint32) for c in cols]
        hi = [(c >> np.uint64(32)).astype(np.uint32) for c in cols]
        tmods = [(_t(a), _t(b)) for a, b in zip(lo, hi)]
        jmods = [(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(lo, hi)]
    else:
        tmods = [_t(c.astype(np.uint32)) for c in cols]
        jmods = [jnp.asarray(c.astype(np.uint32)) for c in cols]
    port = getattr(tcrt, name)(tmods, primes)
    ref = getattr(jcrt, name)(jmods, primes)
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref) == LIFTS[name][2] // 32
    for a, b in zip(port, ref):  # limb for limb, in the carrier's range
        assert a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < 1 << 32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    ints = sum(a.numpy().astype(object) << (32 * k) for k, a in enumerate(port))
    return [int(v) for v in ints], primes


@pytest.mark.parametrize("name", sorted(LIFTS))
def test_lift_matches_jax_on_random_residues(rng, name):
    primes = LIFTS[name][0]
    m = int(np.prod(np.array(primes, dtype=object)))
    values = [int.from_bytes(rng.bytes(48), "little") % m for _ in range(1024)]
    _lift_both(name, values)


@pytest.mark.parametrize("name", sorted(LIFTS))
def test_lift_matches_golden_at_negatives_and_edges(rng, name):
    """Signed values s (a true product may be negative) go in as s mod M and
    must come out as s mod 2^bits, as the golden explicit-CRT lift gives
    them: small magnitudes of both signs, random ones, +M//2 (the largest
    positive value) and the most negative value the digit rule reaches,
    -(M/P_top)·(P_top - 1)/2. Between the two, just above M/2, the
    reference's sign rule (top digit > P_top/2) still lifts positive where
    the explicit CRT goes negative: there the port must follow the digit
    rule, with the JAX package."""
    primes, n_top, bits = LIFTS[name]
    m = int(np.prod(np.array(primes, dtype=object)))
    p_top = int(np.prod(np.array(primes[-n_top:], dtype=object)))
    prefix = m // p_top
    lowest = -prefix * ((p_top - 1) // 2)
    signed = [0, 1, -1, 2, -2, 12345, -12345, m // 2, m // 2 - 1, lowest, lowest + 1,
              -(1 << min(bits, 60)), (1 << min(bits, 60)) + 7]
    signed += [int.from_bytes(rng.bytes(48), "little") % (m // 2) * sgn
               for sgn in (1, -1) for _ in range(64)]
    signed = [s for s in signed if lowest <= s <= m // 2]
    mask = (1 << bits) - 1
    got, _ = _lift_both(name, [s % m for s in signed])
    assert got == [s & mask for s in signed]
    golden = gcrt.reconstruct_signed_wrapping(
        [[s % m % p for s in signed] for p in primes], primes, bits)
    assert got == golden
    if prefix > 1:  # the hairline: positive by the digit rule, negative by the explicit CRT
        hair = [m // 2 + 1, m // 2 + prefix // 2, m + lowest - 1]  # its two ends and inside
        got, _ = _lift_both(name, hair)
        assert got == [x & mask for x in hair]
        assert gcrt.reconstruct_signed_wrapping(
            [[x % p for x in hair] for p in primes], primes, bits) == [(x - m) & mask for x in hair]
