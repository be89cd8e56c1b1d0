"""Port ops/crt.py vs concrete_ntt_tpu.ops.crt: the native64 Plan32 split
and the signed Garner lift, exact equality on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import crt as jcrt
from concrete_ntt_tpu_torch.ops import crt as tcrt
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops.u32 import to_i64, to_u32
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES

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
