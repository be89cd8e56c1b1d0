"""Port crt_mxu.py vs concrete_ntt_tpu.crt_mxu and the port's ops/crt.py:
the three int8-GEMM Garner lifts, bit for bit, at the shapes of
tests/test_crt_mxu.py, at their boundary corners (all-zero, all-(p-1), the
sign edge of the top digit) and below 17 rows (where the operand is padded
for torch._int_mm); the constant matrix equal to the JAX package's, and its
zero-padded, column-major layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu import crt_mxu as jmxu
from concrete_ntt_tpu_torch import crt_mxu as tmxu
from concrete_ntt_tpu_torch.ops import crt as tcrt
from concrete_ntt_tpu_torch.tables import PRIMES32, native_channel_primes

LIFTS = {  # name -> (channels, primes)
    "rec_u64_from5": tuple(PRIMES32[:5]),
    "rec_u128_from5": tuple(PRIMES32[:5]),
    "rec_u128_from10": native_channel_primes(10, 1 << 10),
}


def _check(name, mods):
    """The port's GEMM lift == JAX crt_mxu == the port's scalar lift."""
    primes = LIFTS[name]
    tmods = [torch.from_numpy(m.astype(np.int64)) for m in mods]
    got = getattr(tmxu, name)(tmods, primes)
    want = getattr(jmxu, name)([jnp.asarray(m) for m in mods], primes)
    scalar = getattr(tcrt, name)(tmods, primes)
    assert len(got) == len(want) == len(scalar)
    for g, w, s in zip(got, want, scalar):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(g.numpy(), s.numpy())


@pytest.mark.parametrize("shape", [(4, 257), (1, 64), (3, 128)])
@pytest.mark.parametrize("name", list(LIFTS))
def test_lift_matches_jax_and_scalar(rng, name, shape):
    _check(name, [rng.integers(0, p, shape, dtype=np.uint32) for p in LIFTS[name]])


def _pair_moduli(primes):
    if len(primes) == 5:
        p0, p1, p2, p3, p4 = primes
        return [p0, p1 * p2, p3 * p4]
    return [primes[2 * i] * primes[2 * i + 1] for i in range(5)]


@pytest.mark.parametrize("corner", ["zero", "p_minus_1", "one", "sign_edge"])
@pytest.mark.parametrize("name", list(LIFTS))
def test_lift_boundary_corners(rng, name, corner):
    """All-zero, all-(p-1), all-one and the sign edge (top mixed-radix digit
    at P_top/2 and P_top/2 + 1, 0 and P_top - 1), on [1, 8] (8 rows: the
    operand is padded to torch._int_mm's 17)."""
    primes = LIFTS[name]
    ones = np.ones((1, 8), dtype=np.uint32)
    if corner == "sign_edge":
        moduli = _pair_moduli(primes)
        top = moduli[-1]
        tops = [top // 2, top // 2 + 1, 0, top - 1] * 2
        xs = []
        for t in tops:  # X = Σ d_i · Π_{j<i} P_j with random lower digits
            x, pref = 0, 1
            for m in moduli[:-1]:
                x += int(rng.integers(0, m)) * pref
                pref *= m
            xs.append(x + t * pref)
        mods = [np.array([[x % p for x in xs]], dtype=np.uint32) for p in primes]
    else:
        val = {"zero": lambda p: 0, "p_minus_1": lambda p: p - 1, "one": lambda p: 1}[corner]
        mods = [ones * np.uint32(val(p)) for p in primes]
    _check(name, mods)


@pytest.mark.parametrize("limb_counts,out_limbs,name", [
    ((1, 2, 2), 2, "rec_u64_from5"), ((1, 2, 2), 4, "rec_u128_from5"),
    ((2, 2, 2, 2, 2), 4, "rec_u128_from10")])
def test_mixed_radix_matrix_matches_jax_and_pads(limb_counts, out_limbs, name):
    primes = LIFTS[name]
    moduli = _pair_moduli(primes)
    prefixes = [1]
    for m in moduli[:-1]:
        prefixes.append(prefixes[-1] * m)
    prefixes = tuple(prefixes)
    mat, const = tmxu._mixed_radix_matrix(limb_counts, prefixes, out_limbs)
    jmat, jconst = jmxu._mixed_radix_matrix(limb_counts, prefixes, out_limbs)
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(const, jconst)
    k, n = mat.shape
    assert (k, n) == (4 * sum(limb_counts), 4 * out_limbs + 1)
    padded, const_t = tmxu._mixed_radix_operand(limb_counts, prefixes, out_limbs, "cpu")
    # what the card's torch._int_mm takes: depth and width multiples of 8,
    # the second operand column-major
    assert padded.dtype == torch.int8 and padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    assert padded.shape[0] >= k and padded.shape[1] >= n and padded.shape[0] - k < 8
    assert padded.stride() == (1, padded.shape[0])
    full = padded.numpy()
    np.testing.assert_array_equal(full[:k, :n], mat)
    assert not full[k:].any() and not full[:, n:].any()  # padding enters no sum, Σx's included
    np.testing.assert_array_equal(const_t.numpy(), const.astype(np.int64))
