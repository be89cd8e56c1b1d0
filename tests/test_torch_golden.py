"""The port's golden transforms (`concrete_ntt_tpu_torch.golden.ntt`) vs the
JAX package's (`concrete_ntt_tpu.golden.ntt`), on the CPU.

Both are pure Python integers: the same inputs, made by a seeded numpy
generator, go through the six oracle functions of each module for a 32-bit
and a 64-bit prime at n = 2 ... 1024; the lists must be equal exactly.
"""

import numpy as np
import pytest

from concrete_ntt_tpu.golden import ntt as J
from concrete_ntt_tpu_torch.golden import ntt as T
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES32

PRIMES = {"p32": PRIMES32[0], "goldilocks": GOLDILOCKS}  # 2^16 | p - 1: n up to 2^15
SIZES = (2, 16, 128, 1024)
FUNCTIONS = ("fwd", "inv", "mul_assign_normalize", "normalize", "mul_accumulate",
             "negacyclic_polymul")


def _vec(rng, p, n):
    """n values below p: random, with 0, 1 and p - 1 at the front."""
    v = [int(x) % p for x in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
    v[: min(3, n)] = [0, 1, p - 1][: min(3, n)]
    return v


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("prime", list(PRIMES))
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_golden_matches_jax(fn, prime, n):
    p = PRIMES[prime]
    rng = np.random.default_rng([n, p % 1000])
    a, b, c = (_vec(rng, p, n) for _ in range(3))
    args = {"fwd": (a, p), "inv": (a, p), "mul_assign_normalize": (a, b, p, n),
            "normalize": (a, p, n), "mul_accumulate": (c, a, b, p),
            "negacyclic_polymul": (a, b, p)}[fn]
    got, want = getattr(T, fn)(*args), getattr(J, fn)(*args)
    assert isinstance(got, list) and got == want


@pytest.mark.parametrize("prime", list(PRIMES))
def test_golden_roundtrip_and_product(prime):
    """inv(fwd(x)) == n·x mod p, and the polymul is the schoolbook product."""
    from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_mod

    p, n = PRIMES[prime], 64
    rng = np.random.default_rng(7)
    a, b = _vec(rng, p, n), _vec(rng, p, n)
    assert T.inv(T.fwd(a, p), p) == [n * v % p for v in a]
    assert T.negacyclic_polymul(a, b, p) == negacyclic_convolution_mod(a, b, p)
