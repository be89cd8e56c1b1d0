"""native64 Plan52 (three 50-bit primes, K7a / K7d and the 50-bit Garner lift
`ops/crt.py::rec_from3_p50_u64`) on the CPU against the benchmark's plain
u64 reference, `ntt_bench/reference/products.polymul_u64`, which shares
nothing with the port: seeded full-range planar operands, bit for bit, at
the sizes the cell `native64-plan52-n16384-b256` runs (n = 2^14) and below.

The reference is root-level code, loaded with the repository root on
`sys.path`; the file imports no JAX.
"""

import os
import sys

import pytest
import torch

from concrete_ntt_tpu_torch import native64
from concrete_ntt_tpu_torch.tables import PRIMES52

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from ntt_bench.reference import exact, products  # noqa: E402


def _words(seed: int, b: int, n: int) -> torch.Tensor:
    """[4, B, n] full-range uint32 words: lhs (lo, hi), rhs (lo, hi)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (4, b, n), dtype=torch.int32,
                         generator=gen).view(torch.uint32)


def _against_the_reference(w: torch.Tensor) -> None:
    plan = native64.Plan52.try_new(w.shape[-1], device="cpu")
    assert plan.primes == tuple(PRIMES52[:3])
    lo, hi = plan.negacyclic_polymul((w[0], w[1]), (w[2], w[3]))
    want = products.polymul_u64(*(exact.u32_to_i64(x) for x in w))
    assert torch.equal(exact.u32_to_i64(lo), want[0])
    assert torch.equal(exact.u32_to_i64(hi), want[1])


@pytest.mark.parametrize("n,b", [(1 << 11, 2), (1 << 14, 1)], ids=["n2048-b2", "n16384-b1"])
def test_plan52_polymul_is_the_plain_reference(n, b):
    _against_the_reference(_words(52 + n + b, b, n))


def test_plan52_polymul_at_the_widest_operands():
    """Rows of 2^64 - 1 (the largest sums and both signs of the lift's
    digit), of zeros, and one value at a time: bit for bit."""
    n = 1 << 11
    w = _words(7, 4, n)
    w[:, 0] = 0xFFFFFFFF
    w[2:, 1] = 0
    w[:2, 2] = 0
    w[:, 3] = 0
    w[0, 3, 5], w[2, 3, n - 1] = 1, 0xFFFFFFFF
    _against_the_reference(w)
