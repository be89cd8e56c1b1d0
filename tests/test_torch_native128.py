"""native128's Plan32 against the plain-torch u128 reference, on the CPU.

`native128.Plan32.negacyclic_polymul` on planar u128 operands (four uint32
[B, n] planes a side, the format the benchmark's cell `native128-n65536-b64`
runs) must equal `golden/polymul_u128.py`, the wrapping product mod
(X^n + 1, 2^128) in plain torch integers, bit for bit (tolerance 0: the
product is an integer), on full-range operands at every size from the
per-channel route (n < 2^11) to the channel grid (n = 2^11), and at the
extremes of the range. The reference itself is held to the bigint oracle
`golden/polymul.py::negacyclic_convolution_wrapping(…, 128)`.

The file imports only torch and the port (no JAX):

    python -m pytest tests/test_torch_native128.py --noconftest -q
"""

import random

import pytest
import torch

from concrete_ntt_tpu_torch import native128
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping
from concrete_ntt_tpu_torch.golden.polymul_u128 import negacyclic_polymul_u128
from concrete_ntt_tpu_torch.ops import ntt_dispatch

MASK128 = (1 << 128) - 1


def _planar(seed: int, batch: int, n: int) -> tuple:
    """Full-range u128 polynomials [batch, n] as four uint32 planes."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(-(1 << 31), 1 << 31, (batch, n), dtype=torch.int32,
                               generator=gen).view(torch.uint32) for _ in range(4))


def _from_ints(rows) -> tuple:
    """Lists of Python ints below 2^128 → four uint32 planes [len(rows), n]."""
    return tuple(torch.tensor([[(v >> (32 * j)) & 0xFFFFFFFF for v in row] for row in rows],
                              dtype=torch.int64).to(torch.uint32) for j in range(4))


def _to_ints(planes) -> list:
    """Four uint32 planes [B, n] → lists of Python ints."""
    words = [p.view(torch.int32).to(torch.int64) & 0xFFFFFFFF for p in planes]
    return [[sum(int(w[r, k]) << (32 * j) for j, w in enumerate(words))
             for k in range(planes[0].shape[1])] for r in range(planes[0].shape[0])]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _polymul(n: int, lhs, rhs):
    plan = native128.Plan32.try_new(n, device="cpu")
    assert plan is not None
    return plan.negacyclic_polymul(lhs, rhs)


SIZES = [(1 << k, 1 + k % 3) for k in range(5, 12)]  # (n, B): 2^5 .. 2^11, B 1-3


@pytest.mark.parametrize("n,batch", SIZES, ids=[f"n{n}-b{b}" for n, b in SIZES])
def test_polymul_matches_the_torch_reference(n, batch):
    lhs, rhs = _planar(2 * n + batch, batch, n), _planar(3 * n + batch, batch, n)
    route = ntt_dispatch.route32(n, native128.Plan32.try_new(n, device="cpu").primes)
    assert route == ("K1" if n >= 1 << 11 else None)
    got = _polymul(n, lhs, rhs)
    assert all(g.dtype == torch.uint32 and g.shape == (batch, n) for g in got)
    assert _equal(got, negacyclic_polymul_u128(lhs, rhs))


def _extreme(pattern: str, n: int) -> list:
    if pattern == "all-max":
        return [MASK128] * n
    if pattern == "alternating":
        return [0 if k % 2 == 0 else MASK128 for k in range(n)]
    return [1] + [0] * (n - 1)  # "single-one"


@pytest.mark.parametrize("n", [64, 1 << 11])
@pytest.mark.parametrize("pattern", ["all-max", "alternating", "single-one"])
def test_polymul_at_the_extremes(pattern, n):
    """Both operands at an extreme of the range, and the extreme times
    full-range values: the port equals the reference; (2^128 - 1) in every
    coefficient squares to 2k + 2 - n mod 2^128, and 1 is the identity."""
    ext = _from_ints([_extreme(pattern, n)])
    rand = _planar(n + len(pattern), 1, n)
    # one batch of three products: ext·ext, ext·rand, rand·ext
    lhs = tuple(torch.cat(p) for p in zip(ext, ext, rand))
    rhs = tuple(torch.cat(p) for p in zip(ext, rand, ext))
    want = negacyclic_polymul_u128(lhs, rhs)
    assert _equal(_polymul(n, lhs, rhs), want)
    if pattern == "all-max":
        assert _to_ints(tuple(w[:1] for w in want)) == [[(2 * k + 2 - n) & MASK128 for k in range(n)]]
    if pattern == "single-one":
        assert all(_equal(tuple(w[r:r + 1] for w in want), rand) for r in (1, 2))


@pytest.mark.parametrize("n", [8, 64])
def test_reference_matches_the_bigint_oracle(n):
    rnd = random.Random(n)
    lhs = [[rnd.getrandbits(128) for _ in range(n)] for _ in range(2)]
    rhs = [[rnd.getrandbits(128) for _ in range(n)] for _ in range(2)]
    lhs[1][0] = rhs[1][n - 1] = MASK128  # the top of the range in the wrap-around term
    got = _to_ints(negacyclic_polymul_u128(_from_ints(lhs), _from_ints(rhs)))
    assert got == [negacyclic_convolution_wrapping(a, b, 128) for a, b in zip(lhs, rhs)]


def test_reference_refuses_other_than_four_planes():
    x = _planar(1, 1, 8)
    with pytest.raises(ValueError, match="four uint32"):
        negacyclic_polymul_u128(x[:2], x)
