"""The control of the u128 check: native128's product computed in float64, as
a float64 FFT backend would, instead of in exact integers. Each u128 operand
is rounded to one float64 (53 of its 128 bits kept), the product goes
through the twisted complex FFT of `float64.negacyclic_conv`, and the
result is reduced mod 2^128 in float64 and split into four u32 words. At
full range the float64 product's last kept bit lies far above 2^128, so
what is left mod 2^128 has nothing of the exact value: `correct` has to
come out false when this stands in for the port (`ntt_bench/control.py`).
"""

from __future__ import annotations

import torch

from .float64 import negacyclic_conv

TOP = 2.0 ** 128


def _value(words) -> torch.Tensor:
    return sum(w.to(torch.float64) * 2.0 ** (32 * j) for j, w in enumerate(words))


def polymul_u128(a_words, b_words) -> tuple:
    """Four int64 words in [0, 2^32) (low first) of the float64 product mod
    2^128 of two u128 polynomials given as four such words each."""
    v = torch.remainder(negacyclic_conv(_value(a_words), _value(b_words)), TOP)
    out = []
    for j in (3, 2, 1, 0):  # highest word first: each taken off what is left
        w = torch.clamp(torch.floor(v / 2.0 ** (32 * j)), 0, 2.0 ** 32 - 1)
        v = v - w * 2.0 ** (32 * j)
        out.append(w.to(torch.int64))
    return tuple(reversed(out))
