"""Radix-2 NTT stage engine, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/engine.py`: every stage is a reshape of
the [B, n] batch into [B, m, 2, t] blocks, one vectorized butterfly over all
blocks, and a re-interleave. It is the plain twin of the butterfly kernel K4
(ops/butterfly32_cuda.py) and the route the prime32 plan takes on the CPU
where the four-step engine declines.

A value is a tuple of u32 carrier tensors (ops/u32.py); a butterfly is a
callable on such tuples (ops/butterflies32.py). Stage structure and twiddle
indexing are the reference's:
  fwd: m blocks doubling 1 -> n/2, block width 2t halving; block i uses
       twid[m + i]; output bit-reversed (fwd_breadth_first_scalar,
       prime32/shoup.rs:582-636).
  inv: m halving n/2 -> 1, t doubling 1 -> n/2; block i uses inv_twid[m + i]
       (inv_breadth_first_scalar, prime32/shoup.rs:1355-1408).
The last butterfly runs at s == log2 n - 1 going forward and at s == 0 going
back. `first_stage` / `last_stage` run a sub-range of stages (the seam of the
sharded four-step transform).
"""

from __future__ import annotations

from typing import Callable

import torch

Parts = tuple  # tuple of [B, n] int64 carrier tensors
Butterfly = Callable[[Parts, Parts, Parts], tuple[Parts, Parts]]


def _stage(parts: Parts, twid_parts: Parts, bf: Butterfly, s: int) -> Parts:
    b, n = parts[0].shape
    m = 1 << s
    t = n >> (s + 1)
    z0 = tuple(a.reshape(b, m, 2, t)[:, :, 0, :] for a in parts)
    z1 = tuple(a.reshape(b, m, 2, t)[:, :, 1, :] for a in parts)
    w = tuple(tw[m : 2 * m][None, :, None] for tw in twid_parts)
    y0, y1 = bf(z0, z1, w)
    return tuple(torch.stack([a, c], dim=2).reshape(b, n) for a, c in zip(y0, y1))


def fwd_stages(
    parts: Parts,
    twid_parts: Parts,
    butterfly: Butterfly,
    last_butterfly: Butterfly,
    *,
    first_stage: int = 0,
    last_stage: int | None = None,
) -> Parts:
    """Run forward CT stages [first_stage, last_stage) on [B, n] value parts."""
    log2n = parts[0].shape[1].bit_length() - 1
    stop = log2n if last_stage is None else last_stage
    for s in range(first_stage, stop):
        bf = last_butterfly if s == log2n - 1 else butterfly
        parts = _stage(parts, twid_parts, bf, s)
    return parts


def inv_stages(
    parts: Parts,
    twid_parts: Parts,
    butterfly: Butterfly,
    last_butterfly: Butterfly,
    *,
    first_stage: int | None = None,
    last_stage: int = 0,
) -> Parts:
    """Run inverse GS stages from stage first_stage-1 down to last_stage.

    Inverse stage s undoes forward stage s: m = 2^s blocks, t = n/2^(s+1),
    butterfly (z0, z1) -> (z0+z1, (z0-z1)·w) with w = inv_twid[m + i]."""
    log2n = parts[0].shape[1].bit_length() - 1
    start = log2n if first_stage is None else first_stage
    for s in range(start - 1, last_stage - 1, -1):
        bf = last_butterfly if s == 0 else butterfly
        parts = _stage(parts, twid_parts, bf, s)
    return parts
