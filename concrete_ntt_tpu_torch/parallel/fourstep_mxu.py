"""The sharded four-step NTT on GEMM passes, one rank a process.

Counterpart of `concrete_ntt_tpu/parallel/fourstep_mxu.py`. The four-step
factorization column pass -> diagonal -> row pass is the distributed
decomposition (N = n1 x n2, the inter-factor transpose as the collective):

  * values [B, n1, n2] are sharded on the columns (n2): the column pass
    contracts n1 and is local to a rank's columns;
  * the four-step diagonal is elementwise, with the rank's rows of d;
  * ONE tiled all-to-all (`_dist.all_to_all_tiled`) moves the n2-sharding
    to an n1-sharding;
  * the row pass contracts n2 and is local to the rank's rows.

The layouts alternate stably: values [b, n1, n2 / s] <-> NTT domain
[b, n1 / s, n2], so fwd -> pointwise -> inv needs one all-to-all a
transform and the pointwise product is local. The batch shards over a
data-parallel dim independently.

Each pass is one GEMM pass kernel: K3 (`mxu32_cuda.pass_matmod`,
`csrc/mxu32_pass.cu` `k3_pass`) for a 32-bit prime, K6
(`mxu64_cuda.pass_matmod64`, `csrc/mxu64_pass.cu` `k6_pass`) for a 64-bit
one, on (lo, hi) limb pairs; on CPU tensors their plain versions. The local
sections are module functions (`col_pass`, `row_pass`, `row_pass_inv`,
`col_pass_inv` and their `*64` twins), so that the channel-sharded plans
(`channels.py`) and a single process that holds several ranks call the
same pass sequence.

Results are bit-identical to the single-device four-step (the JAX package's
sharded functions and the port's plans, by test).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mxu32, mxu32_cuda, mxu64, mxu64_cuda
from . import _dist


def transposed(x: torch.Tensor) -> torch.Tensor:
    """The last two axes swapped, as a fresh contiguous tensor (the GEMM
    passes copy 16-byte chunks from an aligned start)."""
    return x.transpose(1, 2).contiguous()


def _check_split(n1: int, n2: int, s: int) -> None:
    if n2 % s or n1 % s:
        raise ValueError(f"mesh axis size {s} must divide n1={n1} and n2={n2}")


def diag_rows(tabs, r: int, rows: int, device) -> tuple:
    """Rows r·rows .. (r+1)·rows of each diagonal table (d [n2, n1] on a
    rank's columns, e [n1, n2] on its rows), on `device`: the rank's shard
    of `P(axis, None)`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a[r * rows:(r + 1) * rows])).to(device)
                 for a in tabs)


# -- 32-bit local sections (K3) -------------------------------------------------


def col_pass(v, d_loc: tuple, *, n: int, p: int) -> torch.Tensor:
    """Forward column pass A with the rank's rows of d: v [b, n2 / s, n1]
    (the value shard transposed; a limb tuple for a wide operand) -> lazy
    representatives [b, n2 / s, n1]."""
    n_limbs = len(v) if isinstance(v, tuple) else 1
    return mxu32_cuda.pass_matmod(v, n=n, p=p, which="A", diag_slices=d_loc, n_limbs=n_limbs)


def row_pass(y: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Forward row pass F after the exchange: y [b, n2, n1 / s] -> canonical
    NTT-domain rows [b, n1 / s, n2] (bit-reversed when flattened)."""
    return mxu32_cuda.pass_matmod(transposed(y), n=n, p=p, which="F")


def row_pass_inv(x: torch.Tensor, e_loc: tuple, *, n: int, p: int) -> torch.Tensor:
    """Inverse row pass G with the rank's rows of e: x [b, n1 / s, n2] (any
    u32) -> lazy representatives [b, n1 / s, n2]."""
    return mxu32_cuda.pass_matmod(x, n=n, p=p, which="G", diag_slices=e_loc)


def col_pass_inv(y: torch.Tensor, *, n: int, p: int, scale: int = 1) -> torch.Tensor:
    """Inverse column pass A_inv (times `scale`) after the exchange:
    y [b, n1, n2 / s] -> canonical values [b, n1, n2 / s], standard order."""
    out = mxu32_cuda.pass_matmod(transposed(y), n=n, p=p, which="Ainv", scale=scale)
    return transposed(out)


# -- 64-bit local sections (K6), on (lo, hi) limb pairs ----------------------------


def col_pass64(v: tuple, d_loc: tuple, *, n: int, p: int) -> tuple:
    """`col_pass` on (lo, hi) [b, n2 / s, n1] (any u64)."""
    return mxu64_cuda.pass_matmod64(v, n=n, p=p, which="A", diag_slices=d_loc)


def row_pass64(y: tuple, *, n: int, p: int) -> tuple:
    """`row_pass` on (lo, hi) [b, n2, n1 / s] -> canonical [b, n1 / s, n2]."""
    return mxu64_cuda.pass_matmod64(tuple(transposed(a) for a in y), n=n, p=p, which="F")


def row_pass_inv64(x: tuple, e_loc: tuple, *, n: int, p: int) -> tuple:
    """`row_pass_inv` on (lo, hi) [b, n1 / s, n2] (any u64)."""
    return mxu64_cuda.pass_matmod64(x, n=n, p=p, which="G", diag_slices=e_loc)


def col_pass_inv64(y: tuple, *, n: int, p: int, scale: int = 1) -> tuple:
    """`col_pass_inv` on (lo, hi) [b, n1, n2 / s] -> canonical [b, n1, n2 / s]."""
    out = mxu64_cuda.pass_matmod64(tuple(transposed(a) for a in y), n=n, p=p, which="Ainv",
                                   scale=scale)
    return tuple(transposed(a) for a in out)


def exchange64(mesh, y: tuple, dim) -> tuple:
    """The all-to-all of a limb pair as one collective: stacked on a last
    axis, split on axis 2, concatenated on axis 1 (the passes after it
    transpose each limb into a fresh tensor)."""
    return _dist.all_to_all_tiled(mesh, torch.stack(y, dim=-1), dim, 2, 1).unbind(-1)


# -- the sharded transforms ---------------------------------------------------------


def make_sharded_prime32_mxu(plan, mesh, axis: str = "sp", batch_axis=None, device=None):
    """(fwd, inv, to_dist, from_dist) for one prime32 channel on this rank.

    fwd: the rank's value shard [b, n1, n2 / s] -> its NTT-domain shard
         [b, n1 / s, n2] (bit-reversed layout when the whole is flattened).
    inv: the exact mirror (unnormalized).
    to_dist: the whole [B, n] (any device; every rank passes the same) ->
         the rank's value shard on its device; with `ntt=True` its
         NTT-domain shard (what inv takes).
    from_dist: a value or NTT-domain shard -> the whole [B, n], gathered on
         every rank (what the JAX caller sees as one global array).
    `device`: as `_dist.rank_device`.
    """
    n, p = plan.n, plan.p
    n1, n2 = mxu32.four_step_factors(n)
    s = _dist.size(mesh, axis)
    _check_split(n1, n2, s)
    dev = _dist.rank_device(device)
    r = _dist.axis_index(mesh, axis)
    tbl = mxu32._mxu_tables(n, p)
    d_loc = diag_rows(tbl["d"], r, n2 // s, dev)  # [n2 / s, n1]
    e_loc = diag_rows(tbl["e"], r, n1 // s, dev)  # [n1 / s, n2]

    def fwd(x_loc):
        y = col_pass(transposed(x_loc), d_loc, n=n, p=p)
        return row_pass(_dist.all_to_all_tiled(mesh, y, axis, 2, 1), n=n, p=p)

    def inv(x_loc):
        y = row_pass_inv(x_loc, e_loc, n=n, p=p)
        return col_pass_inv(_dist.all_to_all_tiled(mesh, y, axis, 2, 1), n=n, p=p)

    return (fwd, inv, *_dist.layout(mesh, n1, n2, batch_axis, axis, dev))


def make_sharded_prime64_mxu(plan, mesh, axis: str = "sp", batch_axis=None, device=None):
    """(fwd, inv, to_dist, from_dist) for one prime64 channel on this rank:
    the 64-bit twin of `make_sharded_prime32_mxu` on u64 limb pairs.

    fwd: [b, n1, n2 / s, 2] values -> [b, n1 / s, n2, 2] NTT domain; inv
    mirrors; one all-to-all a transform. to_dist / from_dist: the whole
    [B, n, 2] <-> the rank's shard.
    """
    n, p = plan.n, plan.p
    n1, n2 = mxu64.four_step_factors(n)
    s = _dist.size(mesh, axis)
    _check_split(n1, n2, s)
    dev = _dist.rank_device(device)
    r = _dist.axis_index(mesh, axis)
    tbl = mxu64._tables(n, p)
    d_loc = diag_rows(tbl["d"], r, n2 // s, dev)
    e_loc = diag_rows(tbl["e"], r, n1 // s, dev)

    def fwd(x_loc):
        y = col_pass64(tuple(transposed(x_loc[..., i]) for i in range(2)), d_loc, n=n, p=p)
        return torch.stack(row_pass64(exchange64(mesh, y, axis), n=n, p=p), dim=-1)

    def inv(x_loc):
        y = row_pass_inv64(tuple(x_loc[..., i].contiguous() for i in range(2)), e_loc, n=n, p=p)
        return torch.stack(col_pass_inv64(exchange64(mesh, y, axis), n=n, p=p), dim=-1)

    return (fwd, inv, *_dist.layout(mesh, n1, n2, batch_axis, axis, dev))
