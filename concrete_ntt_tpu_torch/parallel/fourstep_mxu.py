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

Each pass is one GEMM pass kernel: K3's channel grid
(`mxu32_cuda.pass_matmod_multi`, `csrc/mxu32_pass.cu` `k3_pass_multi`)
for a 32-bit prime, K6's (`mxu64_cuda.pass_matmod64_multi`,
`csrc/mxu64_pass.cu` `k6_pass_multi`) for a 64-bit one, on (lo, hi) limb
pairs, here with one channel; on CPU tensors their plain versions. The
passes read and write the four-step's transposes as strides: A reads the
value shard [b, n1, n2 / s] in place, F the exchange's [b, n2, n1 / s],
A_inv the exchange's [b, n1, n2 / s] and writes the value shard [b, n1,
n2 / s] directly. The local sections are module functions (`col_pass`,
`row_pass`, `row_pass_inv`, `col_pass_inv` and their `*64` twins), so
that a single process that holds several ranks calls the same pass
sequence; the channel-sharded plans (`channels.py`) make the same passes
over all of a rank's channels in one launch each.

Results are bit-identical to the single-device four-step (the JAX package's
sharded functions and the port's plans, by test).
"""

from __future__ import annotations

import torch

from ..ops import mxu32, mxu32_cuda, mxu64, mxu64_cuda
from . import _dist


def _check_split(n1: int, n2: int, s: int) -> None:
    if n2 % s or n1 % s:
        raise ValueError(f"mesh axis size {s} must divide n1={n1} and n2={n2}")


def _cols(v):
    """The value shard [b, n1, c] (or a tuple of limbs) as the column
    pass's operand [b, c, n1]: transposed views, read in place."""
    return tuple(a.transpose(1, 2) for a in v) if isinstance(v, tuple) else v.transpose(1, 2)


# -- 32-bit local sections (K3 on one channel) ---------------------------------


def col_pass(v, d_loc: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Forward column pass A with the rank's rows of d: v the value shard
    [b, n1, n2 / s] (a limb tuple for a wide operand), contracting n1 at
    stride n2 / s in place; d_loc the rank's rows of d (`mxu32_cuda.
    multi_diag(n, (p,), "A", r·n2/s, n2/s, device)`) -> lazy representatives
    [b, n2 / s, n1]."""
    return mxu32_cuda.pass_matmod_multi(_cols(v), n=n, primes=(p,), which="A", diag=d_loc)[0]


def row_pass(y: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Forward row pass F after the exchange: y [b, n2, n1 / s] read in
    place -> canonical NTT-domain rows [b, n1 / s, n2] (bit-reversed when
    flattened)."""
    return mxu32_cuda.pass_matmod_multi(y.transpose(1, 2), n=n, primes=(p,), which="F")[0]


def row_pass_inv(x: torch.Tensor, e_loc: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Inverse row pass G with the rank's rows of e (`multi_diag(n, (p,),
    "G", r·n1/s, n1/s, device)`): x [b, n1 / s, n2] (any u32) -> lazy
    representatives [b, n1 / s, n2]."""
    return mxu32_cuda.pass_matmod_multi(x, n=n, primes=(p,), which="G", diag=e_loc)[0]


def col_pass_inv(y: torch.Tensor, *, n: int, p: int, scale: int = 1) -> torch.Tensor:
    """Inverse column pass A_inv (times `scale`) after the exchange: y [b, n1,
    n2 / s] read in place -> canonical values [b, n1, n2 / s], standard
    order, written at row stride 1."""
    return mxu32_cuda.pass_matmod_multi(y.transpose(1, 2), n=n, primes=(p,), which="Ainv",
                                        scales=(scale,), transposed_out=True)[0]


# -- 64-bit local sections (K6 on one channel), on (lo, hi) limb pairs --------------


def _first(pair: tuple) -> tuple:
    return pair[0][0], pair[1][0]


def col_pass64(v: tuple, d_loc: torch.Tensor, *, n: int, p: int) -> tuple:
    """`col_pass` on the (lo, hi) value shard [b, n1, n2 / s] (any u64)."""
    return _first(mxu64_cuda.pass_matmod64_multi(_cols(v), n=n, primes=(p,), which="A",
                                                 diag=d_loc))


def row_pass64(y: tuple, *, n: int, p: int) -> tuple:
    """`row_pass` on (lo, hi) [b, n2, n1 / s] -> canonical [b, n1 / s, n2]."""
    return _first(mxu64_cuda.pass_matmod64_multi(_cols(y), n=n, primes=(p,), which="F"))


def row_pass_inv64(x: tuple, e_loc: torch.Tensor, *, n: int, p: int) -> tuple:
    """`row_pass_inv` on (lo, hi) [b, n1 / s, n2] (any u64)."""
    return _first(mxu64_cuda.pass_matmod64_multi(x, n=n, primes=(p,), which="G", diag=e_loc))


def col_pass_inv64(y: tuple, *, n: int, p: int, scale: int = 1) -> tuple:
    """`col_pass_inv` on (lo, hi) [b, n1, n2 / s] -> canonical [b, n1, n2 / s]."""
    return _first(mxu64_cuda.pass_matmod64_multi(_cols(y), n=n, primes=(p,), which="Ainv",
                                                 scales=(scale,), transposed_out=True))


def exchange64(mesh, y: tuple, dim) -> tuple:
    """The all-to-all of a limb pair as one collective: stacked on a leading
    axis [2, b, rows, cols], split on the columns, concatenated on the rows;
    the limbs come back as views of one tensor, which the passes after it
    read in place."""
    return _dist.all_to_all_tiled(mesh, torch.stack(y), dim, 3, 2).unbind(0)


def planar(x: torch.Tensor) -> tuple:
    """A [b, rows, cols, 2] limb shard as its (lo, hi) planes: one copy
    [2, b, rows, cols], the limbs views of it."""
    return x.movedim(-1, 0).contiguous().unbind(0)


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
    c, c1 = n2 // s, n1 // s
    d_loc = mxu32_cuda.multi_diag(n, (p,), "A", r * c, c, str(dev))  # [1, 4|2, n2 / s, n1]
    e_loc = mxu32_cuda.multi_diag(n, (p,), "G", r * c1, c1, str(dev))  # [1, 4|2, n1 / s, n2]

    def fwd(x_loc):
        y = col_pass(x_loc, d_loc, n=n, p=p)
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
    c, c1 = n2 // s, n1 // s
    d_loc = mxu64_cuda.multi_diag(n, (p,), "A", r * c, c, str(dev))
    e_loc = mxu64_cuda.multi_diag(n, (p,), "G", r * c1, c1, str(dev))

    def fwd(x_loc):
        y = col_pass64(planar(x_loc), d_loc, n=n, p=p)
        return torch.stack(row_pass64(exchange64(mesh, y, axis), n=n, p=p), dim=-1)

    def inv(x_loc):
        y = row_pass_inv64(planar(x_loc), e_loc, n=n, p=p)
        return torch.stack(col_pass_inv64(exchange64(mesh, y, axis), n=n, p=p), dim=-1)

    return (fwd, inv, *_dist.layout(mesh, n1, n2, batch_axis, axis, dev))
