"""The stage four-step: a large prime32 transform sharded across ranks by
its butterfly stages.

Counterpart of `concrete_ntt_tpu/parallel/fourstep.py`. View the length-N
array as [N1, N2] (row-major). The first log2(N1) stages of the global
transform touch only elements whose indices differ in the N1 coordinate and
use one twiddle per row block: independent column transforms. The remaining
stages stay within rows, where row i1 at local stage s' takes the contiguous
twiddle slice twid[(N1 + i1)·2^s' + j] (the bit-reversed table is
self-similar, so no separate twiddle-correction pass is needed).

Sharding: the column stages run on the rank's N2 / D columns; one tiled
all-to-all re-tiles to rows (N1 / D a rank); the row stages run on the
rank's rows. Output order is the reference's, out[i1·N2 + j2], sharded
contiguously along the transform axis.

The stages are plain torch on the rank's device (the butterflies of
`ops/butterflies32.py` in their three regimes), as they are XLA code, not a
Pallas kernel, in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops import butterflies32 as bf32
from ..ops.u32 import to_i64, to_u32
from . import _dist


def _interleave(y0, y1, shape, axis: int) -> torch.Tensor:
    """Halves y0, y1 back into `shape`, side by side on `axis`."""
    return torch.stack([y0, y1], dim=axis).reshape(shape)


def _col_stages(parts, twid_parts, bf, lbf, n1, first, last, final_stage):
    """Forward stages [first, last) along the N1 axis of [B, N1, C] parts."""
    b, _, c = parts[0].shape
    for s in range(first, last):
        m, tr = 1 << s, n1 >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 1] for a in parts)
        w = tuple(tw[m:2 * m][None, :, None, None] for tw in twid_parts)
        use = lbf if s == final_stage else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(_interleave(a, y, (b, n1, c), 2) for a, y in zip(y0, y1))
    return parts


def _col_stages_inv(parts, twid_parts, bf, lbf, n1, first, last):
    """Inverse stages from first-1 down to last along the N1 axis."""
    b, _, c = parts[0].shape
    for s in range(first - 1, last - 1, -1):
        m, tr = 1 << s, n1 >> (s + 1)
        z0 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, m, 2, tr, c)[:, :, 1] for a in parts)
        w = tuple(tw[m:2 * m][None, :, None, None] for tw in twid_parts)
        use = lbf if s == 0 else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(_interleave(a, y, (b, n1, c), 2) for a, y in zip(y0, y1))
    return parts


def _row_stages(parts, twid_parts, bf, lbf, n1, n2, r0, direction):
    """Row-local stages on [B, R, N2] parts; global row index = r0 + r.

    Twiddles for local stage s': twid[(n1 + r0 + r)·2^s' + j], a contiguous
    slice of length R·2^s' starting at (n1 + r0)·2^s'.
    """
    b, r, _ = parts[0].shape
    log2n2 = n2.bit_length() - 1
    stages = range(log2n2) if direction == "fwd" else range(log2n2 - 1, -1, -1)
    for sp in stages:
        mp, tp = 1 << sp, n2 >> (sp + 1)
        z0 = tuple(a.reshape(b, r, mp, 2, tp)[:, :, :, 0] for a in parts)
        z1 = tuple(a.reshape(b, r, mp, 2, tp)[:, :, :, 1] for a in parts)
        start = (n1 + r0) * mp
        w = tuple(tw[start:start + r * mp].reshape(1, r, mp, 1) for tw in twid_parts)
        is_final = (sp == log2n2 - 1) if direction == "fwd" else (sp == 0)
        use = lbf if is_final and direction == "fwd" else bf
        y0, y1 = use(z0, z1, w)
        parts = tuple(_interleave(a, y, (b, r, n2), 3) for a, y in zip(y0, y1))
    return parts


def _split_n(n: int, n_devices: int) -> tuple[int, int]:
    """Choose N = N1·N2 with D | N1, D | N2, both powers of two, N1 ≈ √N."""
    log2n = n.bit_length() - 1
    log2d = n_devices.bit_length() - 1
    a = max(log2d, min(log2n - log2d, (log2n + 1) // 2))
    if a + log2d > log2n:
        raise ValueError(f"n={n} too small to shard over {n_devices} devices")
    return 1 << a, 1 << (log2n - a)


def make_sharded_prime32(plan, mesh, axis: str = "x", batch_axis: str | None = None,
                         device=None):
    """(fwd, inv, to_dist, from_dist) for a prime32 plan on this rank,
    sharded over `mesh`'s `axis` (the transform) and optionally `batch_axis`
    (data parallel).

    fwd: the rank's value shard [b, N1, N2 / D] (standard order, values < p)
         -> its shard [b, N1 / D, N2] of the bit-reversed NTT values in
         [0, p) (the reference convention, kept across the transpose).
    inv: the mirror, unnormalized.
    to_dist / from_dist: the whole [B, N] <-> the rank's shard, as in
         `fourstep_mxu`. `device`: as `_dist.rank_device`.
    """
    n, p = plan.n, plan.p
    d = _dist.size(mesh, axis)
    n1, n2 = _split_n(n, d)
    log2n1 = n1.bit_length() - 1
    dev = _dist.rank_device(device)
    fbf, flbf = bf32.make(p, plan.variant, plan.p_neginv, "fwd")
    ibf, ilbf = bf32.make(p, plan.variant, plan.p_neginv, "inv")
    names = ("twid", "twid_shoup") if plan.variant != "generic" else ("twid",)
    ftw = tuple(to_i64(torch.from_numpy(plan._tbl[k]).to(dev)) for k in names)
    itw = tuple(to_i64(torch.from_numpy(plan._tbl["inv_" + k]).to(dev)) for k in names)
    r0 = _dist.axis_index(mesh, axis) * (n1 // d)

    def fwd(x_loc):
        parts = _col_stages((to_i64(x_loc),), ftw, fbf, flbf, n1, 0, log2n1, -1)
        x_loc = _dist.all_to_all_tiled(mesh, to_u32(parts[0]), axis, 1, 2)
        return to_u32(_row_stages((to_i64(x_loc),), ftw, fbf, flbf, n1, n2, r0, "fwd")[0])

    def inv(x_loc):
        parts = _row_stages((to_i64(x_loc),), itw, ibf, ilbf, n1, n2, r0, "inv")
        x_loc = _dist.all_to_all_tiled(mesh, to_u32(parts[0]), axis, 2, 1)
        return to_u32(_col_stages_inv((to_i64(x_loc),), itw, ibf, ilbf, n1, log2n1, 0)[0])

    return (fwd, inv, *_dist.layout(mesh, n1, n2, batch_axis, axis, dev))
