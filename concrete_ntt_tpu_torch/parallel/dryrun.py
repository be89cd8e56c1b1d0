"""All four sharded paths once, at a small size: the twin of the JAX
package's `__graft_entry__.dryrun_multichip` (with `_dryrun_channels`,
`_dryrun_mxu` and `_dryrun_hybrid`).

Every rank of a `torch.distributed` world calls `dryrun(mesh)` with the same
`DeviceMesh`, whose dims are among "dp", "ch" and "sp" (a dim left out is
size 1, and a path on a mesh dim it does not shard over repeats its work on
the ranks along that dim, as a JAX array replicated there does). Each path
is held against the single-device plan on the same inputs, which every
rank makes from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native64, native128
from ..ops import crt as crt_ops
from ..ops import ntt_dispatch
from ..ops.u32 import limbs_to_np_u64, np_u64_to_limbs, to_i64, to_u32
from ..tables import PRIMES52
from . import _dist
from .channels import ChannelShardedNative
from .fourstep import make_sharded_prime32
from .fourstep_mxu import make_sharded_prime32_mxu


def dryrun(mesh, device=None) -> None:
    """Run the channel-sharded native128 polymul (dp x ch x sp), the native64
    polymul through one sharded GEMM four-step a channel (dp x sp), the same
    through the stage four-step, and a dp-sharded prime64 transform pair at
    n = 2^15; raise where one differs from the single-device plan."""
    dev = _dist.rank_device(device)
    _dryrun_channels(mesh, dev)
    for make, n in ((make_sharded_prime32_mxu, 4096), (make_sharded_prime32, 1024)):
        _dryrun_native64(mesh, dev, make, n)
    _dryrun_dp64(mesh, dev)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what} differs from the single-device plan")


def _dryrun_channels(mesh, dev) -> None:
    """The north-star configuration (BASELINE.json configs[4]) at a small
    size: native128 with its ten channels over `ch`, the batch over `dp`,
    the four-step over `sp`. Skipped where `ch` does not divide ten."""
    n = 4096
    plan = native128.Plan32.try_new(n, device=dev)
    if len(plan.primes) % _dist.size(mesh, "ch"):
        return
    sharded = ChannelShardedNative(plan, mesh, ch_axis="ch", batch_axis="dp", sp_axis="sp",
                                   device=dev)
    rng = np.random.default_rng(0)
    b = 2 * _dist.size(mesh, "dp")
    lhs, rhs = (torch.from_numpy(rng.integers(0, 1 << 32, (b, n, 4), dtype=np.uint32))
                for _ in range(2))
    out = sharded.negacyclic_polymul(lhs.to(dev), rhs.to(dev))
    _check(out.shape == (b, n, 4) and torch.equal(
        out, plan.negacyclic_polymul(lhs.to(dev), rhs.to(dev))), "channel-sharded native128")


def native64_polymul(plan, channels: list, lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """The wrapping product of numpy uint64 [B, n] operands (every rank
    passes the whole) under a native64 Plan32 whose CRT channels are each
    transformed by one sharded four-step (`channels[i]` = the (fwd, inv,
    to_dist, from_dist) of `plan.plans[i]`): split, fwd, pointwise, inv,
    reconstruct. Every rank returns the whole product."""
    dev = plan.device
    res_l, res_r = (plan._split(tuple(torch.from_numpy(np_u64_to_limbs(v)).to(dev).unbind(-1)))
                    for v in (lhs, rhs))
    prods = []
    for pl, (fwd, inv, to_dist, from_dist), a, c in zip(plan.plans, channels, res_l, res_r):
        prod = pl.mul_assign_normalize(fwd(to_dist(a)), fwd(to_dist(c)))
        prods.append(to_i64(from_dist(inv(prod))))
    lo, hi = crt_ops.rec_u64_from5(prods, plan.primes)
    return limbs_to_np_u64(torch.stack([to_u32(lo), to_u32(hi)], dim=-1).cpu().numpy())


def _dryrun_native64(mesh, dev, make, n: int) -> None:
    """The native64 polymul with each CRT channel's transforms sharded by
    `make` (batch over dp, the transform over sp)."""
    plan = native64.Plan32.try_new(n, device=dev)
    channels = [make(pl, mesh, axis="sp", batch_axis="dp", device=dev) for pl in plan.plans]
    rng = np.random.default_rng(0)
    b = 2 * _dist.size(mesh, "dp")
    lhs, rhs = (rng.integers(0, 1 << 64, (b, n), dtype=np.uint64) for _ in range(2))
    got = native64_polymul(plan, channels, lhs, rhs)
    _check(got.shape == (b, n) and np.array_equal(got, plan.negacyclic_polymul(lhs, rhs)),
           f"native64 through {make.__name__} at n={n}")


def _dryrun_dp64(mesh, dev) -> None:
    """A dp-sharded prime64 fwd + inv at n = 2^15 on each rank's batch row
    (the four-step kernel K5 on the card; in the JAX package the stage-split
    hybrid tier, forced there at this size): inv(fwd(x)) == n·x mod p."""
    n, p = 1 << 15, PRIMES52[0]
    dp = _dist.size(mesh, "dp")
    x = np.random.default_rng(3).integers(0, 1 << 64, (dp, n), dtype=np.uint64)
    row = x[_dist.axis_index(mesh, "dp")][None]
    limbs = torch.from_numpy(np_u64_to_limbs(row)).to(dev)
    f = ntt_dispatch.try_fwd64((limbs[..., 0].contiguous(), limbs[..., 1].contiguous()), n, p)
    back = ntt_dispatch.try_inv64(f, n, p, scale=1)
    got = limbs_to_np_u64(torch.stack(back, dim=-1).cpu().numpy())
    want = np.array([int(v) * n % p for v in row[0]], dtype=np.uint64)
    _check(got.shape == (1, n) and np.array_equal(got[0], want), f"prime64 round trip at n={n}")
