"""CRT residue channels sharded across ranks (the north-star multi-chip
configuration, BASELINE.json configs[4]).

Counterpart of `concrete_ntt_tpu/parallel/channels.py`. The k CRT channels
of a native plan are independent between the residue split and the
reconstruction, so they shard across ranks:

  * k over a `ch` mesh dim (a rank holds primes[c·k/ch : (c+1)·k/ch] for its
    `ch` coordinate c),
  * B over a `dp` mesh dim (data parallel),
  * the four-step factor over an `sp` mesh dim, with ONE tiled all-to-all a
    transform over all the rank's channels (`fourstep_mxu`'s decomposition).

split -> fwd -> pointwise -> inv run on the rank's shards; the only
cross-channel collective is the all-gather of the k standard-order residues
before the CRT lift (and, with dp, the gather of the lifted rows, the
whole array the JAX caller sees).

A rank's channels go through each pass kind in one GEMM pass launch, the
channel on the grid's z axis: for Plan32 channels K3's channel grid
(`mxu32_cuda.pass_matmod_multi`): fwd = A with the operand's 1, 2 or 4
limbs shared by all channels (the residue split folded into each
channel's column matmul) and the rank's rows of d, then F; inv = G with
the rank's rows of e, then A_inv with the scale n^-1·2^32 mod p
(normalization and the Montgomery factor of the pointwise product, as the
JAX package folds it). Plan52 channels take K6's
(`mxu64_cuda.pass_matmod64_multi`) the same way on (x, 0) or (lo, hi)
limb pairs, with n^-1·2^64, where every local prime has one digit and
operand plane count (`route` "grid", the JAX package's channel-grid
condition); else one launch a channel (`route` "per-channel"). The
passes read the four-step's transposes as strides (A the value shards, F
and A_inv the exchange's output in place; A_inv writes the value layout
directly). The outputs of F and A_inv are canonical, so the result is
bit-identical to the single-device plan's (and to the JAX package's
sharded classes, by test). The pointwise Montgomery product is plain torch
on the rank's device, as it is XLA code in the JAX package.
"""

from __future__ import annotations

import torch

from .._native_common import _marshal_in, _marshal_out
from ..ops import mxu32, mxu32_cuda, mxu64, mxu64_cuda
from ..ops.u32 import mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32
from . import _dist


def route52(n: int, primes: tuple) -> str:
    """How `ChannelShardedNative52` runs a rank's channels through K6:
    "grid" (one launch a pass over all of them) where every prime has one
    digit and operand plane count (`mxu64.multi_applicable`, the condition
    of the JAX package's channel grid, `mxu64_pallas.py:460-470`), else
    "per-channel" (one launch a pass a channel). Decided from n and the
    primes alone, the same on every device."""
    return "grid" if mxu64.multi_applicable(n, tuple(primes)) else "per-channel"


class _ChannelSharded:
    """What both tiers share: mesh validation, the rank's channels and
    diagonal rows, the shards, the gather and the lift."""

    _bits = 32  # the Montgomery radix of the pointwise product, 2^bits
    _diag = staticmethod(mxu32_cuda.multi_diag)

    def __init__(self, plan, mesh, ch_axis, batch_axis, sp_axis, device):
        n, primes = plan.n, tuple(plan.primes)
        k = len(primes)
        cs = _dist.size(mesh, ch_axis)
        if k % cs:
            raise ValueError(f"{k} channels must divide over ch={cs}")
        self.plan, self.mesh = plan, mesh
        self.ch, self.dp, self.sp = ch_axis, batch_axis, sp_axis
        s = _dist.size(mesh, sp_axis)
        self.n1, self.n2 = mxu32.four_step_factors(n)
        if self.n2 % s or self.n1 % s:
            raise ValueError(f"sp={s} must divide n1={self.n1} and n2={self.n2}")
        self.device = _dist.rank_device(device)
        k_loc = k // cs
        c = _dist.axis_index(mesh, ch_axis)
        self.primes_loc = primes[c * k_loc:(c + 1) * k_loc]
        # n^-1·2^bits: normalization + Montgomery compensation, folded into A_inv
        self.scales = tuple(pow(n, p - 2, p) * pow(2, self._bits, p) % p for p in self.primes_loc)
        r = _dist.axis_index(mesh, sp_axis)
        c, c1 = self.n2 // s, self.n1 // s
        # the rank's rows of every local channel's d and e, [k_loc, planes, rows, O]
        self._d = self._diag(n, self.primes_loc, "A", r * c, c, str(self.device))
        self._e = self._diag(n, self.primes_loc, "G", r * c1, c1, str(self.device))

    def _shard(self, parts) -> tuple:
        """Whole [B, n] limbs -> the rank's value shards [b, n1, n2 / s]."""
        return tuple(_dist.to_dist(self.mesh, a, self.n1, self.n2, self.dp, self.sp, self.device)
                     for a in parts)

    def _lift(self, res: torch.Tensor, lead, fmt):
        """Standard-order residues [k_loc, b, n1, n2 / s(, 2)] -> the wrapping
        product in `fmt`: gather the channels and columns, lift the rank's
        rows, gather the rows."""
        plan = self.plan
        res = _dist.all_gather(self.mesh, res, (self.ch, 0), (self.sp, 3))
        k, b = res.shape[:2]
        res = to_i64(res.reshape(k, b, plan.n, *res.shape[4:]))
        mods = [res[i] if res.dim() == 3 else (res[i, ..., 0], res[i, ..., 1]) for i in range(k)]
        value_parts = plan._reconstruct(mods)
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        parts = _dist.all_gather(self.mesh, to_u32(torch.stack(value_parts)), (self.dp, 1))
        return _marshal_out(tuple(parts), lead, fmt, plan.n)

    def negacyclic_polymul(self, lhs, rhs):
        """End-to-end wrapping negacyclic product on the mesh, in the format
        of `lhs`; every rank passes the whole operands and returns the whole
        product. The transform pipeline runs on the rank's shards; the CRT
        reconstruction all-gathers the k standard-order residues (the only
        cross-channel collective)."""
        parts_l, lead, fmt = _marshal_in(lhs, self.plan.width, self.plan.n, self.device)
        parts_r, _, _ = _marshal_in(rhs, self.plan.width, self.plan.n, self.device)
        fl = self._fwd_local(self._shard(parts_l))
        fr = self._fwd_local(self._shard(parts_r))
        return self._lift(self._inv_local(self._pointwise(fl, fr)), lead, fmt)


class ChannelShardedNative(_ChannelSharded):
    """Sharded negacyclic polymul for a plan32-tier native plan.

    Mesh dims: `ch_axis` shards the CRT channels, `batch_axis` the batch
    (optional), `sp_axis` the four-step transform with one all-to-all a
    transform (optional). Dims not in the mesh are unsharded. `device`: the
    rank's device (`_dist.rank_device`).

    I/O: the value formats of the underlying plan (numpy uint64 [B, n],
    uint32 limb tensors [B, n, nlimbs], planar limb tuples, uint32 [B, n]);
    `negacyclic_polymul` returns the wrapping product in the input format.
    """

    def __init__(self, plan, mesh, ch_axis: str = "ch", batch_axis=None, sp_axis=None,
                 device=None):
        if plan.tier != "plan32":
            raise ValueError("channel sharding requires a plan32-tier plan")
        if not all((1 << 29) < p < (1 << 30) for p in plan.primes):
            raise ValueError("channel sharding needs 30-bit table primes")
        super().__init__(plan, mesh, ch_axis, batch_axis, sp_axis, device)

    # -- local (per-rank) sections ------------------------------------------

    def _fwd_local(self, parts) -> list:
        """parts: n_limbs x [b, n1, n2 / s] value shards -> per local channel
        the NTT-domain rows [b, n1 / s, n2] (bit-reversed when flattened):
        one A launch over the channels, the exchange, one F launch."""
        n, primes = self.plan.n, self.primes_loc
        y = mxu32_cuda.pass_matmod_multi(tuple(a.transpose(1, 2) for a in parts), n=n,
                                         primes=primes, which="A", diag=self._d)
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 3, 2)  # [k_loc, b, n2, n1 / s]
        return list(mxu32_cuda.pass_matmod_multi(y.transpose(2, 3), n=n, primes=primes,
                                                 which="F"))

    def _inv_local(self, x: list) -> torch.Tensor:
        """x: per local channel [b, n1 / s, n2] NTT-domain values (any u32) ->
        standard-order residues [k_loc, b, n1, n2 / s] (scaled by
        n^-1·2^32 through the folded inverse column planes): one G launch,
        the exchange, one A_inv launch."""
        n, primes = self.plan.n, self.primes_loc
        y = mxu32_cuda.pass_matmod_multi(torch.stack(x), n=n, primes=primes, which="G",
                                         diag=self._e)
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 3, 2)  # [k_loc, b, n1, n2 / s]
        return mxu32_cuda.pass_matmod_multi(y.transpose(2, 3), n=n, primes=primes, which="Ainv",
                                            scales=self.scales, transposed_out=True)

    def _pointwise(self, fl: list, fr: list) -> list:
        """fl·fr·2^-32 mod p per local channel (canonical in, canonical out)."""
        return [to_u32(mont_mul(to_i64(a), to_i64(b), p, mont_neginv(p)))
                for a, b, p in zip(fl, fr, self.primes_loc)]


class ChannelShardedNative52(_ChannelSharded):
    """Sharded negacyclic polymul for a plan52-tier native plan: the
    64-bit-channel twin of ChannelShardedNative. The k prime64 CRT channels
    (~50-bit table primes) shard over `ch`, the batch over `dp`, the
    four-step factor over `sp` with one all-to-all a transform; each local
    pass is K6 on limb pairs."""

    _bits = 64
    _diag = staticmethod(mxu64_cuda.multi_diag)

    def __init__(self, plan, mesh, ch_axis: str = "ch", batch_axis=None, sp_axis=None,
                 device=None):
        if plan.tier != "plan52":
            raise ValueError("ChannelShardedNative52 requires a plan52 plan")
        if not all((1 << 33) < p < (1 << 62) for p in plan.primes):
            raise ValueError("plan52 channel sharding needs p in (2^33, 2^62)")
        super().__init__(plan, mesh, ch_axis, batch_axis, sp_axis, device)
        self.route = route52(plan.n, self.primes_loc)
        k_loc = len(self.primes_loc)
        self._groups = ([slice(0, k_loc)] if self.route == "grid"
                        else [slice(c, c + 1) for c in range(k_loc)])

    def _pass(self, x: tuple, which: str, diag=None, **kw) -> torch.Tensor:
        """One pass kind over the rank's channels, x a limb pair [b, rows,
        K] (shared) or [k_loc, b, rows, K]: one K6 launch on the "grid"
        route, one a channel on the "per-channel" one -> the pair stacked
        [2, k_loc, b, rows, O] ([2, k_loc, b, O, rows] with
        `transposed_out`)."""
        outs = []
        for g in self._groups:
            scales = {"scales": self.scales[g]} if which == "Ainv" else {}
            outs.append(torch.stack(mxu64_cuda.pass_matmod64_multi(
                tuple(a[g] if a.dim() == 4 else a for a in x), n=self.plan.n,
                primes=self.primes_loc[g], which=which,
                diag=None if diag is None else diag[g], **scales, **kw)))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    # -- local (per-rank) sections ------------------------------------------

    def _fwd_local(self, parts) -> list:
        """parts: n_limbs x [b, n1, n2 / s] value limb shards -> per local
        channel the canonical NTT-domain limb pair [b, n1 / s, n2]."""
        if len(parts) == 1:  # u32 values: the hi limb is zero (< 2^32 < p)
            parts = (parts[0], torch.zeros_like(parts[0]))
        y = self._pass(tuple(a.transpose(1, 2) for a in parts), "A", diag=self._d)
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 4, 3)  # [2, k_loc, b, n2, n1 / s]
        f = self._pass((y[0].transpose(2, 3), y[1].transpose(2, 3)), "F")
        return [(f[0, c], f[1, c]) for c in range(f.shape[1])]

    def _inv_local(self, x: list) -> torch.Tensor:
        """x: per local channel a limb pair [b, n1 / s, n2] -> standard-order
        residues [k_loc, b, n1, n2 / s, 2] (scaled by n^-1·2^64 through the
        folded inverse column planes)."""
        y = self._pass(tuple(torch.stack([a[i] for a in x]) for i in range(2)), "G",
                       diag=self._e)
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 4, 3)  # [2, k_loc, b, n1, n2 / s]
        out = self._pass((y[0].transpose(2, 3), y[1].transpose(2, 3)), "Ainv",
                         transposed_out=True)
        return out.movedim(0, -1)

    def _pointwise(self, fl: list, fr: list) -> list:
        """fl·fr·2^-64 mod p per local channel, on limb pairs."""
        out = []
        for a, b, p in zip(fl, fr, self.primes_loc):
            lo, hi = mont_mul64(tuple(map(to_i64, a)), tuple(map(to_i64, b)), p, mont_neginv64(p))
            out.append((to_u32(lo).contiguous(), to_u32(hi).contiguous()))
        return out
