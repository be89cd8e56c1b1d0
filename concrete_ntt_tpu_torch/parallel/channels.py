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

Each local channel pass is one GEMM pass kernel: for Plan32 channels K3
(`mxu32_cuda.pass_matmod`): fwd = A with the operand's 1, 2 or 4 limbs (the
residue split folded into the column matmul) and the rank's rows of d, then
F; inv = G with the rank's rows of e, then A_inv with the scale
n^-1·2^32 mod p (normalization and the Montgomery factor of the pointwise
product, as the JAX package folds it). Plan52 channels take K6
(`mxu64_cuda.pass_matmod64`) the same way on (x, 0) or (lo, hi) limb pairs,
with n^-1·2^64. The outputs of F and A_inv are canonical, so the result is
bit-identical to the single-device plan's (and to the JAX package's
sharded classes, by test). The pointwise Montgomery product is plain torch
on the rank's device, as it is XLA code in the JAX package.
"""

from __future__ import annotations

import torch

from .._native_common import _marshal_in, _marshal_out
from ..ops import mxu32, mxu64
from ..ops.u32 import mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32
from . import _dist, fourstep_mxu as fm


class _ChannelSharded:
    """What both tiers share: mesh validation, the rank's channels and
    diagonal rows, the shards, the gather and the lift."""

    _bits = 32  # the Montgomery radix of the pointwise product, 2^bits
    _tables = staticmethod(mxu32._mxu_tables)

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
        tabs = [self._tables(n, p) for p in self.primes_loc]
        self._d = [fm.diag_rows(t["d"], r, self.n2 // s, self.device) for t in tabs]
        self._e = [fm.diag_rows(t["e"], r, self.n1 // s, self.device) for t in tabs]

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
        the NTT-domain rows [b, n1 / s, n2] (bit-reversed when flattened)."""
        n = self.plan.n
        v = tuple(fm.transposed(a) for a in parts)
        v = v if len(v) > 1 else v[0]
        y = torch.stack([fm.col_pass(v, d, n=n, p=p) for p, d in zip(self.primes_loc, self._d)])
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 3, 2)  # [k_loc, b, n2, n1 / s]
        return [fm.row_pass(y[c], n=n, p=p) for c, p in enumerate(self.primes_loc)]

    def _inv_local(self, x: list) -> torch.Tensor:
        """x: per local channel [b, n1 / s, n2] NTT-domain values (any u32) ->
        standard-order residues [k_loc, b, n1, n2 / s] (scaled by
        n^-1·2^32 through the folded inverse column planes)."""
        n = self.plan.n
        y = torch.stack([fm.row_pass_inv(a, e, n=n, p=p)
                         for a, p, e in zip(x, self.primes_loc, self._e)])
        y = _dist.all_to_all_tiled(self.mesh, y, self.sp, 3, 2)  # [k_loc, b, n1, n2 / s]
        return torch.stack([fm.col_pass_inv(y[c], n=n, p=p, scale=sc)
                            for c, (p, sc) in enumerate(zip(self.primes_loc, self.scales))])

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
    _tables = staticmethod(mxu64._tables)

    def __init__(self, plan, mesh, ch_axis: str = "ch", batch_axis=None, sp_axis=None,
                 device=None):
        if plan.tier != "plan52":
            raise ValueError("ChannelShardedNative52 requires a plan52 plan")
        if not all((1 << 33) < p < (1 << 62) for p in plan.primes):
            raise ValueError("plan52 channel sharding needs p in (2^33, 2^62)")
        super().__init__(plan, mesh, ch_axis, batch_axis, sp_axis, device)

    # -- local (per-rank) sections ------------------------------------------

    def _fwd_local(self, parts) -> list:
        """parts: n_limbs x [b, n1, n2 / s] value limb shards -> per local
        channel the canonical NTT-domain limb pair [b, n1 / s, n2]."""
        n = self.plan.n
        if len(parts) == 1:  # u32 values: the hi limb is zero (< 2^32 < p)
            parts = (parts[0], torch.zeros_like(parts[0]))
        v = tuple(fm.transposed(a) for a in parts)
        y = [torch.stack(fm.col_pass64(v, d, n=n, p=p), dim=-1)
             for p, d in zip(self.primes_loc, self._d)]
        y = _dist.all_to_all_tiled(self.mesh, torch.stack(y), self.sp, 3, 2)
        return [fm.row_pass64(y[c].unbind(-1), n=n, p=p) for c, p in enumerate(self.primes_loc)]

    def _inv_local(self, x: list) -> torch.Tensor:
        """x: per local channel a limb pair [b, n1 / s, n2] -> standard-order
        residues [k_loc, b, n1, n2 / s, 2] (scaled by n^-1·2^64 through the
        folded inverse column planes)."""
        n = self.plan.n
        y = [torch.stack(fm.row_pass_inv64(a, e, n=n, p=p), dim=-1)
             for a, p, e in zip(x, self.primes_loc, self._e)]
        y = _dist.all_to_all_tiled(self.mesh, torch.stack(y), self.sp, 3, 2)
        return torch.stack([torch.stack(fm.col_pass_inv64(y[c].unbind(-1), n=n, p=p, scale=sc),
                                        dim=-1)
                            for c, (p, sc) in enumerate(zip(self.primes_loc, self.scales))])

    def _pointwise(self, fl: list, fr: list) -> list:
        """fl·fr·2^-64 mod p per local channel, on limb pairs."""
        out = []
        for a, b, p in zip(fl, fr, self.primes_loc):
            lo, hi = mont_mul64(tuple(map(to_i64, a)), tuple(map(to_i64, b)), p, mont_neginv64(p))
            out.append((to_u32(lo).contiguous(), to_u32(hi).contiguous()))
        return out
