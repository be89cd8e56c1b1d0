"""Shared machinery for the native (CRT wrapping-arithmetic) NTT plans.

Counterpart of `concrete_ntt_tpu/_native_common.py`. The reference has six
nearly identical plan families (native{32,64,128}.rs,
native_binary{32,64,128}.rs), each in two tiers: Plan32 (k 30-bit prime32
channels) and Plan52 (k 50-bit prime64 channels; none at width 128). One
base covers them all: a plan splits wrapping values into residues over its
primes, transforms each channel, and lifts the residues back with a signed
CRT reconstruction; the concrete modules choose primes, width and lift.

Data conventions (the JAX package's, so that tests compare like with like):
  * u32-width values: uint32 tensors or numpy arrays [..., n];
  * u64-width values: a planar tuple `(lo, hi)` of uint32 tensors [..., n]
    (the performance format: the kernels consume it as it is), a numpy
    uint64 array [..., n], or a uint32 limb tensor [..., n, 2];
  * u128-width values: a planar tuple of four uint32 tensors [..., n], a
    uint32 limb tensor [..., n, 4], or a flat list of n Python ints (host
    convenience, "py128");
  * Plan32 NTT-domain residues: uint32 tensors [k, ..., n], channel-leading;
  * Plan52 NTT-domain residues: uint32 tensors [k, ..., n, 2].

Routes. Plan32 channels at 2^11 <= n <= 2^17 take the channel grid (K1a /
K1b, the residue split folded into K1a's column matmul as 4, 8 or 16
operand digit planes); where `ntt_dispatch.route32` has no route, below
2^11, the plan splits explicitly (`ops/crt.py`) and runs each channel's
`prime32.Plan` (the butterfly kernel K4), as the reference does at every
size. Plan52 channels take K7a / K7d / K5 on `(x, 0)` or `(lo, hi)` limb
pairs, and each channel's `prime64.Plan` where `route64` has no route.

A plan has a device, given at construction and by default the card
("cuda"): numpy and Python-int input is moved there, a tensor computes on
the device it is on (CUDA tensors through the kernels, CPU tensors through
their plain torch twins). With the default and no GPU a numpy call raises;
the CPU is what a caller asks for with `device="cpu"`. Output stays on the
computing device, except the numpy and Python-int formats.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import prime32, prime64
from .ops import crt as crt_ops
from .ops import ntt_dispatch
from .utils.profiling import root_span, span
from .ops.u32 import (
    DEFAULT_DEVICE,
    input_tensor,
    limbs_to_np_u64,
    limbs_to_py_u128,
    np_u128_to_limbs,
    np_u64_to_limbs,
    to_i64,
    to_u32,
)


def _is_planar(x, nlimbs: int) -> bool:
    return (
        isinstance(x, (list, tuple))
        and len(x) == nlimbs
        and all(isinstance(e, torch.Tensor) and e.dim() >= 1 for e in x)
    )


def _marshal_in(x, width: int, n: int, device=DEFAULT_DEVICE):
    """→ (contiguous uint32 limb tensors tuple, lead shape, format tag)."""
    if width == 32:
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            raise TypeError(f"expected uint32 [..., {n}] input")
        arr = input_tensor(x, device)
        if arr.dtype != torch.uint32 or arr.dim() < 1 or arr.shape[-1] != n:
            raise TypeError(f"expected uint32 [..., {n}] input")
        return (arr.reshape(-1, n).contiguous(),), tuple(arr.shape[:-1]), "u32"
    nlimbs = width // 32
    if _is_planar(x, nlimbs):
        if any(a.dtype != torch.uint32 or a.shape != x[0].shape for a in x):
            raise TypeError(f"planar limbs must be {nlimbs} same-shape uint32 tensors")
        if x[0].shape[-1] != n:
            raise ValueError(f"transform axis must be n={n}, got {tuple(x[0].shape)}")
        lead = tuple(x[0].shape[:-1])
        return tuple(a.reshape(-1, n).contiguous() for a in x), lead, "planar"
    if isinstance(x, np.ndarray) and x.dtype == np.uint64 and width == 64:
        limbs = input_tensor(np_u64_to_limbs(x), device)
        fmt = "np64"
    elif isinstance(x, (list, tuple)) and width == 128:
        limbs = input_tensor(np_u128_to_limbs(x), device)
        fmt = "py128"
    elif isinstance(x, torch.Tensor):
        limbs = x
        if limbs.dtype != torch.uint32 or limbs.shape[-1] != nlimbs:
            raise TypeError(f"expected uint32 limb tensor [..., {n}, {nlimbs}]")
        fmt = "limbs"
    else:
        raise TypeError(
            f"expected a planar tuple of {nlimbs} uint32 tensors, a uint32 limb "
            f"tensor [..., {n}, {nlimbs}], "
            + ("or a numpy uint64 array" if width == 64 else "or a list of Python ints")
        )
    if limbs.dim() < 2 or limbs.shape[-2] != n:
        raise ValueError(f"transform axis must be n={n}, got {tuple(limbs.shape)}")
    lead = tuple(limbs.shape[:-2])
    limbs = limbs.reshape(-1, n, nlimbs)
    return tuple(limbs[..., i].contiguous() for i in range(nlimbs)), lead, fmt


def _marshal_out(parts: tuple, lead, fmt: str, n: int):
    if fmt == "u32":
        return parts[0].reshape(*lead, n)
    if fmt == "planar":
        return tuple(p.reshape(*lead, n) for p in parts)
    out = torch.stack(parts, dim=-1).reshape(*lead, n, len(parts))
    if fmt == "np64":
        return limbs_to_np_u64(out.cpu().numpy())
    if fmt == "py128":  # flat list (host convenience; use the limb form for batches)
        return limbs_to_py_u128(out.cpu().numpy())
    return out


def _fmt_of(x, width: int) -> str:
    if width == 32:
        return "u32"
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        return "np64"
    if isinstance(x, (list, tuple)):
        return "planar" if _is_planar(x, width // 32) else "py128"
    return "limbs"


def _stack_pairs(outs: list) -> tuple:
    return tuple(torch.stack([o[i] for o in outs]) for i in range(2))


@dataclass(frozen=True)
class NativePlanBase:
    """k-channel CRT plan: split → k prime NTTs → pointwise → k inverse NTTs
    → signed wrapping reconstruction (reference call stack SURVEY.md §3.3)."""

    n: int
    width: int  # 32 / 64 / 128: the wrapping arithmetic width
    primes: tuple
    plans: tuple = field(repr=False)  # underlying prime32 / prime64 Plans
    tier: str = "plan32"  # "plan32" (u32 channels) | "plan52" (u64 limb-pair channels)
    device: str = DEFAULT_DEVICE

    # -- residue split (the per-channel routes) ---------------------------------

    def _split(self, parts) -> list:
        """Limb tuple of [B, n] uint32 → per-channel residues: uint32 tensors
        (plan32) or (lo, hi) pairs of them (plan52)."""
        xs = tuple(to_i64(a) for a in parts)
        if self.tier == "plan32":
            if self.width == 32:
                res = crt_ops.split_u32(xs[0], self.primes)
            elif self.width == 64:
                res = crt_ops.split_u64(xs[0], xs[1], self.primes)
            else:
                res = crt_ops.split_u128(xs, self.primes)
            return [to_u32(r) for r in res]
        if self.width == 32:
            z = torch.zeros_like(parts[0])
            return [(parts[0], z) for _ in self.primes]  # x < 2^32 < p
        if self.width == 64:
            res = crt_ops.split_u64_to_p50(xs[0], xs[1], self.primes)
            return [(to_u32(lo), to_u32(hi)) for lo, hi in res]
        raise NotImplementedError("no plan52 tier at width 128 (parity w/ reference)")

    def _split_binary(self, parts) -> list:
        """{0,1} operands need no reduction (fwd_binary,
        native_binary64.rs:372-389): the residue is the value itself."""
        lo = parts[0]
        if self.tier == "plan32":
            return [lo for _ in self.primes]
        z = torch.zeros_like(lo)
        return [(lo, z) for _ in self.primes]

    def _residues_in(self, ntt):
        """Validate/flatten user-provided NTT-domain residues."""
        if isinstance(ntt, np.ndarray):
            ntt = input_tensor(np.array(ntt), self.device)  # a writable copy
        if not isinstance(ntt, torch.Tensor) or ntt.dtype != torch.uint32:
            raise TypeError("expected NTT-domain residues as a uint32 tensor")
        trail = (self.n,) if self.tier == "plan32" else (self.n, 2)
        k = len(self.primes)
        if (ntt.dim() < 1 + len(trail) or ntt.shape[0] != k
                or tuple(ntt.shape[-len(trail):]) != trail):
            raise ValueError(
                f"expected residues [k={k}, ..., {', '.join(map(str, trail))}], "
                f"got {tuple(ntt.shape)}"
            )
        lead = tuple(ntt.shape[1:-len(trail)])
        return ntt.reshape(k, -1, *trail).contiguous(), lead

    def _lift(self, residues, lead, fmt: str):
        """Standard-order residues (uint32 [k, B, n], or a (lo, hi) pair of
        such for plan52) → wrapping values in `fmt`."""
        with span("ntt.lift", "lift") as sp:
            value_parts = self._lift_parts(residues)
            sp.io(residues, value_parts)
        with span("ntt.marshal", "marshal") as sp:
            out = _marshal_out(value_parts, lead, fmt, self.n)
            sp.io(value_parts, out)
        return out

    def _lift_parts(self, residues) -> tuple:
        """Standard-order residues → the value's uint32 limb planes [B, n]:
        the plain chain, `_reconstruct` on int64 carriers (a family with a
        lift kernel overrides this)."""
        k = len(self.primes)
        if self.tier == "plan32":
            mods = to_i64(residues)
            mods = [mods[i] for i in range(k)]
        else:
            lo, hi = to_i64(residues[0]), to_i64(residues[1])
            mods = [(lo[i], hi[i]) for i in range(k)]
        value_parts = self._reconstruct(mods)
        if not isinstance(value_parts, tuple):
            value_parts = (value_parts,)
        return tuple(to_u32(v) for v in value_parts)

    def _reconstruct(self, residues):
        raise NotImplementedError

    # -- plan32: the channel routes (K1 / K2), else each channel's plan (K4) ----

    def _route32(self) -> str | None:
        """`ntt_dispatch.route32` for this plan; None is the per-channel
        route (below 2^11)."""
        return ntt_dispatch.route32(self.n, self.primes)

    def _fwd32(self, parts, binary: bool = False):
        """Limb tuple of [B, n] → [k, B, n] NTT-domain residues (the
        per-channel routes' residue split inside the transform's span, as
        K1a folds it into the transform)."""
        with span("ntt.transform", "transform") as sp:
            if self._route32() is not None:
                out = ntt_dispatch.try_fwd32_wide_all(parts[:1] if binary else parts, self.plans)
            else:
                res = self._split_binary(parts) if binary else self._split(parts)
                out = torch.stack([pl.fwd(r) for pl, r in zip(self.plans, res)])
            sp.io(parts[:1] if binary else parts, out)
        return out

    def _inv32(self, arr):
        with span("ntt.transform", "transform") as sp:
            if self._route32() is not None:
                out = ntt_dispatch.try_inv32_all(arr, self.plans)
            else:
                out = torch.stack([pl.inv(arr[i]) for i, pl in enumerate(self.plans)])
            sp.io(arr, out)
        return out

    def _pointwise_inv32(self, fl, fr):
        """Per-channel pointwise·n^-1 then inverse NTT → standard-order
        residues [k, B, n]."""
        if self._route32() is not None:
            return ntt_dispatch.try_pointwise_inv32_all(fl, fr, self.plans)
        with span("ntt.pointwise", "pointwise") as sp:
            prods = [pl.mul_assign_normalize(fl[i], fr[i]) for i, pl in enumerate(self.plans)]
            sp.io(fl, fr, prods)
        with span("ntt.transform", "transform") as sp:
            out = torch.stack([pl.inv(v) for pl, v in zip(self.plans, prods)])
            sp.io(prods, out)
        return out

    # -- plan52: the channel routes (K7 / K5), else each channel's plan ---------

    def _fwd52(self, parts, binary: bool = False):
        """Limb tuple of [B, n] → (lo, hi) of [k, B, n] NTT-domain residues.
        A u32 or {0,1} operand is the limb pair (x, 0)."""
        with span("ntt.transform", "transform") as sp:
            if binary or self.width == 32:
                pair = (parts[0], torch.zeros_like(parts[0]))
            else:
                pair = parts
            out = ntt_dispatch.try_fwd64_wide_all(pair, self.plans)
            if out is None:
                res = self._split_binary(parts) if binary else self._split(parts)
                out = _stack_pairs([pl.fwd_pair(*r) for pl, r in zip(self.plans, res)])
            sp.io(parts[:1] if binary else parts, out)
        return out

    def _inv52(self, arr):
        with span("ntt.transform", "transform") as sp:
            out = _stack_pairs([pl.inv_pair(arr[i, ..., 0].contiguous(), arr[i, ..., 1].contiguous())
                                for i, pl in enumerate(self.plans)])
            sp.io(arr, out)
        return out

    def _pointwise_inv52(self, fl, fr):
        """Per-channel pointwise·n^-1 then inverse NTT → standard-order
        residues (lo, hi) of [k, B, n]: K7d (or plain mont_mul64 + K5) on a
        channel route, else each plan's mul_assign_normalize and inverse."""
        fused = ntt_dispatch.try_pointwise_inv64_all(fl, fr, self.plans)
        if fused is not None:
            return fused
        with span("ntt.pointwise", "pointwise") as sp:
            prods = []
            for i, pl in enumerate(self.plans):
                limbs = lambda pair: torch.stack([pair[0][i], pair[1][i]], dim=-1)
                prods.append(pl.mul_assign_normalize(limbs(fl), limbs(fr)))
            sp.io(fl, fr, prods)
        with span("ntt.transform", "transform") as sp:
            out = _stack_pairs([pl.inv_pair(prod[..., 0].contiguous(), prod[..., 1].contiguous())
                                for pl, prod in zip(self.plans, prods)])
            sp.io(prods, out)
        return out

    # -- transforms -------------------------------------------------------------

    def _fwd(self, x, binary: bool):
        with span("ntt.marshal", "marshal") as sp:
            parts, lead, _ = _marshal_in(x, self.width, self.n, self.device)
            sp.io(x, parts)
        k = len(self.primes)
        res = self._fwd32(parts, binary) if self.tier == "plan32" else self._fwd52(parts, binary)
        with span("ntt.marshal", "marshal") as sp:
            if self.tier == "plan32":
                out = res.reshape(k, *lead, self.n)
            else:
                out = torch.stack(res, dim=-1).reshape(k, *lead, self.n, 2)
            sp.io(res, out)
        return out

    @root_span
    def fwd(self, x):
        """value array [..., n] → NTT-domain residues [k, ..., n] (plan32) or
        [k, ..., n, 2] (plan52), uint32."""
        return self._fwd(x, binary=False)

    @root_span
    def fwd_binary(self, x):
        """Binary-operand forward: x holds {0, 1} coefficients, so its low
        limb is its residue in every channel and the modular reduction is
        skipped."""
        return self._fwd(x, binary=True)

    @root_span
    def inv(self, ntt, out_format: str | None = None):
        """NTT-domain residues → wrapping values (signed CRT lift),
        unnormalized as the reference's: inv(fwd(x)) == n·x (wrapping).
        out_format: by default "u32" at width 32 and "limbs" ([..., n, 2] or
        [..., n, 4]) above; "planar", "np64" (width 64) or "py128" (width 128,
        one polynomial)."""
        with span("ntt.marshal", "marshal") as sp:
            arr, lead = self._residues_in(ntt)
            sp.io(ntt, arr)
        stacked = self._inv32(arr) if self.tier == "plan32" else self._inv52(arr)
        return self._lift(stacked, lead, out_format or ("u32" if self.width == 32 else "limbs"))

    @root_span
    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = False):
        """Wrapping negacyclic product (reference native64.rs:1042-1069) in
        the format of `lhs`. rhs_binary: rhs holds {0, 1} coefficients, so
        only its low limb is transformed."""
        with span("ntt.marshal", "marshal") as sp:
            parts_l, lead, _ = _marshal_in(lhs, self.width, self.n, self.device)
            parts_r, _, _ = _marshal_in(rhs, self.width, self.n, self.device)
            sp.io(lhs, rhs, parts_l, parts_r)
        if self.tier == "plan52":
            stacked = self._pointwise_inv52(self._fwd52(parts_l), self._fwd52(parts_r, rhs_binary))
        elif self._route32() == "K1":
            stacked = ntt_dispatch.try_polymul32_stacked(parts_l, parts_r, self.plans, rhs_binary)
        else:
            stacked = self._pointwise_inv32(self._fwd32(parts_l), self._fwd32(parts_r, rhs_binary))
        return self._lift(stacked, lead, _fmt_of(lhs, self.width))

    # -- accessors (parity with ntt_0()..ntt_k(), native64.rs:950-969) --------

    def ntt(self, i: int):
        return self.plans[i]


def channel_accessors(k: int):
    """Class decorator adding ntt_0() .. ntt_{k-1}(), the reference's named
    accessors of a plan's channels (native64.rs:950-969)."""
    def add(cls):
        for i in range(k):
            setattr(cls, f"ntt_{i}", lambda self, i=i: self.plans[i])
        return cls
    return add


def build_plans32(n: int, primes, device=DEFAULT_DEVICE) -> tuple:
    plans = tuple(prime32.Plan.try_new(n, p, device) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans


def build_plans52(n: int, primes, device=DEFAULT_DEVICE) -> tuple:
    plans = tuple(prime64.Plan.try_new(n, p, device) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans
