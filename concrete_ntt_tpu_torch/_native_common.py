"""Shared machinery for the native (CRT wrapping-arithmetic) NTT plans.

Counterpart of `concrete_ntt_tpu/_native_common.py`, Plan32 tier only. A plan
splits wrapping values into residues over k 30-bit primes, transforms each
channel, and lifts the residues back with a signed CRT reconstruction.

Data conventions (the JAX package's, so that tests compare like with like):
  * u64-width values: a planar tuple `(lo, hi)` of uint32 tensors [..., n]
    (the performance format: the kernels consume it as it is), a numpy
    uint64 array [..., n], or a uint32 limb tensor [..., n, 2];
  * NTT-domain residues: uint32 tensors [k, ..., n], channel-leading.

A plan computes on the device of its input: CUDA tensors go through the
kernels K1a / K1b, CPU tensors (and numpy input) through their plain torch
twins. Output stays on that device, except the numpy format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import prime32
from .ops import ntt_dispatch
from .ops.u32 import limbs_to_np_u64, np_u64_to_limbs, to_i64, to_u32


def _marshal_in(x, width: int, n: int):
    """→ (contiguous uint32 limb tensors tuple, lead shape, format tag)."""
    nlimbs = width // 32
    if (
        isinstance(x, (list, tuple))
        and len(x) == nlimbs
        and all(isinstance(e, torch.Tensor) and e.dim() >= 1 for e in x)
    ):
        if any(a.dtype != torch.uint32 or a.shape != x[0].shape for a in x):
            raise TypeError(f"planar limbs must be {nlimbs} same-shape uint32 tensors")
        if x[0].shape[-1] != n:
            raise ValueError(f"transform axis must be n={n}, got {tuple(x[0].shape)}")
        lead = tuple(x[0].shape[:-1])
        return tuple(a.reshape(-1, n).contiguous() for a in x), lead, "planar"
    if isinstance(x, np.ndarray) and x.dtype == np.uint64 and width == 64:
        limbs = torch.from_numpy(np_u64_to_limbs(x))
        fmt = "np64"
    elif isinstance(x, torch.Tensor):
        limbs = x
        if limbs.dtype != torch.uint32 or limbs.shape[-1] != nlimbs:
            raise TypeError(f"expected uint32 limb tensor [..., {n}, {nlimbs}]")
        fmt = "limbs"
    else:
        raise TypeError(
            f"expected a planar tuple of {nlimbs} uint32 tensors, a numpy uint64 "
            f"array or a uint32 limb tensor [..., {n}, {nlimbs}]"
        )
    if limbs.dim() < 2 or limbs.shape[-2] != n:
        raise ValueError(f"transform axis must be n={n}, got {tuple(limbs.shape)}")
    lead = tuple(limbs.shape[:-2])
    limbs = limbs.reshape(-1, n, nlimbs)
    return tuple(limbs[..., i].contiguous() for i in range(nlimbs)), lead, fmt


def _marshal_out(parts: tuple, lead, fmt: str, n: int):
    if fmt == "planar":
        return tuple(p.reshape(*lead, n) for p in parts)
    out = torch.stack(parts, dim=-1).reshape(*lead, n, len(parts))
    if fmt == "np64":
        return limbs_to_np_u64(out.cpu().numpy())
    return out


def _fmt_of(x) -> str:
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        return "np64"
    if isinstance(x, (list, tuple)):
        return "planar"
    return "limbs"


@dataclass(frozen=True)
class NativePlanBase:
    """k-channel CRT plan: split → k prime NTTs → pointwise → k inverse NTTs
    → signed wrapping reconstruction (reference call stack SURVEY.md §3.3)."""

    n: int
    width: int  # the wrapping arithmetic width (64 in this port so far)
    primes: tuple
    plans: tuple = field(repr=False)  # underlying prime32 Plans

    def _residues_in(self, ntt):
        """Validate/flatten user-provided NTT-domain residues."""
        if not isinstance(ntt, torch.Tensor) or ntt.dtype != torch.uint32:
            raise TypeError("expected NTT-domain residues as a uint32 tensor")
        k = len(self.primes)
        if ntt.dim() < 2 or ntt.shape[0] != k or ntt.shape[-1] != self.n:
            raise ValueError(
                f"expected residues [k={k}, ..., {self.n}], got {tuple(ntt.shape)}"
            )
        lead = tuple(ntt.shape[1:-1])
        return ntt.reshape(k, -1, self.n).contiguous(), lead

    def _lift(self, stacked, lead, fmt: str):
        """Standard-order residues [k, B, n] → wrapping values in `fmt`."""
        mods = to_i64(stacked)
        value_parts = self._reconstruct([mods[i] for i in range(len(self.primes))])
        return _marshal_out(tuple(to_u32(v) for v in value_parts), lead, fmt, self.n)

    def _reconstruct(self, residues):
        raise NotImplementedError

    def fwd(self, x):
        """value array [..., n] → NTT-domain residues [k, ..., n] (uint32)."""
        parts, lead, _ = _marshal_in(x, self.width, self.n)
        out = ntt_dispatch.try_fwd32_wide_all(parts, self.plans)
        return out.reshape(len(self.primes), *lead, self.n)

    def inv(self, ntt, out_format: str | None = None):
        """NTT-domain residues → wrapping values (signed CRT lift),
        unnormalized as the reference's: inv(fwd(x)) == n·x (wrapping).
        out_format: "limbs" (default, [..., n, 2]), "planar" or "np64"."""
        arr, lead = self._residues_in(ntt)
        stacked = ntt_dispatch.try_inv32_all(arr, self.plans)
        return self._lift(stacked, lead, out_format or "limbs")

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = False):
        """Wrapping negacyclic product (reference native64.rs:1042-1069) in
        the format of `lhs`. rhs_binary: rhs holds {0, 1} coefficients, so
        its low limb is its residue in every channel."""
        parts_l, lead, _ = _marshal_in(lhs, self.width, self.n)
        parts_r, _, _ = _marshal_in(rhs, self.width, self.n)
        stacked = ntt_dispatch.try_polymul32_stacked(
            parts_l, parts_r, self.plans, rhs_binary
        )
        return self._lift(stacked, lead, _fmt_of(lhs))

    # -- accessors (parity with ntt_0()..ntt_k(), native64.rs:950-969) --------

    def ntt(self, i: int):
        return self.plans[i]


def build_plans32(n: int, primes) -> tuple:
    plans = tuple(prime32.Plan.try_new(n, p) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans
