"""Generic product-of-distinct-primes NTT plan, u32 channels.

Counterpart of `concrete_ntt_tpu/product.py` (reference src/product.rs, the
tfhe-rs integration layer): the user supplies modulus = Π factors (distinct
primes, 1s allowed and stripped, sorted ascending; product.rs:158-186). inv
returns the canonical CRT value mod `modulus` (no signed truncation): the
plan implements arithmetic in Z/modulus·Z. This port takes factors < 2^32
(prime32 channels); a factor >= 2^32 (a prime64 channel) raises
NotImplementedError until the prime64 slice (ROADMAP.md Queue 1 item 8).

Modes (product.rs:10-20):
  * fwd `GENERIC`: residue = value % p_i.
  * fwd `bounded(b)`: with two u32 channels and b < min(p0, p1), the
    centred representation — values >= modulus/2 map to p_i - (modulus - v)
    (product.rs:303-322). Generic when inapplicable.
  * inv `REPLACE` / `ACCUMULATE`: overwrite, or add mod modulus into the
    given standard buffer (the tfhe-rs PBS hot path, product.rs:444-445).

Routes (`ops/ntt_dispatch.route32`, decided from n and the primes before
any launch, the same on the CPU as on the card):
  * "K1", every prime 2^29 < p < 2^30 and 2^11 <= n <= 2^15: the channel
    grid — K1a (generic fwd, the u64 -> residue split folded in), K1c
    (Bounded fwd), K1b (inv) and K1d (the polymul's pointwise product +
    normalized inverse in one kernel);
  * "K2", every prime odd and >= 2^26 at 2^11 <= n <= 2^15: the four-step
    kernel once per channel (the pointwise product plain torch);
  * otherwise the generic path: the residue split in plain torch and each
    channel's `prime32.Plan` (K2 or K4).
CUDA tensors launch the kernels, CPU tensors (and numpy input) run their
plain twins. The inverse CRT is the Knuth TAOCP 4.3.2 mixed-radix algorithm
with pairwise inverses p_i^-1 mod p_j and a wrapping-u64 Horner sum, plain
torch on the operands' device.

Data: values are numpy uint64 [..., n] or uint32 [..., n, 2] little-endian
limb tensors (or arrays); outputs are numpy uint64 for numpy uint64 input,
else a [..., n, 2] uint32 tensor on the input's device (in Accumulate,
`standard`'s format decides). The NTT domain is an `NttDomain` of res32
[k32, ..., n] uint32 (res64 stays None until the prime64 slice).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import prime32
from .ops import ntt_dispatch
from .ops.u32 import (
    MASK32,
    add64,
    add_mod,
    add_mod64,
    const64_like,
    geq64,
    limbs_to_np_u64,
    mont_mul,
    mont_neginv,
    mul64_u32,
    np_u64_to_limbs,
    shoup_mul,
    sub64,
    sub_mod,
    to_i64,
    to_u32,
)
from .utils.prime import is_prime64

GENERIC = "generic"
REPLACE = "replace"
ACCUMULATE = "accumulate"


def bounded(bound: int):
    """FwdMode::Bounded(bound) equivalent."""
    return ("bounded", int(bound))


@dataclass
class NttDomain:
    """Per-channel NTT-domain residues (the reference's flat buffer):
    res32 [k32, ..., n] uint32 tensor; res64 is None in this port so far."""

    res32: torch.Tensor | None
    res64: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, res32, res64=None, device="cpu") -> "NttDomain":
        """An NTT-domain buffer from numpy (e.g. `np.asarray(dom.res32)` of
        the JAX package's plan: a preloaded operand), on `device`."""
        if res64 is not None:
            raise NotImplementedError(
                "prime64 channels (res64) wait for the prime64 slice (ROADMAP.md Queue 1 item 8)"
            )
        arr = np.array(res32)  # a writable copy: a JAX array's view is read-only
        if arr.dtype != np.uint32:
            raise TypeError(f"expected uint32 residues, got {arr.dtype}")
        return cls(torch.from_numpy(arr).to(device), None)

    def numpy(self) -> tuple:
        """(res32, res64) as numpy arrays (None where absent)."""
        return (None if self.res32 is None else self.res32.cpu().numpy(),
                None if self.res64 is None else self.res64.cpu().numpy())


def _mul_const_mod32(x, c: int, p: int):
    """x·c mod p, canonical, x < p, c const, any odd prime p < 2^32 (int64
    carriers)."""
    if p < 1 << 31:
        return shoup_mul(x, c, (c << 32) // p, p)
    return mont_mul(x, (c << 32) % p, p, mont_neginv(p))


@dataclass(frozen=True)
class Plan:
    """NTT plan modulo a product of distinct primes < 2^32 (product.rs:139-229)."""

    n: int
    modulus: int
    factors: tuple
    plans32: tuple = field(repr=False)

    @classmethod
    def try_new(cls, n: int, modulus: int, factors) -> "Plan | None":
        try:
            return cls.new(n, modulus, factors)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, modulus: int, factors) -> "Plan":
        factors = [int(f) for f in factors]
        stripped = [f for f in factors if f != 1]
        if sorted(factors) != factors:
            raise ValueError("factors must be sorted in increasing order")
        if len(set(stripped)) != len(stripped):
            raise ValueError("factors must be distinct")
        prod = 1
        for f in stripped:
            prod *= f
        if prod != modulus:
            raise ValueError("product of factors must equal modulus")
        if not (1 <= modulus < 1 << 64):
            raise ValueError("modulus must fit in u64")
        for f in stripped:
            if not is_prime64(f):
                raise ValueError(f"factor {f} is not prime")
        if any(f >= 1 << 32 for f in stripped):
            raise NotImplementedError(
                "factors >= 2^32 need prime64 channels, which wait for the prime64 "
                "slice (ROADMAP.md Queue 1 item 8)"
            )
        plans32 = tuple(prime32.Plan.new(n, p) for p in stripped)
        return cls(n=n, modulus=modulus, factors=tuple(stripped), plans32=plans32)

    # -- helpers ---------------------------------------------------------------

    @property
    def primes32(self):
        return tuple(pl.p for pl in self.plans32)

    def _route(self):
        return ntt_dispatch.route32(self.n, self.primes32)

    def _channels(self, fn) -> NttDomain:
        """NttDomain of fn(i, plan) over the channels (None without any)."""
        outs = [fn(i, pl) for i, pl in enumerate(self.plans32)]
        return NttDomain(torch.stack(outs) if outs else None)

    def _marshal(self, x):
        """→ (lo, hi) contiguous uint32 [B, n], lead shape, format tag."""
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            limbs = torch.from_numpy(np_u64_to_limbs(x))
            fmt = "np64"
        else:
            limbs = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
            if (not isinstance(limbs, torch.Tensor) or limbs.dtype != torch.uint32
                    or limbs.dim() < 2 or limbs.shape[-1] != 2):
                raise TypeError("expected NumPy uint64 [..., n] or uint32 [..., n, 2]")
            fmt = "limbs"
        if limbs.shape[-2] != self.n:
            raise ValueError(f"transform axis must be n={self.n}")
        lead = tuple(limbs.shape[:-2])
        limbs = limbs.reshape(-1, self.n, 2)
        # the kernels take contiguous operands: split the strided limb views once
        return limbs[..., 0].contiguous(), limbs[..., 1].contiguous(), lead, fmt

    def _centred(self, lo, hi) -> torch.Tensor:
        """Bounded residues [2, B, n] (product.rs:303-322): a value below
        modulus/2 is its own residue (bound < p_i); above, p_i - (modulus - v),
        wrapping in u32 as the JAX package's."""
        lo64, hi64 = to_i64(lo), to_i64(hi)
        positive = ~geq64((lo64, hi64), const64_like(self.modulus // 2))
        comp_lo, _ = sub64(const64_like(self.modulus), (lo64, hi64))
        return to_u32(torch.stack([torch.where(positive, lo64, (p - comp_lo) & MASK32)
                                   for p in self.primes32]))

    def _use_bounded(self, mode) -> bool:
        return (isinstance(mode, tuple) and mode[0] == "bounded" and len(self.plans32) == 2
                and mode[1] < min(self.primes32))

    # -- forward (product.rs:273-356) ------------------------------------------

    def fwd(self, standard, mode=GENERIC) -> NttDomain:
        lo, hi, lead, _ = self._marshal(standard)
        route = self._route()
        if self._use_bounded(mode):
            res = self._centred(lo, hi)
            if route is not None:
                dom = NttDomain(ntt_dispatch.try_fwd32_perchannel_all(res, self.plans32))
            else:
                dom = self._channels(lambda i, pl: pl.fwd(res[i]))
        elif route is not None:
            # fused split + fwd: the kernels consume the raw limbs (the
            # residue reduction folded into the column matmul)
            dom = NttDomain(ntt_dispatch.try_fwd32_wide_all((lo, hi), self.plans32))
        else:
            lo64, hi64 = to_i64(lo), to_i64(hi)

            def split_fwd(i, pl):
                p, ninv = pl.p, mont_neginv(pl.p)
                # value mod p = lo·(2^32 mod p)·2^-32 + hi·(2^64 mod p)·2^-32
                r = add_mod(mont_mul(lo64, (1 << 32) % p, p, ninv),
                            mont_mul(hi64, (1 << 64) % p, p, ninv), p)
                return pl.fwd(to_u32(r))

            dom = self._channels(split_fwd)
        if dom.res32 is not None:
            dom.res32 = dom.res32.reshape(len(self.plans32), *lead, self.n)
        return dom

    # -- inverse (product.rs:360-879) -------------------------------------------

    def inv(self, ntt: NttDomain, mode=REPLACE, standard=None, out_format=None):
        k = len(self.plans32)
        if not k:  # no channels at all: value is 0 (product.rs:386-393)
            raise ValueError("plan has no channels")
        arr = ntt.res32
        if not isinstance(arr, torch.Tensor) or arr.dtype != torch.uint32:
            raise TypeError("expected NTT-domain res32 as a uint32 tensor (NttDomain.from_numpy)")
        if arr.dim() < 2 or arr.shape[0] != k or arr.shape[-1] != self.n:
            raise ValueError(f"expected res32 [k={k}, ..., {self.n}], got {tuple(arr.shape)}")
        lead = tuple(arr.shape[1:-1])
        arr = arr.reshape(k, -1, self.n).contiguous()
        if self._route() is not None:
            res = ntt_dispatch.try_inv32_all(arr, self.plans32)
        else:
            res = self._channels(lambda i, pl: pl.inv(arr[i])).res32
        acc = self._mixed_radix_lift(res)
        if mode == ACCUMULATE:
            acc, lead, fmt = self._accumulate(acc, standard)
            out_format = out_format or fmt
        return self._output(acc, lead, out_format or "np64")

    def _accumulate(self, acc, standard):
        """(standard + acc) mod modulus → (limb pair, lead shape, format)."""
        if standard is None:
            raise ValueError("accumulate mode requires the standard buffer")
        s_lo, s_hi, lead, fmt = self._marshal(standard)
        dev = acc[0].device
        s = (to_i64(s_lo.to(dev)), to_i64(s_hi.to(dev)))
        return add_mod64(s, acc, self.modulus), lead, fmt

    def _output(self, acc, lead, out_format: str):
        out = to_u32(torch.stack(acc, dim=-1)).reshape(*lead, self.n, 2)
        if out_format == "np64":
            return limbs_to_np_u64(out.cpu().numpy())
        return out

    def _mixed_radix_lift(self, res32: torch.Tensor):
        """Knuth 4.3.2 mixed-radix digits with pairwise inverses
        (product.rs:791-879) + wrapping-u64 Horner accumulation: standard-
        order channel residues [k, B, n] -> canonical value mod `modulus`
        as an int64-carrier limb pair. Factors are sorted ascending, so every
        earlier digit v_i < p_i < p_j is already reduced mod p_j (the
        reference relies on the same order)."""
        residues = to_i64(res32)
        digits = []
        for j, pj in enumerate(self.primes32):
            x = residues[j]
            for i, vi in enumerate(digits):
                inv_c = pow(self.primes32[i] % pj, pj - 2, pj)
                x = _mul_const_mod32(sub_mod(x, vi, pj), inv_c, pj)
            digits.append(x)
        z = torch.zeros_like(digits[0])
        acc = (z, z)
        for v, p in zip(reversed(digits), reversed(self.primes32)):
            acc = add64(mul64_u32(acc, p), (v, z))
        return acc

    # -- elementwise (channel-wise delegation, product.rs:885-966) --------------

    def mul_assign_normalize(self, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        return self._channels(lambda i, pl: pl.mul_assign_normalize(lhs.res32[i], rhs.res32[i]))

    def normalize(self, values: NttDomain) -> NttDomain:
        return self._channels(lambda i, pl: pl.normalize(values.res32[i]))

    def mul_accumulate(self, acc: NttDomain, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        return self._channels(
            lambda i, pl: pl.mul_accumulate(acc.res32[i], lhs.res32[i], rhs.res32[i]))

    # -- convenience + the tfhe-rs hot path --------------------------------------

    def negacyclic_polymul(self, lhs, rhs, mode=REPLACE, standard=None,
                           out_format=None, lhs_fwd_mode=GENERIC):
        """End-to-end product mod `modulus`; mode=ACCUMULATE adds into
        `standard` (the tfhe-rs NTT-PBS hot loop, product.rs:444-445);
        lhs_fwd_mode=bounded(b) applies the centred forward representation
        to lhs (the PBS accumulator operand, product.rs:303-322).

        On a channel route the polymul is fused: the residue split rides the
        forward kernels (K1a, or K1c after the Bounded centring), the bare
        Montgomery pointwise product rides the scaled inverse (K1d), then
        the CRT lift (+ accumulate). Otherwise the generic channel-wise path
        (bit-identical)."""
        out = self._try_polymul_fused(lhs, rhs, mode, standard, out_format, lhs_fwd_mode)
        if out is not None:
            return out
        if out_format is None:
            out_format = ("np64" if isinstance(lhs, np.ndarray) and lhs.dtype == np.uint64
                          else "limbs")
        fl = self.fwd(lhs, lhs_fwd_mode)
        fr = self.fwd(rhs)
        return self.inv(self.mul_assign_normalize(fl, fr), mode, standard, out_format)

    def _try_polymul_fused(self, lhs, rhs, mode, standard, out_format, lhs_fwd_mode=GENERIC):
        if not self.plans32 or self._route() is None:
            return None
        lo, hi, lead, fmt = self._marshal(lhs)
        rlo, rhi, _, _ = self._marshal(rhs)
        if self._use_bounded(lhs_fwd_mode):
            fl = ntt_dispatch.try_fwd32_perchannel_all(self._centred(lo, hi), self.plans32)
        else:
            fl = ntt_dispatch.try_fwd32_wide_all((lo, hi), self.plans32)
        fr = ntt_dispatch.try_fwd32_wide_all((rlo, rhi), self.plans32)
        acc = self._mixed_radix_lift(ntt_dispatch.try_pointwise_inv32_all(fl, fr, self.plans32))
        if mode == ACCUMULATE:
            acc, lead, fmt = self._accumulate(acc, standard)
        return self._output(acc, lead, out_format or fmt or "np64")
