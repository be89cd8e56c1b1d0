"""Generic product-of-distinct-primes NTT plan.

Counterpart of `concrete_ntt_tpu/product.py` (reference src/product.rs, the
tfhe-rs integration layer): the user supplies modulus = Π factors (distinct
primes, 1s allowed and stripped, sorted ascending; product.rs:158-186). inv
returns the canonical CRT value mod `modulus` (no signed truncation): the
plan implements arithmetic in Z/modulus·Z. Factors < 2^32 are prime32
channels, factors >= 2^32 prime64 channels (u64 limb pairs).

Modes (product.rs:10-20):
  * fwd `GENERIC`: residue = value % p_i.
  * fwd `bounded(b)`: with exactly two u32 channels, no u64 channel and
    b < min(p0, p1), the centred representation — values >= modulus/2 map
    to p_i - (modulus - v) (product.rs:303-322). Generic when inapplicable.
  * inv `REPLACE` / `ACCUMULATE`: overwrite, or add mod modulus into the
    given standard buffer (the tfhe-rs PBS hot path, product.rs:444-445).

Routes of the u32 channels (`ops/ntt_dispatch.route32`, decided from n and
the primes before any launch, the same on the CPU as on the card):
  * "K1", every prime 2^29 < p < 2^30 and 2^11 <= n <= 2^17: the channel
    grid — K1a (generic fwd, the u64 -> residue split folded in), K1c
    (Bounded fwd), K1b (inv) and K1d (the polymul's pointwise product +
    normalized inverse in one kernel);
  * "K2", every prime odd and >= 2^26 at 2^11 <= n <= 2^17: the four-step
    kernel once per channel (the pointwise product plain torch);
  * otherwise the generic path: the residue split in plain torch and each
    channel's `prime32.Plan` (K2 or K4).
Each u64 channel runs through its `prime64.Plan` (K5, or the stage engine):
the residue is one Montgomery multiply by 2^64 mod p in plain torch. The
fused polymul serves u32-only plans; with a u64 channel the polymul is fwd,
`mul_assign_normalize`, inv.

The plan's device is given at construction and defaults to the card
("cuda"): numpy input is moved to it, a tensor computes on the device it is
on (CUDA tensors launch the kernels, CPU tensors run their plain twins).
With the default and no GPU a numpy call raises; the CPU is what a caller
asks for with `device="cpu"`. The inverse CRT is the Knuth TAOCP 4.3.2
mixed-radix algorithm with pairwise inverses p_i^-1 mod p_j and a
wrapping-u64 Horner sum, plain torch on the operands' device.

Data: values are numpy uint64 [..., n] or uint32 [..., n, 2] little-endian
limb tensors (or arrays); outputs are numpy uint64 for numpy uint64 input,
else a [..., n, 2] uint32 tensor on the computing device (in Accumulate,
`standard`'s format decides). The NTT domain is an `NttDomain` of res32
[k32, ..., n] and res64 [k64, ..., n, 2] uint32 tensors (None without such
channels).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import prime32, prime64
from .ops import ntt_dispatch
from .ops.u32 import (
    DEFAULT_DEVICE,
    MASK32,
    add64,
    add_mod,
    add_mod64,
    cond_sub64,
    const64_like,
    geq64,
    input_tensor,
    limbs_to_np_u64,
    mont_mul,
    mont_mul64,
    mont_neginv,
    mont_neginv64,
    mul64_u32,
    mullo64,
    np_u64_to_limbs,
    shoup_mul,
    shoup_mul_lazy64,
    sub64,
    sub_mod,
    sub_mod64,
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
    res32 [k32, ..., n] and res64 [k64, ..., n, 2] uint32 tensors, None
    where the plan has no such channels."""

    res32: torch.Tensor | None
    res64: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, res32, res64=None, device=DEFAULT_DEVICE) -> "NttDomain":
        """An NTT-domain buffer from numpy (e.g. `np.asarray(dom.res32)` of
        the JAX package's plan: a preloaded operand), on `device` (by
        default the card)."""

        def conv(a):
            if a is None:
                return None
            arr = np.array(a)  # a writable copy: a JAX array's view is read-only
            if arr.dtype != np.uint32:
                raise TypeError(f"expected uint32 residues, got {arr.dtype}")
            return input_tensor(arr, device)

        return cls(conv(res32), conv(res64))

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


def _mul_const_mod64(x_pair, c: int, p: int):
    """x·c mod p, canonical, limb pairs, any odd prime p < 2^64."""
    if p < 1 << 63:
        q = (c << 64) // p
        return cond_sub64(shoup_mul_lazy64(x_pair, const64_like(c), const64_like(q), p), p)
    return mont_mul64(x_pair, const64_like((c << 64) % p), p, mont_neginv64(p))


def _pair(limbs: torch.Tensor):
    """[..., n, 2] uint32 -> contiguous (lo, hi)."""
    return limbs[..., 0].contiguous(), limbs[..., 1].contiguous()


@dataclass(frozen=True)
class Plan:
    """NTT plan modulo a product of distinct primes (product.rs:139-229)."""

    n: int
    modulus: int
    factors: tuple
    plans32: tuple = field(repr=False)
    plans64: tuple = field(repr=False, default=())
    device: str = DEFAULT_DEVICE

    @classmethod
    def try_new(cls, n: int, modulus: int, factors, device: str = DEFAULT_DEVICE) -> "Plan | None":
        try:
            return cls.new(n, modulus, factors, device)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, modulus: int, factors, device: str = DEFAULT_DEVICE) -> "Plan":
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
        device = str(device)
        plans32 = tuple(prime32.Plan.new(n, p, device) for p in stripped if p < 1 << 32)
        plans64 = tuple(prime64.Plan.new(n, p, device) for p in stripped if p >= 1 << 32)
        return cls(n=n, modulus=modulus, factors=tuple(stripped), plans32=plans32,
                   plans64=plans64, device=device)

    # -- helpers ---------------------------------------------------------------

    @property
    def primes32(self):
        return tuple(pl.p for pl in self.plans32)

    @property
    def primes64(self):
        return tuple(pl.p for pl in self.plans64)

    def ntt_size(self) -> int:
        return self.n

    def _route(self):
        return ntt_dispatch.route32(self.n, self.primes32)

    def _channels(self, fn, fn64=None) -> NttDomain:
        """NttDomain of fn(i, plan) over the u32 channels and fn64(i, plan)
        over the u64 channels (None where there are none)."""
        outs = [fn(i, pl) for i, pl in enumerate(self.plans32)]
        outs64 = [fn64(i, pl) for i, pl in enumerate(self.plans64)] if fn64 else []
        return NttDomain(torch.stack(outs) if outs else None,
                         torch.stack(outs64) if outs64 else None)

    def _marshal(self, x):
        """→ (lo, hi) contiguous uint32 [B, n], lead shape, format tag."""
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            limbs = input_tensor(np_u64_to_limbs(x), self.device)
            fmt = "np64"
        else:
            limbs = input_tensor(x, self.device) if isinstance(x, np.ndarray) else x
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
                and not self.plans64 and mode[1] < min(self.primes32))

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
        elif route is not None and self.plans32:
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
        if self.plans64:
            v = (to_i64(lo), to_i64(hi))
            outs = []
            for pl in self.plans64:
                # value mod p via Montgomery: value·(2^64 mod p)·2^-64
                r = mont_mul64(v, const64_like((1 << 64) % pl.p), pl.p, mont_neginv64(pl.p))
                outs.append(torch.stack(pl.fwd_pair(to_u32(r[0]), to_u32(r[1])), dim=-1))
            dom.res64 = torch.stack(outs).reshape(len(outs), *lead, self.n, 2)
        return dom

    # -- inverse (product.rs:360-879) -------------------------------------------

    def _res_in(self, arr, k: int, trail: tuple, name: str):
        """Validate/flatten one residue buffer -> ([k, B, *trail], lead)."""
        if not isinstance(arr, torch.Tensor) or arr.dtype != torch.uint32:
            raise TypeError(
                f"expected NTT-domain {name} as a uint32 tensor (NttDomain.from_numpy)")
        if (arr.dim() < 1 + len(trail) or arr.shape[0] != k
                or tuple(arr.shape[-len(trail):]) != trail):
            raise ValueError(f"expected {name} [k={k}, ..., {', '.join(map(str, trail))}], "
                             f"got {tuple(arr.shape)}")
        lead = tuple(arr.shape[1:-len(trail)])
        return arr.reshape(k, -1, *trail).contiguous(), lead

    def inv(self, ntt: NttDomain, mode=REPLACE, standard=None, out_format=None):
        k, k64 = len(self.plans32), len(self.plans64)
        if not k and not k64:  # no channels at all: value is 0 (product.rs:386-393)
            raise ValueError("plan has no channels")
        res, res64, lead = None, [], None
        if k:
            arr, lead = self._res_in(ntt.res32, k, (self.n,), "res32")
            if self._route() is not None:
                res = ntt_dispatch.try_inv32_all(arr, self.plans32)
            else:
                res = self._channels(lambda i, pl: pl.inv(arr[i])).res32
        if k64:
            arr64, lead = self._res_in(ntt.res64, k64, (self.n, 2), "res64")
            res64 = [pl.inv_pair(*_pair(arr64[i])) for i, pl in enumerate(self.plans64)]
        acc = self._mixed_radix_lift(res, res64)
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

    def _mixed_radix_lift(self, res32, res64=()):
        """Knuth 4.3.2 mixed-radix digits with pairwise inverses
        (product.rs:791-879) + wrapping-u64 Horner accumulation: standard-
        order channel residues (res32 [k, B, n] uint32 or None; res64 a list
        of (lo, hi) uint32 pairs) -> canonical value mod `modulus` as an
        int64-carrier limb pair. Channel order = u32 channels then u64
        channels; factors are sorted ascending, so every earlier digit
        v_i < p_i < p_j is already reduced mod p_j (the reference relies on
        the same order)."""
        residues = to_i64(res32) if res32 is not None else ()
        digits = []
        for j, pj in enumerate(self.primes32):
            x = residues[j]
            for i, vi in enumerate(digits):
                inv_c = pow(self.primes32[i] % pj, pj - 2, pj)
                x = _mul_const_mod32(sub_mod(x, vi, pj), inv_c, pj)
            digits.append(x)
        digits64 = []
        for j, pj in enumerate(self.primes64):
            x = (to_i64(res64[j][0]), to_i64(res64[j][1]))
            for i, vi in enumerate(digits):
                inv_c = pow(self.primes32[i] % pj, pj - 2, pj)
                x = _mul_const_mod64(sub_mod64(x, (vi, torch.zeros_like(vi)), pj), inv_c, pj)
            for i, vi in enumerate(digits64):
                inv_c = pow(self.primes64[i] % pj, pj - 2, pj)
                x = _mul_const_mod64(sub_mod64(x, vi, pj), inv_c, pj)
            digits64.append(x)
        z = torch.zeros_like(digits[0] if digits else digits64[0][0])
        acc = (z, z)
        for v, p in zip(reversed(digits64), reversed(self.primes64)):
            acc = add64(mullo64(acc, const64_like(p)), v)
        for v, p in zip(reversed(digits), reversed(self.primes32)):
            acc = add64(mul64_u32(acc, p), (v, z))
        return acc

    # -- elementwise (channel-wise delegation, product.rs:885-966) --------------

    def mul_assign_normalize(self, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        return self._channels(
            lambda i, pl: pl.mul_assign_normalize(lhs.res32[i], rhs.res32[i]),
            lambda i, pl: pl.mul_assign_normalize(lhs.res64[i], rhs.res64[i]))

    def normalize(self, values: NttDomain) -> NttDomain:
        return self._channels(lambda i, pl: pl.normalize(values.res32[i]),
                              lambda i, pl: pl.normalize(values.res64[i]))

    def mul_accumulate(self, acc: NttDomain, lhs: NttDomain, rhs: NttDomain) -> NttDomain:
        return self._channels(
            lambda i, pl: pl.mul_accumulate(acc.res32[i], lhs.res32[i], rhs.res32[i]),
            lambda i, pl: pl.mul_accumulate(acc.res64[i], lhs.res64[i], rhs.res64[i]))

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
        if self.plans64 or not self.plans32 or self._route() is None:
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
