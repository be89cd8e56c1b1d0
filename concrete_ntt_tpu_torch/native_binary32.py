"""Native-binary NTT mod 2^32: one operand has {0,1} coefficients.

Counterpart of `concrete_ntt_tpu/native_binary32.py` (reference
src/native_binary32.rs): the binary operand needs no CRT headroom of its
own, so Plan32 uses only 2× 30-bit channels (native_binary32.rs:11) and
Plan52 a single 50-bit channel (native_binary32.rs:19). `fwd_binary` skips
the modular reduction (native_binary32.rs:210-218). Use case: FHE external
products / PBS with binary polynomials. `try_new(n, device=...)`: the
plan's device, by default the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32, build_plans52, channel_accessors
from .ops import crt as crt_ops
from .ops.u32 import DEFAULT_DEVICE
from .tables import PRIMES52, native_channel_primes


@channel_accessors(2)
@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan32 | None":
        primes = native_channel_primes(2, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=32, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_u32_from2(residues, self.primes)

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = True):
        """rhs is the binary operand (the reference's polymul contract)."""
        return super().negacyclic_polymul(lhs, rhs, rhs_binary=rhs_binary)


@channel_accessors(1)
@dataclass(frozen=True)
class Plan52(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan52 | None":
        primes = PRIMES52[:1]
        plans = build_plans52(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=32, primes=primes, plans=plans, tier="plan52",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_from1_p50_u32(residues, self.primes)

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = True):
        return super().negacyclic_polymul(lhs, rhs, rhs_binary=rhs_binary)
