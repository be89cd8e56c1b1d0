"""Native-binary NTT mod 2^64: one operand has {0,1} coefficients.

Counterpart of `concrete_ntt_tpu/native_binary64.py` (reference
src/native_binary64.rs): Plan32 = 3× 30-bit channels
(native_binary64.rs:17-23), Plan52 = 2× 50-bit channels
(native_binary64.rs:25-29); `fwd_binary` at native_binary64.rs:372-389.
Values in the formats of `native64`. `try_new(n, device=...)`: the plan's
device, by default the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32, build_plans52, channel_accessors
from .ops import crt as crt_ops
from .ops.u32 import DEFAULT_DEVICE
from .tables import PRIMES52, native_channel_primes


@channel_accessors(3)
@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan32 | None":
        primes = native_channel_primes(3, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=64, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_u64_from3(residues, self.primes)

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = True):
        """rhs is the binary operand (the reference's polymul contract)."""
        return super().negacyclic_polymul(lhs, rhs, rhs_binary=rhs_binary)


@channel_accessors(2)
@dataclass(frozen=True)
class Plan52(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan52 | None":
        primes = PRIMES52[:2]
        plans = build_plans52(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=64, primes=primes, plans=plans, tier="plan52",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_from2_p50_u64(residues, self.primes)

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = True):
        return super().negacyclic_polymul(lhs, rhs, rhs_binary=rhs_binary)
