"""Native-binary NTT mod 2^128: one operand has {0,1} coefficients.

Counterpart of `concrete_ntt_tpu/native_binary128.py` (reference
src/native_binary128.rs): Plan32 = 5× 30-bit channels
(native_binary128.rs:4-10); no Plan52 tier (parity with the reference).
Reconstruction: v2 pair digits v0 / v12 / v34 → u128
(native_binary128.rs:13-66). In a polymul the u128 lhs goes through K1a
with four limbs and the {0,1} rhs with one. Values in the formats of
`native128`. `try_new(n, device=...)`: the plan's device, by default the
card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32, channel_accessors
from .ops import crt as crt_ops
from .ops.u32 import DEFAULT_DEVICE
from .tables import native_channel_primes


@channel_accessors(5)
@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan32 | None":
        primes = native_channel_primes(5, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=128, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_u128_from5(residues, self.primes)

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = True):
        """rhs is the binary operand (the reference's polymul contract)."""
        return super().negacyclic_polymul(lhs, rhs, rhs_binary=rhs_binary)
