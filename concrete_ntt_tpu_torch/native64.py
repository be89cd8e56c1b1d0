"""Native NTT simulating wrapping arithmetic mod 2^64 via CRT.

Counterpart of `concrete_ntt_tpu/native64.py` (reference src/native64.rs):
Plan32 = 5× 30-bit prime32 channels (~150 bits, native64.rs:16-22,933-942),
with the signed-truncation reconstruction of native64.rs:91-141; Plan52 =
3× 50-bit prime64 channels (native64.rs:29-34,1078-1087), with
reconstruct_52bit_012 (native64.rs:770-829). Both compute the same wrapping
product mod 2^64. `try_new(n, device=...)`: the plan's device, by default
the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32, build_plans52, channel_accessors
from .ops import crt as crt_ops
from .ops.u32 import DEFAULT_DEVICE
from .tables import PRIMES52, native_channel_primes


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
        return cls(n=n, width=64, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_u64_from5(residues, self.primes)


@channel_accessors(3)
@dataclass(frozen=True)
class Plan52(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan52 | None":
        primes = PRIMES52[:3]
        plans = build_plans52(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=64, primes=primes, plans=plans, tier="plan52",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_from3_p50_u64(residues, self.primes)
