"""Native NTT simulating wrapping arithmetic mod 2^32 via CRT.

Counterpart of `concrete_ntt_tpu/native32.py` (reference src/native32.rs):
Plan32 runs 3× 30-bit prime32 channels (~90 bits of headroom,
native32.rs:8-12,338-345) with the single-prime Garner lift of
native32.rs:28-55; Plan52 runs 2× 50-bit prime64 channels
(native32.rs:19,441-445) on `(x, 0)` limb pairs. Values are uint32 tensors or
numpy arrays [..., n].

Exactness contract: negacyclic_polymul equals the schoolbook negacyclic
convolution in wrapping u32 arithmetic whenever the signed result stays
within ±(Π primes)/2, which holds for all u32 inputs at supported n.
`try_new(n, device=...)`: the plan's device, by default the card.
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
        return cls(n=n, width=32, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_u32_from3(residues, self.primes)


@channel_accessors(2)
@dataclass(frozen=True)
class Plan52(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan52 | None":
        primes = PRIMES52[:2]
        plans = build_plans52(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=32, primes=primes, plans=plans, tier="plan52",
                   device=str(device))

    def _reconstruct(self, residues):
        return crt_ops.rec_from2_p50_u32(residues, self.primes)
