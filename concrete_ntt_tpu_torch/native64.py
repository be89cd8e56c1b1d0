"""Native NTT simulating wrapping arithmetic mod 2^64 via CRT.

Counterpart of `concrete_ntt_tpu/native64.py` (reference src/native64.rs):
Plan32 = 5× 30-bit prime32 channels (~150 bits, native64.rs:16-22,933-942),
with the signed-truncation reconstruction of native64.rs:91-141. Plan52
(3× 50-bit prime64 channels) waits for ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32
from .ops import crt as crt_ops
from .tables import native_channel_primes


@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int) -> "Plan32 | None":
        primes = native_channel_primes(5, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes)
        if not plans:
            return None
        return cls(n=n, width=64, primes=primes, plans=plans)

    def _reconstruct(self, residues):
        return crt_ops.rec_u64_from5(residues, self.primes)

    def ntt_0(self):
        return self.plans[0]

    def ntt_1(self):
        return self.plans[1]

    def ntt_2(self):
        return self.plans[2]

    def ntt_3(self):
        return self.plans[3]

    def ntt_4(self):
        return self.plans[4]
