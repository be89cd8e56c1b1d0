"""Native NTT simulating wrapping arithmetic mod 2^128 via CRT.

Counterpart of `concrete_ntt_tpu/native128.py` (reference src/native128.rs):
Plan32 = 10× 30-bit prime32 channels (~300 bits, native128.rs:6-17,123-137)
with the v2 pair-digit lift of native128.rs:20-118. The reference has no
Plan52 tier at width 128 and neither has the port.

u128 values are planar tuples of four uint32 tensors [..., n] (the
performance format: K1a reads the four limbs as they are, the u128 →
residue split folded into its column matmul as 16 operand digit planes),
uint32 limb tensors [..., n, 4], or flat lists of Python ints for host
convenience. Plan32 lifts through two CUDA kernels on the card
(`ops/crt_cuda.py::rec_u128_from10`, `_lift_parts`: the digits, then the
limbs) and the int64 chain `ops/crt.py::rec_u128_from10` on the CPU;
`_reconstruct`, that chain on int64 carriers, stays for the sharded route
(`parallel/channels.py`). The int8-GEMM twin `crt_mxu.rec_u128_from10` is
ported and, as in the reference, taken by no route.
`try_new(n, device=...)`: the plan's device, by default the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32, channel_accessors
from .ops import crt as crt_ops
from .ops import crt_cuda
from .ops.u32 import DEFAULT_DEVICE
from .tables import native_channel_primes


@channel_accessors(10)
@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int, device: str = DEFAULT_DEVICE) -> "Plan32 | None":
        primes = native_channel_primes(10, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes, device)
        if not plans:
            return None
        return cls(n=n, width=128, primes=primes, plans=plans, tier="plan32",
                   device=str(device))

    def _lift_parts(self, residues) -> tuple:
        """The lift kernels (`ops/crt_cuda.py`) on the card, their plain twin
        on the CPU: uint32 [10, B, n] -> four limb planes."""
        return crt_cuda.rec_u128_from10(residues, self.primes)

    def _reconstruct(self, residues):
        return crt_ops.rec_u128_from10(residues, self.primes)
