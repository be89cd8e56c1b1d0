"""Entry: native64's Plan52 negacyclic polymul.

A call is `native64.Plan52(n).negacyclic_polymul(lhs, rhs)` on B
full-range u64 polynomials a side, in the port's planar format: a (lo, hi)
pair of uint32 [B, n] tensors on the card. It computes the wrapping product
mod (X^n + 1, 2^64) over three 50-bit CRT channels through K7a (twice),
K7d (the pointwise product fused into the inverse), the 50-bit Garner lift
(`ops/crt.py::rec_from3_p50_u64`) and the output marshal. Each polynomial
product counts as one product.

Everything but the plan is the native64 entry's (`native64_polymul.py`):
the operand pool, drawn from the seed as that entry draws it (a seed gives
both cells the same operands), the call order, the check against
`reference/products.polymul_u64`, the float64 control and `floor_bytes`.
"""

from __future__ import annotations

import torch

from ntt_bench import spec

_native64 = spec.load_module("entries", "native64_polymul")
floor_bytes = _native64.floor_bytes


class Workload(_native64.Workload):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from concrete_ntt_tpu_torch import native64

        self.n, self.batch, self.pool = int(config["n"]), int(traffic["batch"]), int(traffic["pool"])
        plan = native64.Plan52.try_new(self.n, device=device)
        if plan is None or list(plan.primes) != list(config["primes"]):
            raise RuntimeError(f"native64.Plan52({self.n}) does not run over the configured primes")
        self.plan = plan
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # [pool, side, limb, B, n]: full-range u32 words, one call
        self.words = torch.randint(-(1 << 31), 1 << 31, (self.pool, 2, 2, self.batch, self.n),
                                   dtype=torch.int32, generator=gen, device=device).view(torch.uint32)
        self.products_per_call = self.batch
        self.floor_bytes = floor_bytes(self.batch, self.n)
        self.port_call = plan.negacyclic_polymul
