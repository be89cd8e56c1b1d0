"""Entry: native64's Plan32 negacyclic polymul, the north star.

A call is `native64.Plan32(n).negacyclic_polymul(lhs, rhs)` on B
full-range u64 polynomials a side, in the port's planar format: a (lo, hi)
pair of uint32 [B, n] tensors on the card. It computes the wrapping product
mod (X^n + 1, 2^64) through K1a, the pointwise REDC, K1b, the CRT lift and
the output marshal. Each polynomial product counts as one product.

Inputs: a pool of `pool` operand pairs, made on the device from the seed in
one call; call i multiplies lhs slot i mod pool by rhs slot (i + i // pool)
mod pool, so consecutive calls see different pairs. The reference
recomputes each sampled call's product from the same operands.
"""

from __future__ import annotations

import torch

from ntt_bench.reference import exact, float64, products

BLOCK = 64  # polynomials a reference block


def floor_bytes(batch: int, n: int) -> int:
    """Logical bytes of one call: two u64 operands read, one u64 result
    written, B·n coefficients each."""
    return 24 * batch * n


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from concrete_ntt_tpu_torch import native64

        self.n, self.batch, self.pool = int(config["n"]), int(traffic["batch"]), int(traffic["pool"])
        plan = native64.Plan32.try_new(self.n, device=device)
        if plan is None or list(plan.primes) != list(config["primes"]):
            raise RuntimeError(f"native64.Plan32({self.n}) does not run over the configured primes")
        self.plan = plan
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # [pool, side, limb, B, n]: full-range u32 words, one call
        self.words = torch.randint(-(1 << 31), 1 << 31, (self.pool, 2, 2, self.batch, self.n),
                                   dtype=torch.int32, generator=gen, device=device).view(torch.uint32)
        self.products_per_call = self.batch
        self.floor_bytes = floor_bytes(self.batch, self.n)
        self.port_call = plan.negacyclic_polymul

    def operands(self, i: int) -> tuple:
        a, b = i % self.pool, (i + i // self.pool) % self.pool
        return (self.words[a, 0, 0], self.words[a, 0, 1]), (self.words[b, 1, 0], self.words[b, 1, 1])

    def call(self, i: int):
        lhs, rhs = self.operands(i)
        return i, self.port_call(lhs, rhs)

    def warm(self) -> None:
        for i in range(2):
            self.call(i)

    def control_call(self, lhs, rhs) -> tuple:
        """The reference in float64 in the port's place (the control)."""
        lo, hi = float64.polymul_u64(*(exact.u32_to_i64(x) for x in (*lhs, *rhs)))
        to_u32 = lambda v: torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(torch.uint32)  # noqa: E731
        return to_u32(lo), to_u32(hi)

    def release(self) -> None:
        """Drop the port's plan; the operand pool stays for the check."""
        self.plan = self.port_call = None

    def check(self, records: list) -> dict:
        rows = []  # (lhs_lo, lhs_hi, rhs_lo, rhs_hi, out_lo, out_hi) blocks of [b, n]
        unchecked = 0
        for i, out in records:
            if not (isinstance(out, tuple) and len(out) == 2
                    and all(o.shape == (self.batch, self.n) for o in out)):
                unchecked += 1
                continue
            lhs, rhs = self.operands(i)
            rows.append((*lhs, *rhs, *out))
        mismatched = compared = 0
        for start in range(0, len(rows), max(1, BLOCK // self.batch)):
            chunk = rows[start:start + max(1, BLOCK // self.batch)]
            cols = [exact.u32_to_i64(torch.cat([r[k] for r in chunk])) for k in range(6)]
            for s in range(0, cols[0].shape[0], BLOCK):
                part = [c[s:s + BLOCK] for c in cols]
                lo, hi = products.polymul_u64(*part[:4])
                bad = (lo != part[4]) | (hi != part[5])
                mismatched += int(bad.sum())
                compared += bad.numel()
        return {"compared": compared, "unchecked": unchecked, "checks": {"mismatched_coeffs": mismatched}}
