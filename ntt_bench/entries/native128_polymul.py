"""Entry: native128's Plan32 negacyclic polymul.

A call is `native128.Plan32(n).negacyclic_polymul(lhs, rhs)` on B
full-range u128 polynomials a side, in the port's planar format: four
uint32 [B, n] tensors (low word first) on the card. It computes the
wrapping product mod (X^n + 1, 2^128) over ten 30-bit CRT channels through
K1a with four operand limbs (twice), the pointwise REDC, K1b, the u128
Garner lift (`ops/crt.py::rec_u128_from10`) and the output marshal. Each
polynomial product counts as one product.

Inputs: a pool of `pool` operand pairs, made on the device from the seed in
one call; call i multiplies lhs slot i mod pool by rhs slot (i + i // pool)
mod pool, so consecutive calls see different pairs. The reference
(`reference/products_u128.py`) recomputes each sampled call's product from
the same operands, a block of polynomials at a time.
"""

from __future__ import annotations

import torch

from ntt_bench.reference import exact, float64_u128, products_u128

BLOCK = 64  # polynomials a reference block
WORDS = 4   # u32 words of a u128


def floor_bytes(batch: int, n: int) -> int:
    """Logical bytes of one call: two u128 operands read, one u128 result
    written, B·n coefficients each."""
    return 48 * batch * n


def _to_u32(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(torch.uint32)


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from concrete_ntt_tpu_torch import native128

        self.n, self.batch, self.pool = int(config["n"]), int(traffic["batch"]), int(traffic["pool"])
        plan = native128.Plan32.try_new(self.n, device=device)
        if plan is None or list(plan.primes) != list(config["primes"]):
            raise RuntimeError(f"native128.Plan32({self.n}) does not run over the configured primes")
        self.plan = plan
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # [pool, side, word, B, n]: full-range u32 words, one call
        self.words = torch.randint(-(1 << 31), 1 << 31, (self.pool, 2, WORDS, self.batch, self.n),
                                   dtype=torch.int32, generator=gen, device=device).view(torch.uint32)
        self.products_per_call = self.batch
        self.floor_bytes = floor_bytes(self.batch, self.n)
        self.port_call = plan.negacyclic_polymul

    def operands(self, i: int) -> tuple:
        a, b = i % self.pool, (i + i // self.pool) % self.pool
        return tuple(self.words[a, 0].unbind(0)), tuple(self.words[b, 1].unbind(0))

    def call(self, i: int):
        lhs, rhs = self.operands(i)
        return i, self.port_call(lhs, rhs)

    def warm(self) -> None:
        for i in range(2):
            self.call(i)

    def control_call(self, lhs, rhs) -> tuple:
        """The reference in float64 in the port's place (the control)."""
        out = float64_u128.polymul_u128([exact.u32_to_i64(x) for x in lhs],
                                        [exact.u32_to_i64(x) for x in rhs])
        return tuple(_to_u32(w) for w in out)

    def release(self) -> None:
        """Drop the port's plan; the operand pool stays for the check."""
        self.plan = self.port_call = None

    def check(self, records: list) -> dict:
        rows = []  # (lhs words, rhs words, out words) of [b, n] each
        unchecked = 0
        for i, out in records:
            if not (isinstance(out, tuple) and len(out) == WORDS
                    and all(isinstance(o, torch.Tensor) and o.dtype == torch.uint32
                            and o.shape == (self.batch, self.n) for o in out)):
                unchecked += 1
                continue
            lhs, rhs = self.operands(i)
            rows.append((*lhs, *rhs, *out))
        mismatched = compared = 0
        per_chunk = max(1, BLOCK // self.batch)
        for start in range(0, len(rows), per_chunk):
            chunk = rows[start:start + per_chunk]
            cols = [exact.u32_to_i64(torch.cat([r[k] for r in chunk])) for k in range(3 * WORDS)]
            for s in range(0, cols[0].shape[0], BLOCK):
                part = [c[s:s + BLOCK] for c in cols]
                want = products_u128.polymul_u128(part[:WORDS], part[WORDS:2 * WORDS])
                bad = torch.zeros_like(want[0], dtype=torch.bool)
                for w, got in zip(want, part[2 * WORDS:]):
                    bad |= w != got
                mismatched += int(bad.sum())
                compared += bad.numel()
                del want, bad
        return {"compared": compared, "unchecked": unchecked, "checks": {"mismatched_coeffs": mismatched}}
