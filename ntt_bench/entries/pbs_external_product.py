"""Entry: one step of an NTT-based blind rotation, the external product.

A call is one external product for B GLWE ciphertexts (k = 1, one
decomposition level) over the prime P = 2^64 - 2^32 + 1 through the port's
`prime64.Plan(n, P)`:

  1. `fwd` of the B × 2 decomposed polynomials (K5);
  2. four `mul_accumulate`, one for each (i, j), of digit i with polynomial
     (i, j) of one row of the bootstrapping key, in the NTT domain;
  3. `inv` of the B × 2 sums (K5), added into the accumulator mod P with
     the port's Goldilocks add (`ops/u32.gl_add`).

Each accumulated term d·K counts as one product: 4 a ciphertext a call.
Call i uses key row i mod lwe_dimension (the rows walked in order, as a
blind rotation walks them, and wrapped) and digit set i mod pool; its
accumulator is the one call i - 1 returned.

Made from the seed on the device: the key in the standard domain
(lwe_dimension rows × 4 polynomials in [0, P)), transformed and normalised
in set-up with the port's `fwd` and `normalize` and held on the card for the
run; the digit pool (balanced digits in [-2^(base_log-1), 2^(base_log-1)));
the first accumulator. The caller's rotation by X^a and its gadget
decomposition are left out: that work is the caller's, not this library's.

The check, against the plain reference, from inputs it makes again from the
seed: each sampled call from the accumulator it was given (one step); and
the last call's accumulator from the first one, by linearity: after T steps
it is acc_0 + Σ_{i<T} Σ_i' d_{i mod pool} ⊛ K_{i mod rows}, so every step of
the window is in it, and the key rows are summed for each digit set first.
"""

from __future__ import annotations

import torch

from ntt_bench.reference import float64, products

BLOCK = 256  # ciphertexts a reference block
MASK32 = 0xFFFFFFFF


def floor_bytes(batch: int, n: int) -> int:
    """Logical bytes of one step: the digits (B·2·n u64) read, the
    accumulator (B·2·n u64) read and written, and one key row (4·n u64
    coefficients, 32·n bytes) read once."""
    return 48 * batch * n + 32 * n


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → uint32."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(torch.uint32)


def _limbs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 halves → the port's uint32 limb tensor [..., n, 2]."""
    return torch.stack([_u32(lo), _u32(hi)], dim=-1)


def _halves(limbs: torch.Tensor) -> tuple:
    """uint32 limb tensor [..., 2] → int64 halves (lo, hi)."""
    w = limbs.view(torch.int32).to(torch.int64) & MASK32
    return w[..., 0], w[..., 1]


def _uniform(gen: torch.Generator, shape: tuple, device: str) -> tuple:
    """Halves of values drawn in [0, P) (the few at or above P moved below)."""
    w = torch.randint(0, 1 << 32, (*shape, 2), dtype=torch.int64, generator=gen, device=device)
    lo, hi = w[..., 0], w[..., 1]
    over = (hi == MASK32) & (lo >= 1)
    return torch.where(over, lo - 1, lo), torch.where(over, torch.zeros_like(hi), hi)


def _residue(d: torch.Tensor) -> tuple:
    """Signed digits |d| < 2^31 → halves of d mod P: below zero P + d =
    (2^32 - 1)·2^32 + (d + 1), with a borrow from the high half when d + 1 < 0."""
    e, neg = d + 1, d < 0
    lo = torch.where(neg, e & MASK32, d)
    return lo, torch.where(neg, MASK32 + (e >> 32), torch.zeros_like(d))


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from concrete_ntt_tpu_torch import prime64
        from concrete_ntt_tpu_torch.ops import u32

        self.u32 = u32
        self.n, self.batch, self.pool = int(config["n"]), int(traffic["batch"]), int(traffic["pool"])
        self.p = int(config["ciphertext_modulus"])
        self.rows = int(config["lwe_dimension"])
        if config["glwe_dimension"] != 1 or config["pbs_level"] != 1:
            raise ValueError("this entry runs k = 1 and one decomposition level")
        if self.p != u32.GOLDILOCKS_P:
            raise ValueError("this entry runs the prime 2^64 - 2^32 + 1")
        self.half = 1 << (int(config["pbs_base_log"]) - 1)
        self.device, self.seed = device, seed
        self.plan = prime64.Plan.new(self.n, self.p, device)
        self.key = self.plan.normalize(self.plan.fwd(_limbs(*self.key_standard())))  # [rows, 4, n, 2]
        digits, acc = self.inputs()
        self.digits = _limbs(*_residue(digits))  # [pool, B, 2, n, 2]
        self.acc = _limbs(*acc)                  # [B, 2, n, 2]
        del digits, acc
        self.zero = torch.zeros((self.batch, self.n, 2), dtype=torch.uint32, device=device)
        self.products_per_call = 4 * self.batch
        self.floor_bytes = floor_bytes(self.batch, self.n)
        self.port_call = self.step
        self._key_std = None

    def key_standard(self) -> tuple:
        """The bootstrapping key in the standard domain, halves [rows, 4, n]
        of values in [0, P), made from the seed (again for the reference)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed ^ 0x6B6579)
        return _uniform(gen, (self.rows, 4, self.n), self.device)

    def inputs(self) -> tuple:
        """The digit pool (signed int64 [pool, B, 2, n]) and the first
        accumulator (halves [B, 2, n]), made from the seed (again for the
        reference)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        digits = torch.randint(-self.half, self.half, (self.pool, self.batch, 2, self.n),
                               dtype=torch.int64, generator=gen, device=self.device)
        return digits, _uniform(gen, (self.batch, 2, self.n), self.device)

    def step(self, digits, row: int, acc):
        """The external product through the port: the new accumulator."""
        plan, u32 = self.plan, self.u32
        dig = plan.fwd(digits)  # [B, 2, n, 2]
        key = self.key[row]     # [4, n, 2]
        outs = []
        for j in range(2):
            a = self.zero
            for i in range(2):
                a = plan.mul_accumulate(a, dig[:, i], key[2 * i + j])
            outs.append(a)
        prod = plan.inv(torch.stack(outs, dim=1))  # [B, 2, n, 2]
        s = u32.gl_add((u32.to_i64(acc[..., 0]), u32.to_i64(acc[..., 1])),
                       (u32.to_i64(prod[..., 0]), u32.to_i64(prod[..., 1])))
        return torch.stack([u32.to_u32(s[0]), u32.to_u32(s[1])], dim=-1)

    def call(self, i: int, commit: bool = True):
        k, row, acc = i % self.pool, i % self.rows, self.acc
        out = self.port_call(self.digits[k], row, acc)
        if commit:
            self.acc = out
        return i, k, row, acc, out

    def warm(self) -> None:
        for i in range(2):
            self.call(i, commit=False)

    def control_call(self, digits, row: int, acc):
        """The reference in float64 in the port's place (the control)."""
        if self._key_std is None:
            self._key_std = self.key_standard()
        lo, hi = _halves(digits)
        signed = torch.where(hi == 0, lo, lo + ((hi - MASK32) << 32) - 1)
        k_lo, k_hi = self._key_std
        return _limbs(*float64.external_product(_halves(acc), signed, (k_lo[row][None], k_hi[row][None])))

    def release(self) -> None:
        """Drop the port's plan, the key in its NTT domain and the operands."""
        self.plan = self.key = self.zero = self.port_call = self.digits = self._key_std = None

    def _compare(self, acc, terms, out) -> tuple:
        """Mismatched and compared coefficients of `out` against the
        reference's acc + Σ terms, in blocks of ciphertexts."""
        bad = total = 0
        for s in range(0, out.shape[0], BLOCK):
            blk = slice(s, s + BLOCK)
            part = [(d[blk], (k[0] if k[0].shape[0] == 1 else k[0][blk], k[1] if k[1].shape[0] == 1 else k[1][blk]))
                    for d, k in terms]
            lo, hi = products.external_product((acc[0][blk], acc[1][blk]), part)
            got_lo, got_hi = _halves(out[blk])
            miss = (lo != got_lo) | (hi != got_hi)
            bad += int(miss.sum())
            total += miss.numel()
        return bad, total

    def check(self, records: list) -> dict:
        k_lo, k_hi = self.key_standard()
        digits, acc0 = self.inputs()
        shape = (self.batch, 2, self.n, 2)
        good = [r for r in records
                if isinstance(r[4], torch.Tensor) and r[4].shape == shape and r[4].dtype == torch.uint32]
        step_bad = step_total = 0
        for _, k, row, acc, out in good:  # each sampled step from the accumulator it was given
            bad, total = self._compare(_halves(acc), [(digits[k], (k_lo[row][None], k_hi[row][None]))], out)
            step_bad, step_total = step_bad + bad, step_total + total
        final_bad = final_total = 0
        if good:  # the last call from the first accumulator: every step of the window
            last = max(good, key=lambda r: r[0])
            steps = torch.arange(last[0] + 1)
            counts = torch.zeros((self.pool, self.rows), dtype=torch.int64)
            counts.index_put_((steps % self.pool, steps % self.rows), torch.ones_like(steps), accumulate=True)
            counts = counts.to(self.device)
            terms = []
            for k in range(self.pool):
                if int(counts[k].sum()):
                    g = products.key_sum(counts[k], k_lo, k_hi)
                    terms.append((digits[k], (g[0][None], g[1][None])))
            final_bad, final_total = self._compare(acc0, terms, last[4])
        return {"compared": step_total + final_total, "unchecked": len(records) - len(good),
                "checks": {"mismatched_coeffs": step_bad, "mismatched_final_coeffs": final_bad}}
