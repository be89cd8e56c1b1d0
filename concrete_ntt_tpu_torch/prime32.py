"""32-bit prime negacyclic NTT plan, batch-first.

Counterpart of `concrete_ntt_tpu/prime32.py` (reference prime32.rs:600-928):
bit-reversed negacyclic twiddle tables with Shoup companions (Montgomery
form for p >= 2^31), forward and inverse transforms, and the fused
elementwise ops. Three regimes by modulus size, as the reference's
dispatch (prime32.rs:713-755): lt30 (p < 2^30), lt31 (p < 2^31) and
generic (Montgomery twiddles).

Transforms take a uint32 tensor or numpy array [..., n] and return a uint32
tensor on the computing device. The plan's device is given at construction
and defaults to the card ("cuda"): a numpy array is moved to it, a tensor
computes on the device it is on. With the default and no GPU a numpy call
raises; the CPU is what a caller asks for with `device="cpu"`.
`ops/ntt_dispatch.fwd32/inv32` choose the tier: the four-step kernel K2
for 2^11 <= n <= 2^17 where `mxu32.applicable` holds (odd p >= 2^26), else
the butterfly kernel K4 up to n = 2^17 (a cluster of blocks a polynomial
above 2^10; the reference's kernel stops at 2^15 and runs its XLA stage
engine above), and above that the stage engine in plain torch on the
operand's device (tier "stage"). K3 is only the sharded four-step's
per-rank pass. A CUDA tensor launches the kernel; a CPU tensor runs its
plain torch twin. Outputs are canonical and equal the JAX package's bit for bit:
fwd = standard order -> bit-reversed NTT values in [0, p); inv =
bit-reversed -> standard order, unnormalized (inv(fwd(x)) == n·x mod p).

The elementwise ops are plain torch on the operands' device (XLA
elementwise code in the JAX package, no Pallas kernel there).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .golden.ntt import negacyclic_twiddles
from .ops import ntt_dispatch
from .ops.u32 import (
    DEFAULT_DEVICE,
    add_mod,
    input_tensor,
    mont_mul,
    mont_neginv,
    to_i64,
    to_u32,
)
from .utils.prime import is_prime64
from .utils.profiling import root_span, span

MIN_N = 2  # any power of two >= 2 (a superset of the reference's n >= 32)


def _variant(p: int) -> str:
    if p < 1 << 30:
        return "lt30"
    if p < 1 << 31:
        return "lt31"
    return "generic"


@lru_cache(maxsize=64)
def _tables(n: int, p: int):
    """Host-side twiddle tables (bit-reversed order, Shoup/Montgomery forms)."""
    twid, inv_twid = negacyclic_twiddles(p, n)
    tw = np.array(twid, dtype=np.uint32)
    itw = np.array(inv_twid, dtype=np.uint32)
    if _variant(p) == "generic":
        tw_m = np.array([(w << 32) % p for w in twid], dtype=np.uint32)
        itw_m = np.array([(w << 32) % p for w in inv_twid], dtype=np.uint32)
        return {"twid": tw_m, "inv_twid": itw_m}
    tws = np.array([(w << 32) // p for w in twid], dtype=np.uint32)
    itws = np.array([(w << 32) // p for w in inv_twid], dtype=np.uint32)
    return {"twid": tw, "twid_shoup": tws, "inv_twid": itw, "inv_twid_shoup": itws}


def _as_tensor(x, device) -> torch.Tensor:
    if not isinstance(x, (np.ndarray, torch.Tensor)):
        raise TypeError(f"expected a uint32 tensor or numpy array, got {type(x).__name__}")
    x = input_tensor(x, device)
    if x.dtype != torch.uint32:
        raise TypeError(f"expected uint32 coefficients, got {x.dtype}")
    return x


@dataclass(frozen=True)
class Plan:
    """Negacyclic NTT plan for Z/pZ, p < 2^32 prime, n a power of two.

    Mirrors `prime32::Plan::try_new(n, p)` (prime32.rs:630-686): requires
    p prime with a primitive 2n-th root of unity (2n | p-1).
    """

    n: int
    p: int
    _tbl: dict = field(repr=False, compare=False)
    device: str = DEFAULT_DEVICE

    # -- construction --------------------------------------------------------

    @classmethod
    def try_new(cls, n: int, p: int, device: str = DEFAULT_DEVICE) -> "Plan | None":
        """Returns None for invalid (n, p) — parity with Plan::try_new."""
        try:
            return cls.new(n, p, device)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, p: int, device: str = DEFAULT_DEVICE) -> "Plan":
        if n < MIN_N or n & (n - 1) != 0:
            raise ValueError(f"n must be a power of two >= {MIN_N}, got {n}")
        if not (2 <= p < 1 << 32):
            raise ValueError(f"p must be a 32-bit modulus, got {p}")
        if not is_prime64(p):
            raise ValueError(f"p must be prime, got {p}")
        if (p - 1) % (2 * n) != 0:
            raise ValueError(f"no 2n-th root of unity: 2*{n} does not divide {p}-1")
        return cls(n=n, p=p, _tbl=_tables(n, p), device=str(device))

    # -- derived constants ---------------------------------------------------

    @property
    def variant(self) -> str:
        return _variant(self.p)

    @property
    def p_neginv(self) -> int:
        return mont_neginv(self.p)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.p - 2, self.p)

    # -- transforms ----------------------------------------------------------

    def _prep(self, x):
        x = _as_tensor(x, self.device)
        if x.dim() < 1 or x.shape[-1] != self.n:
            raise ValueError(f"last axis must be n={self.n}, got {tuple(x.shape)}")
        return x.reshape(-1, self.n).contiguous(), x.shape[:-1]

    def _transform(self, x, run):
        """`run` (`ntt_dispatch.fwd32` or `inv32`) on x in the stage spans."""
        with span("ntt.marshal", "marshal") as sp:
            xb, lead = self._prep(x)
            sp.io(x, xb)
        with span("ntt.transform", "transform") as sp:
            out = run(xb, self._tbl, p=self.p, variant=self.variant, p_neginv=self.p_neginv)
            sp.io(xb, out)
        return out.reshape(*lead, self.n)

    @root_span
    def fwd(self, x):
        """Forward negacyclic NTT: [..., n] standard order, values < p ->
        bit-reversed NTT values in [0, p). (prime32.rs:704-755)"""
        return self._transform(x, ntt_dispatch.fwd32)

    @root_span
    def inv(self, x):
        """Inverse negacyclic NTT: bit-reversed -> standard order, UNnormalized:
        inv(fwd(x)) == n·x mod p. (prime32.rs:757-807)"""
        return self._transform(x, ntt_dispatch.inv32)

    def _carrier(self, x):
        return to_i64(_as_tensor(x, self.device))

    # -- elementwise ops (prime32.rs:812-927) --------------------------------

    @root_span
    def mul_assign_normalize(self, lhs, rhs):
        """lhs·rhs·n^{-1} mod p, elementwise, canonical."""
        with span("ntt.pointwise", "pointwise") as sp:
            c1 = (self.n_inv << 64) % self.p
            v = mont_mul(self._carrier(lhs), self._carrier(rhs), self.p, self.p_neginv)
            out = to_u32(mont_mul(v, c1, self.p, self.p_neginv))
            sp.io(lhs, rhs, out)
        return out

    @root_span
    def normalize(self, values):
        """values·n^{-1} mod p, elementwise."""
        with span("ntt.pointwise", "pointwise") as sp:
            c2 = (self.n_inv << 32) % self.p
            out = to_u32(mont_mul(self._carrier(values), c2, self.p, self.p_neginv))
            sp.io(values, out)
        return out

    @root_span
    def mul_accumulate(self, acc, lhs, rhs):
        """acc + lhs·rhs mod p, elementwise."""
        with span("ntt.pointwise", "pointwise") as sp:
            c3 = (1 << 64) % self.p
            v = mont_mul(self._carrier(lhs), self._carrier(rhs), self.p, self.p_neginv)
            t = mont_mul(v, c3, self.p, self.p_neginv)
            out = to_u32(add_mod(self._carrier(acc), t, self.p))
            sp.io(acc, lhs, rhs, out)
        return out

    # -- convenience ---------------------------------------------------------

    @root_span
    def negacyclic_polymul(self, lhs, rhs):
        """Full negacyclic polynomial product (fwd -> pointwise·n^{-1} -> inv)."""
        fl = self.fwd(lhs)
        fr = self.fwd(rhs)
        return self.inv(self.mul_assign_normalize(fl, fr))
