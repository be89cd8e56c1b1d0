"""64-bit prime negacyclic NTT plan on u32 limb pairs, batch-first.

Counterpart of `concrete_ntt_tpu/prime64.py` (reference prime64.rs:701-1129).
u64 coefficients live as little-endian uint32 limb pairs. Four regimes by
the modulus, as the reference's dispatch ladder (prime64.rs:794-864):

  * p = 2^64 - 2^32 + 1: Goldilocks / Solinas (`Solinas`);
  * p < 2^62: 64-bit Shoup, lazy [0, 4p) (covers the 50-bit PRIMES52);
  * p < 2^63: 64-bit Shoup, lazy [0, 2p);
  * otherwise: Montgomery-domain twiddles via REDC64.

Data formats of every method: a numpy uint64 array [..., n] (the host
convenience format: moved to the plan's device, the result comes back as
numpy uint64) or a uint32 limb tensor [..., n, 2] (computed on the device it
is on, split once into contiguous lo and hi). The plan's device is given at
construction and defaults to the card ("cuda"); with the default and no GPU
a numpy call raises, and the CPU is what a caller asks for with
`device="cpu"`.

`ops/ntt_dispatch.tier64` chooses the tier: the four-step kernel K5
(`ops/mxu64_cuda.py`) for 2^11 <= n <= 2^15 and odd 2^33 < p < 2^64, the
stage-split hybrid (`ops/stagesplit.py`: butterfly prefix stages + K5 with
block tables) for the same moduli above 2^15, else the stage engine with
`ops/butterflies64.py` in plain torch (the JAX package has no Pallas kernel
there either). A CUDA tensor launches the kernel; a CPU tensor runs its
plain torch twin. Outputs equal the JAX package's bit for
bit: fwd = standard order -> bit-reversed NTT values in [0, p); inv =
bit-reversed -> standard order, unnormalized (inv(fwd(x)) == n·x mod p).
The elementwise ops are plain torch on the operands' device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .golden.ntt import negacyclic_twiddles
from .ops import butterflies64 as bf64
from .ops import ntt_dispatch
from .ops.engine import fwd_stages, inv_stages
from .ops.mxu32 import _dev
from .ops.u32 import (
    DEFAULT_DEVICE,
    GOLDILOCKS_P,
    add_mod64,
    const64_like,
    gl_add,
    gl_mul,
    input_tensor,
    limbs_to_np_u64,
    mont_mul64,
    mont_neginv64,
    np_u64_to_limbs,
    to_i64,
    to_u32,
)
from .utils.prime import is_prime64
from .utils.profiling import root_span, span

#: name parity with `prime64::Solinas` (prime64.rs:22)
Solinas = GOLDILOCKS_P

MIN_N = 2  # any power of two >= 2 (a superset of the reference's n >= 16)


def _variant(p: int) -> str:
    if p == GOLDILOCKS_P:
        return "goldilocks"
    if p < 1 << 62:
        return "shoup62"
    if p < 1 << 63:
        return "shoup63"
    return "generic"


def _split(vals) -> tuple[np.ndarray, np.ndarray]:
    arr = np.array(vals, dtype=np.uint64)
    return ((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (arr >> np.uint64(32)).astype(np.uint32))


@lru_cache(maxsize=64)
def _tables(n: int, p: int):
    """Host-side twiddle tables as limb pairs (bit-reversed order; Shoup
    companions, or Montgomery form for the generic regime)."""
    twid, inv_twid = negacyclic_twiddles(p, n)
    v = _variant(p)
    if v == "generic":
        return {"twid": _split([(w << 64) % p for w in twid]),
                "inv_twid": _split([(w << 64) % p for w in inv_twid])}
    if v == "goldilocks":
        return {"twid": _split(twid), "inv_twid": _split(inv_twid)}
    return {
        "twid": _split(twid),
        "twid_shoup": _split([(w << 64) // p for w in twid]),
        "inv_twid": _split(inv_twid),
        "inv_twid_shoup": _split([(w << 64) // p for w in inv_twid]),
    }


def _butterflies(p: int, direction: str):
    v = _variant(p)
    fwd = direction == "fwd"
    if v == "goldilocks":
        return bf64.make_fwd_goldilocks() if fwd else bf64.make_inv_goldilocks()
    if v == "shoup62":
        return bf64.make_fwd_shoup62(p) if fwd else bf64.make_inv_shoup62(p)
    if v == "shoup63":
        return bf64.make_fwd_shoup63(p) if fwd else bf64.make_inv_shoup63(p)
    ninv = mont_neginv64(p)
    return bf64.make_fwd_generic64(p, ninv) if fwd else bf64.make_inv_generic64(p, ninv)


def _pointwise(a, b, *, p: int, kind: str, c: int):
    """The elementwise products on carrier limb pairs: "mul_norm" and
    "mul_acc" give a·b·c', "normalize" a·c', with c the constant in the
    regime's form (Montgomery factors included outside Goldilocks)."""
    if p == GOLDILOCKS_P:
        r = a if kind == "normalize" else gl_mul(a, b)
        return r if kind == "mul_acc" else gl_mul(r, const64_like(c))
    ninv = mont_neginv64(p)
    r = a if kind == "normalize" else mont_mul64(a, b, p, ninv)
    return mont_mul64(r, const64_like(c), p, ninv)


@dataclass(frozen=True)
class Plan:
    """Negacyclic NTT plan for Z/pZ, p < 2^64 prime, n a power of two."""

    n: int
    p: int
    _tbl: dict = field(repr=False, compare=False)
    device: str = DEFAULT_DEVICE

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
        if not (2 <= p < 1 << 64):
            raise ValueError(f"p must be a 64-bit modulus, got {p}")
        if not is_prime64(p):
            raise ValueError(f"p must be prime, got {p}")
        if (p - 1) % (2 * n) != 0:
            raise ValueError(f"no 2n-th root of unity: 2*{n} does not divide {p}-1")
        return cls(n=n, p=p, _tbl=_tables(n, p), device=str(device))

    @property
    def variant(self) -> str:
        return _variant(self.p)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.p - 2, self.p)

    # -- data marshalling ----------------------------------------------------

    def _to_limbs(self, x):
        """-> (lo [B, n], hi [B, n] contiguous uint32, lead shape, was_u64)."""
        was_u64 = isinstance(x, np.ndarray) and x.dtype == np.uint64
        limbs = input_tensor(np_u64_to_limbs(x) if was_u64 else x, self.device)
        if limbs.dtype != torch.uint32 or limbs.dim() < 2 or limbs.shape[-1] != 2:
            raise TypeError("expected NumPy uint64 [..., n] or a uint32 limb tensor [..., n, 2]")
        if limbs.shape[-2] != self.n:
            raise ValueError(f"transform axis must be n={self.n}, got {tuple(limbs.shape)}")
        lead = tuple(limbs.shape[:-2])
        limbs = limbs.reshape(-1, self.n, 2)
        return limbs[..., 0].contiguous(), limbs[..., 1].contiguous(), lead, was_u64

    def _from_limbs(self, lo, hi, lead, was_u64):
        out = torch.stack([lo, hi], dim=-1).reshape(*lead, self.n, 2)
        if was_u64:
            return limbs_to_np_u64(out.cpu().numpy())
        return out

    def _twid_parts(self, direction: str, device):
        t = self._tbl
        names = ("twid",) if direction == "fwd" else ("inv_twid",)
        if self.variant in ("shoup62", "shoup63"):
            names += (names[0] + "_shoup",)
        return tuple(_dev(a, device) for name in names for a in t[name])

    # -- transforms ----------------------------------------------------------

    def _stage_engine(self, lo, hi, direction: str):
        bf, lbf = _butterflies(self.p, direction)
        run = fwd_stages if direction == "fwd" else inv_stages
        out = run((to_i64(lo), to_i64(hi)), self._twid_parts(direction, lo.device), bf, lbf)
        return to_u32(out[0]), to_u32(out[1])

    def _marshal_in(self, *xs) -> list:
        """`_to_limbs` of each x, in one marshal span."""
        with span("ntt.marshal", "marshal") as sp:
            out = [self._to_limbs(x) for x in xs]
            sp.io(xs, [o[:2] for o in out])
        return out

    def _marshal_out(self, lo, hi, lead, was_u64):
        """`_from_limbs` in a marshal span."""
        with span("ntt.marshal", "marshal") as sp:
            out = self._from_limbs(lo, hi, lead, was_u64)
            sp.io(lo, hi, out)
        return out

    def _transform(self, lo, hi, direction: str):
        """The four-step tier `ntt_dispatch` picks, else the stage engine."""
        with span("ntt.transform", "transform") as sp:
            run = ntt_dispatch.try_fwd64 if direction == "fwd" else ntt_dispatch.try_inv64
            out = run((lo, hi), self.n, self.p)
            if out is None:
                out = self._stage_engine(lo, hi, direction)
            sp.io(lo, hi, out)
        return out

    def fwd_pair(self, lo, hi):
        """Forward NTT of contiguous uint32 limbs [B, n] -> (lo, hi)."""
        return self._transform(lo, hi, "fwd")

    def inv_pair(self, lo, hi):
        """Unnormalized inverse NTT of contiguous uint32 limbs [B, n]."""
        return self._transform(lo, hi, "inv")

    @root_span
    def fwd(self, x):
        """Forward negacyclic NTT: standard order, values < p -> bit-reversed
        NTT values in [0, p)."""
        ((lo, hi, lead, u64),) = self._marshal_in(x)
        return self._marshal_out(*self.fwd_pair(lo, hi), lead, u64)

    @root_span
    def inv(self, x):
        """Inverse negacyclic NTT: bit-reversed -> standard order,
        unnormalized: inv(fwd(x)) == n·x mod p."""
        ((lo, hi, lead, u64),) = self._marshal_in(x)
        return self._marshal_out(*self.inv_pair(lo, hi), lead, u64)

    # -- elementwise ops (prime64.rs:944-1129) --------------------------------

    def _elementwise(self, kind: str, c: int, lhs, rhs=None, acc=None):
        given = [x for x in (lhs, rhs, acc) if x is not None]
        limbs = self._marshal_in(*given)
        lead, u64 = limbs[0][2:]
        with span("ntt.pointwise", "pointwise") as sp:
            carriers = [(to_i64(lo), to_i64(hi)) for lo, hi, _, _ in limbs]
            a = carriers[0]
            b = carriers[1] if rhs is not None else a
            r = _pointwise(a, b, p=self.p, kind=kind, c=c)
            if acc is not None:
                cc = carriers[-1]
                r = gl_add(cc, r) if self.p == GOLDILOCKS_P else add_mod64(cc, r, self.p)
            r = (to_u32(r[0]), to_u32(r[1]))
            sp.io([x[:2] for x in limbs], r)
        return self._marshal_out(*r, lead, u64)

    def _const(self, shift: int) -> int:
        """n^-1 (or 1 for shift 0 of mul_accumulate) in the regime's form."""
        return self.n_inv if self.variant == "goldilocks" else (self.n_inv << shift) % self.p

    @root_span
    def mul_assign_normalize(self, lhs, rhs):
        """lhs·rhs·n^{-1} mod p, elementwise, canonical."""
        return self._elementwise("mul_norm", self._const(128), lhs, rhs)

    @root_span
    def normalize(self, values):
        """values·n^{-1} mod p, elementwise."""
        return self._elementwise("normalize", self._const(64), values)

    @root_span
    def mul_accumulate(self, acc, lhs, rhs):
        """acc + lhs·rhs mod p, elementwise."""
        c = 1 if self.variant == "goldilocks" else (1 << 128) % self.p
        return self._elementwise("mul_acc", c, lhs, rhs, acc)

    # -- convenience ---------------------------------------------------------

    @root_span
    def negacyclic_polymul(self, lhs, rhs):
        """Full negacyclic polynomial product (fwd -> pointwise·n^{-1} -> inv),
        kept in limb pairs on the device between the steps."""
        (a_lo, a_hi, lead, u64), (b_lo, b_hi, _, _) = self._marshal_in(lhs, rhs)
        fl = self.fwd_pair(a_lo, a_hi)
        fr = self.fwd_pair(b_lo, b_hi)
        with span("ntt.pointwise", "pointwise") as sp:
            prod = _pointwise(tuple(map(to_i64, fl)), tuple(map(to_i64, fr)), p=self.p,
                              kind="mul_norm", c=self._const(128))
            prod = (to_u32(prod[0]), to_u32(prod[1]))
            sp.io(fl, fr, prod)
        return self._marshal_out(*self.inv_pair(*prod), lead, u64)
