"""32-bit prime negacyclic NTT plan: construction and derived constants.

Counterpart of `concrete_ntt_tpu/prime32.py` (reference prime32.rs:600-928).
What comes across now is what the native64 Plan32 channels need: the
validation of `Plan.new` / `Plan.try_new` and the constants `variant`,
`p_neginv` and `n_inv`. The plan's own transforms (the stage engine with
the lt30 / lt31 / generic butterflies, and the elementwise ops) wait for
ROADMAP.md Queue 1 item 6 and raise NotImplementedError until then.
"""

from __future__ import annotations

from dataclasses import dataclass

from .ops.u32 import mont_neginv
from .utils.prime import is_prime64

MIN_N = 2
_STAGE_ENGINE = "prime32 stage engine (ROADMAP.md Queue 1 item 6)"


def _variant(p: int) -> str:
    if p < 1 << 30:
        return "lt30"
    if p < 1 << 31:
        return "lt31"
    return "generic"


@dataclass(frozen=True)
class Plan:
    """Negacyclic NTT plan for Z/pZ, p < 2^32 prime, n a power of two.

    Mirrors `prime32::Plan::try_new(n, p)` (prime32.rs:630-686): requires
    p prime with a primitive 2n-th root of unity (2n | p-1).
    """

    n: int
    p: int

    @classmethod
    def try_new(cls, n: int, p: int) -> "Plan | None":
        """Returns None for invalid (n, p) — parity with Plan::try_new."""
        try:
            return cls.new(n, p)
        except ValueError:
            return None

    @classmethod
    def new(cls, n: int, p: int) -> "Plan":
        if n < MIN_N or n & (n - 1) != 0:
            raise ValueError(f"n must be a power of two >= {MIN_N}, got {n}")
        if not (2 <= p < 1 << 32):
            raise ValueError(f"p must be a 32-bit modulus, got {p}")
        if not is_prime64(p):
            raise ValueError(f"p must be prime, got {p}")
        if (p - 1) % (2 * n) != 0:
            raise ValueError(f"no 2n-th root of unity: 2*{n} does not divide {p}-1")
        return cls(n=n, p=p)

    @property
    def variant(self) -> str:
        return _variant(self.p)

    @property
    def p_neginv(self) -> int:
        return mont_neginv(self.p)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.p - 2, self.p)

    def fwd(self, x):
        """Forward negacyclic NTT of one prime (not ported yet)."""
        raise NotImplementedError(_STAGE_ENGINE)

    def inv(self, x):
        """Inverse negacyclic NTT of one prime (not ported yet)."""
        raise NotImplementedError(_STAGE_ENGINE)
