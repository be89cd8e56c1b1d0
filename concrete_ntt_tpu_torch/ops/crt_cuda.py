"""The native Plan32 Garner lifts as CUDA kernels: native64's and native128's.

`rec_u64_from5(residues, primes) -> (lo, hi)`: the standard-order residues
of five 30-bit CRT channels, uint32 [5, B, n] contiguous, -> the wrapping
u64 values as two uint32 [B, n] limb planes. It computes
`ops/crt.py` rec_u64_from5 (the reference's reconstruct_32bit_01234_v2,
native64.rs:91-141: pair digits, the v2 pairing, the sign by the top
digit's rule), bit for bit on any uint32 input; canonical residues, what
K1b and every channel plan's inverse return, are the contract.

`rec_u128_from10(residues, primes) -> (l0, l1, l2, l3)`: ten channels,
uint32 [10, B, n] contiguous, -> the wrapping u128 values as four uint32
[B, n] limb planes, least significant first: `ops/crt.py` rec_u128_from10
(reconstruct_32bit_0123456789_v2, native128.rs:20-118), bit for bit on any
uint32 input, in two launches: the five mixed-radix digits as u64 planes
(inside the span `ntt.lift_digits`), then the limbs and the sign by the
top digit's rule (inside `ntt.lift_limbs`).

Neither replaces a TPU kernel (the JAX package leaves the lifts to XLA).
They are CUDA C++ for sm_90a in `csrc/crt_lift.cu` and `csrc/crt_lift128.cu`
(two libraries that share no code), built with nvcc at first use
(ops/cuda_build.py) and called through ctypes: streaming launches, four
coefficients a thread, against the plain chains' ~860 and ~5,000 int64
torch operations on [B, n] tensors. Their constants (`lift_constants`,
`lift10_constants`: Python bigints once per primes tuple) reach the kernels
by value in their parameters, so a CUDA graph captures them whole.

Routing is by the device of the residues: a CUDA tensor launches the
kernels or raises, a CPU tensor runs the plain twin (`rec_u64_from5_plain`,
`rec_u128_from10_plain`: `to_i64`, the `ops/crt.py` function, `to_u32`).
Every launch adds one to its key of `LAUNCHES` (read into each top-level
span's `launches` by `utils/profiling`). `native64.Plan32` and
`native128.Plan32` lift through them (`_lift_parts`); the other native
families and the sharded route's `_reconstruct` keep the plain chain.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import profiling
from . import crt, cuda_build
from .cuda_build import call
from .u32 import to_i64, to_u32

LAUNCHES = {"lift_u64_from5": 0, "lift_u128_digits": 0, "lift_u128_limbs": 0}
profiling.register_launches(__name__, LAUNCHES)

CHANNELS = 5
MASK64 = (1 << 64) - 1


class Lift5Consts(ctypes.Structure):
    """The kernel's constants (`Lift5Consts` of csrc/crt_lift.cu: the same
    fields in the same order)."""

    _fields_ = ([(f, ctypes.c_uint64) for f in ("p12", "p34", "c12", "c12_sh", "a34", "a34_sh",
                                                "c34", "c34_sh", "half34", "k12", "m")]
                + [(f, ctypes.c_uint32) for f in ("p0", "p1", "p2", "p3", "p4", "inv12",
                                                  "inv12_sh", "inv34", "inv34_sh")])


@lru_cache(maxsize=16)
def lift_constants(primes: tuple) -> Lift5Consts:
    """The constants of ops/crt.py rec_u64_from5 for `primes` (five primes
    below 2^31), each with its Shoup companion floor(c * 2^32 / p) or
    floor(c * 2^64 / p)."""
    if len(primes) != CHANNELS or any(not 2 < p < 1 << 31 or p % 2 == 0 for p in primes):
        raise ValueError(f"the lift takes five odd primes below 2^31, got {primes}")
    p0, p1, p2, p3, p4 = primes
    p12, p34 = p1 * p2, p3 * p4
    inv12, inv34 = pow(p1, p2 - 2, p2), pow(p3, p4 - 2, p4)
    c12 = pow(p0 % p12, (p1 - 1) * (p2 - 1) - 1, p12)
    a34 = p0 % p34
    c34 = pow((p0 * p12) % p34, (p3 - 1) * (p4 - 1) - 1, p34)
    return Lift5Consts(
        p12=p12, p34=p34, c12=c12, c12_sh=(c12 << 64) // p12, a34=a34, a34_sh=(a34 << 64) // p34,
        c34=c34, c34_sh=(c34 << 64) // p34, half34=p34 // 2 + 1, k12=(p0 * p12) & MASK64,
        m=(p0 * p12 * p34) & MASK64, p0=p0, p1=p1, p2=p2, p3=p3, p4=p4, inv12=inv12,
        inv12_sh=(inv12 << 32) // p2, inv34=inv34, inv34_sh=(inv34 << 32) // p4)


def rec_u64_from5_plain(residues: torch.Tensor, primes) -> tuple:
    """Plain twin: uint32 [5, ...] -> (lo, hi) uint32 [...] through the int64
    chain of ops/crt.py, on the device of the residues."""
    mods = to_i64(residues)
    lo, hi = crt.rec_u64_from5([mods[i] for i in range(CHANNELS)], tuple(primes))
    return to_u32(lo), to_u32(hi)


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("crt_lift")
    if not lib.lift_u64_from5.argtypes:
        lib.lift_u64_from5.argtypes = [_P, _P, _P, ctypes.c_longlong,
                                       ctypes.POINTER(Lift5Consts), _P]
        lib.lift_u64_from5.restype = ctypes.c_int
    return lib


def rec_u64_from5(residues: torch.Tensor, primes) -> tuple:
    """uint32 [5, B, n] residues (contiguous) -> (lo, hi) uint32 [B, n]: the
    kernel for a CUDA tensor, the plain twin for a CPU one."""
    if not isinstance(residues, torch.Tensor) or residues.dtype != torch.uint32:
        raise TypeError("residues must be a uint32 tensor")
    if residues.dim() < 2 or residues.shape[0] != CHANNELS:
        raise ValueError(f"expected residues [5, ..., n], got {tuple(residues.shape)}")
    if not residues.is_contiguous():
        raise ValueError("the residues must be contiguous")
    primes = tuple(primes)
    consts = lift_constants(primes)
    if residues.device.type == "cpu":
        return rec_u64_from5_plain(residues, primes)
    if residues.device.type != "cuda":
        raise ValueError(f"no route for tensors on {residues.device}: use cuda or cpu")
    lo = torch.empty(residues.shape[1:], dtype=torch.uint32, device=residues.device)
    hi = torch.empty_like(lo)
    if lo.numel() == 0:
        return lo, hi
    err = call(residues.device, _lib().lift_u64_from5, residues.data_ptr(), lo.data_ptr(),
               hi.data_ptr(), lo.numel(), ctypes.byref(consts))
    LAUNCHES["lift_u64_from5"] += 1
    if err != 0:
        raise RuntimeError(f"lift_u64_from5 launch failed: CUDA error {err}")
    return lo, hi


# -- native128 Plan32: ten channels -> u128, csrc/crt_lift128.cu ----------------------

CHANNELS10 = 5 * 2
MASK128 = (1 << 128) - 1


class Lift10Consts(ctypes.Structure):
    """The two kernels' constants (`Lift10Consts` of csrc/crt_lift128.cu: the
    same fields in the same order)."""

    _fields_ = ([(f, ctypes.c_uint64 * k) for f, k in (
        ("pp", 5), ("horner", 6), ("horner_sh", 6), ("phi", 4), ("phi_sh", 4), ("pref_lo", 4),
        ("pref_hi", 4))]
                + [(f, ctypes.c_uint64) for f in ("m_lo", "m_hi", "half")]
                + [(f, ctypes.c_uint32 * k) for f, k in (("p", 10), ("inv", 5), ("inv_sh", 5))])


@lru_cache(maxsize=16)
def lift10_constants(primes: tuple) -> Lift10Consts:
    """The constants of ops/crt.py rec_u128_from10 for `primes` (ten odd
    primes below 2^31), each multiplier with its Shoup companion
    floor(c * 2^32 / p) or floor(c * 2^64 / P)."""
    if len(primes) != CHANNELS10 or any(not 2 < p < 1 << 31 or p % 2 == 0 for p in primes):
        raise ValueError(f"the lift takes ten odd primes below 2^31, got {primes}")
    pp = [primes[2 * i] * primes[2 * i + 1] for i in range(5)]
    inv = [pow(primes[2 * i], -1, primes[2 * i + 1]) for i in range(5)]
    horner = [pp[j] % pp[i] for i in range(2, 5) for j in range(i - 2, -1, -1)]
    pref = [1]
    for q in pp:
        pref.append(pref[-1] * q)
    phi = [pow(pref[i] % pp[i], -1, pp[i]) for i in range(1, 5)]
    sh64 = lambda cs, mods: [(c << 64) // q for c, q in zip(cs, mods)]
    return Lift10Consts(
        pp=(ctypes.c_uint64 * 5)(*pp), horner=(ctypes.c_uint64 * 6)(*horner),
        horner_sh=(ctypes.c_uint64 * 6)(*sh64(horner, [pp[i] for i in range(2, 5)
                                                      for _ in range(i - 1)])),
        phi=(ctypes.c_uint64 * 4)(*phi), phi_sh=(ctypes.c_uint64 * 4)(*sh64(phi, pp[1:])),
        pref_lo=(ctypes.c_uint64 * 4)(*[v & MASK64 for v in pref[1:5]]),
        pref_hi=(ctypes.c_uint64 * 4)(*[(v & MASK128) >> 64 for v in pref[1:5]]),
        m_lo=pref[5] & MASK64, m_hi=(pref[5] & MASK128) >> 64, half=pp[4] // 2 + 1,
        p=(ctypes.c_uint32 * 10)(*primes), inv=(ctypes.c_uint32 * 5)(*inv),
        inv_sh=(ctypes.c_uint32 * 5)(*[(v << 32) // primes[2 * i + 1] for i, v in enumerate(inv)]))


def rec_u128_from10_plain(residues: torch.Tensor, primes) -> tuple:
    """Plain twin: uint32 [10, ...] -> four uint32 [...] limb planes through
    the int64 chain of ops/crt.py, on the device of the residues."""
    mods = to_i64(residues)
    limbs = crt.rec_u128_from10([mods[i] for i in range(CHANNELS10)], tuple(primes))
    return tuple(to_u32(v) for v in limbs)


def _lib128() -> ctypes.CDLL:
    lib = cuda_build.load("crt_lift128")
    for fn in (lib.lift_u128_digits, lib.lift_u128_limbs):
        if not fn.argtypes:
            fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.POINTER(Lift10Consts), _P]
            fn.restype = ctypes.c_int
    return lib


def _launch128(name: str, src: torch.Tensor, dst: torch.Tensor, consts: Lift10Consts) -> None:
    """One launch of lift_u128_<name> from `src`'s planes into `dst`'s, over
    the coefficients of a plane of `dst`."""
    key = f"lift_u128_{name}"
    err = call(src.device, getattr(_lib128(), key), src.data_ptr(), dst.data_ptr(),
               dst[0].numel(), ctypes.byref(consts))
    LAUNCHES[key] += 1
    if err != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {err}")


def rec_u128_from10(residues: torch.Tensor, primes) -> tuple:
    """uint32 [10, B, n] residues (contiguous) -> four uint32 [B, n] limb
    planes: the two kernels for a CUDA tensor, the plain twin for a CPU
    one."""
    if not isinstance(residues, torch.Tensor) or residues.dtype != torch.uint32:
        raise TypeError("residues must be a uint32 tensor")
    if residues.dim() < 2 or residues.shape[0] != CHANNELS10:
        raise ValueError(f"expected residues [10, ..., n], got {tuple(residues.shape)}")
    if not residues.is_contiguous():
        raise ValueError("the residues must be contiguous")
    primes = tuple(primes)
    consts = lift10_constants(primes)
    if residues.device.type == "cpu":
        return rec_u128_from10_plain(residues, primes)
    if residues.device.type != "cuda":
        raise ValueError(f"no route for tensors on {residues.device}: use cuda or cpu")
    shape = residues.shape[1:]
    limbs = torch.empty((4, *shape), dtype=torch.uint32, device=residues.device)
    if limbs.numel() == 0:
        return tuple(limbs)
    digits = torch.empty((5, *shape), dtype=torch.uint64, device=residues.device)
    with profiling.span("ntt.lift_digits", "lift_digits") as sp:
        _launch128("digits", residues, digits, consts)
        sp.io(residues, digits)
    with profiling.span("ntt.lift_limbs", "lift_limbs") as sp:
        _launch128("limbs", digits, limbs, consts)
        sp.io(digits, limbs)
    return tuple(limbs)
