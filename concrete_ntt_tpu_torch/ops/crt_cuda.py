"""The native64 Plan32 Garner lift as one CUDA kernel.

`rec_u64_from5(residues, primes) -> (lo, hi)`: the standard-order residues
of five 30-bit CRT channels, uint32 [5, B, n] contiguous, -> the wrapping
u64 values as two uint32 [B, n] limb planes. It computes
`ops/crt.py` rec_u64_from5 (the reference's reconstruct_32bit_01234_v2,
native64.rs:91-141: pair digits, the v2 pairing, the sign by the top
digit's rule), bit for bit on any uint32 input; canonical residues, what
K1b and every channel plan's inverse return, are the contract.

The kernel replaces no TPU kernel (the JAX package leaves the lift to XLA).
It is CUDA C++ for sm_90a in `csrc/crt_lift.cu`, built with nvcc at first
use (ops/cuda_build.py) and called through ctypes: one streaming launch,
four coefficients a thread, 28 bytes a coefficient against the plain
chain's ~860 int64 torch operations on [B, n] tensors. Its constants
(`lift_constants`, Python bigints once per primes tuple) reach the kernel
by value in its parameters, so a CUDA graph captures it whole.

Routing is by the device of the residues: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain twin `rec_u64_from5_plain`
(`to_i64`, `ops/crt.py` rec_u64_from5, `to_u32`). Every launch adds one to
`LAUNCHES["lift_u64_from5"]` (read into each top-level span's `launches` by
`utils/profiling`). Only `native64.Plan32` lifts through it
(`_lift_parts`); the other native families and the sharded route's
`_reconstruct` keep the plain chain.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import profiling
from . import crt, cuda_build
from .mxu32_cuda import _call
from .u32 import to_i64, to_u32

LAUNCHES = {"lift_u64_from5": 0}
profiling.register_launches(LAUNCHES)

CHANNELS = 5
MASK64 = (1 << 64) - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    err = _call(residues.device, _lib().lift_u64_from5, residues.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), lo.numel(), ctypes.byref(consts))
    LAUNCHES["lift_u64_from5"] += 1
    if err != 0:
        raise RuntimeError(f"lift_u64_from5 launch failed: CUDA error {err}")
    return lo, hi
