"""The native Plan32 polymul's pointwise Montgomery product as a CUDA kernel.

`mont_mul32(fl, fr, primes) -> prod`: the NTT-domain residues of C channels,
uint32 [C, B, n] contiguous on the card, -> uint32 [C, B, n], each element
`a·b·2^-32 mod p` of its channel (the bare Montgomery product; the polymul's
inverse folds 2^32 back in). It computes `ops/u32.py` mont_mul, K1d's form
(`csrc/mont32.cuh`, shared with K1d's fragment read), bit for bit on any
uint32 operands: below 2^32 and congruent to a·b·2^-32 mod p always, and
canonical, in [0, p), wherever a·b < p·2^32, so wherever one operand is
below p (the forward transforms' outputs).

It replaces no TPU kernel (the JAX package leaves the product to XLA). It is
CUDA C++ for sm_90a in `csrc/mont32_pointwise.cu`, built with nvcc at first
use (ops/cuda_build.py) and called through ctypes: one streaming launch,
four coefficients a thread, against the plain twin's ~66 int64 torch
operations on [C, B, n] tensors. The channels' (p, -p^-1 mod 2^32) reach
the kernel by value in its parameters (`mont32_constants`, once per primes
tuple), so a CUDA graph captures the launch whole.

`mont_mul32` launches the kernel or raises: it takes only CUDA tensors.
`mont_mul32_plain` is its plain twin on the operands' device (`to_i64`,
`ops/u32.py` mont_mul over the channels' constant columns, `to_u32`).
`ntt_dispatch.pointwise_mont32` routes by the device of the residues. Every
launch adds one to `LAUNCHES["pointwise_mont32"]` (read into each top-level
span's `launches` by `utils/profiling`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import profiling
from . import cuda_build
from .cuda_build import call
from .u32 import mont_mul, mont_neginv, to_i64, to_u32

LAUNCHES = {"pointwise_mont32": 0}
profiling.register_launches(__name__, LAUNCHES)

MAX_CHANNELS = 16  # kMaxChannels of csrc/mont32_pointwise.cu


class Mont32Consts(ctypes.Structure):
    """The kernel's constants (`Mont32Consts` of csrc/mont32_pointwise.cu:
    the same fields in the same order; channels past C are zero)."""

    _fields_ = [("p", ctypes.c_uint32 * MAX_CHANNELS),
                ("p_neginv", ctypes.c_uint32 * MAX_CHANNELS)]


def _check_primes(primes: tuple) -> None:
    if not 1 <= len(primes) <= MAX_CHANNELS or any(
            not 2 < p < 1 << 32 or p % 2 == 0 for p in primes):
        raise ValueError(f"the product takes 1 to {MAX_CHANNELS} odd primes below 2^32, "
                         f"got {primes}")


@lru_cache(maxsize=64)
def mont32_constants(primes: tuple) -> Mont32Consts:
    """(p, -p^-1 mod 2^32) of each channel, zero past the last."""
    _check_primes(primes)
    pad = (0,) * (MAX_CHANNELS - len(primes))
    return Mont32Consts(p=(ctypes.c_uint32 * MAX_CHANNELS)(*primes, *pad),
                        p_neginv=(ctypes.c_uint32 * MAX_CHANNELS)(
                            *(mont_neginv(p) for p in primes), *pad))


@lru_cache(maxsize=64)
def _mont_columns(primes: tuple, device: str) -> tuple:
    """(p, -p^-1 mod 2^32) of each channel as int64 [C, 1, 1] tensors on
    `device`, made once: a per-call host-to-device copy would stop a CUDA
    graph capture of the polymul."""
    def col(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device).reshape(-1, 1, 1)

    return col(primes), col([mont_neginv(p) for p in primes])


def _check(fl, fr, primes: tuple) -> None:
    """The operands both paths take: uint32 [C, B, n] tensors of one shape
    on one device, C the number of primes."""
    _check_primes(primes)
    for t in (fl, fr):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint32:
            raise TypeError("the residues must be uint32 tensors")
    if fl.dim() != 3 or fl.shape != fr.shape or fl.shape[0] != len(primes):
        raise ValueError(f"expected two residue tensors [{len(primes)}, B, n] of one shape, got "
                         f"{tuple(fl.shape)} and {tuple(fr.shape)}")
    if fl.device != fr.device:
        raise ValueError(f"the residues are on {fl.device} and {fr.device}")


def mont_mul32_plain(fl: torch.Tensor, fr: torch.Tensor, primes) -> torch.Tensor:
    """Plain twin: uint32 [C, B, n] x2 -> uint32 [C, B, n] through
    `ops/u32.py` mont_mul on int64 carriers, on the device of the residues."""
    primes = tuple(primes)
    _check(fl, fr, primes)
    pv, nv = _mont_columns(primes, str(fl.device))
    return to_u32(mont_mul(to_i64(fl), to_i64(fr), pv, nv))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mont32_pointwise")
    if not lib.mont32_pointwise.argtypes:
        _p = ctypes.c_void_p
        lib.mont32_pointwise.argtypes = [_p, _p, _p, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.POINTER(Mont32Consts), _p]
        lib.mont32_pointwise.restype = ctypes.c_int
    return lib


def mont_mul32(fl: torch.Tensor, fr: torch.Tensor, primes) -> torch.Tensor:
    """uint32 [C, B, n] residues x2 (contiguous, on the card) -> uint32
    [C, B, n]: one launch of the kernel on the current stream."""
    primes = tuple(primes)
    _check(fl, fr, primes)
    if fl.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {fl.device} "
                         "(mont_mul32_plain computes on any device)")
    if not (fl.is_contiguous() and fr.is_contiguous()):
        raise ValueError("the residues must be contiguous")
    consts = mont32_constants(primes)
    out = torch.empty_like(fl)
    if out.numel() == 0:
        return out
    err = call(fl.device, _lib().mont32_pointwise, fl.data_ptr(), fr.data_ptr(), out.data_ptr(),
               len(primes), out[0].numel(), ctypes.byref(consts))
    LAUNCHES["pointwise_mont32"] += 1
    if err != 0:
        raise RuntimeError(f"pointwise_mont32 launch failed: CUDA error {err}")
    return out
