"""Radix-2 butterfly prime32 NTT: kernel K4.

Counterpart of `concrete_ntt_tpu/ops/pallas32.py` (`try_fwd` :162,
`try_inv` :167; builder `_build_call` :115, kernel `_make_kernel` :78-111):
every log2 n stage of the forward or inverse negacyclic NTT of each
polynomial, with the lt30 / lt31 / generic butterflies of
ops/butterflies32.py. [B, n] uint32 -> [B, n] canonical.

The kernel is CUDA C++ for sm_90a in `csrc/butterfly32.cu`, built with nvcc
at first use (ops/cuda_build.py) and called through ctypes. One block keeps
whole polynomials in shared memory across all stages and reads the compact
bit-reversed twiddle tables of `prime32._tables` (twid[m + i] plus Shoup
companions, or Montgomery form for p >= 2^31); the TPU kernel's
stage-expanded [log2 n, n] tables, roll/select data movement, n >= 256
floor and 8-row padding are Mosaic workarounds and are not ported. What
bounds it at n = 2^14, B = 16: shared-memory and integer throughput inside one
block per polynomial (16 of 132 SMs busy), not device memory.

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises (2 <= n <= 2^15), a CPU tensor runs the plain twin, the stage
engine of ops/engine.py, at any n. Every launch adds one to
`LAUNCHES["fwd"]` or `LAUNCHES["inv"]`. Where the JAX functions return None
for "not applicable", these raise NotImplementedError naming the ROADMAP
item.
"""

from __future__ import annotations

import ctypes

import torch

from . import butterflies32, cuda_build, engine
from .mxu32 import _dev
from .u32 import to_i64, to_u32

LAUNCHES = {"fwd": 0, "inv": 0}

MAX_N = 1 << 15  # a polynomial stays in one block's shared memory (128 KiB)
_REGIME = {"lt30": 0, "lt31": 1, "generic": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_range(n: int, variant: str) -> None:
    """Raise NotImplementedError outside the range K4 serves on the card."""
    if n & (n - 1) or not 2 <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the butterfly kernel K4 serves powers of two in [2, 2^15] (a "
            "polynomial stays in one block's shared memory); above that the card runs "
            "only the four-step kernels K1 / K2, which need an odd prime >= 2^26 "
            "(ROADMAP.md Queue 3)"
        )
    if variant not in _REGIME:
        raise ValueError(f"unknown prime32 regime {variant!r}")


def _twiddles(tbl: dict, variant: str, direction: str) -> tuple:
    """The compact tables of one direction: (twid, twid_shoup) or (twid,)."""
    name = "twid" if direction == "fwd" else "inv_twid"
    if variant == "generic":
        return (tbl[name],)
    return tbl[name], tbl[name + "_shoup"]


# ---------------------------------------------------------------------------
# Plain torch version (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


def _plain(x, tbl, *, p, variant, p_neginv, direction):
    bf, last = butterflies32.make(p, variant, p_neginv, direction)
    tw = tuple(_dev(a, x.device) for a in _twiddles(tbl, variant, direction))
    stages = engine.fwd_stages if direction == "fwd" else engine.inv_stages
    return to_u32(stages((to_i64(x),), tw, bf, last)[0])


def fwd_plain(x: torch.Tensor, tbl: dict, *, p: int, variant: str, p_neginv: int):
    """Plain twin of K4 fwd: the stage engine on the device of x."""
    return _plain(x, tbl, p=p, variant=variant, p_neginv=p_neginv, direction="fwd")


def inv_plain(x: torch.Tensor, tbl: dict, *, p: int, variant: str, p_neginv: int):
    """Plain twin of K4 inv."""
    return _plain(x, tbl, p=p, variant=variant, p_neginv=p_neginv, direction="inv")


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("butterfly32")
    if not lib.k4_ntt.argtypes:
        lib.k4_ntt.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _P]
        lib.k4_ntt.restype = ctypes.c_int
    return lib


def _run(x, tbl, *, p, variant, p_neginv, direction):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint32:
        raise TypeError("operand must be a uint32 tensor")
    if x.dim() != 2:
        raise ValueError(f"operand must be [B, n], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _plain(x, tbl, p=p, variant=variant, p_neginv=p_neginv, direction=direction)
    if x.device.type != "cuda":
        raise ValueError(f"no route for tensors on {x.device}: use cuda or cpu")
    if not x.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    b, n = x.shape
    check_range(n, variant)
    out = torch.empty_like(x)
    if b == 0:
        return out
    tw = [_dev(a, x.device, keep_dtype=True) for a in _twiddles(tbl, variant, direction)]
    tws = tw[-1]  # not read in the generic regime
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().k4_ntt(x.data_ptr(), out.data_ptr(), tw[0].data_ptr(), tws.data_ptr(),
                            b, n.bit_length() - 1, _REGIME[variant], int(direction == "fwd"),
                            p, p_neginv, stream)
    LAUNCHES[direction] += 1
    if err != 0:
        raise RuntimeError(f"K4 {direction} launch failed: CUDA error {err}")
    return out


def try_fwd(x: torch.Tensor, tbl: dict, *, p: int, variant: str, p_neginv: int):
    """K4 fwd: [B, n] uint32 standard order -> bit-reversed NTT values in
    [0, p). `tbl` is the plan's `prime32._tables(n, p)`."""
    return _run(x, tbl, p=p, variant=variant, p_neginv=p_neginv, direction="fwd")


def try_inv(x: torch.Tensor, tbl: dict, *, p: int, variant: str, p_neginv: int):
    """K4 inv: [B, n] uint32 bit-reversed -> standard order in [0, p),
    unnormalized."""
    return _run(x, tbl, p=p, variant=variant, p_neginv=p_neginv, direction="inv")
