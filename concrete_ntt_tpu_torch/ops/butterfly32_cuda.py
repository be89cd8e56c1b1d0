"""Radix-2 butterfly prime32 NTT: kernel K4.

Counterpart of `concrete_ntt_tpu/ops/pallas32.py` (`try_fwd` :162,
`try_inv` :167; builder `_build_call` :115, kernel `_make_kernel` :78-111):
every log2 n stage of the forward or inverse negacyclic NTT of each
polynomial, with the lt30 / lt31 / generic butterflies of
ops/butterflies32.py. [B, n] uint32 -> [B, n] canonical.

The kernel is CUDA C++ for sm_90a in `csrc/butterfly32.cu`, built with nvcc
at first use (ops/cuda_build.py) and called through ctypes. A cluster of
c = `cluster_size(n, B)` blocks (1, 2, 4 or 8) holds a polynomial in shared
memory, n / c values a block (with c = 1 below n = 1024, 1024 / n whole
polynomials a block): the first log2 c forward stages run on columns read
from device memory and exchanged through distributed shared memory, the
others on the block's contiguous slice, `radix_log` (2 or 3) stages a round
in registers between barriers (the inverse is the mirror). Twiddles are the compact
bit-reversed tables of `prime32._tables` (twid[m + i] plus Shoup
companions, or Montgomery form for p >= 2^31); the TPU kernel's
stage-expanded [log2 n, n] tables, roll/select data movement, n >= 256
floor and 8-row padding are Mosaic workarounds and are not ported. What
bounds it at n = 2^14, B = 16: the integer butterflies (about 12
operations each) and the blocks' shared-memory rounds and barriers; c = 8
puts 128 blocks on the card's 132 SMs where one block a polynomial put 16.

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises (2 <= n <= 2^17, `MAX_N`, the port's four-step range), a CPU
tensor runs the plain twin, the stage engine of ops/engine.py, at any n.
Every launch adds one to `LAUNCHES["fwd"]` or `LAUNCHES["inv"]` (read into
each top-level span's `launches` by `utils/profiling`). Where the
JAX functions return None for "not applicable", these raise
NotImplementedError; `ntt_dispatch.tier32` sends a larger n to the stage
engine (`fwd_plain` / `inv_plain`) on the operand's device. The reference
kernel stops at 2^15 (VMEM); above it the reference runs its XLA stage
engine, the same function.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import profiling
from . import butterflies32, cuda_build, engine
from .mxu32 import _dev
from .mxu32_cuda import _call
from .u32 import to_i64, to_u32

LAUNCHES = {"fwd": 0, "inv": 0}
profiling.register_launches(LAUNCHES)

MAX_N = 1 << 17  # the port's four-step range (mxu32_cuda.MAX_N): 16 KiB a block of 8
_REGIME = {"lt30": 0, "lt31": 1, "generic": 2}
_MIN_SLICE, _MAX_BLOCK, _MAX_CLUSTER = 1 << 8, 1 << 15, 8
_WHOLE = 1 << 10  # values of a block of whole polynomials below n = 1024
H100_SMS = 132


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_range(n: int, variant: str) -> None:
    """Raise NotImplementedError outside the range K4 serves on the card."""
    if n & (n - 1) or not 2 <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the butterfly kernel K4 serves powers of two in [2, 2^17] (a "
            "polynomial stays in the shared memory of a cluster of at most 8 blocks); above "
            "that a prime32 plan takes the stage engine (ntt_dispatch.tier32)"
        )
    if variant not in _REGIME:
        raise ValueError(f"unknown prime32 regime {variant!r}")


def cluster_size(n: int, b: int, sms: int = H100_SMS) -> int:
    """Blocks (a cluster) K4 gives each of b polynomials of size n: the
    smallest of 1, 2, 4, 8 with b * c >= sms, within what the block size
    allows (n / c between 2^8 and 2^15 values; 1 below n = 2^9)."""
    c = max(1, n // _MAX_BLOCK)
    top = min(_MAX_CLUSTER, max(1, n // _MIN_SLICE))
    while c < top and b * c < sms:
        c *= 2
    return c


def radix_log(e: int) -> int:
    """Stages a round of K4 runs in registers for a block of e values: two
    (radix 4) up to 1024 values, three (radix 8) above. A sweep on one H100
    set both rules (rounds of 2, 3 and 4 stages against every cluster size
    at B = 16; PERF.md §6): four stages a round lost everywhere (the
    threads it leaves idle cost more than the barriers it saves), so the
    kernel takes rounds of at most three."""
    return 2 if e <= 1 << 10 else 3


@lru_cache(maxsize=8)
def _sms(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
        lib.k4_ntt.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _P]
        lib.k4_ntt.restype = ctypes.c_int
        lib.k4_max_active_clusters.argtypes = [_I, _I, _I]
        lib.k4_max_active_clusters.restype = ctypes.c_int
    return lib


# (id(tbl), variant, direction, device) -> (tbl, device tables, (twid ptr, companion ptr))
_TWIDDLES: dict = {}


def _twiddle_ptrs(tbl: dict, variant: str, direction: str, device) -> tuple:
    """The kernel's twiddle pointers (twid, companions; the companions alias
    twid in the generic regime, where they are not read) for one plan's
    tables, direction and device: the tables go to the device and their
    pointers are taken once. The tables dict and the device tensors the
    pointers point into are kept alive beside them, so the id cannot be
    reused and the memory cannot be freed while the entry exists."""
    key = (id(tbl), variant, direction, str(device))
    hit = _TWIDDLES.get(key)
    if hit is None or hit[0] is not tbl:
        tw = tuple(_dev(a, device, keep_dtype=True) for a in _twiddles(tbl, variant, direction))
        hit = (tbl, tw, (tw[0].data_ptr(), tw[-1].data_ptr()))
        _TWIDDLES[key] = hit
    return hit[2]


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
    dev = x.device
    tw, tws = _twiddle_ptrs(tbl, variant, direction, dev)
    c = cluster_size(n, b, _sms(str(dev)))
    rlog = radix_log(n // c if c > 1 else max(n, _WHOLE))
    err = _call(dev, _lib().k4_ntt, x.data_ptr(), out.data_ptr(), tw, tws, b, n.bit_length() - 1,
                c.bit_length() - 1, rlog, _REGIME[variant], int(direction == "fwd"), p,
                p_neginv)
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
