"""Channel-grid four-step NTTs over all CRT channels: kernels K1a and K1b.

Counterpart of the channel-grid half of `concrete_ntt_tpu/ops/mxu32_pallas.py`.

  * K1a `fwd_wide_multi`: [B, n] u32 limb tuple (1 or 2 limbs) -> [C, B, n]
    canonical NTT-domain residues, bit-reversed order. Replaces the fwd
    branch of `mxu32_pallas.py::_build_multi_call` (kernel body :367-397).
  * K1b `inv_multi`: [C, B, n] u32 (any representative) -> [C, B, n]
    canonical, standard order, times a per-channel scale folded into A_inv.
    Replaces the inv branch of the same builder (kernel body :398-412).

Both kernels are CUDA C++ for sm_90a in `csrc/mxu32_multi.cu`, built with
nvcc at first use (ops/cuda_build.py) and called through ctypes. What bounds
them on the H100 at n = 2^14, B = 8: K1a with two limbs needs 1.0e9 dp4a
(4.0e9 int8 MACs), K1b 0.67e9, against about 12 MiB of memory traffic, so
both are bound by integer-pipe issue, not by bytes. The simple design does
the digit split as one xor in the operand load, contracts four digits per
__dp4a against host-packed plane words, keeps the operator tables in L2 and
puts the mid-pass transpose in the second pass's load strides; int8
tensor-core tiles are later work.

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain torch version (`*_plain`, built on
`ops/mxu32.py`), any other device raises. Every kernel launch adds one to
`LAUNCHES[name]`; nothing else does.

Range: channel primes 2^29 < p < 2^30 (as `mxu32_pallas.py:254`) and
2^11 <= n <= 2^15; 1 or 2 operand limbs. Outside it both routes raise
NotImplementedError.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build, mxu32
from .u32 import to_i64, to_u32

LAUNCHES = {"fwd_wide_multi": 0, "inv_multi": 0}

_MIN_N, _MAX_N = 1 << 11, 1 << 15


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_range(n: int, primes: tuple, n_limbs: int = 1) -> None:
    """Raise NotImplementedError outside the range K1a/K1b serve."""
    if n & (n - 1) or not _MIN_N <= n <= _MAX_N:
        raise NotImplementedError(
            f"n = {n}: the channel-grid kernels serve powers of two in "
            "[2^11, 2^15]; other sizes wait for the prime32 stage engine "
            "and the pass kernels (ROADMAP.md Queue 1 item 6)"
        )
    if not all((1 << 29) < p < (1 << 30) for p in primes):
        raise NotImplementedError(
            "the channel-grid kernels need 30-bit channel primes "
            "(2^29 < p < 2^30); wider primes wait for ROADMAP.md Queue 1 item 6"
        )
    if n_limbs not in (1, 2):
        raise NotImplementedError(
            f"{n_limbs} operand limbs: u128 operands wait for the native128 "
            "slice (ROADMAP.md Queue 1 item 5)"
        )


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def _multi_tables(n: int, primes: tuple, n_limbs: int, scales: tuple):
    """Stacked per-channel tables for the channel-grid kernels (numpy; the
    JAX package's `_multi_tables` without its stage-split hybrid branch)."""
    n1, n2 = mxu32.four_step_factors(n)
    p1f, c1f, p2f, c2f, dgf = [], [], [], [], []
    p1i, c1i, p2i, c2i, dgi = [], [], [], [], []
    scal = []
    for ch, p in enumerate(primes):
        assert (1 << 29) < p < (1 << 30), "channel-grid kernels need 30-bit primes"
        tbl = mxu32._mxu_tables(n, p)
        mat1 = mxu32._wide_col_planes(n, p, n_limbs) if n_limbs > 1 else tbl["A"]
        assert tbl["chain"] == (4 * p, 2 * p, p), "unexpected reduction chain"
        p1f.append(mat1[0])
        c1f.append(mat1[1])
        p2f.append(tbl["F"][0])
        c2f.append(tbl["F"][1])
        dgf.append(tbl["d"])
        p1i.append(tbl["G"][0])
        c1i.append(tbl["G"][1])
        if scales[ch] == 1:
            mat2 = tbl["Ainv"]
        else:
            mat2 = mxu32._scaled_ainv_planes(n, p, scales[ch] % p)
        p2i.append(mat2[0])
        c2i.append(mat2[1])
        dgi.append(tbl["e"])
        # slot 3 stays zero, as in the JAX package's scalar layout
        scal.append([p, int(tbl["c32"]), int(tbl["c32_shoup"]), 0, 2 * p])
    stack = lambda xs: np.ascontiguousarray(np.stack(xs, axis=0))
    n_dg = len(dgf[0])  # 4 scale-table arrays per channel
    return {
        "n1": n1,
        "n2": n2,
        "fwd": (
            stack(p1f),
            stack(c1f),
            stack(p2f),
            stack(c2f),
            tuple(stack([d[j] for d in dgf]) for j in range(n_dg)),
        ),
        "inv": (
            stack(p1i),
            stack(c1i),
            stack(p2i),
            stack(c2i),
            tuple(stack([d[j] for d in dgi]) for j in range(n_dg)),
        ),
        "scalars": np.array(scal, dtype=np.uint32),  # [C, 5]
    }


def pack_planes(planes: np.ndarray, k: int) -> np.ndarray:
    """[C, 4L*k, D*O] int8 planes -> [C, L*k, D*O] int32 words.

    Byte e of word (l*k + i, col) is plane row (4l + e)*k + i: the four plane
    rows that meet the four digits of operand value i of limb l, so one
    __dp4a against the operand word (v ^ 0x80808080) sums those four
    products. Same values as the JAX package's planes, in another order."""
    c, ek, do = planes.shape
    n_limbs = ek // (4 * k)
    assert n_limbs * 4 * k == ek, "plane rows must be 4 digits x limbs x k"
    w = planes.reshape(c, n_limbs, 4, k, do).transpose(0, 1, 3, 4, 2)
    return np.ascontiguousarray(w).view(np.int32).reshape(c, n_limbs * k, do)


@lru_cache(maxsize=32)
def _kernel_tables(n: int, primes: tuple, n_limbs: int, scales: tuple,
                   direction: str, device: str):
    """The kernel's tables for one direction, as tensors on `device`."""
    tabs = _multi_tables(n, primes, n_limbs, scales)
    n1, n2 = tabs["n1"], tabs["n2"]
    planes1, cvec1, planes2, cvec2, diag = tabs[direction]
    k1 = n1 if direction == "fwd" else n2  # contraction per limb, first pass
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "planes1": to_dev(pack_planes(planes1, k1)),
        "cvec1": to_dev(cvec1),
        "planes2": to_dev(pack_planes(planes2, n2 if direction == "fwd" else n1)),
        "cvec2": to_dev(cvec2),
        "diag": to_dev(np.stack(diag, axis=1).view(np.int32)),  # [C, 4, R, O]
        "scal": to_dev(tabs["scalars"].view(np.int32)),
    }


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


def fwd_wide_multi_plain(limbs: tuple, primes: tuple) -> torch.Tensor:
    """Plain twin of K1a on the device of `limbs`: per channel, the
    single-channel four-step of ops/mxu32.py."""
    n = limbs[0].shape[-1]
    check_range(n, primes, len(limbs))
    xs = tuple(to_i64(a) for a in limbs)
    outs = []
    for p in primes:
        tbl = mxu32._mxu_tables(n, p)
        mat1 = mxu32._wide_col_planes(n, p, len(xs)) if len(xs) > 1 else tbl["A"]
        outs.append(mxu32._fwd_core(xs, tbl, mat1, p=p))
    return to_u32(torch.stack(outs))


def inv_multi_plain(x: torch.Tensor, primes: tuple, scales: tuple) -> torch.Tensor:
    """Plain twin of K1b on the device of `x`."""
    n = x.shape[-1]
    check_range(n, primes)
    xi = to_i64(x)
    outs = []
    for ch, p in enumerate(primes):
        tbl = mxu32._mxu_tables(n, p)
        if scales[ch] == 1:
            mat2 = tbl["Ainv"]
        else:
            mat2 = mxu32._scaled_ainv_planes(n, p, scales[ch] % p)
        outs.append(mxu32._inv_core(xi[ch], tbl, mat2, p=p))
    return to_u32(torch.stack(outs))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu32_multi")
    if not lib.k1a_fwd_wide_multi.argtypes:
        lib.k1a_fwd_wide_multi.argtypes = [_P, _P, _I, _I, _I, _I, _I, *[_P] * 9]
        lib.k1a_fwd_wide_multi.restype = ctypes.c_int
        lib.k1b_inv_multi.argtypes = [_P, _I, _I, _I, _I, *[_P] * 9]
        lib.k1b_inv_multi.restype = ctypes.c_int
    return lib


def _check_operands(xs: tuple, ndim: int) -> torch.device:
    if not all(isinstance(a, torch.Tensor) and a.dtype == torch.uint32 for a in xs):
        raise TypeError("operands must be uint32 tensors")
    dev = xs[0].device
    if any(a.dim() != ndim or a.shape != xs[0].shape or a.device != dev for a in xs):
        raise ValueError(
            f"operands must be {ndim}-d tensors of one shape on one device, "
            f"got {[tuple(t.shape) for t in xs]}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {dev}: use cuda or cpu")
    return dev


def _ptrs(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return [t.data_ptr() for t in tensors]


def fwd_wide_multi(limbs: tuple, primes: tuple) -> torch.Tensor:
    """K1a: all CRT channels' forward NTTs. [B, n] uint32 limb tuple ->
    [C, B, n] uint32 canonical NTT-domain residues (bit-reversed order)."""
    limbs = tuple(limbs)
    dev = _check_operands(limbs, 2)
    primes = tuple(primes)
    if dev.type == "cpu":
        return fwd_wide_multi_plain(limbs, primes)
    b, n = limbs[0].shape
    check_range(n, primes, len(limbs))
    tabs = _kernel_tables(n, primes, len(limbs), (1,) * len(primes), "fwd", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty((len(primes), b, n), dtype=torch.uint32, device=dev)
    scratch = torch.empty_like(out)
    x0 = limbs[0]
    x1 = limbs[1] if len(limbs) > 1 else limbs[0]
    ptrs = _ptrs(x0, x1, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                 tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.k1a_fwd_wide_multi(ptrs[0], ptrs[1], len(limbs), b, n1, n2, len(primes),
                                     *ptrs[2:], stream)
    LAUNCHES["fwd_wide_multi"] += 1
    if err != 0:
        raise RuntimeError(f"K1a fwd_wide_multi launch failed: CUDA error {err}")
    return out


def inv_multi(x: torch.Tensor, primes: tuple, scales: tuple) -> torch.Tensor:
    """K1b: all channels' scaled inverse NTTs. [C, B, n] uint32 (any
    representatives) -> [C, B, n] uint32 canonical, standard order."""
    dev = _check_operands((x,), 3)
    primes, scales = tuple(primes), tuple(scales)
    if x.shape[0] != len(primes) or len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {x.shape[0]}")
    if dev.type == "cpu":
        return inv_multi_plain(x, primes, scales)
    _, b, n = x.shape
    check_range(n, primes)
    tabs = _kernel_tables(n, primes, 1, scales, "inv", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    ptrs = _ptrs(x, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                 tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.k1b_inv_multi(ptrs[0], b, n1, n2, len(primes), *ptrs[1:], stream)
    LAUNCHES["inv_multi"] += 1
    if err != 0:
        raise RuntimeError(f"K1b inv_multi launch failed: CUDA error {err}")
    return out
