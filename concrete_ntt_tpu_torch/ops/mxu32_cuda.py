"""Four-step prime32 NTT kernels: K1a-K1d (channel grid), K2, K3.

Counterpart of `concrete_ntt_tpu/ops/mxu32_pallas.py`:

  * K1a `fwd_wide_multi`: [B, n] u32 limb tuple (1 or 2 limbs) -> [C, B, n]
    canonical NTT-domain residues, bit-reversed order, all CRT channels.
    Replaces the fwd branch of `_build_multi_call` (kernel body :367-397).
  * K1b `inv_multi`: [C, B, n] u32 (any representative) -> [C, B, n]
    canonical, standard order, times a per-channel scale folded into A_inv.
    Replaces the inv branch of the same builder (kernel body :398-412).
  * K1c `fwd_multi_perchannel` / `fwd_wide_multi_perchannel`: K1a with a
    different operand per channel, [C, B, n] u32 per limb (any values).
    Replaces the builder's `perch_in=True` fwd (:544, :564); the product
    plan's Bounded forward. No `hyb` argument: the stage-split hybrid is
    not ported.
  * K1d `pointwise_inv_multi`: fl, fr [C, B, n] u32 (any representatives)
    -> K1b of their Montgomery product fl*fr*2^-32 (the u32 overflow of the
    REDC sum kept, as `_sc_mont_mul` :505). Replaces the builder's
    `pointwise=True` inv (:637); the product plan's fused polymul.
  * K2 `fwd` / `fwd_wide` / `inv(scale)`: the whole four-step transform of
    one prime, [B, n] -> [B, n]. Replaces `_build_call` (kernel :72-107).
    `passes_engine` (fwd / fwd_wide / inv) names the same functions: the
    TPU splits 2048 <= n < 2^14 into two `_build_pass_call` passes only
    because the whole transform outgrows VMEM there, and K2 serves every
    2^11 <= n <= 2^15 on the card.
  * K3 `pass_matmod`: one exact modular GEMM pass [B, rows, K] -> [B, rows,
    O] (which in A, F, G, Ainv; scaled-lazy epilogue by rank-local diagonal
    slices, or canonical), the per-rank pass of the sharded four-step.
    Replaces `_build_pass_call` (kernel :706-719).

All are CUDA C++ for sm_90a built with nvcc at first use (ops/cuda_build.py)
and called through ctypes: K1 in `csrc/mxu32_multi.cu`, K2/K3 in
`csrc/mxu32_pass.cu`, both launching the one GEMM pass of
`csrc/matmod_pass.cuh`. What bounds them on the H100 at n = 2^14: K1a with
two limbs at B = 8 needs 1.0e9 dp4a (4.0e9 int8 MACs), K2 fwd at B = 16
0.27e9, against a few MiB of memory traffic, so they are bound by
integer-pipe throughput, not by bytes. The simple design does the digit split as
one xor in the operand load, contracts four digits per __dp4a against
host-packed plane words, keeps the operator tables in L2 and puts the
mid-pass transpose in the second pass's load strides; int8 tensor-core
tiles are later work.

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain torch version (`*_plain`, built on
`ops/mxu32.py`), any other device raises. Every kernel launch adds one to
`LAUNCHES[name]`; nothing else does. K2's `fwd_wide` is its `fwd` kernel
with a second limb and counts under "fwd".

Range: K1 takes channel primes 2^29 < p < 2^30 (as `mxu32_pallas.py:254`)
and 2^11 <= n <= 2^15 (the TPU serves K1c/K1d only at n >= 2^14, a VMEM
and lane limit; the results are the same bits at every n);
K2/K3 take every prime32 regime with odd 2^26 <= p < 2^32 (lt30, lt31,
generic with its Montgomery epilogues and, near 2^32, a fifth matrix digit
plane); all take powers of two 2^11 <= n <= 2^15 and 1 or 2 operand limbs.
Outside it both routes raise NotImplementedError. The Mosaic workarounds
`row_fuse` / `_fused_pass_mat` (mxu32_pallas.py:667-683) are not ported:
they only kept TPU lanes at least 128 wide.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build, mxu32
from .u32 import MASK32, mont_mul, mont_neginv, to_i64, to_u32

LAUNCHES = {"fwd_wide_multi": 0, "inv_multi": 0, "fwd_multi_perchannel": 0,
            "pointwise_inv_multi": 0, "fwd": 0, "inv": 0, "pass_matmod": 0}

MIN_N, MAX_N = 1 << 11, 1 << 15
_SCAL_WORDS = 16  # the scalar record of csrc/matmod_pass.cuh


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_n_limbs(n: int, n_limbs: int, what: str) -> None:
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the {what} serve powers of two in [2^11, 2^15]; a prime32 "
            "plan takes the butterfly kernel K4 below, the native plans wait "
            "for their per-channel route there, and larger sizes for the "
            "native128 2^16 work (ROADMAP.md Queue 1 item 5)"
        )
    if n_limbs not in (1, 2):
        raise NotImplementedError(
            f"{n_limbs} operand limbs: u128 operands wait for the native128 "
            "slice (ROADMAP.md Queue 1 item 5)"
        )


def check_range(n: int, primes: tuple, n_limbs: int = 1) -> None:
    """Raise NotImplementedError outside the range K1a/K1b serve."""
    _check_n_limbs(n, n_limbs, "channel-grid kernels")
    if not all((1 << 29) < p < (1 << 30) for p in primes):
        raise NotImplementedError(
            "the channel-grid kernels need 30-bit channel primes "
            "(2^29 < p < 2^30), as the JAX package's; other primes take the "
            "single-prime kernels K2/K3 one at a time (ROADMAP.md Queue 2)"
        )


def check_single_range(n: int, p: int, n_limbs: int = 1) -> None:
    """Raise NotImplementedError outside the range K2/K3 serve."""
    _check_n_limbs(n, n_limbs, "four-step kernels K2/K3")
    if p % 2 == 0 or not mxu32._MIN_P <= p < (1 << 32):
        raise NotImplementedError(
            f"p = {p}: the four-step kernels need an odd 2^26 <= p < 2^32; "
            "smaller primes take the butterfly kernel K4 "
            "(ops/butterfly32_cuda.py, ROADMAP.md Queue 1 item 6)"
        )


def regime(p: int) -> int:
    """Epilogue regime of csrc/matmod_pass.cuh: 0 lt30 (lazy4 Shoup), 1 lt31
    (Shoup), 2 generic (Montgomery), as tbl["lazy4"] / tbl["mont_regime"]."""
    return 0 if p < (1 << 30) else 1 if p < (1 << 31) else 2


def scalar_record(p: int) -> np.ndarray:
    """[16] uint32 per-prime scalars the GEMM pass reads: p, 2^32 mod p, its
    Shoup companion, -p^-1 mod 2^32, 2^64 mod p, 2p mod 2^32, the length of
    the reduction chain, the chain (ops/mxu32.py::_reduce_chain), zeros."""
    c32 = (1 << 32) % p
    chain = mxu32._reduce_chain(p)
    rec = [p, c32, (c32 << 32) // p, mont_neginv(p), (1 << 64) % p, (2 * p) & MASK32,
           len(chain), *chain]
    assert len(rec) <= _SCAL_WORDS, f"reduction chain of {p} too long: {chain}"
    return np.array(rec + [0] * (_SCAL_WORDS - len(rec)), dtype=np.uint32)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def _multi_tables(n: int, primes: tuple, n_limbs: int, scales: tuple):
    """Stacked per-channel tables for the channel-grid kernels (numpy; the
    JAX package's `_multi_tables` without its stage-split hybrid branch)."""
    n1, n2 = mxu32.four_step_factors(n)
    p1f, c1f, p2f, c2f, dgf = [], [], [], [], []
    p1i, c1i, p2i, c2i, dgi = [], [], [], [], []
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
        "scal": to_dev(np.stack([scalar_record(p) for p in primes]).view(np.int32)),
    }


def _pass_mat(n: int, p: int, which: str, n_limbs: int, scale: int):
    """(planes, cvec) of one pass, as `mxu32_pallas._build_pass_call` picks
    them (without its row fusion)."""
    if which == "A" and n_limbs > 1:
        return mxu32._wide_col_planes(n, p, n_limbs)
    if which == "Ainv" and scale != 1:
        return mxu32._scaled_ainv_planes(n, p, scale)
    return mxu32._mxu_tables(n, p)[which]


@lru_cache(maxsize=64)
def _pass_tables(n: int, p: int, which: str, n_limbs: int, scale: int, device: str):
    """One pass's packed planes, cvec and scalar record on `device`."""
    planes, cvec = _pass_mat(n, p, which, n_limbs, scale)
    k = planes.shape[0] // (4 * n_limbs)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "planes": to_dev(pack_planes(planes[None], k)),
        "cvec": to_dev(cvec),
        "scal": to_dev(scalar_record(p).view(np.int32)),
        "k": k,
        "o": cvec.shape[1],
        "n_d": cvec.shape[0],
    }


@lru_cache(maxsize=64)
def _diag_tables(n: int, p: int, name: str, device: str) -> torch.Tensor:
    """The full diagonal d ([n2, n1]) or e ([n1, n2]) as [4 or 2, R, O] uint32."""
    diag = np.ascontiguousarray(np.stack(mxu32._mxu_tables(n, p)[name]))
    return torch.from_numpy(diag).to(device)


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


def _fwd_channels_plain(chan_limbs: list, primes: tuple) -> torch.Tensor:
    """Per channel, the single-channel four-step of ops/mxu32.py on that
    channel's u32-carrier limb tuple [B, n]."""
    outs = []
    for xs, p in zip(chan_limbs, primes):
        n = xs[0].shape[-1]
        tbl = mxu32._mxu_tables(n, p)
        mat1 = mxu32._wide_col_planes(n, p, len(xs)) if len(xs) > 1 else tbl["A"]
        outs.append(mxu32._fwd_core(xs, tbl, mat1, p=p))
    return to_u32(torch.stack(outs))


def fwd_wide_multi_plain(limbs: tuple, primes: tuple) -> torch.Tensor:
    """Plain twin of K1a on the device of `limbs` (one operand, all channels)."""
    check_range(limbs[0].shape[-1], primes, len(limbs))
    xs = tuple(to_i64(a) for a in limbs)
    return _fwd_channels_plain([xs] * len(primes), primes)


def fwd_multi_perchannel_plain(limbs: tuple, primes: tuple) -> torch.Tensor:
    """Plain twin of K1c on the device of `limbs`: [C, B, n] per limb, channel
    c transforms its own operand limbs[...][c]."""
    check_range(limbs[0].shape[-1], primes, len(limbs))
    xs = tuple(to_i64(a) for a in limbs)
    return _fwd_channels_plain([tuple(x[ch] for x in xs) for ch in range(len(primes))], primes)


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


def pointwise_inv_multi_plain(fl: torch.Tensor, fr: torch.Tensor, primes: tuple,
                              scales: tuple) -> torch.Tensor:
    """Plain twin of K1d: per channel the Montgomery product of ops/u32.py
    (any u32 operands; the u32 overflow of the REDC sum is kept), then K1b's
    plain twin."""
    check_range(fl.shape[-1], primes)
    a, b = to_i64(fl), to_i64(fr)
    prod = torch.stack([mont_mul(a[ch], b[ch], p, mont_neginv(p)) for ch, p in enumerate(primes)])
    return inv_multi_plain(to_u32(prod), primes, scales)


def fwd_plain(x: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Plain twin of K2 fwd: ops/mxu32.py's four-step on the device of x."""
    return fwd_wide_plain((x,), n=n, p=p)


def fwd_wide_plain(limbs: tuple, *, n: int, p: int) -> torch.Tensor:
    """Plain twin of K2 fwd_wide (1 or 2 limbs)."""
    check_single_range(n, p, len(limbs))
    if len(limbs) == 1:
        return mxu32.fwd(limbs[0], n=n, p=p)
    return mxu32.fwd_wide(tuple(limbs), n=n, p=p)


def inv_plain(x: torch.Tensor, *, n: int, p: int, scale: int = 1) -> torch.Tensor:
    """Plain twin of K2 inv (scale folded into A_inv)."""
    check_single_range(n, p)
    return mxu32.inv(x, n=n, p=p, scale=scale)


def pass_matmod_plain(x, *, n: int, p: int, which: str, diag_slices=(),
                      n_limbs: int = 1, scale: int = 1) -> torch.Tensor:
    """Plain twin of K3: one exact pass ops/mxu32.py-style, contracting the
    last axis of x [B, rows, K] (a limb tuple for the wide A pass)."""
    xs = x if isinstance(x, tuple) else (x,)
    check_single_range(n, p, len(xs))
    tbl = mxu32._mxu_tables(n, p)
    mat = _pass_mat(n, p, which, len(xs), scale % p)
    xi = tuple(to_i64(a) for a in xs)
    lo, hi = mxu32._combine(mxu32._dot_planes(xi if len(xi) > 1 else xi[0], mat), mat)
    if diag_slices:
        out = mxu32._epilogue_scaled_lazy(lo, hi, tuple(diag_slices), tbl, p=p)
    else:
        out = mxu32._epilogue_canonical(lo, hi, tbl, p=p)
    return to_u32(out)


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
        lib.k1c_fwd_multi_perchannel.argtypes = [_P, _P, _I, _I, _I, _I, _I, *[_P] * 9]
        lib.k1c_fwd_multi_perchannel.restype = ctypes.c_int
        lib.k1d_pointwise_inv_multi.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 9]
        lib.k1d_pointwise_inv_multi.restype = ctypes.c_int
    return lib


def _pass_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu32_pass")
    if not lib.k2_fwd.argtypes:
        lib.k2_fwd.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 6, _I, _I, _P, _P, _P]
        lib.k2_fwd.restype = ctypes.c_int
        lib.k2_inv.argtypes = [_P, _I, _I, _I, *[_P] * 6, _I, _I, _P, _P, _P]
        lib.k2_inv.restype = ctypes.c_int
        lib.k3_pass.argtypes = [_P, _P, _I, _I, _I, _I, _I, *[_P] * 4, _I, _I, _I, _P, _P]
        lib.k3_pass.restype = ctypes.c_int
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


def _check_n(x: torch.Tensor, n: int) -> None:
    if x.shape[-1] != n:
        raise ValueError(f"last axis must be n={n}, got {tuple(x.shape)}")


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


def _call(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) with `dev` current, on its current stream."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _check_channels(x: torch.Tensor, primes: tuple) -> None:
    if x.shape[0] != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {tuple(x.shape)}")


def fwd_multi_perchannel(x: torch.Tensor, primes: tuple) -> torch.Tensor:
    """K1c: all channels' forward NTTs of per-channel operands. x [C, B, n]
    uint32 (any values) -> [C, B, n] canonical, bit-reversed order."""
    return _fwd_perchannel((x,), tuple(primes))


def fwd_wide_multi_perchannel(x_lo: torch.Tensor, x_hi: torch.Tensor,
                              primes: tuple) -> torch.Tensor:
    """K1c with two limbs: (lo, hi) [C, B, n] u64 values per channel ->
    [C, B, n] canonical NTT-domain residues (value mod p folded into the
    column matmul, as K1a's)."""
    return _fwd_perchannel((x_lo, x_hi), tuple(primes))


def _fwd_perchannel(limbs: tuple, primes: tuple) -> torch.Tensor:
    dev = _check_operands(limbs, 3)
    _check_channels(limbs[0], primes)
    if dev.type == "cpu":
        return fwd_multi_perchannel_plain(limbs, primes)
    c, b, n = limbs[0].shape
    check_range(n, primes, len(limbs))
    tabs = _kernel_tables(n, primes, len(limbs), (1,) * c, "fwd", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty((c, b, n), dtype=torch.uint32, device=dev)
    scratch = torch.empty_like(out)
    x1 = limbs[1] if len(limbs) > 1 else limbs[0]
    ptrs = _ptrs(limbs[0], x1, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                 tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    err = _call(dev, _lib().k1c_fwd_multi_perchannel, ptrs[0], ptrs[1], len(limbs), b, n1, n2,
                c, *ptrs[2:])
    LAUNCHES["fwd_multi_perchannel"] += 1
    if err != 0:
        raise RuntimeError(f"K1c fwd_multi_perchannel launch failed: CUDA error {err}")
    return out


def pointwise_inv_multi(fl: torch.Tensor, fr: torch.Tensor, primes: tuple,
                        scales: tuple) -> torch.Tensor:
    """K1d: all channels' Montgomery product fl*fr*2^-32 mod p (fl, fr
    [C, B, n] uint32, any representatives) and scaled inverse NTT in one
    kernel -> [C, B, n] canonical, standard order. With scale n^-1 * 2^32
    mod p the result is the normalized inverse of the product."""
    dev = _check_operands((fl, fr), 3)
    primes, scales = tuple(primes), tuple(scales)
    _check_channels(fl, primes)
    if len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} scales, got {len(scales)}")
    if dev.type == "cpu":
        return pointwise_inv_multi_plain(fl, fr, primes, scales)
    c, b, n = fl.shape
    check_range(n, primes)
    tabs = _kernel_tables(n, primes, 1, scales, "inv", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty_like(fl)
    scratch = torch.empty_like(fl)
    ptrs = _ptrs(fl, fr, tabs["planes1"], tabs["cvec1"], tabs["planes2"], tabs["cvec2"],
                 tabs["diag"], tabs["scal"], scratch, out)
    err = _call(dev, _lib().k1d_pointwise_inv_multi, ptrs[0], ptrs[1], b, n1, n2, c, *ptrs[2:])
    LAUNCHES["pointwise_inv_multi"] += 1
    if err != 0:
        raise RuntimeError(f"K1d pointwise_inv_multi launch failed: CUDA error {err}")
    return out


@lru_cache(maxsize=64)
def _single_tables(n: int, p: int, n_limbs: int, scale: int, direction: str, device: str):
    """K2's tables for one direction: both passes and the diagonal."""
    first, second = (("A", "F") if direction == "fwd" else ("G", "Ainv"))
    t1 = _pass_tables(n, p, first, n_limbs, 1, device)
    t2 = _pass_tables(n, p, second, 1, scale if direction == "inv" else 1, device)
    diag = _diag_tables(n, p, "d" if direction == "fwd" else "e", device)
    return t1, t2, diag


def fwd_wide(limbs: tuple, *, n: int, p: int) -> torch.Tensor:
    """K2 fwd: one prime's forward NTT of a [B, n] uint32 limb tuple (1 or 2
    limbs, any values) -> [B, n] canonical, bit-reversed order."""
    limbs = tuple(limbs)
    dev = _check_operands(limbs, 2)
    _check_n(limbs[0], n)
    if dev.type == "cpu":
        return fwd_wide_plain(limbs, n=n, p=p)
    check_single_range(n, p, len(limbs))
    b = limbs[0].shape[0]
    t1, t2, diag = _single_tables(n, p, len(limbs), 1, "fwd", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty((b, n), dtype=torch.uint32, device=dev)
    if b == 0:
        return out
    scratch = torch.empty_like(out)
    x1 = limbs[1] if len(limbs) > 1 else limbs[0]
    ptrs = _ptrs(limbs[0], x1, t1["planes"], t1["cvec"], t2["planes"], t2["cvec"], diag,
                 t1["scal"], scratch, out)
    err = _call(dev, _pass_lib().k2_fwd, ptrs[0], ptrs[1], len(limbs), b, n1, n2, *ptrs[2:8],
                t1["n_d"], regime(p), ptrs[8], ptrs[9])
    LAUNCHES["fwd"] += 1
    if err != 0:
        raise RuntimeError(f"K2 fwd launch failed: CUDA error {err}")
    return out


def fwd(x: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """K2 fwd of one u32 limb: [B, n] -> [B, n] canonical, bit-reversed."""
    return fwd_wide((x,), n=n, p=p)


def inv(x: torch.Tensor, *, n: int, p: int, scale: int = 1) -> torch.Tensor:
    """K2 inv: one prime's inverse NTT, [B, n] uint32 (any representative,
    bit-reversed) -> [B, n] canonical, standard order, times `scale`
    (folded into A_inv; scale = 1 is the unnormalized inverse)."""
    dev = _check_operands((x,), 2)
    _check_n(x, n)
    if dev.type == "cpu":
        return inv_plain(x, n=n, p=p, scale=scale)
    check_single_range(n, p)
    b = x.shape[0]
    t1, t2, diag = _single_tables(n, p, 1, scale % p, "inv", str(dev))
    n1, n2 = mxu32.four_step_factors(n)
    out = torch.empty_like(x)
    if b == 0:
        return out
    scratch = torch.empty_like(x)
    ptrs = _ptrs(x, t1["planes"], t1["cvec"], t2["planes"], t2["cvec"], diag, t1["scal"],
                 scratch, out)
    err = _call(dev, _pass_lib().k2_inv, ptrs[0], b, n1, n2, *ptrs[1:7], t1["n_d"], regime(p),
                ptrs[7], ptrs[8])
    LAUNCHES["inv"] += 1
    if err != 0:
        raise RuntimeError(f"K2 inv launch failed: CUDA error {err}")
    return out


def pass_matmod(x, *, n: int, p: int, which: str, diag_slices=(), n_limbs: int = 1,
                scale: int = 1) -> torch.Tensor:
    """K3: one exact modular GEMM pass. x [B, rows, K] uint32 (any
    representative; a little-endian limb tuple for the wide A pass),
    contracting the last axis -> [B, rows, O] uint32. which in {A, F, G,
    Ainv}; `diag_slices` are the rank-local rows [rows, O] of the four (two
    in the generic regime) diagonal tables for the scaled-lazy epilogue
    (uint32 tensors or numpy arrays); without them the epilogue is
    canonical. A scale multiplies the Ainv pass's matrix."""
    xs = tuple(x) if isinstance(x, tuple) else (x,)
    if which not in ("A", "F", "G", "Ainv"):
        raise ValueError(f"which must be A, F, G or Ainv, got {which!r}")
    if n_limbs != len(xs):
        raise ValueError(f"n_limbs={n_limbs} but {len(xs)} operand limbs given")
    dev = _check_operands(xs, 3)
    diag_slices = tuple(
        torch.from_numpy(np.ascontiguousarray(d)) if isinstance(d, np.ndarray) else d
        for d in diag_slices
    )
    if dev.type == "cpu":
        return pass_matmod_plain(xs if len(xs) > 1 else xs[0], n=n, p=p, which=which,
                                 diag_slices=diag_slices, n_limbs=n_limbs, scale=scale)
    check_single_range(n, p, len(xs))
    b, rows, k = xs[0].shape
    tabs = _pass_tables(n, p, which, len(xs), scale % p if which == "Ainv" else 1, str(dev))
    if k != tabs["k"]:
        raise ValueError(f"pass {which} at n={n} contracts {tabs['k']} values, got {k}")
    diag = None
    if diag_slices:
        n_dg = 2 if regime(p) == 2 else 4
        if len(diag_slices) != n_dg or any(
            d.shape != (rows, tabs["o"]) or d.dtype != torch.uint32 for d in diag_slices
        ):
            raise ValueError(f"expected {n_dg} uint32 diagonal slices of shape "
                             f"{(rows, tabs['o'])}")
        diag = torch.stack([d.to(dev) for d in diag_slices]).contiguous()
    out = torch.empty((b, rows, tabs["o"]), dtype=torch.uint32, device=dev)
    if b == 0 or rows == 0:
        return out  # nothing to compute; an empty grid is not a valid launch
    x1 = xs[1] if len(xs) > 1 else xs[0]
    dg = diag if diag is not None else tabs["scal"]  # not read by a canonical pass
    ptrs = _ptrs(xs[0], x1, tabs["planes"], tabs["cvec"], dg, tabs["scal"], out)
    err = _call(dev, _pass_lib().k3_pass, ptrs[0], ptrs[1], len(xs), b, rows, k, tabs["o"],
                *ptrs[2:6], tabs["n_d"], regime(p), int(diag is not None), ptrs[6])
    LAUNCHES["pass_matmod"] += 1
    if err != 0:
        raise RuntimeError(f"K3 pass_matmod launch failed: CUDA error {err}")
    return out


class _PassesEngine:
    """The JAX package's mid-size engine: on the card K2 serves these sizes
    whole, so its entries are K2's (and their plain twins on the CPU)."""

    fwd = staticmethod(fwd)
    fwd_wide = staticmethod(fwd_wide)
    inv = staticmethod(inv)


passes_engine = _PassesEngine()
