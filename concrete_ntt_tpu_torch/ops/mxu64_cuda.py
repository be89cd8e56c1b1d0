"""Four-step prime64 NTT kernels: K5, K6, K7a, K7d.

Counterpart of `concrete_ntt_tpu/ops/mxu64_pallas.py`. Values are u64 limb
pairs: a tuple `(lo, hi)` of uint32 tensors of one shape.

  * K5 `fwd` / `inv(scale)`: the whole four-step transform of one 64-bit
    prime, (lo, hi) [B, n] -> (lo, hi) [B, n]. fwd takes any u64 values and
    returns canonical NTT values in bit-reversed order; inv takes any u64
    representatives and returns canonical values in standard order, times a
    scale folded into A_inv. Replaces `_build_call` (:32; `fwd` :153, `inv`
    :157). It also serves the sizes 2^11 <= n < 2^14 that the TPU sends
    through two `pass_matmod64` passes (its whole-transform kernel needs both
    factors >= 128 and its VMEM; a CUDA launch has neither limit).
  * K6 `pass_matmod64`: one exact modular GEMM pass, (lo, hi) [B, rows, K]
    -> (lo, hi) [B, rows, O] (which in A, F, G, Ainv; scaled-lazy against
    rank-local rows of the diagonal tables, or canonical): the per-rank pass
    of the sharded prime64 four-step. Replaces `_build_pass_call64` (:197;
    `pass_matmod64` :269), without its row fusion (a TPU lane workaround).
  * K7a `fwd_multi`: all Plan52 channels' forward NTTs of one operand,
    (lo, hi) [B, n] -> (lo, hi) [C, B, n]. Replaces the fwd branch of
    `_build_multi_call64` (:522; `fwd_multi` :679).
  * K7d `pointwise_inv_multi`: per channel the Montgomery product
    fl·fr·2^-64 of two [C, B, n] limb-pair operands (any u64; the overflow of
    the REDC sum kept, as `_sc_mont_mul64` :391) and its scaled inverse NTT
    in one kernel. Replaces the same function's `pointwise=True` inv
    (`pointwise_inv_multi` :728).

`_build_multi_call64`'s other entries (`inv_multi` :712, `fwd_multi_perchannel64`
:695), its `hyb` argument and K5's wide forward (`n_limbs = 4`) serve only
the stage-split hybrid or no default route, and are not ported yet
(ROADMAP.md Queue 2).

All are CUDA C++ for sm_90a built with nvcc at first use (ops/cuda_build.py)
and called through ctypes: K5/K6 in `csrc/mxu64_pass.cu`, K7 in
`csrc/mxu64_multi.cu`, both launching the one GEMM pass of
`csrc/matmod64_pass.cuh` (the 64-bit sibling of `matmod_pass.cuh`: digit
split as one xor per limb word, four digits per __dp4a against host-packed
plane words, 5 to 9 int32 accumulators per output, a carry-exact 64-bit
epilogue in four regimes). A mid-pass operand bounded below 2^56 (the plane
diet: 7 operand planes for the 50-bit primes) gets a zero eighth plane row
when the planes are packed, so every pass contracts two words per value.

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain torch version (`*_plain`, built on
`ops/mxu64.py`), any other device raises. Every kernel launch adds one to
`LAUNCHES[name]`; nothing else does.

Range: K5/K6 take every odd prime 2^33 < p < 2^64; K7 takes channel primes
2^33 < p < 2^62 with one (matrix, operand) plane count for all channels;
all take powers of two 2^11 <= n <= 2^15. Outside it both routes raise
NotImplementedError.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build, mxu64
from .mxu32_cuda import _call, _check_operands, _ptrs, pack_planes
from .u32 import to_i64, to_u32

LAUNCHES = {"fwd64": 0, "inv64": 0, "pass_matmod64": 0, "fwd_multi64": 0,
            "pointwise_inv_multi64": 0}

MIN_N, MAX_N = 1 << 11, 1 << 15
_MODES = {"shoup": 0, "mont": 1, "gl": 3}  # mont with p >= 2^63 is 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_n(n: int, what: str) -> None:
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the {what} serve powers of two in [2^11, 2^15]; smaller sizes take "
            "the stage engine through prime64.Plan, larger ones wait for the stage-split "
            "hybrid (ROADMAP.md Queue 1 item 9)"
        )


def check_single_range(n: int, p: int) -> None:
    """Raise NotImplementedError outside the range K5/K6 serve."""
    _check_n(n, "four-step kernels K5/K6")
    if p % 2 == 0 or not (1 << 33) < p < (1 << 64):
        raise NotImplementedError(
            f"p = {p}: the 64-bit four-step kernels need an odd 2^33 < p < 2^64; "
            "other moduli take the stage engine through prime64.Plan"
        )


def check_multi_range(n: int, primes: tuple) -> None:
    """Raise NotImplementedError outside the range K7a/K7d serve."""
    _check_n(n, "channel-grid kernels K7")
    if not mxu64.multi_applicable(n, primes):
        raise NotImplementedError(
            f"primes {primes}: the channel-grid kernels need odd channel primes "
            "2^33 < p < 2^62 with one digit-plane count; other prime sets take "
            "the single-prime kernel K5 once per channel"
        )


def mode(p: int) -> int:
    """Epilogue regime of csrc/matmod64_pass.cuh: 0 shoup (p < 2^62), 1 mont
    with Shoup fold (2^62 <= p < 2^63), 2 mont with Montgomery fold
    (p >= 2^63), 3 Goldilocks."""
    m = _MODES[mxu64._scale_mode(p)]
    return 2 if m == 1 and p >= (1 << 63) else m


def scalar_record(n: int, p: int) -> np.ndarray:
    """[16] uint32 per-prime scalars the GEMM pass reads, as limb pairs: the
    six of `mxu64._scal_vec64` (p, 2^64 mod p, its Shoup companion, -p^-1
    mod 2^64, floor(2^64/p), 2p mod 2^64), then 2^128 mod p (the
    Montgomery fold's constant, used for p >= 2^63), then 0."""
    tbl = mxu64._tables(n, p)
    words = [w & 0xFFFFFFFF for w in mxu64._scal_vec64(n, p, tbl)]
    c64_mont = tbl.get("c64_mont", 0)
    return np.array(words + [c64_mont & 0xFFFFFFFF, c64_mont >> 32, 0, 0], dtype=np.uint32)


def pack_planes64(planes: np.ndarray, k: int) -> np.ndarray:
    """[C, E*k, D*O] int8 planes (E = 7 or 8 operand planes) -> [C, 2*k, D*O]
    int32 words, `mxu32_cuda.pack_planes` after padding E to 8 with zero
    rows: the digit that meets them (the top byte of a value < 2^56, xor
    0x80) is multiplied by 0, and cvec needs no change."""
    c, ek, do = planes.shape
    if ek != 8 * k:
        assert ek % k == 0 and 4 < ek // k < 8, "5 to 8 operand planes"
        planes = np.concatenate([planes, np.zeros((c, 8 * k - ek, do), np.int8)], axis=1)
    return pack_planes(planes, k)


# ---------------------------------------------------------------------------
# Tables on the device
# ---------------------------------------------------------------------------


def _to_dev(a: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@lru_cache(maxsize=64)
def _pass_tables(n: int, p: int, which: str, scale: int, device: str):
    """One pass's packed planes, cvec and scalar record on `device`."""
    planes, cvec = mxu64.pass_mat(n, p, which, scale)
    n1, n2 = mxu64.four_step_factors(n)
    k = n1 if which in ("A", "Ainv") else n2
    return {
        "planes": _to_dev(pack_planes64(planes[None], k), device),
        "cvec": _to_dev(cvec, device),
        "scal": _to_dev(scalar_record(n, p).view(np.int32), device),
        "k": k,
        "o": cvec.shape[1],
        "n_d": cvec.shape[0],
    }


@lru_cache(maxsize=64)
def _diag_tables(n: int, p: int, name: str, device: str) -> torch.Tensor:
    """The full diagonal d ([n2, n1]) or e ([n1, n2]) as [8 or 2, R, O] uint32."""
    return _to_dev(np.stack(mxu64._tables(n, p)[name]), device)


@lru_cache(maxsize=64)
def _single_tables(n: int, p: int, scale: int, direction: str, device: str):
    """K5's tables for one direction: both passes and the diagonal."""
    first, second = (("A", "F") if direction == "fwd" else ("G", "Ainv"))
    t1 = _pass_tables(n, p, first, 1, device)
    t2 = _pass_tables(n, p, second, scale if direction == "inv" else 1, device)
    return t1, t2, _diag_tables(n, p, "d" if direction == "fwd" else "e", device)


@lru_cache(maxsize=16)
def _kernel_tables(n: int, primes: tuple, scales: tuple, direction: str, device: str):
    """K7's stacked tables for one direction, as tensors on `device`."""
    tabs = mxu64._multi_tables64(n, primes, scales)
    n1, n2 = tabs["n1"], tabs["n2"]
    planes1, cvec1, planes2, cvec2, diag = tabs[direction]
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)
    return {
        "planes1": _to_dev(pack_planes64(planes1, k1), device),
        "cvec1": _to_dev(cvec1, device),
        "planes2": _to_dev(pack_planes64(planes2, k2), device),
        "cvec2": _to_dev(cvec2, device),
        "diag": _to_dev(np.stack(diag, axis=1), device),  # [C, 8, R, O]
        "scal": _to_dev(tabs["scalars"].view(np.int32), device),
        "n_d": cvec1.shape[1],
    }


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


def fwd_plain(limbs: tuple, *, n: int, p: int) -> tuple:
    """Plain twin of K5 fwd: ops/mxu64.py's four-step on the device of limbs."""
    check_single_range(n, p)
    return mxu64.fwd(tuple(limbs), n=n, p=p)


def inv_plain(limbs: tuple, *, n: int, p: int, scale: int = 1) -> tuple:
    """Plain twin of K5 inv (scale folded into A_inv)."""
    check_single_range(n, p)
    return mxu64.inv(tuple(limbs), n=n, p=p, scale=scale)


def pass_matmod64_plain(limbs: tuple, *, n: int, p: int, which: str, diag_slices=(),
                        scale: int = 1) -> tuple:
    """Plain twin of K6: one exact pass, contracting the last axis."""
    check_single_range(n, p)
    return mxu64.pass_plain(tuple(limbs), n=n, p=p, which=which, diag_slices=tuple(diag_slices),
                            scale=scale)


def _stack_pairs(outs: list) -> tuple:
    return tuple(to_u32(torch.stack([o[i] for o in outs])) for i in range(2))


def fwd_multi_plain(limbs: tuple, primes: tuple) -> tuple:
    """Plain twin of K7a: per channel the four-step against the stacked
    tables and the scalar record (`mxu64._multi_channel`)."""
    n = limbs[0].shape[-1]
    check_multi_range(n, primes)
    tabs = mxu64._multi_tables64(n, tuple(primes), (1,) * len(primes))
    xs = tuple(to_i64(a) for a in limbs)
    return _stack_pairs([mxu64._multi_channel(xs, tabs, "fwd", ch) for ch in range(len(primes))])


def pointwise_inv_multi_plain(fl: tuple, fr: tuple, primes: tuple, scales: tuple) -> tuple:
    """Plain twin of K7d: per channel `_sc_mont_mul64` of any-u64 operands
    (the REDC sum's overflow kept), then the scaled inverse."""
    n = fl[0].shape[-1]
    check_multi_range(n, primes)
    tabs = mxu64._multi_tables64(n, tuple(primes), tuple(scales))
    a, b = tuple(to_i64(t) for t in fl), tuple(to_i64(t) for t in fr)
    outs = []
    for ch in range(len(primes)):
        sc = mxu64._read_sc(tabs["scalars"][ch])
        prod = mxu64._sc_mont_mul64((a[0][ch], a[1][ch]), (b[0][ch], b[1][ch]), sc)
        outs.append(mxu64._multi_channel(prod, tabs, "inv", ch))
    return _stack_pairs(outs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _pass_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu64_pass")
    if not lib.k5_fwd.argtypes:
        for fn in (lib.k5_fwd, lib.k5_inv):
            fn.argtypes = [_P, _P, _I, _I, _I, *[_P] * 6, _I, _I, *[_P] * 5]
            fn.restype = ctypes.c_int
        lib.k6_pass.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 4, _I, _I, _I, _P, _P, _P]
        lib.k6_pass.restype = ctypes.c_int
    return lib


def _multi_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu64_multi")
    if not lib.k7a_fwd_multi.argtypes:
        lib.k7a_fwd_multi.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 6, _I, *[_P] * 5]
        lib.k7a_fwd_multi.restype = ctypes.c_int
        lib.k7d_pointwise_inv_multi.argtypes = [*[_P] * 4, _I, _I, _I, _I, *[_P] * 6, _I,
                                                *[_P] * 5]
        lib.k7d_pointwise_inv_multi.restype = ctypes.c_int
    return lib


def _check_pair(limbs, ndim: int) -> tuple:
    limbs = tuple(limbs)
    if len(limbs) != 2:
        raise ValueError(f"expected a (lo, hi) limb pair, got {len(limbs)} limbs")
    return limbs, _check_operands(limbs, ndim)


def _check_last(x: torch.Tensor, n: int) -> None:
    if x.shape[-1] != n:
        raise ValueError(f"last axis must be n={n}, got {tuple(x.shape)}")


def _single(name: str, limbs: tuple, dev, n: int, p: int, scale: int) -> tuple:
    """Launch K5 in one direction on checked operands [B, n]."""
    direction = "fwd" if name == "fwd64" else "inv"
    t1, t2, diag = _single_tables(n, p, scale, direction, str(dev))
    n1, n2 = mxu64.four_step_factors(n)
    b = limbs[0].shape[0]
    out = tuple(torch.empty((b, n), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    ptrs = _ptrs(*limbs, t1["planes"], t1["cvec"], t2["planes"], t2["cvec"], diag, t1["scal"],
                 *scratch, *out)
    fn = _pass_lib().k5_fwd if direction == "fwd" else _pass_lib().k5_inv
    err = _call(dev, fn, ptrs[0], ptrs[1], b, n1, n2, *ptrs[2:8], t1["n_d"], mode(p), *ptrs[8:])
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"K5 {name} launch failed: CUDA error {err}")
    return out


def fwd(limbs: tuple, *, n: int, p: int) -> tuple:
    """K5 fwd: one prime's forward NTT of (lo, hi) [B, n] uint32 (any u64
    values) -> (lo, hi) [B, n] canonical, bit-reversed order."""
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return fwd_plain(limbs, n=n, p=p)
    check_single_range(n, p)
    return _single("fwd64", limbs, dev, n, p, 1)


def inv(limbs: tuple, *, n: int, p: int, scale: int = 1) -> tuple:
    """K5 inv: one prime's inverse NTT of (lo, hi) [B, n] uint32 (any u64
    representatives, bit-reversed) -> (lo, hi) canonical, standard order,
    times `scale` (folded into A_inv; 1 is the unnormalized inverse)."""
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return inv_plain(limbs, n=n, p=p, scale=scale)
    check_single_range(n, p)
    return _single("inv64", limbs, dev, n, p, scale % p)


def pass_matmod64(limbs: tuple, *, n: int, p: int, which: str, diag_slices=(),
                  scale: int = 1) -> tuple:
    """K6: one exact modular GEMM pass on (lo, hi) [B, rows, K] uint32 (any
    u64 representatives), contracting the last axis -> (lo, hi) [B, rows, O].
    which in {A, F, G, Ainv}; `diag_slices` are the rank-local rows
    [rows, O] of the eight (shoup regime) or two diagonal tables (uint32
    tensors or numpy arrays) for the scaled-lazy epilogue; without them the
    epilogue is canonical. A scale multiplies the Ainv pass's matrix."""
    if which not in ("A", "F", "G", "Ainv"):
        raise ValueError(f"which must be A, F, G or Ainv, got {which!r}")
    limbs, dev = _check_pair(limbs, 3)
    diag_slices = tuple(
        torch.from_numpy(np.ascontiguousarray(d)) if isinstance(d, np.ndarray) else d
        for d in diag_slices
    )
    if dev.type == "cpu":
        return pass_matmod64_plain(limbs, n=n, p=p, which=which, diag_slices=diag_slices,
                                   scale=scale)
    check_single_range(n, p)
    b, rows, k = limbs[0].shape
    tabs = _pass_tables(n, p, which, scale % p if which == "Ainv" else 1, str(dev))
    if k != tabs["k"]:
        raise ValueError(f"pass {which} at n={n} contracts {tabs['k']} values, got {k}")
    diag = None
    if diag_slices:
        n_dg = 8 if mode(p) == 0 else 2
        if len(diag_slices) != n_dg or any(
            d.shape != (rows, tabs["o"]) or d.dtype != torch.uint32 for d in diag_slices
        ):
            raise ValueError(f"expected {n_dg} uint32 diagonal slices of shape "
                             f"{(rows, tabs['o'])}")
        diag = torch.stack([d.to(dev) for d in diag_slices]).contiguous()
    out = tuple(torch.empty((b, rows, tabs["o"]), dtype=torch.uint32, device=dev)
                for _ in range(2))
    if b == 0 or rows == 0:
        return out  # nothing to compute; an empty grid is not a valid launch
    dg = diag if diag is not None else tabs["scal"]  # not read by a canonical pass
    ptrs = _ptrs(*limbs, tabs["planes"], tabs["cvec"], dg, tabs["scal"], *out)
    err = _call(dev, _pass_lib().k6_pass, ptrs[0], ptrs[1], b, rows, k, tabs["o"], *ptrs[2:6],
                tabs["n_d"], mode(p), int(diag is not None), ptrs[6], ptrs[7])
    LAUNCHES["pass_matmod64"] += 1
    if err != 0:
        raise RuntimeError(f"K6 pass_matmod64 launch failed: CUDA error {err}")
    return out


def fwd_multi(limbs: tuple, primes: tuple) -> tuple:
    """K7a: all channels' forward NTTs of one operand. (lo, hi) [B, n]
    uint32 (any u64 values) -> (lo, hi) [C, B, n] canonical NTT-domain
    residues, bit-reversed order."""
    limbs, dev = _check_pair(limbs, 2)
    primes = tuple(primes)
    if dev.type == "cpu":
        return fwd_multi_plain(limbs, primes)
    b, n = limbs[0].shape
    check_multi_range(n, primes)
    c = len(primes)
    tabs = _kernel_tables(n, primes, (1,) * c, "fwd", str(dev))
    n1, n2 = mxu64.four_step_factors(n)
    out = tuple(torch.empty((c, b, n), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    ptrs = _ptrs(*limbs, tabs["planes1"], tabs["cvec1"], tabs["planes2"], tabs["cvec2"],
                 tabs["diag"], tabs["scal"], *scratch, *out)
    err = _call(dev, _multi_lib().k7a_fwd_multi, ptrs[0], ptrs[1], b, n1, n2, c, *ptrs[2:8],
                tabs["n_d"], *ptrs[8:])
    LAUNCHES["fwd_multi64"] += 1
    if err != 0:
        raise RuntimeError(f"K7a fwd_multi launch failed: CUDA error {err}")
    return out


def pointwise_inv_multi(fl: tuple, fr: tuple, primes: tuple, scales: tuple) -> tuple:
    """K7d: all channels' Montgomery product fl·fr·2^-64 mod p (fl, fr
    (lo, hi) [C, B, n] uint32, any u64 representatives) and scaled inverse
    NTT in one kernel -> (lo, hi) [C, B, n] canonical, standard order. With
    scale n^-1 · 2^64 mod p the result is the normalized inverse of the
    product."""
    fl, dev = _check_pair(fl, 3)
    fr, dev_r = _check_pair(fr, 3)
    primes, scales = tuple(primes), tuple(scales)
    if fr[0].shape != fl[0].shape or dev_r != dev:
        raise ValueError("fl and fr must have one shape on one device")
    if fl[0].shape[0] != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {tuple(fl[0].shape)}")
    if len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} scales, got {len(scales)}")
    if dev.type == "cpu":
        return pointwise_inv_multi_plain(fl, fr, primes, scales)
    c, b, n = fl[0].shape
    check_multi_range(n, primes)
    tabs = _kernel_tables(n, primes, tuple(s % p for s, p in zip(scales, primes)), "inv",
                          str(dev))
    n1, n2 = mxu64.four_step_factors(n)
    out = tuple(torch.empty((c, b, n), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    ptrs = _ptrs(*fl, *fr, tabs["planes1"], tabs["cvec1"], tabs["planes2"], tabs["cvec2"],
                 tabs["diag"], tabs["scal"], *scratch, *out)
    err = _call(dev, _multi_lib().k7d_pointwise_inv_multi, *ptrs[:4], b, n1, n2, c, *ptrs[4:10],
                tabs["n_d"], *ptrs[10:])
    LAUNCHES["pointwise_inv_multi64"] += 1
    if err != 0:
        raise RuntimeError(f"K7d pointwise_inv_multi launch failed: CUDA error {err}")
    return out
