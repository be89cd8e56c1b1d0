"""Four-step prime64 NTT kernels: K5 (direct and with block tables), K6, K7a-K7d.

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
  * K5h `fwd_hyb` / `inv_hyb(scale)`: the same function with its `hyb`
    argument (:36-43, :62-65): the 2^l block transforms of the stage-split
    hybrid (`ops/stagesplit.py`), each of size n_h with the tables of its
    block of a parent transform of size n (A_b, d_b, e_b, A_inv,b times the
    scale per block; F, G shared). The TPU launches one kernel a block on
    slices and concatenates; here the block is a grid axis: one launch pair
    transforms all blocks of (lo, hi) [B, n] in place in the arrays.
  * K6 `pass_matmod64`: one exact modular GEMM pass, (lo, hi) [B, rows, K]
    -> (lo, hi) [B, rows, O] (which in A, F, G, Ainv; scaled-lazy against
    rank-local rows of the diagonal tables, or canonical), the one-to-one
    twin of the JAX `pass_matmod64`. Replaces `_build_pass_call64` (:197;
    `pass_matmod64` :269), without its row fusion (a TPU lane workaround).
  * K6 `pass_matmod64_multi`: the same pass over a rank's C channels in one
    launch (`k6_pass_multi`), the per-rank pass of the sharded prime64
    four-step (`parallel/`), with strided operand views and a transposed
    output as `mxu32_cuda.pass_matmod_multi`; one digit-plane count and
    regime for all channels; 64 or 128 rows a block by `k6_tile` (counted
    in `TILE_LAUNCHES[(name, code)]`).
  * K7a `fwd_multi`: all Plan52 channels' forward NTTs of one operand,
    (lo, hi) [B, n] -> (lo, hi) [C, B, n]. Replaces the fwd branch of
    `_build_multi_call64` (:522; `fwd_multi` :679).
  * K7c `fwd_multi_perchannel64`: the same with one operand per channel,
    (lo, hi) [C, B, n] any u64 -> [C, B, n] (`perch_fwd=True`, :695).
  * K7b `inv_multi`: all channels' scaled inverse, (lo, hi) [C, B, n] any
    u64 -> canonical, standard order (`pointwise=False`, :712).
  * K7d `pointwise_inv_multi`: per channel the Montgomery product
    fl·fr·2^-64 of two [C, B, n] limb-pair operands (any u64; the overflow of
    the REDC sum kept, as `_sc_mont_mul64` :391) and its scaled inverse NTT
    in one kernel. Replaces the same function's `pointwise=True` inv
    (`pointwise_inv_multi` :728).
  K7b, K7c and K7d take `n_h`: with it the operand's last axis is a parent
  transform's n, and its n // n_h blocks are transformed with the hybrid's
  block tables (the `hyb` argument of `_build_multi_call64`, :524), z = channel · nb +
  block on the grid.

K5's `fwd` also takes the four limbs of a u128 operand (`_build_call` with
`n_limbs = 4`, :47-49): the residue split folds into the column pass as 16
operand digit planes (`mxu64._wide_col_planes`), a launch counts under
"fwd64_u128". No route calls it, as in the reference.

All are CUDA C++ for sm_90a built with nvcc at first use (ops/cuda_build.py)
and called through ctypes: K5/K6 in `csrc/mxu64_pass.cu`, K7 in
`csrc/mxu64_multi.cu`, both launching the one GEMM pass of
`csrc/matmod64_pass.cuh`, the 64-bit sibling of `matmod_pass.cuh`: the int8
tensor cores through Hopper's warpgroup product (`wgmma` m64nNk32 s8, N = 16
outputs x 5 to 9 digit planes), the operand word xored with 0x80808080 as
one A register (the digit split stays one xor), the planes K-major from
shared memory in tiles of 16 outputs that `pack_planes64` lays out on the
host as the descriptor reads them, a three-stage cp.async ring, 5 to 9
int32 accumulators per output and a carry-exact 64-bit epilogue in four
regimes. A mid-pass operand bounded below 2^56 (the plane diet: 7 operand
planes for the 50-bit primes) gets a zero eighth plane row when the planes
are packed, so every pass contracts two words per value (four for a u128
operand). Every operand, table and output pointer the pass reads or writes
in 16- or 8-byte pieces must be 16-byte aligned (`_ptrs16` checks and names
the tensor).

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain torch version (`*_plain`, built on
`ops/mxu64.py` and, for block tables, `ops/stagesplit.py`), any other device
raises. Every kernel launch adds one to `LAUNCHES[name]` (`name_hyb` with
block tables); nothing else does (`utils/profiling` reads their sum into
each top-level span's `launches`).

Range: K5/K6 take every odd prime 2^33 < p < 2^64; K7 takes channel primes
2^33 < p < 2^62 with one (matrix, operand) plane count for all channels;
all take powers of two 2^11 <= n <= 2^15 as the transform (block) size, and
with block tables a parent size that is a larger power of two. Outside it
both routes raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build, mxu64
from .mxu32_cuda import (
    _SMS,
    _STAGE_K,
    _addrs16,
    _call,
    _channel_views,
    _check_multi_args,
    _check_operands,
    _ptrs16,
    pack_planes_kmajor,
    pass_layout,
)
from .u32 import to_i64, to_u32

LAUNCHES = dict.fromkeys(
    ("fwd64", "fwd64_u128", "inv64", "fwd64_hyb", "inv64_hyb", "pass_matmod64",
     "pass_matmod64_multi", "fwd_multi64",
     "fwd_multi_perchannel64", "inv_multi64", "pointwise_inv_multi64",
     "fwd_multi_perchannel64_hyb", "inv_multi64_hyb", "pointwise_inv_multi64_hyb"), 0)

# K6's channel-grid launches by (LAUNCHES name, tile code): which of its pass
# instances ran (`k6_tile`)
TILE_LAUNCHES: dict = {}
profiling.register_launches(LAUNCHES)

MIN_N, MAX_N = 1 << 11, 1 << 15
TILE_O = 16  # outputs a block of csrc/matmod64_pass.cuh (N = 16 x the digit planes)
TILE_ROWS = (128, 64)  # rows a block by tile code (csrc/matmod64_pass.cuh tile_rows)
_MODES = {"shoup": 0, "mont": 1, "gl": 3}  # mont with p >= 2^63 is 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    TILE_LAUNCHES.clear()


def _check_n(n: int, what: str) -> None:
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the {what} serve powers of two in [2^11, 2^15]; smaller sizes take "
            "the stage engine through prime64.Plan, larger ones the stage-split hybrid "
            "(ops/stagesplit.py: block tables, `fwd_hyb` / `inv_hyb` and `n_h=`)"
        )


def check_single_range(n: int, p: int) -> None:
    """Raise NotImplementedError outside the range K5/K6 serve."""
    _check_n(n, "four-step kernels K5/K6")
    if p % 2 == 0 or not (1 << 33) < p < (1 << 64):
        raise NotImplementedError(
            f"p = {p}: the 64-bit four-step kernels need an odd 2^33 < p < 2^64; "
            "other moduli take the stage engine through prime64.Plan"
        )


def check_hyb_range(n: int, n_h: int, p: int) -> None:
    """Raise NotImplementedError outside the range K5 serves with block
    tables: a block size K5 takes and a parent size above it."""
    check_single_range(n_h, p)
    _check_parent(n, n_h)


def _check_parent(n: int, n_h: int) -> None:
    if n & (n - 1) or n <= n_h:
        raise NotImplementedError(
            f"n = {n}, n_h = {n_h}: block tables need a parent size that is a power of two "
            "above the block size"
        )


def check_multi_range(n: int, primes: tuple) -> None:
    """Raise NotImplementedError outside the range K7 serves (n the
    transform size: the block size with block tables)."""
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


def scalar_record(n: int, p: int, tbl: dict | None = None) -> np.ndarray:
    """[16] uint32 per-prime scalars the GEMM pass reads, as limb pairs: the
    six of `mxu64._scal_vec64` (p, 2^64 mod p, its Shoup companion, -p^-1
    mod 2^64, floor(2^64/p), 2p mod 2^64), then 2^128 mod p (the
    Montgomery fold's constant, used for p >= 2^63), then 0. They depend on
    p alone; `tbl` is any table dict of p (default: that of (n, p))."""
    if tbl is None:
        tbl = mxu64._tables(n, p)
    words = [w & 0xFFFFFFFF for w in mxu64._scal_vec64(n, p, tbl)]
    c64_mont = tbl.get("c64_mont", 0)
    return np.array(words + [c64_mont & 0xFFFFFFFF, c64_mont >> 32, 0, 0], dtype=np.uint32)


def pack_planes64(planes: np.ndarray, k: int, n_d: int) -> np.ndarray:
    """[C, E*k, D*O] int8 planes (E = 5 to 8 operand planes of a limb pair,
    or 16 of a u128 operand) -> [C, O/16, L*k/32, D*16*32] int32 words (L =
    2 or 4 limbs), the K-major tiles of `csrc/matmod64_pass.cuh`:
    `mxu32_cuda.pack_planes_kmajor` with 16-output tiles after padding E to 8
    with zero rows (the digit that meets them, the top byte of a value
    < 2^56 xor 0x80, is multiplied by 0, and cvec needs no change). A ring
    stage of 32 contraction words must not straddle two limbs: k % 32 == 0."""
    c, ek, do = planes.shape
    assert k % _STAGE_K == 0, "a ring stage of 32 words must lie in one limb"
    if ek < 8 * k:
        assert ek % k == 0 and 4 < ek // k < 8, "5 to 8 operand planes"
        planes = np.concatenate([planes, np.zeros((c, 8 * k - ek, do), np.int8)], axis=1)
    return pack_planes_kmajor(planes, k, n_d, TILE_O)


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
        "planes": _to_dev(pack_planes64(planes[None], k, cvec.shape[0]), device),
        "cvec": _to_dev(cvec, device),
        "scal": _to_dev(scalar_record(n, p).view(np.int32), device),
        "k": k,
        "o": cvec.shape[1],
        "n_d": cvec.shape[0],
    }


@lru_cache(maxsize=64)
def _multi_pass_tables(n: int, primes: tuple, which: str, scales: tuple, device: str):
    """One pass's tables over C channels on `device`: each channel's planes
    packed (`pack_planes64`, its operand planes padded to 8) and stacked
    [C, O / 16, stages, words], cvec [C, D, O], scalar records [C, 16]
    (every channel with one digit-plane count and one epilogue regime)."""
    mats = [mxu64.pass_mat(n, p, which, s) for p, s in zip(primes, scales)]
    n_d = {m[1].shape[0] for m in mats}
    modes = {mode(p) for p in primes}
    if len(n_d) != 1 or len(modes) != 1:
        raise ValueError(f"the channel grid needs one digit-plane count and one regime for all "
                         f"channels, got {sorted(n_d)} and {sorted(modes)} for {primes}")
    n1, n2 = mxu64.four_step_factors(n)
    k = n1 if which in ("A", "Ainv") else n2
    return {
        "planes": _to_dev(np.concatenate([pack_planes64(m[0][None], k, m[1].shape[0])
                                          for m in mats]), device),
        "cvec": _to_dev(np.stack([m[1] for m in mats]), device),
        "scal": _to_dev(np.stack([scalar_record(n, p) for p in primes]).view(np.int32), device),
        "k": k,
        "o": mats[0][1].shape[1],
        "n_d": mats[0][1].shape[0],
    }


@lru_cache(maxsize=64)
def multi_diag(n: int, primes: tuple, which: str, row0: int, rows: int,
               device: str) -> torch.Tensor:
    """Rows row0 .. row0 + rows of each channel's diagonal tables (d for the
    A pass, e for G), stacked [C, 8 or 2, rows, O] uint32 on `device`: a
    rank's rows, the `diag` of `pass_matmod64_multi`."""
    name = {"A": "d", "G": "e"}[which]
    return _to_dev(np.stack([np.stack(mxu64._tables(n, p)[name])[:, row0:row0 + rows]
                             for p in primes]), device)


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


def _flat_blocks(a: np.ndarray, lead: int) -> np.ndarray:
    """Merge the first `lead` axes ([C, nb, ...] -> [C * nb, ...])."""
    return a.reshape(-1, *a.shape[lead:])


@lru_cache(maxsize=16)
def _kernel_tables(n: int, primes: tuple, scales: tuple, direction: str, device: str,
                   hyb: int | None = None):
    """K7's stacked tables for one direction, as tensors on `device`. With
    `hyb` (a parent size) the per-block tables are indexed by
    z = channel * nb + block, the shared ones by the channel."""
    tabs = mxu64._multi_tables64(n, primes, scales, hyb)
    n1, n2 = tabs["n1"], tabs["n2"]
    planes1, cvec1, planes2, cvec2, diag = tabs[direction]
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)
    lead = 1 if hyb is None else 2
    l1, l2 = (lead, 1) if direction == "fwd" else (1, lead)  # A_b / Ainv_b are per block
    n_d = cvec1.shape[-2]
    return {
        "planes1": _to_dev(pack_planes64(_flat_blocks(planes1, l1), k1, n_d), device),
        "cvec1": _to_dev(_flat_blocks(cvec1, l1), device),
        "planes2": _to_dev(pack_planes64(_flat_blocks(planes2, l2), k2, n_d), device),
        "cvec2": _to_dev(_flat_blocks(cvec2, l2), device),
        # [C * nb, 8, R, O]
        "diag": _to_dev(np.stack([_flat_blocks(d, lead) for d in diag], axis=1), device),
        "scal": _to_dev(tabs["scalars"].view(np.int32), device),
        "n_d": n_d,
    }


@lru_cache(maxsize=32)
def _hyb_tables(n: int, p: int, n_h: int, scale: int, direction: str, device: str):
    """K5's block tables for one direction of the hybrid of (n, p, n_h): the
    per-block pass (A_b forward, A_inv,b times the scale inverse) and the
    per-block diagonal stacked over the block, the shared pass (F, G) and the
    scalar record once."""
    from . import stagesplit

    blocks = stagesplit._dev64(n, p, n_h)["blocks"]
    n1, n2 = mxu64.four_step_factors(n_h)  # the column operators contract n1, the row ones n2
    if direction == "fwd":
        per_block, shared, diag = [t["A"] for t in blocks], blocks[0]["F"], "d"
    else:
        per_block = [m if m is not None else t["Ainv"]
                     for m, t in zip(stagesplit._ainv_mats(n, p, n_h, scale), blocks)]
        shared, diag = blocks[0]["G"], "e"
    n_d = shared[1].shape[0]
    return {
        "planes_blk": _to_dev(pack_planes64(np.stack([m[0] for m in per_block]), n1, n_d),
                              device),
        "cvec_blk": _to_dev(np.stack([m[1] for m in per_block]), device),
        "planes_sh": _to_dev(pack_planes64(shared[0][None], n2, n_d), device),
        "cvec_sh": _to_dev(shared[1], device),
        "diag": _to_dev(np.stack([np.stack(t[diag]) for t in blocks]), device),  # [nb, 8|2, R, O]
        "scal": _to_dev(scalar_record(n_h, p, blocks[0]).view(np.int32), device),
        "n_d": n_d,
    }


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


def fwd_plain(limbs: tuple, *, n: int, p: int) -> tuple:
    """Plain twin of K5 fwd (2 limbs, or the 4 of a u128 operand):
    ops/mxu64.py's four-step on the device of limbs."""
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


def pass_matmod64_multi_plain(limbs: tuple, *, n: int, primes: tuple, which: str, diag=None,
                              scales=None, transposed_out: bool = False) -> tuple:
    """Plain twin of K6's channel grid (`pass_matmod64_multi`): per channel
    `pass_matmod64_plain` on the (lo, hi) views made explicit (fresh
    contiguous copies) with that channel's diagonal rows and scale; each
    limb stacked [C, B, rows, O], or [C, B, O, rows] with `transposed_out`."""
    limbs = tuple(limbs)
    primes = tuple(primes)
    if len(limbs) != 2:
        raise ValueError(f"expected a (lo, hi) limb pair, got {len(limbs)} limbs")
    scales = _check_multi_args(which, primes, diag, scales)
    pass_layout(limbs, len(primes))
    outs = [pass_matmod64_plain(_channel_views(limbs, ch), n=n, p=p, which=which,
                                diag_slices=tuple(diag[ch]) if diag is not None else (),
                                scale=scales[ch])
            for ch, p in enumerate(primes)]
    pair = tuple(torch.stack([o[i] for o in outs]) for i in range(2))
    return tuple(a.transpose(-1, -2).contiguous() for a in pair) if transposed_out else pair


def fwd_hyb_plain(limbs: tuple, *, n: int, p: int, n_h: int) -> tuple:
    """Plain twin of K5h fwd: the hybrid's 2^l block transforms of (lo, hi)
    [B, n], each `mxu64._fwd_core` against its block's tables."""
    from . import stagesplit

    check_hyb_range(n, n_h, p)
    dv = stagesplit._dev64(n, p, n_h)
    out = stagesplit._blocks_fwd64(tuple(to_i64(a) for a in limbs), dv, n_h)
    return tuple(to_u32(a) for a in out)


def inv_hyb_plain(limbs: tuple, *, n: int, p: int, n_h: int, scale: int = 1) -> tuple:
    """Plain twin of K5h inv (scale folded into each block's A_inv)."""
    from . import stagesplit

    check_hyb_range(n, n_h, p)
    dv = stagesplit._dev64(n, p, n_h)
    out = stagesplit._blocks_inv64(tuple(to_i64(a) for a in limbs), dv, n_h,
                                   stagesplit._ainv_mats(n, p, n_h, scale))
    return tuple(to_u32(a) for a in out)


def _stack_pairs(outs: list) -> tuple:
    return tuple(to_u32(torch.stack([o[i] for o in outs])) for i in range(2))


def _check_multi(n: int, primes: tuple, n_h: int | None) -> None:
    if n_h is None:
        check_multi_range(n, primes)
    else:
        check_multi_range(n_h, primes)
        _check_parent(n, n_h)


def _tabs_args(n: int, n_h: int | None) -> tuple:
    """(transform size, hyb) of the table functions for an operand of last
    axis n: direct, or n_h-blocks of a parent transform of size n."""
    return (n, None) if n_h is None else (n_h, n)


def _multi_tabs(n: int, primes: tuple, scales: tuple, n_h: int | None) -> dict:
    size, hyb = _tabs_args(n, n_h)
    return mxu64._multi_tables64(size, tuple(primes), tuple(scales), hyb)


def _multi_plain(xs: tuple, tabs: dict, direction: str, n_h: int | None) -> tuple:
    """Per channel, and per block with block tables, `mxu64._multi_channel`
    on carrier limbs [C, B, n] -> stacked (lo, hi) uint32 [C, B, n]."""
    n = xs[0].shape[-1]
    outs = []
    for ch in range(xs[0].shape[0]):
        x = (xs[0][ch], xs[1][ch])
        if n_h is None:
            outs.append(mxu64._multi_channel(x, tabs, direction, ch))
            continue
        blks = [mxu64._multi_channel(tuple(a[:, i * n_h:(i + 1) * n_h] for a in x), tabs,
                                     direction, ch, i) for i in range(n // n_h)]
        outs.append(tuple(torch.cat([o[j] for o in blks], dim=-1) for j in range(2)))
    return _stack_pairs(outs)


def fwd_multi_plain(limbs: tuple, primes: tuple) -> tuple:
    """Plain twin of K7a: per channel the four-step against the stacked
    tables and the scalar record (`mxu64._multi_channel`)."""
    n = limbs[0].shape[-1]
    check_multi_range(n, primes)
    c = len(primes)
    tabs = mxu64._multi_tables64(n, tuple(primes), (1,) * c)
    xs = tuple(to_i64(a).expand(c, *a.shape) for a in limbs)
    return _multi_plain(xs, tabs, "fwd", None)


def fwd_multi_perchannel64_plain(limbs: tuple, primes: tuple, n_h: int | None = None) -> tuple:
    """Plain twin of K7c: K7a's with one operand per channel; with `n_h`,
    per block against the hybrid's block tables."""
    n = limbs[0].shape[-1]
    _check_multi(n, primes, n_h)
    tabs = _multi_tabs(n, primes, (1,) * len(primes), n_h)
    return _multi_plain(tuple(to_i64(a) for a in limbs), tabs, "fwd", n_h)


def inv_multi_plain(limbs: tuple, primes: tuple, scales: tuple, n_h: int | None = None) -> tuple:
    """Plain twin of K7b: per channel (and block) the scaled inverse."""
    n = limbs[0].shape[-1]
    _check_multi(n, primes, n_h)
    tabs = _multi_tabs(n, primes, scales, n_h)
    return _multi_plain(tuple(to_i64(a) for a in limbs), tabs, "inv", n_h)


def pointwise_inv_multi_plain(fl: tuple, fr: tuple, primes: tuple, scales: tuple,
                              n_h: int | None = None) -> tuple:
    """Plain twin of K7d: per channel `_sc_mont_mul64` of any-u64 operands
    (the REDC sum's overflow kept), then the scaled inverse (per block with
    `n_h`: the product is elementwise, so it commutes with the block cut)."""
    n = fl[0].shape[-1]
    _check_multi(n, primes, n_h)
    tabs = _multi_tabs(n, primes, scales, n_h)
    a, b = tuple(to_i64(t) for t in fl), tuple(to_i64(t) for t in fr)
    prods = []
    for ch in range(len(primes)):
        sc = mxu64._read_sc(tabs["scalars"][ch])
        prods.append(mxu64._sc_mont_mul64((a[0][ch], a[1][ch]), (b[0][ch], b[1][ch]), sc))
    xs = tuple(torch.stack([pr[j] for pr in prods]) for j in range(2))
    return _multi_plain(xs, tabs, "inv", n_h)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _pass_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu64_pass")
    if not lib.k5_fwd.argtypes:
        for fn in (lib.k5_fwd, lib.k5_inv):
            fn.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 6, _I, _I, *[_P] * 5]
            fn.restype = ctypes.c_int
        lib.k5_fwd_u128.argtypes = [*[_P] * 4, _I, _I, _I, *[_P] * 6, _I, _I, *[_P] * 5]
        lib.k5_fwd_u128.restype = ctypes.c_int
        lib.k6_pass.argtypes = [_P, _P, _I, _I, _I, _I, *[_P] * 4, _I, _I, _I, _P, _P, _P]
        lib.k6_pass.restype = ctypes.c_int
        lib.k6_pass_multi.argtypes = [_P] * 7
        lib.k6_pass_multi.restype = ctypes.c_int
        lib.k64_pass_smem_bytes.argtypes = [_I, _I]
        lib.k64_pass_smem_bytes.restype = ctypes.c_int
    return lib


def _multi_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu64_multi")
    if not lib.k7_fwd_multi.argtypes:
        lib.k7_fwd_multi.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, *[_P] * 6, _I, *[_P] * 5]
        lib.k7_fwd_multi.restype = ctypes.c_int
        lib.k7_inv_multi.argtypes = [*[_P] * 4, _I, _I, _I, _I, _I, *[_P] * 6, _I, *[_P] * 5]
        lib.k7_inv_multi.restype = ctypes.c_int
    return lib


# names of the tensors `_ptrs16` checks, for its error
_TABS6 = "planes1 cvec1 planes2 cvec2 diag scal"
_OUTS = "scratch_lo scratch_hi out_lo out_hi"


def _check_pair(limbs, ndim: int) -> tuple:
    limbs = tuple(limbs)
    if len(limbs) != 2:
        raise ValueError(f"expected a (lo, hi) limb pair, got {len(limbs)} limbs")
    return limbs, _check_operands(limbs, ndim)


def _check_last(x: torch.Tensor, n: int) -> None:
    if x.shape[-1] != n:
        raise ValueError(f"last axis must be n={n}, got {tuple(x.shape)}")


def _single(name: str, limbs: tuple, dev, n_blk: int, nb: int, tabs6: tuple, n_d: int,
            p: int) -> tuple:
    """Launch K5 in one direction on checked operands [B, nb * n_blk]: nb
    block transforms of size n_blk (1: the direct transform). tabs6 =
    (planes1, cvec1, planes2, cvec2, diag, scal) in pass order."""
    n1, n2 = mxu64.four_step_factors(n_blk)
    b = limbs[0].shape[0]
    out = tuple(torch.empty((b, nb * n_blk), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    ptrs = _ptrs16(*limbs, *tabs6, *scratch, *out, names=f"x_lo x_hi {_TABS6} {_OUTS}")
    fn = _pass_lib().k5_fwd if name.startswith("fwd") else _pass_lib().k5_inv
    err = _call(dev, fn, ptrs[0], ptrs[1], b, n1, n2, nb, *ptrs[2:8], n_d, mode(p), *ptrs[8:])
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"K5 {name} launch failed: CUDA error {err}")
    return out


def _direct(name: str, limbs: tuple, dev, n: int, p: int, scale: int) -> tuple:
    t1, t2, diag = _single_tables(n, p, scale, "fwd" if name == "fwd64" else "inv", str(dev))
    tabs6 = (t1["planes"], t1["cvec"], t2["planes"], t2["cvec"], diag, t1["scal"])
    return _single(name, limbs, dev, n, 1, tabs6, t1["n_d"], p)


def fwd(limbs: tuple, *, n: int, p: int) -> tuple:
    """K5 fwd: one prime's forward NTT of (lo, hi) [B, n] uint32 (any u64
    values) -> (lo, hi) [B, n] canonical, bit-reversed order. Four limbs are
    a u128 operand (any values; the residue split is part of the column
    pass)."""
    limbs = tuple(limbs)
    if len(limbs) == 4:
        return _fwd_u128(limbs, n, p)
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return fwd_plain(limbs, n=n, p=p)
    check_single_range(n, p)
    return _direct("fwd64", limbs, dev, n, p, 1)


@lru_cache(maxsize=16)
def _wide_tables(n: int, p: int, device: str):
    """The u128 column pass's packed planes (16 operand planes) and cvec."""
    planes, cvec = mxu64._wide_col_planes(n, p, 4)
    n1 = mxu64.four_step_factors(n)[0]
    return (_to_dev(pack_planes64(planes[None], n1, cvec.shape[0]), device),
            _to_dev(cvec, device))


def _fwd_u128(limbs: tuple, n: int, p: int) -> tuple:
    dev = _check_operands(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return fwd_plain(limbs, n=n, p=p)
    check_single_range(n, p)
    _, t2, diag = _single_tables(n, p, 1, "fwd", str(dev))
    planes1, cvec1 = _wide_tables(n, p, str(dev))
    n1, n2 = mxu64.four_step_factors(n)
    b = limbs[0].shape[0]
    out = tuple(torch.empty((b, n), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    ptrs = _ptrs16(*limbs, planes1, cvec1, t2["planes"], t2["cvec"], diag, t2["scal"], *scratch,
                   *out, names=f"x0 x1 x2 x3 {_TABS6} {_OUTS}")
    err = _call(dev, _pass_lib().k5_fwd_u128, *ptrs[:4], b, n1, n2, *ptrs[4:10], t2["n_d"],
                mode(p), *ptrs[10:])
    LAUNCHES["fwd64_u128"] += 1
    if err != 0:
        raise RuntimeError(f"K5 fwd64_u128 launch failed: CUDA error {err}")
    return out


def inv(limbs: tuple, *, n: int, p: int, scale: int = 1) -> tuple:
    """K5 inv: one prime's inverse NTT of (lo, hi) [B, n] uint32 (any u64
    representatives, bit-reversed) -> (lo, hi) canonical, standard order,
    times `scale` (folded into A_inv; 1 is the unnormalized inverse)."""
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return inv_plain(limbs, n=n, p=p, scale=scale)
    check_single_range(n, p)
    return _direct("inv64", limbs, dev, n, p, scale % p)


def fwd_hyb(limbs: tuple, *, n: int, p: int, n_h: int) -> tuple:
    """K5h fwd: the n // n_h block transforms of the stage-split hybrid of
    (n, p) in one launch pair. (lo, hi) [B, n] uint32, the output of the
    hybrid's prefix stages (any u64) -> (lo, hi) [B, n] canonical: the
    forward NTT of size n in bit-reversed order."""
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return fwd_hyb_plain(limbs, n=n, p=p, n_h=n_h)
    check_hyb_range(n, n_h, p)
    t = _hyb_tables(n, p, n_h, 1, "fwd", str(dev))
    tabs6 = (t["planes_blk"], t["cvec_blk"], t["planes_sh"], t["cvec_sh"], t["diag"], t["scal"])
    return _single("fwd64_hyb", limbs, dev, n_h, n // n_h, tabs6, t["n_d"], p)


def inv_hyb(limbs: tuple, *, n: int, p: int, n_h: int, scale: int = 1) -> tuple:
    """K5h inv: the block inverses of the hybrid of (n, p), `scale` folded
    into each block's A_inv. (lo, hi) [B, n] uint32 (any u64, bit-reversed)
    -> (lo, hi) [B, n] canonical: the input of the hybrid's suffix stages."""
    limbs, dev = _check_pair(limbs, 2)
    _check_last(limbs[0], n)
    if dev.type == "cpu":
        return inv_hyb_plain(limbs, n=n, p=p, n_h=n_h, scale=scale)
    check_hyb_range(n, n_h, p)
    t = _hyb_tables(n, p, n_h, scale % p, "inv", str(dev))
    tabs6 = (t["planes_sh"], t["cvec_sh"], t["planes_blk"], t["cvec_blk"], t["diag"], t["scal"])
    return _single("inv64_hyb", limbs, dev, n_h, n // n_h, tabs6, t["n_d"], p)


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
    ptrs = _ptrs16(*limbs, tabs["planes"], tabs["cvec"], dg, tabs["scal"], *out,
                   names="x_lo x_hi planes cvec diag scal out_lo out_hi")
    err = _call(dev, _pass_lib().k6_pass, ptrs[0], ptrs[1], b, rows, k, tabs["o"], *ptrs[2:6],
                tabs["n_d"], mode(p), int(diag is not None), ptrs[6], ptrs[7])
    LAUNCHES["pass_matmod64"] += 1
    if err != 0:
        raise RuntimeError(f"K6 pass_matmod64 launch failed: CUDA error {err}")
    return out


class K6MultiArgs(ctypes.Structure):
    """The fixed arguments of a `k6_pass_multi` launch (`K6MultiArgs` of
    csrc/mxu64_pass.cu, the same fields in the same order)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("planes", "cvec", "scal")]
                + [(f, ctypes.c_longlong) for f in ("x_chan", "x_b", "out_chan", "out_b")]
                + [(f, ctypes.c_int) for f in ("channels", "batch", "rows", "k1", "o", "s_k",
                                               "s_r", "t_r", "t_o", "n_d", "mode", "scaled",
                                               "tile")])


def k6_tile(rows: int, outs: int, grids: int) -> int:
    """The tile code of a `pass_matmod64_multi` launch over `rows` operand
    rows (batch x rows of a polynomial), `outs` outputs a row and `grids`
    channels: 64 rows (code 1, one warpgroup, three blocks an SM) where a
    grid of 128-row blocks (two an SM) would hold at most one and a half
    blocks an SM of the card's 132, else 128 rows (code 0).
    `tools/ab_sharded.py`'s sweep set the threshold (PERF.md section 6):
    64 rows won by 13-24 % at 48 and 192 blocks of 128 rows, and lost
    by up to 34 % at 256 and 384."""
    blocks = grids * -(-rows // TILE_ROWS[0]) * (outs // TILE_O)
    return 1 if blocks <= _SMS * 3 // 2 else 0


@lru_cache(maxsize=128)
def _k6m_launch(n: int, primes: tuple, which: str, scales: tuple, device: str, b: int,
                rows: int, strides: tuple, transposed_out: bool, scaled: bool):
    """(address of the K6MultiArgs record, the record, its tables) of one
    table set, batch, operand layout and output layout."""
    tabs = _multi_pass_tables(n, primes, which, scales, device)
    k, o = tabs["k"], tabs["o"]
    x_chan, x_b, s_r, s_k = strides
    t_r, t_o = (1, rows) if transposed_out else (o, 1)
    rec = K6MultiArgs(*_ptrs16(tabs["planes"], tabs["cvec"], tabs["scal"],
                               names="planes cvec scal"), x_chan, x_b, b * rows * o, rows * o,
                      len(primes), b, rows, k, o, s_k, s_r, t_r, t_o, tabs["n_d"],
                      mode(primes[0]), int(scaled), k6_tile(b * rows, o, len(primes)))
    return ctypes.addressof(rec), rec, tabs


def pass_matmod64_multi(limbs: tuple, *, n: int, primes: tuple, which: str, diag=None,
                        scales=None, transposed_out: bool = False) -> tuple:
    """K6 on a channel grid: one exact modular GEMM pass on limb pairs over
    C channels in one launch (`csrc/mxu64_pass.cu` `k6_pass_multi`). limbs:
    (lo, hi) uint32 views [B, rows, K] (every channel's operand) or
    [C, B, rows, K], any u64, in either layout of `mxu32_cuda.pass_layout`
    (a transposed view reads in place); contracting K -> (lo, hi) [C, B,
    rows, O], or their transposes [C, B, O, rows] written directly with
    `transposed_out`. which in {A, F, G, Ainv}; `diag`: the A / G pass's
    diagonal rows [C, 8 or 2, rows, O] (`multi_diag`) for the scaled-lazy
    epilogue, else canonical; `scales`: one a channel, multiplying the Ainv
    pass's matrix. Every channel needs one digit-plane count and regime.
    The tile is `k6_tile`'s; a launch counts under "pass_matmod64_multi".
    A CPU tensor takes the plain twin."""
    limbs = tuple(limbs)
    primes = tuple(primes)
    if len(limbs) != 2:
        raise ValueError(f"expected a (lo, hi) limb pair, got {len(limbs)} limbs")
    scs = _check_multi_args(which, primes, diag, scales)
    (b, rows, k), strides = pass_layout(limbs, len(primes))
    dev = limbs[0].device
    if diag is not None and (diag.dtype != torch.uint32 or diag.device != dev
                             or not diag.is_contiguous()):
        raise ValueError("diag must be a contiguous uint32 tensor on the operand's device")
    if dev.type == "cpu":
        return pass_matmod64_multi_plain(limbs, n=n, primes=primes, which=which, diag=diag,
                                         scales=scales, transposed_out=transposed_out)
    if dev.type != "cuda":
        raise ValueError(f"no route for tensors on {dev}: use cuda or cpu")
    for p in primes:
        check_single_range(n, p)
    scales = tuple(s % p for s, p in zip(scs, primes))
    addr, rec, tabs = _k6m_launch(n, primes, which, scales, str(dev), b, rows, strides,
                                  transposed_out, diag is not None)
    if k != rec.k1:
        raise ValueError(f"pass {which} at n={n} contracts {rec.k1} values, got {k}")
    o, c = rec.o, len(primes)
    if diag is not None and tuple(diag.shape) != (c, 8 if rec.mode == 0 else 2, rows, o):
        raise ValueError(f"diag must be [C, 8 or 2, {rows}, {o}], got {tuple(diag.shape)}")
    out = torch.empty((2, c, b, o, rows) if transposed_out else (2, c, b, rows, o),
                      dtype=torch.uint32, device=dev)
    if b == 0:
        return out[0], out[1]  # nothing to compute; an empty grid is not a valid launch
    dg = diag if diag is not None else tabs["scal"]  # not read by a canonical pass
    err = _call(dev, _pass_lib().k6_pass_multi, addr, *_addrs16(*limbs, names="x_lo x_hi"),
                *_ptrs16(dg, names="diag"), out[0].data_ptr(), out[1].data_ptr())
    LAUNCHES["pass_matmod64_multi"] += 1
    key = ("pass_matmod64_multi", rec.tile)
    TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + 1
    if err != 0:
        raise RuntimeError(f"K6 pass_matmod64_multi launch failed: CUDA error {err}")
    return out[0], out[1]


def _multi(name: str, x: tuple, y: tuple | None, perchannel: bool, dev, primes: tuple,
           scales: tuple, n_h: int | None) -> tuple:
    """Launch K7 on checked operands: x (lo, hi) [B, n] (shared forward
    operand) or [C, B, n]; y the second operand of the pointwise inverse."""
    direction = "fwd" if name.startswith("fwd") else "inv"
    b, n = x[0].shape[-2:]
    c = len(primes)
    size, hyb = _tabs_args(n, n_h)
    tabs = _kernel_tables(size, primes, scales, direction, str(dev), hyb)
    n1, n2 = mxu64.four_step_factors(size)
    out = tuple(torch.empty((c, b, n), dtype=torch.uint32, device=dev) for _ in range(2))
    if b == 0:
        return out
    scratch = tuple(torch.empty_like(o) for o in out)
    tp = _ptrs16(*(tabs[k] for k in _TABS6.split()), names=_TABS6)
    rest = _ptrs16(*scratch, *out, names=_OUTS)
    xp = _ptrs16(*x, names="x_lo x_hi")
    if direction == "fwd":
        err = _call(dev, _multi_lib().k7_fwd_multi, *xp, int(perchannel), b, n1, n2, n // size,
                    c, *tp, tabs["n_d"], *rest)
    else:
        yp = _ptrs16(*y, names="y_lo y_hi") if y is not None else (None, None)
        err = _call(dev, _multi_lib().k7_inv_multi, *xp, *yp, b, n1, n2, n // size, c, *tp,
                    tabs["n_d"], *rest)
    LAUNCHES[name + ("_hyb" if n_h is not None else "")] += 1
    if err != 0:
        raise RuntimeError(f"K7 {name} launch failed: CUDA error {err}")
    return out


def fwd_multi(limbs: tuple, primes: tuple) -> tuple:
    """K7a: all channels' forward NTTs of one operand. (lo, hi) [B, n]
    uint32 (any u64 values) -> (lo, hi) [C, B, n] canonical NTT-domain
    residues, bit-reversed order."""
    limbs, dev = _check_pair(limbs, 2)
    primes = tuple(primes)
    if dev.type == "cpu":
        return fwd_multi_plain(limbs, primes)
    check_multi_range(limbs[0].shape[-1], primes)
    return _multi("fwd_multi64", limbs, None, False, dev, primes, (1,) * len(primes), None)


def _check_channels(x: torch.Tensor, primes: tuple) -> None:
    if x.shape[0] != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {tuple(x.shape)}")


def fwd_multi_perchannel64(x_lo, x_hi, primes: tuple, n_h: int | None = None) -> tuple:
    """K7c: all channels' forward NTTs of per-channel operands. (lo, hi)
    [C, B, n] uint32 (any u64 values) -> (lo, hi) [C, B, n] canonical,
    bit-reversed order. With `n_h`, n is a parent transform's size and the
    n // n_h blocks take the stage-split hybrid's block tables: the operand
    is the hybrid's per-channel prefix output, the result the forward NTT of
    size n."""
    limbs, dev = _check_pair((x_lo, x_hi), 3)
    primes = tuple(primes)
    _check_channels(limbs[0], primes)
    if dev.type == "cpu":
        return fwd_multi_perchannel64_plain(limbs, primes, n_h)
    _check_multi(limbs[0].shape[-1], primes, n_h)
    return _multi("fwd_multi_perchannel64", limbs, None, True, dev, primes,
                  (1,) * len(primes), n_h)


def _check_scales(primes: tuple, scales: tuple) -> tuple:
    if len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} scales, got {len(scales)}")
    return tuple(s % p for s, p in zip(scales, primes))


def inv_multi(x_lo, x_hi, primes: tuple, scales: tuple, n_h: int | None = None) -> tuple:
    """K7b: all channels' scaled inverse NTTs. (lo, hi) [C, B, n] uint32 (any
    u64 representatives, bit-reversed) -> (lo, hi) [C, B, n] canonical,
    standard order, times scales[ch] (folded into A_inv). With `n_h`, the
    n // n_h block inverses of the stage-split hybrid: the result is the
    input of its suffix stages."""
    limbs, dev = _check_pair((x_lo, x_hi), 3)
    primes = tuple(primes)
    _check_channels(limbs[0], primes)
    scales = _check_scales(primes, tuple(scales))
    if dev.type == "cpu":
        return inv_multi_plain(limbs, primes, scales, n_h)
    _check_multi(limbs[0].shape[-1], primes, n_h)
    return _multi("inv_multi64", limbs, None, True, dev, primes, scales, n_h)


def pointwise_inv_multi(fl: tuple, fr: tuple, primes: tuple, scales: tuple,
                        n_h: int | None = None) -> tuple:
    """K7d: all channels' Montgomery product fl·fr·2^-64 mod p (fl, fr
    (lo, hi) [C, B, n] uint32, any u64 representatives) and scaled inverse
    NTT in one kernel -> (lo, hi) [C, B, n] canonical, standard order. With
    scale n^-1 · 2^64 mod p the result is the normalized inverse of the
    product. With `n_h`, the block inverses of the stage-split hybrid."""
    fl, dev = _check_pair(fl, 3)
    fr, dev_r = _check_pair(fr, 3)
    primes = tuple(primes)
    if fr[0].shape != fl[0].shape or dev_r != dev:
        raise ValueError("fl and fr must have one shape on one device")
    _check_channels(fl[0], primes)
    scales = _check_scales(primes, tuple(scales))
    if dev.type == "cpu":
        return pointwise_inv_multi_plain(fl, fr, primes, scales, n_h)
    _check_multi(fl[0].shape[-1], primes, n_h)
    return _multi("pointwise_inv_multi64", fl, fr, True, dev, primes, scales, n_h)
