"""Four-step prime32 NTT kernels: K1a-K1e (channel grid), K2, K3.

Counterpart of `concrete_ntt_tpu/ops/mxu32_pallas.py`:

  * K1a `fwd_wide_multi`: [B, n] u32 limb tuple (1, 2 or 4 limbs: a u32, u64
    or u128 operand) -> [C, B, n] canonical NTT-domain residues,
    bit-reversed order, all CRT channels. Replaces the fwd branch of
    `_build_multi_call` (kernel body :367-397). With four limbs the u128 ->
    residue split is 16 operand digit planes of the column matmul
    (`mxu32._wide_col_planes(n, p, 4)`, contraction 16 * n1 <= 4096, the
    edge `assert_accumulator_exact` proves at every table build).
  * K1b `inv_multi`: [C, B, n] u32 (any representative) -> [C, B, n]
    canonical, standard order, times a per-channel scale folded into A_inv.
    Replaces the inv branch of the same builder (kernel body :398-412).
  * K1c `fwd_multi_perchannel` / `fwd_wide_multi_perchannel`: K1a with a
    different operand per channel, [C, B, n] u32 per limb (any values).
    Replaces the builder's `perch_in=True` fwd (:544, :564); the product
    plan's Bounded forward.
  * K1d `pointwise_inv_multi`: fl, fr [C, B, n] u32 (any representatives)
    -> K1b of their Montgomery product fl*fr*2^-32 (the u32 overflow of the
    REDC sum kept, as `_sc_mont_mul` :505). Replaces the builder's
    `pointwise=True` inv (:637); the product plan's fused polymul.
  * K1e `inv_multi_presplit`: K1b whose operand arrives as the int8 digit
    planes of `digit_planes32` ([C, B, n1, 4 * n2], plain torch), the
    JAX function's `presplit=True` (:331-336, :614). The first pass copies
    the planes with cp.async into K1b's ring (K1b's bytes) and packs the
    four plane bytes of a value into its digit word where the A fragment is
    read instead of xoring the u32; the result is K1b's bit for bit. Its
    passes take tile codes as K1c's (`_k1e_tiles`: `k1_tile` on C channels;
    launches also counted in `TILE_LAUNCHES`). No route takes it (off in
    the reference's 'auto' too): on this card the in-kernel split is one
    xor.
  * K2 `fwd` / `fwd_wide` / `inv(scale)`: the whole four-step transform of
    one prime, [B, n] -> [B, n]. Replaces `_build_call` (kernel :72-107).
    `passes_engine` (fwd / fwd_wide / inv) names the same functions: the
    TPU splits 2048 <= n < 2^14 into two `_build_pass_call` passes only
    because the whole transform outgrows VMEM there, and K2 serves every
    2^11 <= n <= 2^17 on the card.
  * Block tables (the JAX functions' `hyb=(parent_n, blk)` argument, :36-44,
    :262-289): K2 `fwd_hyb` / `inv_hyb(scale)` and the `n_h=` forms of K1b
    `inv_multi`, K1c `fwd_multi_perchannel` / `fwd_wide_multi_perchannel`
    and K1d `pointwise_inv_multi` run the n // n_h block transforms of the
    32-bit stage-split hybrid (`ops/stagesplit.py`), each of size n_h with
    the tables of its block of a parent transform of size n (A_b, d_b, e_b,
    A_inv,b times the scale per block; F, G shared). The TPU launches one
    kernel a block on slices and concatenates; here the block is a grid
    axis (z = channel * nb + block): one launch pair transforms all blocks
    in place in the [.., B, n] arrays. K2's passes take a tile code each
    from the grid with the nb blocks counted (`k2h_tiles`), the block
    tables packed for it (launches also counted in `TILE_LAUNCHES`). No
    route of `ntt_dispatch` takes the 32-bit hybrid (as the reference's
    'auto'); `stagesplit.engine32_fused` and the four `*_hybrid32`
    functions call these.
  * K3 `pass_matmod`: one exact modular GEMM pass [B, rows, K] -> [B, rows,
    O] (which in A, F, G, Ainv; scaled-lazy epilogue by rank-local diagonal
    slices, or canonical), the one-to-one twin of the JAX `pass_matmod`
    (:759). Replaces `_build_pass_call` (kernel :706-719).
  * K3 `pass_matmod_multi`: the same pass over a rank's C CRT channels in
    one launch (`k3_pass_multi`), the per-rank pass of the sharded
    four-step (`parallel/`): the operand limbs [B, rows, K] shared by every
    channel (the A pass) or [C, B, rows, K], read in place through strided
    views (`pass_layout`: a four-step transpose is a view), the output
    [C, B, rows, O] or written transposed; per-channel tables stacked and
    cached, the diagonal rows a rank holds from `multi_diag`; the tile a
    launch from `k3_multi_tile` (`k1_tile` on C channels). Each launch also
    adds one to `TILE_LAUNCHES[(name, code)]`.

All are CUDA C++ for sm_90a built with nvcc at first use (ops/cuda_build.py)
and called through ctypes: K1 in `csrc/mxu32_multi.cu`, K2/K3 in
`csrc/mxu32_pass.cu`, both launching the one GEMM pass of
`csrc/matmod_pass.cuh`. What bounds them on the H100: the int8 digit
products (K1a with two limbs at (2^14, 8) over five channels 4.0e9 int8
MACs, at (2^16, 8) 3.2e10) against a few MiB of memory traffic, so the
contraction's rate decides. The pass contracts on the int8 tensor cores
with Hopper's warpgroup product (`wgmma` m64nNk32, s8 x s8 -> s32, exact):
the operand word xored with 0x80808080 is one A register, so the digit
split stays one xor, and the planes come K-major from shared memory in
per-block tiles that `pack_planes_kmajor` lays out on the host as the
descriptor reads them. Loads run through a three-stage cp.async ring in
shared memory; the operator tables stay in L2 and the mid-pass transpose
is a stride of the second pass's loads. K2, one channel, picks its tiles
per pass from the grid (`k2_tile`: 128 x 32 as K1, or 64 x 16 holding a
contraction of up to four stages whole) and packs its tables for them; its
fixed launch arguments (tables, shape, tiles) are built once per table set
and batch as a `K2Args` record (`_k2_launch`). K1c and K1d, the product
plan's kernels on two or three channels, pick their tiles too (`k1_tile`:
64 x 16, K1's tile holding four stages whole, 128 x 64, or K1's ring; K1d's
pointwise pass copies both operands with cp.async and takes their
Montgomery product where the A fragment is read); each of their launches
also adds one to `TILE_LAUNCHES[(name, code 1, code 2)]`. Every operand,
table and output pointer a kernel reads 16 bytes at a time must be 16-byte
aligned (`_ptrs16` checks; the tables once, when their record is built).

Routing is by the device of the operand: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain torch version (`*_plain`, built on
`ops/mxu32.py`), any other device raises. Every kernel launch adds one to
`LAUNCHES[name]`; nothing else does (`utils/profiling` reads their sum
into each top-level span's `launches`). K2's `fwd_wide` is its `fwd` kernel
with more limbs and counts under "fwd"; a launch with four operand limbs
(K1a, K2 fwd, K3's A pass, on one channel or a grid) counts under its own
name, `*_u128`, and not under the plain one; a launch with block tables
counts under `*_hyb`.

Range: K1 takes channel primes 2^29 < p < 2^30 (as `mxu32_pallas.py:254`)
and 2^11 <= n <= 2^17 (the TPU serves K1c/K1d only at n >= 2^14, a VMEM
and lane limit; the results are the same bits at every n);
K2/K3 take every prime32 regime with odd 2^26 <= p < 2^32 (lt30, lt31,
generic with its Montgomery epilogues and, near 2^32, a fifth matrix digit
plane); all take powers of two 2^11 <= n <= 2^17 (n1 <= 256, n2 <= 512: the
range `mxu32.applicable` proves exact, 16 * n1 = 4096 contraction rows with
four limbs) as the transform (block) size and 1, 2 or 4 operand limbs (K1c 1
or 2: no plan has a u128 operand per channel; block tables 1, or 2 for
K1c), and with block tables a parent size that is a larger power of two.
Outside it both routes raise NotImplementedError. The Mosaic workarounds
`row_fuse` / `_fused_pass_mat` (mxu32_pallas.py:667-683) are not ported:
they only kept TPU lanes at least 128 wide.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build, mxu32
from .cuda_build import call
from .u32 import MASK32, mont_mul, mont_neginv, to_i64, to_u32

LAUNCHES = {"fwd_wide_multi": 0, "inv_multi": 0, "fwd_multi_perchannel": 0,
            "pointwise_inv_multi": 0, "fwd": 0, "inv": 0, "pass_matmod": 0,
            "fwd_wide_multi_u128": 0, "fwd_u128": 0, "pass_matmod_u128": 0,
            "pass_matmod_multi": 0, "pass_matmod_multi_u128": 0,
            "fwd_hyb": 0, "inv_hyb": 0, "inv_multi_hyb": 0, "fwd_multi_perchannel_hyb": 0,
            "pointwise_inv_multi_hyb": 0, "inv_multi_presplit": 0}
# K1c / K1d / K1e launches and K2's with block tables by (LAUNCHES name, tile
# code of the first pass, of the second), K3's channel grid by (name, tile
# code): which of their pass instances ran (`k1_tile`, `k2h_tiles`)
TILE_LAUNCHES: dict = {}
profiling.register_launches(__name__, LAUNCHES, TILE_LAUNCHES)

MIN_N, MAX_N = 1 << 11, 1 << 17
_SCAL_WORDS = 16  # the scalar record of csrc/matmod_pass.cuh


def _check_n_limbs(n: int, n_limbs: int, what: str) -> None:
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"n = {n}: the {what} serve powers of two in [2^11, 2^17]; a prime32 "
            "plan takes the butterfly kernel K4 below and a native plan each "
            "channel's prime32 plan; above 2^17 the int8 accumulators are not "
            "proven exact (mxu32.applicable)"
        )
    if n_limbs not in (1, 2, 4):
        raise NotImplementedError(
            f"{n_limbs} operand limbs: the operand is a u32, a u64 limb pair or "
            "four u128 limbs"
        )


def check_range(n: int, primes: tuple, n_limbs: int = 1) -> None:
    """Raise NotImplementedError outside the range K1a/K1b serve."""
    _check_n_limbs(n, n_limbs, "channel-grid kernels")
    if not all((1 << 29) < p < (1 << 30) for p in primes):
        raise NotImplementedError(
            "the channel-grid kernels need 30-bit channel primes "
            "(2^29 < p < 2^30), as the JAX package's; other primes take the "
            "single-prime kernels K2/K3 one at a time (ntt_dispatch.route32)"
        )


def check_single_range(n: int, p: int, n_limbs: int = 1) -> None:
    """Raise NotImplementedError outside the range K2/K3 serve."""
    _check_n_limbs(n, n_limbs, "four-step kernels K2/K3")
    if p % 2 == 0 or not mxu32._MIN_P <= p < (1 << 32):
        raise NotImplementedError(
            f"p = {p}: the four-step kernels need an odd 2^26 <= p < 2^32; "
            "smaller primes take the butterfly kernel K4 "
            "(ops/butterfly32_cuda.py, n <= 2^15)"
        )


def _check_parent(n: int, n_h: int) -> None:
    if n & (n - 1) or n <= n_h:
        raise NotImplementedError(
            f"n = {n}, n_h = {n_h}: block tables need a parent size that is a power of two "
            "above the block size"
        )


def check_hyb_range(n: int, n_h: int, p: int) -> None:
    """Raise NotImplementedError outside the range K2 serves with block
    tables: a block size K2 takes and a parent size above it."""
    check_single_range(n_h, p)
    _check_parent(n, n_h)


def _check_multi(n: int, primes: tuple, n_limbs: int, n_h: int | None) -> None:
    """The range of the channel grid for an operand of last axis n: direct,
    or n_h-blocks of a parent transform of size n (1 or 2 limbs)."""
    if n_h is None:
        return check_range(n, primes, n_limbs)
    check_range(n_h, primes, n_limbs)
    _check_parent(n, n_h)
    if n_limbs == 4:
        raise NotImplementedError("a u128 operand keeps the direct path: no block tables")


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


def _block_mats(n: int, p: int, n_limbs: int, scale: int, hyb: int | None):
    """(block table dicts, their first-pass forward matrices A_b, their
    second-pass inverse matrices A_inv,b times `scale`) of one prime: the one
    direct transform of size n, or with `hyb` = N the N // n blocks of the
    stage-split hybrid of a parent transform of size N."""
    if hyb is None:
        blocks = (mxu32._mxu_tables(n, p),)
        a = (mxu32._wide_col_planes(n, p, n_limbs) if n_limbs > 1 else blocks[0]["A"],)
        ainv = (blocks[0]["Ainv"] if scale == 1 else mxu32._scaled_ainv_planes(n, p, scale),)
        return blocks, a, ainv
    from . import stagesplit

    blocks = stagesplit._dev32(hyb, p, n)["blocks"]
    if n_limbs > 1:
        a = tuple(stagesplit._wide_block_planes32(hyb, p, n, i, n_limbs)
                  for i in range(len(blocks)))
    else:
        a = tuple(t["A"] for t in blocks)
    ainv = (tuple(t["Ainv"] for t in blocks) if scale == 1
            else stagesplit._scaled_ainv_blocks32(hyb, p, n, scale))
    return blocks, a, ainv


def _multi_tables(n: int, primes: tuple, n_limbs: int, scales: tuple, hyb: int | None = None):
    """Stacked per-channel tables for the channel-grid kernels (numpy; the
    JAX package's `_multi_tables`) for transforms of size n. With `hyb` = N,
    the size of a parent transform, they are the block tables of the
    stage-split hybrid for its nb = N // n blocks: what differs per block
    (A_b and d_b forward, e_b and A_inv,b times the scale inverse) gains a
    block axis after the channel's, [C, nb, ...]; F and G stay per channel."""
    n1, n2 = mxu32.four_step_factors(n)
    stack = lambda xs: np.ascontiguousarray(np.stack(xs, axis=0))
    per_block = stack if hyb is not None else (lambda xs: xs[0])
    p1f, c1f, p2f, c2f, dgf = [], [], [], [], []
    p1i, c1i, p2i, c2i, dgi = [], [], [], [], []
    for ch, p in enumerate(primes):
        assert (1 << 29) < p < (1 << 30), "channel-grid kernels need 30-bit primes"
        blocks, mat1, mat2 = _block_mats(n, p, n_limbs, scales[ch] % p, hyb)
        tbl = blocks[0]  # F, G and the scalars are one for all blocks
        assert tbl["chain"] == (4 * p, 2 * p, p), "unexpected reduction chain"
        p1f.append(per_block([m[0] for m in mat1]))
        c1f.append(per_block([m[1] for m in mat1]))
        p2f.append(tbl["F"][0])
        c2f.append(tbl["F"][1])
        dgf.append([per_block([t["d"][j] for t in blocks]) for j in range(len(tbl["d"]))])
        p1i.append(tbl["G"][0])
        c1i.append(tbl["G"][1])
        p2i.append(per_block([m[0] for m in mat2]))
        c2i.append(per_block([m[1] for m in mat2]))
        dgi.append([per_block([t["e"][j] for t in blocks]) for j in range(len(tbl["e"]))])
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


# the GEMM pass's tile (csrc/matmod_pass.cuh): outputs a block, contraction
# words a ring stage
_TILE_O, _STAGE_K = 32, 32
# (rows, outputs) of the pass's tiles by code (csrc/matmod_pass.cuh `tile`):
# K1's (also K3's and the block tables'), K2's for small grids (K1c / K1d's
# too), then K1c / K1d's own: K1's 128 x 32 holding a short contraction
# whole, and 128 x 64 on K1's ring
TILES = ((128, 32), (64, 16), (128, 32), (128, 64))
K2_CODES = (0, 1)  # the codes K2's entries take (with block tables: all four)
_FILL = 128  # blocks a K2 pass aims for: about one on each of the H100's 132 SMs
_SMS = 132   # the H100's streaming multiprocessors
_RESIDENT = 4  # ring stages tile 2 holds whole (csrc/matmod_pass.cuh `tile`)


def _blocks(rows: int, outs: int, code: int) -> int:
    tm, to = TILES[code]
    return -(-rows // tm) * (outs // to)


def k2_tile(rows: int, outs: int) -> int:
    """The tile code of a K2 pass over `rows` operand rows (batch x rows of
    a polynomial) with `outs` outputs a row: K1's where its grid has at
    least 128 blocks, else 64 x 16 (csrc/mxu32_pass.cu lists the choice at
    each n for B = 16 and the sweep that set the threshold)."""
    return 0 if _blocks(rows, outs, 0) >= _FILL else 1


def k1_tile(rows: int, outs: int, grids: int, stages: int, kind: str = "canonical",
            n_d: int = 4) -> int:
    """The tile code of a K1c / K1d pass over `rows` operand rows (batch x
    rows of a polynomial) with `outs` outputs a row, over `grids` channels
    x blocks, contracting `stages` ring stages of 32 words; `kind` is the
    pass's: "scaled" (K1c's first), "canonical" (both second passes) or
    "pair" (K1d's first, which copies two operands). Where the grid fits
    the card at once: 64 x 16 (code 1, three blocks an SM, two with the
    pair), else K1's tile holding a contraction of up to four stages whole
    (code 2, one block an SM), else 128 x 64 (code 3, one block an SM; not
    for the scaled pass). Else a ring: 128 x 64 for the pair (it copies
    the pair once for twice the outputs), K1's (code 0) otherwise. The
    128 x 64 tile needs four matrix digit planes (`n_d`; five would be
    N = 320 columns, past wgmma's 256) and whole 64-output tiles.
    tools/sweep_product.py timed every code at the product plan's shapes
    (PERF.md section 6) and set the rule; K3's channel grid
    (`pass_matmod_multi`) takes it too."""
    if grids * _blocks(rows, outs, 1) <= _SMS * (2 if kind == "pair" else 3):
        return 1
    if stages <= _RESIDENT and grids * _blocks(rows, outs, 2) <= _SMS:
        return 2
    if kind == "pair":
        return 3  # n2 >= 64: whole 64-output tiles
    fits = n_d == 4 and outs % TILES[3][1] == 0 and grids * _blocks(rows, outs, 3) <= _SMS
    return 3 if kind == "canonical" and fits else 0


def _k1_tiles(b: int, n: int, grids: int, n_limbs: int, direction: str,
              first: str = "pair", n_d: int = 4) -> tuple:
    """Tile codes of K1c's (fwd) or K1d's (inv) two passes in launch order,
    for transforms (blocks) of size n over `grids` channels x blocks: the
    column pass (B·n2 rows, n1 outputs, n_limbs·n1 contraction words) then
    the row pass (B·n1 rows, n2 outputs, n2 words) forward, the other
    order inverse. `first`: the kind of the inverse's first pass ("pair"
    for K1d, "scaled" for K1e and K2 with block tables); `n_d`: matrix
    digit planes."""
    n1, n2 = mxu32.four_step_factors(n)
    col_rows, col_stages = b * n2, n_limbs * n1 // _STAGE_K
    if direction == "fwd":
        return (k1_tile(col_rows, n1, grids, col_stages, "scaled", n_d),
                k1_tile(b * n1, n2, grids, n2 // _STAGE_K, "canonical", n_d))
    return (k1_tile(b * n1, n2, grids, n2 // _STAGE_K, first, n_d),
            k1_tile(col_rows, n1, grids, col_stages, "canonical", n_d))


def _k1e_tiles(b: int, n: int, channels: int) -> tuple:
    """Tile codes of K1e's two passes: `k1_tile` on C channels, "scaled"
    for the presplit row pass (codes 0-2), "canonical" for the column pass,
    as K1c's."""
    return _k1_tiles(b, n, channels, 1, "inv", "scaled")


def k2h_tiles(b: int, n: int, n_h: int, direction: str, n_d: int = 4) -> tuple:
    """Tile codes of K2's two passes with block tables (launch order) for a
    batch of b polynomials of size n cut into n // n_h blocks of size n_h:
    `k1_tile` over the nb = n // n_h grids of one channel, "scaled" for the
    first pass, "canonical" for the second, but where it keeps K1's ring
    (code 0): with five matrix digit planes K1's tile holding a contraction
    of up to four stages whole (code 2; either is one block an SM), with
    four 128 x 64 for the canonical pass (code 3). tools/ab_k1e_k2h.py
    --sweep forced every code at the hybrid's shapes on one H100 and set
    the rule (PERF.md section 6)."""
    n1, n2 = mxu32.four_step_factors(n_h)
    stages = ((n1 if direction == "fwd" else n2) // _STAGE_K,
              (n2 if direction == "fwd" else n1) // _STAGE_K)
    outs = (n1, n2) if direction == "fwd" else (n2, n1)
    codes = _k1_tiles(b, n_h, n // n_h, 1, direction, "scaled", n_d)
    out = []
    for code, st, o, kind in zip(codes, stages, outs, ("scaled", "canonical")):
        if code == 0 and n_d == 5 and st <= _RESIDENT:
            code = 2
        elif code == 0 and n_d == 4 and kind == "canonical" and o % TILES[3][1] == 0:
            code = 3
        out.append(code)
    return tuple(out)


def pack_planes_kmajor(planes: np.ndarray, k: int, n_d: int, tile_o: int = _TILE_O) -> np.ndarray:
    """[C, 4L*k, D*O] int8 planes -> [C, O/T, L*k/32, D*T*32] int32 words,
    the tiles of T = `tile_o` outputs of a GEMM pass (32 for
    `csrc/matmod_pass.cuh`, 16 for `csrc/matmod64_pass.cuh`) in the order
    its wgmma reads them from shared memory: for output tile ot and stage kt,
    tile row (N) r = d*T + j is column d*O + T*ot + j of the plane words
    of `pack_planes` (word (l*k + i, col): the four plane rows that meet the
    four digits of operand value i of limb l), and its 32 words are k-words
    32*kt .. + 31, K-major: 8-row groups of eight 16-byte chunks (four words)
    of eight rows, the core matrices of a descriptor without swizzle. Same
    values as the JAX package's planes, in another order."""
    words = pack_planes(planes, k)  # [C, L*k, D*O]
    c, kw, do = words.shape
    o = do // n_d
    assert n_d * o == do and o % tile_o == 0 and kw % _STAGE_K == 0, "untileable planes"
    w = words.reshape(c, kw // _STAGE_K, 8, 4, n_d, o // tile_o, tile_o // 8, 8)
    # axes: C, stage, chunk, word, digit, output tile, 8-row group, row -> C,
    # output tile, stage, digit, 8-row group, chunk, row, word
    w = w.transpose(0, 5, 1, 4, 6, 2, 7, 3)
    return np.ascontiguousarray(w).reshape(c, o // tile_o, kw // _STAGE_K,
                                          n_d * tile_o * _STAGE_K)


def _flat_blocks(a: np.ndarray, lead: int) -> np.ndarray:
    """Merge the first `lead` axes ([C, nb, ...] -> [C * nb, ...])."""
    return a.reshape(-1, *a.shape[lead:])


def _to_dev(a: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@lru_cache(maxsize=64)
def _kernel_tables(n: int, primes: tuple, n_limbs: int, scales: tuple,
                   direction: str, device: str, hyb: int | None = None,
                   outs: tuple = (_TILE_O, _TILE_O)):
    """The kernel's tables for one direction, as tensors on `device`, the
    planes of each pass packed for tiles of `outs` outputs (in launch
    order). With `hyb` (a parent size) the per-block tables are indexed by
    z = channel * nb + block, the shared ones by the channel."""
    tabs = _multi_tables(n, primes, n_limbs, scales, hyb)
    n1, n2 = tabs["n1"], tabs["n2"]
    planes1, cvec1, planes2, cvec2, diag = tabs[direction]
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)  # contraction per limb
    lead = 1 if hyb is None else 2
    l1, l2 = (lead, 1) if direction == "fwd" else (1, lead)  # A_b / Ainv_b are per block
    return {
        "planes1": _to_dev(pack_planes_kmajor(_flat_blocks(planes1, l1), k1, 4, outs[0]), device),
        "cvec1": _to_dev(_flat_blocks(cvec1, l1), device),
        "planes2": _to_dev(pack_planes_kmajor(_flat_blocks(planes2, l2), k2, 4, outs[1]), device),
        "cvec2": _to_dev(_flat_blocks(cvec2, l2), device),
        # [C * nb, 4, R, O]
        "diag": _to_dev(np.stack([_flat_blocks(d, lead) for d in diag], axis=1).view(np.int32),
                        device),
        "scal": _to_dev(np.stack([scalar_record(p) for p in primes]).view(np.int32), device),
    }


@lru_cache(maxsize=32)
def _hyb_tables(n: int, p: int, n_h: int, scale: int, direction: str, device: str,
                outs: tuple = (_TILE_O, _TILE_O)):
    """K2's block tables for one direction of the hybrid of (n, p, n_h): the
    per-block pass (A_b forward, A_inv,b times the scale inverse) and the
    per-block diagonal stacked over the block, the shared pass (F, G) and the
    scalar record once; each pass's planes packed for tiles of `outs`
    outputs (in launch order: per-block then shared forward, shared then
    per-block inverse)."""
    blocks, a, ainv = _block_mats(n_h, p, 1, scale, n)
    n1, n2 = mxu32.four_step_factors(n_h)  # the column operators contract n1, the row ones n2
    per_block, shared, diag = (a, blocks[0]["F"], "d") if direction == "fwd" else (
        ainv, blocks[0]["G"], "e")
    n_d = shared[1].shape[0]
    o_blk, o_sh = outs if direction == "fwd" else outs[::-1]
    return {
        "planes_blk": _to_dev(pack_planes_kmajor(np.stack([m[0] for m in per_block]), n1, n_d,
                                                 o_blk), device),
        "cvec_blk": _to_dev(np.stack([m[1] for m in per_block]), device),
        "planes_sh": _to_dev(pack_planes_kmajor(shared[0][None], n2, n_d, o_sh), device),
        "cvec_sh": _to_dev(shared[1], device),
        "diag": _to_dev(np.stack([np.stack(t[diag]) for t in blocks]), device),  # [nb, 4|2, R, O]
        "scal": _to_dev(scalar_record(p).view(np.int32), device),
        "n_d": n_d,
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
def _pass_tables(n: int, p: int, which: str, n_limbs: int, scale: int, device: str,
                 tile_o: int = _TILE_O):
    """One pass's packed planes (tiles of `tile_o` outputs), cvec and
    scalar record on `device`."""
    planes, cvec = _pass_mat(n, p, which, n_limbs, scale)
    k = planes.shape[0] // (4 * n_limbs)
    return {
        "planes": _to_dev(pack_planes_kmajor(planes[None], k, cvec.shape[0], tile_o), device),
        "cvec": _to_dev(cvec, device),
        "scal": _to_dev(scalar_record(p).view(np.int32), device),
        "k": k,
        "o": cvec.shape[1],
        "n_d": cvec.shape[0],
    }


@lru_cache(maxsize=64)
def _diag_tables(n: int, p: int, name: str, device: str) -> torch.Tensor:
    """The full diagonal d ([n2, n1]) or e ([n1, n2]) as [4 or 2, R, O] uint32."""
    return _to_dev(np.stack(mxu32._mxu_tables(n, p)[name]), device)


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _multi_pass_tables(n: int, primes: tuple, which: str, n_limbs: int, scales: tuple,
                       device: str, tile_o: int):
    """One pass's tables over C channels on `device`, the planes packed for
    tiles of `tile_o` outputs: planes [C, O / tile_o, stages, words], cvec
    [C, D, O], scalar records [C, 16] (every channel with one digit-plane
    count and regime)."""
    mats = [_pass_mat(n, p, which, n_limbs, s % p) for p, s in zip(primes, scales)]
    n_d = {m[1].shape[0] for m in mats}
    regimes = {regime(p) for p in primes}
    if len(n_d) != 1 or len(regimes) != 1:
        raise ValueError(f"the channel grid needs one digit-plane count and one regime for all "
                         f"channels, got {sorted(n_d)} and {sorted(regimes)} for {primes}")
    planes = np.stack([m[0] for m in mats])
    k = planes.shape[1] // (4 * n_limbs)
    return {
        "planes": _to_dev(pack_planes_kmajor(planes, k, n_d.pop(), tile_o), device),
        "cvec": _to_dev(np.stack([m[1] for m in mats]), device),
        "scal": _to_dev(np.stack([scalar_record(p) for p in primes]).view(np.int32), device),
        "k": k,
        "o": mats[0][1].shape[1],
        "n_d": mats[0][1].shape[0],
    }


@lru_cache(maxsize=64)
def multi_diag(n: int, primes: tuple, which: str, row0: int, rows: int,
               device: str) -> torch.Tensor:
    """Rows row0 .. row0 + rows of each channel's diagonal tables (d
    [n2, n1] for the A pass, e [n1, n2] for G), stacked [C, 4 or 2, rows,
    O] uint32 on `device`: a rank's rows, the `diag` of `pass_matmod_multi`."""
    name = {"A": "d", "G": "e"}[which]
    return _to_dev(np.stack([np.stack(mxu32._mxu_tables(n, p)[name])[:, row0:row0 + rows]
                             for p in primes]), device)


def _fwd_blocks(xs: tuple, p: int, n_h: int | None):
    """Four-step forward of carrier limbs [B, n] mod p: direct, or with `n_h`
    the n // n_h block transforms against the hybrid's block tables."""
    size, hyb = _tabs_args(xs[0].shape[-1], n_h)
    blocks, mat1, _ = _block_mats(size, p, len(xs), 1, hyb)
    outs = [mxu32._fwd_core(tuple(a[:, i * size:(i + 1) * size] for a in xs), tbl, m, p=p)
            for i, (tbl, m) in enumerate(zip(blocks, mat1))]
    return outs[0] if hyb is None else torch.cat(outs, dim=-1)


def _inv_blocks(x, p: int, scale: int, n_h: int | None):
    """Four-step inverse of a carrier [B, n] mod p times `scale`: direct, or
    the block inverses against the hybrid's block tables."""
    size, hyb = _tabs_args(x.shape[-1], n_h)
    blocks, _, mat2 = _block_mats(size, p, 1, scale % p, hyb)
    outs = [mxu32._inv_core(x[:, i * size:(i + 1) * size], tbl, m, p=p)
            for i, (tbl, m) in enumerate(zip(blocks, mat2))]
    return outs[0] if hyb is None else torch.cat(outs, dim=-1)


def _fwd_channels_plain(chan_limbs: list, primes: tuple, n_h: int | None = None) -> torch.Tensor:
    """Per channel, the single-channel four-step of ops/mxu32.py on that
    channel's u32-carrier limb tuple [B, n] (per block with `n_h`)."""
    return to_u32(torch.stack([_fwd_blocks(xs, p, n_h) for xs, p in zip(chan_limbs, primes)]))


def fwd_wide_multi_plain(limbs: tuple, primes: tuple) -> torch.Tensor:
    """Plain twin of K1a on the device of `limbs` (one operand, all channels)."""
    check_range(limbs[0].shape[-1], primes, len(limbs))
    xs = tuple(to_i64(a) for a in limbs)
    return _fwd_channels_plain([xs] * len(primes), primes)


def fwd_multi_perchannel_plain(limbs: tuple, primes: tuple,
                               n_h: int | None = None) -> torch.Tensor:
    """Plain twin of K1c on the device of `limbs`: [C, B, n] per limb, channel
    c transforms its own operand limbs[...][c]; with `n_h`, per block against
    the hybrid's block tables."""
    _check_multi(limbs[0].shape[-1], primes, len(limbs), n_h)
    xs = tuple(to_i64(a) for a in limbs)
    return _fwd_channels_plain([tuple(x[ch] for x in xs) for ch in range(len(primes))], primes,
                               n_h)


def inv_multi_plain(x: torch.Tensor, primes: tuple, scales: tuple,
                    n_h: int | None = None) -> torch.Tensor:
    """Plain twin of K1b on the device of `x` (per block with `n_h`)."""
    _check_multi(x.shape[-1], primes, 1, n_h)
    xi = to_i64(x)
    return to_u32(torch.stack([_inv_blocks(xi[ch], p, scales[ch], n_h)
                               for ch, p in enumerate(primes)]))


def pointwise_inv_multi_plain(fl: torch.Tensor, fr: torch.Tensor, primes: tuple,
                              scales: tuple, n_h: int | None = None) -> torch.Tensor:
    """Plain twin of K1d: per channel the Montgomery product of ops/u32.py
    (any u32 operands; the u32 overflow of the REDC sum is kept), then K1b's
    plain twin (per block with `n_h`: the product is elementwise, so it
    commutes with the block cut)."""
    _check_multi(fl.shape[-1], primes, 1, n_h)
    a, b = to_i64(fl), to_i64(fr)
    prod = torch.stack([mont_mul(a[ch], b[ch], p, mont_neginv(p)) for ch, p in enumerate(primes)])
    return inv_multi_plain(to_u32(prod), primes, scales, n_h)


def digit_planes32(x: torch.Tensor) -> torch.Tensor:
    """[..., B, n] uint32 (any representatives) -> [..., B, n1, 4 * n2] int8:
    the four xor-128 digit planes of each value of the [n1, n2] view,
    plane-major in the last axis (`mxu32_pallas.digit_planes32` :602). Plain
    torch on the device of x; the bytes are the kernel's digit words split
    over four planes, the same 4 bytes a value."""
    n = x.shape[-1]
    n1, n2 = mxu32.four_step_factors(n)
    v = to_i64(x).reshape(*x.shape[:-1], n1, n2)
    planes = [(((v >> (8 * e)) & 255) ^ 128).to(torch.uint8).view(torch.int8) for e in range(4)]
    return torch.cat(planes, dim=-1)


def _planes_to_u32(xd: torch.Tensor) -> torch.Tensor:
    """The u32 values [..., B, n] whose `digit_planes32` is xd."""
    n1, n2 = xd.shape[-2], xd.shape[-1] // 4
    d = (xd.view(torch.uint8).to(torch.int64) ^ 128).reshape(*xd.shape[:-1], 4, n2)
    v = d[..., 0, :] | (d[..., 1, :] << 8) | (d[..., 2, :] << 16) | (d[..., 3, :] << 24)
    return to_u32(v.reshape(*xd.shape[:-2], n1 * n2))


def inv_multi_presplit_plain(xd: torch.Tensor, primes: tuple, scales: tuple) -> torch.Tensor:
    """Plain twin of K1e: K1b's plain twin on the planes put back together."""
    return inv_multi_plain(_planes_to_u32(xd), primes, scales)


def fwd_plain(x: torch.Tensor, *, n: int, p: int) -> torch.Tensor:
    """Plain twin of K2 fwd: ops/mxu32.py's four-step on the device of x."""
    return fwd_wide_plain((x,), n=n, p=p)


def fwd_wide_plain(limbs: tuple, *, n: int, p: int) -> torch.Tensor:
    """Plain twin of K2 fwd_wide (1, 2 or 4 limbs)."""
    check_single_range(n, p, len(limbs))
    if len(limbs) == 1:
        return mxu32.fwd(limbs[0], n=n, p=p)
    return mxu32.fwd_wide(tuple(limbs), n=n, p=p)


def inv_plain(x: torch.Tensor, *, n: int, p: int, scale: int = 1) -> torch.Tensor:
    """Plain twin of K2 inv (scale folded into A_inv)."""
    check_single_range(n, p)
    return mxu32.inv(x, n=n, p=p, scale=scale)


def fwd_hyb_plain(x: torch.Tensor, *, n: int, p: int, n_h: int) -> torch.Tensor:
    """Plain twin of K2 with block tables, forward: the hybrid's n // n_h
    block transforms of [B, n], each `mxu32._fwd_core` against its block's
    tables."""
    check_hyb_range(n, n_h, p)
    return to_u32(_fwd_blocks((to_i64(x),), p, n_h))


def inv_hyb_plain(x: torch.Tensor, *, n: int, p: int, n_h: int, scale: int = 1) -> torch.Tensor:
    """Plain twin of K2 with block tables, inverse (scale folded into each
    block's A_inv)."""
    check_hyb_range(n, n_h, p)
    return to_u32(_inv_blocks(to_i64(x), p, scale, n_h))


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


def pass_layout(xs: tuple, channels: int) -> tuple:
    """The operand of a channel-grid pass (`pass_matmod_multi`, and
    `mxu64_cuda.pass_matmod64_multi` on limb pairs): limb views of one
    shape and strides, [B, rows, K] (one operand for every channel) or
    [C, B, rows, K] (one a channel), contracting K, read in place. Returns
    ((B, rows, K), (x_chan, x_b, s_r, s_k)) in elements, x_chan = 0 for a
    shared operand (a stride of an axis of size 1 counts as 0). The kernels
    copy 16-byte chunks in one of two layouts, and the rule is the same on
    every device: rows contiguous along the contraction (s_k = 1, s_r a
    multiple of 4), or four rows at a time (s_r = 1, s_k a multiple of 4,
    rows a multiple of 4); polynomial and channel strides multiples of 4.
    So a four-step's transpose is a view (`.transpose(-1, -2)` of the
    value shard), not a copy."""
    x0 = xs[0]
    if not all(isinstance(a, torch.Tensor) and a.dtype == torch.uint32 for a in xs):
        raise TypeError("operands must be uint32 tensors")
    if x0.dim() not in (3, 4) or any(a.shape != x0.shape or a.stride() != x0.stride()
                                     or a.device != x0.device for a in xs):
        raise ValueError("operand limbs must be views [B, rows, K] or [C, B, rows, K] of one "
                         f"shape and strides on one device, got {[tuple(a.shape) for a in xs]}")
    if x0.dim() == 4 and x0.shape[0] != channels:
        raise ValueError(f"operand has {x0.shape[0]} channels, expected {channels}")
    st = [0 if size == 1 else s for size, s in zip(x0.shape, x0.stride())]
    x_chan = st[0] if x0.dim() == 4 else 0
    x_b, s_r, s_k = st[-3:]
    rows = x0.shape[-2]
    fits = (s_r % 4 == 0 if s_k == 1 else s_r == 1 and s_k % 4 == 0 and rows % 4 == 0)
    if not (fits and x_b % 4 == 0 and x_chan % 4 == 0):
        raise ValueError(f"operand strides {tuple(x0.stride())} of {tuple(x0.shape)}: the pass "
                         "reads rows contiguous along K (row stride a multiple of 4) or four "
                         "rows at a time (K stride a multiple of 4), batch and channel strides "
                         "multiples of 4")
    return tuple(x0.shape[-3:]), (x_chan, x_b, s_r, s_k)


def _channel_views(xs: tuple, ch: int) -> tuple:
    """Channel ch's operand limbs as fresh contiguous tensors: the strided
    views of a channel-grid pass made explicit."""
    return tuple((a[ch] if a.dim() == 4 else a).contiguous() for a in xs)


def _check_multi_args(which: str, primes: tuple, diag, scales) -> tuple:
    if which not in ("A", "F", "G", "Ainv"):
        raise ValueError(f"which must be A, F, G or Ainv, got {which!r}")
    if diag is not None and which not in ("A", "G"):
        raise ValueError("only the A and G passes take diagonal rows (scaled-lazy epilogue)")
    if scales is None:
        return (1,) * len(primes)
    if which != "Ainv" or len(scales) != len(primes):
        raise ValueError("scales: one a channel, for the Ainv pass only")
    return tuple(scales)


def pass_matmod_multi_plain(x, *, n: int, primes: tuple, which: str, diag=None, scales=None,
                            transposed_out: bool = False) -> torch.Tensor:
    """Plain twin of K3's channel grid (`pass_matmod_multi`): per channel
    `pass_matmod_plain` on the operand's strided view made explicit (a
    fresh contiguous copy), with that channel's diagonal rows and scale;
    stacked [C, B, rows, O], or [C, B, O, rows] with `transposed_out`."""
    xs = tuple(x) if isinstance(x, tuple) else (x,)
    primes = tuple(primes)
    scales = _check_multi_args(which, primes, diag, scales)
    pass_layout(xs, len(primes))
    outs = []
    for ch, p in enumerate(primes):
        xc = _channel_views(xs, ch)
        dg = tuple(diag[ch]) if diag is not None else ()
        outs.append(pass_matmod_plain(xc if len(xc) > 1 else xc[0], n=n, p=p, which=which,
                                      diag_slices=dg, n_limbs=len(xc), scale=scales[ch]))
    out = torch.stack(outs)
    return out.transpose(-1, -2).contiguous() if transposed_out else out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu32_multi")
    if not lib.k1a_fwd_wide_multi.argtypes:
        lib.k1a_fwd_wide_multi.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_P] * 9]
        lib.k1a_fwd_wide_multi.restype = ctypes.c_int
        lib.k1b_inv_multi.argtypes = [_P, _I, _I, _I, _I, _I, *[_P] * 9]
        lib.k1b_inv_multi.restype = ctypes.c_int
        lib.k1e_inv_multi_presplit.argtypes = [_P, *[_I] * 6, *[_P] * 9]
        lib.k1e_inv_multi_presplit.restype = ctypes.c_int
        lib.k1c_fwd_multi_perchannel.argtypes = [_P, _P, *[_I] * 8, *[_P] * 9]
        lib.k1c_fwd_multi_perchannel.restype = ctypes.c_int
        lib.k1d_pointwise_inv_multi.argtypes = [_P, _P, *[_I] * 7, *[_P] * 9]
        lib.k1d_pointwise_inv_multi.restype = ctypes.c_int
        lib.k1_smem_bytes.argtypes = [_I, _I]
        lib.k1_smem_bytes.restype = ctypes.c_int
    return lib


def _pass_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mxu32_pass")
    if not lib.k2_fwd.argtypes:
        lib.k2_fwd.argtypes = [_P] * 8
        lib.k2_fwd.restype = ctypes.c_int
        lib.k2_inv.argtypes = [_P] * 5
        lib.k2_inv.restype = ctypes.c_int
        lib.k3_pass.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_P] * 4, _I, _I, _I,
                                _P, _P]
        lib.k3_pass.restype = ctypes.c_int
        lib.k3_pass_multi.argtypes = [_P] * 8
        lib.k3_pass_multi.restype = ctypes.c_int
        lib.k_pass_smem_bytes.argtypes = [_I, _I]
        lib.k_pass_smem_bytes.restype = ctypes.c_int
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


def _addrs16(*tensors, names: str = "") -> list:
    """Data addresses of tensors the GEMM passes copy in 16-byte chunks,
    each checked to start on a 16-byte boundary. `names`, one word a
    tensor, names the misaligned tensor in the error."""
    labels = names.split() or ["kernel operands"] * len(tensors)
    for label, t in zip(labels, tensors, strict=True):
        if t.data_ptr() % 16:
            raise ValueError(f"{label} must start on a 16-byte boundary (the GEMM pass "
                             "copies 16-byte chunks): pass a fresh or cloned tensor")
    return [t.data_ptr() for t in tensors]


def _ptrs16(*tensors, names: str = ""):
    """`_ptrs` for the GEMM passes: contiguous and 16-byte aligned (`_addrs16`)."""
    _addrs16(*tensors, names=names)
    return _ptrs(*tensors)


def _limb_ptrs(limbs: tuple) -> list:
    """Four limb pointers for the kernels' entry points: those past the
    operand's limbs alias limb 0 and are not read."""
    return _ptrs16(*limbs) + [limbs[0].data_ptr()] * (4 - len(limbs))


def _count(name: str, n_limbs: int) -> None:
    LAUNCHES[name + "_u128" if n_limbs == 4 else name] += 1


def fwd_wide_multi(limbs: tuple, primes: tuple) -> torch.Tensor:
    """K1a: all CRT channels' forward NTTs. [B, n] uint32 limb tuple (1, 2
    or 4 little-endian limbs, any values) -> [C, B, n] uint32 canonical
    NTT-domain residues (bit-reversed order)."""
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
    ptrs = _ptrs16(tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                   tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    err = call(dev, _lib().k1a_fwd_wide_multi, *_limb_ptrs(limbs), len(limbs), b, n1, n2,
               len(primes), *ptrs)
    _count("fwd_wide_multi", len(limbs))
    if err != 0:
        raise RuntimeError(f"K1a fwd_wide_multi launch failed: CUDA error {err}")
    return out


def _tabs_args(n: int, n_h: int | None) -> tuple:
    """(transform size, hyb) of the table functions for an operand of last
    axis n: direct, or n_h-blocks of a parent transform of size n."""
    return (n, None) if n_h is None else (n_h, n)


def _hyb_name(name: str, n_h: int | None) -> str:
    return name if n_h is None else name + "_hyb"


def inv_multi(x: torch.Tensor, primes: tuple, scales: tuple,
              n_h: int | None = None) -> torch.Tensor:
    """K1b: all channels' scaled inverse NTTs. [C, B, n] uint32 (any
    representatives) -> [C, B, n] uint32 canonical, standard order. With
    `n_h`, the n // n_h block inverses of the stage-split hybrid of a parent
    transform of size n: the result is the input of its suffix stages."""
    dev = _check_operands((x,), 3)
    primes, scales = tuple(primes), tuple(scales)
    if x.shape[0] != len(primes) or len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {x.shape[0]}")
    if dev.type == "cpu":
        return inv_multi_plain(x, primes, scales, n_h)
    _, b, n = x.shape
    _check_multi(n, primes, 1, n_h)
    size, hyb = _tabs_args(n, n_h)
    tabs = _kernel_tables(size, primes, 1, scales, "inv", str(dev), hyb)
    n1, n2 = mxu32.four_step_factors(size)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    ptrs = _ptrs16(x, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                   tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    err = call(dev, _lib().k1b_inv_multi, ptrs[0], b, n1, n2, n // size, len(primes), *ptrs[1:])
    LAUNCHES[_hyb_name("inv_multi", n_h)] += 1
    if err != 0:
        raise RuntimeError(f"K1b inv_multi launch failed: CUDA error {err}")
    return out


def inv_multi_presplit(xd: torch.Tensor, primes: tuple, scales: tuple) -> torch.Tensor:
    """K1e: K1b from pre-split digit planes. xd [C, B, n1, 4 * n2] int8 (the
    output of `digit_planes32`) -> [C, B, n] uint32 canonical, standard
    order: bit-identical to `inv_multi(x)` for xd = digit_planes32(x)."""
    if not isinstance(xd, torch.Tensor) or xd.dtype != torch.int8 or xd.dim() != 4:
        raise TypeError("expected int8 digit planes [C, B, n1, 4 * n2]")
    if xd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {xd.device}: use cuda or cpu")
    primes, scales = tuple(primes), tuple(scales)
    c, b, n1, four_n2 = xd.shape
    n = n1 * (four_n2 // 4)
    if four_n2 % 4 or (n1, four_n2 // 4) != mxu32.four_step_factors(n):
        raise ValueError(f"planes {tuple(xd.shape)} are not [C, B, n1, 4 * n2] of a four-step split")
    if c != len(primes) or len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} channels and scales, got {c}, {len(scales)}")
    if xd.device.type == "cpu":
        return inv_multi_presplit_plain(xd, primes, scales)
    check_range(n, primes)
    dev = xd.device
    tiles = _k1e_tiles(b, n, c)
    tabs = _kernel_tables(n, primes, 1, scales, "inv", str(dev), None, _tile_outs(tiles))
    out = torch.empty((c, b, n), dtype=torch.uint32, device=dev)
    scratch = torch.empty_like(out)
    ptrs = _ptrs16(xd, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                   tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out,
                   names="xd planes1 cvec1 planes2 cvec2 diag scal scratch out")
    err = call(dev, _lib().k1e_inv_multi_presplit, ptrs[0], b, n1, four_n2 // 4, c, *tiles,
               *ptrs[1:])
    _count_tiles("inv_multi_presplit", tiles)
    if err != 0:
        raise RuntimeError(f"K1e inv_multi_presplit launch failed: CUDA error {err}")
    return out


def _tile_outs(tiles: tuple) -> tuple:
    """Outputs a block of each pass's tile: how `_kernel_tables` packs its planes."""
    return tuple(TILES[t][1] for t in tiles)


def _count_tiles(name: str, tiles: tuple) -> None:
    LAUNCHES[name] += 1
    TILE_LAUNCHES[(name, *tiles)] = TILE_LAUNCHES.get((name, *tiles), 0) + 1


def _check_channels(x: torch.Tensor, primes: tuple) -> None:
    if x.shape[0] != len(primes):
        raise ValueError(f"expected {len(primes)} channels, got {tuple(x.shape)}")


def fwd_multi_perchannel(x: torch.Tensor, primes: tuple,
                         n_h: int | None = None) -> torch.Tensor:
    """K1c: all channels' forward NTTs of per-channel operands. x [C, B, n]
    uint32 (any values) -> [C, B, n] canonical, bit-reversed order. With
    `n_h`, n is a parent transform's size and the n // n_h blocks take the
    stage-split hybrid's block tables: the operand is the hybrid's
    per-channel prefix output, the result the forward NTT of size n."""
    return _fwd_perchannel((x,), tuple(primes), n_h)


def fwd_wide_multi_perchannel(x_lo: torch.Tensor, x_hi: torch.Tensor,
                              primes: tuple, n_h: int | None = None) -> torch.Tensor:
    """K1c with two limbs: (lo, hi) [C, B, n] u64 values per channel ->
    [C, B, n] canonical NTT-domain residues (value mod p folded into the
    column matmul, as K1a's). With `n_h`, the hybrid's blocks (the wide A_b
    of `stagesplit._wide_block_planes32`)."""
    return _fwd_perchannel((x_lo, x_hi), tuple(primes), n_h)


def _fwd_perchannel(limbs: tuple, primes: tuple, n_h: int | None) -> torch.Tensor:
    dev = _check_operands(limbs, 3)
    _check_channels(limbs[0], primes)
    if dev.type == "cpu":
        return fwd_multi_perchannel_plain(limbs, primes, n_h)
    c, b, n = limbs[0].shape
    _check_multi(n, primes, len(limbs), n_h)
    size, hyb = _tabs_args(n, n_h)
    tiles = _k1_tiles(b, size, c * (n // size), len(limbs), "fwd")
    tabs = _kernel_tables(size, primes, len(limbs), (1,) * c, "fwd", str(dev), hyb,
                          _tile_outs(tiles))
    n1, n2 = mxu32.four_step_factors(size)
    out = torch.empty((c, b, n), dtype=torch.uint32, device=dev)
    scratch = torch.empty_like(out)
    x1 = limbs[1] if len(limbs) > 1 else limbs[0]
    ptrs = _ptrs16(limbs[0], x1, tabs["planes1"], tabs["cvec1"], tabs["planes2"],
                   tabs["cvec2"], tabs["diag"], tabs["scal"], scratch, out)
    err = call(dev, _lib().k1c_fwd_multi_perchannel, ptrs[0], ptrs[1], len(limbs), b, n1, n2,
               n // size, c, *tiles, *ptrs[2:])
    _count_tiles(_hyb_name("fwd_multi_perchannel", n_h), tiles)
    if err != 0:
        raise RuntimeError(f"K1c fwd_multi_perchannel launch failed: CUDA error {err}")
    return out


def pointwise_inv_multi(fl: torch.Tensor, fr: torch.Tensor, primes: tuple,
                        scales: tuple, n_h: int | None = None) -> torch.Tensor:
    """K1d: all channels' Montgomery product fl*fr*2^-32 mod p (fl, fr
    [C, B, n] uint32, any representatives) and scaled inverse NTT in one
    kernel -> [C, B, n] canonical, standard order. With scale n^-1 * 2^32
    mod p the result is the normalized inverse of the product. With `n_h`,
    the block inverses of the stage-split hybrid."""
    dev = _check_operands((fl, fr), 3)
    primes, scales = tuple(primes), tuple(scales)
    _check_channels(fl, primes)
    if len(scales) != len(primes):
        raise ValueError(f"expected {len(primes)} scales, got {len(scales)}")
    if dev.type == "cpu":
        return pointwise_inv_multi_plain(fl, fr, primes, scales, n_h)
    c, b, n = fl.shape
    _check_multi(n, primes, 1, n_h)
    size, hyb = _tabs_args(n, n_h)
    tiles = _k1_tiles(b, size, c * (n // size), 1, "inv")
    tabs = _kernel_tables(size, primes, 1, scales, "inv", str(dev), hyb, _tile_outs(tiles))
    n1, n2 = mxu32.four_step_factors(size)
    out = torch.empty_like(fl)
    scratch = torch.empty_like(fl)
    ptrs = _ptrs16(fl, fr, tabs["planes1"], tabs["cvec1"], tabs["planes2"], tabs["cvec2"],
                   tabs["diag"], tabs["scal"], scratch, out)
    err = call(dev, _lib().k1d_pointwise_inv_multi, ptrs[0], ptrs[1], b, n1, n2, n // size, c,
               *tiles, *ptrs[2:])
    _count_tiles(_hyb_name("pointwise_inv_multi", n_h), tiles)
    if err != 0:
        raise RuntimeError(f"K1d pointwise_inv_multi launch failed: CUDA error {err}")
    return out


class K2Args(ctypes.Structure):
    """The fixed arguments of a K2 launch pair (`K2Args` of
    csrc/mxu32_pass.cu, the same fields in the same order): tables, shape,
    digit planes, regime and each pass's tile code."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("planes1", "cvec1", "planes2", "cvec2", "diag",
                                               "scal")] + [
        (f, ctypes.c_int) for f in ("n_limbs", "batch", "n1", "n2", "nb", "n_d", "regime",
                                    "tile1", "tile2")]


def _k2_record(tabs: tuple, n_d: int, p: int, n_limbs: int, b: int, n: int, nb: int,
               tiles: tuple) -> tuple:
    """(address of a K2Args record, the record, the tables it points into)
    for `_k2_launch` / `_k2h_launch`: the tables are checked once here."""
    n1, n2 = mxu32.four_step_factors(n)
    rec = K2Args(*_ptrs16(*tabs), n_limbs, b, n1, n2, nb, n_d, regime(p), *tiles)
    return ctypes.addressof(rec), rec, tabs


def _k2_tiles(b: int, n: int, direction: str) -> tuple:
    """Tile codes of K2's two passes in launch order: the column pass (B·n2
    rows, n1 outputs) then the row pass (B·n1 rows, n2 outputs) forward,
    the other order inverse."""
    n1, n2 = mxu32.four_step_factors(n)
    shapes = ((b * n2, n1), (b * n1, n2))
    return tuple(k2_tile(r, o) for r, o in (shapes if direction == "fwd" else shapes[::-1]))


@lru_cache(maxsize=64)
def _k2_launch(n: int, p: int, n_limbs: int, scale: int, direction: str, device: str, b: int):
    """K2's fixed launch arguments for one direction, table set and batch:
    both passes' tables packed for the tiles `_k2_tiles` picks, the diagonal,
    and their K2Args record (`_k2_record`)."""
    first, second = ("A", "F") if direction == "fwd" else ("G", "Ainv")
    tiles = _k2_tiles(b, n, direction)
    t1 = _pass_tables(n, p, first, n_limbs, 1, device, TILES[tiles[0]][1])
    t2 = _pass_tables(n, p, second, 1, scale if direction == "inv" else 1, device,
                      TILES[tiles[1]][1])
    diag = _diag_tables(n, p, "d" if direction == "fwd" else "e", device)
    tabs = (t1["planes"], t1["cvec"], t2["planes"], t2["cvec"], diag, t1["scal"])
    return _k2_record(tabs, t1["n_d"], p, n_limbs, b, n, 1, tiles)


def fwd_wide(limbs: tuple, *, n: int, p: int) -> torch.Tensor:
    """K2 fwd: one prime's forward NTT of a [B, n] uint32 limb tuple (1, 2 or
    4 limbs, any values) -> [B, n] canonical, bit-reversed order."""
    limbs = tuple(limbs)
    dev = _check_operands(limbs, 2)
    _check_n(limbs[0], n)
    if dev.type == "cpu":
        return fwd_wide_plain(limbs, n=n, p=p)
    check_single_range(n, p, len(limbs))
    b = limbs[0].shape[0]
    out = torch.empty((b, n), dtype=torch.uint32, device=dev)
    if b == 0:
        return out
    rec = _k2_launch(n, p, len(limbs), 1, "fwd", str(dev), b)[0]
    scratch = torch.empty_like(out)  # out and scratch: fresh, so aligned
    err = call(dev, _pass_lib().k2_fwd, rec, *_limb_ptrs(limbs), scratch.data_ptr(),
               out.data_ptr())
    _count("fwd", len(limbs))
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
    out = torch.empty_like(x)
    if b == 0:
        return out
    rec = _k2_launch(n, p, 1, scale % p, "inv", str(dev), b)[0]
    scratch = torch.empty_like(x)
    err = call(dev, _pass_lib().k2_inv, rec, *_ptrs16(x), scratch.data_ptr(), out.data_ptr())
    LAUNCHES["inv"] += 1
    if err != 0:
        raise RuntimeError(f"K2 inv launch failed: CUDA error {err}")
    return out


@lru_cache(maxsize=32)
def _k2h_launch(n: int, p: int, n_h: int, scale: int, direction: str, device: str, b: int,
                tiles: tuple):
    """K2's fixed launch arguments with block tables (`_hyb_tables` packed
    for the tiles of codes `tiles`), as `_k2_launch`."""
    t = _hyb_tables(n, p, n_h, scale, direction, device, _tile_outs(tiles))
    first, second = ("blk", "sh") if direction == "fwd" else ("sh", "blk")
    tabs = (t["planes_" + first], t["cvec_" + first], t["planes_" + second],
            t["cvec_" + second], t["diag"], t["scal"])
    return _k2_record(tabs, t["n_d"], p, 1, b, n_h, n // n_h, tiles)


def _hyb(name: str, x: torch.Tensor, n: int, p: int, n_h: int, scale: int) -> torch.Tensor:
    """Launch K2 with block tables in one direction on a checked CUDA
    operand [B, n]: n // n_h block transforms of size n_h."""
    fwd_dir = name == "fwd_hyb"
    direction = "fwd" if fwd_dir else "inv"
    b = x.shape[0]
    out = torch.empty_like(x)
    if b == 0:
        return out
    tiles = k2h_tiles(b, n, n_h, direction, mxu32._n_dplanes32(p))
    rec = _k2h_launch(n, p, n_h, scale, direction, str(x.device), b, tiles)[0]
    scratch = torch.empty_like(x)
    ptrs = (*_ptrs16(x), scratch.data_ptr(), out.data_ptr())
    if fwd_dir:
        err = call(x.device, _pass_lib().k2_fwd, rec, *_limb_ptrs((x,)), *ptrs[1:])
    else:
        err = call(x.device, _pass_lib().k2_inv, rec, *ptrs)
    _count_tiles(name, tiles)
    if err != 0:
        raise RuntimeError(f"K2 {name} launch failed: CUDA error {err}")
    return out


def fwd_hyb(x: torch.Tensor, *, n: int, p: int, n_h: int) -> torch.Tensor:
    """K2 with block tables, forward: the n // n_h block transforms of the
    32-bit stage-split hybrid of (n, p) in one launch pair. [B, n] uint32,
    the output of the hybrid's prefix stages (any u32) -> [B, n] canonical:
    the forward NTT of size n in bit-reversed order."""
    dev = _check_operands((x,), 2)
    _check_n(x, n)
    if dev.type == "cpu":
        return fwd_hyb_plain(x, n=n, p=p, n_h=n_h)
    check_hyb_range(n, n_h, p)
    return _hyb("fwd_hyb", x, n, p, n_h, 1)


def inv_hyb(x: torch.Tensor, *, n: int, p: int, n_h: int, scale: int = 1) -> torch.Tensor:
    """K2 with block tables, inverse: the block inverses of the hybrid of
    (n, p), `scale` folded into each block's A_inv. [B, n] uint32 (any u32,
    bit-reversed) -> [B, n] canonical: the input of the hybrid's suffix
    stages."""
    dev = _check_operands((x,), 2)
    _check_n(x, n)
    if dev.type == "cpu":
        return inv_hyb_plain(x, n=n, p=p, n_h=n_h, scale=scale)
    check_hyb_range(n, n_h, p)
    return _hyb("inv_hyb", x, n, p, n_h, scale % p)


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
    dg = diag if diag is not None else tabs["scal"]  # not read by a canonical pass
    ptrs = _ptrs16(tabs["planes"], tabs["cvec"], dg, tabs["scal"], out)
    err = call(dev, _pass_lib().k3_pass, *_limb_ptrs(xs), len(xs), b, rows, k, tabs["o"],
               *ptrs[:4], tabs["n_d"], regime(p), int(diag is not None), ptrs[4])
    _count("pass_matmod", len(xs))
    if err != 0:
        raise RuntimeError(f"K3 pass_matmod launch failed: CUDA error {err}")
    return out


class K3MultiArgs(ctypes.Structure):
    """The fixed arguments of a `k3_pass_multi` launch (`K3MultiArgs` of
    csrc/mxu32_pass.cu, the same fields in the same order): tables,
    strides, shape, digit planes, regime, epilogue and tile code."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("planes", "cvec", "scal")]
                + [(f, ctypes.c_longlong) for f in ("x_chan", "x_b", "out_chan", "out_b")]
                + [(f, ctypes.c_int) for f in ("n_limbs", "channels", "batch", "rows", "k1", "o",
                                               "s_k", "s_r", "t_r", "t_o", "n_d", "regime",
                                               "scaled", "tile")])


def k3_multi_tile(b: int, rows: int, o: int, channels: int, stages: int, scaled: bool,
                  n_d: int) -> int:
    """The tile code of a `pass_matmod_multi` launch: `k1_tile` over its
    B·rows operand rows, o outputs and `channels` grids, "scaled" for the
    A / G passes with diagonal rows, "canonical" otherwise."""
    return k1_tile(b * rows, o, channels, stages, "scaled" if scaled else "canonical", n_d)


@lru_cache(maxsize=128)
def _k3m_launch(n: int, primes: tuple, which: str, n_limbs: int, scales: tuple, device: str,
                b: int, rows: int, strides: tuple, transposed_out: bool, scaled: bool):
    """(address of the K3MultiArgs record, the record, its tables) of one
    table set, batch, operand layout and output layout."""
    planes, cvec = _pass_mat(n, primes[0], which, n_limbs, 1)
    k, (n_d, o) = planes.shape[0] // (4 * n_limbs), cvec.shape
    tile = k3_multi_tile(b, rows, o, len(primes), n_limbs * k // _STAGE_K, scaled, n_d)
    tabs = _multi_pass_tables(n, primes, which, n_limbs, scales, device, TILES[tile][1])
    x_chan, x_b, s_r, s_k = strides
    t_r, t_o = (1, rows) if transposed_out else (o, 1)
    rec = K3MultiArgs(*_ptrs16(tabs["planes"], tabs["cvec"], tabs["scal"]), x_chan, x_b,
                      b * rows * o, rows * o, n_limbs, len(primes), b, rows, k, o, s_k, s_r,
                      t_r, t_o, n_d, regime(primes[0]), int(scaled), tile)
    return ctypes.addressof(rec), rec, tabs


def pass_matmod_multi(x, *, n: int, primes: tuple, which: str, diag=None, scales=None,
                      transposed_out: bool = False) -> torch.Tensor:
    """K3 on a channel grid: one exact modular GEMM pass over C channels in
    one launch (`csrc/mxu32_pass.cu` `k3_pass_multi`). x: uint32 views
    [B, rows, K] (every channel's operand: the A pass's value limbs) or
    [C, B, rows, K], a limb tuple (1, 2 or 4 limbs) for the wide A pass, in
    either layout of `pass_layout` (a transposed view reads in place);
    contracting K -> [C, B, rows, O] uint32, or its transpose [C, B, O,
    rows] written directly with `transposed_out`. which in {A, F, G,
    Ainv}; `diag`: the A / G pass's diagonal rows [C, 4 or 2, rows, O]
    (`multi_diag`) for the scaled-lazy epilogue, else canonical; `scales`:
    one a channel, multiplying the Ainv pass's matrix. Channel c computes
    `pass_matmod` of its view with its prime, rows and scale. The tile is
    `k3_multi_tile`'s; a launch counts under "pass_matmod_multi" (four
    limbs: "pass_matmod_multi_u128"). A CPU tensor takes the plain twin."""
    xs = tuple(x) if isinstance(x, tuple) else (x,)
    primes = tuple(primes)
    scs = _check_multi_args(which, primes, diag, scales)
    (b, rows, k), strides = pass_layout(xs, len(primes))
    dev = xs[0].device
    if diag is not None and (diag.dtype != torch.uint32 or diag.device != dev
                             or not diag.is_contiguous()):
        raise ValueError("diag must be a contiguous uint32 tensor on the operand's device")
    if dev.type == "cpu":
        return pass_matmod_multi_plain(xs, n=n, primes=primes, which=which, diag=diag,
                                       scales=scales, transposed_out=transposed_out)
    if dev.type != "cuda":
        raise ValueError(f"no route for tensors on {dev}: use cuda or cpu")
    for p in primes:
        check_single_range(n, p, len(xs))
    scales = tuple(s % p for s, p in zip(scs, primes))
    addr, rec, tabs = _k3m_launch(n, primes, which, len(xs), scales, str(dev), b, rows, strides,
                                  transposed_out, diag is not None)
    if k != rec.k1:
        raise ValueError(f"pass {which} at n={n} contracts {rec.k1} values, got {k}")
    o = rec.o
    if diag is not None and tuple(diag.shape) != (len(primes), 2 if rec.regime == 2 else 4,
                                                  rows, o):
        raise ValueError(f"diag must be [C, 4 or 2, {rows}, {o}], got {tuple(diag.shape)}")
    out = torch.empty((len(primes), b, o, rows) if transposed_out else (len(primes), b, rows, o),
                      dtype=torch.uint32, device=dev)
    if b == 0:
        return out  # nothing to compute; an empty grid is not a valid launch
    dg = diag if diag is not None else tabs["scal"]  # not read by a canonical pass
    err = call(dev, _pass_lib().k3_pass_multi, addr,
               *_addrs16(*xs, names=" ".join(f"x{i}" for i in range(len(xs)))),
               *[xs[0].data_ptr()] * (4 - len(xs)), *_ptrs16(dg, names="diag"), out.data_ptr())
    _count_tiles("pass_matmod_multi_u128" if len(xs) == 4 else "pass_matmod_multi",
                 (rec.tile,))
    if err != 0:
        raise RuntimeError(f"K3 pass_matmod_multi launch failed: CUDA error {err}")
    return out


class _PassesEngine:
    """The JAX package's mid-size engine: on the card K2 serves these sizes
    whole, so its entries are K2's (and their plain twins on the CPU)."""

    fwd = staticmethod(fwd)
    fwd_wide = staticmethod(fwd_wide)
    inv = staticmethod(inv)


passes_engine = _PassesEngine()
