"""A numpy model of the port's two tensor-core GEMM passes
(`concrete_ntt_tpu_torch/csrc/matmod_pass.cuh`, 32-bit, and
`csrc/matmod64_pass.cuh`, 64-bit) against the dense digit GEMM of the JAX
package's math.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). What can be
checked here is their data layout: which operand word each lane hands to
`wgmma.mma_async.sync.aligned.m64nNk32.s32.s8.s8` as its A registers, where
the descriptor finds each byte of B in the K-major plane tile that
`mxu32_cuda.pack_planes_kmajor` (or `mxu64_cuda.pack_planes64` on top of it)
packs and the kernel copies as it is, and which (row, output, digit) each
accumulator register becomes in the epilogue. The model follows the
kernels' tiling (128 rows x TO outputs a block, TO = 32 in the 32-bit pass
and 16 in the 64-bit one, two warpgroups of 64 rows, N = TO * D columns:
digit d of output j at column TO d + j, the same offset in every digit;
k-steps of 8 words, four a stage) and the PTX layouts of m64nNk32 s8 (g =
lane / 4, t = lane % 4; warp w of a group: A registers rows 16w + g / + 8,
words t / t + 4; D register 4i + q row 16w + g + 8 (q / 2), column 8i + 2t +
q % 2; B byte (column n, byte k) at start + (n / 8) SBO + (k / 16) LBO +
(n % 8) 16 + k % 16 without swizzle). Driven over the port's packed tables
at n = 2^11 and 2^12 it must reproduce the int8 digit GEMM exactly: of
ops/mxu32.py in 32 bits, and of the JAX package's `ops/mxu64.py` planes in
64 bits, one prime per matrix digit-plane count D = 5..9, with two and four
operand limbs and the zero plane rows that pad a mid-pass operand's 6 or 7
planes to 8; and the single-prime K2's smaller tile (`mxu32_cuda.TILES`
code 1: 64 rows x 16 outputs a block, N = 64 with four digit planes and 80
with five) from 2^11 to 2^14, over planes packed by `pack_planes_kmajor(...,
tile_o=16)`, K1c / K1d's 64-output tile (128 rows x 64 outputs, N =
256) over planes packed with tile_o = 64, and the 64-bit pass's 64-row tile
(`mxu64_cuda.TILE_ROWS` code 1, K6's channel grid: one warpgroup, N = 16 kD)
for D = 5..9. The packed tiles must unpack to
the JAX package's planes, and the shared-memory reads of both operand
layouts (strided rows at 128 + 8 and 64 + 8 words) must fall on 32
different banks, K1d's second operand slot too. K1d's pointwise stage is
modelled where the kernel takes it: mont_mul of the two slots' words at the
A-fragment read, held against the port's plain mont_mul (REDC sums that
overflow u32 included) and, stage by stage, through K1b's plain twin
against `pointwise_inv_multi_plain`. `mxu32_cuda.k1_tile`'s codes at the
product plan's shapes are pinned. Tolerance: exact equality.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import mxu64 as jmx64
from concrete_ntt_tpu.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import u32 as tu32
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.ops import mxu64_cuda as tcu64
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

# the kernels' tile constants: rows a block and words a ring stage (both
# passes), outputs a block by word size (kTO of each .cuh)
TM, KC = 128, 32
TILE_O = {32: 32, 64: 16}
A_ROW, A_WORD = KC + 4, TM + 8  # word strides of the two operand layouts (both passes)
LBO, SBO = 128, 1024            # the plane descriptor's byte offsets (K, N)
XOR = np.uint32(0x80808080)
GENERIC = 4293918721  # five matrix digit planes
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
# one 64-bit prime per matrix digit-plane count (2^16 | p - 1: NTT primes to n = 2^15)
P64 = {5: _lp(1 << 16, 1, 1 << 33, 1 << 39), 6: _lp(1 << 16, 1, 1 << 40, 1 << 47),
       7: PRIMES52[0], 8: _lp(1 << 16, 1, 1 << 61, 1 << 62), 9: GOLDILOCKS}


def _bytes(words: np.ndarray) -> np.ndarray:
    """int32 / uint32 words [...] -> their four bytes as int64 [..., 4]."""
    return np.ascontiguousarray(words).view(np.int8).reshape(*words.shape, 4).astype(np.int64)


# A of m64nNk32 s8 from registers: A[16w + row, k] is byte k % 4 of register
# (row >= 8) + 2 (k >= 16) of lane (row % 8) * 4 + (k % 16) // 4 of warp w
_ROW, _K = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
A_LANE, A_REG = (_ROW % 8) * 4 + (_K % 16) // 4, (_ROW >= 8) + 2 * (_K >= 16)
A_BYTE = _K % 4


def _b_offsets(n: int) -> np.ndarray:
    """[n, 32] byte offsets of B (column, byte k of a k-step) from the
    descriptor's start, K-major without swizzle."""
    col, k = np.meshgrid(np.arange(n), np.arange(32), indexing="ij")
    return (col // 8) * SBO + (k // 16) * LBO + (col % 8) * 16 + k % 16


def _model_pass(x: np.ndarray, tiles: np.ndarray, n_d: int, to: int, tm: int = TM) -> np.ndarray:
    """The kernel's contraction of one channel: operand words x [rows, kw]
    (limb-major u32 values), packed plane tiles [O/to, kw/32, n_d*to*32]
    -> accumulators [rows, n_d * O] (digit d of output j at column d * O +
    j), through the registers each lane holds; tm rows a block (tm / 64
    warpgroups)."""
    rows, kw = x.shape
    n_ot = tiles.shape[0]
    n = n_d * to
    pad = -rows % tm
    xp = np.concatenate([x, np.zeros((pad, kw), np.uint32)])  # zero-filled rows past the edge
    acc = np.zeros((rows + pad, n_d * to * n_ot), np.int64)
    boff = _b_offsets(n)
    for r0 in range(0, rows + pad, tm):
        for ot in range(n_ot):
            tile_bytes = tiles[ot].view(np.int8).reshape(kw // KC, -1).astype(np.int64)
            for wg in range(tm // 64):
                d = np.zeros((4, 32, n // 2), np.int64)  # [warp][lane][register]
                for kt in range(kw // KC):
                    for ks in range(KC // 8):
                        k8 = kt * KC + 8 * ks
                        r = r0 + wg * 64 + 16 * np.arange(4)[:, None] + G  # [warp, lane]
                        regs = np.stack([xp[r, k8 + T], xp[r + 8, k8 + T], xp[r, k8 + T + 4],
                                         xp[r + 8, k8 + T + 4]], axis=-1) ^ XOR
                        a = _bytes(regs)[:, A_LANE, A_REG, A_BYTE].reshape(64, 32)
                        b = tile_bytes[kt][64 * 4 * ks + boff]  # start: 256 bytes a k-step
                        prod = a @ b.T                           # [64, n]
                        for q in range(4):
                            rr = 16 * np.arange(4)[:, None] + G + 8 * (q // 2)
                            cc = 8 * np.arange(n // 8)[None, :] + (2 * T + q % 2)[:, None]
                            d[:, :, q::4] += prod[rr[:, :, None], cc[None]]
                # the epilogue's map: register 4 (dd * to / 8 + jj) + 2 hr + cc of lane
                # (g, t) is row 16w + g + 8 hr, output 8 jj + 2t + cc, digit dd
                for w in range(4):
                    for dd in range(n_d):
                        for jj in range(to // 8):
                            for q in range(4):
                                rr = r0 + wg * 64 + 16 * w + G + 8 * (q // 2)
                                oo = ot * to + 8 * jj + 2 * T + q % 2
                                acc[rr, dd * to * n_ot + oo] = d[w, :, 4 * (dd * to // 8 + jj) + q]
    return acc[:rows]


def _dense(x: np.ndarray, planes: np.ndarray, n_limbs: int) -> np.ndarray:
    """ops/mxu32.py's digit GEMM: digit planes of the limbs @ int8 planes."""
    k = x.shape[1] // n_limbs
    limbs = tuple(torch.from_numpy(x[:, l * k:(l + 1) * k].astype(np.int64)) for l in range(n_limbs))
    digits = tmx._digit_cat(limbs if n_limbs > 1 else limbs[0])
    return digits.numpy().astype(np.int64) @ planes.astype(np.int64)


def _dense64(x: np.ndarray, planes: np.ndarray, n_limbs: int) -> np.ndarray:
    """The JAX package's 64-bit digit GEMM (ops/mxu64.py `_digit_cat`,
    `_dot`): the E = planes' rows / k operand digit planes of the limbs
    (E < 4 * n_limbs skips the top bytes) @ int8 planes."""
    k = x.shape[1] // n_limbs
    n_e = planes.shape[0] // k
    limbs = tuple(jnp.asarray(x[:, l * k:(l + 1) * k]) for l in range(n_limbs))
    return np.asarray(jmx64._dot(jmx64._digit_cat(limbs, n_e), jnp.asarray(planes))).astype(
        np.int64)


def _planes64(n: int, n_d: int, which: str):
    """(JAX planes of one pass of the n_d-plane prime, contraction k per limb,
    operand limbs, operand rows): A / wide A (4 limbs) / Ainv contract n1
    over rows (b, j < n2), F / G contract n2 over rows (b, r < n1)."""
    p = P64[n_d]
    n1, n2 = tmx.four_step_factors(n)
    if which == "A4":
        planes = jmx64._wide_col_planes(n, p, 4)[0]
    else:
        planes = jmx64._tables(n, p)[which][0]
    k, rows = (n1, 3 * n2) if which in ("A", "A4", "Ainv") else (n2, 3 * n1)
    return np.asarray(planes), k, 4 if which == "A4" else 2, rows


# (word size, what): the 32-bit cases, then one 64-bit prime per digit-plane
# count: F with 6 operand planes (two zero rows), A with 8, A_inv with 7 (one
# zero row: the 50-bit plane diet), A of a u128 operand (four limbs), G
CASES = {"col-2limbs": (32, None), "row": (32, None), "generic-col": (32, None),
         "64-d5-row-6planes": (64, (5, "F")), "64-d6-col": (64, (6, "A")),
         "64-d7-col-7planes": (64, (7, "Ainv")), "64-d8-col-4limbs": (64, (8, "A4")),
         "64-d9-row": (64, (9, "G"))}


@pytest.mark.parametrize("n", [1 << 11, 1 << 12])
@pytest.mark.parametrize("case", list(CASES))
def test_fragment_model_reproduces_the_digit_gemm(rng, n, case):
    """Both passes' shapes (the column operator with two and four limbs, the
    row operator, five to nine digit planes, padded operand planes), a batch
    whose rows end in a ragged tile."""
    word, spec = CASES[case]
    n1, n2 = tmx.four_step_factors(n)
    if word == 64:
        n_d, which = spec
        planes, k, n_limbs, rows = _planes64(n, n_d, which)
        tiles = tcu64.pack_planes64(planes[None], k, n_d)[0]
        dense = _dense64
    elif case == "generic-col":
        planes, _ = tmx._mxu_tables(n, GENERIC)["A"]
        n_limbs, k, rows, n_d = 1, n1, 3 * n2, 5
    else:
        n_limbs = 2 if case == "col-2limbs" else 1
        tabs = tcu._multi_tables(n, PRIMES[:1], n_limbs, (1,))
        planes = tabs["fwd"][0 if case == "col-2limbs" else 2][0]
        k, rows, n_d = (n1, 3 * n2, 4) if case == "col-2limbs" else (n2, 3 * n1, 4)
    if word == 32:
        tiles = tcu.pack_planes_kmajor(planes[None], k, n_d)[0]
        dense = _dense
    to = TILE_O[word]
    o = planes.shape[1] // n_d
    assert tiles.shape == (o // to, n_limbs * k // KC, n_d * to * KC)
    x = rng.integers(0, 1 << 32, (rows, n_limbs * k), dtype=np.uint32)
    x[0] = 0xFFFFFFFF  # digits at both ends of the int8 range
    x[1] = 0
    np.testing.assert_array_equal(_model_pass(x, tiles, n_d, to), dense(x, planes, n_limbs))


# K2's passes on its small-grid tile: (operand limbs, pass): the forward column
# pass (A, one and two limbs), the row pass (F), the inverse's row pass (G)
# and a five-plane prime's column pass
K2_CASES = {"A": (1, "A"), "A-2limbs": (2, "A"), "F": (1, "F"), "G": (1, "G"),
            "generic-A": (1, "A")}


@pytest.mark.parametrize("n", [1 << 11, 1 << 12, 1 << 13, 1 << 14])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_fragment_model_reproduces_the_digit_gemm_on_k2_tiles(rng, case, n):
    """K2's tile for one channel's small grids (64 rows x 16 outputs a
    block): N = 16 kD columns, planes packed with tile_o = 16, a batch of
    3 polynomials (rows end in a ragged tile)."""
    tm, to = tcu.TILES[1]
    assert (tm, to) == (64, 16)
    n_limbs, which = K2_CASES[case]
    p = GENERIC if case.startswith("generic") else PRIMES[0]
    n1, n2 = tmx.four_step_factors(n)
    planes, cvec = (tmx._wide_col_planes(n, p, n_limbs) if n_limbs > 1
                    else tmx._mxu_tables(n, p)[which])
    n_d = cvec.shape[0]
    assert n_d == (5 if p == GENERIC else 4)
    k, rows = (n1, 3 * n2) if which == "A" else (n2, 3 * n1)
    tiles = tcu.pack_planes_kmajor(planes[None], k, n_d, tile_o=to)[0]
    o = planes.shape[1] // n_d
    assert tiles.shape == (o // to, n_limbs * k // KC, n_d * to * KC)
    x = rng.integers(0, 1 << 32, (rows, n_limbs * k), dtype=np.uint32)
    x[0] = 0xFFFFFFFF
    x[1] = 0
    np.testing.assert_array_equal(_model_pass(x, tiles, n_d, to, tm), _dense(x, planes, n_limbs))


# K1c / K1d's 64-output tile (`mxu32_cuda.TILES` code 3: 128 rows x 64
# outputs, N = 256): K1c's column pass (1 and 2 limbs) and row pass (F),
# K1d's row pass (G)
K1_WIDE_CASES = {"A": (1, "fwd", 0), "A-2limbs": (2, "fwd", 0), "F": (1, "fwd", 2),
                 "G": (1, "inv", 0)}


@pytest.mark.parametrize("n", [1 << 12, 1 << 13])
@pytest.mark.parametrize("case", list(K1_WIDE_CASES))
def test_fragment_model_reproduces_the_digit_gemm_on_64_output_tiles(rng, case, n):
    """The 64-output tile: N = 256 columns (digit d of output j at column
    64 d + j), 128 accumulators a thread, planes packed with tile_o = 64,
    3 polynomials (rows end in a ragged tile)."""
    tm, to = tcu.TILES[3]
    assert (tm, to) == (128, 64)
    n_limbs, direction, which = K1_WIDE_CASES[case]
    n1, n2 = tmx.four_step_factors(n)
    tabs = tcu._multi_tables(n, PRIMES[:1], n_limbs, (1,), None)
    planes = tabs[direction][which][0]
    k, rows = (n1, 3 * n2) if case.startswith("A") else (n2, 3 * n1)
    tiles = tcu.pack_planes_kmajor(planes[None], k, 4, tile_o=to)[0]
    o = planes.shape[1] // 4
    assert tiles.shape == (o // to, n_limbs * k // KC, 4 * to * KC)
    x = rng.integers(0, 1 << 32, (rows, n_limbs * k), dtype=np.uint32)
    x[0] = 0xFFFFFFFF
    x[1] = 0
    np.testing.assert_array_equal(_model_pass(x, tiles, 4, to, tm), _dense(x, planes, n_limbs))


# K6's channel grid on its 64-row tile (`mxu64_cuda.TILE_ROWS` code 1: one
# warpgroup, m64n(16 kD)k32, the same 16-output plane tiles as the 128-row
# tile): one pass of each digit-plane count, both limb counts it takes
K6_ROW64_CASES = {"d5-F-6planes": (5, "F"), "d6-A": (6, "A"), "d7-Ainv-7planes": (7, "Ainv"),
                  "d8-G": (8, "G"), "d9-A": (9, "A")}


@pytest.mark.parametrize("n", [1 << 11, 1 << 12])
@pytest.mark.parametrize("case", list(K6_ROW64_CASES))
def test_fragment_model_reproduces_the_digit_gemm_on_64_row_64_bit_tiles(rng, case, n):
    """The 64-bit pass on 64 rows a block (one warpgroup of four warps, rows
    16 w + g / + 8 of the block, no second warpgroup): the digit GEMM of the
    JAX package's planes over 3 polynomials (rows end in a ragged tile),
    planes packed by `pack_planes64` as for the 128-row tile."""
    assert tcu64.TILE_ROWS[1] == 64
    n_d, which = K6_ROW64_CASES[case]
    planes, k, n_limbs, rows = _planes64(n, n_d, which)
    tiles = tcu64.pack_planes64(planes[None], k, n_d)[0]
    x = rng.integers(0, 1 << 32, (rows, n_limbs * k), dtype=np.uint32)
    x[0] = 0xFFFFFFFF
    x[1] = 0
    np.testing.assert_array_equal(_model_pass(x, tiles, n_d, TILE_O[64], tcu64.TILE_ROWS[1]),
                                  _dense64(x, planes, n_limbs))


def test_k2_tile_choice():
    """K1's 128 x 32 tile where its grid has at least 128 blocks, else
    64 x 16: at B = 16 the grids the source note of csrc/mxu32_pass.cu
    lists, both passes alike, and from 2^15 up K1's tile as before."""
    want = {1 << 11: (1, 32), 1 << 12: (1, 64), 1 << 13: (1, 128), 1 << 14: (1, 256),
            1 << 15: (0, 128), 1 << 16: (0, 256), 1 << 17: (0, 512)}
    for n, (code, blocks) in want.items():
        n1, n2 = tmx.four_step_factors(n)
        for direction in ("fwd", "inv"):
            assert tcu._k2_tiles(16, n, direction) == (code, code)
        for rows, o in ((16 * n2, n1), (16 * n1, n2)):
            tm, to = tcu.TILES[code]
            assert -(-rows // tm) * (o // to) == blocks
    assert tcu._k2_tiles(1, 1 << 17, "fwd") == (1, 1)


def test_k1_tile_choice():
    """K1c / K1d's tile codes (`mxu32_cuda.k1_tile`, the rule the sweep
    set) at the product plan's shapes: where its grid fits the card at
    once, 64 x 16 (3 blocks an SM, 2 with K1d's pair), else K1's tile
    holding four stages whole (<= 132 blocks), else 128 x 64 (<= 132
    blocks; not K1c's scaled first pass); else 128 x 64 for K1d's pair pass
    and K1's ring for the others. K1a / K1b / K1e take no code: their
    entries launch K1's own instances (tile 0)."""
    want = {  # (n, B, channels): (K1c 1 limb, K1c 2 limbs, K1d), passes in launch order
        (1 << 11, 16, 2): ((1, 1), (1, 1), (1, 1)),
        (1 << 13, 16, 3): ((1, 1), (1, 1), (2, 1)),
        (1 << 14, 16, 2): ((2, 2), (0, 2), (2, 2)),   # the product plan's PBS shape
        (1 << 14, 16, 3): ((0, 3), (0, 3), (3, 3)),
        (1 << 14, 8, 2): ((1, 1), (1, 1), (1, 1)),
        (1 << 14, 1, 2): ((1, 1), (1, 1), (1, 1)),
        (1 << 15, 16, 2): ((0, 3), (0, 3), (3, 3)),
        (1 << 16, 8, 2): ((0, 3), (0, 3), (3, 3)),
        (1 << 16, 8, 3): ((0, 0), (0, 0), (3, 0)),
        (1 << 17, 16, 2): ((0, 0), (0, 0), (3, 0)),
    }
    for (n, b, c), (k1c, k1c2, k1d) in want.items():
        assert tcu._k1_tiles(b, n, c, 1, "fwd") == k1c, (n, b, c)
        assert tcu._k1_tiles(b, n, c, 2, "fwd") == k1c2, (n, b, c)
        assert tcu._k1_tiles(b, n, c, 1, "inv") == k1d, (n, b, c)
    # block tables: channels x blocks count as grids (2^16 = 4 blocks of 2^14)
    assert tcu._k1_tiles(8, 1 << 14, 3 * 4, 1, "inv") == (3, 0)
    assert tcu._k1_tiles(8, 1 << 14, 3 * 2, 1, "inv") == (3, 3)
    # (rows, outputs) of each code: K1's 128 x 32 but 64 x 16 for code 1
    assert tcu.TILES == ((128, 32), (64, 16), (128, 32), (128, 64))
    # K1a / K1b launch K1's instances: no tile argument in their entries
    src = (Path(tcu.__file__).parent.parent / "csrc" / "mxu32_multi.cu").read_text()
    for entry in ("k1a_fwd_wide_multi", "k1b_inv_multi"):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert "tile" not in body and "launch_k1" not in body, entry
        assert re.findall(r"launch<4, kLt30, (?:true|false)>\(", body), entry
    # K1e takes a code a pass, as K1c: its presplit row pass, then K1b's column pass
    body = src[src.index('extern "C" int k1e_inv_multi_presplit('):]
    body = body[:body.index("\n}\n")]
    assert "launch_k1<true, false, true>(row, channels, tile1, s)" in body
    assert "launch_k1<false>(col, channels, tile2, s)" in body
    want_k1e = {  # (B, channels): codes at n = 2^14, the presplit pass "scaled" (no code 3)
        (1, 2): (1, 1), (1, 10): (1, 1), (8, 2): (1, 1), (8, 3): (1, 1), (8, 5): (0, 3),
        (8, 10): (0, 0), (16, 2): (2, 2), (16, 3): (0, 3), (16, 5): (0, 0), (16, 10): (0, 0)}
    for (b, c), codes in want_k1e.items():
        assert tcu._k1e_tiles(b, 1 << 14, c) == codes, (b, c)
        assert codes[0] != 3 and codes == tcu._k1_tiles(b, 1 << 14, c, 1, "inv", "scaled")


def _unpack(words: np.ndarray, k: int) -> np.ndarray:
    """Inverse of `pack_planes`: [C, L*k, D*O] int32 -> [C, 4L*k, D*O] int8."""
    c, lk, do = words.shape
    b = words.view(np.int8).reshape(c, lk // k, k, do, 4)
    return np.ascontiguousarray(b.transpose(0, 1, 4, 2, 3)).reshape(c, 4 * lk, do)


# (word size, operand limbs or 64-bit pass): the 32-bit A with 1, 2, 4 limbs;
# the 64-bit A (8 planes), F of a 50-bit prime (7 planes and a zero row), A
# of a u128 operand (16 planes)
ROUND_TRIPS = {"1": (32, 1), "2": (32, 2), "4": (32, 4), "64-A": (64, "A"),
               "64-F-7planes": (64, "F"), "64-A-4limbs": (64, "A4")}


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_packed_tiles_round_trip_to_the_jax_planes(rng, case):
    """Each byte of a packed tile sits where the B descriptor reads it:
    byte k of k-step ks of column col (= TO d + j) in tile (ot, kt) is
    contraction byte 128 kt + 32 ks + k, i.e. digit e of value i of limb l,
    plane row (4l + e) n1 + i, of column d O + TO ot + j; unpacking the
    tiles gives the JAX package's planes (in 64 bits with the zero rows that
    pad fewer than eight operand planes)."""
    word, what = ROUND_TRIPS[case]
    n = 1 << 11
    n1, n2 = tmx.four_step_factors(n)
    if word == 32:
        p, n_d, k = PRIMES[0], 4, n1
        ref = jmx._wide_col_planes(n, p, what)[0] if what > 1 else jmx._mxu_tables(n, p)["A"][0]
        ref = np.asarray(ref)
        tiles = tcu.pack_planes_kmajor(ref[None], k, n_d)[0]  # [O/32, L*k/32, D*32*32]
    else:
        p = PRIMES52[0]
        n_d = jmx64._n_dplanes(p)
        k = n2 if what == "F" else n1
        ref = np.asarray(jmx64._wide_col_planes(n, p, 4)[0] if what == "A4"
                         else jmx64._tables(n, p)[what][0])
        tiles = tcu64.pack_planes64(ref[None], k, n_d)[0]  # [O/16, L*k/32, D*16*32]
        pad = -ref.shape[0] % (4 * k)  # the zero rows of the plane diet
        assert (what == "F") == (pad == k)
        ref = np.concatenate([ref, np.zeros((pad, ref.shape[1]), np.int8)])
    to = TILE_O[word]
    o = ref.shape[1] // n_d
    n_ot, nk = tiles.shape[:2]
    words = tiles.reshape(n_ot, nk, n_d, to // 8, 8, 8, 4).transpose(1, 4, 6, 2, 0, 3, 5)
    words = np.ascontiguousarray(words).reshape(1, nk * KC, n_d * o)
    np.testing.assert_array_equal(_unpack(words, k)[0], ref)
    tb = tiles.view(np.int8).reshape(n_ot, nk, -1)
    boff = _b_offsets(n_d * to)
    for _ in range(256):
        ot, kt, ks, col, kb = (int(rng.integers(0, m)) for m in (n_ot, nk, 4, n_d * to, 32))
        kbyte = 128 * kt + 32 * ks + kb
        l, i = divmod(kbyte // 4, k)
        assert tb[ot, kt, 256 * ks + boff[col, kb]] == ref[(4 * l + kbyte % 4) * k + i,
                                                          (col // to) * o + to * ot + col % to]


def test_shared_memory_fragment_reads_hit_32_banks():
    """Word offsets of one A register over the 32 lanes, in the
    contiguous-row operand layout [row][KC + 4] and the strided one
    [word][rows + 8] that both passes use (128 rows, and 64 on K2's one
    warpgroup tile): 32 banks, no conflict. K1d's pair pass reads a second
    operand slot in the contiguous-row layout, `ring` stages further on
    (after the plane tiles and the first operand's slots of every tile
    code): its reads hit 32 banks too."""
    for rs, ws in ((A_ROW, 1), (1, A_WORD), (1, 64 + 8)):
        for dr, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
            banks = ((G + dr) * rs + (T + dw) * ws) % 32
            assert len(set(banks.tolist())) == 32
    for code, ring in PAIR_RINGS.items():
        tm, to = tcu.TILES[code]
        for slot in range(ring):
            base = ring * 4 * to * KC + ring * _a_stage(tm) + slot * _a_stage(tm)
            for dr, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
                banks = (base + (G + dr) * A_ROW + T + dw) % 32
                assert len(set(banks.tolist())) == 32


# K1d's first pass with its pair operand (csrc/gemm_sm90.cuh, kPair): fl and
# fr copied into two operand slots of one layout, the contiguous-row one
# [row][KC + 4] (the inverse's row pass contracts each row's own words); the
# second slot of ring stage s sits `ring` stages of the first one further on
PAIR_RINGS = {1: 4, 2: 4, 3: 3}  # ring stages by K1d's tile codes (matmod_pass.cuh `tile`)


def _a_stage(tm: int) -> int:
    """Words of one operand stage of tm rows (gemm_sm90.cuh a_stage)."""
    return max(tm * A_ROW, KC * (tm + 8))


def _mont_mul_model(a: np.ndarray, b: np.ndarray, p: int, p_neginv: int):
    """The kernel's mont_mul (csrc/matmod_pass.cuh) on uint64 carriers of
    u32 words: (result, s), s the 64-bit REDC sum hi + mulhi(m, p) + (lo !=
    0) before its one conditional subtract (s >= 2^32: the sum overflows
    u32)."""
    ab = a * b
    lo = ab & np.uint64(0xFFFFFFFF)
    m = (lo * np.uint64(p_neginv)) & np.uint64(0xFFFFFFFF)
    s = (ab >> np.uint64(32)) + ((m * np.uint64(p)) >> np.uint64(32)) + (lo != 0)
    return np.where(s >= p, s - np.uint64(p), s), s


def _pair_fragments(fl: np.ndarray, fr: np.ndarray, p: int, tm: int, ring: int,
                    slot: int) -> tuple:
    """One ring stage of K1d's pair pass over a tile of tm operand rows x KC
    words (fl, fr [tm, KC] u32): both copied into shared memory as the
    kernel lays them out (the second operand's slot `ring` stages on), each
    lane of each warp of each warpgroup reading its A registers at the
    kernel's offsets from both slots and taking mont_mul before the digit
    xor. Returns (the product words [tm, KC] the fragments hand to wgmma,
    xor undone, the REDC sums)."""
    p_neginv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    kas = _a_stage(tm)
    smem = np.zeros(2 * ring * kas, np.uint64)
    xs, xq = slot * kas, ring * kas + slot * kas
    r, w = np.meshgrid(np.arange(tm), np.arange(KC), indexing="ij")
    smem[xs + r * A_ROW + w] = fl
    smem[xq + r * A_ROW + w] = fr
    out = np.zeros((tm, KC), np.uint64)
    sums = np.zeros((tm, KC), np.uint64)
    for warp in range(tm // 16):  # warp w of the block: rows 16 w + g (+ 8)
        a_lane = (16 * warp + G) * A_ROW + T
        for ks in range(KC // 8):
            for dr, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
                off = a_lane + 8 * ks + dr * A_ROW + dw
                word, s = _mont_mul_model(smem[xs + off], smem[xq + off], p, p_neginv)
                af = word.astype(np.uint32) ^ XOR
                out[16 * warp + G + dr, 8 * ks + T + dw] = af ^ XOR
                sums[16 * warp + G + dr, 8 * ks + T + dw] = s
    return out.astype(np.uint32), sums


@pytest.mark.parametrize("code", list(PAIR_RINGS))
def test_pair_stage_model_takes_mont_mul_at_the_fragment_read(rng, code):
    """K1d's pointwise product where the redesign takes it: per lane, at the
    A-fragment read of both operand slots, over the stage's shared-memory
    layout (every ring slot of each tile code), on full-range u32 pairs and
    on pairs whose REDC sum overflows u32: every (row, word) of the stage
    is read once and equals the port's plain mont_mul. Tolerance: exact."""
    tm = tcu.TILES[code][0]
    p = PRIMES[0]
    fl = rng.integers(0, 1 << 32, (tm, KC), dtype=np.uint64)
    fr = rng.integers(0, 1 << 32, (tm, KC), dtype=np.uint64)
    fl[0], fr[0] = 0xFFFFFFFF, 0xFFFFFFFF  # the largest REDC sums
    fl[1, :16], fr[1, :16] = 0, rng.integers(0, 1 << 32, 16)  # lo == 0: no carry
    want = tu32.mont_mul(torch.from_numpy(fl.astype(np.int64)),
                         torch.from_numpy(fr.astype(np.int64)), p, tu32.mont_neginv(p))
    for slot in range(PAIR_RINGS[code]):
        got, sums = _pair_fragments(fl, fr, p, tm, PAIR_RINGS[code], slot)
        assert (sums >= 1 << 32).sum() > 0, "no pair whose REDC sum overflows u32"
        np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


def test_pair_stage_model_through_the_plain_k1d(rng):
    """The whole first-pass operand of K1d built stage by stage through the
    fragment model (n = 2^11: rows (b, r < n1) of 64 words, two stages; B =
    3, so the row tile is ragged, zero-filled past the batch edge), fed to
    K1b's plain twin, equals `pointwise_inv_multi_plain` on full-range u32
    operands over two channels. Tolerance: exact."""
    n, b, primes = 1 << 11, 3, PRIMES[:2]
    n1, n2 = tmx.four_step_factors(n)
    fl = rng.integers(0, 1 << 32, (2, b, n), dtype=np.uint64)
    fr = rng.integers(0, 1 << 32, (2, b, n), dtype=np.uint64)
    fl[:, 0, :64], fr[:, 0, :64] = 0xFFFFFFFF, 0xFFFFFFFF
    prod = np.zeros((2, b * n1, n2), np.uint32)
    for ch, p in enumerate(primes):
        rows_l, rows_r = fl[ch].reshape(b * n1, n2), fr[ch].reshape(b * n1, n2)
        pad = -(b * n1) % TM
        rows_l = np.concatenate([rows_l, np.zeros((pad, n2), np.uint64)])
        rows_r = np.concatenate([rows_r, np.zeros((pad, n2), np.uint64)])
        for r0 in range(0, b * n1 + pad, TM):
            for kt in range(n2 // KC):
                tile = np.s_[r0:r0 + TM, kt * KC:(kt + 1) * KC]
                got, _ = _pair_fragments(rows_l[tile], rows_r[tile], p, TM, 3, kt % 3)
                keep = min(TM, b * n1 - r0)
                prod[ch, r0:r0 + keep, kt * KC:(kt + 1) * KC] = got[:keep]
        assert not got[b * n1 - r0:].any(), "rows past the batch edge must stay zero"
    scales = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in primes)
    t = lambda a: torch.from_numpy(a.astype(np.uint32).reshape(2, b, n))  # noqa: E731
    np.testing.assert_array_equal(
        tcu.inv_multi_plain(t(prod), primes, scales).numpy(),
        tcu.pointwise_inv_multi_plain(t(fl), t(fr), primes, scales).numpy())


# -- K1e's presplit pass: the planes copied as K1b's words, packed at the read --

# the tile codes K1e's presplit row pass may take (`k1_tile` "scaled": no code
# 3) and each code's ring stages (csrc/matmod_pass.cuh `tile`)
PRESPLIT_RINGS = {0: 3, 1: 4, 2: 4}


def _byte_perm(x: np.ndarray, y: np.ndarray, sel) -> np.ndarray:
    """CUDA's __byte_perm (prmt, default mode) on uint64 carriers of u32
    words: result byte n = byte (sel >> 4n) & 7 of the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(both, sel).shape, np.uint64)
    for k in range(4):
        pick = (sel >> np.uint64(4 * k)) & np.uint64(7)
        out |= ((both >> (np.uint64(8) * pick)) & np.uint64(255)) << np.uint64(8 * k)
    return out


def _presplit_stage(xd: np.ndarray, kt: int, tm: int, ring: int, slot: int) -> tuple:
    """One ring stage of K1e's presplit pass over tm rows of plane bytes xd
    [rows, 4 K] (uint8; rows past the edge are not copied: zero): the
    cp.async copies of the kernel (thread tid, chunk c = tid % 8 of row tid
    / 8 + (threads / 8) i: 16 bytes of plane c / 2, values 32 kt + 16 (c %
    2) .. + 15) into the [row][KC + 4] layout of slot `slot`, then each
    lane's fragment read (a 16-byte load of words 4 kp .. + 3 of each plane
    of rows g, g + 8 for k-steps 2 kp, 2 kp + 1; three byte permutes a
    register). Returns (the [tm, KC] words handed to wgmma, the
    shared-memory word addresses each warp's 16-byte loads read, [warps,
    kp, e, half, 32 lanes])."""
    rows, k4 = xd.shape
    k = k4 // 4
    kas = _a_stage(tm)
    smem = np.zeros(ring * kas, np.uint32)
    threads = 2 * tm
    for tid in range(threads):
        c = tid & 7
        for i in range(4):
            r = tid // 8 + (threads // 8) * i
            if r >= rows:
                continue  # zero-filled past the batch edge
            src = (c >> 1) * k + 32 * kt + 16 * (c & 1)
            chunk = np.ascontiguousarray(xd[r, src:src + 16]).view(np.uint32)
            dst = slot * kas + r * A_ROW + 4 * c
            smem[dst:dst + 4] = chunk
    words = np.zeros((tm, KC), np.uint64)
    addrs = np.zeros((tm // 16, KC // 16, 4, 2, 32), np.int64)
    sel = T | ((T + 4) << 4)
    for warp in range(tm // 16):
        p_lane = slot * kas + (16 * warp + G) * A_ROW
        for kp in range(KC // 16):  # two k-steps a 16-byte load
            lo = np.zeros((4, 4, 32), np.uint32)
            hi = np.zeros((4, 4, 32), np.uint32)
            for e in range(4):
                at = p_lane + 4 * kp + 8 * e
                addrs[warp, kp, e, 0] = at
                addrs[warp, kp, e, 1] = at + 8 * A_ROW
                lo[e] = np.stack([smem[at + q] for q in range(4)])
                hi[e] = np.stack([smem[at + 8 * A_ROW + q] for q in range(4)])
            for ks in (2 * kp, 2 * kp + 1):
                for reg, (half, word) in enumerate(((lo, 0), (hi, 0), (lo, 1), (hi, 1))):
                    w = 2 * (ks - 2 * kp) + word
                    v = _byte_perm(_byte_perm(half[0][w], half[1][w], sel),
                                   _byte_perm(half[2][w], half[3][w], sel), 0x5410)
                    row = 16 * warp + G + 8 * (reg % 2)
                    words[row, 8 * ks + T + 4 * (reg // 2)] = v
    return words.astype(np.uint32), addrs


@pytest.mark.parametrize("code", list(PRESPLIT_RINGS))
def test_presplit_fragment_model_gives_the_digit_words(rng, code):
    """K1e's copy-then-prmt read at every tile code its presplit pass may
    take, over every ring slot: the words handed to wgmma are v ^ 0x80808080
    of the values whose `digit_planes32` the pass copies (K1b's words after
    its digit xor), bit for bit; rows past the batch edge stay zero. n =
    2^12 (rows of n2 = 64 values: two stages), B = 3. Tolerance: exact."""
    tm = tcu.TILES[code][0]
    ring = PRESPLIT_RINGS[code]
    n, b = 1 << 12, 3
    n1, n2 = tmx.four_step_factors(n)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint32)
    x[0, :4] = (0, 0x80, 0xFFFFFFFF, 0x7F7F7F7F)
    xd = tcu.digit_planes32(torch.from_numpy(x)).numpy().view(np.uint8)  # [B, n1, 4 n2]
    rows_all = xd.reshape(b * n1, 4 * n2)
    vals = x.reshape(b * n1, n2)
    for r0 in range(0, b * n1, tm):
        for kt in range(n2 // KC):
            slot = kt % ring
            words, _ = _presplit_stage(rows_all[r0:r0 + tm], kt, tm, ring, slot)
            keep = min(tm, b * n1 - r0)
            np.testing.assert_array_equal(words[:keep], vals[r0:r0 + keep, kt * KC:(kt + 1) * KC]
                                          ^ XOR)
            assert not words[keep:].any()


@pytest.mark.parametrize("code", list(PRESPLIT_RINGS))
def test_presplit_fragment_reads_hit_32_banks(rng, code):
    """The presplit read's 16-byte loads (words 4 kp .. + 3 of one plane of
    one row a lane; four lanes of a row read the same address): in each
    warp instruction the 8 distinct addresses cover all 32 banks once, so
    no load waits for a bank, at every ring slot of every code."""
    tm = tcu.TILES[code][0]
    ring = PRESPLIT_RINGS[code]
    xd = rng.integers(0, 256, (tm, 4 * 64), dtype=np.uint8)
    for slot in range(ring):
        _, addrs = _presplit_stage(xd, 0, tm, ring, slot)
        assert (addrs % 4 == 0).all()  # 16-byte aligned loads
        for warp, kp, e, half in np.ndindex(addrs.shape[:4]):
            distinct = np.unique(addrs[warp, kp, e, half])
            banks = {int(a + j) % 32 for a in distinct for j in range(4)}
            assert len(distinct) == 8 and len(banks) == 32


# -- K2 with block tables: tiles from the block grid, tables packed for them --

HYB_N_D = {"lt30": 4, "lt31": 4, "generic4": 4, "generic5": 5}


def test_k2h_tile_choice():
    """K2 with block tables takes a code a pass from its grid with the nb =
    n / n_h blocks counted (`mxu32_cuda.k2h_tiles`: `k1_tile` over nb grids,
    "scaled" first, "canonical" second, and where that keeps K1's ring, K1's
    tile holding the contraction whole with five digit planes and 128 x 64
    for the canonical pass with four: the sweep's picks) at n_h = 2^14, B in
    (1, 4, 16), every regime's plane count, both directions; the grid has at
    least 128 blocks wherever even K2's smallest tile (64 x 16) reaches it."""
    n_h = 1 << 14
    want = {  # (n, B): codes with four planes, with five; both directions alike
        (1 << 15, 1): ((1, 1), (1, 1)), (1 << 15, 4): ((1, 1), (1, 1)),
        (1 << 15, 16): ((2, 2), (2, 2)),
        (1 << 16, 1): ((1, 1), (1, 1)), (1 << 16, 4): ((1, 1), (1, 1)),
        (1 << 16, 16): ((0, 3), (2, 2)),
        (1 << 17, 1): ((1, 1), (1, 1)), (1 << 17, 4): ((2, 2), (2, 2)),
        (1 << 17, 16): ((0, 3), (2, 2)),
    }
    n1, n2 = tmx.four_step_factors(n_h)
    for (n, b), (four, five) in want.items():
        nb = n // n_h
        for regime, n_d in HYB_N_D.items():
            for direction in ("fwd", "inv"):
                codes = tcu.k2h_tiles(b, n, n_h, direction, n_d)
                assert codes == (four if n_d == 4 else five), (n, b, regime, direction)
                for code, kind in zip(codes, ("scaled", "canonical")):
                    assert code != 3 or (kind == "canonical" and n_d == 4)
                    blocks = nb * tcu._blocks(b * n2, n1, code)
                    if nb * tcu._blocks(b * n2, n1, 1) >= 128:
                        assert blocks >= 128, (n, b, code)


@pytest.mark.parametrize("code", [0, 1, 3])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_block_tables_packed_for_each_code_round_trip_to_the_jax_hyb_planes(code, direction):
    """K2's block tables packed for the outputs of each tile code (32, 16,
    64; code 2 packs as code 0) unpack to the JAX package's `hyb=` planes:
    A_b (forward) / A_inv,b times the scale (inverse) for every block, F /
    G once; the table cache keys on the outputs. n = 2^14, n_h = 2^13."""
    from concrete_ntt_tpu.ops import stagesplit as jss

    n, n_h, p = 1 << 14, 1 << 13, PRIMES[0]
    n1, n2 = tmx.four_step_factors(n_h)
    to = tcu.TILES[code][1]
    scale = 1 if direction == "fwd" else pow(n, p - 2, p)
    tabs = tcu._hyb_tables(n, p, n_h, scale, direction, "cpu", (to, to))
    blocks = jss._dev32(n, p, n_h)["blocks"]
    per_block = ([t["A"][0] for t in blocks] if direction == "fwd"
                 else [m[0] for m in jss._scaled_ainv_blocks32(n, p, n_h, scale)])
    shared = blocks[0]["F" if direction == "fwd" else "G"][0]
    for tiles, ref, k in ((tabs["planes_blk"].numpy(), per_block, n1),
                          (tabs["planes_sh"].numpy(), [shared], n2)):
        assert len(tiles) == len(ref)
        for t, r in zip(tiles, ref):
            r = np.asarray(r)
            n_ot, nk = t.shape[:2]
            assert t.shape[-1] == 4 * to * KC and n_ot * to == r.shape[1] // 4
            words = t.reshape(n_ot, nk, 4, to // 8, 8, 8, 4).transpose(1, 4, 6, 2, 0, 3, 5)
            words = np.ascontiguousarray(words).reshape(1, nk * KC, r.shape[1])
            np.testing.assert_array_equal(_unpack(words, k)[0], r)
    other = tcu._hyb_tables(n, p, n_h, scale, direction, "cpu", (32, 32) if to != 32 else (16, 16))
    assert other["planes_blk"].shape != tabs["planes_blk"].shape
