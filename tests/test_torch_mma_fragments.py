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
tile_o=16)`. The packed tiles must unpack to the JAX package's planes, and
the shared-memory reads of both operand layouts (strided rows at 128 + 8
and 64 + 8 words) must fall on 32 different banks. Tolerance: exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import mxu64 as jmx64
from concrete_ntt_tpu.tables import GOLDILOCKS, PRIMES52
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
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
    warpgroup tile): 32 banks, no conflict."""
    for rs, ws in ((A_ROW, 1), (1, A_WORD), (1, 64 + 8)):
        for dr, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
            banks = ((G + dr) * rs + (T + dw) * ws) % 32
            assert len(set(banks.tolist())) == 32
