// One exact modular GEMM pass of the four-step prime32 NTT, for every
// prime32 regime: the building block of kernels K1a-K1e (mxu32_multi.cu)
// and K2/K3 (mxu32_pass.cu). Replaces the GEMM body shared by the TPU
// kernels of concrete_ntt_tpu/ops/mxu32_pallas.py (_build_call :72-107,
// _build_multi_call :367-412, _build_pass_call :706-719).
//
// The pass computes the JAX package's ops/mxu32.py math for a [rows, K] x
// [K, O] product mod p per polynomial and channel: the operand (any u32
// representative, or the 2 / 4 little-endian limbs of a u64 / u128) is split
// into int8 digits (byte - 128,
// the xor-128 bit pattern of _digit8); the digits meet the balanced-digit
// int8 operator planes in kD int32 accumulators (4 matrix digit planes, or
// 5 for primes near 2^32); the accumulators plus the epilogue constants
// combine into a (lo, hi) u32 pair (the fifth plane sits at bit 32 and adds
// into hi, as ops/mxu32.py::_combine); an epilogue reduces the pair:
//
//   scaled (diagonal W, fused four-step twiddle correction):
//     kLt30   two Shoup multiplies, lazy sum reduced by 2p -> [0, 2p)
//     kLt31   two Shoup multiplies, each to [0, p), sum to [0, p)
//     kGeneric two Montgomery multiplies (W*2^32, W*2^64 mod p), add_mod
//   canonical -> [0, p):
//     kLt30/kLt31  Shoup hi*(2^32 mod p) to [0, p); lo down the chain of
//                  multiples of p held in the scalar record; sum, cond_sub
//     kGeneric     Montgomery hi*(2^64 mod p); lo down the chain; add_mod
//
// What bounds it on the H100. A pass is an int8 GEMM of B*R rows, 4*L*K
// contraction bytes and kD*O columns, exact in int32 (assert_accumulator_exact:
// |U_d - 2^27| < 2^27 up to a contraction of 4096 digits), whose operands are
// a few MiB: at the main path's shapes its int8 operations take longer than
// its bytes even at the tensor cores' rate (989 int8 TMAC/s dense), and tens of
// times longer on the CUDA cores' byte dot products.
//
// Design: Hopper's warpgroup product on the int8 tensor cores,
// wgmma.mma_async m64nNk32 .s32.s8.s8, N = 32 * kD, A from registers and B
// from shared memory. A register of the warpgroup's A fragment is four
// consecutive contraction bytes of one row, which is exactly one operand
// word: the digit split stays one xor (v ^ 0x80808080), applied when the
// fragment is read from shared memory, so either memory order of the operand
// serves (wgmma takes 8-bit A only K-major from shared memory, and three of
// the four passes contract a strided axis). B is K-major, as wgmma takes
// 8-bit B: the host packs each plane word (ops/mxu32_cuda.py pack_planes:
// byte e of word (l*K + i, col) meets digit e of value i of limb l) into
// per-block tiles in the exact shared-memory image of the descriptor's core
// matrices without swizzle (pack_planes_kmajor), so a stage is one
// contiguous copy. The products are exact integers, so the accumulators hold
// the exact digit sums of ops/mxu32.py bit for bit. The N axis is the kD digit
// columns of kTO outputs; the n8 chunks of digit d sit at the same output
// offsets for every d, so each thread holds all kD accumulators of its own
// (row, output) pairs and the combine and both epilogues stay per element.
//
// Tiling (tile 0): a block owns kTM = 128 operand rows x kTO = 32 outputs x kD
// digits: two warpgroups of 64 rows, each one m64n(32 kD)k32 product a
// k-step of 8 operand words, 64 (kD 4) or 80 (kD 5) accumulators a thread.
// The contraction streams through a ring of kStages shared-memory stages of
// kKC = 32 words each, filled with cp.async 16-byte copies kStages - 1
// stages ahead of the products, one barrier and one wgmma group a stage. The
// operand tile has two layouts, one per memory order, both
// bank-conflict-free for the fragment reads: contiguous rows (s_k == 1, the
// inverse's row pass and K3) are copied as [row][kKC + 4] words, strided
// ones (s_r == 1: the column passes and the forward row pass) as
// [word][kTM + 8], four rows a copy. The mainloop is gemm_sm90.cuh's, shared
// with matmod64_pass.cuh (16 outputs a block there). Dynamic shared memory,
// 102 KiB with four digits (two blocks an SM), 114 KiB with five. Strides of the operand
// and of the output are fields of the descriptor, so a mid-pass transpose is
// a stride of the next pass's loads. Grid = (row tiles over batch x rows,
// output tiles, z); rows past the batch edge are zero-filled and not stored.
// K2's entries pick a smaller tile where one channel's grid is small (Tile
// below): 64 rows (one warpgroup) x 16 outputs (m64n(16 kD)k32, 32 or 40
// accumulators), with a contraction of up to four stages held whole.
//
// The z axis is channel * nb + block. nb = 1 is a direct transform. With the
// 32-bit stage-split hybrid's block tables (ops/stagesplit.py) a transform of
// size nb * n is nb block transforms of size n after the prefix butterflies:
// block `blk` reads and writes its n-slice of each polynomial in place (x_blk,
// out_blk; the polynomial stride x_b / out_b is then the parent's size), takes
// its own diagonal rows, and takes its own planes where the pass is the
// column operator (A_b, the wide A_b of two limbs, A_inv,b: planes_blk) or
// the channel's where it is the shared row operator (F, G). The scalar record
// is the channel's. This is the layout of matmod64_pass.cuh.
//
// kPresplit (K1e's first pass): the operand arrives as the int8 digit planes
// of ops/mxu32_cuda.py digit_planes32, [.., rows, 4 * K] bytes, plane-major in
// the last axis; the four plane bytes of a value are the xor-128 pattern
// already, so they are packed into the digit word as they are.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace mxu32 {

using sm90::kKC;

// The tiles of a pass, by the code the host passes (ops/mxu32_cuda.py
// k2_tile): rows and outputs a block, ring stages, and whether a short
// contraction is held whole (gemm_sm90.cuh's note). Code 0 is K1's, K3's and
// the block tables' (and K2's where its grid reaches 128 blocks: 2^15 and up
// at B = 16); code 1 is K2's for one channel's small grids, 64 rows x 16
// outputs a block (N = 16 kD).
struct Tile {
  int rows, outs, ring;
  bool resident;
};
__host__ __device__ constexpr Tile tile(int code) {
  return code == 0 ? Tile{128, 32, 3, false} : Tile{64, 16, 4, true};
}
constexpr int kTiles = 2;

// words of one stage of the plane tile: kD * outs rows (N) of kKC words (K),
// in the host-packed order of ops/mxu32_cuda.py pack_planes_kmajor: 8-row
// groups of eight 16-byte chunks of eight rows (wgmma's K-major core
// matrices without swizzle: next chunk along K 128 bytes on, next 8 rows
// 1024 bytes on)
__host__ __device__ constexpr int plane_stage(int kD, int code = 0) {
  return sm90::plane_stage(kD, tile(code).outs);
}
__host__ __device__ constexpr int smem_bytes(int kD, int code = 0) {
  return sm90::smem_bytes(kD, tile(code).outs, tile(code).rows, tile(code).ring);
}
// blocks an SM the registers are budgeted for: two (one with five digit
// planes) for tile 0 as before; tile 1 as many as its shared memory lets in
// (68 / 76 KiB)
__host__ __device__ constexpr int min_blocks(int kD, int code) {
  return code == 0 ? (kD == 4 ? 2 : 1) : (kD == 4 ? 3 : 2);
}

// Per-channel scalar record (uint32 words), built by ops/mxu32_cuda.py
// scalar_record: p, 2^32 mod p, its Shoup companion, -p^-1 mod 2^32,
// 2^64 mod p, 2p mod 2^32, the chain length, then the chain of multiples of
// p that brings a u32 into [0, p) (ops/mxu32.py::_reduce_chain).
constexpr int kScalWords = 16;
constexpr int kMaxChain = kScalWords - 7;

enum Regime { kLt30 = 0, kLt31 = 1, kGeneric = 2 };

struct Pass {
  const uint32_t* x[4];  // operand limbs (x[l] read only if l < n_limbs; K1d reads x[1])
  long long x_b;         // elements between polynomials of the operand
  long long x_chan;      // elements between channels of the operand (0: shared)
  long long x_blk = 0;   // elements between blocks of the operand
  int nb = 1;            // blocks per channel (grid z = channel * nb + block)
  int planes_blk = 0;    // planes / cvec indexed by z (per block), else by the channel
  int n_limbs;
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int o;                 // outputs per row (multiple of the tile's outputs)
  long long out_b;       // elements between polynomials of the output
  long long out_chan;    // elements between channels of the output
  long long out_blk = 0; // elements between blocks of the output
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C or C * nb][o / outs][n_limbs * k1 / kKC][plane_stage] words
  const int32_t* cvec;    // [C or C * nb][kD][o]
  const uint32_t* diag;   // [C * nb][4 or 2][R][o] (scaled pass; see scale_tabs)
  const uint32_t* scal;   // [C][kScalWords]
  uint32_t* out;
};

__device__ __forceinline__ uint32_t cond_sub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

// z*w - floor(z*w_shoup / 2^32)*p, wrapping (ops/u32.py shoup_mul_lazy)
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t z, uint32_t w, uint32_t w_sh,
                                               uint32_t p) {
  return z * w - __umulhi(z, w_sh) * p;
}

// REDC a*b*2^-32 mod p with the (lo != 0) carry (ops/u32.py mont_mul), for
// any u32 a, b: the 64-bit sum keeps the u32 overflow of hi + mulhi(m, p) +
// carry (true value < 2^32 + p), which the JAX package's mont_mul and
// _sc_mont_mul track, and one conditional subtract gives their bit pattern.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p,
                                             uint32_t p_neginv) {
  const uint64_t ab = (uint64_t)a * b;
  const uint32_t lo = (uint32_t)ab;
  const uint32_t m = lo * p_neginv;
  const uint64_t s = (ab >> 32) + __umulhi(m, p) + (lo != 0u);
  return (uint32_t)(s >= p ? s - p : s);
}

// (a + b) mod p with the u32 overflow taken into account (ops/u32.py add_mod)
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint64_t s = (uint64_t)a + b;
  return (uint32_t)(s >= p ? s - p : s);
}

// A table word of the epilogue (cvec, diagonal). K2's small-grid tile reads
// it through the read-only path (the tables do not change during a launch),
// which lets the compiler issue every element's table loads ahead of the
// stores of the elements before it; tile 0 (K1, K3) keeps its plain loads.
template <int kTile, class T>
__device__ __forceinline__ T table_word(const T* ptr) {
  if constexpr (kTile != 0) {
    return __ldg(ptr);
  } else {
    return *ptr;
  }
}

// kPointwise (K1d's first pass): the operand value is the Montgomery product
// mont_mul(x[0][i], x[1][i]) of two operands read at the same index (both
// any u32, one limb each), taken in the load before the digit split.
// kPointwise and kPresplit load their operand tile with plain loads and
// stores (the value is computed or packed on the way); every other pass
// copies it with cp.async.
template <int kD, int kRegime, bool kScaled, bool kPointwise = false, bool kPresplit = false,
          int kTile = 0>
__global__ void __launch_bounds__(sm90::threads(tile(kTile).rows), min_blocks(kD, kTile))
    matmod_pass(Pass a) {
  static_assert(!(kPointwise && kPresplit), "the presplit operand is one array of planes");
  constexpr int kTM = tile(kTile).rows;
  constexpr int kTO = tile(kTile).outs;
  extern __shared__ __align__(128) uint32_t smem[];
  const int z = blockIdx.z;
  const int c = z / a.nb;        // channel
  const int blk = z - c * a.nb;  // block of the channel
  const int pz = a.planes_blk ? z : c;
  const int row0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTO;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's first row (as in sm90::mainloop)
  // this block's plane tiles: [pz][output tile][stage][plane_stage]
  const int nk = a.n_limbs * a.k1 / kKC;
  const uint32_t* planes = reinterpret_cast<const uint32_t*>(a.planes) +
                           ((size_t)pz * (a.o / kTO) + blockIdx.y) * nk * plane_stage(kD, kTile);
  const long long chan = (long long)c * a.x_chan + (long long)blk * a.x_blk;
  uint32_t pw_p = 0, pw_neginv = 0;  // p and -p^-1 of the channel (kPointwise)
  if constexpr (kPointwise) {
    pw_p = a.scal[kScalWords * c];
    pw_neginv = a.scal[kScalWords * c + 3];
  }
  // the operand chunk at `at` of the plain-loading passes
  auto load = [&](long long at, int i0, int) {
    if constexpr (kPointwise) {
      const uint4 l = *reinterpret_cast<const uint4*>(a.x[0] + at);
      const uint4 r = *reinterpret_cast<const uint4*>(a.x[1] + at);
      return make_uint4(mont_mul(l.x, r.x, pw_p, pw_neginv), mont_mul(l.y, r.y, pw_p, pw_neginv),
                        mont_mul(l.z, r.z, pw_p, pw_neginv), mont_mul(l.w, r.w, pw_p, pw_neginv));
    } else {
      // kPresplit: value i0 + w + u of the row that starts at element
      // at - i0 - w has its digit e at byte 4 * (row start) + e * k1 +
      // (i0 + w + u) of the plane array; the bytes are the xor-128 pattern
      // already, so undo the xor the fragment read applies
      const int w = 4 * (threadIdx.x & 7);
      const uint8_t* xb =
          reinterpret_cast<const uint8_t*>(a.x[0]) + 4 * (at - i0 - w) + i0 + w;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u[e] = ((uint32_t)xb[e] | ((uint32_t)xb[a.k1 + e] << 8) |
                ((uint32_t)xb[2 * a.k1 + e] << 16) | ((uint32_t)xb[3 * a.k1 + e] << 24)) ^
               sm90::kDigitXor;
      return make_uint4(u[0], u[1], u[2], u[3]);
    }
  };
  int acc[kD * kTO / 2];  // the warpgroup's m64 x (kD * kTO) int32 tile, this thread's part
  sm90::mainloop<kD, kTO, kPointwise || kPresplit, kTM, tile(kTile).ring, tile(kTile).resident>(
      acc, a, chan, row0, planes, smem, load);

  const uint32_t* sc = a.scal + kScalWords * c;
  const uint32_t p = sc[0], c32 = sc[1], c32_sh = sc[2], p_neginv = sc[3];
  const uint32_t c64m = sc[4], two_p = sc[5];
  uint32_t chain[kMaxChain];  // zero past the chain's end: cond_sub(l, 0) == l
#pragma unroll
  for (int i = 0; i < kMaxChain; ++i) chain[i] = i < (int)sc[6] ? sc[7 + i] : 0u;
  const int32_t* cvz = a.cvec + (size_t)pz * kD * a.o;
  uint32_t* outz = a.out + (long long)c * a.out_chan + (long long)blk * a.out_blk;
  // digit d of output 8 jj + 2t + cc of row g + 8 hr: accumulator
  // 4 (d * kTO / 8 + jj) + 2 hr + cc (column d * kTO + 8 jj + 2t + cc of the tile)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = row0 + wrow + 8 * hr + g;
    if (m >= a.total_rows) continue;
    const int b = m / a.rows_per_poly;
    const int j = m - b * a.rows_per_poly;
#pragma unroll
    for (int jj = 0; jj < kTO / 8; ++jj) {
      const int oi0 = o0 + 8 * jj + 2 * t;
      uint32_t y[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int oi = oi0 + cc;
        const int q = 2 * hr + cc;
        // _combine: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
        uint64_t v = 0;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          v += (uint64_t)(uint32_t)(acc[4 * (d * (kTO / 8) + jj) + q] +
                                    table_word<kTile>(cvz + d * a.o + oi))
               << (8 * d);
        const uint32_t lo = (uint32_t)v;
        uint32_t hi = (uint32_t)(v >> 32);
        if constexpr (kD == 5)
          hi += (uint32_t)(acc[4 * (4 * (kTO / 8) + jj) + q] +
                           table_word<kTile>(cvz + 4 * a.o + oi));
        if constexpr (kScaled) {
          // _epilogue_scaled_lazy: lo*W + hi*(2^32 W)
          const size_t plane = (size_t)a.rows_per_poly * a.o;
          const int n_dg = kRegime == kGeneric ? 2 : 4;
          const uint32_t* dg = a.diag + (size_t)z * n_dg * plane + (size_t)j * a.o + oi;
          if (kRegime == kGeneric) {
            y[cc] = add_mod(mont_mul(lo, table_word<kTile>(dg), p, p_neginv),
                            mont_mul(hi, table_word<kTile>(dg + plane), p, p_neginv), p);
          } else {
            const uint32_t s0 = shoup_lazy(lo, table_word<kTile>(dg),
                                           table_word<kTile>(dg + plane), p);  // [0, 2p)
            const uint32_t s1 = shoup_lazy(hi, table_word<kTile>(dg + 2 * plane),
                                           table_word<kTile>(dg + 3 * plane), p);  // [0, 2p)
            if (kRegime == kLt30) {
              y[cc] = cond_sub(s0 + s1, two_p);  // s0 + s1 < 4p < 2^32
            } else {
              y[cc] = cond_sub(cond_sub(s0, p) + cond_sub(s1, p), p);
            }
          }
        } else {
          // _epilogue_canonical: (hi * 2^32 + lo) mod p in [0, p)
          const uint32_t r = kRegime == kGeneric ? mont_mul(hi, c64m, p, p_neginv)
                                                 : cond_sub(shoup_lazy(hi, c32, c32_sh, p), p);
          uint32_t l = lo;
#pragma unroll
          for (int i = 0; i < kMaxChain; ++i) l = cond_sub(l, chain[i]);
          y[cc] = kRegime == kGeneric ? add_mod(r, l, p) : cond_sub(r + l, p);
        }
      }
      uint32_t* dst = outz + (long long)b * a.out_b + (long long)j * a.t_r + (long long)oi0 * a.t_o;
      if (a.t_o == 1) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(y[0], y[1]);
      } else {
        dst[0] = y[0];
        dst[a.t_o] = y[1];
      }
    }
  }
}

// What the tiles need of a pass: whole stages and output tiles, operand
// chunks of 16 aligned bytes in one of the two memory orders (contiguous
// rows only for the pointwise and presplit first passes), aligned plane rows,
// and aligned output pairs where the outputs of a row are contiguous. n_x
// operand pointers are read 16 bytes at a time (the presplit planes byte by
// byte: none).
inline bool tiles_fit(const Pass& a, bool rows_only, int n_x, int outs) {
  if (a.k1 % kKC || a.o % outs || a.total_rows <= 0) return false;
  if (a.s_k == 1 ? a.s_r % 4 != 0
                 : (rows_only || a.s_r != 1 || a.s_k % 4 || a.rows_per_poly % 4))
    return false;
  if ((a.x_b | a.x_chan | a.x_blk) % 4) return false;
  if (a.t_o == 1 && ((a.out_b | a.out_chan | a.out_blk | a.t_r) % 2 || (uintptr_t)a.out & 7))
    return false;
  for (int l = 0; l < n_x; ++l)
    if (!sm90::aligned16(a.x[l])) return false;
  return sm90::aligned16(a.planes);
}

// static: each library (.cu) keeps its own instance and its own once-flags,
// where a shared template instance's local static would be one object in
// the whole process (GNU unique symbols), though every library's kernel
// needs its own opt-in
template <int kD, int kRegime, bool kScaled, bool kPointwise = false, bool kPresplit = false,
          int kTile = 0>
static cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  constexpr Tile kT = tile(kTile);
  if (!tiles_fit(a, kPointwise || kPresplit, kPresplit ? 0 : kPointwise ? 2 : a.n_limbs, kT.outs))
    return cudaErrorInvalidValue;
  auto kernel = matmod_pass<kD, kRegime, kScaled, kPointwise, kPresplit, kTile>;
  constexpr int smem = smem_bytes(kD, kTile);
  static bool smem_set[sm90::kMaxDevices];
  cudaError_t e = sm90::set_smem_once(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.total_rows + kT.rows - 1) / kT.rows, a.o / kT.outs, channels * a.nb);
  kernel<<<grid, sm90::threads(kT.rows), smem, stream>>>(a);
  return cudaGetLastError();
}

// The two passes of nb four-step forward block transforms of size n = n1 * n2
// over channels (nb = 1: one direct transform). The operand holds polynomials
// of nb * n values, block blk at offset blk * n. Column pass (rows (b, j <
// n2), contract i < n1 at x[i*n2 + j], diagonal d, per-block planes A_b) into
// scratch [C][nb][B][n2][n1], then row pass (rows (b, r < n1), contract j < n2
// at scratch[j*n1 + r], canonical, the channel's planes F) into out
// [C][B][nb * n] (bit-reversed). x holds four limb pointers; those at and past
// n_limbs are not read. x_chan is 0 for an operand shared by all channels.
inline void fwd_passes(Pass* col, Pass* row, const void* const x[4], int n_limbs,
                       long long x_chan, int batch, int n1, int n2, int nb,
                       const void* planes1, const void* cvec1,
                       const void* planes2, const void* cvec2, const void* diag,
                       const void* scal, void* scratch, void* out) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;  // the parent polynomial
  Pass a{};
  for (int l = 0; l < 4; ++l) a.x[l] = (const uint32_t*)x[l < n_limbs ? l : 0];
  a.x_b = poly;
  a.x_chan = x_chan;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 1;
  a.n_limbs = n_limbs;
  a.k1 = n1;
  a.s_k = n2;
  a.s_r = 1;
  a.rows_per_poly = n2;
  a.total_rows = batch * n2;
  a.o = n1;
  a.out_b = n;
  a.out_blk = (long long)batch * n;
  a.out_chan = (long long)batch * poly;
  a.t_r = n1;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *col = a;
  Pass b = a;
  for (int l = 0; l < 4; ++l) b.x[l] = (const uint32_t*)scratch;
  b.x_b = n;
  b.x_blk = (long long)batch * n;
  b.x_chan = (long long)batch * poly;
  b.planes_blk = 0;
  b.n_limbs = 1;
  b.k1 = n2;
  b.s_k = n1;
  b.s_r = 1;
  b.rows_per_poly = n1;
  b.total_rows = batch * n1;
  b.o = n2;
  b.out_b = poly;
  b.out_blk = n;
  b.t_r = n2;
  b.t_o = 1;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *row = b;
}

// The two passes of nb four-step inverse block transforms: row pass (rows (b,
// r < n1), contract j < n2 at x[r*n2 + j], diagonal e, the channel's planes
// G) into scratch [C][nb][B][n1][n2], then column pass (rows (b, k < n2),
// contract r < n1 at scratch[r*n2 + k], canonical, per-block planes A_inv,b)
// into out[s*n2 + k] of each block (standard order within the block).
inline void inv_passes(Pass* row, Pass* col, const void* x, int batch, int n1, int n2, int nb,
                       const void* planes1, const void* cvec1, const void* planes2,
                       const void* cvec2, const void* diag, const void* scal, void* scratch,
                       void* out) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;
  Pass a{};
  for (int l = 0; l < 4; ++l) a.x[l] = (const uint32_t*)x;
  a.x_b = poly;
  a.x_chan = (long long)batch * poly;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 0;
  a.n_limbs = 1;
  a.k1 = n2;
  a.s_k = 1;
  a.s_r = n2;
  a.rows_per_poly = n1;
  a.total_rows = batch * n1;
  a.o = n2;
  a.out_b = n;
  a.out_blk = (long long)batch * n;
  a.out_chan = (long long)batch * poly;
  a.t_r = n2;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *row = a;
  Pass b = a;
  for (int l = 0; l < 4; ++l) b.x[l] = (const uint32_t*)scratch;
  b.x_b = n;
  b.x_blk = (long long)batch * n;
  b.planes_blk = 1;
  b.k1 = n1;
  b.s_k = n2;
  b.s_r = 1;
  b.rows_per_poly = n2;
  b.total_rows = batch * n2;
  b.o = n1;
  b.out_b = poly;
  b.out_blk = n;
  b.t_r = 1;
  b.t_o = n2;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *col = b;
}

}  // namespace mxu32
