// One exact modular GEMM pass of the four-step prime64 NTT on u64 limb pairs,
// for every odd prime 2^33 < p < 2^64: the building block of kernels K5 and
// K6 (mxu64_pass.cu) and K7a-K7d (mxu64_multi.cu), direct and with the
// stage-split hybrid's block tables. Replaces the GEMM body shared by the TPU
// kernels of concrete_ntt_tpu/ops/mxu64_pallas.py (_build_call :32,
// _build_pass_call64 :197, _build_multi_call64 :522). It is the 64-bit
// sibling of matmod_pass.cuh and shares its mainloop (gemm_sm90.cuh).
//
// The pass computes the JAX package's ops/mxu64.py math for a [rows, K] x
// [K, O] product mod p per polynomial and channel. The operand is a pair of
// u32 arrays (lo, hi), any u64 value (or, in K5's forward column pass only,
// the four limbs of a u128 whose residue split folds into the product as 16
// operand planes: n_limbs = 4); each limb word is split into four int8
// digits (byte - 128) by one xor and meets the balanced-digit int8 operator
// planes in kD = 5..9 int32 accumulators per output (the matrix entries'
// radix-256 digits; 7 for 50-bit primes, 9 near 2^64). A pass whose operand
// is bounded below 2^56 (the plane diet's 7 operand planes) gets a zero
// eighth plane row from the host, so every pass contracts n_limbs x K words.
// The accumulators plus the epilogue constants combine into the exact
// three-limb value V = sum_d U_d 2^(8d) (v0, v1, v2; the ninth digit sits at
// bit 64 and adds into v2), and an epilogue reduces it. Mid-pass results are
// any-u64 representatives that the next pass digit-splits, so each step gives
// the bit pattern of the limb-pair code (ops/u32.py, ops/mxu64.py), not just
// its residue class; native uint64_t, __umul64hi and unsigned __int128 stand
// in for limb pairs only where the two agree bit for bit.
//
// Epilogue regimes (kMode; ops/mxu64.py _scale_mode and _fold3to2):
//   kShoup     p < 2^62. scaled: (v0,v1)*W + v2*(2^64 W) as two lazy Shoup
//              multiplies, < 4p. canonical: Shoup fold of v2, approximate
//              Barrett quotient, two conditional subtracts.
//   kMontShoup 2^62 <= p < 2^63. Shoup fold; scaled: Montgomery multiply by
//              W 2^64 mod p. canonical: cond_sub 2p, cond_sub p.
//   kMontMont  p >= 2^63, not Goldilocks. The top limb folds through a
//              Montgomery multiply by 2^128 mod p; canonical: one cond_sub.
//   kGl        Goldilocks 2^64 - 2^32 + 1. Shift/add fold; scaled: 128-bit
//              product reduced by shifts and adds; canonical: one cond_sub.
//
// What bounds it on the H100. A pass is an int8 GEMM of B*R rows, 4 *
// n_limbs * K contraction bytes and kD*O columns, exact in int32 (the JAX
// package's assert_accumulator_exact), whose operands are a few MiB: at the
// main paths' shapes (K5 at n = 2^14, B = 16 with nine planes: 4.8e9 int8
// MACs against about 8 MiB) its int8 operations take longer than its bytes
// even at the tensor cores' rate, and tens of times longer on the CUDA
// cores' byte dot products.
//
// Design: the 32-bit pass's mainloop (gemm_sm90.cuh, the design of
// matmod_pass.cuh:33-66) with a tile of half the outputs: Hopper's
// warpgroup product on the int8 tensor cores, wgmma.mma_async m64nNk32
// .s32.s8.s8 with N = 16 * kD = 80..144 (every value a valid s8 shape; 32
// outputs would need N = 288 > 256 at nine planes and 144 accumulators a
// thread), A = operand words from registers (the digit split stays one xor),
// B from shared memory in K-major tiles that the host packs as the exact
// image of the descriptor's core matrices (ops/mxu64_cuda.py pack_planes64 =
// mxu32_cuda.pack_planes_kmajor with 16-output tiles, after a zero eighth
// plane row where the operand takes 5-7 planes). The products are exact
// integers, so the accumulators hold the exact digit sums of ops/mxu64.py
// bit for bit. The N axis is the kD digit columns of kTO outputs; the n8
// chunks of digit d sit at the same output offsets for every d, so each
// thread holds all kD accumulators of its own (row, output) pairs and the
// combine and every epilogue stay per element.
//
// Tiling: a block owns kTM = 128 operand rows x kTO = 16 outputs x kD
// digits, 8 kD = 40..72 accumulators a thread, at most 128 registers (two
// blocks an SM; no instance spills). The contraction is n_limbs * K words
// (2, or 4 for a u128 operand; K % 32 == 0). Dynamic shared memory 84-108
// KiB (kD 5-9): two blocks an SM. Half-width tiles also double the grid
// against 32 outputs: K5 at (2^14, 16) runs 16 x 8 = 128 blocks a pass on
// the 132 SMs. Strides of the operand and of the output are fields of the
// descriptor, so the mid-pass transpose is a stride of the second pass's
// loads. Grid = (row tiles over batch x rows, output tiles, z); rows past
// the batch edge are zero-filled and not stored.
//
// The z axis is channel * nb + block. nb = 1 is a direct transform. With the
// stage-split hybrid's block tables (ops/stagesplit.py) a transform of size
// nb * n is nb block transforms of size n after the prefix butterflies: block
// `blk` reads and writes its n-slice of each polynomial in place (x_blk,
// out_blk; the polynomial stride x_b / out_b is then the parent's size), takes
// its own diagonal rows, and takes its own planes where the pass is the
// column operator (A_b, A_inv,b: planes_blk) or the channel's where it is the
// shared row operator (F, G). The scalar record is the channel's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace mxu64 {

using sm90::kKC;
using sm90::kTM;
using sm90::kThreads;
constexpr int kTO = 16;  // outputs per block (kD digit columns each)

// words of one stage of the plane tile: kD * kTO rows (N) of kKC words (K),
// in the host-packed order of ops/mxu64_cuda.py pack_planes64 (8-row groups
// of eight 16-byte chunks of eight rows: wgmma's K-major core matrices
// without swizzle)
__host__ __device__ constexpr int plane_stage(int kD) { return sm90::plane_stage(kD, kTO); }
__host__ __device__ constexpr int smem_bytes(int kD) { return sm90::smem_bytes(kD, kTO); }

// Per-channel scalar record, 16 uint32 words = 8 little-endian u64 values
// (ops/mxu64.py _scal_vec64, extended by ops/mxu64_cuda.py scalar_record):
// p, 2^64 mod p, its Shoup companion, -p^-1 mod 2^64, floor(2^64 / p),
// 2p mod 2^64, 2^128 mod p (kMontMont only), 0.
constexpr int kScalWords = 16;

enum Mode { kShoup = 0, kMontShoup = 1, kMontMont = 2, kGl = 3 };

struct Pass {
  const uint32_t* x[4];  // operand limbs (lo, hi; four of a u128: x[l] read only if l < n_limbs)
  const uint32_t* y[2];  // second operand (kPointwise only), same geometry
  long long x_b;         // elements between polynomials of the operand
  long long x_chan;      // elements between channels of the operand (0: shared)
  long long x_blk;       // elements between blocks of the operand
  int nb = 1;            // blocks per channel (grid z = channel * nb + block)
  int planes_blk = 0;    // planes / cvec indexed by z (per block), else by the channel
  int n_limbs = 2;       // operand limbs contracted (4: K5's forward of a u128 operand)
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int o;                 // outputs per row (multiple of kTO)
  long long out_b;       // elements between polynomials of the output
  long long out_chan;    // elements between channels of the output
  long long out_blk;     // elements between blocks of the output
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C or C * nb][o / kTO][n_limbs * k1 / kKC][plane_stage(kD)] words
  const int32_t* cvec;    // [C or C * nb][kD][o]
  const uint32_t* diag;   // [C * nb][8 or 2][R][o] (scaled pass; _scale_tables64 order)
  const uint32_t* scal;   // [C][kScalWords]
  uint32_t* out[2];       // result limbs (lo, hi)
};

struct Scalars {
  uint64_t p, c64, c64_sh, p_neginv, barrett, two_p, c64_mont;
};

__device__ __forceinline__ Scalars read_scalars(const uint32_t* sc) {
  const uint64_t* s = reinterpret_cast<const uint64_t*>(sc);  // 64-byte records
  return Scalars{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
}

__device__ __forceinline__ uint64_t pair(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t cond_sub(uint64_t x, uint64_t m) {
  return x >= m ? x - m : x;
}

// z*w - floor(z*w_shoup / 2^64)*p, wrapping (ops/u32.py shoup_mul_lazy64)
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t z, uint64_t w, uint64_t w_sh,
                                               uint64_t p) {
  return z * w - __umul64hi(z, w_sh) * p;
}

// The same for a u32 operand (ops/u32.py shoup_mul_u32_lazy64): its
// two-multiply quotient is bits [64, 96) of z*w_shoup, which is all of
// __umul64hi(z, w_shoup) since z < 2^32.
__device__ __forceinline__ uint64_t shoup_lazy_u32(uint32_t z, uint64_t w, uint64_t w_sh,
                                                   uint64_t p) {
  return w * z - p * (uint64_t)(uint32_t)__umul64hi((uint64_t)z, w_sh);
}

// REDC a*b*2^-64 mod p (ops/u32.py mont_mul64) for any u64 a, b: the carry
// out of T_hi + mulhi(m, p) + (T_lo != 0) is kept; on it the wrapped sum gets
// 2^64 - p added, else one conditional subtract. With two arbitrary
// operands the result may lie in [p, 2p), as the limb-pair code's.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t p,
                                             uint64_t p_neginv) {
  const uint64_t t_lo = a * b, t_hi = __umul64hi(a, b);
  const uint64_t mp_hi = __umul64hi(t_lo * p_neginv, p);
  const uint64_t s = t_hi + mp_hi;
  const uint64_t s2 = s + (t_lo != 0);
  const bool over = (s < t_hi) | (s2 < s);
  return over ? s2 + (0 - p) : cond_sub(s2, p);
}

// 128-bit value (lo, hi) mod Goldilocks as a u64 representative
// (ops/u32.py gl_reduce128_lazy): hi = l2 + l3 2^32, 2^64 = 2^32 - 1,
// 2^96 = -1; the borrow and the carry are compensated by 2^32 - 1.
__device__ __forceinline__ uint64_t gl_reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint64_t l2 = (uint32_t)hi, l3 = hi >> 32;
  uint64_t t0 = lo - l3;
  if (lo < l3) t0 -= 0xFFFFFFFFull;
  const uint64_t t1 = (l2 << 32) - l2;
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += 0xFFFFFFFFull;
  return t2;
}

// (v0, v1, v2) -> a u64 representative of the same residue (_fold3to2). The
// second carry round is taken always: where 3p < 2^64 it cannot carry, and
// the limb-pair code's single round gives the same bits.
template <int kMode>
__device__ __forceinline__ uint64_t fold3to2(uint64_t v01, uint32_t v2, const Scalars& c) {
  if constexpr (kMode == kGl) {
    // v2 * 2^64 = v2 * (2^32 - 1): t = (v2 << 32) - v2 as the pair (-v2, v2 - [v2 != 0])
    const uint64_t t = pair(0u - v2, v2 - (v2 != 0u));
    uint64_t s = v01 + t;
    if (s < t) s += 0xFFFFFFFFull;
    return s;
  } else {
    const uint64_t t = kMode == kMontMont ? mont_mul((uint64_t)v2, c.c64_mont, c.p, c.p_neginv)
                                          : shoup_lazy_u32(v2, c.c64, c.c64_sh, c.p);
    uint64_t s = v01 + t;
    if (s < t) {
      s += c.c64;
      if (s < c.c64) s += c.c64;
    }
    return s;
  }
}

// _canonical: V mod p in [0, p)
template <int kMode>
__device__ __forceinline__ uint64_t canonical(uint64_t v01, uint32_t v2, const Scalars& c) {
  const uint64_t rep = fold3to2<kMode>(v01, v2, c);
  if constexpr (kMode == kGl || kMode == kMontMont) {
    return cond_sub(rep, c.p);  // rep < 2^64 < 2p
  } else if constexpr (kMode == kMontShoup) {
    return cond_sub(cond_sub(rep, c.two_p), c.p);  // rep < 2^64 < 4p
  } else {
    // approximate Barrett: q in [floor(rep/p) - 2, floor(rep/p)]
    const uint64_t r = rep - __umul64hi(rep, c.barrett) * c.p;
    return cond_sub(cond_sub(r, c.two_p), c.p);
  }
}

// kPointwise (K7d's first pass): the operand value is the Montgomery product
// mont_mul(x, y) of two operands read at the same index (both any u64), taken
// in the load before the digit split, so the operand tile is loaded with
// plain loads and stores (contiguous rows only); every other pass copies it
// with cp.async. The mainloop is gemm_sm90.cuh's.
template <int kD, int kMode, bool kScaled, bool kPointwise = false>
__global__ void __launch_bounds__(kThreads, 2) matmod64_pass(Pass a) {
  static_assert(kD >= 5 && kD <= 9, "5 to 9 matrix digit planes");
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
                           ((size_t)pz * (a.o / kTO) + blockIdx.y) * nk * plane_stage(kD);
  const long long chan = (long long)c * a.x_chan + (long long)blk * a.x_blk;
  uint64_t pw_p = 0, pw_neginv = 0;  // p and -p^-1 of the channel (kPointwise)
  if constexpr (kPointwise) {
    const Scalars sc = read_scalars(a.scal + kScalWords * c);
    pw_p = sc.p;
    pw_neginv = sc.p_neginv;
  }
  // kPointwise: limb `limb` of mont_mul(x, y) at each of the chunk's four values
  auto load = [&](long long at, int, int limb) {
    const uint4 xl = *reinterpret_cast<const uint4*>(a.x[0] + at);
    const uint4 xh = *reinterpret_cast<const uint4*>(a.x[1] + at);
    const uint4 yl = *reinterpret_cast<const uint4*>(a.y[0] + at);
    const uint4 yh = *reinterpret_cast<const uint4*>(a.y[1] + at);
    auto word = [&](uint32_t xlo, uint32_t xhi, uint32_t ylo, uint32_t yhi) {
      const uint64_t prod = mont_mul(pair(xlo, xhi), pair(ylo, yhi), pw_p, pw_neginv);
      return limb ? (uint32_t)(prod >> 32) : (uint32_t)prod;
    };
    return make_uint4(word(xl.x, xh.x, yl.x, yh.x), word(xl.y, xh.y, yl.y, yh.y),
                      word(xl.z, xh.z, yl.z, yh.z), word(xl.w, xh.w, yl.w, yh.w));
  };
  int acc[kD * kTO / 2];  // the warpgroup's m64 x (kD * kTO) int32 tile, this thread's part
  sm90::mainloop<kD, kTO, kPointwise>(acc, a, chan, row0, planes, smem, load);

  const Scalars sc = read_scalars(a.scal + kScalWords * c);
  const int32_t* cvz = a.cvec + (size_t)pz * kD * a.o;
  const long long out_z = (long long)c * a.out_chan + (long long)blk * a.out_blk;
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
      uint64_t y[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int oi = oi0 + cc;
        const int q = 2 * hr + cc;
        uint32_t u[kD];  // _combine8: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
#pragma unroll
        for (int d = 0; d < kD; ++d)
          u[d] = (uint32_t)acc[4 * (d * (kTO / 8) + jj) + q] + (uint32_t)cvz[d * a.o + oi];
        uint64_t low = 0, mid = 0;
#pragma unroll
        for (int d = 0; d < 4; ++d) low += (uint64_t)u[d] << (8 * d);
#pragma unroll
        for (int d = 4; d < (kD < 8 ? kD : 8); ++d) mid += (uint64_t)u[d] << (8 * (d - 4));
        mid += low >> 32;
        const uint64_t v01 = (mid << 32) | (uint32_t)low;
        uint32_t v2 = (uint32_t)(mid >> 32);
        if constexpr (kD == 9) v2 += u[8];  // digit 8 at bit 64
        if constexpr (kScaled) {
          const size_t plane = (size_t)a.rows_per_poly * a.o;
          const int n_dg = kMode == kShoup ? 8 : 2;
          const uint32_t* dg = a.diag + (size_t)z * n_dg * plane + (size_t)j * a.o + oi;
          const uint64_t w = pair(dg[0], dg[plane]);
          if constexpr (kMode == kShoup) {
            // _scaled_epilogue: (v0, v1)*W + v2*(2^64 W), each lazy in [0, 2p)
            const uint64_t w_sh = pair(dg[2 * plane], dg[3 * plane]);
            const uint64_t w2 = pair(dg[4 * plane], dg[5 * plane]);
            const uint64_t w2_sh = pair(dg[6 * plane], dg[7 * plane]);
            y[cc] = shoup_lazy(v01, w, w_sh, sc.p) + shoup_lazy_u32(v2, w2, w2_sh, sc.p);
          } else {
            const uint64_t rep = fold3to2<kMode>(v01, v2, sc);
            if constexpr (kMode == kGl) {
              y[cc] = gl_reduce128_lazy(rep * w, __umul64hi(rep, w));
            } else {
              y[cc] = mont_mul(rep, w, sc.p, sc.p_neginv);
            }
          }
        } else {
          y[cc] = canonical<kMode>(v01, v2, sc);
        }
      }
      const long long at =
          out_z + (long long)b * a.out_b + (long long)j * a.t_r + (long long)oi0 * a.t_o;
      if (a.t_o == 1) {
        *reinterpret_cast<uint2*>(a.out[0] + at) = make_uint2((uint32_t)y[0], (uint32_t)y[1]);
        *reinterpret_cast<uint2*>(a.out[1] + at) =
            make_uint2((uint32_t)(y[0] >> 32), (uint32_t)(y[1] >> 32));
      } else {
        a.out[0][at] = (uint32_t)y[0];
        a.out[0][at + a.t_o] = (uint32_t)y[1];
        a.out[1][at] = (uint32_t)(y[0] >> 32);
        a.out[1][at + a.t_o] = (uint32_t)(y[1] >> 32);
      }
    }
  }
}

// What the tiles need of a pass: whole stages (k1 % kKC == 0, so a stage
// never straddles two limbs) and output tiles, operand chunks of 16 aligned
// bytes in one of the two memory orders (contiguous rows only for the
// pointwise first pass, which reads x and y 16 bytes at a time), aligned
// plane tiles, and aligned output pairs where the outputs of a row are
// contiguous.
inline bool tiles_fit(const Pass& a, bool pointwise) {
  if (a.k1 % kKC || a.o % kTO || a.total_rows <= 0 || a.n_limbs < 1 || a.n_limbs > 4)
    return false;
  if (a.s_k == 1 ? a.s_r % 4 != 0
                 : (pointwise || a.s_r != 1 || a.s_k % 4 || a.rows_per_poly % 4))
    return false;
  if ((a.x_b | a.x_chan | a.x_blk) % 4) return false;
  if (a.t_o == 1 && ((a.out_b | a.out_chan | a.out_blk | a.t_r) % 2 ||
                     (uintptr_t)a.out[0] & 7 || (uintptr_t)a.out[1] & 7))
    return false;
  for (int l = 0; l < (pointwise ? 2 : a.n_limbs); ++l)
    if (!sm90::aligned16(a.x[l])) return false;
  if (pointwise && !(sm90::aligned16(a.y[0]) && sm90::aligned16(a.y[1]))) return false;
  return sm90::aligned16(a.planes);
}

// static: each library keeps its own once-flags (see matmod_pass.cuh launch)
template <int kD, int kMode, bool kScaled, bool kPointwise = false>
static cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  if (!tiles_fit(a, kPointwise)) return cudaErrorInvalidValue;
  auto kernel = matmod64_pass<kD, kMode, kScaled, kPointwise>;
  constexpr int smem = smem_bytes(kD);
  static bool smem_set[sm90::kMaxDevices];
  cudaError_t e = sm90::set_smem_once(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.total_rows + kTM - 1) / kTM, a.o / kTO, channels * a.nb);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Tables of a two-pass transform, as the wrappers of ops/mxu64_cuda.py hold them.
struct Tables {
  const void *planes1, *cvec1, *planes2, *cvec2, *diag, *scal;
};

// The two passes of nb four-step forward block transforms of size n = n1 * n2
// over channels (nb = 1: one direct transform). The operand holds polynomials
// of nb * n values, block blk at offset blk * n. Column pass (rows (b, j <
// n2), contract i < n1 at x[i*n2 + j], diagonal d, per-block planes A_b) into
// scratch [C][nb][B][n2][n1], then row pass (rows (b, r < n1), contract j < n2
// at scratch[j*n1 + r], canonical, the channel's planes F) into out
// [C][B][nb * n] (bit-reversed). x_chan is 0 for an operand shared by all
// channels.
inline void fwd_passes(Pass* col, Pass* row, const void* x_lo, const void* x_hi,
                       long long x_chan, int batch, int n1, int n2, int nb, const Tables& t,
                       void* scratch_lo, void* scratch_hi, void* out_lo, void* out_hi) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;  // the parent polynomial
  Pass a{};
  a.x[0] = a.x[2] = a.x[3] = a.y[0] = (const uint32_t*)x_lo;  // past n_limbs: not read
  a.x[1] = a.y[1] = (const uint32_t*)x_hi;
  a.x_b = poly;
  a.x_chan = x_chan;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 1;
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
  a.planes = (const int32_t*)t.planes1;
  a.cvec = (const int32_t*)t.cvec1;
  a.diag = (const uint32_t*)t.diag;
  a.scal = (const uint32_t*)t.scal;
  a.out[0] = (uint32_t*)scratch_lo;
  a.out[1] = (uint32_t*)scratch_hi;
  *col = a;
  Pass b = a;
  b.x[0] = b.x[2] = b.x[3] = b.y[0] = (const uint32_t*)scratch_lo;
  b.x[1] = b.y[1] = (const uint32_t*)scratch_hi;
  b.n_limbs = 2;  // the mid-pass value is a limb pair whatever the operand was
  b.x_b = n;
  b.x_blk = (long long)batch * n;
  b.x_chan = (long long)batch * poly;
  b.planes_blk = 0;
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
  b.planes = (const int32_t*)t.planes2;
  b.cvec = (const int32_t*)t.cvec2;
  b.diag = nullptr;
  b.out[0] = (uint32_t*)out_lo;
  b.out[1] = (uint32_t*)out_hi;
  *row = b;
}

// The two passes of nb four-step inverse block transforms: row pass (rows (b,
// r < n1), contract j < n2 at x[r*n2 + j], diagonal e, the channel's planes
// G) into scratch [C][nb][B][n1][n2], then column pass (rows (b, k < n2),
// contract r < n1 at scratch[r*n2 + k], canonical, per-block planes A_inv,b)
// into out[s*n2 + k] of each block (standard order within the block). (y_lo,
// y_hi) is the second operand of a pointwise first pass, else null.
inline void inv_passes(Pass* row, Pass* col, const void* x_lo, const void* x_hi,
                       const void* y_lo, const void* y_hi, int batch, int n1, int n2, int nb,
                       const Tables& t, void* scratch_lo, void* scratch_hi, void* out_lo,
                       void* out_hi) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;
  Pass a{};
  a.x[0] = a.x[2] = a.x[3] = (const uint32_t*)x_lo;
  a.x[1] = (const uint32_t*)x_hi;
  a.y[0] = (const uint32_t*)(y_lo ? y_lo : x_lo);
  a.y[1] = (const uint32_t*)(y_hi ? y_hi : x_hi);
  a.x_b = poly;
  a.x_chan = (long long)batch * poly;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 0;
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
  a.planes = (const int32_t*)t.planes1;
  a.cvec = (const int32_t*)t.cvec1;
  a.diag = (const uint32_t*)t.diag;
  a.scal = (const uint32_t*)t.scal;
  a.out[0] = (uint32_t*)scratch_lo;
  a.out[1] = (uint32_t*)scratch_hi;
  *row = a;
  Pass b = a;
  b.x[0] = b.x[2] = b.x[3] = b.y[0] = (const uint32_t*)scratch_lo;
  b.x[1] = b.y[1] = (const uint32_t*)scratch_hi;
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
  b.planes = (const int32_t*)t.planes2;
  b.cvec = (const int32_t*)t.cvec2;
  b.diag = nullptr;
  b.out[0] = (uint32_t*)out_lo;
  b.out[1] = (uint32_t*)out_hi;
  *col = b;
}

}  // namespace mxu64
