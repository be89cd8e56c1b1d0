// One exact modular GEMM pass of the four-step prime64 NTT on u64 limb pairs,
// for every odd prime 2^33 < p < 2^64: the building block of kernels K5 and
// K6 (mxu64_pass.cu) and K7a-K7d (mxu64_multi.cu), direct and with the
// stage-split hybrid's block tables. It is the 64-bit sibling of
// matmod_pass.cuh and shares its tiling and plane packing.
//
// The pass computes the JAX package's ops/mxu64.py math for a [rows, K] x
// [K, O] product mod p per polynomial and channel. The operand is a pair of
// u32 arrays (lo, hi), any u64 value; each limb word is split into four int8
// digits (byte - 128) by one xor and meets host-packed plane words in one
// __dp4a per output digit: kD = 5..9 int32 accumulators per output (the
// matrix entries' balanced radix-256 digits; 7 for 50-bit primes, 9 near
// 2^64). A pass whose operand is bounded below 2^56 (the plane diet's 7
// operand planes) gets a zero eighth plane row from the host, so every pass
// contracts 2 x K words. The accumulators plus the epilogue constants
// combine into the exact three-limb value V = sum_d U_d 2^(8d) (v0, v1, v2;
// the ninth digit sits at bit 64 and adds into v2), and an epilogue reduces
// it. Mid-pass results are any-u64 representatives that the next pass
// digit-splits, so each step gives the bit pattern of the limb-pair code
// (ops/u32.py, ops/mxu64.py), not just its residue class; native uint64_t,
// __umul64hi and unsigned __int128 stand in for limb pairs only where the
// two agree bit for bit.
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
// Tiling: a block owns kTM operand rows x kTO outputs x kD accumulators; 256
// threads, warp w owns rows w, w+8, ..., lane l output l. Strides of the
// operand and of the output are fields of the descriptor, so the mid-pass
// transpose is a stride of the second pass's loads. Grid = (row tiles over
// batch x rows, output tiles, z); rows past the batch edge are masked.
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

namespace mxu64 {

constexpr int kTM = 64;        // operand rows per block
constexpr int kTO = 32;        // outputs per block
constexpr int kKC = 32;        // contraction words per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: warp w owns rows w, w+8, ..., w+56
constexpr int kRowsPerThread = kTM / (kThreads / 32);

// Per-channel scalar record, 16 uint32 words = 8 little-endian u64 values
// (ops/mxu64.py _scal_vec64, extended by ops/mxu64_cuda.py scalar_record):
// p, 2^64 mod p, its Shoup companion, -p^-1 mod 2^64, floor(2^64 / p),
// 2p mod 2^64, 2^128 mod p (kMontMont only), 0.
constexpr int kScalWords = 16;

enum Mode { kShoup = 0, kMontShoup = 1, kMontMont = 2, kGl = 3 };

struct Pass {
  const uint32_t* x[2];  // operand limbs (lo, hi)
  const uint32_t* y[2];  // second operand (kPointwise only), same geometry
  long long x_b;         // elements between polynomials of the operand
  long long x_chan;      // elements between channels of the operand (0: shared)
  long long x_blk;       // elements between blocks of the operand
  int nb = 1;            // blocks per channel (grid z = channel * nb + block)
  int planes_blk = 0;    // planes / cvec indexed by z (per block), else by the channel
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int o;                 // outputs per row (multiple of kTO)
  long long out_b;       // elements between polynomials of the output
  long long out_chan;    // elements between channels of the output
  long long out_blk;     // elements between blocks of the output
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C or C * nb][2 * k1][kD * o] packed digit words
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
// in the load before the digit split.
template <int kD, int kMode, bool kScaled, bool kPointwise = false>
__global__ void __launch_bounds__(kThreads) matmod64_pass(Pass a) {
  static_assert(kD >= 5 && kD <= 9, "5 to 9 matrix digit planes");
  __shared__ uint32_t xs[kKC][kTM + 1];  // operand digit words, [k][row]
  __shared__ int32_t ps[kKC][kD * kTO];  // plane words, [k][digit * kTO + out]
  const int z = blockIdx.z;
  const int c = z / a.nb;           // channel
  const int blk = z - c * a.nb;     // block of the channel
  const int pz = a.planes_blk ? z : c;
  const int row0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTO;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int kw = 2 * a.k1;
  const int od = kD * a.o;
  const int32_t* planes = a.planes + (size_t)pz * kw * od;
  const Scalars sc = read_scalars(a.scal + kScalWords * c);

  int acc[kRowsPerThread][kD];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[q][d] = 0;

  for (int k0 = 0; k0 < kw; k0 += kKC) {
    const int limb = k0 / a.k1;
    const int i0 = k0 - limb * a.k1;
    const long long chan = (long long)c * a.x_chan + (long long)blk * a.x_blk;
    for (int t = threadIdx.x; t < kTM * kKC; t += kThreads) {
      int r, kk;  // neighbouring threads read neighbouring addresses
      if (a.s_k == 1) {
        kk = t % kKC;
        r = t / kKC;
      } else {
        r = t % kTM;
        kk = t / kTM;
      }
      const int m = row0 + r;
      uint32_t v = 0;
      if (m < a.total_rows) {
        const int b = m / a.rows_per_poly;
        const int j = m - b * a.rows_per_poly;
        const long long at = chan + (long long)b * a.x_b + (long long)(i0 + kk) * a.s_k +
                             (long long)j * a.s_r;
        if constexpr (kPointwise) {
          const uint64_t prod = mont_mul(pair(a.x[0][at], a.x[1][at]),
                                         pair(a.y[0][at], a.y[1][at]), sc.p, sc.p_neginv);
          v = limb ? (uint32_t)(prod >> 32) : (uint32_t)prod;
        } else {
          v = a.x[limb][at];
        }
      }
      xs[kk][r] = v ^ 0x80808080u;  // byte e = int8 digit e of v, minus 128
    }
    for (int t = threadIdx.x; t < kKC * kD * kTO; t += kThreads) {
      const int kk = t / (kD * kTO);
      const int q = t - kk * kD * kTO;
      const int d = q / kTO;
      ps[kk][q] = planes[(size_t)(k0 + kk) * od + d * a.o + o0 + (q - d * kTO)];
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKC; ++kk) {
      int w[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) w[d] = ps[kk][d * kTO + tx];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int xv = (int)xs[kk][ty + 8 * q];
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[q][d] = __dp4a(xv, w[d], acc[q][d]);
      }
    }
    __syncthreads();
  }

  const int oi = o0 + tx;
  const int32_t* cv = a.cvec + (size_t)pz * kD * a.o + oi;
  uint32_t cvr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) cvr[d] = (uint32_t)cv[d * a.o];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int m = row0 + ty + 8 * q;
    if (m >= a.total_rows) break;
    const int b = m / a.rows_per_poly;
    const int j = m - b * a.rows_per_poly;
    // _combine8: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
    uint64_t low = 0, mid = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) low += (uint64_t)((uint32_t)acc[q][d] + cvr[d]) << (8 * d);
#pragma unroll
    for (int d = 4; d < (kD < 8 ? kD : 8); ++d)
      mid += (uint64_t)((uint32_t)acc[q][d] + cvr[d]) << (8 * (d - 4));
    mid += low >> 32;
    const uint64_t v01 = (mid << 32) | (uint32_t)low;
    uint32_t v2 = (uint32_t)(mid >> 32);
    if constexpr (kD == 9) v2 += (uint32_t)acc[q][8] + cvr[8];  // digit 8 at bit 64
    uint64_t y;
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
        y = shoup_lazy(v01, w, w_sh, sc.p) + shoup_lazy_u32(v2, w2, w2_sh, sc.p);
      } else {
        const uint64_t rep = fold3to2<kMode>(v01, v2, sc);
        if constexpr (kMode == kGl) {
          y = gl_reduce128_lazy(rep * w, __umul64hi(rep, w));
        } else {
          y = mont_mul(rep, w, sc.p, sc.p_neginv);
        }
      }
    } else {
      y = canonical<kMode>(v01, v2, sc);
    }
    const long long at = (long long)c * a.out_chan + (long long)blk * a.out_blk +
                         (long long)b * a.out_b + (long long)j * a.t_r + (long long)oi * a.t_o;
    a.out[0][at] = (uint32_t)y;
    a.out[1][at] = (uint32_t)(y >> 32);
  }
}

template <int kD, int kMode, bool kScaled, bool kPointwise = false>
cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  const dim3 grid((a.total_rows + kTM - 1) / kTM, a.o / kTO, channels * a.nb);
  matmod64_pass<kD, kMode, kScaled, kPointwise><<<grid, kThreads, 0, stream>>>(a);
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
  a.x[0] = a.y[0] = (const uint32_t*)x_lo;
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
  b.x[0] = b.y[0] = (const uint32_t*)scratch_lo;
  b.x[1] = b.y[1] = (const uint32_t*)scratch_hi;
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
  a.x[0] = (const uint32_t*)x_lo;
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
  b.x[0] = b.y[0] = (const uint32_t*)scratch_lo;
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
