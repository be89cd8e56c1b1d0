// One exact modular GEMM pass of the four-step prime32 NTT, for every
// prime32 regime: the building block of kernels K1a-K1d (mxu32_multi.cu)
// and K2/K3 (mxu32_pass.cu).
//
// The pass computes the JAX package's ops/mxu32.py math for a [rows, K] x
// [K, O] product mod p per polynomial and channel: the operand (any u32
// representative, or a limb pair) is split into int8 digits (byte - 128,
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
// Tiling: a block owns kTM operand rows x kTO outputs x kD digit
// accumulators; 256 threads, warp w owns rows w, w+8, ..., lane l output l.
// The operator planes are packed on the host (ops/mxu32_cuda.py
// pack_planes) so that one int32 word holds the four plane rows that meet
// the four digits of one operand value: the digit split is one xor
// (v ^ 0x80808080) and the contraction one __dp4a per operand value and
// output digit. Strides of the operand and of the output are fields of the
// descriptor, so a mid-pass transpose is a stride of the next pass's loads.
// Grid = (row tiles over batch x rows, output tiles, channel); rows past the
// batch edge are masked.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxu32 {

constexpr int kTM = 64;        // operand rows per block
constexpr int kTO = 32;        // outputs per block
constexpr int kKC = 32;        // contraction words per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: warp w owns rows w, w+8, ..., w+56
constexpr int kRowsPerThread = kTM / (kThreads / 32);

// Per-channel scalar record (uint32 words), built by ops/mxu32_cuda.py
// scalar_record: p, 2^32 mod p, its Shoup companion, -p^-1 mod 2^32,
// 2^64 mod p, 2p mod 2^32, the chain length, then the chain of multiples of
// p that brings a u32 into [0, p) (ops/mxu32.py::_reduce_chain).
constexpr int kScalWords = 16;
constexpr int kMaxChain = kScalWords - 7;

enum Regime { kLt30 = 0, kLt31 = 1, kGeneric = 2 };

struct Pass {
  const uint32_t* x[2];  // operand limbs (x[1] read only if n_limbs == 2)
  long long x_b;         // elements between polynomials of the operand
  long long x_chan;      // elements between channels of the operand (0: shared)
  int n_limbs;
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int o;                 // outputs per row (multiple of kTO)
  long long out_b;       // elements between polynomials of the output
  long long out_chan;    // elements between channels of the output
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C][n_limbs * k1][kD * o] packed digit words
  const int32_t* cvec;    // [C][kD][o]
  const uint32_t* diag;   // [C][4 or 2][R][o] (scaled pass; see scale_tabs)
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

// kPointwise (K1d's first pass): the operand value is the Montgomery product
// mont_mul(x[0][i], x[1][i]) of two operands read at the same index (both
// any u32, one limb each), taken in the load before the digit split.
template <int kD, int kRegime, bool kScaled, bool kPointwise = false>
__global__ void __launch_bounds__(kThreads) matmod_pass(Pass a) {
  __shared__ uint32_t xs[kKC][kTM + 1];  // operand digit words, [k][row]
  __shared__ int32_t ps[kKC][kD * kTO];  // plane words, [k][digit * kTO + out]
  const int c = blockIdx.z;
  const int row0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTO;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int kw = a.n_limbs * a.k1;
  const int od = kD * a.o;
  const int32_t* planes = a.planes + (size_t)c * kw * od;
  uint32_t pw_p = 0, pw_neginv = 0;  // p and -p^-1 of the channel (kPointwise)
  if constexpr (kPointwise) {
    pw_p = a.scal[kScalWords * c];
    pw_neginv = a.scal[kScalWords * c + 3];
  }

  int acc[kRowsPerThread][kD];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[q][d] = 0;

  for (int k0 = 0; k0 < kw; k0 += kKC) {
    const int limb = k0 / a.k1;
    const int i0 = k0 - limb * a.k1;
    const uint32_t* xl = a.x[limb] + (long long)c * a.x_chan;
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
        const long long at =
            (long long)b * a.x_b + (long long)(i0 + kk) * a.s_k + (long long)j * a.s_r;
        v = xl[at];
        if constexpr (kPointwise) {
          v = mont_mul(v, a.x[1][(long long)c * a.x_chan + at], pw_p, pw_neginv);
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
#pragma unroll 4
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

  const uint32_t* sc = a.scal + kScalWords * c;
  const uint32_t p = sc[0], c32 = sc[1], c32_sh = sc[2], p_neginv = sc[3];
  const uint32_t c64m = sc[4], two_p = sc[5];
  uint32_t chain[kMaxChain];  // zero past the chain's end: cond_sub(l, 0) == l
#pragma unroll
  for (int i = 0; i < kMaxChain; ++i) chain[i] = i < (int)sc[6] ? sc[7 + i] : 0u;
  const int oi = o0 + tx;
  const int32_t* cv = a.cvec + (size_t)c * kD * a.o + oi;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int m = row0 + ty + 8 * q;
    if (m >= a.total_rows) break;
    const int b = m / a.rows_per_poly;
    const int j = m - b * a.rows_per_poly;
    // _combine: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
    uint64_t v = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) v += (uint64_t)(uint32_t)(acc[q][d] + cv[d * a.o]) << (8 * d);
    const uint32_t lo = (uint32_t)v;
    uint32_t hi = (uint32_t)(v >> 32);
    if constexpr (kD == 5) hi += (uint32_t)(acc[q][4] + cv[4 * a.o]);  // digit 4 at bit 32
    uint32_t y;
    if constexpr (kScaled) {
      // _epilogue_scaled_lazy: lo*W + hi*(2^32 W)
      const size_t plane = (size_t)a.rows_per_poly * a.o;
      const int n_dg = kRegime == kGeneric ? 2 : 4;
      const uint32_t* dg = a.diag + (size_t)c * n_dg * plane + (size_t)j * a.o + oi;
      if (kRegime == kGeneric) {
        y = add_mod(mont_mul(lo, dg[0], p, p_neginv), mont_mul(hi, dg[plane], p, p_neginv), p);
      } else {
        const uint32_t s0 = shoup_lazy(lo, dg[0], dg[plane], p);          // [0, 2p)
        const uint32_t s1 = shoup_lazy(hi, dg[2 * plane], dg[3 * plane], p);  // [0, 2p)
        if (kRegime == kLt30) {
          y = cond_sub(s0 + s1, two_p);  // s0 + s1 < 4p < 2^32
        } else {
          y = cond_sub(cond_sub(s0, p) + cond_sub(s1, p), p);
        }
      }
    } else {
      // _epilogue_canonical: (hi * 2^32 + lo) mod p in [0, p)
      const uint32_t r = kRegime == kGeneric ? mont_mul(hi, c64m, p, p_neginv)
                                             : cond_sub(shoup_lazy(hi, c32, c32_sh, p), p);
      uint32_t l = lo;
#pragma unroll
      for (int i = 0; i < kMaxChain; ++i) l = cond_sub(l, chain[i]);
      y = kRegime == kGeneric ? add_mod(r, l, p) : cond_sub(r + l, p);
    }
    a.out[(long long)c * a.out_chan + (long long)b * a.out_b + (long long)j * a.t_r +
          (long long)oi * a.t_o] = y;
  }
}

template <int kD, int kRegime, bool kScaled, bool kPointwise = false>
cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  const dim3 grid((a.total_rows + kTM - 1) / kTM, a.o / kTO, channels);
  matmod_pass<kD, kRegime, kScaled, kPointwise><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The two passes of a four-step forward transform over `channels` channels:
// column pass (rows (b, j < n2), contract i < n1 at x[i*n2 + j], diagonal d)
// into scratch [C][B][n2][n1], then row pass (rows (b, r < n1), contract
// j < n2 at scratch[j*n1 + r], canonical) into out [C][B][n] (bit-reversed).
inline void fwd_passes(Pass* col, Pass* row, const void* x0, const void* x1, int n_limbs,
                       int batch, int n1, int n2, const void* planes1, const void* cvec1,
                       const void* planes2, const void* cvec2, const void* diag,
                       const void* scal, void* scratch, void* out) {
  const int n = n1 * n2;
  Pass a{};
  a.x[0] = (const uint32_t*)x0;
  a.x[1] = (const uint32_t*)(n_limbs > 1 ? x1 : x0);
  a.x_b = n;
  a.x_chan = 0;
  a.n_limbs = n_limbs;
  a.k1 = n1;
  a.s_k = n2;
  a.s_r = 1;
  a.rows_per_poly = n2;
  a.total_rows = batch * n2;
  a.o = n1;
  a.out_b = n;
  a.out_chan = (long long)batch * n;
  a.t_r = n1;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *col = a;
  Pass b = a;
  b.x[0] = b.x[1] = (const uint32_t*)scratch;
  b.x_chan = (long long)batch * n;
  b.n_limbs = 1;
  b.k1 = n2;
  b.s_k = n1;
  b.s_r = 1;
  b.rows_per_poly = n1;
  b.total_rows = batch * n1;
  b.o = n2;
  b.t_r = n2;
  b.t_o = 1;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *row = b;
}

// The two passes of a four-step inverse transform: row pass (rows (b, r <
// n1), contract j < n2 at x[r*n2 + j], diagonal e) into scratch [C][B][n1][n2],
// then column pass (rows (b, k < n2), contract r < n1 at scratch[r*n2 + k],
// canonical) into out[s*n2 + k] (standard order).
inline void inv_passes(Pass* row, Pass* col, const void* x, int batch, int n1, int n2,
                       const void* planes1, const void* cvec1, const void* planes2,
                       const void* cvec2, const void* diag, const void* scal, void* scratch,
                       void* out) {
  const int n = n1 * n2;
  Pass a{};
  a.x[0] = a.x[1] = (const uint32_t*)x;
  a.x_b = n;
  a.x_chan = (long long)batch * n;
  a.n_limbs = 1;
  a.k1 = n2;
  a.s_k = 1;
  a.s_r = n2;
  a.rows_per_poly = n1;
  a.total_rows = batch * n1;
  a.o = n2;
  a.out_b = n;
  a.out_chan = (long long)batch * n;
  a.t_r = n2;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *row = a;
  Pass b = a;
  b.x[0] = b.x[1] = (const uint32_t*)scratch;
  b.k1 = n1;
  b.s_k = n2;
  b.s_r = 1;
  b.rows_per_poly = n2;
  b.total_rows = batch * n2;
  b.o = n1;
  b.t_r = 1;
  b.t_o = n2;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *col = b;
}

}  // namespace mxu32
