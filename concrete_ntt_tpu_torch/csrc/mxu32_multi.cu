// Channel-grid four-step prime32 NTT for Hopper (sm_90a): kernels K1a and K1b.
//
// Replaces the TPU kernel concrete_ntt_tpu/ops/mxu32_pallas.py::_build_multi_call:
//   K1a  k1a_fwd_wide_multi  <- its fwd branch (fwd_wide_multi, kernel body :367-397)
//   K1b  k1b_inv_multi       <- its inv branch (inv_multi, kernel body :398-412)
// for every CRT channel prime 2^29 < p < 2^30 and 2^11 <= n <= 2^15.
//
// What is computed is the JAX kernel's math (ops/mxu32.py): a four-step NTT
// made of two exact modular matrix products per channel and polynomial.
// Each product splits the operand into four int8 digits (byte - 128, the
// xor-128 bit pattern of _digit8), multiplies them with balanced-digit int8
// operator planes, accumulates in int32 (exact by assert_accumulator_exact),
// combines the four digit accumulators into a (lo, hi) u32 pair and reduces
// it with Shoup multiplies:
//   K1a: transpose [n1,n2]->[n2,n1] . planes1 (A, or A with the u64->residue
//        split folded in as 8 operand digit planes) . scaled-lazy epilogue by
//        the diagonal d . transpose . planes2 (F) . canonical epilogue.
//   K1b: planes1 (G) . scaled-lazy epilogue by the diagonal e . transpose .
//        planes2 (scale-folded A_inv) . canonical epilogue . transpose.
//
// Design. Each product is one launch of matmod_pass: a tiled GEMM with the
// digit split in the operand load and the combine + reduction in the
// epilogue. The operator planes are packed on the host so that one int32
// word holds the four plane rows that meet the four digits of one u32
// operand value: the digit split is then one xor (v ^ 0x80808080) and the
// contraction one __dp4a per operand value and output digit. The [n2, n1]
// intermediate goes through global memory (the wrapper's scratch tensor);
// the mid-pass transpose is only a stride of the second pass's loads. Grid
// = (row tiles over batch x rows, output tiles, channel); rows past the
// batch edge are masked, so any batch size works. Both launches of a
// kernel go on the caller's stream; the C entry point returns
// cudaGetLastError() after them.
//
// Bound at n = 2^14, B = 8, five channels: K1a (two limbs) needs 1.0e9
// dp4a (4.0e9 int8 MACs; K1b 0.67e9 dp4a) and moves about 12 MiB (operand,
// scratch written and read back, result, and the 3.75 MiB of operator
// tables, which L2 holds). At 3.35 TB/s the bytes take a few microseconds;
// the dp4a issue takes tens, so the kernel is bound by the integer pipes,
// not by memory. This first kernel uses dp4a on the CUDA cores and leaves
// int8 tensor-core tiles (mma.sync / wgmma) to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;        // operand rows per block
constexpr int kTO = 32;        // outputs per block (4 digit accumulators each)
constexpr int kKC = 32;        // contraction words per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: warp w owns rows w, w+8, ..., w+56
constexpr int kRowsPerThread = kTM / (kThreads / 32);

struct Pass {
  const uint32_t* x[2];  // operand limbs, [.., B, n] (x[1] read only if n_limbs == 2)
  long long x_chan;      // elements between channels of the operand (0: shared)
  int n_limbs;
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int n;                 // polynomial length
  int o;                 // outputs per row (multiple of kTO)
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C][n_limbs * k1][4 * o] packed digit words
  const int32_t* cvec;    // [C][4][o]
  const uint32_t* diag;   // [C][4][R][o]: w, w_shoup, w*2^32, its shoup (scaled pass)
  const uint32_t* scal;   // [C][5]: p, 2^32 mod p, its shoup, 0, 2p
  uint32_t* out;          // [C][B][n]
};

template <bool kScaled>
__global__ void __launch_bounds__(kThreads) matmod_pass(Pass a) {
  __shared__ uint32_t xs[kKC][kTM + 1];  // operand digit words, [k][row]
  __shared__ int32_t ps[kKC][4 * kTO];   // plane words, [k][digit * kTO + out]
  const int c = blockIdx.z;
  const int row0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTO;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int kw = a.n_limbs * a.k1;
  const int o4 = 4 * a.o;
  const int32_t* planes = a.planes + (size_t)c * kw * o4;

  int acc[kRowsPerThread][4];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[q][d] = 0;

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
        v = xl[(long long)b * a.n + (long long)(i0 + kk) * a.s_k + (long long)j * a.s_r];
      }
      xs[kk][r] = v ^ 0x80808080u;  // byte e = int8 digit e of v, minus 128
    }
    for (int t = threadIdx.x; t < kKC * 4 * kTO; t += kThreads) {
      const int kk = t / (4 * kTO);
      const int q = t - kk * 4 * kTO;
      const int d = q / kTO;
      ps[kk][q] = planes[(size_t)(k0 + kk) * o4 + d * a.o + o0 + (q - d * kTO)];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      int w[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) w[d] = ps[kk][d * kTO + tx];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int xv = (int)xs[kk][ty + 8 * q];
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[q][d] = __dp4a(xv, w[d], acc[q][d]);
      }
    }
    __syncthreads();
  }

  const uint32_t* sc = a.scal + 5 * c;
  const uint32_t p = sc[0], c32 = sc[1], c32_sh = sc[2], two_p = sc[4];
  const int oi = o0 + tx;
  const int batch = a.total_rows / a.rows_per_poly;
  const int32_t* cv = a.cvec + (size_t)c * 4 * a.o + oi;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int m = row0 + ty + 8 * q;
    if (m >= a.total_rows) break;
    const int b = m / a.rows_per_poly;
    const int j = m - b * a.rows_per_poly;
    // _sc_combine: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
    uint64_t v = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) v += (uint64_t)(uint32_t)(acc[q][d] + cv[d * a.o]) << (8 * d);
    const uint32_t lo = (uint32_t)v;
    const uint32_t hi = (uint32_t)(v >> 32);
    uint32_t y;
    if (kScaled) {
      // _sc_epilogue_scaled_lazy: lo*W + hi*(2^32 W) as a [0, 2p) representative
      const size_t plane = (size_t)a.rows_per_poly * a.o;
      const uint32_t* dg = a.diag + (size_t)c * 4 * plane + (size_t)j * a.o + oi;
      const uint32_t w = dg[0], w_sh = dg[plane], w32 = dg[2 * plane], w32_sh = dg[3 * plane];
      const uint32_t s = (lo * w - __umulhi(lo, w_sh) * p) + (hi * w32 - __umulhi(hi, w32_sh) * p);
      y = s >= two_p ? s - two_p : s;
    } else {
      // _sc_epilogue_canonical: (hi * 2^32 + lo) mod p in [0, p)
      uint32_t r = hi * c32 - __umulhi(hi, c32_sh) * p;
      r = r >= p ? r - p : r;
      uint32_t l = lo;
      const uint32_t four_p = two_p + two_p;
      l = l >= four_p ? l - four_p : l;
      l = l >= two_p ? l - two_p : l;
      l = l >= p ? l - p : l;
      const uint32_t s = r + l;
      y = s >= p ? s - p : s;
    }
    a.out[((size_t)c * batch + b) * a.n + (size_t)j * a.t_r + (size_t)oi * a.t_o] = y;
  }
}

template <bool kScaled>
cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  const dim3 grid((a.total_rows + kTM - 1) / kTM, a.o / kTO, channels);
  matmod_pass<kScaled><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K1a: x0 (, x1) [B, n] u32 limbs -> out [C, B, n] canonical, bit-reversed.
extern "C" int k1a_fwd_wide_multi(const void* x0, const void* x1, int n_limbs, int batch,
                                  int n1, int n2, int channels, const void* planes1,
                                  const void* cvec1, const void* planes2, const void* cvec2,
                                  const void* diag, const void* scal, void* scratch, void* out,
                                  void* stream) {
  const int n = n1 * n2;
  cudaStream_t s = (cudaStream_t)stream;
  // column pass: rows (b, j < n2), contract i < n1 at x[i*n2 + j] -> scratch[j*n1 + r]
  Pass a{};
  a.x[0] = (const uint32_t*)x0;
  a.x[1] = (const uint32_t*)(n_limbs > 1 ? x1 : x0);
  a.x_chan = 0;
  a.n_limbs = n_limbs;
  a.k1 = n1;
  a.s_k = n2;
  a.s_r = 1;
  a.rows_per_poly = n2;
  a.total_rows = batch * n2;
  a.n = n;
  a.o = n1;
  a.t_r = n1;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  cudaError_t e = launch<true>(a, channels, s);
  if (e != cudaSuccess) return (int)e;
  // row pass: rows (b, r < n1), contract j < n2 at scratch[j*n1 + r] -> out[r*n2 + k]
  Pass b{};
  b.x[0] = b.x[1] = (const uint32_t*)scratch;
  b.x_chan = (long long)batch * n;
  b.n_limbs = 1;
  b.k1 = n2;
  b.s_k = n1;
  b.s_r = 1;
  b.rows_per_poly = n1;
  b.total_rows = batch * n1;
  b.n = n;
  b.o = n2;
  b.t_r = n2;
  b.t_o = 1;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.scal = (const uint32_t*)scal;
  b.out = (uint32_t*)out;
  return (int)launch<false>(b, channels, s);
}

// K1b: x [C, B, n] u32 (any representative) -> out [C, B, n] canonical, standard order.
extern "C" int k1b_inv_multi(const void* x, int batch, int n1, int n2, int channels,
                             const void* planes1, const void* cvec1, const void* planes2,
                             const void* cvec2, const void* diag, const void* scal,
                             void* scratch, void* out, void* stream) {
  const int n = n1 * n2;
  cudaStream_t s = (cudaStream_t)stream;
  // row pass: rows (b, r < n1), contract j < n2 at x[r*n2 + j] -> scratch[r*n2 + k]
  Pass a{};
  a.x[0] = a.x[1] = (const uint32_t*)x;
  a.x_chan = (long long)batch * n;
  a.n_limbs = 1;
  a.k1 = n2;
  a.s_k = 1;
  a.s_r = n2;
  a.rows_per_poly = n1;
  a.total_rows = batch * n1;
  a.n = n;
  a.o = n2;
  a.t_r = n2;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  cudaError_t e = launch<true>(a, channels, s);
  if (e != cudaSuccess) return (int)e;
  // column pass: rows (b, k < n2), contract r < n1 at scratch[r*n2 + k] -> out[s*n2 + k]
  Pass b{};
  b.x[0] = b.x[1] = (const uint32_t*)scratch;
  b.x_chan = (long long)batch * n;
  b.n_limbs = 1;
  b.k1 = n1;
  b.s_k = n2;
  b.s_r = 1;
  b.rows_per_poly = n2;
  b.total_rows = batch * n2;
  b.n = n;
  b.o = n1;
  b.t_r = 1;
  b.t_o = n2;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.scal = (const uint32_t*)scal;
  b.out = (uint32_t*)out;
  return (int)launch<false>(b, channels, s);
}
