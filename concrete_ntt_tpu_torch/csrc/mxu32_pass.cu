// Single-prime four-step prime32 NTT for Hopper (sm_90a): kernels K2 and K3.
//
// Replaces two TPU kernels of concrete_ntt_tpu/ops/mxu32_pallas.py:
//   K2  k2_fwd / k2_inv  <- _build_call (kernel :72-107): the whole four-step
//       transform of one prime, fwd (1 or 2 operand limbs) and inv (scale
//       folded into A_inv). It serves every 2^11 <= n <= 2^15, so it also
//       takes the sizes the TPU sends through two _build_pass_call passes
//       (2048 <= n < 2^14): that split exists because the whole transform
//       outgrows the TPU's VMEM there, and a CUDA launch has no such limit;
//   K3  k3_pass          <- _build_pass_call (kernel :706-719): one exact
//       modular GEMM pass [B, rows, K] -> [B, rows, O] over contiguous
//       operands, scaled-lazy (rank-local diagonal rows) or canonical
//       epilogue: the per-rank pass of the sharded four-step.
// for every prime32 regime with odd p >= 2^26: lt30 (p < 2^30), lt31
// (p < 2^31) and generic (Montgomery epilogues; 5 matrix digit planes for
// primes near 2^32), and 2^11 <= n <= 2^15.
//
// Design. Both are launches of matmod_pass (matmod_pass.cuh, shared with
// K1a/K1b), instantiated per (digit planes, regime, scaled) and chosen at
// run time from the host's n_d and regime. K2 is K1a/K1b's two-pass
// structure over one channel: the [n2, n1] intermediate goes through the
// wrapper's scratch tensor and the mid-pass transpose is a stride of the
// second pass's loads. The reduction chain of the canonical epilogue (one to
// six multiples of p for p >= 2^26) is read from the scalar record.
//
// Bound at n = 2^14, B = 16, one prime: a transform needs 0.27e9 dp4a (four
// planes; 0.34e9 with five) against about 4 MiB of memory traffic (operand,
// scratch both ways, result, 0.75 MiB of operator tables held by L2), so
// like K1 it is bound by integer-pipe throughput. Its grid (128 blocks a pass)
// is 2.5x smaller than K1's at B = 8 over five channels.

#include "matmod_pass.cuh"

using mxu32::kGeneric;
using mxu32::kLt30;
using mxu32::kLt31;
using mxu32::launch;
using mxu32::Pass;

namespace {

template <bool kScaled>
cudaError_t launch_any(const Pass& a, int n_d, int regime, cudaStream_t s) {
  if (n_d == 5 && regime == kGeneric) return launch<5, kGeneric, kScaled>(a, 1, s);
  if (n_d != 4) return cudaErrorInvalidValue;
  switch (regime) {
    case kLt30:
      return launch<4, kLt30, kScaled>(a, 1, s);
    case kLt31:
      return launch<4, kLt31, kScaled>(a, 1, s);
    case kGeneric:
      return launch<4, kGeneric, kScaled>(a, 1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K2 fwd: x0 (, x1) [B, n] u32 limbs -> out [B, n] canonical, bit-reversed.
extern "C" int k2_fwd(const void* x0, const void* x1, int n_limbs, int batch, int n1, int n2,
                      const void* planes1, const void* cvec1, const void* planes2,
                      const void* cvec2, const void* diag, const void* scal, int n_d, int regime,
                      void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  mxu32::fwd_passes(&col, &row, x0, x1, n_limbs, batch, n1, n2, planes1, cvec1, planes2, cvec2,
                    diag, scal, scratch, out);
  cudaError_t e = launch_any<true>(col, n_d, regime, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, n_d, regime, s);
}

// K2 inv: x [B, n] u32 (any representative) -> out [B, n] canonical, standard order.
extern "C" int k2_inv(const void* x, int batch, int n1, int n2, const void* planes1,
                      const void* cvec1, const void* planes2, const void* cvec2, const void* diag,
                      const void* scal, int n_d, int regime, void* scratch, void* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, x, batch, n1, n2, planes1, cvec1, planes2, cvec2, diag, scal,
                    scratch, out);
  cudaError_t e = launch_any<true>(row, n_d, regime, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(col, n_d, regime, s);
}

// K3: one pass over contiguous operands. Row j < rows of polynomial b
// contracts x_l[b][j][0..k1) of each limb l and writes out[b][j][0..o);
// diag is [4 or 2][rows][o] (scaled only).
extern "C" int k3_pass(const void* x0, const void* x1, int n_limbs, int batch, int rows, int k1,
                       int o, const void* planes, const void* cvec, const void* diag,
                       const void* scal, int n_d, int regime, int scaled, void* out,
                       void* stream) {
  Pass a{};
  a.x[0] = (const uint32_t*)x0;
  a.x[1] = (const uint32_t*)(n_limbs > 1 ? x1 : x0);
  a.x_b = (long long)rows * k1;
  a.x_chan = 0;
  a.n_limbs = n_limbs;
  a.k1 = k1;
  a.s_k = 1;
  a.s_r = k1;
  a.rows_per_poly = rows;
  a.total_rows = batch * rows;
  a.o = o;
  a.out_b = (long long)rows * o;
  a.out_chan = 0;
  a.t_r = o;
  a.t_o = 1;
  a.planes = (const int32_t*)planes;
  a.cvec = (const int32_t*)cvec;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(scaled ? launch_any<true>(a, n_d, regime, s) : launch_any<false>(a, n_d, regime, s));
}
