// Single-prime four-step prime64 NTT for Hopper (sm_90a): kernels K5 and K6.
//
// Replaces two TPU kernels of concrete_ntt_tpu/ops/mxu64_pallas.py:
//   K5  k5_fwd / k5_inv  <- _build_call (:32, kernel :71-96; fwd :153, inv
//       :157): the whole four-step transform of one 64-bit prime on u64 limb
//       pairs, (lo, hi) 2 x [B, n] u32 -> 2 x [B, n] u32, fwd and inv with a
//       scale folded into A_inv; and the same function with its hyb argument
//       (:36-43, :62-65; called at ops/stagesplit.py:380, 401), K5h: the nb
//       block transforms of the stage-split hybrid, each with the tables of
//       its block of a parent transform, (lo, hi) 2 x [B, nb * n];
//   K6  k6_pass          <- _build_pass_call64 (:197, kernel :212-227;
//       pass_matmod64 :269): one exact modular GEMM pass on limb pairs,
//       [B, rows, K] -> [B, rows, O], scaled-lazy (rank-local diagonal rows)
//       or canonical: the per-rank pass of the sharded prime64 four-step;
// for every odd prime 2^33 < p < 2^64 (four epilogue regimes, 5 to 9 matrix
// digit planes) and 2^11 <= n <= 2^15. The TPU's size cut between the two
// (the whole transform needs both factors >= 128 and its VMEM) and its row
// fusion to 128 lanes are not carried over: a CUDA launch has neither limit.
//
// Design. Both are launches of matmod64_pass (matmod64_pass.cuh, shared with
// K7), instantiated per (digit planes, regime, scaled) and chosen at run
// time from the host's n_d and mode. K5 is two launches: the mid-pass
// intermediate (any-u64 representatives, a limb pair) goes through the
// wrapper's two scratch tensors and the transpose is a stride of the second
// pass's loads. With block tables (nb > 1) the block index is a grid axis
// (z = block; matmod64_pass.cuh): one launch pair serves all nb blocks, each
// reading its slice of the [B, nb * n] operand in place and writing its slice
// of the result, where the TPU code launches one kernel a block on sliced
// copies and concatenates. The column operators A_b / A_inv,b and the
// diagonals are stacked over the block, F / G and the scalar record are one.
//
// Bound at n = 2^14, B = 16: K5 fwd needs 2048·256·D·128 dp4a a pass, 1.2e9
// for both with D = 9 (Goldilocks; 4.8e9 int8 MACs) and 0.94e9 with D = 7,
// against about 8 MiB of memory traffic (operand, scratch both ways, result,
// and 2 to 2.5 MiB of operator tables that L2 holds): bound by integer-pipe
// throughput, not by bytes. The epilogue adds three to six 64 x 64-bit
// multiplies per output value (one output per 2·K dp4a·D). This first kernel
// contracts with __dp4a on the CUDA cores; int8 tensor-core tiles are later
// work.

#include "matmod64_pass.cuh"

using mxu64::kGl;
using mxu64::kMontMont;
using mxu64::kMontShoup;
using mxu64::kShoup;
using mxu64::launch;
using mxu64::Pass;
using mxu64::Tables;

namespace {

// The instance for (n_d, mode): shoup takes 5 to 8 planes by the size of p,
// mont with Shoup fold 8, mont with Montgomery fold 8 or 9, Goldilocks 9.
template <bool kScaled>
cudaError_t launch_any(const Pass& a, int n_d, int mode, cudaStream_t s) {
  switch (mode * 16 + n_d) {
    case kShoup * 16 + 5:
      return launch<5, kShoup, kScaled>(a, 1, s);
    case kShoup * 16 + 6:
      return launch<6, kShoup, kScaled>(a, 1, s);
    case kShoup * 16 + 7:
      return launch<7, kShoup, kScaled>(a, 1, s);
    case kShoup * 16 + 8:
      return launch<8, kShoup, kScaled>(a, 1, s);
    case kMontShoup * 16 + 8:
      return launch<8, kMontShoup, kScaled>(a, 1, s);
    case kMontMont * 16 + 8:
      return launch<8, kMontMont, kScaled>(a, 1, s);
    case kMontMont * 16 + 9:
      return launch<9, kMontMont, kScaled>(a, 1, s);
    case kGl * 16 + 9:
      return launch<9, kGl, kScaled>(a, 1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K5 fwd: (x_lo, x_hi) [B, nb * n] -> (out_lo, out_hi) [B, nb * n] canonical:
// nb block transforms of size n = n1 * n2 (nb = 1: the direct transform,
// bit-reversed order). planes1 / cvec1 [nb][..] (A_b), planes2 / cvec2 (F),
// diag [nb][8 or 2][n2][n1].
extern "C" int k5_fwd(const void* x_lo, const void* x_hi, int batch, int n1, int n2, int nb,
                      const void* planes1, const void* cvec1, const void* planes2,
                      const void* cvec2, const void* diag, const void* scal, int n_d, int mode,
                      void* scratch_lo, void* scratch_hi, void* out_lo, void* out_hi,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass col, row;
  mxu64::fwd_passes(&col, &row, x_lo, x_hi, 0, batch, n1, n2, nb, t, scratch_lo, scratch_hi,
                    out_lo, out_hi);
  cudaError_t e = launch_any<true>(col, n_d, mode, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, n_d, mode, s);
}

// K5 fwd of a u128 operand: the four limbs x0..x3 [B, n] -> (out_lo, out_hi)
// [B, n] canonical, bit-reversed: mxu64_pallas.py::_build_call with
// n_limbs = 4 (:47-49). The column pass contracts 16 operand planes
// (planes1 [4 * n1][D * n1], mxu64._wide_col_planes); the rest is k5_fwd's.
extern "C" int k5_fwd_u128(const void* x0, const void* x1, const void* x2, const void* x3,
                           int batch, int n1, int n2, const void* planes1, const void* cvec1,
                           const void* planes2, const void* cvec2, const void* diag,
                           const void* scal, int n_d, int mode, void* scratch_lo,
                           void* scratch_hi, void* out_lo, void* out_hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass col, row;
  mxu64::fwd_passes(&col, &row, x0, x1, 0, batch, n1, n2, 1, t, scratch_lo, scratch_hi, out_lo,
                    out_hi);
  col.x[2] = (const uint32_t*)x2;
  col.x[3] = (const uint32_t*)x3;
  col.n_limbs = 4;
  cudaError_t e = launch_any<true>(col, n_d, mode, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, n_d, mode, s);
}

// K5 inv: (x_lo, x_hi) [B, nb * n], any u64 -> (out_lo, out_hi) canonical,
// standard order within each block. planes1 / cvec1 (G), planes2 / cvec2
// [nb][..] (A_inv,b times the scale), diag [nb][8 or 2][n1][n2].
extern "C" int k5_inv(const void* x_lo, const void* x_hi, int batch, int n1, int n2, int nb,
                      const void* planes1, const void* cvec1, const void* planes2,
                      const void* cvec2, const void* diag, const void* scal, int n_d, int mode,
                      void* scratch_lo, void* scratch_hi, void* out_lo, void* out_hi,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass row, col;
  mxu64::inv_passes(&row, &col, x_lo, x_hi, nullptr, nullptr, batch, n1, n2, nb, t, scratch_lo,
                    scratch_hi, out_lo, out_hi);
  cudaError_t e = launch_any<true>(row, n_d, mode, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(col, n_d, mode, s);
}

// K6: one pass over contiguous operands. Row j < rows of polynomial b
// contracts x[b][j][0..k1) of each limb and writes out[b][j][0..o); diag is
// [8 or 2][rows][o] (scaled only).
extern "C" int k6_pass(const void* x_lo, const void* x_hi, int batch, int rows, int k1, int o,
                       const void* planes, const void* cvec, const void* diag, const void* scal,
                       int n_d, int mode, int scaled, void* out_lo, void* out_hi, void* stream) {
  Pass a{};
  a.x[0] = a.x[2] = a.x[3] = a.y[0] = (const uint32_t*)x_lo;
  a.x[1] = a.y[1] = (const uint32_t*)x_hi;
  a.x_b = (long long)rows * k1;
  a.x_chan = 0;
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
  a.out[0] = (uint32_t*)out_lo;
  a.out[1] = (uint32_t*)out_hi;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(scaled ? launch_any<true>(a, n_d, mode, s) : launch_any<false>(a, n_d, mode, s));
}
