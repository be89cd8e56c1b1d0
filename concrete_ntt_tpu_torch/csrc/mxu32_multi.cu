// Channel-grid four-step prime32 NTT for Hopper (sm_90a): kernels K1a-K1d.
//
// Replaces the TPU kernel concrete_ntt_tpu/ops/mxu32_pallas.py::_build_multi_call:
//   K1a  k1a_fwd_wide_multi        <- its fwd branch (fwd_wide_multi, kernel body :367-397)
//   K1b  k1b_inv_multi             <- its inv branch (inv_multi, kernel body :398-412)
//   K1c  k1c_fwd_multi_perchannel  <- its fwd branch with perch_in=True
//                                     (fwd_multi_perchannel :544, fwd_wide_multi_perchannel :564)
//   K1d  k1d_pointwise_inv_multi   <- its inv branch with pointwise=True
//                                     (pointwise_inv_multi :637, _sc_mont_mul :505)
// for every CRT channel prime 2^29 < p < 2^30 and 2^11 <= n <= 2^15. (The TPU
// serves K1c/K1d only at n >= 2^14, a VMEM/lane limit; the results are
// bit-identical at every n.)
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
//   K1c: K1a with a different operand (1 or 2 limbs) per channel: x [C][B][n]
//        per limb, the column pass reading channel c at c * B * n.
//   K1d: K1b whose first pass loads fl and fr [C][B][n] at the same index and
//        feeds mont_mul(fl, fr) (REDC for any u32 operands, its u32 overflow
//        kept) into the digit split; n^-1 * 2^32 is folded into A_inv.
//
// Design. Each product is one launch of matmod_pass (matmod_pass.cuh, shared
// with K2/K3): a tiled GEMM with the digit split in the operand load and the
// combine + reduction in the epilogue, here instantiated with four matrix
// digit planes and the lt30 epilogues (every channel prime is below 2^30).
// The [n2, n1]
// intermediate goes through global memory (the wrapper's scratch tensor);
// the mid-pass transpose is only a stride of the second pass's loads. Grid
// = (row tiles over batch x rows, output tiles, channel); rows past the
// batch edge are masked, so any batch size works. Both launches of a
// kernel go on the caller's stream; the C entry point returns
// cudaGetLastError() after them. K1c is K1a's launches with a channel
// stride on the operand; K1d's first pass is the one pointwise instance of
// the template (kPointwise), so K1a/K1b/K2/K3 keep their instances.
//
// Bound at n = 2^14, B = 8, five channels: K1a (two limbs) needs 1.0e9
// dp4a (4.0e9 int8 MACs; K1b 0.67e9 dp4a) and moves about 12 MiB (operand,
// scratch written and read back, result, and the 3.75 MiB of operator
// tables, which L2 holds). At 3.35 TB/s the bytes take a few microseconds;
// the dp4a issue takes tens, so the kernel is bound by the integer pipes,
// not by memory. K1d adds one 32x32 multiply-high chain per operand value
// to the load (n values per polynomial against n * n1 dp4a), and two
// operand reads instead of one. This first kernel uses dp4a on the CUDA
// cores and leaves int8 tensor-core tiles (mma.sync / wgmma) to later work.

#include "matmod_pass.cuh"

using mxu32::kLt30;
using mxu32::launch;
using mxu32::Pass;

// K1a: x0 (, x1) [B, n] u32 limbs -> out [C, B, n] canonical, bit-reversed.
extern "C" int k1a_fwd_wide_multi(const void* x0, const void* x1, int n_limbs, int batch,
                                  int n1, int n2, int channels, const void* planes1,
                                  const void* cvec1, const void* planes2, const void* cvec2,
                                  const void* diag, const void* scal, void* scratch, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  mxu32::fwd_passes(&col, &row, x0, x1, n_limbs, batch, n1, n2, planes1, cvec1, planes2, cvec2,
                    diag, scal, scratch, out);
  cudaError_t e = launch<4, kLt30, true>(col, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(row, channels, s);
}

// K1b: x [C, B, n] u32 (any representative) -> out [C, B, n] canonical, standard order.
extern "C" int k1b_inv_multi(const void* x, int batch, int n1, int n2, int channels,
                             const void* planes1, const void* cvec1, const void* planes2,
                             const void* cvec2, const void* diag, const void* scal,
                             void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, x, batch, n1, n2, planes1, cvec1, planes2, cvec2, diag, scal,
                    scratch, out);
  cudaError_t e = launch<4, kLt30, true>(row, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(col, channels, s);
}

// K1c: x0 (, x1) [C, B, n] u32 limbs, one operand per channel (any values)
// -> out [C, B, n] canonical, bit-reversed.
extern "C" int k1c_fwd_multi_perchannel(const void* x0, const void* x1, int n_limbs, int batch,
                                        int n1, int n2, int channels, const void* planes1,
                                        const void* cvec1, const void* planes2,
                                        const void* cvec2, const void* diag, const void* scal,
                                        void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  mxu32::fwd_passes(&col, &row, x0, x1, n_limbs, batch, n1, n2, planes1, cvec1, planes2, cvec2,
                    diag, scal, scratch, out);
  col.x_chan = (long long)batch * n1 * n2;
  cudaError_t e = launch<4, kLt30, true>(col, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(row, channels, s);
}

// K1d: fl, fr [C, B, n] u32 (any representatives) -> out [C, B, n] =
// inv(mont_mul(fl, fr)) times the scale folded into A_inv, canonical,
// standard order.
extern "C" int k1d_pointwise_inv_multi(const void* fl, const void* fr, int batch, int n1,
                                       int n2, int channels, const void* planes1,
                                       const void* cvec1, const void* planes2,
                                       const void* cvec2, const void* diag, const void* scal,
                                       void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, fl, batch, n1, n2, planes1, cvec1, planes2, cvec2, diag, scal,
                    scratch, out);
  row.x[1] = (const uint32_t*)fr;  // the pointwise pass's second operand (n_limbs stays 1)
  cudaError_t e = launch<4, kLt30, true, true>(row, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(col, channels, s);
}
