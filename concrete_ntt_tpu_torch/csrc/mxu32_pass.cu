// Single-prime four-step prime32 NTT for Hopper (sm_90a): kernels K2 and K3.
//
// Replaces two TPU kernels of concrete_ntt_tpu/ops/mxu32_pallas.py:
//   K2  k2_fwd / k2_inv  <- _build_call (kernel :72-107): the whole four-step
//       transform of one prime, fwd (1, 2 or 4 operand limbs) and inv (scale
//       folded into A_inv), and with its hyb argument (:36-44, :61-66) the nb
//       block transforms of the 32-bit stage-split hybrid (per-block tables,
//       the block on the grid's z axis, one launch pair for all blocks, one
//       operand limb). It serves every 2^11 <= n <= 2^17, so it also
//       takes the sizes the TPU sends through two _build_pass_call passes
//       (2048 <= n < 2^14): that split exists because the whole transform
//       outgrows the TPU's VMEM there, and a CUDA launch has no such limit;
//   K3  k3_pass          <- _build_pass_call (kernel :706-719): one exact
//       modular GEMM pass [B, rows, K] -> [B, rows, O] over contiguous
//       operands, scaled-lazy (rank-local diagonal rows) or canonical
//       epilogue: the per-rank pass of the sharded four-step.
// for every prime32 regime with odd p >= 2^26: lt30 (p < 2^30), lt31
// (p < 2^31) and generic (Montgomery epilogues; 5 matrix digit planes for
// primes near 2^32), and 2^11 <= n <= 2^17 (n1 <= 256, n2 <= 512).
//
// Design. Both are launches of matmod_pass (matmod_pass.cuh, shared with
// K1a-K1e: int8 tensor cores through wgmma m64nNk32), instantiated per
// (digit planes, regime, scaled, tile) and chosen at run time from the
// host's n_d, regime and tile codes. K2 is K1a/K1b's two-pass structure over
// one channel: the [n2, n1] intermediate goes through the wrapper's scratch
// tensor and the mid-pass transpose is a stride of the second pass's loads.
// The reduction chain of the canonical epilogue (one to six multiples of p
// for p >= 2^26) is read from the scalar record.
//
// Bound at n = 2^14, B = 16, one prime: a transform is 1.1e9 int8 MACs
// (four planes; 1.3e9 with five) against about 4 MiB of memory traffic
// (operand, scratch both ways, result, 0.75 MiB of operator tables held by
// L2), so like K1 it is bound by the contraction's rate, 0.0011 ms on the
// tensor cores. One channel gives a small grid, and K1's tiles (128 rows x
// 32 outputs, a three-stage ring) leave most of the card idle and half of
// each block's life in the ring's prologue. So K2's entries take a tile per
// pass from the host (ops/mxu32_cuda.py k2_tile): K1's (code 0) where its
// grid puts at least 128 blocks (about one a streaming multiprocessor) on
// the card, else 64 rows x 16 outputs (code 1, one warpgroup), which holds a
// contraction of up to four stages whole in shared memory (68 KiB with four
// digit planes: three blocks an SM) and gives four times K1's grid. Blocks a
// pass at B = 16, both passes and both directions alike:
//
//   n        2^11   2^12   2^13   2^14   2^15   2^16   2^17
//   tile     1      1      1      1      0      0      0
//   blocks   32     64     128    256    128    256    512
//
// (K1's tiles gave 8, 16, 32, 64 blocks a pass from 2^11 to 2^14.) The
// threshold is a sweep's on one H100 (every tile forced at every n, B = 16,
// device time by torch.profiler; PERF.md §6): 64 x 16 was the
// fastest from 2^11 to 2^13, no slower than any other tile at 2^14, and at
// 2^15 and above K1's tile beat it (more blocks re-read each operand tile
// more often). K2 with block tables (nb > 1) and K3 keep tile 0.
//
// Host work of a launch: the wrapper builds the fixed arguments (tables,
// shape, tiles) once per table set and batch as a K2Args record and passes
// its address; the shared-memory opt-in is made once per instance and
// device (matmod_pass.cuh launch).

#include "matmod_pass.cuh"

using mxu32::kGeneric;
using mxu32::kLt30;
using mxu32::kLt31;
using mxu32::launch;
using mxu32::Pass;

namespace {

template <bool kScaled, int kTile>
cudaError_t launch_tile(const Pass& a, int n_d, int regime, cudaStream_t s) {
  if (n_d == 5 && regime == kGeneric) return launch<5, kGeneric, kScaled, false, false, kTile>(a, 1, s);
  if (n_d != 4) return cudaErrorInvalidValue;
  switch (regime) {
    case kLt30:
      return launch<4, kLt30, kScaled, false, false, kTile>(a, 1, s);
    case kLt31:
      return launch<4, kLt31, kScaled, false, false, kTile>(a, 1, s);
    case kGeneric:
      return launch<4, kGeneric, kScaled, false, false, kTile>(a, 1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kScaled>
cudaError_t launch_any(const Pass& a, int n_d, int regime, int tile, cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch_tile<kScaled, 0>(a, n_d, regime, s);
    case 1:
      return launch_tile<kScaled, 1>(a, n_d, regime, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K2's fixed launch arguments (ops/mxu32_cuda.py K2Args: the same fields in
// the same order): the two passes' tables, the diagonal and the scalar
// record, the shape (n_limbs operand limbs, batch, n = n1 * n2, nb blocks),
// n_d matrix digit planes, the regime, and the tile code of each pass in
// launch order (column then row forward, row then column inverse).
struct K2Args {
  const void *planes1, *cvec1, *planes2, *cvec2, *diag, *scal;
  int n_limbs, batch, n1, n2, nb, n_d, regime, tile1, tile2;
};

// K2 fwd: x0 (, x1 (, x2, x3)) [B, nb * n] u32 limbs (n_limbs = 1, 2 or 4) ->
// out [B, nb * n] canonical, bit-reversed (nb > 1: the hybrid's blocks).
extern "C" int k2_fwd(const K2Args* k, const void* x0, const void* x1, const void* x2,
                      const void* x3, void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  const void* const x[4] = {x0, x1, x2, x3};
  mxu32::fwd_passes(&col, &row, x, k->n_limbs, 0, k->batch, k->n1, k->n2, k->nb, k->planes1,
                    k->cvec1, k->planes2, k->cvec2, k->diag, k->scal, scratch, out);
  cudaError_t e = launch_any<true>(col, k->n_d, k->regime, k->tile1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, k->n_d, k->regime, k->tile2, s);
}

// K2 inv: x [B, nb * n] u32 (any representative) -> out [B, nb * n] canonical,
// standard order within each block.
extern "C" int k2_inv(const K2Args* k, const void* x, void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, x, k->batch, k->n1, k->n2, k->nb, k->planes1, k->cvec1,
                    k->planes2, k->cvec2, k->diag, k->scal, scratch, out);
  cudaError_t e = launch_any<true>(row, k->n_d, k->regime, k->tile1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(col, k->n_d, k->regime, k->tile2, s);
}

// K3: one pass over contiguous operands. Row j < rows of polynomial b
// contracts x_l[b][j][0..k1) of each limb l < n_limbs (1, 2 or 4) and writes
// out[b][j][0..o); diag is [4 or 2][rows][o] (scaled only).
extern "C" int k3_pass(const void* x0, const void* x1, const void* x2, const void* x3,
                       int n_limbs, int batch, int rows, int k1, int o, const void* planes,
                       const void* cvec, const void* diag,
                       const void* scal, int n_d, int regime, int scaled, void* out,
                       void* stream) {
  Pass a{};
  const void* const x[4] = {x0, x1, x2, x3};
  for (int l = 0; l < 4; ++l) a.x[l] = (const uint32_t*)x[l < n_limbs ? l : 0];
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
  return (int)(scaled ? launch_any<true>(a, n_d, regime, 0, s)
                      : launch_any<false>(a, n_d, regime, 0, s));
}

// Dynamic shared memory of one pass block with n_d matrix digit planes and
// the tile of code `tile` (its ring or resident stages of operand and plane
// tiles), for the build report.
extern "C" int k_pass_smem_bytes(int n_d, int tile) {
  if (tile < 0 || tile >= mxu32::kTiles) return -1;
  return mxu32::smem_bytes(n_d == 5 ? 5 : 4, tile);
}
