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
//       or canonical, the one-to-one twin of the JAX pass_matmod64; and
//       k6_pass_multi, the same pass over a rank's C channels in one launch
//       with strided operands and outputs: the per-rank pass of the sharded
//       prime64 four-step (below);
// for every odd prime 2^33 < p < 2^64 (four epilogue regimes, 5 to 9 matrix
// digit planes) and 2^11 <= n <= 2^15. The TPU's size cut between the two
// (the whole transform needs both factors >= 128 and its VMEM) and its row
// fusion to 128 lanes are not carried over: a CUDA launch has neither limit.
//
// Design. Both are launches of matmod64_pass (matmod64_pass.cuh, shared with
// K7: int8 tensor cores through wgmma m64nNk32 with N = 16 x the digit
// planes, a three-stage cp.async ring), instantiated per (digit planes,
// regime, scaled) and chosen at run time from the host's n_d and mode. K5 is
// two launches: the mid-pass intermediate (any-u64 representatives, a limb
// pair) goes through the wrapper's two scratch tensors and the transpose is a
// stride of the second pass's loads. With block tables (nb > 1) the block
// index is a grid axis (z = block; matmod64_pass.cuh): one launch pair serves
// all nb blocks, each reading its slice of the [B, nb * n] operand in place
// and writing its slice of the result, where the TPU code launches one kernel
// a block on sliced copies and concatenates. The column operators A_b /
// A_inv,b and the diagonals are stacked over the block, F / G and the scalar
// record are one.
//
// Bound at n = 2^14, B = 16: K5 fwd is 2048 x (8 x 128) x (D x 128) int8
// MACs a pass, 4.8e9 for both with D = 9 (Goldilocks) and 3.8e9 with D = 7,
// against about 8 MiB of memory traffic (operand, scratch both ways, result,
// and 2 to 2.5 MiB of operator tables that L2 holds): bound by the
// contraction's rate, not by bytes. The epilogue adds three to six 64 x
// 64-bit multiplies per output value. A pass of 2048 rows is 16 row tiles x
// 8 output tiles = 128 blocks of 128 rows x 16 outputs on the card's 132 SMs.

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
template <bool kScaled, int kTile>
cudaError_t launch_mode(const Pass& a, int n_d, int mode, int channels, cudaStream_t s) {
  switch (mode * 16 + n_d) {
    case kShoup * 16 + 5:
      return launch<5, kShoup, kScaled, false, kTile>(a, channels, s);
    case kShoup * 16 + 6:
      return launch<6, kShoup, kScaled, false, kTile>(a, channels, s);
    case kShoup * 16 + 7:
      return launch<7, kShoup, kScaled, false, kTile>(a, channels, s);
    case kShoup * 16 + 8:
      return launch<8, kShoup, kScaled, false, kTile>(a, channels, s);
    case kMontShoup * 16 + 8:
      return launch<8, kMontShoup, kScaled, false, kTile>(a, channels, s);
    case kMontMont * 16 + 8:
      return launch<8, kMontMont, kScaled, false, kTile>(a, channels, s);
    case kMontMont * 16 + 9:
      return launch<9, kMontMont, kScaled, false, kTile>(a, channels, s);
    case kGl * 16 + 9:
      return launch<9, kGl, kScaled, false, kTile>(a, channels, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K5 and k6_pass take tile 0 on one channel; k6_pass_multi a channel grid
// on either tile (ops/mxu64_cuda.py k6_tile)
template <bool kScaled>
cudaError_t launch_any(const Pass& a, int n_d, int mode, cudaStream_t s, int channels = 1,
                       int tile = 0) {
  switch (tile) {
    case 0:
      return launch_mode<kScaled, 0>(a, n_d, mode, channels, s);
    case 1:
      return launch_mode<kScaled, 1>(a, n_d, mode, channels, s);
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

// K6 on a channel grid: k6_pass_multi, the per-rank pass of the sharded
// prime64 four-step (parallel/fourstep_mxu.py, parallel/channels.py), the
// 64-bit twin of mxu32_pass.cu's k3_pass_multi. At the routes' shapes a
// pass is small: Plan52's (2^14, 8) at (dp, ch, sp) = (2, 1, 2) is, a
// channel, 256 rows x 1024 contraction bytes (a limb pair) x 896 digit
// columns (7 planes x 128 outputs), 0.24e9 int8 MACs (0.24 us at 1,979
// TOP/s, the data sheet of the NVIDIA H100 80GB HBM3 at 700 W) against 1.6
// MiB of operand, result, planes and diagonal rows (0.5 us at 3.35 TB/s):
// bytes bound it. What held k6_pass at 23-27x that bound was the grid: 16 blocks
// of 128 rows x 16 outputs for one channel on 132 SMs, three launches where
// one channel grid does, and a transposing copy of both limbs around the
// passes that read or write across the rows. So, as k3_pass_multi:
//   * the rank's C channels in one launch (grid z = channel, per-channel
//     planes, cvec, diagonal rows [C][8 or 2][rows][o] and scalar records;
//     one regime and one digit-plane count for all, the condition of
//     ops/mxu64.py multi_applicable that parallel/channels.py checks once);
//   * a tile from the grid (ops/mxu64_cuda.py k6_tile): 64 rows (tile code
//     1, one warpgroup, three blocks an SM) where 128-row blocks (two an
//     SM) would be at most 198 on the 132 SMs, twice their blocks; 128 rows
//     otherwise. A sweep on the card set it (tools/ab_sharded.py): 64 rows
//     won by 13-24 % at 48 and 192 blocks of 128 rows, lost by up to 34 %
//     at 256 and 384, where more blocks re-read each plane tile;
//   * the operand's contraction and row strides and the output's row and
//     output strides, so that the four-step's transposes are strides of the
//     loads and stores, on both limbs alike.
// The fixed arguments come as one record (ops/mxu64_cuda.py K6MultiArgs).
struct K6MultiArgs {
  const void *planes, *cvec, *scal;
  long long x_chan, x_b, out_chan, out_b;
  int channels, batch, rows, k1, o, s_k, s_r, t_r, t_o, n_d, mode, scaled, tile;
};

// (x_lo, x_hi): the operand's limbs, element (c, b, j, i) at c * x_chan +
// b * x_b + j * s_r + i * s_k of each (x_chan = 0: shared by all
// channels); diag [C][8 or 2][rows][o] (scaled only); (out_lo, out_hi)
// element (c, b, j, oi) at c * out_chan + b * out_b + j * t_r + oi * t_o.
extern "C" int k6_pass_multi(const K6MultiArgs* k, const void* x_lo, const void* x_hi,
                             const void* diag, void* out_lo, void* out_hi, void* stream) {
  Pass a{};
  a.x[0] = a.x[2] = a.x[3] = a.y[0] = (const uint32_t*)x_lo;
  a.x[1] = a.y[1] = (const uint32_t*)x_hi;
  a.x_b = k->x_b;
  a.x_chan = k->x_chan;
  a.k1 = k->k1;
  a.s_k = k->s_k;
  a.s_r = k->s_r;
  a.rows_per_poly = k->rows;
  a.total_rows = k->batch * k->rows;
  a.o = k->o;
  a.out_b = k->out_b;
  a.out_chan = k->out_chan;
  a.t_r = k->t_r;
  a.t_o = k->t_o;
  a.planes = (const int32_t*)k->planes;
  a.cvec = (const int32_t*)k->cvec;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)k->scal;
  a.out[0] = (uint32_t*)out_lo;
  a.out[1] = (uint32_t*)out_hi;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(k->scaled ? launch_any<true>(a, k->n_d, k->mode, s, k->channels, k->tile)
                         : launch_any<false>(a, k->n_d, k->mode, s, k->channels, k->tile));
}

// Dynamic shared memory of one pass block with n_d matrix digit planes and
// the tile of code `tile` (the ring of operand and plane stages), for the
// build report.
extern "C" int k64_pass_smem_bytes(int n_d, int tile) {
  if (tile < 0 || tile >= mxu64::kTiles) return -1;
  return mxu64::smem_bytes(n_d, tile);
}
