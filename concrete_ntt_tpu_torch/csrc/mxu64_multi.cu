// Channel-grid four-step prime64 NTT for Hopper (sm_90a): kernels K7a-K7d.
//
// Replaces the TPU kernel
// concrete_ntt_tpu/ops/mxu64_pallas.py::_build_multi_call64 (:522), all four
// of its entries:
//   K7a  k7_fwd_multi, perchannel = 0  <- its fwd branch with a shared operand
//        (fwd_multi :679, kernel body :555-582): all Plan52 channels' forward
//        NTTs of one u64 operand, (lo, hi) [B, n] -> (lo, hi) [C, B, n];
//   K7c  k7_fwd_multi, perchannel = 1  <- the same with perch_fwd=True
//        (fwd_multi_perchannel64 :695, operand block spec :621-626): one
//        operand per channel, (lo, hi) [C, B, n] -> [C, B, n];
//   K7b  k7_inv_multi, no second operand  <- its inv branch with
//        pointwise=False (inv_multi :712): all channels' scaled inverse;
//   K7d  k7_inv_multi with a second operand  <- pointwise=True
//        (pointwise_inv_multi :728, _sc_mont_mul64 :391): the Montgomery
//        product of two [C, B, n] limb-pair operands (any u64) taken in the
//        load, then the scaled inverse, n^-1 * 2^64 folded into A_inv;
// for channel primes 2^33 < p < 2^62 (the "shoup" regime) with one plane
// count for all channels, and 2^11 <= n <= 2^15; and its hyb argument (:524;
// called at ops/stagesplit.py:490, 511, 535): with nb > 1, K7b / K7c / K7d
// run the nb block transforms of the stage-split hybrid on operands
// [C, B, nb * n] with per-block tables.
//
// Design. Each transform is two launches of matmod64_pass (matmod64_pass.cuh,
// shared with K5/K6: int8 tensor cores through wgmma) with z = channel * nb +
// block on blockIdx.z: per-channel planes of the shared row operators and the
// 16-word scalar record are indexed by the channel, the per-block column
// operators and diagonals by z; K7a's operand has channel stride 0. All
// blocks of all channels go in one launch pair, reading and writing their
// slices in place, where the TPU code launches one kernel a block on sliced
// copies. K7d's first pass is the pointwise instance of the template
// (kPointwise): each operand word is a limb of mont_mul(fl, fr) for any u64
// fl, fr, with the overflow of the REDC sum kept as the limb-pair code keeps
// it, computed in the load with plain loads and stores (cp.async cannot).
//
// Bound at n = 2^14, B = 8, three 50-bit channels (D = 7, 8 operand planes
// in the first pass and 7 non-zero ones in the second): K7a needs 3 x 2 x
// 1024 x (8 x 128) x (7 x 128) = 5.6e9 int8 MACs against about 12 MiB of
// memory traffic (operand, scratch both ways, result, 5.3 MiB of operator
// tables that L2 holds): bound by the contraction's rate. K7d adds three 64 x
// 64-bit multiply-high chains per loaded operand word, and recomputes the
// product for the lo and the hi limb stage and for each of the o / 16 output
// tiles.

#include "matmod64_pass.cuh"

using mxu64::kShoup;
using mxu64::launch;
using mxu64::Pass;
using mxu64::Tables;

namespace {

template <bool kScaled, bool kPointwise = false>
cudaError_t launch_any(const Pass& a, int n_d, int channels, cudaStream_t s) {
  switch (n_d) {
    case 5:
      return launch<5, kShoup, kScaled, kPointwise>(a, channels, s);
    case 6:
      return launch<6, kShoup, kScaled, kPointwise>(a, channels, s);
    case 7:
      return launch<7, kShoup, kScaled, kPointwise>(a, channels, s);
    case 8:
      return launch<8, kShoup, kScaled, kPointwise>(a, channels, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7a / K7c: (x_lo, x_hi) [B, nb * n] (perchannel = 0, nb = 1) or
// [C, B, nb * n] -> (out_lo, out_hi) [C, B, nb * n] canonical; bit-reversed
// order of the whole transform. planes1 / cvec1 [C * nb][..], planes2 / cvec2
// [C][..], diag [C * nb][8][n2][n1].
extern "C" int k7_fwd_multi(const void* x_lo, const void* x_hi, int perchannel, int batch, int n1,
                            int n2, int nb, int channels, const void* planes1, const void* cvec1,
                            const void* planes2, const void* cvec2, const void* diag,
                            const void* scal, int n_d, void* scratch_lo, void* scratch_hi,
                            void* out_lo, void* out_hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  const long long x_chan = perchannel ? (long long)batch * nb * n1 * n2 : 0;
  Pass col, row;
  mxu64::fwd_passes(&col, &row, x_lo, x_hi, x_chan, batch, n1, n2, nb, t, scratch_lo, scratch_hi,
                    out_lo, out_hi);
  cudaError_t e = launch_any<true>(col, n_d, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, n_d, channels, s);
}

// K7b / K7d: x (lo, hi) [C, B, nb * n], any u64 -> (out_lo, out_hi)
// [C, B, nb * n] canonical, standard order within each block: the scaled
// inverse of x (y null: K7b) or of mont_mul(x, y) (K7d). planes1 / cvec1
// [C][..], planes2 / cvec2 [C * nb][..], diag [C * nb][8][n1][n2].
extern "C" int k7_inv_multi(const void* x_lo, const void* x_hi, const void* y_lo,
                            const void* y_hi, int batch, int n1, int n2, int nb, int channels,
                            const void* planes1, const void* cvec1, const void* planes2,
                            const void* cvec2, const void* diag, const void* scal, int n_d,
                            void* scratch_lo, void* scratch_hi, void* out_lo, void* out_hi,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass row, col;
  mxu64::inv_passes(&row, &col, x_lo, x_hi, y_lo, y_hi, batch, n1, n2, nb, t, scratch_lo,
                    scratch_hi, out_lo, out_hi);
  cudaError_t e = y_lo ? launch_any<true, true>(row, n_d, channels, s)
                       : launch_any<true, false>(row, n_d, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(col, n_d, channels, s);
}
