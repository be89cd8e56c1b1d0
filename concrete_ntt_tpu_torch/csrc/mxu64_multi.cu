// Channel-grid four-step prime64 NTT for Hopper (sm_90a): kernels K7a and K7d.
//
// Replaces the TPU kernel
// concrete_ntt_tpu/ops/mxu64_pallas.py::_build_multi_call64 (:522), two of
// its entries:
//   K7a  k7a_fwd_multi            <- its fwd branch with a shared operand
//        (fwd_multi :679, kernel body :555-582): all Plan52 channels' forward
//        NTTs of one u64 operand, (lo, hi) [B, n] -> (lo, hi) [C, B, n];
//   K7d  k7d_pointwise_inv_multi  <- its inv branch with pointwise=True
//        (pointwise_inv_multi :728, _sc_mont_mul64 :391): the Montgomery
//        product of two [C, B, n] limb-pair operands (any u64) taken in the
//        load, then the scaled inverse, n^-1 * 2^64 folded into A_inv;
// for channel primes 2^33 < p < 2^62 (the "shoup" regime) with one plane
// count for all channels, and 2^11 <= n <= 2^15. That function's other two
// entries (inv_multi, fwd_multi_perchannel64) serve only the stage-split
// hybrid and are not ported yet.
//
// Design. Each transform is two launches of matmod64_pass (matmod64_pass.cuh,
// shared with K5/K6) with the channel on blockIdx.z: per-channel planes,
// diagonals and the 16-word scalar record are indexed by the channel; K7a's
// operand has channel stride 0. K7d's first pass is the pointwise instance of
// the template (kPointwise): each operand word is a limb of
// mont_mul(fl, fr) for any u64 fl, fr, with the overflow of the REDC sum
// kept as the limb-pair code keeps it.
//
// Bound at n = 2^14, B = 8, three 50-bit channels (D = 7, 8 operand planes
// in the first pass and 7 non-zero ones in the second): K7a needs 3 x 2 x
// 1024·256·7·128 = 1.4e9 dp4a (5.6e9 int8 MACs) against about 12 MiB of
// memory traffic (operand, scratch both ways, result, 5.3 MiB of operator
// tables that L2 holds): bound by integer-pipe throughput. K7d adds three 64 x 64-bit
// multiply-high chains per loaded operand word, and recomputes the product
// for the lo and the hi limb stage and for each of the o / 32 output tiles.

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

// K7a: (x_lo, x_hi) [B, n] -> (out_lo, out_hi) [C, B, n] canonical, bit-reversed.
extern "C" int k7a_fwd_multi(const void* x_lo, const void* x_hi, int batch, int n1, int n2,
                             int channels, const void* planes1, const void* cvec1,
                             const void* planes2, const void* cvec2, const void* diag,
                             const void* scal, int n_d, void* scratch_lo, void* scratch_hi,
                             void* out_lo, void* out_hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass col, row;
  mxu64::fwd_passes(&col, &row, x_lo, x_hi, 0, batch, n1, n2, t, scratch_lo, scratch_hi, out_lo,
                    out_hi);
  cudaError_t e = launch_any<true>(col, n_d, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(row, n_d, channels, s);
}

// K7d: fl, fr (lo, hi) [C, B, n], any u64 -> (out_lo, out_hi) [C, B, n]
// canonical, standard order: the scaled inverse of mont_mul(fl, fr).
extern "C" int k7d_pointwise_inv_multi(const void* fl_lo, const void* fl_hi, const void* fr_lo,
                                       const void* fr_hi, int batch, int n1, int n2,
                                       int channels, const void* planes1, const void* cvec1,
                                       const void* planes2, const void* cvec2, const void* diag,
                                       const void* scal, int n_d, void* scratch_lo,
                                       void* scratch_hi, void* out_lo, void* out_hi,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tables t{planes1, cvec1, planes2, cvec2, diag, scal};
  Pass row, col;
  mxu64::inv_passes(&row, &col, fl_lo, fl_hi, fr_lo, fr_hi, batch, n1, n2, t, scratch_lo,
                    scratch_hi, out_lo, out_hi);
  cudaError_t e = launch_any<true, true>(row, n_d, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_any<false>(col, n_d, channels, s);
}
