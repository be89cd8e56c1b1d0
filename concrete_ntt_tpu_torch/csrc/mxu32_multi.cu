// Channel-grid four-step prime32 NTT for Hopper (sm_90a): kernels K1a-K1d.
//
// Replaces the TPU kernel concrete_ntt_tpu/ops/mxu32_pallas.py::_build_multi_call:
//   K1a  k1a_fwd_wide_multi        <- its fwd branch (fwd_wide_multi, kernel body :367-397)
//   K1b  k1b_inv_multi             <- its inv branch (inv_multi, kernel body :398-412)
//   K1c  k1c_fwd_multi_perchannel  <- its fwd branch with perch_in=True
//                                     (fwd_multi_perchannel :544, fwd_wide_multi_perchannel :564)
//   K1d  k1d_pointwise_inv_multi   <- its inv branch with pointwise=True
//                                     (pointwise_inv_multi :637, _sc_mont_mul :505)
//   K1e  k1e_inv_multi_presplit    <- its inv branch with presplit=True
//                                     (inv_multi_presplit :614, digit_planes32 :602)
// for every CRT channel prime 2^29 < p < 2^30 and 2^11 <= n <= 2^17 (n1 <= 256,
// n2 <= 512). (The TPU serves K1c/K1d only at n >= 2^14, a VMEM/lane limit;
// the results are bit-identical at every n.) K1b, K1c and K1d also take the
// JAX function's hyb argument (:323; tables :262-289): nb > 1 block transforms of
// the 32-bit stage-split hybrid (ops/stagesplit.py) with per-block tables, the
// block on the grid's z axis (z = channel * nb + block), all blocks in one
// launch pair, operand and result in place in the [C, B, nb * n] arrays.
//
// What is computed is the JAX kernel's math (ops/mxu32.py): a four-step NTT
// made of two exact modular matrix products per channel and polynomial.
// Each product splits the operand into four int8 digits (byte - 128, the
// xor-128 bit pattern of _digit8), multiplies them with balanced-digit int8
// operator planes, accumulates in int32 (exact by assert_accumulator_exact),
// combines the four digit accumulators into a (lo, hi) u32 pair and reduces
// it with Shoup multiplies:
//   K1a: transpose [n1,n2]->[n2,n1] . planes1 (A, or A with the u64 / u128 ->
//        residue split folded in as 8 / 16 operand digit planes: 2 / 4 operand
//        limbs, contraction 4 * limbs * n1 digits) . scaled-lazy epilogue by
//        the diagonal d . transpose . planes2 (F) . canonical epilogue.
//   K1b: planes1 (G) . scaled-lazy epilogue by the diagonal e . transpose .
//        planes2 (scale-folded A_inv) . canonical epilogue . transpose.
//   K1c: K1a with a different operand (1 or 2 limbs) per channel: x [C][B][n]
//        per limb, the column pass reading channel c at c * B * n.
//   K1d: K1b whose first pass loads fl and fr [C][B][n] at the same index and
//        feeds mont_mul(fl, fr) (REDC for any u32 operands, its u32 overflow
//        kept) into the digit split; n^-1 * 2^32 is folded into A_inv.
//   K1e: K1b whose operand is [C][B][n1][4 * n2] int8 digit planes: the first
//        pass copies the planes with cp.async into K1b's ring (the same bytes:
//        four 16-byte runs, one a plane, a 16-value chunk) and packs the four
//        plane bytes of a value into its digit word with byte permutes where
//        the A fragment is read, no xor. On this card the in-kernel split is
//        one xor, so K1e saves nothing; it is ported because the reference
//        has it.
//
// Design. Each product is one launch of matmod_pass (matmod_pass.cuh, shared
// with K2/K3): a tiled int8 tensor-core GEMM (wgmma m64nNk32, s8 x s8 ->
// s32) with the digit split as one xor where the A fragment is read and the
// combine + reduction in the epilogue, here instantiated with four matrix
// digit planes and the lt30 epilogues (every channel prime is below 2^30).
// The [n2, n1] intermediate goes through global memory (the wrapper's
// scratch tensor); the mid-pass transpose is only a stride of the second
// pass's loads. Grid = (row tiles over batch x rows, output tiles, channel);
// rows past the batch edge are masked, so any batch size works. Both
// launches of a kernel go on the caller's stream; the C entry point returns
// cudaGetLastError() after them. K1c is K1a's launches with a channel
// stride on the operand; K1d's first pass is the pointwise instance of the
// template (kPointwise): fl and fr are copied with cp.async into two operand
// slots and multiplied where the A fragment is read (gemm_sm90.cuh's pair),
// so no stage waits a global round trip for its operand.
//
// K1c / K1d run the product plan's small channel grids (two or three
// channels: 128 blocks a pass at (2^14, 16, 2 ch) on K1's tile, 4 stages
// of contraction), so each pass takes a tile code from the host
// (ops/mxu32_cuda.py k1_tile, set by tools/sweep_product.py; matmod_pass.cuh
// Tile): K1's ring (code 0; not K1d's first pass), 64 x 16 (1), K1's tile
// holding the contraction of up to four stages whole with one wgmma group in
// flight (2: 136 KiB, 208 KiB with the pair), or 128 rows x 64 outputs on
// K1's ring (3: 150 KiB, 204 KiB with the pair; not K1c's scaled first
// pass), which copies each operand tile, and K1d's pair, once for twice the
// outputs. K1e takes codes the same way (k1_tile on C channels: "scaled"
// for the presplit first pass, codes 0-2, "canonical" for the second): at
// B = 1 over two channels K1's tile gave 8 blocks a pass on 132 SMs. K1a /
// K1b keep K1's instances (tile 0) and take no code; K2 / K3 keep theirs.
//
// Bound at n = 2^14, B = 8, five channels: K1a (two limbs) is 4.0e9 int8
// MACs (K1b 2.7e9) against about 12 MiB moved (operand, scratch written and
// read back, result, the 3.75 MiB of operator tables, which L2 holds); at
// (2^16, 8) 3.2e10 MACs against about 60 MiB. At the int8 tensor-core rate
// (989 TMAC/s dense) and 3.35 TB/s the MACs and the bytes take a few
// microseconds each at 2^14 and 10-30 at 2^16, so the kernel is bound by how
// close the contraction comes to the tensor cores' rate (measured in
// PERF.md section 6). K1d adds one 32x32
// multiply-high chain per operand value (n values per polynomial against
// n * n1 MACs), and two operand reads instead of one: every output tile's
// block copies and multiplies its rows again, so on 32-output tiles its
// first pass copies 1.5x a plain pass's bytes from L2 (about 4 TB/s on this
// card, PERF.md section 6), on 64-output tiles (code 3) as many as a plain
// pass on 32.

#include "matmod_pass.cuh"

using mxu32::kLt30;
using mxu32::launch;
using mxu32::Pass;

namespace {

// K1c / K1d / K1e's passes on the tile of code `tile` (matmod_pass.cuh
// Tile; the host's mxu32_cuda.k1_tile): code 0 on K1a / K1b's instances (and
// K1e's presplit instance), codes 1 and 2, and code 3 (64 outputs) for the
// canonical second passes and K1d's pointwise first pass; no code 0 for the
// pointwise pass, no code 3 for the scaled first passes (K1c's, K1e's)
template <bool kScaled, bool kPointwise = false, bool kPresplit = false>
cudaError_t launch_k1(const Pass& a, int channels, int tile, cudaStream_t s) {
  switch (tile) {
    case 0:
      if constexpr (!kPointwise) return launch<4, kLt30, kScaled, false, kPresplit>(a, channels, s);
      break;
    case 1:
      return launch<4, kLt30, kScaled, kPointwise, kPresplit, 1>(a, channels, s);
    case 2:
      return launch<4, kLt30, kScaled, kPointwise, kPresplit, 2>(a, channels, s);
    case 3:
      if constexpr (kPointwise || !kScaled)
        return launch<4, kLt30, kScaled, kPointwise, kPresplit, 3>(a, channels, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K1a: x0 (, x1 (, x2, x3)) [B, n] u32 limbs of a u32 / u64 / u128 operand
// (n_limbs = 1, 2 or 4) -> out [C, B, n] canonical, bit-reversed.
extern "C" int k1a_fwd_wide_multi(const void* x0, const void* x1, const void* x2,
                                  const void* x3, int n_limbs, int batch,
                                  int n1, int n2, int channels, const void* planes1,
                                  const void* cvec1, const void* planes2, const void* cvec2,
                                  const void* diag, const void* scal, void* scratch, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  const void* const x[4] = {x0, x1, x2, x3};
  mxu32::fwd_passes(&col, &row, x, n_limbs, 0, batch, n1, n2, 1, planes1, cvec1, planes2,
                    cvec2, diag, scal, scratch, out);
  cudaError_t e = launch<4, kLt30, true>(col, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(row, channels, s);
}

// K1b: x [C, B, nb * n] u32 (any representative) -> out [C, B, nb * n] canonical,
// standard order within each of the nb blocks (nb = 1: the direct transform).
extern "C" int k1b_inv_multi(const void* x, int batch, int n1, int n2, int nb, int channels,
                             const void* planes1, const void* cvec1, const void* planes2,
                             const void* cvec2, const void* diag, const void* scal,
                             void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, x, batch, n1, n2, nb, planes1, cvec1, planes2, cvec2, diag,
                    scal, scratch, out);
  cudaError_t e = launch<4, kLt30, true>(row, channels, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<4, kLt30, false>(col, channels, s);
}

// K1e: xd [C, B, n1, 4 * n2] int8 digit planes of K1b's operand (16-byte
// aligned) -> out [C, B, n] canonical, standard order: the bits of K1b on the
// values the planes hold. tile1, tile2: the tile codes of the row and the
// column pass.
extern "C" int k1e_inv_multi_presplit(const void* xd, int batch, int n1, int n2, int channels,
                                      int tile1, int tile2, const void* planes1,
                                      const void* cvec1, const void* planes2, const void* cvec2,
                                      const void* diag, const void* scal, void* scratch,
                                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, xd, batch, n1, n2, 1, planes1, cvec1, planes2, cvec2, diag,
                    scal, scratch, out);
  cudaError_t e = launch_k1<true, false, true>(row, channels, tile1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_k1<false>(col, channels, tile2, s);
}

// K1c: x0 (, x1) [C, B, nb * n] u32 limbs, one operand per channel (any values)
// -> out [C, B, nb * n] canonical, bit-reversed; nb > 1: the hybrid's blocks.
// tile1, tile2: the tile codes of the column and the row pass.
extern "C" int k1c_fwd_multi_perchannel(const void* x0, const void* x1, int n_limbs, int batch,
                                        int n1, int n2, int nb, int channels, int tile1,
                                        int tile2, const void* planes1, const void* cvec1,
                                        const void* planes2, const void* cvec2, const void* diag,
                                        const void* scal, void* scratch, void* out,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass col, row;
  const void* const x[4] = {x0, x1, x0, x0};  // 1 or 2 limbs
  mxu32::fwd_passes(&col, &row, x, n_limbs, (long long)batch * nb * n1 * n2, batch, n1, n2, nb,
                    planes1, cvec1, planes2, cvec2, diag, scal, scratch, out);
  cudaError_t e = launch_k1<true>(col, channels, tile1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_k1<false>(row, channels, tile2, s);
}

// K1d: fl, fr [C, B, nb * n] u32 (any representatives) -> out [C, B, nb * n] =
// inv(mont_mul(fl, fr)) times the scale folded into A_inv, canonical,
// standard order within each block. tile1, tile2: the tile codes of the row
// and the column pass.
extern "C" int k1d_pointwise_inv_multi(const void* fl, const void* fr, int batch, int n1,
                                       int n2, int nb, int channels, int tile1, int tile2,
                                       const void* planes1, const void* cvec1,
                                       const void* planes2, const void* cvec2, const void* diag,
                                       const void* scal, void* scratch, void* out,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass row, col;
  mxu32::inv_passes(&row, &col, fl, batch, n1, n2, nb, planes1, cvec1, planes2, cvec2, diag,
                    scal, scratch, out);
  row.x[1] = (const uint32_t*)fr;  // the pointwise pass's second operand (n_limbs stays 1)
  cudaError_t e = launch_k1<true, true>(row, channels, tile1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_k1<false>(col, channels, tile2, s);
}

// Dynamic shared memory of a block of K1c / K1d's passes on the tile of
// code `tile`, with K1d's second operand if `pair`, for the build report.
extern "C" int k1_smem_bytes(int tile, int pair) {
  if (tile < 0 || tile >= mxu32::kTiles) return -1;
  return mxu32::smem_bytes(4, tile, pair != 0);
}
