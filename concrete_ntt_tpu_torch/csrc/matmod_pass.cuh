// One exact modular GEMM pass of the four-step prime32 NTT, for every
// prime32 regime: the building block of kernels K1a-K1e (mxu32_multi.cu)
// and K2/K3 (mxu32_pass.cu). Replaces the GEMM body shared by the TPU
// kernels of concrete_ntt_tpu/ops/mxu32_pallas.py (_build_call :72-107,
// _build_multi_call :367-412, _build_pass_call :706-719).
//
// The pass computes the JAX package's ops/mxu32.py math for a [rows, K] x
// [K, O] product mod p per polynomial and channel: the operand (any u32
// representative, or the 2 / 4 little-endian limbs of a u64 / u128) is split
// into int8 digits (byte - 128,
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
// What bounds it on the H100. A pass is an int8 GEMM of B*R rows, 4*L*K
// contraction bytes and kD*O columns, exact in int32 (assert_accumulator_exact:
// |U_d - 2^27| < 2^27 up to a contraction of 4096 digits), whose operands are
// a few MiB: at the main path's shapes its int8 operations take longer than
// its bytes even at the tensor cores' rate (989 int8 TMAC/s dense), and tens of
// times longer on the CUDA cores' byte dot products.
//
// Design: Hopper's warpgroup product on the int8 tensor cores,
// wgmma.mma_async m64nNk32 .s32.s8.s8, N = 32 * kD, A from registers and B
// from shared memory. A register of the warpgroup's A fragment is four
// consecutive contraction bytes of one row, which is exactly one operand
// word: the digit split stays one xor (v ^ 0x80808080), applied when the
// fragment is read from shared memory, so either memory order of the operand
// serves (wgmma takes 8-bit A only K-major from shared memory, and three of
// the four passes contract a strided axis). B is K-major, as wgmma takes
// 8-bit B: the host packs each plane word (ops/mxu32_cuda.py pack_planes:
// byte e of word (l*K + i, col) meets digit e of value i of limb l) into
// per-block tiles in the exact shared-memory image of the descriptor's core
// matrices without swizzle (pack_planes_kmajor), so a stage is one
// contiguous copy. The products are exact integers, so the accumulators hold
// the exact digit sums of ops/mxu32.py bit for bit. The N axis is the kD digit
// columns of kTO outputs; the n8 chunks of digit d sit at the same output
// offsets for every d, so each thread holds all kD accumulators of its own
// (row, output) pairs and the combine and both epilogues stay per element.
//
// Tiling: a block owns kTM = 128 operand rows x kTO = 32 outputs x kD
// digits: two warpgroups of 64 rows, each one m64n(32 kD)k32 product a
// k-step of 8 operand words, 64 (kD 4) or 80 (kD 5) accumulators a thread.
// The contraction streams through a ring of kStages shared-memory stages of
// kKC = 32 words each, filled with cp.async 16-byte copies kStages - 1
// stages ahead of the products, one barrier and one wgmma group a stage. The
// operand tile has two layouts, one per memory order, both
// bank-conflict-free for the fragment reads: contiguous rows (s_k == 1, the
// inverse's row pass and K3) are copied as [row][kKC + 4] words, strided
// ones (s_r == 1: the column passes and the forward row pass) as
// [word][kTM + 8], four rows a copy. Dynamic shared memory, 102 KiB with
// four digits (two blocks an SM), 114 KiB with five. Strides of the operand
// and of the output are fields of the descriptor, so a mid-pass transpose is
// a stride of the next pass's loads. Grid = (row tiles over batch x rows,
// output tiles, z); rows past the batch edge are zero-filled and not stored.
//
// The z axis is channel * nb + block. nb = 1 is a direct transform. With the
// 32-bit stage-split hybrid's block tables (ops/stagesplit.py) a transform of
// size nb * n is nb block transforms of size n after the prefix butterflies:
// block `blk` reads and writes its n-slice of each polynomial in place (x_blk,
// out_blk; the polynomial stride x_b / out_b is then the parent's size), takes
// its own diagonal rows, and takes its own planes where the pass is the
// column operator (A_b, the wide A_b of two limbs, A_inv,b: planes_blk) or
// the channel's where it is the shared row operator (F, G). The scalar record
// is the channel's. This is the layout of matmod64_pass.cuh.
//
// kPresplit (K1e's first pass): the operand arrives as the int8 digit planes
// of ops/mxu32_cuda.py digit_planes32, [.., rows, 4 * K] bytes, plane-major in
// the last axis; the four plane bytes of a value are the xor-128 pattern
// already, so they are packed into the digit word as they are.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxu32 {

constexpr int kTM = 128;       // operand rows per block: two warpgroups of 64
constexpr int kTO = 32;        // outputs per block (kD digit columns each)
constexpr int kKC = 32;        // contraction words per ring stage (four k32 steps)
constexpr int kStages = 3;     // ring depth: loads run kStages - 1 stages ahead
constexpr int kThreads = 256;  // two warpgroups; warp w of a group owns 16 rows
constexpr int kARow = kKC + 4;     // words a row, contiguous-row operand layout
constexpr int kAWord = kTM + 8;    // words a contraction word, strided operand layout
constexpr int kAStage = kTM * kARow > kKC * kAWord ? kTM * kARow : kKC * kAWord;
constexpr uint32_t kDigitXor = 0x80808080u;  // byte e of v ^ this = int8 digit e

// words of one stage of the plane tile: kD * kTO rows (N) of kKC words (K),
// in the host-packed order of ops/mxu32_cuda.py pack_planes_kmajor: 8-row
// groups of eight 16-byte chunks of eight rows (wgmma's K-major core
// matrices without swizzle: next chunk along K 128 bytes on, next 8 rows
// 1024 bytes on)
__host__ __device__ constexpr int plane_stage(int kD) { return kD * kTO * kKC; }
__host__ __device__ constexpr int smem_bytes(int kD) {
  return 4 * kStages * (plane_stage(kD) + kAStage);
}

// Per-channel scalar record (uint32 words), built by ops/mxu32_cuda.py
// scalar_record: p, 2^32 mod p, its Shoup companion, -p^-1 mod 2^32,
// 2^64 mod p, 2p mod 2^32, the chain length, then the chain of multiples of
// p that brings a u32 into [0, p) (ops/mxu32.py::_reduce_chain).
constexpr int kScalWords = 16;
constexpr int kMaxChain = kScalWords - 7;

enum Regime { kLt30 = 0, kLt31 = 1, kGeneric = 2 };

struct Pass {
  const uint32_t* x[4];  // operand limbs (x[l] read only if l < n_limbs; K1d reads x[1])
  long long x_b;         // elements between polynomials of the operand
  long long x_chan;      // elements between channels of the operand (0: shared)
  long long x_blk = 0;   // elements between blocks of the operand
  int nb = 1;            // blocks per channel (grid z = channel * nb + block)
  int planes_blk = 0;    // planes / cvec indexed by z (per block), else by the channel
  int n_limbs;
  int k1;                // contraction words per limb (multiple of kKC)
  int s_k, s_r;          // operand strides of the contraction and the row index
  int rows_per_poly;     // R
  int total_rows;        // B * R
  int o;                 // outputs per row (multiple of kTO)
  long long out_b;       // elements between polynomials of the output
  long long out_chan;    // elements between channels of the output
  long long out_blk = 0; // elements between blocks of the output
  int t_r, t_o;          // output strides of the row and the output index
  const int32_t* planes;  // [C or C * nb][o / kTO][n_limbs * k1 / kKC][plane_stage(kD)] words
  const int32_t* cvec;    // [C or C * nb][kD][o]
  const uint32_t* diag;   // [C * nb][4 or 2][R][o] (scaled pass; see scale_tabs)
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

// 16 bytes global -> shared, asynchronous; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory writes of the generic proxy (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Matrix descriptor of a K-major plane tile stage without swizzle, at k-step
// `smem`: start address, leading byte offset 128 (the next 16 contraction
// bytes), stride byte offset 1024 (the next 8 rows of N), in 16-byte units.
__device__ __forceinline__ uint64_t plane_desc(const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}

// d += a (64 x 32 int8 of the warpgroup, registers) * b (32 x N int8,
// K-major in shared memory), int32, N = 32 * kD. Warp w of the group holds
// rows 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4): a[0] = words t
// of row g, a[1] of row g + 8, a[2] / a[3] words t + 4 of the same rows;
// d[4i + q] = row g + 8 (q / 2), column 8i + 2t + q % 2.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[80], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// kPointwise (K1d's first pass): the operand value is the Montgomery product
// mont_mul(x[0][i], x[1][i]) of two operands read at the same index (both
// any u32, one limb each), taken in the load before the digit split.
// kPointwise and kPresplit load their operand tile with plain loads and
// stores (the value is computed or packed on the way); every other pass
// copies it with cp.async.
template <int kD, int kRegime, bool kScaled, bool kPointwise = false, bool kPresplit = false>
__global__ void __launch_bounds__(kThreads, kD == 4 ? 2 : 1) matmod_pass(Pass a) {
  static_assert(!(kPointwise && kPresplit), "the presplit operand is one array of planes");
  constexpr int kPS = plane_stage(kD);
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* ps = smem;                   // [kStages][kPS] plane tiles (the packed image)
  uint32_t* xs = smem + kStages * kPS;   // [kStages][kAStage] operand words
  const int z = blockIdx.z;
  const int c = z / a.nb;        // channel
  const int blk = z - c * a.nb;  // block of the channel
  const int pz = a.planes_blk ? z : c;
  const int row0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTO;
  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int wrow = (tid >> 5) * 16;  // first row of the warp: group (tid / 128) * 64 + 16 w
  const int kw = a.n_limbs * a.k1;
  const int nk = kw / kKC;
  // this block's plane tiles: [pz][output tile][stage][kPS]
  const uint32_t* planes = reinterpret_cast<const uint32_t*>(a.planes) +
                           ((size_t)pz * (a.o / kTO) + blockIdx.y) * nk * kPS;
  const long long chan = (long long)c * a.x_chan + (long long)blk * a.x_blk;
  const bool rowmajor = a.s_k == 1;  // each row's contraction words are contiguous
  uint32_t pw_p = 0, pw_neginv = 0;  // p and -p^-1 of the channel (kPointwise)
  if constexpr (kPointwise) {
    pw_p = a.scal[kScalWords * c];
    pw_neginv = a.scal[kScalWords * c + 3];
  }

  // The four 16-byte operand chunks this thread fills in every stage:
  // contiguous rows, chunk q of row r = tid / 8 + 32 i; strided, rows
  // 4 (tid % 32) .. + 3 of word tid / 32 + 8 i. x_src is the element offset
  // of the chunk's first value in the stage of contraction word 0.
  int x_dst[4];
  long long x_src[4];
  unsigned x_ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, w;
    if (rowmajor) {
      r = (tid >> 3) + 32 * i;
      w = 4 * (tid & 7);
      x_dst[i] = r * kARow + w;
    } else {
      r = 4 * (tid & 31);
      w = (tid >> 5) + 8 * i;
      x_dst[i] = w * kAWord + r;
    }
    const int m = row0 + r;
    x_src[i] = 0;
    if (m < a.total_rows) {
      const int b = m / a.rows_per_poly;
      const int j = m - b * a.rows_per_poly;
      x_src[i] = chan + (long long)b * a.x_b + (long long)j * a.s_r + (long long)w * a.s_k;
      x_ok |= 1u << i;
    }
  }

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kKC;
    const int limb = k0 / a.k1;  // a stage never straddles two limbs (k1 % kKC == 0)
    const int i0 = k0 - limb * a.k1;
    const uint32_t* xl = limb == 0 ? a.x[0] : limb == 1 ? a.x[1] : limb == 2 ? a.x[2] : a.x[3];
    uint32_t* xd = xs + s * kAStage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (x_ok >> i) & 1u;
      if constexpr (kPointwise || kPresplit) {  // contiguous rows (s_k == 1)
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const long long at = x_src[i] + i0;
          if constexpr (kPointwise) {
            const uint4 l = *reinterpret_cast<const uint4*>(a.x[0] + at);
            const uint4 r = *reinterpret_cast<const uint4*>(a.x[1] + at);
            v = make_uint4(mont_mul(l.x, r.x, pw_p, pw_neginv), mont_mul(l.y, r.y, pw_p, pw_neginv),
                           mont_mul(l.z, r.z, pw_p, pw_neginv), mont_mul(l.w, r.w, pw_p, pw_neginv));
          } else {
            // value i0 + w + u of row j has its digit e at byte 4 * (row start)
            // + e * k1 + (i0 + w + u) of the plane array; the bytes are the
            // xor-128 pattern already, so undo the xor the fragment read applies
            const int w = 4 * (tid & 7);
            const uint8_t* xb =
                reinterpret_cast<const uint8_t*>(a.x[0]) + 4 * (x_src[i] - w) + i0 + w;
            uint32_t u[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              u[e] = ((uint32_t)xb[e] | ((uint32_t)xb[a.k1 + e] << 8) |
                      ((uint32_t)xb[2 * a.k1 + e] << 16) | ((uint32_t)xb[3 * a.k1 + e] << 24)) ^
                     kDigitXor;
            v = make_uint4(u[0], u[1], u[2], u[3]);
          }
        }
        *reinterpret_cast<uint4*>(xd + x_dst[i]) = v;
      } else {
        cp_async16(xd + x_dst[i], xl + x_src[i] + (long long)i0 * a.s_k, ok);
      }
    }
    // the stage's plane tile is one contiguous packed block: chunk tid + 256 i
    uint32_t* pd = ps + s * kPS + 4 * tid;
    const uint32_t* src = planes + (size_t)kt * kPS + 4 * tid;
#pragma unroll
    for (int i = 0; i < kD; ++i) cp_async16(pd + 4 * kThreads * i, src + 4 * kThreads * i, true);
  };

  // A fragment addresses: word (row r, word w) at r * rs + w * ws of a stage
  const int rs = rowmajor ? kARow : 1;
  const int ws = rowmajor ? 1 : kAWord;
  const int a_lane = (wrow + g) * rs + t * ws;

  int acc[kD * kTO / 2];  // the warpgroup's m64 x (kD * kTO) int32 tile, this thread's part
#pragma unroll
  for (int i = 0; i < kD * kTO / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt are in
    fence_proxy_async();           // and visible to the tensor cores' reads
    __syncthreads();               // everyone's are, and stage kt - 1 is consumed
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const int s = kt % kStages;
    const uint32_t* xa = xs + s * kAStage + a_lane;
    uint32_t af[kKC / 8][4];  // the four k32 steps' A fragments: operand words, digit split
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const uint32_t* xr = xa + 8 * ks * ws;
      af[ks][0] = xr[0] ^ kDigitXor;
      af[ks][1] = xr[8 * rs] ^ kDigitXor;
      af[ks][2] = xr[4 * ws] ^ kDigitXor;
      af[ks][3] = xr[8 * rs + 4 * ws] ^ kDigitXor;
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks)
      wgmma_s8(acc, af[ks], plane_desc(ps + s * kPS + 64 * ks));  // 2 chunks of 128 B a k-step
    wgmma_commit();
    wgmma_wait_all();  // the A registers and this stage's tiles are free again
  }

  const uint32_t* sc = a.scal + kScalWords * c;
  const uint32_t p = sc[0], c32 = sc[1], c32_sh = sc[2], p_neginv = sc[3];
  const uint32_t c64m = sc[4], two_p = sc[5];
  uint32_t chain[kMaxChain];  // zero past the chain's end: cond_sub(l, 0) == l
#pragma unroll
  for (int i = 0; i < kMaxChain; ++i) chain[i] = i < (int)sc[6] ? sc[7 + i] : 0u;
  const int32_t* cvz = a.cvec + (size_t)pz * kD * a.o;
  uint32_t* outz = a.out + (long long)c * a.out_chan + (long long)blk * a.out_blk;
  // digit d of output 8 jj + 2t + cc of row g + 8 hr: accumulator
  // 4 (4d + jj) + 2 hr + cc (column d * kTO + 8 jj + 2t + cc of the tile)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = row0 + wrow + 8 * hr + g;
    if (m >= a.total_rows) continue;
    const int b = m / a.rows_per_poly;
    const int j = m - b * a.rows_per_poly;
#pragma unroll
    for (int jj = 0; jj < kTO / 8; ++jj) {
      const int oi0 = o0 + 8 * jj + 2 * t;
      uint32_t y[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int oi = oi0 + cc;
        const int q = 2 * hr + cc;
        // _combine: U_d = acc_d + cvec_d in [0, 2^28); V = sum_d U_d 2^(8d)
        uint64_t v = 0;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          v += (uint64_t)(uint32_t)(acc[4 * (4 * d + jj) + q] + cvz[d * a.o + oi]) << (8 * d);
        const uint32_t lo = (uint32_t)v;
        uint32_t hi = (uint32_t)(v >> 32);
        if constexpr (kD == 5) hi += (uint32_t)(acc[4 * (16 + jj) + q] + cvz[4 * a.o + oi]);
        if constexpr (kScaled) {
          // _epilogue_scaled_lazy: lo*W + hi*(2^32 W)
          const size_t plane = (size_t)a.rows_per_poly * a.o;
          const int n_dg = kRegime == kGeneric ? 2 : 4;
          const uint32_t* dg = a.diag + (size_t)z * n_dg * plane + (size_t)j * a.o + oi;
          if (kRegime == kGeneric) {
            y[cc] = add_mod(mont_mul(lo, dg[0], p, p_neginv),
                            mont_mul(hi, dg[plane], p, p_neginv), p);
          } else {
            const uint32_t s0 = shoup_lazy(lo, dg[0], dg[plane], p);              // [0, 2p)
            const uint32_t s1 = shoup_lazy(hi, dg[2 * plane], dg[3 * plane], p);  // [0, 2p)
            if (kRegime == kLt30) {
              y[cc] = cond_sub(s0 + s1, two_p);  // s0 + s1 < 4p < 2^32
            } else {
              y[cc] = cond_sub(cond_sub(s0, p) + cond_sub(s1, p), p);
            }
          }
        } else {
          // _epilogue_canonical: (hi * 2^32 + lo) mod p in [0, p)
          const uint32_t r = kRegime == kGeneric ? mont_mul(hi, c64m, p, p_neginv)
                                                 : cond_sub(shoup_lazy(hi, c32, c32_sh, p), p);
          uint32_t l = lo;
#pragma unroll
          for (int i = 0; i < kMaxChain; ++i) l = cond_sub(l, chain[i]);
          y[cc] = kRegime == kGeneric ? add_mod(r, l, p) : cond_sub(r + l, p);
        }
      }
      uint32_t* dst = outz + (long long)b * a.out_b + (long long)j * a.t_r + (long long)oi0 * a.t_o;
      if (a.t_o == 1) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(y[0], y[1]);
      } else {
        dst[0] = y[0];
        dst[a.t_o] = y[1];
      }
    }
  }
}

// What the tiles need of a pass: whole stages and output tiles, operand
// chunks of 16 aligned bytes in one of the two memory orders (contiguous
// rows only for the pointwise and presplit first passes), aligned plane rows,
// and aligned output pairs where the outputs of a row are contiguous. n_x
// operand pointers are read 16 bytes at a time (the presplit planes byte by
// byte: none).
inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

inline bool tiles_fit(const Pass& a, bool rows_only, int n_x) {
  if (a.k1 % kKC || a.o % kTO || a.total_rows <= 0) return false;
  if (a.s_k == 1 ? a.s_r % 4 != 0
                 : (rows_only || a.s_r != 1 || a.s_k % 4 || a.rows_per_poly % 4))
    return false;
  if ((a.x_b | a.x_chan | a.x_blk) % 4) return false;
  if (a.t_o == 1 && ((a.out_b | a.out_chan | a.out_blk | a.t_r) % 2 || (uintptr_t)a.out & 7))
    return false;
  for (int l = 0; l < n_x; ++l)
    if (!aligned16(a.x[l])) return false;
  return aligned16(a.planes);
}

template <int kD, int kRegime, bool kScaled, bool kPointwise = false, bool kPresplit = false>
cudaError_t launch(const Pass& a, int channels, cudaStream_t stream) {
  if (!tiles_fit(a, kPointwise || kPresplit, kPresplit ? 0 : kPointwise ? 2 : a.n_limbs))
    return cudaErrorInvalidValue;
  auto kernel = matmod_pass<kD, kRegime, kScaled, kPointwise, kPresplit>;
  constexpr int smem = smem_bytes(kD);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.total_rows + kTM - 1) / kTM, a.o / kTO, channels * a.nb);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The two passes of nb four-step forward block transforms of size n = n1 * n2
// over channels (nb = 1: one direct transform). The operand holds polynomials
// of nb * n values, block blk at offset blk * n. Column pass (rows (b, j <
// n2), contract i < n1 at x[i*n2 + j], diagonal d, per-block planes A_b) into
// scratch [C][nb][B][n2][n1], then row pass (rows (b, r < n1), contract j < n2
// at scratch[j*n1 + r], canonical, the channel's planes F) into out
// [C][B][nb * n] (bit-reversed). x holds four limb pointers; those at and past
// n_limbs are not read. x_chan is 0 for an operand shared by all channels.
inline void fwd_passes(Pass* col, Pass* row, const void* const x[4], int n_limbs,
                       long long x_chan, int batch, int n1, int n2, int nb,
                       const void* planes1, const void* cvec1,
                       const void* planes2, const void* cvec2, const void* diag,
                       const void* scal, void* scratch, void* out) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;  // the parent polynomial
  Pass a{};
  for (int l = 0; l < 4; ++l) a.x[l] = (const uint32_t*)x[l < n_limbs ? l : 0];
  a.x_b = poly;
  a.x_chan = x_chan;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 1;
  a.n_limbs = n_limbs;
  a.k1 = n1;
  a.s_k = n2;
  a.s_r = 1;
  a.rows_per_poly = n2;
  a.total_rows = batch * n2;
  a.o = n1;
  a.out_b = n;
  a.out_blk = (long long)batch * n;
  a.out_chan = (long long)batch * poly;
  a.t_r = n1;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *col = a;
  Pass b = a;
  for (int l = 0; l < 4; ++l) b.x[l] = (const uint32_t*)scratch;
  b.x_b = n;
  b.x_blk = (long long)batch * n;
  b.x_chan = (long long)batch * poly;
  b.planes_blk = 0;
  b.n_limbs = 1;
  b.k1 = n2;
  b.s_k = n1;
  b.s_r = 1;
  b.rows_per_poly = n1;
  b.total_rows = batch * n1;
  b.o = n2;
  b.out_b = poly;
  b.out_blk = n;
  b.t_r = n2;
  b.t_o = 1;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *row = b;
}

// The two passes of nb four-step inverse block transforms: row pass (rows (b,
// r < n1), contract j < n2 at x[r*n2 + j], diagonal e, the channel's planes
// G) into scratch [C][nb][B][n1][n2], then column pass (rows (b, k < n2),
// contract r < n1 at scratch[r*n2 + k], canonical, per-block planes A_inv,b)
// into out[s*n2 + k] of each block (standard order within the block).
inline void inv_passes(Pass* row, Pass* col, const void* x, int batch, int n1, int n2, int nb,
                       const void* planes1, const void* cvec1, const void* planes2,
                       const void* cvec2, const void* diag, const void* scal, void* scratch,
                       void* out) {
  const int n = n1 * n2;
  const long long poly = (long long)nb * n;
  Pass a{};
  for (int l = 0; l < 4; ++l) a.x[l] = (const uint32_t*)x;
  a.x_b = poly;
  a.x_chan = (long long)batch * poly;
  a.x_blk = n;
  a.nb = nb;
  a.planes_blk = 0;
  a.n_limbs = 1;
  a.k1 = n2;
  a.s_k = 1;
  a.s_r = n2;
  a.rows_per_poly = n1;
  a.total_rows = batch * n1;
  a.o = n2;
  a.out_b = n;
  a.out_blk = (long long)batch * n;
  a.out_chan = (long long)batch * poly;
  a.t_r = n2;
  a.t_o = 1;
  a.planes = (const int32_t*)planes1;
  a.cvec = (const int32_t*)cvec1;
  a.diag = (const uint32_t*)diag;
  a.scal = (const uint32_t*)scal;
  a.out = (uint32_t*)scratch;
  *row = a;
  Pass b = a;
  for (int l = 0; l < 4; ++l) b.x[l] = (const uint32_t*)scratch;
  b.x_b = n;
  b.x_blk = (long long)batch * n;
  b.planes_blk = 1;
  b.k1 = n1;
  b.s_k = n2;
  b.s_r = 1;
  b.rows_per_poly = n2;
  b.total_rows = batch * n2;
  b.o = n1;
  b.out_b = poly;
  b.out_blk = n;
  b.t_r = 1;
  b.t_o = n2;
  b.planes = (const int32_t*)planes2;
  b.cvec = (const int32_t*)cvec2;
  b.diag = nullptr;
  b.out = (uint32_t*)out;
  *col = b;
}

}  // namespace mxu32
