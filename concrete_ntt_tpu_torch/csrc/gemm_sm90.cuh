// The mainloop of the port's two int8 tensor-core GEMM passes on Hopper
// (sm_90a), matmod_pass.cuh (32-bit; 32 outputs a block) and
// matmod64_pass.cuh (64-bit; 16 outputs a block), and its building blocks:
// cp.async copies into the shared-memory ring, the proxy fence that makes
// them visible to the tensor cores, wgmma's fence / group / wait, the
// descriptor of a K-major plane tile, and wgmma.mma_async m64nNk32
// .s32.s8.s8 with A from registers for every N the passes take: 16 * kD
// (kD 4-9 digit planes: N = 64..144), 32 * kD (kD 4 or 5: N = 128, 160) and
// 64 * 4 (N = 256: K1c / K1d's 64-output tile).
// The products are exact integers accumulated in int32.
//
// Tiling (both passes): a block owns kTM = 128 operand rows x kTO outputs x
// kD digits: two warpgroups of 64 rows, each one m64n(kTO kD)k32 product a
// k-step of 8 operand words. The contraction (n_limbs * k1 words,
// limb-major; k1 % kKC == 0, so a stage never straddles two limbs) streams
// through a ring of kStages shared-memory stages of kKC = 32 words each,
// filled kStages - 1 stages ahead of the products, one barrier and one wgmma
// group a stage. A register of the warpgroup's A fragment is four
// consecutive contraction bytes of one row, one operand word: the digit
// split is one xor (v ^ 0x80808080) applied when the fragment is read from
// shared memory, so either memory order of the operand serves. The operand
// tile has one layout per memory order, both bank-conflict-free for the
// fragment reads: contiguous rows (s_k == 1) as [row][kKC + 4] words,
// strided ones (s_r == 1) as [word][kTM + 8], four rows a 16-byte copy. The
// plane tile of a stage is the host-packed image of the descriptor's K-major
// core matrices (no swizzle: the next 16 contraction bytes 128 bytes on, the
// next 8 rows of N 1024 bytes on), one contiguous copy. Rows past the batch
// edge are zero-filled.
//
// The single-prime four-step K2 (matmod_pass.cuh, one channel: a small
// grid) also takes a smaller tile and a resident contraction: 64 rows (one
// warpgroup, 128 threads), kTO = 16, and kStages = 4 stages
// that hold the whole contraction where it has at most four stages (up to
// 128 words: n1 or n2 <= 128): every stage's copies are issued up front,
// then each stage's products as its copies land, one wgmma group in flight
// behind the next (no ring slot is reused, so no barrier waits for the
// products). A longer contraction runs the ring as above.
//
// The channel-grid kernels K1c / K1d take the same resident contraction on
// K1's 128-row tile too. One wgmma group stays in flight only there: in the
// ring's rolled loop a group in flight across the loop's back edge gave
// wrong sums on the card, where the unrolled resident path is exact, so the
// ring waits for each stage's group.
//
// A pair operand (K1d's first pass) is two arrays read at the same
// index, x[0] and x[1], both copied with cp.async into two operand slots of
// one layout; the word the digit split takes is pair(l, r) (the Montgomery
// product), taken where the A fragment is read: each operand word is read
// by one thread of its warpgroup, once a block.
//
// A presplit operand (K1e's first pass, Presplit) is the four int8 digit
// planes of contiguous rows: the 4 K bytes of a row, plane e at byte e K.
// It is copied with cp.async as K1b's words are, four 16-byte chunks a
// thread a stage, one chunk holding 16 bytes of one plane; a row's stage
// (32 values) lands as [plane][32 bytes] in the [row][kKC + 4] layout, so
// its chunks sit where K1b's would. The digit word of value v (byte e =
// plane e's byte v, the xor-128 pattern already) is packed where the A
// fragment is read: for two k-steps at a time lane t reads the sixteen
// bytes 16 kp .. + 15 of each plane of its two rows (one 16-byte load
// each), and three byte permutes (prmt) pick byte t of the four planes'
// words for value 8 ks + t (+ 4); the two k-steps' products are issued as
// soon as their registers are packed (a wgmma fence a pair), so two
// k-steps' plane words are live at a time.


#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

constexpr int kTM = 128;       // operand rows per block: two warpgroups of 64
constexpr int kKC = 32;        // contraction words per ring stage (four k32 steps)
constexpr int kStages = 3;     // ring depth: loads run kStages - 1 stages ahead
constexpr int kThreads = 256;  // two warpgroups; warp w of a group owns 16 rows
constexpr int kARow = kKC + 4;     // words a row, contiguous-row operand layout
constexpr uint32_t kDigitXor = 0x80808080u;  // byte e of v ^ this = int8 digit e
constexpr int kMaxDevices = 64;  // devices a process tracks for set_smem_once

// threads of a block of tm rows: one warpgroup (128 threads) per 64 rows
__host__ __device__ constexpr int threads(int tm) { return 2 * tm; }
// words a contraction word, strided operand layout of tm rows
__host__ __device__ constexpr int a_word(int tm) { return tm + 8; }
// words of one operand stage of tm rows (the larger of the two layouts)
__host__ __device__ constexpr int a_stage(int tm) {
  return tm * kARow > kKC * a_word(tm) ? tm * kARow : kKC * a_word(tm);
}

// words of one stage of a plane tile: kD * kTO rows (N) of kKC words (K)
__host__ __device__ constexpr int plane_stage(int kD, int kTO) { return kD * kTO * kKC; }
// dynamic shared memory of a block: the ring of plane and operand stages,
// and with a pair operand a second operand slot a stage
__host__ __device__ constexpr int smem_bytes(int kD, int kTO, int tm = kTM,
                                             int stages = kStages, bool pair = false) {
  return 4 * stages * (plane_stage(kD, kTO) + (pair ? 2 : 1) * a_stage(tm));
}
// blocks of `bytes` of dynamic shared memory an SM holds: 228 KiB, less
// 1 KiB the runtime reserves for each block
__host__ __device__ constexpr int blocks_per_sm(int bytes) {
  return 233472 / (bytes + 1024) > 0 ? 233472 / (bytes + 1024) : 1;
}

// The operand of a pass that is one array (or the limbs of one): no pair.
struct NoPair {};
// The operand as four int8 digit planes of each row (the header's note).
struct Presplit {};
// No per-chunk load: the operand tile is copied with cp.async (kPlain false).
struct NoLoad {};

inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// instance and device, not on every launch: the flags are per instance
// (a static of the template that calls this) and the setting lasts for the
// process
template <class K>
cudaError_t set_smem_once(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
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

// cp_async_wait with a count known only once a loop is unrolled (0 .. 7)
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Shared-memory writes of the generic proxy (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// digit word of byte t of four plane words: byte e = byte t of p[e] (t = 0..3)
__device__ __forceinline__ uint32_t plane_word(uint32_t p0, uint32_t p1, uint32_t p2,
                                               uint32_t p3, uint32_t sel) {
  return __byte_perm(__byte_perm(p0, p1, sel), __byte_perm(p2, p3, sel), 0x5410);
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

// wait until at most kPending wgmma groups of this warpgroup are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
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
// K-major in shared memory), int32, N = 2 * (the length of d). Warp w of the
// group holds rows 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4):
// a[0] = words t of row g, a[1] of row g + 8, a[2] / a[3] words t + 4 of
// the same rows; d[4i + q] = row g + 8 (q / 2), column 8i + 2t + q % 2.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[40], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[56], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55}"
      ", {%56, %57, %58, %59}, %60, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[72], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71}"
      ", {%72, %73, %74, %75}, %76, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[80], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"
      ", {%80, %81, %82, %83}, %84, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// The mainloop of a pass block: acc (this thread's part of its warpgroup's
// m64 x (kD * kTO) int32 tile; d[4i + q] = row g + 8 (q / 2), column 8i +
// 2t + q % 2) = the digit products of the block's kRows operand rows from
// row0 and its plane tiles `planes` ([stage][plane_stage(kD, kTO)] words).
// `a` is the pass descriptor (mxu32::Pass or mxu64::Pass: x[4], n_limbs,
// k1, s_k, s_r, x_b, rows_per_poly, total_rows), `chan` the element offset
// of the block's channel and block in the operand. The operand tile is
// copied with cp.async, or with kPlain (contiguous rows only; the 64-bit
// pointwise pass) stored from load(at, i0, limb): the four words of the
// 16-byte chunk at element offset `at` of limb `limb`, in the stage that
// starts at contraction word i0 of the limb, computed on the way. kRows =
// 128 (two warpgroups) or 64 (one); kResident: a contraction of at most
// kRing stages is loaded whole up front (the header's note), a longer one
// runs the ring. With a `pair` (one operand limb, copied with cp.async) the
// operand word is pair(x[0][i], x[1][i]); with Presplit the operand is the
// digit planes of contiguous rows (the header's notes).
template <int kD, int kTO, bool kPlain, int kRows = kTM, int kRing = kStages,
          bool kResident = false, class P, class Load, class Pair = NoPair>
__device__ __forceinline__ void mainloop(int (&acc)[kD * kTO / 2], const P& a, long long chan,
                                         int row0, const uint32_t* planes, uint32_t* smem,
                                         Load load, Pair pair = Pair{}) {
  constexpr bool kPresplit = std::is_same_v<Pair, Presplit>;
  constexpr bool kPair = !std::is_same_v<Pair, NoPair> && !kPresplit;
  static_assert(kRows == 64 || kRows == 128, "one or two warpgroups of 64 rows");
  static_assert(kRing >= 2 && kRing <= 8, "a ring of 2 to 8 stages");
  static_assert(!((kPair || kPresplit) && kPlain), "pair and presplit operands use cp.async");
  constexpr int kT = threads(kRows);
  constexpr int kAW = a_word(kRows);
  constexpr int kAS = a_stage(kRows);
  constexpr int kPS = plane_stage(kD, kTO);
  constexpr int kPChunks = kPS / 4;  // 16-byte chunks of a plane stage
  constexpr int kCols = kRows / 4;   // 16-byte chunks a contraction word, strided layout
  uint32_t* ps = smem;                // [kRing][kPS] plane tiles (the packed image)
  uint32_t* xs = smem + kRing * kPS;  // [kRing][kAS] operand words
  uint32_t* xq = xs + kRing * kAS;    // [kRing][kAS] a pair's second operand
  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int wrow = (tid >> 5) * 16;  // first row of the warp: group (tid / 128) * 64 + 16 w
  const int nk = a.n_limbs * a.k1 / kKC;
  const bool rowmajor = a.s_k == 1;  // each row's contraction words are contiguous

  // The four 16-byte operand chunks this thread fills in every stage:
  // contiguous rows, chunk tid % 8 of row tid / 8 + (kRows / 4) i; strided,
  // rows 4 (tid % kCols) .. + 3 of word tid / kCols + 8 i. x_src is the
  // element offset of the chunk's first value in the stage of contraction
  // word 0; with Presplit the byte offset in the planes of chunk c = tid %
  // 8: plane c / 2, values 16 (c % 2) .. + 15 (4 bytes an element of the
  // row's start), landing where K1b's chunk c of the row would.
  int x_dst[4];
  long long x_src[4];
  unsigned x_ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, w;
    if (rowmajor) {
      r = (tid >> 3) + (kT / 8) * i;
      w = 4 * (tid & 7);
      x_dst[i] = r * kARow + w;
    } else {
      r = 4 * (tid % kCols);
      w = tid / kCols + 8 * i;
      x_dst[i] = w * kAW + r;
    }
    const int m = row0 + r;
    x_src[i] = 0;
    if (m < a.total_rows) {
      const int b = m / a.rows_per_poly;
      const int j = m - b * a.rows_per_poly;
      const long long row = chan + (long long)b * a.x_b + (long long)j * a.s_r;
      if constexpr (kPresplit) {
        const int c = tid & 7;
        x_src[i] = 4 * row + (long long)(c >> 1) * a.k1 + 16 * (c & 1);
      } else {
        x_src[i] = row + (long long)w * a.s_k;
      }
      x_ok |= 1u << i;
    }
  }

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kKC;
    const int limb = k0 / a.k1;  // a stage never straddles two limbs (k1 % kKC == 0)
    const int i0 = k0 - limb * a.k1;
    const uint32_t* xl = limb == 0 ? a.x[0] : limb == 1 ? a.x[1] : limb == 2 ? a.x[2] : a.x[3];
    uint32_t* xd = xs + s * kAS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (x_ok >> i) & 1u;
      if constexpr (kPlain) {
        const uint4 v = ok ? load(x_src[i] + i0, i0, limb) : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(xd + x_dst[i]) = v;
      } else if constexpr (kPresplit) {
        cp_async16(xd + x_dst[i], reinterpret_cast<const uint8_t*>(a.x[0]) + x_src[i] + i0, ok);
      } else {
        cp_async16(xd + x_dst[i], xl + x_src[i] + (long long)i0 * a.s_k, ok);
        if constexpr (kPair)
          cp_async16(xq + s * kAS + x_dst[i], a.x[1] + x_src[i] + (long long)i0 * a.s_k, ok);
      }
    }
    // the stage's plane tile is one contiguous packed block: chunk tid + kT i
    uint32_t* pd = ps + s * kPS;
    const uint32_t* src = planes + (size_t)kt * kPS;
#pragma unroll
    for (int i = 0; i < (kPChunks + kT - 1) / kT; ++i) {
      const int q = tid + kT * i;
      if (kPChunks % kT == 0 || q < kPChunks) cp_async16(pd + 4 * q, src + 4 * q, true);
    }
  };

  // A fragment addresses: word (row r, word w) at r * rs + w * ws of a stage
  const int rs = rowmajor ? kARow : 1;
  const int ws = rowmajor ? 1 : kAW;
  const int a_lane = (wrow + g) * rs + t * ws;
  // the four k32 steps of ring slot s: A fragments (operand words, digit
  // split; kPair: the pair of the two slots' words) from shared memory,
  // then one wgmma group
  // Presplit: byte selector of this lane's value in a plane word (byte t of
  // the first word, of the second) and the lane's row offsets
  const uint32_t sel = (uint32_t)t | ((uint32_t)(t + 4) << 4);
  const int p_lane = (wrow + g) * kARow;
  auto products = [&](int s) {
    if constexpr (kPresplit) {
      // two k-steps' registers packed, then their products (one fence a
      // pair): two k-steps' plane words live at a time, the permutes beside
      // the tensor cores' work. Plane e of rows g, g + 8: words 4 kp .. + 3
      // (values 16 kp .. + 15: k-steps 2 kp and 2 kp + 1), one 16-byte load
      // each; the xor-128 pattern already, no digit xor.
      const uint32_t* pr0 = xs + s * kAS + p_lane;
#pragma unroll
      for (int kp = 0; kp < kKC / 16; ++kp) {
        const uint32_t* pr = pr0 + 4 * kp;
        uint4 lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = *reinterpret_cast<const uint4*>(pr + 8 * e);
          hi[e] = *reinterpret_cast<const uint4*>(pr + 8 * kARow + 8 * e);
        }
        const uint32_t af0[4] = {plane_word(lo[0].x, lo[1].x, lo[2].x, lo[3].x, sel),
                                 plane_word(hi[0].x, hi[1].x, hi[2].x, hi[3].x, sel),
                                 plane_word(lo[0].y, lo[1].y, lo[2].y, lo[3].y, sel),
                                 plane_word(hi[0].y, hi[1].y, hi[2].y, hi[3].y, sel)};
        const uint32_t af1[4] = {plane_word(lo[0].z, lo[1].z, lo[2].z, lo[3].z, sel),
                                 plane_word(hi[0].z, hi[1].z, hi[2].z, hi[3].z, sel),
                                 plane_word(lo[0].w, lo[1].w, lo[2].w, lo[3].w, sel),
                                 plane_word(hi[0].w, hi[1].w, hi[2].w, hi[3].w, sel)};
        wgmma_fence();
        wgmma_s8(acc, af0, plane_desc(ps + s * kPS + 64 * (2 * kp)));
        wgmma_s8(acc, af1, plane_desc(ps + s * kPS + 64 * (2 * kp + 1)));
      }
      wgmma_commit();
      return;
    }
    const uint32_t* xa = xs + s * kAS + a_lane;
    uint32_t af[kKC / 8][4];
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const uint32_t* xr = xa + 8 * ks * ws;
      if constexpr (kPair) {
        const uint32_t* yr = xq + s * kAS + a_lane + 8 * ks * ws;
        af[ks][0] = pair(xr[0], yr[0]) ^ kDigitXor;
        af[ks][1] = pair(xr[8 * rs], yr[8 * rs]) ^ kDigitXor;
        af[ks][2] = pair(xr[4 * ws], yr[4 * ws]) ^ kDigitXor;
        af[ks][3] = pair(xr[8 * rs + 4 * ws], yr[8 * rs + 4 * ws]) ^ kDigitXor;
      } else {
        af[ks][0] = xr[0] ^ kDigitXor;
        af[ks][1] = xr[8 * rs] ^ kDigitXor;
        af[ks][2] = xr[4 * ws] ^ kDigitXor;
        af[ks][3] = xr[8 * rs + 4 * ws] ^ kDigitXor;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks)
      wgmma_s8(acc, af[ks], plane_desc(ps + s * kPS + 64 * ks));  // 256 B a k-step
    wgmma_commit();
  };

#pragma unroll
  for (int i = 0; i < kD * kTO / 2; ++i) acc[i] = 0;
  if (kResident && nk <= kRing) {
    // the whole contraction: stage kt in slot kt, one copy group each (empty
    // past nk), so stage kt has landed once kRing - 1 - kt groups are pending
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
#pragma unroll
    for (int kt = 0; kt < kRing; ++kt) {
      if (kt < nk) {
        cp_async_wait_n(kRing - 1 - kt);  // this thread's copies of stage kt are in
        fence_proxy_async();              // and visible to the tensor cores' reads
        __syncthreads();                  // everyone's are
        products(kt);
        wgmma_wait<1>();  // the previous stage's group is done: its A registers are free
      }
    }
    wgmma_wait_all();
    return;
  }
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage kt are in
    fence_proxy_async();         // and visible to the tensor cores' reads
    __syncthreads();             // everyone's are, and stage kt - 1 is consumed
    if (kt + kRing - 1 < nk) load_stage((kt + kRing - 1) % kRing, kt + kRing - 1);
    cp_async_commit();
    products(kt % kRing);
    wgmma_wait_all();  // the A registers and this stage's tiles are free again
  }
}

}  // namespace sm90
