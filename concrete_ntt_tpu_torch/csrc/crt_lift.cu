// The native64 Plan32 Garner lift for Hopper (sm_90a): five 30-bit CRT
// channels -> the wrapping u64 value, one launch.
//
// Replaces no TPU kernel: in the JAX package the lift is XLA code
// (concrete_ntt_tpu/ops/crt.py rec_u64_from5). The port's plain twin,
// ops/crt.py rec_u64_from5 on int64 carriers, is a chain of about 860
// elementwise torch operations on [B, n] tensors; at (B, n) = (256, 2^14)
// it held 70 % of the north-star polymul. This kernel computes the same
// function in one pass over the residues.
//
// What is computed is ops/crt.py rec_u64_from5 (the reference's
// reconstruct_32bit_01234_v2, native64.rs:91-141), operation for operation,
// so that every wrap of the plain chain wraps here too and the bits agree on
// any uint32 input (canonical residues, what K1b and every channel plan's
// inverse return, are the contract):
//   * pair digits mod_p12 = m1 + p1 * ((2 p2 + m2 - m1) * p1^-1 mod p2), and
//     mod_p34 the same over (p3, p4), the difference wrapping mod 2^32;
//   * v0 = m0; v12 = (mod_p12 - v0 + 2 P12) * c12 mod P12; partial = v0 +
//     v12 * (p0 mod P34) mod P34; v34 = (mod_p34 - partial + 2 P34) * c34 mod
//     P34, wrapping mod 2^64 where the chain's limb pairs wrap;
//   * sign by the reference's digit rule v34 >= P34 // 2 + 1 (not the
//     explicit CRT's: they part in the hairline just above M / 2);
//   * pos = v0 + v12 * p0 + v34 * (p0 P12 mod 2^64), neg = pos - (M mod 2^64),
//     both mod 2^64.
// Every product by a constant is a Shoup product with the constant's
// companion floor(c * 2^k / p): the 32-bit one for the pair digits, the
// 64-bit one (__umul64hi) for the ~60-bit moduli, each followed by one
// conditional subtract, as ops/u32.py shoup_mul / _mul_mod64. The constants
// (ops/crt_cuda.py lift_constants, Python bigints once per primes tuple)
// come by value in the kernel's parameters: no device table, no copy a call,
// and a CUDA graph captures the launch whole.
//
// Bound: 28 bytes a coefficient (five u32 residues read, two u32 limbs
// written): 117,440,512 bytes at (256, 2^14), 0.035 ms at 3.35 TB/s. The
// arithmetic, with the 64-bit products emulated by 32-bit multiply-adds, is
// about 100-150 integer operations a coefficient, of the same order at the
// card's integer rate. Design for that: a streaming elementwise kernel, each
// thread four consecutive coefficients, one 16-byte load from each of the
// five channel planes and one 16-byte store to each limb plane, 256 threads
// a block (4,096 blocks at (256, 2^14)). A residue tensor whose planes are
// not all 16-byte aligned (a count B * n that is not a multiple of 4, or a
// misaligned base) takes the scalar instance, one coefficient a thread.

#include <cuda_runtime.h>
#include <stdint.h>

// The lift's constants (ops/crt_cuda.py Lift5Consts: the same fields in the
// same order). p12 = p1 p2, p34 = p3 p4; *_sh the Shoup companions;
// a34 = p0 mod P34; half34 = P34 // 2 + 1; k12 = p0 P12 mod 2^64;
// m = p0 P12 P34 mod 2^64.
struct Lift5Consts {
  uint64_t p12, p34, c12, c12_sh, a34, a34_sh, c34, c34_sh, half34, k12, m;
  uint32_t p0, p1, p2, p3, p4, inv12, inv12_sh, inv34, inv34_sh;
};

namespace {

constexpr int kThreads = 256;

// z * w mod p for z < 2^32, w < p < 2^31 (ops/u32.py shoup_mul)
__device__ __forceinline__ uint32_t shoup32(uint32_t z, uint32_t w, uint32_t w_sh, uint32_t p) {
  const uint32_t t = z * w - __umulhi(z, w_sh) * p;
  return t >= p ? t - p : t;
}

// z * w mod p for z < 2^64, w < p < 2^63 (ops/crt.py _mul_mod64)
__device__ __forceinline__ uint64_t shoup64(uint64_t z, uint64_t w, uint64_t w_sh, uint64_t p) {
  const uint64_t t = z * w - __umul64hi(z, w_sh) * p;
  return t >= p ? t - p : t;
}

// ops/crt.py _pair_digit: the residue mod p_lo p_hi of channels (lo, hi)
__device__ __forceinline__ uint64_t pair_digit(uint32_t m_lo, uint32_t m_hi, uint32_t p_lo,
                                               uint32_t p_hi, uint32_t inv, uint32_t inv_sh) {
  const uint32_t v_hi = shoup32(2u * p_hi + m_hi - m_lo, inv, inv_sh, p_hi);
  return (uint64_t)v_hi * p_lo + m_lo;
}

__device__ __forceinline__ uint64_t lift1(const Lift5Consts& c, uint32_t m0, uint32_t m1,
                                          uint32_t m2, uint32_t m3, uint32_t m4) {
  const uint64_t mod12 = pair_digit(m1, m2, c.p1, c.p2, c.inv12, c.inv12_sh);
  const uint64_t mod34 = pair_digit(m3, m4, c.p3, c.p4, c.inv34, c.inv34_sh);
  const uint64_t v12 = shoup64(mod12 - m0 + 2 * c.p12, c.c12, c.c12_sh, c.p12);
  const uint64_t partial = m0 + shoup64(v12, c.a34, c.a34_sh, c.p34);
  const uint64_t v34 = shoup64(mod34 - partial + 2 * c.p34, c.c34, c.c34_sh, c.p34);
  const uint64_t pos = m0 + (v12 * c.p0 + v34 * c.k12);
  return v34 >= c.half34 ? pos - c.m : pos;
}

// Vector instance: thread t lifts coefficients 4t .. 4t + 3 of count / 4
// groups (count a multiple of 4, every plane 16-byte aligned).
__global__ void __launch_bounds__(kThreads)
    lift_u64_from5_vec(const uint4* __restrict__ x, uint4* __restrict__ lo,
                       uint4* __restrict__ hi, long long groups, const Lift5Consts c) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const uint4 r0 = x[g], r1 = x[groups + g], r2 = x[2 * groups + g], r3 = x[3 * groups + g],
              r4 = x[4 * groups + g];
  const uint64_t v0 = lift1(c, r0.x, r1.x, r2.x, r3.x, r4.x);
  const uint64_t v1 = lift1(c, r0.y, r1.y, r2.y, r3.y, r4.y);
  const uint64_t v2 = lift1(c, r0.z, r1.z, r2.z, r3.z, r4.z);
  const uint64_t v3 = lift1(c, r0.w, r1.w, r2.w, r3.w, r4.w);
  lo[g] = make_uint4((uint32_t)v0, (uint32_t)v1, (uint32_t)v2, (uint32_t)v3);
  hi[g] = make_uint4((uint32_t)(v0 >> 32), (uint32_t)(v1 >> 32), (uint32_t)(v2 >> 32),
                     (uint32_t)(v3 >> 32));
}

// Scalar instance: thread t lifts coefficient t of count.
__global__ void __launch_bounds__(kThreads)
    lift_u64_from5_scalar(const uint32_t* __restrict__ x, uint32_t* __restrict__ lo,
                          uint32_t* __restrict__ hi, long long count, const Lift5Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const uint64_t v = lift1(c, x[i], x[count + i], x[2 * count + i], x[3 * count + i],
                           x[4 * count + i]);
  lo[i] = (uint32_t)v;
  hi[i] = (uint32_t)(v >> 32);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// x [5, count] u32 (channel planes of B * n residues each) -> lo, hi [count]
// u32, the wrapping u64 lift. count >= 1. The vector instance where count is
// a multiple of 4 and x, lo, hi are 16-byte aligned, else the scalar one.
extern "C" int lift_u64_from5(const void* x, void* lo, void* hi, long long count,
                              const Lift5Consts* consts, void* stream) {
  if (count <= 0 || consts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count % 4 == 0 && aligned16(x) && aligned16(lo) && aligned16(hi)) {
    const long long groups = count / 4;
    const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
    lift_u64_from5_vec<<<blocks, kThreads, 0, s>>>((const uint4*)x, (uint4*)lo, (uint4*)hi,
                                                   groups, *consts);
  } else {
    const unsigned blocks = (unsigned)((count + kThreads - 1) / kThreads);
    lift_u64_from5_scalar<<<blocks, kThreads, 0, s>>>((const uint32_t*)x, (uint32_t*)lo,
                                                      (uint32_t*)hi, count, *consts);
  }
  return (int)cudaGetLastError();
}
