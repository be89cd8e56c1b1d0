// The native128 Plan32 Garner lift for Hopper (sm_90a): ten 30-bit CRT
// channels -> the wrapping u128 value, in two launches (digits, then limbs).
//
// Replaces no TPU kernel: in the JAX package the lift is XLA code
// (concrete_ntt_tpu/ops/crt.py rec_u128_from10). The port's plain twin,
// ops/crt.py rec_u128_from10 on int64 carriers, is a chain of about 5,000
// elementwise torch operations on [B, n] tensors; at (B, n) = (64, 2^16) it
// held 79 % of the native128 polymul. These two kernels compute the same
// function in two passes.
//
// What is computed is ops/crt.py rec_u128_from10 (the reference's
// reconstruct_32bit_0123456789_v2, native128.rs:20-118), operation for
// operation, so that every wrap of the plain chain wraps here too and the
// bits agree on any uint32 input (canonical residues, what K1b and every
// channel plan's inverse return, are the contract):
//   * lift_u128_digits: the five pair digits (ops/crt.py _pair_digit) over
//     (p0, p1) ... (p8, p9), the difference wrapping mod 2^32; then the outer
//     Garner over the pair moduli P01 ... P89 (_pair_digits_from10): digit
//     i = (pair_i - acc + 2 P_i) * phi_i mod P_i, acc the Horner sum
//     d_{i-1}, then d_j + acc * (P_j mod P_i) mod P_i for j = i - 2 ... 0,
//     every sum and the lazy difference wrapping mod 2^64. Out: the digits
//     v01, v23, v45, v67, v89 as five u64 planes.
//   * lift_u128_limbs: pos = v01 + sum_i v_i * (P_0 ... P_{i-1} mod 2^128)
//     mod 2^128; pos - (M mod 2^128) where v89 >= P89 // 2 + 1 (the
//     reference's digit rule, not the explicit CRT's: they part in the
//     hairline just above M / 2), the sign read again from v89, so no sign
//     plane crosses memory. Out: four u32 limb planes.
// Every product by a constant modulo a prime or a pair modulus is a Shoup
// product with the constant's companion floor(c * 2^k / p): the 32-bit one
// for the pair digits, the 64-bit one (__umul64hi) for the ~60-bit pair
// moduli, each followed by one conditional subtract, as ops/u32.py
// shoup_mul and ops/crt.py _mul_mod64. The constants (ops/crt_cuda.py
// lift10_constants, Python bigints once per primes tuple) come by value in
// the kernels' parameters: no device table, no copy a call, and a CUDA
// graph captures both launches whole.
//
// Bound: the digits kernel reads ten u32 residues and writes five u64
// digits, 80 bytes a coefficient; the limbs kernel reads the digits and
// writes four u32 limbs, 56 bytes: 335,544,320 and 234,881,024 bytes at
// (64, 2^16), 0.100 and 0.070 ms at 3.35 TB/s. The arithmetic, about ten
// 64-bit and five 32-bit Shoup products a coefficient (the 64-bit ones
// emulated by 32-bit multiply-adds), is of the same order at the card's
// integer rate. Design for that: two streaming elementwise kernels, each
// thread four consecutive coefficients with 16-byte loads and stores from
// and to every plane, 256 threads a block. Two launches and not one, so
// that each stage keeps its own span (ops/crt_cuda.py); fusing would save
// the digits' round trip, 80 bytes a coefficient. Planes that are not all
// 16-byte aligned (a count B * n that is not a multiple of 4, or a
// misaligned base) take the scalar instance, one coefficient a thread.

#include <cuda_runtime.h>
#include <stdint.h>

// The lift's constants (ops/crt_cuda.py Lift10Consts: the same fields in the
// same order). pp: the pair moduli P_i = p_{2i} p_{2i+1}. horner / _sh:
// P_j mod P_i with its Shoup companion, for (i, j) = (2, 0), (3, 1), (3, 0),
// (4, 2), (4, 1), (4, 0), the Horner order. phi / _sh: (P_0 ... P_{i-1})^-1
// mod P_i for i = 1 ... 4. pref_lo / _hi: P_0 ... P_{i-1} mod 2^128 for
// i = 1 ... 4. m_lo / m_hi: M = P_0 ... P_4 mod 2^128. half: P_4 // 2 + 1.
// p: the ten primes; inv / _sh: p_{2i}^-1 mod p_{2i+1}.
struct Lift10Consts {
  uint64_t pp[5], horner[6], horner_sh[6], phi[4], phi_sh[4], pref_lo[4], pref_hi[4];
  uint64_t m_lo, m_hi, half;
  uint32_t p[10], inv[5], inv_sh[5];
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

// ops/crt.py _pair_digits_from10 (without the sign): ten residues -> the
// five mixed-radix digits
__device__ __forceinline__ void digits10(const Lift10Consts& c, const uint32_t (&m)[10],
                                         uint64_t (&d)[5]) {
  uint64_t pair[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // _pair_digit over (p_{2i}, p_{2i+1})
    const uint32_t lo = m[2 * i], p_hi = c.p[2 * i + 1];
    const uint32_t v = shoup32(2u * p_hi + m[2 * i + 1] - lo, c.inv[i], c.inv_sh[i], p_hi);
    pair[i] = (uint64_t)v * c.p[2 * i] + lo;
  }
  d[0] = pair[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    uint64_t acc = d[i - 1];
#pragma unroll
    for (int j = i - 2; j >= 0; --j) {
      const int k = (i - 1) * (i - 2) / 2 + (i - 2 - j);  // (i, j)'s place in horner
      acc = d[j] + shoup64(acc, c.horner[k], c.horner_sh[k], c.pp[i]);
    }
    d[i] = shoup64(pair[i] - acc + 2 * c.pp[i], c.phi[i - 1], c.phi_sh[i - 1], c.pp[i]);
  }
}

// The limbs of rec_u128_from10: the prefix products' multiply-accumulate mod
// 2^128, and M subtracted where the top digit says negative.
__device__ __forceinline__ uint4 limbs10(const Lift10Consts& c, const uint64_t (&d)[5]) {
  uint64_t lo = d[0], hi = 0;
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    const uint64_t plo = d[i] * c.pref_lo[i - 1];
    lo += plo;
    hi += __umul64hi(d[i], c.pref_lo[i - 1]) + d[i] * c.pref_hi[i - 1] + (lo < plo);
  }
  if (d[4] >= c.half) {
    hi -= c.m_hi + (lo < c.m_lo);
    lo -= c.m_lo;
  }
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
}

// Vector instance: thread t lifts coefficients 4t .. 4t + 3 of count / 4
// groups (count a multiple of 4, every plane 16-byte aligned). x: ten u32
// planes; d: five u64 planes, each two ulonglong2 a group.
__global__ void __launch_bounds__(kThreads)
    lift_u128_digits_vec(const uint4* __restrict__ x, ulonglong2* __restrict__ d,
                         long long groups, const Lift10Consts c) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  uint32_t m[4][10];
#pragma unroll
  for (int ch = 0; ch < 10; ++ch) {
    const uint4 r = x[ch * groups + g];
    m[0][ch] = r.x, m[1][ch] = r.y, m[2][ch] = r.z, m[3][ch] = r.w;
  }
  uint64_t v[4][5];
#pragma unroll
  for (int q = 0; q < 4; ++q) digits10(c, m[q], v[q]);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    d[2 * (i * groups + g)] = make_ulonglong2(v[0][i], v[1][i]);
    d[2 * (i * groups + g) + 1] = make_ulonglong2(v[2][i], v[3][i]);
  }
}

// Scalar instance: thread t lifts coefficient t of count.
__global__ void __launch_bounds__(kThreads)
    lift_u128_digits_scalar(const uint32_t* __restrict__ x, uint64_t* __restrict__ d,
                            long long count, const Lift10Consts c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= count) return;
  uint32_t m[10];
#pragma unroll
  for (int ch = 0; ch < 10; ++ch) m[ch] = x[ch * count + t];
  uint64_t v[5];
  digits10(c, m, v);
#pragma unroll
  for (int i = 0; i < 5; ++i) d[i * count + t] = v[i];
}

// Vector instance of the limbs: d five u64 planes, out four u32 planes.
__global__ void __launch_bounds__(kThreads)
    lift_u128_limbs_vec(const ulonglong2* __restrict__ d, uint4* __restrict__ out,
                        long long groups, const Lift10Consts c) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  uint64_t v[4][5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const ulonglong2 a = d[2 * (i * groups + g)], b = d[2 * (i * groups + g) + 1];
    v[0][i] = a.x, v[1][i] = a.y, v[2][i] = b.x, v[3][i] = b.y;
  }
  uint4 w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = limbs10(c, v[q]);
  out[g] = make_uint4(w[0].x, w[1].x, w[2].x, w[3].x);
  out[groups + g] = make_uint4(w[0].y, w[1].y, w[2].y, w[3].y);
  out[2 * groups + g] = make_uint4(w[0].z, w[1].z, w[2].z, w[3].z);
  out[3 * groups + g] = make_uint4(w[0].w, w[1].w, w[2].w, w[3].w);
}

__global__ void __launch_bounds__(kThreads)
    lift_u128_limbs_scalar(const uint64_t* __restrict__ d, uint32_t* __restrict__ out,
                           long long count, const Lift10Consts c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= count) return;
  uint64_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = d[i * count + t];
  const uint4 w = limbs10(c, v);
  out[t] = w.x;
  out[count + t] = w.y;
  out[2 * count + t] = w.z;
  out[3 * count + t] = w.w;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// x [10, count] u32 (channel planes of B * n residues each) -> d [5, count]
// u64, the mixed-radix digits. count >= 1. The vector instance where count is
// a multiple of 4 and x, d are 16-byte aligned, else the scalar one.
extern "C" int lift_u128_digits(const void* x, void* d, long long count,
                                const Lift10Consts* consts, void* stream) {
  if (count <= 0 || consts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count % 4 == 0 && aligned16(x) && aligned16(d)) {
    lift_u128_digits_vec<<<blocks_for(count / 4), kThreads, 0, s>>>(
        (const uint4*)x, (ulonglong2*)d, count / 4, *consts);
  } else {
    lift_u128_digits_scalar<<<blocks_for(count), kThreads, 0, s>>>(
        (const uint32_t*)x, (uint64_t*)d, count, *consts);
  }
  return (int)cudaGetLastError();
}

// d [5, count] u64 digits -> out [4, count] u32, the wrapping u128 limbs,
// least significant first. count >= 1; instances as lift_u128_digits.
extern "C" int lift_u128_limbs(const void* d, void* out, long long count,
                               const Lift10Consts* consts, void* stream) {
  if (count <= 0 || consts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count % 4 == 0 && aligned16(d) && aligned16(out)) {
    lift_u128_limbs_vec<<<blocks_for(count / 4), kThreads, 0, s>>>(
        (const ulonglong2*)d, (uint4*)out, count / 4, *consts);
  } else {
    lift_u128_limbs_scalar<<<blocks_for(count), kThreads, 0, s>>>(
        (const uint64_t*)d, (uint32_t*)out, count, *consts);
  }
  return (int)cudaGetLastError();
}
