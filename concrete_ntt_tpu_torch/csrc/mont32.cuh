// The Montgomery product of the 32-bit GEMM pass's pointwise operand
// (matmod_pass.cuh, K1d) and of the Plan32 polymul's pointwise stage
// (mont32_pointwise.cu): one device function, so both give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxu32 {

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

}  // namespace mxu32
