// The pointwise stage of the native Plan32 polymul for Hopper (sm_90a): the
// bare Montgomery product a * b * 2^-32 mod p of every channel, one launch.
//
// Replaces no TPU kernel: in the JAX package the product is XLA code
// (concrete_ntt_tpu/ops/ntt_dispatch.py's stacked polymul). The port's plain
// twin, ops/u32.py mont_mul on int64 carriers, is a chain of about 66
// elementwise torch operations on [C, B, n] tensors; at (5, 256, 2^14) it
// held 77 % of the north-star polymul, at (10, 64, 2^16) 68 % of native128's.
// This kernel computes the same function in one pass over the residues.
//
// What is computed is matmod_pass.cuh's mont_mul (mont32.cuh, the function
// K1d applies at its fragment read), so the bits agree with K1d and with the
// plain twin on any uint32 operands: the 64-bit REDC sum keeps the u32
// overflow of hi + mulhi(m, p) + carry, and one conditional subtract follows.
// The result is below 2^32 and congruent to a * b * 2^-32; it is canonical,
// in [0, p), wherever a * b < p * 2^32, so wherever one operand is below p
// (the forward transforms' outputs, what the polymul gives it). The
// channels' (p, -p^-1 mod 2^32) come by value in the kernel's parameters
// (Mont32Consts): no device table, no copy a call, and a CUDA graph captures
// the launch whole.
//
// Bound: 12 bytes a coefficient and channel (two u32 operands read, one u32
// product written): 0.075 ms at (C, B, n) = (5, 256, 2^14) and 0.150 ms at
// (10, 64, 2^16), at 3.35 TB/s. The arithmetic is about ten integer
// operations a coefficient, far below the card's integer rate. Design for
// the bytes: a streaming elementwise kernel, each thread four consecutive
// coefficients of one channel, one 16-byte load from each operand and one
// 16-byte store, 256 threads a block. The grid's y index is the channel
// (the flat index over the channel's count B * n), so a block's constants
// are uniform and no thread divides. Operands whose count is not a multiple
// of 4, or whose planes are not all 16-byte aligned, take the scalar
// instance, one coefficient a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mont32.cuh"

// The channels' constants (ops/pointwise_cuda.py Mont32Consts: the same
// fields in the same order), sized for every channel grid of the port.
constexpr int kMaxChannels = 16;
struct Mont32Consts {
  uint32_t p[kMaxChannels], p_neginv[kMaxChannels];
};

namespace {

constexpr int kThreads = 256;

// Vector instance: thread t of channel y multiplies coefficients 4t .. 4t + 3
// of its channel's count / 4 groups (count a multiple of 4, every plane
// 16-byte aligned).
__global__ void __launch_bounds__(kThreads)
    mont32_pointwise_vec(const uint4* __restrict__ fl, const uint4* __restrict__ fr,
                         uint4* __restrict__ out, long long groups, const Mont32Consts c) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const uint32_t p = c.p[blockIdx.y], ninv = c.p_neginv[blockIdx.y];
  const long long i = (long long)blockIdx.y * groups + g;
  const uint4 a = fl[i], b = fr[i];
  out[i] = make_uint4(mxu32::mont_mul(a.x, b.x, p, ninv), mxu32::mont_mul(a.y, b.y, p, ninv),
                      mxu32::mont_mul(a.z, b.z, p, ninv), mxu32::mont_mul(a.w, b.w, p, ninv));
}

// Scalar instance: thread t of channel y multiplies coefficient t of its
// channel's count.
__global__ void __launch_bounds__(kThreads)
    mont32_pointwise_scalar(const uint32_t* __restrict__ fl, const uint32_t* __restrict__ fr,
                            uint32_t* __restrict__ out, long long count, const Mont32Consts c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= count) return;
  const long long i = (long long)blockIdx.y * count + t;
  out[i] = mxu32::mont_mul(fl[i], fr[i], c.p[blockIdx.y], c.p_neginv[blockIdx.y]);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// fl, fr [channels, count] u32 -> out [channels, count] u32, the Montgomery
// product of channel y's constants. 1 <= channels <= kMaxChannels,
// count >= 1. The vector instance where count is a multiple of 4 and fl, fr,
// out are 16-byte aligned, else the scalar one.
extern "C" int mont32_pointwise(const void* fl, const void* fr, void* out, int channels,
                                long long count, const Mont32Consts* consts, void* stream) {
  if (channels < 1 || channels > kMaxChannels || count <= 0 || consts == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count % 4 == 0 && aligned16(fl) && aligned16(fr) && aligned16(out)) {
    const long long groups = count / 4;
    const dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)channels);
    mont32_pointwise_vec<<<grid, kThreads, 0, s>>>((const uint4*)fl, (const uint4*)fr,
                                                   (uint4*)out, groups, *consts);
  } else {
    const dim3 grid((unsigned)((count + kThreads - 1) / kThreads), (unsigned)channels);
    mont32_pointwise_scalar<<<grid, kThreads, 0, s>>>((const uint32_t*)fl, (const uint32_t*)fr,
                                                      (uint32_t*)out, count, *consts);
  }
  return (int)cudaGetLastError();
}
