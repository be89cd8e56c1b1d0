// Radix-2 butterfly prime32 NTT for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel concrete_ntt_tpu/ops/pallas32.py::_build_call
// (kernel _make_kernel :78-111): every log2 n stage of a forward or inverse
// negacyclic NTT per polynomial, with the lt30 / lt31 / generic butterflies
// of ops/butterflies32.py, for any prime32 modulus and 2 <= n <= 2^15.
//
// What is computed is the stage engine of ops/engine.py: stage s has
// m = 2^s blocks of width 2t (t = n / 2^(s+1)); butterfly j of block i pairs
// elements i*2t + j and i*2t + j + t with the twiddle twid[m + i] (its Shoup
// companion beside it, or Montgomery form w*2^32 mod p for p >= 2^31). The
// forward runs stages 0 .. log2 n - 1, the inverse log2 n - 1 .. 0; the last
// stage (s = log2 n - 1 forward, s = 0 inverse) takes the regime's last
// butterfly. uint32_t wraparound gives the JAX u32 semantics exactly.
//
// Design. One block owns ppb = max(1, 1024 / n) whole polynomials (at least
// 1024 elements) in dynamic shared memory for all stages: one read and one
// write of device memory per element, __syncthreads() between stages.
// Twiddles come from the compact bit-reversed tables (n words each) through
// the L1 cache: the TPU kernel's stage-expanded [log2 n, n] tables and its
// roll/select data movement exist only because Mosaic has no gathers.
// n = 2^15 holds 128 KiB in shared memory, above the 48 KiB default, so the
// host raises cudaFuncAttributeMaxDynamicSharedMemorySize first.
//
// Bound: a transform of n = 2^14 does 2^13 butterflies in each of 14 stages
// (one or two 32-bit multiplies and a few selects each) and moves 128 KiB of
// device memory per polynomial, so it is bound by shared-memory and integer
// throughput inside each block; with one polynomial per block a batch of 16 uses
// 16 of the 132 SMs. Spreading a large polynomial over several blocks (or a
// cluster) and register-tiled radix-4 stages are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinElems = 1024;     // elements per block at small n
constexpr int kMaxSmem = 4 << 15;   // bytes for n = 2^15
constexpr size_t kDefaultSmem = 48 << 10;  // dynamic shared memory without opting in

enum Regime { kLt30 = 0, kLt31 = 1, kGeneric = 2 };

__device__ __forceinline__ uint32_t cond_sub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t z, uint32_t w, uint32_t w_sh,
                                               uint32_t p) {
  return z * w - __umulhi(z, w_sh) * p;
}

// REDC with the (lo != 0) carry; the 64-bit sum and one conditional
// subtract give ops/u32.py mont_mul's wrapping result
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p,
                                             uint32_t p_neginv) {
  const uint64_t ab = (uint64_t)a * b;
  const uint32_t lo = (uint32_t)ab;
  const uint32_t m = lo * p_neginv;
  const uint64_t s = (ab >> 32) + __umulhi(m, p) + (lo != 0u);
  return (uint32_t)(s >= p ? s - p : s);
}

// One butterfly of ops/butterflies32.py on (x0, x1) in place.
template <int kRegime, bool kFwd>
__device__ __forceinline__ void butterfly(uint32_t& x0, uint32_t& x1, uint32_t w, uint32_t ws,
                                          uint32_t p, uint32_t p_neginv, bool last) {
  const uint32_t two_p = 2u * p;
  if (kRegime == kLt30 && kFwd) {
    if (!last) {
      const uint32_t a = cond_sub(x0, two_p);
      const uint32_t t = shoup_lazy(x1, w, ws, p);
      x0 = a + t;
      x1 = a - t + two_p;
    } else {
      const uint32_t a = cond_sub(cond_sub(x0, two_p), p);
      const uint32_t t = cond_sub(shoup_lazy(x1, w, ws, p), p);
      x0 = cond_sub(a + t, p);
      x1 = cond_sub(a - t + p, p);
    }
  } else if (kRegime == kLt30) {
    const uint32_t y0 = cond_sub(x0 + x1, two_p);
    const uint32_t y1 = shoup_lazy(x0 - x1 + two_p, w, ws, p);
    x0 = last ? cond_sub(y0, p) : y0;
    x1 = last ? cond_sub(y1, p) : y1;
  } else if (kRegime == kLt31 && kFwd) {
    const uint32_t a = cond_sub(x0, p);
    const uint32_t t = cond_sub(shoup_lazy(x1, w, ws, p), p);
    const uint32_t y0 = a + t;
    const uint32_t y1 = a - t + p;
    x0 = last ? cond_sub(y0, p) : y0;
    x1 = last ? cond_sub(y1, p) : y1;
  } else if (kRegime == kLt31) {
    const uint32_t y0 = cond_sub(x0 + x1, p);
    x1 = cond_sub(shoup_lazy(x0 - x1 + p, w, ws, p), p);
    x0 = y0;
  } else if (kFwd) {
    const uint32_t t = mont_mul(x1, w, p, p_neginv);
    const uint32_t s = x0 + t;
    const uint32_t y0 = s < x0 ? s - p : cond_sub(s, p);
    x1 = x0 >= t ? x0 - t : x0 - t + p;
    x0 = y0;
  } else {
    const uint32_t s = x0 + x1;
    const uint32_t y0 = s < x0 ? s - p : cond_sub(s, p);
    const uint32_t d = x0 >= x1 ? x0 - x1 : x0 - x1 + p;
    x1 = mont_mul(d, w, p, p_neginv);
    x0 = y0;
  }
}

template <int kRegime, bool kFwd>
__global__ void __launch_bounds__(kThreads)
    ntt_radix2(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws, int batch,
               int log2n, int ppb, uint32_t p, uint32_t p_neginv) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log2n;
  const int elems = ppb * n;
  const long long base = (long long)blockIdx.x * elems;
  const long long total = (long long)batch * n;
  for (int i = threadIdx.x; i < elems; i += kThreads)
    buf[i] = base + i < total ? x[base + i] : 0u;  // polynomials past the batch: zeros
  __syncthreads();
  const int half_log = log2n - 1;
  const int pairs = elems >> 1;
  for (int st = 0; st < log2n; ++st) {
    const int s = kFwd ? st : log2n - 1 - st;
    const bool last = kFwd ? s == log2n - 1 : s == 0;
    const int log2t = log2n - 1 - s;
    const int m = 1 << s;
    for (int k = threadIdx.x; k < pairs; k += kThreads) {
      const int poly = k >> half_log;
      const int kk = k & ((1 << half_log) - 1);  // butterfly within the polynomial
      const int blk = kk >> log2t;
      const int i0 = poly * n + (blk << (log2t + 1)) + (kk & ((1 << log2t) - 1));
      const uint32_t w = tw[m + blk];
      const uint32_t ws = kRegime == kGeneric ? 0u : tws[m + blk];
      uint32_t x0 = buf[i0];
      uint32_t x1 = buf[i0 + (1 << log2t)];
      butterfly<kRegime, kFwd>(x0, x1, w, ws, p, p_neginv, last);
      buf[i0] = x0;
      buf[i0 + (1 << log2t)] = x1;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < elems; i += kThreads)
    if (base + i < total) out[base + i] = buf[i];
}

template <int kRegime, bool kFwd>
cudaError_t launch(const uint32_t* x, uint32_t* out, const uint32_t* tw, const uint32_t* tws,
                   int batch, int log2n, uint32_t p, uint32_t p_neginv, cudaStream_t stream) {
  const int n = 1 << log2n;
  const int ppb = n >= kMinElems ? 1 : kMinElems / n;
  const int blocks = (batch + ppb - 1) / ppb;
  const size_t smem = (size_t)ppb * n * sizeof(uint32_t);
  if (smem > kDefaultSmem) {  // n >= 2^14: opt in to the large carve-out
    cudaError_t e = cudaFuncSetAttribute(ntt_radix2<kRegime, kFwd>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  ntt_radix2<kRegime, kFwd><<<blocks, kThreads, smem, stream>>>(x, out, tw, tws, batch, log2n,
                                                                 ppb, p, p_neginv);
  return cudaGetLastError();
}

template <bool kFwd>
cudaError_t launch_regime(int regime, const uint32_t* x, uint32_t* out, const uint32_t* tw,
                          const uint32_t* tws, int batch, int log2n, uint32_t p,
                          uint32_t p_neginv, cudaStream_t s) {
  switch (regime) {
    case kLt30:
      return launch<kLt30, kFwd>(x, out, tw, tws, batch, log2n, p, p_neginv, s);
    case kLt31:
      return launch<kLt31, kFwd>(x, out, tw, tws, batch, log2n, p, p_neginv, s);
    case kGeneric:
      return launch<kGeneric, kFwd>(x, out, tw, tws, batch, log2n, p, p_neginv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: x [B, n] u32 -> out [B, n]; fwd != 0: standard order -> bit-reversed,
// else bit-reversed -> standard order. tw (and tws, unused for generic) are
// the compact bit-reversed tables of prime32._tables for the direction.
extern "C" int k4_ntt(const void* x, void* out, const void* tw, const void* tws, int batch,
                      int log2n, int regime, int fwd, unsigned int p, unsigned int p_neginv,
                      void* stream) {
  if (log2n < 1 || log2n > 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* w = (const uint32_t*)tw;
  const uint32_t* ws = (const uint32_t*)tws;
  cudaError_t e = fwd ? launch_regime<true>(regime, xi, o, w, ws, batch, log2n, p, p_neginv, s)
                      : launch_regime<false>(regime, xi, o, w, ws, batch, log2n, p, p_neginv, s);
  return (int)e;
}
