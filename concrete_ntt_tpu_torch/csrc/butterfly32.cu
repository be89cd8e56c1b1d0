// Radix-2 butterfly prime32 NTT for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel concrete_ntt_tpu/ops/pallas32.py::_build_call
// (kernel _make_kernel :78-111): every log2 n stage of a forward or inverse
// negacyclic NTT per polynomial, with the lt30 / lt31 / generic butterflies
// of ops/butterflies32.py, for any prime32 modulus and 2 <= n <= 2^17 (the
// TPU kernel stops at 2^15, where its polynomial outgrows VMEM; above that
// the reference runs its XLA stage engine, the same function).
//
// What is computed is the stage engine of ops/engine.py: stage s has
// m = 2^s blocks of width 2t (t = n / 2^(s+1)); butterfly j of block i pairs
// elements i*2t + j and i*2t + j + t with the twiddle twid[m + i] (its Shoup
// companion beside it, or Montgomery form w*2^32 mod p for p >= 2^31). The
// forward runs stages 0 .. log2 n - 1, the inverse log2 n - 1 .. 0; the last
// stage (s = log2 n - 1 forward, s = 0 inverse) takes the regime's last
// butterfly. Every value goes through the same butterflies, in the same
// stage order and with the same twiddles, as in the stage engine, so the
// lazy lt30 / lt31 ranges and the generic regime's Montgomery carry give its
// bits; uint32_t wraparound gives the JAX u32 semantics exactly.
//
// Bound: a transform of n = 2^14 does 2^13 butterflies in each of 14 stages
// (one or two 32-bit multiplies and a few selects each, about 12 integer
// operations) and moves 128 KiB of device memory per polynomial: at B = 16
// 0.00033 ms of the CUDA cores' 67 TOP/s against 0.00066 ms of memory, so
// bytes bound it; in practice the latency of its phases does (loads,
// shared-memory rounds, barriers), and how many SMs hold a polynomial.
//
// Design. A cluster of c = 1, 2, 4 or 8 blocks owns a polynomial (c is the
// host's: ops/butterfly32_cuda.py cluster_size, so that B * c fills the
// card while each block holds n / c >= 256 values, at most 2^15), each
// block n / c of its values in dynamic shared memory; with c = 1 below
// n = 1024 a block holds 1024 / n whole polynomials. With c > 1 the forward's
// first log2 c stages (strides n/2 .. n/c) only combine the c values of a
// "column" k * (n/c) + j; block r takes the n / c^2 columns r * n/c^2 + jj,
// reads them coalesced over jj, runs those stages in registers and stores
// value k of each column into block k's shared memory through distributed
// shared memory (a cluster's blocks can address each other's); after one
// cluster barrier block r holds the contiguous slice r * (n/c) .. of the
// polynomial and runs the remaining stages on it alone, where stage s takes
// twid[(c + r) * 2^(s - log2 c) + i] for its local block i. The inverse is
// the mirror: the slice's stages, a cluster barrier, the column stages read
// from the peers' shared memory and written to device memory, and a last
// barrier so that no block leaves while its peers read it. Inside a block,
// stages run in rounds in registers: a thread loads 2^k values that k
// consecutive stages combine (stride n / 2^(s0 + k) apart), runs the k stages
// on them, and stores them back, one barrier a round; k is at most the
// host's rlog (butterfly32_cuda.radix_log: radix 8, or 4 for blocks of up to
// 1024 values; the kernel takes 1 to 3). log2(n/c) = 11 stages at (2^14,
// c = 8): rounds of 3, 3, 3 and 2 stages, four block barriers in place of
// eleven, beside the cluster's two. The regime's last butterfly (its extra
// conditional subtracts) is compiled only into the round that holds the
// last stage (round_k), so no other round carries a select for it: on one
// H100 that made (2^14, 16) 0.0076 -> 0.0070 ms forward and 0.0084 ->
// 0.0077 inverse (PERF.md §6).
// Twiddles come from the compact bit-reversed tables (n words each) through
// the read-only cache: the TPU kernel's stage-expanded [log2 n, n] tables
// and its roll/select data movement exist only because Mosaic has no
// gathers. A value's shared-memory word is swizzled (swz) so that the
// strided groups of a round share a bank two lanes at most. Blocks of more than
// 48 KiB opt in to the large carve-out once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinElems = 1024;         // values a block of whole polynomials holds
constexpr int kMinLog2Slice = 8;        // values a block of a cluster holds at least
constexpr int kMaxLog2Block = 15;       // and at most (128 KiB of shared memory)
constexpr int kMaxSmem = 4 << kMaxLog2Block;
constexpr int kMaxRadixLog = 3;         // stages a thread runs in registers between barriers
constexpr int kMaxLog2Cluster = 3;      // 8 blocks: the portable cluster size
constexpr int kMaxDevices = 64;

enum Regime { kLt30 = 0, kLt31 = 1, kGeneric = 2 };

// Shared-memory word of value i: bits 3-7 of i xored into bits 0-4 (an
// invertible map of each 256 words onto themselves), so that a warp's
// groups in a round (values 2^log_s apart) put at most two lanes on a bank
// (8 values in a row, log_s = 0, would put 8 there) and 32 consecutive
// values one
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 31); }

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

struct Mod {
  const uint32_t* __restrict__ tw;   // compact twiddles of the direction
  const uint32_t* __restrict__ tws;  // their Shoup companions (not read for generic)
  uint32_t p, p_neginv;
};

// Stages s0 .. s0 + kK - 1 of a segment's stage structure on the 2^kK values
// v[u] of one group (value u at stride 2^(kK-1-a) of stage s0 + a), forward
// in that order, inverse in the other. hb is the group's block index at stage
// s0; stage s takes the twiddle (mult << s) + i of its local block i (mult =
// 1 for a whole polynomial or its columns, c + r for slice r of a cluster).
// With kLast, stage last_s takes the last butterfly; without it, none does
// (the caller's stages do not hold last_s).
template <int kRegime, bool kFwd, int kK, bool kLast>
__device__ __forceinline__ void run_stages(uint32_t (&v)[1 << kK], int s0, int hb, int mult,
                                           const Mod& md, int last_s) {
#pragma unroll
  for (int aa = 0; aa < kK; ++aa) {
    const int a = kFwd ? aa : kK - 1 - aa;
    const int s = s0 + a;
    const int h = (1 << kK) >> (a + 1);
    const bool last = kLast && s == last_s;
#pragma unroll
    for (int blk = 0; blk < (1 << a); ++blk) {
      const int idx = (mult << s) + (hb << a) + blk;
      const uint32_t w = __ldg(md.tw + idx);
      const uint32_t ws = kRegime == kGeneric ? 0u : __ldg(md.tws + idx);
#pragma unroll
      for (int j = 0; j < h; ++j)
        butterfly<kRegime, kFwd>(v[2 * h * blk + j], v[2 * h * blk + j + h], w, ws, md.p,
                                 md.p_neginv, last);
    }
  }
}

// One radix-2^kK round over the e values of buf, which are segments of
// 2^log2l values each (a polynomial or a cluster's slice): local stages
// s0 .. s0 + kK - 1. Group gi holds values base + u * 2^log_s, u < 2^kK.
template <int kRegime, bool kFwd, int kK, bool kLast>
__device__ void radix_round(uint32_t* buf, int e, int log2l, int s0, int mult, const Mod& md,
                            int last_s) {
  constexpr int kR = 1 << kK;
  const int log_s = log2l - s0 - kK;
  for (int gi = threadIdx.x; gi < (e >> kK); gi += blockDim.x) {
    const int hi = gi >> log_s;
    const int base = (hi << (log_s + kK)) | (gi & ((1 << log_s) - 1));
    uint32_t v[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) v[u] = buf[swz(base + (u << log_s))];
    run_stages<kRegime, kFwd, kK, kLast>(v, s0, hi & ((1 << s0) - 1), mult, md, last_s);
#pragma unroll
    for (int u = 0; u < kR; ++u) buf[swz(base + (u << log_s))] = v[u];
  }
}

// radix_round with the last butterfly compiled in only for the round that
// holds stage last_s
template <int kRegime, bool kFwd, int kK>
__device__ __forceinline__ void round_k(uint32_t* buf, int e, int log2l, int s0, int mult,
                                        const Mod& md, int last_s) {
  if (last_s >= s0 && last_s < s0 + kK)
    radix_round<kRegime, kFwd, kK, true>(buf, e, log2l, s0, mult, md, last_s);
  else
    radix_round<kRegime, kFwd, kK, false>(buf, e, log2l, s0, mult, md, last_s);
}

// All log2l local stages of every segment of buf, in rounds of at most rlog
// (<= kMaxRadixLog) stages as even as they split (fwd: from stage 0 up; inv:
// the mirror), a block barrier after each round.
template <int kRegime, bool kFwd>
__device__ void segment_stages(uint32_t* buf, int e, int log2l, int mult, const Mod& md,
                               int last_s, int rlog) {
  const int rounds = (log2l + rlog - 1) / rlog;
  int done = 0;
  for (int i = 0; i < rounds; ++i) {
    const int k = (log2l - done + rounds - i - 1) / (rounds - i);
    const int s0 = kFwd ? done : log2l - done - k;
    switch (k) {
      case 1:
        round_k<kRegime, kFwd, 1>(buf, e, log2l, s0, mult, md, last_s);
        break;
      case 2:
        round_k<kRegime, kFwd, 2>(buf, e, log2l, s0, mult, md, last_s);
        break;
      default:
        round_k<kRegime, kFwd, 3>(buf, e, log2l, s0, mult, md, last_s);
        break;
    }
    done += k;
    __syncthreads();
  }
}

// The column stages of a cluster of 2^kC blocks (global stages 0 .. kC - 1):
// block r's columns col = r * 2^log2w + jj, value k of a column at
// k * 2^log2l + col of the polynomial. Forward: read from device memory,
// run the stages, store value k into block k's slice at col. Inverse: read
// value k from block k's slice at col, run the stages (the last butterfly at
// stage 0), write to device memory.
template <int kRegime, bool kFwd, int kC>
__device__ void column_stages(cg::cluster_group& cluster, uint32_t* buf, const uint32_t* xb,
                              uint32_t* ob, int r, int log2l, int log2w, const Mod& md) {
  constexpr int kN = 1 << kC;
  uint32_t* peer[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) peer[k] = cluster.map_shared_rank(buf, k);
  for (int jj = threadIdx.x; jj < (1 << log2w); jj += blockDim.x) {
    const int col = (r << log2w) + jj;
    uint32_t v[kN];
    if constexpr (kFwd) {
#pragma unroll
      for (int k = 0; k < kN; ++k) v[k] = xb[(k << log2l) + col];
      run_stages<kRegime, true, kC, false>(v, 0, 0, 1, md, -1);
#pragma unroll
      for (int k = 0; k < kN; ++k) peer[k][swz(col)] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) v[k] = peer[k][swz(col)];
      run_stages<kRegime, false, kC, true>(v, 0, 0, 1, md, 0);
#pragma unroll
      for (int k = 0; k < kN; ++k) ob[(k << log2l) + col] = v[k];
    }
  }
}

template <int kRegime, bool kFwd>
__device__ void column_dispatch(cg::cluster_group& cluster, int log2c, uint32_t* buf,
                                const uint32_t* xb, uint32_t* ob, int r, int log2l, int log2w,
                                const Mod& md) {
  switch (log2c) {
    case 1:
      column_stages<kRegime, kFwd, 1>(cluster, buf, xb, ob, r, log2l, log2w, md);
      break;
    case 2:
      column_stages<kRegime, kFwd, 2>(cluster, buf, xb, ob, r, log2l, log2w, md);
      break;
    default:
      column_stages<kRegime, kFwd, 3>(cluster, buf, xb, ob, r, log2l, log2w, md);
      break;
  }
}

// x [batch, n] -> out [batch, n]. log2c = 0: block b holds polynomials
// b * ppb .. + ppb - 1 whole (zeros past the batch); log2c > 0: the grid is
// batch * c blocks in clusters of c, cluster b the polynomial b.
template <int kRegime, bool kFwd>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_k4(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, Mod md, int batch,
           int log2n, int log2c, int ppb, int rlog) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log2n;
  if (log2c == 0) {
    const int e = ppb * n;
    const long long base = (long long)blockIdx.x * e;
    const long long total = (long long)batch * n;
    for (int i = threadIdx.x; i < e; i += blockDim.x)
      buf[swz(i)] = base + i < total ? x[base + i] : 0u;
    __syncthreads();
    segment_stages<kRegime, kFwd>(buf, e, log2n, 1, md, kFwd ? log2n - 1 : 0, rlog);
    for (int i = threadIdx.x; i < e; i += blockDim.x)
      if (base + i < total) out[base + i] = buf[swz(i)];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int log2l = log2n - log2c;  // values of a block's slice
  const int l = 1 << log2l;
  const int log2w = log2l - log2c;  // columns of a block
  const long long poly = (long long)(blockIdx.x >> log2c) * n;
  const uint32_t* xb = x + poly;
  uint32_t* ob = out + poly;
  const int mult = (1 << log2c) + r;
  if constexpr (kFwd) {
    cluster.sync();  // every block of the cluster runs: its shared memory can be written
    column_dispatch<kRegime, true>(cluster, log2c, buf, xb, ob, r, log2l, log2w, md);
    cluster.sync();  // every column's values are in their slices
    segment_stages<kRegime, true>(buf, l, log2l, mult, md, log2l - 1, rlog);
    for (int i = threadIdx.x; i < l; i += blockDim.x) ob[(long long)r * l + i] = buf[swz(i)];
  } else {
    for (int i = threadIdx.x; i < l; i += blockDim.x) buf[swz(i)] = xb[(long long)r * l + i];
    __syncthreads();
    segment_stages<kRegime, false>(buf, l, log2l, mult, md, -1, rlog);
    cluster.sync();  // every slice is done
    column_dispatch<kRegime, false>(cluster, log2c, buf, xb, ob, r, log2l, log2w, md);
    cluster.sync();  // no block leaves while its peers read its slice
  }
}

// The launch of a batch: ppb polynomials a block (log2c = 0) or 2^log2c
// blocks in a cluster a polynomial; e >> rlog threads (one group of a full
// round each), at least 32 and at most 512; e values of shared memory.
cudaLaunchConfig_t config(int batch, int log2n, int log2c, int rlog, int* ppb,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int n = 1 << log2n;
  *ppb = log2c == 0 && n < kMinElems ? kMinElems / n : 1;
  const int e = log2c == 0 ? *ppb * n : n >> log2c;
  const int threads = e >> rlog;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(log2c == 0 ? (batch + *ppb - 1) / *ppb : batch << log2c);
  cfg.blockDim = dim3(threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads);
  cfg.dynamicSmemBytes = (size_t)e * sizeof(uint32_t);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << log2c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = log2c > 0 ? 1 : 0;
  return cfg;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per instance and device
template <class K>
cudaError_t opt_in_once(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int kRegime, bool kFwd>
cudaError_t launch(const uint32_t* x, uint32_t* out, const Mod& md, int batch, int log2n,
                   int log2c, int rlog, cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  auto kernel = ntt_k4<kRegime, kFwd>;
  cudaError_t e = opt_in_once(kernel, smem_set);
  if (e != cudaSuccess) return e;
  int ppb;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(batch, log2n, log2c, rlog, &ppb, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, x, out, md, batch, log2n, log2c, ppb, rlog);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kFwd>
cudaError_t launch_regime(int regime, const uint32_t* x, uint32_t* out, const Mod& md, int batch,
                          int log2n, int log2c, int rlog, cudaStream_t s) {
  switch (regime) {
    case kLt30:
      return launch<kLt30, kFwd>(x, out, md, batch, log2n, log2c, rlog, s);
    case kLt31:
      return launch<kLt31, kFwd>(x, out, md, batch, log2n, log2c, rlog, s);
    case kGeneric:
      return launch<kGeneric, kFwd>(x, out, md, batch, log2n, log2c, rlog, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the shape rules of k4_ntt: a block of a cluster holds 2^8 .. 2^15 values,
// a block of whole polynomials at most 2^15, a cluster at most 8 blocks;
// rounds of 1 to 3 stages
bool shape_ok(int log2n, int log2c, int rlog) {
  if (log2n < 1 || log2n > 17 || log2c < 0 || log2c > kMaxLog2Cluster) return false;
  if (rlog < 1 || rlog > kMaxRadixLog) return false;
  if (log2c == 0) return log2n <= kMaxLog2Block;
  const int log2l = log2n - log2c;
  return log2l >= kMinLog2Slice && log2l <= kMaxLog2Block;
}

}  // namespace

// K4: x [B, n] u32 -> out [B, n]; fwd != 0: standard order -> bit-reversed,
// else bit-reversed -> standard order. tw (and tws, unused for generic) are
// the compact bit-reversed tables of prime32._tables for the direction;
// 2^log2c blocks (a cluster) a polynomial, rounds of up to rlog stages.
extern "C" int k4_ntt(const void* x, void* out, const void* tw, const void* tws, int batch,
                      int log2n, int log2c, int rlog, int regime, int fwd, unsigned int p,
                      unsigned int p_neginv, void* stream) {
  if (!shape_ok(log2n, log2c, rlog) || batch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Mod md{(const uint32_t*)tw, (const uint32_t*)tws, p, p_neginv};
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  return (int)(fwd ? launch_regime<true>(regime, xi, o, md, batch, log2n, log2c, rlog, s)
                   : launch_regime<false>(regime, xi, o, md, batch, log2n, log2c, rlog, s));
}

// How many clusters of the lt30 forward instance at (n, c) the card can hold
// at once (cudaOccupancyMaxActiveClusters), for the build report: 0 or an
// error code < 0 means the cluster launch would be refused.
extern "C" int k4_max_active_clusters(int log2n, int log2c, int rlog) {
  if (!shape_ok(log2n, log2c, rlog)) return -(int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  auto kernel = ntt_k4<kLt30, true>;
  cudaError_t e = opt_in_once(kernel, smem_set);
  if (e != cudaSuccess) return -(int)e;
  int ppb, count = 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(1, log2n, log2c, rlog, &ppb, 0, &attr);
  e = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}
