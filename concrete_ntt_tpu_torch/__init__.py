"""concrete_ntt_tpu_torch — the PyTorch + CUDA port of `concrete_ntt_tpu`.

The port runs on one NVIDIA H100 (Hopper, sm_90a) and is held bit-for-bit
against the JAX package, which stays in the repository as the reference.
It imports torch and numpy, never jax or `concrete_ntt_tpu`.

Ported so far:

  * the native64 Plan32 main path, `native64.Plan32.negacyclic_polymul`
    (fwd, inv and the polymul) on planar `(lo, hi)` uint32 limbs, numpy
    uint64 or `[..., n, 2]` limb tensors, for 2^11 <= n <= 2^15, through
    the channel-grid four-step kernels K1a (`fwd_wide_multi`) and K1b
    (`inv_multi`) of `ops/mxu32_cuda.py` + `csrc/mxu32_multi.cu`;
  * the single-prime plan `prime32.Plan(n, p)` (fwd, inv, the elementwise
    ops and the polymul) in the lt30, lt31 and generic regimes: the
    four-step kernel K2 of `csrc/mxu32_pass.cu` for 2^11 <= n <= 2^15 where
    `mxu32.applicable` holds (odd p >= 2^26), the butterfly kernel K4
    (`ops/butterfly32_cuda.py` + `csrc/butterfly32.cu`) otherwise, 2 <= n
    <= 2^15 on the card; `ops/ntt_dispatch.py` picks the tier. K3 (one
    GEMM pass, same source) is only the sharded four-step's per-rank pass;
  * the product plan `product.Plan(n, modulus, factors)` for factors
    < 2^32 (the tfhe-rs integration layer: Generic and Bounded fwd,
    Replace and Accumulate inv, the mixed-radix lift, the elementwise ops
    and the fused polymul): on the channel grid K1a-K1d for 30-bit primes
    at 2^11 <= n <= 2^15 (K1c `fwd_multi_perchannel` for the Bounded fwd,
    K1d `pointwise_inv_multi` for the polymul), K2 once per channel for
    other primes >= 2^26, each channel's prime32 plan otherwise;
  * beside them `ops/mxu32.py` (table builders, plain four-step),
    `ops/butterflies32.py` and `ops/engine.py` (plain stage engine),
    `ops/u32.py`, `ops/crt.py` (`rec_u64_from5`), `tables.py`, `golden/`,
    `utils/`.

The CUDA sources are built with nvcc at first use. CUDA tensors go through
the kernels, CPU tensors through the plain versions. Everything else (the
other plans, prime64 and the product plan's u64 channels, `fwd_binary`,
u128 limbs, Plan52, the sharded paths and the other Pallas kernels) is
listed in ROADMAP.md, in the order it will be ported.
"""

from . import native64, prime32, product, tables

__all__ = ["native64", "prime32", "product", "tables"]
