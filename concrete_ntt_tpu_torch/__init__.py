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
  * the product plan `product.Plan(n, modulus, factors)` (the tfhe-rs
    integration layer: Generic and Bounded fwd,
    Replace and Accumulate inv, the mixed-radix lift, the elementwise ops
    and the fused polymul): on the channel grid K1a-K1d for 30-bit primes
    at 2^11 <= n <= 2^15 (K1c `fwd_multi_perchannel` for the Bounded fwd,
    K1d `pointwise_inv_multi` for the polymul), K2 once per channel for
    other primes >= 2^26, each channel's prime32 plan otherwise; factors
    >= 2^32 are prime64 channels through `prime64.Plan`;
  * the 64-bit single-prime plan `prime64.Plan(n, p)` in its four regimes
    (Goldilocks, p < 2^62, p < 2^63, generic): the four-step kernel K5 of
    `csrc/mxu64_pass.cu` for 2^11 <= n <= 2^15 and odd 2^33 < p < 2^64, the
    plain stage engine (`ops/butterflies64.py`) otherwise; K6 (one pass,
    same source) is the sharded prime64 four-step's per-rank pass;
  * `native64.Plan52` (three 50-bit channels): K7a (`fwd_multi`) and K7d
    (`pointwise_inv_multi`) of `csrc/mxu64_multi.cu`, K5 per channel for
    `inv`; `ops/mxu64.py` (tables through `csrc/hostmath64.cpp`, plain
    four-step) and `ops/mxu64_cuda.py` beside them;
  * beside them `ops/mxu32.py` (table builders, plain four-step),
    `ops/butterflies32.py` and `ops/engine.py` (plain stage engine),
    `ops/u32.py`, `ops/crt.py` (`rec_u64_from5`, `rec_from3_p50_u64`),
    `tables.py`, `golden/`, `utils/`.

Every plan has a device, given at construction and by default the card
("cuda"): numpy input is moved to it, a tensor computes on the device it is
on; the CPU is what a caller asks for (`device="cpu"`). The CUDA sources
are built with nvcc at first use. CUDA tensors go through the kernels, CPU
tensors through the plain versions. Everything else (the other plans,
`fwd_binary`, u128 limbs, n > 2^15, the stage-split hybrid, the sharded
paths and the remaining Pallas kernel entries) is listed in ROADMAP.md, in
the order it will be ported.
"""

from . import native64, prime32, prime64, product, tables

__all__ = ["native64", "prime32", "prime64", "product", "tables"]
