"""concrete_ntt_tpu_torch — the PyTorch + CUDA port of `concrete_ntt_tpu`.

The port runs on one NVIDIA H100 (Hopper, sm_90a) and is held bit-for-bit
against the JAX package, which stays in the repository as the reference.
It imports torch and numpy, never jax or `concrete_ntt_tpu`.

Ported so far:

  * the six native CRT plan families, `native32`, `native64`, `native128`,
    `native_binary32`, `native_binary64`, `native_binary128`
    (`negacyclic_polymul`, `fwd`, `fwd_binary`, `inv`), in the Plan32 tier
    (2, 3, 5 or 10 30-bit channels) and, at widths 32 and 64, the Plan52
    tier (1, 2 or 3 50-bit channels). Values are uint32 tensors (width 32),
    planar `(lo, hi)` uint32 limbs, numpy uint64 or `[..., n, 2]` limb
    tensors (width 64), planar 4-limb tuples, `[..., n, 4]` limb tensors or
    lists of Python ints (width 128). Plan32 at 2^11 <= n <= 2^17 runs the
    channel-grid four-step kernels K1a (`fwd_wide_multi`, the value ->
    residue split folded in as 4, 8 or 16 operand digit planes: 1, 2 or 4
    operand limbs) and K1b (`inv_multi`) of `ops/mxu32_cuda.py` +
    `csrc/mxu32_multi.cu`; below 2^11 it splits explicitly and runs each
    channel's `prime32.Plan` (K4). Plan52 runs K7a (`fwd_multi`) and K7d
    (`pointwise_inv_multi`) of `csrc/mxu64_multi.cu` on `(x, 0)` or
    `(lo, hi)` limb pairs, K5 per channel for `inv` and where the channel
    grid does not apply, the stage engine below 2^11;
  * the single-prime plan `prime32.Plan(n, p)` (fwd, inv, the elementwise
    ops and the polymul) in the lt30, lt31 and generic regimes: the
    four-step kernel K2 of `csrc/mxu32_pass.cu` for 2^11 <= n <= 2^17 where
    `mxu32.applicable` holds (odd p >= 2^26), the butterfly kernel K4
    (`ops/butterfly32_cuda.py` + `csrc/butterfly32.cu`) otherwise, 2 <= n
    <= 2^15 on the card; `ops/ntt_dispatch.py` picks the tier. K3 (one
    GEMM pass, same source) is only the sharded four-step's per-rank pass;
  * the product plan `product.Plan(n, modulus, factors)` (the tfhe-rs
    integration layer: Generic and Bounded fwd,
    Replace and Accumulate inv, the mixed-radix lift, the elementwise ops
    and the fused polymul): on the channel grid K1a-K1d for 30-bit primes
    at 2^11 <= n <= 2^17 (K1c `fwd_multi_perchannel` for the Bounded fwd,
    K1d `pointwise_inv_multi` for the polymul), K2 once per channel for
    other primes >= 2^26, each channel's prime32 plan otherwise; factors
    >= 2^32 are prime64 channels through `prime64.Plan`;
  * the 64-bit single-prime plan `prime64.Plan(n, p)` in its four regimes
    (Goldilocks, p < 2^62, p < 2^63, generic): the four-step kernel K5 of
    `csrc/mxu64_pass.cu` for 2^11 <= n <= 2^15 and odd 2^33 < p < 2^64; at
    n = 2^16 and 2^17 the stage-split hybrid (`ops/stagesplit.py`:
    plain-torch butterfly stages around K5 with block tables); the plain
    stage engine (`ops/butterflies64.py`) otherwise; K6 (one pass, same
    source) is the sharded prime64 four-step's per-rank pass; K7b / K7c
    and block tables for K7 serve the channel-grid hybrid;
  * the 32-bit stage-split hybrid (`ops/stagesplit.py`: `engine32_fused`,
    the four `*_hybrid32` functions, around K2 / K1b / K1c / K1d with block
    tables), the presplit inverse K1e (`mxu32_cuda.inv_multi_presplit`) and
    K5's forward of a u128 operand: as in the JAX package's default routing
    no plan takes them (K1 / K2 serve 2^16 and 2^17 directly);
  * beside them `ops/mxu32.py` and `ops/mxu64.py` (the host tables, the
    64-bit ones through `csrc/hostmath64.cpp`; plain four-steps),
    `ops/butterflies32.py` and `ops/engine.py` (plain stage engine),
    `ops/u32.py` (u32 / u64 / N-limb arithmetic in int64 carriers),
    `ops/crt.py` (every residue split and signed lift), `tables.py`,
    `golden/`, `utils/`.

Every plan has a device, given at construction and by default the card
("cuda"): numpy and Python-int input is moved to it, a tensor computes on
the device it is on; the CPU is what a caller asks for (`device="cpu"`). The
CUDA sources are built with nvcc at first use. CUDA tensors go through the
kernels, CPU tensors through the plain versions. Everything else (the
sharded paths, tooling) is listed in ROADMAP.md, in the order it will be
ported.
"""

from . import (
    native32,
    native64,
    native128,
    native_binary32,
    native_binary64,
    native_binary128,
    prime32,
    prime64,
    product,
    tables,
)

__all__ = [
    "native32",
    "native64",
    "native128",
    "native_binary32",
    "native_binary64",
    "native_binary128",
    "prime32",
    "prime64",
    "product",
    "tables",
]
