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
    ops and the polymul) in the lt30, lt31 and generic regimes, through
    the four-step kernels K2 (n >= 2^14) and K3 (one GEMM pass, 2048 <= n
    < 2^14) of `csrc/mxu32_pass.cu` for odd p >= 2^26, and the butterfly
    kernel K4 (`ops/butterfly32_cuda.py` + `csrc/butterfly32.cu`)
    otherwise, 2 <= n <= 2^15 on the card; `ops/ntt_dispatch.py` picks the
    tier;
  * beside them `ops/mxu32.py` (table builders, plain four-step),
    `ops/butterflies32.py` and `ops/engine.py` (plain stage engine),
    `ops/u32.py`, `ops/crt.py` (`rec_u64_from5`), `tables.py`, `golden/`,
    `utils/`.

The CUDA sources are built with nvcc at first use. CUDA tensors go through
the kernels, CPU tensors through the plain versions. Everything else (the
other plans, `fwd_binary`, u128 limbs, Plan52, the sharded paths and the
other Pallas kernels) is listed in ROADMAP.md, in the order it will be
ported.
"""

from . import native64, prime32, tables

__all__ = ["native64", "prime32", "tables"]
