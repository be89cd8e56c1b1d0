"""concrete_ntt_tpu_torch — the PyTorch + CUDA port of `concrete_ntt_tpu`.

The port runs on one NVIDIA H100 (Hopper, sm_90a) and is held bit-for-bit
against the JAX package, which stays in the repository as the reference.
It imports torch and numpy, never jax or `concrete_ntt_tpu`.

Ported so far: the native64 Plan32 main path,
`native64.Plan32.negacyclic_polymul` (fwd, inv and the polymul) on planar
`(lo, hi)` uint32 limbs, numpy uint64 or `[..., n, 2]` limb tensors, for
2^11 <= n <= 2^15:

  * `ops/mxu32_cuda.py` + `csrc/mxu32_multi.cu` — the channel-grid
    four-step kernels K1a (`fwd_wide_multi`) and K1b (`inv_multi`), CUDA
    C++ built with nvcc at first use, each beside its plain torch twin;
  * `ops/mxu32.py` (table builders, plain four-step), `ops/u32.py`,
    `ops/crt.py` (`rec_u64_from5`), `ops/ntt_dispatch.py`, `prime32.py`
    (construction only), `tables.py`, `golden/`, `utils/`.

CUDA tensors go through the kernels, CPU tensors through the plain
versions. Everything else (the other plans, the prime32 stage engine,
`fwd_binary`, u128 limbs, Plan52, the sharded paths and the other Pallas
kernels) is listed in ROADMAP.md, in the order it will be ported.
"""

from . import native64, prime32, tables

__all__ = ["native64", "prime32", "tables"]
