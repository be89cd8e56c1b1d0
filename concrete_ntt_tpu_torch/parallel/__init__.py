"""The sharded paths, on `torch.distributed` (one process a rank).

Counterpart of `concrete_ntt_tpu/parallel/`:

  * `fourstep_mxu` — the four-step on GEMM passes split across ranks: the
    column pass on a rank's columns, one tiled all-to-all a transform, the
    row pass on its rows; each pass one kernel (K3 `pass_matmod` for 32-bit
    primes, K6 `pass_matmod64` for 64-bit ones, their plain versions on CPU
    tensors). `fourstep` — the stage four-step of a prime32 plan, plain
    torch butterfly stages around the same all-to-all.
  * `channels` — the CRT residue channels of a native plan sharded over a
    `ch` mesh dim (`ChannelShardedNative`, `ChannelShardedNative52`):
    split -> fwd -> pointwise -> inv on each rank's channels, the only
    cross-channel collective the all-gather before the CRT lift. Composes
    with dp (batch) and sp (four-step) dims.
  * `dryrun` (imported on its own) — all four sharded paths at a small
    size, called by every rank.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims; a
dim left out is size 1. Each rank computes on the card by default
(`cuda:{LOCAL_RANK % device_count}`), on the CPU only with `device="cpu"`.
The collective layer is `_dist`.
"""

from . import channels, fourstep, fourstep_mxu

__all__ = ["channels", "fourstep", "fourstep_mxu"]
