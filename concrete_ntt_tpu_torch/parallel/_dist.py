"""The collective layer of the sharded paths, on `torch.distributed`.

The port's counterpart of what the JAX package takes from its mesh: named
mesh axes, `jax.lax.all_to_all(..., tiled=True)`, `jax.lax.axis_index` and
the `device_put` that gathers a sharded array whole.

  * A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims:
    "dp" (batch), "ch" (CRT channels), "sp" (the four-step factor), or "x"
    for the stage four-step. A dim the caller leaves out (None, or a name
    the mesh does not have) is size 1, as an axis missing from a JAX mesh
    is: its collectives are the identity and its index is 0.
  * One process a rank. Each rank computes on one device (`rank_device`):
    by default the card `cuda:{LOCAL_RANK % device_count}`, the CPU only
    when the caller passes `device="cpu"`; without a card and without
    `device="cpu"` it raises.
  * gloo refuses uint32 tensors ("Invalid scalar type"), so a uint32 tensor
    crosses as its int32 view and is viewed back: the move is bitwise, and
    lazy representatives anywhere in [0, 2^32) arrive intact.
  * The collectives take tensors on the rank's device as they are: NCCL
    moves CUDA tensors between cards; gloo (the backend of a CPU world, and
    of several ranks held on one card, where NCCL refuses) copies CUDA
    tensors through the host itself.

`CALLS` counts the collectives issued (one a mesh dim of size > 1), so that
a test can hold a path to its collective count. `spawn` starts a world of
ranks on one host (the tests' CPU worlds, several ranks on one card).
"""

from __future__ import annotations

import io
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.u32 import check_device

CALLS = {"all_to_all": 0, "all_gather": 0}


def reset_call_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: `device` if given (the CPU only so),
    else the card `cuda:{LOCAL_RANK % torch.cuda.device_count()}` (the global
    rank where LOCAL_RANK is unset). Raises where that is the card and there
    is none."""
    if device is not None:
        return check_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the sharded paths compute on the card by default but "
            'torch.cuda.is_available() is False; pass device="cpu" to compute on the CPU'
        )
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else (dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def size(mesh, dim: str | None) -> int:
    """Size of the mesh dim `dim`; 1 where it is None or not in the mesh."""
    names = mesh.mesh_dim_names or ()
    if dim is None or dim not in names:
        return 1
    return mesh.shape[names.index(dim)]


def axis_index(mesh, dim: str | None) -> int:
    """This rank's position along `dim` (`jax.lax.axis_index`); 0 where the
    dim has size 1."""
    return mesh.get_local_rank(dim) if size(mesh, dim) > 1 else 0


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def all_to_all_tiled(mesh, x: torch.Tensor, dim: str | None, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """`jax.lax.all_to_all(x, dim, split_axis, concat_axis, tiled=True)`:
    split x into s equal chunks along `split_axis`, send chunk j to the rank
    at position j of `dim`, and concatenate what arrives along `concat_axis`
    in rank order (s = the dim's size)."""
    s = size(mesh, dim)
    if s == 1:
        return x
    if x.shape[split_axis] % s:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split into {s} chunks")
    # chunk j of the split axis leading: `all_to_all_single` sends row block j to rank j
    front = x.movedim(split_axis, 0)
    send = front.reshape(s, front.shape[0] // s, *front.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_wire(recv), _wire(send), group=mesh.get_group(dim))
    CALLS["all_to_all"] += 1
    # recv[i] is rank i's chunk with the split axis leading: put it back, then
    # lay the s chunks side by side along the concat axis
    chunks = recv.movedim(1, split_axis + 1)  # [s, *chunk shape]
    merged = chunks.movedim(0, concat_axis)  # s just before the concat axis
    shape = list(chunks.shape[1:])
    shape[concat_axis] *= s
    return merged.reshape(shape)


def all_gather(mesh, x: torch.Tensor, *along: tuple) -> torch.Tensor:
    """Gather x whole along each (mesh dim, tensor axis) pair of `along`, in
    rank order: the shards of every rank of the dim concatenated on that
    axis. One collective a dim of size > 1."""
    for dim, axis in along:
        s = size(mesh, dim)
        if s == 1:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(s)]
        dist.all_gather([_wire(t) for t in parts], _wire(x), group=mesh.get_group(dim))
        CALLS["all_gather"] += 1
        x = torch.cat(parts, dim=axis)
    return x


def to_dist(mesh, x: torch.Tensor, n1: int, n2: int, batch_dim: str | None, dim: str | None,
            device, ntt: bool = False) -> torch.Tensor:
    """This rank's shard of a whole [B, n(, L)] array (every rank passes the
    same): its batch rows over `batch_dim`, viewed as [b, n1, n2], and its
    columns over `dim` -> a value shard [B / dp, n1, n2 / s(, L)]; with
    `ntt`, its rows -> an NTT-domain shard [B / dp, n1 / s, n2(, L)].
    Contiguous, on `device`."""
    x = torch.as_tensor(x).to(device)
    dp, s = size(mesh, batch_dim), size(mesh, dim)
    b_all = x.shape[0]
    if b_all % dp:
        raise ValueError(f"batch {b_all} must divide over {batch_dim}={dp}")
    b = b_all // dp
    q, r = axis_index(mesh, batch_dim), axis_index(mesh, dim)
    grid = x[q * b:(q + 1) * b].reshape(b, n1, n2, *x.shape[2:])
    if ntt:
        return grid[:, r * (n1 // s):(r + 1) * (n1 // s)].contiguous()
    return grid[:, :, r * (n2 // s):(r + 1) * (n2 // s)].contiguous()


def from_dist(mesh, x: torch.Tensor, n1: int, n2: int, batch_dim: str | None,
              dim: str | None) -> torch.Tensor:
    """The whole [B, n(, L)] array from every rank's shard: a value shard
    [b, n1, n2 / s(, L)] (columns over `dim`) or an NTT-domain shard
    [b, n1 / s, n2(, L)] (rows over `dim`), told apart by their shape (the
    two agree only where s = 1), gathered over `batch_dim` and `dim`."""
    s = size(mesh, dim)
    if tuple(x.shape[1:3]) == (n1, n2 // s):
        axis = 2
    elif tuple(x.shape[1:3]) == (n1 // s, n2):
        axis = 1
    else:
        raise ValueError(f"{tuple(x.shape)} is neither a value shard [b, {n1}, {n2 // s}] nor "
                         f"an NTT-domain shard [b, {n1 // s}, {n2}]")
    whole = all_gather(mesh, x, (batch_dim, 0), (dim, axis))
    return whole.reshape(whole.shape[0], n1 * n2, *x.shape[3:])


def layout(mesh, n1: int, n2: int, batch_dim: str | None, dim: str | None, device) -> tuple:
    """(to_dist, from_dist) of one [B, n1, n2] grid layout: to_dist(x) the
    value shard, to_dist(x, ntt=True) the NTT-domain shard."""
    return (lambda x, ntt=False: to_dist(mesh, x, n1, n2, batch_dim, dim, device, ntt),
            lambda x: from_dist(mesh, x, n1, n2, batch_dim, dim))


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str, args: tuple, out) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                                rank=rank)
        try:
            # serialized here by value: a tensor put on the queue as it is
            # would be shared through a descriptor that dies with this
            # process, and plain pickle cannot load a uint32 tensor back
            buf = io.BytesIO()
            torch.save(fn(rank, world, *args), buf)
            out.put((rank, True, buf.getvalue()))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, init_file: str, args: tuple = (), *, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """Run fn(rank, world_size, *args) in `world_size` new processes
    (multiprocessing's spawn), each a rank of one `torch.distributed` world
    (`backend`, rendezvous through the FileStore at `init_file`, a path no
    other world uses; with NCCL the current card is rank % device_count),
    and return their results in rank order. fn must pickle, its results
    go through `torch.save`.
    LOCAL_RANK stays unset: ranks may share a card (a DeviceMesh of type
    "cuda" would take LOCAL_RANK for a card's ordinal), and `rank_device`
    then takes the global rank modulo the cards. Raises RuntimeError, after
    ending every rank process, where a rank raises or dies or the world
    outlasts `timeout` seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, init_file, args, out),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results: dict = {}
    try:
        while len(results) < world_size:
            try:
                rank, ok, val = out.get(timeout=min(1.0, max(0.0, deadline - time.monotonic())))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"world of {world_size} ranks: {len(results)} reported within "
                        f"{timeout} s; exit codes {[p.exitcode for p in procs]}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{val}")
            # written by our own rank process
            results[rank] = torch.load(io.BytesIO(val), weights_only=False)
    finally:
        for p in procs:  # a failed world's ranks may wait in a collective: end them
            p.join(timeout=10.0 if len(results) == world_size else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
