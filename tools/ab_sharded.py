#!/usr/bin/env python3
"""Time the sharded four-step's GEMM passes (K3 / K6 at one rank's shapes),
the sharded polymuls, and the GEMM rows that share their sources, of the
port checkout in the current directory on one GPU.

Sections, each printing one line a row:
  * rank: one rank of each sharded path held in this process, its
    collectives replaced by local copies of the same shapes (a stand-in mesh
    at coordinate 0 whose all-to-all concatenates the rank's own first
    chunk and whose gather repeats the rank's shard): native128.Plan32(2^16)
    through ChannelShardedNative at (dp, ch, sp) = (1, 2, 2),
    native64.Plan32(2^14) through one make_sharded_prime32_mxu a channel at
    (2, 1, 2) and native64.Plan52(2^14) through ChannelShardedNative52 at
    (2, 1, 2), B = 8 (a rank's share of it): the device ms a polymul of its
    GEMM-pass kernels (torch.profiler, 10 polymuls), their launches a
    polymul, device busy and aten ops a polymul, and the host-clock ms of
    this one-rank stand-in (not a sharded polymul's time: no exchange
    crosses a process);
  * worlds: the same three paths in a world of four gloo ranks on the card
    and in one of a single NCCL rank (`_dist.spawn` of the checkout under
    test): rank 0's launches and its polymul ms, host clock barrier to
    barrier (mean of 5); the NCCL rank's torch.profiler breakdown (host ms,
    device busy share, GEMM passes, device events, aten ops a polymul);
  * rows: wrapper ms (CUDA events) and device ms (torch.profiler, median of
    20, one session) of K1a fwd_wide_multi (2^14, 8, 5 channels, 2 limbs),
    K1b inv_multi (2^14, 8, 5 channels), K2 fwd / inv (2^14, 16, lt30) and
    the rows of `chip_smoke.gemm64_rows` (K5, K5h, K6, K7a-K7d, W4-64): the
    kernels whose sources this work shares, held within 3 %;
  * sweep, where the checkout has the channel grids: each pass of the rank
    section's shapes (and of the worlds of one: s = 1, every channel) on
    every tile code of its rule's range (`mxu32_cuda.k3_multi_tile`,
    `mxu64_cuda.k6_tile` replaced for its calls), device ms, beside the code
    the rule picks.

The helpers (`chip_smoke.py` of this script's own checkout: sharded_path,
sharded_inputs, profile_polymul, gemm64_rows, and its gate's
route_passes; `utils/profiling.device_times`, `launch_counts` and
`reset_launches`) drive the package, kernels and wrappers of the current
directory, so an A/B
of two checkouts on one card runs it from each in turns, in one call:

    for d in parent change change parent; do (cd $d && python3 /abs/tools/ab_sharded.py); done

Arguments, if any, name the sections to run (`python3 tools/ab_sharded.py
sweep` runs the sweep alone); none runs all four.

Then the card line and a last JSON line {"rank": ..., "worlds": ...,
"rows": ..., "sweep": ..., "port": <checkout>}. Exits non-zero without a
CUDA GPU. Imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the checkout under test: its package, kernels, wrappers
# chip_smoke.py of this script's checkout (the current directory may hold another one)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from concrete_ntt_tpu_torch.utils.profiling import device_times  # noqa: E402

PATHS = ("native128", "native64", "plan52")
POLYMULS = 10  # profiled polymuls of the rank section
WORLD_REPS = 5


class RankMesh:
    """A stand-in DeviceMesh of one rank at coordinate 0 of every dim: what
    `parallel._dist` reads of a mesh (dim names, sizes, local rank)."""

    mesh_dim_names = ("dp", "ch", "sp")

    def __init__(self, shape: tuple):
        self.shape = shape

    def get_local_rank(self, dim) -> int:
        return 0


def local_collectives(_dist):
    """(all_to_all_tiled, all_gather) of one rank alone: the same shapes, the
    rank's own data in place of the others'."""

    def all_to_all_tiled(mesh, x, dim, split_axis, concat_axis):
        s = _dist.size(mesh, dim)
        if s == 1:
            return x
        return torch.cat([x.narrow(split_axis, 0, x.shape[split_axis] // s)] * s, concat_axis)

    def all_gather(mesh, x, *along):
        for dim, axis in along:
            s = _dist.size(mesh, dim)
            if s > 1:
                x = torch.cat([x] * s, axis)
        return x

    return all_to_all_tiled, all_gather


def rank_section(smi: str) -> dict:
    """One rank of each path in this process (the module note's `rank`)."""
    from concrete_ntt_tpu_torch.parallel import _dist
    from concrete_ntt_tpu_torch.utils import profiling

    saved = (_dist.all_to_all_tiled, _dist.all_gather)
    _dist.all_to_all_tiled, _dist.all_gather = local_collectives(_dist)
    inputs = cs.sharded_inputs(2024)
    out = {}
    try:
        for name in PATHS:
            run = cs.sharded_path(name, RankMesh(cs.SHARDED_MESHES[name]), None)
            lhs, rhs = (torch.from_numpy(v).cuda() if v.dtype == np.uint32 else v
                        for v in inputs[name])
            run(lhs, rhs)
            torch.cuda.synchronize()
            profiling.reset_launches()
            run(lhs, rhs)
            torch.cuda.synchronize()
            launched = {k: v for k, v in profiling.launch_counts().items() if v}
            r = cs.profile_polymul(lambda: run(lhs, rhs), reps=POLYMULS)
            out[name] = {"launches": launched, **r}
            print(f"ab_sharded: rank {name} at (dp, ch, sp) = {cs.SHARDED_MESHES[name]}: GEMM "
                  f"passes {r['kernel_ms']:.4f} ms of device time a polymul, launches "
                  f"{launched}, device busy {r['busy_ms']:.4f} ms, {r['aten_ops']:.0f} aten ops, "
                  f"host {r['host_ms']:.4f} ms (one rank alone, collectives as local copies; "
                  f"{POLYMULS} polymuls) | {smi}", flush=True)
    finally:
        _dist.all_to_all_tiled, _dist.all_gather = saved
    return out


def world_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of a world: each path once (its launches), then WORLD_REPS
    polymuls barrier to barrier; alone on the card (a world of one), its
    torch.profiler breakdown too."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from concrete_ntt_tpu_torch.utils import profiling

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    inputs = cs.sharded_inputs(seed)
    out = {}
    for name in PATHS:
        shape = cs.SHARDED_MESHES[name] if world > 1 else (1, 1, 1)
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("dp", "ch", "sp"))
        run = cs.sharded_path(name, mesh, None)
        lhs, rhs = (torch.from_numpy(v).cuda() if v.dtype == np.uint32 else v
                    for v in inputs[name])
        torch.cuda.synchronize()
        profiling.reset_launches()
        run(lhs, rhs)
        torch.cuda.synchronize()
        launched = {k: v for k, v in profiling.launch_counts().items() if v}
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(WORLD_REPS):
            run(lhs, rhs)
        torch.cuda.synchronize()
        dist.barrier()
        out[name] = {"launches": launched,
                     "ms": (time.perf_counter() - t0) * 1e3 / WORLD_REPS}
        if world == 1:
            out[name]["profile"] = cs.profile_polymul(lambda: run(lhs, rhs), reps=WORLD_REPS)
    return out


def worlds_section(smi: str) -> dict:
    """The sharded paths in worlds of rank processes (the module note's
    `worlds`); the kernels are built by then."""
    from concrete_ntt_tpu_torch.parallel import _dist

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in (("gloo", cs.RANKS), ("nccl", 1)):
            ranks = _dist.spawn(world_rank, world, os.path.join(tmp, backend), (2024,),
                                backend=backend, timeout=cs.SHARDED_TIMEOUT)
            out[backend] = ranks[0]
            for name in PATHS:
                r = ranks[0][name]
                line = (f"ab_sharded: {backend} world of {world}, {name}: rank 0 launches "
                        f"{r['launches']}, polymul {r['ms']:.4f} ms (host clock barrier to "
                        f"barrier, mean of {WORLD_REPS})")
                if "profile" in r:
                    p = r["profile"]
                    line += (f"; torch.profiler: host {p['host_ms']:.4f} ms, device busy "
                             f"{p['busy_ms']:.4f} ms ({100 * p['busy_share']:.1f} %), GEMM "
                             f"passes {p['kernel_ms']:.4f} ms, {p['device_events']:.0f} device "
                             f"events, {p['aten_ops']:.0f} aten ops a polymul")
                print(line + f" | {smi}", flush=True)
    return out


def rows_section(dev, u32, smi: str) -> dict:
    """The GEMM rows that share the passes' sources (module note's `rows`)."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu32_cuda as m
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES

    lt30 = 1073479681
    n, b = 1 << 14, 8
    n1, n2 = mxu32.four_step_factors(n)
    limbs = (u32((b, n)), u32((b, n)))
    xm = u32((len(PRIMES), b, n))
    scaled = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
    x16 = u32((16, n))
    calls = [("K1a", "fwd_wide_multi n=16384 B=8 C=5 2 limbs",
              lambda: m.fwd_wide_multi(limbs, PRIMES), 2),
             ("K1b", "inv_multi n=16384 B=8 C=5 scaled", lambda: m.inv_multi(xm, PRIMES, scaled),
              2),
             ("K2-fwd", "fwd n=16384 B=16 lt30", lambda: m.fwd(x16, n=n, p=lt30), 2),
             ("K2-inv", "inv n=16384 B=16 lt30", lambda: m.inv(x16, n=n, p=lt30), 2)]
    calls += [(key, f"{name} {label}", kernel, per_call)
              for key, name, label, kernel, _, per_call, _ in cs.gemm64_rows(dev, u32)]
    ms = {key: cs.median_ms(kernel) for key, _, kernel, _ in calls}
    prof = device_times([(key, (lambda k=kernel: (k, cs.is_pass)), per_call)
                            for key, _, kernel, per_call in calls])
    rows = {}
    for key, label, _, _ in calls:
        rows[key] = {"label": label, "ms": ms[key], "device_ms": prof[key]}
        dv = "not measured" if prof[key] is None else f"{prof[key]:.4f} ms"
        print(f"ab_sharded: row {key} ({label}): wrapper {ms[key]:.4f} ms, device {dv} "
              f"(median of {cs.REPS}) | {smi}", flush=True)
    return rows


def sweep_section(dev, u32, smi: str) -> dict:
    """Each channel-grid pass of the rank section's shapes and of the worlds
    of one on every tile code of its rule's range, device ms."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m, mxu64, mxu64_cuda as m64
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.tables import PRIMES52, primes32_ext

    ext, p52 = primes32_ext(), tuple(PRIMES52[:3])
    shapes = (("native128", 1 << 16, tuple(ext[:5]), 8, 2, 4),
              ("native128 world of 1", 1 << 16, tuple(ext[:10]), 8, 1, 4),
              ("native64", 1 << 14, tuple(PRIMES[:1]), 4, 2, 1),
              ("native64 world of 1", 1 << 14, tuple(PRIMES[:1]), 8, 1, 1),
              ("plan52", 1 << 14, p52, 4, 2, 1), ("plan52 world of 1", 1 << 14, p52, 8, 1, 1),
              # larger 64-bit grids, where 128-row blocks fill the card twice over and more
              ("plan52 B=16 world of 1", 1 << 14, p52, 16, 1, 1),
              ("prime64 2^15 B=16 world of 1", 1 << 15, p52[:1], 16, 1, 1),
              ("plan52 2^15 B=16 world of 1", 1 << 15, p52, 16, 1, 1))
    rules = (m.k3_multi_tile, m64.k6_tile)
    tasks, picked = [], {}

    def forced(code, wide, xx, kw):
        """The pass with its tile rule replaced by `code` (its launch record
        rebuilt), for device_times."""
        if wide:
            m64.k6_tile = lambda *a: code
            m64._k6m_launch.cache_clear()
            return (lambda: m64.pass_matmod64_multi(xx, **kw)), cs.is_pass
        m.k3_multi_tile = lambda *a: code
        m._k3m_launch.cache_clear()
        return (lambda: m.pass_matmod_multi(xx, **kw)), cs.is_pass

    try:
        for path, n, primes, b, s, limbs in shapes:
            wide = path.startswith(("plan52", "prime64"))
            for which, x, rows in cs.gate().route_passes(u32, n, b, s, len(primes), limbs, pair=wide):
                mod = m64 if wide else m
                kw = dict(n=n, primes=primes, which=which, transposed_out=which == "Ainv",
                          diag=mod.multi_diag(n, primes, which, *rows, str(dev)) if rows
                          else None)
                xx = x if wide or len(x) > 1 else x[0]
                if wide:
                    o = mxu64.pass_mat(n, primes[0], which)[1].shape[1]
                    codes, rule = (0, 1), m64.k6_tile(b * x[0].shape[-2], o, len(primes))
                else:
                    o = m._pass_mat(n, primes[0], which, len(x), 1)[1].shape[1]
                    codes = tuple(c for c in ((0, 1, 2) if rows else (0, 1, 2, 3))
                                  if o % m.TILES[c][1] == 0)
                    rule = m.k3_multi_tile(b, x[0].shape[-2], o, len(primes),
                                           len(x) * x[0].shape[-1] // 32, bool(rows), 4)
                picked[f"{path} {which}"] = rule
                for code in codes:
                    tasks.append(((path, which, code),
                                  lambda code=code, wide=wide, xx=xx, kw=kw: forced(
                                      code, wide, xx, kw), 1))
        prof = device_times(tasks)
    finally:
        m.k3_multi_tile, m64.k6_tile = rules
        m._k3m_launch.cache_clear()
        m64._k6m_launch.cache_clear()
    out = {}
    for (path, which, code), v in prof.items():
        out.setdefault(f"{path} {which}", {"rule": picked[f"{path} {which}"]})[code] = v
    for key, r in out.items():
        times = ", ".join(f"code {c}: " + ("not measured" if t is None else f"{t:.4f} ms")
                          for c, t in r.items() if c != "rule")
        print(f"ab_sharded: sweep {key}: {times}; the rule picks {r['rule']} | {smi}",
              flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_sharded: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32_cuda

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        list(pool.map(cuda_build.build, cuda_build.SOURCES))  # one nvcc a source, together
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(2024)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    print(f"ab_sharded: {os.getcwd()}: build {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    run = sys.argv[1:] or ["rows", "rank", "sweep", "worlds"]
    out = {"rows": rows_section(dev, u32, smi) if "rows" in run else None,
           "rank": rank_section(smi) if "rank" in run else None}
    out["sweep"] = (sweep_section(dev, u32, smi)
                    if "sweep" in run and hasattr(mxu32_cuda, "pass_matmod_multi") else None)
    out["worlds"] = worlds_section(smi) if "worlds" in run else None
    print(f"ab_sharded: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(smi)
    print(json.dumps({**out, "port": os.getcwd()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
