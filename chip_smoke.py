#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`concrete_ntt_tpu_torch`) on one GPU.

Whether every kernel and plan gives the right bits on the card is the parity
gate's question (`tools/gpu_parity.py`: each kernel against its plain torch
twin, each public plan against an independent oracle and with its route's
launches); this script runs the gate's --quick rows and checks only what
the gate cannot express: the build's instances, registers, SASS and cluster
occupancy, the device rule and the host formats, the sharded paths across
rank processes, CUDA-graph capture; then it times the kernels and plans.

Phases, one line each (or a few), stopping with a non-zero exit at the first
failure:
  1. device  — needs torch.cuda.is_available(); prints nvidia-smi's name and
               power limit.
  2. build   — compiles every kernel source from the checkout with nvcc, one
               process per source, all started together; prints ptxas's
               lines and each GEMM pass instance's (digit planes, regime,
               epilogue, tile) registers and spills, both GEMM passes'
               dynamic shared memory and, from `cuobjdump -sass`, each
               library's GMMA, IMMA and IDP.4A instructions: the four GEMM
               libraries (mxu32_*, mxu64_*) must hold GMMA and no IDP.4A, no
               instance of the 64-bit pass nor of K2's small-grid tiles may
               spill, K1c / K1d's eight tile instances, K3's channel-grid
               instances of every tile `k3_multi_tile` picks and the 16
               64-row instances of the 64-bit pass must be built, the lift
               kernels' and the pointwise product's vector and scalar
               instances must be built and must not spill, and a
               missing cuobjdump fails; K4's registers and how many of its
               clusters the card holds at once
               (cudaOccupancyMaxActiveClusters: accepted at 2^14 and 2^17).
  3. parity  — tools/gpu_parity.py's --quick rows in this process: every
               value of `ntt_dispatch.route32` / `tier32` / `tier64` /
               `route64` at n in its QUICK_N, each kernel row against its
               plain twin (the forced tile codes, every tile instance, the
               eight instances of the 64-bit pass and K1a / K1b / the lifts
               / the pointwise product at the native64 and native128 cells'
               n and B = 8 among them),
               each plan row (the ten public plans' polymul and round trip,
               the PBS loop of 16 terms) against the golden oracle, against
               the same plan on the CPU (every row) and with its route's
               launches, the dense fixture against its digests; each plan,
               route and fixture row also holds the dispatcher to the
               gate's literal ROUTES; prints the FAIL and fixture lines, and
               fails on any FAIL.
  4. formats — what no gate row holds: the device rule (a default
               native64.Plan32(2^14) takes numpy input to the card, the same
               bits as planar limbs there, K1a +2, the pointwise product +1,
               K1b +1, the lift +1 each);
               the README vector (prime32 N = 32, p = 1062862849, round trip
               == N·x on a default plan, K4 +1 fwd +1 inv); `"py128"` lists
               on a default native128 plan == the planar result (K1a-u128 +2,
               the pointwise product +1, K1b +1, the two lift kernels +1
               each). Each call's launch
               counters (`utils/profiling.launch_counts`) are zeroed just
               before it and read just after.
  4b. sharded — `parallel._dist.spawn` starts the worlds (the kernels are
               built by then; FileStores in a temporary directory; 600 s a
               world): R = 4 gloo ranks on the one card (NCCL refuses two
               ranks on one card) and a world of one on NCCL. Each rank runs
               native128.Plan32(2^16) through ChannelShardedNative at (dp, ch,
               sp) = (1, 2, 2), native64.Plan32(2^14) through one
               make_sharded_prime32_mxu a channel at (2, 1, 2) and
               native64.Plan52(2^14) through ChannelShardedNative52 at (2, 1,
               2), B = 8, with its launch counts zeroed just before each and
               read just after: it raises unless they are the route's (K3's
               grid 2 with four limbs and 4 with one for native128; 30 for
               native64; K6's grid 6 for Plan52) and nothing else, and, in the
               gloo world, unless the same path on CPU tensors gives the same
               bits; then 5 polymuls timed barrier to barrier; the NCCL rank
               also under torch.profiler. Rank 0's products == the
               single-card plans' on the same inputs, for both worlds; a
               failed, hung or silent rank fails the phase.
  5. times   — CUDA events, warm-up then the median of reps, each kernel
               beside its plain version (K1d also beside plain mont_mul +
               K1b), the polymuls in products/s (product in its three
               modes) and the PBS loop's ms per term; K5 fwd / inv per
               regime, one K6 pass, K7a, K7d (also beside plain mont_mul64 +
               three K5 inverses), the prime64 polymul per regime and the
               Plan52 polymul beside Plan32's; K5h fwd / inv at 2^16 and
               2^17, K7c / K7b direct, K7 with block tables; K5 direct
               beside the hybrid at (2^15, 16) and the Plan52 polymul direct
               beside the channel-grid hybrid at (2^15, 8), in turns; the
               prime64 transforms and polymul at 2^16 and 2^17; K1a with four
               limbs over 10 and 5 channels, K1b over 10, K2 fwd_wide and K3
               A with four limbs; the polymul of every native family at
               (2^14, 8) and the per-channel route's at 1024; the direct
               32-bit kernels at 2^16 (and K2 at 2^17), K2h and K1 with block
               tables at 2^16, K1e beside K1b, K2h at (2^16 | 2^17, 16 | 1),
               K5 with four limbs; K4 at (1024, 16), (2^14, 16) and (2^16, 16)
               (device time too); K2 and K1a / K1d direct beside the 32-bit
               hybrid at 2^15, 2^16 and 2^17, in turns, with the hybrid's
               split; the polymuls above 2^15. Each GEMM pass row
               (csrc/matmod_pass.cuh, csrc/matmod64_pass.cuh) also gets its
               device time (the pass launches of a call by torch.profiler,
               median of 20) beside torch._int_mm on int8 matrices of the
               same passes' shapes; K3's and K6's channel grids at the gloo
               world's rank-local shapes likewise.
  6. stages  — `stages_phase`: the native64 Plan32 polymul at (2^14, 8) and
               its stages, native128 Plan32 at (2^16, 8) and its lift
               kernels, and the lift A/B of `ops/crt.py` against `crt_mxu`,
               each by `profiling.chain_time` on CUDA graphs (a graph of two
               steps held bit for bit against eager; a capture that fails
               fails the run) and by the eager CUDA-event median; then the
               three `examples/*_torch.py` on the card, all started together.
Then one JSON line of kernel summaries (each with its launches: its
kernel's in one call of the public plan whose route takes it at the row's
shape, else of the call its ms times, the channel grids' over the gloo
ranks of phase 4b, each call with the counters zeroed just before; its
max_abs_err: the largest over the gate's --quick kernel rows of phase 3 that
launched it, null where none did; ms, plain ms, and, for the direct 32-bit
kernels, the same numbers and launches at their shape above 2^15 under
`n17`; the rows of both GEMM passes and the `n17` entries also
`device_ms` and `gemm_ms`, the two profiler times; and the bound: the larger
of its bytes over 3.35 TB/s and its int8 operations over 1,979 TOP/s, the
H100 SXM data-sheet rates that `concrete_ntt_tpu_torch/utils/profiling.py`
holds; `library_ms` is null for all: no single PyTorch call computes an
exact modular transform), the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.

The card routine after a kernel change: `python3 chip_smoke.py`, then
`python3 tools/gpu_parity.py` in full, its log committed as
`GPU_PARITY_r{N}.txt`. Run from the repository root with no arguments.
`--profile` adds, before the JSON lines, a torch.profiler breakdown of the
prime32 polymul at B = 16 (n = 2^14 per regime, 4096, 1024), of the product
polymul at (2^14, 16) in Replace and Bounded, of the prime64 polymul per
regime, of the Plan52 polymul, of the prime64 polymul at 2^16 with its split
into prefix stages, block kernels and suffix stages, of the polymul of each
native family at (2^14, 8), and of the polymuls above 2^15: host-clock ms,
device busy ms and share, GEMM / butterfly device ms, and device kernels and
aten ops per polymul. Inputs come from numpy's default_rng(--seed); the
script imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

N_MAIN, B_MAIN = 1 << 14, 8
N32, B32 = 1 << 14, 16
REPS = 20
# K1c / K1d's pass instances beside K1's own (csrc/mxu32_multi.cu launch_k1):
# (epilogue of the pass, tile code)
K1_TILED = (("scaled", 1), ("scaled", 2), ("canonical", 1), ("canonical", 2), ("canonical", 3),
            ("scaled+pointwise", 1), ("scaled+pointwise", 2), ("scaled+pointwise", 3))
RANKS = 4  # ranks of the sharded phase's gloo world, on the one card
BENCH_PRIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
N_PROD, B_PROD = 1 << 14, 16
BOUND = 1 << 20  # Bounded fwd: |value| < 2^19, a PBS decomposition digit's size
PBS_TERMS = 16
SMALL_P = 67043329  # < 2^26: the butterfly kernel at every n
N64, B64, B52 = 1 << 14, 16, 8
N_H = 1 << 14  # the hybrid's block size
N_HYB15, HYB_SIZES, B_HYB = 1 << 15, (1 << 16, 1 << 17), 16
HYB_BIG = ("p50", "goldilocks")  # the regimes run at 2^17 (the reference grid's two)
MULTI_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_multi.cu"
PASS_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_pass.cu"
BFLY_SRC = "concrete_ntt_tpu_torch/csrc/butterfly32.cu"
PASS64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_pass.cu"
MULTI64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_multi.cu"
LIFT_SRC = "concrete_ntt_tpu_torch/csrc/crt_lift.cu"
LIFT128_SRC = "concrete_ntt_tpu_torch/csrc/crt_lift128.cu"
MONT_SRC = "concrete_ntt_tpu_torch/csrc/mont32_pointwise.cu"
# the launch counter (`utils/profiling.launch_counts`) of a JSON row whose
# name is not its counter's: native128's lift pair counts its digits launch
COUNTER = {"lift_u128_from10": "lift_u128_digits"}
KERNELS = {  # JSON name -> (source, TPU kernel replaced)
    "fwd_wide_multi": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:367"),
    "inv_multi": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:398"),
    "fwd_multi_perchannel": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:544"),
    "pointwise_inv_multi": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:637"),
    "fwd": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:35"),
    "inv": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:35"),
    "pass_matmod": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:687"),
    "butterfly32_fwd": (BFLY_SRC, "concrete_ntt_tpu/ops/pallas32.py:115"),
    "butterfly32_inv": (BFLY_SRC, "concrete_ntt_tpu/ops/pallas32.py:115"),
    "fwd64": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:32"),
    "inv64": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:32"),
    "pass_matmod64": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:197"),
    "fwd_multi64": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:522"),
    "pointwise_inv_multi64": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:728"),
    # the same TPU kernels with their `hyb` argument (block tables)
    "fwd64_hyb": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:32"),
    "inv64_hyb": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:32"),
    "fwd_multi_perchannel64": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:695"),
    "inv_multi64": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:712"),
    "fwd_multi_perchannel64_hyb": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:695"),
    "inv_multi64_hyb": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:712"),
    "pointwise_inv_multi64_hyb": (MULTI64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:728"),
    # the same TPU kernels with the four limbs of a u128 operand (16 operand planes)
    "fwd_wide_multi_u128": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:527"),
    "fwd_u128": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:163"),
    "pass_matmod_u128": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:687"),
    # the 32-bit kernels with their `hyb` argument (block tables)
    "fwd_hyb": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:35"),
    "inv_hyb": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:35"),
    "fwd_multi_perchannel_hyb": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:544"),
    "inv_multi_hyb": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:585"),
    "pointwise_inv_multi_hyb": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:637"),
    # K1b from pre-split digit planes; K5 fwd with the four limbs of a u128 operand
    "inv_multi_presplit": (MULTI_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:614"),
    "fwd64_u128": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:32"),
    # K3 / K6 on a rank's channel grid, strided: the sharded four-step's passes
    "pass_matmod_multi": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:687"),
    "pass_matmod_multi_u128": (PASS_SRC, "concrete_ntt_tpu/ops/mxu32_pallas.py:687"),
    "pass_matmod64_multi": (PASS64_SRC, "concrete_ntt_tpu/ops/mxu64_pallas.py:197"),
    # the native64 Plan32 Garner lift: no TPU kernel (XLA code there)
    "lift_u64_from5": (LIFT_SRC, "none: concrete_ntt_tpu/ops/crt.py rec_u64_from5 is XLA code"),
    # the native128 Plan32 Garner lift, digits then limbs: one launch pair a lift
    "lift_u128_from10": (LIFT128_SRC,
                         "none: concrete_ntt_tpu/ops/crt.py rec_u128_from10 is XLA code"),
    # the native Plan32 polymul's pointwise Montgomery product: no TPU kernel
    "pointwise_mont32": (MONT_SRC, "none: the JAX stacked polymul's product is XLA code"),
}
# the rows that also carry their shape above 2^15 (fields `n17_*` of the JSON line)
BIG_ROWS = ("fwd_wide_multi", "fwd_wide_multi_u128", "inv_multi", "fwd_multi_perchannel",
            "pointwise_inv_multi", "fwd", "fwd_u128", "inv", "pass_matmod_u128")
# (module, tier) of the native plans beside native64's, and the three run at
# n = 1024 through the per-channel route (one of each width)
NATIVE_PLANS = (("native32", "Plan32"), ("native32", "Plan52"), ("native_binary32", "Plan32"),
                ("native_binary32", "Plan52"), ("native_binary64", "Plan32"),
                ("native_binary64", "Plan52"), ("native128", "Plan32"),
                ("native_binary128", "Plan32"))
PERCHANNEL_PLANS = (("native32", "Plan32"), ("native_binary64", "Plan32"), ("native128", "Plan32"))
N_PERCH = 1024
# n = 2^16 and 2^17 (n1 = 256, n2 = 256 | 512): the direct 32-bit kernels there,
# the 32-bit hybrid's block tables, the presplit inverse, K5's u128 operand
N16, N17 = 1 << 16, 1 << 17
B_BIG = 8  # batch of the native plans' polymuls timed at 2^16 and 2^17
# the rows of the GEMM passes' kernels (csrc/matmod_pass.cuh, 32-bit, then
# csrc/matmod64_pass.cuh, 64-bit): their JSON rows carry `device_ms` and `gemm_ms`
GEMM_ROWS = ("fwd_wide_multi", "inv_multi", "fwd_multi_perchannel", "pointwise_inv_multi", "fwd",
             "inv", "pass_matmod", "fwd_wide_multi_u128", "fwd_u128", "pass_matmod_u128",
             "fwd_hyb", "inv_hyb", "fwd_multi_perchannel_hyb", "inv_multi_hyb",
             "pointwise_inv_multi_hyb", "inv_multi_presplit",
             "fwd64", "inv64", "pass_matmod64", "fwd_multi64", "pointwise_inv_multi64",
             "fwd64_hyb", "inv64_hyb", "fwd_multi_perchannel64", "inv_multi64",
             "fwd_multi_perchannel64_hyb", "inv_multi64_hyb", "pointwise_inv_multi64_hyb",
             "fwd64_u128", "pass_matmod_multi", "pass_matmod_multi_u128", "pass_matmod64_multi")


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


@functools.lru_cache(maxsize=None)
def gate():
    """tools/gpu_parity.py of this checkout, loaded once: the parity gate's
    rows (phase 3b) and the checks both scripts use (`same_bits`,
    `route_passes`)."""
    spec = importlib.util.spec_from_file_location(
        "gpu_parity", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                   "gpu_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launched(call) -> tuple:
    """call()'s result and the kernel launches it made: the non-zero
    `profiling.launch_counts()`, the counters zeroed just before."""
    from concrete_ntt_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.reset_launches()
    out = call()
    torch.cuda.synchronize()
    return out, {k: v for k, v in profiling.launch_counts().items() if v}


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def ptxas_entries(log: str) -> list:
    """(entry, registers, spill store bytes, spill load bytes) of each kernel
    in an `nvcc -Xptxas -v` log."""
    out, entry, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            entry, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            out.append((entry, int(m.group(1)), *spill))
            entry = None
    return out


def pass_instance(entry: str) -> str:
    """'kD/regime/epilogue[/tile t]' of a mangled GEMM pass instance:
    matmod64_pass<kD, kMode, kScaled, kPointwise, kTile> or matmod_pass<kD,
    kRegime, kScaled, kPointwise, kPresplit, kTile> (no tile shown for code
    0)."""
    m = re.search(r"matmod(64)?_passILi(\d)ELi(\d)ELb(\d)ELb(\d)E(?:Lb(\d)E)?(?:Li(\d)E)?",
                  entry)
    if not m:
        return entry
    wide, d, mode, scaled, pw, presplit, tile = m.groups()
    regime = (("shoup", "montshoup", "montmont", "gl") if wide else
              ("lt30", "lt31", "generic"))[int(mode)]
    form = ("scaled" if scaled == "1" else "canonical") + (
        "+pointwise" if pw == "1" else "+presplit" if presplit == "1" else "")
    return f"{d}/{regime}/{form}" + (f"/tile {tile}" if tile and tile != "0" else "")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_pass(name: str) -> bool:
    return "matmod_pass" in name or "matmod64_pass" in name


def is_k4(name: str) -> bool:
    return "ntt_k4" in name


def k4_bound(n: int, b: int) -> tuple:
    """K4's bound at (n, B): B·(n/2)·log2 n butterflies of about 12 integer
    operations on the CUDA cores; operand, result and two twiddle tables once."""
    from concrete_ntt_tpu_torch.utils.profiling import CORE_OPS_PER_S, HBM_BYTES_PER_S

    ops = b * (n // 2) * (n.bit_length() - 1) * 12
    t_b, t_o = 4 * (2 * b * n + 2 * n) / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def gemm_pairs(dev, direction: str, n1: int, n2: int, b: int, c: int, e1: int, n_d: int = 4,
               nb: int = 1, passes: int = 2, e2: int = 4) -> list:
    """int8 matrices of the shapes of a four-step transform's digit GEMMs,
    per channel and block: pass 1 [B·R, E1·K1] x [E1·K1, D·K1] and pass 2
    [B·K1, E2·R] x [E2·R, D·R] (K1 = n1 forward, n2 inverse; R the other
    factor; E2 = 4 for a u32 mid-pass operand, 8 for a u64 one), the right
    factor K-major (column-major), the layout the int8 tensor cores take.
    Random values: an int8 GEMM's time does not depend on them. `passes` =
    1: the first pass alone (K3, K6)."""
    k1, r = (n1, n2) if direction == "fwd" else (n2, n1)
    gen = torch.Generator(device=dev).manual_seed(1)
    mat = lambda rows, cols: torch.randint(-128, 128, (rows, cols), dtype=torch.int8, device=dev,
                                           generator=gen)
    pairs = []
    for _ in range(c * nb):
        pairs.append((mat(b * r, e1 * k1), mat(n_d * k1, e1 * k1).t()))
        if passes == 2:
            pairs.append((mat(b * k1, e2 * r), mat(n_d * r, e2 * r).t()))
    return pairs


def gemm64_rows(dev, u32) -> list:
    """The rows of the 64-bit GEMM pass's kernels (csrc/matmod64_pass.cuh) at
    the shapes their JSON rows report, from the port first on sys.path:
    (key, name, label, kernel call, plain call, matmod64_pass launches a
    call, int8 pairs of the same passes' shapes) for `median_ms` and
    `device_times`. The pass contracts 8 operand planes (7 with a zero
    eighth, or 16 of a u128 operand in K5's column pass) against D matrix
    planes. u32(shape) makes random uint32 operands on dev."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu64
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52

    gl, p52, p50, n15 = GOLDILOCKS, PRIMES52[:3], PRIMES52[0], 1 << 15
    d_gl, d50 = mxu64._n_dplanes(gl), mxu64._n_dplanes(p50)
    n1, n2 = mxu32.four_step_factors(N64)
    n1k, n2k = mxu32.four_step_factors(4096)
    scale = lambda n, p: pow(n, p - 2, p) * pow(2, 64, p) % p
    pair = lambda shape: (u32(shape), u32(shape))
    x, x52, xc = pair((B64, N64)), pair((B52, N64)), pair((3, B52, N64))
    fl, fr = pair((3, B52, N64)), pair((3, B52, N64))
    xh, x3, y3 = pair((B_HYB, 1 << 16)), pair((3, B52, n15)), pair((3, B52, n15))
    w4 = tuple(u32((B64, N64)) for _ in range(4))
    tbl = mxu64._tables(4096, p50)
    xa = pair((B64, tbl["n2"], tbl["n1"]))
    k6 = dict(n=4096, p=p50, which="A",
              diag_slices=tuple(torch.from_numpy(a).to(dev) for a in tbl["d"]))
    sg, s52, s15 = scale(N64, gl), tuple(scale(N64, q) for q in p52), \
        tuple(scale(n15, q) for q in p52)
    hyb = dict(n=1 << 16, p=gl, n_h=N_H)
    sh = scale(1 << 16, gl)
    pairs = lambda direction, b, c, e1, n_d, **kw: (
        lambda: gemm_pairs(dev, direction, n1, n2, b, c, e1, n_d, e2=8, **kw))
    return [
        ("fwd64", "K5 fwd64", f"n={N64} B={B64} p={gl} (goldilocks)",
         lambda: m.fwd(x, n=N64, p=gl), lambda: m.fwd_plain(x, n=N64, p=gl), 2,
         pairs("fwd", B64, 1, 8, d_gl)),
        ("inv64", "K5 inv64", f"n={N64} B={B64} p={gl} (goldilocks) scaled",
         lambda: m.inv(x, n=N64, p=gl, scale=sg), lambda: m.inv_plain(x, n=N64, p=gl, scale=sg),
         2, pairs("inv", B64, 1, 8, d_gl)),
        ("pass_matmod64", "K6 pass_matmod64", f"A scaled n=4096 B={B64} p={p50}",
         lambda: m.pass_matmod64(xa, **k6), lambda: m.pass_matmod64_plain(xa, **k6), 1,
         lambda: gemm_pairs(dev, "fwd", n1k, n2k, B64, 1, 8, d50, passes=1)),
        ("fwd_multi64", "K7a fwd_multi64", f"n={N64} B={B52} C=3",
         lambda: m.fwd_multi(x52, p52), lambda: m.fwd_multi_plain(x52, p52), 2,
         pairs("fwd", B52, 3, 8, d50)),
        ("pointwise_inv_multi64", "K7d pointwise_inv_multi64", f"n={N64} B={B52} C=3 scaled",
         lambda: m.pointwise_inv_multi(fl, fr, p52, s52),
         lambda: m.pointwise_inv_multi_plain(fl, fr, p52, s52), 2, pairs("inv", B52, 3, 8, d50)),
        ("fwd64_hyb", "K5h fwd64_hyb", f"n={1 << 16} n_h={N_H} B={B_HYB} p={gl} (goldilocks)",
         lambda: m.fwd_hyb(xh, **hyb), lambda: m.fwd_hyb_plain(xh, **hyb), 2,
         pairs("fwd", B_HYB, 1, 8, d_gl, nb=4)),
        ("inv64_hyb", "K5h inv64_hyb",
         f"n={1 << 16} n_h={N_H} B={B_HYB} p={gl} (goldilocks) scaled",
         lambda: m.inv_hyb(xh, scale=sh, **hyb), lambda: m.inv_hyb_plain(xh, scale=sh, **hyb),
         2, pairs("inv", B_HYB, 1, 8, d_gl, nb=4)),
        ("fwd_multi_perchannel64", "K7c fwd_multi_perchannel64", f"n={N64} B={B52} C=3",
         lambda: m.fwd_multi_perchannel64(*xc, p52),
         lambda: m.fwd_multi_perchannel64_plain(xc, p52), 2, pairs("fwd", B52, 3, 8, d50)),
        ("inv_multi64", "K7b inv_multi64", f"n={N64} B={B52} C=3 scaled",
         lambda: m.inv_multi(*xc, p52, s52), lambda: m.inv_multi_plain(xc, p52, s52), 2,
         pairs("inv", B52, 3, 8, d50)),
        ("fwd_multi_perchannel64_hyb", "K7c fwd_multi_perchannel64 with block tables",
         f"n={n15} n_h={N_H} B={B52} C=3",
         lambda: m.fwd_multi_perchannel64(*x3, p52, n_h=N_H),
         lambda: m.fwd_multi_perchannel64_plain(x3, p52, N_H), 2,
         pairs("fwd", B52, 3, 8, d50, nb=2)),
        ("inv_multi64_hyb", "K7b inv_multi64 with block tables",
         f"n={n15} n_h={N_H} B={B52} C=3 scaled",
         lambda: m.inv_multi(*x3, p52, s15, n_h=N_H),
         lambda: m.inv_multi_plain(x3, p52, s15, N_H), 2, pairs("inv", B52, 3, 8, d50, nb=2)),
        ("pointwise_inv_multi64_hyb", "K7d pointwise_inv_multi64 with block tables",
         f"n={n15} n_h={N_H} B={B52} C=3 scaled",
         lambda: m.pointwise_inv_multi(x3, y3, p52, s15, n_h=N_H),
         lambda: m.pointwise_inv_multi_plain(x3, y3, p52, s15, N_H), 2,
         pairs("inv", B52, 3, 8, d50, nb=2)),
        ("fwd64_u128", "K5 fwd64 with four limbs", f"n={N64} B={B64} p={gl} (goldilocks)",
         lambda: m.fwd(w4, n=N64, p=gl), lambda: m.fwd_plain(w4, n=N64, p=gl), 2,
         pairs("fwd", B64, 1, 16, d_gl)),
    ]


def bind_now(fn):
    """fn with the current values of its free variables: the timing phase
    reuses names for the next shape, and a queued call must keep its own."""
    if not fn.__closure__:
        return fn
    cells = tuple(types.CellType(c.cell_contents) for c in fn.__closure__)
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, fn.__defaults__, cells)


def profile_polymul(fn, reps: int = 10) -> dict:
    """Per-call breakdown of fn(): host-clock ms (perf_counter around reps
    synchronized calls, no profiler), then under torch.profiler the device
    busy ms (device events: kernels and copies), the device ms of the GEMM
    passes (matmod_pass, matmod64_pass) and butterfly (ntt_k4) kernels, and the counts
    of device events and aten ops (nested ones included)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = kern = 0.0
    n_dev = n_aten = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy += us
            n_dev += 1
            if "matmod_pass" in ev.name or "matmod64_pass" in ev.name or "ntt_k4" in ev.name:
                kern += us
        elif ev.name.startswith("aten::"):
            n_aten += 1
    busy_ms = busy / 1e3 / reps
    return {"host_ms": host_ms, "busy_ms": busy_ms, "busy_share": busy_ms / host_ms,
            "kernel_ms": kern / 1e3 / reps, "device_events": n_dev / reps,
            "aten_ops": n_aten / reps}


def aten_ops(fn, reps: int = 3) -> float:
    """aten ops a call of fn() (nested ones included, as `profile_polymul`
    counts them), by a torch.profiler session on the CPU activity alone."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
    return sum(ev.name.startswith("aten::") for ev in prof.events()) / reps


def stages_phase(smi: str, seed: int, dev: torch.device) -> None:
    """The `stages` phase, twin of tools/profile_stages.py and
    tools/ab_lift.py: the native64 Plan32 polymul at (2^14, 8) and its
    stages, native128 Plan32 at (2^16, 8), and both implementations of the
    three Garner lifts at their plans' shapes, each timed by
    `profiling.chain_time` on CUDA graphs (dispatch removed) and by the
    eager CUDA-event median (dispatch included). Raises on a capture that
    fails, a graph that disagrees with eager, lifts that disagree, or
    launches other than the route's."""
    from concrete_ntt_tpu_torch import crt_mxu, native64, native128
    from concrete_ntt_tpu_torch.ops import crt, crt_cuda, ntt_dispatch
    from concrete_ntt_tpu_torch.ops.u32 import MASK32, to_i64, to_u32
    from concrete_ntt_tpu_torch.tables import native_channel_primes
    from concrete_ntt_tpu_torch.utils import profiling

    rng = np.random.default_rng(seed)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    residues = lambda primes, b, n: torch.stack([u32((b, n), p) for p in primes])

    def row(name, step, args, length, roof, mult=1.0):
        """Print one stage: chain ms, eager ms, roofline share; check that a
        graph of two steps replays to eager's bits. Returns the chain ms."""
        graph, out = profiling.capture(step, args, 2)
        graph.replay()
        torch.cuda.synchronize()
        require(gate().same_bits(out, step(step(args))),
                f"stages: {name}: the CUDA graph's outputs differ from eager")
        del graph, out
        t = profiling.chain_time(step, args, length=length) * 1e3
        eager = median_ms(lambda: step(args))
        r = roof(t / 1e3)
        print(f"stages: {name}: chain {t:.4f} ms (dispatch removed: CUDA graphs of {length} and "
              f"1 steps, best of 5 in turns), eager {eager:.4f} ms (CUDA events, median of "
              f"{REPS}), roofline share {100 * r.share:.3f} % ({r.hbm_bytes} B, {r.mxu_macs} "
              f"int8 MACs), x{mult:g} a polymul; graph == eager | {smi}", flush=True)
        torch.cuda.empty_cache()
        return t

    def lift_step(rec, primes):
        """carry (t [C, B, n] uint32, prev) -> (C fresh words from the lift, t)."""
        def step(carry):
            t, _ = carry
            mods = to_i64(t)
            out = rec([mods[i] for i in range(len(primes))], primes)
            mix = [out[i % len(out)] + i for i in range(len(primes))]
            return to_u32(torch.stack(mix) & MASK32), t
        return step

    def kernel_lift_step(primes):
        """carry (t [5, B, n] uint32, prev) -> ((lo, hi, lo, hi, lo) of the lift
        kernel as the next residues, t): one stack of feedback a step."""
        def step(carry):
            t, _ = carry
            lo, hi = crt_cuda.rec_u64_from5(t, primes)
            return torch.stack([v.view(torch.int32) for v in (lo, hi, lo, hi, lo)]).view(
                torch.uint32), t
        return step

    # -- the native64 Plan32 polymul (2^14, 8) and its stages ------------------------
    t_start = time.perf_counter()
    n, b = N_MAIN, B_MAIN
    plan = native64.Plan32.try_new(n)
    primes, c = plan.primes, len(plan.primes)
    scales = ntt_dispatch._pointwise_scales(n, primes)
    length = 64  # tools/profile_stages.py: 64 steps up to 2^14, 32 above
    ops = [u32((b, n)) for _ in range(4)]
    _, moved = launched(lambda: plan.negacyclic_polymul(tuple(ops[:2]), tuple(ops[2:])))
    require(moved == {"fwd_wide_multi": 2, "pointwise_mont32": 1, "inv_multi": 1,
                      "lift_u64_from5": 1},
            f"stages: the native64 Plan32 polymul launched {moved}")
    fwd_r = lambda t: profiling.mxu_transform_roofline(n, b * c, t, 8, 4)
    inv_r = lambda t: profiling.mxu_transform_roofline(n, b * c, t, 4, 4)
    word = 4 * b * n  # bytes of one u32 [B, n]
    full = row(f"full-polymul native64 Plan32 n={n} B={b}",
               lambda cr: (*plan.negacyclic_polymul(cr[:2], cr[2:]), cr[0], cr[1]), tuple(ops),
               length, lambda t: profiling.Roofline(
                   t, 6 * word, 2 * fwd_r(t).mxu_macs + inv_r(t).mxu_macs))
    fwd = row("fwd-wide-multi", lambda cr: tuple(ntt_dispatch.try_fwd32_wide_all(
        cr, plan.plans)[:2]), tuple(ops[:2]), length, fwd_r, 2.0)
    fl, fr = residues(primes, b, n), residues(primes, b, n)
    pw = row("pointwise-montgomery", lambda cr: (ntt_dispatch.pointwise_mont32(
        cr[0], cr[1], primes), cr[0]), (fl, fr), length,
        lambda t: profiling.Roofline(t, 3 * c * word, 0))
    inv = row("inv-multi", lambda cr: (ntt_dispatch.try_inv32_all(cr[0], plan.plans, scales),
                                       cr[0]), (fl, fr), length, inv_r)
    lift_roof = lambda macs: lambda t: profiling.Roofline(t, (c + 2) * word, macs)
    row("garner-lift rec_u64_from5", lift_step(crt.rec_u64_from5, primes), (fl, fr), length,
        lift_roof(0))
    row("garner-lift crt_mxu.rec_u64_from5", lift_step(crt_mxu.rec_u64_from5, primes), (fl, fr),
        length, lift_roof(b * n * 20 * 9))
    lift = row("garner-lift crt_cuda.rec_u64_from5 (the lift kernel; the step's feedback one "
               "int32 stack)", kernel_lift_step(primes), (fl, fr), length, lift_roof(0))
    parts = 2 * fwd + pw + inv + lift
    print(f"stages: SUM(parts) {parts:.4f} ms (fwd x2 + pointwise + inv + kernel lift) vs "
          f"full-polymul {full:.4f} ms: ratio {parts / full:.3f}; {1e3 / full:.1f} polymuls/s "
          f"with dispatch removed | {smi}", flush=True)

    # -- native128 Plan32 (2^16, 8), BASELINE.json configs[4] -----------------------
    n128 = N16
    plan128 = native128.Plan32.try_new(n128)
    ops = [u32((b, n128)) for _ in range(8)]
    _, moved = launched(lambda: plan128.negacyclic_polymul(tuple(ops[:4]), tuple(ops[4:])))
    require(moved == {"fwd_wide_multi_u128": 2, "pointwise_mont32": 1, "inv_multi": 1,
                      "lift_u128_digits": 1, "lift_u128_limbs": 1},
            f"stages: the native128 Plan32 polymul launched {moved}")
    c128, w128 = len(plan128.primes), 4 * b * n128
    row(f"full-polymul native128 Plan32 n={n128} B={b}",
        lambda cr: (*plan128.negacyclic_polymul(cr[:4], cr[4:]), *cr[:4]), tuple(ops), 32,
        lambda t: profiling.Roofline(t, 12 * w128, 2 * profiling.mxu_transform_roofline(
            n128, b * c128, t, 16, 4).mxu_macs + profiling.mxu_transform_roofline(
            n128, b * c128, t, 4, 4).mxu_macs))
    p128 = plan128.primes
    fl128 = residues(p128, b, n128)
    require(gate().same_bits(crt_cuda.rec_u128_from10(fl128, p128),
                             crt_cuda.rec_u128_from10_plain(fl128, p128)),
            f"stages: native128's lift kernels differ from their plain twin at [{b}, {n128}]")

    def kernel_lift128_step(carry):
        """carry (t [10, B, n] uint32, prev) -> (the four limbs of the lift
        kernels, twice over plus two, as the next residues, t)."""
        t, _ = carry
        limbs = crt_cuda.rec_u128_from10(t, p128)
        return torch.stack([v.view(torch.int32) for v in (*limbs, *limbs, *limbs[:2])]).view(
            torch.uint32), t

    # bytes the two launches move: 80 a coefficient (digits), 56 (limbs)
    row("garner-lift crt_cuda.rec_u128_from10 (native128's two lift kernels; the step's "
        "feedback one int32 stack)", kernel_lift128_step, (fl128, fl128), 32,
        lambda t: profiling.Roofline(t, 34 * w128, 0))

    # -- the lift A/B at the plans' shapes (tools/ab_lift.py) ------------------------
    for name, k, nn, words in (("rec_u64_from5", 5, n, 2), ("rec_u128_from5", 5, n, 4),
                               ("rec_u128_from10", 10, n128, 4)):
        pr = native_channel_primes(k, nn)
        t = residues(pr, b, nn)
        mods = [m for m in to_i64(t)]
        scalar, gemm = getattr(crt, name), getattr(crt_mxu, name)
        require(gate().same_bits(scalar(mods, pr), gemm(mods, pr)),
                f"stages: lift A/B: crt_mxu.{name} differs from ops/crt.py's at [{b}, {nn}]")
        impls = {"scalar chain": scalar, "int8 GEMM": gemm}
        chains = {impl: [] for impl in impls}
        for impl in ("scalar chain", "int8 GEMM", "int8 GEMM", "scalar chain"):  # in turns
            chains[impl].append(profiling.chain_time(
                lift_step(impls[impl], pr), (t, t), length=64 if nn <= N_MAIN else 32) * 1e3)
        print(f"stages: lift A/B {name} [{b}, {nn}], {k} channels -> {words} limbs, equal bit "
              "for bit; chain ms in turns (scalar, GEMM, GEMM, scalar): " + "; ".join(
                  f"{impl} {chains[impl][0]:.4f}, {chains[impl][1]:.4f}, eager "
                  f"{median_ms(lambda: rec(mods, pr)):.4f} ms, "
                  f"{aten_ops(lambda: rec(mods, pr)):.0f} aten ops" for impl, rec in impls.items())
              + f"; GEMM / scalar chain, best of each "
              f"{min(chains['int8 GEMM']) / min(chains['scalar chain']):.3f} | {smi}", flush=True)
        torch.cuda.empty_cache()
    print(f"stages: done in {time.perf_counter() - t_start:.1f} s", flush=True)


EXAMPLES = ("mul_poly_native_torch.py", "mul_poly_prime_torch.py",
            "mul_poly_product_accumulate_torch.py")


def examples_phase(root: str, smi: str) -> None:
    """Run the port's three examples on the card, all started together;
    each must exit 0 and print its `ok:` line."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, os.path.join(root, "examples", name)],
                                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name in EXAMPLES}
    try:
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            require(proc.returncode == 0 and "ok:" in out,
                    f"examples: {name} exited {proc.returncode}: {out[-2000:]}")
            print(f"examples: {name}: {out.strip().splitlines()[-1]}", flush=True)
    finally:
        for proc in procs.values():
            proc.kill()
    print(f"examples: {len(EXAMPLES)} on the card in {time.perf_counter() - t0:.1f} s | {smi}",
          flush=True)


# the `sharded` phase: the slice's three paths in a world of RANKS rank
# processes on the one card (gloo: NCCL refuses two ranks on one card), and
# once in a world of one on NCCL; (dp, ch, sp) of each path's mesh
N_SH128, N_SH64, B_SH = 1 << 16, 1 << 14, 8
SHARDED_MESHES = {"native128": (1, 2, 2), "native64": (2, 1, 2), "plan52": (2, 1, 2)}
SHARDED_REPS = 5
SHARDED_TIMEOUT = 600  # seconds a world may take, rank processes' start and tables included


def sharded_inputs(seed: int) -> dict:
    """The operands of the three sharded paths, the same on every rank:
    native128 as uint32 limbs [B, 2^16, 4], the native64 paths as numpy
    uint64 [B, 2^14]."""
    rng = np.random.default_rng(seed)
    return {"native128": tuple(rng.integers(0, 1 << 32, (B_SH, N_SH128, 4), dtype=np.uint32)
                               for _ in range(2)),
            **{k: tuple(rng.integers(0, 1 << 64, (B_SH, N_SH64), dtype=np.uint64)
                        for _ in range(2)) for k in ("native64", "plan52")}}


def sharded_want(name: str, mesh: tuple) -> dict:
    """The launches of one polymul on a rank of `mesh` (dp, ch, sp): six
    passes (A and F for each operand, G and A_inv), each one channel-grid
    launch over all of the rank's channels."""
    if name == "native128":  # the A passes take the operand's four limbs
        return {"pass_matmod_multi_u128": 2, "pass_matmod_multi": 4}
    if name == "native64":  # one sharded four-step a channel, all five on every rank
        return {"pass_matmod_multi": 6 * 5}
    return {"pass_matmod64_multi": 6}  # Plan52's primes: the "grid" route


def sharded_path(name: str, mesh, device):
    """The polymul of path `name` on this rank: the port's sharded entry
    points (`parallel.channels`, `parallel.fourstep_mxu`) on `device` (None:
    the card)."""
    from concrete_ntt_tpu_torch import native64, native128
    from concrete_ntt_tpu_torch.parallel import channels, dryrun, fourstep_mxu

    on = {} if device is None else {"device": device}
    axes = dict(ch_axis="ch", batch_axis="dp", sp_axis="sp", device=device)
    if name == "native128":
        plan = native128.Plan32.try_new(N_SH128, **on)
        return channels.ChannelShardedNative(plan, mesh, **axes).negacyclic_polymul
    if name == "plan52":
        plan = native64.Plan52.try_new(N_SH64, **on)
        return channels.ChannelShardedNative52(plan, mesh, **axes).negacyclic_polymul
    plan = native64.Plan32.try_new(N_SH64, **on)
    chans = [fourstep_mxu.make_sharded_prime32_mxu(pl, mesh, axis="sp", batch_axis="dp",
                                                   device=device) for pl in plan.plans]
    return lambda lhs, rhs: dryrun.native64_polymul(plan, chans, lhs, rhs)


def sharded_rank(rank: int, world: int, seed: int, check_cpu: bool) -> dict:
    """One rank of the `sharded` phase: each path once on the card with the
    launch counts set to 0 just before it and read just after (raises unless
    they are `sharded_want`'s and nothing else), with `check_cpu` once more
    with device="cpu" (the plain passes; the result must be the same bits),
    then SHARDED_REPS polymuls timed barrier to barrier. Returns, by path,
    rank 0's product, this rank's launches and the ms of one polymul."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    inputs = sharded_inputs(seed)
    out = {}
    for name, shape in SHARDED_MESHES.items():
        shape = shape if world == RANKS else (1, 1, 1)
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("dp", "ch", "sp"))
        run = sharded_path(name, mesh, None)
        lhs, rhs = (torch.from_numpy(v).cuda() if v.dtype == np.uint32 else v
                    for v in inputs[name])
        got, moved = launched(lambda: run(lhs, rhs))
        if moved != sharded_want(name, shape):
            raise RuntimeError(f"rank {rank}: {name} launched {moved}, expected "
                               f"{sharded_want(name, shape)}")
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        if check_cpu:
            cpu = sharded_path(name, mesh, "cpu")(*(torch.from_numpy(v) if v.dtype == np.uint32
                                                     else v for v in inputs[name]))
            cpu = cpu.numpy() if isinstance(cpu, torch.Tensor) else cpu
            if not np.array_equal(got, cpu):
                raise RuntimeError(f"rank {rank}: {name} on the card differs from the CPU plain "
                                   "path of the sharded module")
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARDED_REPS):
            run(lhs, rhs)
        torch.cuda.synchronize()
        dist.barrier()
        ms = (time.perf_counter() - t0) * 1e3 / SHARDED_REPS
        out[name] = {"out": got if rank == 0 else None, "launches": moved, "ms": ms}
        if world == 1:  # alone on the card: its device-busy share and aten ops a polymul
            out[name]["profile"] = profile_polymul(lambda: run(lhs, rhs), reps=3)
    return out


def gemm_bound(macs: float, nbytes: float) -> tuple:
    """(bound ms, which bounds): the larger of the bytes the function must
    move over the card's memory rate and its int8 operations (2 a MAC) over
    the card's int8 tensor-core peak (`utils/profiling`'s H100 figures)."""
    from concrete_ntt_tpu_torch.utils.profiling import HBM_BYTES_PER_S, INT8_OPS_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * macs / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fourstep_work(direction, b, n1, n2, c, e1, e2, d, limbs_in, limbs_out, n_diag,
                  operands=1, shared_operand=False) -> tuple:
    """(int8 MACs, bytes) of a two-pass four-step transform over c channels:
    MACs a pass = B·R·(E·K)·(D·O) from the plane shapes (E operand planes, D
    matrix planes); bytes = operands and results once (4-byte limbs) plus the
    tables once (int8 planes, int32 cvec, u32 diagonals). The mid-pass
    scratch is the kernel's own and not counted."""
    n = n1 * n2
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)
    macs = c * b * n * d * (e1 * k1 + e2 * k2)
    tables = c * (d * (e1 * k1 * k1 + e2 * k2 * k2) + 4 * d * (k1 + k2) + 4 * n_diag * n)
    io = 4 * b * n * ((1 if shared_operand else c) * operands * limbs_in + c * limbs_out)
    return macs, io + tables


def hybrid_work(direction, b, n1, n2, nb, c, e1, e2, d, n_diag, operands=1, limbs=2) -> tuple:
    """(int8 MACs, bytes) of the nb block transforms of size n1·n2 of a
    stage-split hybrid over c channels: the MACs of nb four-steps; operands
    and results once (`limbs` u32 limbs of [c, B, nb·n1·n2]: (lo, hi), or 1 in
    32 bits); the per-block
    column operator and diagonals nb times, the shared row operator once."""
    n = n1 * n2
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)
    macs = c * nb * b * n * d * (e1 * k1 + e2 * k2)
    blk, sh = ((e1, k1), (e2, k2)) if direction == "fwd" else ((e2, k2), (e1, k1))
    tables = c * (nb * (d * blk[0] * blk[1] ** 2 + 4 * d * blk[1] + 4 * n_diag * n)
                  + d * sh[0] * sh[1] ** 2 + 4 * d * sh[1])
    io = 4 * b * nb * n * c * limbs * (operands + 1)
    return macs, io + tables


def u64_limbs(v: np.ndarray) -> torch.Tensor:
    """numpy uint64 [..., n] -> uint32 [..., n, 2] little-endian limbs."""
    return torch.from_numpy(np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                      (v >> np.uint64(32)).astype(np.uint32)], axis=-1))


def rand_mod(rng, m: int, shape) -> np.ndarray:
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(m)


def centred(rng, m: int, shape) -> np.ndarray:
    """Signed values |v| < BOUND / 2 mod m: what a Bounded fwd takes."""
    v = rng.integers(-(BOUND // 2), BOUND // 2, shape)
    return np.where(v < 0, np.uint64(m) - np.abs(v).astype(np.uint64), v.astype(np.uint64))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--profile", action="store_true",
                    help="also profile the prime32 polymul (torch.profiler)")
    args = ap.parse_args()

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import concrete_ntt_tpu_torch as port
    from concrete_ntt_tpu_torch import native64, prime32, prime64, product
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu
    from concrete_ntt_tpu_torch.ops import (
        crt_cuda, cuda_build, mxu32, mxu32_cuda, mxu64, mxu64_cuda, pointwise_cuda, stagesplit)
    from concrete_ntt_tpu_torch.ops.u32 import (
        limbs_to_np_u64, mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32)
    from concrete_ntt_tpu_torch.parallel import _dist
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, NATIVE128_PRIMES, PRIMES52, primes32_ext
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)
    from concrete_ntt_tpu_torch.utils.profiling import device_times

    scale32, scale64 = gate().scale32, gate().scale64

    # the five regime primes of the prime64 plan: four epilogue regimes, and
    # the shoup regime with 7 and with 8 digit planes
    PRIMES64 = {
        "goldilocks": GOLDILOCKS,
        "p50": PRIMES52[0],
        "p63": prime_in_ap(1 << 15, 1, 1 << 62, 1 << 63),
        "p64": prime_in_ap(1 << 15, 1, 1 << 63, (1 << 64) - 1),
        "p62": prime_in_ap(1 << 16, 1, 1 << 61, 1 << 62),
    }
    P52 = PRIMES52[:3]
    # the same five regimes with 2^18 | p - 1: NTT primes up to n = 2^17
    HYB64 = {
        "goldilocks": GOLDILOCKS,
        "p50": prime_in_ap(1 << 18, 1, 0, 1 << 50),
        "p62": prime_in_ap(1 << 18, 1, 1 << 61, 1 << 62),
        "p63": prime_in_ap(1 << 18, 1, 1 << 62, 1 << 63),
        "p64": prime_in_ap(1 << 18, 1, 1 << 63, (1 << 64) - 1),
    }

    # the three prime32 regimes with 2^18 | p - 1, and the ten 30-bit channel
    # primes of the native plans above 2^15
    BIG32 = {
        "lt30": prime_in_ap(1 << 18, 1, 1 << 29, 1 << 30),
        "lt31": prime_in_ap(1 << 18, 1, 1 << 30, 1 << 31),
        "generic": prime_in_ap(1 << 18, 1, 1 << 31, 1 << 32),
    }
    EXT = tuple(primes32_ext())
    SMALL18 = prime_in_ap(1 << 18, 1, 0, 1 << 26)  # < 2^26, NTT prime up to 2^17: K4 there

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        sos = list(pool.map(cuda_build.build, cuda_build.SOURCES))
    mxu32_cuda._lib(), mxu32_cuda._pass_lib(), bcu._lib()
    mxu64_cuda._pass_lib(), mxu64_cuda._multi_lib(), crt_cuda._lib(), crt_cuda._lib128()
    pointwise_cuda._lib()
    print(f"build: {len(sos)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    for so in sos:
        with open(so[:-3] + ".log") as f:
            log = f.read()
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        print(f"build: {os.path.relpath(so)}: " + " | ".join(ptxas), flush=True)
        passes = [e for e in ptxas_entries(log) if "matmod" in e[0]]
        if passes:
            print(f"build: {os.path.basename(so)} GEMM pass instances (digit planes, regime, "
                  "epilogue): " + "; ".join(f"{pass_instance(e)} {r} registers, {st} / {ld} B "
                                            "spill stores / loads" for e, r, st, ld in passes),
                  flush=True)
        for lib, kernel, instances in (("crt_lift_", "lift_u64_from5", 2),
                                       ("crt_lift128_", "lift_u128_", 4),
                                       ("mont32_pointwise_", "mont32_pointwise", 2)):
            if os.path.basename(so).startswith(lib):  # the vector and scalar instances
                found = [e for e in ptxas_entries(log) if kernel in e[0]]
                require(len(found) == instances and all(st == ld == 0 for _, _, st, ld in found),
                        f"build: {os.path.basename(so)}: streaming instances {found} missing or "
                        "spilling")
        if os.path.basename(so).startswith("mxu64_"):
            require(passes and all(st == ld == 0 for _, _, st, ld in passes),
                    f"build: {os.path.basename(so)}: a GEMM pass instance spills registers")
        built = {pass_instance(entry): (st, ld) for entry, _, st, ld in passes}
        if os.path.basename(so).startswith("mxu32_pass"):
            # K2's tile for small grids (tile 1): no spill; K3's channel grid:
            # every tile k3_multi_tile picks, 128 x 64 canonical with four planes
            want = {f"{dr}/{form}/tile {t}" for t in (1, 2) for form in ("scaled", "canonical")
                    for dr in ("4/lt30", "4/lt31", "4/generic", "5/generic")}
            want |= {f"4/{r}/canonical/tile 3" for r in ("lt30", "lt31", "generic")}
            require(want <= set(built) and all(
                built[k] == (0, 0) for k in built if k.endswith("/tile 1")),
                f"build: {os.path.basename(so)}: channel-grid / small-grid tile instances "
                f"{sorted(want - set(built))} missing, or a tile-1 instance spills")
        if os.path.basename(so).startswith("mxu64_pass"):
            # K6's channel grid on 64 rows: every (digit planes, regime) instance
            want = {k for k in built if k.endswith("/tile 1")}
            require(len(want) == 16, f"build: {os.path.basename(so)}: {len(want)} of the 16 "
                                     "64-row instances of the 64-bit pass built")
        # K1c / K1d's tile instances and K1e's presplit pass on codes 0-2: all built
        if os.path.basename(so).startswith("mxu32_multi"):
            want = {f"4/lt30/{form}/tile {t}" for form, t in K1_TILED}
            want |= {"4/lt30/scaled+presplit"} | {f"4/lt30/scaled+presplit/tile {t}"
                                                  for t in (1, 2)}
            require(want <= set(built), f"build: {os.path.basename(so)}: K1c / K1d's tile "
                                        f"instances {sorted(want - set(built))} missing")
        k4 = [e for e in ptxas_entries(log) if "ntt_k4" in e[0]]
        if k4:
            print(f"build: {os.path.basename(so)} K4 instances: " + "; ".join(
                f"{r} registers, {st} / {ld} B spill stores / loads" for _, r, st, ld in k4),
                flush=True)
    smem = {(d, t): mxu32_cuda._pass_lib().k_pass_smem_bytes(d, t)
            for t in range(len(mxu32_cuda.TILES)) for d in (4, 5)}
    smem64 = {(d, t): mxu64_cuda._pass_lib().k64_pass_smem_bytes(d, t) for t in (0, 1)
              for d in range(5, 10)}
    smem_pair = {t: mxu32_cuda._lib().k1_smem_bytes(t, 1) for t in (1, 2, 3)}
    print("build: matmod_pass dynamic shared memory a block, 4 / 5 digit planes: " + "; ".join(
          f"tile {t} {tm} x {to}: {smem[(4, t)]} / {smem[(5, t)]} B"
          for t, (tm, to) in enumerate(mxu32_cuda.TILES)) + "; K1d's pair pass (4 planes): " +
          ", ".join(f"tile {t} {v} B" for t, v in smem_pair.items()) +
          "; matmod64_pass with 5..9 digit planes, 128 / 64 rows: "
          + ", ".join(f"{smem64[(d, 0)]} / {smem64[(d, 1)]} B" for d in range(5, 10))
          + " (the ring of operand and plane stages, or the whole contraction of up to four "
          "stages)", flush=True)
    # K4's cluster launch: how many clusters the card holds at once
    clusters = {(n, c): bcu._lib().k4_max_active_clusters(n.bit_length() - 1, c.bit_length() - 1,
                                                          bcu.radix_log(n // c))
                for n, c in ((1 << 14, 8), (1 << 17, 8), (1 << 17, 4))}
    print("build: K4 clusters the card holds at once (cudaOccupancyMaxActiveClusters): " +
          "; ".join(f"n={n} c={c}: {v}" for (n, c), v in clusters.items()), flush=True)
    require(all(v > 0 for v in clusters.values()),
            f"build: K4's cluster launch is refused: {clusters}")
    # both GEMM passes contract on the int8 tensor cores (wgmma: GMMA in the
    # SASS) and never with dp4a (IDP.4A)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    require(os.path.exists(cuobjdump), f"build: no cuobjdump at {cuobjdump}: the SASS check "
                                       "needs the CUDA toolkit's cuobjdump")
    for so in sos:
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True).stdout
        n_gmma, n_imma, n_idp = (sass.count(op) for op in ("GMMA", "IMMA", "IDP.4A"))
        print(f"build: {os.path.basename(so)} SASS: {n_gmma} GMMA, {n_imma} IMMA, "
              f"{n_idp} IDP.4A", flush=True)
        if os.path.basename(so).startswith(("mxu32_", "mxu64_")):
            require(n_gmma > 0 and n_idp == 0,
                    f"build: {os.path.basename(so)} does not contract on the tensor cores")

    # -- 3. parity: the gate's --quick rows ------------------------------------------
    # tools/gpu_parity.py's rows at n in its QUICK_N in this process: each
    # kernel row against its plain twin (and the tile instances it is there
    # for launched), each plan row against the golden oracle and its route's
    # launches, the dense fixture's five plans at N = 2048 against their digests
    t0 = time.perf_counter()
    gate_ctx = gate().Ctx("cuda", True, args.seed)
    gate_rows = gate().rows(quick=True)
    gate_lines = []
    passed, failed = gate().run_rows(gate_ctx, gate_rows, out=gate_lines.append)
    for line in gate_lines:
        if line.startswith("FAIL") or line.startswith("PASS fixture"):
            print(f"parity: gpu_parity {line}", flush=True)
    print(f"parity: tools/gpu_parity.py --quick: {passed} of {len(gate_rows)} rows PASS "
          f"({sum(r.kind == 'kernel' for r in gate_rows)} kernel rows against their plain "
          f"versions, the rest against the golden oracle or the dense fixture's digests, each "
          f"plan row with its route's launches) in {time.perf_counter() - t0:.1f} s", flush=True)
    require(not failed, f"parity: gpu_parity rows failed: {failed[:8]}")
    # each JSON row's max_abs_err: the largest over the gate's kernel rows
    # that launched its kernel in this run (None where none did)
    max_err = {k: gate_ctx.max_err.get(COUNTER.get(k, k)) for k in KERNELS}
    print(f"parity: JSON rows no --quick kernel row launched: "
          f"{[k for k, v in max_err.items() if v is None] or 'none'}", flush=True)
    launches, launches_n17 = {}, {}  # each JSON row's launches (the sharded phase, then 5)

    # -- 4. formats: what no gate row holds --------------------------------------------
    rng = np.random.default_rng(args.seed)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    planar = lambda a: (
        torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        torch.from_numpy((a >> np.uint64(32)).astype(np.uint32)),
    )

    def limbs_np(width, shape, binary=False):
        """Random `width`-bit values as uint32 limbs [..., width / 32] ({0, 1} if binary)."""
        nl = width // 32
        if not binary:
            return rng.integers(0, 1 << 32, (*shape, nl), dtype=np.uint32)
        out = np.zeros((*shape, nl), dtype=np.uint32)
        out[..., 0] = rng.integers(0, 2, shape, dtype=np.uint32)
        return out

    def as_ints(limbs):
        """uint32 limbs [..., nl] -> object array of Python integers [...]."""
        return sum(limbs[..., k].astype(object) << (32 * k) for k in range(limbs.shape[-1]))

    def plan_arg(limbs, device):
        """The plan's performance format: a uint32 tensor (width 32) or planar limbs."""
        ts = tuple(torch.from_numpy(np.ascontiguousarray(limbs[..., k])).to(device)
                   for k in range(limbs.shape[-1]))
        return ts[0] if len(ts) == 1 else ts

    def out_limbs(out):
        """A plan's output (a tensor or planar limbs) -> uint32 limbs [..., nl] on the host."""
        parts = out if isinstance(out, tuple) else (out,)
        return np.stack([t.cpu().numpy() for t in parts], axis=-1)

    # the device rule: a default-constructed plan computes numpy input on the
    # card, the same bits as the planar limbs it takes on the card
    plan = native64.Plan32.try_new(N_MAIN)
    require(plan.device == "cuda", f"formats: default plan device is {plan.device!r}, not the card")
    operands = [
        tuple(rng.integers(0, 1 << 64, (B_MAIN, N_MAIN), dtype=np.uint64) for _ in range(2))
        for _ in range(3)
    ]
    on_card = [tuple(tuple(t.to(dev) for t in planar(a)) for a in pair) for pair in operands]
    want64 = {"fwd_wide_multi": 2, "pointwise_mont32": 1, "inv_multi": 1, "lift_u64_from5": 1}
    np_out, rule = launched(lambda: plan.negacyclic_polymul(*operands[0]))
    planar_out, moved = launched(lambda: plan.negacyclic_polymul(*on_card[0]))
    require(rule == want64 and moved == want64,
            f"formats: a native64 Plan32 polymul launched {rule} (numpy), {moved} (planar)")
    require(isinstance(np_out, np.ndarray) and np.array_equal(
        np_out, limbs_to_np_u64(torch.stack([o.cpu() for o in planar_out], dim=-1).numpy())),
        "formats: the numpy-input polymul differs from the planar one")
    print(f"formats: device rule: native64.Plan32({N_MAIN}) default device {plan.device!r}, "
          f"numpy-input polymul B={B_MAIN} == the planar one on the card, each launched "
          f"{rule}", flush=True)

    # the README vector on a default plan: N = 32, p = 1062862849, round trip
    readme = prime32.Plan.new(32, 1062862849)
    readme_x = np.arange(32, dtype=np.uint32)[None]
    readme_rt, moved = launched(lambda: readme.inv(readme.fwd(readme_x)))
    require(moved == {"butterfly32_fwd": 1, "butterfly32_inv": 1}
            and np.array_equal(readme_rt.cpu().numpy(),
                               (readme_x.astype(np.uint64) * 32 % readme.p).astype(np.uint32)),
            f"formats: README vector (N=32, p=1062862849) round trip != N·x or launched {moved}")
    print(f"formats: README vector N=32 p=1062862849: inv(fwd(x)) == N·x on the card; launches "
          f"{moved}", flush=True)

    # host formats: Python ints ("py128") on a default native128 plan
    pl128 = port.native128.Plan32.try_new(N_MAIN)
    a128, b128 = limbs_np(128, (1, N_MAIN)), limbs_np(128, (1, N_MAIN))
    route128 = {"fwd_wide_multi_u128": 2, "pointwise_mont32": 1, "inv_multi": 1,
                "lift_u128_digits": 1, "lift_u128_limbs": 1}
    py_out, moved = launched(lambda: pl128.negacyclic_polymul(
        [int(v) for v in as_ints(a128[0])], [int(v) for v in as_ints(b128[0])]))
    planar128 = pl128.negacyclic_polymul(plan_arg(a128, dev), plan_arg(b128, dev))
    require(moved == route128 and isinstance(py_out, list)
            and py_out == [int(v) for v in as_ints(out_limbs(planar128)[0])],
            f"formats: native128 py128 polymul differs from the planar one or launched {moved}")
    print(f"formats: native128.Plan32 default device {pl128.device!r}: a polymul of two lists of "
          f"{N_MAIN} Python ints == the 4-limb planar result; launches {moved}", flush=True)

    # -- the timed paths' plans and operands (phase 5; the gate holds their bits) ------
    host = lambda a: torch.from_numpy(a)
    card = lambda v: u64_limbs(v).to(dev)
    p32_cases = []
    for name, p in BENCH_PRIMES.items():
        pl = prime32.Plan.new(N32, p)
        lhs, rhs = (rng.integers(0, p, (B32, N32), dtype=np.uint32) for _ in range(2))
        p32_cases.append((name, pl, lhs, rhs))
    mid = prime32.Plan.new(4096, BENCH_PRIMES["lt30"])
    mid_ops = tuple(rng.integers(0, mid.p, (B32, 4096), dtype=np.uint32) for _ in range(2))
    small = prime32.Plan.new(1024, 1073479681)
    small_ops = tuple(rng.integers(0, small.p, (B32, 1024), dtype=np.uint32) for _ in range(2))

    f1, f2 = PRIMES[0], PRIMES[1]
    p2 = PRIMES[:2]
    pplan = product.Plan.new(N_PROD, f1 * f2, (f1, f2))
    m = pplan.modulus
    pa, pb, pacc = (rand_mod(rng, m, (B_PROD, N_PROD)) for _ in range(3))
    px = centred(rng, m, (B_PROD, N_PROD))
    keys = [rand_mod(rng, m, (B_PROD, N_PROD)) for _ in range(PBS_TERMS)]
    digits = [centred(rng, m, (B_PROD, N_PROD)) for _ in range(PBS_TERMS)]
    pre = [pplan.normalize(pplan.fwd(card(k))) for k in keys]  # preloaded NTT-domain operands
    d_pa, d_pb, d_pacc, d_px = map(card, (pa, pb, pacc, px))
    d_digits = [card(d) for d in digits]
    bnd = product.bounded(BOUND)
    acc = product.ACCUMULATE

    def pbs_loop(plan_, digits_, pre_, standard):
        """One Bounded fwd and one mul_accumulate a term, one inv(ACCUMULATE)."""
        dom = product.NttDomain(torch.zeros((2, *digits_[0].shape[:-1]), dtype=torch.uint32,
                                            device=digits_[0].device))
        for d, key in zip(digits_, pre_):
            dom = plan_.mul_accumulate(dom, plan_.fwd(d, bnd), key)
        return plan_.inv(dom, mode=acc, standard=standard)

    p64_cases = []
    for rname, p in PRIMES64.items():
        pl = prime64.Plan.new(N64, p)
        lhs, rhs = (rand_mod(rng, p, (B64, N64)) for _ in range(2))
        p64_cases.append((rname, pl, lhs, rhs))
    plan52 = native64.Plan52.try_new(N64)
    ops52 = [tuple(rng.integers(0, 1 << 64, (B52, N64), dtype=np.uint64) for _ in range(2))
             for _ in range(2)]
    card52 = [tuple(tuple(t.to(dev) for t in planar(a)) for a in pair) for pair in ops52]
    hyb_cases = []
    for n in HYB_SIZES:
        for rname, p in HYB64.items():
            if n == 1 << 17 and rname not in HYB_BIG:
                continue
            pl = prime64.Plan.new(n, p)
            lhs, rhs = (rand_mod(rng, p, (B_HYB, n)) for _ in range(2))
            hyb_cases.append((rname, pl, lhs, rhs))

    # the channel-grid hybrid at its one system shape: Plan52's primes at 2^15
    n15 = N_HYB15
    plan52_15 = native64.Plan52.try_new(n15)
    a15, b15 = (rng.integers(0, 1 << 64, (B52, n15), dtype=np.uint64) for _ in range(2))
    l15, r15 = (tuple(t.to(dev) for t in planar(v)) for v in (a15, b15))
    sc15 = tuple(scale64(n15, q) for q in P52)

    def hybrid52_polymul(lhs, rhs):
        fl = stagesplit.fwd_multi_hybrid64(lhs, P52, n=n15)
        fr = stagesplit.fwd_multi_hybrid64(rhs, P52, n=n15)
        res = stagesplit.pointwise_inv_multi_hybrid64(fl, fr, P52, sc15, n=n15)
        return plan52_15._lift(res, (lhs[0].shape[0],), "planar")

    fam = []
    for mod, tier in NATIVE_PLANS:
        pl = getattr(getattr(port, mod), tier).try_new(N_MAIN)
        binary = "binary" in mod
        fam.append((f"{mod}.{tier}", pl, binary, limbs_np(pl.width, (B_MAIN, N_MAIN)),
                    limbs_np(pl.width, (B_MAIN, N_MAIN), binary)))
    perch = []
    for mod, tier in PERCHANNEL_PLANS:
        pl = getattr(getattr(port, mod), tier).try_new(N_PERCH)
        perch.append((f"{mod}.{tier}", pl, limbs_np(pl.width, (B_MAIN, N_PERCH)),
                      limbs_np(pl.width, (B_MAIN, N_PERCH), "binary" in mod)))
    big_fam = []
    for mod, n in (("native128", N16), ("native64", N16), ("native64", N17)):
        pl = getattr(port, mod).Plan32.try_new(n)
        big_fam.append((f"{mod}.Plan32", n, pl, limbs_np(pl.width, (B_BIG, n)),
                        limbs_np(pl.width, (B_BIG, n))))
    big32 = [(rname, prime32.Plan.new(N16, p)) for rname, p in BIG32.items()]
    big32.append(("lt30", prime32.Plan.new(N17, BIG32["lt30"])))
    big32 = [(rname, pl, *(rng.integers(0, pl.p, (B32, pl.n), dtype=np.uint32) for _ in range(2)))
             for rname, pl in big32]
    pplan16 = product.Plan.new(N16, EXT[0] * EXT[1], EXT[:2])
    m16 = pplan16.modulus
    qa, qb, qacc = (rand_mod(rng, m16, (B_BIG, N16)) for _ in range(3))
    qx = centred(rng, m16, (B_BIG, N16))
    d_qa, d_qb, d_qacc, d_qx = map(card, (qa, qb, qacc, qx))
    p5, p2e, p3e = EXT[:5], EXT[:2], EXT[:3]
    sc3 = tuple(scale32(N16, q) for q in p3e)
    tbl = mxu32._mxu_tables(N16, BIG32["lt30"])
    geo16 = dict(n1=tbl["n1"], n2=tbl["n2"])
    d16 = torch.from_numpy(np.stack(tbl["d"])).to(dev)

    def memory_line(when: str) -> None:
        """Device bytes held and their peak, beside the fill of the 32-bit table caches."""
        mib = lambda v: f"{v / 2**20:.0f} MiB"
        print(f"memory: {when}: allocated {mib(torch.cuda.memory_allocated())}, peak "
              f"{mib(torch.cuda.max_memory_allocated())}, reserved "
              f"{mib(torch.cuda.memory_reserved())}; mxu32_cuda._kernel_tables "
              f"{mxu32_cuda._kernel_tables.cache_info()}, _hyb_tables "
              f"{mxu32_cuda._hyb_tables.cache_info()} | {smi}", flush=True)

    # -- 4b. sharded: the slice's paths in worlds of rank processes -------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:  # the worlds' FileStores
        try:
            gloo = _dist.spawn(sharded_rank, RANKS, os.path.join(tmp, "gloo"), (args.seed, True),
                               backend="gloo", timeout=SHARDED_TIMEOUT)
            nccl = _dist.spawn(sharded_rank, 1, os.path.join(tmp, "nccl"), (args.seed, False),
                               backend="nccl", timeout=SHARDED_TIMEOUT)
        except RuntimeError as e:
            raise PhaseError(f"sharded: {e}") from e
    t_worlds = time.perf_counter() - t0
    sh_in = sharded_inputs(args.seed)
    single = {  # the single-card plans on the same operands (K1a-u128 / K1b, K1a / K1b, K7a / K7d)
        "native128": port.native128.Plan32.try_new(N_SH128).negacyclic_polymul(
            *(torch.from_numpy(v).to(dev) for v in sh_in["native128"])).cpu().numpy(),
        "native64": native64.Plan32.try_new(N_SH64).negacyclic_polymul(*sh_in["native64"]),
        "plan52": native64.Plan52.try_new(N_SH64).negacyclic_polymul(*sh_in["plan52"]),
    }
    what = {"native128": "native128.Plan32(2^16) through ChannelShardedNative",
            "native64": "native64.Plan32(2^14) through make_sharded_prime32_mxu x5 channels",
            "plan52": "native64.Plan52(2^14) through ChannelShardedNative52"}
    for name, want in single.items():
        for world, ranks in (("gloo", gloo), ("nccl", nccl)):
            require(np.array_equal(ranks[0][name]["out"], want),
                    f"sharded: {what[name]}, {world} rank 0 differs from the single-card plan")
        print(f"sharded: {what[name]} B={B_SH} at (dp, ch, sp) = {SHARDED_MESHES[name]} over "
              f"{RANKS} gloo rank processes on {kind}: rank 0 == the single-card plan, every "
              f"rank == the CPU plain path of the sharded module; launches a rank "
              f"{gloo[0][name]['launches']} (each rank's as predicted); one sharded polymul "
              f"{gloo[0][name]['ms']:.4f} ms (rank 0, host clock barrier to barrier, mean of "
              f"{SHARDED_REPS}; {RANKS} ranks share one card: not a scaling figure); NCCL world of 1: == the single-card plan, launches "
              f"{nccl[0][name]['launches']}, {nccl[0][name]['ms']:.4f} ms | {smi}", flush=True)
        prof = nccl[0][name]["profile"]
        print(f"sharded: {what[name]}, NCCL world of 1, rank 0 under torch.profiler: host clock "
              f"{prof['host_ms']:.4f} ms, device busy {prof['busy_ms']:.4f} ms "
              f"({100 * prof['busy_share']:.1f} %), GEMM passes {prof['kernel_ms']:.4f} ms, "
              f"{prof['device_events']:.0f} device events and {prof['aten_ops']:.0f} aten ops a "
              f"polymul (3 polymuls) | {smi}", flush=True)
    launches["pass_matmod_multi_u128"] = sum(
        r["native128"]["launches"]["pass_matmod_multi_u128"] for r in gloo)
    launches["pass_matmod_multi"] = sum(r[k]["launches"]["pass_matmod_multi"] for r in gloo
                                        for k in ("native128", "native64"))
    launches["pass_matmod64_multi"] = sum(r["plan52"]["launches"]["pass_matmod64_multi"]
                                          for r in gloo)
    print(f"sharded: worlds of {RANKS} (gloo) and 1 (NCCL) in {t_worlds:.1f} s; K3 / K6 "
          f"channel-grid launches over the gloo ranks: pass_matmod_multi_u128 "
          f"{launches['pass_matmod_multi_u128']}, pass_matmod_multi "
          f"{launches['pass_matmod_multi']}, pass_matmod64_multi "
          f"{launches['pass_matmod64_multi']}", flush=True)

    memory_line("after the main paths")

    # one rank's channel-grid passes at the sharded routes' shapes (the gloo
    # world's ranks): (path, transform size, a launch's channels, s, A-pass
    # limbs, row, four-steps a polymul); native64 runs one four-step a channel
    GRID_PATHS = (("native128", N_SH128, EXT[:5], 2, 4, "pass_matmod_multi", 1),
                  ("native64", N_SH64, PRIMES[:1], 2, 1, "pass_matmod_multi", len(PRIMES)),
                  ("plan52", N_SH64, P52, 2, 1, "pass_matmod64_multi", 1))

    def grid_case(path: str, which: str) -> tuple:
        """(JSON row, label, kernel call, plain call, (int8 MACs, bytes), int8
        pairs of the same digit GEMMs: one a channel) of one pass of a rank of
        `path` on random operands laid out as the route lays them. Bytes: the
        operand (once where the channels share it), the outputs, each
        channel's planes, cvec and diagonal rows once."""
        _, n, primes, s, limbs, row, _ = next(g for g in GRID_PATHS if g[0] == path)
        b = B_SH // SHARDED_MESHES[path][0]
        wide = row == "pass_matmod64_multi"
        x, rows = next((x, r) for w, x, r in gate().route_passes(u32, n, b, s, len(primes), limbs,
                                                           pair=wide) if w == which)
        nl = len(x)
        scales = (tuple((scale64 if wide else scale32)(n, q) for q in primes)
                  if which == "Ainv" else None)
        mats = [mxu64.pass_mat(n, q, which, sc) if wide else
                mxu32_cuda._pass_mat(n, q, which, nl, sc % q)
                for q, sc in zip(primes, scales or (1,) * len(primes))]
        mod = mxu64_cuda if wide else mxu32_cuda
        kw = dict(n=n, primes=primes, which=which, scales=scales, transposed_out=which == "Ainv",
                  diag=mod.multi_diag(n, primes, which, *rows, str(dev)) if rows else None)
        xx = x if wide or nl > 1 else x[0]
        call = mod.pass_matmod64_multi if wide else mod.pass_matmod_multi
        plain = mod.pass_matmod64_multi_plain if wide else mod.pass_matmod_multi_plain
        r_all, k = b * x[0].shape[-2], x[0].shape[-1]
        e_k, d_o = mats[0][0].shape
        word = 8 if wide else 4
        nbytes = (word * r_all * k * (1 if wide else nl) * (1 if x[0].dim() == 3 else len(primes))
                  + word * len(primes) * r_all * mats[0][1].shape[1]
                  + sum(m[0].nbytes + m[1].nbytes for m in mats)
                  + (kw["diag"].numel() * 4 if rows else 0))
        pairs = lambda: [
            (torch.randint(-128, 128, (r_all, e_k), dtype=torch.int8, device=dev),
             torch.randint(-128, 128, (d_o, e_k), dtype=torch.int8, device=dev).t())
            for _ in primes]
        key = "pass_matmod_multi_u128" if which == "A" and limbs == 4 else row
        label = (f"{path} {which}{' x4 limbs' if key.endswith('u128') else ''} n={n} "
                 f"C={len(primes)} [{b}, {x[0].shape[-2]}, {k}] s={s}")
        return (key, label, lambda: call(xx, **kw), lambda: plain(xx, **kw),
                (len(primes) * r_all * e_k * d_o, nbytes), pairs)

    # -- 5. times -----------------------------------------------------------------
    ms, plain_ms = {}, {}
    row_calls, row_calls17 = {}, {}  # JSON row -> the kernel call it times
    limbs = (u32((B_MAIN, N_MAIN)), u32((B_MAIN, N_MAIN)))
    x = u32((len(PRIMES), B_MAIN, N_MAIN))
    scaled = tuple(pow(N_MAIN, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
    ms["fwd_wide_multi"] = median_ms(lambda: mxu32_cuda.fwd_wide_multi(limbs, PRIMES))
    ms["inv_multi"] = median_ms(lambda: mxu32_cuda.inv_multi(x, PRIMES, scaled))
    plain_ms["fwd_wide_multi"] = median_ms(
        lambda: mxu32_cuda.fwd_wide_multi_plain(limbs, PRIMES))
    plain_ms["inv_multi"] = median_ms(lambda: mxu32_cuda.inv_multi_plain(x, PRIMES, scaled))
    lift_res = torch.stack([u32((B_MAIN, N_MAIN), p) for p in PRIMES])
    ms["lift_u64_from5"] = median_ms(lambda: crt_cuda.rec_u64_from5(lift_res, PRIMES))
    plain_ms["lift_u64_from5"] = median_ms(lambda: crt_cuda.rec_u64_from5_plain(lift_res, PRIMES))
    print(f"times: lift_u64_from5 n={N_MAIN} B={B_MAIN}: kernel {ms['lift_u64_from5']:.4f} ms, "
          f"plain {plain_ms['lift_u64_from5']:.4f} ms (median of {REPS}) | {smi}", flush=True)
    lift128_res = torch.stack([u32((B_MAIN, N_MAIN), p) for p in NATIVE128_PRIMES])
    ms["lift_u128_from10"] = median_ms(
        lambda: crt_cuda.rec_u128_from10(lift128_res, NATIVE128_PRIMES))
    plain_ms["lift_u128_from10"] = median_ms(
        lambda: crt_cuda.rec_u128_from10_plain(lift128_res, NATIVE128_PRIMES))
    print(f"times: lift_u128_from10 n={N_MAIN} B={B_MAIN}: kernels {ms['lift_u128_from10']:.4f} "
          f"ms, plain {plain_ms['lift_u128_from10']:.4f} ms (median of {REPS}) | {smi}",
          flush=True)
    pw_r = u32((len(PRIMES), B_MAIN, N_MAIN))
    ms["pointwise_mont32"] = median_ms(lambda: pointwise_cuda.mont_mul32(x, pw_r, PRIMES))
    plain_ms["pointwise_mont32"] = median_ms(
        lambda: pointwise_cuda.mont_mul32_plain(x, pw_r, PRIMES))
    print(f"times: pointwise_mont32 n={N_MAIN} B={B_MAIN} C={len(PRIMES)}: kernel "
          f"{ms['pointwise_mont32']:.4f} ms, plain {plain_ms['pointwise_mont32']:.4f} ms (median "
          f"of {REPS}) | {smi}", flush=True)
    # the GEMM rows' device time (the pass launches of a call) beside
    # torch._int_mm on int8 matrices of the same passes' shapes
    dev_ms, int_mm_ms = {}, {}
    dev_tasks = []  # read in one profiler session after the times (device_times)
    dev_into = {}   # id -> the dict a task's result goes to

    def dev_times(key, kernel, per_call, pairs, into=(dev_ms, int_mm_ms)):
        """Queue the GEMM row `key`: its kernel's pass launches and
        torch._int_mm over int8 pairs of the same passes' shapes."""
        kernel, pairs = bind_now(kernel), bind_now(pairs)

        def gemm():
            mats = pairs()
            return (lambda: [torch._int_mm(a, p) for a, p in mats]), is_kernel

        for d in into:
            dev_into[id(d)] = d
        dev_tasks.append(((id(into[0]), key), lambda: (kernel, is_pass), per_call))
        dev_tasks.append(((id(into[1]), key), gemm, None))

    n1m, n2m = mxu32.four_step_factors(N_MAIN)
    dev_times("fwd_wide_multi", lambda: mxu32_cuda.fwd_wide_multi(limbs, PRIMES), 2,
              lambda: gemm_pairs(dev, "fwd", n1m, n2m, B_MAIN, len(PRIMES), 8))
    dev_times("inv_multi", lambda: mxu32_cuda.inv_multi(x, PRIMES, scaled), 2,
              lambda: gemm_pairs(dev, "inv", n1m, n2m, B_MAIN, len(PRIMES), 4))
    lhs, rhs = on_card[0]
    poly_ms = median_ms(lambda: plan.negacyclic_polymul(lhs, rhs))
    shape = {"fwd_wide_multi": "2 limbs", "inv_multi": "scaled"}
    for k in ("fwd_wide_multi", "inv_multi"):
        print(f"times: {k} n={N_MAIN} B={B_MAIN} {shape[k]}: kernel {ms[k]:.4f} ms, "
              f"plain {plain_ms[k]:.4f} ms (median of {REPS}) | {smi}", flush=True)
    print(f"times: native64 polymul n={N_MAIN} B={B_MAIN} planar: {poly_ms:.4f} ms (median of "
          f"{REPS}) = {B_MAIN / poly_ms * 1e3:.1f} products/s | {smi}", flush=True)

    def timed(name, label, kernel, plain, key=None, gemm=None):
        """`gemm` = (pass launches a call, the int8 pairs of its passes) for
        a GEMM row: its device time and torch._int_mm's."""
        t, tp = median_ms(kernel), median_ms(plain)
        if key:
            ms[key], plain_ms[key] = t, tp
            row_calls[key] = bind_now(kernel)
        print(f"times: {name} {label}: kernel {t:.4f} ms, plain {tp:.4f} ms "
              f"(median of {REPS}) | {smi}", flush=True)
        if key and gemm:
            dev_times(key, kernel, *gemm)

    for rname, p in BENCH_PRIMES.items():
        x = u32((B32, N32), p)
        headline = rname == "lt30"
        timed("K2 fwd", f"n={N32} B={B32} p={p} ({rname})",
              lambda: mxu32_cuda.fwd(x, n=N32, p=p), lambda: mxu32_cuda.fwd_plain(x, n=N32, p=p),
              "fwd" if headline else None,
              (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B32, 1, 4)))
        timed("K2 inv", f"n={N32} B={B32} p={p} ({rname})",
              lambda: mxu32_cuda.inv(x, n=N32, p=p), lambda: mxu32_cuda.inv_plain(x, n=N32, p=p),
              "inv" if headline else None,
              (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B32, 1, 4)))
    p = BENCH_PRIMES["lt30"]
    tbl = mxu32._mxu_tables(4096, p)
    dg = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])
    xa = u32((B32, tbl["n2"], tbl["n1"]))
    kw = dict(n=4096, p=p, which="A", diag_slices=dg)
    timed("K3 pass_matmod", f"A scaled n=4096 B={B32} p={p}",
          lambda: mxu32_cuda.pass_matmod(xa, **kw), lambda: mxu32_cuda.pass_matmod_plain(xa, **kw),
          "pass_matmod",
          (1, lambda: gemm_pairs(dev, "fwd", tbl["n1"], tbl["n2"], B32, 1, 4, passes=1)))
    # K3 / K6 on a rank's channel grid, each JSON row at one pass of a
    # sharded route (the rank-local rows below time every pass): native128's
    # F over five channels and its A with four limbs, Plan52's A over three
    grid_work = {}
    for path, which in (("native128", "F"), ("native128", "A"), ("plan52", "A")):
        key, label, kernel, plain, work_g, pairs = grid_case(path, which)
        grid_work[key] = work_g
        timed(f"K3 / K6 {key}", label, kernel, plain, key, (1, pairs))
    x = u32((B32, 4096), p)
    timed("K2 fwd (passes_engine)", f"n=4096 B={B32} p={p}",
          lambda: mxu32_cuda.passes_engine.fwd(x, n=4096, p=p),
          lambda: mxu32_cuda.fwd_plain(x, n=4096, p=p))
    # K4 at the headline (1024, 16), at (2^14, 16) and (2^16, 16) with a
    # prime below 2^26 (clusters of 8 blocks); each row's device time (its
    # ntt_k4 launch) from the profiler session
    k4_dev, k4_rows, k4_polymul = {}, {}, {}
    dev_into[id(k4_dev)] = k4_dev
    for n, p in ((1024, BENCH_PRIMES["lt30"]), (N32, SMALL_P), (N16, SMALL18)):
        pl = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=pl.variant, p_neginv=pl.p_neginv)
        x = u32((B32, n), p)
        k4_polymul[n] = lambda pl=pl, x=x: pl.negacyclic_polymul(x, x)
        for d, fn, plain in (("fwd", bcu.try_fwd, bcu.fwd_plain),
                             ("inv", bcu.try_inv, bcu.inv_plain)):
            key = f"butterfly32_{d}"
            kernel = bind_now(lambda fn=fn: fn(x, pl._tbl, **kw))
            t = median_ms(kernel)
            tp = median_ms(lambda plain=plain: plain(x, pl._tbl, **kw), reps=5, warmup=1)
            if n == 1024:
                ms[key], plain_ms[key] = t, tp
            k4_rows[(key, n)] = (f"n={n} B={B32} p={p} c={bcu.cluster_size(n, B32)}", t, tp)
            dev_tasks.append(((id(k4_dev), (key, n)), lambda kernel=kernel: (kernel, is_k4), 1))
            print(f"times: K4 {d} n={n} B={B32} p={p} ({bcu.cluster_size(n, B32)} blocks a "
                  f"polynomial): kernel {t:.4f} ms, plain {tp:.4f} ms (median of {REPS}; plain "
                  f"of 5) | {smi}", flush=True)
    for name, pl, lhs, rhs in p32_cases:
        a, b = host(lhs).to(dev), host(rhs).to(dev)
        t = median_ms(lambda: pl.negacyclic_polymul(a, b))
        print(f"times: prime32 polymul n={N32} B={B32} p={pl.p} ({name}): {t:.4f} ms (median "
              f"of {REPS}) = {B32 / t * 1e3:.1f} products/s | {smi}", flush=True)

    xs = (u32((2, B_PROD, N_PROD)), u32((2, B_PROD, N_PROD)))
    sc2 = tuple(pow(N_PROD, p - 2, p) * pow(2, 32, p) % p for p in p2)
    timed("K1c fwd_multi_perchannel", f"n={N_PROD} B={B_PROD} C=2 1 limb",
          lambda: mxu32_cuda.fwd_multi_perchannel(xs[0], p2),
          lambda: mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], p2), "fwd_multi_perchannel",
          (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B_PROD, 2, 4)))
    timed("K1d pointwise_inv_multi", f"n={N_PROD} B={B_PROD} C=2 scaled",
          lambda: mxu32_cuda.pointwise_inv_multi(*xs, p2, sc2),
          lambda: mxu32_cuda.pointwise_inv_multi_plain(*xs, p2, sc2), "pointwise_inv_multi",
          (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B_PROD, 2, 4)))

    def mont_then_k1b():
        a, b = to_i64(xs[0]), to_i64(xs[1])
        prod = torch.stack([mont_mul(a[c], b[c], p, mont_neginv(p)) for c, p in enumerate(p2)])
        return mxu32_cuda.inv_multi(to_u32(prod), p2, sc2)

    t_fused, t_split = median_ms(lambda: mxu32_cuda.pointwise_inv_multi(*xs, p2, sc2)), \
        median_ms(mont_then_k1b)
    print(f"times: K1d vs plain mont_mul + K1b n={N_PROD} B={B_PROD} C=2: K1d {t_fused:.4f} ms, "
          f"mont_mul + K1b {t_split:.4f} ms (median of {REPS}) | {smi}", flush=True)
    prod_calls = {
        "Replace": lambda: pplan.negacyclic_polymul(d_pa, d_pb),
        "Accumulate": lambda: pplan.negacyclic_polymul(d_pa, d_pb, mode=acc, standard=d_pacc),
        "Bounded": lambda: pplan.negacyclic_polymul(d_px, d_pb, mode=acc, standard=d_pacc,
                                                    lhs_fwd_mode=bnd),
    }
    for what, fn in prod_calls.items():
        t = median_ms(fn)
        print(f"times: product polymul {what} n={N_PROD} B={B_PROD} ({f1}·{f2}): {t:.4f} ms "
              f"(median of {REPS}) = {B_PROD / t * 1e3:.1f} products/s | {smi}", flush=True)
    t = median_ms(lambda: pbs_loop(pplan, d_digits, pre, d_pacc), reps=5, warmup=1)
    print(f"times: PBS loop n={N_PROD} B={B_PROD} {PBS_TERMS} terms: {t:.4f} ms (median of 5) "
          f"= {t / PBS_TERMS:.4f} ms a term | {smi}", flush=True)

    # the 64-bit rows (kernels of csrc/matmod64_pass.cuh) at their JSON shapes,
    # with their device time and torch._int_mm's; the other regimes beside them
    for key, name, label, kernel, plain, per_call, pairs in gemm64_rows(dev, u32):
        timed(name, label, kernel, plain, key, (per_call, pairs))
    for rname, p in PRIMES64.items():
        if rname == "goldilocks":  # the fwd64 / inv64 rows
            continue
        x = (u32((B64, N64)), u32((B64, N64)))
        sc = scale64(N64, p)
        timed("K5 fwd64", f"n={N64} B={B64} p={p} ({rname})",
              lambda: mxu64_cuda.fwd(x, n=N64, p=p), lambda: mxu64_cuda.fwd_plain(x, n=N64, p=p))
        timed("K5 inv64", f"n={N64} B={B64} p={p} ({rname}) scaled",
              lambda: mxu64_cuda.inv(x, n=N64, p=p, scale=sc),
              lambda: mxu64_cuda.inv_plain(x, n=N64, p=p, scale=sc))
    fl52, fr52 = ((u32((3, B52, N64)), u32((3, B52, N64))) for _ in range(2))
    sc52 = tuple(scale64(N64, q) for q in P52)

    def mont64_then_k5():
        a, b = tuple(map(to_i64, fl52)), tuple(map(to_i64, fr52))
        outs = []
        for c, q in enumerate(P52):
            prod = mont_mul64((a[0][c], a[1][c]), (b[0][c], b[1][c]), q, mont_neginv64(q))
            outs.append(mxu64_cuda.inv(tuple(to_u32(t) for t in prod), n=N64, p=q, scale=sc52[c]))
        return outs

    t_fused = median_ms(lambda: mxu64_cuda.pointwise_inv_multi(fl52, fr52, P52, sc52))
    t_split = median_ms(mont64_then_k5)
    print(f"times: K7d vs plain mont_mul64 + 3 x K5 inv n={N64} B={B52} C=3: K7d {t_fused:.4f} "
          f"ms, mont_mul64 + K5 {t_split:.4f} ms (median of {REPS}) | {smi}", flush=True)
    for rname, pl, lhs, rhs in p64_cases:
        a, b = card(lhs), card(rhs)
        t = median_ms(lambda: pl.negacyclic_polymul(a, b))
        print(f"times: prime64 polymul n={N64} B={B64} p={pl.p} ({rname}): {t:.4f} ms (median "
              f"of {REPS}) = {B64 / t * 1e3:.1f} products/s | {smi}", flush=True)
    lhs52, rhs52 = card52[0]
    for name, pl in (("Plan52", plan52), ("Plan32", plan), ("Plan52", plan52), ("Plan32", plan)):
        t = median_ms(lambda: pl.negacyclic_polymul(lhs52, rhs52))
        print(f"times: native64 {name} polymul n={N64} B={B52} planar: {t:.4f} ms (median of "
              f"{REPS}) = {B52 / t * 1e3:.1f} products/s | {smi}", flush=True)

    # the hybrid: K5 with block tables at 2^16 / 2^17, K7b / K7c, K7 with block tables
    for n in HYB_SIZES:
        for rname in (HYB64 if n == 1 << 16 else HYB_BIG):
            p = HYB64[rname]
            x = (u32((B_HYB, n)), u32((B_HYB, n)))
            sc = scale64(n, p)
            kw = dict(n=n, p=p, n_h=N_H)
            if n == 1 << 16 and rname == "goldilocks":  # the fwd64_hyb / inv64_hyb rows
                continue
            timed("K5h fwd64_hyb", f"n={n} B={B_HYB} p={p} ({rname})",
                  lambda: mxu64_cuda.fwd_hyb(x, **kw), lambda: mxu64_cuda.fwd_hyb_plain(x, **kw))
            timed("K5h inv64_hyb", f"n={n} B={B_HYB} p={p} ({rname}) scaled",
                  lambda: mxu64_cuda.inv_hyb(x, scale=sc, **kw),
                  lambda: mxu64_cuda.inv_hyb_plain(x, scale=sc, **kw))

    # the direct kernel beside the hybrid at 2^15, in turns (direct, hybrid, hybrid, direct)
    def split_times(n, p, x, sc):
        """(prefix stages, K5h fwd, K5h inv scaled, suffix stages) ms of the hybrid."""
        dv = stagesplit._dev64(n, p, N_H)
        canon = mxu64_cuda.inv_hyb(x, n=n, p=p, n_h=N_H, scale=sc)
        return (median_ms(lambda: stagesplit._pair_u32(
                    stagesplit._prefix64(stagesplit._carriers(x), dv))),
                median_ms(lambda: mxu64_cuda.fwd_hyb(x, n=n, p=p, n_h=N_H)),
                median_ms(lambda: mxu64_cuda.inv_hyb(x, n=n, p=p, n_h=N_H, scale=sc)),
                median_ms(lambda: stagesplit._pair_u32(
                    stagesplit._suffix64(stagesplit._carriers(canon), dv))))

    for rname in HYB_BIG:
        p, n = HYB64[rname], N_HYB15
        x = (u32((B_HYB, n)), u32((B_HYB, n)))
        sc = scale64(n, p)
        runs = {"fwd": (lambda: mxu64_cuda.fwd(x, n=n, p=p),
                        lambda: stagesplit.fwd64_fused(x, n=n, p=p)),
                "inv scaled": (lambda: mxu64_cuda.inv(x, n=n, p=p, scale=sc),
                               lambda: stagesplit.inv64_fused(x, n=n, p=p, scale=sc))}
        for what, (direct, hybrid) in runs.items():
            t = [median_ms(fn) for fn in (direct, hybrid, hybrid, direct)]
            print(f"times: K5 direct vs hybrid {what} n={n} B={B_HYB} p={p} ({rname}): direct "
                  f"{t[0]:.4f} / {t[3]:.4f} ms, hybrid {t[1]:.4f} / {t[2]:.4f} ms (median of "
                  f"{REPS}, in turns) | {smi}", flush=True)
        pre, kf, ki, suf = split_times(n, p, x, sc)
        print(f"times: hybrid split n={n} B={B_HYB} p={p} ({rname}): prefix stage {pre:.4f} ms, "
              f"K5h fwd {kf:.4f} ms, K5h inv {ki:.4f} ms, suffix stage {suf:.4f} ms | {smi}",
              flush=True)
    t = [median_ms(fn) for fn in (
        lambda: plan52_15.negacyclic_polymul(l15, r15), lambda: hybrid52_polymul(l15, r15),
        lambda: hybrid52_polymul(l15, r15), lambda: plan52_15.negacyclic_polymul(l15, r15))]
    print(f"times: Plan52 polymul n={n15} B={B52} planar, direct (K7a x2 + K7d) vs channel-grid "
          f"hybrid: direct {t[0]:.4f} / {t[3]:.4f} ms, hybrid {t[1]:.4f} / {t[2]:.4f} ms (median "
          f"of {REPS}, in turns) | {smi}", flush=True)
    for rname, pl, lhs, rhs in hyb_cases:
        a, b = card(lhs), card(rhs)
        tf, ti = median_ms(lambda: pl.fwd(a)), median_ms(lambda: pl.inv(a))
        t = median_ms(lambda: pl.negacyclic_polymul(a, b))
        print(f"times: prime64 hybrid n={pl.n} B={B_HYB} p={pl.p} ({rname}): fwd {tf:.4f} ms = "
              f"{B_HYB / tf * 1e3:.1f} transforms/s, inv {ti:.4f} ms = {B_HYB / ti * 1e3:.1f} "
              f"transforms/s, polymul {t:.4f} ms = {B_HYB / t * 1e3:.1f} products/s (median of "
              f"{REPS}) | {smi}", flush=True)

    # the u128 operand: K1a over 10 and 5 channels, K1b over 10, K2 / K3 with four limbs
    w4 = tuple(u32((B_MAIN, N_MAIN)) for _ in range(4))
    for ch in (10, 5):
        pr = NATIVE128_PRIMES[:ch]
        timed("K1a fwd_wide_multi", f"n={N_MAIN} B={B_MAIN} C={ch} 4 limbs",
              lambda: mxu32_cuda.fwd_wide_multi(w4, pr),
              lambda: mxu32_cuda.fwd_wide_multi_plain(w4, pr),
              "fwd_wide_multi_u128" if ch == 10 else None,
              (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B_MAIN, ch, 16)))
    x10 = u32((10, B_MAIN, N_MAIN))
    sc10 = tuple(pow(N_MAIN, p - 2, p) * pow(2, 32, p) % p for p in NATIVE128_PRIMES)
    timed("K1b inv_multi", f"n={N_MAIN} B={B_MAIN} C=10 scaled",
          lambda: mxu32_cuda.inv_multi(x10, NATIVE128_PRIMES, sc10),
          lambda: mxu32_cuda.inv_multi_plain(x10, NATIVE128_PRIMES, sc10))
    p = BENCH_PRIMES["lt30"]
    w4k2 = tuple(u32((B32, N32)) for _ in range(4))
    timed("K2 fwd_wide", f"n={N32} B={B32} p={p} 4 limbs",
          lambda: mxu32_cuda.fwd_wide(w4k2, n=N32, p=p),
          lambda: mxu32_cuda.fwd_wide_plain(w4k2, n=N32, p=p), "fwd_u128",
          (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B32, 1, 16)))
    tbl = mxu32._mxu_tables(4096, p)
    w4k3 = tuple(u32((B32, tbl["n2"], tbl["n1"])) for _ in range(4))
    kw = dict(n=4096, p=p, which="A", n_limbs=4,
              diag_slices=tuple(torch.from_numpy(a).to(dev) for a in tbl["d"]))
    timed("K3 pass_matmod", f"A scaled n=4096 B={B32} p={p} 4 limbs",
          lambda: mxu32_cuda.pass_matmod(w4k3, **kw),
          lambda: mxu32_cuda.pass_matmod_plain(w4k3, **kw), "pass_matmod_u128",
          (1, lambda: gemm_pairs(dev, "fwd", tbl["n1"], tbl["n2"], B32, 1, 16, passes=1)))
    fam_calls = {}
    for name, pl, binary, a, b in fam:
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        fam_calls[name] = (lambda pl=pl, la=la, lb=lb: pl.negacyclic_polymul(la, lb))
        t = median_ms(fam_calls[name])
        print(f"times: {name} polymul n={N_MAIN} B={B_MAIN} "
              f"{'planar' if pl.width > 32 else 'u32'}: {t:.4f} ms (median of {REPS}) = "
              f"{B_MAIN / t * 1e3:.1f} products/s | {smi}", flush=True)
    for name, pl, a, b in perch:
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        t = median_ms(lambda: pl.negacyclic_polymul(la, lb), reps=5, warmup=1)
        print(f"times: {name} polymul n={N_PERCH} B={B_MAIN} (per-channel route): {t:.4f} ms "
              f"(median of 5) = {B_MAIN / t * 1e3:.1f} products/s | {smi}", flush=True)

    # n = 2^16 and 2^17: the direct kernels at their main-path shapes (the JSON
    # line's n17 fields), then the block-table variants, K1e and K5 with four limbs
    big_ms, big_dev, big_int_mm = {}, {}, {}
    nb1, nb2 = mxu32.four_step_factors(N16)

    def timed_big(key, name, label, kernel, plain, gemm=None):
        t, tp = median_ms(kernel), median_ms(plain, reps=5, warmup=1)
        big_ms[key] = (label, t, tp)
        row_calls17[key] = bind_now(kernel)
        print(f"times: {name} {label}: kernel {t:.4f} ms, plain {tp:.4f} ms (median of {REPS}; "
              f"plain of 5) | {smi}", flush=True)
        if gemm:
            dev_times(key, kernel, *gemm, into=(big_dev, big_int_mm))

    w4b = tuple(u32((B_BIG, N16)) for _ in range(4))
    x10b = u32((10, B_BIG, N16))
    sc10b = tuple(scale32(N16, q) for q in EXT)
    timed_big("fwd_wide_multi", "K1a fwd_wide_multi", f"n={N16} B={B_BIG} C=5 2 limbs",
              lambda: mxu32_cuda.fwd_wide_multi(w4b[:2], p5),
              lambda: mxu32_cuda.fwd_wide_multi_plain(w4b[:2], p5),
              (2, lambda: gemm_pairs(dev, "fwd", nb1, nb2, B_BIG, 5, 8)))
    timed_big("fwd_wide_multi_u128", "K1a fwd_wide_multi", f"n={N16} B={B_BIG} C=10 4 limbs",
              lambda: mxu32_cuda.fwd_wide_multi(w4b, EXT),
              lambda: mxu32_cuda.fwd_wide_multi_plain(w4b, EXT),
              (2, lambda: gemm_pairs(dev, "fwd", nb1, nb2, B_BIG, 10, 16)))
    timed_big("inv_multi", "K1b inv_multi", f"n={N16} B={B_BIG} C=10 scaled",
              lambda: mxu32_cuda.inv_multi(x10b, EXT, sc10b),
              lambda: mxu32_cuda.inv_multi_plain(x10b, EXT, sc10b),
              (2, lambda: gemm_pairs(dev, "inv", nb1, nb2, B_BIG, 10, 4)))
    xs2b = (u32((2, B_BIG, N16)), u32((2, B_BIG, N16)))
    timed_big("fwd_multi_perchannel", "K1c fwd_multi_perchannel", f"n={N16} B={B_BIG} C=2 1 limb",
              lambda: mxu32_cuda.fwd_multi_perchannel(xs2b[0], p2e),
              lambda: mxu32_cuda.fwd_multi_perchannel_plain(xs2b[:1], p2e),
              (2, lambda: gemm_pairs(dev, "fwd", nb1, nb2, B_BIG, 2, 4)))
    timed_big("pointwise_inv_multi", "K1d pointwise_inv_multi", f"n={N16} B={B_BIG} C=2 scaled",
              lambda: mxu32_cuda.pointwise_inv_multi(*xs2b, p2e, sc10b[:2]),
              lambda: mxu32_cuda.pointwise_inv_multi_plain(*xs2b, p2e, sc10b[:2]),
              (2, lambda: gemm_pairs(dev, "inv", nb1, nb2, B_BIG, 2, 4)))
    for n, rnames in ((N16, tuple(BIG32)), (N17, ("lt30",))):
        for rname in rnames:
            p = BIG32[rname]
            x = u32((B32, n))
            s = scale32(n, p)
            headline = n == N16 and rname == "lt30"
            for key, name, kernel, plain in (
                    ("fwd", "K2 fwd", lambda: mxu32_cuda.fwd(x, n=n, p=p),
                     lambda: mxu32_cuda.fwd_plain(x, n=n, p=p)),
                    ("inv", "K2 inv scaled", lambda: mxu32_cuda.inv(x, n=n, p=p, scale=s),
                     lambda: mxu32_cuda.inv_plain(x, n=n, p=p, scale=s))):
                timed_big(key if headline else f"{key} {n} {rname}", name,
                          f"n={n} B={B32} p={p} ({rname})", kernel, plain,
                          (2, lambda: gemm_pairs(dev, key, nb1, nb2, B32, 1, 4)) if headline
                          else None)
    p = BIG32["lt30"]
    w4k2b = tuple(u32((B32, N16)) for _ in range(4))
    timed_big("fwd_u128", "K2 fwd_wide", f"n={N16} B={B32} p={p} 4 limbs",
              lambda: mxu32_cuda.fwd_wide(w4k2b, n=N16, p=p),
              lambda: mxu32_cuda.fwd_wide_plain(w4k2b, n=N16, p=p),
              (2, lambda: gemm_pairs(dev, "fwd", nb1, nb2, B32, 1, 16)))
    w4k3b = tuple(u32((B32, geo16["n2"], geo16["n1"])) for _ in range(4))
    kw = dict(n=N16, p=p, which="A", n_limbs=4, diag_slices=tuple(d16))
    timed_big("pass_matmod_u128", "K3 pass_matmod", f"A scaled n={N16} B={B32} p={p} 4 limbs",
              lambda: mxu32_cuda.pass_matmod(w4k3b, **kw),
              lambda: mxu32_cuda.pass_matmod_plain(w4k3b, **kw),
              (1, lambda: gemm_pairs(dev, "fwd", nb1, nb2, B32, 1, 16, passes=1)))

    xh16 = u32((B32, N16))
    kw = dict(n=N16, p=p, n_h=N_H)
    sh16 = scale32(N16, p)
    timed("K2h fwd_hyb", f"n={N16} n_h={N_H} B={B32} p={p} (lt30)",
          lambda: mxu32_cuda.fwd_hyb(xh16, **kw), lambda: mxu32_cuda.fwd_hyb_plain(xh16, **kw),
          "fwd_hyb", (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B32, 1, 4, nb=4)))
    timed("K2h inv_hyb", f"n={N16} n_h={N_H} B={B32} p={p} (lt30) scaled",
          lambda: mxu32_cuda.inv_hyb(xh16, scale=sh16, **kw),
          lambda: mxu32_cuda.inv_hyb_plain(xh16, scale=sh16, **kw), "inv_hyb",
          (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B32, 1, 4, nb=4)))
    x3b, y3b = u32((3, B_BIG, N16)), u32((3, B_BIG, N16))
    timed("K1c fwd_multi_perchannel with block tables", f"n={N16} n_h={N_H} B={B_BIG} C=3 1 limb",
          lambda: mxu32_cuda.fwd_multi_perchannel(x3b, p3e, n_h=N_H),
          lambda: mxu32_cuda.fwd_multi_perchannel_plain((x3b,), p3e, N_H),
          "fwd_multi_perchannel_hyb", (2, lambda: gemm_pairs(dev, "fwd", n1m, n2m, B_BIG, 3, 4, nb=4)))
    timed("K1b inv_multi with block tables", f"n={N16} n_h={N_H} B={B_BIG} C=3 scaled",
          lambda: mxu32_cuda.inv_multi(x3b, p3e, sc3, n_h=N_H),
          lambda: mxu32_cuda.inv_multi_plain(x3b, p3e, sc3, N_H), "inv_multi_hyb",
          (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B_BIG, 3, 4, nb=4)))
    timed("K1d pointwise_inv_multi with block tables", f"n={N16} n_h={N_H} B={B_BIG} C=3 scaled",
          lambda: mxu32_cuda.pointwise_inv_multi(x3b, y3b, p3e, sc3, n_h=N_H),
          lambda: mxu32_cuda.pointwise_inv_multi_plain(x3b, y3b, p3e, sc3, N_H),
          "pointwise_inv_multi_hyb", (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B_BIG, 3, 4, nb=4)))
    xe = u32((5, B_MAIN, N_MAIN))
    xde = mxu32_cuda.digit_planes32(xe)
    timed("K1e inv_multi_presplit", f"n={N_MAIN} B={B_MAIN} C=5 scaled",
          lambda: mxu32_cuda.inv_multi_presplit(xde, PRIMES, scaled),
          lambda: mxu32_cuda.inv_multi_presplit_plain(xde, PRIMES, scaled), "inv_multi_presplit",
          (2, lambda: gemm_pairs(dev, "inv", n1m, n2m, B_MAIN, 5, 4)))
    t_b, t_e, t_s = (median_ms(fn) for fn in (
        lambda: mxu32_cuda.inv_multi(xe, PRIMES, scaled),
        lambda: mxu32_cuda.inv_multi_presplit(xde, PRIMES, scaled),
        lambda: mxu32_cuda.digit_planes32(xe)))
    print(f"times: K1b vs K1e n={N_MAIN} B={B_MAIN} C=5: K1b {t_b:.4f} ms, K1e {t_e:.4f} ms, "
          f"digit_planes32 (plain torch) {t_s:.4f} ms (median of {REPS}) | {smi}", flush=True)
    # K1e beside K1b at (2^14, 8, 5) and (2^14, 16, 2), K2h at 2^16 and 2^17 at B = 16
    # and 1: device ms and torch._int_mm from the profiler session, bound
    # and bound share on the lines after it
    ext_dev, ext_int_mm, ext_rows = {}, {}, {}
    for c, b in ((5, B_MAIN), (2, 16)):
        pr, xk = PRIMES[:c], u32((c, b, N_MAIN))
        xdk = mxu32_cuda.digit_planes32(xk)
        sck = tuple(scale32(N_MAIN, q) for q in pr)
        work = fourstep_work("inv", b, n1m, n2m, c, 4, 4, 4, 1, 1, 4)
        for key, kernel in (
                (f"K1b n={N_MAIN} B={b} C={c} codes (0, 0)",
                 lambda xk=xk, pr=pr, sck=sck: mxu32_cuda.inv_multi(xk, pr, sck)),
                (f"K1e n={N_MAIN} B={b} C={c} codes {mxu32_cuda._k1e_tiles(b, N_MAIN, c)}",
                 lambda xdk=xdk, pr=pr, sck=sck: mxu32_cuda.inv_multi_presplit(xdk, pr, sck))):
            ext_rows[key] = (median_ms(kernel), work)
            dev_times(key, kernel, 2, lambda b=b, c=c: gemm_pairs(dev, "inv", n1m, n2m, b, c, 4),
                      into=(ext_dev, ext_int_mm))
    p = BIG32["lt30"]
    for n in (N16, N17):
        for b in (B32, 1):
            xk, sk = u32((b, n)), scale32(n, p)
            for d, kernel in (
                    ("fwd", lambda xk=xk, n=n: mxu32_cuda.fwd_hyb(xk, n=n, p=p, n_h=N_H)),
                    ("inv", lambda xk=xk, n=n, sk=sk: mxu32_cuda.inv_hyb(xk, n=n, p=p, n_h=N_H,
                                                                          scale=sk))):
                key = (f"K2h {d} n={n} n_h={N_H} B={b} p={p} (lt30) codes "
                       f"{mxu32_cuda.k2h_tiles(b, n, N_H, d)}")
                ext_rows[key] = (median_ms(kernel),
                                 hybrid_work(d, b, n1m, n2m, n // N_H, 1, 4, 4, 4, 4, limbs=1))
                dev_times(key, kernel, 2,
                          lambda b=b, d=d, n=n: gemm_pairs(dev, d, n1m, n2m, b, 1, 4,
                                                           nb=n // N_H),
                          into=(ext_dev, ext_int_mm))

    # the direct 32-bit kernels beside the 32-bit hybrid at 2^15, 2^16 and 2^17,
    # in turns (direct, hybrid, hybrid, direct); the route stays direct
    def in_turns(label, direct, hybrid):
        t = [median_ms(fn) for fn in (direct, hybrid, hybrid, direct)]
        print(f"times: direct vs 32-bit hybrid {label}: direct {t[0]:.4f} / {t[3]:.4f} ms, hybrid "
              f"{t[1]:.4f} / {t[2]:.4f} ms (median of {REPS}, in turns) | {smi}", flush=True)

    for n in (N_HYB15, N16, N17):
        for rname in ("lt30", "generic"):
            p = BIG32[rname]
            x = u32((B32, n))
            s = scale32(n, p)
            in_turns(f"K2 fwd n={n} B={B32} p={p} ({rname})",
                     lambda: mxu32_cuda.fwd(x, n=n, p=p),
                     lambda: stagesplit.engine32_fused.fwd(x, n=n, p=p))
            in_turns(f"K2 inv scaled n={n} B={B32} p={p} ({rname})",
                     lambda: mxu32_cuda.inv(x, n=n, p=p, scale=s),
                     lambda: stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s))
        dv = stagesplit._dev32(n, BIG32["lt30"], N_H)
        xi = to_i64(x)
        pre, suf = (median_ms(lambda: to_u32(stagesplit._prefix32(xi, dv))),
                    median_ms(lambda: to_u32(stagesplit._suffix32(xi % BIG32["lt30"], dv))))
        kf, ki = (median_ms(lambda: mxu32_cuda.fwd_hyb(x, n=n, p=BIG32["lt30"], n_h=N_H)),
                  median_ms(lambda: mxu32_cuda.inv_hyb(x, n=n, p=BIG32["lt30"], n_h=N_H)))
        print(f"times: 32-bit hybrid split n={n} B={B32} p={BIG32['lt30']} (lt30): prefix stages "
              f"{pre:.4f} ms, K2h fwd {kf:.4f} ms, K2h inv {ki:.4f} ms, suffix stages {suf:.4f} "
              f"ms | {smi}", flush=True)
        p3 = (PRIMES if n <= 1 << 15 else EXT)[:3]
        scs = tuple(scale32(n, q) for q in p3)
        lo_hi = (u32((B_BIG, n)), u32((B_BIG, n)))
        fl, fr = u32((3, B_BIG, n)), u32((3, B_BIG, n))
        in_turns(f"K1a fwd_wide_multi 2 limbs n={n} B={B_BIG} C=3",
                 lambda: mxu32_cuda.fwd_wide_multi(lo_hi, p3),
                 lambda: stagesplit.fwd_wide_multi_hybrid32(lo_hi, p3, n=n))
        in_turns(f"K1d pointwise_inv_multi n={n} B={B_BIG} C=3",
                 lambda: mxu32_cuda.pointwise_inv_multi(fl, fr, p3, scs),
                 lambda: stagesplit.pointwise_inv_multi_hybrid32(fl, fr, p3, scs, n=n))

    # the polymuls above 2^15
    big_calls = {}
    for name, n, pl, a, b in big_fam:
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        big_calls[f"{name}({n})"] = (lambda pl=pl, la=la, lb=lb: pl.negacyclic_polymul(la, lb))
        t = median_ms(big_calls[f"{name}({n})"], reps=10)
        print(f"times: {name} polymul n={n} B={B_BIG} planar: {t:.4f} ms (median of 10) = "
              f"{B_BIG / t * 1e3:.1f} products/s | {smi}", flush=True)
    for rname, pl, lhs, rhs in big32:
        a, b = host(lhs).to(dev), host(rhs).to(dev)
        big_calls[f"prime32.Plan({pl.n}, {rname})"] = (
            lambda pl=pl, a=a, b=b: pl.negacyclic_polymul(a, b))
        tf, ti = median_ms(lambda: pl.fwd(a)), median_ms(lambda: pl.inv(a))
        t = median_ms(lambda: pl.negacyclic_polymul(a, b))
        print(f"times: prime32 n={pl.n} B={B32} p={pl.p} ({rname}): fwd {tf:.4f} ms = "
              f"{B32 / tf * 1e3:.1f} transforms/s, inv {ti:.4f} ms = {B32 / ti * 1e3:.1f} "
              f"transforms/s, polymul {t:.4f} ms = {B32 / t * 1e3:.1f} products/s (median of "
              f"{REPS}) | {smi}", flush=True)
    for what, fn in (("Replace", lambda: pplan16.negacyclic_polymul(d_qa, d_qb)),
                     ("Bounded", lambda: pplan16.negacyclic_polymul(
                         d_qx, d_qb, mode=acc, standard=d_qacc, lhs_fwd_mode=bnd))):
        t = median_ms(fn)
        print(f"times: product polymul {what} n={N16} B={B_BIG} ({EXT[0]}·{EXT[1]}): {t:.4f} ms "
              f"(median of {REPS}) = {B_BIG / t * 1e3:.1f} products/s | {smi}", flush=True)

    # each JSON row's launches: its kernel's in one call of the public plan
    # whose route takes it at the row's shape, else in one call of what the
    # row times (the channel grids': the sharded phase's gloo ranks); the
    # counters zeroed just before each call
    card_args = lambda pair: tuple(card(v) for v in pair)
    gl_case = next(c for c in p64_cases if c[0] == "goldilocks")
    hyb_case = next(c for c in hyb_cases if c[0] == "goldilocks" and c[1].n == N16)
    lt30_case = next(c for c in p32_cases if c[0] == "lt30")
    on_plans = (
        (lambda: plan.negacyclic_polymul(*on_card[0]),
         ("fwd_wide_multi", "inv_multi", "lift_u64_from5", "pointwise_mont32")),
        (fam_calls["native128.Plan32"], ("fwd_wide_multi_u128", "lift_u128_from10")),
        (lambda: lt30_case[1].negacyclic_polymul(*(host(v).to(dev) for v in lt30_case[2:])),
         ("fwd", "inv")),
        (lambda: small.negacyclic_polymul(*(host(v).to(dev) for v in small_ops)),
         ("butterfly32_fwd", "butterfly32_inv")),
        (prod_calls["Bounded"], ("fwd_multi_perchannel", "pointwise_inv_multi")),
        (lambda: gl_case[1].negacyclic_polymul(*card_args(gl_case[2:])), ("fwd64", "inv64")),
        (lambda: plan52.negacyclic_polymul(*card52[0]), ("fwd_multi64", "pointwise_inv_multi64")),
        (lambda: hyb_case[1].negacyclic_polymul(*card_args(hyb_case[2:])),
         ("fwd64_hyb", "inv64_hyb")))
    on_plans17 = (
        (big_calls[f"native64.Plan32({N16})"], ("fwd_wide_multi",)),
        (big_calls[f"native128.Plan32({N16})"], ("fwd_wide_multi_u128", "inv_multi")),
        (lambda: pplan16.negacyclic_polymul(d_qx, d_qb, mode=acc, standard=d_qacc,
                                            lhs_fwd_mode=bnd),
         ("fwd_multi_perchannel", "pointwise_inv_multi")),
        (big_calls[f"prime32.Plan({N16}, lt30)"], ("fwd", "inv")),
        (k4_polymul[N16], ("butterfly32_fwd", "butterfly32_inv")))
    for plans, calls, into, keys in ((on_plans, row_calls, launches, KERNELS),
                                     (on_plans17, row_calls17, launches_n17,
                                      (*BIG_ROWS, "butterfly32_fwd", "butterfly32_inv"))):
        for call, names in plans:
            moved = launched(call)[1]
            into.update((k, moved.get(COUNTER.get(k, k), 0)) for k in names)
        for k in keys:
            if k not in into:
                into[k] = launched(calls[k])[1].get(COUNTER.get(k, k), 0)
    idle = [k for k in KERNELS if not launches[k]] + [
        f"{k} (n17)" for k, v in launches_n17.items() if not v]
    require(not idle, f"launches: {idle} launched no kernel on the call of their row")
    print(f"launches: each JSON row's kernel in one call of its plan at its shape "
          f"({sum(len(k) for _, k in on_plans)} rows; above 2^15 "
          f"{sum(len(k) for _, k in on_plans17)}), else of the call it times: {launches}; "
          f"above 2^15 {launches_n17}", flush=True)

    # the GEMM rows' device time (their pass launches a call) beside
    # torch._int_mm on the same passes' shapes, from one profiler session
    t0 = time.perf_counter()
    for (did, key), v in device_times(dev_tasks).items():
        dev_into[did][key] = v
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    for key in GEMM_ROWS:
        print(f"times: {key} device {fmt(dev_ms.get(key))}, torch._int_mm on the same shapes "
              f"{fmt(int_mm_ms.get(key))}; above 2^15 device {fmt(big_dev.get(key))}, "
              f"torch._int_mm {fmt(big_int_mm.get(key))} (torch.profiler, median of {REPS}) | "
              f"{smi}", flush=True)
    for key, (t, work_k) in ext_rows.items():
        bms, by = gemm_bound(*work_k)
        dv = ext_dev.get(key)
        share = "not measured" if dv is None else f"{100 * bms / dv:.1f} %"
        print(f"times: {key}: wrapper {t:.4f} ms, device {fmt(dv)}, torch._int_mm on the same "
              f"GEMMs {fmt(ext_int_mm.get(key))}, bound {bms:.6f} ms ({by}), device at "
              f"{share} of the bound (torch.profiler, median of {REPS}) | {smi}", flush=True)
    for (key, n), (label, t, _) in k4_rows.items():
        bms, by = k4_bound(n, B32)
        print(f"times: {key} {label} device {fmt(k4_dev.get((key, n)))}, kernel {t:.4f} ms "
              f"(torch.profiler, median of {REPS}) | {smi}", flush=True)
        print(f"bound: {key} at {label}: {bms:.6f} ms by {by} (kernel {t:.4f} ms = "
              f"{t / bms:.1f} x the bound, device {fmt(k4_dev.get((key, n)))})", flush=True)
    print(f"times: device-time session {time.perf_counter() - t0:.1f} s", flush=True)

    # K3 / K6 on the channel grids at the rank-local shapes of the `sharded`
    # phase's gloo world, one rank's passes of a polymul: wrapper ms (CUDA
    # events), device ms and torch._int_mm on the same digit-plane GEMMs (one
    # a channel; a second torch.profiler session, after the one above so that
    # its rows are read as before), bound
    rl_cases = [(*grid_case(path, which), path) for path, *_ in GRID_PATHS
                for which in ("A", "F", "G", "Ainv")]

    def rl_gemm(pairs):
        mats = pairs()
        return (lambda: [torch._int_mm(a, q) for a, q in mats]), is_kernel

    rl_tasks = []
    for i, (_, _, fn, _, _, pairs, _) in enumerate(rl_cases):
        rl_tasks.append(((i, "device"), (lambda f=fn: (f, is_pass)), 1))
        rl_tasks.append(((i, "gemm"), (lambda q=pairs: rl_gemm(q)), None))
    rl_dev = device_times(rl_tasks)
    rank_local_rows, per_path = {}, {}
    for i, (row, label, fn, _, work_rl, _, path) in enumerate(rl_cases):
        t = median_ms(fn)
        bnd = gemm_bound(*work_rl)
        dv, gm = rl_dev[(i, "device")], rl_dev[(i, "gemm")]
        rank_local_rows.setdefault(row, {})[label] = {
            "ms": t, "device_ms": dv, "gemm_ms": gm, "bound_ms": bnd[0], "bound_by": bnd[1]}
        per_path.setdefault(path, []).append((dv, bnd[0]))
        print(f"sharded: rank-local {row} {label}: wrapper {t:.4f} ms, device {fmt(dv)}, "
              f"torch._int_mm on the same GEMMs {fmt(gm)}, bound {bnd[0]:.6f} ms ({bnd[1]}) | "
              f"{smi}", flush=True)
    for path, passes in per_path.items():  # A, F, G, A_inv: a polymul runs A and F twice
        if all(dv is not None for dv, _ in passes):
            reps = dict((g[0], g[-1]) for g in GRID_PATHS)[path]
            twice = tuple(reps * w for w in (2, 2, 1, 1))
            print(f"sharded: rank-local {path}: the channel-grid launches of one rank's polymul "
                  f"({reps} x (2 A + 2 F + G + A_inv)) take "
                  f"{sum(w * dv for w, (dv, _) in zip(twice, passes)):.4f} ms of device time, "
                  f"bound {sum(w * bd for w, (_, bd) in zip(twice, passes)):.6f} ms | {smi}",
                  flush=True)

    # the bound of each kernel at the shape it was timed at: MACs a pass =
    # B·R·(E·K)·(D·O) from the plane shapes, bytes = operands, results and tables once
    n1m, n2m = mxu32.four_step_factors(N_MAIN)
    d50, d_gl = mxu64._n_dplanes(PRIMES64["p50"]), mxu64._n_dplanes(GOLDILOCKS)
    e50 = mxu64._n_eplanes_lazy(PRIMES64["p50"])
    n1k, n2k = mxu32.four_step_factors(4096)
    work = {
        # the lift: five u32 residues read, two u32 limbs written a coefficient
        "lift_u64_from5": (0, 28 * B_MAIN * N_MAIN),
        # native128's: ten u32 residues -> five u64 digits (80 B), digits -> four u32 limbs (56 B)
        "lift_u128_from10": (0, 136 * B_MAIN * N_MAIN),
        # the pointwise product: two u32 operands read, one u32 written a coefficient and channel
        "pointwise_mont32": (0, 12 * len(PRIMES) * B_MAIN * N_MAIN),
        "fwd_wide_multi": fourstep_work("fwd", B_MAIN, n1m, n2m, 5, 8, 4, 4, 2, 1, 4,
                                        shared_operand=True),
        "inv_multi": fourstep_work("inv", B_MAIN, n1m, n2m, 5, 4, 4, 4, 1, 1, 4),
        "fwd_multi_perchannel": fourstep_work("fwd", B_PROD, n1m, n2m, 2, 4, 4, 4, 1, 1, 4),
        "pointwise_inv_multi": fourstep_work("inv", B_PROD, n1m, n2m, 2, 4, 4, 4, 1, 1, 4,
                                             operands=2),
        "fwd": fourstep_work("fwd", B32, n1m, n2m, 1, 4, 4, 4, 1, 1, 4),
        "inv": fourstep_work("inv", B32, n1m, n2m, 1, 4, 4, 4, 1, 1, 4),
        # one A pass at (4096, 16): rows n2, contraction 4 planes x n1, 4 x n1 outputs
        "pass_matmod": (B32 * n2k * 4 * n1k * 4 * n1k,
                        4 * B32 * 4096 * 2 + 16 * n1k * n1k + 16 * n1k + 16 * 4096),
        "fwd64": fourstep_work("fwd", B64, n1m, n2m, 1, 8, 8, d_gl, 2, 2, 2),
        "inv64": fourstep_work("inv", B64, n1m, n2m, 1, 8, 8, d_gl, 2, 2, 2),
        "pass_matmod64": (B64 * n2k * 8 * n1k * d50 * n1k,
                          4 * B64 * 4096 * 4 + 8 * d50 * n1k * n1k + 4 * d50 * n1k + 32 * 4096),
        "fwd_multi64": fourstep_work("fwd", B52, n1m, n2m, 3, 8, e50, d50, 2, 2, 8,
                                     shared_operand=True),
        "pointwise_inv_multi64": fourstep_work("inv", B52, n1m, n2m, 3, 8, e50, d50, 2, 2, 8,
                                               operands=2),
        # K5h at (2^16, 16), Goldilocks: 4 blocks of 2^14
        "fwd64_hyb": hybrid_work("fwd", B_HYB, n1m, n2m, 4, 1, 8, 8, d_gl, 2),
        "inv64_hyb": hybrid_work("inv", B_HYB, n1m, n2m, 4, 1, 8, 8, d_gl, 2),
        "fwd_multi_perchannel64": fourstep_work("fwd", B52, n1m, n2m, 3, 8, e50, d50, 2, 2, 8),
        "inv_multi64": fourstep_work("inv", B52, n1m, n2m, 3, 8, e50, d50, 2, 2, 8),
        # the channel grid with block tables at (2^15, 8): 2 blocks of 2^14 a channel
        "fwd_multi_perchannel64_hyb": hybrid_work("fwd", B52, n1m, n2m, 2, 3, 8, e50, d50, 8),
        "inv_multi64_hyb": hybrid_work("inv", B52, n1m, n2m, 2, 3, 8, e50, d50, 8),
        "pointwise_inv_multi64_hyb": hybrid_work("inv", B52, n1m, n2m, 2, 3, 8, e50, d50, 8,
                                                 operands=2),
        # four operand limbs: 16 operand planes in the column pass
        "fwd_wide_multi_u128": fourstep_work("fwd", B_MAIN, n1m, n2m, 10, 16, 4, 4, 4, 1, 4,
                                             shared_operand=True),
        "fwd_u128": fourstep_work("fwd", B32, n1m, n2m, 1, 16, 4, 4, 4, 1, 4),
        "pass_matmod_u128": (B32 * n2k * 16 * n1k * 4 * n1k,
                             4 * B32 * 4096 * 5 + 64 * n1k * n1k + 16 * n1k + 16 * 4096),
        # the 32-bit block tables at 2^16: 4 blocks of 2^14, one u32 limb
        "fwd_hyb": hybrid_work("fwd", B32, n1m, n2m, 4, 1, 4, 4, 4, 4, limbs=1),
        "inv_hyb": hybrid_work("inv", B32, n1m, n2m, 4, 1, 4, 4, 4, 4, limbs=1),
        "fwd_multi_perchannel_hyb": hybrid_work("fwd", B_BIG, n1m, n2m, 4, 3, 4, 4, 4, 4, limbs=1),
        "inv_multi_hyb": hybrid_work("inv", B_BIG, n1m, n2m, 4, 3, 4, 4, 4, 4, limbs=1),
        "pointwise_inv_multi_hyb": hybrid_work("inv", B_BIG, n1m, n2m, 4, 3, 4, 4, 4, 4,
                                               operands=2, limbs=1),
        # K1e: K1b's work with the operand as four int8 planes (the same bytes)
        "inv_multi_presplit": fourstep_work("inv", B_MAIN, n1m, n2m, 5, 4, 4, 4, 1, 1, 4),
        # K5 fwd with four limbs: 16 operand planes in the column pass
        "fwd64_u128": fourstep_work("fwd", B64, n1m, n2m, 1, 16, 8, d_gl, 4, 2, 2),
        # the channel grids at the pass of a sharded route their rows time
        **grid_work,
    }
    bounds = {k: gemm_bound(*w) for k, w in work.items()}
    # the direct 32-bit kernels at n = 2^16 (n1 = n2 = 256), the shapes of `big_ms`
    nb1, nb2 = mxu32.four_step_factors(N16)
    big_work = {
        "fwd_wide_multi": fourstep_work("fwd", B_BIG, nb1, nb2, 5, 8, 4, 4, 2, 1, 4,
                                        shared_operand=True),
        "fwd_wide_multi_u128": fourstep_work("fwd", B_BIG, nb1, nb2, 10, 16, 4, 4, 4, 1, 4,
                                             shared_operand=True),
        "inv_multi": fourstep_work("inv", B_BIG, nb1, nb2, 10, 4, 4, 4, 1, 1, 4),
        "fwd_multi_perchannel": fourstep_work("fwd", B_BIG, nb1, nb2, 2, 4, 4, 4, 1, 1, 4),
        "pointwise_inv_multi": fourstep_work("inv", B_BIG, nb1, nb2, 2, 4, 4, 4, 1, 1, 4,
                                             operands=2),
        "fwd": fourstep_work("fwd", B32, nb1, nb2, 1, 4, 4, 4, 1, 1, 4),
        "inv": fourstep_work("inv", B32, nb1, nb2, 1, 4, 4, 4, 1, 1, 4),
        "fwd_u128": fourstep_work("fwd", B32, nb1, nb2, 1, 16, 4, 4, 4, 1, 4),
        "pass_matmod_u128": (B32 * nb2 * 16 * nb1 * 4 * nb1,
                             4 * B32 * N16 * 5 + 64 * nb1 * nb1 + 16 * nb1 + 16 * N16),
    }
    big_rows = {}
    for k in BIG_ROWS:
        label, t, tp = big_ms[k]
        bms, by = gemm_bound(*big_work[k])
        big_rows[k] = {"shape": label, "launches": launches_n17[k], "ms": t, "plain_ms": tp,
                       "bound_ms": bms, "bound_by": by, "device_ms": big_dev.get(k),
                       "gemm_ms": big_int_mm.get(k)}
        print(f"bound: {k} at {label}: {bms:.6f} ms by {by} (kernel {t:.4f} ms = "
              f"{t / bms:.1f} x the bound)", flush=True)
    # K4 at (1024, 16), and above 2^15 at (2^16, 16) with a prime below 2^26
    for k in ("butterfly32_fwd", "butterfly32_inv"):
        bounds[k] = k4_bound(1024, B32)
        label, t, tp = k4_rows[(k, N16)]
        bms, by = k4_bound(N16, B32)
        big_rows[k] = {"shape": label, "launches": launches_n17[k], "ms": t, "plain_ms": tp,
                       "bound_ms": bms, "bound_by": by, "device_ms": k4_dev.get((k, N16))}
    for k in KERNELS:
        print(f"bound: {k}: {bounds[k][0]:.6f} ms by {bounds[k][1]} (kernel {ms[k]:.4f} ms = "
              f"{ms[k] / bounds[k][0]:.1f} x the bound)", flush=True)
    memory_line("after the times")

    if args.profile:
        prof_cases = [(f"n={N32} ({name})", pl, lhs, rhs) for name, pl, lhs, rhs in p32_cases]
        prof_cases += [("n=4096 (lt30)", mid, *mid_ops), ("n=1024 (lt30)", small, *small_ops)]
        for label, pl, lhs, rhs in prof_cases:
            a, b = host(lhs).to(dev), host(rhs).to(dev)
            r = profile_polymul(lambda: pl.negacyclic_polymul(a, b))
            print(f"profile: prime32 polymul {label} B={B32} p={pl.p}: host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), matmod_pass/ntt_k4 "
                  f"{r['kernel_ms']:.4f} ms, {r['device_events']:.0f} device events and "
                  f"{r['aten_ops']:.0f} aten ops a polymul (10 polymuls) | {smi}", flush=True)
        for what in ("Replace", "Bounded"):
            r = profile_polymul(prod_calls[what])
            print(f"profile: product polymul {what} n={N_PROD} B={B_PROD}: host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), matmod_pass {r['kernel_ms']:.4f} ms, "
                  f"{r['device_events']:.0f} device events and {r['aten_ops']:.0f} aten ops "
                  f"a polymul (10 polymuls) | {smi}", flush=True)

        for rname, pl, lhs, rhs in p64_cases:
            a, b = card(lhs), card(rhs)
            r = profile_polymul(lambda: pl.negacyclic_polymul(a, b))
            print(f"profile: prime64 polymul n={N64} B={B64} p={pl.p} ({rname}): host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), matmod64_pass {r['kernel_ms']:.4f} ms, "
                  f"{r['device_events']:.0f} device events and {r['aten_ops']:.0f} aten ops "
                  f"a polymul (10 polymuls) | {smi}", flush=True)
        for name, pl in (("Plan52", plan52), ("Plan32", plan)):
            r = profile_polymul(lambda: pl.negacyclic_polymul(lhs52, rhs52))
            print(f"profile: native64 {name} polymul n={N64} B={B52} planar: host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), GEMM passes {r['kernel_ms']:.4f} ms, "
                  f"{r['device_events']:.0f} device events and {r['aten_ops']:.0f} aten ops "
                  f"a polymul (10 polymuls) | {smi}", flush=True)

        for name, fn in fam_calls.items():
            r = profile_polymul(fn)
            print(f"profile: {name} polymul n={N_MAIN} B={B_MAIN}: host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), GEMM passes {r['kernel_ms']:.4f} ms, "
                  f"{r['device_events']:.0f} device events and {r['aten_ops']:.0f} aten ops "
                  f"a polymul (10 polymuls) | {smi}", flush=True)

        for rname, pl, lhs, rhs in hyb_cases:
            if pl.n != 1 << 16:
                continue
            a, b = card(lhs), card(rhs)
            r = profile_polymul(lambda: pl.negacyclic_polymul(a, b))
            x = tuple(t.contiguous() for t in a.unbind(-1))
            pre, kf, ki, suf = split_times(pl.n, pl.p, x, scale64(pl.n, pl.p))
            print(f"profile: prime64 hybrid polymul n={pl.n} B={B_HYB} p={pl.p} ({rname}): host "
                  f"clock {r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), matmod64_pass {r['kernel_ms']:.4f} ms, "
                  f"{r['device_events']:.0f} device events and {r['aten_ops']:.0f} aten ops a "
                  f"polymul (10 polymuls); by CUDA events: prefix {pre:.4f} ms x2, K5h fwd "
                  f"{kf:.4f} ms x2, K5h inv {ki:.4f} ms, suffix {suf:.4f} ms | {smi}", flush=True)

        for name, fn in big_calls.items():
            r = profile_polymul(fn, reps=5)
            print(f"profile: {name} polymul above 2^15: host clock {r['host_ms']:.4f} ms, device "
                  f"busy {r['busy_ms']:.4f} ms ({100 * r['busy_share']:.1f} %), GEMM passes "
                  f"{r['kernel_ms']:.4f} ms, {r['device_events']:.0f} device events and "
                  f"{r['aten_ops']:.0f} aten ops a polymul (5 polymuls) | {smi}", flush=True)

    # -- 6. stages and examples ---------------------------------------------------
    stages_phase(smi, args.seed, dev)
    examples_phase(os.path.dirname(os.path.abspath(__file__)), smi)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k], "ms": ms[k],
         "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None,
         **({"device_ms": dev_ms.get(k), "gemm_ms": int_mm_ms.get(k)}
            if k in GEMM_ROWS else {}),
         **({"device_ms": k4_dev.get((k, 1024))} if k.startswith("butterfly32_") else {}),
         **({"n17": big_rows[k]} if k in big_rows else {}),
         **({"rank_local": rank_local_rows[k]} if k in rank_local_rows else {})}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
