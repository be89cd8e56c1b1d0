#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`concrete_ntt_tpu_torch`) on one GPU.

Drives the port's paths through their hand-written CUDA kernels:
  * native64: `native64.Plan32(2^14).negacyclic_polymul` on planar (lo, hi)
    uint32 limbs at batch 8, through K1a (`fwd_wide_multi`) and K1b
    (`inv_multi`) of `csrc/mxu32_multi.cu`;
  * prime32: `prime32.Plan(n, p).negacyclic_polymul` in the three prime
    regimes (lt30, lt31, generic), through K2 (four-step `fwd` / `inv`,
    2048 <= n <= 2^15, p >= 2^26) of `csrc/mxu32_pass.cu` and K4 (butterfly
    `fwd` / `inv`, n < 2048 or p < 2^26) of `csrc/butterfly32.cu`;
  * rank-local passes: K3 (`pass_matmod`, `csrc/mxu32_pass.cu`) as the
    sharded four-step's local sections call it (the JAX package's
    `parallel/fourstep_mxu.py`: a column pass with the rank's diagonal
    rows, the all-to-all, a row pass), with R = 4 ranks held on one card
    and the all-to-all done as slices and concatenations;
  * product: `product.Plan(2^14, f1·f2, (f1, f2))` over two 30-bit primes
    (the reference grid's product-2xu32-16384 shape) at batch 16, the
    tfhe-rs hot path: `negacyclic_polymul` in Replace, Accumulate and
    Bounded through K1a, K1c (`fwd_multi_perchannel`, the Bounded fwd) and
    K1d (`pointwise_inv_multi`, the fused pointwise product + inverse) of
    `csrc/mxu32_multi.cu`, and K1b for `inv`; a PBS-shaped loop; a pair of
    primes above 2^31 through K2 once per channel; one u32 and one u64
    factor (the u64 channel through K5);
  * prime64: `prime64.Plan(2^14, p).negacyclic_polymul` at batch 16 in the
    four epilogue regimes (five primes: Goldilocks, PRIMES52[0], the largest
    NTT primes below 2^62, 2^63 and 2^64), through K5 (`fwd64` / `inv64`,
    the whole four-step transform on u64 limb pairs) of
    `csrc/mxu64_pass.cu`; n = 1024 through the plain stage engine;
  * rank-local 64-bit passes: K6 (`pass_matmod64`, same source) as the
    sharded prime64 four-step's ranks call it, R = 4 ranks on one card;
  * Plan52: `native64.Plan52(2^14).negacyclic_polymul` on planar (lo, hi)
    limbs at batch 8 over three 50-bit primes, through K7a (`fwd_multi64`)
    and K7d (`pointwise_inv_multi64`) of `csrc/mxu64_multi.cu`, held
    against Plan32 on the same inputs; `Plan52.fwd` (K7a) and `inv` (K5);
  * prime64 above 2^15: `prime64.Plan(2^16, p)` (five regime primes) and
    `Plan(2^17, p)` (a 50-bit prime and Goldilocks) `fwd`, `inv` and
    `negacyclic_polymul` at batch 16 from numpy uint64 input on
    default-device plans, through the stage-split hybrid
    (`ops/stagesplit.py`): butterfly prefix / suffix stages in plain torch
    around K5 with block tables (`fwd64_hyb` / `inv64_hyb`, all 2^l blocks
    in one launch pair) of `csrc/mxu64_pass.cu`; `product.Plan(2^16, p,
    (p,))` with one u64 factor through the same;
  * the channel-grid hybrid at its one system shape, Plan52's three primes at
    n = 2^15, n_h = 2^14, batch 8: `stagesplit.fwd_multi_hybrid64`,
    `pointwise_inv_multi_hybrid64` and `inv_multi_hybrid64` through K7c,
    K7d and K7b with block tables of `csrc/mxu64_multi.cu`, held against
    Plan52's direct route (K7a, K7d, K5); and K7c / K7b direct at 2^14 as a
    per-channel round trip;
  * the device rule: a default-constructed plan given numpy input computes
    on the card (its launch counters move).

Phases, one line each (or a few), stopping with a non-zero exit at the first
failure:
  1. device  — needs torch.cuda.is_available(); prints nvidia-smi's name and
               power limit.
  2. build   — compiles every kernel source from the checkout with nvcc, one
               process per source, all started together; prints ptxas's
               lines.
  3. parity  — each kernel against its plain torch version on the card,
               exact equality: K1a/K1b at (n, B) = (2^14, 8), (2^14, 5),
               (2^11, 3), (2^15, 2); K2 fwd, fwd_wide, inv (unscaled and
               scaled) at (2^14, 16), (2^14, 3), (2^15, 2) and at n in
               {2048, 4096, 8192}, B in {16, 3}; K3 pass_matmod (A scaled
               with 1 and 2 limbs, F, G scaled, Ainv plain and scaled, a
               row slice with rank-local diagonals) at the same mid sizes;
               all of K2/K3 for the three bench primes; K4 fwd / inv at n in
               {2, 32, 256, 1024, 2^14, 2^15}, B in {16, 9}, in each regime,
               and with p = 67043329 at 2^14 and 2^15; K1c (1 and 2 limbs)
               and K1d (full-range u32 operands) with two 30-bit primes at
               (n, B) = (2^14, 16), (2^14, 5), (2^11, 3), (2^15, 2); K5 fwd,
               inv unscaled and scaled for the five regime primes at
               (2^14, 16), (2^14, 3), (2^11, 3) and at (2^15, 2) for
               Goldilocks and PRIMES52[0], full-range u32 limbs; K6 (A
               scaled, F, G scaled, Ainv plain and scaled, a row slice with
               rank-local diagonals) at n in {2048, 4096, 8192}, B in
               {16, 3}, five primes; K7a and K7d over PRIMES52[:3] at
               (2^14, 8), (2^14, 5), (2^11, 3), (2^15, 2), K7d with
               full-range u64 operands; K5 with block tables (K5h) fwd and
               inv scaled at (2^15, 16), (2^16, 16) in five regime primes
               with 2^18 | p - 1 and at (2^17, 16) in two, and at 2^15 the
               whole hybrid against the plain hybrid and the direct K5
               output; K7c and K7b direct at (2^14, 8) and (2^11, 3); K7c,
               K7b and K7d with block tables at (2^15, 8) against their
               plain versions and, as the whole channel-grid hybrid,
               against K7a, K5 x3 and K7d direct.
  4. main    — native64: three polymuls on the card == CPU plain path ==
               numpy wrapping oracle (row 0); K1a +2, K1b +1 per call.
               prime32: Plan(2^14, p) polymul at B = 16 for each bench prime
               == CPU plain path, and inv(fwd(x)) == n·x mod p (K2 +2 fwd
               +1 inv per polymul, also at n = 4096); Plan(1024,
               1073479681) polymul, row 0 == the schoolbook oracle (K4 +2
               fwd +1 inv); the README vector N = 32, p = 1062862849, round
               trip. Rank-local passes: fwd and inv at n = 4096, B = 16 for
               each bench prime == CPU plain path, and inv(fwd(x)) == n·x
               (K3 +2R passes a transform). product: Plan(2^14, f1·f2)
               polymul at B = 16 in Replace, Accumulate (K1a +2, K1d +1)
               and Bounded b = 2^20 (K1c +1, K1a +1, K1d +1), fwd(bounded)
               (K1c +1) and inv (K1b +1), each == CPU plain path; at
               n = 2048 one Replace polymul, row 0 == the schoolbook
               oracle; a PBS loop (a Bounded fwd and a mul_accumulate
               against a preloaded NTT-domain operand per term, 16 terms,
               one inv(ACCUMULATE)) == CPU plain path; primes (2147352577,
               4293918721) at 2^14: K2 fwd +4, inv +2 a polymul, == CPU.
               prime64: Plan(2^14, p) polymul at B = 16 per regime == CPU
               plain path, inv(fwd(x)) == n·x (K5 +2 fwd +1 inv a polymul);
               Plan(1024, PRIMES52[0]) polymul through the stage engine,
               row 0 == the schoolbook oracle; rank-local fwd and inv
               through K6 at n = 4096 (K6 +4R a round trip). Plan52(2^14)
               polymul at B = 8 == CPU plain path == numpy wrapping oracle
               (row 0) == Plan32 on the same inputs (K7a +2, K7d +1);
               Plan52.fwd (K7a +1) and inv (K5 inv +3); product.Plan with a
               30-bit and a 34-bit factor at 2^14 == CPU plain path. A
               numpy-input polymul on a default-constructed plan moves the
               launch counters. prime64 Plan(2^16, p) x5 and Plan(2^17, p)
               x2 at B = 16, numpy input on default plans: polymul (K5h fwd
               +2, inv +1, direct K5 +0), fwd, inv == CPU plain path (all
               rows at 2^16, four at 2^17), inv(fwd(x)) == n·x, four
               sampled coefficients of row 0 == direct sums in Python
               integers; product.Plan(2^16, p, (p,)) == CPU. The
               channel-grid hybrid at (2^15, 8): K7c-hyb +2, K7d-hyb +1 a
               polymul == Plan52 direct == CPU plain path, K7b-hyb +1 an
               inverse, n·x; K7c +1, K7b +1 a per-channel round trip at
               2^14. Each path's launch counters are set to 0
               just before it and read just after.
  5. times   — CUDA events, warm-up then the median of reps, each kernel
               beside its plain version (K1d also beside plain mont_mul +
               K1b), the polymuls in products/s (product in its three
               modes) and the PBS loop's ms per term; K5 fwd / inv per
               regime, one K6 pass, K7a, K7d (also beside plain mont_mul64 +
               three K5 inverses), the prime64 polymul per regime and the
               Plan52 polymul beside Plan32's; K5h fwd / inv at 2^16 and
               2^17, K7c / K7b direct, K7 with block tables; K5 direct
               beside the hybrid (prefix + K5h, K5h + suffix) at (2^15, 16)
               and the Plan52 polymul direct beside the channel-grid hybrid
               at (2^15, 8), in turns; the prime64 transforms and polymul
               at 2^16 and 2^17.
Then one JSON line of kernel summaries (each with its launches on its main
path, error, ms, plain ms, and the bound: the larger of its bytes over
3.35 TB/s and its int8 operations over 1,979 TOP/s, the H100 SXM data-sheet
rates; `library_ms` is null for all: no single PyTorch call computes an
exact modular transform), the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
`--profile` adds, before the JSON lines, a torch.profiler breakdown of the
prime32 polymul at B = 16 (n = 2^14 per regime, 4096, 1024) and of the
product polymul at (2^14, 16) in Replace and Bounded, of the prime64 polymul
per regime and of the Plan52 polymul: host-clock ms, device
busy ms and share, matmod_pass / butterfly device ms, and device kernels
and aten ops per polymul; and of the prime64 polymul at 2^16 with its split
into prefix stages, block kernels and suffix stages.
Inputs come from numpy's default_rng(--seed); the script imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, B_MAIN = 1 << 14, 8
N32, B32 = 1 << 14, 16
REPS = 20
PARITY_SHAPES = ((1 << 14, 8), (1 << 14, 5), (1 << 11, 3), (1 << 15, 2))
K1CD_SHAPES = ((1 << 14, 16), (1 << 14, 5), (1 << 11, 3), (1 << 15, 2))
K3_SIZES, K3_BATCHES = (2048, 4096, 8192), (16, 3)
K2_SHAPES = ((1 << 14, 16), (1 << 14, 3), (1 << 15, 2)) + tuple(
    (n, b) for n in K3_SIZES for b in K3_BATCHES)
RANKS = 4  # ranks of the rank-local pass path, held on one card
K4_SIZES, K4_BATCHES = (2, 32, 256, 1024, 1 << 14, 1 << 15), (16, 9)
BENCH_PRIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
N_PROD, B_PROD, N_PROD_SMALL = 1 << 14, 16, 2048
BOUND = 1 << 20  # Bounded fwd: |value| < 2^19, a PBS decomposition digit's size
PBS_TERMS = 16
K2_PAIR = (BENCH_PRIMES["lt31"], BENCH_PRIMES["generic"])  # product < 2^64
SMALL_P = 67043329  # < 2^26: the butterfly kernel at every n
N64, B64, B52 = 1 << 14, 16, 8
K5_SHAPES = ((1 << 14, 16), (1 << 14, 3), (1 << 11, 3))
K7_SHAPES = ((1 << 14, 8), (1 << 14, 5), (1 << 11, 3), (1 << 15, 2))
N_H = 1 << 14  # the hybrid's block size
N_HYB15, HYB_SIZES, B_HYB = 1 << 15, (1 << 16, 1 << 17), 16
HYB_BIG = ("p50", "goldilocks")  # the regimes run at 2^17 (the reference grid's two)
K7BC_SHAPES = ((1 << 14, 8), (1 << 11, 3))
CPU_ROWS_BIG = 4  # rows held against the CPU plain path at 2^17
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet: 80 GB of HBM at 3.35 TB/s
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet: 1,979 TOP/s int8, dense (2 ops a MAC)
CORE_OPS_PER_S = 67e12      # H100 SXM data sheet: 67 TFLOP/s outside the tensor cores
MULTI_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_multi.cu"
PASS_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_pass.cu"
BFLY_SRC = "concrete_ntt_tpu_torch/csrc/butterfly32.cu"
PASS64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_pass.cu"
MULTI64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_multi.cu"
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
}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


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


def profile_polymul(fn, reps: int = 10) -> dict:
    """Per-call breakdown of fn(): host-clock ms (perf_counter around reps
    synchronized calls, no profiler), then under torch.profiler the device
    busy ms (device events: kernels and copies), the device ms of the GEMM
    passes (matmod_pass, matmod64_pass) and butterfly (ntt_radix2) kernels, and the counts
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
            if "matmod_pass" in ev.name or "matmod64_pass" in ev.name or "ntt_radix2" in ev.name:
                kern += us
        elif ev.name.startswith("aten::"):
            n_aten += 1
    busy_ms = busy / 1e3 / reps
    return {"host_ms": host_ms, "busy_ms": busy_ms, "busy_share": busy_ms / host_ms,
            "kernel_ms": kern / 1e3 / reps, "device_events": n_dev / reps,
            "aten_ops": n_aten / reps}


def rank_local_fwd(pass_matmod, x, diag, *, n, n1, n2, p):
    """Forward NTT [B, n] -> [B, n] (bit-reversed) as the sharded
    four-step's ranks compute it: rank r holds columns r*c.. of [B, n1, n2]
    and runs the column pass A with its rows of the diagonal d; the
    all-to-all gives rank q outputs q*c1.. of every rank; each runs the row
    pass F on its rows."""
    b = x.shape[0]
    c, c1 = n2 // RANKS, n1 // RANKS
    xv = x.reshape(b, n1, n2)
    ys = [pass_matmod(xv[:, :, r * c:(r + 1) * c].transpose(1, 2).contiguous(), n=n, p=p,
                      which="A", diag_slices=tuple(t[r * c:(r + 1) * c] for t in diag))
          for r in range(RANKS)]  # [B, c, n1] each
    outs = [pass_matmod(torch.cat([y[:, :, q * c1:(q + 1) * c1] for y in ys], dim=1)
                        .transpose(1, 2).contiguous(), n=n, p=p, which="F")
            for q in range(RANKS)]  # [B, c1, n2] each
    return torch.cat(outs, dim=1).reshape(b, n)


def rank_local_inv(pass_matmod, x, diag, *, n, n1, n2, p):
    """The mirror: rank q holds rows q*c1.. of the NTT domain, runs the row
    pass G with its rows of the diagonal e, the all-to-all regroups by
    columns, and each rank runs the column pass Ainv (unnormalized)."""
    b = x.shape[0]
    c, c1 = n2 // RANKS, n1 // RANKS
    xv = x.reshape(b, n1, n2)
    ys = [pass_matmod(xv[:, q * c1:(q + 1) * c1].contiguous(), n=n, p=p, which="G",
                      diag_slices=tuple(t[q * c1:(q + 1) * c1] for t in diag))
          for q in range(RANKS)]  # [B, c1, n2] each
    outs = [pass_matmod(torch.cat([y[:, :, r * c:(r + 1) * c] for y in ys], dim=1)
                        .transpose(1, 2).contiguous(), n=n, p=p, which="Ainv").transpose(1, 2)
            for r in range(RANKS)]  # [B, n1, c] each
    return torch.cat(outs, dim=2).reshape(b, n)


def rank_local_fwd64(pass_matmod64, x, diag, *, n, n1, n2, p):
    """`rank_local_fwd` on (lo, hi) limb pairs through the 64-bit pass."""
    b = x[0].shape[0]
    c, c1 = n2 // RANKS, n1 // RANKS
    xv = tuple(a.reshape(b, n1, n2) for a in x)
    ys = [pass_matmod64(tuple(a[:, :, r * c:(r + 1) * c].transpose(1, 2).contiguous() for a in xv),
                        n=n, p=p, which="A",
                        diag_slices=tuple(t[r * c:(r + 1) * c] for t in diag))
          for r in range(RANKS)]  # (lo, hi) [B, c, n1] each
    outs = [pass_matmod64(tuple(torch.cat([y[i][:, :, q * c1:(q + 1) * c1] for y in ys], dim=1)
                                .transpose(1, 2).contiguous() for i in range(2)),
                          n=n, p=p, which="F")
            for q in range(RANKS)]  # (lo, hi) [B, c1, n2] each
    return tuple(torch.cat([o[i] for o in outs], dim=1).reshape(b, n) for i in range(2))


def rank_local_inv64(pass_matmod64, x, diag, *, n, n1, n2, p):
    """`rank_local_inv` on (lo, hi) limb pairs through the 64-bit pass."""
    b = x[0].shape[0]
    c, c1 = n2 // RANKS, n1 // RANKS
    xv = tuple(a.reshape(b, n1, n2) for a in x)
    ys = [pass_matmod64(tuple(a[:, q * c1:(q + 1) * c1].contiguous() for a in xv), n=n, p=p,
                        which="G", diag_slices=tuple(t[q * c1:(q + 1) * c1] for t in diag))
          for q in range(RANKS)]  # (lo, hi) [B, c1, n2] each
    outs = [pass_matmod64(tuple(torch.cat([y[i][:, :, r * c:(r + 1) * c] for y in ys], dim=1)
                                .transpose(1, 2).contiguous() for i in range(2)),
                          n=n, p=p, which="Ainv")
            for r in range(RANKS)]  # (lo, hi) [B, c, n1] each
    return tuple(torch.cat([o[i].transpose(1, 2) for o in outs], dim=2).reshape(b, n)
                 for i in range(2))


def gemm_bound(macs: float, nbytes: float) -> tuple:
    """(bound ms, which bounds): the larger of the bytes the function must
    move over the card's memory rate and its int8 operations (2 a MAC) over
    the card's int8 tensor-core peak."""
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


def hybrid_work(direction, b, n1, n2, nb, c, e1, e2, d, n_diag, operands=1) -> tuple:
    """(int8 MACs, bytes) of the nb block transforms of size n1·n2 of a
    stage-split hybrid over c channels: the MACs of nb four-steps; operands
    and results once ((lo, hi) limbs of [c, B, nb·n1·n2]); the per-block
    column operator and diagonals nb times, the shared row operator once."""
    n = n1 * n2
    k1, k2 = (n1, n2) if direction == "fwd" else (n2, n1)
    macs = c * nb * b * n * d * (e1 * k1 + e2 * k2)
    blk, sh = ((e1, k1), (e2, k2)) if direction == "fwd" else ((e2, k2), (e1, k1))
    tables = c * (nb * (d * blk[0] * blk[1] ** 2 + 4 * d * blk[1] + 4 * n_diag * n)
                  + d * sh[0] * sh[1] ** 2 + 4 * d * sh[1])
    io = 4 * b * nb * n * c * 2 * (operands + 1)
    return macs, io + tables


def negacyclic_coeff(a, b, k: int, p: int) -> int:
    """Coefficient k of a·b mod (X^n + 1, p) by its direct sum, a and b
    object arrays of Python integers."""
    return (int((a[:k + 1] * b[k::-1]).sum()) - int((a[k + 1:] * b[:k:-1]).sum())) % p


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
    from concrete_ntt_tpu_torch import native64, prime32, prime64, product
    from concrete_ntt_tpu_torch.golden.polymul import (
        negacyclic_convolution_mod,
        negacyclic_convolution_wrapping_np,
    )
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu
    from concrete_ntt_tpu_torch.ops import (
        cuda_build, mxu32, mxu32_cuda, mxu64, mxu64_cuda, stagesplit)
    from concrete_ntt_tpu_torch.ops.u32 import (
        limbs_to_np_u64, mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32)
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)

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
    mxu64_cuda._pass_lib(), mxu64_cuda._multi_lib()
    print(f"build: {len(sos)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    for so in sos:
        with open(so[:-3] + ".log") as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        print(f"build: {os.path.relpath(so)}: " + " | ".join(ptxas), flush=True)

    def counts() -> dict:
        return {**mxu32_cuda.LAUNCHES, **{f"butterfly32_{k}": v for k, v in bcu.LAUNCHES.items()},
                **mxu64_cuda.LAUNCHES}

    def reset_counts() -> None:
        mxu32_cuda.reset_launch_counts()
        bcu.reset_launch_counts()
        mxu64_cuda.reset_launch_counts()

    # -- 3. parity --------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    max_err = {k: 0 for k in KERNELS}
    checks = {k: 0 for k in KERNELS}

    def compare(name: str, got, want, what: str) -> None:
        torch.cuda.synchronize()
        require(got.shape == want.shape,
                f"parity: {name} {what} shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((to_i64(got) - to_i64(want)).abs().max().item()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        checks[name] += 1
        require(err == 0, f"parity: {name} {what} differs from its plain version "
                          f"(max |err| {err})")

    t0 = time.perf_counter()
    for n, b in PARITY_SHAPES:
        limbs = (u32((b, n)), u32((b, n)))
        for nl in (1, 2):
            compare("fwd_wide_multi", mxu32_cuda.fwd_wide_multi(limbs[:nl], PRIMES),
                    mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], PRIMES),
                    f"n={n} B={b} limbs={nl}")
        x = u32((len(PRIMES), b, n))
        scaled = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
        for scales in ((1,) * len(PRIMES), scaled):
            compare("inv_multi", mxu32_cuda.inv_multi(x, PRIMES, scales),
                    mxu32_cuda.inv_multi_plain(x, PRIMES, scales),
                    f"n={n} B={b} scaled={scales != (1,) * len(PRIMES)}")
    print(f"parity: K1a/K1b {checks['fwd_wide_multi'] + checks['inv_multi']} checks exact "
          f"at (n, B) in {PARITY_SHAPES} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    p2 = PRIMES[:2]
    for n, b in K1CD_SHAPES:
        xs = (u32((2, b, n)), u32((2, b, n)))  # full-range u32
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_multi_perchannel(xs[0], p2),
                mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], p2), f"n={n} B={b} limbs=1")
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_wide_multi_perchannel(*xs, p2),
                mxu32_cuda.fwd_multi_perchannel_plain(xs, p2), f"n={n} B={b} limbs=2")
        scales = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in p2)
        compare("pointwise_inv_multi", mxu32_cuda.pointwise_inv_multi(*xs, p2, scales),
                mxu32_cuda.pointwise_inv_multi_plain(*xs, p2, scales), f"n={n} B={b}")
    print(f"parity: K1c {checks['fwd_multi_perchannel']}, K1d {checks['pointwise_inv_multi']} "
          f"checks exact at (n, B) in {K1CD_SHAPES}, primes {p2}, full-range u32 operands in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for p in BENCH_PRIMES.values():
        for n, b in K2_SHAPES:
            limbs = (u32((b, n)), u32((b, n)))
            compare("fwd", mxu32_cuda.fwd(limbs[0], n=n, p=p),
                    mxu32_cuda.fwd_plain(limbs[0], n=n, p=p), f"p={p} n={n} B={b}")
            compare("fwd", mxu32_cuda.fwd_wide(limbs, n=n, p=p),
                    mxu32_cuda.fwd_wide_plain(limbs, n=n, p=p), f"p={p} n={n} B={b} 2 limbs")
            x = u32((b, n))
            for s in (1, pow(n, p - 2, p) * pow(2, 32, p) % p):
                compare("inv", mxu32_cuda.inv(x, n=n, p=p, scale=s),
                        mxu32_cuda.inv_plain(x, n=n, p=p, scale=s),
                        f"p={p} n={n} B={b} scale={s}")
    print(f"parity: K2 fwd {checks['fwd']}, inv {checks['inv']} checks exact at (n, B) in "
          f"{K2_SHAPES} x p in {tuple(BENCH_PRIMES.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for p in BENCH_PRIMES.values():
        for n in K3_SIZES:
            tbl = mxu32._mxu_tables(n, p)
            n1, n2 = tbl["n1"], tbl["n2"]
            d = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])  # [n2, n1]
            e = tuple(torch.from_numpy(a).to(dev) for a in tbl["e"])  # [n1, n2]
            sc = pow(n, p - 2, p) * pow(2, 32, p) % p
            for b in K3_BATCHES:
                xa = (u32((b, n2, n1)), u32((b, n2, n1)))
                cases = [
                    ("A", xa[0], d, 1, 1), ("A", xa, d, 2, 1),
                    ("F", u32((b, n1, n2)), (), 1, 1), ("G", u32((b, n1, n2)), e, 1, 1),
                    ("Ainv", u32((b, n2, n1)), (), 1, 1), ("Ainv", u32((b, n2, n1)), (), 1, sc),
                    ("A", u32((b, n2 // 2, n1)), tuple(t[n2 // 4: n2 // 4 + n2 // 2] for t in d),
                     1, 1),  # a rank-local row slice
                ]
                for which, x, dg, nl, s in cases:
                    kw = dict(n=n, p=p, which=which, diag_slices=dg, n_limbs=nl, scale=s)
                    compare("pass_matmod", mxu32_cuda.pass_matmod(x, **kw),
                            mxu32_cuda.pass_matmod_plain(x, **kw),
                            f"p={p} n={n} B={b} {which} limbs={nl} scale={s} rows={x[0].shape[1] if nl > 1 else x.shape[1]}")
    print(f"parity: K3 {checks['pass_matmod']} checks exact at n in {K3_SIZES}, B in "
          f"{K3_BATCHES}, p in {tuple(BENCH_PRIMES.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    k4_cases = [(p, n) for p in BENCH_PRIMES.values() for n in K4_SIZES]
    k4_cases += [(SMALL_P, 1 << 14), (SMALL_P, 1 << 15)]
    for p, n in k4_cases:
        plan = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
        for b in K4_BATCHES:
            x = u32((b, n), p)
            compare("butterfly32_fwd", bcu.try_fwd(x, plan._tbl, **kw),
                    bcu.fwd_plain(x, plan._tbl, **kw), f"p={p} n={n} B={b}")
            compare("butterfly32_inv", bcu.try_inv(x, plan._tbl, **kw),
                    bcu.inv_plain(x, plan._tbl, **kw), f"p={p} n={n} B={b}")
    print(f"parity: K4 fwd {checks['butterfly32_fwd']}, inv {checks['butterfly32_inv']} checks "
          f"exact at n in {K4_SIZES}, B in {K4_BATCHES}, three regimes, and p={SMALL_P} at "
          f"2^14, 2^15 in {time.perf_counter() - t0:.1f} s", flush=True)

    def compare_pair(name: str, got, want, what: str) -> None:
        for g, w, limb in zip(got, want, ("lo", "hi")):
            compare(name, g, w, f"{what} ({limb})")
        checks[name] -= 1  # one check a pair

    def scale64(n, p):
        return pow(n, p - 2, p) * pow(2, 64, p) % p

    def mid_pair(shape, p):
        """A mid-pass operand: any u64, or below 4p where the pass takes only
        7 operand planes (the plane diet of the 50-bit primes)."""
        if mxu64._n_eplanes_lazy(p) == 8:
            return u32(shape), u32(shape)
        v = rng.integers(0, 4 * p, shape, dtype=np.uint64)
        return tuple(torch.from_numpy(a).to(dev) for a in
                     ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (v >> np.uint64(32)).astype(np.uint32)))

    t0 = time.perf_counter()
    for rname, p in PRIMES64.items():
        shapes = K5_SHAPES + (((1 << 15, 2),) if rname in ("goldilocks", "p50") else ())
        for n, b in shapes:
            x = (u32((b, n)), u32((b, n)))
            compare_pair("fwd64", mxu64_cuda.fwd(x, n=n, p=p), mxu64_cuda.fwd_plain(x, n=n, p=p),
                         f"p={p} n={n} B={b}")
            for sc in (1, scale64(n, p)):
                compare_pair("inv64", mxu64_cuda.inv(x, n=n, p=p, scale=sc),
                             mxu64_cuda.inv_plain(x, n=n, p=p, scale=sc),
                             f"p={p} n={n} B={b} scaled={sc != 1}")
    print(f"parity: K5 fwd {checks['fwd64']}, inv {checks['inv64']} checks exact at (n, B) in "
          f"{K5_SHAPES} (+ (32768, 2) for goldilocks, p50) x p in {tuple(PRIMES64.values())}, "
          f"full-range limbs, in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for p in PRIMES64.values():
        for n in K3_SIZES:
            tbl = mxu64._tables(n, p)
            n1, n2 = tbl["n1"], tbl["n2"]
            d = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])  # [n2, n1]
            e = tuple(torch.from_numpy(a).to(dev) for a in tbl["e"])  # [n1, n2]
            for b in K3_BATCHES:
                cases = [
                    ("A", (u32((b, n2, n1)), u32((b, n2, n1))), d, 1),
                    ("F", mid_pair((b, n1, n2), p), (), 1),
                    ("G", (u32((b, n1, n2)), u32((b, n1, n2))), e, 1),
                    ("Ainv", mid_pair((b, n2, n1), p), (), 1),
                    ("Ainv", mid_pair((b, n2, n1), p), (), scale64(n, p)),
                    ("A", (u32((b, n2 // 2, n1)), u32((b, n2 // 2, n1))),
                     tuple(t[n2 // 4: n2 // 4 + n2 // 2] for t in d), 1),  # a rank-local slice
                ]
                for which, x, dg, sc in cases:
                    kw = dict(n=n, p=p, which=which, diag_slices=dg, scale=sc)
                    compare_pair("pass_matmod64", mxu64_cuda.pass_matmod64(x, **kw),
                                 mxu64_cuda.pass_matmod64_plain(x, **kw),
                                 f"p={p} n={n} B={b} {which} scale={sc} rows={x[0].shape[1]}")
    print(f"parity: K6 {checks['pass_matmod64']} checks exact at n in {K3_SIZES}, B in "
          f"{K3_BATCHES}, five primes in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for n, b in K7_SHAPES:
        x = (u32((b, n)), u32((b, n)))
        compare_pair("fwd_multi64", mxu64_cuda.fwd_multi(x, P52),
                     mxu64_cuda.fwd_multi_plain(x, P52), f"n={n} B={b}")
        fl, fr = ((u32((3, b, n)), u32((3, b, n))) for _ in range(2))  # full-range u64
        scs = tuple(scale64(n, p) for p in P52)
        compare_pair("pointwise_inv_multi64", mxu64_cuda.pointwise_inv_multi(fl, fr, P52, scs),
                     mxu64_cuda.pointwise_inv_multi_plain(fl, fr, P52, scs), f"n={n} B={b}")
    print(f"parity: K7a {checks['fwd_multi64']}, K7d {checks['pointwise_inv_multi64']} checks "
          f"exact at (n, B) in {K7_SHAPES}, primes {P52}, full-range u64 operands in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    hyb_shapes, hyb_build = [], []
    for rname, p in HYB64.items():
        sizes = (N_HYB15, 1 << 16) + ((1 << 17,) if rname in HYB_BIG else ())
        for n in sizes:
            hyb_shapes.append((rname, n))
            t1 = time.perf_counter()  # the host build: operators, block proof, digit planes
            stagesplit._dev64(n, p, N_H)
            hyb_build.append(f"{n} {rname} {time.perf_counter() - t1:.1f} s")
            x = (u32((B_HYB, n)), u32((B_HYB, n)))
            sc = scale64(n, p)
            kw = dict(n=n, p=p, n_h=N_H)
            what = f"p={p} n={n} B={B_HYB}"
            compare_pair("fwd64_hyb", mxu64_cuda.fwd_hyb(x, **kw),
                         mxu64_cuda.fwd_hyb_plain(x, **kw), what)
            compare_pair("inv64_hyb", mxu64_cuda.inv_hyb(x, scale=sc, **kw),
                         mxu64_cuda.inv_hyb_plain(x, scale=sc, **kw), what + " scaled")
            if n != N_HYB15:
                continue
            # the whole hybrid == the plain hybrid == the direct kernel, bit for bit
            f = stagesplit.fwd64_fused(x, n=n, p=p)
            compare_pair("fwd64_hyb", f, stagesplit.fwd64(x, n=n, p=p), what + " vs plain hybrid")
            compare_pair("fwd64_hyb", f, mxu64_cuda.fwd(x, n=n, p=p), what + " vs direct K5")
            i = stagesplit.inv64_fused(x, n=n, p=p, scale=sc)
            compare_pair("inv64_hyb", i, stagesplit.inv64(x, n=n, p=p, scale=sc),
                         what + " scaled vs plain hybrid")
            compare_pair("inv64_hyb", i, mxu64_cuda.inv(x, n=n, p=p, scale=sc),
                         what + " scaled vs direct K5")
    print(f"parity: K5h fwd {checks['fwd64_hyb']}, inv {checks['inv64_hyb']} checks exact at "
          f"B={B_HYB}, (regime, n) in {hyb_shapes}, n_h={N_H}, full-range limbs; at n={N_HYB15} "
          f"also the whole hybrid == plain hybrid == direct K5, in "
          f"{time.perf_counter() - t0:.1f} s; host build of the block tables (from the table "
          f"cache where it is warm): {', '.join(hyb_build)}", flush=True)

    t0 = time.perf_counter()
    for n, b in K7BC_SHAPES:
        x3 = (u32((3, b, n)), u32((3, b, n)))
        compare_pair("fwd_multi_perchannel64", mxu64_cuda.fwd_multi_perchannel64(*x3, P52),
                     mxu64_cuda.fwd_multi_perchannel64_plain(x3, P52), f"n={n} B={b}")
        for scs in ((1, 1, 1), tuple(scale64(n, p) for p in P52)):
            compare_pair("inv_multi64", mxu64_cuda.inv_multi(*x3, P52, scs),
                         mxu64_cuda.inv_multi_plain(x3, P52, scs),
                         f"n={n} B={b} scaled={scs != (1, 1, 1)}")
    n = N_HYB15
    x3, y3 = ((u32((3, B52, n)), u32((3, B52, n))) for _ in range(2))  # full-range u64
    scs = tuple(scale64(n, p) for p in P52)
    what = f"n={n} B={B52} n_h={N_H}"
    compare_pair("fwd_multi_perchannel64_hyb",
                 mxu64_cuda.fwd_multi_perchannel64(*x3, P52, n_h=N_H),
                 mxu64_cuda.fwd_multi_perchannel64_plain(x3, P52, N_H), what)
    compare_pair("inv_multi64_hyb", mxu64_cuda.inv_multi(*x3, P52, scs, n_h=N_H),
                 mxu64_cuda.inv_multi_plain(x3, P52, scs, N_H), what)
    compare_pair("pointwise_inv_multi64_hyb",
                 mxu64_cuda.pointwise_inv_multi(x3, y3, P52, scs, n_h=N_H),
                 mxu64_cuda.pointwise_inv_multi_plain(x3, y3, P52, scs, N_H), what)
    shared = (x3[0][0].contiguous(), x3[1][0].contiguous())
    compare_pair("fwd_multi_perchannel64_hyb", stagesplit.fwd_multi_hybrid64(shared, P52, n=n),
                 mxu64_cuda.fwd_multi(shared, P52), what + " hybrid vs K7a direct")
    k5_inv = [mxu64_cuda.inv((x3[0][c].contiguous(), x3[1][c].contiguous()), n=n, p=p,
                             scale=scs[c]) for c, p in enumerate(P52)]
    compare_pair("inv_multi64_hyb", stagesplit.inv_multi_hybrid64(*x3, P52, scs, n=n),
                 tuple(torch.stack([o[i] for o in k5_inv]) for i in range(2)),
                 what + " hybrid vs K5 direct")
    compare_pair("pointwise_inv_multi64_hyb",
                 stagesplit.pointwise_inv_multi_hybrid64(x3, y3, P52, scs, n=n),
                 mxu64_cuda.pointwise_inv_multi(x3, y3, P52, scs), what + " hybrid vs K7d direct")
    print(f"parity: K7c {checks['fwd_multi_perchannel64']}, K7b {checks['inv_multi64']} checks "
          f"exact at (n, B) in {K7BC_SHAPES}; with block tables at (n, B) = ({n}, {B52}): K7c "
          f"{checks['fwd_multi_perchannel64_hyb']}, K7b {checks['inv_multi64_hyb']}, K7d "
          f"{checks['pointwise_inv_multi64_hyb']} checks exact against the plain versions and "
          f"against K7a / K5 / K7d direct, primes {P52}, full-range u64 operands in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- 4. main paths ------------------------------------------------------------
    plan = native64.Plan32.try_new(N_MAIN)
    operands = [
        tuple(rng.integers(0, 1 << 64, (B_MAIN, N_MAIN), dtype=np.uint64) for _ in range(2))
        for _ in range(3)
    ]
    planar = lambda a: (
        torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        torch.from_numpy((a >> np.uint64(32)).astype(np.uint32)),
    )
    on_card = [tuple(tuple(t.to(dev) for t in planar(a)) for a in pair) for pair in operands]
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for lhs, rhs in on_card:
        before = counts()
        outs.append(plan.negacyclic_polymul(lhs, rhs))
        after = counts()
        require(after["fwd_wide_multi"] - before["fwd_wide_multi"] == 2
                and after["inv_multi"] - before["inv_multi"] == 1,
                f"main: launch counts moved {before} -> {after}")
    torch.cuda.synchronize()
    launches = counts()
    for i, ((a, b), out) in enumerate(zip(operands, outs)):
        got = limbs_to_np_u64(torch.stack([o.cpu() for o in out], dim=-1).numpy())
        cpu = plan.negacyclic_polymul(planar(a), planar(b))
        want = limbs_to_np_u64(torch.stack(cpu, dim=-1).numpy())
        require(got.shape == (B_MAIN, N_MAIN) and np.array_equal(got, want),
                f"main: call {i} differs from the CPU plain path")
        require(np.array_equal(got[0], negacyclic_convolution_wrapping_np(a[0], b[0])),
                f"main: call {i} row 0 differs from the numpy wrapping oracle")
    print(f"main: 3 x Plan32({N_MAIN}).negacyclic_polymul B={B_MAIN} on {kind} == CPU plain "
          f"path == numpy oracle (row 0); launches {launches}", flush=True)

    def expect_delta(before: dict, want: dict, what: str) -> None:
        after = counts()
        delta = {k: after[k] - before[k] for k in after}
        require(all(delta[k] == want.get(k, 0) for k in delta),
                f"main: {what} moved the launch counters by {delta}, expected {want}")

    # the device rule: a default-constructed plan moves numpy input to the card
    require(plan.device == "cuda", f"main: default plan device is {plan.device!r}, not the card")
    torch.cuda.synchronize()
    reset_counts()
    np_out = plan.negacyclic_polymul(*operands[0])
    rule = counts()
    require(rule["fwd_wide_multi"] == 2 and rule["inv_multi"] == 1,
            f"main: a numpy-input polymul on a default plan launched {rule}")
    require(isinstance(np_out, np.ndarray) and np.array_equal(
        np_out, limbs_to_np_u64(torch.stack([o.cpu() for o in outs[0]], dim=-1).numpy())),
        "main: numpy-input polymul differs from the planar one")
    print(f"main: device rule: Plan32 default device {plan.device!r}, numpy-input polymul "
          f"launched K1a x{rule['fwd_wide_multi']}, K1b x{rule['inv_multi']}", flush=True)

    host = lambda a: torch.from_numpy(a)
    p32_cases = []
    for name, p in BENCH_PRIMES.items():
        pl = prime32.Plan.new(N32, p)
        lhs, rhs = (rng.integers(0, p, (B32, N32), dtype=np.uint32) for _ in range(2))
        p32_cases.append((name, pl, lhs, rhs))
    mid = prime32.Plan.new(4096, BENCH_PRIMES["lt30"])
    mid_ops = tuple(rng.integers(0, mid.p, (B32, 4096), dtype=np.uint32) for _ in range(2))
    small = prime32.Plan.new(1024, 1073479681)
    small_ops = tuple(rng.integers(0, small.p, (B32, 1024), dtype=np.uint32) for _ in range(2))
    readme = prime32.Plan.new(32, 1062862849)
    readme_x = np.arange(32, dtype=np.uint32)[None]
    torch.cuda.synchronize()
    reset_counts()
    p32_out = []
    for name, pl, lhs, rhs in p32_cases:
        before = counts()
        got = pl.negacyclic_polymul(host(lhs).to(dev), host(rhs).to(dev))
        expect_delta(before, {"fwd": 2, "inv": 1}, f"Plan({N32}, {pl.p}) polymul")
        before = counts()
        rt = pl.inv(pl.fwd(host(lhs).to(dev)))
        expect_delta(before, {"fwd": 1, "inv": 1}, f"Plan({N32}, {pl.p}) round trip")
        p32_out.append((got, rt))
    before = counts()
    mid_got = mid.negacyclic_polymul(*(host(a).to(dev) for a in mid_ops))
    expect_delta(before, {"fwd": 2, "inv": 1}, f"Plan(4096, {mid.p}) polymul")
    before = counts()
    small_got = small.negacyclic_polymul(*(host(a).to(dev) for a in small_ops))
    expect_delta(before, {"butterfly32_fwd": 2, "butterfly32_inv": 1},
                 f"Plan(1024, {small.p}) polymul")
    before = counts()
    readme_rt = readme.inv(readme.fwd(host(readme_x).to(dev)))
    expect_delta(before, {"butterfly32_fwd": 1, "butterfly32_inv": 1}, "README vector")
    torch.cuda.synchronize()
    launches32 = counts()
    for (name, pl, lhs, rhs), (got, rt) in zip(p32_cases, p32_out):
        want = pl.negacyclic_polymul(host(lhs), host(rhs))
        require(got.device.type == "cuda" and got.shape == (B32, N32)
                and torch.equal(got.cpu(), want),
                f"main: Plan({N32}, {pl.p}) polymul differs from the CPU plain path")
        nx = (lhs.astype(np.uint64) * N32 % pl.p).astype(np.uint32)
        require(np.array_equal(rt.cpu().numpy(), nx),
                f"main: Plan({N32}, {pl.p}) inv(fwd(x)) != n·x mod p")
    require(torch.equal(mid_got.cpu(), mid.negacyclic_polymul(*map(host, mid_ops))),
            "main: Plan(4096) polymul differs from the CPU plain path")
    small_cpu = small.negacyclic_polymul(*map(host, small_ops))
    require(torch.equal(small_got.cpu(), small_cpu),
            "main: Plan(1024) polymul differs from the CPU plain path")
    require(small_got[0].cpu().tolist() == negacyclic_convolution_mod(
        small_ops[0][0].tolist(), small_ops[1][0].tolist(), small.p),
        "main: Plan(1024) polymul row 0 differs from the schoolbook oracle")
    require(np.array_equal(readme_rt.cpu().numpy(),
                           (readme_x.astype(np.uint64) * 32 % readme.p).astype(np.uint32)),
            "main: README vector (N=32, p=1062862849) round trip != N·x")
    for k in ("fwd", "inv", "butterfly32_fwd", "butterfly32_inv"):
        launches[k] = launches32[k]
    print(f"main: prime32 polymuls on {kind}: Plan({N32}, p) B={B32} for p in "
          f"{tuple(BENCH_PRIMES.values())} == CPU plain path, inv(fwd(x)) == n·x; "
          f"Plan(4096) == CPU; Plan(1024) == CPU == schoolbook oracle (row 0); README "
          f"vector round trip; launches {launches32}", flush=True)

    n_sh = 4096
    sharded = []
    for p in BENCH_PRIMES.values():
        tbl = mxu32._mxu_tables(n_sh, p)
        geo = dict(n=n_sh, n1=tbl["n1"], n2=tbl["n2"], p=p)
        d, e = (tuple(torch.from_numpy(a).to(dev) for a in tbl[k]) for k in ("d", "e"))
        sharded.append((geo, d, e, rng.integers(0, p, (B32, n_sh), dtype=np.uint32)))
    torch.cuda.synchronize()
    reset_counts()
    sh_out = []
    for geo, d, e, x in sharded:
        before = counts()
        f = rank_local_fwd(mxu32_cuda.pass_matmod, host(x).to(dev), d, **geo)
        sh_out.append((f, rank_local_inv(mxu32_cuda.pass_matmod, f, e, **geo)))
        expect_delta(before, {"pass_matmod": 4 * RANKS},
                     f"rank-local passes n={n_sh} p={geo['p']}")
    torch.cuda.synchronize()
    launches_k3 = counts()
    for (geo, d, e, x), (f, back) in zip(sharded, sh_out):
        p = geo["p"]
        require(f.device.type == "cuda" and torch.equal(
            f.cpu(), mxu32_cuda.fwd_plain(host(x), n=n_sh, p=p)),
            f"main: rank-local fwd n={n_sh} p={p} differs from the CPU plain path")
        require(np.array_equal(back.cpu().numpy(),
                               (x.astype(np.uint64) * n_sh % p).astype(np.uint32)),
                f"main: rank-local inv(fwd(x)) != n·x mod p at n={n_sh} p={p}")
    launches["pass_matmod"] = launches_k3["pass_matmod"]
    print(f"main: rank-local passes on {kind}: fwd and inv at n={n_sh} B={B32}, R={RANKS} "
          f"ranks, for p in {tuple(BENCH_PRIMES.values())} == CPU plain path, "
          f"inv(fwd(x)) == n·x; launches {launches_k3}", flush=True)

    f1, f2 = PRIMES[0], PRIMES[1]
    pplan = product.Plan.new(N_PROD, f1 * f2, (f1, f2))
    m = pplan.modulus
    pa, pb, pacc = (rand_mod(rng, m, (B_PROD, N_PROD)) for _ in range(3))
    px = centred(rng, m, (B_PROD, N_PROD))
    sm_plan = product.Plan.new(N_PROD_SMALL, m, (f1, f2))
    sa, sb = (rand_mod(rng, m, (2, N_PROD_SMALL)) for _ in range(2))
    keys = [rand_mod(rng, m, (B_PROD, N_PROD)) for _ in range(PBS_TERMS)]
    digits = [centred(rng, m, (B_PROD, N_PROD)) for _ in range(PBS_TERMS)]
    k2plan = product.Plan.new(N_PROD, K2_PAIR[0] * K2_PAIR[1], K2_PAIR)
    ka, kb = (rand_mod(rng, k2plan.modulus, (B_PROD, N_PROD)) for _ in range(2))
    card = lambda v: u64_limbs(v).to(dev)
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

    torch.cuda.synchronize()
    reset_counts()
    fused = {"fwd_wide_multi": 2, "pointwise_inv_multi": 1}
    before = counts()
    p_rep = pplan.negacyclic_polymul(d_pa, d_pb)
    expect_delta(before, fused, "product Replace polymul")
    before = counts()
    p_acc = pplan.negacyclic_polymul(d_pa, d_pb, mode=acc, standard=d_pacc)
    expect_delta(before, fused, "product Accumulate polymul")
    before = counts()
    p_bnd = pplan.negacyclic_polymul(d_px, d_pb, mode=acc, standard=d_pacc, lhs_fwd_mode=bnd)
    expect_delta(before, {"fwd_multi_perchannel": 1, "fwd_wide_multi": 1,
                          "pointwise_inv_multi": 1}, "product Bounded polymul")
    before = counts()
    p_dom = pplan.fwd(d_px, bnd)
    expect_delta(before, {"fwd_multi_perchannel": 1}, "product fwd(bounded)")
    before = counts()
    p_back = pplan.inv(p_dom, out_format="limbs")
    expect_delta(before, {"inv_multi": 1}, "product inv")
    before = counts()
    p_small = sm_plan.negacyclic_polymul(card(sa), card(sb))
    expect_delta(before, fused, f"product n={N_PROD_SMALL} polymul")
    before = counts()
    p_pbs = pbs_loop(pplan, d_digits, pre, d_pacc)
    expect_delta(before, {"fwd_multi_perchannel": PBS_TERMS, "inv_multi": 1}, "PBS loop")
    before = counts()
    p_k2 = k2plan.negacyclic_polymul(card(ka), card(kb))
    expect_delta(before, {"fwd": 4, "inv": 2}, f"product {K2_PAIR} polymul")
    torch.cuda.synchronize()
    launches_prod = counts()
    wants = [
        ("Replace", p_rep, pplan.negacyclic_polymul(u64_limbs(pa), u64_limbs(pb))),
        ("Accumulate", p_acc, pplan.negacyclic_polymul(u64_limbs(pa), u64_limbs(pb), mode=acc,
                                                       standard=u64_limbs(pacc))),
        ("Bounded", p_bnd, pplan.negacyclic_polymul(u64_limbs(px), u64_limbs(pb), mode=acc,
                                                    standard=u64_limbs(pacc), lhs_fwd_mode=bnd)),
        ("fwd(bounded)", p_dom.res32, pplan.fwd(u64_limbs(px), bnd).res32),
        ("inv", p_back, pplan.inv(pplan.fwd(u64_limbs(px), bnd), out_format="limbs")),
        (f"n={N_PROD_SMALL}", p_small, sm_plan.negacyclic_polymul(u64_limbs(sa), u64_limbs(sb))),
        ("PBS loop", p_pbs, pbs_loop(pplan, [u64_limbs(d) for d in digits],
                                     [product.NttDomain(k.res32.cpu()) for k in pre], u64_limbs(pacc))),
        (f"{K2_PAIR}", p_k2, k2plan.negacyclic_polymul(u64_limbs(ka), u64_limbs(kb))),
    ]
    for what, got, want in wants:
        require(got.device.type == "cuda" and got.shape == want.shape
                and torch.equal(got.cpu(), want),
                f"main: product {what} differs from the CPU plain path")
    row0 = limbs_to_np_u64(p_small[0].cpu().numpy()).tolist()
    require(row0 == negacyclic_convolution_mod(sa[0].tolist(), sb[0].tolist(), m),
            f"main: product n={N_PROD_SMALL} polymul row 0 differs from the schoolbook oracle")
    nx = [int(v) * N_PROD % m for v in px[0]]
    require(limbs_to_np_u64(p_back[0].cpu().numpy()).tolist() == nx,
            "main: product inv(fwd(x, bounded)) != n·x mod m (row 0)")
    for k in ("fwd_multi_perchannel", "pointwise_inv_multi"):
        launches[k] = launches_prod[k]
    print(f"main: product on {kind}: Plan({N_PROD}, {f1}·{f2}) B={B_PROD} polymul Replace, "
          f"Accumulate, Bounded b={BOUND}, fwd(bounded), inv == CPU plain path; Plan("
          f"{N_PROD_SMALL}) polymul == CPU == schoolbook oracle (row 0); PBS loop of "
          f"{PBS_TERMS} terms == CPU; Plan({N_PROD}, {K2_PAIR}) polymul via K2 == CPU; "
          f"launches {launches_prod}", flush=True)

    # prime64: K5 through the plan, per regime
    p64_cases = []
    for rname, p in PRIMES64.items():
        pl = prime64.Plan.new(N64, p)
        lhs, rhs = (rand_mod(rng, p, (B64, N64)) for _ in range(2))
        p64_cases.append((rname, pl, lhs, rhs))
    small64 = prime64.Plan.new(1024, PRIMES52[0])
    small64_ops = tuple(rand_mod(rng, small64.p, (B64, 1024)) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    p64_out = []
    for rname, pl, lhs, rhs in p64_cases:
        before = counts()
        got = pl.negacyclic_polymul(card(lhs), card(rhs))
        expect_delta(before, {"fwd64": 2, "inv64": 1}, f"prime64 Plan({N64}, {pl.p}) polymul")
        before = counts()
        rt = pl.inv(pl.fwd(card(lhs)))
        expect_delta(before, {"fwd64": 1, "inv64": 1}, f"prime64 Plan({N64}, {pl.p}) round trip")
        p64_out.append((got, rt))
    before = counts()
    small64_got = small64.negacyclic_polymul(*(card(a) for a in small64_ops))
    expect_delta(before, {}, "prime64 Plan(1024) polymul (stage engine)")
    torch.cuda.synchronize()
    launches64 = counts()
    for (rname, pl, lhs, rhs), (got, rt) in zip(p64_cases, p64_out):
        want = prime64.Plan.new(N64, pl.p, device="cpu").negacyclic_polymul(
            u64_limbs(lhs), u64_limbs(rhs))
        require(got.device.type == "cuda" and got.shape == (B64, N64, 2)
                and torch.equal(got.cpu(), want),
                f"main: prime64 Plan({N64}, {pl.p}) polymul differs from the CPU plain path")
        nx = np.array([int(v) * N64 % pl.p for v in lhs[0]], dtype=np.uint64)
        require(np.array_equal(limbs_to_np_u64(rt[0].cpu().numpy()), nx),
                f"main: prime64 Plan({N64}, {pl.p}) inv(fwd(x)) != n·x mod p (row 0)")
    require(small64_got.device.type == "cuda" and torch.equal(
        small64_got.cpu(), prime64.Plan.new(1024, small64.p, device="cpu").negacyclic_polymul(
            *(u64_limbs(a) for a in small64_ops))),
        "main: prime64 Plan(1024) polymul differs from the CPU plain path")
    require(limbs_to_np_u64(small64_got[0].cpu().numpy()).tolist() == negacyclic_convolution_mod(
        small64_ops[0][0].tolist(), small64_ops[1][0].tolist(), small64.p),
        "main: prime64 Plan(1024) polymul row 0 differs from the schoolbook oracle")
    for k in ("fwd64", "inv64"):
        launches[k] = launches64[k]
    print(f"main: prime64 polymuls on {kind}: Plan({N64}, p) B={B64} for p in "
          f"{tuple(PRIMES64.values())} == CPU plain path, inv(fwd(x)) == n·x; Plan(1024, "
          f"{small64.p}) through the stage engine == CPU == schoolbook oracle (row 0); "
          f"launches {launches64}", flush=True)

    sharded64 = []
    for p in PRIMES64.values():
        tbl = mxu64._tables(n_sh, p)
        geo = dict(n=n_sh, n1=tbl["n1"], n2=tbl["n2"], p=p)
        d, e = (tuple(torch.from_numpy(a).to(dev) for a in tbl[k]) for k in ("d", "e"))
        sharded64.append((geo, d, e, rand_mod(rng, p, (B64, n_sh))))
    pair_of = lambda v: tuple(t.contiguous() for t in card(v).unbind(-1))
    torch.cuda.synchronize()
    reset_counts()
    sh64_out = []
    for geo, d, e, x in sharded64:
        before = counts()
        f = rank_local_fwd64(mxu64_cuda.pass_matmod64, pair_of(x), d, **geo)
        sh64_out.append((f, rank_local_inv64(mxu64_cuda.pass_matmod64, f, e, **geo)))
        expect_delta(before, {"pass_matmod64": 4 * RANKS},
                     f"rank-local 64-bit passes n={n_sh} p={geo['p']}")
    torch.cuda.synchronize()
    launches_k6 = counts()
    for (geo, d, e, x), (f, back) in zip(sharded64, sh64_out):
        p = geo["p"]
        want = mxu64_cuda.fwd_plain(tuple(t.contiguous() for t in u64_limbs(x).unbind(-1)),
                                    n=n_sh, p=p)
        require(all(g.device.type == "cuda" and torch.equal(g.cpu(), w) for g, w in zip(f, want)),
                f"main: rank-local 64-bit fwd n={n_sh} p={p} differs from the CPU plain path")
        got = limbs_to_np_u64(torch.stack([t.cpu() for t in back], dim=-1).numpy())
        nx = np.array([int(v) * n_sh % p for v in x[0]], dtype=np.uint64)
        require(np.array_equal(got[0], nx),
                f"main: rank-local 64-bit inv(fwd(x)) != n·x mod p at n={n_sh} p={p} (row 0)")
    launches["pass_matmod64"] = launches_k6["pass_matmod64"]
    print(f"main: rank-local 64-bit passes on {kind}: fwd and inv at n={n_sh} B={B64}, "
          f"R={RANKS} ranks, five primes == CPU plain path, inv(fwd(x)) == n·x; launches "
          f"{launches_k6}", flush=True)

    # Plan52: K7a, K7d (polymul, fwd), K5 (inv), held against Plan32
    plan52 = native64.Plan52.try_new(N64)
    ops52 = [tuple(rng.integers(0, 1 << 64, (B52, N64), dtype=np.uint64) for _ in range(2))
             for _ in range(2)]
    card52 = [tuple(tuple(t.to(dev) for t in planar(a)) for a in pair) for pair in ops52]
    torch.cuda.synchronize()
    reset_counts()
    outs52 = []
    for lhs, rhs in card52:
        before = counts()
        outs52.append(plan52.negacyclic_polymul(lhs, rhs))
        expect_delta(before, {"fwd_multi64": 2, "pointwise_inv_multi64": 1}, "Plan52 polymul")
    before = counts()
    res52 = plan52.fwd(card52[0][0])
    expect_delta(before, {"fwd_multi64": 1}, "Plan52 fwd")
    before = counts()
    back52 = plan52.inv(res52, out_format="planar")
    expect_delta(before, {"inv64": 3}, "Plan52 inv")
    torch.cuda.synchronize()
    launches52 = counts()
    before = counts()
    outs32 = [plan.negacyclic_polymul(lhs, rhs) for lhs, rhs in card52]
    expect_delta(before, {"fwd_wide_multi": 4, "inv_multi": 2}, "Plan32 on the Plan52 inputs")
    plan52_cpu = native64.Plan52.try_new(N64, device="cpu")
    as_np = lambda pr: limbs_to_np_u64(torch.stack([t.cpu() for t in pr], dim=-1).numpy())
    for i, ((a, b), out) in enumerate(zip(ops52, outs52)):
        got = as_np(out)
        require(out[0].device.type == "cuda" and got.shape == (B52, N64)
                and np.array_equal(got, as_np(plan52_cpu.negacyclic_polymul(planar(a), planar(b)))),
                f"main: Plan52 call {i} differs from the CPU plain path")
        require(np.array_equal(got[0], negacyclic_convolution_wrapping_np(a[0], b[0])),
                f"main: Plan52 call {i} row 0 differs from the numpy wrapping oracle")
        require(np.array_equal(got, as_np(outs32[i])),
                f"main: Plan52 call {i} differs from Plan32 on the same inputs")
    require(tuple(res52.shape) == (3, B52, N64, 2) and torch.equal(
        res52.cpu(), plan52_cpu.fwd(planar(ops52[0][0]))),
        "main: Plan52 fwd differs from the CPU plain path")
    require(np.array_equal(as_np(back52), ops52[0][0] * np.uint64(N64)),
            "main: Plan52 inv(fwd(x)) != n·x (wrapping)")
    for k in ("fwd_multi64", "pointwise_inv_multi64"):
        launches[k] = launches52[k]
    launches["inv64"] += launches52["inv64"]
    print(f"main: 2 x Plan52({N64}).negacyclic_polymul B={B52} on {kind} == CPU plain path == "
          f"numpy oracle (row 0) == Plan32 on the same inputs; fwd == CPU, inv(fwd(x)) == n·x; "
          f"launches {launches52}", flush=True)

    # product with one u32 and one u64 factor: the u64 channel through K5
    mix = (PRIMES[0], prime_in_ap(1 << 15, 1, 1 << 33, 1 << 34))
    mplan = product.Plan.new(N_PROD, mix[0] * mix[1], mix)
    ma, mb = (rand_mod(rng, mplan.modulus, (B_PROD, N_PROD)) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    p_mix = mplan.negacyclic_polymul(card(ma), card(mb))
    expect_delta(before, {"fwd_wide_multi": 2, "inv_multi": 1, "fwd64": 2, "inv64": 1},
                 f"product {mix} polymul")
    require(p_mix.device.type == "cuda" and torch.equal(
        p_mix.cpu(), product.Plan.new(N_PROD, mplan.modulus, mix, device="cpu").negacyclic_polymul(
            u64_limbs(ma), u64_limbs(mb))),
        f"main: product {mix} polymul differs from the CPU plain path")
    print(f"main: product Plan({N_PROD}, {mix}) B={B_PROD} polymul (u32 channel K1a / K1b, u64 "
          f"channel K5) == CPU plain path; launches {counts()}", flush=True)

    # prime64 above 2^15: the stage-split hybrid through default-device plans,
    # numpy uint64 in and out
    hyb_cases = []
    for n in HYB_SIZES:
        for rname, p in HYB64.items():
            if n == 1 << 17 and rname not in HYB_BIG:
                continue
            pl = prime64.Plan.new(n, p)
            lhs, rhs = (rand_mod(rng, p, (B_HYB, n)) for _ in range(2))
            hyb_cases.append((rname, pl, lhs, rhs))
    pp = prime_in_ap(1 << 17, 1, 1 << 40, 1 << 41)
    hplan = product.Plan.new(1 << 16, pp, (pp,))
    ha, hb = (rand_mod(rng, pp, (4, 1 << 16)) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    hyb_out = []
    for rname, pl, lhs, rhs in hyb_cases:
        require(pl.device == "cuda", f"main: default prime64 plan device is {pl.device!r}")
        what = f"prime64 Plan({pl.n}, {pl.p})"
        before = counts()
        got = pl.negacyclic_polymul(lhs, rhs)
        expect_delta(before, {"fwd64_hyb": 2, "inv64_hyb": 1}, what + " polymul")
        before = counts()
        f = pl.fwd(lhs)
        expect_delta(before, {"fwd64_hyb": 1}, what + " fwd")
        before = counts()
        rt = pl.inv(f)
        expect_delta(before, {"inv64_hyb": 1}, what + " inv")
        hyb_out.append((got, f, rt))
    before = counts()
    h_got = hplan.negacyclic_polymul(card(ha), card(hb))
    expect_delta(before, {"fwd64_hyb": 2, "inv64_hyb": 1}, f"product Plan(65536, ({pp},)) polymul")
    torch.cuda.synchronize()
    launches_hyb = counts()
    t0 = time.perf_counter()
    for (rname, pl, lhs, rhs), (got, f, rt) in zip(hyb_cases, hyb_out):
        n, p = pl.n, pl.p
        rows = B_HYB if n == 1 << 16 else CPU_ROWS_BIG
        cpu = prime64.Plan.new(n, p, device="cpu")
        require(isinstance(got, np.ndarray) and got.shape == (B_HYB, n) and np.array_equal(
            got[:rows], cpu.negacyclic_polymul(lhs[:rows], rhs[:rows])),
            f"main: prime64 Plan({n}, {p}) polymul differs from the CPU plain path")
        require(np.array_equal(f[:2], cpu.fwd(lhs[:2])),
                f"main: prime64 Plan({n}, {p}) fwd differs from the CPU plain path")
        require(np.array_equal(rt[:2], cpu.inv(f[:2])),
                f"main: prime64 Plan({n}, {p}) inv differs from the CPU plain path")
        nx = np.array([int(v) * n % p for v in lhs[0]], dtype=np.uint64)
        require(np.array_equal(rt[0], nx), f"main: prime64 Plan({n}, {p}) inv(fwd(x)) != n·x mod p")
        ao, bo = lhs[0].astype(object), rhs[0].astype(object)
        for k in (0, 1, n // 2 + 7, n - 1):
            require(int(got[0, k]) == negacyclic_coeff(ao, bo, k, p),
                    f"main: prime64 Plan({n}, {p}) polymul coefficient {k} of row 0 differs "
                    "from its direct sum")
    require(h_got.device.type == "cuda" and torch.equal(
        h_got.cpu(), product.Plan.new(1 << 16, pp, (pp,), device="cpu").negacyclic_polymul(
            u64_limbs(ha), u64_limbs(hb))),
        f"main: product Plan(65536, ({pp},)) polymul differs from the CPU plain path")
    for k in ("fwd64_hyb", "inv64_hyb"):
        launches[k] = launches_hyb[k]
    print(f"main: prime64 hybrid on {kind}: Plan(n, p) B={B_HYB} numpy input on default plans, "
          f"(n, regime) in {[(pl.n, r) for r, pl, *_ in hyb_cases]}: polymul, fwd, inv == CPU "
          f"plain path (all rows at 65536, {CPU_ROWS_BIG} at 131072), inv(fwd(x)) == n·x, 4 "
          f"sampled coefficients == direct sums; product Plan(65536, ({pp},)) == CPU; launches "
          f"{launches_hyb}; checks {time.perf_counter() - t0:.1f} s", flush=True)

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

    res_x = tuple(torch.stack([t.to(dev) for t in parts]) for parts in zip(
        *(planar(rand_mod(rng, q, (B52, N64))) for q in P52)))  # canonical residues [3, B, n]
    n_inv = tuple(pow(N64, q - 2, q) for q in P52)
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    hyb52 = hybrid52_polymul(l15, r15)
    expect_delta(before, {"fwd_multi_perchannel64_hyb": 2, "pointwise_inv_multi64_hyb": 1},
                 "channel-grid hybrid polymul")
    before = counts()
    f15 = stagesplit.fwd_multi_hybrid64(l15, P52, n=n15)
    back15 = stagesplit.inv_multi_hybrid64(*f15, P52, (1, 1, 1), n=n15)
    expect_delta(before, {"fwd_multi_perchannel64_hyb": 1, "inv_multi64_hyb": 1},
                 "channel-grid hybrid round trip")
    before = counts()
    rt14 = mxu64_cuda.inv_multi(*mxu64_cuda.fwd_multi_perchannel64(*res_x, P52), P52, n_inv)
    expect_delta(before, {"fwd_multi_perchannel64": 1, "inv_multi64": 1},
                 "per-channel round trip (K7c, K7b)")
    torch.cuda.synchronize()
    launches_ch = counts()
    before = counts()
    direct52 = plan52_15.negacyclic_polymul(l15, r15)
    expect_delta(before, {"fwd_multi64": 2, "pointwise_inv_multi64": 1}, "Plan52(32768) polymul")
    cpu52 = native64.Plan52.try_new(n15, device="cpu").negacyclic_polymul(
        tuple(t[:2] for t in planar(a15)), tuple(t[:2] for t in planar(b15)))
    require(hyb52[0].device.type == "cuda" and np.array_equal(as_np(hyb52), as_np(direct52)),
            "main: channel-grid hybrid polymul differs from Plan52's direct route")
    require(np.array_equal(as_np(hyb52)[:2], as_np(cpu52)),
            "main: channel-grid hybrid polymul differs from the CPU plain path")
    require(np.array_equal(as_np(plan52_15._lift(back15, (B52,), "planar")),
                           a15 * np.uint64(n15)),
            "main: channel-grid hybrid inv(fwd(x)) != n·x (wrapping)")
    require(all(torch.equal(g, w) for g, w in zip(rt14, res_x)),
            "main: per-channel round trip K7b(K7c(x), n^-1) != x")
    for k in ("fwd_multi_perchannel64_hyb", "pointwise_inv_multi64_hyb", "inv_multi64_hyb",
              "fwd_multi_perchannel64", "inv_multi64"):
        launches[k] = launches_ch[k]
    print(f"main: channel-grid hybrid on {kind}: n={n15} n_h={N_H} B={B52} primes {P52}: "
          f"polymul == Plan52 direct == CPU plain path (2 rows), inv(fwd(x)) == n·x; K7c / K7b "
          f"round trip at n={N64} == x; launches {launches_ch}", flush=True)

    # -- 5. times -----------------------------------------------------------------
    ms, plain_ms = {}, {}
    limbs = (u32((B_MAIN, N_MAIN)), u32((B_MAIN, N_MAIN)))
    x = u32((len(PRIMES), B_MAIN, N_MAIN))
    scaled = tuple(pow(N_MAIN, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
    ms["fwd_wide_multi"] = median_ms(lambda: mxu32_cuda.fwd_wide_multi(limbs, PRIMES))
    ms["inv_multi"] = median_ms(lambda: mxu32_cuda.inv_multi(x, PRIMES, scaled))
    plain_ms["fwd_wide_multi"] = median_ms(
        lambda: mxu32_cuda.fwd_wide_multi_plain(limbs, PRIMES))
    plain_ms["inv_multi"] = median_ms(lambda: mxu32_cuda.inv_multi_plain(x, PRIMES, scaled))
    lhs, rhs = on_card[0]
    poly_ms = median_ms(lambda: plan.negacyclic_polymul(lhs, rhs))
    shape = {"fwd_wide_multi": "2 limbs", "inv_multi": "scaled"}
    for k in ("fwd_wide_multi", "inv_multi"):
        print(f"times: {k} n={N_MAIN} B={B_MAIN} {shape[k]}: kernel {ms[k]:.4f} ms, "
              f"plain {plain_ms[k]:.4f} ms (median of {REPS}) | {smi}", flush=True)
    print(f"times: native64 polymul n={N_MAIN} B={B_MAIN} planar: {poly_ms:.4f} ms (median of "
          f"{REPS}) = {B_MAIN / poly_ms * 1e3:.1f} products/s | {smi}", flush=True)

    def timed(name, label, kernel, plain, key=None):
        t, tp = median_ms(kernel), median_ms(plain)
        if key:
            ms[key], plain_ms[key] = t, tp
        print(f"times: {name} {label}: kernel {t:.4f} ms, plain {tp:.4f} ms "
              f"(median of {REPS}) | {smi}", flush=True)

    for rname, p in BENCH_PRIMES.items():
        x = u32((B32, N32), p)
        headline = rname == "lt30"
        timed("K2 fwd", f"n={N32} B={B32} p={p} ({rname})",
              lambda: mxu32_cuda.fwd(x, n=N32, p=p), lambda: mxu32_cuda.fwd_plain(x, n=N32, p=p),
              "fwd" if headline else None)
        timed("K2 inv", f"n={N32} B={B32} p={p} ({rname})",
              lambda: mxu32_cuda.inv(x, n=N32, p=p), lambda: mxu32_cuda.inv_plain(x, n=N32, p=p),
              "inv" if headline else None)
    p = BENCH_PRIMES["lt30"]
    tbl = mxu32._mxu_tables(4096, p)
    dg = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])
    xa = u32((B32, tbl["n2"], tbl["n1"]))
    kw = dict(n=4096, p=p, which="A", diag_slices=dg)
    timed("K3 pass_matmod", f"A scaled n=4096 B={B32} p={p}",
          lambda: mxu32_cuda.pass_matmod(xa, **kw), lambda: mxu32_cuda.pass_matmod_plain(xa, **kw),
          "pass_matmod")
    x = u32((B32, 4096), p)
    timed("K2 fwd (passes_engine)", f"n=4096 B={B32} p={p}",
          lambda: mxu32_cuda.passes_engine.fwd(x, n=4096, p=p),
          lambda: mxu32_cuda.fwd_plain(x, n=4096, p=p))
    for n, p in ((1024, BENCH_PRIMES["lt30"]), (N32, SMALL_P)):
        pl = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=pl.variant, p_neginv=pl.p_neginv)
        x = u32((B32, n), p)
        headline = n == 1024
        timed("K4 fwd", f"n={n} B={B32} p={p}", lambda: bcu.try_fwd(x, pl._tbl, **kw),
              lambda: bcu.fwd_plain(x, pl._tbl, **kw), "butterfly32_fwd" if headline else None)
        timed("K4 inv", f"n={n} B={B32} p={p}", lambda: bcu.try_inv(x, pl._tbl, **kw),
              lambda: bcu.inv_plain(x, pl._tbl, **kw), "butterfly32_inv" if headline else None)
    for name, pl, lhs, rhs in p32_cases:
        a, b = host(lhs).to(dev), host(rhs).to(dev)
        t = median_ms(lambda: pl.negacyclic_polymul(a, b))
        print(f"times: prime32 polymul n={N32} B={B32} p={pl.p} ({name}): {t:.4f} ms (median "
              f"of {REPS}) = {B32 / t * 1e3:.1f} products/s | {smi}", flush=True)

    xs = (u32((2, B_PROD, N_PROD)), u32((2, B_PROD, N_PROD)))
    sc2 = tuple(pow(N_PROD, p - 2, p) * pow(2, 32, p) % p for p in p2)
    timed("K1c fwd_multi_perchannel", f"n={N_PROD} B={B_PROD} C=2 1 limb",
          lambda: mxu32_cuda.fwd_multi_perchannel(xs[0], p2),
          lambda: mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], p2), "fwd_multi_perchannel")
    timed("K1d pointwise_inv_multi", f"n={N_PROD} B={B_PROD} C=2 scaled",
          lambda: mxu32_cuda.pointwise_inv_multi(*xs, p2, sc2),
          lambda: mxu32_cuda.pointwise_inv_multi_plain(*xs, p2, sc2), "pointwise_inv_multi")

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

    for rname, p in PRIMES64.items():
        x = (u32((B64, N64)), u32((B64, N64)))
        sc = scale64(N64, p)
        headline = rname == "goldilocks"
        timed("K5 fwd64", f"n={N64} B={B64} p={p} ({rname})",
              lambda: mxu64_cuda.fwd(x, n=N64, p=p), lambda: mxu64_cuda.fwd_plain(x, n=N64, p=p),
              "fwd64" if headline else None)
        timed("K5 inv64", f"n={N64} B={B64} p={p} ({rname}) scaled",
              lambda: mxu64_cuda.inv(x, n=N64, p=p, scale=sc),
              lambda: mxu64_cuda.inv_plain(x, n=N64, p=p, scale=sc),
              "inv64" if headline else None)
    p = PRIMES64["p50"]
    tbl64 = mxu64._tables(4096, p)
    dg64 = tuple(torch.from_numpy(a).to(dev) for a in tbl64["d"])
    xa64 = (u32((B64, tbl64["n2"], tbl64["n1"])), u32((B64, tbl64["n2"], tbl64["n1"])))
    kw = dict(n=4096, p=p, which="A", diag_slices=dg64)
    timed("K6 pass_matmod64", f"A scaled n=4096 B={B64} p={p}",
          lambda: mxu64_cuda.pass_matmod64(xa64, **kw),
          lambda: mxu64_cuda.pass_matmod64_plain(xa64, **kw), "pass_matmod64")
    x52 = (u32((B52, N64)), u32((B52, N64)))
    fl52, fr52 = ((u32((3, B52, N64)), u32((3, B52, N64))) for _ in range(2))
    sc52 = tuple(scale64(N64, q) for q in P52)
    timed("K7a fwd_multi64", f"n={N64} B={B52} C=3",
          lambda: mxu64_cuda.fwd_multi(x52, P52), lambda: mxu64_cuda.fwd_multi_plain(x52, P52),
          "fwd_multi64")
    timed("K7d pointwise_inv_multi64", f"n={N64} B={B52} C=3 scaled",
          lambda: mxu64_cuda.pointwise_inv_multi(fl52, fr52, P52, sc52),
          lambda: mxu64_cuda.pointwise_inv_multi_plain(fl52, fr52, P52, sc52),
          "pointwise_inv_multi64")

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
            headline = n == 1 << 16 and rname == "goldilocks"
            timed("K5h fwd64_hyb", f"n={n} B={B_HYB} p={p} ({rname})",
                  lambda: mxu64_cuda.fwd_hyb(x, **kw), lambda: mxu64_cuda.fwd_hyb_plain(x, **kw),
                  "fwd64_hyb" if headline else None)
            timed("K5h inv64_hyb", f"n={n} B={B_HYB} p={p} ({rname}) scaled",
                  lambda: mxu64_cuda.inv_hyb(x, scale=sc, **kw),
                  lambda: mxu64_cuda.inv_hyb_plain(x, scale=sc, **kw),
                  "inv64_hyb" if headline else None)
    xc = (u32((3, B52, N64)), u32((3, B52, N64)))
    timed("K7c fwd_multi_perchannel64", f"n={N64} B={B52} C=3",
          lambda: mxu64_cuda.fwd_multi_perchannel64(*xc, P52),
          lambda: mxu64_cuda.fwd_multi_perchannel64_plain(xc, P52), "fwd_multi_perchannel64")
    timed("K7b inv_multi64", f"n={N64} B={B52} C=3 scaled",
          lambda: mxu64_cuda.inv_multi(*xc, P52, sc52),
          lambda: mxu64_cuda.inv_multi_plain(xc, P52, sc52), "inv_multi64")
    timed("K7c fwd_multi_perchannel64 with block tables", f"n={n15} n_h={N_H} B={B52} C=3",
          lambda: mxu64_cuda.fwd_multi_perchannel64(*x3, P52, n_h=N_H),
          lambda: mxu64_cuda.fwd_multi_perchannel64_plain(x3, P52, N_H),
          "fwd_multi_perchannel64_hyb")
    timed("K7b inv_multi64 with block tables", f"n={n15} n_h={N_H} B={B52} C=3 scaled",
          lambda: mxu64_cuda.inv_multi(*x3, P52, sc15, n_h=N_H),
          lambda: mxu64_cuda.inv_multi_plain(x3, P52, sc15, N_H), "inv_multi64_hyb")
    timed("K7d pointwise_inv_multi64 with block tables", f"n={n15} n_h={N_H} B={B52} C=3 scaled",
          lambda: mxu64_cuda.pointwise_inv_multi(x3, y3, P52, sc15, n_h=N_H),
          lambda: mxu64_cuda.pointwise_inv_multi_plain(x3, y3, P52, sc15, N_H),
          "pointwise_inv_multi64_hyb")

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

    # the bound of each kernel at the shape it was timed at: MACs a pass =
    # B·R·(E·K)·(D·O) from the plane shapes, bytes = operands, results and tables once
    n1m, n2m = mxu32.four_step_factors(N_MAIN)
    d50, d_gl = mxu64._n_dplanes(PRIMES64["p50"]), mxu64._n_dplanes(GOLDILOCKS)
    e50 = mxu64._n_eplanes_lazy(PRIMES64["p50"])
    n1k, n2k = mxu32.four_step_factors(4096)
    work = {
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
    }
    bounds = {k: gemm_bound(*w) for k, w in work.items()}
    # K4 at (1024, 16): B·(n/2)·log2 n butterflies of about 12 integer operations
    # on the CUDA cores; operand, result and two twiddle tables once
    bfly_ops = B32 * 512 * 10 * 12
    bfly_bytes = 4 * (2 * B32 * 1024 + 2 * 1024)
    t_b, t_o = bfly_bytes / HBM_BYTES_PER_S, bfly_ops / CORE_OPS_PER_S
    for k in ("butterfly32_fwd", "butterfly32_inv"):
        bounds[k] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    for k in KERNELS:
        print(f"bound: {k}: {bounds[k][0]:.6f} ms by {bounds[k][1]} (kernel {ms[k]:.4f} ms = "
              f"{ms[k] / bounds[k][0]:.1f} x the bound)", flush=True)

    if args.profile:
        prof_cases = [(f"n={N32} ({name})", pl, lhs, rhs) for name, pl, lhs, rhs in p32_cases]
        prof_cases += [("n=4096 (lt30)", mid, *mid_ops), ("n=1024 (lt30)", small, *small_ops)]
        for label, pl, lhs, rhs in prof_cases:
            a, b = host(lhs).to(dev), host(rhs).to(dev)
            r = profile_polymul(lambda: pl.negacyclic_polymul(a, b))
            print(f"profile: prime32 polymul {label} B={B32} p={pl.p}: host clock "
                  f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %), matmod_pass/ntt_radix2 "
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

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k], "ms": ms[k],
         "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
