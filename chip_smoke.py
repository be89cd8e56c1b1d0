#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`concrete_ntt_tpu_torch`) on one GPU.

Drives the port's paths through their hand-written CUDA kernels:
  * native64: `native64.Plan32(2^14).negacyclic_polymul` on planar (lo, hi)
    uint32 limbs at batch 8, through K1a (`fwd_wide_multi`) and K1b
    (`inv_multi`) of `csrc/mxu32_multi.cu`;
  * prime32: `prime32.Plan(n, p).negacyclic_polymul` in the three prime
    regimes (lt30, lt31, generic), through K2 (four-step `fwd` / `inv`,
    2048 <= n <= 2^17, p >= 2^26; tiles for one channel's small grids) of
    `csrc/mxu32_pass.cu` and K4 (butterfly `fwd` / `inv`, n < 2048 or
    p < 2^26, up to 2^17 over a cluster of blocks) of `csrc/butterfly32.cu`;
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
  * the other five native families (native32, native_binary32,
    native_binary64 in the Plan32 and Plan52 tiers; native128 and
    native_binary128 Plan32): `negacyclic_polymul`, `fwd`, `inv` at n = 2^14,
    batch 8. The u128 plans run K1a with the four limbs of the operand (the
    u128 -> residue split folded into the column matmul as 16 operand digit
    planes) over 10 and 5 channels, the others K1a / K1b with one or two
    limbs and K7a / K7d / K5 on `(x, 0)` limb pairs; at n = 1024 one plan of
    each width through the per-channel route (explicit split, K4 per
    channel, the lift); Python-int and 4-limb planar input on a default
    plan; K2's `fwd_wide` with four limbs as the per-channel four-step route
    of `ntt_dispatch.try_fwd32_wide_all`, and K3's A pass with four limbs as
    the rank-local column pass of a u128 operand;
  * the 32-bit transforms above 2^15 (n1 = 256, n2 = 256 | 512), on the same
    direct kernels: `native128.Plan32(2^16)` (K1a with four limbs over the ten
    30-bit primes with 2^18 | p - 1, K1b), `native64.Plan32(2^16 | 2^17)`,
    `prime32.Plan(2^16, p)` in the three regimes and `Plan(2^17, p)` (K2),
    `product.Plan(2^16, f1·f2)` Replace and Bounded (K1a, K1c, K1d), a u128
    operand through K2 and through K3's A pass at 2^16 (the 4096 contraction);
  * the 32-bit stage-split hybrid, which no route takes (the direct kernels
    serve 2^16 and 2^17): `stagesplit.engine32_fused.fwd / inv` around K2
    with block tables (`fwd_hyb` / `inv_hyb`), and the four channel-grid
    functions `fwd_wide_multi_hybrid32`, `fwd_perchannel_multi_hybrid32`,
    `inv_multi_hybrid32`, `pointwise_inv_multi_hybrid32` around K1c / K1b /
    K1d with block tables, at n = 2^16, held against the direct kernels;
  * K1e (`inv_multi_presplit` on `digit_planes32`' int8 planes) and K5's
    forward of a u128 operand (`mxu64_cuda.fwd` with four limbs), each as a
    round trip through its entry point (no route takes either);
  * the device rule: a default-constructed plan given numpy input computes
    on the card (its launch counters move).

Phases, one line each (or a few), stopping with a non-zero exit at the first
failure:
  1. device  — needs torch.cuda.is_available(); prints nvidia-smi's name and
               power limit.
  2. build   — compiles every kernel source from the checkout with nvcc, one
               process per source, all started together; prints ptxas's
               lines and each GEMM pass instance's (digit planes, regime,
               epilogue, tile) registers and spills, both GEMM passes'
               dynamic shared memory (the 32-bit pass's per tile) and, from
               `cuobjdump -sass`, each library's GMMA (warpgroup tensor-core
               products), IMMA (int8 mma.sync) and IDP.4A (dp4a)
               instructions: the four GEMM libraries (mxu32_*, mxu64_*) must
               hold GMMA and no IDP.4A, no instance of the 64-bit pass nor of
               K2's small-grid tiles may spill, and a missing cuobjdump fails;
               K4's instances' registers and spills, and how many of its
               clusters the card holds at once (cudaOccupancyMaxActiveClusters:
               the cluster launch must be accepted at 2^14 and 2^17).
  3. parity  — each kernel against its plain torch version on the card,
               exact equality: K1a/K1b at (n, B) = (2^14, 8), (2^14, 5),
               (2^11, 3), (2^15, 2); K2 fwd, fwd_wide, inv (unscaled and
               scaled) at (2^14, 16), (2^14, 3), (2^15, 2) and at n in
               {2048, 4096, 8192}, B in {16, 3}; K3 pass_matmod (A scaled
               with 1 and 2 limbs, F, G scaled, Ainv plain and scaled, a
               row slice with rank-local diagonals) at the same mid sizes;
               all of K2/K3 for the three bench primes; K4 fwd / inv at n in
               {2, 32, 256, 1024, 2^14, 2^15}, B in {16, 9}, in each regime,
               with p = 67043329 at 2^14 and 2^15, and at 2^16 and 2^17 (B in
               {16, 9}) in the three regimes and with a prime below 2^26,
               all with 2^18 | p - 1; K1c (1 and 2 limbs)
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
               against K7a, K5 x3 and K7d direct; with the four limbs of
               a u128 operand (full-range u32 limbs): K1a over 10 and over 5
               channels at (2^14, 8), (2^14, 5), (2^11, 3), (2^15, 2), K2
               fwd_wide at K2's shapes and K3's A pass (scaled) at K3's, in
               the three bench primes. Above 2^15: K1a (1, 2 and 4 limbs;
               10 and 5 channels at 2^16, 5 at 2^17), K1b, K1c (1, 2 limbs),
               K1d at (2^16, 8), (2^16, 3), (2^17, 8), (2^17, 2); K2 fwd,
               fwd_wide (2, 4 limbs), inv plain and scaled in three regime
               primes with 2^18 | p - 1 at (2^16, 16), (2^16, 3), (2^17, 16),
               (2^17, 2): the main paths' shapes among them; K3's A pass
               with four limbs at 2^16. Block tables: K2h fwd / inv scaled at
               (2^15, 16), (2^16, 16), (2^17, 4) in the three regimes, K1c
               (1, 2 limbs) / K1b / K1d over three channel primes at
               (2^15, 8), (2^16, 8), each against its plain version and each
               whole hybrid against the direct kernel. K1e == K1b at
               (2^14, 8), (2^11, 3), (2^16, 2); K5 fwd with four limbs at
               (2^14, 16), (2^11, 3) in five regime primes. The tensor-core
               pass at small and ragged shapes, (n, B) in (2^11, 1),
               (2^11, 3), (2^12, 2), (2^13, 5): K1a with 1, 2, 4 limbs, K1b,
               K2 fwd / fwd_wide / inv in lt30 and with a five-plane prime.
               The eight (digit planes, regime) instances of the 64-bit
               pass, one prime each: K5 fwd, inv (plain, scaled) at (2^11,
               3) (ragged row tiles) and (2^14, 3), K6 A scaled on a row
               slice and F canonical at (2^11, 3).
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
               2^14. The native families at (2^14, 8): each of the eight
               plan classes' polymul == CPU plain path == the wrapping
               oracle (row 0; four sampled coefficients at width 128), fwd
               == CPU, inv(fwd(x)) == n·x wrapping; native128 K1a-u128 +2,
               K1b +1, native_binary128 K1a-u128 +1, K1a +1, K1b +1; at
               n = 1024 native32, native_binary64 and native128 Plan32
               through the per-channel route (K4 +2k fwd, +k inv, no K1
               launch); `"py128"` lists on a default native128 plan == the
               planar result; a u128 operand through K2 (x3 primes) and
               through the rank-local passes (K3-u128 +R, K3 +R) == its
               residues through the one-limb path. Above 2^15 at B = 8:
               native128.Plan32(2^16) and native64.Plan32(2^16 | 2^17)
               polymul, fwd, inv == CPU plain path (all rows) == the wrapping
               oracle (4 coefficients of row 0), inv(fwd(x)) == n·x (K1a or
               K1a-u128 +2, K1b +1 a polymul); prime32 Plan(2^16, p) x3 and
               Plan(2^17, p) at B = 16 from numpy input (K2 +2 fwd +1 inv)
               == CPU (all rows) == direct sums, n·x; product.Plan(2^16)
               Replace and Bounded == CPU (all rows); a u128 operand through K2 and K3 at
               2^16. The 32-bit hybrid at 2^16: engine32_fused (K2h fwd +1,
               inv +1) == direct K2, n·x; the channel-grid hybrid as a
               three-channel polymul (K1c-hyb +2, K1d-hyb +1) == K1a x2 + K1d
               direct == native_binary64.Plan32's polymul, K1b-hyb +1 and
               K1c-hyb +1 a round trip. K1e and K5-u128 round trips == the
               operand's residues. prime32 with p < 2^26 above 2^15 (no
               four-step; formerly the plain "stage" tier): Plan(2^16, p)
               from numpy input on a default plan: polymul, fwd == CPU plain
               path, inv(fwd(x)) == n·x, K4 +4 fwd +2 inv over clusters of
               blocks and nothing else. Each path's launch
               counters are set to 0 just before it and read just after.
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
               at 2^16 and 2^17; K1a with four limbs over 10 and 5
               channels, K1b over 10, K2 fwd_wide and K3 A with four limbs;
               the polymul of every native family at (2^14, 8) and the
               per-channel route's at 1024; the direct 32-bit kernels at
               2^16 (and K2 at 2^17), K2h and K1 with block tables at 2^16,
               K1e beside K1b, K5 with four limbs; K4 at (2^14, 16) and
               (2^16, 16) with a prime below 2^26 (device time too); K2 and K1a / K1d direct
               beside the 32-bit hybrid at 2^15, 2^16 and 2^17, in turns, with
               the hybrid's split; the polymuls above 2^15. Each row of a
               GEMM pass's kernel (csrc/matmod_pass.cuh, 32-bit, and
               csrc/matmod64_pass.cuh, 64-bit: K5, K5h, K6, K7a-K7d, W4-64)
               also gets its device time: the pass launches of a call by
               torch.profiler, median of 20 calls, beside torch._int_mm (by
               the same profiler) on int8 matrices of the shapes of the same
               passes, one GEMM per channel, block and pass: the yardstick
               of the mainloop, which the port never calls.
Then one JSON line of kernel summaries (each with its launches on its main
path, error, ms, plain ms, and, for the direct 32-bit kernels, the same
numbers at their shape above 2^15 under `n17`; the rows of both GEMM passes
and the `n17` entries also `device_ms` and `gemm_ms`, the two profiler times;
and the bound: the larger of its bytes over
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
into prefix stages, block kernels and suffix stages; of the polymul of
each native family at (2^14, 8), and of the polymuls above 2^15.
Inputs come from numpy's default_rng(--seed); the script imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

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
K4_SIZES, K4_BATCHES = (2, 32, 256, 512, 1024, 1 << 14, 1 << 15), (16, 9)
K4_BIG = (1 << 16, 1 << 17)  # K4 over clusters above the reference kernel's 2^15
K4_PAIR = (1 << 14, 80)  # (n, B) where K4 takes clusters of two blocks, as at n = 512
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
# the main paths' shapes (B = 8 for the channel grid, 16 for K2) and a ragged and a small batch
K1_BIG_SHAPES = ((N16, 8), (N16, 3), (N17, 8), (N17, 2))
K2_BIG_SHAPES = ((N16, 16), (N16, 3), (N17, 16), (N17, 2))
HYB32_SHAPES = ((1 << 15, 16), (N16, 16), (N17, 4))
K1H_SHAPES = ((1 << 15, 8), (N16, 8))
K1E_SHAPES = ((1 << 14, 8), (1 << 11, 3), (N16, 2))
W464_SHAPES = ((1 << 14, 16), (1 << 11, 3))
# the eight instances of the 64-bit pass: at 2^11 B = 3 leaves ragged row
# tiles (96 and 192 rows); at 2^14 the main paths' contraction
INST64_SHAPES = ((1 << 11, 3), (1 << 14, 3))
B_BIG = 8      # batch of the native plans' polymuls at 2^16 and 2^17 (all rows are checked)
# the tensor-core pass at its smallest contraction (one ring stage at 2^11) and
# batches that leave ragged row tiles; the batch of prime32 with p < 2^26 at 2^16 (K4)
TC_SHAPES = ((1 << 11, 1), (1 << 11, 3), (1 << 12, 2), (1 << 13, 5))
B_STAGE = 2
# the rows of the GEMM passes' kernels (csrc/matmod_pass.cuh, 32-bit, then
# csrc/matmod64_pass.cuh, 64-bit): their JSON rows carry `device_ms` and `gemm_ms`
GEMM_ROWS = ("fwd_wide_multi", "inv_multi", "fwd_multi_perchannel", "pointwise_inv_multi", "fwd",
             "inv", "pass_matmod", "fwd_wide_multi_u128", "fwd_u128", "pass_matmod_u128",
             "fwd_hyb", "inv_hyb", "fwd_multi_perchannel_hyb", "inv_multi_hyb",
             "pointwise_inv_multi_hyb", "inv_multi_presplit",
             "fwd64", "inv64", "pass_matmod64", "fwd_multi64", "pointwise_inv_multi64",
             "fwd64_hyb", "inv64_hyb", "fwd_multi_perchannel64", "inv_multi64",
             "fwd_multi_perchannel64_hyb", "inv_multi64_hyb", "pointwise_inv_multi64_hyb",
             "fwd64_u128")


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
    matmod64_pass<kD, kMode, kScaled, kPointwise> or matmod_pass<kD,
    kRegime, kScaled, kPointwise, kPresplit, kTile> (tile 1: K2's tile for
    small grids)."""
    m = re.search(r"matmod(64)?_passILi(\d)ELi(\d)ELb(\d)ELb(\d)E(?:Lb(\d)ELi(\d)E)?", entry)
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


def device_times(tasks: list, reps: int = REPS) -> dict:
    """Device time of a call, median of `reps` calls, for each task = (key,
    make, per_call): make() -> (fn, match). All tasks run in ONE
    torch.profiler session; a spin kernel (torch.cuda._sleep) before and
    after each task's calls splits the device trace into their segments. A
    call's time is the sum of its kernels whose name matches, the calls being
    consecutive groups of per_call such kernels (None: as many as there are
    per call). A key whose segment does not split so, or a trace that lost
    its markers, maps to None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        matches = []
        for _, make, _ in tasks:
            fn, match = make()
            fn()  # warm, outside the segment
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            matches.append(match)
            del fn
    evs = sorted((ev.time_range.start, ev.time_range.elapsed_us(), ev.name) for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    segments, seg = [], None
    for _, us, name in evs:
        if "spin_kernel" in name:
            if seg is None:
                seg = []
            else:
                segments.append(seg)
                seg = None
        elif seg is not None:
            seg.append((us, name))
    out = {key: None for key, _, _ in tasks}
    if len(segments) != len(tasks):
        print(f"profile: {len(segments)} marked segments for {len(tasks)} tasks: device times "
              "not measured", flush=True)
        return out
    for (key, _, per_call), match, seg in zip(tasks, matches, segments):
        us = [t for t, name in seg if match(name)]
        k = per_call or len(us) // reps
        if k and len(us) == k * reps:
            out[key] = statistics.median(sum(us[i * k:(i + 1) * k]) for i in range(reps)) / 1e3
    return out


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


def rank_local_fwd(pass_matmod, x, diag, *, n, n1, n2, p):
    """Forward NTT [B, n] -> [B, n] (bit-reversed) as the sharded
    four-step's ranks compute it: rank r holds columns r*c.. of [B, n1, n2]
    and runs the column pass A with its rows of the diagonal d; the
    all-to-all gives rank q outputs q*c1.. of every rank; each runs the row
    pass F on its rows."""
    limbs = x if isinstance(x, tuple) else (x,)  # a wide operand: little-endian u32 limbs
    b = limbs[0].shape[0]
    c, c1 = n2 // RANKS, n1 // RANKS

    def cols(r):
        sl = tuple(a.reshape(b, n1, n2)[:, :, r * c:(r + 1) * c].transpose(1, 2).contiguous()
                   for a in limbs)
        return sl if len(sl) > 1 else sl[0]

    ys = [pass_matmod(cols(r), n=n, p=p, which="A", n_limbs=len(limbs),
                      diag_slices=tuple(t[r * c:(r + 1) * c] for t in diag))
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
    import concrete_ntt_tpu_torch as port
    from concrete_ntt_tpu_torch import native64, prime32, prime64, product
    from concrete_ntt_tpu_torch.golden.polymul import (
        negacyclic_coefficients_wrapping,
        negacyclic_convolution_mod,
        negacyclic_convolution_wrapping_np,
    )
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu
    from concrete_ntt_tpu_torch.ops import (
        cuda_build, mxu32, mxu32_cuda, mxu64, mxu64_cuda, ntt_dispatch, stagesplit)
    from concrete_ntt_tpu_torch.ops.u32 import (
        limbs_to_np_u64, mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32)
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, NATIVE128_PRIMES, PRIMES52, primes32_ext
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

    # one prime for each of the eight (digit planes, epilogue regime)
    # instances of the 64-bit GEMM pass (csrc/mxu64_pass.cu launch_any; K7
    # runs the four shoup ones); 2^16 | p - 1
    INSTANCES64 = {
        (5, "shoup"): prime_in_ap(1 << 16, 1, 1 << 33, 1 << 39),
        (6, "shoup"): prime_in_ap(1 << 16, 1, 1 << 40, 1 << 47),
        (7, "shoup"): PRIMES52[0],
        (8, "shoup"): prime_in_ap(1 << 16, 1, 1 << 61, 1 << 62),
        (8, "montshoup"): prime_in_ap(1 << 16, 1, 1 << 62, 1 << 63),
        (8, "montmont"): prime_in_ap(1 << 16, 1, 1 << 63, 3 << 62),
        (9, "montmont"): prime_in_ap(1 << 16, 1, 1 << 63, (1 << 64) - 1),
        (9, "gl"): GOLDILOCKS,
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
    mxu64_cuda._pass_lib(), mxu64_cuda._multi_lib()
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
        if os.path.basename(so).startswith("mxu64_"):
            require(passes and all(st == ld == 0 for _, _, st, ld in passes),
                    f"build: {os.path.basename(so)}: a GEMM pass instance spills registers")
        # K2's tile for small grids (tile 1): built, and no spill
        small = [e for e in passes if "/tile " in pass_instance(e[0])]
        if os.path.basename(so).startswith("mxu32_pass"):
            require(len(small) == 8 and all(st == ld == 0 for _, _, st, ld in small),
                    f"build: {os.path.basename(so)}: K2's small-grid tile instances "
                    f"({len(small)} of 8) missing or spilling registers")
        k4 = [e for e in ptxas_entries(log) if "ntt_k4" in e[0]]
        if k4:
            print(f"build: {os.path.basename(so)} K4 instances: " + "; ".join(
                f"{r} registers, {st} / {ld} B spill stores / loads" for _, r, st, ld in k4),
                flush=True)
    smem = {(d, t): mxu32_cuda._pass_lib().k_pass_smem_bytes(d, t)
            for t in range(len(mxu32_cuda.TILES)) for d in (4, 5)}
    smem64 = {d: mxu64_cuda._pass_lib().k64_pass_smem_bytes(d) for d in range(5, 10)}
    print("build: matmod_pass dynamic shared memory a block, 4 / 5 digit planes: " + "; ".join(
          f"tile {t} {tm} x {to}: {smem[(4, t)]} / {smem[(5, t)]} B"
          for t, (tm, to) in enumerate(mxu32_cuda.TILES)) + "; matmod64_pass with 5..9 digit "
          f"planes: {', '.join(f'{v} B' for v in smem64.values())} (the ring of operand and "
          "plane stages, or the whole contraction of up to four stages)", flush=True)
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

    def counts() -> dict:
        return {**mxu32_cuda.LAUNCHES, **{f"butterfly32_{k}": v for k, v in bcu.LAUNCHES.items()},
                **mxu64_cuda.LAUNCHES}

    def nz(d: dict) -> dict:
        """The non-zero entries of a launch-count dict, for the printed lines."""
        return {k: v for k, v in d.items() if v}

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

    # the tensor-core pass at its smallest contraction (32 words: one ring
    # stage) and with ragged row tiles: K1a with 1, 2, 4 limbs, K1b, K2 fwd /
    # fwd_wide / inv in lt30 and with five digit planes (kD = 5)
    t0 = time.perf_counter()
    base = dict(checks)
    p5d = prime_in_ap(1 << 14, 1, 1 << 31, 1 << 32)
    require(mxu32._n_dplanes32(p5d) == 5, f"parity: {p5d} should take five digit planes")
    for n, b in TC_SHAPES:
        w = tuple(u32((b, n)) for _ in range(4))
        for nl, key, pr in ((1, "fwd_wide_multi", PRIMES), (2, "fwd_wide_multi", PRIMES),
                            (4, "fwd_wide_multi_u128", NATIVE128_PRIMES)):
            compare(key, mxu32_cuda.fwd_wide_multi(w[:nl], pr),
                    mxu32_cuda.fwd_wide_multi_plain(w[:nl], pr), f"n={n} B={b} limbs={nl}")
        x = u32((len(PRIMES), b, n))
        scs = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
        compare("inv_multi", mxu32_cuda.inv_multi(x, PRIMES, scs),
                mxu32_cuda.inv_multi_plain(x, PRIMES, scs), f"n={n} B={b} scaled")
        for p in (BENCH_PRIMES["lt30"], p5d):
            compare("fwd", mxu32_cuda.fwd(w[0], n=n, p=p), mxu32_cuda.fwd_plain(w[0], n=n, p=p),
                    f"p={p} n={n} B={b}")
            compare("fwd", mxu32_cuda.fwd_wide(w[:2], n=n, p=p),
                    mxu32_cuda.fwd_wide_plain(w[:2], n=n, p=p), f"p={p} n={n} B={b} 2 limbs")
            s_inv = pow(n, p - 2, p) * pow(2, 32, p) % p
            compare("inv", mxu32_cuda.inv(w[1], n=n, p=p, scale=s_inv),
                    mxu32_cuda.inv_plain(w[1], n=n, p=p, scale=s_inv), f"p={p} n={n} B={b} scaled")
    tc = {k: checks[k] - base[k] for k in ("fwd_wide_multi", "fwd_wide_multi_u128", "inv_multi",
                                          "fwd", "inv") if checks[k] > base[k]}
    print(f"parity: tensor-core pass at small and ragged shapes: {tc} checks exact at (n, B) in "
          f"{TC_SHAPES}; K2 in lt30 and with five digit planes (p = {p5d}) in "
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
    k4_cases += [(p, n) for p in (*BIG32.values(), SMALL18) for n in K4_BIG]
    k4_cases = [(p, n, K4_BATCHES) for p, n in k4_cases]
    k4_cases += [(p, K4_PAIR[0], K4_PAIR[1:]) for p in (*BENCH_PRIMES.values(), SMALL_P)]
    k4_clusters = set()
    for p, n, batches in k4_cases:
        plan = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
        for b in batches:
            k4_clusters.add(bcu.cluster_size(n, b))
            x = u32((b, n), p)
            compare("butterfly32_fwd", bcu.try_fwd(x, plan._tbl, **kw),
                    bcu.fwd_plain(x, plan._tbl, **kw), f"p={p} n={n} B={b}")
            compare("butterfly32_inv", bcu.try_inv(x, plan._tbl, **kw),
                    bcu.inv_plain(x, plan._tbl, **kw), f"p={p} n={n} B={b}")
    print(f"parity: K4 fwd {checks['butterfly32_fwd']}, inv {checks['butterfly32_inv']} checks "
          f"exact at n in {K4_SIZES}, B in {K4_BATCHES}, three regimes, p={SMALL_P} at 2^14, "
          f"2^15, at n in {K4_BIG} for p in {(*BIG32.values(), SMALL18)}, and at (n, B) = "
          f"{K4_PAIR} in three regimes and p={SMALL_P} (clusters of {sorted(k4_clusters)} "
          f"blocks) in {time.perf_counter() - t0:.1f} s", flush=True)
    require(k4_clusters == {1, 2, 4, 8}, f"parity: K4 ran clusters of {sorted(k4_clusters)} "
                                         "blocks, not every size it takes (1, 2, 4, 8)")

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

    # each (digit planes, regime) instance of the 64-bit pass, in its scaled
    # (the first pass of K5; K6's A) and its canonical form (the second; K6's
    # F), at 2^11 with ragged row tiles and at 2^14
    t0 = time.perf_counter()
    base = dict(checks)
    regimes64 = ("shoup", "montshoup", "montmont", "gl")
    for (n_d, regime), p in INSTANCES64.items():
        require((mxu64._n_dplanes(p), regimes64[mxu64_cuda.mode(p)]) == (n_d, regime),
                f"parity: {p} is not the ({n_d}, {regime}) instance")
        for n, b in INST64_SHAPES:
            x = (u32((b, n)), u32((b, n)))
            what = f"({n_d}, {regime}) p={p} n={n} B={b}"
            compare_pair("fwd64", mxu64_cuda.fwd(x, n=n, p=p), mxu64_cuda.fwd_plain(x, n=n, p=p),
                         what)
            for sc in (1, scale64(n, p)):
                compare_pair("inv64", mxu64_cuda.inv(x, n=n, p=p, scale=sc),
                             mxu64_cuda.inv_plain(x, n=n, p=p, scale=sc),
                             f"{what} scaled={sc != 1}")
        n, b = INST64_SHAPES[0]
        tbl = mxu64._tables(n, p)
        n1, n2 = tbl["n1"], tbl["n2"]
        for which, x, dg in (
                ("A", (u32((b, n2 // 4, n1)), u32((b, n2 // 4, n1))),
                 tuple(torch.from_numpy(a[n2 // 4: n2 // 2]).to(dev) for a in tbl["d"])),
                ("F", mid_pair((b, n1, n2), p), ())):
            kw = dict(n=n, p=p, which=which, diag_slices=dg)
            compare_pair("pass_matmod64", mxu64_cuda.pass_matmod64(x, **kw),
                         mxu64_cuda.pass_matmod64_plain(x, **kw),
                         f"({n_d}, {regime}) p={p} n={n} B={b} {which} rows={x[0].shape[1]}")
    inst = {k: checks[k] - base[k] for k in ("fwd64", "inv64", "pass_matmod64")}
    print(f"parity: the eight 64-bit pass instances (digit planes, regime) "
          f"{tuple(INSTANCES64)}: K5 fwd / inv (plain, scaled) at (n, B) in {INST64_SHAPES} and "
          f"K6 A scaled on a row slice / F canonical at {INST64_SHAPES[0]}: {inst} checks exact "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

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

    # the four limbs of a u128 operand: K1a over the native128 (10) and the
    # native_binary128 (5) channels, K2 fwd_wide and K3's A pass per bench prime
    t0 = time.perf_counter()
    for n, b in PARITY_SHAPES:
        limbs = tuple(u32((b, n)) for _ in range(4))
        for ch in (10, 5):
            compare("fwd_wide_multi_u128",
                    mxu32_cuda.fwd_wide_multi(limbs, NATIVE128_PRIMES[:ch]),
                    mxu32_cuda.fwd_wide_multi_plain(limbs, NATIVE128_PRIMES[:ch]),
                    f"n={n} B={b} limbs=4 channels={ch}")
    for p in BENCH_PRIMES.values():
        for n, b in K2_SHAPES:
            limbs = tuple(u32((b, n)) for _ in range(4))
            compare("fwd_u128", mxu32_cuda.fwd_wide(limbs, n=n, p=p),
                    mxu32_cuda.fwd_wide_plain(limbs, n=n, p=p), f"p={p} n={n} B={b} 4 limbs")
        for n in K3_SIZES:
            tbl = mxu32._mxu_tables(n, p)
            d = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])  # [n2, n1]
            for b in K3_BATCHES:
                xa = tuple(u32((b, tbl["n2"], tbl["n1"])) for _ in range(4))
                kw = dict(n=n, p=p, which="A", diag_slices=d, n_limbs=4)
                compare("pass_matmod_u128", mxu32_cuda.pass_matmod(xa, **kw),
                        mxu32_cuda.pass_matmod_plain(xa, **kw), f"p={p} n={n} B={b} A 4 limbs")
    print(f"parity: four-limb (u128) operands, full-range u32 limbs: K1a "
          f"{checks['fwd_wide_multi_u128']} checks exact over 10 and 5 channels at (n, B) in "
          f"{PARITY_SHAPES}; K2 fwd_wide {checks['fwd_u128']} at (n, B) in {K2_SHAPES}, K3 A "
          f"{checks['pass_matmod_u128']} at n in {K3_SIZES}, B in {K3_BATCHES}, p in "
          f"{tuple(BENCH_PRIMES.values())}, in {time.perf_counter() - t0:.1f} s", flush=True)

    # n = 2^16 and 2^17 (n1 = 256): the direct 32-bit kernels over the channel
    # primes of those sizes and per regime; full-range u32 limbs everywhere
    def scale32(n, p):
        return pow(n, p - 2, p) * pow(2, 32, p) % p

    t0 = time.perf_counter()
    base = dict(checks)
    p5, p2e = EXT[:5], EXT[:2]
    for n, b in K1_BIG_SHAPES:
        limbs = tuple(u32((b, n)) for _ in range(4))
        for ch in ((10, 5) if n == N16 else (5,)):
            for nl in (1, 2, 4):
                compare("fwd_wide_multi_u128" if nl == 4 else "fwd_wide_multi",
                        mxu32_cuda.fwd_wide_multi(limbs[:nl], EXT[:ch]),
                        mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], EXT[:ch]),
                        f"n={n} B={b} limbs={nl} channels={ch}")
        x = u32((5, b, n))
        scs = tuple(scale32(n, p) for p in p5)
        compare("inv_multi", mxu32_cuda.inv_multi(x, p5, scs),
                mxu32_cuda.inv_multi_plain(x, p5, scs), f"n={n} B={b} scaled")
        xs = (u32((2, b, n)), u32((2, b, n)))
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_multi_perchannel(xs[0], p2e),
                mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], p2e), f"n={n} B={b} limbs=1")
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_wide_multi_perchannel(*xs, p2e),
                mxu32_cuda.fwd_multi_perchannel_plain(xs, p2e), f"n={n} B={b} limbs=2")
        compare("pointwise_inv_multi", mxu32_cuda.pointwise_inv_multi(*xs, p2e, scs[:2]),
                mxu32_cuda.pointwise_inv_multi_plain(*xs, p2e, scs[:2]), f"n={n} B={b}")
    k1_big = {k: checks[k] - base[k] for k in ("fwd_wide_multi", "fwd_wide_multi_u128",
                                               "inv_multi", "fwd_multi_perchannel",
                                               "pointwise_inv_multi")}
    print(f"parity: n = 2^16, 2^17: K1a / K1a-u128 / K1b / K1c / K1d {k1_big} checks exact at "
          f"(n, B) in {K1_BIG_SHAPES} (K1a over 10 and 5 channels at {N16}, 5 at {N17}; 1, 2 and "
          f"4 limbs; K1b over 5), channel primes {EXT}, in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    base = dict(checks)
    for p in BIG32.values():
        for n, b in K2_BIG_SHAPES:
            limbs = tuple(u32((b, n)) for _ in range(4))
            compare("fwd", mxu32_cuda.fwd(limbs[0], n=n, p=p),
                    mxu32_cuda.fwd_plain(limbs[0], n=n, p=p), f"p={p} n={n} B={b}")
            for nl in (2, 4):
                compare("fwd_u128" if nl == 4 else "fwd", mxu32_cuda.fwd_wide(limbs[:nl], n=n, p=p),
                        mxu32_cuda.fwd_wide_plain(limbs[:nl], n=n, p=p),
                        f"p={p} n={n} B={b} {nl} limbs")
            for s in (1, scale32(n, p)):
                compare("inv", mxu32_cuda.inv(limbs[1], n=n, p=p, scale=s),
                        mxu32_cuda.inv_plain(limbs[1], n=n, p=p, scale=s),
                        f"p={p} n={n} B={b} scale={s}")
        tbl = mxu32._mxu_tables(N16, p)
        d = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])  # [n2, n1]
        for b in K3_BATCHES:
            xa = tuple(u32((b, tbl["n2"], tbl["n1"])) for _ in range(4))  # 16 x 256 = 4096 rows
            kw = dict(n=N16, p=p, which="A", diag_slices=d, n_limbs=4)
            compare("pass_matmod_u128", mxu32_cuda.pass_matmod(xa, **kw),
                    mxu32_cuda.pass_matmod_plain(xa, **kw), f"p={p} n={N16} B={b} A 4 limbs")
    k2_big = {k: checks[k] - base[k] for k in ("fwd", "fwd_u128", "inv", "pass_matmod_u128")}
    print(f"parity: n = 2^16, 2^17: K2 fwd (1, 2 limbs) / fwd_wide 4 limbs / inv (plain, scaled) / "
          f"K3 A 4 limbs at {N16} (the 4096 contraction) {k2_big} checks exact at (n, B) in "
          f"{K2_BIG_SHAPES}, p in {tuple(BIG32.values())}, in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the 32-bit hybrid's block tables: K2 per regime, K1b / K1c / K1d over three
    # channel primes; and each whole hybrid against the direct kernel at the same n
    t0 = time.perf_counter()
    hyb32_build = []
    for rname, p in BIG32.items():
        for n, b in HYB32_SHAPES:
            t1 = time.perf_counter()  # the host build: operators, block proof, digit planes
            stagesplit._dev32(n, p, N_H)
            hyb32_build.append(f"{n} {rname} {time.perf_counter() - t1:.1f} s")
            x = u32((b, n))
            s = scale32(n, p)
            kw = dict(n=n, p=p, n_h=N_H)
            what = f"p={p} n={n} B={b}"
            compare("fwd_hyb", mxu32_cuda.fwd_hyb(x, **kw), mxu32_cuda.fwd_hyb_plain(x, **kw), what)
            compare("inv_hyb", mxu32_cuda.inv_hyb(x, scale=s, **kw),
                    mxu32_cuda.inv_hyb_plain(x, scale=s, **kw), what + " scaled")
            compare("fwd_hyb", stagesplit.engine32_fused.fwd(x, n=n, p=p),
                    mxu32_cuda.fwd(x, n=n, p=p), what + " hybrid vs direct K2")
            compare("inv_hyb", stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s),
                    mxu32_cuda.inv(x, n=n, p=p, scale=s), what + " scaled hybrid vs direct K2")
    print(f"parity: K2 with block tables (K2h) fwd {checks['fwd_hyb']}, inv {checks['inv_hyb']} "
          f"checks exact at (n, B) in {HYB32_SHAPES}, n_h={N_H}, p in {tuple(BIG32.values())}: "
          f"against the plain versions, and the whole 32-bit hybrid == direct K2, in "
          f"{time.perf_counter() - t0:.1f} s; host build of the block tables: "
          f"{', '.join(hyb32_build)}", flush=True)

    t0 = time.perf_counter()
    for n, b in K1H_SHAPES:
        p3 = (PRIMES if n <= 1 << 15 else EXT)[:3]
        scs = tuple(scale32(n, p) for p in p3)
        x, y = u32((3, b, n)), u32((3, b, n))
        what = f"n={n} B={b} n_h={N_H}"
        compare("fwd_multi_perchannel_hyb", mxu32_cuda.fwd_multi_perchannel(x, p3, n_h=N_H),
                mxu32_cuda.fwd_multi_perchannel_plain((x,), p3, N_H), what + " limbs=1")
        compare("fwd_multi_perchannel_hyb",
                mxu32_cuda.fwd_wide_multi_perchannel(x, y, p3, n_h=N_H),
                mxu32_cuda.fwd_multi_perchannel_plain((x, y), p3, N_H), what + " limbs=2")
        compare("inv_multi_hyb", mxu32_cuda.inv_multi(x, p3, scs, n_h=N_H),
                mxu32_cuda.inv_multi_plain(x, p3, scs, N_H), what)
        compare("pointwise_inv_multi_hyb", mxu32_cuda.pointwise_inv_multi(x, y, p3, scs, n_h=N_H),
                mxu32_cuda.pointwise_inv_multi_plain(x, y, p3, scs, N_H), what)
        for limbs in ((x[0],), (x[0], y[0])):
            compare("fwd_multi_perchannel_hyb",
                    stagesplit.fwd_wide_multi_hybrid32(limbs, p3, n=n),
                    mxu32_cuda.fwd_wide_multi(limbs, p3),
                    what + f" hybrid vs K1a direct, {len(limbs)} limbs")
        compare("fwd_multi_perchannel_hyb", stagesplit.fwd_perchannel_multi_hybrid32(x, p3, n=n),
                mxu32_cuda.fwd_multi_perchannel(x, p3), what + " hybrid vs K1c direct")
        compare("inv_multi_hyb", stagesplit.inv_multi_hybrid32(x, p3, scs, n=n),
                mxu32_cuda.inv_multi(x, p3, scs), what + " hybrid vs K1b direct")
        compare("pointwise_inv_multi_hyb",
                stagesplit.pointwise_inv_multi_hybrid32(x, y, p3, scs, n=n),
                mxu32_cuda.pointwise_inv_multi(x, y, p3, scs), what + " hybrid vs K1d direct")
    print(f"parity: the channel grid with block tables: K1c {checks['fwd_multi_perchannel_hyb']} "
          f"(1 and 2 limbs), K1b {checks['inv_multi_hyb']}, K1d "
          f"{checks['pointwise_inv_multi_hyb']} checks exact at (n, B) in {K1H_SHAPES}, "
          f"n_h={N_H}, over {PRIMES[:3]} at 32768 and {EXT[:3]} at 65536: against the plain "
          f"versions, and the four channel-grid hybrids == K1a / K1c / K1b / K1d direct, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # K1e (the operand as int8 digit planes) == K1b; K5 fwd with four limbs
    t0 = time.perf_counter()
    for n, b in K1E_SHAPES:
        pr = PRIMES if n <= 1 << 15 else p5
        scs = tuple(scale32(n, p) for p in pr)
        x = u32((5, b, n))
        xd = mxu32_cuda.digit_planes32(x)
        got = mxu32_cuda.inv_multi_presplit(xd, pr, scs)
        compare("inv_multi_presplit", got, mxu32_cuda.inv_multi_presplit_plain(xd, pr, scs),
                f"n={n} B={b}")
        compare("inv_multi_presplit", got, mxu32_cuda.inv_multi(x, pr, scs),
                f"n={n} B={b} vs K1b on the values")
    for rname, p in PRIMES64.items():
        for n, b in W464_SHAPES:
            x = tuple(u32((b, n)) for _ in range(4))
            compare_pair("fwd64_u128", mxu64_cuda.fwd(x, n=n, p=p),
                         mxu64_cuda.fwd_plain(x, n=n, p=p), f"p={p} n={n} B={b} 4 limbs")
    print(f"parity: K1e inv_multi_presplit {checks['inv_multi_presplit']} checks exact (== its "
          f"plain version == K1b) at (n, B) in {K1E_SHAPES}; K5 fwd with four limbs "
          f"{checks['fwd64_u128']} checks exact at (n, B) in {W464_SHAPES} x five regime primes, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

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
          f"path == numpy oracle (row 0); launches {nz(launches)}", flush=True)

    def expect_delta(before: dict, want: dict, what: str) -> None:
        after = counts()
        delta = {k: after[k] - before[k] for k in after}
        require(all(delta[k] == want.get(k, 0) for k in delta),
                f"main: {what} moved the launch counters by {nz(delta)}, expected {want}")

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
          f"vector round trip; launches {nz(launches32)}", flush=True)

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
          f"inv(fwd(x)) == n·x; launches {nz(launches_k3)}", flush=True)

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
          f"launches {nz(launches_prod)}", flush=True)

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
          f"launches {nz(launches64)}", flush=True)

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
          f"launches {nz(launches52)}", flush=True)

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
          f"channel K5) == CPU plain path; launches {nz(counts())}", flush=True)

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
          f"round trip at n={N64} == x; launches {nz(launches_ch)}", flush=True)

    # the other native families: widths 32, 64 and 128, both tiers
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

    def native_counts(pl, binary):
        """Launches of one polymul, one fwd and one inv of a native plan at 2^11 <= n <= 2^17."""
        k, nl = len(pl.primes), pl.width // 32
        if pl.tier == "plan32":
            wide = "fwd_wide_multi_u128" if nl == 4 else "fwd_wide_multi"
            poly = {wide: 1, "inv_multi": 1}
            poly["fwd_wide_multi" if binary else wide] = poly.get(
                "fwd_wide_multi" if binary else wide, 0) + 1
            return poly, {wide: 1}, {"inv_multi": 1}
        if ntt_dispatch.route64(pl.n, pl.primes) == "K7":
            return ({"fwd_multi64": 2, "pointwise_inv_multi64": 1}, {"fwd_multi64": 1},
                    {"inv64": k})
        return {"fwd64": 2 * k, "inv64": k}, {"fwd64": k}, {"inv64": k}

    fam = []
    for mod, tier in NATIVE_PLANS:
        cls = getattr(getattr(port, mod), tier)
        pl = cls.try_new(N_MAIN)
        require(pl is not None and pl.device == "cuda",
                f"main: {mod}.{tier}({N_MAIN}) default device is not the card")
        binary = "binary" in mod
        fam.append((f"{mod}.{tier}", pl, cls.try_new(N_MAIN, device="cpu"), binary,
                    limbs_np(pl.width, (B_MAIN, N_MAIN)),
                    limbs_np(pl.width, (B_MAIN, N_MAIN), binary)))
    torch.cuda.synchronize()
    reset_counts()
    fam_out = []
    for name, pl, _, binary, a, b in fam:
        poly, fwd_c, inv_c = native_counts(pl, binary)
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        before = counts()
        got = pl.negacyclic_polymul(la, lb)  # the binary plans take rhs as the {0, 1} operand
        expect_delta(before, poly, f"{name}({N_MAIN}) polymul")
        before = counts()
        f = pl.fwd(la)
        expect_delta(before, fwd_c, f"{name}({N_MAIN}) fwd")
        before = counts()
        back = pl.inv(f, out_format="u32" if pl.width == 32 else "planar")
        expect_delta(before, inv_c, f"{name}({N_MAIN}) inv")
        fam_out.append((got, f, back))
    torch.cuda.synchronize()
    launches_fam = counts()
    t0 = time.perf_counter()
    for (name, pl, cpu, binary, a, b), (got, f, back) in zip(fam, fam_out):
        g = out_limbs(got)
        require(f.device.type == "cuda" and g.shape == a.shape and np.array_equal(
            g, out_limbs(cpu.negacyclic_polymul(plan_arg(a, "cpu"), plan_arg(b, "cpu")))),
            f"main: {name}({N_MAIN}) polymul differs from the CPU plain path")
        if pl.width == 128:
            ks = (0, 1, N_MAIN // 2 + 7, N_MAIN - 1)
            want = negacyclic_coefficients_wrapping(as_ints(a[0]), as_ints(b[0]), ks, 128)
            require([int(v) for v in as_ints(g[0])[list(ks)]] == want,
                    f"main: {name}({N_MAIN}) polymul row 0 differs from the wrapping oracle at "
                    f"coefficients {ks}")
        else:
            dt = np.uint32 if pl.width == 32 else np.uint64
            row = lambda v: as_ints(v[0]).astype(dt)
            require(np.array_equal(row(g), negacyclic_convolution_wrapping_np(row(a), row(b))),
                    f"main: {name}({N_MAIN}) polymul row 0 differs from the numpy wrapping oracle")
        require(torch.equal(f.cpu(), cpu.fwd(plan_arg(a, "cpu"))),
                f"main: {name}({N_MAIN}) fwd differs from the CPU plain path")
        nx = (as_ints(a[:2]) * N_MAIN) & ((1 << pl.width) - 1)
        require((as_ints(out_limbs(back)[:2]) == nx).all(),
                f"main: {name}({N_MAIN}) inv(fwd(x)) != n·x (wrapping)")
    launches["fwd_wide_multi_u128"] = launches_fam["fwd_wide_multi_u128"]
    print(f"main: native families on {kind}: {[n for n, *_ in fam]} at n={N_MAIN} B={B_MAIN}: "
          f"polymul == CPU plain path == wrapping oracle (row 0; 4 coefficients at width 128), "
          f"fwd == CPU, inv(fwd(x)) == n·x; launches {nz(launches_fam)}; checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # below 2^11: no channel route, each channel's prime32 plan (K4)
    perch = []
    for mod, tier in PERCHANNEL_PLANS:
        cls = getattr(getattr(port, mod), tier)
        pl = cls.try_new(N_PERCH)
        perch.append((f"{mod}.{tier}", pl, cls.try_new(N_PERCH, device="cpu"),
                      limbs_np(pl.width, (B_MAIN, N_PERCH)),
                      limbs_np(pl.width, (B_MAIN, N_PERCH), "binary" in mod)))
    torch.cuda.synchronize()
    reset_counts()
    perch_out = []
    for name, pl, _, a, b in perch:
        k = len(pl.primes)
        require(ntt_dispatch.route32(N_PERCH, pl.primes) is None,
                f"main: {name}({N_PERCH}) has a channel route")
        before = counts()
        perch_out.append(pl.negacyclic_polymul(plan_arg(a, dev), plan_arg(b, dev)))
        expect_delta(before, {"butterfly32_fwd": 2 * k, "butterfly32_inv": k},
                     f"{name}({N_PERCH}) polymul")
    torch.cuda.synchronize()
    launches_perch = counts()
    for (name, pl, cpu, a, b), got in zip(perch, perch_out):
        g = out_limbs(got)
        require(np.array_equal(g, out_limbs(cpu.negacyclic_polymul(
            plan_arg(a, "cpu"), plan_arg(b, "cpu")))),
            f"main: {name}({N_PERCH}) polymul differs from the CPU plain path")
        ks = (0, 1, N_PERCH // 2 + 7, N_PERCH - 1)
        require([int(v) for v in as_ints(g[0])[list(ks)]] == negacyclic_coefficients_wrapping(
            as_ints(a[0]), as_ints(b[0]), ks, pl.width),
            f"main: {name}({N_PERCH}) polymul row 0 differs from the wrapping oracle")
    print(f"main: per-channel route on {kind}: {[n for n, *_ in perch]} at n={N_PERCH} "
          f"B={B_MAIN}: polymul == CPU plain path == wrapping oracle (4 coefficients of row 0), "
          f"K4 per channel and no K1 launch; launches {nz(launches_perch)}", flush=True)

    # host formats on a default plan: Python ints ("py128") move to the card
    name, pl128, _, _, a128, b128 = fam[[n for n, *_ in fam].index("native128.Plan32")]
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    py_out = pl128.negacyclic_polymul([int(v) for v in as_ints(a128[0])],
                                      [int(v) for v in as_ints(b128[0])])
    expect_delta(before, {"fwd_wide_multi_u128": 2, "inv_multi": 1}, "native128 py128 polymul")
    planar_row0 = as_ints(out_limbs(fam_out[[n for n, *_ in fam].index(name)][0])[0])
    require(isinstance(py_out, list) and py_out == [int(v) for v in planar_row0],
            "main: native128 py128 polymul differs from the planar one")
    print(f"main: device rule: native128.Plan32 default device {pl128.device!r}, a polymul of "
          f"two lists of {N_MAIN} Python ints launched {nz(counts())} and == the 4-limb planar "
          f"result (row 0)", flush=True)

    # a u128 operand through K2 (the per-channel four-step route of the plans'
    # forward) and through K3 (the rank-local column pass): both must give the
    # transform of the operand's residue
    wide_plans = tuple(prime32.Plan.new(N32, p) for p in BENCH_PRIMES.values())
    w128 = limbs_np(128, (B32, N32))
    w_sh = limbs_np(128, (B32, n_sh))
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    wide_got = ntt_dispatch.try_fwd32_wide_all(plan_arg(w128, dev), wide_plans)
    expect_delta(before, {"fwd_u128": len(wide_plans)}, "u128 operand through the K2 route")
    sh_wide = []
    for geo, d, e, _ in sharded:
        before = counts()
        sh_wide.append(rank_local_fwd(mxu32_cuda.pass_matmod, plan_arg(w_sh, dev), d, **geo))
        expect_delta(before, {"pass_matmod_u128": RANKS, "pass_matmod": RANKS},
                     f"rank-local fwd of a u128 operand n={n_sh} p={geo['p']}")
    torch.cuda.synchronize()
    launches_wide = counts()
    residue = lambda v, p: torch.from_numpy((as_ints(v) % p).astype(np.uint32))
    for i, pl in enumerate(wide_plans):
        require(wide_got.device.type == "cuda" and torch.equal(
            wide_got[i].cpu(), mxu32_cuda.fwd_plain(residue(w128, pl.p), n=N32, p=pl.p)),
            f"main: u128 operand through K2, p={pl.p}: differs from the transform of value mod p")
    for (geo, *_), f in zip(sharded, sh_wide):
        require(torch.equal(f.cpu(), mxu32_cuda.fwd_plain(residue(w_sh, geo["p"]), n=n_sh,
                                                          p=geo["p"])),
                f"main: rank-local fwd of a u128 operand, p={geo['p']}: differs from the "
                "transform of value mod p")
    for k in ("fwd_u128", "pass_matmod_u128"):
        launches[k] = launches_wide[k]
    print(f"main: u128 operands on {kind}: try_fwd32_wide_all over p in "
          f"{tuple(BENCH_PRIMES.values())} at n={N32} B={B32} (K2 with four limbs) and the "
          f"rank-local fwd at n={n_sh} (K3's A pass with four limbs, R={RANKS}) == the CPU "
          f"transform of value mod p; launches {nz(launches_wide)}", flush=True)

    # -- this slice's paths: the 32-bit transforms above 2^15, on the direct kernels --
    ks_of = lambda n: (0, 1, n // 2 + 7, n - 1)
    launches_n17 = {}
    t0 = time.perf_counter()
    big_fam = []
    for mod, n in (("native128", N16), ("native64", N16), ("native64", N17)):
        cls = getattr(port, mod).Plan32
        pl = cls.try_new(n)
        require(pl is not None and pl.device == "cuda" and pl.primes == EXT[:len(pl.primes)],
                f"main: {mod}.Plan32({n}) is not a default-device plan over the 2^18 primes")
        big_fam.append((f"{mod}.Plan32", n, pl, cls.try_new(n, device="cpu"),
                        limbs_np(pl.width, (B_BIG, n)), limbs_np(pl.width, (B_BIG, n))))
    torch.cuda.synchronize()
    reset_counts()
    big_out = []
    for name, n, pl, _, a, b in big_fam:
        poly, fwd_c, inv_c = native_counts(pl, False)
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        before = counts()
        got = pl.negacyclic_polymul(la, lb)
        expect_delta(before, poly, f"{name}({n}) polymul")
        before = counts()
        f = pl.fwd(la)
        expect_delta(before, fwd_c, f"{name}({n}) fwd")
        before = counts()
        back = pl.inv(f, out_format="planar")
        expect_delta(before, inv_c, f"{name}({n}) inv")
        big_out.append((got, f, back))
    torch.cuda.synchronize()
    launches_big = counts()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (name, n, pl, cpu, a, b), (got, f, back) in zip(big_fam, big_out):
        g = out_limbs(got)
        require(f.device.type == "cuda" and g.shape == a.shape and np.array_equal(
            g, out_limbs(cpu.negacyclic_polymul(plan_arg(a, "cpu"), plan_arg(b, "cpu")))),
            f"main: {name}({n}) polymul differs from the CPU plain path")
        want = negacyclic_coefficients_wrapping(as_ints(a[0]), as_ints(b[0]), ks_of(n), pl.width)
        require([int(v) for v in as_ints(g[0])[list(ks_of(n))]] == want,
                f"main: {name}({n}) polymul row 0 differs from the wrapping oracle at "
                f"coefficients {ks_of(n)}")
        require(tuple(f.shape) == (len(pl.primes), B_BIG, n) and torch.equal(
            f.cpu(), cpu.fwd(plan_arg(a, "cpu"))),
            f"main: {name}({n}) fwd differs from the CPU plain path")
        nx = (as_ints(a) * n) & ((1 << pl.width) - 1)
        require((as_ints(out_limbs(back)) == nx).all(),
                f"main: {name}({n}) inv(fwd(x)) != n·x (wrapping)")
    for k in ("fwd_wide_multi", "fwd_wide_multi_u128", "inv_multi"):
        launches_n17[k] = launches_big[k]
    print(f"main: native plans above 2^15 on {kind}: {[(nm, n) for nm, n, *_ in big_fam]} at "
          f"B={B_BIG}, planar input on default plans over the channel primes {EXT}: polymul == "
          f"CPU plain path (all {B_BIG} rows) == wrapping oracle (4 coefficients of row 0), fwd == "
          f"CPU (all rows), inv(fwd(x)) == n·x (all rows); launches {nz(launches_big)}; on the card {t_card:.1f} s (tables "
          f"included), checks {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    big32 = [(rname, prime32.Plan.new(N16, p)) for rname, p in BIG32.items()]
    big32.append(("lt30", prime32.Plan.new(N17, BIG32["lt30"])))
    big32 = [(rname, pl, *(rng.integers(0, pl.p, (B32, pl.n), dtype=np.uint32) for _ in range(2)))
             for rname, pl in big32]
    torch.cuda.synchronize()
    reset_counts()
    big32_out = []
    for rname, pl, lhs, rhs in big32:
        require(pl.device == "cuda", f"main: default prime32 plan device is {pl.device!r}")
        before = counts()
        got = pl.negacyclic_polymul(lhs, rhs)  # numpy input on a default plan
        expect_delta(before, {"fwd": 2, "inv": 1}, f"prime32 Plan({pl.n}, {pl.p}) polymul")
        before = counts()
        rt = pl.inv(pl.fwd(lhs))
        expect_delta(before, {"fwd": 1, "inv": 1}, f"prime32 Plan({pl.n}, {pl.p}) round trip")
        big32_out.append((got, rt))
    torch.cuda.synchronize()
    launches_b32 = counts()
    for (rname, pl, lhs, rhs), (got, rt) in zip(big32, big32_out):
        n, p = pl.n, pl.p
        want = prime32.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs)
        require(got.device.type == "cuda" and tuple(got.shape) == (B32, n)
                and torch.equal(got.cpu(), want),
                f"main: prime32 Plan({n}, {p}) polymul differs from the CPU plain path")
        require(np.array_equal(rt.cpu().numpy(), (lhs.astype(np.uint64) * n % p).astype(np.uint32)),
                f"main: prime32 Plan({n}, {p}) inv(fwd(x)) != n·x mod p")
        ao, bo = lhs[0].astype(object), rhs[0].astype(object)
        for k in ks_of(n):
            require(int(got[0, k]) == negacyclic_coeff(ao, bo, k, p),
                    f"main: prime32 Plan({n}, {p}) polymul coefficient {k} of row 0 differs from "
                    "its direct sum")
    for k in ("fwd", "inv"):
        launches_n17[k] = launches_b32[k]
    print(f"main: prime32 above 2^15 on {kind}: Plan(n, p) B={B32} numpy input on default plans, "
          f"(n, regime, p) in {[(pl.n, rn, pl.p) for rn, pl, *_ in big32]}: polymul == CPU plain "
          f"path (all {B32} rows) == direct sums (4 coefficients of row 0), inv(fwd(x)) == n·x; "
          f"launches {nz(launches_b32)}; {time.perf_counter() - t0:.1f} s", flush=True)

    # prime32 with a prime below 2^26 above 2^15: no four-step (p too small);
    # K4 serves it over clusters of blocks (formerly the plain "stage" tier,
    # as the reference runs its XLA stage engine there)
    t0 = time.perf_counter()
    p_st = prime_in_ap(2 * N16, 1, 0, 1 << 26)
    st_plan, st_cpu = prime32.Plan.new(N16, p_st), prime32.Plan.new(N16, p_st, device="cpu")
    require(ntt_dispatch.tier32(N16, p_st, st_plan.variant) == "K4",
            f"main: prime32 Plan({N16}, {p_st}) should take K4")
    st_l, st_r = (rng.integers(0, p_st, (B_STAGE, N16), dtype=np.uint32) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    st_out = (st_plan.negacyclic_polymul(st_l, st_r), st_plan.fwd(st_l),
              st_plan.inv(st_plan.fwd(st_l)))  # numpy input on a default plan
    torch.cuda.synchronize()
    launches_st = counts()
    require(nz(launches_st) == {"butterfly32_fwd": 4, "butterfly32_inv": 2},
            f"main: prime32 Plan({N16}, {p_st}) launched {nz(launches_st)}, not K4 +4 fwd "
            "+2 inv")
    require(all(o.device.type == "cuda" for o in st_out), "main: the K4 path left the card")
    require(torch.equal(st_out[0].cpu(), st_cpu.negacyclic_polymul(st_l, st_r)),
            f"main: prime32 Plan({N16}, {p_st}) polymul differs from the CPU plain path")
    require(torch.equal(st_out[1].cpu(), st_cpu.fwd(st_l)),
            f"main: prime32 Plan({N16}, {p_st}) fwd differs from the CPU plain path")
    require(np.array_equal(st_out[2].cpu().numpy(),
                           (st_l.astype(np.uint64) * N16 % p_st).astype(np.uint32)),
            f"main: prime32 Plan({N16}, {p_st}) inv(fwd(x)) != n·x mod p")
    for k in ("butterfly32_fwd", "butterfly32_inv"):
        launches_n17[k] = launches_st[k]
    print(f"main: prime32 K4 above 2^15 on {kind}: Plan({N16}, {p_st}) (p < 2^26) B={B_STAGE} "
          f"numpy input on a default plan ({bcu.cluster_size(N16, B_STAGE)} blocks a "
          f"polynomial): polymul, fwd == CPU plain path, inv(fwd(x)) == n·x; launches "
          f"{nz(launches_st)}; {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    pplan16 = product.Plan.new(N16, EXT[0] * EXT[1], EXT[:2])
    m16 = pplan16.modulus
    qa, qb, qacc = (rand_mod(rng, m16, (B_BIG, N16)) for _ in range(3))
    qx = centred(rng, m16, (B_BIG, N16))
    d_qa, d_qb, d_qacc, d_qx = map(card, (qa, qb, qacc, qx))
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    q_rep = pplan16.negacyclic_polymul(d_qa, d_qb)
    expect_delta(before, fused, f"product Plan({N16}) Replace polymul")
    before = counts()
    q_bnd = pplan16.negacyclic_polymul(d_qx, d_qb, mode=acc, standard=d_qacc, lhs_fwd_mode=bnd)
    expect_delta(before, {"fwd_multi_perchannel": 1, "fwd_wide_multi": 1,
                          "pointwise_inv_multi": 1}, f"product Plan({N16}) Bounded polymul")
    torch.cuda.synchronize()
    launches_p16 = counts()
    lim = u64_limbs
    require(q_rep.device.type == "cuda" and torch.equal(
        q_rep.cpu(), pplan16.negacyclic_polymul(lim(qa), lim(qb))),
        f"main: product Plan({N16}) Replace polymul differs from the CPU plain path")
    require(torch.equal(q_bnd.cpu(), pplan16.negacyclic_polymul(
        lim(qx), lim(qb), mode=acc, standard=lim(qacc), lhs_fwd_mode=bnd)),
        f"main: product Plan({N16}) Bounded polymul differs from the CPU plain path")
    ao, bo = qa[0].astype(object), qb[0].astype(object)
    row0 = limbs_to_np_u64(q_rep[0].cpu().numpy())
    for k in ks_of(N16):
        require(int(row0[k]) == negacyclic_coeff(ao, bo, k, m16),
                f"main: product Plan({N16}) polymul coefficient {k} of row 0 differs from its "
                "direct sum")
    for k in ("fwd_multi_perchannel", "pointwise_inv_multi"):
        launches_n17[k] = launches_p16[k]
    print(f"main: product above 2^15 on {kind}: Plan({N16}, {EXT[0]}·{EXT[1]}) B={B_BIG} polymul "
          f"Replace and Bounded b={BOUND} == CPU plain path (all rows), Replace == direct sums "
          f"(4 coefficients of row 0); launches {nz(launches_p16)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # a u128 operand at 2^16 through K2 (x3 primes) and through the rank-local
    # passes (K3's A pass at the 4096 contraction)
    t0 = time.perf_counter()
    wide16 = tuple(prime32.Plan.new(N16, p) for p in BIG32.values())
    w16 = limbs_np(128, (4, N16))
    p_rl = BIG32["lt30"]
    tbl = mxu32._mxu_tables(N16, p_rl)
    geo16 = dict(n=N16, n1=tbl["n1"], n2=tbl["n2"], p=p_rl)
    d16 = tuple(torch.from_numpy(a).to(dev) for a in tbl["d"])
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    wide16_got = ntt_dispatch.try_fwd32_wide_all(plan_arg(w16, dev), wide16)
    expect_delta(before, {"fwd_u128": len(wide16)}, f"u128 operand through the K2 route at {N16}")
    before = counts()
    rl16 = rank_local_fwd(mxu32_cuda.pass_matmod, plan_arg(w16, dev), d16, **geo16)
    expect_delta(before, {"pass_matmod_u128": RANKS, "pass_matmod": RANKS},
                 f"rank-local fwd of a u128 operand n={N16}")
    torch.cuda.synchronize()
    launches_w16 = counts()
    for i, pl in enumerate(wide16):
        require(torch.equal(wide16_got[i].cpu(),
                            mxu32_cuda.fwd_plain(residue(w16, pl.p), n=N16, p=pl.p)),
                f"main: u128 operand through K2 at {N16}, p={pl.p}: differs from the transform "
                "of value mod p")
    require(torch.equal(rl16.cpu(), mxu32_cuda.fwd_plain(residue(w16, p_rl), n=N16, p=p_rl)),
            f"main: rank-local fwd of a u128 operand at {N16}: differs from the transform of "
            "value mod p")
    for k in ("fwd_u128", "pass_matmod_u128"):
        launches_n17[k] = launches_w16[k]
    print(f"main: u128 operands at n={N16} B=4 on {kind}: try_fwd32_wide_all over p in "
          f"{tuple(BIG32.values())} (K2 with four limbs) and the rank-local fwd (K3's A pass "
          f"with four limbs, R={RANKS}, p={p_rl}) == the CPU transform of value mod p; launches "
          f"{launches_w16}; {time.perf_counter() - t0:.1f} s", flush=True)

    # the 32-bit stage-split hybrid at 2^16 through its entry points (no route
    # takes it): the engine over K2 with block tables, and the channel-grid
    # hybrid as a three-channel polymul, held against the direct kernels
    t0 = time.perf_counter()
    p_h = BIG32["generic"]
    xh = rng.integers(0, p_h, (B32, N16), dtype=np.uint32)
    d_xh = host(xh).to(dev)
    p3e = EXT[:3]
    sc3 = tuple(scale32(N16, q) for q in p3e)
    ninv3 = tuple(pow(N16, q - 2, q) for q in p3e)
    ha, hb = (limbs_np(64, (B_BIG, N16)) for _ in range(2))
    l16, r16 = plan_arg(ha, dev), plan_arg(hb, dev)
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    hf = stagesplit.engine32_fused.fwd(d_xh, n=N16, p=p_h)
    expect_delta(before, {"fwd_hyb": 1}, "engine32_fused.fwd")
    before = counts()
    hi = stagesplit.engine32_fused.inv(hf, n=N16, p=p_h)
    expect_delta(before, {"inv_hyb": 1}, "engine32_fused.inv")
    before = counts()
    fl16 = stagesplit.fwd_wide_multi_hybrid32(l16, p3e, n=N16)
    fr16 = stagesplit.fwd_wide_multi_hybrid32(r16, p3e, n=N16)
    res16 = stagesplit.pointwise_inv_multi_hybrid32(fl16, fr16, p3e, sc3, n=N16)
    expect_delta(before, {"fwd_multi_perchannel_hyb": 2, "pointwise_inv_multi_hyb": 1},
                 "channel-grid hybrid32 polymul")
    before = counts()
    back16 = stagesplit.inv_multi_hybrid32(fl16, p3e, ninv3, n=N16)
    refwd16 = stagesplit.fwd_perchannel_multi_hybrid32(back16, p3e, n=N16)
    expect_delta(before, {"inv_multi_hyb": 1, "fwd_multi_perchannel_hyb": 1},
                 "channel-grid hybrid32 round trip")
    torch.cuda.synchronize()
    launches_h32 = counts()
    require(torch.equal(hf, mxu32_cuda.fwd(d_xh, n=N16, p=p_h)),
            "main: engine32_fused.fwd differs from the direct K2")
    require(np.array_equal(hi.cpu().numpy(), (xh.astype(np.uint64) * N16 % p_h).astype(np.uint32)),
            "main: engine32_fused inv(fwd(x)) != n·x mod p")
    dl16, dr16 = (mxu32_cuda.fwd_wide_multi(v, p3e) for v in (l16, r16))
    require(torch.equal(fl16, dl16) and torch.equal(fr16, dr16),
            "main: fwd_wide_multi_hybrid32 differs from K1a direct")
    require(torch.equal(res16, mxu32_cuda.pointwise_inv_multi(dl16, dr16, p3e, sc3)),
            "main: pointwise_inv_multi_hybrid32 differs from K1d direct")
    for c, q in enumerate(p3e):
        require(np.array_equal(back16[c].cpu().numpy(), (as_ints(ha) % q).astype(np.uint32)),
                f"main: inv_multi_hybrid32(fwd, n^-1) != x mod {q}")
    require(torch.equal(refwd16, fl16), "main: fwd_perchannel_multi_hybrid32 of the residues "
                                        "differs from the forward of the values")
    native3 = port.native_binary64.Plan32.try_new(N16)
    require(native3.primes == p3e, "main: native_binary64.Plan32(65536) has other primes")
    hyb_poly = native3._lift(res16, (B_BIG,), "planar")
    require(np.array_equal(out_limbs(hyb_poly), out_limbs(native3.negacyclic_polymul(
        l16, r16, rhs_binary=False))),
        "main: the channel-grid hybrid32 polymul differs from the plan's direct route")
    for k in ("fwd_hyb", "inv_hyb", "fwd_multi_perchannel_hyb", "inv_multi_hyb",
              "pointwise_inv_multi_hyb"):
        launches[k] = launches_h32[k]
    print(f"main: 32-bit hybrid at n={N16} n_h={N_H} on {kind} (no route takes it): "
          f"engine32_fused fwd / inv B={B32} p={p_h} == direct K2, inv(fwd(x)) == n·x; the "
          f"channel-grid hybrid B={B_BIG} over {p3e}: fwd x2 + pointwise_inv == K1a x2 + K1d "
          f"direct == native_binary64.Plan32's polymul after the lift, inv(fwd(x), n^-1) == x "
          f"mod p, fwd_perchannel of it == fwd; launches {nz(launches_h32)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # K1e and K5 with four limbs through their entry points (no route takes them)
    t0 = time.perf_counter()
    e_limbs = limbs_np(64, (B_MAIN, N_MAIN))
    e_arg = plan_arg(e_limbs, dev)
    ninv5 = tuple(pow(N_MAIN, q - 2, q) for q in PRIMES)
    w64 = limbs_np(128, (B64, N64))
    w64_arg = plan_arg(w64, dev)
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    e_back = mxu32_cuda.inv_multi_presplit(
        mxu32_cuda.digit_planes32(mxu32_cuda.fwd_wide_multi(e_arg, PRIMES)), PRIMES, ninv5)
    expect_delta(before, {"fwd_wide_multi": 1, "inv_multi_presplit": 1}, "K1e round trip")
    w64_out = []
    for rname in HYB_BIG:
        q = PRIMES64[rname]
        before = counts()
        w64_out.append(mxu64_cuda.inv(mxu64_cuda.fwd(w64_arg, n=N64, p=q), n=N64, p=q,
                                      scale=pow(N64, q - 2, q)))
        expect_delta(before, {"fwd64_u128": 1, "inv64": 1}, f"K5 u128 round trip p={q}")
    torch.cuda.synchronize()
    launches_e = counts()
    for c, q in enumerate(PRIMES):
        require(np.array_equal(e_back[c].cpu().numpy(), (as_ints(e_limbs) % q).astype(np.uint32)),
                f"main: K1e(planes of K1a(x), n^-1) != x mod {q}")
    for rname, out in zip(HYB_BIG, w64_out):
        q = PRIMES64[rname]
        got = limbs_to_np_u64(torch.stack([t.cpu() for t in out], dim=-1).numpy())
        require(np.array_equal(got, (as_ints(w64) % q).astype(np.uint64)),
                f"main: K5 inv(K5 fwd of a u128 operand, n^-1) != value mod {q}")
    for k in ("inv_multi_presplit", "fwd64_u128"):
        launches[k] = launches_e[k]
    print(f"main: K1e and K5-u128 on {kind}: inv_multi_presplit(digit_planes32(K1a(x)), n^-1) == "
          f"x mod p at n={N_MAIN} B={B_MAIN} over {PRIMES}; K5 inv(fwd of four limbs, n^-1) == "
          f"value mod p at n={N64} B={B64} for {HYB_BIG}; launches {nz(launches_e)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def memory_line(when: str) -> None:
        """Device bytes held and their peak, beside the fill of the 32-bit table caches."""
        mib = lambda v: f"{v / 2**20:.0f} MiB"
        print(f"memory: {when}: allocated {mib(torch.cuda.memory_allocated())}, peak "
              f"{mib(torch.cuda.max_memory_allocated())}, reserved "
              f"{mib(torch.cuda.memory_reserved())}; mxu32_cuda._kernel_tables "
              f"{mxu32_cuda._kernel_tables.cache_info()}, _hyb_tables "
              f"{mxu32_cuda._hyb_tables.cache_info()} | {smi}", flush=True)

    memory_line("after the main paths")

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
    x = u32((B32, 4096), p)
    timed("K2 fwd (passes_engine)", f"n=4096 B={B32} p={p}",
          lambda: mxu32_cuda.passes_engine.fwd(x, n=4096, p=p),
          lambda: mxu32_cuda.fwd_plain(x, n=4096, p=p))
    # K4 at the headline (1024, 16), at (2^14, 16) and (2^16, 16) with a
    # prime below 2^26 (clusters of 8 blocks); each row's device time (its
    # ntt_k4 launch) from the profiler session
    k4_dev, k4_rows = {}, {}
    dev_into[id(k4_dev)] = k4_dev
    for n, p in ((1024, BENCH_PRIMES["lt30"]), (N32, SMALL_P), (N16, SMALL18)):
        pl = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=pl.variant, p_neginv=pl.p_neginv)
        x = u32((B32, n), p)
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
    for name, pl, _, binary, a, b in fam:
        la, lb = plan_arg(a, dev), plan_arg(b, dev)
        fam_calls[name] = (lambda pl=pl, la=la, lb=lb: pl.negacyclic_polymul(la, lb))
        t = median_ms(fam_calls[name])
        print(f"times: {name} polymul n={N_MAIN} B={B_MAIN} "
              f"{'planar' if pl.width > 32 else 'u32'}: {t:.4f} ms (median of {REPS}) = "
              f"{B_MAIN / t * 1e3:.1f} products/s | {smi}", flush=True)
    for name, pl, _, a, b in perch:
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
    kw = dict(n=N16, p=p, which="A", n_limbs=4, diag_slices=d16)
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
    for name, n, pl, _, a, b in big_fam:
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
    for (key, n), (label, t, _) in k4_rows.items():
        bms, by = k4_bound(n, B32)
        print(f"times: {key} {label} device {fmt(k4_dev.get((key, n)))}, kernel {t:.4f} ms "
              f"(torch.profiler, median of {REPS}) | {smi}", flush=True)
        print(f"bound: {key} at {label}: {bms:.6f} ms by {by} (kernel {t:.4f} ms = "
              f"{t / bms:.1f} x the bound, device {fmt(k4_dev.get((key, n)))})", flush=True)
    print(f"times: device-time session {time.perf_counter() - t0:.1f} s", flush=True)

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

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k], "ms": ms[k],
         "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None,
         **({"device_ms": dev_ms.get(k), "gemm_ms": int_mm_ms.get(k)}
            if k in GEMM_ROWS else {}),
         **({"device_ms": k4_dev.get((k, 1024))} if k.startswith("butterfly32_") else {}),
         **({"n17": big_rows[k]} if k in big_rows else {})}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
