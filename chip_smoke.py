#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`concrete_ntt_tpu_torch`) on one GPU.

Drives the port's paths through their hand-written CUDA kernels:
  * native64: `native64.Plan32(2^14).negacyclic_polymul` on planar (lo, hi)
    uint32 limbs at batch 8, through K1a (`fwd_wide_multi`) and K1b
    (`inv_multi`) of `csrc/mxu32_multi.cu` and the Garner lift kernel
    (`lift_u64_from5`, `csrc/crt_lift.cu`);
  * prime32: `prime32.Plan(n, p).negacyclic_polymul` in the three prime
    regimes (lt30, lt31, generic), through K2 (four-step `fwd` / `inv`,
    2048 <= n <= 2^17, p >= 2^26; tiles for one channel's small grids) of
    `csrc/mxu32_pass.cu` and K4 (butterfly `fwd` / `inv`, n < 2048 or
    p < 2^26, up to 2^17 over a cluster of blocks) of `csrc/butterfly32.cu`;
  * rank-local passes: K3's channel grid (`pass_matmod_multi`,
    `csrc/mxu32_pass.cu` `k3_pass_multi`) through the port's local sections
    (`parallel/fourstep_mxu.py`: a column pass on a view of the rank's
    value shard with its diagonal rows, the all-to-all, a row pass on the
    exchange's output in place), with R = 4 ranks held in this process and
    the all-to-all done as slices and concatenations (`exchange`); K3's
    one-channel `pass_matmod` (`k3_pass`, the JAX pass_matmod's twin, which
    no route takes) on rank 0's four passes beside it;
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
  * rank-local 64-bit passes: K6's channel grid (`pass_matmod64_multi`,
    `k6_pass_multi`, same source) through the same local sections on limb
    pairs, R = 4 ranks in this process, and `pass_matmod64` (`k6_pass`) on
    rank 0's four passes beside it;
  * the sharded paths (`concrete_ntt_tpu_torch.parallel`) in worlds of rank
    processes: R = 4 gloo ranks on the one card (NCCL refuses two ranks on
    one card) and a world of one on NCCL, each rank running
    `native128.Plan32(2^16)` through `ChannelShardedNative` at (dp, ch, sp)
    = (1, 2, 2) (one K3 channel-grid launch a pass over the rank's five
    channels: the A passes with the operand's four limbs), `native64.Plan32(2^14)`
    through one `make_sharded_prime32_mxu` a channel at (2, 1, 2) (K3's grid
    with one channel) and `native64.Plan52(2^14)` through
    `ChannelShardedNative52` at (2, 1, 2) (one K6 launch a pass over three
    channels), batch 8;
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
    planes) over 10 and 5 channels (native128 lifting through its two lift
    kernels, `lift_u128_digits` and `lift_u128_limbs` of
    `csrc/crt_lift128.cu`), the others K1a / K1b with one or two
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
               dynamic shared memory (the 32-bit pass's per tile, and with
               K1d's second operand) and, from
               `cuobjdump -sass`, each library's GMMA (warpgroup tensor-core
               products), IMMA (int8 mma.sync) and IDP.4A (dp4a)
               instructions: the four GEMM libraries (mxu32_*, mxu64_*) must
               hold GMMA and no IDP.4A, no instance of the 64-bit pass nor of
               K2's small-grid tiles may spill, K1c / K1d's eight tile
               instances must be built, and a missing cuobjdump fails;
               K4's instances' registers and spills, and how many of its
               clusters the card holds at once (cudaOccupancyMaxActiveClusters:
               the cluster launch must be accepted at 2^14 and 2^17);
               K3's channel-grid instances of every tile `k3_multi_tile`
               picks and the 16 64-row instances of the 64-bit pass built;
               the lift kernels' vector and scalar instances (native64's
               one, native128's two), no spill.
  3. parity  — each kernel against its plain torch version on the card,
               exact equality: K1a/K1b at (n, B) = (2^14, 8), (2^14, 5),
               (2^11, 3), (2^15, 2); the lift kernel at (n, B) = (2^14, 8),
               (2^14, 5), (1024, 3), (2^17, 3), (2, 3) and (2^11, 3) one
               word past an aligned base; native128's two lift kernels
               (`LIFT128_SHAPES`: the same and (2^16, 8), (2^16, 64));
               K2 fwd, fwd_wide, inv (unscaled and scaled) at (2^14, 16),
               (2^14, 3), (2^15, 2) and at n in {2048, 4096, 8192}, B in
               {16, 3}; K3 pass_matmod (A scaled
               with 1 and 2 limbs, F, G scaled, Ainv plain and scaled, a
               row slice with rank-local diagonals) at the same mid sizes;
               all of K2/K3 for the three bench primes; K4 fwd / inv at n in
               {2, 32, 256, 1024, 2^14, 2^15}, B in {16, 9}, in each regime,
               with p = 67043329 at 2^14 and 2^15, and at 2^16 and 2^17 (B in
               {16, 9}) in the three regimes and with a prime below 2^26,
               all with 2^18 | p - 1; K1c (1 and 2 limbs)
               and K1d (full-range u32 operands) over 2 or 3 channel primes
               at (n, B, C) = (2^14, 16, 2), (2^14, 16, 3), (2^14, 5, 2),
               (2^14, 1, 2), (2^11, 3, 2), (2^15, 2, 2), (2^16, 8, 2),
               (2^16, 8, 3), (2^16, 5, 3), (2^16, 1, 2): the tiles
               `mxu32_cuda.k1_tile` picks, every one of K1c / K1d's eight
               tile instances launched (`mxu32_cuda.TILE_LAUNCHES`) or the
               phase fails; K5 fwd,
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
               (2^15, 16), (2^16, 1), (2^16, 16), (2^17, 1), (2^17, 16) in
               four regimes (lt30, lt31, generic with four and with five
               digit planes) on the tile codes `mxu32_cuda.k2h_tiles` picks,
               and at (2^16, 1), (2^16, 16) every pair of codes forced
               (against the rule's result; the phase fails unless every
               code ran), K1c (1, 2 limbs) / K1b / K1d over three channel
               primes at (2^15, 8), (2^16, 8), each against its plain
               version and each whole hybrid (`engine32_fused`) against the
               direct kernel. K1e == its plain version == K1b at (2^11, 3,
               5 ch), (2^16, 2, 5 ch) and (2^14, B, C) for B in {1, 8, 16}
               x C in {2, 3, 5, 10} on the codes `mxu32_cuda._k1e_tiles`
               picks, every pair of codes forced at (2^14, 8, 5) and
               (2^14, 1, 2) (the phase fails unless every code ran); K5 fwd
               with four limbs at
               (2^14, 16), (2^11, 3) in five regime primes. The tensor-core
               pass at small and ragged shapes, (n, B) in (2^11, 1),
               (2^11, 3), (2^12, 2), (2^13, 5): K1a with 1, 2, 4 limbs, K1b,
               K2 fwd / fwd_wide / inv in lt30 and with a five-plane prime.
               The eight (digit planes, regime) instances of the 64-bit
               pass, one prime each: K5 fwd, inv (plain, scaled) at (2^11,
               3) (ragged row tiles) and (2^14, 3), K6 A scaled on a row
               slice and F canonical at (2^11, 3). K3's and K6's channel
               grids (`pass_matmod_multi`, `pass_matmod64_multi`): the four
               passes of a rank's transform pair on the routes' strided
               views (A on the value shard, F on the exchange's output, G,
               A_inv written transposed) at K3_MULTI_SHAPES /
               K6_MULTI_SHAPES (the gloo world's rank-local shapes, s = 2
               and 4, n = 2^11 .. 2^17, C = 1-5 and 10), K3 with one channel per
               regime, K6 with one channel per 64-bit instance on both
               tiles: every tile code of `k3_multi_tile` (0-3) and
               `k6_tile` (0, 1) launched or the phase fails.
  3b. parity gate — tools/gpu_parity.py's --quick rows in this process:
               every value of `ntt_dispatch.route32` / `tier32` / `tier64` /
               `route64` at n in its QUICK_N (B 1, 3, 16; every regime,
               limb count and channel count), each kernel row against its
               plain version, each plan row (the ten public plans) against
               the golden oracle's sampled coefficients, and the dense
               fixture (tests/fixtures/dense_oracle_2048.json: native32,
               native64 Plan32 and Plan52, native128, native_binary64 at
               N = 2048) against its digests; prints the FAIL and fixture
               lines, and fails on any FAIL.
  4. main    — native64: three polymuls on the card == CPU plain path ==
               numpy wrapping oracle (row 0); K1a +2, K1b +1, the lift +1
               per call.
               prime32: Plan(2^14, p) polymul at B = 16 for each bench prime
               == CPU plain path, and inv(fwd(x)) == n·x mod p (K2 +2 fwd
               +1 inv per polymul, also at n = 4096); Plan(1024,
               1073479681) polymul, row 0 == the schoolbook oracle (K4 +2
               fwd +1 inv); the README vector N = 32, p = 1062862849, round
               trip. Rank-local passes: fwd and inv at n = 4096, B = 16 for
               each bench prime == CPU plain path, and inv(fwd(x)) == n·x
               (K3's channel grid +2R passes a transform; rank 0's four
               passes through K3 `pass_matmod` == the grid's). product:
               Plan(2^14, f1·f2)
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
               through K6's grid at n = 4096 (+4R a round trip; rank 0's
               passes through K6 `pass_matmod64` == the grid's). Plan52(2^14)
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
               K1b +1, the two lift kernels +1 each, native_binary128
               K1a-u128 +1, K1a +1, K1b +1; at n = 1024 native32,
               native_binary64 and native128 Plan32 through the per-channel
               route (K4 +2k fwd, +k inv, no K1 launch; native128's lift
               kernels +1 each); `"py128"` lists on a default native128
               plan == the planar result; a u128 operand through K2 (x3 primes) and
               through the rank-local passes (K3's grid with four limbs +R,
               one limb +R; rank 0's A pass through K3 `pass_matmod` with
               four limbs == the grid's) == its
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
  4b. sharded — `parallel._dist.spawn` starts the worlds (the kernels are
               built by then; FileStores in a temporary directory; 600 s a
               world). Each rank runs the three sharded paths once with its
               launch counts set to 0 just before each and read just after:
               it raises unless they are the route's (a rank at (1, 2, 2):
               K3's grid 2 with four limbs and 4 with one for native128; 30
               for native64; K6's grid 6 for Plan52) and nothing else, and,
               in the gloo world, unless the same path on CPU tensors
               (device="cpu", the plain passes) gives the same bits; then 5
               polymuls timed barrier to barrier; the NCCL rank, alone on
               the card, also under torch.profiler (device busy share,
               aten ops a polymul). Rank 0's products == the single-card
               plans' (K1a-u128 / K1b, K1a / K1b, K7a / K7d) on the same
               inputs, for both worlds; a failed, hung or silent rank fails
               the phase. Then K3's and K6's channel grids at the rank-local
               shapes of the gloo world (each pass of each path: wrapper ms,
               device ms, torch._int_mm on the same digit GEMMs, bound; the
               device ms of a rank's polymul), which the JSON rows of
               pass_matmod_multi, pass_matmod_multi_u128 and
               pass_matmod64_multi carry under `rank_local`; their
               `launches` are the gloo world's, summed over its ranks.
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
               K1e beside K1b (and at (2^14, 8, 5), (2^14, 16, 2) their
               device ms, torch._int_mm, bound and share of it), K2h at
               (2^16 | 2^17, 16 | 1) likewise, K5 with four limbs; K4 at
               (2^14, 16) and
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
  6. stages  — the twin of tools/profile_stages.py and tools/ab_lift.py on
               `utils/profiling.chain_time` (CUDA graphs: a chain of 64
               dependent steps, 32 at 2^16, minus a chain of one, replayed
               in turns): the native64 Plan32 polymul at (2^14, 8) on planar
               uint32 limbs (its launches K1a 2, K1b 1, the lift 1 read on
               an eager call), its stages fwd-wide-multi (x2 a polymul),
               pointwise-montgomery (`ntt_dispatch.pointwise_mont32`),
               inv-multi, the lift `crt.rec_u64_from5`, beside it
               `crt_mxu.rec_u64_from5` and the lift kernel
               (`crt_cuda.rec_u64_from5`, the route's), and native128
               Plan32 at (2^16, 8) (launches K1a-u128 2, K1b 1, its two
               lift kernels 1 each) with its lift kernels
               (`crt_cuda.rec_u128_from10`):
               each row's chain ms (dispatch removed), eager CUDA-event
               median (dispatch included) and roofline share
               (`profiling.Roofline`), a graph of two steps held bit for bit
               against eager; the sum of the stages (the kernel's lift)
               beside the whole. Then
               the lift A/B: `ops/crt.py` against `crt_mxu` (the int8-GEMM
               accumulation, `torch._int_mm`) for rec_u64_from5 and
               rec_u128_from5 at [8, 2^14] and rec_u128_from10 at [8, 2^16]:
               equal bit for bit, chain ms, eager ms and aten ops a call.
               A capture that fails fails the run. Then the three
               `examples/*_torch.py` run on the card, all started together.
Then one JSON line of kernel summaries (each with its launches on its main
path, error, ms, plain ms, and, for the direct 32-bit kernels, the same
numbers at their shape above 2^15 under `n17`; the rows of both GEMM passes
and the `n17` entries also `device_ms` and `gemm_ms`, the two profiler times;
and the bound: the larger of its bytes over
3.35 TB/s and its int8 operations over 1,979 TOP/s, the H100 SXM data-sheet
rates that `concrete_ntt_tpu_torch/utils/profiling.py` holds; `library_ms`
is null for all: no single PyTorch call computes an exact modular
transform), the nvidia-smi line, and last
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
PARITY_SHAPES = ((1 << 14, 8), (1 << 14, 5), (1 << 11, 3), (1 << 15, 2))
# (n, B, base offset in words) of the lift kernel's parity: both prime
# families, a count B·n that is not a multiple of 4 and a misaligned base
# (its scalar instance)
LIFT_SHAPES = ((1 << 14, 8, 0), (1 << 14, 5, 0), (1024, 3, 0), (1 << 17, 3, 0), (2, 3, 0),
               (1 << 11, 3, 1))
# (n, B, base offset in words) of native128's lift kernels: both ten-prime
# families, the cell native128-n65536-b64's (2^16, 64), counts that are not a
# multiple of 4 and misaligned bases (their scalar instances)
LIFT128_SHAPES = ((1 << 14, 8, 0), (1 << 16, 8, 0), (1 << 16, 64, 0), (1024, 3, 0), (2, 3, 0),
                  (1 << 11, 3, 1), (1 << 17, 3, 2))
# (n, B, channels) of K1c / K1d's parity: the product plan's (2^14, 16, 2),
# batch edges, 3 channels, and (2^16, 8): every tile instance k1_tile picks
K1CD_SHAPES = ((1 << 14, 16, 2), (1 << 14, 16, 3), (1 << 14, 5, 2), (1 << 14, 1, 2),
               (1 << 11, 3, 2), (1 << 15, 2, 2), (1 << 16, 8, 2), (1 << 16, 8, 3),
               (1 << 16, 5, 3), (1 << 16, 1, 2))
# K1c / K1d's pass instances beside K1's own (csrc/mxu32_multi.cu launch_k1):
# (epilogue of the pass, tile code)
K1_TILED = (("scaled", 1), ("scaled", 2), ("canonical", 1), ("canonical", 2), ("canonical", 3),
            ("scaled+pointwise", 1), ("scaled+pointwise", 2), ("scaled+pointwise", 3))
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
MULTI_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_multi.cu"
PASS_SRC = "concrete_ntt_tpu_torch/csrc/mxu32_pass.cu"
BFLY_SRC = "concrete_ntt_tpu_torch/csrc/butterfly32.cu"
PASS64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_pass.cu"
MULTI64_SRC = "concrete_ntt_tpu_torch/csrc/mxu64_multi.cu"
LIFT_SRC = "concrete_ntt_tpu_torch/csrc/crt_lift.cu"
LIFT128_SRC = "concrete_ntt_tpu_torch/csrc/crt_lift128.cu"
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
# K2 with block tables: (n, B) per regime (its tile codes from k2h_tiles), and
# the shapes where every pair of tile codes is forced
HYB32_SHAPES = ((1 << 15, 16), (N16, 1), (N16, 16), (N17, 1), (N17, 16))
K2H_FORCED = ((N16, 1), (N16, 16))
K1H_SHAPES = ((1 << 15, 8), (N16, 8))
# K1e: (n, B, C), its codes from k1_tile on C channels; every code pair forced
# at K1E_FORCED
K1E_SHAPES = ((1 << 11, 3, 5), (N16, 2, 5)) + tuple(
    (1 << 14, b, c) for b in (1, 8, 16) for c in (2, 3, 5, 10))
K1E_FORCED = ((1 << 14, 8, 5), (1 << 14, 1, 2))
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
    reset_launch_counts()
    plan.negacyclic_polymul(tuple(ops[:2]), tuple(ops[2:]))
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    require(launched == {"fwd_wide_multi": 2, "inv_multi": 1, "lift_u64_from5": 1},
            f"stages: the native64 Plan32 polymul launched {launched}")
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
    require(gate().same_bits(crt_cuda.rec_u64_from5(fl, primes),
                             crt_cuda.rec_u64_from5_plain(fl, primes)),
            f"stages: the lift kernel differs from its plain twin at [{b}, {n}]")
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
    reset_launch_counts()
    plan128.negacyclic_polymul(tuple(ops[:4]), tuple(ops[4:]))
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    require(launched == {"fwd_wide_multi_u128": 2, "inv_multi": 1, "lift_u128_digits": 1,
                         "lift_u128_limbs": 1},
            f"stages: the native128 Plan32 polymul launched {launched}")
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


def exchange(ys: list, split_axis: int, concat_axis: int) -> list:
    """The tiled all-to-all over RANKS ranks held in this process: rank q gets
    chunk q of every rank's split axis, concatenated in rank order (what
    `parallel._dist.all_to_all_tiled` does between processes)."""
    return [torch.cat([y.chunk(len(ys), split_axis)[q] for y in ys], dim=concat_axis)
            for q in range(len(ys))]


def rank_rows(diag, r: int, rows: int):
    """Rank r's rows of a diagonal [planes, R, O] (all its tables stacked) as
    the channel-grid passes take them: [1, planes, rows, O], contiguous."""
    return diag[:, r * rows:(r + 1) * rows].unsqueeze(0).contiguous()


def held_fwd(fm, x, diag, *, n, n1, n2, p):
    """Forward NTT [B, n] -> [B, n] (bit-reversed) through the port's
    rank-local sections (`parallel/fourstep_mxu.py`: `col_pass` with the
    rank's rows of d, the all-to-all, `row_pass`), RANKS ranks held in this
    process: rank r's value shard is columns r·c.. of [B, n1, n2], read in
    place as a view; a limb tuple is a wide operand; diag = d's tables
    stacked [planes, n2, n1]."""
    limbs = x if isinstance(x, tuple) else (x,)
    b, c = limbs[0].shape[0], n2 // RANKS
    ys = []
    for r in range(RANKS):
        v = tuple(a.reshape(b, n1, n2)[:, :, r * c:(r + 1) * c] for a in limbs)
        ys.append(fm.col_pass(v if len(v) > 1 else v[0], rank_rows(diag, r, c), n=n, p=p))
    outs = [fm.row_pass(y, n=n, p=p) for y in exchange(ys, 2, 1)]  # [B, c1, n2] each
    return torch.cat(outs, dim=1).reshape(b, n)


def held_inv(fm, x, diag, *, n, n1, n2, p):
    """The mirror (unnormalized): rank q holds rows q·c1.. of the NTT domain;
    `row_pass_inv` with its rows of e (diag = e stacked [planes, n1, n2]),
    the all-to-all, `col_pass_inv`."""
    b, c1 = x.shape[0], n1 // RANKS
    xv = x.reshape(b, n1, n2)
    ys = [fm.row_pass_inv(xv[:, q * c1:(q + 1) * c1], rank_rows(diag, q, c1), n=n, p=p)
          for q in range(RANKS)]
    outs = [fm.col_pass_inv(y, n=n, p=p) for y in exchange(ys, 2, 1)]  # [B, n1, c] each
    return torch.cat(outs, dim=2).reshape(b, n)


def held_fwd64(fm, x, diag, *, n, n1, n2, p):
    """`held_fwd` on (lo, hi) limb pairs (`col_pass64`, `row_pass64`)."""
    b, c = x[0].shape[0], n2 // RANKS
    ys = [fm.col_pass64(tuple(a.reshape(b, n1, n2)[:, :, r * c:(r + 1) * c] for a in x),
                        rank_rows(diag, r, c), n=n, p=p)
          for r in range(RANKS)]
    recv = zip(*(exchange([y[i] for y in ys], 2, 1) for i in range(2)))
    outs = [fm.row_pass64(pair, n=n, p=p) for pair in recv]  # (lo, hi) [B, c1, n2] each
    return tuple(torch.cat([o[i] for o in outs], dim=1).reshape(b, n) for i in range(2))


def held_inv64(fm, x, diag, *, n, n1, n2, p):
    """`held_inv` on (lo, hi) limb pairs (`row_pass_inv64`, `col_pass_inv64`)."""
    b, c1 = x[0].shape[0], n1 // RANKS
    xv = tuple(a.reshape(b, n1, n2) for a in x)
    ys = [fm.row_pass_inv64(tuple(a[:, q * c1:(q + 1) * c1] for a in xv),
                            rank_rows(diag, q, c1), n=n, p=p)
          for q in range(RANKS)]
    recv = zip(*(exchange([y[i] for y in ys], 2, 1) for i in range(2)))
    outs = [fm.col_pass_inv64(pair, n=n, p=p) for pair in recv]  # (lo, hi) [B, n1, c] each
    return tuple(torch.cat([o[i] for o in outs], dim=2).reshape(b, n) for i in range(2))


# K3 / K6 on a rank's channel grid: (n, B, s, channels[, A-pass limbs]) of
# the four passes of a rank's transform pair (A on the value shard, F on the
# exchange's output, G, A_inv written transposed): the sharded routes'
# rank-local shapes in the gloo world (native128 (2^16, 8) at (dp, ch, sp) =
# (1, 2, 2), native64 (2^14, 8) at (2, 1, 2), Plan52 (2^14, 8) at (2, 1, 2)
# and in a world of one, the held ranks of the main phase), s = 2 and 4, n =
# 2^11 .. 2^17, C = 1-5 and 10, and every tile code the rules pick
# (`mxu32_cuda.k3_multi_tile`: 64 x 16, K1's tile holding four stages whole
# at (2^14, 16, 1, 2), 128 x 64 for canonical passes at (4096, 16, 1, 10),
# K1's ring; `mxu64_cuda.k6_tile`: 64 rows here, 128 at the eight
# instances' (2^14, 32, 1, 1)). The NCCL world of one checks its own shapes
# end to end (phase `sharded`).
K3_MULTI_SHAPES = ((1 << 16, 8, 2, 5, 4), (1 << 14, 4, 2, 1, 1),
                   (4096, 16, 4, 1, 1), (1 << 11, 3, 4, 1, 1), (1 << 11, 2, 2, 5, 2),
                   (1 << 12, 4, 2, 3, 4), (1 << 13, 3, 4, 2, 1), (1 << 14, 16, 1, 2, 1),
                   (4096, 16, 1, 10, 1), (1 << 15, 2, 4, 5, 1), (1 << 17, 2, 4, 2, 1))
K6_MULTI_SHAPES = ((1 << 14, 4, 2, 3), (1 << 14, 8, 1, 3), (4096, 16, 4, 1), (1 << 11, 3, 4, 1),
                   (1 << 12, 2, 2, 5), (1 << 13, 3, 4, 2), (1 << 15, 2, 2, 3))


# the `sharded` phase: the slice's three paths in a world of RANKS rank
# processes on the one card (gloo: NCCL refuses two ranks on one card), and
# once in a world of one on NCCL; (dp, ch, sp) of each path's mesh
N_SH128, N_SH64, B_SH = 1 << 16, 1 << 14, 8
SHARDED_MESHES = {"native128": (1, 2, 2), "native64": (2, 1, 2), "plan52": (2, 1, 2)}
SHARDED_REPS = 5
SHARDED_TIMEOUT = 600  # seconds a world may take, rank processes' start and tables included


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda, crt_cuda, mxu32_cuda, mxu64_cuda

    return {**mxu32_cuda.LAUNCHES, **mxu64_cuda.LAUNCHES, **crt_cuda.LAUNCHES,
            **{f"butterfly32_{k}": v for k, v in butterfly32_cuda.LAUNCHES.items()}}


def reset_launch_counts() -> None:
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda, crt_cuda, mxu32_cuda, mxu64_cuda

    for m in (mxu32_cuda, mxu64_cuda, butterfly32_cuda, crt_cuda):
        m.reset_launch_counts()


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
        torch.cuda.synchronize()
        reset_launch_counts()
        got = run(lhs, rhs)
        torch.cuda.synchronize()
        launched = {k: v for k, v in launch_counts().items() if v}
        if launched != sharded_want(name, shape):
            raise RuntimeError(f"rank {rank}: {name} launched {launched}, expected "
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
        out[name] = {"out": got if rank == 0 else None, "launches": launched, "ms": ms}
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
        crt_cuda, cuda_build, mxu32, mxu32_cuda, mxu64, mxu64_cuda, ntt_dispatch, stagesplit)
    from concrete_ntt_tpu_torch.ops.u32 import (
        limbs_to_np_u64, mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32)
    from concrete_ntt_tpu_torch.parallel import _dist
    from concrete_ntt_tpu_torch.parallel import fourstep_mxu as fm
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, NATIVE128_PRIMES, PRIMES52, primes32_ext
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)
    from concrete_ntt_tpu_torch.utils.profiling import device_times

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
    mxu64_cuda._pass_lib(), mxu64_cuda._multi_lib(), crt_cuda._lib(), crt_cuda._lib128()
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
                                       ("crt_lift128_", "lift_u128_", 4)):
            if os.path.basename(so).startswith(lib):  # the vector and scalar instances
                lifts = [e for e in ptxas_entries(log) if kernel in e[0]]
                require(len(lifts) == instances and all(st == ld == 0 for _, _, st, ld in lifts),
                        f"build: {os.path.basename(so)}: lift instances {lifts} missing or "
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

    counts, reset_counts = launch_counts, reset_launch_counts

    def nz(d: dict) -> dict:
        """The non-zero entries of a launch-count dict, for the printed lines."""
        return {k: v for k, v in d.items() if v}

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
    for n, b, off in LIFT_SHAPES:
        lp = PRIMES if n <= 1 << 15 else EXT[:5]
        words = np.concatenate([np.zeros(off, dtype=np.uint32)] + [
            rng.integers(0, p, b * n, dtype=np.uint32) for p in lp])
        res = torch.from_numpy(words).to(dev)[off:].view(5, b, n)  # `off` words in
        got, want = crt_cuda.rec_u64_from5(res, lp), crt_cuda.rec_u64_from5_plain(res, lp)
        for i, limb in enumerate(("lo", "hi")):
            compare("lift_u64_from5", got[i], want[i], f"n={n} B={b} offset={off} {limb}")
    print(f"parity: lift_u64_from5 {checks['lift_u64_from5']} checks exact at (n, B, base "
          f"offset in words) in {LIFT_SHAPES}, primes {PRIMES} up to 2^15, {EXT[:5]} above, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for n, b, off in LIFT128_SHAPES:
        lp = NATIVE128_PRIMES if n <= 1 << 15 else EXT
        words = np.concatenate([np.zeros(off, dtype=np.uint32)] + [
            rng.integers(0, p, b * n, dtype=np.uint32) for p in lp])
        res = torch.from_numpy(words).to(dev)[off:].view(10, b, n)
        got, want = crt_cuda.rec_u128_from10(res, lp), crt_cuda.rec_u128_from10_plain(res, lp)
        for i in range(4):
            compare("lift_u128_from10", got[i], want[i], f"n={n} B={b} offset={off} limb {i}")
    print(f"parity: lift_u128_from10 (digits + limbs) {checks['lift_u128_from10']} checks exact "
          f"at (n, B, base offset in words) in {LIFT128_SHAPES}, primes {NATIVE128_PRIMES} up to "
          f"2^15, {EXT} above, in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    p2 = PRIMES[:2]
    reset_counts()
    for n, b, c in K1CD_SHAPES:
        pc = (PRIMES if n <= 1 << 15 else EXT)[:c]
        xs = (u32((c, b, n)), u32((c, b, n)))  # full-range u32
        what = f"n={n} B={b} C={c}"
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_multi_perchannel(xs[0], pc),
                mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], pc), what + " limbs=1")
        compare("fwd_multi_perchannel", mxu32_cuda.fwd_wide_multi_perchannel(*xs, pc),
                mxu32_cuda.fwd_multi_perchannel_plain(xs, pc), what + " limbs=2")
        scales = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in pc)
        compare("pointwise_inv_multi", mxu32_cuda.pointwise_inv_multi(*xs, pc, scales),
                mxu32_cuda.pointwise_inv_multi_plain(*xs, pc, scales), what)
    # every pass instance of K1c / K1d's tiles ran (the first pass's epilogue
    # is scaled, K1d's with the pointwise pair; the second pass's canonical)
    ran = set()
    for (name, t1, t2), v in mxu32_cuda.TILE_LAUNCHES.items():
        first = "scaled+pointwise" if name.startswith("pointwise") else "scaled"
        ran |= {(first, t1), ("canonical", t2)}
    require(set(K1_TILED) <= ran, f"parity: K1c / K1d pass instances {sorted(set(K1_TILED) - ran)} "
                                  "never ran")
    print(f"parity: K1c {checks['fwd_multi_perchannel']}, K1d {checks['pointwise_inv_multi']} "
          f"checks exact at (n, B, C) in {K1CD_SHAPES}, primes {PRIMES[:3]} up to 2^15, "
          f"{EXT[:3]} above, full-range u32 operands; launches by (kernel, tile codes) "
          f"{dict(mxu32_cuda.TILE_LAUNCHES)}: every pass instance {K1_TILED} ran, in "
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

    # K3 / K6 on channel grids with strided operands, against their plain
    # twins, at the routes' shapes and every tile code their rules pick
    t0 = time.perf_counter()
    mxu32_cuda.TILE_LAUNCHES.clear()
    mxu64_cuda.TILE_LAUNCHES.clear()
    grid32 = [(shape, tuple((EXT if shape[0] > 1 << 15 else NATIVE128_PRIMES)[:shape[3]]))
              for shape in K3_MULTI_SHAPES]
    grid32 += [((4096, 3, 2, 1, 2), (p,)) for p in BENCH_PRIMES.values()]
    grid32 += [((N17, 16, 2, 1, 1), (BENCH_PRIMES["generic"],)), ((N16, 3, 2, 1, 4),
                                                                  (BIG32["lt31"],))]
    for (n, b, s, c, limbs), primes in grid32:
        for which, x, rows in gate().route_passes(u32, n, b, s, c, limbs):
            kw = dict(n=n, primes=primes, which=which, transposed_out=which == "Ainv",
                      diag=mxu32_cuda.multi_diag(n, primes, which, *rows, str(dev)) if rows
                      else None,
                      scales=tuple(pow(n, q - 2, q) * pow(2, 32, q) % q for q in primes)
                      if which == "Ainv" else None)
            x = x if len(x) > 1 else x[0]
            key = "pass_matmod_multi_u128" if which == "A" and limbs == 4 else "pass_matmod_multi"
            compare(key, mxu32_cuda.pass_matmod_multi(x, **kw),
                    mxu32_cuda.pass_matmod_multi_plain(x, **kw),
                    f"n={n} B={b} s={s} C={c} {which} limbs={limbs} primes={primes[:2]}")
    grid64 = [(shape, tuple(PRIMES52[:shape[3]])) for shape in K6_MULTI_SHAPES]
    for p in INSTANCES64.values():
        grid64 += [((4096, 3, 2, 1), (p,)), ((1 << 14, 32, 1, 1), (p,))]
    for (n, b, s, c), primes in grid64:
        for which, x, rows in gate().route_passes(u32, n, b, s, c, 1, pair=True):
            kw = dict(n=n, primes=primes, which=which, transposed_out=which == "Ainv",
                      diag=mxu64_cuda.multi_diag(n, primes, which, *rows, str(dev)) if rows
                      else None,
                      scales=tuple(scale64(n, q) for q in primes) if which == "Ainv" else None)
            compare_pair("pass_matmod64_multi", mxu64_cuda.pass_matmod64_multi(x, **kw),
                         mxu64_cuda.pass_matmod64_multi_plain(x, **kw),
                         f"n={n} B={b} s={s} C={c} {which} primes={primes[:2]}")
    tiles32 = sorted({k[1] for k in mxu32_cuda.TILE_LAUNCHES if k[0].startswith("pass_matmod_m")})
    tiles64 = sorted({k[1] for k in mxu64_cuda.TILE_LAUNCHES})
    require(tiles32 == [0, 1, 2, 3] and tiles64 == [0, 1],
            f"parity: the channel grids launched tile codes {tiles32} (K3) and {tiles64} (K6), "
            "not every code their rules pick")
    print(f"parity: K3's channel grid {checks['pass_matmod_multi']} + "
          f"{checks['pass_matmod_multi_u128']} (four limbs) checks exact at (n, B, s, C, limbs) "
          f"in {K3_MULTI_SHAPES} and one channel per regime, tile codes {tiles32}; K6's "
          f"{checks['pass_matmod64_multi']} at {K6_MULTI_SHAPES} and the eight instances on both "
          f"tiles, tile codes {tiles64}; in {time.perf_counter() - t0:.1f} s", flush=True)

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

    # the 32-bit hybrid's block tables: K2 per regime (a generic prime with four
    # digit planes besides BIG32's three), its tile codes from k2h_tiles and,
    # at K2H_FORCED, every pair of codes forced; K1b / K1c / K1d over three
    # channel primes; and each whole hybrid against the direct kernel at the same n
    t0 = time.perf_counter()
    hyb32_build = []
    HYB32 = {"lt30": BIG32["lt30"], "lt31": BIG32["lt31"],
             "generic4": prime_in_ap(1 << 18, 1, 1 << 31, 3 << 30), "generic5": BIG32["generic"]}
    require([mxu32._n_dplanes32(q) for q in HYB32.values()] == [4, 4, 4, 5],
            f"parity: the hybrid's regime primes {HYB32} take other plane counts")
    mxu32_cuda.TILE_LAUNCHES.clear()
    rule_k2h, k2h_picked, k2h_forced = mxu32_cuda.k2h_tiles, set(), 0
    for rname, p in HYB32.items():
        for n, b in HYB32_SHAPES:
            t1 = time.perf_counter()  # the host build: operators, block proof, digit planes
            stagesplit._dev32(n, p, N_H)
            hyb32_build.append(f"{n} {rname} {time.perf_counter() - t1:.1f} s")
            x = u32((b, n))
            s = scale32(n, p)
            kw = dict(n=n, p=p, n_h=N_H)
            what = f"p={p} ({rname}) n={n} B={b}"
            calls = {"fwd_hyb": lambda: mxu32_cuda.fwd_hyb(x, **kw),
                     "inv_hyb": lambda: mxu32_cuda.inv_hyb(x, scale=s, **kw)}
            want = {"fwd_hyb": calls["fwd_hyb"](), "inv_hyb": calls["inv_hyb"]()}
            compare("fwd_hyb", want["fwd_hyb"], mxu32_cuda.fwd_hyb_plain(x, **kw), what)
            compare("inv_hyb", want["inv_hyb"], mxu32_cuda.inv_hyb_plain(x, scale=s, **kw),
                    what + " scaled")
            compare("fwd_hyb", stagesplit.engine32_fused.fwd(x, n=n, p=p),
                    mxu32_cuda.fwd(x, n=n, p=p), what + " hybrid vs direct K2")
            compare("inv_hyb", stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s),
                    mxu32_cuda.inv(x, n=n, p=p, scale=s), what + " scaled hybrid vs direct K2")
            for d in ("fwd", "inv"):
                k2h_picked.add(rule_k2h(b, n, N_H, d, mxu32._n_dplanes32(p)))
            if (n, b) not in K2H_FORCED:
                continue
            try:
                for codes in ((t1, t2) for t1 in range(3) for t2 in range(4)
                              if t2 < 3 or mxu32._n_dplanes32(p) == 4):
                    mxu32_cuda.k2h_tiles = lambda *a, codes=codes, **k: codes
                    for name, call in calls.items():
                        compare(name, call(), want[name], what + f" tiles {codes} forced")
                        k2h_forced += 1
            finally:
                mxu32_cuda.k2h_tiles = rule_k2h
    ran = {k[1:3] for k in mxu32_cuda.TILE_LAUNCHES if k[0] in ("fwd_hyb", "inv_hyb")}
    every = {(t1, t2) for t1 in range(3) for t2 in range(4)}
    require(every <= ran and k2h_picked <= ran, f"parity: K2h tile codes "
            f"{sorted((every | k2h_picked) - ran)} never ran")
    print(f"parity: K2 with block tables (K2h) fwd {checks['fwd_hyb']}, inv {checks['inv_hyb']} "
          f"checks exact at (n, B) in {HYB32_SHAPES}, n_h={N_H}, p in {HYB32}: against the "
          f"plain versions, the whole 32-bit hybrid == direct K2; the rule's codes "
          f"{sorted(k2h_picked)}, and {k2h_forced} launches with every code pair forced at "
          f"{K2H_FORCED} == the rule's result; launches by (kernel, codes) "
          f"{dict(mxu32_cuda.TILE_LAUNCHES)}; in {time.perf_counter() - t0:.1f} s; host build "
          f"of the block tables: {', '.join(hyb32_build)}", flush=True)

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

    # K1e (the operand as int8 digit planes) == its plain version == K1b, its
    # codes from k1_tile and, at K1E_FORCED, every pair of codes forced; K5
    # fwd with four limbs
    t0 = time.perf_counter()
    mxu32_cuda.TILE_LAUNCHES.clear()
    rule_k1e, k1e_picked, k1e_forced = mxu32_cuda._k1e_tiles, set(), 0
    for n, b, c in K1E_SHAPES:
        pr = ((PRIMES if c <= 5 else NATIVE128_PRIMES) if n <= 1 << 15 else EXT)[:c]
        scs = tuple(scale32(n, p) for p in pr)
        x = u32((c, b, n))
        xd = mxu32_cuda.digit_planes32(x)
        got = mxu32_cuda.inv_multi_presplit(xd, pr, scs)
        what = f"n={n} B={b} C={c}"
        k1e_picked.add(rule_k1e(b, n, c))
        compare("inv_multi_presplit", got, mxu32_cuda.inv_multi_presplit_plain(xd, pr, scs), what)
        k1b = mxu32_cuda.inv_multi(x, pr, scs)
        compare("inv_multi_presplit", got, k1b, what + " vs K1b on the values")
        if (n, b, c) not in K1E_FORCED:
            continue
        try:
            for codes in ((t1, t2) for t1 in range(3) for t2 in range(4)):
                mxu32_cuda._k1e_tiles = lambda *a, codes=codes: codes
                compare("inv_multi_presplit", mxu32_cuda.inv_multi_presplit(xd, pr, scs), k1b,
                        what + f" tiles {codes} forced vs K1b")
                k1e_forced += 1
        finally:
            mxu32_cuda._k1e_tiles = rule_k1e
    ran = {k[1:] for k in mxu32_cuda.TILE_LAUNCHES if k[0] == "inv_multi_presplit"}
    every = {(t1, t2) for t1 in range(3) for t2 in range(4)}
    require(every <= ran and k1e_picked <= ran,
            f"parity: K1e tile codes {sorted((every | k1e_picked) - ran)} never ran")
    k1e_line = (f"K1e inv_multi_presplit {checks['inv_multi_presplit']} checks exact (== its "
                f"plain version == K1b) at (n, B, C) in {K1E_SHAPES}, the rule's codes "
                f"{sorted(k1e_picked)}, {k1e_forced} launches with every code pair forced at "
                f"{K1E_FORCED} == K1b")
    for rname, p in PRIMES64.items():
        for n, b in W464_SHAPES:
            x = tuple(u32((b, n)) for _ in range(4))
            compare_pair("fwd64_u128", mxu64_cuda.fwd(x, n=n, p=p),
                         mxu64_cuda.fwd_plain(x, n=n, p=p), f"p={p} n={n} B={b} 4 limbs")
    print(f"parity: {k1e_line}; K5 fwd with four limbs "
          f"{checks['fwd64_u128']} checks exact at (n, B) in {W464_SHAPES} x five regime primes, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3b. the parity gate: tools/gpu_parity.py's --quick rows in this
    # process (every dispatcher value at n in its QUICK_N, the dense fixture's
    # five plans at N = 2048), each kernel row against its plain version and
    # each plan row against the golden oracle
    t0 = time.perf_counter()
    gate_rows = gate().rows(quick=True)
    gate_lines = []
    passed, failed = gate().run_rows(gate().Ctx("cuda", True, args.seed), gate_rows,
                                     out=gate_lines.append)
    for line in gate_lines:
        if line.startswith("FAIL") or line.startswith("PASS fixture"):
            print(f"parity: gpu_parity {line}", flush=True)
    print(f"parity: tools/gpu_parity.py --quick: {passed} of {len(gate_rows)} rows PASS "
          f"({sum(r.kind == 'kernel' for r in gate_rows)} kernel rows against their plain "
          f"versions, the rest against the golden oracle or the dense fixture's digests) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(not failed, f"parity: gpu_parity rows failed: {failed[:8]}")

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
                and after["inv_multi"] - before["inv_multi"] == 1
                and after["lift_u64_from5"] - before["lift_u64_from5"] == 1,
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
    require(rule["fwd_wide_multi"] == 2 and rule["inv_multi"] == 1
            and rule["lift_u64_from5"] == 1,
            f"main: a numpy-input polymul on a default plan launched {rule}")
    require(isinstance(np_out, np.ndarray) and np.array_equal(
        np_out, limbs_to_np_u64(torch.stack([o.cpu() for o in outs[0]], dim=-1).numpy())),
        "main: numpy-input polymul differs from the planar one")
    print(f"main: device rule: Plan32 default device {plan.device!r}, numpy-input polymul "
          f"launched K1a x{rule['fwd_wide_multi']}, K1b x{rule['inv_multi']}, the lift "
          f"x{rule['lift_u64_from5']}", flush=True)

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
        d, e = (torch.from_numpy(np.stack(tbl[k])).to(dev) for k in ("d", "e"))
        sharded.append((geo, d, e, rng.integers(0, p, (B32, n_sh), dtype=np.uint32)))
    torch.cuda.synchronize()
    reset_counts()
    sh_out, twin_out = [], []
    for geo, d, e, x in sharded:
        before = counts()
        f = held_fwd(fm, host(x).to(dev), d, **geo)
        sh_out.append((f, held_inv(fm, f, e, **geo)))
        expect_delta(before, {"pass_matmod_multi": 4 * RANKS},
                     f"rank-local passes n={n_sh} p={geo['p']}")
        # the one-to-one twin of the JAX pass_matmod (K3 `pass_matmod`, which
        # no route takes): rank 0's four passes through its entry point on
        # contiguous operands == the local sections' channel grid on views
        c, c1, p = geo["n2"] // RANKS, geo["n1"] // RANKS, geo["p"]
        v = host(x).to(dev).reshape(B32, geo["n1"], geo["n2"])[:, :, :c]
        y = (u32((B32, geo["n2"], c1)), u32((B32, c1, geo["n2"])), u32((B32, geo["n1"], c)))
        before = counts()
        kw = dict(n=n_sh, p=p)
        twin_out.append((
            (mxu32_cuda.pass_matmod(v.transpose(1, 2).contiguous(), which="A",
                                    diag_slices=tuple(d[:, :c]), **kw),
             mxu32_cuda.pass_matmod(y[0].transpose(1, 2).contiguous(), which="F", **kw),
             mxu32_cuda.pass_matmod(y[1], which="G", diag_slices=tuple(e[:, :c1]), **kw),
             mxu32_cuda.pass_matmod(y[2].transpose(1, 2).contiguous(), which="Ainv",
                                    **kw).transpose(1, 2)),
            (fm.col_pass(v, rank_rows(d, 0, c), **kw), fm.row_pass(y[0], **kw),
             fm.row_pass_inv(y[1], rank_rows(e, 0, c1), **kw), fm.col_pass_inv(y[2], **kw))))
        expect_delta(before, {"pass_matmod": 4, "pass_matmod_multi": 4},
                     f"K3 pass_matmod against its channel grid n={n_sh} p={p}")
    torch.cuda.synchronize()
    launches_k3 = counts()
    for twin, grid in twin_out:
        for which, a, g in zip(("A", "F", "G", "Ainv"), twin, grid):
            require(torch.equal(a, g), f"main: K3 pass_matmod {which} differs from its channel "
                                       "grid (pass_matmod_multi) at the held rank 0's shape")
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
          f"ranks (K3's channel grid on views of the shards), for p in "
          f"{tuple(BENCH_PRIMES.values())} == CPU plain path, inv(fwd(x)) == n·x; rank 0's "
          f"four passes through K3 pass_matmod == the grid's; launches {nz(launches_k3)}",
          flush=True)

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
        d, e = (torch.from_numpy(np.stack(tbl[k])).to(dev) for k in ("d", "e"))
        sharded64.append((geo, d, e, rand_mod(rng, p, (B64, n_sh))))
    pair_of = lambda v: tuple(t.contiguous() for t in card(v).unbind(-1))
    torch.cuda.synchronize()
    reset_counts()
    sh64_out, twin64 = [], []
    for geo, d, e, x in sharded64:
        before = counts()
        f = held_fwd64(fm, pair_of(x), d, **geo)
        sh64_out.append((f, held_inv64(fm, f, e, **geo)))
        expect_delta(before, {"pass_matmod64_multi": 4 * RANKS},
                     f"rank-local 64-bit passes n={n_sh} p={geo['p']}")
        # K6 `pass_matmod64`, the JAX pass_matmod64's twin (no route takes
        # it): rank 0's four passes == the local sections' channel grid
        c, c1, p = geo["n2"] // RANKS, geo["n1"] // RANKS, geo["p"]
        v = tuple(a.reshape(B64, geo["n1"], geo["n2"])[:, :, :c] for a in pair_of(x))
        y = (mid_pair((B64, geo["n2"], c1), p), (u32((B64, c1, geo["n2"])),
                                                 u32((B64, c1, geo["n2"]))),
             mid_pair((B64, geo["n1"], c), p))
        tr = lambda pair: tuple(a.transpose(1, 2).contiguous() for a in pair)
        before = counts()
        kw = dict(n=n_sh, p=p)
        twin64.append((
            (mxu64_cuda.pass_matmod64(tr(v), which="A", diag_slices=tuple(d[:, :c]), **kw),
             mxu64_cuda.pass_matmod64(tr(y[0]), which="F", **kw),
             mxu64_cuda.pass_matmod64(y[1], which="G", diag_slices=tuple(e[:, :c1]), **kw),
             tuple(a.transpose(1, 2) for a in mxu64_cuda.pass_matmod64(tr(y[2]), which="Ainv",
                                                                        **kw))),
            (fm.col_pass64(v, rank_rows(d, 0, c), **kw), fm.row_pass64(y[0], **kw),
             fm.row_pass_inv64(y[1], rank_rows(e, 0, c1), **kw), fm.col_pass_inv64(y[2], **kw))))
        expect_delta(before, {"pass_matmod64": 4, "pass_matmod64_multi": 4},
                     f"K6 pass_matmod64 against its channel grid n={n_sh} p={p}")
    torch.cuda.synchronize()
    launches_k6 = counts()
    for twin, grid in twin64:
        for which, a, g in zip(("A", "F", "G", "Ainv"), twin, grid):
            require(all(torch.equal(s, t) for s, t in zip(a, g)),
                    f"main: K6 pass_matmod64 {which} differs from its channel grid "
                    "(pass_matmod64_multi) at the held rank 0's shape")
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
          f"R={RANKS} ranks (K6's channel grid on views of the shards), five primes == CPU "
          f"plain path, inv(fwd(x)) == n·x; rank 0's four passes through K6 pass_matmod64 == "
          f"the grid's; launches {nz(launches_k6)}", flush=True)

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
    expect_delta(before, {"fwd_wide_multi": 4, "inv_multi": 2, "lift_u64_from5": 2},
                 "Plan32 on the Plan52 inputs")
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

    def lift_launches(pl) -> dict:
        """The lift kernels' launches of one lift of a native plan."""
        if isinstance(pl, native64.Plan32):
            return {"lift_u64_from5": 1}
        if isinstance(pl, port.native128.Plan32):
            return {"lift_u128_digits": 1, "lift_u128_limbs": 1}
        return {}

    def native_counts(pl, binary):
        """Launches of one polymul, one fwd and one inv of a native plan at
        2^11 <= n <= 2^17 (native64.Plan32 lifts through its lift kernel,
        native128.Plan32 through its two)."""
        k, nl = len(pl.primes), pl.width // 32
        if pl.tier == "plan32":
            wide = "fwd_wide_multi_u128" if nl == 4 else "fwd_wide_multi"
            lift = lift_launches(pl)
            poly = {wide: 1, "inv_multi": 1, **lift}
            poly["fwd_wide_multi" if binary else wide] = poly.get(
                "fwd_wide_multi" if binary else wide, 0) + 1
            return poly, {wide: 1}, {"inv_multi": 1, **lift}
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
    launches["lift_u128_from10"] = launches_fam["lift_u128_digits"]  # launch pairs
    require(launches_fam["lift_u128_limbs"] == launches_fam["lift_u128_digits"],
            f"main: native128's lift kernels launched unpaired: {nz(launches_fam)}")
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
        expect_delta(before, {"butterfly32_fwd": 2 * k, "butterfly32_inv": k,
                              **lift_launches(pl)}, f"{name}({N_PERCH}) polymul")
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
    expect_delta(before, {"fwd_wide_multi_u128": 2, "inv_multi": 1, **lift_launches(pl128)},
                 "native128 py128 polymul")
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
    sh_wide, twin_wide = [], []
    for geo, d, e, _ in sharded:
        before = counts()
        sh_wide.append(held_fwd(fm, plan_arg(w_sh, dev), d, **geo))
        expect_delta(before, {"pass_matmod_multi_u128": RANKS, "pass_matmod_multi": RANKS},
                     f"rank-local fwd of a u128 operand n={n_sh} p={geo['p']}")
        # rank 0's A pass through K3 pass_matmod with the four limbs (the JAX
        # twin's entry point) == the local section's channel grid
        c = geo["n2"] // RANKS
        v = tuple(a.reshape(B32, geo["n1"], geo["n2"])[:, :, :c] for a in plan_arg(w_sh, dev))
        before = counts()
        twin_wide.append((
            mxu32_cuda.pass_matmod(tuple(a.transpose(1, 2).contiguous() for a in v), n=n_sh,
                                   p=geo["p"], which="A", diag_slices=tuple(d[:, :c]), n_limbs=4),
            fm.col_pass(v, rank_rows(d, 0, c), n=n_sh, p=geo["p"])))
        expect_delta(before, {"pass_matmod_u128": 1, "pass_matmod_multi_u128": 1},
                     f"K3 pass_matmod with four limbs against its channel grid p={geo['p']}")
    torch.cuda.synchronize()
    launches_wide = counts()
    require(all(torch.equal(a, g) for a, g in twin_wide),
            "main: K3 pass_matmod's A pass with four limbs differs from its channel grid")
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
          f"rank-local fwd at n={n_sh} (K3's channel-grid A pass with four limbs, R={RANKS}) == "
          f"the CPU transform of value mod p, rank 0's A pass through K3 pass_matmod == the "
          f"grid's; launches {nz(launches_wide)}", flush=True)

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
    d16 = torch.from_numpy(np.stack(tbl["d"])).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    before = counts()
    wide16_got = ntt_dispatch.try_fwd32_wide_all(plan_arg(w16, dev), wide16)
    expect_delta(before, {"fwd_u128": len(wide16)}, f"u128 operand through the K2 route at {N16}")
    before = counts()
    rl16 = held_fwd(fm, plan_arg(w16, dev), d16, **geo16)
    expect_delta(before, {"pass_matmod_multi_u128": RANKS, "pass_matmod_multi": RANKS},
                 f"rank-local fwd of a u128 operand n={N16}")
    c16 = tbl["n2"] // RANKS
    v16 = tuple(a.reshape(4, tbl["n1"], tbl["n2"])[:, :, :c16] for a in plan_arg(w16, dev))
    before = counts()
    twin16 = (mxu32_cuda.pass_matmod(tuple(a.transpose(1, 2).contiguous() for a in v16), n=N16,
                                     p=p_rl, which="A", diag_slices=tuple(d16[:, :c16]),
                                     n_limbs=4),
              fm.col_pass(v16, rank_rows(d16, 0, c16), n=N16, p=p_rl))
    expect_delta(before, {"pass_matmod_u128": 1, "pass_matmod_multi_u128": 1},
                 f"K3 pass_matmod with four limbs against its channel grid at {N16}")
    torch.cuda.synchronize()
    launches_w16 = counts()
    require(torch.equal(*twin16), f"main: K3 pass_matmod's A pass with four limbs at {N16} "
                                  "differs from its channel grid")
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
