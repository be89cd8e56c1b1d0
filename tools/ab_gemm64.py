#!/usr/bin/env python3
"""Time the kernels of the 64-bit GEMM pass (K5, K5h, K6, K7a-K7d, W4-64) of
the port checkout in the current directory on one GPU.

Rows and shapes are those of `chip_smoke.py`'s JSON line (`gemm64_rows`):
for each, the wrapper's CUDA-event median of 20 calls, and from one
torch.profiler session the device time of its `matmod64_pass` launches a
call and of `torch._int_mm` on int8 matrices of the same passes' shapes
(the mainloop's yardstick, which the port never calls), beside nvidia-smi's
card name and power limit. The row definitions and `median_ms` come from
`chip_smoke.py` of this script's own checkout; the package, kernels,
wrappers and `utils/profiling.device_times` from the current directory. So an A/B of two checkouts on one card
runs it from each in turns, in one call:

    for d in parent change change parent; do (cd $d && python3 /abs/tools/ab_gemm64.py); done

Prints one line a row, then the card line and a last JSON line
{"rows": {key: {"ms", "device_ms", "gemm_ms"}}, "port": <checkout>}. Exits
non-zero without a CUDA GPU. Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

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


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_gemm64: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch.ops import cuda_build

    for name in ("mxu64_pass", "mxu64_multi"):
        cuda_build.load(name)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(2024)
    u32 = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 1 << 32, shape, dtype=np.uint32)).to(dev)
    ms, tasks, labels = {}, [], {}
    for key, name, label, kernel, _, per_call, pairs in cs.gemm64_rows(dev, u32):
        ms[key], labels[key] = cs.median_ms(kernel), f"{name} {label}"
        tasks.append(((key, "device_ms"), lambda kernel=kernel: (kernel, cs.is_pass), per_call))

        def gemm(pairs=pairs):
            mats = pairs()
            return (lambda: [torch._int_mm(a, b) for a, b in mats]), cs.is_kernel

        tasks.append(((key, "gemm_ms"), gemm, None))
    prof = device_times(tasks)
    rows = {k: {"ms": t, "device_ms": prof[(k, "device_ms")], "gemm_ms": prof[(k, "gemm_ms")]}
            for k, t in ms.items()}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    for k, r in rows.items():
        print(f"ab_gemm64: {k} ({labels[k]}): wrapper {r['ms']:.4f} ms, device "
              f"{fmt(r['device_ms'])}, torch._int_mm {fmt(r['gemm_ms'])} (median of {cs.REPS}) "
              f"| {smi}", flush=True)
    print(smi)
    print(json.dumps({"rows": rows, "port": os.getcwd()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
