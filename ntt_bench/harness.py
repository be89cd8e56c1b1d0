"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

The loop is closed with one caller on one stream: call i + 1 is issued once
call i has completed on the device (an FHE evaluator's loop: each step needs
the one before it). A call's latency runs from its entry to the completion
of its outputs; its host span from its entry to its return. The window runs
calls until `seconds` have passed since the first one began; the calls that
started in it all finish and count.

What the calls produce is checked after the window: a sample of the calls,
drawn from the seed by reservoir sampling, and always the last call. The
entry holds the outputs of the sampled calls until the reference has read
them.
"""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import spec as spec_mod
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "concrete_ntt_tpu")


@dataclass
class Window:
    """What the readers see: the measured window, and the traced stretch."""

    setup_s: float
    window_s: float = 0.0
    calls: int = 0
    failed: int = 0
    products_per_call: int = 0
    floor_bytes: int = 0
    latencies_ms: list = field(default_factory=list)
    host_ms: list = field(default_factory=list)
    profile: trace_mod.Profile | None = None
    kernels: frozenset = frozenset()
    peaks: dict | None = None


def forbidden_modules() -> list:
    """Top-level module names of the JAX package or JAX in this process."""
    tops = {name.split(".")[0] for name in sys.modules}
    return sorted(tops.intersection(FORBIDDEN))


class Reservoir:
    """A uniform sample of `size` call records, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(seed), [], 0

    def offer(self, rec) -> None:
        if len(self.items) < self.size:
            self.items.append(rec)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = rec
        self.seen += 1


def card_info() -> dict:
    """The card's name and power limit from nvidia-smi, printed beside the
    data-sheet peaks (a card below 700 W runs slower under load)."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"]
    try:
        out = subprocess.run(query, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"not read ({type(exc).__name__})"
    return {"nvidia_smi": out.splitlines()[0] if out else "not read"}


def _sync(device: str):
    if device.startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def run_cell(spec: spec_mod.Spec, seed: int, seconds: float, traced: bool, device: str,
             t_process: float, patch=None) -> dict:
    """Set up the cell, measure, check; the result line as a dict.
    `patch(workload)` may put something else in the port's place (the
    control, the fault tests)."""
    t_start = time.perf_counter()
    entry = spec_mod.load_module("entries", spec.config["entry"])
    traffic = spec.traffic
    work = entry.Workload(spec.config, traffic, seed, device)
    t_built = time.perf_counter()
    if patch is not None:
        patch(work)
    sync = _sync(device)
    work.warm()
    sync()
    gc.collect()
    gc.freeze()  # what set-up made is never scanned again: no collection of it in the window

    win = Window(setup_s=0.0, products_per_call=work.products_per_call,
                 floor_bytes=work.floor_bytes)
    sample = Reservoir(int(traffic["check_calls"]), seed)
    last = None
    i = 0
    t_first = time.perf_counter()
    win.setup_s = t_first - t_process
    deadline = t_first + seconds
    t_done = t_first
    while i == 0 or t_done < deadline:
        t0 = time.perf_counter()
        try:
            rec = work.call(i)
            t1 = time.perf_counter()
            sync()
        except Exception:  # a call that raises is a failed call; the loop goes on
            traceback.print_exc()
            win.failed += 1
            rec = t1 = None
        t_done = time.perf_counter()
        if rec is not None:
            win.host_ms.append((t1 - t0) * 1e3)
            sample.offer(rec)
            last = rec
        win.latencies_ms.append((t_done - t0) * 1e3)
        i += 1
    win.calls = i
    win.window_s = t_done - t_first
    gc.unfreeze()
    print(f"window: {i} calls ({win.failed} failed) in {win.window_s:.3f} s after "
          f"{win.setup_s:.3f} s of set-up (imports {t_start - t_process:.3f} s, plan and inputs "
          f"{t_built - t_start:.3f} s, warm-up {t_first - t_built:.3f} s)", file=sys.stderr, flush=True)

    is_cuda = device.startswith("cuda")
    kind = torch.cuda.get_device_name(0) if is_cuda else "cpu"
    if traced:
        first = i
        win.profile = trace_mod.profile_calls(lambda k: work.call(first + k),
                                              int(traffic["trace_calls"]), sync)
        win.kernels = spec_mod.kernel_names()
        win.peaks = spec_mod.peaks(kind)
    memory_peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    records = list(sample.items)
    if last is not None and all(r is not last for r in records):
        records.append(last)
    work.release()
    del sample, last
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = work.check(records)
    print(f"check: {len(records)} calls, {verdict['compared']} coefficients compared in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)

    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        value = spec_mod.load_module("metrics", m["name"]).read(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": kind,
           "count": spec.chips if is_cuda else 0, "memory_peak_bytes": memory_peak}
    checks = {name: {"value": value, "limit": 0} for name, value in verdict["checks"].items()}
    checks["unchecked_calls"] = {"value": verdict["unchecked"], "limit": 0}
    checks["failed_calls"] = {"value": win.failed, "limit": 0}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": win.calls,
        "failed": win.failed,
        "metrics": metrics,
        "device": dev,
    }
    if is_cuda:
        result["card"] = {**card_info(), "peaks": spec_mod.peaks(kind)}
        print(f"card: {result['card']}", file=sys.stderr, flush=True)
    if win.profile is not None:
        dev["busy_s"] = trace_mod.busy_us(win.profile) / 1e6
        dev["window_s"] = (win.profile.span[1] - win.profile.span[0]) / 1e6
        result["breakdown"] = trace_mod.breakdown(win.profile)
    result["checks"] = checks
    return result
