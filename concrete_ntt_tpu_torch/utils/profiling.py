"""Profiling and roofline helpers.

Counterpart of `concrete_ntt_tpu/utils/profiling.py`, with the same names:

  * `trace(log_dir)`: a torch.profiler session (CPU, and CUDA where there is
    a card) that writes a Chrome trace into `log_dir` when it closes;
  * `chain_time(step, args)`: seconds a step with host dispatch removed, by
    the JAX package's chain-difference rule: a chain of `length` dependent
    steps minus a chain of one, best of `reps` interleaved pairs. On CUDA
    tensors both chains are captured as CUDA graphs (`capture`) and replayed
    in turns, timed by CUDA events, so what is left is the device's time,
    the gaps between the graph's kernels included. A step that cannot be
    captured (one that synchronises with the host or copies from pageable
    host memory) raises: timing it eagerly would measure the dispatch that
    the chain is meant to remove. On CPU tensors the chains run eagerly
    under `time.perf_counter`;
  * `Roofline` and `mxu_transform_roofline`: the JAX package's byte and
    int8 MAC counts of a four-step transform, against the H100's peaks;
  * `device_times(tasks)`: the device time of each of many calls in ONE
    torch.profiler session (a later session in the same process may return
    no device events), spin kernels marking each call's segment; for
    `chip_smoke.py`, `tools/gpu_parity.py --times` and the A/B tools;
  * `span(name, stage)`, `root_span`, `recorded_spans()`, `clear_spans()`:
    the plans' calls and their stages (`STAGES`) on the timeline of any
    torch.profiler session that is recording (`trace` among them), each
    with its device time and logical bytes, a top-level call with its
    kernel launches; nothing at all while no session records.

The peaks are NVIDIA's H100 SXM data-sheet figures (dense, at the 700 W
power limit), the one copy that `chip_smoke.py` and `benches/run_torch.py`
read.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: 80 GB of HBM at 3.35 TB/s
INT8_OPS_PER_S = 1979e12   # H100 SXM data sheet: 1,979 TOP/s int8, dense (2 ops a MAC)
CORE_OPS_PER_S = 67e12     # H100 SXM data sheet: 67 TFLOP/s outside the tensor cores


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler session over the block; on exit a Chrome trace
    (`*.pt.trace.json`, for TensorBoard or chrome://tracing) lands in
    `log_dir`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _check_carry(args: tuple, out, what: str) -> None:
    out = tuple(out)
    if len(out) != len(args) or any(o.shape != a.shape for o, a in zip(out, args)):
        raise ValueError(f"chain_time: {what} must map the carry to a tuple of the same shapes, "
                         f"got {[tuple(o.shape) for o in out]} for {[tuple(a.shape) for a in args]}")


def capture(step, args: tuple, length: int = 1):
    """(graph, outputs): `step` warmed up on a side stream (three calls:
    tables, libraries and kernel attributes come into being there), then
    `length` dependent steps from `args` captured into one CUDA graph. Each
    replay recomputes `outputs` from the current contents of `args`. A
    capture error is raised as a RuntimeError that names it."""
    args = tuple(args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            _check_carry(args, step(args), "step")
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    caller = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph):
            out = args
            for _ in range(length):
                out = tuple(step(out))
    except RuntimeError as exc:  # the capture stream may be left current
        torch.cuda.set_stream(caller)
        raise RuntimeError(
            f"chain_time: the step cannot be captured in a CUDA graph ({type(exc).__name__}: "
            f"{exc}); a step that synchronises with the host or copies from pageable host "
            "memory has no time with dispatch removed") from exc
    return graph, out


def chain_samples(step, args: tuple, *, length: int = 128, reps: int = 5) -> list:
    """`reps` interleaved (t_length, t_1) pairs in seconds: a chain of
    `length` dependent steps, then a chain of one (see the module doc for
    how each device runs them)."""
    args = tuple(args)
    if length < 2:
        raise ValueError(f"chain_time: length must be at least 2, got {length}")
    if args[0].device.type != "cuda":
        _check_carry(args, step(args), "step")  # warm-up

        def run(k):
            t0 = time.perf_counter()
            out = args
            for _ in range(k):
                out = step(out)
            return time.perf_counter() - t0

        return [(run(length), run(1)) for _ in range(reps)]
    graphs = [capture(step, args, k)[0] for k in (length, 1)]
    pairs = []
    for _ in range(reps):
        pair = []
        for graph in graphs:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            pair.append(start.elapsed_time(stop) / 1e3)
        pairs.append(tuple(pair))
    return pairs


def chain_time(step, args, *, length: int = 128, reps: int = 5) -> float:
    """Seconds a step, dispatch removed: (best t_length - best t_1) /
    (length - 1) over `reps` interleaved pairs (`chain_samples`). `step`
    maps a tuple of tensors to a tuple of the same shapes; each step's
    outputs are the next one's inputs. A non-positive difference raises."""
    pairs = chain_samples(step, args, length=length, reps=reps)
    best_k, best_1 = min(a for a, _ in pairs), min(b for _, b in pairs)
    if best_k <= best_1:
        raise RuntimeError(f"chain_time: non-monotone chain (t_{length} = {best_k:.6f} s <= "
                           f"t_1 = {best_1:.6f} s)")
    return (best_k - best_1) / (length - 1)


@dataclass
class Roofline:
    seconds: float
    hbm_bytes: int
    mxu_macs: int  # int8 multiply-accumulates (tensor cores on the card)

    @property
    def hbm_gbs(self) -> float:
        return self.hbm_bytes / self.seconds / 1e9

    @property
    def mxu_tops(self) -> float:
        return 2 * self.mxu_macs / self.seconds / 1e12

    @property
    def hbm_util(self) -> float:
        return self.hbm_bytes / self.seconds / HBM_BYTES_PER_S

    @property
    def mxu_util(self) -> float:
        return 2 * self.mxu_macs / self.seconds / INT8_OPS_PER_S

    @property
    def share(self) -> float:
        """The roofline share: the least time the card could take (bytes or
        int8 operations at peak, whichever is larger) over `seconds`."""
        return max(self.hbm_util, self.mxu_util)


def mxu_transform_roofline(n: int, batch: int, seconds: float,
                           n_eplanes: int = 4, n_dplanes: int = 4) -> Roofline:
    """Roofline for one four-step transform of [batch, n] u32 data.

    hbm_bytes counts the ideal fused traffic (operand in + result out);
    mxu_macs counts both digit-plane matmuls."""
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    n2 = n // n1
    # col pass: contraction E*n1, output D*n1 int32; row: 4*n2 planes
    macs = batch * n2 * (n_eplanes * n1) * (n_dplanes * n1)
    macs += batch * n1 * (4 * n2) * (n_dplanes * n2)
    data = batch * n * 4 * (n_eplanes // 4 + 1)
    return Roofline(seconds=seconds, hbm_bytes=data, mxu_macs=macs)


def device_times(tasks: list, reps: int = 20) -> dict:
    """Device time of a call, median of `reps` calls, for each task = (key,
    make, per_call) or (key, make, per_call, pick): make() -> (fn, match).
    All tasks run in ONE torch.profiler session; a spin kernel
    (torch.cuda._sleep) before and after each task's calls splits the device
    trace into their segments. A call's time is the sum of its kernels whose
    name matches (with `pick`, only its pick-th such kernel, in launch
    order), the calls being consecutive groups of per_call such kernels
    (None: as many as there are per call). A key whose segment does not
    split so, or a trace that lost its markers, maps to None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        matches = []
        for _, make, *_ in tasks:
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
    out = {task[0]: None for task in tasks}
    if len(segments) != len(tasks):
        print(f"profile: {len(segments)} marked segments for {len(tasks)} tasks: device times "
              "not measured", flush=True)
        return out
    for (key, _, per_call, *pick), match, seg in zip(tasks, matches, segments):
        us = [t for t, name in seg if match(name)]
        k = per_call or len(us) // reps
        if k and len(us) == k * reps:
            calls = [us[i * k:(i + 1) * k] for i in range(reps)]
            out[key] = statistics.median(c[pick[0]] if pick else sum(c) for c in calls) / 1e3
    return out


# ---------------------------------------------------------------------------
# Spans: the plans' stages on the profiler's timeline
# ---------------------------------------------------------------------------

#: the stage of every stage span, each named "ntt.<stage>": layout changes
#: between the caller's format and the limb planes; forward and inverse NTTs
#: (a kernel that fuses the pointwise product into its inverse included);
#: the NTT-domain products and adds; the CRT reconstruction
STAGES = ("marshal", "transform", "pointwise", "lift")
MAX_SPANS = 1 << 16  # records kept; the oldest go first

_records: deque = deque(maxlen=MAX_SPANS)
_counters: list = []  # the kernel modules' LAUNCHES dicts (`register_launches`)
_open = threading.local()  # .stack: the records of the spans open on this thread
_index = itertools.count()


def register_launches(counter: dict) -> None:
    """Add a kernel module's launch counter (name -> launches) to those a
    top-level span reads its `launches` from."""
    _counters.append(counter)


def _launches() -> int:
    return sum(sum(c.values()) for c in _counters)


def _nbytes(obj) -> int:
    """Bytes of the tensors and arrays in `obj` (nested lists and tuples
    walked), from their shapes and item sizes."""
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    size = getattr(obj, "nbytes", 0)
    return size if isinstance(size, int) else 0


class _Off:
    """The span while no profiler session records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def io(self, *tensors) -> None:
        pass


_OFF = _Off()


class _Span:
    """One span while a profiler session records (see `span`)."""

    __slots__ = ("rec", "fn", "start", "mark")

    def __init__(self, name: str, stage: str | None):
        self.rec = {"index": None, "name": name, "stage": stage, "parent": None, "root": None,
                    "nbytes": 0, "launches": None, "device_ms": None, "_events": None}

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = self.rec
        rec["index"] = index = next(_index)
        if stack:
            rec["parent"], rec["root"] = stack[-1]["index"], stack[-1]["root"]
            self.mark = None
        else:
            rec["root"] = index
            self.mark = _launches()
        self.fn = torch.profiler.record_function(rec["name"])
        self.fn.__enter__()
        self.start = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        _records.append(rec)
        stack.append(rec)
        return self

    def io(self, *tensors) -> None:
        """Count the logical bytes of the stage's inputs or outputs."""
        self.rec["nbytes"] += _nbytes(tensors)

    def __exit__(self, *exc):
        rec = self.rec
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec["_events"] = (self.start, end)
        self.fn.__exit__(*exc)
        _open.stack.pop()
        if self.mark is not None:
            rec["launches"] = _launches() - self.mark
        return None


def span(name: str, stage: str | None = None):
    """A context manager marking a stretch of the port's work.

    While no torch.profiler session records
    (`torch.autograd.profiler._is_profiler_enabled` false) it returns one
    shared object that does nothing: no allocation, no record, no CUDA call.

    While one records (the benchmark's traced run, `trace(log_dir)`), the
    span enters `torch.profiler.record_function(name)`, so it sits on the
    profiler's timeline as a host event; on a CUDA stream that is not
    capturing a graph it records a timing event at entry and one at exit
    (never a synchronise); and it appends a record to a buffer of the last
    `MAX_SPANS` spans: `index`, `name`, `stage` (one of `STAGES`, or None),
    the `parent`'s and the `root`'s index (the spans of one top-level call
    share its root), `nbytes` (what `io(*tensors)` counted: the logical
    bytes of the stage's inputs and outputs, from their shapes), and on a
    top-level span `launches`, the kernel launches made inside it (the
    change of the registered counters' sum). `recorded_spans` reads it.
    """
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, stage)


def root_span(method):
    """Wrap a plan's public method in a span `ntt.<module>.<method>`, a
    top-level span unless another span is open (a method one of the plan's
    own methods calls, a channel plan under a CRT plan)."""
    suffix = "." + method.__name__

    @functools.wraps(method)
    def spanned(self, *args, **kwargs):
        if not torch.autograd.profiler._is_profiler_enabled:
            return method(self, *args, **kwargs)
        with _Span("ntt." + type(self).__module__.rsplit(".", 1)[-1] + suffix, None):
            return method(self, *args, **kwargs)
    return spanned


def recorded_spans() -> list:
    """The buffer's records as dicts, oldest first, with `device_ms`: the
    time between the span's two events on the call's stream, which is its
    device operations plus any time the device sat idle inside the span
    waiting for the host (None where no event was recorded: CPU work, a
    graph capture, a span still open). Waits for each span's end event once."""
    out = []
    for rec in _records:
        events = rec["_events"]
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
            rec["_events"] = None
        out.append({k: v for k, v in rec.items() if k != "_events"})
    return out


def clear_spans() -> None:
    """Empty the buffer."""
    _records.clear()
