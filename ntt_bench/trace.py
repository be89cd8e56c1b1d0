"""One torch.profiler session around a steady stretch of calls, and the
arithmetic the per-layer readers share.

The session follows the port's `utils/profiling.trace` / `device_times`
(copied, not imported: the program may change): CPU and CUDA activities, one
session a process. Each call runs inside `record_function("ntt_bench.call")`
and ends with a synchronise, so its span covers its device work. The first
profiled call is left out of every count (it pays the profiler's start).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

CALL = "ntt_bench.call"
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclass
class Profile:
    calls: int          # calls counted (the first profiled call left out)
    span: tuple         # (start_us, end_us) of the counted calls
    cpu: list           # (start_us, end_us, name) of the caller thread's host events
    device: list        # (start_us, end_us, name) of device operations in the span


def profile_calls(run_call, calls: int, sync) -> Profile:
    """Profile `calls` + 1 calls of run_call(k), k = 0 .. calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for k in range(calls + 1):
            with record_function(CALL):
                run_call(k)
                sync()
    cuda = torch.autograd.DeviceType.CUDA
    # a user annotation shows on the host and again on the device's timeline:
    # the host's marks the calls, and neither is a device operation
    events = [ev for ev in prof.events()
              if not (ev.device_type == cuda and (ev.name == CALL or _annotation(ev)))]
    marks = sorted((ev.time_range.start, ev.time_range.end, ev.thread) for ev in events
                   if ev.name == CALL and ev.device_type == torch.autograd.DeviceType.CPU)
    if len(marks) != calls + 1:
        kinds = sorted({(str(ev.device_type), ev.thread) for ev in prof.events() if ev.name == CALL})
        raise RuntimeError(f"profile: {len(marks)} call spans for {calls + 1} calls ({kinds})")
    start, end, thread = marks[1][0], marks[-1][1], marks[0][2]
    inside = lambda ev: start <= ev.time_range.start and ev.time_range.end <= end  # noqa: E731
    cpu = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in events
                 if ev.device_type != cuda and ev.thread == thread and inside(ev))
    device = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in events
                    if ev.device_type == cuda and inside(ev))
    return Profile(calls=calls, span=(start, end), cpu=cpu, device=device)


def _annotation(ev) -> bool:
    return bool(getattr(ev, "is_user_annotation", False))


def is_port_kernel(name: str, kernels) -> bool:
    """A device event of the port's own kernels: one of `kernels` is an
    identifier in its (demangled) name."""
    return not kernels.isdisjoint(_IDENT.findall(name))


def union(intervals) -> list:
    """Merged (start, end) intervals of a list of (start, end, ...)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(prof: Profile) -> float:
    return sum(e - s for s, e in union(prof.device))


def idle_gaps(prof: Profile) -> list:
    """(start_us, end_us) of the span's stretches with no device operation."""
    gaps, t = [], prof.span[0]
    for s, e in union(prof.device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if prof.span[1] > t:
        gaps.append((t, prof.span[1]))
    return gaps


def host_at(prof: Profile, times) -> list:
    """For each time (ascending), the innermost host event of the caller
    thread that covers it ("python" where none does)."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(prof.cpu) and prof.cpu[k][0] <= t:
            ev = prof.cpu[k]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def breakdown(prof: Profile, top: int = 10, width: int = 160) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, each [name, seconds] over the counted calls."""
    ops: dict = {}
    for s, e, name in prof.device:
        ops[name[:width]] = ops.get(name[:width], 0.0) + (e - s) / 1e6
    gaps = idle_gaps(prof)
    idle: dict = {}
    for (s, e), name in zip(gaps, host_at(prof, [(s + e) / 2 for s, e in gaps])):
        idle[name[:width]] = idle.get(name[:width], 0.0) + (e - s) / 1e6
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
