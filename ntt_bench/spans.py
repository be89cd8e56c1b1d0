"""What the port's own spans and launch counter say about the traced calls.

The port records a span for each plan method a caller enters (a root,
`ntt.<module>.<method>`) and for each stage inside it (`ntt.marshal`,
`ntt.transform`, `ntt.pointwise`, `ntt.lift`), while a torch.profiler
session records: `concrete_ntt_tpu_torch.utils.profiling.recorded_spans()`.
A span's `device_ms` is the time between its two CUDA events on the call's
stream, its device work plus the device's idle time inside it; a root holds
its kernel `launches`.

The counted calls' roots are the last k roots of the buffer, k being the
number of outermost `ntt.` host events in the profile (which leaves out the
first profiled call, as every reader does). A checkout whose port records
no spans reads nothing: each function returns None.
"""

from __future__ import annotations

PREFIX = "ntt."


def _recorded() -> list | None:
    try:
        from concrete_ntt_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded_spans", None)
    return read() if read is not None else None


def _outermost_calls(cpu: list) -> int:
    """Host events named ntt.* that no other ntt.* event holds."""
    k, end = 0, None
    for start, stop, name in cpu:
        if name.startswith(PREFIX) and (end is None or start >= end):
            k, end = k + 1, stop
    return k


def counted(win) -> tuple | None:
    """(roots, spans): the counted calls' root records, and every record
    under them; None without a device profile or without spans."""
    prof = win.profile
    if prof is None or not prof.device or not prof.calls:
        return None
    k = _outermost_calls(prof.cpu)
    spans = _recorded() if k else None
    if not spans:
        return None
    roots = [s for s in spans if s["parent"] is None]
    if len(roots) < k:
        return None
    roots = roots[-k:]
    ids = {r["index"] for r in roots}
    return roots, [s for s in spans if s["root"] in ids]


def stage_ms(win, stage: str) -> float | None:
    """Device ms a call of the stage: the sum over the counted calls of its
    outermost stage spans (no stage span above them, so a stage nested in
    another is counted once, in the outer one), over the calls."""
    found = counted(win)
    if found is None:
        return None
    _, spans = found
    by_index = {s["index"]: s for s in spans}
    total = 0.0
    for s in spans:
        if s["stage"] != stage:
            continue
        parent = by_index.get(s["parent"])
        while parent is not None and parent["stage"] is None:
            parent = by_index.get(parent["parent"])
        if parent is not None:
            continue
        if s["device_ms"] is None:
            return None
        total += s["device_ms"]
    return total / win.profile.calls


def launches_per_call(win) -> float | None:
    """Kernel launches a call: the counted roots' `launches` over the calls."""
    found = counted(win)
    if found is None:
        return None
    roots, _ = found
    if any(r.get("launches") is None for r in roots):
        return None
    return sum(r["launches"] for r in roots) / win.profile.calls
