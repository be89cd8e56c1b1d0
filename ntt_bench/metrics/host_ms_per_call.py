"""host_ms_per_call (plan API, marshal and dispatch): the mean host-clock span
from entering a call to its return to the caller, before completion, over
the window's calls (outside the profiler session)."""

import statistics


def read(win):
    return statistics.fmean(win.host_ms) if win.host_ms else None
