"""device_idle_pct (device): 100 minus the share of the profiled span in which
some operation ran on the device (the union of their intervals)."""

from ntt_bench import trace


def read(win):
    prof = win.profile
    if prof is None or not prof.device:
        return None
    span = prof.span[1] - prof.span[0]
    return 100.0 * (1.0 - trace.busy_us(prof) / span)
