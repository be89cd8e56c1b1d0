"""kernel_device_ms (kernels): device ms a call of the port's own kernels,
those ntt_bench/kernels/ lists. Nothing where a call launches none."""

from ntt_bench import trace


def read(win):
    prof = win.profile
    if prof is None:
        return None
    us = sum(e - s for s, e, name in prof.device if trace.is_port_kernel(name, win.kernels))
    return us / prof.calls / 1e3 if us > 0 else None
