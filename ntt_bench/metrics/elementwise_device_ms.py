"""elementwise_device_ms (the plain-torch stages): device ms a call of the
operations that are not the port's own kernels (ntt_bench/kernels/):
the CRT lifts, REDC and Montgomery products, centring, accumulation,
copies."""

from ntt_bench import trace


def read(win):
    prof = win.profile
    if prof is None or not prof.device:
        return None
    us = sum(e - s for s, e, name in prof.device if not trace.is_port_kernel(name, win.kernels))
    return us / prof.calls / 1e3
