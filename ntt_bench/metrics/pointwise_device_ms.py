"""pointwise_device_ms (plain-torch stages): device ms a call inside the
port's `ntt.pointwise` spans, the NTT-domain products and adds
(`ntt_dispatch.pointwise_mont32`, prime64's `_pointwise` and the accumulate
add). A span's device ms runs from its entry to its exit on the call's
stream, so idle time inside it counts. Nothing where the port records no
spans."""

from ntt_bench import spans


def read(win):
    return spans.stage_ms(win, "pointwise")
