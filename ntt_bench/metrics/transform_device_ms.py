"""transform_device_ms (kernels): device ms a call inside the port's
`ntt.transform` spans, the forward and inverse NTTs, each kernel with its
wrapper's own torch operations (K1d and K7d, which fuse the pointwise
product into the inverse, count here). A span's device ms runs from its
entry to its exit on the call's stream, so idle time inside it counts.
Nothing where the port records no spans."""

from ntt_bench import spans


def read(win):
    return spans.stage_ms(win, "transform")
