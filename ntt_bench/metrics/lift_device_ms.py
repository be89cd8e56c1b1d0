"""lift_device_ms (plain-torch stages): device ms a call inside the port's
`ntt.lift` spans, the CRT reconstruction (`NativePlanBase._lift`: the
widening to int64, the Garner lift, the narrowing to u32). A span's device
ms runs from its entry to its exit on the call's stream, so idle time
inside it counts. Nothing where the port records no spans."""

from ntt_bench import spans


def read(win):
    return spans.stage_ms(win, "lift")
