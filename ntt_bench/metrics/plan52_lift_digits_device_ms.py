"""plan52_lift_digits_device_ms (plain-torch stages): device ms a call inside
the port's `ntt.lift_digits` spans, the Garner digits of native64 Plan52's
50-bit lift (`ops/crt.py::rec_from3_p50_u64`: v1 mod p1, the partial sum,
v2 mod p2 and the sign), a child of `ntt.lift`. A span's device ms runs from
its entry to its exit on the call's stream, so idle time inside it counts.
Nothing where the port records no such spans."""

from ntt_bench import substages


def read(win):
    return substages.stage_ms(win, "lift_digits")
