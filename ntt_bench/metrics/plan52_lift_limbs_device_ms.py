"""plan52_lift_limbs_device_ms (plain-torch stages): device ms a call inside
the port's `ntt.lift_limbs` spans, the limb arithmetic of native64 Plan52's
50-bit lift (`ops/crt.py::rec_from3_p50_u64`: v0 + v1·p0 + v2·(p0·p1) mod
2^64, the subtraction of P and the sign select), a child of `ntt.lift`. A
span's device ms runs from its entry to its exit on the call's stream, so
idle time inside it counts. Nothing where the port records no such spans."""

from ntt_bench import substages


def read(win):
    return substages.stage_ms(win, "lift_limbs")
