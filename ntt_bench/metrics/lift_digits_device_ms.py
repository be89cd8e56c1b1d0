"""lift_digits_device_ms (plain-torch stages): device ms a call inside the
port's `ntt.lift_digits` spans, the Garner digits of native128's u128 lift
(`ops/crt.py::rec_u128_from10`: the five pair digits, the outer Garner over
the pair moduli and the sign), a child of `ntt.lift`. A span's device ms
runs from its entry to its exit on the call's stream, so idle time inside
it counts. Nothing where the port records no such spans."""

from ntt_bench import substages


def read(win):
    return substages.stage_ms(win, "lift_digits")
