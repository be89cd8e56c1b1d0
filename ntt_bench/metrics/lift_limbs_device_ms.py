"""lift_limbs_device_ms (plain-torch stages): device ms a call inside the
port's `ntt.lift_limbs` spans, the limb arithmetic of native128's u128 lift
(`ops/crt.py::rec_u128_from10`: the four-limb multiply-accumulate of the
digits by the prefix products, the subtraction of P and the sign select), a
child of `ntt.lift`. A span's device ms runs from its entry to its exit on
the call's stream, so idle time inside it counts. Nothing where the port
records no such spans."""

from ntt_bench import substages


def read(win):
    return substages.stage_ms(win, "lift_limbs")
