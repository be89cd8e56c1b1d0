"""marshal_device_ms (plan API, marshal and dispatch): device ms a call inside
the port's `ntt.marshal` spans, the layout changes between the caller's
format and the limb planes (`_marshal_in` / `_marshal_out`, prime64's
`_to_limbs` / `_from_limbs`). A span's device ms runs from its entry to its
exit on the call's stream, so idle time inside it counts. Nothing where the
port records no spans."""

from ntt_bench import spans


def read(win):
    return spans.stage_ms(win, "marshal")
