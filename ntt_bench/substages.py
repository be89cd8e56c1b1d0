"""What the port's spans say about a stage that runs inside another stage.

`spans.stage_ms` counts a stage's outermost spans only, so that a stage
nested in a span of another stage is counted once, in the outer one. The
lift's own stages (`ntt.lift_digits`, `ntt.lift_limbs`, inside `ntt.lift`
in `ops/crt.py::rec_u128_from10`) are such children: here each span of the
stage counts unless a span of the same stage holds it. A checkout whose
port records no spans, or none of the stage, reads nothing (None).
"""

from __future__ import annotations

from ntt_bench import spans


def stage_ms(win, stage: str) -> float | None:
    """Device ms a call of the stage: the sum over the counted calls of its
    spans that no span of the same stage holds, over the calls."""
    found = spans.counted(win)
    if found is None:
        return None
    _, records = found
    by_index = {s["index"]: s for s in records}
    total, seen = 0.0, False
    for s in records:
        if s["stage"] != stage:
            continue
        parent = by_index.get(s["parent"])
        while parent is not None and parent["stage"] != stage:
            parent = by_index.get(parent["parent"])
        if parent is not None:
            continue
        if s["device_ms"] is None:
            return None
        total, seen = total + s["device_ms"], True
    return total / win.profile.calls if seen else None
