"""aten_ops_per_call (plan API, marshal and dispatch): torch.profiler's host
events named aten::* a call, nested ones included."""


def read(win):
    prof = win.profile
    if prof is None or not prof.calls:
        return None
    return sum(name.startswith("aten::") for _, _, name in prof.cpu) / prof.calls
