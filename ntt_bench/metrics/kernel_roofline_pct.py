"""kernel_roofline_pct (kernels): the call's logical-byte floor at the card's
data-sheet HBM bandwidth, over the summed device time of every operation the
call launched, the port's kernels and torch's alike. The floor (the entry's
`floor_bytes`) counts each input read once and each output written once at
the configured widths, no tables or intermediates: it reads the same work
whatever implements it. Nothing on a device without a peak in peaks.json."""


def read(win):
    prof = win.profile
    if prof is None or not prof.device or not win.peaks:
        return None
    seconds = sum(e - s for s, e, _ in prof.device) / prof.calls / 1e6
    return 100.0 * win.floor_bytes / win.peaks["hbm_bytes_per_s"] / seconds
