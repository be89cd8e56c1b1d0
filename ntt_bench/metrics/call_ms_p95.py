"""call_ms_p95 (end to end, host clock): the 95th percentile of every call's
latency in the window, from its entry to the completion of its outputs."""

import statistics


def read(win):
    lat = win.latencies_ms
    if len(lat) < 2:
        return lat[0] if lat else None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
