"""step_ms_p90 (ms): the 90th percentile (linear between order
statistics) of the host-clock latencies of every step of the window.
End-to-end."""

import statistics


def read(rec):
    lat = rec["latencies"]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]
