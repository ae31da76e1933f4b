"""pose_ms_p95: the 95th percentile of the latencies of all requests
completed in the window, in ms (host clock, each from the request's start
to its pose on the host after the device's work has ended)."""

import statistics

UNIT = "ms"


def read(run):
    lat = [r.latency_s for r in run.records]
    if not lat:
        return None
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
