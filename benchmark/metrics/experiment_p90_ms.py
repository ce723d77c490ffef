"""The 90th percentile (linear interpolation, as numpy's default) of the
wall time of every unit the traced run's window started, failed ones too.
Nothing to read where the traffic gives its traced run no window.  The
mixes that list it hold 100 or more units a window."""

import statistics


def read(rec):
    lat = rec["latency_s"]
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3
