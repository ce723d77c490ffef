"""The device step's share of its roofline: the least time the card could
take for the traced calls' statistics work (``work.tables_work``: ROI
pixels x channels x bytes read once, rows written once, or its float32
operations, whichever is longer at the card's peaks) over the union of
every device kernel's interval (copies excluded) in those calls.  It reads
the same work whatever kernels implement it."""

from .. import profiling, work


def read(rec):
    kernels, pk = rec.get("kernels"), rec.get("peak")
    if not kernels or not pk:
        return None
    calls = rec["calls"]
    least = work.least_seconds(rec["work"]["bytes"] * calls, rec["work"]["ops"] * calls, pk)
    return 100.0 * least / (profiling.union([(a, b) for _, a, b in kernels]) / 1e6)
