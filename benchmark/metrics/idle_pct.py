"""Share of the traced calls' wall in which no kernel or copy ran on the
device: 1 - the union of their intervals over the wall."""


def read(rec):
    if not rec.get("kernels") and not rec.get("copies"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
