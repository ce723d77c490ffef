"""Device kernel launches in the traced calls (copies and memsets left
out) per key (stage) those calls processed."""


def read(rec):
    kernels = rec.get("kernels")
    if not kernels:
        return None
    return len(kernels) / (rec["keys_per_unit"] * rec["calls"])
