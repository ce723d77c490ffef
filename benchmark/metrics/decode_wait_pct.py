"""Share of the traced calls' wall that the runner's main thread waited for
the prefetch loader (host decode and tiling): ``HostPhases``'
``load_wait`` over the wall.  Nothing to read where the runner has no
phases (the serial runner)."""


def read(rec):
    ph = rec.get("phase_s") or {}
    if "load_wait" not in ph:
        return None
    return 100.0 * ph["load_wait"] / rec["traced_s"]
