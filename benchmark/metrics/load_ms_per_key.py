"""Loader-thread milliseconds per key (stage) of the traced calls: every
``HostPhases`` ``ld_*`` phase (decode, backgrounds or FRET scalars, tile
gather, and ``ld_roi``, the rest of a key's load), summed over the
prefetch threads, over the keys those calls loaded."""


def read(rec):
    loads = [s for name, s in (rec.get("phase_s") or {}).items() if name.startswith("ld_")]
    if not loads:
        return None
    return 1000.0 * sum(loads) / (rec["keys_per_unit"] * rec["calls"])
