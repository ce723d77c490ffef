"""Share of the traced calls' wall that no span of the runner's main
thread covers: the wall less every ``HostPhases`` phase but the loader
threads' ``ld_*``, over the wall.  The main thread's phases never overlap,
so their sum is the time they cover.  Nothing to read where the runner
has no phases."""


def read(rec):
    main = [s for name, s in (rec.get("phase_s") or {}).items() if not name.startswith("ld_")]
    if not main:
        return None
    return 100.0 * (rec["traced_s"] - sum(main)) / rec["traced_s"]
