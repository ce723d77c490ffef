"""Share of the traced calls' wall that the segmentation path spent on the
host before a frame's forward could start: ``seg_read`` (the TIFF
decode), ``seg_prepass`` (histogram, bounds, cull) and ``seg_upload``
(upload, normalisation, tile cut), over the wall.  Nothing to read where
the program has no such phases."""

PHASES = ("seg_read", "seg_prepass", "seg_upload")


def read(rec):
    ph = rec.get("phase_s") or {}
    if not any(p in ph for p in PHASES):
        return None
    return 100.0 * sum(ph.get(p, 0.0) for p in PHASES) / rec["traced_s"]
