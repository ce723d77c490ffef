"""Share of the traced calls' wall spent making rows and writing the XLSX
and CSV: ``HostPhases``' ``emit`` + ``xls`` over the wall."""


def read(rec):
    ph = rec.get("phase_s") or {}
    if "emit" not in ph and "xls" not in ph:
        return None
    return 100.0 * (ph.get("emit", 0.0) + ph.get("xls", 0.0)) / rec["traced_s"]
