"""The native decoder's rate: megapixels (stages x channels x H x W) of the
traced calls per loader-thread second of ``HostPhases``' ``ld_decode``,
summed over the prefetch threads."""


def read(rec):
    decode_s = (rec.get("phase_s") or {}).get("ld_decode")
    if not decode_s:
        return None
    return rec["pixels_per_unit"] * rec["calls"] / 1e6 / decode_s
