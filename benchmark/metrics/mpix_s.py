"""Megapixels of input (stages x channels x H x W) of every unit completed
in the window, per second of the window (from its start to the end of the
last call)."""


def read(rec):
    return rec["units_ok"] * rec["pixels_per_unit"] / rec["window_s"] / 1e6
