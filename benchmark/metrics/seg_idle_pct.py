"""``idle_pct`` in the segmentation cells: share of the traced calls' wall
in which no kernel or copy ran on the device."""

from .idle_pct import read  # noqa: F401
