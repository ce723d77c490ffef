"""Batched execution: the tile step and the host streaming protocol."""
