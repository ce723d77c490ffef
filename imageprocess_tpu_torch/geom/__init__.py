"""Polygon rasterization (plain PyTorch)."""
