"""Numeric core: percentile positions, tile statistics and their kernel."""
