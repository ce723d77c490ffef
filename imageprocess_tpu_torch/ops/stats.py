"""Per-ROI statistic names (port of ``imageprocess_tpu/ops/stats.py``).

``masked_stats`` comes with the serial intensity slice."""

STAT_FIELDS = ("mean", "median", "std", "p5", "p95", "vmin", "vmax", "vsum", "npx")
