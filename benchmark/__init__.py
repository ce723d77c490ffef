"""The benchmark of ``imageprocess_tpu_torch``: ``python3 benchmark/run.py``."""
