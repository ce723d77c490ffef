"""imageprocess_tpu_torch — the PyTorch / CUDA port of ``imageprocess_tpu``.

The JAX package stays the reference; this package mirrors its layout so a
reader finds each counterpart by path (``ops/tilestats_u16.py`` here ports
``imageprocess_tpu/ops/tilestats_u16.py``).  Plain tensor code is PyTorch;
each Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper (``kernels/``), built with ``nvcc`` at first use.

Ported so far: the batched, tables-only intensity path
(``pipelines.intensity.run_intensity_batched``) with the u16 tile-statistics
kernel.  The package never imports ``jax`` nor the ``imageprocess_tpu``
package; the jax-free host helpers it shares are loaded by file path
(``_host``).  Every entry point takes an explicit ``device``.
"""
