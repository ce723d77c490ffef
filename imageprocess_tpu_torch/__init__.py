"""imageprocess_tpu_torch — the PyTorch / CUDA port of ``imageprocess_tpu``.

The JAX package stays the reference; this package mirrors its layout so a
reader finds each counterpart by path (``ops/tilestats_u16.py`` here ports
``imageprocess_tpu/ops/tilestats_u16.py``).  Plain tensor code is PyTorch;
each Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper (``kernels/``), built with ``nvcc`` at first use.

Ported so far: every workload of the command line (``cli``, the console
script ``imageprocess-torch``): intensity and FRET tables, serial and
batched, with the two statistics kernels; Nesprin-2 rim FRET; morphology;
focal adhesions; the channel cropper; U-Net and threshold segmentation
(``segment.auto``); ROI refinement; the FRET timelapse deck; the TIFF and
PNG outputs; ``doctor`` (``utils.doctor``, a CUDA probe) and ``--xprof``
(``utils.profiling``, ``torch.profiler``).  Not yet: the figures that
matplotlib lays out, the interactive apps, training and several devices.
The package never imports ``jax`` nor the ``imageprocess_tpu`` package,
and runs none of its files: the host tier is its own (``native`` over
``native/tiff_lzw.cpp``, ``core.naming``, ``core.i18n``, ``geom.polygon``,
``report.xlsxlite``, ``morphology.contours``, ``models.synthcells``).  It
reads only the bundled checkpoints from ``imageprocess_tpu/models/
pretrained/``, as data.  Every entry point takes an explicit ``device``.
"""
