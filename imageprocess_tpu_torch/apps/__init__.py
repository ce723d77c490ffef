"""Interactive applications (port of ``imageprocess_tpu/apps``): the ROI
annotator (``draw``) and the focal-adhesion tuner (``fa_tune``).

Their core actions need no display and compute on ``device`` (default
``"cuda"``).  Only their display methods import matplotlib, inside the
method: without it, ``show()`` raises matplotlib's ``ImportError``.
"""
