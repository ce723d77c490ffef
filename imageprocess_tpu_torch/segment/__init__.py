"""Cell segmentation: tiled U-Net inference, flow following, the auto drawer (port of ``imageprocess_tpu.segment``)."""
