"""U-Net model and checkpoint loading (port of ``imageprocess_tpu.models``)."""
