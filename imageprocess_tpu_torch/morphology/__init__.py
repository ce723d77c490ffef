"""Binary morphology and connected components on the device (port of ``imageprocess_tpu.morphology``)."""
