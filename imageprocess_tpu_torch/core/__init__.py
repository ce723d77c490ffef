"""Host-side ROI input (dataset grammar comes from ``_host.naming``)."""
