"""Host-side dataset grammar (``naming``), messages (``i18n``) and ROI
input (``roiio``)."""
