"""Report writers: tables (stdlib csv + the shared XLSX writer), the deck,
and the TIFF and PNG image outputs (PIL, no matplotlib)."""
