"""Tabular report writers (stdlib csv + the shared XLSX writer)."""
