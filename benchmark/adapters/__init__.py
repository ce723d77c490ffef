"""Adapters of the program's entries, found by the ``adapter`` a
configuration names."""
