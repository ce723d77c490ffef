"""Traffic generators, found by the ``generator`` a traffic file names."""
