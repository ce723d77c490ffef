"""Plain NumPy references of the benchmark's configurations: they read the
files the benchmark generated and nothing that the program made."""
