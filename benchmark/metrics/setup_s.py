"""Seconds from the start of the process to the end of the warm-up call:
imports, the kernel libraries, the experiment, the warm-up."""


def read(rec):
    return rec["setup_s"]
