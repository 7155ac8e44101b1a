"""Seconds from the run's start (its first process) to the window's:
imports, CUDA start-up, loading the kernels (building them in a fresh
checkout), making the cell's clouds, and one warm registration."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
