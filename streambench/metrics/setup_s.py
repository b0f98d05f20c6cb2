"""Seconds from the harness's first statement to the first timed block:
imports, CUDA init, kernel and parser loads, the traffic's rendering,
the job's build and the warm batches (host clock)."""


def read(run):
    return run.setup_s
