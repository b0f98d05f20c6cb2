"""The program's own build time: plan, host stage, program and state
allocation (``Metrics.build_time_s``)."""


def read(run):
    return run.build_time_s
