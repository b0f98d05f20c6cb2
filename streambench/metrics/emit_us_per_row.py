"""Formatting and sinks (``Metrics.emit_times_s``) over the rows emitted
in the window, in microseconds a row."""


def read(run):
    rows = run.count["records_emitted"]
    return run.stage["emit_times_s"] / rows * 1e6 if rows else None
