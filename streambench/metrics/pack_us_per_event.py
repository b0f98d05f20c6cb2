"""Wire packing on the host (``Metrics.upload_times_s``) over the
window's events, in microseconds an event."""


def read(run):
    return run.stage["upload_times_s"] / run.events * 1e6 if run.events else None
