"""Host waits on a device-to-host copy (``Metrics.d2h_syncs``) over the
window's steps: an exact count."""


def read(run):
    steps = run.count["steps"]
    return run.count["d2h_syncs"] / steps if steps else None
