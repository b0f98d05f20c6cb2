"""Device-to-host fetch of emissions (``Metrics.fetch_times_s``) over
the window's steps, in milliseconds a step."""


def read(run):
    steps = run.count["steps"]
    return run.stage["fetch_times_s"] / steps * 1e3 if steps else None
