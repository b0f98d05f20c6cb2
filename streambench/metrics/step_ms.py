"""Device step time (``Metrics.step_times_s``: host issue plus the
step's share of the wait for its counts) over the window's steps, in
milliseconds a step."""


def read(run):
    steps = run.count["steps"]
    return run.stage["step_times_s"] / steps * 1e3 if steps else None
