"""Events the job took in during the timed window over the window's
seconds (host clock): all the work over all the time."""


def read(run):
    return run.events / run.window_s if run.window_s else None
