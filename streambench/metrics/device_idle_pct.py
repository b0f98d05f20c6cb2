"""Share of the traced window in which no operation ran on the device:
100 x (1 - the union of device intervals over the window), from
``torch.profiler``'s CUDA activity."""


def read(run):
    t = run.tracer
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
