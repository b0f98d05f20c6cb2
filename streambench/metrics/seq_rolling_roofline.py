"""``kernels/seq_rolling.cu``'s share of its memory roofline: the bytes
the traced calls need at the card's peak bandwidth, over the kernel's
device time in the trace."""

from streambench.roofline import peak, seq_rolling_bytes


def read(run):
    t = run.tracer
    bw = peak(run.device_kind, "hbm_bytes_per_s")
    if t is None or bw is None:
        return None
    calls, secs = t.kernel("seq_rolling_kernel")
    blocks = list(run.window_blocks)
    if not calls or secs <= 0 or not blocks:
        return None
    # one call a step, a step a block: the traced calls are the window's
    per_call = [seq_rolling_bytes(run.traffic.batch_size,
                                  run.traffic.block_keys(i)) for i in blocks]
    nbytes = sum(per_call) / len(per_call) * calls
    return 100.0 * nbytes / bw / secs
