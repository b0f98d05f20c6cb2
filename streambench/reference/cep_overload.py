"""Plain reference of the link-overload CEP alert: chapter 4's pattern
``begin("breach").where(bytes > threshold).times(3).consecutive()
.within(1 min)`` per channel, with its ``select_alert`` rows, written as
plain PyTorch on the CPU.

A match completes at an event if and only if that event and the
``times - 1`` events of its channel just before it, in arrival order,
all breach (``value > threshold_bytes``), and each later of those
events lies less than ``within_s`` seconds after the first. Matches
overlap: four breaches in a row give two rows, as FlinkCEP's default
no-skip strategy does. A row is ``(channel, sum of the events' values,
first epoch s, last epoch s)``, in stream order of the completing
events. Sums are exact in int64; ``sum_dtype`` computes them in another
dtype (``torch.int32`` wraps, ``torch.float32`` rounds) for the
configuration's precision control, the rows' types kept.

One departure from FlinkCEP, which sorts each key's events by event
time before matching: events are taken in arrival order per channel.
The traffic's jitter is below its sample interval, so a channel's
events arrive in event-time order and the two orders agree.
"""

from __future__ import annotations

import torch

from streambench.check import labels


def expected(events: dict, config: dict,
             sum_dtype: torch.dtype = torch.int64) -> list:
    """``[channel names (object array), summed bytes, first epoch s,
    last epoch s (int64 arrays)]``, the sums taken in ``sum_dtype``."""
    p = config["pattern"]
    n, within = int(p["times"]), int(p["within_s"])
    key = torch.from_numpy(events["key"])
    ts = torch.from_numpy(events["ts"])
    value = torch.from_numpy(events["value"])
    # each channel's events together, in arrival order within it
    order = torch.sort(key, stable=True).indices
    k, t, v = key[order], ts[order], value[order]
    breach = v > int(p["threshold_bytes"])
    # run i: the n events at sorted positions i .. i + n - 1
    m = max(k.numel() - (n - 1), 0)
    first = t[:m]
    hit = breach[:m].clone()
    total = v[:m].to(sum_dtype, copy=True)
    for j in range(1, n):
        at = slice(j, j + m)
        hit &= (k[at] == k[:m]) & breach[at] & (t[at] - first < within)
        total += v[at].to(sum_dtype)
    start = torch.nonzero(hit).flatten()
    end = start + (n - 1)
    by_stream = torch.sort(order[end]).indices  # completing events' order
    start, end = start[by_stream], end[by_stream]
    channel = labels(k[end].numpy(), lambda c: f"www.{c:07d}.com")
    total = total[start].to(torch.int64)
    return [channel, total.numpy(), t[start].numpy(), t[end].numpy()]
