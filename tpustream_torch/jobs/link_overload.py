"""Chapter 4's CEP alert as a link-overload monitor.

The deployment: a network operations centre streams one telemetry
sample per interface every 10 s (Telegraf's default agent ``interval``)
from about a million access ports, as the chapter-3 ``<iso-datetime>
<channel> <bytes>`` lines. Per interface, three consecutive samples
above the overload threshold within one minute raise one alert, so the
page is for sustained saturation and not for a one-sample spike.

The threshold is in the line's own unit: 90% of a 1 Gb/s port over one
10 s sample, ``OVERLOAD_BYTES`` = 1,125,000,000 bytes. Everything else
is chapter 4's job unchanged (``jobs/chapter4_cep_alert.py``): the
pattern ``begin("breach").where(f2 > threshold).times(3).consecutive()
.within(1 min)``, ``select_alert``'s ``Tuple4(channel, summed bytes,
first epoch s, last epoch s)`` and the 5 s out-of-orderness delay.

The module's name does not start with ``chapter``: the lint command's
default set is the tutorial's chapter jobs, each with its twin in the
JAX package, and this deployment has no twin there.
"""

from __future__ import annotations

from tpustream_torch.jobs import chapter4_cep_alert

# 0.9 x 1e9 bit/s x 10 s / 8 bits a byte
OVERLOAD_BYTES = 1_125_000_000


def build(env, text):
    return chapter4_cep_alert.build(env, text, threshold=OVERLOAD_BYTES)
