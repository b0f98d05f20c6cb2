"""Chapter 4: CEP flow-breach alert over the chapter-3 telemetry feed.

FlinkCEP-style pattern job on the same ``<iso-datetime> <channel>
<flow>`` lines the bandwidth jobs consume: per channel, THREE
consecutive flow readings above a threshold within one minute raise one
alert carrying the channel, the summed flow, and the first/last breach
times. Partial runs (one or two breaches whose minute expires) route to
a timeout side output — the monitoring distinction between "sustained
overload" (alert) and "transient spike" (timeout).

PyTorch port of tpustream/jobs/chapter4_cep_alert.py: the pattern
compiles to a dense NFA (tpustream_torch/cep/nfa.py) and every channel's
register vector advances in one device step
(tpustream_torch/runtime/cep_program.py).
"""

from __future__ import annotations

from tpustream_torch import (
    BoundedOutOfOrdernessTimestampExtractor,
    CEP,
    OutputTag,
    Pattern,
    StreamExecutionEnvironment,
    Time,
    TimeCharacteristic,
    Tuple3,
    Tuple4,
)
from tpustream_torch.javacompat import LocalDateTime, Long, ZoneOffset

DEFAULT_THRESHOLD = 5000


class IsoTimestampExtractor(BoundedOutOfOrdernessTimestampExtractor):
    def extract_timestamp(self, element):
        time = LocalDateTime.parse(element.split(" ")[0]).toEpochSecond(
            ZoneOffset.ofHours(8)
        )
        return time * 1000


def parse(s: str) -> Tuple3:
    items = s.split(" ")
    time = LocalDateTime.parse(items[0]).toEpochSecond(ZoneOffset.ofHours(8))
    channel = items[1]
    flow = Long.parseLong(items[2])
    return Tuple3(time, channel, flow)


def make_pattern(threshold: int = DEFAULT_THRESHOLD,
                 within: Time = None) -> Pattern:
    within = within or Time.minutes(1)
    return (
        Pattern.begin("breach")
        .where(lambda r: r.f2 > threshold)
        .times(3)
        .consecutive()
        .within(within)
    )


def select_alert(match):
    first, mid, last = match["breach"]
    return Tuple4(
        first.f1,                       # channel
        first.f2 + mid.f2 + last.f2,    # total breach flow
        first.f0,                       # first breach epoch sec
        last.f0,                        # last breach epoch sec
    )


def build(env: StreamExecutionEnvironment, text,
          threshold: int = DEFAULT_THRESHOLD,
          within: Time = None, delay: Time = None,
          timeout_tag: OutputTag = None):
    delay = delay or Time.seconds(5)
    keyed = (
        text.assign_timestamps_and_watermarks(IsoTimestampExtractor(delay))
        .map(parse)
        .key_by(1)
    )
    return CEP.pattern(keyed, make_pattern(threshold, within)).select(
        select_alert, timeout_tag=timeout_tag
    )


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    timeout_tag = OutputTag("breach-timeout")
    alerts = build(env, env.from_collection([]), timeout_tag=timeout_tag)
    alerts.print()
    alerts.get_side_output(timeout_tag).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    text = env.socket_text_stream(host, port)
    timeout_tag = OutputTag("breach-timeout")
    alerts = build(env, text, timeout_tag=timeout_tag)
    alerts.print()
    alerts.get_side_output(timeout_tag).print()
    env.execute("CepFlowBreachAlert")


if __name__ == "__main__":
    main()
