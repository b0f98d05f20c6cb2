"""Chapter 3 flagship: event-time sliding-window bandwidth alert.

PyTorch port of reference
chapter3/.../BandwidthMonitorWithEventTime.java:24-57:
EventTime characteristic; BoundedOutOfOrdernessTimestampExtractor(1 min)
parsing ISO-8601 local datetimes at UTC+8 BEFORE any other operator
(:29-35); map to Tuple3(epochSec, channel, flow) (:36-45); keyBy(1) —
the channel field (:45); sliding window (5 min, 5 s) (:46); reduce
summing f2 (:47); map to (channel, Mbps) with the reference's constant
``*8.0/60/1024/1024`` — it divides by 60 s even for the 5-minute window,
a reference quirk reproduced for output parity (:48-53); filter < 100.0
Mbps (:55).
"""

from __future__ import annotations

from tpustream_torch import (
    BoundedOutOfOrdernessTimestampExtractor,
    StreamExecutionEnvironment,
    Time,
    TimeCharacteristic,
    Tuple2,
    Tuple3,
)
from tpustream_torch.javacompat import LocalDateTime, Long, ZoneOffset


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


def build(env: StreamExecutionEnvironment, text,
          size: Time = None, slide: Time = None, delay: Time = None):
    size = size or Time.minutes(5)
    slide = slide or Time.seconds(5)
    delay = delay or Time.minutes(1)
    return (
        text.assign_timestamps_and_watermarks(IsoTimestampExtractor(delay))
        .map(parse)
        .key_by(1)
        .time_window(size, slide)
        .reduce(lambda a, b: Tuple3(a.f0, a.f1, a.f2 + b.f2))
        .map(lambda t: Tuple2(t.f1, t.f2 * 8.0 / 60 / 1024 / 1024))
        .filter(lambda t: t.f1 < 100.0)
    )


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    build(env, env.from_collection([])).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    text = env.socket_text_stream(host, port)
    build(env, text).print()
    env.execute("BandwidthMonitorWithEventTime")


if __name__ == "__main__":
    main()
