"""Chapter 3: channel bandwidth alert, processing time.

PyTorch port of reference chapter3/.../BandwidthMonitor.java:19-43:
explicit ProcessingTime, parse ``ts channel flow`` -> Tuple2(channel,
flow), keyBy(0), 1-min tumbling window (the commented sliding variant is
exposed via ``sliding=True``), reduce summing flow, filter channels whose
bandwidth ``flow*8/60/1024/1024 < 100`` Mbps. The reduce keeps f0 and
the printed value is the RAW summed flow (golden
``(www.163.com,11200)``, chapter3/README.md:80).
"""

from __future__ import annotations

from tpustream_torch import StreamExecutionEnvironment, Time, TimeCharacteristic, Tuple2
from tpustream_torch.javacompat import Long


def parse(s: str) -> Tuple2:
    items = s.split(" ")
    return Tuple2(items[1], Long.parseLong(items[2]))


def build(env: StreamExecutionEnvironment, text, sliding: bool = False):
    keyed = text.map(parse).key_by(0)
    if sliding:
        # chapter3/.../BandwidthMonitor.java:36 (commented variant)
        win = keyed.time_window(Time.minutes(1), Time.seconds(15))
    else:
        win = keyed.time_window(Time.minutes(1))
    return (
        win.reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1))
        .filter(lambda t: t.f1 * 8.0 / 60 / 1024 / 1024 < 100)
    )


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.ProcessingTime)
    build(env, env.from_collection([])).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_stream_time_characteristic(TimeCharacteristic.ProcessingTime)
    text = env.socket_text_stream(host, port)
    build(env, text).print()
    env.execute("BandwidthMonitor")


if __name__ == "__main__":
    main()
