"""Chapter 2: per-host 1-minute median CPU usage (full-window process).

PyTorch port of reference chapter2/.../ComputeCpuMiddle.java:23-51:
parse -> Tuple2(host, usage) -> keyBy(0) -> 1-min tumbling window ->
ProcessWindowFunction buffering all elements, sorting, and emitting the
median: 0.0 when empty, the mean of the two middles when even (:41-47).
Elements buffer in device arrays; the sort and median run on the host
at the fire, exactly like the reference's deliberately non-incremental
path (chapter2/README.md:231).
"""

from __future__ import annotations

from tpustream_torch import (
    ProcessWindowFunction,
    StreamExecutionEnvironment,
    Time,
    Tuple2,
)
from tpustream_torch.javacompat import Double


def parse(value: str) -> Tuple2:
    items = value.split(" ")
    return Tuple2(items[1], Double.parseDouble(items[3]))


class MedianProcess(ProcessWindowFunction):
    def process(self, key, context, elements, out):
        values = sorted(t.f1 for t in elements)
        if not values:
            out.collect(0.0)
        elif len(values) % 2 != 0:
            out.collect(values[len(values) // 2])
        else:
            out.collect((values[len(values) // 2] + values[len(values) // 2 - 1]) / 2)


def build(env: StreamExecutionEnvironment, text):
    return (
        text.map(parse)
        .key_by(0)
        .time_window(Time.minutes(1))
        .process(MedianProcess())
    )


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    build(env, env.from_collection([])).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    text = env.socket_text_stream(host, port)
    build(env, text).print()
    env.execute("ComputeCpuMiddle")


if __name__ == "__main__":
    main()
