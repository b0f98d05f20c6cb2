"""Chapter 2: per-host 1-minute average CPU usage.

PyTorch port of reference chapter2/.../ComputeCpuAvg.java:16-61:
parse -> Tuple2(host, usage) -> keyBy(0) -> 1-min tumbling processing-time
window -> AggregateFunction((count, sum) accumulator -> mean) -> print.
The accumulator contract (create/add/get_result/merge) mirrors
chapter2/.../ComputeCpuAvg.java:31-59, including the division-by-zero
guard returning 0.0 (:47-50), written with ``torch.where`` in place of
a Java ternary: the runtime calls these functions once over whole
``[B]`` tensors of a batch, or of a fire's keys.
"""

from __future__ import annotations

import torch

from tpustream_torch import (
    AggregateFunction,
    StreamExecutionEnvironment,
    Time,
    Tuple2,
)
from tpustream_torch.javacompat import Double


def parse(value: str) -> Tuple2:
    items = value.split(" ")
    return Tuple2(items[1], Double.parseDouble(items[3]))


class AvgAggregate(AggregateFunction):
    def create_accumulator(self):
        return Tuple2(0, 0.0)

    def add(self, value, accumulator):
        accumulator.f0 = accumulator.f0 + 1
        accumulator.f1 = accumulator.f1 + value.f1
        return accumulator

    def get_result(self, accumulator):
        return torch.where(accumulator.f0 == 0, 0.0, accumulator.f1 / accumulator.f0)

    def merge(self, a, b):
        a.f0 = a.f0 + b.f0
        a.f1 = a.f1 + b.f1
        return a


def build(env: StreamExecutionEnvironment, text):
    return (
        text.map(parse)
        .key_by(0)
        .time_window(Time.minutes(1))
        .aggregate(AvgAggregate())
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
    env.execute("ComputeCpuAvg")


if __name__ == "__main__":
    main()
