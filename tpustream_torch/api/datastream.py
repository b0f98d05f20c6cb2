"""DataStream / KeyedStream / WindowedStream — the lazy operator API.

Reproduces the DataStream vocabulary the reference jobs call
(SURVEY.md §2.2 capability table): ``map``/``filter``
(chapter1/.../Main.java:18-33), ``key_by`` (chapter2/.../ComputeCpuMax.java:26),
rolling ``max`` (:26), ``time_window`` tumbling/sliding
(chapter2/.../ComputeCpuAvg.java:29,
chapter3/.../BandwidthMonitorWithEventTime.java:46), window
``reduce``/``aggregate``/``process``
(chapter3/.../BandwidthMonitor.java:37, chapter2/.../ComputeCpuAvg.java:31-59,
chapter2/.../ComputeCpuMiddle.java:34-49),
``assign_timestamps_and_watermarks``
(chapter3/.../BandwidthMonitorWithEventTime.java:30-35), allowed lateness +
late side outputs (chapter3/README.md:209-228), session windows
(chapter3/README.md:412-428), and the parallel ``print`` sink
(chapter1/README.md:80-84). camelCase aliases are provided so code written
against the Flink names reads identically.
"""

from __future__ import annotations

from typing import Any, Optional, Union

from .graph import Node
from .output import OutputTag
from .timeapi import Time
from .windows import WindowSpec, count_window_spec, time_window_spec


class DataStream:
    def __init__(self, env, node: Node):
        self.env = env
        self.node = node

    # -- stateless transforms ----------------------------------------------
    def map(self, fn) -> "DataStream":
        return DataStream(self.env, Node("map", self.node, {"fn": fn}))

    def filter(self, fn) -> "DataStream":
        return DataStream(self.env, Node("filter", self.node, {"fn": fn}))

    def flat_map(self, fn) -> "DataStream":
        return DataStream(self.env, Node("flat_map", self.node, {"fn": fn}))

    flatMap = flat_map

    # -- event time ---------------------------------------------------------
    def assign_timestamps_and_watermarks(self, assigner) -> "DataStream":
        return DataStream(
            self.env, Node("assign_ts", self.node, {"assigner": assigner})
        )

    assignTimestampsAndWatermarks = assign_timestamps_and_watermarks

    # -- partitioning --------------------------------------------------------
    def key_by(self, key: Union[int, Any]) -> "KeyedStream":
        return KeyedStream(self.env, Node("key_by", self.node, {"key": key}))

    keyBy = key_by

    # -- sinks ---------------------------------------------------------------
    def print(self) -> "DataStreamSink":
        node = Node("sink_print", self.node, {})
        self.env._register_sink(node)
        return DataStreamSink(self.env, node)

    def collect(self) -> "CollectHandle":
        """Test/deterministic sink: gather emitted records into a list."""
        node = Node("sink_collect", self.node, {})
        handle = CollectHandle()
        node.params["handle"] = handle
        self.env._register_sink(node)
        return handle

    def add_sink(self, sink_fn) -> "DataStreamSink":
        node = Node("sink_fn", self.node, {"fn": sink_fn})
        self.env._register_sink(node)
        return DataStreamSink(self.env, node)

    addSink = add_sink

    # -- broadcast state (dynamic rules) -------------------------------------
    def broadcast(self, rules, parse=None):
        """Turn THIS stream into the job's control stream (Flink's
        ``ruleStream.broadcast(descriptor)``): its records are
        :class:`~tpustream_torch.broadcast.RuleUpdate`s (or text lines parsed
        by ``parse``, default ``name value [after_records]``) applied to
        ``rules`` at exact record boundaries of the data stream. The
        stream must come straight from a source — control records never
        enter the data path. Registers the broadcast on the environment
        and returns the :class:`~tpustream_torch.broadcast.BroadcastStream`."""
        from ..broadcast import BroadcastStream

        if self.node.op != "source":
            raise NotImplementedError(
                "broadcast() applies to a raw source stream; transform "
                "rule records inside the parse fn instead"
            )
        bs = BroadcastStream(
            self.env, self.node.params["source"], rules, parse=parse
        )
        self.env._register_broadcast(bs)
        return bs


class SingleOutputStreamOperator(DataStream):
    """A window result stream; may expose late-data side outputs
    (chapter3/README.md:216-228)."""

    def get_side_output(self, tag: OutputTag) -> DataStream:
        return DataStream(
            self.env, Node("side_output", self.node, {"tag": tag})
        )

    getSideOutput = get_side_output


class KeyedStream(DataStream):
    # -- rolling aggregates (per-record emission, persistent keyed state) ---
    def _rolling(self, kind: str, pos: int) -> DataStream:
        return DataStream(
            self.env, Node("rolling", self.node, {"kind": kind, "pos": pos})
        )

    def max(self, pos: int) -> DataStream:
        """Rolling max with Flink semantics: emits on EVERY record and only
        the aggregated field updates; other fields keep first-seen values
        (golden transcript chapter2/README.md:52-66)."""
        return self._rolling("max", pos)

    def min(self, pos: int) -> DataStream:
        return self._rolling("min", pos)

    def sum(self, pos: int) -> DataStream:
        return self._rolling("sum", pos)

    def max_by(self, pos: int) -> DataStream:
        """Rolling max that keeps the WHOLE record of the maximum."""
        return self._rolling("max_by", pos)

    def min_by(self, pos: int) -> DataStream:
        return self._rolling("min_by", pos)

    maxBy = max_by
    minBy = min_by

    def reduce(self, fn) -> DataStream:
        """Rolling reduce over the keyed stream (emits per record)."""
        return DataStream(self.env, Node("rolling_reduce", self.node, {"fn": fn}))

    # -- windows -------------------------------------------------------------
    def time_window(self, size: Time, slide: Optional[Time] = None) -> "WindowedStream":
        spec = time_window_spec(self.env.time_characteristic, size, slide)
        return WindowedStream(
            self.env, Node("window", self.node, {"spec": spec})
        )

    timeWindow = time_window

    def count_window(self, count: int, slide: Optional[int] = None) -> "WindowedStream":
        return WindowedStream(
            self.env,
            Node("window", self.node, {"spec": count_window_spec(count, slide)}),
        )

    countWindow = count_window

    def window(self, spec: WindowSpec) -> "WindowedStream":
        return WindowedStream(self.env, Node("window", self.node, {"spec": spec}))


class WindowedStream:
    def __init__(self, env, node: Node):
        self.env = env
        self.node = node

    def allowed_lateness(self, t: Time) -> "WindowedStream":
        self.node.params["allowed_lateness_ms"] = t.to_milliseconds()
        return self

    allowedLateness = allowed_lateness

    def side_output_late_data(self, tag: OutputTag) -> "WindowedStream":
        self.node.params["late_tag"] = tag
        return self

    sideOutputLateData = side_output_late_data

    def _apply(self, kind: str, **params) -> SingleOutputStreamOperator:
        return SingleOutputStreamOperator(
            self.env, Node(f"window_{kind}", self.node, params)
        )

    def reduce(self, fn) -> SingleOutputStreamOperator:
        return self._apply("reduce", fn=fn)

    def aggregate(self, fn) -> SingleOutputStreamOperator:
        return self._apply("aggregate", fn=fn)

    def process(self, fn) -> SingleOutputStreamOperator:
        return self._apply("process", fn=fn)

    def sum(self, pos: int) -> SingleOutputStreamOperator:
        return self._apply("reduce", fn=_field_sum(pos))

    def max(self, pos: int) -> SingleOutputStreamOperator:
        return self._apply("reduce", fn=_field_extreme(pos, True))

    def min(self, pos: int) -> SingleOutputStreamOperator:
        return self._apply("reduce", fn=_field_extreme(pos, False))


def _field_sum(pos: int):
    def fn(a, b):
        vals = list(a)
        vals[pos] = a[pos] + b[pos]
        from .tuples import make_tuple

        return make_tuple(*vals)

    return fn


def _field_extreme(pos: int, is_max: bool):
    import torch

    def fn(a, b):
        vals = list(a)
        vals[pos] = torch.maximum(a[pos], b[pos]) if is_max else torch.minimum(a[pos], b[pos])
        from .tuples import make_tuple

        return make_tuple(*vals)

    return fn


class DataStreamSink:
    def __init__(self, env, node: Node):
        self.env = env
        self.node = node


class CollectHandle:
    """Holds records gathered by a collect() sink after execute()."""

    def __init__(self) -> None:
        self.items: list = []

    def append(self, item) -> None:
        self.items.append(item)
