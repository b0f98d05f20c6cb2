"""tpustream_torch.cep — complex event processing over keyed streams.

Counterpart of tpustream/cep. FlinkCEP's surface (SASE+ NFA model):
patterns compile to a dense NFA table (nfa.py) and a device program
(runtime/cep_program.py) advances one NFA state vector per key in keyed
device state, every key of a batch at once, as torch ops.

    from tpustream_torch import CEP, Pattern, Time

    p = (Pattern.begin("breach").where(lambda r: r.f2 > 100.0)
         .times(3).consecutive().within(Time.seconds(60)))
    alerts = CEP.pattern(stream.key_by(1), p).select(make_alert,
                                                     timeout_tag=tag)

See docs/cep.md for the pattern API, lowering, state layout, and
recovery semantics.
"""

from __future__ import annotations

from typing import Optional, Union

from ..api.datastream import KeyedStream, SingleOutputStreamOperator
from ..api.graph import Node
from ..api.output import OutputTag
from ..api.timeapi import Time
from .nfa import CompiledPattern, compile_pattern
from .oracle import run_oracle
from .pattern import Pattern, PatternSelectFunction, make_select_adapter


class PatternStream:
    """A pattern applied to a keyed stream; terminal ``select`` wires the
    NFA operator into the job graph."""

    def __init__(self, stream: KeyedStream, pattern: Pattern):
        self._stream = stream
        self._pattern = pattern
        self._allowed_lateness_ms = 0
        self._late_tag: Optional[OutputTag] = None

    def allowed_lateness(self, t: Union[Time, int]) -> "PatternStream":
        """Accept events up to this much behind the watermark (they can
        still extend partials that have not yet timed out)."""
        self._allowed_lateness_ms = (
            t.to_milliseconds() if isinstance(t, Time) else int(t)
        )
        return self

    allowedLateness = allowed_lateness

    def side_output_late_data(self, tag: OutputTag) -> "PatternStream":
        self._late_tag = tag
        return self

    sideOutputLateData = side_output_late_data

    def select(
        self, fn=None, timeout_tag: Optional[OutputTag] = None
    ) -> SingleOutputStreamOperator:
        """Emit one record per full match. ``fn`` (callable or
        PatternSelectFunction) receives ``{stage_name: [events]}`` and
        runs as torch ops over whole columns; with ``fn=None`` matches
        emit as the flat concatenation of the matched events' fields.
        Partial matches that exceed ``within()`` route to
        ``timeout_tag`` (read with ``result.get_side_output(tag)``) as
        ``(n_matched, start_ts, ev0.f0, ev0.f1, ..)`` records, unmatched
        trailing fields padded with zeros / None."""
        node = Node(
            "cep",
            self._stream.node,
            {
                "pattern": self._pattern,
                "select_fn": fn,
                "timeout_tag": timeout_tag,
                "allowed_lateness_ms": self._allowed_lateness_ms,
                "late_tag": self._late_tag,
            },
        )
        return SingleOutputStreamOperator(self._stream.env, node)


class CEP:
    """Entry point mirroring ``org.apache.flink.cep.CEP``."""

    @staticmethod
    def pattern(stream: KeyedStream, pattern: Pattern) -> PatternStream:
        if not isinstance(stream, KeyedStream):
            raise TypeError(
                "CEP.pattern requires a keyed stream: call "
                ".key_by(...) before applying a pattern (NFA state is "
                "per key, like Flink's keyed CEP operator)"
            )
        return PatternStream(stream, pattern)


__all__ = [
    "CEP",
    "CompiledPattern",
    "Pattern",
    "PatternSelectFunction",
    "PatternStream",
    "compile_pattern",
    "make_select_adapter",
    "run_oracle",
]
