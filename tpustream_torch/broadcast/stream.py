"""Broadcast/control streams: the API half of the dynamic-rules pattern.

Flink's broadcast-state idiom (``ruleStream.broadcast(descriptor)``)
connects a low-rate control stream to every parallel instance of the
operators it parameterizes. Here the control stream carries
:class:`RuleUpdate` records — "set rule R to V for every data record
from stream position N on" — and the executor applies them at exact
record boundaries: a data batch straddling an update position is SPLIT
there, so the update semantics are batch-size independent.

Replayable control sources are drained eagerly into a deterministic
schedule (what supervised restarts replay against); live sources drain
on a daemon thread and stamp each update at the position it was first
seen. ``RuleSet.version`` is the schedule cursor: a restored job skips
exactly the first ``version`` updates.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from .rules import RuleSet, RuleUpdate


def parse_control_line(item) -> Optional[RuleUpdate]:
    """Default control-record parser: ``name value [after_records]``.
    RuleUpdate objects pass through; blank lines and ``#`` comments are
    dropped (value coercion to the rule's declared kind happens in
    :meth:`RuleSet.apply`)."""
    if isinstance(item, RuleUpdate):
        return item
    if isinstance(item, bytes):
        item = item.decode("utf-8", "replace")
    s = str(item).strip()
    if not s or s.startswith("#"):
        return None
    parts = s.split()
    if len(parts) < 2:
        raise ValueError(
            f"control record {s!r}: want 'name value [after_records]'"
        )
    after = int(parts[2]) if len(parts) > 2 else 0
    return RuleUpdate(parts[0], parts[1], after)


class BroadcastStream:
    """A control stream bound to a :class:`RuleSet` — the result of
    ``DataStream.broadcast(rules)`` on the control stream. Registered on
    the environment; the runtime threads the rule pytree into every
    program of the job, so no explicit connect() wiring is needed."""

    def __init__(self, env, source, rules: RuleSet,
                 parse: Optional[Callable] = None):
        self.env = env
        self.source = source
        self.rules = rules
        self.parse = parse or parse_control_line

    def feed(self, batch_size: int = 256) -> "ControlFeed":
        return ControlFeed(
            self.rules, source=self.source, parse=self.parse,
            batch_size=batch_size,
        )

    # Flink-flavored camelCase alias
    getRuleSet = get_rule_set = lambda self: self.rules


class ControlFeed:
    """The executor-side view of a broadcast stream: an ordered,
    position-addressed update schedule with ``RuleSet.version`` as the
    applied-prefix cursor."""

    def __init__(self, rules: RuleSet, source=None,
                 parse: Optional[Callable] = None, batch_size: int = 256):
        self.rules = rules
        self._parse = parse or parse_control_line
        self._schedule: List[RuleUpdate] = []
        self._live_iter = None
        self._live_buf: List[RuleUpdate] = []
        self._live_lock = threading.Lock()
        self._live_thread = None
        if source is not None:
            if getattr(source, "replayable", False):
                for sb in source.batches(batch_size, 0.0):
                    for item in sb.lines:
                        u = self._parse(item)
                        if u is not None:
                            self._schedule.append(u)
                # stable by position: same-position updates apply in
                # control-stream arrival order
                self._schedule.sort(key=lambda u: u.after_records)
            else:
                self._live_iter = source.batches(batch_size, 50.0)
                self._live_thread = threading.Thread(
                    target=self._drain_live, daemon=True
                )
                self._live_thread.start()

    # ---- schedule construction ----------------------------------------
    def add(self, update: RuleUpdate) -> None:
        """Programmatic control record (tests, embedding hosts)."""
        self._schedule.append(update)
        self._schedule.sort(key=lambda u: u.after_records)

    def _drain_live(self):
        try:
            for sb in self._live_iter:
                parsed = []
                for item in sb.lines:
                    u = self._parse(item)
                    if u is not None:
                        parsed.append(u)
                if parsed:
                    with self._live_lock:
                        self._live_buf.extend(parsed)
                if sb.final:
                    break
        except Exception:  # pragma: no cover - a dead control socket
            pass           # must not take the data path down

    def absorb_live(self, consumed: int) -> None:
        """Move live-arrived updates into the schedule, stamped at the
        current stream position (never before an already-applied one)."""
        if self._live_thread is None:
            return
        with self._live_lock:
            fresh, self._live_buf = self._live_buf, []
        for u in fresh:
            self._schedule.append(
                RuleUpdate(
                    u.name, u.value, max(u.after_records, consumed),
                    tenant=u.tenant,
                )
            )
        if fresh:
            self._schedule.sort(key=lambda u: u.after_records)

    # ---- executor queries ----------------------------------------------
    def pending(self) -> List[RuleUpdate]:
        """Scheduled updates not yet applied (cursor = rules.version)."""
        return self._schedule[self.rules.version:]

    def splits_for(self, base: int, n: int) -> List[Tuple[int, List[RuleUpdate]]]:
        """Pending updates due inside a data batch covering absolute
        record positions [base, base+n): (offset, updates) groups in
        ascending offset order. An update positioned at or before
        ``base`` gets offset 0 (apply before the whole batch)."""
        self.absorb_live(base)
        due = [u for u in self.pending() if u.after_records < base + n]
        groups: dict = {}
        for u in due:
            groups.setdefault(max(0, u.after_records - base), []).append(u)
        return sorted(groups.items())

    def remaining(self, consumed: int) -> List[RuleUpdate]:
        """Updates still pending at end of stream (positions >= total
        records) — applied before the EOS flush so they govern final
        window fires deterministically."""
        self.absorb_live(consumed)
        return self.pending()
