"""Crash-dump flight recorder: a bounded structured ring of runtime
events the executor can dump as JSON on failure or on demand.

Counterpart of tpustream/obs/flightrecorder.py (the port's own copy).

Flink answers "why did the job die" with REST-exposed exception history
and job-manager logs; this runtime's equivalent is a single in-memory
ring that every layer appends structured events to — config resolution,
program (re)builds, key-capacity growth, watermark jumps, source
stalls, health-rule transitions, and the terminal exception with the
operator that was active when it happened. The ring is bounded
(``ObsConfig.flight_ring_size``), so recording is O(1) per event and a
week-long job carries the same memory as a test run; events are
per-*incident*, never per record or per step.

``NULL_FLIGHT`` is the disabled twin (same surface, no state, no work),
installed whenever obs is off so call sites stay branch-free.

This module imports nothing beyond the stdlib — no jax, no
``tpustream_torch.runtime`` — so dumps are readable and writable anywhere
(including the ``tpustream_torch.obs.dump`` CLI host).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

FLIGHT_DUMP_VERSION = 1


class FlightRecorder:
    """Bounded ring of ``{"t_s", "seq", "kind", ...payload}`` events.

    ``t_s`` is seconds since the recorder was created (monotonic —
    ``perf_counter``-based, so NTP steps never reorder the timeline);
    ``seq`` is a global event sequence number that survives ring
    overwrite, so a dump always reveals how much history was lost.
    """

    enabled = True

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._ring: "deque" = deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self.total_events = 0
        # the operator whose step/dispatch most recently ran — the
        # "failing operator" context attached to exception events
        self.active_operator = ""

    def set_active(self, operator: str) -> None:
        self.active_operator = operator

    def record(self, kind: str, **payload) -> None:
        self.total_events += 1
        ev = {
            "t_s": round(time.perf_counter() - self._t0, 6),
            "seq": self.total_events,
            "kind": kind,
        }
        ev.update(payload)
        self._ring.append(ev)

    def record_exception(self, exc: BaseException, operator: str = "") -> None:
        self.record(
            "exception",
            error_type=type(exc).__name__,
            error=str(exc)[:2000],
            operator=operator or self.active_operator,
        )

    def events(self) -> list:
        return list(self._ring)

    def tenant_events(self, tenant: str) -> list:
        """Postmortem triage by tenant: the ring's events that name
        ``tenant`` — SLO ``health_transition``s carry it via their
        gauge labels, admission/retirement events (`tenant_obs_retired`,
        ``tenant_capacity_grown``) directly — so an on-call can ask
        "what happened to acme" without grepping the whole dump."""
        return [
            ev for ev in self._ring
            if ev.get("tenant") == tenant
            or (isinstance(ev.get("labels"), dict)
                and ev["labels"].get("tenant") == tenant)
        ]

    def dump(self, meta: Optional[dict] = None) -> dict:
        """JSON-serializable postmortem bundle."""
        events = self.events()
        return {
            "version": FLIGHT_DUMP_VERSION,
            "meta": dict(meta or {}),
            "active_operator": self.active_operator,
            "total_events": self.total_events,
            "dropped_events": max(0, self.total_events - len(events)),
            "events": events,
        }

    def write(self, path: str, meta: Optional[dict] = None) -> str:
        # default=repr: config payloads may carry callables (alert
        # sinks, user functions) — a postmortem wants their repr, not a
        # serialization failure
        with open(path, "w") as f:
            json.dump(self.dump(meta), f, indent=2, sort_keys=True,
                      default=repr)
            f.write("\n")
        return path


class _NullFlightRecorder:
    """Disabled twin: full surface, no state, no work."""

    enabled = False
    capacity = 0
    total_events = 0
    active_operator = ""

    __slots__ = ()

    def set_active(self, operator: str) -> None:
        pass

    def record(self, kind: str, **payload) -> None:
        pass

    def record_exception(self, exc, operator: str = "") -> None:
        pass

    def events(self) -> list:
        return []

    def tenant_events(self, tenant: str) -> list:
        return []

    def dump(self, meta: Optional[dict] = None) -> dict:
        return {
            "version": FLIGHT_DUMP_VERSION,
            "meta": dict(meta or {}),
            "active_operator": "",
            "total_events": 0,
            "dropped_events": 0,
            "events": [],
        }

    def write(self, path: str, meta: Optional[dict] = None) -> str:
        return path


NULL_FLIGHT = _NullFlightRecorder()


def jsonable_config(cfg) -> dict:
    """Best-effort JSON-friendly view of a (nested) config dataclass:
    dataclasses become dicts, everything non-primitive reprs. Used for
    the ``config_resolved`` flight event so a postmortem always carries
    the exact knobs the job ran with."""
    import dataclasses

    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {
                f.name: conv(getattr(v, f.name))
                for f in dataclasses.fields(v)
            }
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        return repr(v)

    return conv(cfg)
