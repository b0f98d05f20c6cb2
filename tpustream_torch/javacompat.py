"""Java-flavored parsing shims so job code mirrors the reference closely.

The reference parses with ``Double.parseDouble(items[3])``
(chapter1/.../Main.java:23), ``Long.parseLong(items[2])``
(chapter3/.../BandwidthMonitor.java:29) and
``LocalDateTime.parse(items[0]).toEpochSecond(ZoneOffset.ofHours(8))``
(chapter3/.../BandwidthMonitorWithEventTime.java:33). These shims work on
real strings (per-record fallback path) AND on symbolic values (planning
path), letting one job definition drive both the vectorized host parser
and plain Python execution.
"""

from __future__ import annotations

import datetime as _dt

from .broadcast import (  # noqa: F401 — the broadcast-state surface
    # (ruleStream.broadcast(descriptor) in Flink) re-exported with its
    # camelCase accessors (RuleSet.getParam/getValue/getVersion,
    # BroadcastStream.getRuleSet) so chapter-style jobs read like the
    # original MapStateDescriptor idiom
    BroadcastStream,
    RuleDescriptor,
    RuleSet,
    RuleUpdate,
)
from .cep import CEP, Pattern, PatternSelectFunction  # noqa: F401 — the
# FlinkCEP surface re-exported with its Java camelCase methods
# (Pattern.begin(..).followedBy(..).within(..), PatternStream
# .sideOutputLateData) so chapter-style jobs read like the original
from .hostparse import PExpr, SymNum, SymStr
from .obs import MetricsServer, TenantSLO  # noqa: F401 — the fleet's
# observability surface (TenantSLO objectives, the live scrape endpoint)
from .tenancy import (  # noqa: F401 — the multi-tenant serving surface
    # (JobServer.addTenant/removeTenant/updateTenantRules camelCase
    # aliases) re-exported to match the CEP/broadcast convention
    JobServer,
    TenantPlan,
    TenantQuota,
)
from .utils.timeutil import iso_local_to_epoch_sec


class Double:
    @staticmethod
    def parseDouble(s):
        if isinstance(s, SymStr):
            return SymNum(PExpr("parse_f64", (s._expr,)))
        return float(s)

    parse_double = parseDouble


class Long:
    @staticmethod
    def parseLong(s):
        if isinstance(s, SymStr):
            return SymNum(PExpr("parse_i64", (s._expr,)))
        return int(s)

    parse_long = parseLong


class Integer:
    @staticmethod
    def parseInt(s):
        if isinstance(s, SymStr):
            return SymNum(PExpr("parse_i64", (s._expr,)))
        return int(s)

    parse_int = parseInt


class ZoneOffset:
    def __init__(self, hours: int):
        self.hours = hours

    @staticmethod
    def ofHours(hours: int) -> "ZoneOffset":
        return ZoneOffset(hours)

    of_hours = ofHours


class _SymLocalDateTime:
    def __init__(self, expr: PExpr):
        self._expr = expr

    def toEpochSecond(self, offset: ZoneOffset) -> SymNum:
        return SymNum(PExpr("parse_iso", (self._expr, offset.hours)))

    to_epoch_second = toEpochSecond


class _RealLocalDateTime:
    def __init__(self, s: str):
        self._s = s
        self._dt = _dt.datetime.fromisoformat(s)

    def toEpochSecond(self, offset: ZoneOffset) -> int:
        return iso_local_to_epoch_sec(self._s, offset.hours)

    to_epoch_second = toEpochSecond


class LocalDateTime:
    @staticmethod
    def parse(s):
        if isinstance(s, SymStr):
            return _SymLocalDateTime(s._expr)
        return _RealLocalDateTime(s)
