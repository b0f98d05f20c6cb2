"""Deterministic test harnesses (fault injection, poison inputs).

Importable without torch or the runtime — everything here is stdlib-only
so tests and bench phases can build injection schedules before any
device work starts.
"""

from .faults import (
    FAULT_POINTS,
    FaultInjected,
    FaultInjector,
    FaultPoint,
    poison_lines,
)

__all__ = [
    "FAULT_POINTS",
    "FaultInjected",
    "FaultInjector",
    "FaultPoint",
    "poison_lines",
]
