"""StallWatchdog: monotonic-deadline supervision for host-plane waits.

The ingest plane's lane heartbeats (runtime/ingest.py) catch a HUNG
WORKER — a child process that stops making progress. They cannot catch a
wedged PLANE: a producer stuck forever in a ring-credit wait, or a merge
wait that no reply will ever satisfy (heartbeat detection disabled, or a
reply lost in a way liveness checks miss). Those waits happen on the
executor's own threads, so the only remedy left is escalation: turn the
silent hang into a typed :class:`IngestStallError` the supervisor
(runtime/supervisor.py) can restart-with-cause, instead of blocking
``frames()`` — and therefore tier-1 — forever.

Design:

* one daemon thread per watchdog, started lazily on the first ``arm``
  and woken exactly at the earliest armed deadline (no polling between
  deadlines);
* all deadlines are ``time.monotonic()`` based — wall-clock steps (NTP,
  suspend/resume skew) never fire it spuriously;
* ``arm`` returns a token; ``poke`` pushes the deadline out (progress
  happened), ``disarm`` retires it (the guarded wait exited);
* an optional ``guard`` callable is consulted AT EXPIRY: returning
  False means "this silence is legitimate" (e.g. the producer is idle
  inside a paced source, not wedged) and the entry re-arms for another
  full limit instead of firing;
* ``on_fire(name, limit_s)`` runs on the watchdog thread with no locks
  held — implementations flag the stall and notify the stalled waiters,
  which then raise :class:`IngestStallError` on their own threads.

The watchdog never kills anything itself: it is a detector, and the
degradation ladder (lane restart -> fold-out -> inline) plus the
supervisor own the remedies.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class IngestStallError(RuntimeError):
    """The ingest plane stopped making progress past the watchdog limit.

    ``point`` feeds the supervisor's ``_failure_cause`` so restarts land
    in ``job_restarts_total{cause="ingest_stall"}`` — the postmortem
    distinguishes "the plane wedged" from a worker crash or a data
    fault without parsing the message.
    """

    point = "ingest_stall"

    def __init__(self, scope: str, limit_s: float):
        super().__init__(
            f"ingest plane stalled: no progress in {scope!r} "
            f"for {limit_s:g}s"
        )
        self.scope = scope
        self.limit_s = limit_s


class _Entry:
    __slots__ = ("name", "limit_s", "deadline", "guard")

    def __init__(self, name: str, limit_s: float, deadline: float, guard):
        self.name = name
        self.limit_s = limit_s
        self.deadline = deadline
        self.guard = guard


class StallWatchdog:
    """Deadline registry + the daemon thread that enforces it."""

    def __init__(
        self, on_fire: Callable[[str, float], None],
        name: str = "tpustream-watchdog",
    ):
        self._on_fire = on_fire
        self._name = name
        self._cv = threading.Condition()
        self._entries: Dict[int, _Entry] = {}
        self._next_token = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- arming ------------------------------------------------------------

    def arm(
        self, name: str, limit_s: float,
        guard: Optional[Callable[[], bool]] = None,
    ) -> int:
        """Register a deadline ``limit_s`` from now; returns a token.

        ``guard`` (optional) is called at expiry: False re-arms the
        entry for another full limit instead of firing (the silence is
        expected — e.g. an idle paced source, or downstream compute
        between generator pulls).
        """
        with self._cv:
            if self._closed or limit_s <= 0:
                return -1
            tok = self._next_token
            self._next_token += 1
            self._entries[tok] = _Entry(
                name, limit_s, time.monotonic() + limit_s, guard
            )
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
            return tok

    def poke(self, token: int) -> None:
        """Progress happened: push the token's deadline out a full limit."""
        with self._cv:
            e = self._entries.get(token)
            if e is not None:
                e.deadline = time.monotonic() + e.limit_s
                # no notify: the thread re-reads deadlines at each wake

    def disarm(self, token: int) -> None:
        with self._cv:
            self._entries.pop(token, None)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._entries.clear()
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    # -- enforcement -------------------------------------------------------

    def _run(self) -> None:
        while True:
            fire = None
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                soonest = None
                for tok, e in list(self._entries.items()):
                    if e.deadline <= now:
                        if e.guard is not None and not e.guard():
                            e.deadline = now + e.limit_s
                        else:
                            del self._entries[tok]
                            fire = (e.name, e.limit_s)
                            break
                    if soonest is None or e.deadline < soonest:
                        soonest = e.deadline
                if fire is None:
                    timeout = (
                        None if soonest is None
                        else max(0.01, soonest - now)
                    )
                    self._cv.wait(timeout)
            if fire is not None:
                # outside the lock: on_fire typically takes the plane's
                # own condition variable to flag the stall
                try:
                    self._on_fire(*fire)
                except Exception:
                    pass
