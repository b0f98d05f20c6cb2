"""Seeded fault injection for supervised-execution tests and bench.

The runtime exposes twelve control-plane fault points, checked on the
paths named after them:

* ``source_read``  — before each source batch enters the host stage
* ``parse``        — before the host parse of a batch (distinct from a
  data-plane parse error: an injected parse fault escalates to the
  supervisor, a malformed LINE is quarantined — see
  StreamConfig.dead_letter)
* ``device_step``  — before each jitted step dispatch
* ``cep_step``     — before each jitted step dispatch of a CEP (pattern
  matching) program only: targets crash recovery of mid-pattern NFA
  register state without also firing on the job's other operators
* ``exchange``     — before a sharded (n_shards > 1) step's keyBy
  all-to-all, on the last shard's thread while the others wait in it
  (the mesh aborts, so every shard fails: runtime/sharded.py)
* ``sink_emit``    — inside each sink emit attempt (so sink retry
  with backoff is exercised; see runtime/sinks.py RetryingSink)
* ``control_apply``— after a broadcast rule update lands on the
  device rule pytree, before the next data batch dispatches: targets
  the crash window between rule application and the batch it governs
  (the recovered run must re-apply the update at the same record
  boundary — byte-identical output; see tpustream_torch/broadcast)
* ``tenant_apply``  — same window, but only when the applied batch of
  updates contains a TENANT-scoped one (JobServer add_tenant /
  remove_tenant / update_tenant_rules land as tenant-scoped rule
  updates): targets crash recovery of the multi-tenant fleet mid
  admission or rule change (see tpustream_torch/tenancy)
* ``checkpoint_write`` — inside the snapshot writer, mid-chunk-write
  (after the first chunk lands, before the manifest): models the
  writer thread dying with orphan chunks on disk and no manifest —
  the ``latest`` marker still names the previous snapshot, recovery
  restores from it, and the next GC collects the orphans. In async
  mode the failure crosses back to the stepping thread at the next
  submit/flush with its ``point`` intact (runtime/checkpoint.py
  CheckpointPlane)
* ``checkpoint_gc`` — between the GC mark file landing and the unlink
  sweep: models a crash that leaves ``chunks/gc-mark.json`` plus the
  still-undeleted chunks; the next GC re-verifies the marked names
  against the live reference set and finishes the sweep

Two further points target the sharded ingest plane's LANE WORKER
PROCESSES (runtime/ingest.py lane supervision) and are evaluated inside
the worker, not by :meth:`FaultInjector.check`:

* ``lane_worker_crash`` — the worker holding frame ``at`` dies right
  before parsing it: ``os._exit(exit_code)`` for ``exit_code >= 0``
  (0 models the premature-clean-exit shape), or the signal
  ``-exit_code`` delivered to itself for negative values (``-9`` = a
  real SIGKILL, the OOM-killer shape)
* ``lane_worker_hang`` — the worker holding frame ``at`` stops dead
  (sleeps without stamping its heartbeat) until the plane kills it:
  exercises heartbeat stall detection and, with detection disabled,
  the StallWatchdog escalation path

For lane points ``at`` is the producer's global frame SEQUENCE number
(attempt-local) and ``times`` widens the window to ``[at, at+times)``;
``p`` is not supported (worker-side draws would not be deterministic
across respawns). The fire budget lives in shared memory on the
injector's FaultPoint, so a respawned worker — or a supervised restart
replaying the same sequence numbers — never re-triggers a spent fault.
Lane fires do not appear in ``FaultInjector.log`` (they happen in a
child process); assert on the plane's flight breadcrumbs instead.

An injector installs into ``StreamConfig.extra["fault_injector"]`` (use
:meth:`FaultInjector.install`); the executor reads it from there so the
runtime never imports this module. The injector OUTLIVES supervised
restart attempts — occurrence counters keep counting across rebuilds,
so a fault scheduled ``at`` occurrence k fires exactly once and the
replayed occurrences after the restart do not re-trigger it.

Determinism: ``at`` faults are positional; probabilistic faults draw
from one ``random.Random(seed)`` in occurrence order, so the same
schedule over the same stream yields the same fault sequence.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

FAULT_POINTS = (
    "source_read",
    "parse",
    "device_step",
    "cep_step",
    "exchange",
    "sink_emit",
    "control_apply",
    "tenant_apply",
    "checkpoint_write",
    "checkpoint_gc",
    "lane_worker_crash",
    "lane_worker_hang",
)

#: fault points evaluated INSIDE ingest lane worker processes, not by
#: FaultInjector.check — see the module docstring
LANE_FAULT_POINTS = ("lane_worker_crash", "lane_worker_hang")


class FaultInjected(RuntimeError):
    """Raised by FaultInjector.check at a scheduled fault point.

    ``fault_injection`` marks the exception so data-plane error handling
    (dead-letter quarantine, which catches parse exceptions) lets it
    escalate to the supervisor instead of swallowing it as a bad record.
    """

    fault_injection = True

    def __init__(self, point: str, occurrence: int):
        super().__init__(
            f"injected fault at {point} (occurrence {occurrence})"
        )
        self.point = point
        self.occurrence = occurrence


@dataclass
class FaultPoint:
    """One scheduled fault.

    ``at``: fire at this 0-based occurrence of ``point`` (positional,
    fully deterministic). ``p``: per-occurrence fire probability when
    ``at`` is None (seeded). ``times``: total fires before the point
    goes dormant (1 = fail once, then the restarted attempt sails
    through — the standard recovery-test shape). ``exit_code``: lane
    points only — how ``lane_worker_crash`` dies (>= 0: os._exit code,
    0 models premature clean exit; < 0: self-delivered signal, -9 = a
    real SIGKILL).
    """

    point: str
    at: Optional[int] = None
    p: float = 0.0
    times: int = 1
    exit_code: int = 1

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; one of {FAULT_POINTS}"
            )
        if self.point in LANE_FAULT_POINTS and self.at is None:
            raise ValueError(
                f"{self.point} needs a positional at= frame seq; p-based "
                "draws inside a lane worker would not be deterministic"
            )


class FaultInjector:
    """Evaluates a schedule of :class:`FaultPoint` s. One instance per
    job; thread-compatible with the parse-ahead thread (the executor
    sequences per-point checks from a single thread each)."""

    def __init__(self, *points: FaultPoint, seed: int = 0):
        self.points = list(points)
        self.seed = seed
        self._rng = random.Random(seed)
        self._occurrences = {}      # point name -> occurrences seen
        self._fires = [0] * len(self.points)
        self.log: List[Tuple[str, int]] = []  # (point, occurrence) fired

    @property
    def fired(self) -> int:
        return len(self.log)

    def occurrences(self, point: str) -> int:
        return self._occurrences.get(point, 0)

    def check(self, point: str) -> None:
        """Count one occurrence of ``point``; raise FaultInjected if a
        scheduled fault is due."""
        occ = self._occurrences.get(point, 0)
        self._occurrences[point] = occ + 1
        for i, fp in enumerate(self.points):
            if fp.point != point or self._fires[i] >= fp.times:
                continue
            if fp.at is not None:
                hit = occ == fp.at or (
                    fp.times > 1 and fp.at <= occ < fp.at + fp.times
                )
            else:
                # one draw per live probabilistic point per occurrence,
                # in schedule order — deterministic under a fixed seed
                hit = fp.p > 0.0 and self._rng.random() < fp.p
            if hit:
                self._fires[i] += 1
                self.log.append((point, occ))
                raise FaultInjected(point, occ)

    def wrap_source(self, batches):
        """Wrap a source-batch iterator: one ``source_read`` occurrence
        per batch, checked before the batch is handed to the host
        stage."""
        for sb in batches:
            self.check("source_read")
            yield sb

    def install(self, cfg):
        """Return ``cfg`` with this injector installed in
        ``extra["fault_injector"]`` (where the executor looks)."""
        extra = dict(cfg.extra)
        extra["fault_injector"] = self
        return cfg.replace(extra=extra)


def poison_lines(
    lines: List[str],
    count: int = 1,
    seed: int = 0,
    poison: str = "!!poison not-a-record!!",
) -> Tuple[List[str], int]:
    """Insert ``count`` malformed lines at seeded positions. The default
    payload fails every chapter parser (too few fields for the index
    access, non-numeric where a number is parsed). Returns
    ``(new_lines, count)``."""
    out = list(lines)
    rng = random.Random(seed)
    for _ in range(count):
        out.insert(rng.randrange(len(out) + 1), poison)
    return out, count
