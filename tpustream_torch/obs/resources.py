"""Resource plane: host/process/lane telemetry from ``/proc``, and the
environment fingerprint every snapshot and bench record carries.

Counterpart of tpustream/obs/resources.py; the environment
fingerprint asks torch for the job's device.

The rest of the obs stack watches the *stream* — records, watermarks,
device steps. This module watches the *host* the stream runs on, which
is the resource the ingest plane is actually bottlenecked on: on a
host with one usable core, more parse lanes mean fewer lines a second,
and nothing else in the system could say so. Two exports fix that:

* :class:`ResourceSampler` — registered as a ``Snapshotter`` pre-hook,
  so resource series advance at exactly the snapshot cadence. It reads
  ``/proc`` directly (stdlib only, no psutil): system-wide CPU util
  deltas from ``/proc/stat``, this process's RSS and context switches
  from ``/proc/self/statm|status``, and — once the ingest plane hands
  over its worker PIDs via :meth:`ResourceSampler.attach_lanes` —
  per-lane CPU time and last-seen core from ``/proc/<pid>/stat``.
  A contention detector turns that pathology into a self-diagnosed
  alert: two live lanes observed on the same core, or a multi-lane
  plane whose summed CPU time is pinned at ~1 core, increments
  ``lane_core_contention_total`` and drops a ``lane_core_contention``
  flight breadcrumb (the executor installs a built-in WARN health rule
  over the counter).

* :class:`EnvFingerprint` — usable cores (``sched_getaffinity`` ∩
  cgroup v1/v2 cpu quota), NUMA node count, the job's device backend,
  kind and count (``cuda`` with the card's name and the visible card
  count, or ``cpu``), and a hostname hash. Embedded in every obs snapshot's
  meta, served at ``/env.json``, stamped into checkpoint flight
  events, and written into the schema-versioned BENCH record header so
  ``bench.py --compare`` can refuse cross-environment claims.

Everything takes injectable ``proc_root``/``sys_root``/clock arguments
so tests run against canned fixture trees instead of the live host; on
a platform without ``/proc`` the sampler degrades to no-op samples.
"""

from __future__ import annotations

import hashlib
import math
import os
import socket
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "ENV_FINGERPRINT_SCHEMA",
    "EnvFingerprint",
    "ResourceSampler",
    "affinity_cores",
    "cgroup_quota_cores",
    "collect_env_fingerprint",
    "usable_cores",
]

ENV_FINGERPRINT_SCHEMA = 1

# summed lane utilisation inside this band (with >= 2 live lanes) reads
# as "the whole plane is squeezed through one core"
_PINNED_BAND = (0.55, 1.15)
# a lane below this utilisation is idle; idle lanes parked on the same
# core by the scheduler are not contention
_LANE_BUSY_MIN = 0.10


def _read_text(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            return f.read()
    except OSError:
        return None


def affinity_cores() -> int:
    """Cores this process may be scheduled on (``sched_getaffinity``),
    falling back to ``os.cpu_count()`` where affinity is unsupported."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def cgroup_quota_cores(sys_root: str = "/sys/fs/cgroup") -> Optional[float]:
    """CPU quota in cores from the cgroup controller, or None when
    unlimited/unreadable. Checks v2 (``cpu.max``) then v1
    (``cpu/cpu.cfs_quota_us`` / ``cpu.cfs_period_us``)."""
    raw = _read_text(os.path.join(sys_root, "cpu.max"))
    if raw is not None:
        parts = raw.split()
        if parts and parts[0] != "max":
            try:
                quota = float(parts[0])
                period = float(parts[1]) if len(parts) > 1 else 100000.0
                if quota > 0 and period > 0:
                    return quota / period
            except ValueError:
                pass
    quota_raw = _read_text(os.path.join(sys_root, "cpu", "cpu.cfs_quota_us"))
    period_raw = _read_text(os.path.join(sys_root, "cpu", "cpu.cfs_period_us"))
    if quota_raw is not None and period_raw is not None:
        try:
            quota = float(quota_raw.strip())
            period = float(period_raw.strip())
            if quota > 0 and period > 0:
                return quota / period
        except ValueError:
            pass
    return None


def usable_cores(sys_root: str = "/sys/fs/cgroup") -> int:
    """Cores this process can actually burn: scheduler affinity capped
    by the cgroup cpu quota (ceil'd — a 1.5-core quota can still run 2
    lanes at reduced duty), floor 1. This is the number TSM016 checks
    ``ingest_lanes`` against and the one the env fingerprint records —
    a 96-core box with a 2-core container quota is a 2-core host."""
    cores = affinity_cores()
    quota = cgroup_quota_cores(sys_root)
    if quota is not None:
        cores = min(cores, max(1, math.ceil(quota)))
    return max(1, cores)


def _numa_nodes(node_root: str = "/sys/devices/system/node") -> int:
    try:
        names = os.listdir(node_root)
    except OSError:
        return 1
    count = 0
    for name in names:
        if name.startswith("node") and name[4:].isdigit():
            count += 1
    return count or 1


@dataclass(frozen=True)
class EnvFingerprint:
    """What the host looked like when a run happened — the minimum set
    of facts needed to decide whether two perf numbers are comparable."""

    schema: int
    usable_cores: int
    affinity_cores: int
    cgroup_quota_cores: Optional[float]
    numa_nodes: int
    backend: str        # "cuda" or "cpu": where the job's device program runs
    device_kind: str
    device_count: int
    host: str           # sha256(hostname)[:12] — identity without leaking it

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "usable_cores": self.usable_cores,
            "affinity_cores": self.affinity_cores,
            "cgroup_quota_cores": self.cgroup_quota_cores,
            "numa_nodes": self.numa_nodes,
            "backend": self.backend,
            "device_kind": self.device_kind,
            "device_count": self.device_count,
            "host": self.host,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EnvFingerprint":
        return cls(
            schema=int(d.get("schema", 0)),
            usable_cores=int(d.get("usable_cores", 0)),
            affinity_cores=int(d.get("affinity_cores", 0)),
            cgroup_quota_cores=d.get("cgroup_quota_cores"),
            numa_nodes=int(d.get("numa_nodes", 1)),
            backend=str(d.get("backend", "unknown")),
            device_kind=str(d.get("device_kind", "unknown")),
            device_count=int(d.get("device_count", 0)),
            host=str(d.get("host", "")),
        )

    def compact(self) -> str:
        """One-token form for flight breadcrumbs and log lines."""
        return f"{self.backend}/{self.device_kind}x{self.device_count}" \
               f"@{self.usable_cores}c/{self.host or '?'}"

    def comparability(self, other: "EnvFingerprint") -> list:
        """Reasons two fingerprints are NOT perf-comparable (empty list
        means comparable). Usable-core count and backend are the axes
        that make two runs' numbers incomparable; host identity and
        device kind get a say too, NUMA/affinity do not (quota already
        folded in)."""
        reasons = []
        if self.usable_cores != other.usable_cores:
            reasons.append(
                f"usable cores differ: {self.usable_cores} vs "
                f"{other.usable_cores}"
            )
        if self.backend != other.backend:
            reasons.append(
                f"device backend differs: {self.backend} vs {other.backend}"
            )
        if self.device_kind != other.device_kind:
            reasons.append(
                f"device kind differs: {self.device_kind} vs "
                f"{other.device_kind}"
            )
        if self.device_count != other.device_count:
            reasons.append(
                f"device count differs: {self.device_count} vs "
                f"{other.device_count}"
            )
        return reasons


def collect_env_fingerprint(
    sys_root: str = "/sys/fs/cgroup",
    node_root: str = "/sys/devices/system/node",
    hostname: Optional[str] = None,
    device: Optional[str] = None,
) -> EnvFingerprint:
    """Snapshot the environment. Deterministic on a fixed host: every
    field is a property of the box/container, not of the moment.
    ``device`` is the job's device (``StreamConfig.device``): a CUDA
    device reports backend ``cuda``, the card's name and the visible
    card count; anything else reports ``cpu``. None reads the card when
    torch sees one."""
    backend, device_kind, device_count = "unknown", "unknown", 0
    try:
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        if torch.device(device).type == "cuda":
            backend = "cuda"
            device_kind = str(torch.cuda.get_device_name(torch.device(device)))
            device_count = int(torch.cuda.device_count())
        else:
            backend, device_kind, device_count = "cpu", "cpu", 1
    except Exception:
        backend, device_kind, device_count = "unknown", "unknown", 0
    name = hostname if hostname is not None else socket.gethostname()
    return EnvFingerprint(
        schema=ENV_FINGERPRINT_SCHEMA,
        usable_cores=usable_cores(sys_root),
        affinity_cores=affinity_cores(),
        cgroup_quota_cores=cgroup_quota_cores(sys_root),
        numa_nodes=_numa_nodes(node_root),
        backend=backend,
        device_kind=device_kind,
        device_count=device_count,
        host=hashlib.sha256(name.encode("utf-8")).hexdigest()[:12],
    )


def _parse_pid_stat(text: str) -> Optional[Tuple[float, int]]:
    """(cpu_ticks, last_core) from a ``/proc/<pid>/stat`` line. The
    comm field may contain spaces and parens, so split AFTER the last
    ')': utime/stime are fields 14/15 and processor is field 39 of the
    full 1-indexed line, i.e. offsets 11/12 and 36 past the comm."""
    _, _, rest = text.rpartition(")")
    fields = rest.split()
    if len(fields) < 37:
        return None
    try:
        ticks = float(fields[11]) + float(fields[12])
        core = int(fields[36])
    except ValueError:
        return None
    return ticks, core


class ResourceSampler:
    """Reads ``/proc`` at every snapshot tick and mints the resource
    series. Construct once per job (JobObs owns it when
    ``ObsConfig.resources`` is on), then register :meth:`sample` as a
    Snapshotter pre-hook; the ingest plane attaches its worker PIDs via
    :meth:`attach_lanes` once lanes are up.

    Series minted (all in the job's label scope):

    * ``host_cpu_util`` — fraction [0,1] of TOTAL host CPU capacity
      busy over the last inter-sample interval (``/proc/stat`` deltas).
    * ``process_rss_bytes`` — this process's resident set.
    * ``ctx_switches_total{kind=voluntary|involuntary}`` — this
      process's cumulative context switches.
    * ``lane_cpu_util{lane}`` — cores of CPU a lane worker burned over
      the interval (1.0 == a full core); ``lane_core{lane}`` — the core
      it was last seen on (-1 once the lane is gone).
    * ``lane_core_contention_total`` — contention detections; the
      executor hangs a built-in WARN health rule off this.
    """

    def __init__(
        self,
        group,
        flight=None,
        proc_root: str = "/proc",
        clock: Callable[[], float] = time.monotonic,
        page_size: Optional[int] = None,
        ticks_per_s: Optional[float] = None,
    ):
        self._group = group
        self._flight = flight
        self._proc = proc_root
        self._clock = clock
        if page_size is None:
            try:
                page_size = os.sysconf("SC_PAGE_SIZE")
            except (ValueError, OSError, AttributeError):
                page_size = 4096
        self._page = int(page_size)
        if ticks_per_s is None:
            try:
                ticks_per_s = os.sysconf("SC_CLK_TCK")
            except (ValueError, OSError, AttributeError):
                ticks_per_s = 100
        self._ticks_per_s = float(ticks_per_s) or 100.0
        self._lane_pids_fn: Optional[Callable[[], Dict[int, int]]] = None
        self._prev_host: Optional[Tuple[float, float]] = None
        self._prev_lane: Dict[int, Tuple[float, float]] = {}  # idx -> (t, ticks)
        self._reported: set = set()  # contention reasons already breadcrumbed
        self.samples = 0
        self.contentions = 0
        self.last_lane_util: Dict[int, float] = {}
        self.last_lane_core: Dict[int, int] = {}
        self._host_util = group.gauge("host_cpu_util")
        self._rss = group.gauge("process_rss_bytes")
        self._ctx = {
            kind: group.group(kind=kind).counter("ctx_switches_total")
            for kind in ("voluntary", "involuntary")
        }
        self._contention = group.counter("lane_core_contention_total")
        self._lane_util_g: Dict[int, object] = {}
        self._lane_core_g: Dict[int, object] = {}

    def attach_lanes(
        self, pids_fn: Callable[[], Dict[int, int]]
    ) -> None:
        """``pids_fn`` maps live lane index -> worker PID (IngestPlane's
        ``lane_pids``); re-called each sample so respawned incarnations
        are picked up with their fresh PID."""
        self._lane_pids_fn = pids_fn

    # -- per-sample readers -------------------------------------------------

    def _sample_host(self) -> None:
        raw = _read_text(os.path.join(self._proc, "stat"))
        if raw is None:
            return
        first = raw.split("\n", 1)[0].split()
        if not first or first[0] != "cpu":
            return
        try:
            vals = [float(v) for v in first[1:]]
        except ValueError:
            return
        if len(vals) < 5:
            return
        total = sum(vals)
        idle = vals[3] + vals[4]  # idle + iowait
        busy = total - idle
        if self._prev_host is not None:
            pb, pt = self._prev_host
            dt = total - pt
            if dt > 0:
                self._host_util.set(max(0.0, min(1.0, (busy - pb) / dt)))
        self._prev_host = (busy, total)

    def _sample_process(self) -> None:
        raw = _read_text(os.path.join(self._proc, "self", "statm"))
        if raw is not None:
            fields = raw.split()
            if len(fields) >= 2 and fields[1].isdigit():
                self._rss.set(int(fields[1]) * self._page)
        raw = _read_text(os.path.join(self._proc, "self", "status"))
        if raw is not None:
            for line in raw.splitlines():
                if line.startswith("voluntary_ctxt_switches:"):
                    self._set_ctx("voluntary", line)
                elif line.startswith("nonvoluntary_ctxt_switches:"):
                    self._set_ctx("involuntary", line)

    def _set_ctx(self, kind: str, line: str) -> None:
        try:
            total = int(line.split(":", 1)[1])
        except (ValueError, IndexError):
            return
        ctr = self._ctx[kind]
        # counters only move forward; replay the kernel's running total
        delta = total - ctr.value
        if delta > 0:
            ctr.inc(delta)

    def _sample_lanes(self, now: float) -> Dict[int, float]:
        pids = {}
        if self._lane_pids_fn is not None:
            try:
                pids = dict(self._lane_pids_fn() or {})
            except Exception:
                pids = {}
        utils: Dict[int, float] = {}
        for idx, pid in pids.items():
            raw = _read_text(os.path.join(self._proc, str(pid), "stat"))
            parsed = _parse_pid_stat(raw) if raw is not None else None
            if parsed is None:
                continue
            ticks, core = parsed
            if idx not in self._lane_util_g:
                lane_group = self._group.group(lane=str(idx))
                self._lane_util_g[idx] = lane_group.gauge("lane_cpu_util")
                self._lane_core_g[idx] = lane_group.gauge("lane_core")
            self._lane_core_g[idx].set(core)
            self.last_lane_core[idx] = core
            prev = self._prev_lane.get(idx)
            if prev is not None and now > prev[0] and ticks >= prev[1]:
                util = (ticks - prev[1]) / self._ticks_per_s / (now - prev[0])
                self._lane_util_g[idx].set(util)
                utils[idx] = util
                self.last_lane_util[idx] = util
            self._prev_lane[idx] = (now, ticks)
        # lanes that folded or finished: zero the util, park the core
        for idx in list(self._prev_lane):
            if idx not in pids:
                del self._prev_lane[idx]
                if idx in self._lane_util_g:
                    self._lane_util_g[idx].set(0.0)
                    self._lane_core_g[idx].set(-1)
                self.last_lane_util.pop(idx, None)
                self.last_lane_core.pop(idx, None)
        return utils

    def _detect_contention(self, utils: Dict[int, float]) -> None:
        busy = {i: u for i, u in utils.items() if u >= _LANE_BUSY_MIN}
        if len(busy) < 2:
            return
        reasons = []
        by_core: Dict[int, list] = {}
        for idx in busy:
            core = self.last_lane_core.get(idx)
            if core is not None and core >= 0:
                by_core.setdefault(core, []).append(idx)
        for core, idxs in sorted(by_core.items()):
            if len(idxs) >= 2:
                reasons.append(
                    ("same_core", core,
                     f"lanes {sorted(idxs)} observed on core {core}")
                )
        total = sum(busy.values())
        if _PINNED_BAND[0] <= total <= _PINNED_BAND[1]:
            reasons.append(
                ("pinned", -1,
                 f"{len(busy)} busy lanes share ~1 core of CPU "
                 f"(sum util {total:.2f})")
            )
        for kind, core, detail in reasons:
            self._contention.inc()
            self.contentions += 1
            key = (kind, core)
            if key in self._reported:
                continue
            self._reported.add(key)
            if self._flight is not None:
                try:
                    self._flight.record(
                        "lane_core_contention", reason=kind, detail=detail,
                        lanes=sorted(busy),
                    )
                except Exception:
                    pass

    def sample(self) -> None:
        """One tick: called by the Snapshotter pre-hook (exceptions are
        swallowed there, but every reader is individually guarded so a
        vanished PID can't spoil the rest of the sample)."""
        now = self._clock()
        self._sample_host()
        self._sample_process()
        utils = self._sample_lanes(now)
        self._detect_contention(utils)
        self.samples += 1
