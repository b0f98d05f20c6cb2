"""AdaptiveController: closed-loop tuning of barrier-safe pipeline knobs.

Counterpart of tpustream/runtime/controller.py, copied: it reads the
obs registry and returns knob dicts, and touches no device. The item
numbers and figures below are the reference's.

ROADMAP item 1 left "tune depths (async_depth/fetch_group/h2d_depth
sweeps) and chase sustainable-rate p99 under 300 ms" as manual offline
work. With per-series history (obs/timeseries.py) and the continuous
profiler, a running job has everything a human sweep had: windowed
throughput, windowed latency quantiles, and per-stage attribution. The
controller closes the loop.

Safety rules (the contract, not an aspiration):

* **Only barrier-safe overlap depths** — ``async_depth``,
  ``fetch_group``, ``h2d_depth``. These are documented in ``config.py``
  as never changing output bytes; semantics-bearing config (batch
  sizing, watermark policy, window params, checkpointing) is untouchable
  by construction — the knob list is closed, not configurable.
* **Applied only at a drained barrier** — the executor calls
  ``Runner.apply_knobs`` after ``drain_chain()``, the same
  quiesce-then-mutate pattern rule updates use, so a depth change never
  observes (or creates) a half-staged pipeline.
* **Strictly off by default** (``ObsConfig.adaptive = False``) and
  forced off under multi-host execution, where locally-timed decisions
  would diverge across processes.
* **Bounded** — every knob moves only inside ``ObsConfig.
  adaptive_bounds`` (clamped defaults below).
* **Auditable** — every decision is a flight-recorder event
  (``controller_decision``) and lands in ``controller_*`` series.

The algorithm is deliberately boring: round-robin hill-climb with
hysteresis and a cooldown. At each Snapshotter tick the controller reads
the windowed ``records_in`` rate (the objective) and the e2e-latency p99
(the guard). In cooldown it just re-baselines. Otherwise it probes one
knob one step in its current direction; on the next tick it keeps the
move if the objective improved by more than ``adaptive_hysteresis``
(and p99 stayed under ``adaptive_p99_ms``), else reverts and flips that
knob's direction. A p99 breach outside a probe steps every depth down
one notch ("backoff"). Hysteresis means noise can't walk the knobs; the
cooldown means each move's effect is measured against a settled
baseline.

This module imports nothing from the executor and no accelerator
libraries — it reads the registry and emits knob dicts, so the dump
CLI's selftest and pure-host unit tests can drive it directly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# The closed set of knobs the controller may ever touch, and hard outer
# bounds user-configured bounds are clamped into.
SAFE_KNOBS = ("async_depth", "fetch_group", "h2d_depth")
DEFAULT_BOUNDS: Dict[str, Tuple[int, int]] = {
    "async_depth": (1, 6),
    "fetch_group": (1, 4),
    "h2d_depth": (1, 4),
}


class AdaptiveController:
    """One instance per job attempt; ``on_tick()`` at Snapshotter ticks.

    Returns a ``{knob: value}`` dict when the pipeline depths should
    change (caller applies it at a drained barrier), else ``None``.
    """

    def __init__(self, cfg, job_obs):
        obs_cfg = cfg.obs
        self.job_obs = job_obs
        self.registry = job_obs.registry
        self.flight = job_obs.flight
        self.job_name = getattr(job_obs, "job_name", "job")

        self.bounds: Dict[str, Tuple[int, int]] = dict(DEFAULT_BOUNDS)
        user = getattr(obs_cfg, "adaptive_bounds", None) or {}
        for k, lohi in user.items():
            if k in SAFE_KNOBS:  # unknown knobs are ignored, never added
                lo, hi = int(lohi[0]), int(lohi[1])
                dlo, dhi = DEFAULT_BOUNDS[k]
                self.bounds[k] = (max(1, min(lo, dhi)), max(1, min(hi, dhi * 2)))
        self.cooldown = max(0, int(getattr(obs_cfg, "adaptive_cooldown_ticks", 2)))
        self.hysteresis = float(getattr(obs_cfg, "adaptive_hysteresis", 0.05))
        self.p99_bound_ms = float(getattr(obs_cfg, "adaptive_p99_ms", 300.0))
        # objective/guard lookback: a couple of tick intervals, floored
        # so a sub-ms test interval still spans several samples
        interval = float(getattr(obs_cfg, "snapshot_interval_s", 0.0) or 0.0)
        self.window_s = max(interval, 0.05) * 2.0

        self.knobs: Dict[str, int] = {}
        for k in SAFE_KNOBS:
            lo, hi = self.bounds[k]
            self.knobs[k] = min(hi, max(lo, int(getattr(cfg, k, lo))))

        self._gauges = {
            k: job_obs.gauge(f"controller_{k}") for k in SAFE_KNOBS
        }
        self._decisions = job_obs.counter("controller_decisions_total")
        self._reverts = job_obs.counter("controller_reverts_total")
        self._obj_gauge = job_obs.gauge("controller_objective_rows_per_s")
        self._p99_gauge = job_obs.gauge("controller_p99_ms")
        for k, v in self.knobs.items():
            self._gauges[k].set(v)

        self._order = list(SAFE_KNOBS)
        self._ki = 0
        self._dir = {k: +1 for k in SAFE_KNOBS}
        self._state = "idle"  # "idle" | "probe"
        self._probe: Optional[Tuple[str, int]] = None
        self._base_obj = 0.0
        self._cooldown_left = self.cooldown  # settle before the first probe

    # -- signal reads --------------------------------------------------------

    def _objective(self) -> float:
        """Windowed ingest rate (rows/s) — the throughput being chased."""
        inst = self.registry.find("records_in", {"job": self.job_name})
        h = getattr(inst, "history", None)
        if h is None:
            return 0.0
        return h.rate(self.window_s)

    def _p99_ms(self) -> Optional[float]:
        """e2e-latency p99 over the window, in ms; None when no latency
        series has window samples (latency markers off)."""
        for name, scale in (("emit_latency_s", 1000.0), ("step_time_s", 1000.0)):
            inst = self.registry.find(name, {"job": self.job_name})
            h = getattr(inst, "history", None)
            if h is None or not h.points(self.window_s):
                continue
            return h.quantile(0.99, self.window_s) * scale
        return None

    # -- the tick ------------------------------------------------------------

    def on_tick(self) -> Optional[Dict[str, int]]:
        obj = self._objective()
        p99 = self._p99_ms()
        self._obj_gauge.set(round(obj, 3))
        if p99 is not None:
            self._p99_gauge.set(round(p99, 3))

        if self._state == "probe":
            return self._evaluate_probe(obj, p99)
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._base_obj = obj  # settle: re-baseline, no moves
            return None
        if p99 is not None and p99 > self.p99_bound_ms:
            return self._backoff(obj, p99)
        return self._start_probe(obj, p99)

    def _evaluate_probe(self, obj: float, p99: Optional[float]):
        knob, old = self._probe
        self._probe = None
        self._state = "idle"
        self._cooldown_left = self.cooldown
        improved = obj > self._base_obj * (1.0 + self.hysteresis)
        lat_ok = p99 is None or p99 <= self.p99_bound_ms
        if improved and lat_ok:
            self._base_obj = obj
            self._log("keep", knob, old, self.knobs[knob], obj, p99)
            return None
        self._dir[knob] = -self._dir[knob]
        self._reverts.inc()
        return self._move(knob, old, "revert", obj, p99)

    def _backoff(self, obj: float, p99: float):
        """Latency breach in steady state: step every depth down one."""
        moved = False
        for k in SAFE_KNOBS:
            lo, _hi = self.bounds[k]
            if self.knobs[k] > lo:
                self._set_knob(k, self.knobs[k] - 1)
                moved = True
        if not moved:
            return None
        self._cooldown_left = self.cooldown
        self._decisions.inc()
        self.flight.record(
            "controller_decision", action="backoff", knobs=dict(self.knobs),
            objective_rows_per_s=round(obj, 3), p99_ms=round(p99, 3),
        )
        return dict(self.knobs)

    def _start_probe(self, obj: float, p99: Optional[float]):
        for _ in range(len(self._order)):
            k = self._order[self._ki]
            self._ki = (self._ki + 1) % len(self._order)
            lo, hi = self.bounds[k]
            cand = self.knobs[k] + self._dir[k]
            if cand < lo or cand > hi:
                self._dir[k] = -self._dir[k]
                cand = self.knobs[k] + self._dir[k]
                if cand < lo or cand > hi:
                    continue  # degenerate bounds (lo == hi): skip knob
            self._base_obj = obj
            self._probe = (k, self.knobs[k])
            self._state = "probe"
            return self._move(k, self.knobs[k], "probe", obj, p99, new=cand)
        return None

    # -- bookkeeping ---------------------------------------------------------

    def _set_knob(self, knob: str, value: int) -> None:
        self.knobs[knob] = value
        self._gauges[knob].set(value)

    def _move(self, knob, old, action, obj, p99, new=None):
        self._set_knob(knob, old if new is None else new)
        self._decisions.inc()
        self._log(action, knob, old, self.knobs[knob], obj, p99)
        return dict(self.knobs)

    def _log(self, action, knob, old, new, obj, p99):
        self.flight.record(
            "controller_decision", action=action, knob=knob,
            old=old, new=new,
            objective_rows_per_s=round(obj, 3),
            p99_ms=None if p99 is None else round(p99, 3),
        )

    # -- reporting -----------------------------------------------------------

    def converged(self) -> Dict[str, int]:
        """Current knob settings (the bench's converged-knob report)."""
        return dict(self.knobs)

    def summary(self) -> dict:
        return {
            "knobs": dict(self.knobs),
            "bounds": {k: list(v) for k, v in self.bounds.items()},
            "decisions": int(self._decisions.value),
            "reverts": int(self._reverts.value),
        }
