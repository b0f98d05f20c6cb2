"""The build registry: every device-program build and reshape, counted.

Counterpart of tpustream/obs/compilation.py, the compile/recompile
registry. The JAX package counts XLA builds of its jitted step; PyTorch
compiles nothing, so here a "compile" is what would have been one
there:

* a program build (``runtime/step.py::build_program``), once per stage
  at cause ``initial``;
* a reshape of a program's state in place of a rebuild: key-capacity
  growth through ``grow_state`` (cause ``key_capacity_growth``), and a
  tenant-capacity growth or a changed set of rule names, which replaces
  the rule leaves (cause ``tenant_capacity_growth``).

The series names and the cause taxonomy are the reference's, so a fleet
proves "one program" the same way in both packages (labels ``{job,
operator}``):

* ``operator_compile_count``   — every build or reshape
* ``operator_recompile_count`` — those after the first (total)
* ``operator_recompile_cause`` — the same, labelled ``{cause=...}``
* ``operator_compile_wall_ms`` — histogram of each one's host wall time

Left out: the reference's XLA cost- and memory-analysis gauges
(``operator_compile_flops``, ``_bytes_accessed``, ``_output_bytes``,
``_temp_bytes``, ``_argument_bytes``, ``_code_bytes``), which read
``Compiled.cost_analysis()`` and have no counterpart for eager torch
ops. A batch of a new length rebuilds nothing here, so
``batch_shape_change`` is a cause of the taxonomy that this registry
never records; neither does ``config_change`` (a checkpoint restore's
capacity reconciliation, which the port does not have yet).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

CAUSE_INITIAL = "initial"
CAUSE_KEY_GROWTH = "key_capacity_growth"
CAUSE_TENANT_GROWTH = "tenant_capacity_growth"
CAUSE_BATCH_SHAPE = "batch_shape_change"
CAUSE_CONFIG = "config_change"


class CompileObs:
    """Per-runner build instrumentation bundle (one per OperatorObs)."""

    def __init__(self, op_obs, flight, meta: Optional[Dict[str, Any]] = None):
        self._obs = op_obs
        self._flight = flight
        self._meta = dict(meta or {})
        self.compile_count = op_obs.counter("compile_count")
        self.recompile_count = op_obs.counter("recompile_count")
        self.compile_wall_ms = op_obs.histogram("compile_wall_ms")
        self._n = 0

    def build(self, cause: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` (a build or a reshape) and record it under
        ``cause`` with its wall time; returns what ``fn`` returns."""
        t0 = time.perf_counter()
        out = fn()
        self.record_compile(cause, (time.perf_counter() - t0) * 1e3)
        return out

    def record_compile(self, cause: str, wall_ms: float) -> None:
        self.compile_count.inc()
        if self._n > 0:
            self.recompile_count.inc()
            self._obs.scoped(cause=cause).counter("operator_recompile_cause").inc()
        event: Dict[str, Any] = {
            "operator": self._obs.name,
            "cause": cause,
            "wall_ms": round(wall_ms, 3),
            "compile_index": self._n,
        }
        event.update(self._meta)
        self._n += 1
        self.compile_wall_ms.observe(wall_ms)
        self._flight.record("program_compiled", **event)
