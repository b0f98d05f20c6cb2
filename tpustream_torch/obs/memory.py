"""Device state-memory accounting and key-skew gauges.

Counterpart of tpustream/obs/memory.py (the port's own copy; its tree
walk is ``utils/tree.py``'s). The series keep the reference's names,
``hbm`` included, so that both packages' dashboards line up.

A keyed program holds its state in one dict of leaves
(``Runner.state``), so "how much device memory does this job hold" is a
walk over that dict's tensors (``numel x element_size``, no device
sync), and "what is it holding" is the program's own classification of
its state keys into named components (pane rings, session cells,
rolling planes, process buffers; see ``BaseProgram.state_components``).

The count is the state as the port holds it on its device: every
tensor leaf, with the trailing sink row or cell each keyed leaf carries.
Host leaves (the pane ring's ``slot_pane`` and the scalar clocks the
port keeps as numpy arrays and Python ints) are not on the device and
count 0, where the reference holds them as device arrays.

Per-operator series (labels ``{job, operator}``; all lazy ``set_fn``
gauges, evaluated only at snapshot/scrape time):

* ``operator_hbm_state_bytes``             — total state bytes
* ``operator_hbm_state_bytes{shard=i}``    — each shard's state bytes
  (``parallelism > 1``: the shards' own states, which sum to the total)
* ``operator_state_component_bytes{component=...}``
* ``operator_exchange_buffer_bytes``       — the keyBy all-to-all's
  staging columns a sharded step makes, per shard
  (``parallel/exchange.py::exchange_buffer_bytes``)
* ``operator_key_table_capacity`` / ``_occupancy`` / ``_load_factor``
* ``operator_key_cardinality``             — distinct keys seen
* ``operator_hot_key_share``               — top key's share of keyed
  updates (NaN until any update lands); ``operator_hot_key_id`` names it
* ``operator_key_updates`` (counter)       — keyed rows observed

Skew tracking is host-side and obs-gated: one ``np.bincount`` over the
batch's key-id column per feed (interned ids are dense ``< capacity``),
never per-record Python. Raw int64 key columns whose ids exceed the
tracking bound disable skew gauges for the runner (one flight event)
rather than growing an unbounded count table. A sharded program's
state (``runtime/sharded.py``) is walked shard by shard: the global
view's summed counters and clocks are not counted twice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.tree import tree_leaves

# ids beyond this are not dense interned ids (raw i64 key column):
# tracking them per-id would be unbounded, so skew tracking opts out
MAX_TRACKED_KEY_ID = 1 << 22


def leaf_nbytes(leaf) -> int:
    """A device leaf's bytes from its metadata only (never a device
    sync); a host leaf (numpy array, Python int) counts 0."""
    if not isinstance(leaf, torch.Tensor):
        return 0
    return int(math.prod(leaf.shape)) * leaf.element_size()


class StateMemoryTracker:
    """Installs the memory/skew gauges for one runner and accumulates
    per-key update counts from the feed path."""

    def __init__(self, runner):
        self._runner = runner
        obs = runner.obs
        self._counts = np.zeros(0, dtype=np.int64)
        self._updates = 0
        self._skew_disabled = False
        # fleet attribution: the JobServer reads tenant_breakdown() off
        # this registry at snapshot time (obs/runtime.py JobObs keeps
        # the list; single-job runs never consult it)
        trackers = getattr(runner.metrics.job_obs, "state_trackers", None)
        if trackers is not None:
            trackers.append(self)

        obs.gauge("hbm_state_bytes").set_fn(self.total_bytes)
        shards = runner.program.n_shards
        if shards > 1:
            for i in range(shards):
                obs.scoped(shard=str(i)).gauge(
                    "operator_hbm_state_bytes"
                ).set_fn(lambda i=i: self.shard_bytes(i))
            obs.gauge("exchange_buffer_bytes").set_fn(self.exchange_bytes)
        for comp in self._component_names():
            obs.scoped(component=comp).gauge(
                "operator_state_component_bytes"
            ).set_fn(lambda c=comp: self.component_bytes().get(c, 0))

        if runner.plan.key_pos is not None:
            obs.gauge("key_table_capacity").set_fn(
                lambda: self._runner.cfg.key_capacity
            )
            obs.gauge("key_table_occupancy").set_fn(self.occupancy)
            obs.gauge("key_table_load_factor").set_fn(self.load_factor)
            obs.gauge("key_cardinality").set_fn(self.cardinality)
            obs.gauge("hot_key_share").set_fn(self.hot_key_share)
            obs.gauge("hot_key_id").set_fn(self.hot_key_id)
            self._updates_counter = obs.counter("key_updates")
        else:
            self._updates_counter = None

    # -- state walk ---------------------------------------------------------

    def _states(self) -> list:
        """The state dicts to walk: a sharded program's shard states,
        else the runner's one state."""
        state = self._runner.state
        if isinstance(state, dict) and "shards" in state:
            return list(state["shards"])
        return [state] if isinstance(state, dict) else []

    def _state_items(self):
        return [kv for st in self._states() for kv in st.items()]

    def total_bytes(self) -> int:
        return sum(leaf_nbytes(l) for st in self._states()
                   for l in tree_leaves(st))

    def shard_bytes(self, shard: int) -> int:
        states = self._states()
        if shard >= len(states):
            return 0
        return sum(leaf_nbytes(l) for l in tree_leaves(states[shard]))

    def exchange_bytes(self) -> int:
        """The keyBy all-to-all's staging: the ``[n_shards * capacity]``
        post-exchange columns (+ ts + valid) a sharded step makes on
        each shard."""
        from ..parallel.exchange import exchange_buffer_bytes

        prog = self._runner.program
        kinds = (getattr(getattr(prog, "pre_chain", None), "out_kinds", None)
                 or self._runner.plan.record_kinds)
        return exchange_buffer_bytes(
            prog.n_shards, getattr(prog, "exchange_capacity", 0), kinds)

    def component_bytes(self) -> dict:
        comp_of = self._runner.program.state_components()
        out: dict = {}
        for key, entry in self._state_items():
            comp = comp_of.get(key, "scalars")
            nb = sum(leaf_nbytes(l) for l in tree_leaves(entry))
            out[comp] = out.get(comp, 0) + nb
        return out

    def _component_names(self):
        comp_of = self._runner.program.state_components()
        names = set(comp_of.values())
        names.add("scalars")
        return sorted(names)

    # -- key table ----------------------------------------------------------

    def _key_table(self):
        r = self._runner
        if r.plan.key_pos is None:
            return None
        if r.plan.synthetic_key:
            return r.plan.tables[-1] if r.plan.tables else None
        return r.program.pre_chain.out_tables[r.plan.key_pos]

    def occupancy(self) -> Optional[int]:
        t = self._key_table()
        if t is not None:
            return len(t)
        # raw integer keys have no intern table: distinct ids seen so far
        return int((self._counts > 0).sum()) if self._updates else 0

    def load_factor(self) -> float:
        occ = self.occupancy() or 0
        cap = self._runner.cfg.key_capacity
        return occ / cap if cap else 0.0

    def cardinality(self) -> Optional[int]:
        return self.occupancy()

    def tenant_breakdown(self) -> dict:
        """Per-tenant keyed-state attribution from the key namespace:
        fleet keys are interned as ``"<slot>\\x1f<key>"`` (the
        JobServer's key namespace), so counting interned strings by prefix
        yields each tenant's key cardinality, and the tenant's share of
        the keyed state components is ``keys/total * keyed_bytes`` (the
        dense key table allocates uniformly per slot). Returns
        ``{slot: {"keys": n, "hbm_bytes": b}}``; empty outside a fleet
        (no separator in any key) or for raw-integer key columns."""
        t = self._key_table()
        if t is None or not len(t):
            return {}
        sep = "\x1f"
        per_slot: dict = {}
        for i in range(len(t)):
            key = t.lookup(i)
            if not isinstance(key, str) or sep not in key:
                continue
            slot_s = key.split(sep, 1)[0]
            try:
                slot = int(slot_s)
            except ValueError:
                continue
            per_slot[slot] = per_slot.get(slot, 0) + 1
        total = sum(per_slot.values())
        if not total:
            return {}
        comp = self.component_bytes()
        keyed_bytes = sum(
            b for c, b in comp.items() if c != "scalars"
        ) or self.total_bytes()
        return {
            slot: {
                "keys": n,
                "hbm_bytes": int(round(keyed_bytes * (n / total))),
            }
            for slot, n in per_slot.items()
        }

    # -- skew ---------------------------------------------------------------

    def observe_batch(self, batch) -> None:
        """Accumulate per-key update counts from one (pre-split) feed
        batch: one vectorized bincount over the key-id column."""
        if self._skew_disabled:
            return
        r = self._runner
        pos = r.plan.key_pos
        if pos is None or pos >= len(batch.columns):
            return
        ids = np.asarray(batch.columns[pos].data)
        if ids.dtype.kind not in "iu":
            return
        valid = np.asarray(batch.valid)
        if valid.shape == ids.shape and not valid.all():
            ids = ids[valid]
        if ids.size == 0:
            return
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= MAX_TRACKED_KEY_ID:
            self._skew_disabled = True
            r._flight.record(
                "key_skew_tracking_disabled",
                operator=r.obs.name,
                reason=f"key id out of tracked range [0, {MAX_TRACKED_KEY_ID})",
                observed=hi if lo >= 0 else lo,
            )
            return
        counts = np.bincount(ids, minlength=self._counts.shape[0])
        if counts.shape[0] > self._counts.shape[0]:
            counts[: self._counts.shape[0]] += self._counts
            self._counts = counts
        else:
            self._counts += counts
        self._updates += int(ids.size)
        if self._updates_counter is not None:
            self._updates_counter.inc(int(ids.size))

    def hot_key_share(self) -> float:
        if self._updates == 0:
            return float("nan")
        return float(self._counts.max()) / float(self._updates)

    def hot_key_id(self) -> float:
        if self._updates == 0:
            return float("nan")
        return int(self._counts.argmax())
