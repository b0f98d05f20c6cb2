"""Sharded program variants: a keyed job over S shards.

Counterpart of tpustream/runtime/sharded.py. There, a single-chip
program becomes SPMD by overriding its hooks (``_exchange``: keyBy as an
all-to-all; ``_local_keys`` and ``_global_key_ids``: key <-> the owner's
dense slot; ``_global_max``/``_global_sum``: the watermark, the decision
scalars and the counters through ``pmax``/``psum``; ``_row_offset``) and
running its whole step under ``shard_map``. Here each shard is an
instance of the same family program, with ``key_capacity / S`` keys, and
those hooks bound to the mesh's collectives (:class:`_ShardHooks`); one
host thread a shard runs that shard's ordinary step, and the collectives
are the rendezvous points of the threads (``parallel/mesh.py``). So each
family keeps one step body, with the hooks where the reference calls
them. Every host decision a shard takes reads only scalars that the
reference reduces over the shards, or that it keeps per shard.

Keyed state shards over the mesh as in the reference: key ``k`` lives on
shard ``k % S`` at local row ``k // S``. A batch is padded to
``batch_size`` and split into S contiguous row blocks (the reference's
``P(AXIS)`` input spec); each shard's block goes through the pre chain
and the exchange, which hands every shard ``S * capacity`` rows
(``parallel/exchange.py``), source shard by source shard. Emissions
concatenate per shard along the row axis (``out_specs = P(AXIS)``); a
prefix stream (the window programs' append-compacted rows) becomes one
prefix of the shards' prefixes in shard order, gathered on the device.

The state the executor holds is ``{"shards": [S per-shard states], ...}``
plus the counters (summed over the shards, as the reference's ``psum``
makes them) and the deferred-fire count (every shard holds the same). A
snapshot converts it to the reference's global, shard-major layout
(``state_to_jax_numpy``): row ``s * k_local + r`` of a key-sharded leaf
holds global key ``r * S + s``, so snapshots stay interchangeable with
the JAX package's, and restore at any parallelism
(``rescale_key_leaf``).

Under a process group (``parallel/distributed.py``) the S shards span
the processes: a process builds and steps only its own contiguous block
of shards (``Mesh.local_shards``), feeds their rows of each batch (the
reference's ``_gshard``), and merges only their emissions, which go to
its own sinks; the counters are summed over every process's shards,
and a snapshot gathers every process's key-sharded rows into the same
global layout.

All shards issue their device work on the caller's current stream, so
what a shard hands another across a collective is ordered on the card;
the two hand kernels launch on that stream too. If a shard raises, the
mesh is aborted and every shard fails: the step raises the first error.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..parallel.exchange import exchange_by_key, exchange_capacity
from ..parallel.mesh import MeshAborted, make_mesh
from ..utils.tree import tree_leaves, tree_unflatten
from .cep_program import CepProgram
from .count_program import (
    CountProcessProgram,
    CountWindowProgram,
    SlidingCountWindowProgram,
)
from .plan import JobPlan
from .process_program import ProcessWindowProgram
from .session_program import SessionProcessProgram, SessionWindowProgram
from .step import RULE_VERSION_KEY, RULES_KEY, RollingProgram
from .window_program import WindowProgram

# state leaves the reference sums over the shards (psum); every other
# leaf that is not key-sharded holds the same value on every shard
SUMMED = frozenset((
    "window_fires", "late_dropped", "alert_overflow", "buffer_overflow",
    "evicted_unfired", "exchange_overflow", "cep_matches", "cep_timeouts",
    "cep_partials",
))
# host state every shard holds alike that the executor reads off the
# global state (the deferred fires it drains)
REPLICATED = ("pending_fires",)


class _ShardHooks:
    """The SPMD hooks of one shard, bound to the mesh's collectives (the
    reference's ``_ShardedMixin`` hooks)."""

    def _bind_shard(self, mesh, shard: int, n_shards: int, capacity: int):
        self.mesh, self.shard, self.n_shards = mesh, shard, n_shards
        self.exchange_capacity = capacity
        self.xovf = None  # this step's exchange overflow (int64, 0-d)

    def _global_max(self, x):
        return self.mesh.pmax(self.shard, x)

    def _global_sum(self, x):
        return self.mesh.psum(self.shard, x)

    def _exchange(self, mid_cols, mask, ts):
        if self.shard == self.n_shards - 1:
            # the ``exchange`` fault point, once a step, raised on the
            # last shard's thread while the others wait in the keyBy
            inj = self.cfg.extra.get("fault_injector") if self.cfg.extra else None
            if inj is not None:
                inj.check("exchange")
        if ts is None:
            ts = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
        keys = mid_cols[-1] if self.plan.synthetic_key else mid_cols[self.key_pos]
        cols, valid, ts2, ovf = exchange_by_key(
            list(mid_cols), mask, ts, keys, self.n_shards,
            self.exchange_capacity, self.mesh, self.shard)
        self.xovf = ovf
        return cols, valid, ts2, ovf

    def _local_keys(self, key_col):
        return key_col.to(torch.int32) // self.n_shards

    def _global_key_ids(self, local_ids):
        return local_ids.to(torch.int32) * self.n_shards + self.shard

    def _row_offset(self, n_local_rows: int) -> int:
        return self.shard * n_local_rows


_SHARD_CLASSES: Dict[type, type] = {}


def _shard_class(family: type) -> type:
    cls = _SHARD_CLASSES.get(family)
    if cls is None:
        cls = _SHARD_CLASSES[family] = type(
            f"{family.__name__}Shard", (_ShardHooks, family), {})
    return cls


def _concat(parts):
    """One leaf of the shards' emissions, concatenated along the rows
    (the reference's ``out_specs = P(AXIS)``)."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        if x.dim() == 0:
            return x
        dev = x.device
        return torch.cat([p.to(dev) for p in parts], dim=0)
    if isinstance(x, (tuple, list)):
        return type(x)(_concat([p[i] for p in parts]) for i in range(len(x)))
    return x


def _take(x, idx):
    """Rows ``idx`` of an emission leaf (a tensor, or a list or tuple
    of them)."""
    if isinstance(x, torch.Tensor):
        return x[idx] if x.dim() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_take(v, idx) for v in x)
    return x


class _ShardedMixin:
    """What the executor sees of a sharded program: the family's own
    program (built at the global config, for its schema, ring and
    hooks into the executor) plus S shard programs that do the work."""

    _family: type = None

    def _setup_sharding(self, plan: JobPlan, cfg):
        s = cfg.parallelism
        if cfg.key_capacity % s:
            raise ValueError(
                f"key_capacity ({cfg.key_capacity}) must divide evenly by "
                f"parallelism ({s})"
            )
        if cfg.batch_size % s:
            raise ValueError(
                f"batch_size ({cfg.batch_size}) must divide evenly by "
                f"parallelism ({s})"
            )
        self.n_shards = s
        self.mesh = make_mesh(s, device=cfg.device)
        self.exchange_capacity = exchange_capacity(
            cfg.batch_size, s, cfg.exchange_capacity_factor)
        shard_cls = _shard_class(self._family)
        # this process's shards only: under a process group the others
        # run in the peer processes (``Mesh.local_shards``)
        self.shards = []
        for i in self.mesh.local_shards:
            dev = self.mesh.device_of(i)
            shard_cfg = cfg.replace(key_capacity=cfg.key_capacity // s,
                                    device=str(dev))
            p = shard_cls(plan, shard_cfg)
            p._bind_shard(self.mesh, i, s, self.exchange_capacity)
            self.shards.append(p)
        self._own_reads = 0

    # set by the executor when an event-time stage is downstream: the
    # shards' steps carry each row's timestamp
    @property
    def emit_ts(self) -> bool:
        return getattr(self, "_emit_ts", False)

    @emit_ts.setter
    def emit_ts(self, v: bool) -> None:
        self._emit_ts = v
        for p in getattr(self, "shards", ()):
            p.emit_ts = v

    # the executor counts the device reads a step made
    @property
    def host_reads(self) -> int:
        return self._own_reads + sum(
            getattr(p, "host_reads", 0) for p in getattr(self, "shards", ()))

    @host_reads.setter
    def host_reads(self, v: int) -> None:
        self._own_reads = v

    # -- running the shards -----------------------------------------------
    def _run_shards(self, fn) -> list:
        """``fn(i)`` for every local shard ``i`` (its index in
        :attr:`shards`), each on a thread of its own for the step: every
        shard issues its device work on the caller's stream.
        If a shard raises, the mesh is aborted (no shard waits forever in
        a collective) and the first error is raised."""
        mesh, n = self.mesh, len(self.shards)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        results, errors = [None] * n, [None] * n

        def work(i):
            try:
                if stream is not None:
                    with torch.cuda.stream(stream):
                        results[i] = mesh.run_shard(fn, i)
                else:
                    results[i] = mesh.run_shard(fn, i)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[i] = e
                mesh.abort()

        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"tpustream-shard-{p.shard}")
                   for i, p in enumerate(self.shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            mesh.reset()
            raise next((e for e in failed if not isinstance(e, MeshAborted)),
                       failed[0])
        return results

    def _blocks(self, cols, valid, ts):
        """The batch padded to ``batch_size`` and split into S contiguous
        row blocks, each on its shard's device: this process's blocks
        only (the reference's ``_gshard``: every process holds the whole
        batch and feeds its own rows)."""
        b, s = self.cfg.batch_size, self.n_shards
        n = valid.shape[0]
        if n < b:
            def pad(x):
                return torch.cat([x, torch.zeros((b - n,) + tuple(x.shape[1:]),
                                                 dtype=x.dtype,
                                                 device=x.device)])
            cols, valid = [pad(c) for c in cols], pad(valid)
            ts = None if ts is None else pad(ts)
        elif n > b:
            raise ValueError(f"a step of {n} rows exceeds batch_size {b}")
        blk = b // s
        out = []
        for i in self.mesh.local_shards:
            dev = self.mesh.device_of(i)
            sl = slice(i * blk, (i + 1) * blk)
            out.append(([c[sl].to(dev) for c in cols], valid[sl].to(dev),
                        None if ts is None else ts[sl].to(dev)))
        return out

    def run_step(self, state: dict, cols, valid, ts=None, wm_lower=None):
        blocks = self._blocks(cols, valid, ts)
        shard_states = state["shards"]
        if RULES_KEY in state:
            # the rule tensors are the global state's (updates write
            # them, or replace them, between steps)
            for st in shard_states:
                st[RULES_KEY] = state[RULES_KEY]
                st[RULE_VERSION_KEY] = state[RULE_VERSION_KEY]

        def one(i):
            c, v, t = blocks[i]
            return self.shards[i].run_step(shard_states[i], c, v, t, wm_lower)

        out = self._run_shards(one)
        new_states = [o[0] for o in out]
        xovf = [p.xovf for p in self.shards if p.xovf is not None]
        for p in self.shards:
            p.xovf = None
        state = self._assemble(new_states, state, xovf)
        return state, self._merge_emissions([o[1] for o in out])

    def step(self, state, cols, valid, ts=None, wm_lower=None):
        return self.run_step(state, cols, valid, ts, wm_lower)

    # -- the global state ---------------------------------------------------
    def _assemble(self, shard_states: list, prev: dict = None,
                  xovf: list = ()) -> dict:
        """The executor's view of the shards' states: the states, the
        counters summed over every shard (across processes too: one
        gather on the group, the reference's ``psum``), the replicated
        clocks and the rule tensors. ``xovf`` is this step's exchange
        overflow of each local shard."""
        first = shard_states[0]
        out = {"shards": shard_states}
        summed = [k for k, v in first.items()
                  if k in SUMMED and isinstance(v, torch.Tensor)]
        for k, v in first.items():
            if k in REPLICATED:
                out[k] = v
        if RULES_KEY in first:
            out[RULES_KEY] = first[RULES_KEY]
            out[RULE_VERSION_KEY] = first[RULE_VERSION_KEY]
        dev = self.device
        parts = [torch.stack([st[k].to(dev).to(torch.int64).reshape(())
                              for st in shard_states]).sum() for k in summed]
        parts.append(torch.stack([x.to(dev).reshape(()) for x in xovf]).sum()
                     if xovf else torch.zeros((), dtype=torch.int64,
                                              device=dev))
        vec = torch.stack(parts)
        if self.mesh.multiprocess:
            from ..parallel.distributed import allgather_array

            t0 = time.perf_counter()
            host = vec.cpu().numpy()
            vec = torch.from_numpy(
                allgather_array(host).sum(axis=0)).to(dev)
            self.mesh.xproc_calls += 1
            self.mesh.xproc_bytes += host.nbytes
            self.mesh.xproc_seconds += time.perf_counter() - t0
        for j, k in enumerate(summed):
            out[k] = vec[j].to(first[k].dtype)
        xo = None if prev is None else prev.get("exchange_overflow")
        if xo is None:
            xo = torch.zeros((), dtype=torch.int64, device=dev)
        out["exchange_overflow"] = xo + vec[-1] if xovf else xo
        return out

    def init_state(self, key_capacity: int = None) -> dict:
        k = self._local_capacity(key_capacity)
        return self._assemble([p.init_state(k) for p in self.shards])

    def _local_capacity(self, key_capacity) -> int:
        k = key_capacity or self.cfg.key_capacity
        if k % self.n_shards:
            raise ValueError(
                f"key_capacity ({k}) must divide evenly by parallelism "
                f"({self.n_shards})")
        return k // self.n_shards

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        k = self._local_capacity(key_capacity)
        grown = [p.grow_state(st, k)
                 for p, st in zip(self.shards, state["shards"])]
        return self._assemble(grown, state)

    def key_capacity(self, state) -> int:
        return self.mesh.n_procs * sum(
            p.key_capacity(st) for p, st in zip(self.shards, state["shards"]))

    # -- snapshots in the reference's global layout ----------------------------
    def _merge_jax(self, parts: list, concat, xovf, total=None) -> dict:
        """The shards' reference-layout states as one global state:
        key-sharded leaves stacked shard-major, summed counters summed
        (``total`` adds a local sum over the processes), every other
        leaf shard 0's."""
        flags = tree_leaves(self.shards[0].key_sharded_leaves(parts[0]))
        names = _leaf_names(parts[0])
        per = [tree_leaves(p) for p in parts]
        leaves = []
        for j, (flag, name) in enumerate(zip(flags, names)):
            col = [p[j] for p in per]
            if flag:
                leaves.append(concat(col))
            elif name == "exchange_overflow":
                leaves.append(np.asarray(xovf, dtype=np.int64))
            elif name in SUMMED:
                local = sum(int(x) for x in col)
                leaves.append(np.asarray(
                    local if total is None else total(local),
                    dtype=np.asarray(col[0]).dtype))
            else:
                leaves.append(col[0])
        return tree_unflatten(parts[0], leaves)

    def state_to_jax_numpy(self, state: dict) -> dict:
        parts = [p.state_to_jax_numpy(st)
                 for p, st in zip(self.shards, state["shards"])]
        xovf = int(state["exchange_overflow"])
        if not self.mesh.multiprocess:
            return self._merge_jax(parts, lambda c: np.concatenate(c, axis=0),
                                   xovf)
        # a collective: every process's rows of each key-sharded leaf, in
        # process order, which is global shard order (the reference's
        # ``process_allgather(tiled=True)``, tpustream/runtime/
        # checkpoint.py:145-158)
        from ..parallel.distributed import allgather_array

        def gathered(col):
            local = np.concatenate(col, axis=0)
            g = allgather_array(local)
            return g.reshape((-1,) + local.shape[1:])

        return self._merge_jax(
            parts, gathered, xovf,
            total=lambda n: int(allgather_array(np.asarray(n, np.int64)).sum()))

    def jax_state_spec(self, key_capacity: int = None) -> dict:
        spec = self.shards[0].jax_state_spec(self._local_capacity(key_capacity))
        s = self.n_shards

        def stacked(col):
            x = col[0]
            return np.broadcast_to(np.zeros((), x.dtype),
                                   (x.shape[0] * s,) + tuple(x.shape[1:]))

        return self._merge_jax([spec] * s, stacked, 0)

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        flags = tree_leaves(self.shards[0].key_sharded_leaves(state_np))
        names = _leaf_names(state_np)
        leaves = tree_leaves(state_np)
        s = self.n_shards
        states = []
        for p in self.shards:
            i = p.shard  # this process's shards take their own rows
            mine = []
            for flag, name, x in zip(flags, names, leaves):
                x = np.asarray(x)
                if flag:
                    blk = x.shape[0] // s
                    mine.append(np.ascontiguousarray(x[i * blk:(i + 1) * blk]))
                elif name in SUMMED and i > 0:
                    mine.append(np.zeros_like(x))
                else:
                    mine.append(x)
            states.append(p.state_from_jax_numpy(tree_unflatten(state_np, mine)))
        out = self._assemble(states)
        if "exchange_overflow" in state_np:
            out["exchange_overflow"] = torch.tensor(
                int(state_np["exchange_overflow"]), dtype=torch.int64,
                device=self.device)
        return out

    def evaluate_fires(self, state, fire_info, emit, fetch) -> int:
        """Host evaluation of the shards' fires, in the reference's
        order: a count window's fires (one merged prefix) by their
        closing record; a time window's, candidate by candidate, each
        over the shards in order; a session's, shard by shard."""
        if isinstance(fire_info, dict):
            return self._family.evaluate_fires(self, state, fire_info, emit,
                                               fetch)
        states = state["shards"]
        fired = 0
        if hasattr(self._family, "evaluate_window") and not hasattr(
                self._family, "_gather_fired"):
            per = [p.fired_windows(st, info, fetch) if info is not None else {}
                   for p, st, info in zip(self.shards, states, fire_info)]
            for j in sorted({j for d in per for j in d}):
                for p, st, info, d in zip(self.shards, states, fire_info, per):
                    if j in d:
                        fired += p.evaluate_window(st, info, j, d[j], emit,
                                                   fetch)
            return fired
        for p, st, info in zip(self.shards, states, fire_info):
            if info is not None:
                fired += p.evaluate_fires(st, info, emit, fetch)
        return fired

    def obs_state_scalars(self, state: dict) -> dict:
        return self.shards[0].obs_state_scalars(state["shards"][0])

    # -- emissions ------------------------------------------------------------
    def _merge_emissions(self, per_shard: List[dict]) -> dict:
        names = []
        for e in per_shard:
            for k in e:
                if k not in names:
                    names.append(k)
        out = {}
        for name in names:
            parts = [e.get(name) for e in per_shard]
            if any(p is not None and "count" in p for p in parts):
                out[name] = self._merge_prefix(parts)
            elif name == "process_fire":
                # a time window's fires: the host evaluates each shard's
                # against its state (evaluate_fires)
                out[name] = parts
            else:
                out[name] = self._merge_masked(parts)
        return out

    def _merge_masked(self, parts: List[dict]) -> dict:
        out = {}
        for k in parts[0]:
            vals = [p[k] for p in parts]
            if k == "bad_keys":
                out[k] = torch.stack([v.to(self.device) for v in vals]).sum(
                    dim=0)
            else:
                out[k] = _concat(vals)
        return out

    def _merge_prefix(self, parts: List[dict]) -> dict:
        """The shards' prefix streams as one prefix, in shard order: the
        first ``count_s`` rows of each shard's buffers, gathered on the
        device (no wait for the counts)."""
        live = [p for p in parts if p is not None
                and isinstance(p.get("count"), torch.Tensor)]
        if not live:
            return {"count": 0}
        dev = self.device
        counts = torch.stack([p["count"].reshape(()).to(device=dev,
                                                        dtype=torch.int64)
                              for p in live])
        caps = [_rows(p) for p in live]
        rows = sum(caps)
        base = torch.tensor(np.cumsum([0] + caps[:-1]), dtype=torch.int64,
                            device=dev)
        ends = torch.cumsum(counts, 0)
        starts = ends - counts
        r = torch.arange(rows, dtype=torch.int64, device=dev)
        shard = torch.searchsorted(ends, r, right=True).clamp(max=len(live) - 1)
        src = (base[shard] + r - starts[shard]).clamp(0, rows - 1)

        out = {"count": ends[-1].to(torch.int32)}
        for k in live[0]:
            vals = [p[k] for p in live]
            if k == "bad_keys":
                out[k] = torch.stack([v.to(dev) for v in vals]).sum(dim=0)
            elif k != "count":
                out[k] = _take(_concat(vals), src)
        return out


def _rows(stream: dict) -> int:
    """The buffer rows of a prefix stream (its first row leaf's)."""
    for k, v in stream.items():
        if k in ("count", "bad_keys"):
            continue
        while isinstance(v, (tuple, list)) and v:
            v = v[0]
        if isinstance(v, torch.Tensor) and v.dim():
            return int(v.shape[0])
    return 0


def _leaf_names(tree: dict) -> list:
    """The top-level key of each of ``tree``'s leaves, in
    :func:`tree_leaves` order."""
    out = []
    for k in sorted(tree):
        out.extend([k] * len(tree_leaves(tree[k])))
    return out


def _sharded(family: type, doc: str) -> type:
    def __init__(self, plan: JobPlan, cfg):
        family.__init__(self, plan, cfg)
        self._setup_sharding(plan, cfg)

    return type(f"Sharded{family.__name__}", (_ShardedMixin, family), {
        "__init__": __init__, "_family": family, "__doc__": doc,
        "__module__": __name__})


ShardedWindowProgram = _sharded(
    WindowProgram, "Tumbling and sliding windows at parallelism N.")
ShardedSessionWindowProgram = _sharded(
    SessionWindowProgram, "Session windows at parallelism N.")
ShardedSessionProcessProgram = _sharded(
    SessionProcessProgram,
    "Session windows with a ProcessWindowFunction at parallelism N: the "
    "host evaluates each shard's fired sessions with global key ids.")
ShardedRollingProgram = _sharded(
    RollingProgram,
    "keyBy + rolling aggregate at parallelism N: each shard runs the "
    "rolling kernel on its [K/S] plane.")
ShardedCountWindowProgram = _sharded(
    CountWindowProgram, "Tumbling count windows at parallelism N.")
ShardedSlidingCountWindowProgram = _sharded(
    SlidingCountWindowProgram, "Sliding count windows at parallelism N.")
ShardedCountProcessProgram = _sharded(
    CountProcessProgram,
    "Count-window process() at parallelism N: emission payloads carry "
    "global key ids.")
ShardedCepProgram = _sharded(
    CepProgram,
    "CEP at parallelism N: the keyBy exchange routes events to their "
    "key's owner shard, the NFA planes shard on the key axis, the "
    "watermark agrees through pmax, and matches carry global key ids.")
ShardedProcessWindowProgram = _sharded(
    ProcessWindowProgram,
    "Full-window process() at parallelism N: the host evaluates each "
    "shard's fired windows with global key ids "
    "(reference chapter2/README.md:177-196 runs at parallelism N).")
