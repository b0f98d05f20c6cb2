"""Checkpoint / resume: snapshots of the device-resident streaming state.

Counterpart of tpustream/runtime/checkpoint.py, on one device, writing
and reading the JAX package's snapshot format (``FORMAT_VERSION`` 12):

* at a barrier the executor turns every stage's live state into the
  reference's layout (``state_to_jax_numpy``: sink cells sliced off,
  int64 aggregates split into two int32 words, host scalars as 0-d int64
  leaves, all on the device) and copies it to the host; the leaves go in
  the reference's pytree order (``utils/tree.py``) and are OWNED host
  copies, so the next step, which writes the planes in place, cannot
  touch the cut (the *capture*, the only part on the barrier's path);
* alongside host-side stream position: lines consumed from the source,
  the virtual processing-time clock, records emitted so far, and the
  string-intern tables (so key ids keep meaning across restarts);
* encode + write happen off the hot path on a single background writer
  thread (``CheckpointPlane``), which touches numpy only;
* snapshots are INCREMENTAL by default: the ``.npz`` is a manifest that
  references per-leaf chunk files by content hash (``chunks/<sha256>
  .npy``), so an unchanged leaf re-uses the chunk an earlier snapshot
  wrote;
* restore checks every saved leaf against the program's leaf spec (the
  reference layout's shapes and dtypes, built on the ``meta`` device
  without allocating state), then places the leaves through the
  program's ``state_from_jax_numpy`` onto the program's own device.

A snapshot written by either package restores in the other, at any
parallelism: the key-sharded leaves of a snapshot written at another
``parallelism`` are re-laid onto the restoring program's shard-major
layout (``rescale_key_leaf``, the reference's
tpustream/runtime/checkpoint.py:265-315; ROADMAP item 12a). Under
several processes (ROADMAP item 12b) the capture is collective: each
process's key-sharded rows gather into the global layout, and only the
coordinator writes; a restore reads the whole snapshot on every process
and each takes its own shards' rows.

Retention is tiered: the ``keep`` newest snapshots, plus every
``keep_every``-th as durable, plus pinned **savepoints** (self-contained
full snapshots written on request). Chunk GC deletes a chunk only when
no retained manifest references it, and is crash-safe via a mark file
written before the unlink sweep.

With the deterministic ``ReplaySource`` this gives exactly-once resume:
a restored run emits exactly the records the original run had not yet
emitted.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..utils.tree import tree_leaves, tree_unflatten

#: format migration table — what each version bump changed; a copy of
#: the reference's, so both packages read and write the same versions.
MIGRATIONS = {
    2: "window/process/session state gained device-side metric counter "
       "leaves (window_fires / late_dropped), changing the snapshot treedef",
    3: "process state gained exchange_overflow (sharded process windows); "
       "meta records parallelism because the sharded key layout is "
       "shard-major",
    4: "stateless state is a real alert_overflow counter (device-compacted "
       "emissions); session process() programs add cell_min/max/"
       "pending_clear",
    5: "commutative rolling state derives occupancy from a -1-initialized "
       "sentinel STR plane — a v4 snapshot's zero-initialized plane would "
       "read every key row as already-seen",
    6: "session state gains cell_fired (allowed-lateness retention); count "
       "windows gain element-log programs (ebuf/tot)",
    7: "meta carries lazy_schemas / key_capacities / chain_key_tables and "
       "restore may rescale across parallelism or grow capacity (added "
       "late in v6's life — the bump makes pre-feature builds reject such "
       "snapshots with the version message instead of a leaf-shape "
       "ValueError); DerivedKeyTable reserves id 0 as the filter-drop "
       "placeholder, shifting every derived key id by one",
    8: "supervised recovery (runtime/supervisor.py) — meta gains a payload "
       "checksum (load/validate detect corruption), absolute collect-sink "
       "counts + quarantined dead-letter count at snapshot time (the "
       "restore rollback that makes an in-process restart's output "
       "byte-identical to an uninterrupted run), and the writing "
       "supervision session's nonce; snapshots are now named by source "
       "position (monotone across restart attempts, where the per-attempt "
       "batch counter is not)",
    9: "dynamic rules (tpustream_torch/broadcast) — a broadcast-parameterized "
       "job's state pytree carries rule leaves (__rules__/"
       "__rule_version__), and meta records the host RuleSet's values "
       "plus its applied-update count so a restore re-syncs the "
       "control-feed cursor exactly-once",
    10: "multi-tenancy (tpustream_torch/tenancy) — rule leaves may be [T] "
        "per-tenant vectors (rule_values carries the tenant table under "
        "\"__tenant__\"), and meta gains a ``tenancy`` dict: the "
        "JobServer's tenant→slot map, admitted/quota counters, and slot "
        "capacity, so a supervised restart restores the whole fleet "
        "exactly-once",
    11: "retention tiers + savepoints — meta gains ``kind`` (checkpoint|"
        "savepoint), a monotone ``seq`` ordinal, and ``durable`` (every "
        "keep_every-th snapshot survives pruning); savepoints are pinned "
        "self-contained snapshots named savepoint-<pos> that pruning and "
        "GC never touch",
    12: "incremental chunked snapshots — the .npz may be a MANIFEST whose "
        "meta lists per-leaf chunk references (sha256 over dtype/shape/"
        "bytes) into chunks/<hash>.npy instead of carrying inline L-"
        "arrays; unchanged leaves re-use chunks written by earlier "
        "snapshots, so a v12 manifest is only restorable next to its "
        "chunk store (self-contained inline snapshots remain valid v12)",
}
FORMAT_VERSION = max(MIGRATIONS)
_META_KEY = "__meta__"
CHUNK_DIR = "chunks"
GC_MARK = "gc-mark.json"
#: chunk files are content-named — GC refuses to touch anything else
_CHUNK_RE = re.compile(r"^[0-9a-f]{64}\.npy$")


def _checksum(leaves: List[np.ndarray]) -> int:
    """CRC32 chained over every leaf's dtype/shape/bytes — cheap enough
    to run on each save, strong enough to catch the torn/overwritten
    payloads a crashed writer or bad disk leaves behind."""
    import zlib

    c = 0
    for l in leaves:
        a = np.ascontiguousarray(l)
        c = zlib.crc32(str((a.dtype.str, a.shape)).encode(), c)
        c = zlib.crc32(a.tobytes(), c)
    return c & 0xFFFFFFFF


def _leaf_hash(a: np.ndarray) -> str:
    """Content hash of one leaf — sha256 over dtype/shape/bytes (the
    ledger's digest idiom). Names the leaf's chunk file: equal content
    means equal name means the chunk is written once, ever. The shape
    hashes BEFORE the contiguous copy (ascontiguousarray promotes 0-d
    to 1-d, which would alias scalar and one-element leaves)."""
    a = np.asarray(a)
    h = hashlib.sha256()
    h.update(str((a.dtype.str, tuple(a.shape))).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _leaves(state) -> List[np.ndarray]:
    """Every leaf of a state in the reference layout (a stage's
    ``state_to_jax_numpy`` dict, or a list of them for a chain), in the
    reference's pytree order, as host arrays. The conversion already
    copied them off the device, so they are owned and immutable."""
    return [np.asarray(l) for l in tree_leaves(state)]


@dataclass
class Checkpoint:
    """A loaded checkpoint: device-state leaves + host-side metadata."""

    leaves: List[np.ndarray]
    record_kinds: List[str]
    tables: List[Optional[dict]]     # StringTable.state_dict() per column
    source_pos: int                  # lines consumed from the source
    proc_now: int                    # virtual processing-time clock (ms)
    emitted: int                     # records emitted before this snapshot
    batches: int
    job_name: Optional[str] = None
    parallelism: int = 1             # shards at snapshot time
    # per lazily-built chain stage (in chain order): the record schema a
    # process()-fed downstream had inferred from collected rows at
    # snapshot time — {"kinds": [...], "tables": [state_dict|None]}.
    # A restored run rebuilds those stages eagerly from this instead of
    # waiting for (already-consumed) rows to re-infer from.
    lazy_schemas: Optional[list] = None
    # per built chain stage: the key capacity the stage was running at —
    # dynamic growth may have doubled it past StreamConfig.key_capacity,
    # and the restored runners must be rebuilt to match before their
    # state leaves place
    key_capacities: Optional[list] = None
    # per built chain stage: the DerivedKeyTable state of a
    # computed-KeySelector stage (None elsewhere). Chain-stage key
    # tables are built at runtime, so without this a resumed run would
    # re-intern only post-snapshot keys and mis-map saved state rows.
    chain_key_tables: Optional[list] = None
    # absolute collect-sink lengths at snapshot time, in sink-node
    # order (None per non-collect sink): a supervised in-process
    # restart truncates each handle back to these before replaying, so
    # the recovered output is byte-identical to an uninterrupted run
    sink_counts: Optional[list] = None
    # dead-letter records quarantined before this snapshot (same
    # rollback, for env.dead_letters)
    quarantined: int = 0
    # nonce of the supervision session that wrote the snapshot; the
    # rollback above only applies when it matches the restoring
    # session (a pre-session snapshot predates this process's output)
    session: Optional[str] = None
    # dynamic rules (tpustream/broadcast): the host RuleSet's values
    # and applied-update count at snapshot time. The device rule leaves
    # restore with the state pytree; these re-sync the HOST set so the
    # control feed skips exactly the already-applied schedule prefix.
    rule_values: Optional[dict] = None
    rule_version: int = 0
    # multi-tenancy (tpustream/tenancy): the JobServer's host-side
    # fleet state at snapshot time — tenant→slot map, per-tenant
    # admitted/quota-rejected counters, slot capacity. The per-tenant
    # rule VECTORS ride rule_values["__tenant__"] above.
    tenancy: Optional[dict] = None
    # sharded ingestion (runtime/ingest.py): the per-lane frame cursor
    # at snapshot time — {lanes, merged_frames, lane_frames,
    # host_frames}. Informational: exactly-once replay is carried by
    # source_pos (frames past the merge are in it, frames still in a
    # lane ring are not), so restore never consumes this; recovery
    # tests assert against it. Optional key — older snapshots load as
    # None, no format bump.
    ingest: Optional[dict] = None
    # conservation ledger (obs/ledger.py): per-sink output anchors
    # {sink: {count, digest, verifiable}} at snapshot time, None when
    # the ledger is off. A supervised restore re-derives and verifies
    # them over the truncated sinks; replay never consumes them (output
    # bytes are governed by sink_counts truncation). Optional key, no
    # format bump.
    ledger: Optional[dict] = None

    def restore_chain(self, programs, key_capacities=None):
        """Restore a runner CHAIN's states: the snapshot's leaf list is
        the concatenation of each stage's state leaves (saved as a list
        pytree), split here by each program's own leaf count, read from
        its leaf spec at the stage's saved key capacity."""
        caps = list(key_capacities or [])
        states = []
        offset = 0
        for i, prog in enumerate(programs):
            spec = prog.jax_state_spec(caps[i] if i < len(caps) else None)
            n = len(tree_leaves(spec))
            if offset + n <= len(self.leaves):
                states.append(
                    self._place(prog, self.leaves[offset : offset + n], spec))
            offset += n
        if offset != len(self.leaves):
            raise ValueError(
                f"checkpoint has {len(self.leaves)} state arrays but the "
                f"{len(programs)}-stage chain expects {offset} — job graph "
                "or config changed since the snapshot"
            )
        return states

    def restore_state(self, program, key_capacity: Optional[int] = None):
        """Place the saved leaves onto ``program``'s device.

        The program's leaf spec at ``key_capacity`` (shapes and dtypes
        of the reference layout, no tensors) gives the target structure;
        a config or job-graph mismatch surfaces as an error here rather
        than as silent corruption later."""
        spec = program.jax_state_spec(key_capacity)
        n = len(tree_leaves(spec))
        if n != len(self.leaves):
            raise ValueError(
                f"checkpoint has {len(self.leaves)} state arrays but the "
                f"program expects {n} — job graph or config "
                "changed since the snapshot"
            )
        return self._place(program, self.leaves, spec)

    def _place(self, program, saved, spec):
        for s, like in zip(saved, tree_leaves(spec)):
            if tuple(s.shape) != tuple(like.shape) or s.dtype != like.dtype:
                raise ValueError(
                    f"checkpoint leaf {s.shape}/{s.dtype} does not "
                    f"match program state {like.shape}/{like.dtype} — "
                    "key_capacity / batch_size / window config changed"
                )
        # the key layout is shard-major (row shard*k_local+r holds global
        # key r*S+shard), so a snapshot written at another parallelism has
        # the same shapes and another layout: each key-sharded leaf is
        # permuted through the canonical key-major order onto this
        # program's (Flink savepoints restore at any parallelism)
        if max(1, self.parallelism) != max(1, program.n_shards):
            sharded = tree_leaves(program.key_sharded_leaves(spec))
            saved = [program.rescale_key_leaf(np.asarray(s), self.parallelism)
                     if k else s for s, k in zip(saved, sharded)]
        return program.state_from_jax_numpy(tree_unflatten(spec, list(saved)))

    def restore_tables(self, plan) -> None:
        """Restore string-intern tables (and record kinds for adaptive
        parse plans) so interned key ids keep their dense-slot meaning."""
        from ..records import STR, DerivedKeyTable, StringTable

        if not plan.record_kinds:
            plan.record_kinds.extend(self.record_kinds)
            last = len(self.record_kinds) - 1
            plan.tables.extend(
                # a computed-KeySelector plan's trailing synthetic
                # column must come back as a DerivedKeyTable (its
                # lookup returns original values, and the host re-runs
                # intern_values on it)
                (
                    DerivedKeyTable()
                    if plan.synthetic_key and i == last
                    else StringTable()
                )
                if k == STR
                else None
                for i, k in enumerate(self.record_kinds)
            )
        elif list(plan.record_kinds) != list(self.record_kinds):
            raise ValueError(
                f"checkpoint record kinds {self.record_kinds} != plan "
                f"record kinds {plan.record_kinds}"
            )
        for table, saved in zip(plan.tables, self.tables):
            if table is not None and saved is not None:
                table.load_state_dict(saved)


# ---------------------------------------------------------------------------
# Capture (barrier-side) / write (writer-side) split
# ---------------------------------------------------------------------------
@dataclass
class PendingSnapshot:
    """A consistent cut captured at the barrier, awaiting write. Leaves
    are host buffers; meta is fully built AT THE CUT (sink counts and
    ledger anchors reflect the barrier, not write completion)."""

    leaves: List[np.ndarray]
    meta: dict
    source_pos: int
    batches: int


def capture_checkpoint(
    *,
    state,
    plan,
    source_pos: int,
    proc_now: int,
    emitted: int,
    batches: int,
    job_name: Optional[str] = None,
    parallelism: int = 1,
    lazy_schemas: Optional[list] = None,
    key_capacities: Optional[list] = None,
    chain_key_tables: Optional[list] = None,
    sink_counts: Optional[list] = None,
    quarantined: int = 0,
    session: Optional[str] = None,
    rule_values: Optional[dict] = None,
    rule_version: int = 0,
    tenancy: Optional[dict] = None,
    ingest: Optional[dict] = None,
    ledger: Optional[dict] = None,
) -> PendingSnapshot:
    """The cheap barrier-side half of a snapshot: ``state`` is already
    in the reference layout on the host (each stage's
    ``state_to_jax_numpy``); this freezes its leaves and the meta dict.
    ``ledger``: the conservation ledger's per-sink anchors at the
    barrier (None when the ledger is off)."""
    leaves = _leaves(state)
    meta = {
        "version": FORMAT_VERSION,
        "kind": "checkpoint",
        "record_kinds": list(plan.record_kinds),
        "tables": [
            t.state_dict() if t is not None else None for t in plan.tables
        ],
        "source_pos": int(source_pos),
        "proc_now": int(proc_now),
        "emitted": int(emitted),
        "batches": int(batches),
        "job_name": job_name,
        "parallelism": int(parallelism),
        "lazy_schemas": lazy_schemas or [],
        "key_capacities": list(key_capacities or []),
        "chain_key_tables": list(chain_key_tables or []),
        "sink_counts": list(sink_counts) if sink_counts is not None else None,
        "quarantined": int(quarantined),
        "session": session,
        "rule_values": rule_values,
        "rule_version": int(rule_version),
        "tenancy": tenancy,
        "ingest": ingest,
        "ledger": ledger,
        "checksum": _checksum(leaves),
    }
    return PendingSnapshot(
        leaves=leaves, meta=meta, source_pos=int(source_pos),
        batches=int(batches),
    )


def _atomic_write(directory: str, path: str, write_fn) -> None:
    """Write-to-.tmp + ``os.replace``: a crash mid-write leaves only
    ``.tmp`` debris that every reader here already skips."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_meta(path: str) -> dict:
    """Meta dict of one snapshot without touching its leaf payload
    (npz members decompress lazily — only ``__meta__`` is read)."""
    with np.load(path) as z:
        return json.loads(bytes(z[_META_KEY]).decode())


def _snapshot_names(directory: str) -> List[str]:
    return sorted(
        n for n in os.listdir(directory)
        if n.startswith("ckpt-") and n.endswith(".npz")
    )


def _savepoint_names(directory: str) -> List[str]:
    return sorted(
        n for n in os.listdir(directory)
        if n.startswith("savepoint-") and n.endswith(".npz")
    )


def _marker_target(directory: str) -> Optional[str]:
    marker = os.path.join(directory, "latest")
    if not os.path.exists(marker):
        return None
    try:
        with open(marker) as f:
            name = f.read().strip()
        return name or None
    except OSError:
        return None


def _next_seq(directory: str) -> int:
    """1 + the highest ``seq`` any existing snapshot recorded. Manifests
    carry the ordinal because filenames are source positions: "every
    Mth snapshot is durable" must count snapshots, not lines."""
    top = 0
    for n in _snapshot_names(directory) + _savepoint_names(directory):
        try:
            top = max(top, int(_read_meta(os.path.join(directory, n)).get("seq", 0)))
        except Exception:
            continue  # partial/foreign files never block a save
    return top + 1


def write_snapshot(
    directory: str,
    pending: PendingSnapshot,
    *,
    keep: int = 3,
    keep_every: int = 0,
    incremental: bool = True,
    fault: Optional[Callable[[str], None]] = None,
) -> dict:
    """The writer-side half: encode ``pending`` into
    ``directory/ckpt-<source_pos>.npz`` (atomic), refresh the ``latest``
    marker, apply the retention policy, and GC unreferenced chunks.
    Returns a report dict (bytes written/reused, prune/GC counts) for
    the metrics plane. Runs on the CheckpointPlane's writer thread in
    async mode, or inline in sync mode — same code either way.

    ``incremental=True`` writes a MANIFEST: per-leaf chunk files named
    by content hash under ``chunks/``; a leaf whose hash matches a chunk
    an earlier snapshot wrote is referenced, not rewritten. ``False``
    writes a self-contained inline snapshot (savepoint-style payload
    under a ckpt- name)."""
    os.makedirs(directory, exist_ok=True)
    meta = dict(pending.meta)
    seq = _next_seq(directory)
    meta["seq"] = seq
    meta["durable"] = bool(keep_every > 0 and seq % keep_every == 0)
    name = f"ckpt-{pending.source_pos:010d}.npz"
    path = os.path.join(directory, name)
    report = {
        "path": path,
        "kind": "checkpoint",
        "seq": seq,
        "source_pos": pending.source_pos,
        "batches": pending.batches,
        "bytes_total": 0,
        "bytes_delta": 0,
        "chunks_written": 0,
        "chunks_reused": 0,
        "gc_deleted": 0,
    }
    if incremental:
        cdir = os.path.join(directory, CHUNK_DIR)
        os.makedirs(cdir, exist_ok=True)
        refs = []
        for i, leaf in enumerate(pending.leaves):
            a = np.asarray(leaf)
            h = _leaf_hash(a)
            cpath = os.path.join(cdir, f"{h}.npy")
            if os.path.exists(cpath):
                report["chunks_reused"] += 1
            else:
                _atomic_write(cdir, cpath, lambda f, a=a: np.save(f, a))
                report["chunks_written"] += 1
                report["bytes_delta"] += os.path.getsize(cpath)
            report["bytes_total"] += os.path.getsize(cpath)
            refs.append({
                "chunk": h,
                "dtype": a.dtype.str,
                "shape": list(a.shape),
                "nbytes": int(a.nbytes),
            })
            if i == 0 and fault is not None:
                # writer-thread crash mid-chunk-write: some chunks on
                # disk, no manifest referencing them (GC debris), the
                # latest marker still naming the previous snapshot
                fault("checkpoint_write")
        meta["chunks"] = refs
        _atomic_write(
            directory, path,
            lambda f: np.savez(f, **{_META_KEY: np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)}),
        )
        manifest_bytes = os.path.getsize(path)
        report["bytes_total"] += manifest_bytes
        report["bytes_delta"] += manifest_bytes
    else:
        if fault is not None:
            fault("checkpoint_write")
        arrays = {f"L{i:04d}": l for i, l in enumerate(pending.leaves)}
        _atomic_write(
            directory, path,
            lambda f: np.savez(f, **arrays, **{_META_KEY: np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)}),
        )
        report["bytes_total"] = report["bytes_delta"] = os.path.getsize(path)
    with open(os.path.join(directory, "latest.tmp"), "w") as f:
        f.write(name)
    os.replace(
        os.path.join(directory, "latest.tmp"), os.path.join(directory, "latest")
    )
    report["pruned"] = _prune(directory, keep)
    report["gc_deleted"] = _gc_chunks(directory, fault=fault)
    return report


def save_savepoint(
    directory: str, pending: PendingSnapshot, tag: Optional[str] = None
) -> str:
    """Write a pinned, self-contained snapshot:
    ``savepoint-<source_pos>[-<tag>].npz``. Savepoints carry their full
    payload inline (restorable away from the chunk store — the
    rescale/migration artifact), are never named by the ``latest``
    marker, and are exempt from pruning and GC by name. Under several
    processes only the coordinator writes (snapshots live on storage
    the processes share); the others return the path."""
    suffix = f"-{re.sub(r'[^A-Za-z0-9_.-]', '_', str(tag))}" if tag else ""
    name = f"savepoint-{pending.source_pos:010d}{suffix}.npz"
    path = os.path.join(directory, name)
    if not _writes():
        return path
    os.makedirs(directory, exist_ok=True)
    meta = dict(pending.meta)
    meta["kind"] = "savepoint"
    meta["seq"] = _next_seq(directory)
    meta["durable"] = True
    if tag is not None:
        meta["tag"] = str(tag)
    arrays = {f"L{i:04d}": l for i, l in enumerate(pending.leaves)}
    _atomic_write(
        directory, path,
        lambda f: np.savez(f, **arrays, **{_META_KEY: np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)}),
    )
    return path


def _writes() -> bool:
    """Whether this process writes snapshots: the only process, or the
    coordinator of several (tpustream/runtime/checkpoint.py:622,761)."""
    from ..parallel.distributed import process_index

    return process_index() == 0


def _prune(directory: str, keep: int) -> int:
    """Retention policy: keep the ``keep`` newest snapshots, every
    snapshot whose meta says ``durable`` (the keep_every tier), and —
    the marker-race fix — whatever ``latest`` currently names. A file
    whose meta cannot be read is retained (never delete what we cannot
    identify). Savepoints live under savepoint-* names and are not
    candidates at all."""
    names = _snapshot_names(directory)
    keep = max(0, int(keep))
    retained = set(names[-keep:]) if keep else set()
    target = _marker_target(directory)
    if target is not None:
        retained.add(target)
    pruned = 0
    for n in names:
        if n in retained:
            continue
        try:
            meta = _read_meta(os.path.join(directory, n))
        except Exception:
            continue
        if meta.get("durable") or meta.get("kind") == "savepoint":
            continue
        os.unlink(os.path.join(directory, n))
        pruned += 1
    return pruned


def _referenced_chunks(directory: str) -> set:
    """Union of chunk hashes referenced by every snapshot and savepoint
    still on disk. Unreadable files contribute nothing — but they also
    cannot resurrect chunks, which is why GC only ever deletes content-
    named files no retained manifest mentions."""
    refs = set()
    for n in _snapshot_names(directory) + _savepoint_names(directory):
        try:
            meta = _read_meta(os.path.join(directory, n))
        except Exception:
            continue
        for r in meta.get("chunks") or []:
            refs.add(r.get("chunk"))
    return refs


def _gc_chunks(directory: str, fault: Optional[Callable] = None) -> int:
    """Delete chunks no retained manifest references. Crash-safe: the
    doomed list is recorded in ``chunks/gc-mark.json`` (atomic) BEFORE
    the unlink sweep; a sweep interrupted mid-way leaves the mark, and
    the next GC re-verifies the marked names against the current
    reference set and finishes the job. Only content-named files
    (64-hex ``.npy``) are ever candidates — foreign or unparseable
    files are never touched."""
    cdir = os.path.join(directory, CHUNK_DIR)
    if not os.path.isdir(cdir):
        return 0
    referenced = _referenced_chunks(directory)
    mark_path = os.path.join(cdir, GC_MARK)
    doomed = sorted(
        n for n in os.listdir(cdir)
        if _CHUNK_RE.match(n) and n[:-4] not in referenced
    )
    if not doomed:
        if os.path.exists(mark_path):
            os.unlink(mark_path)  # stale mark from a finished sweep
        return 0
    _atomic_write(
        cdir, mark_path,
        lambda f: f.write(json.dumps({"doomed": doomed}).encode()),
    )
    if fault is not None:
        # crash between GC mark and sweep: chunks still on disk, mark
        # present — the next GC resumes from the re-verified mark
        fault("checkpoint_gc")
    deleted = 0
    for n in doomed:
        try:
            os.unlink(os.path.join(cdir, n))
            deleted += 1
        except FileNotFoundError:
            pass
    os.unlink(mark_path)
    return deleted


def save_checkpoint(
    directory: str,
    *,
    state,
    plan,
    source_pos: int,
    proc_now: int,
    emitted: int,
    batches: int,
    job_name: Optional[str] = None,
    parallelism: int = 1,
    keep: int = 3,
    keep_every: int = 0,
    incremental: bool = True,
    fault: Optional[Callable[[str], None]] = None,
    lazy_schemas: Optional[list] = None,
    key_capacities: Optional[list] = None,
    chain_key_tables: Optional[list] = None,
    sink_counts: Optional[list] = None,
    quarantined: int = 0,
    session: Optional[str] = None,
    rule_values: Optional[dict] = None,
    rule_version: int = 0,
    tenancy: Optional[dict] = None,
    ingest: Optional[dict] = None,
    ledger: Optional[dict] = None,
) -> str:
    """Synchronous capture + write in one call (the pre-async surface,
    kept for direct callers and tests): snapshot to
    ``directory/ckpt-<source_pos>.npz``, refresh ``latest``, prune, GC.
    Named by source position because restart attempts reset the batch
    counter: the name order must stay monotone with stream progress
    across attempts so pruning and the sorted-glob fallback never prefer
    a stale snapshot. A re-save at the same position (processing-time
    advancement without new lines) atomically replaces the older file."""
    pending = capture_checkpoint(
        state=state, plan=plan, source_pos=source_pos, proc_now=proc_now,
        emitted=emitted, batches=batches, job_name=job_name,
        parallelism=parallelism, lazy_schemas=lazy_schemas,
        key_capacities=key_capacities, chain_key_tables=chain_key_tables,
        sink_counts=sink_counts, quarantined=quarantined, session=session,
        rule_values=rule_values, rule_version=rule_version, tenancy=tenancy,
        ingest=ingest, ledger=ledger,
    )
    if not _writes():
        # the capture's gathers were collective; the coordinator writes
        return os.path.join(directory, f"ckpt-{int(source_pos):010d}.npz")
    report = write_snapshot(
        directory, pending, keep=keep, keep_every=keep_every,
        incremental=incremental, fault=fault,
    )
    return report["path"]


# ---------------------------------------------------------------------------
# CheckpointPlane: the single background writer thread
# ---------------------------------------------------------------------------
class CheckpointPlane:
    """Asynchronous snapshot writer (Flink's async barrier
    snapshotting): the executor captures a cut on the hot path and
    ``submit``\\ s it here; one daemon thread runs ``write_snapshot``
    off the critical path. The in-flight budget bounds memory — a
    barrier arriving while the queue is full WAITS (time returned to
    the caller, surfaced as barrier stall). A writer-thread failure is
    re-raised on the submitting thread at the next submit/flush with
    the ORIGINAL exception object, so fault attribution
    (``FaultInjected.point``) survives the thread hop."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        keep_every: int = 0,
        inflight: int = 1,
        incremental: bool = True,
        fault: Optional[Callable[[str], None]] = None,
    ):
        self.directory = directory
        self._keep = keep
        self._keep_every = keep_every
        self._budget = max(1, int(inflight))
        self._incremental = incremental
        self._fault = fault
        self._q: deque = deque()
        self._reports: deque = deque()
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None
        self._closed = False
        self.stalls = 0  # barriers that waited on the in-flight budget
        self._thread = threading.Thread(
            target=self._worker, name="tpustream-ckpt-writer", daemon=True
        )
        self._thread.start()

    def _raise_if_failed(self):
        if self._error is not None:
            raise self._error

    def submit(self, pending: PendingSnapshot) -> float:
        """Queue one captured cut; returns seconds spent waiting on the
        in-flight budget (0.0 when a writer slot was free)."""
        waited = 0.0
        with self._cv:
            self._raise_if_failed()
            if len(self._q) >= self._budget:
                self.stalls += 1
                t0 = time.perf_counter()
                while len(self._q) >= self._budget and self._error is None:
                    self._cv.wait()
                waited = time.perf_counter() - t0
                self._raise_if_failed()
            self._q.append(pending)
            self._cv.notify_all()
        return waited

    def inflight(self) -> int:
        with self._cv:
            return len(self._q)

    def drain_reports(self) -> List[dict]:
        """Write reports completed since the last drain (main thread
        turns these into metrics/flight events)."""
        with self._cv:
            out = list(self._reports)
            self._reports.clear()
        return out

    def flush(self) -> None:
        """Block until every queued write has landed; re-raises a writer
        failure (the EOS path calls this so a fault with no later
        barrier still surfaces)."""
        with self._cv:
            while self._q and self._error is None:
                self._cv.wait()
            self._raise_if_failed()

    def close(self, raise_error: bool = True) -> None:
        """Drain the queue, stop the writer. ``raise_error=False`` on
        the failure-cleanup path: the original failure is what
        propagates, not the writer's."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
        if raise_error and self._error is not None:
            raise self._error

    def _worker(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return  # closed and drained
                pending = self._q[0]  # stays queued while writing:
                # inflight() counts it and submit's budget check sees it
            t0 = time.perf_counter()
            try:
                report = write_snapshot(
                    self.directory, pending, keep=self._keep,
                    keep_every=self._keep_every,
                    incremental=self._incremental, fault=self._fault,
                )
                report["write_wall_ms"] = (time.perf_counter() - t0) * 1000.0
                with self._cv:
                    self._q.popleft()
                    self._reports.append(report)
                    self._cv.notify_all()
            except BaseException as e:
                with self._cv:
                    self._q.popleft()
                    self._error = e
                    self._cv.notify_all()
                return


# ---------------------------------------------------------------------------
# Validation / discovery / load
# ---------------------------------------------------------------------------
def validate_checkpoint(path: str) -> Optional[str]:
    """Full validation: returns None when ``path`` is a loadable
    snapshot of this build's format, else a reason string (partial
    write, corrupt payload, version mismatch, unreadable). For a
    chunked manifest this WALKS THE CHUNK CHAIN: every referenced chunk
    must exist, match its recorded dtype/shape, and re-hash to its
    content name — a bit-flipped or half-GC'd chain fails here."""
    try:
        meta = _read_meta(path)
    except KeyError:
        return "no metadata (partial or foreign file)"
    except Exception as e:
        return f"unreadable ({type(e).__name__}: {e})"
    if meta.get("version") != FORMAT_VERSION:
        return (
            f"format version {meta.get('version')} != this build's "
            f"{FORMAT_VERSION}"
        )
    chunks = meta.get("chunks")
    if chunks is not None:
        cdir = os.path.join(os.path.dirname(os.path.abspath(path)), CHUNK_DIR)
        for ref in chunks:
            h = ref.get("chunk")
            cpath = os.path.join(cdir, f"{h}.npy")
            if not os.path.exists(cpath):
                return f"missing chunk {h[:12]}… (half-completed GC or lost file)"
            try:
                a = np.load(cpath)
            except Exception as e:
                return f"chunk {h[:12]}… unreadable ({type(e).__name__})"
            if (
                a.dtype.str != ref.get("dtype")
                or list(a.shape) != list(ref.get("shape"))
                or _leaf_hash(a) != h
            ):
                return f"chunk {h[:12]}… checksum mismatch (corrupt)"
        return None
    try:
        _, leaves = _read_npz(path)
    except Exception as e:
        return f"unreadable ({type(e).__name__}: {e})"
    saved = meta.get("checksum")
    if saved is not None and _checksum(leaves) != saved:
        return "payload checksum mismatch (corrupt)"
    return None


def latest_checkpoint(directory: str, flight=None, audit=None) -> Optional[str]:
    """Newest VALID snapshot in ``directory`` (the ``latest`` marker's
    target first, then the remaining snapshots newest-first). Partial,
    corrupt, version-incompatible, or chunk-chain-broken files are
    skipped — with a ``checkpoint_skipped`` flight breadcrumb when a
    recorder is passed — instead of being handed to the supervisor as
    an unloadable path. Savepoints are pinned artifacts, not recovery
    candidates: restore one explicitly via
    ``env.restore_from_checkpoint(path)``.

    ``audit`` (optional): a ``path -> Optional[str]`` callable consulted
    AFTER basic validation passes, returning a reason string when the
    snapshot cannot restore into the current job graph; None lets the
    snapshot through. The supervisor passes its ``_layout_audit``."""
    if not os.path.isdir(directory):
        return None
    candidates: List[str] = []
    marker = _marker_target(directory)
    if marker is not None:
        candidates.append(marker)
    for n in _snapshot_names(directory)[::-1]:
        if n not in candidates:
            candidates.append(n)
    for name in candidates:
        p = os.path.join(directory, name)
        reason = (
            "missing" if not os.path.exists(p) else validate_checkpoint(p)
        )
        if reason is None and audit is not None:
            audit_reason = audit(p)
            if audit_reason is not None:
                reason = f"audit: {audit_reason}"
        if reason is None:
            return p
        if flight is not None:
            flight.record("checkpoint_skipped", path=p, reason=reason)
    return None


def _read_npz(path: str):
    """Meta + leaves of one snapshot, assembling a chunked manifest's
    leaves from its chunk store (the directory next to the manifest)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        names = sorted(k for k in z.files if k.startswith("L"))
        leaves = [z[k] for k in names]
    chunks = meta.get("chunks")
    if chunks is not None:
        cdir = os.path.join(os.path.dirname(os.path.abspath(path)), CHUNK_DIR)
        leaves = []
        for ref in chunks:
            cpath = os.path.join(cdir, f"{ref['chunk']}.npy")
            if not os.path.exists(cpath):
                raise FileNotFoundError(
                    f"checkpoint {path} references missing chunk "
                    f"{ref['chunk'][:12]}… — half-completed GC or a manifest "
                    "copied away from its chunk store (use a savepoint for "
                    "portable snapshots)"
                )
            leaves.append(np.load(cpath))
    return meta, leaves


def load_checkpoint(path: str) -> Checkpoint:
    """Load an ``.npz`` snapshot (or the latest valid one in a
    directory). Raises ValueError on a version mismatch or a payload
    that fails its recorded checksum."""
    if os.path.isdir(path):
        p = latest_checkpoint(path)
        if p is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        path = p
    meta, leaves = _read_npz(path)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format version {meta.get('version')} does not "
            f"match this build's {FORMAT_VERSION} — the snapshot was "
            "written by a different tpustream version; restart the job "
            "from the source instead of resuming"
        )
    saved_crc = meta.get("checksum")
    if saved_crc is not None and _checksum(leaves) != saved_crc:
        raise ValueError(
            f"checkpoint {path} is corrupt: payload checksum "
            f"{_checksum(leaves):#010x} does not match the recorded "
            f"{saved_crc:#010x} — the file was truncated or modified "
            "after writing; pick an older snapshot (latest_checkpoint "
            "skips corrupt files automatically)"
        )
    return Checkpoint(
        leaves=leaves,
        record_kinds=meta["record_kinds"],
        tables=meta["tables"],
        source_pos=meta["source_pos"],
        proc_now=meta["proc_now"],
        emitted=meta["emitted"],
        batches=meta["batches"],
        job_name=meta.get("job_name"),
        parallelism=meta.get("parallelism", 1),
        lazy_schemas=meta.get("lazy_schemas", []),
        key_capacities=meta.get("key_capacities", []),
        chain_key_tables=meta.get("chain_key_tables", []),
        sink_counts=meta.get("sink_counts"),
        quarantined=meta.get("quarantined", 0),
        session=meta.get("session"),
        rule_values=meta.get("rule_values"),
        rule_version=meta.get("rule_version", 0),
        tenancy=meta.get("tenancy"),
        ingest=meta.get("ingest"),
        ledger=meta.get("ledger"),
    )


# ---------------------------------------------------------------------------
# Restore drills: prove the snapshot restorable BEFORE a crash needs it
# ---------------------------------------------------------------------------
def restore_drill(
    directory: str,
    *,
    audit: Optional[Callable[[str], Optional[str]]] = None,
    verify_anchors: Optional[Callable[[Optional[dict]], Optional[str]]] = None,
) -> dict:
    """Dry-restore the NOMINAL newest snapshot (the ``latest`` marker's
    target, else newest by name) in-process: format/chunk-chain walk
    (``validate_checkpoint``), optional layout audit, optional
    ledger digest-anchor re-derivation. Deliberately NO fallback to an
    older snapshot — the drill's job is to flag that the snapshot a
    crash would want first has rotted, while ``latest_checkpoint``
    separately falls back at real recovery time.

    Returns ``{"ok": bool|None, "path": ..., "reason": ...}`` — ``ok``
    is None when there is nothing to drill yet."""
    name = _marker_target(directory) if os.path.isdir(directory) else None
    if name is None or not os.path.exists(os.path.join(directory, name)):
        names = _snapshot_names(directory) if os.path.isdir(directory) else []
        name = names[-1] if names else None
    if name is None:
        return {"ok": None, "path": None, "reason": "no snapshots yet"}
    path = os.path.join(directory, name)
    reason = validate_checkpoint(path)
    if reason is None and audit is not None:
        audit_reason = audit(path)
        if audit_reason is not None:
            reason = f"audit: {audit_reason}"
    if reason is None and verify_anchors is not None:
        try:
            anchor_reason = verify_anchors(_read_meta(path).get("ledger"))
        except Exception as e:
            anchor_reason = f"{type(e).__name__}: {e}"
        if anchor_reason is not None:
            reason = f"ledger anchors: {anchor_reason}"
    return {"ok": reason is None, "path": path, "reason": reason}
