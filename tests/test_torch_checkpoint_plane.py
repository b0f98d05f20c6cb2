"""The checkpoint plane through the PyTorch port, on the CPU: the cases
of tests/test_checkpoint_plane.py, the savepoint restored at another
parallelism among them: incremental chunked snapshots, tiered retention + crash-safe chunk GC,
pinned savepoints, restore drills, and writer/GC fault recovery.

The unit half drives ``write_snapshot`` directly with hand-built
``PendingSnapshot`` cuts (no device needed), pinning the byte-level
contracts; the job half runs supervised chapter-2 jobs through the
port's executor (``device="cpu"``), the conservation ledger's digest
anchors verified after a restore among them.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from tpustream_torch import StreamExecutionEnvironment
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.runtime.checkpoint import (
    CHUNK_DIR,
    FORMAT_VERSION,
    GC_MARK,
    PendingSnapshot,
    _checksum,
    _prune,
    _read_meta,
    _read_npz,
    latest_checkpoint,
    load_checkpoint,
    restore_drill,
    validate_checkpoint,
    write_snapshot,
)
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.supervisor import fixed_delay
from tpustream_torch.testing import FaultInjected, FaultInjector, FaultPoint

LINES = [
    f"15634520{i % 60:02d} 10.8.22.{i % 5} cpu{i % 3} {(i * 13) % 100}.5"
    for i in range(16)
]


# ---------------------------------------------------------------------------
# unit half: hand-built cuts through write_snapshot
# ---------------------------------------------------------------------------
def make_pending(leaves, source_pos, batches=1):
    """A minimal-but-valid cut: real leaves, the meta fields the writer
    and validators actually read."""
    leaves = [np.asarray(l) for l in leaves]
    return PendingSnapshot(
        leaves=leaves,
        meta={
            "version": FORMAT_VERSION,
            "kind": "checkpoint",
            "checksum": _checksum(leaves),
        },
        source_pos=source_pos,
        batches=batches,
    )


def base_leaves(n=8, size=1024, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size, dtype=np.int32) for _ in range(n)]


def chunk_files(directory):
    cdir = os.path.join(directory, CHUNK_DIR)
    if not os.path.isdir(cdir):
        return set()
    return {n for n in os.listdir(cdir) if n.endswith(".npy")}


def manifest_refs(path):
    return {r["chunk"] for r in _read_meta(path).get("chunks") or []}


def test_incremental_delta_scales_with_churn(tmp_path):
    """Churning 1 of 8 equal-size leaves between snapshots must ship
    roughly 1/8th of the state — the incremental contract. The bound is
    25% (the manifest and atomic-write overhead ride on top of the one
    rewritten chunk, never on the seven stable ones)."""
    d = str(tmp_path)
    leaves = base_leaves()
    r1 = write_snapshot(d, make_pending(leaves, 2), keep=5)
    assert r1["chunks_written"] == 8 and r1["chunks_reused"] == 0
    assert r1["bytes_delta"] == r1["bytes_total"]

    leaves[3] = leaves[3] + 1
    r2 = write_snapshot(d, make_pending(leaves, 4), keep=5)
    assert r2["chunks_written"] == 1 and r2["chunks_reused"] == 7
    assert r2["bytes_delta"] <= 0.25 * r2["bytes_total"]
    # both snapshots restore their exact leaves next to the shared store
    for pos, want in ((2, base_leaves()), (4, leaves)):
        _, got = _read_npz(os.path.join(d, f"ckpt-{pos:010d}.npz"))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_unchanged_state_reuses_every_chunk(tmp_path):
    """A fully stable cut writes only the manifest: every leaf chunk is
    referenced from the first snapshot's store."""
    d = str(tmp_path)
    leaves = base_leaves()
    write_snapshot(d, make_pending(leaves, 2), keep=5)
    before = chunk_files(d)
    r = write_snapshot(d, make_pending(leaves, 4), keep=5)
    assert r["chunks_written"] == 0 and r["chunks_reused"] == 8
    assert chunk_files(d) == before
    manifest = os.path.getsize(os.path.join(d, "ckpt-0000000004.npz"))
    assert r["bytes_delta"] == manifest


def test_gc_deletes_only_unreferenced_chunks(tmp_path):
    """Pruning a snapshot orphans its unique chunks; the next write's GC
    deletes exactly those — never a still-referenced chunk, never a
    foreign (non-content-named) file — and clears its mark."""
    d = str(tmp_path)
    leaves = base_leaves()
    write_snapshot(d, make_pending(leaves, 2), keep=1)
    doomed = manifest_refs(os.path.join(d, "ckpt-0000000002.npz"))
    cdir = os.path.join(d, CHUNK_DIR)
    with open(os.path.join(cdir, "operator-notes.txt"), "w") as f:
        f.write("not a chunk\n")

    # all-new leaves: keep=1 prunes snapshot 2, orphaning all its chunks
    fresh = [l + 100 for l in leaves]
    r = write_snapshot(d, make_pending(fresh, 4), keep=1)
    assert r["pruned"] == 1
    assert r["gc_deleted"] == len(doomed)
    survivors = chunk_files(d)
    assert not any(f"{h}.npy" in survivors for h in doomed)
    assert manifest_refs(os.path.join(d, "ckpt-0000000004.npz")) == {
        n[:-4] for n in survivors
    }
    assert os.path.exists(os.path.join(cdir, "operator-notes.txt"))
    assert not os.path.exists(os.path.join(cdir, GC_MARK))
    assert validate_checkpoint(os.path.join(d, "ckpt-0000000004.npz")) is None


def test_gc_crash_between_mark_and_sweep_resumes(tmp_path):
    """A crash after the GC mark lands but before the unlink sweep
    leaves the doomed chunks on disk and the mark present; the next
    write's GC re-verifies the mark and finishes — no retained snapshot
    loses a chunk at any point."""
    d = str(tmp_path)
    leaves = base_leaves()
    write_snapshot(d, make_pending(leaves, 2), keep=1)

    def fault(point):
        if point == "checkpoint_gc":
            raise FaultInjected(point, 0)

    fresh = [l + 100 for l in leaves]
    with pytest.raises(FaultInjected):
        write_snapshot(d, make_pending(fresh, 4), keep=1, fault=fault)
    cdir = os.path.join(d, CHUNK_DIR)
    mark = os.path.join(cdir, GC_MARK)
    assert os.path.exists(mark)
    with open(mark) as f:
        doomed = set(json.load(f)["doomed"])
    assert doomed and doomed <= chunk_files(d)  # marked, NOT yet swept
    # the interrupted write itself completed (GC runs last): usable now
    assert validate_checkpoint(os.path.join(d, "ckpt-0000000004.npz")) is None

    r = write_snapshot(d, make_pending(fresh, 6), keep=1)
    assert not os.path.exists(mark)
    assert r["gc_deleted"] >= len(doomed)
    assert not (doomed & chunk_files(d))
    latest = latest_checkpoint(d)
    assert latest is not None and validate_checkpoint(latest) is None


def test_retention_tiers_keep_plus_durable(tmp_path):
    """keep=2 keep_every=3 over eight snapshots retains the newest two
    plus every third seq as durable — and every survivor's chunk chain
    is still complete after the interleaved GC."""
    d = str(tmp_path)
    leaves = base_leaves(n=4)
    for i in range(1, 9):
        leaves[0] = leaves[0] + 1  # churn one leaf per snapshot
        write_snapshot(
            d, make_pending(leaves, 2 * i), keep=2, keep_every=3
        )
    names = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(d, "ckpt-*.npz"))
    )
    # seqs 3 and 6 are durable; seqs 7, 8 are the newest two
    assert names == [
        "ckpt-0000000006.npz", "ckpt-0000000012.npz",
        "ckpt-0000000014.npz", "ckpt-0000000016.npz",
    ]
    for n in names:
        p = os.path.join(d, n)
        assert validate_checkpoint(p) is None, n
        assert _read_meta(p)["seq"] in (3, 6, 7, 8)


def test_prune_consults_latest_marker(tmp_path):
    """The marker-race regression: whatever ``latest`` names must
    survive pruning even when newer-named snapshots exist — a crash
    between write and marker refresh must never leave the marker
    dangling at a deleted file."""
    d = str(tmp_path)
    leaves = base_leaves(n=4)
    for pos in (2, 4, 6):
        write_snapshot(d, make_pending(leaves, pos), keep=5)
    # simulate the race: marker still names the OLDEST snapshot
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("ckpt-0000000002.npz")
    assert _prune(d, keep=1) == 1  # only ckpt-4 is prunable
    kept = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(d, "ckpt-*.npz"))
    )
    assert kept == ["ckpt-0000000002.npz", "ckpt-0000000006.npz"]
    assert latest_checkpoint(d) is not None


def test_corrupt_chunk_fails_validation_and_falls_back(tmp_path):
    """A bit-flipped chunk breaks exactly the manifests that reference
    it: validate_checkpoint names the chunk, latest_checkpoint falls
    back to the older intact snapshot, and the restore drill flags the
    nominal-latest rot instead of silently falling back."""
    d = str(tmp_path)
    leaves = base_leaves()
    write_snapshot(d, make_pending(leaves, 2), keep=5)
    leaves[0] = leaves[0] + 1
    write_snapshot(d, make_pending(leaves, 4), keep=5)
    newest = os.path.join(d, "ckpt-0000000004.npz")
    older = os.path.join(d, "ckpt-0000000002.npz")
    unique = manifest_refs(newest) - manifest_refs(older)
    assert unique
    cpath = os.path.join(d, CHUNK_DIR, f"{unique.pop()}.npy")
    raw = bytearray(open(cpath, "rb").read())
    raw[-1] ^= 0xFF
    with open(cpath, "wb") as f:
        f.write(bytes(raw))

    assert "checksum mismatch" in validate_checkpoint(newest)
    assert validate_checkpoint(older) is None
    assert latest_checkpoint(d) == older
    drill = restore_drill(d)
    assert drill["ok"] is False and drill["path"] == newest
    assert "checksum mismatch" in drill["reason"]


def test_half_gc_store_fails_drill(tmp_path):
    """A referenced chunk going missing (lost file, over-eager manual
    cleanup) is the drill's other catch: the walk names the missing
    chunk rather than reporting a loadable snapshot."""
    d = str(tmp_path)
    write_snapshot(d, make_pending(base_leaves(), 2), keep=5)
    newest = os.path.join(d, "ckpt-0000000002.npz")
    victim = sorted(manifest_refs(newest))[0]
    os.unlink(os.path.join(d, CHUNK_DIR, f"{victim}.npy"))
    drill = restore_drill(d)
    assert drill["ok"] is False
    assert "missing chunk" in drill["reason"]
    assert latest_checkpoint(d) is None  # the only snapshot is broken


# ---------------------------------------------------------------------------
# job half: real executors over the plane
# ---------------------------------------------------------------------------
def run_job(
    items=LINES, ckdir=None, restore=None, injector=None, strategy=None,
    savepoint_tags=(), **over
):
    from tpustream_torch.jobs.chapter2_max import build

    over.setdefault("batch_size", 4)
    cfg = StreamConfig(device="cpu", **over)
    if ckdir is not None:
        cfg = cfg.replace(
            checkpoint_dir=str(ckdir), checkpoint_interval_batches=1
        )
    if injector is not None:
        cfg = injector.install(cfg)
    env = StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    if restore is not None:
        env.restore_from_checkpoint(restore)
    for tag in savepoint_tags:
        env.savepoint(tag)
    handle = build(env, env.add_source(ReplaySource(items))).collect()
    result = env.execute("plane-test")
    return env, handle.items, result


def test_savepoint_pinned_and_self_contained(tmp_path):
    """A requested savepoint lands at the next barrier, survives a
    retention policy that prunes everything else down to one snapshot,
    restores the exact output suffix, and — being self-contained —
    loads from a bare directory with no chunk store at all."""
    ckdir = tmp_path / "ck"
    env, full, _ = run_job(
        ckdir=ckdir, savepoint_tags=("pre-upgrade",), checkpoint_keep=1
    )
    assert len(env.savepoints) == 1
    sp = env.savepoints[0]
    assert os.path.basename(sp).startswith("savepoint-")
    assert "pre-upgrade" in os.path.basename(sp)
    assert os.path.exists(sp)  # outlived keep=1 pruning and GC
    assert validate_checkpoint(sp) is None
    # savepoints are pinned artifacts, never recovery candidates
    assert latest_checkpoint(str(ckdir)) != sp

    ck = load_checkpoint(sp)
    _, resumed, _ = run_job(restore=sp)
    assert resumed == full[ck.emitted:]

    exiled = tmp_path / "exiled" / os.path.basename(sp)
    os.makedirs(exiled.parent)
    shutil.copy(sp, exiled)
    assert validate_checkpoint(str(exiled)) is None
    _, resumed2, _ = run_job(restore=str(exiled))
    assert resumed2 == full[ck.emitted:]


def test_savepoint_restores_at_another_parallelism(tmp_path):
    """The savepoint's rescale story: state written at parallelism 1
    restores the identical suffix at parallelism 2 (as a multiset: the
    emission order depends on the parallelism)."""
    ckdir = tmp_path / "ck"
    env, full, _ = run_job(ckdir=ckdir, savepoint_tags=("rescale",))
    sp = env.savepoints[0]
    ck = load_checkpoint(sp)
    _, resumed, _ = run_job(restore=sp, parallelism=2)
    assert sorted(map(repr, resumed)) == sorted(map(repr, full[ck.emitted:]))


@pytest.mark.parametrize("point,at", [
    ("checkpoint_write", 1),
    ("checkpoint_gc", 0),
])
def test_writer_and_gc_fault_recovery(tmp_path, point, at):
    """A crash inside the snapshot writer (mid-chunk, manifest not yet
    landed) or inside the GC sweep (mark landed, unlink pending) is a
    supervised restart like any other: the job restarts from the newest
    VALID snapshot, output stays byte-identical, and afterwards the
    store is coherent — every retained manifest's chunk chain walks."""
    _, full, _ = run_job()
    inj = FaultInjector(FaultPoint(point, at=at))
    ckdir = tmp_path / point
    # keep=1 with churn makes every barrier prune + GC, so the GC point
    # actually fires; async off keeps the fault on the barrier path
    _, out, _ = run_job(
        ckdir=ckdir, injector=inj, strategy=fixed_delay(3, 0.0),
        checkpoint_keep=1, checkpoint_async=False,
    )
    assert inj.fired == 1, point
    assert out == full, f"{point} recovery diverged"
    latest = latest_checkpoint(str(ckdir))
    assert latest is not None
    for p in glob.glob(os.path.join(str(ckdir), "ckpt-*.npz")):
        assert validate_checkpoint(p) is None, p


def test_async_writer_fault_surfaces_and_recovers(tmp_path):
    """The same writer crash in ASYNC mode: the failure crosses the
    writer thread and re-raises at a later barrier with its fault point
    intact, so supervision attributes and recovers identically."""
    _, full, _ = run_job()
    inj = FaultInjector(FaultPoint("checkpoint_write", at=1))
    env, out, res = run_job(
        ckdir=tmp_path, injector=inj, strategy=fixed_delay(3, 0.0),
        checkpoint_async=True, obs=ObsConfig(enabled=True),
    )
    assert inj.fired == 1
    assert out == full
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    restarts = [s for s in series if s["name"] == "job_restarts_total"]
    assert sum(s["value"] for s in restarts) == 1
    assert restarts[0]["labels"]["cause"] == "checkpoint_write"


def test_device_fault_recovers_from_incremental_chain(tmp_path):
    """The tentpole composition: a device_step crash recovers from an
    async-incremental chunk chain — the restored run replays from a
    manifest snapshot and the output is byte-identical."""
    _, full, _ = run_job()
    inj = FaultInjector(FaultPoint("device_step", at=2))
    env, out, res = run_job(
        ckdir=tmp_path, injector=inj, strategy=fixed_delay(3, 0.0),
        checkpoint_async=True, checkpoint_incremental=True,
        obs=ObsConfig(enabled=True),
    )
    assert inj.fired == 1
    assert out == full
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    replay = next(
        s for s in series if s["name"] == "recovery_replay_batches"
    )
    assert replay["value"] > 0
    # the restored-from snapshot really was a manifest
    restored = next(
        e for e in res.metrics.job_obs.flight.events()
        if e["kind"] == "job_restored"
    )
    assert _read_meta(restored["checkpoint"]).get("chunks")
    # the ledger's digest anchors verified the restore's sink rollback
    rst = res.metrics.obs_snapshot()["ledger"].get("restore")
    assert rst and rst["verified"] >= 1 and rst["mismatches"] == 0


def test_restore_drill_passes_on_intact_store(tmp_path):
    """Drills on a healthy store: verdict gauge 1, latency observed, no
    failure counter, no restore_drill_failed breadcrumb."""
    env, _, res = run_job(
        ckdir=tmp_path, restore_drill_interval_s=1e-6,
        obs=ObsConfig(enabled=True),
    )
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    by_name = {s["name"]: s["value"] for s in series}
    assert by_name.get("restore_drill_verdict") == 1.0
    assert by_name.get("restore_drill_ms", {}).get("count", 0) >= 1
    assert "restore_drill_failures_total" not in by_name
    kinds = [e["kind"] for e in res.metrics.job_obs.flight.events()]
    assert "restore_drill_failed" not in kinds


def test_restore_drill_catches_rotted_store(tmp_path):
    """Bit-rot the whole chunk store between two runs of the same job:
    the second run's snapshots reference the (hash-matching, now
    corrupt) chunks, and its drills must catch the rot — verdict 0,
    failures counted, and a restore_drill_failed breadcrumb naming the
    reason — while the run's own output is unaffected."""
    _, full, _ = run_job(ckdir=tmp_path)
    cdir = os.path.join(str(tmp_path), CHUNK_DIR)
    for n in os.listdir(cdir):
        if not n.endswith(".npy"):
            continue
        p = os.path.join(cdir, n)
        raw = bytearray(open(p, "rb").read())
        raw[-1] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(raw))

    env, out, res = run_job(
        ckdir=tmp_path, restore_drill_interval_s=1e-6,
        obs=ObsConfig(enabled=True),
    )
    assert out == full  # drills observe; they never perturb the stream
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    by_name = {s["name"]: s["value"] for s in series}
    assert by_name.get("restore_drill_verdict") == 0.0
    assert by_name.get("restore_drill_failures_total", 0) >= 1
    failed = [
        e for e in res.metrics.job_obs.flight.events()
        if e["kind"] == "restore_drill_failed"
    ]
    assert failed and "checksum mismatch" in failed[0]["reason"]
