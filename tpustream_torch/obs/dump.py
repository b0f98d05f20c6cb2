"""``python -m tpustream_torch.obs.dump <snapshot.json>`` — pretty-print an
observability snapshot file.

Accepts a single-snapshot ``.json`` (from
:func:`tpustream_torch.obs.snapshot.write_snapshot` or the bench JSON tail's
``obs_snapshot`` field) or a ``.jsonl`` time series (from
:class:`~tpustream_torch.obs.snapshot.Snapshotter`); for JSONL the last line
is shown unless ``--index`` picks another. ``--prom`` prints the
embedded Prometheus exposition text verbatim instead of the table view.
``--health`` shows the snapshot's embedded health section (rule levels
and transitions); ``--tenants`` shows the per-tenant fleet view
(tenant-labeled series joined with SLO states and budget burn);
``--profile`` shows only the continuous profiler's stage-attribution
section (binding stage, per-stage shares, occupancy);
``--rules rules.json`` re-evaluates a rule set against the snapshot's
series offline — postmortem alert-rule replay over any recorded
snapshot. ``--selftest`` needs no input at all: it pushes a canned
registry + hostile labels + alert rules + time-series/profiler
machinery through the whole snapshot/exposition/health path and exits
nonzero on any mismatch (the CI smoke mode).

This module deliberately imports nothing beyond the stdlib — no torch,
no ``tpustream_torch.runtime`` — so ``render``/``main`` are importable
and testable without a device runtime (running it as ``-m`` still
executes the ``tpustream_torch`` package root, which does import torch).
"""

from __future__ import annotations

import argparse
import json
import re
import sys


def _load(path: str, index: int) -> dict:
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if not stripped:
        raise SystemExit(f"{path}: empty file")
    if "\n" in text.strip() and stripped[0] == "{" and _looks_jsonl(text):
        lines = [ln for ln in text.splitlines() if ln.strip()]
        return json.loads(lines[index])
    doc = json.loads(text)
    # Allow pointing at a whole bench JSON tail; descend to its snapshot.
    if "metrics" not in doc and "obs_snapshot" in doc:
        return doc["obs_snapshot"]
    if "metrics" not in doc and "obs_snapshot" in doc.get("detail", {}):
        return doc["detail"]["obs_snapshot"]
    return doc


def _looks_jsonl(text: str) -> bool:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if len(lines) < 2:
        return False
    try:
        json.loads(lines[0])
        json.loads(lines[1])
        return True
    except ValueError:
        return False


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return "-"
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render(snap: dict) -> str:
    out = []
    meta = snap.get("meta", {})
    if meta:
        out.append("meta: " + ", ".join(f"{k}={meta[k]}" for k in sorted(meta)))
    series = snap.get("metrics", {}).get("series", [])
    scalars = [s for s in series if s["type"] in ("counter", "gauge")]
    hists = [s for s in series if s["type"] == "histogram"]
    if scalars:
        out.append("")
        out.append(f"{'NAME':<32} {'TYPE':<8} {'VALUE':>14}  LABELS")
        for s in scalars:
            out.append(
                f"{s['name']:<32} {s['type']:<8} {_fmt_val(s['value']):>14}  "
                f"{_fmt_labels(s['labels'])}"
            )
    if hists:
        out.append("")
        out.append(
            f"{'HISTOGRAM':<32} {'COUNT':>8} {'SUM':>12} {'P50':>10} "
            f"{'P90':>10} {'P99':>10}  LABELS"
        )
        for s in hists:
            v = s["value"]
            out.append(
                f"{s['name']:<32} {v['count']:>8} {_fmt_val(v['sum']):>12} "
                f"{_fmt_val(v['p50']):>10} {_fmt_val(v['p90']):>10} "
                f"{_fmt_val(v['p99']):>10}  {_fmt_labels(s['labels'])}"
            )
    prof = snap.get("profile")
    if prof:
        out.append("")
        out.append(render_profile(prof).rstrip("\n"))
    health = snap.get("health")
    if health:
        out.append("")
        out.append(render_health(health).rstrip("\n"))
    trace = snap.get("trace")
    if trace:
        out.append("")
        out.append(
            f"trace: {trace['total_spans']} spans total, "
            f"{len(trace.get('events', []))} retained "
            f"(capacity {trace['capacity']}, dropped {trace['dropped_spans']})"
        )
        by_kind = {}
        for ev in trace.get("events", []):
            agg = by_kind.setdefault(ev["kind"], [0, 0.0])
            agg[0] += 1
            agg[1] += ev["dur_s"]
        for kind in sorted(by_kind):
            n, tot = by_kind[kind]
            out.append(
                f"  {kind:<10} n={n:<6} total={tot:.6f}s mean={tot / n:.6f}s"
            )
    return "\n".join(out) + "\n"


def render_health(health: dict) -> str:
    """Render a snapshot's health section (see obs/health.py)."""
    out = [f"health: {str(health.get('level', 'ok')).upper()}"]
    rules = health.get("rules", [])
    if rules:
        out.append(
            f"  {'RULE':<24} {'LEVEL':<6} {'KIND':<10} {'VALUE':>12}  REASON"
        )
        for r in rules:
            out.append(
                f"  {r.get('rule', '?'):<24} "
                f"{str(r.get('level', '?')).upper():<6} "
                f"{r.get('kind', '?'):<10} "
                f"{_fmt_val(r.get('value')) if r.get('value') is not None else '-':>12}"
                f"  {r.get('reason', '')}"
            )
    transitions = health.get("transitions", [])
    if transitions:
        out.append(f"  transitions ({len(transitions)}):")
        for t in transitions:
            out.append(
                f"    t={_fmt_val(t.get('at_s', 0))}s {t.get('rule', '?')}: "
                f"{t.get('from', '?')} -> {t.get('to', '?')} "
                f"({t.get('reason', '')})"
            )
    return "\n".join(out) + "\n"


_LEVELS = {"ok": 0, "warn": 1, "crit": 2}


def render_tenants(snap: dict) -> str:
    """Render the per-tenant fleet view (docs/multitenancy.md): one row
    per ``tenant`` label value across the snapshot's series, joined with
    the health section's per-tenant SLO rule states and budget burn."""
    series = snap.get("metrics", {}).get("series", [])
    per: dict = {}
    for s in series:
        tenant = (s.get("labels") or {}).get("tenant")
        if tenant is None:
            continue
        row = per.setdefault(tenant, {})
        v = s["value"]
        if s["type"] == "histogram":
            if s["name"] == "tenant_e2e_latency_ms":
                row["e2e_p99_ms"] = v.get("p99")
        else:
            row[s["name"]] = v
    if not per:
        return "no tenant-labeled series in this snapshot\n"
    worst: dict = {}
    burn: dict = {}
    for r in (snap.get("health") or {}).get("rules", []):
        tenant = (r.get("labels") or {}).get("tenant")
        if tenant is None:
            continue
        lvl = str(r.get("level", "ok"))
        if _LEVELS.get(lvl, 0) >= _LEVELS.get(worst.get(tenant, "ok"), 0):
            worst[tenant] = lvl
        b = r.get("budget_burn")
        if b is not None:
            burn[tenant] = max(float(b), burn.get(tenant, 0.0))
    out = [f"tenants: {len(per)}"]
    out.append(
        f"  {'TENANT':<16} {'RECORDS':>8} {'EMITTED':>8} {'QUOTA':>6} "
        f"{'DEAD':>5} {'ERR_RATE':>9} {'P99_MS':>9} {'SHARE':>6} "
        f"{'SLO':<5} BURN"
    )
    for tenant in sorted(per):
        row = per[tenant]

        def _c(name, row=row):
            v = row.get(name)
            return "-" if v is None else _fmt_val(v)

        out.append(
            f"  {tenant:<16} {_c('tenant_records_total'):>8} "
            f"{_c('tenant_emitted_total'):>8} "
            f"{_c('tenant_quota_exceeded_total'):>6} "
            f"{_c('tenant_dead_letter_total'):>5} "
            f"{_c('tenant_error_rate'):>9} {_c('e2e_p99_ms'):>9} "
            f"{_c('tenant_step_share'):>6} "
            f"{worst.get(tenant, '-').upper():<5} "
            f"{_fmt_val(burn[tenant]) if tenant in burn else '-'}"
        )
    return "\n".join(out) + "\n"


def render_profile(prof: dict) -> str:
    """Render a snapshot's profile section (see obs/profiler.py)."""
    binding = prof.get("binding_stage") or "-"
    share = float(prof.get("binding_share", 0.0))
    out = [
        f"profile: binding={binding} share={share * 100:.1f}% "
        f"occupancy={_fmt_val(prof.get('occupancy', 0.0))} "
        f"batch_wall={_fmt_val(prof.get('batch_wall_ms', 0.0))}ms "
        f"window={_fmt_val(prof.get('window_s', 0.0))}s"
    ]
    stages = prof.get("stages", {})
    if stages:
        out.append(
            f"  {'STAGE':<10} {'N':>6} {'TOTAL_MS':>12} {'MEAN_MS':>10} "
            f"{'P50_MS':>10} {'P99_MS':>10} {'SHARE':>8}"
        )
        order = prof.get("stage_kinds") or sorted(stages)
        for k in order:
            s = stages.get(k)
            if s is None:
                continue
            out.append(
                f"  {k:<10} {s['n']:>6} {_fmt_val(s['total_ms']):>12} "
                f"{_fmt_val(s['mean_ms']):>10} {_fmt_val(s['p50_ms']):>10} "
                f"{_fmt_val(s['p99_ms']):>10} {s['share'] * 100:>7.1f}%"
            )
    dropped = prof.get("spans_dropped", 0)
    if dropped:
        out.append(f"  (spans dropped before attribution: {dropped})")
    return "\n".join(out) + "\n"


def render_ledger(led: dict) -> str:
    """Render a snapshot's ledger section (see obs/ledger.py)."""
    v = led.get("violations", {})
    out = [
        f"ledger: ticks={led.get('ticks', 0)} "
        f"digests={'on' if led.get('digests') else 'off'} "
        f"violations={v.get('total', 0)}"
    ]
    if v.get("edges"):
        out.append("  tripped: " + ", ".join(v["edges"]))
    edges = led.get("edges", [])
    if edges:
        out.append(f"  {'EDGE':<24} {'RESIDUAL':>9}  TERMS")
        for e in edges:
            r = e.get("residual")
            terms = " ".join(
                f"{k}={e[k]}" for k in e
                if k not in ("edge", "residual", "note")
            )
            if e.get("note"):
                terms += f"  ({e['note']})"
            out.append(
                f"  {e.get('edge', '?'):<24} "
                f"{'-' if r is None else r:>9}  {terms}"
            )
    anchors = led.get("anchors", {})
    if anchors:
        out.append(f"  {'SINK':<24} {'COUNT':>7}  DIGEST")
        for name, a in anchors.items():
            d = a.get("digest") or "-"
            out.append(
                f"  {name:<24} {a.get('count', 0):>7}  {d[:16]}"
                + ("" if a.get("verifiable") else "  (informational)")
            )
    rst = led.get("restore")
    if rst:
        out.append(
            f"  restore: verified={rst.get('verified', 0)} "
            f"mismatches={rst.get('mismatches', 0)}"
        )
    return "\n".join(out) + "\n"


def _read_npz_meta(path: str):
    """``(meta, member_sizes)`` of one checkpoint ``.npz`` without
    numpy: the file is a plain zip whose ``__meta__.npy`` member is a
    1-D uint8 array of JSON bytes, so a hand-rolled npy-header walk
    (magic, version byte, little-endian header length) reaches the
    payload with the stdlib alone. ``member_sizes`` maps each member
    name (sans ``.npy``) to its uncompressed byte size — enough to
    price inline leaf arrays without decompressing them."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as z:
        sizes = {
            i.filename[:-4]: i.file_size
            for i in z.infolist()
            if i.filename.endswith(".npy")
        }
        raw = z.read("__meta__.npy")
    if raw[:6] != b"\x93NUMPY":
        raise ValueError(f"{path}: __meta__ is not an npy member")
    if raw[6] == 1:
        hlen = struct.unpack("<H", raw[8:10])[0]
        off = 10 + hlen
    else:
        hlen = struct.unpack("<I", raw[8:12])[0]
        off = 12 + hlen
    return json.loads(raw[off:].decode("utf-8")), sizes


#: content-hash chunk file names, the only GC candidates (checkpoint.py)
_CHUNK_NAME = re.compile(r"^[0-9a-f]{64}\.npy$")


def render_checkpoints(directory: str) -> str:
    """Render a checkpoint directory's retention tree: every snapshot
    and savepoint in ``seq`` order with its form (inline vs chunked
    manifest), total bytes, DELTA bytes (chunks not already referenced
    by the previous snapshot — the incremental win), and retention
    tier (``latest`` marker, durable, savepoint pin); then the chunk
    store's referenced/unreferenced accounting and any interrupted-GC
    mark. Stdlib-only, read-only, tolerant of corrupt files."""
    import os as _os

    names = sorted(
        n for n in _os.listdir(directory)
        if (n.startswith("ckpt-") or n.startswith("savepoint-"))
        and n.endswith(".npz")
    )
    if not names:
        return f"no snapshots in {directory}\n"
    marker = None
    try:
        with open(_os.path.join(directory, "latest")) as f:
            marker = f.read().strip() or None
    except OSError:
        pass
    cdir = _os.path.join(directory, "chunks")
    store = {}
    if _os.path.isdir(cdir):
        for n in _os.listdir(cdir):
            if _CHUNK_NAME.match(n):
                store[n[:-4]] = _os.path.getsize(_os.path.join(cdir, n))

    rows, version = [], None
    for n in names:
        try:
            meta, sizes = _read_npz_meta(_os.path.join(directory, n))
        except Exception as e:
            rows.append({"name": n, "error": f"{type(e).__name__}: {e}"})
            continue
        refs = meta.get("chunks")
        if refs is not None:
            total = sum(int(r.get("nbytes", 0)) for r in refs)
            chunks = [str(r.get("chunk", "")) for r in refs]
            form = "manifest"
            missing = sum(1 for c in chunks if c not in store)
        else:
            total = sum(
                s for m, s in sizes.items() if m.startswith("L")
            )
            chunks, form, missing = [], "inline", 0
        version = meta.get("version", version)
        rows.append({
            "name": n,
            "seq": int(meta.get("seq", 0)),
            "kind": meta.get("kind", "checkpoint"),
            "tag": meta.get("tag"),
            "durable": bool(meta.get("durable")),
            "form": form,
            "total": total,
            "refs": [
                (str(r.get("chunk", "")), int(r.get("nbytes", 0)))
                for r in (refs or [])
            ],
            "missing": missing,
        })

    n_save = sum(1 for r in rows if r.get("kind") == "savepoint")
    out = [
        f"checkpoints: {directory}  format=v{version or '?'}  "
        f"snapshots={len(rows) - n_save}  savepoints={n_save}  "
        f"marker={marker or '-'}"
    ]
    wide = max(len(r["name"]) for r in rows)
    out.append(
        f"  {'NAME':<{wide}} {'SEQ':>4} {'FORM':<8} "
        f"{'BYTES':>10} {'DELTA':>10}  TIER"
    )
    prev_chunks = set()
    for r in sorted(
        [r for r in rows if "error" not in r],
        key=lambda r: (r["seq"], r["name"]),
    ):
        if r["form"] == "manifest":
            delta = sum(b for c, b in r["refs"] if c not in prev_chunks)
            prev_chunks = {c for c, _ in r["refs"]}
        else:
            # an inline snapshot carries everything itself; it neither
            # reuses nor publishes chunks, so the delta baseline holds
            delta = r["total"]
        tiers = []
        if r["name"] == marker:
            tiers.append("latest")
        if r["kind"] == "savepoint":
            tiers.append(
                f"savepoint({r['tag']})" if r.get("tag") else "savepoint"
            )
            tiers.append("pinned")
        elif r["durable"]:
            tiers.append("durable")
        line = (
            f"  {r['name']:<{wide}} {r['seq']:>4} {r['form']:<8} "
            f"{r['total']:>10} {delta:>10}  {','.join(tiers) or '-'}"
        )
        if r["missing"]:
            line += f"  MISSING-CHUNKS:{r['missing']}"
        out.append(line)
    for r in rows:
        if "error" in r:
            out.append(f"  {r['name']:<{wide}} unreadable: {r['error']}")

    if store:
        referenced = set()
        for r in rows:
            referenced.update(c for c, _ in r.get("refs", []))
        orphan = sorted(set(store) - referenced)
        out.append(
            f"  chunks: {len(store)} files / "
            f"{sum(store.values())} bytes, "
            f"referenced={len(store) - len(orphan)}, "
            f"unreferenced={len(orphan)}"
            + (f" ({sum(store[c] for c in orphan)} bytes)" if orphan
               else "")
        )
    if _os.path.exists(_os.path.join(cdir, "gc-mark.json")):
        out.append(
            "  WARNING: chunks/gc-mark.json present — a GC sweep was "
            "interrupted; the next snapshot's GC resumes it"
        )
    return "\n".join(out) + "\n"


class _FakeClock:
    """Deterministic injectable clock for the selftest's ticks."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _selftest_timeseries() -> list:
    """Checks for the per-series history machinery: windowed queries,
    explicit timestamps in both expositions, shard merging, reservoir
    bounds, and the snapshotter's absolute deadline grid."""
    from .registry import Histogram, MetricsRegistry
    from .snapshot import Snapshotter
    from .timeseries import TimeSeries

    checks = []
    clock = _FakeClock(0.0)
    reg = MetricsRegistry()
    reg.now = clock
    reg._epoch_wall = 0.0
    reg._epoch_perf = 0.0
    g = reg.group(job="ts")
    c = g.counter("rows")
    for i in range(1, 11):
        clock.t = float(i)
        c.inc(100)
    checks.append(("counter rate over the window is exact",
                   abs(c.history.rate(5.0) - 100.0) < 1e-9))
    checks.append(("counter delta over the window is exact",
                   abs(c.history.delta(5.0) - 500.0) < 1e-9))
    snap = reg.snapshot()
    row = next(s for s in snap["series"] if s["name"] == "rows")
    checks.append(("snapshot series carry explicit ts_ms",
                   row.get("ts_ms") == 10_000))
    checks.append(("snapshot counters carry windowed rate_per_s",
                   abs(row.get("rate_per_s", 0.0) - 100.0) < 1e-6))
    checks.append(("prometheus lines carry the sample timestamp",
                   'rows{job="ts"} 1000 10000' in reg.to_prometheus_text()))
    clock.t = 20.0
    hist = g.histogram("lat_ms")
    for v in range(1, 101):
        hist.observe(float(v))
    checks.append(("histogram history quantile matches the exact percentile",
                   abs(hist.history.quantile(0.5) - 50.5) < 1e-9))
    checks.append(("histogram lines share the series timestamp",
                   'lat_ms_count{job="ts"} 100 20000'
                   in reg.to_prometheus_text()))

    # eviction folds into centroids: the long-window mean stays EXACT
    # (centroids preserve sum/weight) even after the raw ring turned over
    ts = TimeSeries(capacity=64, kind="sample", digest=16)
    for i in range(1000):
        ts.record(i * 0.01, float(i % 100))
    checks.append(("digest keeps the long-window mean exact",
                   abs(ts.mean() - 49.5) < 1e-6))
    checks.append(("digest bounds retained points",
                   len(ts) <= 64 and ts.total_samples == 1000))

    # shard merge, cumulative: two shards on one timeline; the merged
    # step function's windowed rate equals the sum of the shard rates
    a = TimeSeries(capacity=128, kind="cumulative")
    b = TimeSeries(capacity=128, kind="cumulative")
    for i in range(1, 11):
        a.record(float(i), 60.0 * i)
        b.record(float(i), 40.0 * i)
    m = TimeSeries(capacity=256, kind="cumulative")
    m.merge_from(a)
    m.merge_from(b)
    checks.append(("merged cumulative rate equals the sum of shard rates",
                   abs(m.rate(5.0) - 100.0) < 1e-9))
    # shard merge, samples: evens + odds == the combined series
    s1 = TimeSeries(capacity=128, kind="sample")
    s2 = TimeSeries(capacity=128, kind="sample")
    for v in range(1, 101):
        (s1 if v % 2 == 0 else s2).record(float(v), float(v))
    s1.merge_from(s2)
    checks.append(("merged sample quantile equals the combined series",
                   abs(s1.quantile(0.5) - 50.5) < 1e-9))

    # histogram reservoir (satellite): retention bounded, totals exact
    h = Histogram("reservoir_check", {}, reservoir=128)
    for v in range(1, 10_001):
        h.observe(float(v))
    checks.append(("histogram reservoir bounds retention",
                   len(h.samples) == 128))
    checks.append(("histogram count/sum stay exact past the reservoir",
                   h.count == 10_000 and h.sum == 50_005_000.0))
    checks.append(("reservoir subsample stays representative",
                   abs(h.percentile(50) - 5000.0) < 1500.0))

    # snapshotter deadline grid (satellite): a slow tick records skew
    # but does NOT shift the cadence, and a stall never burst-fires
    clk = _FakeClock(0.0)
    reg2 = MetricsRegistry()
    snapper = Snapshotter(reg2, interval_s=1.0, meta={"job": "ts"},
                          clock=clk)
    clk.t = 0.5
    none_early = snapper.maybe_snapshot() is None
    clk.t = 1.05
    s_a = snapper.maybe_snapshot()
    clk.t = 2.60  # slow tick: 600 ms late
    s_b = snapper.maybe_snapshot()
    clk.t = 3.01  # old drift logic would wait until 3.60
    s_c = snapper.maybe_snapshot()
    clk.t = 8.70  # long stall: exactly ONE catch-up snapshot
    s_d = snapper.maybe_snapshot()
    clk.t = 8.80
    none_after = snapper.maybe_snapshot() is None
    checks.append(("snapshotter ticks on the absolute deadline grid",
                   none_early and s_a is not None and s_b is not None))
    checks.append(("slow tick does not shift the cadence",
                   s_c is not None))
    checks.append(("a stall fires one catch-up tick, not a burst",
                   s_d is not None and none_after))
    skews = reg2.find("snapshotter_tick_skew_ms", {"job": "ts"})
    checks.append(("tick skew is recorded",
                   skews is not None and skews.count == 4
                   and abs(skews.samples[0] - 50.0) < 1e-6
                   and abs(skews.samples[1] - 600.0) < 1e-6))
    checks.append(("tick skew lands in the snapshot meta",
                   abs(s_b["meta"]["tick_skew_ms"] - 600.0) < 1e-6))
    return checks


def _selftest_profile() -> list:
    """Checks for the continuous profiler: crafted spans through a real
    StepTracer, windowed attribution, gauges, snapshot embedding, and
    the render paths."""
    from .profiler import PipelineProfiler
    from .registry import MetricsRegistry
    from .snapshot import Snapshotter
    from .tracing import StepTracer

    checks = []
    tr = StepTracer(capacity=64)
    tr._epoch = 0.0  # absolute-time spans for determinism
    for i in range(3):
        t = 1.0 + i
        tr._record("parse", i, "src", t, 0.005)
        tr._record("dispatch", i, "window", t + 0.01, 0.010)
        tr._record("fetch", i, "window", t + 0.02, 0.030)
    reg = MetricsRegistry()
    pclk = _FakeClock(4.0)
    prof = PipelineProfiler(tr, reg.group(job="p"), window_s=60.0,
                            clock=pclk)
    p = prof.profile()
    share_sum = sum(s["share"] for s in p["stages"].values())
    checks.append(("profile names the binding stage",
                   p["binding_stage"] == "fetch"))
    checks.append(("profile shares sum to one",
                   abs(share_sum - 1.0) < 1e-6))
    checks.append(("binding share matches the span totals",
                   abs(p["binding_share"] - 90.0 / 135.0) < 1e-6))
    checks.append(("profile counts every span per stage",
                   p["stages"]["fetch"]["n"] == 3
                   and p["stages"]["parse"]["n"] == 3))
    prom = reg.to_prometheus_text()
    checks.append(("profile gauges land in the exposition",
                   'profile_binding_stage{job="p"} 4' in prom
                   and 'stage="fetch"' in prom))
    snapper = Snapshotter(reg, tracer=tr, interval_s=1.0,
                          meta={"job": "p"}, clock=_FakeClock(5.0))
    snapper.profiler = prof
    snap = snapper.take()
    checks.append(("profile lands in the snapshot",
                   snap.get("profile", {}).get("binding_stage") == "fetch"))
    text = render(snap)
    checks.append(("render shows the profile section",
                   "profile: binding=fetch" in text))
    checks.append(("profile render carries the stage table",
                   "STAGE" in render_profile(p)
                   and "fetch" in render_profile(p)))
    pclk.t = 5.0
    tr._record("fetch", 3, "window", 4.1, 0.030)
    p2 = prof.profile()
    checks.append(("profiler drains spans incrementally",
                   p2["stages"]["fetch"]["n"] == 4))
    return checks


def _selftest_trace() -> list:
    """Checks for the unified Perfetto timeline (obs/tracing_export.py):
    crafted device/lane spans, flight instants and a record flight path
    folded into Chrome-trace JSON, plus the span-drop accounting and a
    live /trace.json round-trip."""
    import json as _json
    import urllib.request

    from .flightrecorder import FlightRecorder
    from .latency import RecordTrace
    from .serve import MetricsServer
    from .tracing import StepTracer
    from .tracing_export import (
        PID_DEVICE,
        PID_LANES,
        PID_RECORDS,
        RecordTraceLog,
        timeline_from_parts,
        timeline_from_snapshot,
    )

    checks = []
    tr = StepTracer(capacity=64)
    tr._epoch = 100.0  # absolute-time spans for determinism
    tr._record("pack", 1, "window", 100.01, 0.002)
    tr._record("dispatch", 1, "window", 100.02, 0.010)
    tr._record("fetch", 1, "window", 100.04, 0.030)
    tr._record("lane_parse", -1, "lane0", 100.005, 0.004)
    tr._record("lane_parse", -1, "lane1", 100.006, 0.004)
    flight = FlightRecorder(capacity=8)
    flight._t0 = 100.0
    flight.record("serve_started", host="127.0.0.1", port=0)
    rt = RecordTrace(marker_id=1, trace_id=1, source_offset=7,
                     tenant="acme", born_s=100.001)
    rt.spans.clear()
    rt.spans.append({"name": "source", "t0_s": 100.001, "dur_s": 0.0,
                     "args": {"offset": 7}})
    rt.add_span("lane_parse", t0=100.005, dur=0.004, lane=0, frame_seq=0)
    rt.add_span("merge", t0=100.010, dur=0.001)
    rt.add_span("pack", t0=100.012, dur=0.002, step=1)
    rt.add_span("device_step", t0=100.020, dur=0.010, step=1)
    rt.add_span("fetch", t0=100.040, dur=0.030)
    rt.add_span("sink0", t0=100.071, dur=0.0, age_ms=70.0)
    log = RecordTraceLog(4)
    log.add(rt)
    tl = timeline_from_parts(
        tr.events(), flight_events=flight.events(),
        record_traces=log.traces(), tracer_epoch_s=tr.epoch,
        flight_epoch_s=100.0, meta={"job": "selftest"},
    )
    blob = _json.dumps(tl)
    rt2 = _json.loads(blob)
    evs = rt2["traceEvents"]
    slices = [e for e in evs if e["ph"] != "M"]
    ts_list = [e["ts"] for e in slices]
    checks.append(("timeline serializes and reloads",
                   rt2["displayTimeUnit"] == "ms" and len(evs) > 0))
    checks.append(("every event carries ph/ts/pid/tid",
                   all(all(k in e for k in ("ph", "pid", "tid"))
                       for e in evs)
                   and all("ts" in e for e in slices)))
    checks.append(("timestamps are non-negative and sorted",
                   all(t >= 0 for t in ts_list)
                   and ts_list == sorted(ts_list)))
    checks.append(("device spans land on the device track",
                   any(e["pid"] == PID_DEVICE and e["ph"] == "X"
                       and e["name"] == "dispatch" for e in evs)))
    checks.append(("lane spans get one tid per lane",
                   {e["tid"] for e in evs
                    if e["pid"] == PID_LANES and e["ph"] == "X"}
                   == {1, 2}))
    checks.append(("flight events export as instants",
                   any(e["ph"] == "i" and e["pid"] == PID_DEVICE
                       and e["name"] == "serve_started" for e in evs)))
    rec = [e for e in evs if e["pid"] == PID_RECORDS and e["ph"] != "M"]
    rec_names = [e["name"] for e in rec]
    checks.append(("record lineage spans source->sink",
                   rec_names[0] == "source" and rec_names[-1] == "sink0"
                   and "device_step" in rec_names))
    checks.append(("lineage spans carry the trace id",
                   all(e["args"].get("trace_id") == 1 for e in rec)))
    checks.append(("timeline meta counts the tracks",
                   tl["meta"]["n_record_traces"] == 1
                   and tl["meta"]["n_lane_spans"] == 2
                   and tl["meta"]["n_flight_instants"] == 1))
    # snapshot round-trip: the same parts via the snapshot shape
    snap = {
        "trace": tr.snapshot(),
        "trace_meta": {"tracer_epoch_s": tr.epoch,
                       "flight_epoch_s": 100.0},
        "flight_events": flight.events(),
        "record_traces": log.traces(),
    }
    tl2 = timeline_from_snapshot(snap)
    checks.append(("snapshot rebuilds the same timeline",
                   tl2 is not None
                   and tl2["meta"]["n_record_traces"] == 1
                   and tl2["meta"]["n_device_spans"]
                   == tl["meta"]["n_device_spans"]))
    checks.append(("snapshot without trace yields no timeline",
                   timeline_from_snapshot({"metrics": {}}) is None))
    # span-drop accounting: overflow counts + fires the one-shot hook
    class _Ctr:
        n = 0

        def inc(self, v=1):
            self.n += v

    small = StepTracer(capacity=2)
    small.drop_counter = _Ctr()
    fired = []
    small.on_first_drop = lambda: fired.append(1)
    for i in range(5):
        small._record("pack", i, "w", float(i), 0.001)
    checks.append(("tracer ring overflow counts drops",
                   small.drop_counter.n == 3))
    checks.append(("first drop fires the flight hook once",
                   fired == [1]))

    # live /trace.json round-trip on an ephemeral port
    class _TraceProvider:
        health = None

        def to_prometheus_text(self):
            return ""

        def snapshot(self):
            return dict(snap)

        def trace_timeline(self):
            return timeline_from_snapshot(snap)

    srv = MetricsServer(_TraceProvider(), port=0)
    srv.start()
    try:
        served = _json.loads(urllib.request.urlopen(
            srv.url + "/trace.json", timeout=5
        ).read().decode("utf-8"))
    finally:
        srv.close()
    checks.append(("/trace.json serves the timeline",
                   served["meta"]["n_record_traces"] == 1
                   and any(e.get("name") == "source"
                           for e in served["traceEvents"])))
    return checks


def _pid_stat_line(pid: int, comm: str, utime: int, stime: int,
                   core: int) -> str:
    """A /proc/<pid>/stat line with the comm parens intact: utime and
    stime are fields 14/15 and processor is field 39 (1-indexed)."""
    fields = ["0"] * 37
    fields[0] = "R"
    fields[11] = str(utime)
    fields[12] = str(stime)
    fields[36] = str(core)
    return f"{pid} ({comm}) " + " ".join(fields) + "\n"


def _selftest_resources() -> list:
    """Resource-plane checks (obs/resources.py): fingerprint
    determinism and round-trip, cgroup-quota core capping, and a
    ResourceSampler run over a canned /proc tree — host util deltas,
    RSS, context switches, per-lane CPU/core attribution, and both
    contention shapes (same core, plane pinned at ~1 core)."""
    import os as _os
    import tempfile

    from .flightrecorder import FlightRecorder
    from .registry import MetricsRegistry
    from .resources import (
        EnvFingerprint,
        ResourceSampler,
        cgroup_quota_cores,
        collect_env_fingerprint,
        usable_cores,
    )

    fp1 = collect_env_fingerprint()
    fp2 = collect_env_fingerprint()
    roundtrip = EnvFingerprint.from_dict(fp1.to_dict())
    mismatched = EnvFingerprint.from_dict(
        dict(fp1.to_dict(), usable_cores=fp1.usable_cores + 7,
             backend="antique-abacus")
    )

    checks = [
        ("env fingerprint is deterministic", fp1 == fp2),
        ("env fingerprint round-trips through its dict",
         roundtrip == fp1),
        ("identical fingerprints are comparable",
         fp1.comparability(fp2) == []),
        ("core/backend mismatch yields incomparability reasons",
         len(fp1.comparability(mismatched)) >= 2),
        ("compact form carries cores and backend",
         f"@{fp1.usable_cores}c" in fp1.compact()
         and fp1.backend in fp1.compact()),
    ]

    with tempfile.TemporaryDirectory() as td:
        proc = _os.path.join(td, "proc")
        cg = _os.path.join(td, "cgroup")

        def w(root, rel, body):
            p = _os.path.join(root, rel)
            _os.makedirs(_os.path.dirname(p), exist_ok=True)
            with open(p, "w") as f:
                f.write(body)

        # a half-core cgroup v2 quota must cap usable cores at 1
        w(cg, "cpu.max", "50000 100000\n")
        checks.append(
            ("cgroup v2 quota parses to cores",
             cgroup_quota_cores(cg) == 0.5)
        )
        checks.append(
            ("quota caps usable cores", usable_cores(sys_root=cg) == 1)
        )

        # tick 1 of the canned host: 2 busy-equivalent of 10 total
        w(proc, "stat", "cpu 100 0 100 700 100 0 0 0\n")
        w(proc, "self/statm", "5000 2500 300 1 0 1200 0\n")
        w(proc, "self/status",
          "Name:\tselftest\n"
          "voluntary_ctxt_switches:\t10\n"
          "nonvoluntary_ctxt_switches:\t3\n")
        w(proc, "111/stat", _pid_stat_line(111, "tsm-lane0", 50, 50, 0))
        w(proc, "222/stat", _pid_stat_line(222, "tsm-lane1", 40, 60, 0))

        reg = MetricsRegistry()
        g = reg.group(job="selftest")
        flight = FlightRecorder(capacity=16)
        clock = iter((0.0, 1.0, 2.0))
        sampler = ResourceSampler(
            g, flight=flight, proc_root=proc,
            clock=lambda: next(clock), page_size=4096, ticks_per_s=100,
        )
        sampler.attach_lanes(lambda: {0: 111, 1: 222})
        sampler.sample()

        # tick 2, one second later: host burned 200 of 800 ticks; lane
        # 0 burned 60 ticks (0.6 cores), lane 1 burned 40 (0.4) — both
        # on core 0, summing inside the pinned-at-one-core band
        w(proc, "stat", "cpu 200 0 200 1300 100 0 0 0\n")
        w(proc, "self/statm", "5000 2500 300 1 0 1200 0\n")
        w(proc, "self/status",
          "Name:\tselftest\n"
          "voluntary_ctxt_switches:\t15\n"
          "nonvoluntary_ctxt_switches:\t5\n")
        w(proc, "111/stat", _pid_stat_line(111, "tsm-lane0", 90, 70, 0))
        w(proc, "222/stat", _pid_stat_line(222, "tsm-lane1", 60, 80, 0))
        sampler.sample()

        series = {
            (s["name"], s["labels"].get("lane", ""),
             s["labels"].get("kind", "")): s["value"]
            for s in reg.snapshot()["series"]
            if "value" in s
        }
        prom = reg.to_prometheus_text()
        contention_kinds = [
            e.get("reason") for e in flight.events()
            if e["kind"] == "lane_core_contention"
        ]
        checks.extend([
            ("host util follows /proc/stat deltas",
             abs(series.get(("host_cpu_util", "", ""), 0.0) - 0.25) < 1e-9),
            ("process rss follows statm pages",
             series.get(("process_rss_bytes", "", "")) == 2500 * 4096),
            ("ctx switch counters replay the kernel totals",
             series.get(("ctx_switches_total", "", "voluntary")) == 15
             and series.get(("ctx_switches_total", "", "involuntary")) == 5),
            ("per-lane cpu util attributes the burn",
             abs(series.get(("lane_cpu_util", "0", ""), 0.0) - 0.6) < 1e-9
             and abs(series.get(("lane_cpu_util", "1", ""), 0.0) - 0.4)
             < 1e-9),
            ("lane core placement lands",
             series.get(("lane_core", "0", "")) == 0
             and series.get(("lane_core", "1", "")) == 0),
            ("same-core contention leaves a breadcrumb",
             "same_core" in contention_kinds),
            ("pinned-at-one-core contention leaves a breadcrumb",
             "pinned" in contention_kinds),
            ("contention counter feeds the health rule",
             series.get(("lane_core_contention_total", "", ""), 0) >= 2),
            ("prometheus carries the resource series",
             'host_cpu_util{job="selftest"}' in prom
             and 'lane_cpu_util{job="selftest",lane="0"}' in prom),
        ])

        # tick 3: lane 1 vanished — its util zeroes, its core parks
        sampler.attach_lanes(lambda: {0: 111})
        w(proc, "stat", "cpu 300 0 300 1900 100 0 0 0\n")
        w(proc, "111/stat", _pid_stat_line(111, "tsm-lane0", 120, 90, 1))
        sampler.sample()
        series3 = {
            (s["name"], s["labels"].get("lane", "")): s["value"]
            for s in reg.snapshot()["series"]
            if "value" in s
        }
        checks.append(
            ("vanished lane zeroes its series",
             series3.get(("lane_cpu_util", "1")) == 0.0
             and series3.get(("lane_core", "1")) == -1)
        )
    return checks


def _selftest_ledger() -> list:
    """Checks for the conservation ledger: invariant evaluation and
    residual gauges, violation latching + breadcrumbs, digest anchors,
    restore verification, the /ledger.json route, and the render."""
    import hashlib as _hashlib
    import json as _json
    import urllib.error
    import urllib.request

    from .flightrecorder import FlightRecorder
    from .ledger import (
        ConservationLedger,
        encode_row,
        ledger_effective,
    )
    from .registry import MetricsRegistry
    from .serve import MetricsServer

    checks = []

    class _Auto:
        enabled = True
        ledger = None

    class _ObsOff:
        enabled = False
        ledger = True

    class _Explicit:
        enabled = True
        ledger = False

    checks.append(
        ("ledger tri-state resolves (auto on, no obs, explicit off)",
         ledger_effective(_Auto) and not ledger_effective(_ObsOff)
         and not ledger_effective(_Explicit))
    )
    checks.append(
        ("row encoding is newline-framed and type-stable",
         encode_row("alpha") == b"alpha\n" and encode_row(7) == b"7\n")
    )

    reg = MetricsRegistry()
    g = reg.group(job="selftest")
    flight = FlightRecorder(capacity=16)

    class _JobObs:
        pass

    jo = _JobObs()
    jo.group = g
    jo.flight = flight
    jo.counter = lambda name: g.counter(name)

    led = ConservationLedger(jo, digests=True)
    items: list = []
    acct = led.register_sink("sink0", lambda: items, persistent=True)
    edge = led.emit_edge("sink0")
    for v in ("alpha", "beta", "gamma"):
        edge["in"] += 1
        items.append(v)
        acct.fold_tail()
    edge["in"] += 1
    edge["filtered"] += 1  # one row dropped by the sink's filter tail
    led.refresh()
    checks.append(
        ("balanced edges evaluate to zero residuals",
         all(e["residual"] == 0 for e in led.edges()
             if e.get("residual") is not None))
    )
    checks.append(
        ("residual gauges land in the exposition",
         'ledger_conservation_residual{edge="sink0",job="selftest"} 0'
         in reg.to_prometheus_text())
    )
    h = _hashlib.sha256()
    for v in items:
        h.update(encode_row(v))
    saved = led.anchors()
    checks.append(
        ("anchor digest equals a fresh sha256 over the contents",
         saved["sink0"]["count"] == 3
         and saved["sink0"]["digest"] == h.hexdigest()
         and saved["sink0"]["verifiable"])
    )

    # hand-tamper: a row vanishes behind the emit path
    items.pop()
    led.refresh()
    led.refresh()  # latch must hold, not double-count
    tampered = next(
        e for e in led.edges() if e["edge"] == "contents:sink0"
    )
    checks.append(
        ("hand-tampered sink trips the contents edge",
         tampered["residual"] == 1)
    )
    checks.append(
        ("violation latches exactly once",
         led.state()["violations"]["total"] == 1
         and led.state()["violations"]["edges"] == ["contents:sink0"])
    )
    checks.append(
        ("violation leaves a flight breadcrumb",
         any(e["kind"] == "ledger_violation"
             and e.get("edge") == "contents:sink0"
             for e in flight.events()))
    )

    # restore verification: the true anchor passes, a forged one trips
    items.append("gamma")
    led.on_restore(saved, verify=True)
    restored_ok = led.state()["restore"]
    led.on_restore(
        {"sink0": {"count": 2, "digest": "00" * 32, "verifiable": True}},
        verify=True,
    )
    checks.append(
        ("restore verifies a matching anchor",
         restored_ok["verified"] == 1 and restored_ok["mismatches"] == 0)
    )
    checks.append(
        ("forged anchor flags a restore digest mismatch",
         led.state()["restore"]["mismatches"] == 1
         and any(e["kind"] == "ledger_restore_digest_mismatch"
                 and e.get("sink") == "sink0"
                 for e in flight.events()))
    )
    text = render_ledger(led.state())
    checks.append(
        ("ledger render names the edges and anchors",
         "contents:sink0" in text and "tripped:" in text
         and "mismatches=1" in text)
    )

    class _P:
        def to_prometheus_text(self):
            return reg.to_prometheus_text()

        def snapshot(self):
            return {"meta": {"job": "selftest"}}

        def ledger_snapshot(self):
            return led.state()

    srv = MetricsServer(_P(), port=0)
    srv.start()
    try:
        body = _json.loads(
            urllib.request.urlopen(
                srv.url + "/ledger.json", timeout=5
            ).read().decode("utf-8")
        )
    finally:
        srv.close()
    checks.append(
        ("ledger.json round-trips the state",
         body["violations"]["total"] == 2
         and body["digests"] is True
         and "contents:sink0" in body["violations"]["edges"])
    )

    class _P2:
        def to_prometheus_text(self):
            return ""

        def snapshot(self):
            return {}

    srv2 = MetricsServer(_P2(), port=0)
    srv2.start()
    try:
        try:
            urllib.request.urlopen(srv2.url + "/ledger.json", timeout=5)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
    finally:
        srv2.close()
    checks.append(("ledger.json 404s when the ledger is off", code == 404))
    return checks


def _selftest_checkpoints() -> list:
    """Checkpoint-directory renderer checks: a hand-built fake
    checkpoint plane (two chunked manifests sharing a chunk, an inline
    tagged savepoint, a ``latest`` marker, an orphan chunk, a foreign
    file, an interrupted-GC mark, and a corrupt ``.npz``) rendered
    end-to-end — retention tiers, incremental delta accounting, chunk
    store totals, and corruption tolerance, all without numpy."""
    import os as _os
    import struct
    import tempfile
    import zipfile

    def npy_u8(payload: bytes) -> bytes:
        header = (
            "{'descr': '|u1', 'fortran_order': False, "
            "'shape': (%d,), }" % len(payload)
        )
        header += " " * ((64 - (10 + len(header) + 1) % 64) % 64) + "\n"
        return (
            b"\x93NUMPY\x01\x00" + struct.pack("<H", len(header))
            + header.encode("latin1") + payload
        )

    def write_npz(path, meta, leaves=()):
        with zipfile.ZipFile(path, "w") as z:
            for i, payload in enumerate(leaves):
                z.writestr(f"L{i:04d}.npy", npy_u8(payload))
            z.writestr(
                "__meta__.npy", npy_u8(json.dumps(meta).encode("utf-8"))
            )

    ha, hb, hc, hd = "a" * 64, "b" * 64, "c" * 64, "d" * 64

    def ref(h, nbytes):
        return {"chunk": h, "dtype": "uint8", "shape": [nbytes],
                "nbytes": nbytes}

    with tempfile.TemporaryDirectory() as d:
        cdir = _os.path.join(d, "chunks")
        _os.makedirs(cdir)
        for h, size in ((ha, 100), (hb, 200), (hc, 50), (hd, 64)):
            with open(_os.path.join(cdir, h + ".npy"), "wb") as f:
                f.write(b"\x00" * size)
        with open(_os.path.join(cdir, "notes.txt"), "w") as f:
            f.write("not a chunk\n")
        with open(_os.path.join(cdir, "gc-mark.json"), "w") as f:
            json.dump({"doomed": [hd + ".npy"]}, f)
        base = {"version": 12, "kind": "checkpoint", "durable": False}
        write_npz(
            _os.path.join(d, "ckpt-0000000002.npz"),
            dict(base, seq=1, source_pos=2,
                 chunks=[ref(ha, 100), ref(hb, 200)]),
        )
        write_npz(
            _os.path.join(d, "ckpt-0000000004.npz"),
            dict(base, seq=2, source_pos=4, durable=True,
                 chunks=[ref(ha, 100), ref(hc, 50)]),
        )
        write_npz(
            _os.path.join(d, "savepoint-0000000004-pre.npz"),
            dict(base, seq=3, source_pos=4, durable=True,
                 kind="savepoint", tag="pre"),
            leaves=(b"\x07" * 80,),
        )
        with open(_os.path.join(d, "ckpt-0000000009.npz"), "wb") as f:
            f.write(b"this is not a zip archive")
        with open(_os.path.join(d, "latest"), "w") as f:
            f.write("ckpt-0000000004.npz")
        try:
            text = render_checkpoints(d)
            raised = None
        except Exception as e:  # the tolerance check below fails loudly
            text, raised = "", e
        lines = {
            l.split()[0]: l for l in text.splitlines() if l.strip()
        }
        empty = render_checkpoints(cdir)  # no snapshots live there

    first = lines.get("ckpt-0000000002.npz", "")
    second = lines.get("ckpt-0000000004.npz", "")
    save = lines.get("savepoint-0000000004-pre.npz", "")
    return [
        ("checkpoint render survives a corrupt member", raised is None),
        ("checkpoint header counts forms and names the marker",
         "snapshots=3" in text and "savepoints=1" in text
         and "marker=ckpt-0000000004.npz" in text
         and "format=v12" in text),
        ("manifest bytes priced from chunk refs",
         " 300 " in first and "manifest" in first),
        ("incremental delta counts only fresh chunks",
         second.split()[4] == "50" and first.split()[4] == "300"),
        ("latest marker tier rides the marked snapshot",
         "latest" in second and "latest" not in first),
        ("durable tier annotated", "durable" in second
         and "durable" not in first),
        ("savepoint is pinned and carries its tag",
         "savepoint(pre)" in save and "pinned" in save
         and "inline" in save),
        ("inline snapshot priced from its leaf members",
         save.split()[3] == save.split()[4] != "0"),
        ("chunk store separates referenced from orphaned",
         "chunks: 4 files" in text and "referenced=3" in text
         and "unreferenced=1 (64 bytes)" in text),
        ("interrupted GC mark is surfaced", "gc-mark.json present" in text),
        ("corrupt snapshot degrades to an unreadable row",
         "unreadable:" in lines.get("ckpt-0000000009.npz", "")),
        ("empty directory renders the no-snapshots notice",
         empty.startswith("no snapshots in ")),
    ]


def _selftest() -> int:
    """CI smoke mode: a canned registry (hostile labels included) runs
    through snapshot -> render -> Prometheus exposition -> health
    evaluation -> flight-recorder dump, asserting on each. Everything
    here is stdlib-only and device-free, so the tier-1 suite can invoke
    it unconditionally."""
    import json as _json

    from .flightrecorder import FlightRecorder
    from .health import AlertRule, HealthEngine
    from .registry import MetricsRegistry
    from .snapshot import job_snapshot

    reg = MetricsRegistry()
    g = reg.group(job="selftest")
    g.counter("records_in").inc(1234)
    g.gauge("watermark_lag_ms").set(45000)
    h = g.histogram("e2e_latency_ms")
    for v in (1.0, 2.0, 5.0, 10.0):
        h.observe(v)
    # supervised-recovery series (docs/recovery.md): snapshot cost
    # histograms + the per-cause restart counter
    cs = g.histogram("checkpoint_save_ms")
    for v in (2.5, 3.5):
        cs.observe(v)
    g.histogram("checkpoint_bytes").observe(8192.0)
    g.group(cause="device_step").counter("job_restarts_total").inc(2)
    # CEP series (docs/cep.md): per-job match/timeout counters the
    # pattern operator mints through the same registry path
    g.counter("cep_matches").inc(7)
    g.counter("cep_timeouts").inc(3)
    # dynamic-rules series (docs/dynamic_rules.md): the broadcast
    # control stream's version gauge, update counter, and propagation
    # latency histogram
    g.gauge("rule_version").set(2)
    g.counter("rule_updates_total").inc(2)
    g.histogram("rule_update_propagation_ms").observe(1.5)
    # async-pipeline series (docs/performance.md): wire-byte counters,
    # the compaction win, spills, and the lazily-evaluated occupancy
    # gauge the executor registers with set_fn
    g.counter("h2d_bytes_total").inc(1_048_576)
    g.counter("fetch_bytes_total").inc(4096)
    g.counter("compaction_spills").inc(1)
    g.gauge("compaction_ratio").set(0.015625)
    g.gauge("pipeline_occupancy").set_fn(lambda: 3)
    # controller series surface (runtime/controller.py mints these; the
    # algorithm itself is exercised in tests/test_obs_timeseries.py —
    # importing it here would pull the tpustream_torch package root)
    g.gauge("controller_async_depth").set(3)
    g.gauge("controller_objective_rows_per_s").set(123456.0)
    g.counter("controller_decisions_total").inc(4)
    # sharded-ingestion series (runtime/ingest.py, docs/performance.md):
    # per-lane parse counters / ring-occupancy gauges plus the merge
    # stall histogram the IngestPlane mints through the same group path
    lg = g.group(lane="0")
    lg.counter("ingest_lane_records_total").inc(256)
    lg.gauge("ingest_ring_occupancy").set(0.25)
    g.group(lane="1").counter("ingest_lane_records_total").inc(240)
    g.histogram("ingest_lane_stall_ms").observe(1.25)
    # lane supervision series (runtime/ingest.py self-healing,
    # docs/recovery.md): per-lane restart counters, the fold-out gauge,
    # and the pull-evaluated heartbeat age gauge
    lg.counter("ingest_lane_restarts_total").inc(1)
    lg.gauge("ingest_heartbeat_age_ms").set_fn(lambda: 12.5)
    g.group(lane="1").gauge("ingest_lane_folded").set(1)
    # multi-tenant fleet series (docs/multitenancy.md): the fleet-size
    # gauge plus per-tenant-labeled admission/quota/rule-version series
    # the JobServer mints through the same group path
    g.gauge("tenant_count").set(2)
    tg = g.group(tenant="acme")
    tg.counter("tenant_records_total").set_total(512)
    tg.counter("tenant_quota_exceeded_total").set_total(3)
    tg.gauge("tenant_rule_version").set(4)
    # per-tenant SLO surface (docs/multitenancy.md "Operating a fleet"):
    # attributed latency/error series plus a second, healthy tenant so
    # the --tenants view and the budget burn have a contrast case
    tg.gauge("tenant_error_rate").set(0.02)
    th = tg.histogram("tenant_e2e_latency_ms")
    for v in (5.0, 8.0, 13.0, 55.0):
        th.observe(v)
    og = g.group(tenant="globex")
    og.counter("tenant_records_total").set_total(64)
    og.gauge("tenant_error_rate").set(0.0)
    og.histogram("tenant_e2e_latency_ms").observe(4.0)
    # pre-flight analysis series (docs/analysis.md): per-code finding
    # counters the executor mints when the analyzer reports
    g.group(code="TSM009").counter("analysis_findings_total").inc()
    g.group(code="TSM012").counter("analysis_findings_total").inc()
    # schema-inference (TSM03x) and checkpoint-audit (TSM04x) codes land
    # through the same per-code counter path
    g.group(code="TSM030").counter("analysis_findings_total").inc()
    g.group(code="TSM040").counter("analysis_findings_total").inc()
    # the satellite escaping case: backslash, quote, and newline in a
    # label value must survive the Prometheus text exposition
    reg.group(job="selftest", operator='he"llo\\wo\nrld').counter(
        "operator_records_in"
    ).inc(1)
    engine = HealthEngine(
        [
            AlertRule(name="lag_crit", metric="watermark_lag_ms",
                      op=">", value=30_000),
            AlertRule(name="throughput", metric="records_in",
                      kind="absence", severity="warn"),
        ],
        gauge_group=g,
    )
    # per-tenant SLOs land in the SAME engine post-construction (the
    # fleet path): acme breaches both objectives, globex breaches none
    from .slo import TenantSLO, compile_tenant_slo

    slo = TenantSLO(p99_ms=50.0, max_error_rate=0.01, budget_window_s=60.0)
    engine.add_rules(compile_tenant_slo("acme", slo))
    engine.add_rules(compile_tenant_slo("globex", slo))
    snap = job_snapshot(reg, meta={"job": "selftest"})
    # two ticks 30 s apart: the budget burn is the time-weighted breach
    # fraction of the observed span (acme breached throughout -> 1.0)
    engine.evaluate(snap["metrics"]["series"], now_s=1.0)
    snap["health"] = engine.evaluate(snap["metrics"]["series"], now_s=31.0)
    flight = FlightRecorder(capacity=4)
    flight.record("config_resolved", config={"batch_size": 16})
    for i in range(6):
        flight.record("tick", i=i)
    flight.record(
        "rule_applied", old_version=1, new_version=2,
        rules={"threshold": 95.0},
    )
    # the supervisor's pre-restore state-layout audit breadcrumb
    # (runtime/supervisor.py _layout_audit; docs/recovery.md)
    flight.record(
        "checkpoint_audit",
        path="ckpt-0000000001.npz",
        verdict="compatible",
        codes=[],
    )
    flight.record_exception(ValueError("boom"), operator="window")
    dump = flight.dump(meta={"job": "selftest"})
    # lane supervision breadcrumbs (runtime/ingest.py, docs/recovery.md):
    # the full degradation ladder — died -> restarted -> folded ->
    # degraded — plus both watchdog events, in a ring of their own so
    # the bounded-ring checks above keep their pinned counts
    sflight = FlightRecorder(capacity=8)
    sflight.record(
        "watchdog_armed", scopes=["merge_wait", "producer_ring"],
        limit_ms=30000.0, stall_limit_ms=5000.0, lane_restart_budget=2,
    )
    sflight.record(
        "ingest_lane_died", lane=0, gen=0, shape="exit", exitcode=-9,
        rerouted_frames=2,
    )
    sflight.record("ingest_lane_restarted", lane=0, gen=1, restarts=1,
                   budget=2)
    sflight.record("ingest_lane_folded", lane=1, restarts=2, budget=2)
    sflight.record("ingest_degraded", lanes=2)
    sflight.record("watchdog_fired", scope="merge_wait", limit_ms=30000.0)
    sdump = sflight.dump(meta={"job": "selftest"})

    text = render(snap)
    prom = snap["prometheus"]

    # live-exposition round-trip: the same registry behind a real HTTP
    # server on an ephemeral loopback port, scraped with urllib
    import urllib.request

    from .serve import MetricsServer

    from .resources import collect_env_fingerprint as _collect_env

    _env_view = _collect_env().to_dict()

    class _Provider:
        health = engine

        def to_prometheus_text(self):
            return reg.to_prometheus_text()

        def snapshot(self):
            return job_snapshot(reg, meta={"job": "selftest"})

        def env_snapshot(self):
            return _env_view

    srv = MetricsServer(_Provider(), port=0)
    srv.start()
    try:
        scraped = urllib.request.urlopen(
            srv.url + "/metrics", timeout=5
        ).read().decode("utf-8")
        served_snap = _json.loads(
            urllib.request.urlopen(
                srv.url + "/snapshot.json", timeout=5
            ).read().decode("utf-8")
        )
        served_env = _json.loads(
            urllib.request.urlopen(
                srv.url + "/env.json", timeout=5
            ).read().decode("utf-8")
        )
        try:
            hz = urllib.request.urlopen(srv.url + "/healthz", timeout=5)
            hz_code = hz.status
        except urllib.error.HTTPError as e:  # crit -> 503 raises
            hz_code = e.code
    finally:
        srv.close()

    _slo_states = {r["rule"]: r["level"] for r in snap["health"]["rules"]}
    _slo_burns = {
        r["rule"]: float(r["budget_burn"])
        for r in snap["health"]["rules"]
        if r.get("budget_burn") is not None
    }
    _tenants_text = render_tenants(snap)

    checks = [
        # vs a fresh render, not ``prom``: the health evaluation above
        # minted series after that snapshot was taken
        ("serve round-trips the exposition",
         scraped == reg.to_prometheus_text()),
        ("serve escapes the hostile label over HTTP",
         'operator="he\\"llo\\\\wo\\nrld"' in scraped),
        ("serve snapshot carries the series",
         any(s["name"] == "records_in"
             for s in served_snap["metrics"]["series"])),
        ("healthz reflects the crit rule", hz_code == 503),
        ("serve env.json round-trips the fingerprint",
         served_env == _env_view),
        ("render names the counter", "records_in" in text),
        ("render names the histogram", "e2e_latency_ms" in text),
        ("render names the checkpoint cost histograms",
         "checkpoint_save_ms" in text and "checkpoint_bytes" in text),
        ("prometheus carries the restart cause label",
         "job_restarts_total" in prom and 'cause="device_step"' in prom),
        ("render names the cep counters",
         "cep_matches" in text and "cep_timeouts" in text),
        ("prometheus carries the cep counters",
         'cep_matches{job="selftest"} 7' in prom
         and 'cep_timeouts{job="selftest"} 3' in prom),
        ("render names the dynamic-rules series",
         "rule_version" in text and "rule_updates_total" in text
         and "rule_update_propagation_ms" in text),
        ("prometheus carries the dynamic-rules series",
         'rule_version{job="selftest"} 2' in prom
         and 'rule_updates_total{job="selftest"} 2' in prom),
        ("render names the pipeline wire counters",
         "h2d_bytes_total" in text and "fetch_bytes_total" in text),
        ("prometheus carries the pipeline wire counters",
         'h2d_bytes_total{job="selftest"} 1048576' in prom
         and 'fetch_bytes_total{job="selftest"} 4096' in prom),
        ("prometheus carries the compaction series",
         'compaction_spills{job="selftest"} 1' in prom
         and 'compaction_ratio{job="selftest"} 0.015625' in prom),
        ("set_fn occupancy gauge evaluates in the exposition",
         'pipeline_occupancy{job="selftest"} 3' in prom),
        ("flight keeps the rule_applied event",
         any(e["kind"] == "rule_applied"
             and e.get("new_version") == 2 for e in dump["events"])),
        ("render includes health", "health: CRIT" in text),
        ("prometheus escapes the hostile label",
         'operator="he\\"llo\\\\wo\\nrld"' in prom),
        ("lag rule is crit",
         snap["health"]["rules"][0]["level"] == "crit"),
        ("health render works",
         "lag_crit" in render_health(snap["health"])),
        ("flight ring bounded", len(dump["events"]) == 4),
        ("flight counts drops", dump["dropped_events"] == 6),
        ("flight keeps the checkpoint_audit breadcrumb",
         any(e["kind"] == "checkpoint_audit"
             and e.get("verdict") == "compatible"
             for e in dump["events"])),
        ("flight keeps the exception",
         dump["events"][-1]["kind"] == "exception"
         and dump["events"][-1]["operator"] == "window"),
        ("flight dump serializes", bool(_json.dumps(dump))),
        ("snapshot serializes", bool(_json.dumps(snap))),
        ("prometheus carries the controller series",
         'controller_async_depth{job="selftest"} 3' in prom
         and 'controller_decisions_total{job="selftest"} 4' in prom
         and 'controller_objective_rows_per_s{job="selftest"} 123456'
         in prom),
        ("render names the tenancy series",
         "tenant_count" in text and "tenant_records_total" in text),
        ("prometheus carries the per-tenant labels",
         'tenant_records_total{job="selftest",tenant="acme"} 512' in prom
         and 'tenant_quota_exceeded_total{job="selftest",tenant="acme"} 3'
         in prom),
        ("prometheus carries the fleet gauges",
         'tenant_count{job="selftest"} 2' in prom
         and 'tenant_rule_version{job="selftest",tenant="acme"} 4'
         in prom),
        ("prometheus carries the per-tenant error rate",
         'tenant_error_rate{job="selftest",tenant="acme"} 0.02' in prom),
        ("health carries the per-tenant SLO rule states",
         _slo_states.get("slo_p99[acme]") == "crit"
         and _slo_states.get("slo_err[acme]") == "crit"),
        ("healthy tenant's SLO rules stay ok",
         _slo_states.get("slo_p99[globex]") == "ok"
         and _slo_states.get("slo_err[globex]") == "ok"),
        ("breaching tenant burns its error budget",
         abs(_slo_burns.get("slo_err[acme]", 0.0) - 1.0) < 1e-6),
        ("healthy tenant keeps its error budget",
         _slo_burns.get("slo_err[globex]", 1.0) == 0.0),
        ("per-tenant rule gauges land in the exposition",
         'health_rule_state{job="selftest",rule="slo_err[acme]",'
         'tenant="acme"}' in scraped
         and 'slo_budget_burn{job="selftest",rule="slo_err[acme]",'
         'tenant="acme"}' in scraped),
        ("tenants render names both tenants",
         "acme" in _tenants_text and "globex" in _tenants_text),
        ("tenants render carries the SLO verdicts",
         "CRIT" in _tenants_text and "OK" in _tenants_text),
        ("render names the ingest-lane series",
         "ingest_lane_records_total" in text
         and "ingest_lane_stall_ms" in text),
        ("prometheus carries the per-lane ingest counters",
         'ingest_lane_records_total{job="selftest",lane="0"} 256' in prom
         and 'ingest_lane_records_total{job="selftest",lane="1"} 240'
         in prom),
        ("prometheus carries the ingest ring gauge",
         'ingest_ring_occupancy{job="selftest",lane="0"} 0.25' in prom),
        ("render names the analysis findings counter",
         "analysis_findings_total" in text),
        ("prometheus carries the per-code analysis findings",
         'analysis_findings_total{code="TSM009",job="selftest"} 1' in prom
         and 'analysis_findings_total{code="TSM012",job="selftest"} 1'
         in prom),
        ("prometheus carries the schema and audit finding codes",
         'analysis_findings_total{code="TSM030",job="selftest"} 1' in prom
         and 'analysis_findings_total{code="TSM040",job="selftest"} 1'
         in prom),
        ("prometheus carries the lane supervision series",
         'ingest_lane_restarts_total{job="selftest",lane="0"} 1' in prom
         and 'ingest_lane_folded{job="selftest",lane="1"} 1' in prom),
        ("set_fn heartbeat age gauge evaluates in the exposition",
         'ingest_heartbeat_age_ms{job="selftest",lane="0"} 12.5' in prom),
        ("flight keeps the watchdog breadcrumbs",
         any(e["kind"] == "watchdog_armed"
             and e.get("scopes") == ["merge_wait", "producer_ring"]
             for e in sdump["events"])
         and any(e["kind"] == "watchdog_fired"
                 and e.get("scope") == "merge_wait"
                 for e in sdump["events"])),
        ("flight keeps the degradation ladder in order",
         [e["kind"] for e in sdump["events"]
          if e["kind"].startswith("ingest_")]
         == ["ingest_lane_died", "ingest_lane_restarted",
             "ingest_lane_folded", "ingest_degraded"]),
    ]
    checks.extend(_selftest_timeseries())
    checks.extend(_selftest_profile())
    checks.extend(_selftest_trace())
    checks.extend(_selftest_resources())
    checks.extend(_selftest_ledger())
    checks.extend(_selftest_checkpoints())
    failed = [name for name, ok in checks if not ok]
    for name, ok in checks:
        sys.stdout.write(f"{'ok' if ok else 'FAIL'}: {name}\n")
    if failed:
        sys.stdout.write(f"selftest FAILED ({len(failed)} checks)\n")
        return 1
    sys.stdout.write(f"selftest ok ({len(checks)} checks)\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpustream_torch.obs.dump",
        description="Pretty-print a tpustream_torch observability snapshot.",
    )
    ap.add_argument(
        "path",
        nargs="?",
        help="snapshot .json, Snapshotter .jsonl, or bench JSON tail",
    )
    ap.add_argument(
        "--index",
        type=int,
        default=-1,
        help="which snapshot to show from a .jsonl time series (default: last)",
    )
    ap.add_argument(
        "--prom",
        action="store_true",
        help="print the embedded Prometheus exposition text instead",
    )
    ap.add_argument(
        "--health",
        action="store_true",
        help="show only the snapshot's health section",
    )
    ap.add_argument(
        "--profile",
        action="store_true",
        help="show only the continuous profiler's stage attribution "
        "(binding stage, per-stage shares, occupancy)",
    )
    ap.add_argument(
        "--trace",
        action="store_true",
        help="emit the unified Chrome-trace/Perfetto timeline JSON "
        "(StepTracer spans, lane spans, flight instants, sampled "
        "record flight paths); load it at ui.perfetto.dev",
    )
    ap.add_argument(
        "--tenants",
        action="store_true",
        help="show only the per-tenant fleet view (tenant-labeled "
        "series joined with per-tenant SLO states and budget burn)",
    )
    ap.add_argument(
        "--ledger",
        action="store_true",
        help="show only the conservation-ledger section (per-edge "
        "residuals, violation latches, per-sink digest anchors)",
    )
    ap.add_argument(
        "--checkpoints",
        action="store_true",
        help="treat PATH as a checkpoint DIRECTORY and render its "
        "retention tree (per-snapshot form/bytes/delta/tier, chunk "
        "store accounting, interrupted-GC marks)",
    )
    ap.add_argument(
        "--rules",
        help="JSON file with a list of alert-rule dicts to (re-)evaluate "
        "against the snapshot's series",
    )
    ap.add_argument(
        "--env",
        action="store_true",
        help="show the environment fingerprint: a snapshot's embedded "
        "one when a path is given, the LIVE host's otherwise",
    )
    ap.add_argument(
        "--selftest",
        action="store_true",
        help="run the built-in smoke test (no snapshot needed)",
    )
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    if args.env and not args.path:
        from .resources import collect_env_fingerprint

        sys.stdout.write(
            json.dumps(collect_env_fingerprint().to_dict(),
                       indent=2, sort_keys=True) + "\n"
        )
        return 0
    if not args.path:
        ap.error("path is required (or use --selftest / --env)")
    if args.checkpoints:
        out = render_checkpoints(args.path)
        sys.stdout.write(out)
        return 1 if out.startswith("no snapshots in ") else 0
    snap = _load(args.path, args.index)
    if args.env:
        env = snap.get("meta", {}).get("env") or snap.get("env")
        if not env:
            sys.stdout.write(
                "no environment fingerprint in this snapshot "
                "(pre-resource-plane capture)\n"
            )
            return 1
        sys.stdout.write(
            json.dumps(env, indent=2, sort_keys=True) + "\n"
        )
        return 0
    if args.rules:
        from .health import HealthEngine

        with open(args.rules) as f:
            rules = json.load(f)
        engine = HealthEngine(rules)
        snap["health"] = engine.evaluate(
            snap.get("metrics", {}).get("series", []),
            now_s=float(snap.get("meta", {}).get("at_s", 0.0)),
        )
    if args.prom:
        sys.stdout.write(snap.get("prometheus", ""))
    elif args.tenants:
        out = render_tenants(snap)
        sys.stdout.write(out)
        if out.startswith("no tenant-labeled"):
            return 1
    elif args.trace:
        from .tracing_export import timeline_from_snapshot

        timeline = timeline_from_snapshot(snap)
        if timeline is None:
            sys.stdout.write(
                "no trace section in this snapshot (requires "
                "ObsConfig.enabled with trace on)\n"
            )
            return 1
        sys.stdout.write(json.dumps(timeline, default=str) + "\n")
    elif args.ledger:
        led = snap.get("ledger")
        if not led:
            sys.stdout.write(
                "no ledger section in this snapshot (requires "
                "ObsConfig.enabled with ledger on)\n"
            )
            return 1
        sys.stdout.write(render_ledger(led))
    elif args.profile:
        prof = snap.get("profile")
        if not prof:
            sys.stdout.write(
                "no profile section in this snapshot (requires "
                "ObsConfig.enabled with trace on)\n"
            )
            return 1
        sys.stdout.write(render_profile(prof))
    elif args.health:
        health = snap.get("health")
        if not health:
            sys.stdout.write(
                "no health section in this snapshot (configure "
                "ObsConfig.health_rules, or pass --rules FILE)\n"
            )
            return 1
        sys.stdout.write(render_health(health))
    else:
        sys.stdout.write(render(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
