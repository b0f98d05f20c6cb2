"""Schema inference (TSM025/TSM030-034) and the checkpoint state-layout
audit (TSM040-047) of the PyTorch port (``tpustream_torch/analysis/
{schema,state_audit}.py``), side by side with the JAX package's.

Counterparts of tests/test_schema_audit.py's contracts. Every job is
built in both packages from the same code with one node-id counter start
(``tests/test_torch_analysis.py::build_both``), and the port's findings
must be the JAX package's letter for letter, with ``tpustream_torch``
read as ``tpustream`` (TSM045's migration notes name the package's
directories). Every audit verdict must be the reference's, on:

* the checked-in format-version golden fixtures (tests/goldens/, v8-v13
  and the v12 incremental manifest form, all written by the JAX
  package), against what the port's ``validate_checkpoint`` /
  ``load_checkpoint`` / a real restore do;
* snapshots of several program families written by each package
  (``tests/test_torch_checkpoint_format.py``'s jobs), audited by both;
* doctored snapshots (a leaf's dtype changed, leaves missing or extra).

The expected leaf tree (names, dtypes, shapes, symbolic shapes, which
leaves shard on the key axis) is held equal to the reference's too. The
supervisor's hook skips a doomed snapshot, and an auditor crash never
blocks recovery (it leaves a ``checkpoint_audit`` breadcrumb with the
verdict ``crashed``).
"""

import dataclasses
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest

import tpustream_torch
from tests.test_torch_analysis import (PK, analyze_both, build_both, codes,
                                       each_package, norm)
from tests.test_torch_checkpoint_format import FAMILIES, mid_snapshot, run

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _goldens_mod():
    spec = importlib.util.spec_from_file_location(
        "make_checkpoint_goldens",
        os.path.join(GOLDENS, "make_checkpoint_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LINES = _goldens_mod().LINES


def fixture(version: int) -> str:
    return os.path.join(GOLDENS, f"ckpt-fv{version:02d}.npz")


def golden_env(P, ckdir, **over):
    """The job graph the golden fixtures were saved from (the chapter-2
    rolling max, batch_size=2), constructed but not run."""
    env = P.env(batch_size=2, checkpoint_dir=str(ckdir),
                checkpoint_interval_batches=1, **over)
    P.mod("jobs.chapter2_max").build(env, env.from_collection(LINES)).collect()
    return env


def fields(objs):
    """Dataclass records as field tuples (each package has its own
    classes, so records compare by their fields)."""
    if objs is None or dataclasses.is_dataclass(objs):
        return objs if objs is None else dataclasses.astuple(objs)
    return [fields(o) for o in objs]


def audit_both(build, path):
    """Both packages' audit of ``path`` against ``build``'s graph: the
    port's report, after holding its verdict, findings and expected
    leaf tree against the reference's."""
    envs = build_both(build)
    want = envs["jax"].audit_checkpoint(path)
    got = envs["torch"].audit_checkpoint(path)
    assert got.verdict == want.verdict
    assert [norm(str(f)) for f in got.findings] == [str(f) for f in want.findings]
    assert (got.expected is None) == (want.expected is None)
    if got.expected is not None and not want.expected.partial:
        assert fields(got.expected.leaves) == fields(want.expected.leaves)
    return got


class Ring:
    def __init__(self):
        self.events = []

    def record(self, kind, **payload):
        self.events.append((kind, payload))


def _extract(P):
    class Extract(P.mod("api.watermarks").BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(P.Time.seconds(1))

        def extract_timestamp(self, element):
            return int(float(element.split(" ")[3]) * 1000)

    return Extract()


def parse3(P):
    return P.mod("jobs.chapter3_bandwidth").parse


# ---------------------------------------------------------------------------
# schema rules: broken construction -> exact code; clean twin -> silent
# ---------------------------------------------------------------------------


def test_port_tsm025_unreadable_source_is_visible_info():
    ns = {}
    exec("def mystery(v):\n    return v\n", ns)

    def build(P):
        env = P.env()
        env.from_collection([]).map(P.parse).map(ns["mystery"]).print()
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM025")
    assert f.severity == "info"
    assert "source unavailable" in f.message


def test_port_tsm025_silent_for_readable_functions():
    def build(P):
        env = P.env()
        env.from_collection([]).map(P.parse).key_by(0).max(2).print()
        return env

    assert "TSM025" not in codes(analyze_both(build))


def test_port_tsm030_float_key_column():
    def build(P):
        env = P.env()
        env.from_collection([]).map(P.parse).key_by(2).max(2).print()
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM030")
    assert f.severity == "warn"
    assert "f64" in f.message


def test_port_tsm030_silent_for_string_key():
    def build(P):
        env = P.env()
        env.from_collection([]).map(P.parse).key_by(0).max(2).print()
        return env

    assert "TSM030" not in codes(analyze_both(build))


def test_port_tsm031_window_reduce_changes_schema():
    def build(P):
        env = P.env()
        (env.from_collection([]).map(P.parse).key_by(0)
         .time_window(P.Time.seconds(5))
         .reduce(lambda a, b: P.root.Tuple2(a.f0, a.f2 + b.f2)).print())
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM031")
    assert f.severity == "error"


def test_port_tsm031_rolling_reduce_changes_schema():
    def build(P):
        env = P.env()
        (env.from_collection([]).map(P.parse).key_by(0)
         .reduce(lambda a, b: P.root.Tuple2(a.f0, a.f2 + b.f2)).print())
        return env

    assert "TSM031" in codes(analyze_both(build))


def test_port_tsm031_silent_for_schema_preserving_reduce():
    def build(P):
        env = P.env()
        (env.from_collection([]).map(P.parse).key_by(0)
         .time_window(P.Time.seconds(5))
         .reduce(lambda a, b: P.Tuple3(a.f0, a.f1, a.f2 + b.f2)).print())
        return env

    assert "TSM031" not in codes(analyze_both(build))


def test_port_tsm032_fleet_parse_schema_mismatch():
    def build(P):
        server = P.mod("jobs.chapter6_tenant_fleet").make_fleet({"tenant00": 90.0})
        env = P.StreamExecutionEnvironment(server.config)
        env.from_collection([]).map(parse3(P)).filter(lambda v: v.f1 > 0).collect()
        env._tenancy = server
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM032")
    assert f.severity == "error"
    assert "template" in f.message


def test_port_tsm032_key_field_resolves_to_non_str():
    def build(P):
        c6 = P.mod("jobs.chapter6_tenant_fleet")
        plan = P.root.TenantPlan(parse=P.parse, build=c6.build,
                                 rules=c6.make_rules(), tenant_capacity=8,
                                 key_field=2)
        server = P.root.JobServer(plan, config=P.cfg())
        server.add_tenant("t0", rules={"threshold": 90.0})
        env = P.StreamExecutionEnvironment(server.config)
        server.build_job(env)
        return env

    assert "key_field" in next(
        f for f in analyze_both(build) if f.code == "TSM032").message


def test_port_tsm032_silent_for_real_fleet():
    found = analyze_both(lambda P: P.mod("jobs.chapter6_tenant_fleet").lint_env())
    assert "TSM032" not in codes(found)


def test_port_tsm033_packed_wire_without_compress():
    def build(P):
        env = P.env(packed_wire=True, h2d_compress=False)
        env.from_collection([]).map(parse3(P)).key_by(0).sum(1).print()
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM033")
    assert f.severity == "info"
    assert "f1" in f.message


def test_port_tsm033_silent_with_compression_or_no_i64():
    def compressed(P):
        env = P.env(packed_wire=True, h2d_compress=True)
        env.from_collection([]).map(parse3(P)).key_by(0).sum(1).print()
        return env

    def no_i64(P):
        env = P.env(packed_wire=True, h2d_compress=False)
        env.from_collection([]).map(P.parse).key_by(0).max(2).print()
        return env

    assert "TSM033" not in codes(analyze_both(compressed))
    assert "TSM033" not in codes(analyze_both(no_i64))


def _late_and_timeout_job(P, late_id, timeout_id):
    env = P.env()
    env.set_stream_time_characteristic(P.TimeCharacteristic.EventTime)
    pattern = (P.Pattern.begin("a").where(lambda r: r.f2 > 0)
               .times(2).within(P.Time.seconds(10)))
    keyed = (env.from_collection([])
             .assign_timestamps_and_watermarks(_extract(P))
             .map(P.parse).key_by(0))
    matches = P.CEP.pattern(keyed, pattern).select(
        _select_first, timeout_tag=P.OutputTag(timeout_id))
    (matches.key_by(0).time_window(P.Time.seconds(5))
     .allowed_lateness(P.Time.seconds(1))
     .side_output_late_data(P.OutputTag(late_id)).sum(2).print())
    return env


def _select_first(match):
    return match["a"][0]


def test_port_tsm034_tag_fed_disagreeing_schemas():
    found = analyze_both(lambda P: _late_and_timeout_job(P, "spill", "spill"))
    f = next(f for f in found if f.code == "TSM034")
    assert f.severity == "warn"
    assert "spill" in f.message
    assert "TSM003" in codes(found)


def test_port_tsm034_silent_for_distinct_tags():
    found = analyze_both(lambda P: _late_and_timeout_job(P, "late", "to"))
    assert "TSM034" not in codes(found)


def test_port_infer_schemas_chapter_goldens():
    reps = {}
    for ch in ("chapter1_threshold", "chapter3_bandwidth"):
        def build(P):
            env = P.env()
            P.mod(f"jobs.{ch}").build(env, env.from_collection([])).print()
            return env

        envs = build_both(build)
        reps[ch] = {side: PK[side].mod("analysis").infer_schemas(env)
                    for side, env in envs.items()}
        want, got = reps[ch]["jax"], reps[ch]["torch"]
        assert got.complete == want.complete
        assert fields(got.sink) == fields(want.sink)
        assert fields(got.stages) == fields(want.stages)
    rep = reps["chapter1_threshold"]["torch"]
    assert rep.complete and rep.sink.kinds == ["str", "str", "f64"]
    assert [f.name for f in rep.sink.fields] == ["f0", "f1", "f2"]
    rep = reps["chapter3_bandwidth"]["torch"]
    assert rep.sink.kinds == ["str", "i64"]
    (stage,) = rep.stages
    assert stage.stateful_kind == "window" and stage.mid.key_kind == "str"


def test_port_analyze_never_builds(monkeypatch):
    """``env.analyze()`` and ``infer_schemas()`` are pure graph work: no
    program is built and the build registry records nothing, for CEP,
    fleet and chained-window graphs."""
    import tpustream_torch.runtime.step as step
    from tpustream_torch.obs.compilation import CompileObs

    compiles = []
    monkeypatch.setattr(CompileObs, "record_compile",
                        lambda self, *a, **k: compiles.append((a, k)))
    monkeypatch.setattr(step, "build_program",
                        lambda *a, **k: compiles.append("build"))
    P = PK["torch"]
    for env in (_late_and_timeout_job(P, "late", "to"),
                P.mod("jobs.chapter6_tenant_fleet").lint_env()):
        env.analyze()
        P.mod("analysis").infer_schemas(env)
    assert compiles == []


# ---------------------------------------------------------------------------
# checkpoint state-layout audit vs the format-version golden fixtures
# ---------------------------------------------------------------------------


def test_port_audit_identical_job_is_compatible(tmp_path):
    report = audit_both(lambda P: golden_env(P, tmp_path / P.side), fixture(12))
    assert isinstance(report, tpustream_torch.analysis.state_audit.AuditReport)
    assert report.verdict == "compatible"
    assert report.findings == [] and report.reason is None
    assert len(report.expected.leaves) == len(report.manifest.leaves) == 4
    assert report.expected.format_version == 12


def test_port_audit_symbolic_shapes_name_the_key_axis(tmp_path):
    lays = {side: P.mod("analysis.state_audit").expected_layout(
        golden_env(P, tmp_path / side)) for side, P in PK.items()}
    assert fields(lays["torch"].leaves) == fields(lays["jax"].leaves)
    keyed = [l for l in lays["torch"].leaves if l.key_sharded]
    assert keyed and all(l.symbolic.startswith("(K") for l in keyed)
    assert lays["torch"].key_capacities == [1024]


def test_port_audit_grown_key_capacity_stays_compatible(tmp_path):
    report = audit_both(lambda P: golden_env(P, tmp_path / P.side,
                                             key_capacity=4096), fixture(12))
    assert report.verdict == "compatible"
    assert set(codes(report.findings)) == {"TSM043"}
    assert all(f.severity == "info" for f in report.findings)
    assert report.reason is None


def test_port_audit_missing_leaves_tsm040():
    def build(P):
        env = P.env(batch_size=2)

        def parse_pair(value):
            items = value.split(" ")
            return P.root.Tuple2(items[1], P.mod("javacompat").Double.parseDouble(items[3]))

        (env.from_collection(LINES).map(parse_pair)
         .key_by(0).sum(1).key_by(0).max(1).collect())
        return env

    report = audit_both(build, fixture(12))
    assert report.verdict == "incompatible"
    assert codes(report.findings) == ["TSM040"]
    assert report.reason.startswith("TSM040") and "stage1/" in report.reason


def test_port_audit_orphaned_leaves_tsm041():
    def build(P):
        env = P.env()
        P.mod("jobs.chapter1_threshold").build(env, env.from_collection([])).collect()
        return env

    report = audit_both(build, fixture(12))
    assert report.verdict == "incompatible"
    assert codes(report.findings) == ["TSM041"]
    assert "orphaned" in report.reason


def _doctored(tmp_path, name, change):
    """The v12 fixture with ``change(arrays)`` applied and its checksum
    made valid again."""
    from tpustream_torch.runtime.checkpoint import _META_KEY, _checksum

    path = tmp_path / name
    with np.load(fixture(12)) as z:
        arrays = {k: z[k] for k in z.files}
    change(arrays)
    leaves = [arrays[k] for k in sorted(arrays) if k.startswith("L")]
    meta = json.loads(bytes(arrays[_META_KEY]).decode())
    meta["checksum"] = _checksum(leaves)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return str(path)


def test_port_audit_leaf_dtype_change_tsm042(tmp_path):
    def narrow(arrays):
        arrays["L0002"] = arrays["L0002"].astype(np.float32)

    path = _doctored(tmp_path, "ckpt-narrow.npz", narrow)
    report = audit_both(lambda P: golden_env(P, tmp_path / P.side), path)
    assert report.verdict == "incompatible"
    assert codes(report.findings) == ["TSM042"]
    f = report.findings[0]
    assert "float64" in f.message and "float32" in f.message
    assert report.reason.startswith("TSM042")


def test_port_audit_parallelism_rescale_is_not_blocking(tmp_path):
    """A rescale at restore is supported: never incompatible, TSM047 an
    INFO, with the reference's message. The port builds the sharded
    program at ``parallelism=2``, so it derives the sharded layout and
    its verdict is the reference's, ``compatible``."""
    envs = build_both(lambda P: golden_env(P, tmp_path / P.side, parallelism=2))
    reports = {side: env.audit_checkpoint(fixture(12)) for side, env in envs.items()}
    for report in reports.values():
        assert report.verdict != "incompatible"
        assert next(f for f in report.findings
                    if f.code == "TSM047").severity == "info"
    assert reports["torch"].verdict == reports["jax"].verdict == "compatible"
    assert [norm(str(f)) for f in reports["torch"].findings if f.code == "TSM047"] \
        == [str(f) for f in reports["jax"].findings if f.code == "TSM047"]


def test_port_audit_unreadable_snapshot_tsm046(tmp_path):
    p = tmp_path / "ckpt-garbage.npz"
    p.write_bytes(b"not a zip at all")
    for P in PK.values():
        report = P.mod("analysis.state_audit").audit_manifest_only(str(p))
        assert report.verdict == "incompatible"
        assert codes(report.findings) == ["TSM046"]
    report = audit_both(lambda P: golden_env(P, tmp_path / P.side), str(p))
    assert report.verdict == "incompatible"


@pytest.mark.parametrize("version", [8, 9, 10, 11, 13])
def test_port_audit_version_verdict_matches_real_restore(tmp_path, version):
    """TSM045 parity: the port's auditor, validate_checkpoint and loader
    agree that a cross-version snapshot cannot restore, as the
    reference's do, with the same migration narrative."""
    from tpustream_torch.runtime.checkpoint import load_checkpoint, validate_checkpoint

    report = audit_both(lambda P: golden_env(P, tmp_path / P.side),
                        fixture(version))
    assert report.verdict == "incompatible"
    f = next(f for f in report.findings if f.code == "TSM045")
    assert f"v{version}" in f.message
    if version == 13:
        assert "future format" in f.message
    else:
        assert f"v{version + 1}:" in f.message
    assert f"format version {version}" in validate_checkpoint(fixture(version))
    with pytest.raises(ValueError, match="format version"):
        load_checkpoint(fixture(version))
    env = golden_env(PK["torch"], tmp_path / "restore")
    env.restore_from_checkpoint(fixture(version))
    with pytest.raises(ValueError, match="format version"):
        env.execute("doomed-restore")


def test_port_audit_compatible_verdict_matches_real_restore(tmp_path):
    from tpustream_torch.runtime.checkpoint import validate_checkpoint

    env = golden_env(PK["torch"], tmp_path)
    assert env.audit_checkpoint(fixture(12)).verdict == "compatible"
    assert validate_checkpoint(fixture(12)) is None
    env.restore_from_checkpoint(fixture(12))
    env.execute("golden-resume")


def test_port_latest_checkpoint_skips_future_format(tmp_path):
    from tpustream_torch.runtime.checkpoint import latest_checkpoint

    for v in (12, 13):
        shutil.copy(fixture(v), tmp_path / os.path.basename(fixture(v)))
    ring = Ring()
    assert latest_checkpoint(str(tmp_path), flight=ring) == str(
        tmp_path / "ckpt-fv12.npz")
    (skip,) = [p for k, p in ring.events if k == "checkpoint_skipped"]
    assert skip["path"].endswith("ckpt-fv13.npz")
    assert "format version 13" in skip["reason"]


def _hook(P, env, tmp_path):
    """The package's supervisor hook over a directory holding the v12
    fixture: (picked path, breadcrumbs)."""
    ring = Ring()
    audit = P.mod("runtime.supervisor")._layout_audit(env, env._sinks, ring)
    picked = P.mod("runtime.checkpoint").latest_checkpoint(
        str(tmp_path), flight=ring, audit=audit)
    return picked, ring.events


def test_port_supervisor_audit_hook_preempts_doomed_restore(tmp_path):
    shutil.copy(fixture(12), tmp_path / "ckpt-fv12.npz")

    def build(P):
        env = P.env()
        P.mod("jobs.chapter1_threshold").build(env, env.from_collection([])).collect()
        return env

    envs = build_both(build)
    results = {side: _hook(PK[side], env, tmp_path) for side, env in envs.items()}
    picked, events = results["torch"]
    assert picked is None
    audits = [p for k, p in events if k == "checkpoint_audit"]
    assert audits[0]["verdict"] == "incompatible" and "TSM041" in audits[0]["codes"]
    (skip,) = [p for k, p in events if k == "checkpoint_skipped"]
    assert skip["reason"].startswith("audit: TSM041")
    assert norm(repr(events)) == repr(results["jax"][1])


def test_port_supervisor_audit_passes_compatible_snapshot(tmp_path):
    shutil.copy(fixture(12), tmp_path / "ckpt-fv12.npz")
    env = golden_env(PK["torch"], tmp_path / "ck")
    picked, events = _hook(PK["torch"], env, tmp_path)
    assert picked == str(tmp_path / "ckpt-fv12.npz")
    audits = [p for k, p in events if k == "checkpoint_audit"]
    assert audits[0]["verdict"] == "compatible" and audits[0]["codes"] == []
    assert not [p for k, p in events if k == "checkpoint_skipped"]


def test_port_audit_crash_never_blocks_recovery(tmp_path, monkeypatch):
    """An auditor bug lets the snapshot through (the restore path stays
    authoritative) and leaves a ``checkpoint_audit`` breadcrumb."""
    shutil.copy(fixture(12), tmp_path / "ckpt-fv12.npz")
    env = golden_env(PK["torch"], tmp_path / "ck")
    monkeypatch.setattr(
        "tpustream_torch.analysis.state_audit.audit_checkpoint",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("auditor bug")))
    picked, events = _hook(PK["torch"], env, tmp_path)
    assert picked == str(tmp_path / "ckpt-fv12.npz")
    (crumb,) = [p for k, p in events if k == "checkpoint_audit"]
    assert crumb["verdict"] == "crashed" and "auditor bug" in crumb["error"]


def test_port_read_manifest_never_loads_arrays():
    m = PK["torch"].mod("analysis.state_audit").read_manifest(fixture(12))
    assert m.meta["version"] == 12
    assert [(l.dtype, l.shape) for l in m.leaves] == [
        ("int32", (1024,)), ("int32", (1024,)),
        ("float64", (1024,)), ("bool", (1024,))]
    ref = PK["jax"].mod("analysis.state_audit").read_manifest(fixture(12))
    assert fields(m.leaves) == fields(ref.leaves) and m.meta == ref.meta


def test_port_manifest_form_fixture_matches_inline(tmp_path):
    from tpustream_torch.analysis.state_audit import read_manifest
    from tpustream_torch.runtime.checkpoint import load_checkpoint, validate_checkpoint

    manifest_path = os.path.join(GOLDENS, "ckpt-fv12m.npz")
    m = read_manifest(manifest_path)
    assert m.meta["version"] == 12
    assert [(l.dtype, l.shape) for l in m.leaves] == [
        (l.dtype, l.shape) for l in read_manifest(fixture(12)).leaves]
    report = audit_both(lambda P: golden_env(P, tmp_path / P.side), manifest_path)
    assert report.verdict == "compatible"
    assert validate_checkpoint(manifest_path) is None
    inline, manifest = load_checkpoint(fixture(12)), load_checkpoint(manifest_path)
    assert len(inline.leaves) == len(manifest.leaves)
    for a, b in zip(inline.leaves, manifest.leaves):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# snapshots written by either package, audited by both
# ---------------------------------------------------------------------------

CROSS_FAMILIES = ["rolling_f64", "window_exact", "process", "session_reduce",
                  "count_sliding", "cep", "rules", "window_float32"]
# families whose parse (``int()`` of a field) resolves only at run time:
# their leaf tree is underivable before a run, in both packages
ADAPTIVE = {"session_reduce", "count_sliding"}


def _family_env(P, family):
    build, _, event_time, extra = FAMILIES[family]
    ns = type("NS", (), {"pkg": P.root, "sources": P.mod("runtime.sources"),
                         "windows": P.mod("api.windows")})
    env = P.env(batch_size=4, key_capacity=16, **extra)
    if event_time:
        env.set_stream_time_characteristic(P.TimeCharacteristic.EventTime)
    for s in build(ns, env, env.add_source(P.mod("runtime.sources").ReplaySource([]))):
        s.collect()
    return env


@pytest.mark.parametrize("family", CROSS_FAMILIES)
def test_port_audit_snapshots_of_either_package(tmp_path, family):
    """A mid-stream snapshot of ``family`` written by the JAX package and
    one written by the port: each audits ``compatible`` in both packages
    against the family's graph (``unknown`` in both where the parse
    resolves at run time), with the same findings and expected leaves; a
    snapshot of another family audits ``incompatible`` in both."""
    assert run("jax", family, ckdir=tmp_path / "jax") == run(
        "torch", family, ckdir=tmp_path / "torch")
    snap = mid_snapshot(tmp_path / "jax")
    port_snap = os.path.join(str(tmp_path / "torch"), os.path.basename(snap))
    for path in (snap, port_snap):
        report = audit_both(lambda P: _family_env(P, family), path)
        assert report.verdict == (
            "unknown" if family in ADAPTIVE else "compatible"), (family, path)
    other = "stateless" if family != "stateless" else "rolling_f64"
    report = audit_both(lambda P: _family_env(P, other), port_snap)
    assert report.verdict == "incompatible"


# ---------------------------------------------------------------------------
# audit CLI
# ---------------------------------------------------------------------------


def audit_cli_both(argv):
    def audit(P):
        buf = io.StringIO()
        rc = P.mod("analysis.audit").main(
            [a.format(pkg=P.name) for a in argv], out=buf)
        return rc, buf.getvalue()

    out = each_package(audit)
    assert out["torch"][0] == out["jax"][0]
    assert norm(out["torch"][1]) == out["jax"][1]
    return out["torch"]


def test_port_audit_cli_compatible_with_job():
    rc, text = audit_cli_both([fixture(12), "--job", "{pkg}.jobs.chapter2_max"])
    assert rc == 0 and "compatible" in text


def test_port_audit_cli_version_gap_exits_2():
    rc, text = audit_cli_both([fixture(11)])
    assert rc == 2 and "TSM045" in text


def test_port_audit_cli_json_record_shape():
    rc, text = audit_cli_both([fixture(8), "--format", "json"])
    assert rc == 2
    doc = json.loads(text)
    assert doc["verdict"] == "incompatible"
    assert doc["reason"].startswith("TSM045")
    assert doc["manifest"]["meta_version"] == 8
    catalog = tpustream_torch.analysis.CATALOG
    for rec in doc["findings"]:
        assert set(rec) == {"code", "severity", "node", "message", "fix_hint"}
        assert rec["code"] in catalog


# ---------------------------------------------------------------------------
# obs integration: the native-parse breadcrumb
# ---------------------------------------------------------------------------


def test_port_flight_names_native_parse_state():
    """The port's flight names whether the native parser is ready (its
    build has no sanitizer flavor to name)."""
    from tpustream_torch import native

    P = PK["torch"]
    env = P.env(obs=P.ObsConfig(enabled=True))
    handle = env.from_collection(["1563452051 10.8.22.1 cpu2 99.2"]).map(
        P.parse).collect()
    res = env.execute("native-breadcrumb")
    assert [repr(t) for t in handle.items] == ["(10.8.22.1,cpu2,99.2)"]
    kinds = [e["kind"] for e in res.metrics.job_obs.flight.events()]
    want = "native_parse_ready" if native.available() else "native_parse_unavailable"
    assert want in kinds
