"""The obs dump CLI of the PyTorch port (``tpustream_torch/obs/dump.py``),
side by side with the JAX package's.

The port's copy renders the same snapshot JSON to the same bytes as the
reference's ``render``/``main``: a registry-and-tracer snapshot (the
reference test's own), and a snapshot of an obs-enabled job of the port
in each view (table, ``--prom``, ``--health``, ``--tenants``,
``--ledger``, ``--profile``, ``--trace``, and ``--checkpoints`` over a
checkpoint directory). ``--selftest`` passes with the reference's pinned
check count, in process and as ``python -m tpustream_torch.obs.dump``.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

import tpustream.obs.dump as jax_dump
import tpustream_torch.obs.dump as torch_dump
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.obs import MetricsRegistry
from tpustream_torch.obs.snapshot import job_snapshot, write_snapshot
from tpustream_torch.obs.tracing import StepTracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main_both(argv):
    """Both CLIs' ``main(argv)``: the port's ``(rc, stdout)``, after
    holding it byte-equal to the reference's."""
    out = {}
    for side, mod in (("jax", jax_dump), ("torch", torch_dump)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv))
        out[side] = (rc, buf.getvalue())
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_port_dump_render_and_cli(tmp_path):
    reg = MetricsRegistry()
    g = reg.group(job="j", operator="window")
    g.counter("operator_records_in").inc(11)
    g.histogram("operator_step_time_s").observe_many([0.5, 1.5])
    tr = StepTracer(capacity=8)
    with tr.span("emit", step=1, operator="window"):
        pass
    path = tmp_path / "snap.json"
    write_snapshot(str(path), job_snapshot(reg, tr, meta={"job": "j"}))

    snap = json.loads(path.read_text())
    text = torch_dump.render(snap)
    assert text == jax_dump.render(snap)
    assert "operator_records_in" in text and "HISTOGRAM" in text
    assert "emit" in text
    rc, out = main_both([str(path)])
    assert rc == 0 and "operator_records_in" in out
    rc, out = main_both([str(path), "--prom"])
    assert rc == 0 and "tpustream_operator_records_in" in out


@pytest.fixture(scope="module")
def job_snapshot_path(tmp_path_factory):
    """A snapshot of the port's chapter-6 fleet with obs on (tenant
    series, health, the ledger, latency markers) and its checkpoint
    directory."""
    from tpustream_torch.jobs import chapter6_tenant_fleet as c6
    from tpustream_torch.obs.slo import TenantSLO

    base = tmp_path_factory.mktemp("dump")
    cfg = StreamConfig(device="cpu", batch_size=16,
                       checkpoint_dir=str(base / "ck"),
                       checkpoint_interval_batches=2,
                       obs=ObsConfig(enabled=True, latency_marker_interval_ms=1e-6))
    srv = c6.make_fleet({"t0": 85.0, "t1": 95.0}, quotas={"t0": 5}, config=cfg)
    srv.set_tenant_slo("t1", TenantSLO(p99_ms=50.0, max_error_rate=0.01))
    for t in ("t0", "t1"):
        srv.ingest(t, c6.tenant_lines(t, 24))
    res = srv.run("dump")
    path = base / "snap.json"
    path.write_text(json.dumps(res.metrics.obs_snapshot()))
    return str(path), str(base / "ck")


@pytest.mark.parametrize("view", ["", "--prom", "--health", "--tenants",
                                  "--ledger", "--profile", "--trace"])
def test_port_dump_job_snapshot_views_match(job_snapshot_path, view):
    path, _ = job_snapshot_path
    rc, out = main_both([path] + ([view] if view else []))
    assert rc == 0 and out


def test_port_dump_checkpoint_tree_matches(job_snapshot_path):
    _, ckdir = job_snapshot_path
    rc, out = main_both([ckdir, "--checkpoints"])
    assert rc == 0 and "ckpt-" in out


def test_port_dump_selftest_smoke():
    """``--selftest`` in process: every check holds, with the reference's
    pinned count (134), the analysis-findings checks among them."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert torch_dump.main(["--selftest"]) == 0
    out = buf.getvalue()
    assert "FAIL" not in out
    m = re.search(r"selftest ok \((\d+) checks\)", out)
    assert m and int(m.group(1)) == 134
    assert "ok: prometheus carries the per-code analysis findings" in out
    assert "ok: prometheus carries the schema and audit finding codes" in out
    assert "ok: flight keeps the checkpoint_audit breadcrumb" in out


def test_port_dump_selftest_as_a_module():
    """``python -m tpustream_torch.obs.dump --selftest``: exit 0, and no
    JAX in the process."""
    probe = ("import sys, runpy; sys.argv = ['dump', '--selftest']\n"
             "try:\n"
             "    runpy.run_module('tpustream_torch.obs.dump', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert 'jax' not in sys.modules\n"
             "    raise\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "selftest ok (134 checks)" in proc.stdout
