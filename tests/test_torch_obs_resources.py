"""Counterparts of the JAX package's tests/test_obs_resources.py that
need no ingest lanes, over both packages (fixture ``pk``): cgroup v1/v2
quotas and usable cores, the environment fingerprint, the ``/proc``
sampler on a canned ``/proc`` (lane PIDs are attached by hand there),
the contention health rule, the ``/env.json`` scrape and the null obs
root. The live two-lane job waits for the port's ingest lanes; the
``bench --compare`` cases belong to the JAX package's bench.

``_pid_stat_line`` (a ``/proc/<pid>/stat`` line builder) and the
contention rule's name are test fixtures taken from the JAX package.
"""

import json
import os
import urllib.request

import pytest

from tests.test_torch_obs import pk  # noqa: F401
from tpustream.obs.dump import _pid_stat_line
from tpustream.runtime.supervisor import LANE_CONTENTION_HEALTH_RULE_NAME


def _write(root, rel, body):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(body)


def _series(reg):
    return reg.snapshot()["series"]


def _value(series, name, **labels):
    for s in series:
        if s["name"] == name and all(
            s["labels"].get(k) == v for k, v in labels.items()
        ):
            return s["value"]
    raise AssertionError(f"no series {name} {labels}")


def test_cgroup_v2_quota(pk, tmp_path):
    _write(tmp_path, "cpu.max", "150000 100000\n")
    assert pk.cgroup_quota_cores(str(tmp_path)) == pytest.approx(1.5)


def test_cgroup_v2_unlimited(pk, tmp_path):
    _write(tmp_path, "cpu.max", "max 100000\n")
    assert pk.cgroup_quota_cores(str(tmp_path)) is None


def test_cgroup_v1_quota(pk, tmp_path):
    _write(tmp_path, "cpu/cpu.cfs_quota_us", "200000\n")
    _write(tmp_path, "cpu/cpu.cfs_period_us", "100000\n")
    assert pk.cgroup_quota_cores(str(tmp_path)) == pytest.approx(2.0)


def test_cgroup_v1_unlimited(pk, tmp_path):
    _write(tmp_path, "cpu/cpu.cfs_quota_us", "-1\n")
    _write(tmp_path, "cpu/cpu.cfs_period_us", "100000\n")
    assert pk.cgroup_quota_cores(str(tmp_path)) is None


def test_usable_cores_capped_by_quota(pk, tmp_path):
    # a 0.5-core quota must floor to 1 usable core, never 0
    _write(tmp_path, "cpu.max", "50000 100000\n")
    assert pk.usable_cores(str(tmp_path)) == 1
    # a fractional quota rounds up: 2.5 cores of quota -> 3 usable at
    # most, then capped by the scheduler affinity of this process
    _write(tmp_path, "cpu.max", "250000 100000\n")
    assert 1 <= pk.usable_cores(str(tmp_path)) <= 3


def test_usable_cores_no_cgroup(pk, tmp_path):
    # empty sysfs root: affinity alone decides
    assert pk.usable_cores(str(tmp_path)) >= 1


def test_fingerprint_deterministic_and_roundtrips(pk):
    a = pk.collect_env_fingerprint()
    b = pk.collect_env_fingerprint()
    assert a == b
    assert pk.EnvFingerprint.from_dict(a.to_dict()) == a
    assert a.comparability(b) == []
    assert str(a.usable_cores) in a.compact()


def test_fingerprint_comparability_reasons(pk):
    a = pk.collect_env_fingerprint()
    d = a.to_dict()
    d["usable_cores"] = a.usable_cores + 8
    d["backend"] = "tpu" if a.backend != "tpu" else "cpu"
    other = pk.EnvFingerprint.from_dict(d)
    reasons = a.comparability(other)
    assert len(reasons) >= 2
    assert any("usable cores" in r for r in reasons)
    assert any("backend" in r for r in reasons)
    # hostname differences alone do NOT make records incomparable
    d2 = a.to_dict()
    d2["host"] = "ffffffffffff"
    assert a.comparability(pk.EnvFingerprint.from_dict(d2)) == []


@pytest.fixture
def canned(pk, tmp_path):
    """A fake /proc with one deterministic host + process + two lane
    workers pinned to core 0; advancing it one tick moves every clock
    by a known amount."""
    proc = tmp_path / "proc"

    def tick0():
        _write(proc, "stat", "cpu  100 0 100 700 100 0 0 0\n")
        _write(proc, "self/statm", "5000 2500 300 1 0 800 0\n")
        _write(
            proc,
            "self/status",
            "voluntary_ctxt_switches:\t10\n"
            "nonvoluntary_ctxt_switches:\t3\n",
        )
        _write(proc, "111/stat", _pid_stat_line(111, "tsm-lane0", 50, 50, 0))
        _write(proc, "222/stat", _pid_stat_line(222, "tsm-lane1", 60, 40, 0))

    def tick1():
        # +200 busy / +800 total host ticks -> util 0.25; lane0 +60
        # ticks over 1 injected second -> util 0.6; lane1 +40 -> 0.4
        _write(proc, "stat", "cpu  250 0 150 1250 150 0 0 0\n")
        _write(
            proc,
            "self/status",
            "voluntary_ctxt_switches:\t15\n"
            "nonvoluntary_ctxt_switches:\t5\n",
        )
        _write(proc, "111/stat", _pid_stat_line(111, "tsm-lane0", 90, 70, 0))
        _write(proc, "222/stat", _pid_stat_line(222, "tsm-lane1", 80, 60, 0))

    reg = pk.MetricsRegistry()
    flight = pk.FlightRecorder(256)
    clock = iter((0.0, 1.0, 2.0, 3.0))
    sampler = pk.ResourceSampler(
        reg.group(job="t"),
        flight=flight,
        proc_root=str(proc),
        clock=lambda: next(clock),
        page_size=4096,
        ticks_per_s=100,
    )
    pids = {0: 111, 1: 222}
    sampler.attach_lanes(lambda: pids)
    return sampler, reg, flight, tick0, tick1, pids


def test_sampler_minted_series(pk, canned):
    sampler, reg, flight, tick0, tick1, _ = canned
    tick0()
    sampler.sample()
    tick1()
    sampler.sample()
    series = _series(reg)
    assert _value(series, "host_cpu_util") == pytest.approx(0.25)
    assert _value(series, "lane_cpu_util", lane="0") == pytest.approx(0.6)
    assert _value(series, "lane_cpu_util", lane="1") == pytest.approx(0.4)
    assert _value(series, "lane_core", lane="0") == 0
    assert _value(series, "lane_core", lane="1") == 0
    assert _value(series, "process_rss_bytes") == 2500 * 4096
    assert _value(series, "ctx_switches_total", kind="voluntary") == 15
    assert _value(series, "ctx_switches_total", kind="involuntary") == 5
    assert sampler.samples == 2


def test_sampler_contention_breadcrumbs(pk, canned):
    sampler, reg, flight, tick0, tick1, _ = canned
    tick0()
    sampler.sample()
    tick1()
    sampler.sample()
    # both lanes busy on core 0 AND their summed util ~1.0: the same
    # tick fires the same_core reason and the pinned reason
    series = _series(reg)
    assert _value(series, "lane_core_contention_total") >= 2
    crumbs = [
        e for e in flight.events() if e["kind"] == "lane_core_contention"
    ]
    assert {c["reason"] for c in crumbs} == {"same_core", "pinned"}
    # breadcrumbs are one-shot per (reason, core); the counter keeps
    # climbing on a repeat observation but the flight ring does not
    before = len(crumbs)
    tick1()
    sampler.sample()
    crumbs = [
        e for e in flight.events() if e["kind"] == "lane_core_contention"
    ]
    assert len(crumbs) == before


def test_sampler_vanished_lane_parked(pk, canned):
    sampler, reg, flight, tick0, tick1, pids = canned
    tick0()
    sampler.sample()
    tick1()
    sampler.sample()
    pids.pop(1)
    sampler.sample()
    series = _series(reg)
    assert _value(series, "lane_cpu_util", lane="1") == 0.0
    assert _value(series, "lane_core", lane="1") == -1
    assert 1 not in sampler.last_lane_util


def test_sampler_survives_empty_proc(pk, tmp_path):
    reg = pk.MetricsRegistry()
    sampler = pk.ResourceSampler(
        reg.group(job="t"), proc_root=str(tmp_path / "nope")
    )
    sampler.attach_lanes(lambda: {0: 999999})
    sampler.sample()
    sampler.sample()
    assert sampler.samples == 2


def test_contention_trips_health_rule(pk, canned):
    sampler, reg, flight, tick0, tick1, _ = canned
    tick0()
    sampler.sample()
    tick1()
    sampler.sample()
    engine = pk.HealthEngine(
        [
            pk.AlertRule(
                name=LANE_CONTENTION_HEALTH_RULE_NAME,
                metric="lane_core_contention_total",
                op=">",
                value=0.0,
                severity="warn",
                agg="sum",
            )
        ]
    )
    state = engine.evaluate(_series(reg), now_s=1.0)
    assert state["level"] == "warn"
    by_name = {r["rule"]: r for r in state["rules"]}
    assert by_name[LANE_CONTENTION_HEALTH_RULE_NAME]["level"] == "warn"


def test_env_json_scrape_roundtrip(pk):
    jo = pk.JobObs(
        pk.ObsConfig(enabled=True, serve_port=0), job_name="env-scrape"
    )
    try:
        with urllib.request.urlopen(
            jo.server.url + "/env.json", timeout=5
        ) as resp:
            served = json.loads(resp.read().decode())
        assert served == jo.env_snapshot()
        assert served["schema"] >= 1
        assert jo.env_compact()  # non-empty summary string
    finally:
        jo.close(dump=False)


def test_null_obs_has_env_surface(pk):
    assert pk.NULL_JOB_OBS.env_snapshot() is None
    assert pk.NULL_JOB_OBS.env_compact() is None
    assert pk.NULL_JOB_OBS.resources is None
    assert pk.NULL_JOB_OBS.env_fingerprint is None


def test_port_fingerprint_names_the_job_device(monkeypatch):
    """The port's fingerprint reports the job's device: ``cpu`` for a
    CPU job, and for a CUDA job the backend ``cuda``, the card's name
    and the visible card count (asked of torch, never of JAX)."""
    import torch

    from tpustream_torch.obs.resources import collect_env_fingerprint

    fp = collect_env_fingerprint(device="cpu")
    assert (fp.backend, fp.device_kind, fp.device_count) == ("cpu", "cpu", 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    fp = collect_env_fingerprint(device="cuda")
    assert (fp.backend, fp.device_kind, fp.device_count) == (
        "cuda", "NVIDIA H100 80GB HBM3", 4)
    assert fp.compact().startswith("cuda/NVIDIA H100 80GB HBM3x4@")
