"""Counterparts of the JAX package's tests/test_obs_serve.py, all 9,
over both packages (fixture ``pk``): the live scrape endpoint's
``/metrics`` (hostile label values escaped over a real socket),
``/snapshot.json``, ``/healthz``, 404/405/500 replies, clean shutdown,
and a chapter-3 job scraped while it runs (the port's executor in the
``torch`` cases; both packages mint the state-memory series).
"""

import json
import urllib.error
import urllib.request

import pytest

from tests.test_torch_obs import pk  # noqa: F401


def _get(url, timeout=5):
    """(status, body) even for non-2xx replies."""
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


class _Health:
    def __init__(self, level):
        self.level_value = level

    def state(self):
        return {"level": self.level_value, "rules": []}


class _Provider:
    """Duck-typed stand-in for JobObs over a bare registry of package
    ``pk``."""

    def __init__(self, pk, reg, health=None):
        self._pk = pk
        self._reg = reg
        self.health = health

    def to_prometheus_text(self):
        return self._reg.to_prometheus_text()

    def snapshot(self):
        return self._pk.job_snapshot(self._reg, meta={"job": "t"})


@pytest.fixture()
def served(pk):
    reg = pk.MetricsRegistry()
    g = reg.group(job="t")
    g.counter("records_in").inc(5)
    # hostile label value: quote, backslash, newline must survive the
    # exposition over a real socket, not just in-process
    reg.group(job="t", operator='a"b\\c\nd').counter(
        "operator_records_in"
    ).inc(1)
    health = _Health("ok")
    srv = pk.MetricsServer(_Provider(pk, reg, health), port=0)
    srv.start()
    yield srv, health
    srv.close()


def test_serve_metrics_and_hostile_label_escaping(pk, served):
    srv, _ = served
    code, body = _get(srv.url + "/metrics")
    assert code == 200
    assert "tpustream_records_in" in body
    assert 'operator="a\\"b\\\\c\\nd"' in body


def test_serve_snapshot_json(pk, served):
    srv, _ = served
    code, body = _get(srv.url + "/snapshot.json")
    assert code == 200
    snap = json.loads(body)
    assert any(
        s["name"] == "records_in" for s in snap["metrics"]["series"]
    )


def test_serve_healthz_tracks_engine_level(pk, served):
    srv, health = served
    code, body = _get(srv.url + "/healthz")
    assert code == 200 and json.loads(body)["level"] == "ok"
    health.level_value = "crit"
    code, body = _get(srv.url + "/healthz")
    assert code == 503 and json.loads(body)["level"] == "crit"
    health.level_value = "warn"  # degraded-but-alive stays scrapable
    code, body = _get(srv.url + "/healthz")
    assert code == 200 and json.loads(body)["level"] == "warn"


def test_serve_unknown_path_404(pk, served):
    srv, _ = served
    code, body = _get(srv.url + "/nope")
    assert code == 404
    assert json.loads(body)["path"] == "/nope"


def test_serve_non_get_405(pk, served):
    srv, _ = served
    req = urllib.request.Request(
        srv.url + "/metrics", data=b"x", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=5)
    assert ei.value.code == 405
    assert ei.value.headers["Allow"] == "GET"


def test_serve_render_error_is_500_with_flight_breadcrumb(pk):
    class _Broken:
        health = None

        def to_prometheus_text(self):
            raise RuntimeError("registry gone")

        def snapshot(self):
            return {}

    flight = pk.FlightRecorder(16)
    srv = pk.MetricsServer(_Broken(), port=0, flight=flight)
    srv.start()
    try:
        code, body = _get(srv.url + "/metrics")
        assert code == 500
        assert "registry gone" in body
    finally:
        srv.close()
    events = [
        e for e in flight.dump()["events"]
        if e["kind"] == "serve_render_error"
    ]
    assert len(events) == 1


def test_serve_clean_shutdown(pk, served):
    srv, _ = served
    assert srv._thread.is_alive()
    srv.close()
    srv.close()  # idempotent
    assert not srv._thread.is_alive()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + "/metrics", timeout=2)


def test_serve_close_before_start_does_not_hang(pk):
    srv = pk.MetricsServer(_Provider(pk, pk.MetricsRegistry()), port=0)
    srv.close()  # shutdown() on a never-served loop would block forever


ET_LINES = [
    f"2020-01-01T00:{m:02d}:{s:02d} ch{(m + s) % 3} 1234567"
    for m in range(4)
    for s in range(60)
]


_LAG_RULE = dict(
    name="lag_crit", metric="watermark_lag_ms",
    op=">", value=30_000, severity="crit",
)


def _run_et(pk, serve: bool, probe=None):
    obs = pk.ObsConfig(
        enabled=True,
        serve_port=0 if serve else None,
        # evaluate health on every pump so the mid-job /healthz scrape
        # sees the engine's verdict, not its initial state
        snapshot_interval_s=1e-6 if serve else 0.0,
        health_rules=(pk.AlertRule(**_LAG_RULE),),
    )
    cfg = pk.StreamConfig(batch_size=16, key_capacity=64, obs=obs)
    env = pk.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(pk.TimeCharacteristic.EventTime)
    stream = pk.build_et(
        env,
        env.add_source(pk.ReplaySource(ET_LINES)),
        size=pk.Time.minutes(5),
        slide=pk.Time.seconds(5),
        delay=pk.Time.minutes(1),
    )
    if probe is not None:
        stream.add_sink(lambda x: probe(env, x))
    handle = stream.collect()
    env.execute("serve-e2e")
    return env, [repr(t) for t in handle.items]


def test_live_scrape_end_to_end(pk):
    """The acceptance path: a keyed job with ``serve_port=0`` scraped
    over HTTP while running — compile registry, HBM accounting and
    health all visible in the live exposition — and the emitted output
    identical to the same job without the server."""
    scrapes = {}

    def probe(env, _):
        srv = env.metrics.job_obs.server
        # overwrite on every emission: keep the LAST mid-job scrape (by
        # then health has evaluated and the window program has built)
        scrapes["metrics"] = _get(srv.url + "/metrics")
        scrapes["healthz"] = _get(srv.url + "/healthz")
        scrapes["snapshot"] = _get(srv.url + "/snapshot.json")

    env, served_out = _run_et(pk, serve=True, probe=probe)

    assert scrapes, "probe sink never fired"
    code, metrics = scrapes["metrics"]
    assert code == 200

    # (a) compile registry: one compile_count series per built program
    compile_lines = [
        l for l in metrics.splitlines()
        if l.startswith("tpustream_operator_compile_count{")
    ]
    assert compile_lines
    for line in compile_lines:
        assert float(line.rsplit(" ", 1)[1]) >= 1
    assert 'operator="window"' in "".join(compile_lines)

    # (b) state-memory accounting (obs/memory.py in both packages):
    # a nonzero total for the window program
    hbm = [
        l for l in metrics.splitlines()
        if l.startswith("tpustream_operator_hbm_state_bytes{")
        and "shard=" not in l
    ]
    assert hbm and all(float(l.rsplit(" ", 1)[1]) > 0 for l in hbm)

    # (c) /healthz reflects the engine: the 1-minute OOO delay keeps
    # watermark lag at 60000 ms, breaching the 30000 crit rule
    code, body = scrapes["healthz"]
    assert code == 503
    assert json.loads(body)["level"] == "crit"

    # snapshot endpoint serves the full series set mid-job
    code, body = scrapes["snapshot"]
    assert code == 200
    snap = json.loads(body)
    names = {s["name"] for s in snap["metrics"]["series"]}
    assert "operator_compile_count" in names
    assert "operator_key_table_load_factor" in names

    # the server is torn down with the job: socket refused afterwards
    srv = env.metrics.job_obs.server
    assert srv.closed
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + "/metrics", timeout=2)

    # serving must not perturb the job's emitted output
    _, plain_out = _run_et(pk, serve=False)
    assert served_out == plain_out

