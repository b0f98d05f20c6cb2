"""A later change adds a configuration, a cell or a metric as files of
its own and entries in ``BENCHMARK.json``: the harness finds each by its
name, with no edit of a file that is there."""

import json
import shutil

from streambench.harness import Cell, run_cell


def test_new_config_cell_and_metric_are_found(tiny):
    bench = tiny.parent / "streambench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # a configuration: its file and its reference
    cfg = json.loads((bench / "configs" / "cpu_max.json").read_text())
    cfg["name"] = "cpu_max_copy"
    (bench / "configs" / "cpu_max_copy.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "reference" / "cpu_max.py",
                bench / "reference" / "cpu_max_copy.py")
    # a cell: its traffic parameters, for the committed generator
    params = json.loads((bench / "workloads" / "cpu_max.fleet128k.json").read_text())
    params.update(keys=64, lines_per_poll=4, interval_s=60)
    (bench / "workloads" / "cpu_max_copy.hosts64.json").write_text(json.dumps(params))
    # a metric: its reader
    (bench / "metrics" / "rows_per_s.py").write_text(
        "def read(run):\n"
        "    return run.count['records_emitted'] / run.window_s\n")
    m = json.loads(tiny.read_text())
    m["configs"].append({"name": "cpu_max_copy", "source": "a copy",
                         "file": "streambench/configs/cpu_max_copy.json",
                         "reduced": [], "why": "a copy"})
    m["workloads"].append({"name": "cpu_max_copy.hosts64", "config": "cpu_max_copy",
                           "traffic": "hosts64", "chips": 1, "why": "a copy"})
    m["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["cpu_max_copy.hosts64"]})
    tiny.write_text(json.dumps(m))
    res, _ = run_cell(Cell("cpu_max_copy.hosts64", tiny, bench), 4, 0.3,
                      device="cpu", log=lambda *a: None)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"events_per_s", "setup_s", "rows_per_s"}
    assert res["metrics"]["rows_per_s"]["value"] > 0
    for p, body in before.items():
        assert p.read_bytes() == body, p
