"""``BENCHMARK.json`` keeps the contract's shape: its keys, the
characters of its names and units, its bounds, and a file under
``streambench/`` for every configuration, reference, cell, generator
and metric it names."""

import json
import re

from streambench.harness import HERE as BENCH, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
        assert c["name"] in used


def test_cells():
    names = [w["name"] for w in M["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        params = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "traffic" / f"{params['generator']}.py").is_file()


def reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics():
    e2e, per = M["end_to_end"], M["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    cells = {w["name"] for w in M["workloads"]}
    for m in e2e + per:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in e2e else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    setup = {m["name"]: m for m in e2e}["setup_s"]
    assert setup["bound"] <= 0.25
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    by_name = {m["name"]: m for m in e2e}
    for m in per:
        assert one_line(m["layer"]) and m["moves"] in by_name
        for cell in m.get("workloads", cells):
            assert reports(cell, by_name[m["moves"]])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in e2e if reports(cell, m)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(reports(cell, m) for m in per)

