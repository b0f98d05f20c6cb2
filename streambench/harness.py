"""One run of one cell: the port's job over the cell's traffic, a timed
window, the drain, and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the job, its ``StreamConfig`` sizes, its
  line format and its control (the program's own lower-precision path);
- ``reference/<config>.py``: the plain reference's ``expected``;
- ``workloads/<cell>.json``: the traffic's parameters, its generator's
  name and the untimed warm batches;
- ``traffic/<generator>.py``: a ``Traffic`` class;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the number, or
  None when the run has nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import ModuleType
from typing import Optional

import numpy as np

from streambench.check import LOSS_COUNTERS, Rows, compare_rows

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpustream")
# the Metrics stage lists and counters a window's readers take deltas of
STAGE_LISTS = ("host_times_s", "upload_times_s", "step_times_s",
               "fetch_times_s", "emit_times_s")
COUNTS = ("steps", "records_in", "records_emitted", "d2h_syncs")


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file, whatever characters its name holds."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``tpustream_torch`` is not
    ``tpustream``)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, manifest_path: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        manifest = json.loads(manifest_path.read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {manifest_path.name}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        cfg_entry = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = json.loads((manifest_path.parent / cfg_entry["file"]).read_text())
        self.params = json.loads((base / "workloads" / f"{name}.json").read_text())
        self.base = base
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def traffic(self, seed: int):
        gen = load_module(self.base / "traffic" / f"{self.params['generator']}.py",
                          f"streambench_traffic_{self.params['generator']}")
        return gen.Traffic(self.params, self.config["line"],
                           self.config["stream_config"]["batch_size"], seed)

    def reference(self) -> ModuleType:
        return load_module(self.base / "reference" / f"{self.config['name']}.py",
                           f"streambench_reference_{self.config['name']}")

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py",
                           f"streambench_metric_{metric}").read


class Run:
    """What a run measured, as the metric readers read it."""

    def __init__(self):
        self.setup_s = self.window_s = None
        self.events = 0            # events handed to the job in the window
        self.window_blocks = range(0)
        self.blocks = 0            # blocks handed to the job in the run
        self.stage = {}            # Metrics stage list: seconds in the window
        self.count = {}            # Metrics counter: delta over the window
        self.build_time_s = None
        self.tracer = None         # streambench.trace.Tracer under --trace 1
        self.traffic = None
        self.device_kind = None


def _snapshot(m) -> dict:
    snap = {n: len(getattr(m, n)) for n in STAGE_LISTS}
    snap.update({n: int(getattr(m, n)) for n in COUNTS})
    return snap


def bench_source(traffic, warm: int, seconds: float, run: Run, env, tracer):
    """The cell's closed loop: the next block whenever the job asks for
    one. Blocks ``0 .. warm - 1`` are untimed; the window opens as block
    ``warm`` is asked for and closes at the first ask ``seconds`` later;
    then the stream ends (the drain is untimed)."""
    from tpustream_torch.runtime.sources import Source, SourceBatch

    B = traffic.batch_size
    state = {}

    def open_window():
        if tracer is not None:
            tracer.start()  # the profiler's own start-up stays out
        state["t0"] = time.perf_counter()
        state["m0"] = _snapshot(env.metrics)

    def close_window(i: int):
        t1 = time.perf_counter()
        m1 = _snapshot(env.metrics)
        if tracer is not None:
            tracer.stop()
        m0, lists = state["m0"], env.metrics
        run.window_s = t1 - state["t0"]
        run.window_blocks = range(warm, i)
        run.events = (i - warm) * B
        run.stage = {n: float(sum(getattr(lists, n)[m0[n]:m1[n]]))
                     for n in STAGE_LISTS}
        run.count = {n: m1[n] - m0[n] for n in COUNTS}

    class BenchSource(Source):
        replayable = False

        def batches(self, batch_size, max_delay_ms):
            if batch_size != B:
                raise ValueError(f"blocks of {B} lines, steps of {batch_size}")
            i = 0
            while True:
                if i == warm:
                    open_window()
                elif i > warm and time.perf_counter() - state["t0"] >= seconds:
                    close_window(i)
                    break
                with tracer.range("source") if tracer else nullcontext():
                    raw = traffic.block(i)
                yield SourceBatch([], np.zeros(B, np.int64), raw=raw, n_raw=B)
                i += 1
            run.blocks = i
            yield SourceBatch([], np.empty(0, np.int64), final=True)

    return BenchSource(), state


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False,
             device: str = "cuda", control: bool = False,
             t_start: Optional[float] = None, log=print):
    """Run ``cell`` once: ``(result, run)``, the result line's dict
    (before the import check, which the caller makes) and what the run
    measured. ``control``: the configuration's control path in the
    program's place."""
    import torch

    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run()
    cfg = cell.config
    t = time.perf_counter()
    run.traffic = traffic = cell.traffic(seed)
    log(f"traffic: {traffic.pool_blocks} blocks of {traffic.batch_size} "
        f"lines rendered in {time.perf_counter() - t:.3f} s")
    tracer = None
    if trace:
        from streambench.trace import Tracer

        tracer = run.tracer = Tracer(device)
        tracer.wrap_stages()
    sizes = dict(cfg["stream_config"])
    if control:
        sizes.update(cfg["control"])
    job = importlib.import_module(cfg["job"])
    env = StreamExecutionEnvironment(StreamConfig(device=device, **sizes))
    if cfg["time"] == "event":
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    src, window = bench_source(traffic, int(cell.params["warm_batches"]),
                               seconds, run, env, tracer)
    rows_seen = Rows()
    job.build(env, env.add_source(src)).add_sink(rows_seen.sink())
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    try:
        env.execute(cfg["name"])
    finally:
        if tracer is not None:
            tracer.unwrap_stages()
    run.setup_s = window["t0"] - t_start
    m = env.metrics
    run.build_time_s = m.build_time_s
    peak = 0
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        run.device_kind = torch.cuda.get_device_name(0)
    if tracer is not None:
        tracer.reduce()
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    # the window has closed and the peak is read: free the program's
    # state, then hold every row against the reference
    losses = {n: int(getattr(m, n)) for n in LOSS_COUNTERS}
    fed, taken = run.blocks * traffic.batch_size, int(m.records_in)
    parses = (int(m.native_parses), int(m.numpy_parses))
    env._runner = None
    del env, src
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = cell.reference().expected(traffic.events(run.blocks), cfg)
    rows = compare_rows(rows_seen, want)
    log(f"check: reference and comparison of {rows['rows_due']} rows "
        f"in {time.perf_counter() - t:.3f} s; native parses {parses[0]}, "
        f"numpy parses {parses[1]}; first wrong row {rows['first_wrong']}")
    check = {"rows_wrong": (rows["rows_wrong"], 0),
             "sampled_rows_wrong": (rows["sampled_rows_wrong"], 0),
             "events_lost": (fed - taken, 0)}
    check.update({n: (v, 0) for n, v in losses.items()})
    result = {
        "correct": all(v <= lim for v, lim in check.values()),
        "attempted": rows["rows_due"],
        "failed": rows["rows_failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": run.device_kind or device,
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if tracer is not None:
        result["device"]["busy_s"] = tracer.busy_s
        result["device"]["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    result["check"] = {n: {"value": v, "limit": lim} for n, (v, lim) in check.items()}
    return result, run
