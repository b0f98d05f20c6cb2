"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout, holds each
against its plain PyTorch version on the card (float32, float64 and
int64, the int64 sums bitwise, a wrapping one among them), drives the chapter-2
rolling-max job through ``StreamExecutionEnvironment.execute`` at
1M keys, and checks every emitted row against a host oracle (phases
``kernel`` and ``job``). Phase ``flagship`` drives the chapter-3
event-time job (5 min / 5 s windows, 1 min delay) over 1M generated
lines at B = 131072 and 1M channels, in the exact and the 32-bit
configuration, checks every row against a host oracle and the loss
counters against 0, prints its throughput, wall split and, from a
second run, a ``torch.profiler`` split of four warm data steps beside
those steps' wall times, and holds small runs (the
event-time jump input, the processing-time goldens) against the same
job on the CPU; the flagship's lines also go through the host stage
with the native parser and with the numpy path, and the phase fails
unless the job's runs parsed natively. Phase ``chain`` drives a
two-stage rollup over the flagship's input: 1-minute event-time window
sums per channel, then a computed key (1,049 channel groups) and an
int64 rolling max on the kernel, every row against a numpy oracle in
emission order. Phases ``ch1``, ``avg`` and ``median`` drive the
chapter-1 threshold filter and the chapter-2 windowed average and
median over 1M lines each against host oracles, with the loss counters
at 0. Phase ``session`` drives session windows at the JAX bench's
phase-K configuration (B = K = 131072, gap and delay 1 s) over 1M lines,
``reduce`` in int32 (the scatter-reduce merge) and an ``aggregate`` mean
in float64 (the sorted merge); phase ``count`` drives tumbling and
sliding count-window ``reduce`` over 1M lines and a sliding ``process()``
over 100k; each against a numpy oracle with the loss counters at 0.
The session runs too must parse natively. Phase ``cep`` drives the
chapter-4 CEP job over the flagship's lines at B = 131072 and 1M
channels (every alert and timeout row against the host NFA oracle over
the same batches, the loss counters at 0, the rounds a step, a profiled
second run for the busy share) and one run of the JAX bench's phase-P
pattern (L = 5, 131072 uniform keys) against the oracle. Phase
``rules`` drives the chapter-5 job with three threshold updates over
1M chapter-1 lines and a rolling max whose filter reads the rule (on
the kernel, which must launch), each against a host oracle and each
program built once across the updates; the kernel is then held against
its plain version on the inputs of the max's second call. Phase
``fleet`` drives the
chapter-6 job server: 4096 tenants x 64 lines at B = 65536 with quotas,
mid-stream threshold updates, removals and late admissions, every
tenant's rows and quota side output against the chapter-6 oracle and
one program build; the same fleet from half the tenant capacity, which
must grow once; a profiled rerun of the first fleet; and a keyed fleet
(a tenant-namespaced rolling max on the kernel, 65,536 keys) against a
numpy running max, the kernel then held against its plain version on
the inputs of the keyed fleet's second call. Phase ``obs`` runs the
flagship's int32 configuration in three interleaved pairs, obs off and
the obs layer on (spans, snapshots, chapter 1's health rules, latency
markers, the live endpoint scraped while it runs), then the layer
without the scraper and the registry alone: equal rows, equal waits on
the card, one build, parsed scrapes, health at OK; then a short run
under ``torch.profiler``, whose events name the spans. Phase ``small`` holds the
goldens of the new jobs, ``max_by``, the allowed-lateness cases (main
and side-output rows), the session and count goldens, integer rolling
goldens, the chained-stage goldens, a punctuated-watermark job, the
chapter-4 and chapter-5 goldens and the subnormal probes (XLA's flush:
the chapter-2 mean, rolling max and median, a float32 rolling sum and a
filter over subnormal usages) on the card against the CPU. Each phase
prints its wall
time. Prints the card's name and power limit, one line per
kernel case (with a per-launch device-time split from ``torch.profiler``
for the main case, a cold-L2 time and ``torch.sort`` as a reference
point), a ``kernels`` JSON line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, when there is no CUDA
device, when the package is not beside this script, or when any phase
fails.

Phase ``analysis`` (after ``recovery``) runs the pre-flight analyzer:
``python -m tpustream_torch.analysis.lint`` over the chapter jobs as a
subprocess (exit 0, no error) and each job's ``analyze()`` timed, first
call and warm; chapter 2 at the job phase's shape under
``strict_analysis=True`` with obs on (rows against the oracle, the
kernel on its path, the pre-flight's share of the wall, the finding's
counter); a broken job (an event-time window without an assigner),
which must raise PlanAnalysisError with nothing allocated on the card
and nothing launched; the state-layout audit of the recovery phase's
snapshots (compatible; incompatible with TSM042 against a float32
graph); and ``python -m tpustream_torch.obs.dump --selftest``.

Phase ``acc32`` drives the 32-bit accumulator configurations: the
fixed-order float32 merge's kernels (``ordered_scatter_add``) against
their plain version at the flagship's plane (88 x 2^20 + 1 cells, B =
131072; uniform, skewed and one-key cells, subnormal values and values
that cancel into the subnormal range, twice for the same bits; each
case's bytes bound and chain bound, and a stable sort of the batch's
cells alone, which a sort-based merge would pay); the
flagship under float32 (rows against the int32 oracle, then with obs on:
every ledger residual 0, a savepoint restored in a fresh env whose
ledger verifies its anchors, the state bytes beside the exact
configuration's; then obs on with the ledger off and on in two
interleaved pairs, its cost); the chapter-2 mean under float32 and int32, every row
bitwise against a float32 arrival-order oracle (the merge's paths), and
under float32 at half the lines with one host sending half of them and
usages below float32's normal range (the long-run fold and the flush); a
rolling float32 sum on the rolling kernel's float64 path; one session
and one count-window job under float32.

Phase ``sharded`` (after ``acc32``) drives keyed state sharded over 8
shards in one process (``StreamConfig(parallelism=8)``): the flagship's
exact configuration at full width (1M channels, B = 131072), every row
against the host oracle as a multiset and the exchange's overflow 0; the
chapter-2 rolling max at full width, every row against the oracle in the
sharded order, the rolling kernel launched on every shard's plane and
each launch held bitwise against its plain version; the chapter-2 mean
under float32 at 4 shards, every row bitwise against the float32
arrival-order oracle, each call of the ordered merge held against its
plain version; a snapshot written at 8 shards restored at 4 and at 1;
and a run with ``exchange_capacity_factor=0.5`` whose overflow equals
the host's count.

Phase ``multiproc`` (after ``sharded``) drives one job over two
processes: two workers of this script (``--multiproc-worker RANK
PORT``, started with ``subprocess`` once both kernels and the native
parser are built) join a ``torch.distributed`` group on the ``gloo``
backend and share ``cuda:0``, 4 of the 8 shards each. The flagship
exact at full width, the chapter-2 rolling max (every launch of the
rolling kernel held against its plain version) and the chapter-2 mean
under float32 at 4 shards (every merge call likewise): the union of
both processes' rows against the host oracle, each process emitting a
non-empty, strict part; then the pair's snapshot, written by its
coordinator alone, restored here at 4 shards and at 1. It prints each
process's events/s, wall, steps, median step and waits a step, the
seconds and bytes of the collectives that crossed processes, and the
pair's events/s beside phase ``sharded``'s one-process figure.

Options (the default runs everything): ``--phases
kernel,job,flagship,chain,ch1,avg,median,session,count,cep,rules,fleet,obs,pipeline,recovery,analysis,acc32,sharded,multiproc,small``,
``--reps N`` (timed repeats per kernel case), ``--lines N`` (job input),
``--flagship-lines N`` (flagship, chain, recovery's flagship runs and
acc32 input), ``--obs-lines N`` (obs, and acc32's ledger-cost pairs),
``--pipeline-lines N`` (pipeline; ``--obs-lines`` also sizes the
analysis phase's strict run), ``--new-lines N`` (input of
ch1, avg and median), ``--window-lines N`` (input of session, count and
acc32's window jobs),
``--cep-lines N`` (input of cep and rules), ``--sharded-lines N``
(input of the sharded phase's flagship, rolling and mean runs),
``--multiproc-lines N`` (the same for the multiproc phase). The
defaults keep the whole run well inside 20 minutes: 786,432 lines (six
batches of 131,072, which the recovery crash at data step 5 needs) for the job, flagship, window and cep
inputs, 524,288 for the unprofiled ch1, avg and median, 327,680 for
the pipeline (20 frames of its lanes' source: more than the 16 its
producer runs ahead, so a killed lane respawns), 262,144 for obs, the
sharded and the multiproc phases (whose flagships span 10 minutes of
event time, two window lengths, not 20: their time is set by the window
ends to fire, not by the lines; the sharded snapshot's job 262,144),
50,000 for the dead letters; the fleet's tenants send 64
lines each (262,144 in all); the phase texts above give the shapes the
earlier runs used.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
L2_BYTES = 50 * 2**20
B_MAIN = 131072
K_MAIN = 1 << 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# a dependent float32 add's latency on Hopper, in cycles: a run of m
# values folded in arrival order takes at least m of them
ADD_LATENCY_CYCLES = 4


def build_kernels() -> None:
    """Build every kernel source of the package in parallel (one nvcc
    each) and print the compiler's register/spill report."""
    from tpustream_torch import kernels

    names = sorted(p.stem for p in kernels.KERNEL_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(kernels.build, names))
    print(f"built {names} in {time.perf_counter() - t0:.1f} s")
    for p in paths:
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def time_ms(fn, reps: int, before=None) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    two warm-up calls; ``before`` runs ahead of each call, untimed."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, calls: int):
    """``({kernel: device ms per call}, kernel launches per call)`` for
    the kernels ``fn`` launches, from a ``torch.profiler`` trace of
    ``calls`` calls (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split, launches = {}, 0
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)(<[^()]*>)?\(", e.key)
            split[name.group(0)[:-1] if name else e.key] = \
                e.device_time_total / calls / 1e3
            launches += e.count
    return split, launches / calls


def graph_launches(fn) -> int:
    """The device launches (kernels and memsets) one call of ``fn``
    enqueues, counted as the nodes of a CUDA graph captured from the
    call (its DOT dump). The capture runs nothing; unlike
    :func:`device_split` it does not depend on the profiler, which late
    in a long process drops kernel records."""
    import torch

    torch.cuda.synchronize()
    # kept, not instantiated, so that its nodes can be dumped
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        fn()
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the dump's notes
        path = f"{d}/graph.dot"
        g.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    g.reset()
    nodes = set(re.findall(r"graph_\d+_node_\d+", dot))
    if not nodes:
        raise AssertionError(f"no node in the captured graph's dump: "
                             f"{dot[:400]!r}")
    return len(nodes)


def same_bits(a, b) -> bool:
    """Equal values, equal zero signs, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(a) & torch.isnan(b)
    eq = (a == b) & (torch.signbit(a) == torch.signbit(b))
    return bool((eq | nan).all())


def interned_ids(names: np.ndarray) -> np.ndarray:
    """Key ids as the job's string table gives them: 0, 1, 2, ... in
    order of first arrival."""
    _, first, inverse = np.unique(names, return_index=True,
                                  return_inverse=True)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    return rank[inverse]


def kernel_phase(reps: int) -> dict:
    """Every dtype x op at the main path's shape, plus skewed, one-key,
    half-one-key and the job's own keys, kernel vs plain version on the
    card; sum twice for determinism; a cold-L2 time and ``torch.sort``
    as reference points for the main case."""
    import torch

    from tpustream_torch.ops import seq_rolling as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    inputs = {
        "uniform": rng.integers(0, K_MAIN, B_MAIN),
        # 1024 hot keys take 90% of the rows
        "skewed": np.where(rng.random(B_MAIN) < 0.9,
                           rng.integers(0, 1024, B_MAIN),
                           rng.integers(0, K_MAIN, B_MAIN)),
        "one_key": np.full(B_MAIN, 7),
        # one noisy host sends half the lines
        "half_one_key": np.where(rng.random(B_MAIN) < 0.5, 7,
                                 rng.integers(0, K_MAIN, B_MAIN)),
        # the job's first step: interned host ids in arrival order
        "job_keys": interned_ids(make_hosts(B_MAIN, K_MAIN, seed=7)),
    }
    cases = [(dt, op, "uniform") for dt in ("float32", "float64")
             for op in S.OPS]
    cases += [("float64", "max", "skewed"), ("float64", "max", "half_one_key"),
              ("float64", "max", "job_keys"), ("float64", "max", "one_key"),
              ("float32", "sum", "one_key"), ("float32", "sum", "half_one_key")]
    results = {}
    for dt_name, op, dist in cases:
        dt = getattr(torch, dt_name)
        keys_np = inputs[dist].astype(np.int32)
        keys = torch.from_numpy(keys_np).to(dev)
        vals = torch.from_numpy(rng.random(B_MAIN) * 100).to(dev, dt)
        # half the keys hold stored values, half start at the identity
        stored = torch.from_numpy(rng.random(K_MAIN) * 100).to(dev, dt)
        plane0 = torch.where(torch.arange(K_MAIN, device=dev) % 2 == 0,
                             stored, torch.full_like(stored, S.IDENTITY[dt][op]))
        pk, pr = plane0.clone(), plane0.clone()
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bad)
        er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=bad)
        torch.cuda.synchronize()
        err = max(float((ek - er).abs().max()), float((pk - pr).abs().max()))
        if op in ("max", "min"):
            ok = same_bits(ek, er) and same_bits(pk, pr)
            tol = "bitwise"
        else:
            # two summation orders of the same m values each differ from
            # the exact sum by at most (m-1)*eps*sum|v|, so from each
            # other by twice that; m = the key's rows in the batch + 1
            eps = torch.finfo(dt).eps
            mult = torch.bincount(keys.long(), minlength=K_MAIN) + 1
            abs_run = S.seq_rolling_reduce_ref(
                plane0.abs().double(), keys, vals.abs().double(), "sum",
                bad_keys=bad)
            bound = 2 * (mult[keys.long()] - 1).double() * eps * abs_run
            ok = bool(((ek.double() - er.double()).abs() <= bound).all())
            tol = "2*(m-1)*eps*sum|v| per row"
            # the tree order is fixed: a second launch gives the same bits
            p2 = plane0.clone()
            e2 = S.seq_rolling_reduce(p2, keys, vals, op, bad_keys=bad)
            torch.cuda.synchronize()
            if not (torch.equal(e2.view(torch.int32), ek.view(torch.int32))
                    and torch.equal(p2.view(torch.int32),
                                    pk.view(torch.int32))):
                raise AssertionError(
                    f"two launches of {dt_name} sum {dist} differ in bits")
            tol += "; two launches bitwise equal"
        if not ok or int(bad[0]) != 0:
            raise AssertionError(
                f"kernel != plain for {dt_name} {op} {dist}: max |diff| {err}"
                f", out-of-range count {int(bad[0])}")
        emis = torch.empty_like(vals)
        ms = time_ms(lambda: S.launch(pk, keys, vals, op, emis, bad), reps)
        plain_ms = time_ms(
            lambda: S.seq_rolling_reduce_ref(pr, keys, vals, op, bad), reps)
        touched = int(np.unique(keys_np).size)
        nbytes = B_MAIN * (4 + 2 * vals.element_size()) \
            + 2 * touched * vals.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[(dt_name, op, dist)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f"kernel seq_rolling_reduce {dt_name} {op} {dist} B={B_MAIN} "
              f"K={K_MAIN}: ok ({tol}) max_abs_err={err} ms={ms} "
              f"plain_ms={plain_ms} bound_ms={bound_ms} bytes={nbytes} "
              f"keys={touched}")
        if (dt_name, op, dist) == ("float64", "max", "uniform"):
            results[(dt_name, op, dist)]["device_launches_per_call"] = \
                main_reference_points(S, pk, keys, vals, op, emis, bad, ms,
                                      reps)

    results.update(kernel_int64_cases(S, rng, inputs, reps))

    # the sum's tree order against the sequential fold, on arbitrary values
    keys_np = rng.integers(0, 64, 4096).astype(np.int32)
    vals_np = rng.standard_normal(4096).astype(np.float32)
    plane_np = np.full(64, -0.0, np.float32)
    want = np.empty_like(vals_np)
    abs_run = np.zeros(64)
    bound = np.empty(4096)
    mult = np.zeros(64, np.int64)
    for i, (k, v) in enumerate(zip(keys_np, vals_np)):
        plane_np[k] = np.float32(plane_np[k] + v)
        want[i] = plane_np[k]
        abs_run[k] += abs(float(v))
        mult[k] += 1
        bound[i] = 2 * mult[k] * np.finfo(np.float32).eps * abs_run[k]
    plane = torch.full((64,), -0.0, dtype=torch.float32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    got = S.seq_rolling_reduce(plane, torch.from_numpy(keys_np).to(dev),
                               torch.from_numpy(vals_np).to(dev), "sum",
                               bad_keys=bad).cpu().numpy()
    diff = np.abs(got.astype(np.float64) - want)
    if not np.all(diff <= bound):
        raise AssertionError("kernel sum is outside the bound of the "
                             "sequential fold")
    print("kernel seq_rolling_reduce float32 sum 64 keys B=4096: within "
          f"2*(m-1)*eps*sum|v| of the sequential numpy fold (max |diff| "
          f"{diff.max()}, {int(np.sum(diff == 0))}/4096 rows bit-equal)")
    return results


I64_MAX = 2**63 - 1


def kernel_int64_cases(S, rng, inputs, reps) -> dict:
    """The int64 instantiation at the main path's shape: max, min and sum
    on uniform, skewed and one-key keys, and a one-key sum of values near
    INT64_MAX that wraps many times; each bitwise equal to the plain
    version, each sum launched twice with equal bits."""
    import torch

    dev = torch.device("cuda")
    cases = [(op, dist, "small") for op in S.OPS
             for dist in ("uniform", "skewed", "one_key")]
    cases.append(("sum", "one_key", "near_max"))
    results = {}
    for op, dist, scale in cases:
        keys_np = inputs[dist].astype(np.int32)
        keys = torch.from_numpy(keys_np).to(dev)
        if scale == "small":
            v = rng.integers(-10**9, 10**9, B_MAIN)
        else:
            v = rng.integers(I64_MAX - 2**40, I64_MAX, B_MAIN, dtype=np.int64)
        vals = torch.from_numpy(v).to(dev)
        stored = torch.from_numpy(rng.integers(-10**9, 10**9, K_MAIN)).to(dev)
        plane0 = torch.where(
            torch.arange(K_MAIN, device=dev) % 2 == 0, stored,
            torch.full_like(stored, S.IDENTITY[torch.int64][op]))
        pk, pr = plane0.clone(), plane0.clone()
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bad)
        er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=bad)
        torch.cuda.synchronize()
        ok = torch.equal(ek, er) and torch.equal(pk, pr) and int(bad[0]) == 0
        err = max(float((ek - er).abs().max()), float((pk - pr).abs().max()))
        tol = "bitwise"
        if op == "sum":
            p2 = plane0.clone()
            e2 = S.seq_rolling_reduce(p2, keys, vals, op, bad_keys=bad)
            torch.cuda.synchronize()
            ok = ok and torch.equal(e2, ek) and torch.equal(p2, pk)
            tol += "; two launches bitwise equal"
        if scale == "near_max":
            wraps = int((er < 0).sum())
            ok = ok and wraps > 0
            tol += f"; {wraps} running sums wrapped past INT64_MAX"
        label = f"int64 {op} {dist}" + (" near INT64_MAX" if scale == "near_max" else "")
        if not ok:
            raise AssertionError(f"kernel != plain for {label}: max |diff| {err}, "
                                 f"out-of-range count {int(bad[0])}")
        emis = torch.empty_like(vals)
        ms = time_ms(lambda: S.launch(pk, keys, vals, op, emis, bad), reps)
        plain_ms = time_ms(
            lambda: S.seq_rolling_reduce_ref(pr, keys, vals, op, bad), reps)
        touched = int(np.unique(keys_np).size)
        nbytes = B_MAIN * (4 + 2 * 8) + 2 * touched * 8
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[("int64", op, dist if scale == "small" else f"{dist}_near_max")] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f"kernel seq_rolling_reduce {label} B={B_MAIN} K={K_MAIN}: ok ({tol}) "
              f"max_abs_err={err} ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} "
              f"bytes={nbytes} keys={touched}")
    return results


def main_reference_points(S, plane, keys, vals, op, emis, bad, ms, reps):
    """For the main case: the device time of each launch of one call, the
    call with a cold L2, and a stable ``torch.sort`` of the same keys.
    Returns the device launches one call makes."""
    import torch

    launch = lambda: S.launch(plane, keys, vals, op, emis, bad)  # noqa: E731
    split, launches = device_split(launch, reps)
    busy = sum(split.values())
    print(f"kernel seq_rolling_reduce float64 max uniform: {launches} "
          f"device launches a call ({S.sort_passes(K_MAIN)} radix passes), "
          f"device time {busy} ms of {ms} ms; " + ", ".join(
              f"{name}={t}" for name, t in sorted(split.items())))
    # the host's time to issue one call, and a call's time when calls
    # queue back to back (the larger of host and device time)
    n = 10 * reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"kernel seq_rolling_reduce float64 max uniform: host_ms_per_call="
          f"{host_ms} back_to_back_ms_per_call={queued_ms}")
    # a write over more than the L2 between calls evicts keys, values and
    # plane, as a step that runs after other work would find them
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    cold = time_ms(launch, reps, before=lambda: flush.fill_(1))
    sort_ms = time_ms(lambda: torch.sort(keys, stable=True), reps)
    print(f"kernel seq_rolling_reduce float64 max uniform: cold_l2_ms={cold} "
          f"(a {2 * L2_BYTES >> 20} MB write between calls); reference "
          f"point torch.sort(keys, stable=True) sort_ms={sort_ms}")
    return launches


def capture_kernel_call(index: int = 1):
    """Keep the inputs of the path's ``index``-th call (0-based) of the
    rolling kernel, cloned before the call folds them: ``(box, undo)``,
    ``box["call"] = (plane, keys, vals, op)`` once the call was made."""
    from tpustream_torch.ops import rolling

    plain = rolling.seq_rolling_reduce
    box = {"calls": 0}

    def capture(plane, keys, vals, op="max", bad_keys=None, fresh=None):
        if box["calls"] == index:
            box["call"] = (plane.clone(), keys.clone(), vals.clone(), op)
        box["calls"] += 1
        return plain(plane, keys, vals, op, bad_keys=bad_keys, fresh=fresh)

    rolling.seq_rolling_reduce = capture
    return box, lambda: setattr(rolling, "seq_rolling_reduce", plain)


def path_kernel_case(label: str, call, reps: int) -> dict:
    """The kernel against its plain version on one call's inputs as a
    main path gave them (a max or min: bitwise), its time and the plain
    version's, and the bound from this call's bytes: keys, values and
    emissions once a row, the touched plane entries read and written
    once. (No launch count from ``device_split`` here: late in the
    script the profiler dropped kernel records, counting 0.5 launches
    for a call that is one launch by construction.)"""
    import torch

    from tpustream_torch.ops import seq_rolling as S

    plane0, keys, vals, op = call
    if op not in ("max", "min"):
        raise AssertionError(f"{label}: no bitwise check for a {op}")
    pk, pr = plane0.clone(), plane0.clone()
    bad = torch.zeros(1, dtype=torch.int32, device=keys.device)
    ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bad)
    er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=bad)
    torch.cuda.synchronize()
    err = max(float((ek - er).abs().nan_to_num().max()),
              float((pk - pr).abs().nan_to_num().max()))
    if not (same_bits(ek, er) and same_bits(pk, pr)) or int(bad[0]):
        raise AssertionError(f"{label}: kernel != plain, max |diff| {err}, "
                             f"out-of-range count {int(bad[0])}")
    emis = torch.empty_like(vals)
    ms = time_ms(lambda: S.launch(pk, keys, vals, op, emis, bad), reps)
    plain_ms = time_ms(
        lambda: S.seq_rolling_reduce_ref(pr, keys, vals, op, bad), reps)
    rows, size = keys.numel(), vals.element_size()
    touched = int(torch.unique(keys[keys >= 0]).numel())
    nbytes = rows * (keys.element_size() + 2 * size) + 2 * touched * size
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dtype = str(vals.dtype).rsplit(".", 1)[-1]
    print(f"kernel seq_rolling_reduce {dtype} {op} on the {label} path's "
          f"call: B={rows} K={plane0.numel()} keys={touched} padding="
          f"{int((keys < 0).sum())}: ok (bitwise) max_abs_err={err} ms={ms} "
          f"plain_ms={plain_ms} bound_ms={bound_ms} bytes={nbytes}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def make_hosts(n: int, n_hosts: int, seed: int) -> np.ndarray:
    """The host number of each of :func:`make_lines`'s lines."""
    return np.random.default_rng(seed).integers(0, n_hosts, n)


def make_lines(n: int, n_hosts: int, seed: int):
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, n_hosts, n)
    cpus = rng.integers(0, 8, n)
    usage = rng.integers(0, 10000, n)
    return [
        f"{1563452000 + i} 10.{h >> 16}.{(h >> 8) & 255}.{h & 255} "
        f"cpu{c} {u / 100}"
        for i, (h, c, u) in enumerate(zip(hosts.tolist(), cpus.tolist(),
                                          usage.tolist()))
    ]


def oracle_rows(lines):
    """Flink's rolling max over (host, cpu, usage): keep-first cpu,
    running-max usage (the logic of tests/test_chapter2_max_golden.py)."""
    state, rows = {}, []
    for line in lines:
        _, host, cpu, usage = line.split(" ")
        u = float(usage)
        s = state.get(host)
        if s is None:
            s = state[host] = [host, cpu, u]
        elif u > s[2]:
            s[2] = u
        rows.append((s[0], s[1], s[2]))
    return rows


def job_phase(n_lines: int) -> dict:
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.sources import ReplaySource

    t0 = time.perf_counter()
    lines = make_lines(n_lines, K_MAIN, seed=7)
    print(f"job input: {n_lines} lines generated in "
          f"{time.perf_counter() - t0:.1f} s")
    env = StreamExecutionEnvironment(
        StreamConfig(batch_size=B_MAIN, key_capacity=K_MAIN))
    handle = build(env, env.add_source(ReplaySource(lines))).collect()
    S.reset_launches()
    t0 = time.perf_counter()
    env.execute("ComputeCpuMax")
    wall = time.perf_counter() - t0
    launches = S.seq_rolling_reduce.launches
    m = env.metrics
    want = oracle_rows(lines)
    got = [tuple(t.values()) for t in handle.items]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if len(got) == len(want) else None
        raise AssertionError(
            f"job output differs from the oracle: {len(got)} rows vs "
            f"{len(want)}, first bad row {bad}")
    if launches < m.steps or m.steps < 1:
        raise AssertionError(
            f"kernel launched {launches} times over {m.steps} steps")
    s = m.summary()
    n_keys = len(set(r[0] for r in want))
    print(f"job chapter2_max: {n_lines} lines, {n_keys} keys, "
          f"{m.steps} steps, all rows equal the oracle; "
          f"kernel launches={launches}")
    # the first step also loads the kernel library and warms the allocator
    print(f"job events_per_s_end_to_end={n_lines / wall} wall_s={wall} "
          f"step_ms_first={m.step_times_s[0] * 1e3} step_ms_median_rest="
          f"{statistics.median(m.step_times_s[1:] or m.step_times_s) * 1e3} "
          f"parse_s={s['host_time_s']} upload_s={s['upload_time_s']} "
          f"device_s={s['device_time_s']} fetch_s={s['fetch_time_s']} "
          f"emit_s={s['emit_time_s']}")
    job_device_share(lines[: 4 * B_MAIN])
    return {"seq_rolling_reduce": launches}


def job_device_share(lines) -> None:
    """The job again over four batches, traced by ``torch.profiler``
    (CUDA activity only): the device time per step of the keyed-reduce
    kernel and of all kernels, against the median host-clock time of the
    steps after the first."""
    from torch.profiler import ProfilerActivity, profile

    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.runtime.sources import ReplaySource

    env = StreamExecutionEnvironment(
        StreamConfig(batch_size=B_MAIN, key_capacity=K_MAIN))
    build(env, env.add_source(ReplaySource(lines))).collect()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        env.execute("ComputeCpuMax")
    kernel_ms = all_ms = 0.0  # all: every kernel and copy on the card
    for e in prof.key_averages():
        all_ms += e.device_time_total / 1e3
        if "seq_rolling_kernel" in e.key:
            kernel_ms += e.device_time_total / 1e3
    steps = env.metrics.steps
    warm_ms = statistics.median(env.metrics.step_times_s[1:]) * 1e3
    print(f"job traced: {steps} steps, step_ms_median_rest={warm_ms} "
          f"device_ms_per_step_all={all_ms / steps} "
          f"device_ms_per_step_seq_rolling={kernel_ms / steps} "
          f"kernel_share_of_step={kernel_ms / steps / warm_ms} "
          f"device_busy_share_of_step={all_ms / steps / warm_ms}")


# -- phase flagship: the chapter-3 event-time job ---------------------------

T0_SEC = 1_566_957_600  # 2019-08-28T10:00:00 at UTC+8, the job's zone
SIZE_MS, SLIDE_MS = 300_000, 5_000
FLAGSHIP_CONFIGS = {
    "exact": {},
    # the 32-bit configuration: scatter-add planes and a fire budget
    "int32": {"acc_dtype": "int32", "max_fires_per_step": 4},
}
ET_LINES = [
    "2019-08-28T10:00:00 www.163.com 10000",
    "2019-08-28T10:01:00 www.163.com 100",
    "2019-08-28T10:02:00 www.163.com 100",
    "2019-08-28T09:01:00 www.163.com 100",
    "2019-08-28T10:06:00 www.163.com 100",
]
JUMP_LINES = [
    "2019-08-28T09:03:00 www.163.com 1000",
    "2019-08-28T09:04:00 www.163.com 2000",
    "2019-08-28T09:05:00 www.163.com 3000",
    "2019-08-28T09:01:00 www.163.com 9999",
    "2019-08-28T10:06:00 www.163.com 5000",
]
FLOW_LINES = [
    "2019-08-28T10:00:00 www.163.com 10000",
    "2019-08-28T10:01:00 www.163.com 100",
    "2019-08-28T10:02:00 www.163.com 100",
    "2019-08-28T10:03:00 www.163.com 1000",
]


def make_flagship_input(n: int, n_channels: int, seed: int,
                        span_s: int = 1200):
    """``(lines, ts_sec, channel)``: n lines ``ISO-ts channel flow`` over
    ``span_s`` of event time, each jittered back by up to 30 s (under the
    1 min delay, so nothing is late); half from 1024 hot channels, half
    uniform over ``n_channels``. Channels with ``id % 128 == 0`` send
    1-1000 bytes and alert; the rest send 1e9 bytes (127 Mbps, filtered)."""
    rng = np.random.default_rng(seed)
    ts = T0_SEC + (np.arange(n, dtype=np.int64) * span_s) // n \
        - rng.integers(0, 31, n)
    ch = np.where(rng.random(n) < 0.5, rng.integers(0, 1024, n),
                  rng.integers(0, n_channels, n))
    flow = np.where(ch % 128 == 0, rng.integers(1, 1001, n), 10**9)
    tz = datetime.timezone(datetime.timedelta(hours=8))
    iso = {int(t): datetime.datetime.fromtimestamp(int(t), tz).strftime(
        "%Y-%m-%dT%H:%M:%S") for t in np.unique(ts)}
    lines = [f"{iso[t]} www.{c:07d}.com {f}" for t, c, f in
             zip(ts.tolist(), ch.tolist(), flow.tolist())]
    return lines, ts, ch, flow


def flagship_oracle(ts, ch, flow, int32_panes=False):
    """Flink's sliding event-time windows (5 min, 5 s): the flows of each
    channel are summed per 5 s pane, and a window sums its 60 panes;
    nothing is late and the end of the stream fires every window, so the
    rows are every (window, channel) that passes the filter, in order of
    window end, then of the channel's first arrival (its key id). Mbps
    as the job computes it (a division by a constant is a multiply by
    its reciprocal, as in the JAX package), filtered < 100.

    ``int32_panes``: the 32-bit configuration stores each pane sum in
    int32, which wraps mod 2^32 (three 1e9-byte records already do), and
    adds the stored pane sums in int64 at the fire, as the JAX package
    does. A channel whose pane sums are all exact has windows of at
    least 1e9 bytes unless it alerts (``id % 128 == 0``), so only the
    alerting channels and those with a wrapped pane sum are enumerated."""
    rank = interned_ids(ch)
    n_win = SIZE_MS // SLIDE_MS
    cells, inv = np.unique((ts * 1000 // SLIDE_MS) * (1 << 21) + rank,
                           return_inverse=True)
    part = np.zeros(cells.size, np.int64)
    np.add.at(part, inv, flow)
    stored = ((part + 2**31) % 2**32) - 2**31 if int32_panes else part
    cell_key, cell_pane = cells % (1 << 21), cells >> 21
    names = np.empty(rank.max() + 1, np.int64)
    names[rank] = ch
    keep = np.zeros(names.size, bool)
    keep[names % 128 == 0] = True
    keep[cell_key[stored != part]] = True
    sel = keep[cell_key]
    # pane p lies in the windows ending at (p + 1) * slide .. (p + 60) * slide
    ends = ((cell_pane[sel, None] + 1 + np.arange(n_win)) * SLIDE_MS).ravel()
    keys = np.repeat(cell_key[sel], n_win)
    wins, winv = np.unique(ends * (1 << 21) + keys, return_inverse=True)
    sums = np.zeros(wins.size, np.int64)
    np.add.at(sums, winv, np.repeat(stored[sel], n_win))
    mbps = sums * 8.0 * (1 / 60) * (1 / 1024) * (1 / 1024)
    return [(f"www.{int(names[k]):07d}.com", float(m)) for k, m in
            zip(wins % (1 << 21), mbps) if m < 100.0]


def run_flagship(lines, device, batch=B_MAIN, keys=K_MAIN, processing=False,
                 **config):
    """The chapter-3 job (event time, or the processing-time job) through
    ``execute``: (rows, metrics, wall seconds)."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth, chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

    env = StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=batch, key_capacity=keys,
        alert_capacity=1 << 16, **config))
    if processing:
        env.set_stream_time_characteristic(TimeCharacteristic.ProcessingTime)
        src = ReplaySource(lines + [AdvanceProcessingTime(61_000)])
        handle = chapter3_bandwidth.build(env, env.add_source(src)).collect()
    else:
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        handle = chapter3_bandwidth_eventtime.build(
            env, env.add_source(ReplaySource(lines))).collect()
    t0 = time.perf_counter()
    env.execute("BandwidthMonitorWithEventTime")
    return [repr(t) for t in handle.items], env.metrics, time.perf_counter() - t0


def profile_steps(label: str, program_cls, run, main_step_s: list,
                  first: int = 2, n: int = 2) -> None:
    """``run()`` (the job again; returns its Metrics) with
    ``torch.profiler`` (CPU and CUDA activity) on from data step
    ``first`` through data step ``first + n - 1`` of ``program_cls``
    (0-based, warm), with the drain steps among them and none after. Each program step in that window runs in a labelled
    range, so the device time of an aten op (the kernels it launches
    itself) belongs to the step that issued it. Prints, from the same
    steps of this one run: each data step's wall and device ms, the
    drain steps' (int32 config) apart, the card's busy share of a warm
    data step and the device ms of a data step by op (top 10); and the
    same steps' wall ms in the unprofiled run (``main_step_s``), where
    the host issues the same kernels without the profiler's cost, with
    the busy share against those. The end-of-stream flush lies outside
    the window."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = []  # (step index, "data" | "drain") of the profiled steps
    seen = {"steps": 0, "data": 0, "on": False, "last_done": False}
    plain_step = program_cls.step

    def step(self, state, cols, valid, ts, wm_lower):
        i = seen["steps"]
        seen["steps"] += 1
        kind = "data" if valid.shape[0] > 1 else "drain"  # drains: 1 row
        d = seen["data"]
        if seen["last_done"]:
            # stopping takes seconds: it falls in the step after the
            # window, which is not reported
            prof.stop()
            seen["on"] = seen["last_done"] = False
        if kind == "data":
            seen["data"] += 1
            if d == first:
                prof.start()
                seen["on"] = True
        if not seen["on"]:
            return plain_step(self, state, cols, valid, ts, wm_lower)
        window.append((i, kind))
        with record_function(f"chip_smoke_step_{i}"):
            out = plain_step(self, state, cols, valid, ts, wm_lower)
            torch.cuda.synchronize()
        seen["last_done"] = kind == "data" and d == first + n - 1
        return out

    program_cls.step = step
    try:
        m = run()
    finally:
        program_cls.step = plain_step
    if seen["on"] or not window:
        raise AssertionError(f"{label}: the run has under "
                             f"{first + n} data steps to profile")
    if m.steps != len(main_step_s):
        raise AssertionError(f"{label}: {m.steps} steps profiled "
                             f"run vs {len(main_step_s)} unprofiled")

    events = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    spans = sorted((e.time_range.start, e.time_range.end,
                    int(e.name.rsplit("_", 1)[1])) for e in events
                   if e.name.startswith("chip_smoke_step_"))
    starts = [s[0] for s in spans]
    dev = {i: 0.0 for i, _ in window}
    by_op = {}
    kinds = dict(window)
    for e in events:
        t = getattr(e, "self_device_time_total", 0) / 1e3
        j = bisect.bisect_right(starts, e.time_range.start) - 1
        if t <= 0 or j < 0 or e.time_range.start >= spans[j][1]:
            continue
        i = spans[j][2]
        dev[i] += t
        if kinds[i] == "data":
            by_op[e.key] = by_op.get(e.key, 0.0) + t
    data = [i for i, k in window if k == "data"]
    drain = [i for i, k in window if k == "drain"]
    wall = {i: m.step_times_s[i] * 1e3 for i, _ in window}
    plain_wall = [main_step_s[i] * 1e3 for i in data]
    dev_data = sum(dev[i] for i in data)
    print(f"{label} profiled run: data steps {data} (step indices) "
          f"wall_ms={[wall[i] for i in data]} "
          f"device_ms={[dev[i] for i in data]} "
          f"device_busy_share_of_data_step="
          f"{dev_data / sum(wall[i] for i in data)}; unprofiled run, same "
          f"steps (same kernels, no profiler on the host): wall_ms="
          f"{plain_wall} device_busy_share={dev_data / sum(plain_wall)}")
    print(f"{label} profiled run: {len(drain)} drain steps among "
          f"them, wall_ms_sum={sum(wall[i] for i in drain)} "
          f"device_ms_sum={sum(dev[i] for i in drain)}")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    print(f"{label} device ms per data step by op: " + ", ".join(
        f"{k}={v / len(data)}" for k, v in top))


def check_native(label: str, m) -> str:
    """Which parser a run's host stage used; fails unless every parse
    plan evaluation was the native parser's."""
    if m.native_parses == 0 or m.numpy_parses:
        raise AssertionError(
            f"{label}: parsed natively {m.native_parses} times and with numpy "
            f"{m.numpy_parses} times; the native parser must take every batch")
    return f"parser=native ({m.native_parses} native parse passes, 0 numpy)"


def parse_compare(lines, batch: int = B_MAIN) -> None:
    """The flagship's lines through the port's HostStage three ways, in
    batches of ``batch``: the native parser on lines (the ReplaySource
    path: a timestamp pass and a column pass), the native parser on raw
    byte buffers (one pass), and the numpy path; equal columns, and each
    one's host seconds."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch import native
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.executor import HostStage
    from tpustream_torch.runtime.plan import build_plan_chain
    from tpustream_torch.runtime.sources import ReplaySource

    def host_stage():
        env = StreamExecutionEnvironment(StreamConfig(device="cpu"))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        chapter3_bandwidth_eventtime.build(
            env, env.add_source(ReplaySource(lines[:1]))).collect()
        plan = build_plan_chain(env, env._sinks)[0]
        return HostStage(plan, env.config)

    chunks = [lines[i:i + batch] for i in range(0, len(lines), batch)]
    raw = [("\n".join(c) + "\n").encode() for c in chunks]
    proc = [np.zeros(len(c), np.int64) for c in chunks]
    out, times = {}, {}
    plain_available = native.available
    for how in ("native lines", "native raw", "numpy lines"):
        if how.startswith("numpy"):
            native.available = lambda: False
        try:
            host = host_stage()
            t0 = time.perf_counter()
            if how == "native raw":
                got = [host.process_raw(r, len(c), p)[0]
                       for r, c, p in zip(raw, chunks, proc)]
            else:
                got = [host.process(c, p)[0] for c, p in zip(chunks, proc)]
            times[how] = time.perf_counter() - t0
        finally:
            native.available = plain_available
        counts = host.parse_counts()
        want_native = 0 if how.startswith("numpy") else 1
        if (counts["native"] > 0) != bool(want_native) or any(b is None for b in got):
            raise AssertionError(f"parse {how}: parse counts {counts}")
        out[how] = [np.concatenate([b.ts for b in got])] + [
            np.concatenate([b.columns[i].data for b in got])
            for i in range(len(got[0].columns))]
    for how in ("native raw", "numpy lines"):
        if not all(np.array_equal(a, b) for a, b in zip(out[how], out["native lines"])):
            raise AssertionError(f"parse {how}: columns differ from the native parser's")
    print(f"parse flagship {len(lines)} lines through HostStage in batches of "
          f"{batch}, equal columns: " + " ".join(
              f"{how.replace(' ', '_')}_s={t}" for how, t in times.items())
          + f" numpy_over_native_lines={times['numpy lines'] / times['native lines']}")


def flagship_phase(n_lines: int) -> None:
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.window_program import WindowProgram

    t0 = time.perf_counter()
    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    print(f"flagship input: {n_lines} lines over 20 min of event time, "
          f"{np.unique(ch).size} channels "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    for name, config in FLAGSHIP_CONFIGS.items():
        t0 = time.perf_counter()
        want = flagship_oracle(ts, ch, flow, int32_panes=name == "int32")
        print(f"flagship {name}: {len(want)} oracle rows "
              f"({time.perf_counter() - t0:.1f} s)")
        # the flagship runs no hand-written kernel: the count shows it
        S.reset_launches()
        rows, m, wall = run_flagship(lines, "cuda", **config)
        print(f"flagship {name}: seq_rolling_reduce launches="
              f"{S.seq_rolling_reduce.launches}; {check_native(f'flagship {name}', m)}")
        want_repr = [f"({c},{v!r})" for c, v in want]
        if rows != want_repr:
            bad = next((i for i, (a, b) in enumerate(zip(rows, want_repr))
                        if a != b), min(len(rows), len(want_repr)))
            raise AssertionError(
                f"flagship {name}: {len(rows)} rows vs {len(want_repr)} from "
                f"the oracle, first difference at row {bad}")
        losses = {k: getattr(m, k) for k in
                  ("late_dropped", "alert_overflow", "evicted_unfired")}
        if any(losses.values()):
            raise AssertionError(f"flagship {name}: loss counters {losses}")
        s = m.summary()
        rest = m.step_times_s[1:] or m.step_times_s
        stages = {k: s[f"{k}_time_s"] for k in
                  ("build", "host", "upload", "device", "fetch", "emit")}
        print(f"flagship {name}: {len(rows)} rows equal the oracle; {losses}; "
              f"window_fires={m.window_fires} steps={m.steps} "
              f"d2h_syncs_per_step={m.d2h_syncs / m.steps}")
        # build: the program (liveness traces, whose first one in a
        # process also imports torch's tracing modules, and the state);
        # other: the source and the loop around the stages
        print(f"flagship {name}: events_per_s_end_to_end={n_lines / wall} "
              f"wall_s={wall} build_s={stages['build']} "
              f"parse_s={stages['host']} upload_s={stages['upload']} "
              f"step_s={stages['device']} fetch_s={stages['fetch']} "
              f"emit_s={stages['emit']} other_s={wall - sum(stages.values())} "
              f"step_ms_first={m.step_times_s[0] * 1e3} "
              f"step_ms_median_rest={statistics.median(rest) * 1e3}")
        profile_steps(f"flagship {name}", WindowProgram,
                      lambda: run_flagship(lines, "cuda", **config)[1],
                      m.step_times_s)

    parse_compare(lines)

    # small runs: the card's rows equal the same job's on the CPU
    small = [("event-time jump, batch 8", JUMP_LINES, dict(batch=8)),
             ("event-time jump, batch 1", JUMP_LINES, dict(batch=1)),
             ("event-time golden, batch 1", ET_LINES, dict(batch=1)),
             ("processing-time tumbling golden", FLOW_LINES,
              dict(batch=8, processing=True))]
    for label, small_lines, kw in small:
        for name, config in FLAGSHIP_CONFIGS.items():
            card, _, _ = run_flagship(small_lines, "cuda", keys=1024, **kw, **config)
            cpu, _, _ = run_flagship(small_lines, "cpu", keys=1024, **kw, **config)
            if card != cpu or not card:
                raise AssertionError(
                    f"{label} {name}: card rows {card} != CPU rows {cpu}")
            print(f"flagship small run {label} {name}: {len(card)} rows, "
                  f"card equals CPU")


# -- phase chain: a two-stage rollup at the flagship's width ----------------

def chain_build(text):
    """Stage 1, the flagship's extractor and parse, then a 1-minute
    event-time window per channel summing the Long flow; stage 2 keyed
    by a computed selector, the channel name's first four digits (1,049
    groups over 1<<20 channels), a rolling max of the window sums."""
    from tpustream_torch import Time, Tuple3
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime as ch3

    return (text.assign_timestamps_and_watermarks(
                ch3.IsoTimestampExtractor(Time.minutes(1)))
            .map(ch3.parse).key_by(1).time_window(Time.minutes(1))
            .reduce(lambda a, b: Tuple3(a.f0, a.f1, a.f2 + b.f2))
            .key_by(lambda t: t.f1[:8]).max(2))


def chain_oracle(ts, ch, flow):
    """Stage 1 fires each (minute, channel) cell in order of window end,
    then of the channel's first arrival (its key id), keeping the cell's
    first record's timestamp and channel and summing its flows (nothing
    is late; the end of the stream fires the rest). Stage 2 folds those
    rows in that order per group ``channel // 1000``: the group's first
    row's timestamp and channel, and the running max of the sums."""
    rank = interned_ids(ch)
    cell = (ts // 60) * (1 << 21) + rank
    order = np.argsort(cell, kind="stable")  # arrival order within a cell
    sc = cell[order]
    first = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
    sums = np.add.reduceat(flow[order], first)
    first_ts = ts[order][first]
    chan = ch[order][first]
    rows, seen = [], {}
    for t, c, v in zip(first_ts.tolist(), chan.tolist(), sums.tolist()):
        g = c // 1000
        if g in seen:
            t0, c0, best = seen[g]
            seen[g] = (t0, c0, max(best, v))
        else:
            seen[g] = (t, c, v)
        t0, c0, best = seen[g]
        rows.append((t0, f"www.{c0:07d}.com", best))
    return rows, len(seen)


def stage_times(classes):
    """Wrap each program class's ``step`` to record its host time (the
    step and a synchronise, which the Runner makes right after anyway);
    returns ``({class name: [seconds]}, undo)``."""
    import torch

    got = {c.__name__: [] for c in classes}
    plain = {c: c.step for c in classes}

    def wrap(cls):
        def step(self, *a, **k):
            t0 = time.perf_counter()
            out = plain[cls](self, *a, **k)
            torch.cuda.synchronize()
            got[cls.__name__].append(time.perf_counter() - t0)
            return out
        return step

    for c in classes:
        c.step = wrap(c)
    return got, lambda: [setattr(c, "step", f) for c, f in plain.items()]


def chain_phase(n_lines: int) -> dict:
    """The two-stage rollup over the flagship's generated input at B =
    131072 and ``key_capacity`` 1<<20: every stage-2 row against the
    numpy oracle in emission order, the loss counters 0, the int64
    rolling max on the kernel. Returns the kernel's launches by dtype."""
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.step import RollingProgram
    from tpustream_torch.runtime.window_program import WindowProgram

    t0 = time.perf_counter()
    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    want, n_groups = chain_oracle(ts, ch, flow)
    print(f"chain input: {n_lines} flagship lines, {np.unique(ch).size} channels, "
          f"{len(want)} stage-1 results into {n_groups} groups "
          f"({time.perf_counter() - t0:.1f} s to generate and fold)")
    steps, undo = stage_times([WindowProgram, RollingProgram])
    S.reset_launches()
    try:
        items, m, wall = run_env(chain_build, lines, event_time=True, name="chain",
                                 batch_size=B_MAIN, key_capacity=K_MAIN,
                                 alert_capacity=1 << 18)
    finally:
        undo()
    launches = dict(S.seq_rolling_reduce.launches_by_dtype)
    got = [tuple(t) for t in items]
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(f"chain: {len(got)} rows vs {len(want)} from the "
                             f"oracle, first difference at row {bad}")
    losses = check_losses("chain", m, ("late_dropped", "alert_overflow",
                                       "evicted_unfired"))
    if launches.get("int64", 0) < 1:
        raise AssertionError(f"chain: the int64 kernel never launched ({launches})")
    w, r = steps["WindowProgram"], steps["RollingProgram"]
    print(f"chain: {len(got)} rows equal the oracle in emission order; {losses}; "
          f"hand-off rows={len(got)}; seq_rolling_reduce launches by dtype "
          f"{launches}; {check_native('chain', m)}")
    print(f"chain stage 1 (window): steps={len(w)} step_ms_first={w[0] * 1e3} "
          f"step_ms_median_rest={statistics.median(w[1:] or w) * 1e3}; stage 2 "
          f"(int64 rolling max, computed key): steps={len(r)} step_ms_first="
          f"{r[0] * 1e3} step_ms_median_rest={statistics.median(r[1:] or r) * 1e3}")
    print(f"chain {run_summary(m, wall)}")
    return launches


# -- phases ch1, avg, median: the rest of the tutorial's jobs ---------------

def wall_split(m, wall: float) -> str:
    """``events/s`` and the stages of one run from its Metrics."""
    s = m.summary()
    stages = {k: s[f"{k}_time_s"] for k in
              ("build", "host", "upload", "device", "fetch", "emit")}
    rest = m.step_times_s[1:] or m.step_times_s
    return (f"events_per_s_end_to_end={m.records_in / wall} wall_s={wall} "
            f"build_s={stages['build']} parse_s={stages['host']} "
            f"upload_s={stages['upload']} step_s={stages['device']} "
            f"fetch_s={stages['fetch']} emit_s={stages['emit']} "
            f"other_s={wall - sum(stages.values())} steps={m.steps} "
            f"step_ms_first={m.step_times_s[0] * 1e3} "
            f"step_ms_median_rest={statistics.median(rest) * 1e3} "
            f"d2h_syncs={m.d2h_syncs} d2h_bytes={m.d2h_bytes}")


def run_job(module, items, device="cuda", name="job", **cfg):
    """A job module's ``build`` over ``items`` through ``execute``:
    (collected items, metrics, wall seconds)."""
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource

    env = StreamExecutionEnvironment(StreamConfig(device=device, **cfg))
    handle = module.build(env, env.add_source(ReplaySource(items))).collect()
    t0 = time.perf_counter()
    env.execute(name)
    return handle.items, env.metrics, time.perf_counter() - t0


def check_losses(phase: str, m, names) -> dict:
    losses = {k: getattr(m, k) for k in names}
    if any(losses.values()):
        raise AssertionError(f"{phase}: loss counters {losses}")
    return losses


def ch1_phase(n_lines: int, batch: int = 65536) -> None:
    """The chapter-1 threshold job on bench.py's chapter-1 shape
    (``_render_ch1_lines``): 256 hosts, cpu0-3, usage 91.5 on one line
    in 128 and 50.5 otherwise. The oracle is the lines above 90, in
    order."""
    from tpustream_torch.jobs import chapter1_threshold
    from tpustream_torch.ops import seq_rolling as S

    g = np.arange(n_lines, dtype=np.int64)
    h = g * 2654435761
    hosts = ((h ^ (h >> 31)) % 256).tolist()
    cpus = (g % 4).tolist()
    alert = (g % 128 == 0).tolist()
    lines = [f"1563450000 h{hh:06d} cpu{c} {'91.5' if a else '50.5'}"
             for hh, c, a in zip(hosts, cpus, alert)]
    want = [(f"h{hh:06d}", f"cpu{c}", 91.5)
            for hh, c, a in zip(hosts, cpus, alert) if a]
    S.reset_launches()
    items, m, wall = run_job(chapter1_threshold, lines, batch_size=batch,
                             name="Window WordCount")
    launches = S.seq_rolling_reduce.launches
    got = [tuple(t.values()) for t in items]
    if got != want:
        raise AssertionError(f"ch1: {len(got)} rows vs {len(want)} from the "
                             f"oracle")
    losses = check_losses("ch1", m, ("alert_overflow",))
    print(f"ch1 chapter1_threshold: {n_lines} lines at B={batch}, {len(got)} "
          f"rows equal the oracle; {losses}; seq_rolling_reduce launches="
          f"{launches}")
    print(f"ch1 {wall_split(m, wall)}")


def with_minutes(lines, per_minute: int):
    """``lines`` with an ``AdvanceProcessingTime`` to the next minute
    after every ``per_minute`` lines and at the end: the k-th run of
    lines falls in the processing-time window [k, k + 1) minutes."""
    from tpustream_torch.runtime.sources import AdvanceProcessingTime

    items = []
    for k, start in enumerate(range(0, len(lines), per_minute)):
        items += lines[start:start + per_minute]
        items.append(AdvanceProcessingTime((k + 1) * 60_000))
    return items


def window_groups(hosts: np.ndarray, per_minute: int):
    """``(order, starts)`` grouping the lines by (minute, key id) in fire
    order: the minute, then the host's key id (its first arrival in the
    whole stream). ``order`` sorts the lines; ``starts`` marks each
    group's first position in it."""
    minute = np.arange(hosts.size) // per_minute
    key = interned_ids(hosts)
    order = np.lexsort((key, minute))
    cell = minute[order] * (1 << 21) + key[order]
    starts = np.r_[True, cell[1:] != cell[:-1]]
    return order, starts


def avg_phase(n_lines: int, per_minute: int = 100_000) -> None:
    """The chapter-2 windowed average (window ``aggregate``) on the job
    phase's lines, a processing-time minute every ``per_minute`` lines.
    The oracle is numpy's mean per (window, host) in fire order. The
    job adds a cell's values in the reference's scan order and numpy in
    arrival order, so a row of m values agrees to 2(m-1)·eps·mean."""
    from tpustream_torch.jobs import chapter2_avg
    from tpustream_torch.ops import seq_rolling as S

    t0 = time.perf_counter()
    hosts = make_hosts(n_lines, K_MAIN, seed=7)
    lines = make_lines(n_lines, K_MAIN, seed=7)
    usage = np.array([float(l.rsplit(" ", 1)[1]) for l in lines])
    order, starts = window_groups(hosts, per_minute)
    idx = np.flatnonzero(starts)
    sums = np.add.reduceat(usage[order], idx)
    counts = np.diff(np.r_[idx, n_lines])
    want = sums / counts
    print(f"avg input: {n_lines} lines, {np.unique(hosts).size} hosts, "
          f"{want.size} (window, host) cells "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    S.reset_launches()
    items, m, wall = run_job(chapter2_avg, with_minutes(lines, per_minute),
                             batch_size=B_MAIN, key_capacity=K_MAIN,
                             alert_capacity=1 << 18, name="ComputeCpuAvg")
    launches = S.seq_rolling_reduce.launches
    got = np.array(items, dtype=np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"avg: {got.size} rows vs {want.size} from the "
                             f"oracle")
    bound = 2 * (counts - 1) * np.finfo(np.float64).eps * want
    err = np.abs(got - want)
    if not np.all(err <= bound):
        bad = int(np.flatnonzero(err > bound)[0])
        raise AssertionError(f"avg: row {bad} is {got[bad]!r}, the oracle "
                             f"{want[bad]!r} ({counts[bad]} values)")
    losses = check_losses("avg", m, ("late_dropped", "alert_overflow",
                                     "evicted_unfired"))
    print(f"avg chapter2_avg: {n_lines} lines at B={B_MAIN}, "
          f"K={K_MAIN}, {m.window_fires} fires, {got.size} rows equal the "
          f"oracle within 2(m-1)*eps*mean ({int(np.sum(err == 0))} bit-equal, "
          f"max |diff| {err.max()}); {losses}; seq_rolling_reduce "
          f"launches={launches}")
    print(f"avg {wall_split(m, wall)}")


def median_phase(n_lines: int, n_hosts: int = 1 << 14,
                 per_minute: int = 100_000, cap: int = 128) -> None:
    """The chapter-2 windowed median (full-window ``process()``): each
    second every host sends one sample, in a shuffled order; a
    processing-time minute every ``per_minute`` lines. The oracle is the
    median per (window, host) in fire order, taken as the job takes it
    (the middle value, or the mean of the two middles)."""
    from tpustream_torch.jobs import chapter2_median
    from tpustream_torch.runtime import process_program as P

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    sec = np.arange(n_lines) // n_hosts
    hosts = np.concatenate([rng.permutation(n_hosts)
                            for _ in range(sec[-1] + 1)])[:n_lines]
    usage = rng.integers(0, 10000, n_lines) / 100
    lines = [f"{1563452000 + s} 10.9.{h >> 8}.{h & 255} cpu{h % 4} {u}"
             for s, h, u in zip(sec.tolist(), hosts.tolist(), usage.tolist())]
    order, starts = window_groups(hosts, per_minute)
    idx = np.flatnonzero(starts)
    counts = np.diff(np.r_[idx, n_lines])
    # sort each group's values: by group, then value
    group = np.cumsum(starts) - 1
    vals = usage[order]
    srt = vals[np.lexsort((vals, group))]
    lo = srt[idx + (counts - 1) // 2]
    hi = srt[idx + counts // 2]
    want = np.where(counts % 2 == 1, hi, (hi + lo) / 2)
    print(f"median input: {n_lines} lines, {n_hosts} hosts, {want.size} "
          f"(window, host) cells, at most {counts.max()} values a cell "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    # the element buffers' size, read from the program's state
    buf_bytes = {}
    plain_init = P.ProcessWindowProgram.init_state

    def init_state(self, key_capacity=None):
        state = plain_init(self, key_capacity)
        buf_bytes["n"] = sum(t.numel() * t.element_size()
                             for t in state["buf"] + [state["cnt"]])
        return state

    P.ProcessWindowProgram.init_state = init_state
    try:
        items, m, wall = run_job(
            chapter2_median, with_minutes(lines, per_minute),
            batch_size=B_MAIN, key_capacity=n_hosts,
            process_buffer_capacity=cap, name="ComputeCpuMiddle")
    finally:
        P.ProcessWindowProgram.init_state = plain_init
    got = np.array(items, dtype=np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"median: {got.size} rows vs {want.size} from "
                             f"the oracle, or a row differs")
    losses = check_losses("median", m, ("late_dropped", "buffer_overflow",
                                        "evicted_unfired"))
    firing = sum(1 for t in m.fetch_times_s if t > 0)
    print(f"median chapter2_median: {n_lines} lines at B={B_MAIN}, "
          f"{m.window_fires} (host, window) fires, {got.size} rows equal the "
          f"oracle (bitwise); {losses}; element buffers and counts "
          f"{buf_bytes['n']} bytes on the card, d2h_bytes of the run "
          f"{m.d2h_bytes} (a whole-buffer copy a firing step would be "
          f"{buf_bytes['n']} bytes x {firing} steps)")
    print(f"median {wall_split(m, wall)}")


# -- phases session and count: session windows and count windows ----------

SESSION_B = 131072
SESSION_K = 131072
SESSION_GAP_MS = 1_000
SESSION_RATE = 50  # lines a millisecond of event time: 50,000 a second


def session_input(n: int, seed: int = 3):
    """bench.py phase K's stream (``device_session``): an 8192-key active
    block that rotates every 2 s of event time over 131072 keys, here at
    50,000 lines a second of event time, each timestamp up to 499 ms
    early (under the 1 s delay, so no record is late). ``(ts, key
    numbers, long values, float values)``."""
    g = np.arange(n, dtype=np.int64)
    h = (g * 2654435761) & 0xFFFFFFFF
    h ^= h >> 15
    rng = np.random.default_rng(seed)
    base = 1_600_000_000_000 + g // SESSION_RATE
    block = (g // SESSION_RATE) // 2000
    keys = ((h % 8192) + block * 8192) % SESSION_K
    ts = base - rng.integers(0, 500, n)
    return ts, keys, rng.integers(0, 1000, n), rng.integers(-10**6, 10**6, n) / 100


def session_oracle(ts, keys, vals, ids, batch: int):
    """The sessions of a stream with no late record: per key, sorted by
    time, split where consecutive records are >= gap apart. Returns
    ``(order, first, ends, counts, sums, abs_sums, per_step)`` over the
    sessions in the job's
    emission order: by the step whose watermark (the newest timestamp so
    far less the 1 s delay, a batch at a time; the end of the stream
    fires the rest) passes ``max + gap - 1``, then the session's last
    pane, then the key id. ``order`` sorts the lines by (key, time) and
    ``first`` is each session's first position in it; ``ends`` are
    ``max + gap``; ``sums`` and ``abs_sums`` are of ``vals`` and
    ``|vals|`` in that order; ``per_step`` counts the sessions each step
    fires (the flush last)."""
    order = np.lexsort((ts, keys))
    sk, st = keys[order], ts[order]
    starts = np.r_[True, (sk[1:] != sk[:-1]) | (st[1:] - st[:-1] >= SESSION_GAP_MS)]
    idx = np.flatnonzero(starts)
    last = np.maximum.reduceat(st, idx)
    n = ts.size
    counts = np.diff(np.r_[idx, n])
    newest = np.maximum.accumulate(ts)
    wm = newest[np.minimum(np.arange(batch, n + batch, batch), n) - 1] - 1_000
    step = np.searchsorted(wm, last + SESSION_GAP_MS - 1)  # first step past it
    emit = np.lexsort((ids[order][idx], last // SESSION_GAP_MS, step))
    sums = np.add.reduceat(vals[order], idx)
    abs_sums = np.add.reduceat(np.abs(vals[order]), idx)
    ends = last + SESSION_GAP_MS
    return (order, idx[emit], ends[emit], counts[emit], sums[emit], abs_sums[emit],
            np.bincount(step))


def run_env(build, items, device="cuda", name="job", event_time=False, **cfg):
    """``build(text)``'s stream through ``execute``: (collected items,
    metrics, wall seconds)."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource

    env = StreamExecutionEnvironment(StreamConfig(device=device, **cfg))
    if event_time:
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    handle = build(env.add_source(ReplaySource(items))).collect()
    t0 = time.perf_counter()
    env.execute(name)
    return handle.items, env.metrics, time.perf_counter() - t0


def session_build(kind: str, gap_ms: int = SESSION_GAP_MS, delay_ms: int = 1_000):
    """bench.py phase K's job (``reduce``: ``Tuple2(a.f0, a.f1 + b.f1)``
    over ``<ts_ms> <key> <long>`` lines), or (``mean``) an aggregate of
    (key, count, float sum) into (key, count, mean) over a float
    column. Fields parse with ``Long.parseLong`` and
    ``Double.parseDouble``, as the Java jobs do, which the planner traces
    into the native parser (Python's ``int()``/``float()`` would take
    the per-record fallback)."""
    from tpustream_torch import (AggregateFunction,
                                 BoundedOutOfOrdernessTimestampExtractor, Time,
                                 Tuple2, Tuple3)
    from tpustream_torch.api.windows import EventTimeSessionWindows
    from tpustream_torch.javacompat import Double, Long

    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.milliseconds(delay_ms))

        def extract_timestamp(self, value):
            return Long.parseLong(value.split(" ")[0])

    class Mean(AggregateFunction):
        def create_accumulator(self):
            return Tuple3("", 0, 0.0)

        def add(self, value, acc):
            return Tuple3(value.f0, acc.f1 + 1, acc.f2 + value.f1)

        def get_result(self, acc):
            return Tuple3(acc.f0, acc.f1, acc.f2 / acc.f1)

        def merge(self, a, b):
            return Tuple3(a.f0, a.f1 + b.f1, a.f2 + b.f2)

    def build(text):
        stamped = text.assign_timestamps_and_watermarks(Ts())
        window = EventTimeSessionWindows.with_gap(Time.milliseconds(gap_ms))
        if kind == "mean":
            return (stamped.map(lambda l: Tuple2(l.split(" ")[1],
                                                 Double.parseDouble(l.split(" ")[2])))
                    .key_by(0).window(window).aggregate(Mean()))
        return (stamped.map(lambda l: Tuple2(l.split(" ")[1],
                                             Long.parseLong(l.split(" ")[2])))
                .key_by(0).window(window).reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1)))

    return build


def state_bytes(program_cls):
    """Wrap ``program_cls.init_state`` so it records the bytes of the
    state's device tensors; returns ``(record dict, undo)``."""
    import torch

    got = {}
    plain = program_cls.init_state

    def init_state(self, key_capacity=None):
        state = plain(self, key_capacity)
        tensors = []
        for v in state.values():
            tensors += v if isinstance(v, list) else [v]
        got["n"] = sum(t.numel() * t.element_size() for t in tensors
                       if isinstance(t, torch.Tensor))
        return state

    program_cls.init_state = init_state
    return got, lambda: setattr(program_cls, "init_state", plain)


def session_ends(program_cls):
    """Wrap ``program_cls._emit_sessions`` so it keeps each step's fired
    rows' ``window_end`` (device tensors, read after the run, so the
    steps wait on nothing more); returns ``(read, undo)``, ``read()``
    the ends of all rows in emission order."""
    kept = []
    plain = program_cls._emit_sessions

    def emit(self, *a, **k):
        main = plain(self, *a, **k)
        kept.append((main["count"], main["window_end"]))
        return main

    def read():
        return np.concatenate([e[:int(c)].cpu().numpy() for c, e in kept]
                              or [np.zeros(0, np.int64)])

    program_cls._emit_sessions = emit
    return read, lambda: setattr(program_cls, "_emit_sessions", plain)


def run_summary(m, wall: float) -> str:
    """events/s, the wall split, the step median, waits a step."""
    return (f"{wall_split(m, wall)} waits_a_step={m.d2h_syncs / max(m.steps, 1)} "
            f"window_fires={m.window_fires}")


def session_phase(n_lines: int) -> None:
    """Session windows at bench.py phase K's configuration (B = K =
    131072, gap and delay 1 s, alert and fire capacity 1<<14,
    ``session_extra_panes`` 16), twice: ``reduce`` of a Long sum under
    ``acc_dtype="int32"`` (the scatter-reduce merge), then an
    ``aggregate`` mean over a float column under the exact default (the
    sorted merge). Every session against the numpy oracle: key, end and
    count exact, int32 sums exact, means within 2(m-1)*eps*sum|v|. Each
    run again with ``torch.profiler`` on for data steps 2-3: the card's
    busy share of a warm step and its device time by op."""
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.session_program import SessionWindowProgram

    t0 = time.perf_counter()
    ts, keys, longs, floats = session_input(n_lines)
    names = np.array([f"k{k}" for k in keys.tolist()])
    ids = interned_ids(names)
    print(f"session input: {n_lines} lines over "
          f"{(ts.max() - ts.min()) / 1000:.1f} s of event time, "
          f"{np.unique(keys).size} keys ({time.perf_counter() - t0:.1f} s to "
          f"generate); reduced from bench.py's 10M lines/s stream rate to 50,000 "
          f"lines/s of event time, so sessions close before the flush")
    cfg = dict(batch_size=SESSION_B, key_capacity=SESSION_K,
               alert_capacity=1 << 14, fire_capacity=1 << 14,
               session_extra_panes=16)
    for kind, acc_dtype, vals in (("reduce", "int32", longs),
                                  ("mean", "float64", floats)):
        order, first, ends, counts, sums, abs_sums, per_step = session_oracle(
            ts, keys, vals, ids, SESSION_B)
        lines = ([f"{t} k{k} {v}" for t, k, v in zip(ts.tolist(), keys.tolist(),
                                                      vals.tolist())])
        got_bytes, undo_bytes = state_bytes(SessionWindowProgram)
        read_ends, undo_ends = session_ends(SessionWindowProgram)
        S.reset_launches()
        try:
            items, m, wall = run_env(session_build(kind), lines, event_time=True,
                                     name=f"session {kind}", acc_dtype=acc_dtype, **cfg)
        finally:
            undo_bytes()
            undo_ends()
        launches = S.seq_rolling_reduce.launches
        want_keys = names[order][first]
        if len(items) != first.size:
            raise AssertionError(f"session {kind}: {len(items)} rows, the oracle "
                                 f"{first.size} sessions")
        got_keys = np.array([t.f0 for t in items])
        if not np.array_equal(got_keys, want_keys):
            bad = int(np.flatnonzero(got_keys != want_keys)[0])
            raise AssertionError(f"session {kind}: row {bad} is key {got_keys[bad]}, "
                                 f"the oracle's {want_keys[bad]}")
        if not np.array_equal(read_ends(), ends):
            raise AssertionError(f"session {kind}: a window end differs from the oracle")
        if kind == "reduce":
            got = np.array([t.f1 for t in items], dtype=np.int64)
            if not np.array_equal(got, sums):
                raise AssertionError(f"session reduce: a sum differs from the oracle")
            check = "keys, ends, order and int64 sums exact"
        else:
            got_n = np.array([t.f1 for t in items], dtype=np.int64)
            got_mean = np.array([t.f2 for t in items], dtype=np.float64)
            if not np.array_equal(got_n, counts):
                raise AssertionError("session mean: a count differs from the oracle")
            want = sums / counts
            err = np.abs(got_mean - want)
            bound = 2 * (counts - 1) * np.finfo(np.float64).eps * abs_sums
            if not np.all(err <= bound):
                bad = int(np.flatnonzero(err > bound)[0])
                raise AssertionError(f"session mean: row {bad} is {got_mean[bad]!r}, "
                                     f"the oracle {want[bad]!r} ({counts[bad]} values)")
            check = (f"keys, ends, order and counts exact, means within "
                     f"2(m-1)*eps*sum|v| "
                     f"({int(np.sum(err == 0))} bit-equal, max |diff| {err.max()})")
        losses = check_losses(f"session {kind}", m, ("late_dropped", "evicted_unfired",
                                                     "alert_overflow"))
        print(f"session {kind} ({acc_dtype}): {n_lines} lines at B={SESSION_B}, "
              f"K={SESSION_K}, {len(items)} sessions equal the oracle ({check}); "
              f"{losses}; fires a step (oracle) {per_step.tolist()}; cell state "
              f"{got_bytes['n']} bytes on the card; seq_rolling_reduce "
              f"launches={launches}; {check_native(f'session {kind}', m)}")
        print(f"session {kind} {run_summary(m, wall)}")
        profile_steps(f"session {kind}", SessionWindowProgram,
                      lambda: run_env(session_build(kind), lines, event_time=True,
                                      acc_dtype=acc_dtype, **cfg)[1],
                      m.step_times_s)


def count_build(size: int, slide=None, process: bool = False):
    """bench.py phase L's job: ``count_window(size[, slide])`` over
    ``<x> <key> <long>`` lines, ``reduce`` to the Long sum, or a
    ``process()`` median (the middle value, or the mean of the two
    middles)."""
    from tpustream_torch import Tuple2
    from tpustream_torch.javacompat import Long

    def median(key, ctx, elements, out):
        vals = sorted(e.f1 for e in elements)
        mid = len(vals) // 2
        out.collect(Tuple2(key, float(vals[mid]) if len(vals) % 2
                           else (vals[mid - 1] + vals[mid]) / 2))

    def build(text):
        w = (text.map(lambda l: Tuple2(l.split(" ")[1], Long.parseLong(l.split(" ")[2])))
             .key_by(0).count_window(size, slide))
        if process:
            return w.process(median)
        return w.reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1))

    return build


def count_oracle(hosts: np.ndarray, vals: np.ndarray, size: int, slide: int):
    """Flink's ``countWindow(size, slide)`` per key in arrival order: a
    fire at every ``slide``-th element of a key over its last
    ``min(size, seen)`` elements. ``(fire rows in arrival order, window
    [F, size] value matrix with NaN padding)``."""
    n = hosts.size
    order = np.argsort(hosts, kind="stable")
    sh = hosts[order]
    starts = np.r_[True, sh[1:] != sh[:-1]]
    first = np.maximum.accumulate(np.where(starts, np.arange(n), 0))
    rank = np.arange(n) - first
    fire = (rank + 1) % slide == 0
    pos = np.flatnonzero(fire)
    j = np.arange(size)[None, :] - (size - 1)
    take = pos[:, None] + j
    ok = take >= first[pos][:, None]
    window = np.where(ok, vals[order][np.clip(take, 0, n - 1)], np.nan)
    arrival = order[pos]
    by_arrival = np.argsort(arrival, kind="stable")
    return arrival[by_arrival], window[by_arrival]


def count_phase(n_lines: int, n_hosts: int = 1 << 14, process_lines: int = 100_000,
                process_hosts: int = 1024) -> None:
    """Count windows at bench.py phase L's configuration (B = K = 131072,
    ``acc_dtype="int32"``): ``count_window(50).reduce`` of a Long sum, then
    ``count_window(50, 10).reduce`` and ``count_window(50, 10).process``
    (a median) on the same kind of lines. Every row against the numpy
    oracle, exactly, with the loss counters at 0."""
    from tpustream_torch.ops import seq_rolling as S

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    hosts = rng.integers(0, n_hosts, n_lines)
    vals = rng.integers(0, 10**6, n_lines)
    lines = [f"{i} h{h} {v}" for i, (h, v) in enumerate(zip(hosts.tolist(), vals.tolist()))]
    p_hosts = rng.integers(0, process_hosts, process_lines)
    p_vals = rng.integers(0, 10**6, process_lines)
    p_lines = [f"{i} h{h} {v}" for i, (h, v) in
               enumerate(zip(p_hosts.tolist(), p_vals.tolist()))]
    print(f"count input: {n_lines} lines from {n_hosts} hosts (reduced from bench.py's "
          f"131072 keys, where 1M lines close no 50-element window), and "
          f"{process_lines} lines from {process_hosts} hosts for process() "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    cfg = dict(batch_size=B_MAIN, key_capacity=131072, alert_capacity=1 << 16,
               acc_dtype="int32")
    runs = (("tumbling reduce", 50, None, False, hosts, vals, lines),
            ("sliding reduce", 50, 10, False, hosts, vals, lines),
            ("sliding process", 50, 10, True, p_hosts, p_vals, p_lines))
    for label, size, slide, process, h, v, ls in runs:
        arrival, window = count_oracle(h, v, size, slide or size)
        names = np.array([f"h{x}" for x in h[arrival].tolist()])
        if process:
            want = np.nanmedian(window, axis=1)
        else:
            want = np.nansum(window, axis=1).astype(np.int64)
        S.reset_launches()
        items, m, wall = run_env(count_build(size, slide, process), ls,
                                 name=f"count {label}", **cfg)
        launches = S.seq_rolling_reduce.launches
        got_keys = np.array([t.f0 for t in items])
        got = np.array([t.f1 for t in items], dtype=want.dtype)
        if got.shape != want.shape or not np.array_equal(got_keys, names) \
                or not np.array_equal(got, want):
            raise AssertionError(f"count {label}: {got.size} rows vs {want.size} from "
                                 f"the oracle, or a row differs")
        losses = check_losses(f"count {label}", m, ("alert_overflow",))
        print(f"count {label} (size {size}, slide {slide or size}): {len(ls)} lines at "
              f"B={B_MAIN}, {got.size} rows equal the oracle (bitwise); {losses}; "
              f"seq_rolling_reduce launches={launches}")
        print(f"count {label} {run_summary(m, wall)}")


# -- phases cep and rules: chapter 4 (CEP) and chapter 5 (dynamic rules) ---

CEP_P_KEYS = 131072  # bench.py phase P: uniform keys
CEP_P_RATE = 10_000  # lines a millisecond of event time (bench.py SIM_RATE)
CEP_P_WITHIN_MS = 1_000


def capture_programs(program_cls):
    """Wrap ``program_cls.__init__`` so every instance built is kept;
    returns ``(instances, undo)``."""
    got = []
    plain = program_cls.__init__

    def init(self, *a, **k):
        plain(self, *a, **k)
        got.append(self)

    program_cls.__init__ = init
    return got, lambda: setattr(program_cls, "__init__", plain)


def count_builds():
    """Count the executor's program builds by plan; returns ``(counts,
    undo)``: a rule update must rebuild nothing."""
    from tpustream_torch.runtime import executor

    counts = {}
    plain = executor.build_program

    def counted(plan, cfg):
        counts[id(plan)] = counts.get(id(plan), 0) + 1
        return plain(plan, cfg)

    executor.build_program = counted
    return counts, lambda: setattr(executor, "build_program", plain)


def capacity_for(per_batch) -> int:
    """The smallest power of two holding the largest per-batch count."""
    return 1 << max(1, int(max(per_batch, default=1)) - 1).bit_length()


def cep_oracle(recs, batch: int, pattern, delay_ms: int, key_of=None):
    """The port's host NFA (``tpustream_torch/cep/oracle.py``) over
    ``recs`` (``(record, ts_ms)`` in arrival order, each record ending in
    its arrival index) in batches of ``batch``: ``(matches, timeouts,
    matches a batch, timeouts a batch)``. A timeout falls in the first
    batch whose watermark reaches its start + within (else the
    end-of-stream flush)."""
    from tpustream_torch.cep import compile_pattern, run_oracle

    batches = [recs[i:i + batch] for i in range(0, len(recs), batch)]
    m, t, late = run_oracle(pattern, batches, delay_ms=delay_ms, key_of=key_of)
    if late:
        raise AssertionError(f"cep oracle: {len(late)} late records; none expected")
    n_b = len(batches)
    m_per = np.bincount([ev[-1][-1] // batch for ev in m], minlength=n_b + 1)
    ts = np.array([r[1] for r in recs], np.int64)
    wm = np.maximum.accumulate(np.maximum.reduceat(ts, np.arange(0, ts.size, batch))) \
        - delay_ms
    within = compile_pattern(pattern).within_ms
    t_batch = np.searchsorted(wm, np.array([s for _, s, _ in t], np.int64) + within)
    t_per = np.bincount(t_batch, minlength=n_b + 1)
    return m, t, m_per, t_per


def drop_index(ev):
    """An oracle event without its trailing arrival index."""
    return ev[:-1]


def cep_timeout_rows(timeouts, R: int, pad):
    """Oracle timeouts as the job's timeout records: (n, start, the R
    capture slots' fields), slots past n padded with ``pad``."""
    rows = []
    for n, start, evs in timeouts:
        row = [n, start]
        for e in range(R):
            row.extend(drop_index(evs[e]) if e < len(evs) else pad)
        rows.append(tuple(row))
    return rows


def rounds_line(programs) -> str:
    rounds = [r for p in programs for r in p.rounds]
    return (f"rounds_a_step={rounds} rounds_median="
            f"{statistics.median(rounds) if rounds else 0}")


def cep_job_oracle(n_lines: int, n_channels: int, batch: int):
    """The chapter-4 job's expected output over the flagship's generated
    lines (run in a worker process): ``(alert reprs, timeout rows, alerts
    a batch, timeouts a batch)``. The oracle's records are ``((sec,
    channel, flow, arrival index), ts_ms)``."""
    from tpustream_torch.jobs import chapter4_cep_alert as ch4

    _, ts, ch, flow = make_flagship_input(n_lines, n_channels, seed=3)
    names = [f"www.{c:07d}.com" for c in ch.tolist()]
    recs = [((t, nm, f, i), t * 1000) for i, (t, nm, f) in
            enumerate(zip(ts.tolist(), names, flow.tolist()))]
    m, t, m_per, t_per = cep_oracle(recs, batch, ch4.make_pattern(), 60_000)
    want = [f"({b0[1]},{b0[2] + b1[2] + b2[2]},{b0[0]},{b2[0]})" for b0, b1, b2 in m]
    return (want, cep_timeout_rows(t, 2, (0, None, 0)), m_per.tolist(),
            t_per.tolist())


def cep_p_input(n: int):
    """bench.py phase P's stream (``device_cep``): ``(ts_ms, key, value)``
    arrays; the key is the record hash's low bits, the value 1000 (a
    breach) where hash bits 7-8 are 0, else 10."""
    g = np.arange(n, dtype=np.int64)
    h = g * 2654435761
    h = h ^ (h >> 29)
    return (1_566_957_600_000 + g // CEP_P_RATE, h % CEP_P_KEYS,
            np.where((h >> 7) % 4 == 0, 1000, 10))


def cep_p_pattern():
    from tpustream_torch import Pattern, Time

    return (Pattern.begin("b").where(lambda r: r.f1 > 500).times(5)
            .consecutive().within(Time.milliseconds(CEP_P_WITHIN_MS)))


def cep_p_oracle(n: int, batch: int):
    """Phase P's expected output (run in a worker process): ``(match
    reprs, timeouts, matches a batch, timeouts a batch)``."""
    ts, key, val = cep_p_input(n)
    recs = [((f"{k:06d}", v, i), a) for i, (a, k, v) in
            enumerate(zip(ts.tolist(), key.tolist(), val.tolist()))]
    m, t, m_per, t_per = cep_oracle(recs, batch, cep_p_pattern(), 1_000,
                                    key_of=lambda r: r[0])
    return ([f"({e[0][0]},{e[-1][1]})" for e in m], len(t), m_per.tolist(),
            t_per.tolist())


def cep_phase(n_lines: int, p_lines: int) -> None:
    """Chapter 4 at the flagship's width: ``jobs/chapter4_cep_alert.py``
    (three consecutive breaches of 5000 within a minute, a timeout side
    output) over the flagship's generated lines at B = 131072,
    ``key_capacity`` 1<<20 and a 1-minute delay (no line late); every
    alert and every timeout row equal to the host oracle over the same
    batch boundaries, in order; the loss counters 0; the run again under
    ``torch.profiler`` for the busy share of warm steps. Then one run of
    bench.py phase P's shape (L = 5, ``times(5).consecutive()
    .within(1 s)``, 131072 uniform keys, a quarter of events breaching)
    as lines through the executor, held against the oracle too. The two
    oracles run first, side by side in two worker processes, and are
    done before any run on the card is timed."""
    import multiprocessing

    from tpustream_torch import (CEP, BoundedOutOfOrdernessTimestampExtractor,
                                 OutputTag, Time, Tuple2)
    from tpustream_torch.javacompat import Long
    from tpustream_torch.jobs import chapter4_cep_alert as ch4
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.cep_program import CepProgram

    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        job_oracle = pool.submit(cep_job_oracle, n_lines, K_MAIN, B_MAIN)
        p_oracle = pool.submit(cep_p_oracle, p_lines, B_MAIN)
        lines, _, ch, _ = make_flagship_input(n_lines, K_MAIN, seed=3)
        n_channels = np.unique(ch).size
        p_ts, p_key, p_val = cep_p_input(p_lines)
        p_lines_ = [f"{a} {k:06d} {v}" for a, k, v in
                    zip(p_ts.tolist(), p_key.tolist(), p_val.tolist())]
        want, want_t, m_per, t_per = job_oracle.result()
        p_want, p_tmo, pm_per, pt_per = p_oracle.result()
    cap = capacity_for(m_per + t_per)
    p_cap = capacity_for(pm_per + pt_per)
    print(f"cep input: {n_lines} flagship lines, {n_channels} channels; oracle "
          f"{len(want)} alerts, {len(want_t)} timeouts; alerts a batch {m_per}, "
          f"timeouts a batch (last: the end-of-stream flush) {t_per}; "
          f"alert_capacity {cap}. Phase P: {p_lines} lines, {CEP_P_KEYS} keys, "
          f"{int(np.sum(p_val > 500))} breaching; oracle {len(p_want)} matches, "
          f"{p_tmo} timeouts; alert_capacity {p_cap} ({time.perf_counter() - t0:.1f} s "
          f"to generate and run both oracles in two worker processes)")

    def build(text):
        tag = OutputTag("breach-timeout")
        alerts = ch4.build(None, text, delay=Time.minutes(1), timeout_tag=tag)
        timeouts.append(alerts.get_side_output(tag).collect())
        return alerts

    cfg = dict(batch_size=B_MAIN, key_capacity=K_MAIN, alert_capacity=cap)
    timeouts = []
    programs, undo_p = capture_programs(CepProgram)
    builds, undo_b = count_builds()
    S.reset_launches()
    try:
        items, mt, wall = run_env(build, lines, event_time=True, name="cep", **cfg)
    finally:
        undo_p()
        undo_b()
    got, got_t = [repr(x) for x in items], [tuple(x) for x in timeouts[0].items]
    for label, a, b in (("alert", got, want), ("timeout", got_t, want_t)):
        if a != b:
            bad = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
            raise AssertionError(f"cep: {len(a)} {label} rows vs {len(b)} from the "
                                 f"oracle, first difference at row {bad}")
    losses = check_losses("cep", mt, ("late_dropped", "alert_overflow",
                                      "exchange_overflow"))
    if (mt.cep_matches, mt.cep_timeouts) != (len(want), len(want_t)):
        raise AssertionError(f"cep: counters {mt.cep_matches} matches, "
                             f"{mt.cep_timeouts} timeouts")
    if list(builds.values()) != [1]:
        raise AssertionError(f"cep: program builds {builds}")
    print(f"cep chapter4_cep_alert: {len(got)} alerts and {len(got_t)} timeouts "
          f"equal the oracle in order; {losses}; cep_matches={mt.cep_matches} "
          f"cep_timeouts={mt.cep_timeouts}; seq_rolling_reduce launches="
          f"{S.seq_rolling_reduce.launches}; {check_native('cep', mt)}")
    print(f"cep {run_summary(mt, wall)} {rounds_line(programs)}")
    profile_steps("cep", CepProgram,
                  lambda: run_env(build, lines, event_time=True, **cfg)[1],
                  mt.step_times_s)

    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.seconds(1))

        def extract_timestamp(self, value):
            return Long.parseLong(value.split(" ")[0])

    def p_build(text):
        keyed = (text.assign_timestamps_and_watermarks(Ts())
                 .map(lambda l: Tuple2(l.split(" ")[1], Long.parseLong(l.split(" ")[2])))
                 .key_by(0))
        return CEP.pattern(keyed, cep_p_pattern()).select(
            lambda mm: Tuple2(mm["b"][0].f0, mm["b"][-1].f1))

    programs, undo_p = capture_programs(CepProgram)
    try:
        items, mp, wall = run_env(p_build, p_lines_, event_time=True, name="cep P",
                                  batch_size=B_MAIN, key_capacity=CEP_P_KEYS,
                                  alert_capacity=p_cap)
    finally:
        undo_p()
    got = [repr(x) for x in items]
    if got != p_want or (mp.cep_matches, mp.cep_timeouts) != (len(p_want), p_tmo):
        raise AssertionError(f"cep phase P: {len(got)} rows vs {len(p_want)} from the "
                             f"oracle; counters {mp.cep_matches}, {mp.cep_timeouts}")
    losses = check_losses("cep phase P", mp, ("late_dropped", "alert_overflow",
                                              "exchange_overflow"))
    print(f"cep phase P (L=5, within 1 s): {len(got)} matches equal the oracle in "
          f"order, cep_timeouts={mp.cep_timeouts} (oracle {p_tmo}); {losses}; "
          f"{check_native('cep phase P', mp)}")
    print(f"cep phase P {run_summary(mp, wall)} {rounds_line(programs)}")


def rules_max_oracle(lines, updates, threshold: float):
    """chapter2_max with the chapter-5 threshold ahead of the keyed max:
    a row passes when its usage exceeds the threshold active at its
    position; each passing row emits its host's keep-first cpu and
    running max."""
    timeline = sorted(updates)
    state, rows, u = {}, [], 0
    for i, line in enumerate(lines):
        while u < len(timeline) and i >= timeline[u][0]:
            threshold = timeline[u][1]
            u += 1
        _, host, cpu, usage = line.split(" ")
        v = float(usage)
        if not v > threshold:
            continue
        s = state.get(host)
        if s is None:
            s = state[host] = [host, cpu, v]
        elif v > s[2]:
            s[2] = v
        rows.append((s[0], s[1], s[2]))
    return rows


def rules_phase(n_lines: int, reps: int) -> dict:
    """Chapter 5: the chapter-5 job (``jobs/chapter5_dynamic_rules.py``)
    on bench.py's chapter-1 lines at B = 65536 with three threshold
    updates, two inside a batch, every row against the job's own oracle;
    then chapter2_max with a pre-chain filter reading the rule
    (B = 131072, ``key_capacity`` 1<<20, the job phase's lines, an update
    inside a batch), every row against a host oracle, the max on
    ``seq_rolling.cu`` (fails if it launched 0 times). Each stage's
    program is built once in both runs: an update rebuilds nothing.
    Returns the kernel's launches and its case on the max's second call
    (:func:`path_kernel_case`)."""
    from tpustream_torch import RuleUpdate
    from tpustream_torch.jobs import chapter2_max, chapter5_dynamic_rules as ch5
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.step import RollingProgram, StatelessProgram
    from tpustream_torch.runtime.sources import ReplaySource

    g = np.arange(n_lines, dtype=np.int64)
    h = g * 2654435761
    hosts = ((h ^ (h >> 31)) % 256).tolist()
    cpus = (g % 4).tolist()
    alert = (g % 128 == 0).tolist()
    lines = [f"1563450000 h{hh:06d} cpu{c} {'91.5' if a else '50.5'}"
             for hh, c, a in zip(hosts, cpus, alert)]
    updates = [(100_000, 95.0), (524_288, 60.0), (n_lines - 1, 50.0)]
    t0 = time.perf_counter()
    want = [tuple(t) for t in ch5.oracle(lines, updates)]
    print(f"rules input: {n_lines} chapter-1 lines; updates {updates}; oracle "
          f"{len(want)} rows ({time.perf_counter() - t0:.1f} s)")

    def build_ch5(text):
        rules_box.append(ch5.make_rules())
        env = text.env
        return ch5.build(env, text, env.add_source(
            ReplaySource(ch5.control_lines(updates))), rules_box[-1])

    rules_box = []
    builds, undo_b = count_builds()
    S.reset_launches()
    try:
        items, m, wall = run_env(build_ch5, lines, name="Dynamic Threshold Alert",
                                 batch_size=65536)
    finally:
        undo_b()
    got = [tuple(t) for t in items]
    if got != want or rules_box[-1].version != len(updates):
        raise AssertionError(f"rules chapter5: {len(got)} rows vs {len(want)} from "
                             f"the oracle, rule version {rules_box[-1].version}")
    if list(builds.values()) != [1]:
        raise AssertionError(f"rules chapter5: program builds {builds}")
    losses = check_losses("rules chapter5", m, ("alert_overflow",))
    print(f"rules chapter5_dynamic_rules: {len(got)} rows equal the oracle; rule "
          f"version {rules_box[-1].version}; program builds {list(builds.values())}; "
          f"{losses}; seq_rolling_reduce launches={S.seq_rolling_reduce.launches}")
    print(f"rules chapter5 {run_summary(m, wall)}")
    profile_steps("rules chapter5", StatelessProgram,
                  lambda: run_env(build_ch5, lines, batch_size=65536)[1],
                  m.step_times_s)

    t0 = time.perf_counter()
    max_lines = make_lines(n_lines, K_MAIN, seed=7)
    max_updates = [(300_000, 50.0)]
    want = rules_max_oracle(max_lines, max_updates, 90.0)
    print(f"rules max input: {n_lines} job lines; update {max_updates}; oracle "
          f"{len(want)} rows ({time.perf_counter() - t0:.1f} s)")

    def build_max(text):
        rules = ch5.make_rules()
        rules_box.append(rules)
        thr = rules.param("threshold")
        text.env.from_collection([RuleUpdate("threshold", v, pos)
                                  for pos, v in max_updates]).broadcast(rules)
        return (text.map(chapter2_max.parse).filter(lambda v: v.f2 > thr)
                .key_by(0).max(2))

    builds, undo_b = count_builds()
    captured, undo_c = capture_kernel_call()
    S.reset_launches()
    try:
        items, m, wall = run_env(build_max, max_lines, name="ComputeCpuMax rules",
                                 batch_size=B_MAIN, key_capacity=K_MAIN)
    finally:
        undo_b()
        undo_c()
    launches = S.seq_rolling_reduce.launches
    got = [tuple(t.values()) for t in items]
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(f"rules max: {len(got)} rows vs {len(want)} from the "
                             f"oracle, first difference at row {bad}")
    if launches < 1:
        raise AssertionError("rules max: seq_rolling_reduce launched 0 times")
    if list(builds.values()) != [1]:
        raise AssertionError(f"rules max: program builds {builds}")
    print(f"rules max (chapter2_max + threshold rule): {len(got)} rows equal the "
          f"oracle; rule version {rules_box[-1].version}; program builds "
          f"{list(builds.values())}; seq_rolling_reduce launches={launches}")
    print(f"rules max {run_summary(m, wall)}")
    profile_steps("rules max", RollingProgram,
                  lambda: run_env(build_max, max_lines, batch_size=B_MAIN,
                                  key_capacity=K_MAIN)[1],
                  m.step_times_s)
    return {"launches": launches,
            "case": path_kernel_case("rules max", captured["call"], reps)}


# -- phases fleet and obs: chapter 6 (tenancy) and the observability layer --

FLEET_TENANTS = 4096
FLEET_RECORDS = 64  # a tenant's lines: 4096 x 64 = 262,144
FLEET_B = 65536
FLEET_LATE = 64      # tenants admitted after ingestion began
FLEET_ROUNDS = 16    # round-robin ingestion blocks
FLEET_HOSTS = 16     # host names every tenant of the keyed fleet shares


def fleet_schedule(seed: int = 11) -> dict:
    """The chapter-6 fleet's traffic, as data: per tenant its threshold,
    its FLEET_RECORDS lines (``c6.tenant_lines``), a quota of half its records for
    64 of them, 256 mid-stream threshold updates (tenant, local record,
    value), 64 removals (tenant, round) and the 64 tenants admitted at
    round 4."""
    from tpustream_torch.jobs import chapter6_tenant_fleet as c6

    rng = np.random.default_rng(seed)
    tenants = [f"t{i:04d}" for i in range(FLEET_TENANTS)]
    early = tenants[:FLEET_TENANTS - FLEET_LATE]
    pick = rng.permutation(len(early))
    quota = {early[i]: FLEET_RECORDS // 2 for i in pick[:64]}
    removed = {early[i]: int(rng.integers(2, FLEET_ROUNDS))
               for i in pick[64:128]}
    updated = [tenants[i] for i in rng.permutation(FLEET_TENANTS)[:256]]
    updates = [(t, int(rng.integers(FLEET_RECORDS // 2, FLEET_RECORDS)),
                float(np.round(rng.uniform(80.0, 104.0), 2))) for t in updated]
    return {
        "tenants": tenants, "late": tenants[len(early):],
        "threshold": {t: float(np.round(rng.uniform(80.0, 100.0), 2))
                      for t in tenants},
        "lines": {t: c6.tenant_lines(t, FLEET_RECORDS,
                                     base=float(70 + (i % 16)))
                  for i, t in enumerate(tenants)},
        "quota": quota, "removed": removed, "updates": updates,
    }


def fleet_server(sched: dict, capacity: int, device: str = "cuda", obs=None):
    """The schedule through a JobServer: admissions, round-robin
    ingestion in blocks, removals and the late admissions at round
    boundaries, then the threshold updates at positions from
    ``JobServer.position`` (each after its record was ingested)."""
    from tpustream_torch import JobServer, TenantQuota
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs import chapter6_tenant_fleet as c6

    cfg = StreamConfig(device=device, batch_size=FLEET_B,
                       obs=obs or ObsConfig(enabled=True))
    srv = JobServer(c6.make_plan(capacity), config=cfg)

    def admit(t):
        q = sched["quota"].get(t)
        srv.add_tenant(t, rules={"threshold": sched["threshold"][t]},
                       quota=TenantQuota(max_records=q) if q else None)

    late = set(sched["late"])
    admitted = {t: 0 for t in sched["tenants"]}
    for t in sched["tenants"]:
        if t not in late:
            admit(t)
    block = FLEET_RECORDS // FLEET_ROUNDS
    for r in range(FLEET_ROUNDS):
        if r == 4:
            for t in sched["late"]:
                admit(t)
        for t, at in sched["removed"].items():
            if at == r:
                srv.remove_tenant(t)
        for t in sched["tenants"]:
            if t in late and r < 4:
                continue
            if t in late:
                # the late tenants ingest all their lines in rounds 4-15
                lo = (r - 4) * FLEET_RECORDS // 12
                hi = (r - 3) * FLEET_RECORDS // 12
            else:
                lo, hi = r * block, (r + 1) * block
            admitted[t] += srv.ingest(t, sched["lines"][t][lo:hi])
    for t, n, v in sched["updates"]:
        if n < admitted[t]:
            srv.update_tenant_rules(t, {"threshold": v},
                                    after_records=srv.position(t, n))
    return srv


def fleet_expected(sched: dict) -> dict:
    """Per tenant ``(rows, quota lines)`` from ``c6.expected`` on its own
    admitted lines and rule timeline: the quota cuts its lines at 128, a
    removal keeps the lines ingested before it, an update lands at its
    local record."""
    from tpustream_torch.jobs import chapter6_tenant_fleet as c6

    block = FLEET_RECORDS // FLEET_ROUNDS
    ups = {}
    for t, n, v in sched["updates"]:
        ups.setdefault(t, []).append((n, v))
    out = {}
    for t in sched["tenants"]:
        lines = sched["lines"][t]
        q = sched["quota"].get(t)
        admitted, diverted = (lines[:q], lines[q:]) if q else (lines, [])
        if t in sched["removed"]:
            admitted = admitted[:sched["removed"][t] * block]
        thr = sched["threshold"][t]
        timeline = [(0, thr)] + [(n, v) for n, v in ups.get(t, [])
                                 if n < len(admitted)]
        out[t] = ([tuple(x) for x in c6.expected(t, admitted, thr, timeline)],
                  diverted)
    return out


def check_fleet(label: str, srv, want: dict) -> int:
    got = srv.outputs()
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: {len(got)} tenants vs {len(want)}")
    for t, (rows, diverted) in want.items():
        if [tuple(x) for x in got[t]] != rows:
            raise AssertionError(f"{label}: tenant {t}: {len(got[t])} rows "
                                 f"vs {len(rows)} from the oracle")
        if srv.quota_output(t) != diverted:
            raise AssertionError(f"{label}: tenant {t}: quota side output differs")
    # JobServer.output (a pass over every row a call), on four tenants
    for t in srv.tenants()[::FLEET_TENANTS // 4]:
        if [tuple(x) for x in srv.output(t)] != want[t][0]:
            raise AssertionError(f"{label}: JobServer.output({t}) differs")
    return sum(len(r) for r, _ in want.values())


def recompile_causes(m) -> dict:
    return {s["labels"].get("cause"): s["value"]
            for s in m.obs_snapshot()["metrics"]["series"]
            if s["name"] == "operator_recompile_cause"}


def fleet_kv_parse(line):
    """The keyed fleet's host parse: ``host value``."""
    from tpustream_torch import Tuple2

    items = line.split(" ")
    return Tuple2(items[0], float(items[1]))


def keyed_fleet(n_per_tenant: int, device: str = "cuda"):
    """``(server, lines by tenant)``: a template ``key_by(host).max(value)``
    (the parse is the plan's) over 4096 tenants that share 16 host names:
    65,536 namespaced keys at ``key_capacity`` 1<<17, ingested
    round-robin in 16 blocks."""
    from tpustream_torch import JobServer, RuleSet, TenantPlan
    from tpustream_torch.config import StreamConfig

    rules = RuleSet()
    rules.declare("unused", 0.0, "f64")
    plan = TenantPlan(parse=fleet_kv_parse,
                      build=lambda s, r: s.key_by(0).max(1),
                      rules=rules, tenant_capacity=FLEET_TENANTS)
    srv = JobServer(plan, config=StreamConfig(
        device=device, batch_size=FLEET_B, key_capacity=1 << 17))
    rng = np.random.default_rng(5)
    tenants = [f"k{i:04d}" for i in range(FLEET_TENANTS)]
    hosts = rng.integers(0, FLEET_HOSTS, (FLEET_TENANTS, n_per_tenant))
    vals = np.round(rng.uniform(0.0, 1000.0, (FLEET_TENANTS, n_per_tenant)), 1)
    lines = {t: [f"h{h:02d} {v}" for h, v in zip(hosts[i].tolist(), vals[i].tolist())]
             for i, t in enumerate(tenants)}
    for t in tenants:
        srv.add_tenant(t)
    block = max(1, n_per_tenant // FLEET_ROUNDS)
    for lo in range(0, n_per_tenant, block):
        for t in tenants:
            srv.ingest(t, lines[t][lo:lo + block])
    return srv, lines


def keyed_fleet_oracle(lines: dict) -> dict:
    """A running max per (tenant, host) in the tenant's arrival order."""
    out = {}
    for t, ls in lines.items():
        best, rows = {}, []
        for line in ls:
            h, v = line.split(" ")
            b = max(best.get(h, float("-inf")), float(v))
            best[h] = b
            rows.append((h, b))
        out[t] = rows
    return out


def host_timers(targets):
    """Wrap each ``(owner, name)`` method to add up its host seconds;
    returns ``(seconds by name, undo)``."""
    got = {name: 0.0 for _, name in targets}
    plain = {(o, n): getattr(o, n) for o, n in targets}

    def wrap(o, n):
        f = plain[(o, n)]

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                got[n] += time.perf_counter() - t0
        return timed

    for o, n in targets:
        setattr(o, n, wrap(o, n))
    return got, lambda: [setattr(o, n, f) for (o, n), f in plain.items()]


def run_fleet_server(srv, name: str):
    """``srv.run(name)`` with its builds counted and the fleet's host
    work outside the stages timed: the rule refreshes at updates, and the
    per-tenant obs refresh and post-run series (``refresh_obs``,
    ``_mint_obs``). Returns ``(result, wall, builds, host seconds)``."""
    from tpustream_torch.runtime.executor import Runner
    from tpustream_torch.tenancy.server import JobServer

    builds, undo_b = count_builds()
    timers, undo_t = host_timers([(Runner, "refresh_rules"),
                                  (JobServer, "refresh_obs"),
                                  (JobServer, "_mint_obs")])
    try:
        t0 = time.perf_counter()
        res = srv.run(name)
        wall = time.perf_counter() - t0
    finally:
        undo_b()
        undo_t()
    return res, wall, builds, timers


def check_fleet_run(label: str, srv, res, builds, want, cap: int) -> None:
    m = res.metrics
    rows = check_fleet(label, srv, want)
    causes = recompile_causes(m)
    grown = [(e["old_capacity"], e["new_capacity"])
             for e in m.job_obs.flight.events()
             if e["kind"] == "tenant_capacity_grown"]
    if list(builds.values()) != [1] or "config_change" in causes:
        raise AssertionError(f"{label}: builds {builds}, causes {causes}")
    if cap == FLEET_TENANTS and (grown or causes):
        raise AssertionError(f"{label}: grew {grown}, causes {causes}")
    if cap < FLEET_TENANTS and (grown != [(cap, FLEET_TENANTS)]
                                or causes != {"tenant_capacity_growth": 1}):
        raise AssertionError(f"{label}: grew {grown}, causes {causes}")
    print(f"{label}: every tenant's {rows} rows and quota side outputs "
          f"equal the oracle; program builds {list(builds.values())}; "
          f"recompile causes {causes}; capacity grown {grown}")


def fleet_phase(reps: int) -> dict:
    """Chapter 6 at a fleet size users run: 4096 tenants, 262,144
    lines (64 a tenant; cut from 256, then 128, to keep the script inside
    its time limit), B = 65536. Every tenant's demuxed rows and quota side output
    against ``c6.expected``; one program build; the same fleet from half
    the tenant capacity grows once; a profiled rerun of the first fleet
    for warm steps 2-3; the keyed fleet's rolling max on the kernel
    against a numpy running max. Returns the kernel's launches in the
    keyed fleet and its case on the keyed fleet's second call
    (:func:`path_kernel_case`)."""
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.step import StatelessProgram

    t0 = time.perf_counter()
    sched = fleet_schedule()
    want = fleet_expected(sched)
    n_lines = FLEET_TENANTS * FLEET_RECORDS
    print(f"fleet input: {FLEET_TENANTS} tenants x {FLEET_RECORDS} lines = "
          f"{n_lines}; {len(sched['quota'])} quotas, {len(sched['removed'])} "
          f"removals, {len(sched['updates'])} updates, {FLEET_LATE} late "
          f"admissions; oracle {sum(len(r) for r, _ in want.values())} rows "
          f"({time.perf_counter() - t0:.1f} s)")
    for label, cap in (("fleet", FLEET_TENANTS),
                       ("fleet growth", FLEET_TENANTS // 2)):
        t0 = time.perf_counter()
        srv = fleet_server(sched, cap)
        t_sched = time.perf_counter() - t0
        res, wall, builds, timers = run_fleet_server(srv, label)
        check_fleet_run(label, srv, res, builds, want, cap)
        m = res.metrics
        print(f"{label} lines_offered={n_lines} events_per_s_offered="
              f"{n_lines / wall} {run_summary(m, wall)} schedule_s={t_sched} "
              + " ".join(f"{k}_s={v}" for k, v in timers.items()))
        if label == "fleet":
            main_steps = m.step_times_s

    def rerun():
        g = fleet_server(sched, FLEET_TENANTS)
        return g.run("fleet profiled").metrics

    profile_steps("fleet", StatelessProgram, rerun, main_steps)

    t0 = time.perf_counter()
    srv, lines = keyed_fleet(FLEET_RECORDS)
    kwant = keyed_fleet_oracle(lines)
    keys = len({(t, line.split(" ")[0]) for t, ls in lines.items() for line in ls})
    print(f"keyed fleet input: {FLEET_TENANTS} tenants x {FLEET_RECORDS} lines, "
          f"{FLEET_HOSTS} shared hosts, {keys} namespaced keys "
          f"({time.perf_counter() - t0:.1f} s with the oracle)")
    captured, undo_c = capture_kernel_call()
    S.reset_launches()
    try:
        res, wall, builds, timers = run_fleet_server(srv, "keyed fleet")
    finally:
        undo_c()
    launches = S.seq_rolling_reduce.launches
    got = srv.outputs()
    for t in srv.tenants():
        if [tuple(x) for x in got[t]] != kwant[t]:
            raise AssertionError(f"keyed fleet: tenant {t} differs from the "
                                 f"numpy running max")
    if launches < 1:
        raise AssertionError("keyed fleet: seq_rolling_reduce launched 0 times")
    if list(builds.values()) != [1]:
        raise AssertionError(f"keyed fleet: program builds {builds}")
    print(f"keyed fleet: every tenant's {sum(map(len, kwant.values()))} rows "
          f"equal the numpy running max per (tenant, host); program builds "
          f"{list(builds.values())}; seq_rolling_reduce launches={launches}")
    print(f"keyed fleet {run_summary(res.metrics, wall)} "
          + " ".join(f"{k}_s={v}" for k, v in timers.items()))
    return {"launches": launches,
            "case": path_kernel_case("keyed fleet", captured["call"], reps)}


def obs_run(lines, obs, scrape: bool = False, device: str = "cuda"):
    """The flagship in the int32 configuration with ``obs``; with
    ``scrape`` a thread reads ``/metrics`` and ``/snapshot.json`` from the
    job's endpoint while it runs. ``(rows, metrics, wall, scrapes)``."""
    import threading
    import urllib.request

    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.sources import ReplaySource

    env = StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=B_MAIN, key_capacity=K_MAIN,
        alert_capacity=1 << 16, obs=obs, **FLAGSHIP_CONFIGS["int32"]))
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    handle = chapter3_bandwidth_eventtime.build(
        env, env.add_source(ReplaySource(lines))).collect()
    scrapes, done = [], threading.Event()

    def scraper():
        url = None
        while not done.is_set():
            m = env.metrics
            server = getattr(getattr(m, "job_obs", None), "server", None)
            if url is None and server is not None:
                url = server.url
            if url is not None:
                try:
                    for path in ("/metrics", "/snapshot.json"):
                        with urllib.request.urlopen(url + path, timeout=5) as r:
                            scrapes.append((path, r.read().decode()))
                except OSError:
                    pass  # the job closed its endpoint
            done.wait(0.5)

    th = threading.Thread(target=scraper, daemon=True) if scrape else None
    if th is not None:
        th.start()
    t0 = time.perf_counter()
    try:
        env.execute("BandwidthMonitorWithEventTime")
    finally:
        wall = time.perf_counter() - t0
        done.set()
        if th is not None:
            th.join()
    return [repr(t) for t in handle.items], env.metrics, wall, scrapes


PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+( \d+)?$')


def obs_phase(n_lines: int) -> None:
    """The flagship (int32 configuration, the flagship phase's lines and
    settings) in three interleaved pairs of runs, obs off then the whole
    obs layer on (spans, snapshots every second, chapter 1's health
    rules, latency markers, the live endpoint scraped while the job
    runs); then the whole layer without the scraper, and the registry
    alone (no spans, snapshots, health, markers or endpoint). Every
    run's rows equal the oracle, every run waits on the card as often,
    each builds once with no recompile; every scrape parses, health ends
    at OK. Prints each run's events/s and step times. Then a short run
    under ``torch.profiler``: the span names, ``step.fold`` among them,
    are among its events."""
    import torch

    from tpustream_torch.config import ObsConfig
    from tpustream_torch.jobs import chapter1_threshold as ch1

    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    want = [f"({c},{v!r})" for c, v in flagship_oracle(ts, ch, flow, int32_panes=True)]
    full = ObsConfig(enabled=True, trace=True, snapshot_interval_s=1.0,
                     health_rules=ch1.health_rules(), serve_port=0,
                     latency_marker_interval_ms=100.0)
    plan = [("off", ObsConfig(), False), ("on", full, True)] * 3 + [
        ("on, no scraper", full, False),
        ("registry only", ObsConfig(enabled=True, trace=False), False)]
    runs = []
    for i, (label, obs, scrape) in enumerate(plan):
        builds, undo_b = count_builds()
        try:
            rows, m, wall, scrapes = obs_run(lines, obs, scrape=scrape)
        finally:
            undo_b()
        if rows != want:
            raise AssertionError(f"obs run {i} ({label}): {len(rows)} rows vs "
                                 f"{len(want)} from the oracle")
        if list(builds.values()) != [1]:
            raise AssertionError(f"obs run {i} ({label}): builds {builds}")
        rest = sorted(m.step_times_s[1:])
        q1, q2, q3 = statistics.quantiles(rest, n=4)
        print(f"obs run {i} ({label}): events_per_s={n_lines / wall} "
              f"step_ms_quartiles_rest={[q1 * 1e3, q2 * 1e3, q3 * 1e3]} "
              f"step_s_sum={sum(m.step_times_s)} {wall_split(m, wall)}")
        runs.append((label, m, wall, scrapes))
    syncs = {m.d2h_syncs for _, m, _, _ in runs}
    if len(syncs) != 1:
        raise AssertionError(f"obs: d2h_syncs differ between runs: "
                             f"{[(label, m.d2h_syncs) for label, m, _, _ in runs]}")
    n_metrics = n_snap = 0
    for label, m, _, scrapes in runs:
        if label == "off":
            continue
        snap = m.obs_snapshot()
        compiles = sum(s["value"] for s in snap["metrics"]["series"]
                       if s["name"] == "operator_compile_count")
        causes = recompile_causes(m)
        if compiles != 1 or causes:
            raise AssertionError(f"obs ({label}): compile count {compiles}, "
                                 f"recompile causes {causes}")
        for path, body in scrapes:
            if path == "/metrics":
                bad = [l for l in body.splitlines()
                       if l and not l.startswith("#") and not PROM_LINE.match(l)]
                if bad or not body:
                    raise AssertionError(f"obs: /metrics does not parse: {bad[:3]}")
                n_metrics += 1
            else:
                json.loads(body)["metrics"]["series"]
                n_snap += 1
        if label == "on" and not scrapes:
            raise AssertionError("obs: a scraped run saw no scrape")
        if label.startswith("on") and snap["health"]["level"] != "ok":
            raise AssertionError(f"obs ({label}): health ended at "
                                 f"{snap['health']['level']}: {snap['health']}")
    eps = {}
    for label, m, wall, _ in runs:
        eps.setdefault(label, []).append(n_lines / wall)
    pairs = [(on - off) / off for off, on in zip(eps["off"], eps["on"])]
    print(f"obs: rows equal the oracle in all {len(runs)} runs ({len(want)}); "
          f"d2h_syncs {syncs.pop()} in every run; one build and no recompile "
          f"in every obs run; {n_metrics} /metrics and {n_snap} "
          f"/snapshot.json scrapes parsed; health ok")
    print(f"obs: events_per_s_obs_off={eps['off']} events_per_s_obs_on="
          f"{eps['on']} change_a_pair={pairs} on_no_scraper="
          f"{eps['on, no scraper']} registry_only={eps['registry only']}")
    label, on, _, _ = [r for r in runs if r[0] == "on"][-1]
    snap = on.obs_snapshot()
    spans = {}
    for e in snap["trace"]["events"]:
        spans[e["kind"]] = spans.get(e["kind"], 0.0) + e["dur_s"]
    s = on.summary()
    lat = next(x["value"] for x in snap["metrics"]["series"]
               if x["name"] == "operator_sink0_e2e_latency_ms")
    print(f"obs: last on run: {len(on.job_obs.snapshotter.snapshots)} snapshots "
          f"kept, trace ring {snap['trace']['total_spans']} spans "
          f"({snap['trace']['dropped_spans']} dropped)")
    print("obs: span seconds by kind " + " ".join(
        f"{k}={v}" for k, v in sorted(spans.items()))
        + f"; Metrics stage sums parse_s={s['host_time_s']} "
        f"upload_s={s['upload_time_s']} step_s={s['device_time_s']} "
        f"fetch_s={s['fetch_time_s']} emit_s={s['emit_time_s']}")
    print(f"obs: latency markers source->sink0 count={lat['count']} "
          f"p50_ms={lat['p50']} p99_ms={lat['p99']}")

    short = lines[:B_MAIN]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, traced, _, _ = obs_run(short, ObsConfig(enabled=True))
    names = {e.name for e in prof.events()}
    # every span kind the run traced (the int32 config's fire budget keeps
    # its uploads unstaged, so it has no h2d hop, as in the reference),
    # and the fold's sub-span, which only the profiler sees
    kinds = sorted({e["kind"] for e in traced.obs_snapshot()["trace"]["events"]})
    missing = [k for k in kinds + ["step.fold"] if f"tpustream.{k}" not in names]
    if missing or not {"parse", "pack", "dispatch", "fetch", "emit"} <= set(kinds):
        raise AssertionError(f"obs: spans {missing} of {kinds} not among the "
                             f"profiler's events")
    cuda = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    print(f"obs: profiled run ({len(short)} lines): every span kind "
          f"{list(kinds)} and step.fold among the profiler's events, beside "
          f"{cuda} CUDA events")


# -- phase small: the new jobs on the card equal the same jobs on the CPU ---

# -- phase pipeline: the executor pipeline at three settings -----------------

PIPELINE_SETTINGS = {
    # fully synchronous: one step in flight, no staging, no compaction,
    # the wire unpacked
    "sync": dict(async_depth=1, h2d_depth=1, compaction_capacity=0,
                 packed_wire=False, h2d_compress=False),
    "defaults": {},
    "deep": dict(async_depth=4, h2d_depth=3, fetch_group=2, parse_ahead=2),
}
LANE_FRAME = 16384  # lines a raw frame of the lanes' source: 31 frames a 500k
PIPELINE_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"


def pipeline_line(label: str, m, wall: float) -> None:
    """One run's numbers: the wall split, waits on the card a step and
    the wire bytes each way."""
    print(f"pipeline {label}: {wall_split(m, wall)} "
          f"waits_per_step={m.d2h_syncs / max(1, m.steps)} "
          f"h2d_bytes_total={m.h2d_bytes} fetch_bytes_total={m.d2h_bytes} "
          f"compaction_spills={m.compaction_spills}")


def one_build(label: str, counts: dict, m=None) -> None:
    """Every run builds its program once; a wire demotion is the only
    rebuild, reported by its cause (obs-enabled runs)."""
    if sorted(counts.values()) != [1]:
        raise AssertionError(f"{label}: program builds {counts}")
    counts.clear()
    if m is not None:
        causes = recompile_causes(m)
        if set(causes) - {"batch_shape_change"}:
            raise AssertionError(f"{label}: rebuilds by cause {causes}")


def flight_kinds(m) -> list:
    return [e["kind"] for e in m.job_obs.flight.events()]


def lane_run(lines, n_lines, injector=None, **cfg):
    """The flagship's int32 config from raw frames of LANE_FRAME lines
    through ``ingest_lanes=4``, obs on (the plane's breadcrumbs and
    per-lane series): ``(rows, metrics, wall)``."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.sources import ReplayBytesSource

    config = StreamConfig(
        device=PIPELINE_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
        alert_capacity=1 << 16,
        ingest_lanes=4, obs=ObsConfig(enabled=True),
        **FLAGSHIP_CONFIGS["int32"], **cfg)
    if injector is not None:
        config = injector.install(config)
    env = StreamExecutionEnvironment(config)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    frames = [("\n".join(lines[i:i + LANE_FRAME]).encode(),
               len(lines[i:i + LANE_FRAME]))
              for i in range(0, n_lines, LANE_FRAME)]
    handle = chapter3_bandwidth_eventtime.build(
        env, env.add_source(ReplayBytesSource(frames))).collect()
    t0 = time.perf_counter()
    env.execute("BandwidthMonitorWithEventTime")
    return [repr(t) for t in handle.items], env.metrics, time.perf_counter() - t0


def lane_series(m, name: str) -> dict:
    return {s["labels"]["lane"]: s["value"]
            for s in m.obs_snapshot()["metrics"]["series"]
            if s["name"] == name and "lane" in s["labels"]}


def pipeline_phase(n_lines: int, flagship_lines: int, dead_lines: int,
                   reps: int) -> dict:
    """The executor pipeline on the card. Chapter 2 on the kernel and
    the flagship's int32 config at three settings (``sync``, the
    defaults, ``deep``), each against its oracle; the flagship from raw
    frames through four ingest lanes, then again with one lane SIGKILLed
    at frame 3 (it must heal in place); chapter 1 with one line in
    10,000 malformed under ``dead_letter``; the flagship under the
    adaptive controller. Returns the kernel's launches on the chapter-2
    ``defaults`` run and its case on that run's second call."""
    from tpustream_torch.config import ObsConfig
    from tpustream_torch.jobs import chapter1_threshold, chapter2_max
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.testing import FaultInjector, FaultPoint

    out = {}
    counts, undo = count_builds()
    try:
        # chapter 2 on the kernel
        lines = make_lines(n_lines, K_MAIN, seed=7)
        want = oracle_rows(lines)
        for name, cfg in PIPELINE_SETTINGS.items():
            box, undo_cap = (capture_kernel_call(1) if name == "defaults"
                             else (None, lambda: None))
            S.reset_launches()
            try:
                items, m, wall = run_job(
                    chapter2_max, lines, PIPELINE_DEVICE, "ComputeCpuMax",
                    batch_size=B_MAIN, key_capacity=K_MAIN, **cfg)
            finally:
                undo_cap()
            launches = S.seq_rolling_reduce.launches
            if [tuple(t.values()) for t in items] != want:
                raise AssertionError(f"pipeline ch2 {name}: rows differ from "
                                     f"the oracle")
            if launches != m.steps or m.steps < 1:
                raise AssertionError(f"pipeline ch2 {name}: kernel launched "
                                     f"{launches} times over {m.steps} steps")
            one_build(f"pipeline ch2 {name}", counts)
            print(f"pipeline ch2 {name}: {len(items)} rows equal the oracle; "
                  f"seq_rolling_reduce launches={launches} (one a data step); "
                  f"{check_native(f'pipeline ch2 {name}', m)}")
            pipeline_line(f"ch2 {name}", m, wall)
            if name == "defaults":
                out["launches"] = launches
                out["case"] = path_kernel_case("pipeline", box["call"], reps)

        # the flagship's int32 config
        lines, ts, ch, flow = make_flagship_input(flagship_lines, K_MAIN, seed=3)
        want = [f"({c},{v!r})" for c, v in
                flagship_oracle(ts, ch, flow, int32_panes=True)]
        losses = ("late_dropped", "alert_overflow", "evicted_unfired",
                  "buffer_overflow")
        for name, cfg in PIPELINE_SETTINGS.items():
            rows, m, wall = run_flagship(lines, PIPELINE_DEVICE,
                                         **FLAGSHIP_CONFIGS["int32"], **cfg)
            if rows != want:
                raise AssertionError(f"pipeline flagship {name}: {len(rows)} "
                                     f"rows vs {len(want)} from the oracle")
            lost = check_losses(f"pipeline flagship {name}", m, losses)
            one_build(f"pipeline flagship {name}", counts)
            print(f"pipeline flagship {name}: {len(rows)} rows equal the "
                  f"oracle; {lost}; "
                  f"{check_native(f'pipeline flagship {name}', m)}")
            pipeline_line(f"flagship {name}", m, wall)

        # chapter 4 (CEP) at sync and deep: its waits on the card a step
        from tpustream_torch import OutputTag, Time
        from tpustream_torch.jobs import chapter4_cep_alert as ch4

        cep_rows = {}
        for name in ("sync", "deep"):
            timeouts = []

            def build(text):
                tag = OutputTag("breach-timeout")
                alerts = ch4.build(None, text, delay=Time.minutes(1),
                                   timeout_tag=tag)
                timeouts.append(alerts.get_side_output(tag).collect())
                return alerts

            items, m, wall = run_env(
                build, lines, PIPELINE_DEVICE, "cep", True, batch_size=B_MAIN,
                key_capacity=K_MAIN, alert_capacity=1 << 18,
                **PIPELINE_SETTINGS[name])
            cep_rows[name] = ([repr(t) for t in items],
                              [repr(t) for t in timeouts[0].items])
            check_losses(f"pipeline cep {name}", m,
                         ("late_dropped", "alert_overflow"))
            one_build(f"pipeline cep {name}", counts)
            print(f"pipeline cep {name}: {len(cep_rows[name][0])} alerts, "
                  f"{len(cep_rows[name][1])} timeouts")
            pipeline_line(f"cep {name}", m, wall)
        if cep_rows["deep"] != cep_rows["sync"] or not cep_rows["sync"][0]:
            raise AssertionError("pipeline cep: deep rows differ from sync")

        # ingest lanes, then one lane killed at frame 3
        for label, inj in (("lanes", None), (
                "lanes, lane killed", FaultInjector(
                    FaultPoint("lane_worker_crash", at=3, exit_code=-9)))):
            extra = {} if inj is None else {"ingest_lane_restarts": 1}
            rows, m, wall = lane_run(lines, flagship_lines, inj, **extra)
            if rows != want:
                raise AssertionError(f"pipeline {label}: {len(rows)} rows vs "
                                     f"{len(want)} from the oracle")
            check_losses(f"pipeline {label}", m, losses)
            one_build(f"pipeline {label}", counts, m)
            kinds = flight_kinds(m)
            per_lane = lane_series(m, "ingest_lane_records_total")
            if ("ingest_lanes_enabled" not in kinds
                    or "ingest_lanes_disabled" in kinds
                    or "ingest_degraded" in kinds):
                raise AssertionError(f"pipeline {label}: the lane plane did "
                                     f"not run ({kinds})")
            restarts = sum(lane_series(m, "ingest_lane_restarts_total").values())
            if inj is None:
                if sum(per_lane.values()) != flagship_lines or restarts:
                    raise AssertionError(
                        f"pipeline {label}: lanes parsed {per_lane} of "
                        f"{flagship_lines} lines, restarts {restarts}")
            elif (restarts != 1 or "ingest_lane_restarted" not in kinds
                  or "ingest_lane_folded" in kinds):
                raise AssertionError(
                    f"pipeline {label}: restarts {restarts}, events "
                    f"{[k for k in kinds if k.startswith('ingest_')]}")
            print(f"pipeline {label}: {len(rows)} rows equal the oracle; "
                  f"records a lane {per_lane}; ingest_lane_restarts_total="
                  f"{restarts}; "
                  f"{[k for k in kinds if k.startswith('ingest_lane_')]}")
            pipeline_line(label, m, wall)

        # dead letters: one line in 10,000 of chapter 1's is malformed
        g = np.arange(dead_lines, dtype=np.int64)
        h = g * 2654435761
        hosts = ((h ^ (h >> 31)) % 256).tolist()
        clean = [f"1563450000 h{hh:06d} cpu{c} {'91.5' if a else '50.5'}"
                 for hh, c, a in zip(hosts, (g % 4).tolist(),
                                     (g % 128 == 0).tolist())]
        want_dl = [(f"h{hh:06d}", f"cpu{c}", 91.5) for hh, c, a in
                   zip(hosts, (g % 4).tolist(), (g % 128 == 0).tolist()) if a]
        poisoned = list(clean)
        bad_at = list(range(5_000, dead_lines, 10_000))
        for i in bad_at:
            poisoned[i] = f"!!malformed line {i}!!"
            if clean[i].endswith("91.5"):
                raise AssertionError("a malformed line replaced an alert")
        from tpustream_torch import StreamExecutionEnvironment
        from tpustream_torch.config import StreamConfig
        from tpustream_torch.runtime.sources import ReplaySource

        env = StreamExecutionEnvironment(StreamConfig(
            device=PIPELINE_DEVICE, batch_size=65536, dead_letter=True))
        handle = chapter1_threshold.build(
            env, env.add_source(ReplaySource(poisoned))).collect()
        t0 = time.perf_counter()
        env.execute("Window WordCount")
        wall = time.perf_counter() - t0
        m = env.metrics
        got = [tuple(t.values()) for t in handle.items]
        dead = env.dead_letters
        if (got != want_dl or len(dead) != len(bad_at)
                or m.records_quarantined != len(bad_at)
                or [d[0] for d in dead] != [poisoned[i] for i in bad_at]):
            raise AssertionError(
                f"pipeline dead letters: {len(got)} rows vs {len(want_dl)}, "
                f"{len(dead)} dead letters and {m.records_quarantined} "
                f"quarantined vs {len(bad_at)} malformed")
        one_build("pipeline dead letters", counts)
        print(f"pipeline dead letters: {dead_lines} chapter-1 lines, "
              f"{len(bad_at)} malformed: {len(got)} rows equal the oracle, "
              f"len(dead_letters)={len(dead)} records_quarantined="
              f"{m.records_quarantined}; first {dead[0]}")
        pipeline_line("dead letters", m, wall)

        # the adaptive controller
        rows, m, wall = run_flagship(
            lines, PIPELINE_DEVICE, obs=ObsConfig(enabled=True, adaptive=True,
                                         snapshot_interval_s=0.25,
                                         adaptive_cooldown_ticks=0),
            **FLAGSHIP_CONFIGS["int32"])
        if rows != want:
            raise AssertionError(f"pipeline controller: {len(rows)} rows "
                                 f"differ from the defaults run's")
        check_losses("pipeline controller", m, losses)
        one_build("pipeline controller", counts, m)
        moves = [(e.get("action"), e.get("knob"), e.get("old"), e.get("new"))
                 for e in m.job_obs.flight.events()
                 if e["kind"] == "controller_decision"]
        knobs = {s["name"]: s["value"]
                 for s in m.obs_snapshot()["metrics"]["series"]
                 if s["name"] in ("controller_async_depth",
                                  "controller_fetch_group",
                                  "controller_h2d_depth")}
        print(f"pipeline controller: {len(rows)} rows equal the defaults "
              f"run's; decisions {moves}; final knobs {knobs}")
        pipeline_line("controller", m, wall)
    finally:
        undo()
    return out


# -- phase recovery: checkpoints, savepoints, supervised restarts -----------

RECOVERY_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"


def recorded_metrics():
    """Keep every Metrics the executor makes (one a supervised attempt):
    ``(list, undo)``."""
    import tpustream_torch.runtime.executor as E

    made = []
    plain = E.Metrics

    class Recorded(plain):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    E.Metrics = Recorded
    return made, lambda: setattr(E, "Metrics", plain)


def series_value(m, name: str, field=None):
    """The sum of an obs series over its labels (a histogram's
    ``field``, e.g. ``sum``), from an attempt's registry."""
    total = 0
    for s in m.obs_snapshot()["metrics"]["series"]:
        if s["name"] == name:
            v = s["value"]
            total += v[field] if field else v
    return total


def checkpoint_lines(label: str, made) -> None:
    """Each attempt's barrier captures and each write report it noted
    (a write still queued when its attempt failed lands, unreported). A
    restored attempt counts its batches from the restore, skipped ones
    included, so its first barrier may re-save the restored position."""
    for a, m in enumerate(made):
        print(f"recovery {label}: attempt {a} capture_ms="
              f"{m.checkpoint_capture_ms}")
        for r in m.checkpoint_reports:
            print(f"recovery {label}: attempt {a} wrote "
                  f"{r['path'].rsplit('/', 1)[-1]} batches={r['batches']} "
                  f"write_wall_ms={r.get('write_wall_ms')} bytes="
                  f"{r['bytes_total']} bytes_delta={r['bytes_delta']} "
                  f"chunks_written={r['chunks_written']} chunks_reused="
                  f"{r['chunks_reused']} gc_deleted={r['gc_deleted']}")


def supervised(env, interval: int, directory: str, at: int):
    """Checkpointing every ``interval`` batches into ``directory``, a
    fixed-delay restart strategy and a ``device_step`` fault at data
    step ``at``: the injector."""
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    inj = FaultInjector(FaultPoint("device_step", at=at))
    env.config = inj.install(env.config)
    env.enable_checkpointing(interval, directory)
    env.set_restart_strategy(fixed_delay(3, 0.0))
    return inj


def check_recovered(label: str, inj, m) -> dict:
    restarts = series_value(m, "job_restarts_total")
    if inj.fired != 1 or restarts != 1:
        raise AssertionError(f"recovery {label}: fault fired {inj.fired} "
                             f"times, job_restarts_total={restarts}")
    kinds = flight_kinds(m)
    for want in ("job_failed", "job_restarting", "job_restored", "job_recovered"):
        if want not in kinds:
            raise AssertionError(f"recovery {label}: no {want} in {kinds}")
    return {"recovery_wall_ms": series_value(m, "recovery_wall_ms", "sum"),
            "recovery_replay_batches": series_value(m, "recovery_replay_batches")}


def recovery_ch2(n_lines: int) -> dict:
    """Chapter 2 at the job phase's shape: an uninterrupted run, then a
    supervised one crashed at data step 5 (snapshots every 2 batches),
    whose rows must equal it and the oracle; the kernel held against its
    plain version on its first call after the restore."""
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.sources import ReplaySource

    lines = make_lines(n_lines, K_MAIN, seed=7)
    want = [str(r) for r in oracle_rows(lines)]

    def run(directory=None, at=None):
        env = StreamExecutionEnvironment(StreamConfig(
            device=RECOVERY_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            obs=ObsConfig(enabled=True)))
        inj = supervised(env, 2, directory, at) if directory else None
        h = build(env, env.add_source(ReplaySource(lines))).collect()
        t0 = time.perf_counter()
        env.execute("ComputeCpuMax")
        wall = time.perf_counter() - t0
        return [str(tuple(t.values())) for t in h.items], env.metrics, wall, inj

    full, m0, wall0, _ = run()
    if full != want:
        raise AssertionError("recovery ch2: the uninterrupted run differs "
                             "from the oracle")
    steps = m0.steps
    with tempfile.TemporaryDirectory() as d:
        # the first attempt runs 5 steps (calls 0-4) and fails at the
        # 6th: call 5 is the restored run's first
        box, undo = capture_kernel_call(index=5)
        made, undo_m = recorded_metrics()
        S.reset_launches()
        try:
            got, m, wall, inj = run(d, at=5)
        finally:
            undo()
            undo_m()
        launches = S.seq_rolling_reduce.launches
        rec = check_recovered("ch2", inj, m)
        if got != full:
            raise AssertionError("recovery ch2: recovered rows differ from "
                                 "the uninterrupted run")
        checkpoint_lines("ch2", made)
        keep_manifest("ch2", d)
    print(f"recovery ch2: {n_lines} lines, {steps} steps a run, recovered "
          f"rows equal the uninterrupted run and the oracle; "
          f"job_restarts_total=1 {rec} kernel launches={launches}; "
          f"events_per_s uninterrupted={n_lines / wall0} "
          f"recovered={n_lines / wall} (wall_s {wall0} / {wall})")
    if RECOVERY_DEVICE != "cuda":
        return {"launches": launches}
    case = path_kernel_case("recovery (first call after the restore)",
                            box["call"], 20)
    return {"launches": launches, "case": case}


def recovery_flagship(n_lines: int) -> None:
    """The flagship's exact config at 1M lines and 1M channels, async
    incremental snapshots every 3 batches, crashed at data step 5: rows
    equal to an uninterrupted run and the oracle, losses 0, the
    snapshots' sizes and times, the recovery's wall and replay; then a
    restore drill on the store."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.checkpoint import restore_drill
    from tpustream_torch.runtime.sources import ReplaySource
    from tpustream_torch.runtime.window_program import WindowProgram

    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    want = [f"({c},{v!r})" for c, v in flagship_oracle(ts, ch, flow)]

    def run(directory=None, at=None):
        env = StreamExecutionEnvironment(StreamConfig(
            device=RECOVERY_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            alert_capacity=1 << 16, obs=ObsConfig(enabled=True)))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        inj = supervised(env, 3, directory, at) if directory else None
        h = chapter3_bandwidth_eventtime.build(
            env, env.add_source(ReplaySource(lines))).collect()
        t0 = time.perf_counter()
        env.execute("BandwidthMonitorWithEventTime")
        wall = time.perf_counter() - t0
        return [repr(t) for t in h.items], env.metrics, wall, inj

    full, m0, wall0, _ = run()
    if full != want:
        raise AssertionError("recovery flagship: the uninterrupted run "
                             "differs from the oracle")
    with tempfile.TemporaryDirectory() as d:
        got_bytes, undo_b = state_bytes(WindowProgram)
        made, undo_m = recorded_metrics()
        try:
            got, m, wall, inj = run(d, at=5)
        finally:
            undo_b()
            undo_m()
        rec = check_recovered("flagship", inj, m)
        losses = {k: getattr(m, k) for k in
                  ("late_dropped", "alert_overflow", "evicted_unfired")}
        if got != full or any(losses.values()):
            raise AssertionError(f"recovery flagship: recovered rows equal "
                                 f"the uninterrupted run: {got == full}; "
                                 f"losses {losses}")
        checkpoint_lines("flagship", made)
        keep_manifest("flagship", d)
        t0 = time.perf_counter()
        drill = restore_drill(d)
        drill_s = time.perf_counter() - t0
        if drill["ok"] is not True:
            raise AssertionError(f"recovery flagship: restore drill {drill}")
    print(f"recovery flagship: {n_lines} lines, {len(full)} rows equal the "
          f"uninterrupted run and the oracle; {losses}; state_bytes="
          f"{got_bytes.get('n')} job_restarts_total=1 {rec}; restore drill "
          f"ok in {drill_s} s; events_per_s uninterrupted={n_lines / wall0} "
          f"recovered={n_lines / wall} (wall_s {wall0} / {wall})")


def recovery_savepoint(n_lines: int) -> None:
    """A savepoint of the flagship's int32 config after the third batch,
    restored in a fresh env: its rows equal the uninterrupted run's
    suffix from the savepoint's ``emitted``."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.checkpoint import load_checkpoint
    from tpustream_torch.runtime.sources import ReplaySource

    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    want = [f"({c},{v!r})" for c, v in
            flagship_oracle(ts, ch, flow, int32_panes=True)]

    class SavepointAt(ReplaySource):
        """Requests a savepoint as it yields its third batch (the
        executor writes it at that batch's boundary)."""

        def __init__(self, items, env):
            super().__init__(items)
            self.env = env

        def batches(self, batch_size, max_delay_ms):
            for i, sb in enumerate(super().batches(batch_size, max_delay_ms)):
                if i == 2:
                    self.env.savepoint("batch3")
                yield sb

    def run(directory, restore=None):
        env = StreamExecutionEnvironment(StreamConfig(
            device=RECOVERY_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            alert_capacity=1 << 16, checkpoint_dir=directory, parse_ahead=0,
            **FLAGSHIP_CONFIGS["int32"]))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        if restore is not None:
            env.restore_from_checkpoint(restore)
            src = ReplaySource(lines)
        else:
            src = SavepointAt(lines, env)
        h = chapter3_bandwidth_eventtime.build(env, env.add_source(src)).collect()
        t0 = time.perf_counter()
        env.execute("BandwidthMonitorWithEventTime")
        return [repr(t) for t in h.items], env, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        full, env, wall0 = run(d)
        if full != want or len(env.savepoints) != 1:
            raise AssertionError(f"recovery savepoint: rows equal the oracle: "
                                 f"{full == want}; savepoints {env.savepoints}")
        sp = env.savepoints[0]
        ck = load_checkpoint(sp)
        got, _, wall = run(d, restore=sp)
        if got != full[ck.emitted:] or ck.batches != 3:
            raise AssertionError(
                f"recovery savepoint: restored rows equal the suffix: "
                f"{got == full[ck.emitted:]}; savepoint batches {ck.batches}")
    print(f"recovery savepoint: {sp.rsplit('/', 1)[-1]} after batch 3 "
          f"(source_pos={ck.source_pos}, emitted={ck.emitted}); the fresh "
          f"env's {len(got)} rows equal the uninterrupted run's suffix; "
          f"wall_s full={wall0} restored={wall}")


# the newest snapshot manifest of each recovery run, kept for the
# analysis phase's audit (a manifest carries every leaf's dtype and shape;
# the audit reads nothing else)
SNAPSHOTS: dict = {}
_KEPT: list = []  # the directory holding them, made at first use


def keep_manifest(label: str, directory: str) -> None:
    import glob
    import shutil

    if not _KEPT:
        _KEPT.append(tempfile.TemporaryDirectory())
    newest = sorted(glob.glob(os.path.join(directory, "ckpt-*.npz")))[-1]
    SNAPSHOTS[label] = shutil.copy(newest, os.path.join(
        _KEPT[0].name, f"{label}-{os.path.basename(newest)}"))


def recovery_phase(n_lines: int, flagship_lines: int) -> dict:
    for name, fn, args in (("ch2", recovery_ch2, (n_lines,)),
                           ("flagship", recovery_flagship, (flagship_lines,)),
                           ("savepoint", recovery_savepoint, (flagship_lines,))):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"recovery {name}: {time.perf_counter() - t0:.1f} s")
        if name == "ch2":
            result = out
    return result


# -- phase analysis: the pre-flight analyzer, the audit, the dump CLI --------

CHAPTERS = ("chapter1_threshold", "chapter2_avg", "chapter2_max",
            "chapter2_median", "chapter3_bandwidth",
            "chapter3_bandwidth_eventtime", "chapter4_cep_alert",
            "chapter5_dynamic_rules", "chapter6_tenant_fleet")


def analysis_lint() -> None:
    """``python -m tpustream_torch.analysis.lint`` over the port's chapter
    jobs as a subprocess (exit 0, no error finding), then each job's
    ``analyze()`` in this process, first call and warm."""
    import importlib

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpustream_torch.analysis.lint"],
                          capture_output=True, text=True, timeout=300,
                          cwd=HERE)
    lint_s = time.perf_counter() - t0
    oks = [ln for ln in proc.stdout.splitlines() if ": ok (0 errors" in ln]
    if proc.returncode != 0 or len(oks) != len(CHAPTERS):
        raise AssertionError(f"analysis lint: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-2000:]}")
    print(f"analysis lint: rc 0, {len(oks)} job modules with 0 errors, "
          f"{lint_s} s as a subprocess")
    for ch in CHAPTERS:
        env = importlib.import_module(f"tpustream_torch.jobs.{ch}").lint_env()
        t0 = time.perf_counter()
        found = env.analyze()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        env.analyze()
        warm = time.perf_counter() - t0
        print(f"analysis analyze() {ch}: first_s={first} warm_s={warm} "
              f"findings={[f.code for f in found]}")


def analysis_strict_run(n_lines: int) -> dict:
    """Chapter 2 at the job phase's shape with ``strict_analysis=True`` and
    obs on, over a fetch group wider than its window (a TSM009 WARN, which
    strict analysis lets through): rows against the oracle, the kernel on
    the path, the finding's counter and breadcrumb, and the pre-flight's
    share of the wall. Then the kernel against its plain version on the
    inputs of its second call on this path."""
    import tpustream_torch.analysis as A
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.sources import ReplaySource

    lines = make_lines(n_lines, K_MAIN, seed=7)
    want = oracle_rows(lines)
    env = StreamExecutionEnvironment(StreamConfig(
        device=ANALYSIS_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
        strict_analysis=True, async_depth=2, fetch_group=4,
        obs=ObsConfig(enabled=True)))
    handle = build(env, env.add_source(ReplaySource(lines))).collect()
    plain, spent = A.analyze, []

    def timed_analyze(*a, **k):
        t0 = time.perf_counter()
        out = plain(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    box, undo = capture_kernel_call(index=1)
    A.analyze = timed_analyze
    S.reset_launches()
    try:
        t0 = time.perf_counter()
        env.execute("ComputeCpuMax")
        wall = time.perf_counter() - t0
    finally:
        A.analyze = plain
        undo()
    launches = S.seq_rolling_reduce.launches
    m = env.metrics
    got = [tuple(t.values()) for t in handle.items]
    series = {s["labels"].get("code"): s["value"]
              for s in m.obs_snapshot()["metrics"]["series"]
              if s["name"] == "analysis_findings_total"}
    crumbs = [e["code"] for e in m.job_obs.flight.events()
              if e["kind"] == "analysis_finding"]
    on_card = ANALYSIS_DEVICE == "cuda"
    if got != want or (on_card and launches < 1) or series != {"TSM009": 1} \
            or crumbs != ["TSM009"] or len(spent) != 1:
        raise AssertionError(
            f"analysis strict run: rows equal the oracle {got == want}, "
            f"launches {launches}, findings counters {series}, breadcrumbs "
            f"{crumbs}, analyses {len(spent)}")
    print(f"analysis strict run: chapter 2 strict_analysis=True obs on, "
          f"{n_lines} lines, {m.steps} steps, rows equal the oracle, kernel "
          f"launches={launches}, analysis_findings_total={series}; "
          f"preflight_s={spent[0]} wall_s={wall} preflight_share="
          f"{spent[0] / wall} events_per_s={n_lines / wall}")
    if not on_card:
        return {"launches": launches}
    case = path_kernel_case("analysis (strict, obs on)", box["call"], 20)
    return {"launches": launches, "case": case}


def analysis_refusal() -> None:
    """An event-time window with no timestamp assigner (TSM002) under
    ``strict_analysis``: PlanAnalysisError before anything is allocated
    on the card or launched."""
    import torch

    from tpustream_torch import (PlanAnalysisError, StreamExecutionEnvironment,
                                 Time, TimeCharacteristic)
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs.chapter2_max import parse
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.sources import ReplaySource

    on_card = ANALYSIS_DEVICE == "cuda"
    env = StreamExecutionEnvironment(StreamConfig(
        device=ANALYSIS_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
        strict_analysis=True))
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    (env.add_source(ReplaySource(make_lines(1000, 64, seed=1))).map(parse)
     .key_by(0).time_window(Time.seconds(5)).max(2).collect())
    if on_card:
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() if on_card else 0
    S.reset_launches()
    try:
        env.execute("broken")
    except PlanAnalysisError as e:
        codes = [f.code for f in e.findings]
    else:
        raise AssertionError("analysis refusal: the broken job ran")
    if on_card:
        torch.cuda.synchronize()
    after = torch.cuda.memory_allocated() if on_card else 0
    if "TSM002" not in codes or after != before or \
            S.seq_rolling_reduce.launches or env.metrics is not None:
        raise AssertionError(f"analysis refusal: codes {codes}, allocated "
                             f"{before} -> {after}, launches "
                             f"{S.seq_rolling_reduce.launches}")
    print(f"analysis refusal: PlanAnalysisError {codes}; "
          f"torch.cuda.memory_allocated {before} -> {after}; 0 launches")


def analysis_audit() -> None:
    """The state-layout audit of the recovery phase's snapshots: each
    ``compatible`` against its job's graph; the chapter-2 snapshot
    against the same graph under ``acc_dtype="float32"`` (its aggregated
    leaf float32) ``incompatible`` with TSM042."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.jobs import chapter2_max, chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.sources import ReplaySource

    if set(SNAPSHOTS) != {"ch2", "flagship"}:
        raise AssertionError("analysis audit: run phase recovery first "
                             f"(snapshots kept: {sorted(SNAPSHOTS)})")

    def env_for(module, event_time=False, **cfg):
        env = StreamExecutionEnvironment(StreamConfig(
            device=ANALYSIS_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            **cfg))
        if event_time:
            env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        module.build(env, env.add_source(ReplaySource([]))).collect()
        return env

    for label, env, path, want, code in (
            ("ch2", env_for(chapter2_max), SNAPSHOTS["ch2"], "compatible", None),
            ("flagship", env_for(chapter3_bandwidth_eventtime, True,
                                 alert_capacity=1 << 16),
             SNAPSHOTS["flagship"], "compatible", None),
            ("ch2 under float32", env_for(chapter2_max, acc_dtype="float32"),
             SNAPSHOTS["ch2"], "incompatible", "TSM042")):
        t0 = time.perf_counter()
        report = env.audit_checkpoint(path)
        audit_s = time.perf_counter() - t0
        codes = [f.code for f in report.findings]
        if report.verdict != want or (code is not None and code not in codes):
            raise AssertionError(f"analysis audit {label}: {report.verdict} "
                                 f"{[str(f) for f in report.findings]}")
        print(f"analysis audit {label}: {report.verdict} {codes} "
              f"({len(report.manifest.leaves)} leaves, {audit_s} s)")


def analysis_dump() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpustream_torch.obs.dump",
                           "--selftest"], capture_output=True, text=True,
                          timeout=300, cwd=HERE)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not last.startswith("selftest ok"):
        raise AssertionError(f"analysis dump: rc {proc.returncode} {last}\n"
                             f"{proc.stderr[-2000:]}")
    print(f"analysis dump: python -m tpustream_torch.obs.dump --selftest "
          f"rc 0, {last} ({time.perf_counter() - t0} s)")


ANALYSIS_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))  # the checkout's root


def analysis_phase(n_lines: int) -> dict:
    result = {}
    for name, fn, args in (("lint", analysis_lint, ()),
                           ("strict run", analysis_strict_run, (n_lines,)),
                           ("refusal", analysis_refusal, ()),
                           ("audit", analysis_audit, ()),
                           ("dump", analysis_dump, ())):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"analysis {name}: {time.perf_counter() - t0:.1f} s")
        if name == "strict run":
            result = out
    return result


# -- phase acc32: the 32-bit accumulators at full width ---------------------

ACC32_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"
ACC32_FLAGSHIP = {"acc_dtype": "float32", "max_fires_per_step": 4}
# the flagship's pane ring: 60 panes a window, its slack and delay, 88
# slots of K cells, plus the sink: the plane the float merge's kernel is
# held at
ACC32_PLANE_SLOTS = 88
OSC_REPLACES = "tpustream/runtime/window_program.py:477-480"


def capture_scatter_call(index: int = 1):
    """Keep the inputs of the path's ``index``-th call (0-based) of the
    fixed-order float merge, cloned before the call adds into them:
    ``(box, undo)``, ``box["call"] = (plane, cells, vals)``."""
    from tpustream_torch.runtime import window_program as W

    plain = W.ordered_scatter_add
    box = {"calls": 0}

    def capture(plane, cells, vals):
        if box["calls"] == index:
            box["call"] = (plane.clone(), cells.clone(), vals.clone())
        box["calls"] += 1
        return plain(plane, cells, vals)

    W.ordered_scatter_add = capture
    return box, lambda: setattr(W, "ordered_scatter_add", plain)


def scatter_case(label: str, plane0, cells, vals, reps: int,
                 plain_reps: int) -> dict:
    """The merge's kernels against their plain version on the card,
    bitwise, and against a second call (the same bits); the call's time
    (all its launches, on int32 cells as the path passes them), the
    plain version's and ``index_add_``'s (the library call that computes
    the same sums in no fixed order), and, as a reference point, the
    stable ``torch.sort`` of the int64 cells alone (what a sort-based
    merge pays before it adds anything). Two bounds from these inputs:
    bytes (cells and values, 4 B each, read once a row; each touched
    cell read and written once, 4 B each way) and the chain (the longest
    run's adds in arrival order, ``ADD_LATENCY_CYCLES`` each at the
    card's maximum SM clock, an operations bound above the adds' time at
    the peak rate); ``bound_ms`` is the larger. The launches a call
    makes are counted from a CUDA graph of the call and held equal to
    ``device_launches``; the profiler's count is printed beside them."""
    import torch

    from tpustream_torch.ops import ordered_scatter as O

    n = plane0.numel() - 1
    cells = cells.to(torch.int32)
    pk, p2, pr = plane0.clone(), plane0.clone(), plane0.clone()
    O.ordered_scatter_add(pk, cells, vals)
    O.ordered_scatter_add(p2, cells, vals)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    O.ordered_scatter_add_ref(pr, cells, vals)
    end.record()
    torch.cuda.synchronize()
    first_plain_ms = start.elapsed_time(end)
    err = float((pk - pr).abs().nan_to_num().max())
    if not torch.equal(pk.view(torch.int32), pr.view(torch.int32)):
        raise AssertionError(f"ordered_scatter_add {label}: kernel != plain, "
                             f"max |diff| {err}")
    if not torch.equal(pk.view(torch.int32), p2.view(torch.int32)):
        raise AssertionError(f"ordered_scatter_add {label}: two launches "
                             f"differ in bits")
    # every cell the call adds into is flushed; the others keep their
    # bits (a copy)
    live = cells[(cells >= 0) & (cells < n)]
    got = pk[live.to(torch.int64)]
    subnormal = int(((got != 0) & (got.abs() < torch.finfo(torch.float32).tiny)
                     ).sum())
    if subnormal:
        raise AssertionError(f"ordered_scatter_add {label}: {subnormal} "
                             f"rows' cells left subnormal")
    ms = time_ms(lambda: O.ordered_scatter_add(pk, cells, vals), reps)
    split, measured = device_split(lambda: O.launch(pk, cells, vals), 5)
    cells64 = cells.to(torch.int64)
    sort_ms = time_ms(lambda: torch.sort(cells64, stable=True), reps)
    # the plain version is one round a rank: a hot cell's run makes it
    # take seconds, so with plain_reps 1 its time is the comparison's call
    plain_ms = (first_plain_ms if plain_reps == 1 else
                time_ms(lambda: O.ordered_scatter_add_ref(pr, cells, vals),
                        plain_reps))
    library_ms = time_ms(lambda: p2.index_add_(0, cells, vals), reps)
    touched = int(torch.unique(live).numel())
    longest = int(torch.unique(live, return_counts=True)[1].max()) \
        if live.numel() else 0
    nbytes = cells.numel() * 8 + 8 * touched
    bytes_bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_bound_ms = longest * ADD_LATENCY_CYCLES / sm_clock_hz() * 1e3
    bound_ms = max(bytes_bound_ms, chain_bound_ms)
    bound_by = "bytes" if bytes_bound_ms >= chain_bound_ms else "operations"
    launches = graph_launches(lambda: O.launch(pk, cells, vals))
    if launches != O.device_launches(cells.numel()):
        raise AssertionError(
            f"ordered_scatter_add {label}: a call enqueued {launches} "
            f"launches, device_launches says "
            f"{O.device_launches(cells.numel())}")
    print(f"kernel ordered_scatter_add {label}: B={cells.numel()} "
          f"cells={n}+1 touched={touched} longest_run={longest}: ok (bitwise "
          f"against the plain version; two launches bitwise equal; no "
          f"subnormal left) max_abs_err={err} ms={ms} plain_ms={plain_ms} "
          f"library_ms={library_ms} (index_add_, atomics) "
          f"ratio_to_library={ms / library_ms} sort_int64_ms={sort_ms} "
          f"(torch.sort, stable, alone) bound_ms={bound_ms} "
          f"bytes_bound_ms={bytes_bound_ms} bytes={nbytes} "
          f"chain_bound_ms={chain_bound_ms} bound_by={bound_by} "
          f"device_launches_per_call={launches} (a captured graph's nodes; "
          f"the profiler counted {measured}) device_ms_by_kernel={split}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bytes_bound_ms=bytes_bound_ms, chain_bound_ms=chain_bound_ms,
                bound_by=bound_by, library_ms=library_ms, sort_ms=sort_ms,
                device_launches_per_call=launches)


def acc32_kernel_cases(reps: int) -> None:
    """The merge's kernels at the flagship's plane (88 x 2^20 + 1 float32
    cells) and batch (B = 131072): uniform, skewed (1024 hot cells take
    90% of the rows) and one-key cells, values from ``torch.randn`` on a
    seeded generator (not integers, so an add out of order shows); then
    the flush: subnormal values into subnormal cells, and values that
    cancel into the subnormal range, on the skewed cells."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2026)
    n = ACC32_PLANE_SLOTS * K_MAIN
    plane0 = torch.randn(n + 1, generator=gen, device=dev)
    uniform = torch.randint(0, n + 1, (B_MAIN,), generator=gen, device=dev)
    hot = torch.rand(B_MAIN, generator=gen, device=dev) < 0.9
    skewed = torch.where(hot, torch.randint(0, 1024, (B_MAIN,), generator=gen,
                                            device=dev), uniform)
    one_key = torch.full((B_MAIN,), 12345, dtype=torch.int64, device=dev)
    vals = torch.randn(B_MAIN, generator=gen, device=dev)
    for label, cells, plain_reps in (("uniform", uniform, 3),
                                     ("skewed", skewed, 3),
                                     ("one_key", one_key, 1)):
        scatter_case(label, plane0, cells, vals, reps, plain_reps)
    # XLA's flush: subnormal values into a plane of subnormals, and
    # normal values that cancel into the subnormal range (+1.5e-38 then
    # -1.4e-38 on a cell), both on the skewed cells so runs form
    tiny = torch.finfo(torch.float32).tiny
    sub_plane = (torch.rand(n + 1, generator=gen, device=dev) - 0.5) * 4 * tiny
    sub_vals = (torch.rand(B_MAIN, generator=gen, device=dev) - 0.5) * 4 * tiny
    scatter_case("subnormal", sub_plane, skewed, sub_vals, reps, 3)
    del sub_plane
    sign = torch.where(torch.arange(B_MAIN, device=dev) % 2 == 0, 1.5, -1.4)
    cancel_vals = (sign * 1e-38 * (1 + 0.01 * torch.rand(
        B_MAIN, generator=gen, device=dev))).to(torch.float32)
    scatter_case("cancel", torch.zeros_like(plane0), skewed, cancel_vals,
                 reps, 3)


def acc32_avg(n_lines: int, acc_dtype: str, reps: int,
              per_minute: int = 100_000) -> dict:
    """The chapter-2 windowed mean (``AvgAggregate``) on the job phase's
    lines under a 32-bit ``acc_dtype``: the (count, sum) accumulator is
    an int32 plane and a float32 plane on the scatter-reduce path, the
    float sum through the fixed-order merge. The oracle adds each
    (window, host) cell's usage as float32 in arrival order (``np.add.at``,
    rounding after every add) and divides in float64, as the job does:
    every row bitwise. Then the kernel against its plain version on the
    path's second merge call."""
    from tpustream_torch.jobs import chapter2_avg
    from tpustream_torch.ops import ordered_scatter as O
    from tpustream_torch.ops import seq_rolling as S

    hosts = make_hosts(n_lines, K_MAIN, seed=7)
    lines = make_lines(n_lines, K_MAIN, seed=7)
    usage = np.array([float(l.rsplit(" ", 1)[1]) for l in lines])
    order, starts = window_groups(hosts, per_minute)
    group = np.empty(n_lines, np.int64)
    group[order] = np.cumsum(starts) - 1
    sums = np.zeros(int(starts.sum()), np.float32)
    np.add.at(sums, group, usage.astype(np.float32))
    counts = np.bincount(group)
    want = sums.astype(np.float64) / counts
    box, undo = capture_scatter_call()
    O.reset_launches()
    S.reset_launches()
    try:
        items, m, wall = run_job(chapter2_avg, with_minutes(lines, per_minute),
                                 device=ACC32_DEVICE, batch_size=B_MAIN,
                                 key_capacity=K_MAIN, alert_capacity=1 << 18,
                                 name="ComputeCpuAvg", acc_dtype=acc_dtype)
    finally:
        undo()
    launches = O.ordered_scatter_add.launches
    got = np.array(items, dtype=np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.flatnonzero(got != want)[0]) if got.shape == want.shape
               else None)
        raise AssertionError(f"acc32 avg {acc_dtype}: {got.size} rows vs "
                             f"{want.size} from the float32 oracle, first "
                             f"difference at row {bad}")
    if ACC32_DEVICE == "cuda" and launches < m.steps // 2:
        raise AssertionError(f"acc32 avg {acc_dtype}: ordered_scatter_add "
                             f"launched {launches} times over {m.steps} steps")
    losses = check_losses(f"acc32 avg {acc_dtype}", m,
                          ("late_dropped", "alert_overflow", "evicted_unfired"))
    print(f"acc32 avg {acc_dtype}: {n_lines} lines at B={B_MAIN}, K={K_MAIN}, "
          f"{got.size} rows equal the float32 arrival-order oracle (bitwise; "
          f"{int(np.sum(got != usage_means(usage, group, counts)))} of them "
          f"differ from the float64 means); {losses}; ordered_scatter_add "
          f"launches={launches}; seq_rolling_reduce launches="
          f"{S.seq_rolling_reduce.launches}")
    print(f"acc32 avg {acc_dtype} {wall_split(m, wall)}")
    out = {"launches": launches}
    if ACC32_DEVICE == "cuda":
        out["case"] = scatter_case(f"on the acc32 avg {acc_dtype} path's call",
                                   *box["call"], reps, 3)
    return out


def acc32_hot_host(n_lines: int, reps: int, per_minute: int = 100_000) -> dict:
    """The chapter-2 mean under float32 with a hot key, as a monitoring
    fleet sees one: one host sends half of the lines (a seeded random
    half), so each batch's minute holds a run of tens of thousands of
    rows on one cell, the merge's long-run fold; and one line in a
    hundred carries a usage below float32's normal range (k * 1e-39),
    which the float32 plane stores as a zero. Every row bitwise against
    a float32 oracle: each (minute, host) cell's usages rounded to
    float32 and flushed as XLA flushes them, added in arrival order
    (``np.add.at``), divided in float64. Then the kernels against their
    plain version on the path's second merge call."""
    from tpustream_torch.jobs import chapter2_avg
    from tpustream_torch.ops import ordered_scatter as O

    rng = np.random.default_rng(8)
    hosts = make_hosts(n_lines, K_MAIN, seed=8)
    hosts[rng.random(n_lines) < 0.5] = K_MAIN  # 10.16.0.0, no other host's
    cpus = rng.integers(0, 8, n_lines)
    tiny_rows = rng.random(n_lines) < 0.01
    usage = np.where(tiny_rows, rng.integers(1, 9, n_lines) * 1e-39,
                     rng.integers(0, 10000, n_lines) / 100)
    lines = [f"{1563452000 + i} 10.{h >> 16}.{(h >> 8) & 255}.{h & 255} "
             f"cpu{c} {u!r}" for i, (h, c, u) in
             enumerate(zip(hosts.tolist(), cpus.tolist(), usage.tolist()))]
    order, starts = window_groups(hosts, per_minute)
    group = np.empty(n_lines, np.int64)
    group[order] = np.cumsum(starts) - 1
    u32 = usage.astype(np.float32)
    u32[np.abs(u32) < np.finfo(np.float32).tiny] = 0.0  # usages are >= 0
    sums = np.zeros(int(starts.sum()), np.float32)
    np.add.at(sums, group, u32)  # nonnegative: no sum is subnormal
    want = sums.astype(np.float64) / np.bincount(group)
    box, undo = capture_scatter_call()
    O.reset_launches()
    try:
        items, m, wall = run_job(chapter2_avg, with_minutes(lines, per_minute),
                                 device=ACC32_DEVICE, batch_size=B_MAIN,
                                 key_capacity=K_MAIN, alert_capacity=1 << 18,
                                 name="ComputeCpuAvg", acc_dtype="float32")
    finally:
        undo()
    launches = O.ordered_scatter_add.launches
    got = np.array(items, dtype=np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.flatnonzero(got != want)[0]) if got.shape == want.shape
               else None)
        raise AssertionError(f"acc32 hot host: {got.size} rows vs {want.size} "
                             f"from the flushed float32 oracle, first "
                             f"difference at row {bad}")
    if ACC32_DEVICE == "cuda" and launches < m.steps // 2:
        raise AssertionError(f"acc32 hot host: ordered_scatter_add launched "
                             f"{launches} times over {m.steps} steps")
    losses = check_losses("acc32 hot host", m,
                          ("late_dropped", "alert_overflow", "evicted_unfired"))
    hot = int(np.sum(hosts == K_MAIN))
    print(f"acc32 hot host float32: {n_lines} lines, {hot} of them from one "
          f"host, {int(tiny_rows.sum())} usages below float32's normal range; "
          f"{got.size} rows equal the flushed float32 oracle (bitwise); "
          f"{losses}; ordered_scatter_add launches={launches}")
    print(f"acc32 hot host {wall_split(m, wall)}")
    out = {"launches": launches}
    if ACC32_DEVICE == "cuda":
        out["case"] = scatter_case("on the acc32 hot-host path's call",
                                   *box["call"], reps, 1)
    return out


def usage_means(usage, group, counts) -> np.ndarray:
    """The exact (float64) means of the same cells, for contrast."""
    s = np.zeros(counts.size)
    np.add.at(s, group, usage)
    return s / counts


def rolling_sum_oracle(ids: np.ndarray, vals: np.ndarray, batch: int):
    """The chapter-2 rolling sum under float32, as the JAX package
    computes it: per batch, each key's prefix of the batch's values in
    float64 (here in arrival order), added to the key's stored float32
    value widened to float64; the key's last row rounds to float32 and
    is stored. ``(emissions, error bound)``: the card folds the prefix
    in the rolling kernel's tree order, which differs from arrival order
    by at most 2(m-1)*eps*sum|v| for m terms, and a stored float32 value
    may then round one float32 ulp apart (eps32 * |stored|)."""
    n = ids.size
    stored = np.zeros(int(ids.max()) + 1, np.float32)
    seen = np.zeros(stored.size, bool)
    emis = np.empty(n)
    bound = np.empty(n)
    for lo in range(0, n, batch):
        k, v = ids[lo:lo + batch], vals[lo:lo + batch]
        order = np.argsort(k, kind="stable")
        sk, sv = k[order], v[order]
        starts = np.r_[True, sk[1:] != sk[:-1]]
        seg = np.cumsum(starts) - 1
        first = np.flatnonzero(starts)
        rank = np.arange(sk.size) - first[seg]
        # each key's running sum in arrival order, one rank at a time
        prefix, pabs = sv.copy(), np.abs(sv)
        for r in range(1, int(rank.max()) + 1):
            at = np.flatnonzero(rank == r)
            prefix[at] = prefix[at - 1] + sv[at]
            pabs[at] = pabs[at - 1] + np.abs(sv[at])
        old = stored[sk].astype(np.float64)
        old_seen = seen[sk]
        e = np.where(old_seen, old + prefix, prefix)
        emis[lo + order] = e
        bound[lo + order] = (2 * rank * np.finfo(np.float64).eps * (np.abs(old) + pabs)
                             + np.finfo(np.float32).eps * np.abs(old))
        last = np.r_[first[1:] - 1, sk.size - 1]
        stored[sk[last]] = e[last].astype(np.float32)
        seen[sk[last]] = True
    return emis, bound


def path_sum_case(label: str, call, reps: int) -> dict:
    """The rolling kernel's float64 sum against its plain version on one
    call's inputs as the path gave them: two summation trees of each
    key's values, so within 2(m-1)*eps*sum|v| of each other; two launches
    bitwise equal; times and the bound from the call's bytes."""
    import torch

    from tpustream_torch.ops import seq_rolling as S

    plane0, keys, vals, op = call
    pk, pr, p2 = plane0.clone(), plane0.clone(), plane0.clone()
    bad = torch.zeros(1, dtype=torch.int32, device=keys.device)
    ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bad)
    e2 = S.seq_rolling_reduce(p2, keys, vals, op, bad_keys=bad)
    er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=bad)
    eps = torch.finfo(vals.dtype).eps
    valid = keys >= 0
    mult = torch.bincount(keys[valid].long(), minlength=plane0.numel()) + 1
    abs_run = S.seq_rolling_reduce_ref(
        plane0.abs().nan_to_num(posinf=0.0, neginf=0.0), keys, vals.abs(),
        "sum", bad_keys=bad)
    bound = 2 * (mult[keys.clamp(min=0).long()] - 1).double() * eps * abs_run
    torch.cuda.synchronize()
    err = float((ek - er).abs().max())
    if not bool(((ek - er).abs() <= bound).all()) or int(bad[0]):
        raise AssertionError(f"{label}: kernel sum outside 2(m-1)*eps*sum|v| "
                             f"of the plain version, max |diff| {err}")
    if not (torch.equal(ek.view(torch.int64), e2.view(torch.int64))
            and torch.equal(pk.view(torch.int64), p2.view(torch.int64))):
        raise AssertionError(f"{label}: two launches differ in bits")
    emis = torch.empty_like(vals)
    ms = time_ms(lambda: S.launch(pk, keys, vals, op, emis, bad), reps)
    plain_ms = time_ms(
        lambda: S.seq_rolling_reduce_ref(pr, keys, vals, op, bad), reps)
    rows, size = keys.numel(), vals.element_size()
    touched = int(torch.unique(keys[valid]).numel())
    nbytes = rows * (keys.element_size() + 2 * size) + 2 * touched * size
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel seq_rolling_reduce float64 sum on the {label} path's "
          f"call: B={rows} K={plane0.numel()} keys={touched}: ok (within "
          f"2(m-1)*eps*sum|v| of the plain version; two launches bitwise "
          f"equal) max_abs_err={err} ms={ms} plain_ms={plain_ms} "
          f"bound_ms={bound_ms} bytes={nbytes}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def acc32_rolling(n_lines: int, reps: int) -> dict:
    """A chapter-2 rolling ``sum`` over usage under ``acc_dtype="float32"``
    at 1M keys: the seq_rolling kernel folds the batch in float64 over a
    float64 widening of the stored float32 plane. Every row against
    :func:`rolling_sum_oracle` within its bound."""
    from tpustream_torch import Tuple2
    from tpustream_torch.javacompat import Double
    from tpustream_torch.ops import ordered_scatter as O
    from tpustream_torch.ops import seq_rolling as S

    lines = make_lines(n_lines, K_MAIN, seed=7)
    hosts = make_hosts(n_lines, K_MAIN, seed=7)
    ids = interned_ids(hosts)
    usage = np.array([float(l.rsplit(" ", 1)[1]) for l in lines])
    want, bound = rolling_sum_oracle(ids, usage, B_MAIN)

    def build(text):
        return (text.map(lambda l: Tuple2(l.split(" ")[1],
                                          Double.parseDouble(l.split(" ")[3])))
                .key_by(0).sum(1))

    box, undo = capture_kernel_call()
    S.reset_launches()
    O.reset_launches()
    try:
        items, m, wall = run_env(build, lines, device=ACC32_DEVICE,
                                 name="rolling sum float32", batch_size=B_MAIN,
                                 key_capacity=K_MAIN, acc_dtype="float32")
    finally:
        undo()
    launches = S.seq_rolling_reduce.launches
    got = np.array([t.f1 for t in items])
    err = np.abs(got - want)
    if got.shape != want.shape or not np.all(err <= bound):
        bad = int(np.flatnonzero(err > bound)[0]) if got.shape == want.shape else None
        raise AssertionError(f"acc32 rolling: {got.size} rows vs {want.size}, "
                             f"row {bad} outside its bound")
    if ACC32_DEVICE == "cuda" and launches < m.steps:
        raise AssertionError(f"acc32 rolling: kernel launched {launches} times "
                             f"over {m.steps} steps")
    print(f"acc32 rolling sum float32: {n_lines} lines, {ids.max() + 1} keys at "
          f"B={B_MAIN}, every row within its bound of the oracle "
          f"({int(np.sum(err == 0))} bit-equal, max |diff| {err.max()}); "
          f"seq_rolling_reduce launches={launches} (float64: "
          f"{S.seq_rolling_reduce.launches_by_dtype.get('float64', 0)}); "
          f"ordered_scatter_add launches={O.ordered_scatter_add.launches}")
    print(f"acc32 rolling {wall_split(m, wall)}")
    out = {"launches": launches}
    if ACC32_DEVICE == "cuda":
        out["case"] = path_sum_case("acc32 rolling", box["call"], reps)
    return out


def acc32_windows(n_lines: int) -> None:
    """One session job and one count-window job under float32: both
    packages keep these accumulators at their kinds' dtypes, so the rows
    are the exact configuration's; the session mean within the session
    phase's bound of its oracle, the count sums exact."""
    from tpustream_torch.runtime.session_program import SessionWindowProgram

    ts, keys, longs, floats = session_input(n_lines)
    names = np.array([f"k{k}" for k in keys.tolist()])
    ids = interned_ids(names)
    order, first, ends, counts, sums, abs_sums, _ = session_oracle(
        ts, keys, floats, ids, SESSION_B)
    lines = [f"{t} k{k} {v}" for t, k, v in
             zip(ts.tolist(), keys.tolist(), floats.tolist())]
    read_ends, undo = session_ends(SessionWindowProgram)
    try:
        items, m, wall = run_env(session_build("mean"), lines,
                                 device=ACC32_DEVICE, event_time=True,
                                 name="session mean float32",
                                 acc_dtype="float32", batch_size=SESSION_B,
                                 key_capacity=SESSION_K, alert_capacity=1 << 14,
                                 fire_capacity=1 << 14, session_extra_panes=16)
    finally:
        undo()
    got_keys = np.array([t.f0 for t in items])
    got_n = np.array([t.f1 for t in items], dtype=np.int64)
    got_mean = np.array([t.f2 for t in items], dtype=np.float64)
    want = sums / counts
    err = np.abs(got_mean - want) if got_mean.shape == want.shape else None
    if (err is None or not np.array_equal(got_keys, names[order][first])
            or not np.array_equal(got_n, counts)
            or not np.array_equal(read_ends(), ends)
            or not np.all(err <= 2 * (counts - 1) * np.finfo(np.float64).eps
                          * abs_sums)):
        raise AssertionError("acc32 session mean float32: a row differs from "
                             "the oracle")
    losses = check_losses("acc32 session", m, ("late_dropped", "evicted_unfired",
                                               "alert_overflow"))
    print(f"acc32 session mean float32: {n_lines} lines, {len(items)} sessions "
          f"equal the oracle (keys, ends, counts exact; means within "
          f"2(m-1)*eps*sum|v|, {int(np.sum(err == 0))} bit-equal); {losses}")
    print(f"acc32 session {run_summary(m, wall)}")

    rng = np.random.default_rng(17)
    hosts = rng.integers(0, 1 << 14, n_lines)
    vals = rng.integers(0, 10**6, n_lines)
    c_lines = [f"{i} h{h} {v}" for i, (h, v) in
               enumerate(zip(hosts.tolist(), vals.tolist()))]
    arrival, window = count_oracle(hosts, vals, 50, 10)
    want_keys = np.array([f"h{x}" for x in hosts[arrival].tolist()])
    want = np.nansum(window, axis=1).astype(np.int64)
    items, m, wall = run_env(count_build(50, 10), c_lines, device=ACC32_DEVICE,
                             name="count float32", batch_size=B_MAIN,
                             key_capacity=131072, alert_capacity=1 << 16,
                             acc_dtype="float32")
    got = np.array([t.f1 for t in items], dtype=np.int64)
    if (got.shape != want.shape or not np.array_equal(got, want)
            or not np.array_equal(np.array([t.f0 for t in items]), want_keys)):
        raise AssertionError("acc32 count (50, 10) float32: a row differs from "
                             "the oracle")
    losses = check_losses("acc32 count", m, ("alert_overflow",))
    print(f"acc32 count (50, 10) reduce float32: {n_lines} lines, {got.size} "
          f"rows equal the oracle (bitwise); {losses}")
    print(f"acc32 count {run_summary(m, wall)}")


def ledger_line(label: str, led) -> None:
    """Every ledger edge's residual (each must be 0) and the violation
    count (0)."""
    state = led.state()
    edges = {e["edge"]: e["residual"] for e in state["edges"]}
    bad = {k: v for k, v in edges.items() if v not in (0, None)}
    if bad or state["violations"]["total"]:
        raise AssertionError(f"{label}: ledger residuals {bad}, violations "
                             f"{state['violations']}")
    print(f"{label}: ledger residuals {edges}; ledger_violations_total="
          f"{state['violations']['total']}")


def acc32_flagship(n_lines: int) -> None:
    """The flagship under float32 (the flow, a Long, is stored as wrapped
    int32 as under int32, so the oracle is the int32 one): obs off, then
    with obs on, a savepoint after its third batch and a restore of that
    savepoint in a fresh env whose collect handle already holds the rows
    emitted before it: every ledger residual 0 in both runs, the
    savepoint's anchors verified by the fresh env's ledger, and the state
    bytes beside the exact configuration's."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.checkpoint import load_checkpoint
    from tpustream_torch.runtime.sources import ReplaySource

    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3)
    want = [f"({c},{v!r})" for c, v in
            flagship_oracle(ts, ch, flow, int32_panes=True)]
    rows, m, wall = run_flagship(lines, ACC32_DEVICE, **ACC32_FLAGSHIP)
    if rows != want:
        raise AssertionError(f"acc32 flagship float32: {len(rows)} rows vs "
                             f"{len(want)} from the oracle")
    losses = check_losses("acc32 flagship", m, ("late_dropped", "alert_overflow",
                                                "evicted_unfired"))
    print(f"acc32 flagship float32: {len(rows)} rows equal the oracle; "
          f"{losses}; {check_native('acc32 flagship', m)}")
    print(f"acc32 flagship float32 {run_summary(m, wall)}")

    class SavepointAt(ReplaySource):
        def __init__(self, items, env):
            super().__init__(items)
            self.env = env

        def batches(self, batch_size, max_delay_ms):
            for i, sb in enumerate(super().batches(batch_size, max_delay_ms)):
                if i == 2:
                    self.env.savepoint("acc32")
                yield sb

    def run(items, directory, restore=None, seed_rows=(), **config):
        env = StreamExecutionEnvironment(StreamConfig(
            device=ACC32_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            alert_capacity=1 << 16, checkpoint_dir=directory, parse_ahead=0,
            obs=ObsConfig(enabled=True), **config))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        if restore is not None:
            env.restore_from_checkpoint(restore)
        src = ReplaySource(items) if restore is not None else SavepointAt(items, env)
        h = chapter3_bandwidth_eventtime.build(env, env.add_source(src)).collect()
        h.items.extend(seed_rows)
        t0 = time.perf_counter()
        env.execute("BandwidthMonitorWithEventTime")
        return h.items, env, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        # the exact configuration's state bytes, from one batch at K
        _, env_x, _ = run(lines[:B_MAIN], d + "/exact")
        exact_bytes = series_value(env_x.metrics, "operator_hbm_state_bytes")
        full, env, wall_on = run(lines, d + "/f32", **ACC32_FLAGSHIP)
        if [repr(t) for t in full] != want or len(env.savepoints) != 1:
            raise AssertionError(f"acc32 flagship obs on: rows equal the "
                                 f"oracle: {[repr(t) for t in full] == want}; "
                                 f"savepoints {env.savepoints}")
        f32_bytes = series_value(env.metrics, "operator_hbm_state_bytes")
        led = env.metrics.job_obs.ledger
        ledger_line("acc32 flagship obs on", led)
        sp = env.savepoints[0]
        ck = load_checkpoint(sp)
        anchors = ck.ledger
        if anchors is None or anchors["sink0"]["count"] != ck.emitted:
            raise AssertionError(f"acc32 savepoint anchors {anchors}, emitted "
                                 f"{ck.emitted}")
        if led.verify_anchors(anchors) is not None:
            raise AssertionError("acc32 savepoint: the run's own ledger refuses "
                                 "its anchors")
        got, env2, wall_r = run(lines, d + "/f32", restore=sp,
                                seed_rows=full[:ck.emitted], **ACC32_FLAGSHIP)
        if [repr(t) for t in got] != want:
            raise AssertionError("acc32 savepoint: the restored rows differ")
        led2 = env2.metrics.job_obs.ledger
        ledger_line("acc32 flagship restored", led2)
        reason = led2.verify_anchors(anchors)
        if reason is not None:
            raise AssertionError(f"acc32 savepoint anchors: {reason}")
    print(f"acc32 flagship obs on: events_per_s_end_to_end={n_lines / wall_on} "
          f"wall_s={wall_on}; operator_hbm_state_bytes float32={f32_bytes} "
          f"exact={exact_bytes} (ratio {f32_bytes / exact_bytes}); savepoint "
          f"{sp.rsplit('/', 1)[-1]} after batch 3 (emitted={ck.emitted}, "
          f"anchor digest {anchors['sink0']['digest'][:16]}...); the fresh "
          f"env's rows equal the oracle and its ledger verifies the "
          f"anchors; restored wall_s={wall_r}")


def acc32_ledger_cost(n_lines: int) -> None:
    """The ledger's cost: the flagship under float32 with obs on, the
    ledger off and on (auto), in two interleaved pairs (off, on, on,
    off); equal rows, every residual 0 in the on runs."""
    from tpustream_torch import StreamExecutionEnvironment, TimeCharacteristic
    from tpustream_torch.config import ObsConfig, StreamConfig
    from tpustream_torch.jobs import chapter3_bandwidth_eventtime
    from tpustream_torch.runtime.sources import ReplaySource

    lines, _, _, _ = make_flagship_input(n_lines, K_MAIN, seed=3)
    rows0 = None
    for ledger in (False, None, None, False):
        env = StreamExecutionEnvironment(StreamConfig(
            device=ACC32_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            alert_capacity=1 << 16, obs=ObsConfig(enabled=True, ledger=ledger),
            **ACC32_FLAGSHIP))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        h = chapter3_bandwidth_eventtime.build(
            env, env.add_source(ReplaySource(lines))).collect()
        t0 = time.perf_counter()
        env.execute("BandwidthMonitorWithEventTime")
        wall = time.perf_counter() - t0
        rows = [repr(t) for t in h.items]
        if rows0 is None:
            rows0 = rows
        elif rows != rows0:
            raise AssertionError("acc32 ledger cost: rows differ between runs")
        label = "ledger off" if ledger is False else "ledger on"
        led = env.metrics.job_obs.ledger
        if (led is None) != (ledger is False):
            raise AssertionError(f"acc32 ledger cost: {label} but ledger {led}")
        if led is not None:
            ledger_line(f"acc32 ledger cost {label}", led)
        print(f"acc32 ledger cost {label}: {run_summary(env.metrics, wall)}")


def acc32_phase(n_lines: int, window_lines: int, ledger_lines: int,
                reps: int) -> dict:
    """The 32-bit accumulator configurations at full width: the merge's
    kernel cases, the flagship under float32 (with obs, a savepoint and
    a restore; then the ledger off and on in interleaved pairs), the
    chapter-2 mean under float32 and int32 (the merge's
    path) and under float32 with a hot host (its long-run fold, and
    XLA's flush), a rolling float32 sum (the rolling kernel's float64 path),
    a session job and a count-window job. Returns the paths' kernel
    entries."""
    out = {}
    for name, fn, args in (
            ("kernel cases", acc32_kernel_cases, (reps,)),
            ("flagship", acc32_flagship, (n_lines,)),
            ("ledger cost", acc32_ledger_cost, (ledger_lines,)),
            ("avg float32", acc32_avg, (n_lines, "float32", reps)),
            ("avg int32", acc32_avg, (n_lines, "int32", reps)),
            ("hot host", acc32_hot_host, (n_lines // 2, reps)),
            ("rolling", acc32_rolling, (n_lines, reps)),
            ("windows", acc32_windows, (window_lines,))):
        if name == "kernel cases" and ACC32_DEVICE != "cuda":
            continue
        t0 = time.perf_counter()
        out[name] = fn(*args)
        print(f"acc32 {name}: {time.perf_counter() - t0:.1f} s")
    return out


AVG_LINES = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.1 cpu0 99.9",
    "1563452056 10.8.22.2 cpu1 20.2",
]
LATE_BASE = 1_200_000  # epoch seconds, a multiple of 60


def lateness_job(lines, device, lateness_s=0, tag=False, **cfg):
    """tests/test_lateness_sideoutput.py's job: 1-minute event-time
    windows summing a flow, the late rows to a side output when
    ``tag``. (main rows, side rows, late_dropped)."""
    from tpustream_torch import (BoundedOutOfOrdernessTimestampExtractor,
                                 StreamExecutionEnvironment, Time,
                                 TimeCharacteristic, Tuple2, Tuple3)
    from tpustream_torch.api.output import OutputTag
    from tpustream_torch.api.windows import TumblingEventTimeWindows
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource

    class Seconds(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.seconds(0))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0]) * 1000

    def parse(line):
        p = line.split(" ")
        return Tuple3(int(p[0]), p[1], int(p[2]))

    env = StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=1, key_capacity=16, **cfg))
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    w = (env.add_source(ReplaySource(lines))
         .assign_timestamps_and_watermarks(Seconds()).map(parse).key_by(1)
         .window(TumblingEventTimeWindows.of(Time.seconds(60))))
    if lateness_s:
        w = w.allowed_lateness(Time.seconds(lateness_s))
    late_tag = OutputTag("late-data") if tag else None
    if tag:
        w = w.side_output_late_data(late_tag)
    summed = w.reduce(lambda a, b: Tuple3(a.f0, a.f1, a.f2 + b.f2))
    main = summed.map(lambda t: Tuple2(t.f1, t.f2)).collect()
    late = summed.get_side_output(late_tag).collect() if tag else None
    env.execute("lateness")
    return ([repr(t) for t in main.items],
            None if late is None else [repr(t) for t in late.items],
            env.metrics.late_dropped)


def small_phase() -> None:
    """The goldens of the new jobs, the max_by golden and the four
    allowed-lateness cases, each on the card equal to the same run on
    the CPU and to the golden rows."""
    from tpustream_torch.jobs import (chapter1_threshold, chapter2_avg,
                                      chapter2_max, chapter2_median)
    from tpustream_torch.runtime.sources import AdvanceProcessingTime

    class MaxBy:
        @staticmethod
        def build(env, text):
            return text.map(chapter2_max.parse).key_by(0).max_by(2)

    tick = [AdvanceProcessingTime(61_000)]
    cases = [
        ("ch1 filter golden", chapter1_threshold,
         ["1563452051 10.8.22.1 cpu2 10.5", "1563452051 10.8.22.1 cpu2 99.2"],
         {}, ["(10.8.22.1,cpu2,99.2)"]),
        ("max_by golden", MaxBy,
         ["1 h1 cpu0 50.0", "2 h1 cpu7 60.0", "3 h1 cpu3 55.0"], {},
         ["(h1,cpu0,50.0)", "(h1,cpu7,60.0)", "(h1,cpu7,60.0)"]),
        ("avg golden", chapter2_avg, AVG_LINES + tick, {},
         ["86.26666666666667", "20.2"]),
        ("avg golden, batch 1", chapter2_avg, AVG_LINES + tick,
         {"batch_size": 1}, ["86.26666666666667", "20.2"]),
        ("avg two windows", chapter2_avg,
         AVG_LINES + tick + ["1563452056 10.8.22.1 cpu0 10.0",
                             "1563452056 10.8.22.1 cpu0 20.0",
                             AdvanceProcessingTime(130_000)], {},
         ["86.26666666666667", "20.2", "15.0"]),
        ("median golden", chapter2_median, AVG_LINES + tick, {},
         ["80.5", "20.2"]),
        ("median golden, batch 1", chapter2_median, AVG_LINES + tick,
         {"batch_size": 1}, ["80.5", "20.2"]),
        ("median even count", chapter2_median,
         ["1 h1 cpu0 1.0", "1 h1 cpu0 2.0", "1 h1 cpu0 10.0",
          "1 h1 cpu0 4.0"] + tick, {}, ["3.0"]),
    ]
    for label, module, items, cfg, golden in cases:
        card, m, _ = run_job(module, items, "cuda", **cfg)
        cpu, _, _ = run_job(module, items, "cpu", **cfg)
        card, cpu = [repr(t) for t in card], [repr(t) for t in cpu]
        if card != cpu or card != golden:
            raise AssertionError(f"small run {label}: card {card}, CPU {cpu}, "
                                 f"golden {golden}")
        print(f"small run {label}: {len(card)} rows, card equals CPU and the "
              f"golden")

    b = LATE_BASE
    early = [f"{b + 10} www.a.com 100", f"{b + 70} www.a.com 7",
             f"{b + 20} www.a.com 900"]
    late_cases = [
        ("dropped by default", early + [f"{b + 140} www.a.com 5"], {},
         ("(www.a.com,1000)", False)),
        ("refire within the lateness", early + [f"{b + 400} www.a.com 5"],
         {"lateness_s": 300}, ("(www.a.com,1000)", True)),
        ("side output past the lateness", early + [f"{b + 140} www.a.com 5"],
         {"tag": True}, ("(www.a.com,1000)", False)),
        ("refire under a fire budget", early + [f"{b + 400} www.a.com 5"],
         {"lateness_s": 300, "max_fires_per_step": 1},
         ("(www.a.com,1000)", True)),
    ]
    for label, lines, kw, (refired, expect_refire) in late_cases:
        card = lateness_job(lines, "cuda", **kw)
        cpu = lateness_job(lines, "cpu", **kw)
        ok = (card == cpu and "(www.a.com,100)" in card[0]
              and (refired in card[0]) == expect_refire)
        if kw.get("tag"):
            ok = ok and card[1] == [f"({b + 20},www.a.com,900)"] and card[2] == 0
        if not ok:
            raise AssertionError(f"lateness {label}: card {card}, CPU {cpu}")
        print(f"small run lateness {label}: main {card[0]}, side {card[1]}, "
              f"late_dropped {card[2]}; card equals CPU")


def subnormal_items(scale: float, n: int = 200, minute: bool = True):
    """The chapter-2 lines of the subnormal probes: 3 hosts, ``usage =
    rng.random() * scale``, and a processing-time minute at the end."""
    from tpustream_torch.runtime.sources import AdvanceProcessingTime

    rng = np.random.default_rng(0)
    out = [f"{1563452000 + i} 10.8.0.{int(rng.integers(0, 3))} cpu{i % 2} "
           f"{float(rng.random() * scale)!r}" for i in range(n)]
    return out + ([AdvanceProcessingTime(n * 400 + 120_000)] if minute else [])


def small_subnormal() -> None:
    """XLA's flush of subnormal floats on the card: the probes of
    ``tests/test_torch_subnormal.py`` (where the CPU rows equal the JAX
    package's), each on the card equal to the same run on the CPU. The
    chapter-2 mean (float32 at 1e-39, exact at 1e-309: every row 0.0),
    the rolling max at 1e-309 (every max 0.0; ``seq_rolling.cu``'s
    explicit flush), a float32 rolling sum near 1e-39 (its stored
    float32 words flushed), a user filter ``usage > 0`` (a comparison),
    and the median at 1e-39 and 1e-309, a copy path that keeps them.
    Then the one-row rule and the scan's zeros on ``seq_rolling.cu``,
    against the JAX package's rows written out here."""
    from tpustream_torch import Tuple2, Tuple3
    from tpustream_torch.jobs import chapter2_avg, chapter2_max, chapter2_median

    class RollingSum:
        @staticmethod
        def build(env, text):
            return text.map(lambda l: Tuple3(l.split(" ")[1], l.split(" ")[2],
                                             float(l.split(" ")[3]))
                            ).key_by(0).sum(2)

    class Positive:
        @staticmethod
        def build(env, text):
            return text.map(lambda l: Tuple2(l.split(" ")[1],
                                             float(l.split(" ")[3]))
                            ).filter(lambda t: t.f1 > 0.0)

    rng = np.random.default_rng(0)
    exact_sums = [f"{1563452000 + i} 10.8.0.{int(rng.integers(0, 3))} "
                  f"cpu{i % 2} {int(rng.integers(1, 4)) * 2.0 ** -130!r}"
                  for i in range(200)]
    signs = [f"{1563452000 + i} 10.8.0.{i % 3} cpu0 {v!r}" for i, v in
             enumerate([1e-309, -1e-309, 5e-324, 1.0, 2e-308, 3e-308, 0.5])]
    cases = [
        ("mean float32 at 1e-39", chapter2_avg, subnormal_items(1e-39),
         {"acc_dtype": "float32"}, lambda r: set(r) == {"0.0"}),
        ("mean exact at 1e-309", chapter2_avg, subnormal_items(1e-309), {},
         lambda r: set(r) == {"0.0"}),
        ("rolling max at 1e-309", chapter2_max,
         subnormal_items(1e-309, minute=False), {},
         lambda r: len(r) == 200 and all(x.endswith(",0.0)") for x in r)),
        ("rolling sum float32 near 1e-39", RollingSum, exact_sums,
         {"acc_dtype": "float32", "batch_size": 16}, lambda r: len(r) == 200),
        ("filter usage > 0", Positive, signs, {"batch_size": 4},
         lambda r: len(r) == 3),
        ("median at 1e-39", chapter2_median, subnormal_items(1e-39), {},
         lambda r: r and all(0.0 < float(x) < 1e-39 for x in r)),
        ("median at 1e-309", chapter2_median, subnormal_items(1e-309), {},
         lambda r: r and all(0.0 < float(x) < 1e-309 for x in r)),
    ]
    for label, module, items, cfg, check in cases:
        cfg = {"batch_size": 64, **cfg}
        card, _, _ = run_job(module, items, "cuda", **cfg)
        cpu, _, _ = run_job(module, items, "cpu", **cfg)
        card, cpu = [repr(t) for t in card], [repr(t) for t in cpu]
        if card != cpu or not check(card):
            raise AssertionError(f"small subnormal {label}: card {card[:4]}, "
                                 f"CPU {cpu[:4]}")
        print(f"small run subnormal {label}: {len(card)} rows, card equals "
              f"CPU (first {card[:2]})")
    # the one-row rule and the scan's zeros through seq_rolling.cu: the rows the JAX
    # package prints for the chapter-2 rolling max over these lines (a
    # batch of one row copies a new key's value; a scan turns a flushed
    # negative subnormal into +0.0), held on the card and on the CPU
    from tpustream_torch.ops import seq_rolling as S

    lines = ["1563452000 10.8.0.1 cpu0 1e-309", "1563452001 10.8.0.1 cpu0 3e-309",
             "1563452002 10.8.0.2 cpu0 -2e-309"]
    for label, batch, want in (
            ("batch_size 1", 1, ["(10.8.0.1,cpu0,1e-309)", "(10.8.0.1,cpu0,0.0)",
                                    "(10.8.0.2,cpu0,-2e-309)"]),
            ("batch_size 4", 4, ["(10.8.0.1,cpu0,0.0)", "(10.8.0.1,cpu0,0.0)",
                                    "(10.8.0.2,cpu0,0.0)"])):
        S.reset_launches()
        card, _, _ = run_job(chapter2_max, lines, "cuda", batch_size=batch)
        launches = S.seq_rolling_reduce.launches
        cpu, _, _ = run_job(chapter2_max, lines, "cpu", batch_size=batch)
        card, cpu = [repr(t) for t in card], [repr(t) for t in cpu]
        if card != want or cpu != want or launches < 1:
            raise AssertionError(f"small subnormal rolling {label}: card "
                                 f"{card}, CPU {cpu}, want {want}, kernel "
                                 f"launches {launches}")
        print(f"small run subnormal rolling {label}: card and CPU print "
              f"the JAX package's rows {card}; kernel launches={launches}")


def small_windows() -> None:
    """Session and count goldens of the JAX package's suites, a session
    with allowed lateness and the late side output, and a session
    ``process()``, each on the card equal to the same run on the CPU and
    to the golden rows."""
    from tpustream_torch import (BoundedOutOfOrdernessTimestampExtractor,
                                 OutputTag, Time, Tuple2)
    from tpustream_torch.api.windows import EventTimeSessionWindows

    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.milliseconds(2_000))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    def median(key, ctx, elements, out):
        vals = sorted(e.f1 for e in elements)
        mid = len(vals) // 2
        out.collect(Tuple2(key, float(vals[mid]) if len(vals) % 2
                           else (vals[mid - 1] + vals[mid]) / 2))

    def sessions(lateness_ms=0, tag=None, process=False):
        def build(text):
            w = (text.assign_timestamps_and_watermarks(Ts())
                 .map(lambda l: Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
                 .key_by(0).window(EventTimeSessionWindows.with_gap(
                     Time.milliseconds(10_000))))
            if lateness_ms:
                w = w.allowed_lateness(Time.milliseconds(lateness_ms))
            if process:
                return w.process(median)
            if tag is not None:
                w = w.side_output_late_data(tag)
                reduced = w.reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1))
                late_rows.append(reduced.get_side_output(tag).collect())
                return reduced
            return w.reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1))
        return build

    def counts(size, slide=None):
        def build(text):
            return (text.map(lambda l: Tuple2(l.split(" ")[0], float(l.split(" ")[1])))
                    .key_by(0).count_window(size, slide)
                    .reduce(lambda a, b: Tuple2(a.f0, a.f1 + b.f1)))
        return build

    def lines(recs):
        return [f"{t} {k} {v}" for t, k, v in recs]

    count_lines = ["a 1", "a 2", "b 10", "a 4", "b 20", "a 8", "b 30", "a 16",
                   "a 32", "a 64", "b 40"]
    cases = [
        ("session golden", sessions(), lines([(1_000, "a", 1), (4_000, "a", 2),
                                              (9_000, "a", 4), (25_000, "a", 8)]),
         1, ["(a,7)", "(a,8)"]),
        ("session out-of-order merge", sessions(),
         lines([(0, "a", 1), (2_000, "a", 2), (13_000, "a", 4), (7_000, "a", 8),
                (60_000, "a", 16)]), 1, ["(a,15)", "(a,16)"]),
        ("session intra-batch rescue", sessions(),
         lines([(0, "a", 1), (50_000, "a", 2), (40_000, "a", 4), (35_000, "a", 8),
                (120_000, "a", 16)]), 2, ["(a,1)", "(a,2)", "(a,12)", "(a,16)"]),
        ("session refire within the lateness", sessions(lateness_ms=30_000),
         lines([(0, "a", 1), (5_000, "a", 2), (30_000, "a", 4), (8_000, "a", 8),
                (90_000, "a", 16)]), 1, ["(a,3)", "(a,11)", "(a,4)", "(a,16)"]),
        ("session process adjacent panes", sessions(process=True),
         ["1000000 a 1", "1019999 a 2", "1100000 b 3"], 8,
         ["(a,1.0)", "(a,2.0)", "(b,3.0)"]),
        ("count tumbling golden", counts(3), count_lines, 4,
         ["(a,7.0)", "(b,60.0)", "(a,56.0)"]),
        ("count sliding golden", counts(3, 2), count_lines, 4,
         ["(a,3.0)", "(b,30.0)", "(a,14.0)", "(a,56.0)", "(b,90.0)"]),
    ]
    for label, build, items, batch, golden in cases:
        late_rows = []
        got = [
            [repr(t) for t in run_env(build, items, dev, event_time=True,
                                      batch_size=batch, key_capacity=16)[0]]
            for dev in ("cuda", "cpu")
        ]
        if got[0] != got[1] or sorted(got[0]) != sorted(golden):
            raise AssertionError(f"small run {label}: card {got[0]}, CPU {got[1]}, "
                                 f"golden {golden}")
        print(f"small run {label}: {len(got[0])} rows, card equals CPU and the golden")
    recs = lines([(0, "a", 1), (40_000, "a", 2), (3_000, "a", 4), (90_000, "a", 8)])
    out = []
    for dev in ("cuda", "cpu"):
        late_rows = []
        items, m, _ = run_env(sessions(lateness_ms=5_000, tag=OutputTag("late")),
                              recs, dev, event_time=True, batch_size=1, key_capacity=16)
        out.append(([repr(t) for t in items], [repr(t) for t in late_rows[0].items],
                    m.late_dropped))
    if out[0] != out[1] or out[0][1] != ["(a,4)"] or out[0][2]:
        raise AssertionError(f"small run session side output: card {out[0]}, CPU {out[1]}")
    print(f"small run session side output past the lateness: main {out[0][0]}, side "
          f"{out[0][1]}, late_dropped {out[0][2]}; card equals CPU")


def small_chains() -> None:
    """Integer rolling goldens at batch sizes 1, 3 and 64, the
    single-device cases of the JAX package's chained-stage suite
    (tests/test_chained_stages.py) and a punctuated-watermark job, each
    on the card equal to the same run on the CPU and to the golden
    rows."""
    from tpustream_torch import (BoundedOutOfOrdernessTimestampExtractor, Time,
                                 Tuple2, Tuple3, Watermark)
    from tpustream_torch.api.watermarks import AssignerWithPunctuatedWatermarks
    from tpustream_torch.api.windows import (EventTimeSessionWindows,
                                             TumblingProcessingTimeWindows)

    roll_lines = [f"1 k{i % 5} {(i * 7) % 97}" for i in range(40)]

    def rolling(kind):
        def build(text):
            return getattr(text.map(lambda l: Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
                           .key_by(0), kind)(1)
        return build

    def rolling_golden(kind):
        acc, out = {}, []
        for line in roll_lines:
            k, v = line.split(" ")[1], int(line.split(" ")[2])
            acc[k] = v if k not in acc else {"sum": acc[k] + v, "max": max(acc[k], v),
                                             "min": min(acc[k], v)}[kind]
            out.append(f"({k},{acc[k]})")
        return out

    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.milliseconds(1000))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    def parse3(line):
        items = line.split(" ")
        return Tuple3(items[1], items[2], int(items[3]))

    add3 = lambda p, q: Tuple3(p.f0, p.f1, p.f2 + q.f2)  # noqa: E731
    add2 = lambda p, q: Tuple2(p.f0, p.f1 + q.f1)  # noqa: E731

    def stage1(text, slide=None):
        w = text.assign_timestamps_and_watermarks(Ts()).map(parse3).key_by(0)
        w = (w.time_window(Time.seconds(10)) if slide is None
             else w.time_window(Time.seconds(10), Time.seconds(slide)))
        return w.reduce(add3)

    def median(key, ctx, elements, out):
        vals = sorted(e.f2 for e in elements)
        mid = len(vals) // 2
        out.collect(Tuple2(key, float(vals[mid]) if len(vals) % 2
                           else (vals[mid - 1] + vals[mid]) / 2))

    class Punct(AssignerWithPunctuatedWatermarks):
        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

        def check_and_get_next_watermark(self, element, extracted_timestamp):
            if element.split(" ")[3] == "wm":
                return Watermark(extracted_timestamp + 9_000)
            return None

    chain_lines = ["1000 a x 5", "2000 b y 7", "5000 a x 3", "12000 a y 4", "25000 b x 9"]
    session_lines = ["1000 a 1", "2000 b 2", "3000 a 4", "9000 b 8", "20000 a 16",
                     "22000 b 32", "23000 a 64", "40000 c 100", "55000 c 200"]
    punct_lines = ["1000 a 1 -", "2000 b 2 -", "3000 a 4 wm", "4000 a 8 -",
                   "2500 b 16 -", "15000 a 32 -", "11000 b 64 wm", "9000 a 128 -",
                   "12000 b 256 -", "31000 a 512 -", "20000 b 1024 -"]
    cases = [(f"int rolling {kind} golden, batch {b}", rolling(kind), roll_lines,
              False, b, rolling_golden(kind))
             for kind in ("sum", "max", "min") for b in (1, 3, 64)]
    cases += [
        ("chain window then int rolling max", lambda t: stage1(t).key_by(1).max(2),
         chain_lines, True, 2, ["(a,x,8)", "(b,y,7)", "(b,y,7)", "(a,x,9)"]),
        ("chain window then processing-time window", lambda t: (
            stage1(t).key_by(1).window(TumblingProcessingTimeWindows.of(Time.minutes(5)))
            .reduce(add3)), chain_lines, True, 2, ["(a,x,17)", "(b,y,11)"]),
        ("chain event-time windows", lambda t: (
            stage1(t).key_by(1).time_window(Time.seconds(30)).reduce(add3)),
         chain_lines, True, 1, ["(a,x,17)", "(b,y,11)"]),
        ("chain after process()", lambda t: (
            t.assign_timestamps_and_watermarks(Ts()).map(parse3).key_by(0)
            .time_window(Time.seconds(10)).process(median)
            .key_by(0).time_window(Time.seconds(30)).reduce(add2)),
         chain_lines, True, 2, ["(a,8.0)", "(b,16.0)"]),
        ("chain sliding-window fed", lambda t: (
            stage1(t, slide=5).key_by(1).time_window(Time.seconds(30)).reduce(add3)),
         chain_lines, True, 2, ["(a,x,29)", "(b,x,9)", "(b,y,18)"]),
        ("chain session fed", lambda t: (
            t.assign_timestamps_and_watermarks(Ts())
            .map(lambda l: Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
            .key_by(0).window(EventTimeSessionWindows.with_gap(Time.seconds(4)))
            .reduce(add2).key_by(0).time_window(Time.seconds(30)).reduce(add2)),
         session_lines, True, 4, ["(a,85)", "(b,42)", "(c,300)"]),
        ("chain computed key on the chain stage", lambda t: (
            t.map(lambda l: Tuple2(l.split(" ")[0], float(l.split(" ")[1])))
            .key_by(0).reduce(add2).key_by(lambda r: len(r.f0)).reduce(add2)),
         ["a 1", "bb 10", "c 2", "dd 20", "e 4", "ff 40", "a 8"], False, 2,
         ["(a,1.0)", "(bb,10.0)", "(a,3.0)", "(bb,30.0)", "(a,7.0)", "(bb,70.0)",
          "(a,16.0)"]),
        ("punctuated watermarks", lambda t: (
            t.assign_timestamps_and_watermarks(Punct())
            .map(lambda l: Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
            .key_by(0).time_window(Time.seconds(10)).reduce(add2)),
         punct_lines, True, 1, None),
    ]
    for label, build, items, event_time, batch, golden in cases:
        runs = [run_env(build, items, dev, event_time=event_time, batch_size=batch,
                        key_capacity=16) for dev in ("cuda", "cpu")]
        card, cpu = ([repr(t) for t in r[0]] for r in runs)
        late = [r[1].late_dropped for r in runs]
        ok = card == cpu and late[0] == late[1] and card
        if golden is not None:
            ok = ok and sorted(card) == sorted(golden)
        if not ok:
            raise AssertionError(f"small run {label}: card {card}, CPU {cpu}, golden "
                                 f"{golden}, late_dropped {late}")
        print(f"small run {label}: {len(card)} rows, late_dropped {late[0]}, card "
              f"equals CPU" + ("" if golden is None else " and the golden"))


CH4_LINES = [
    "2019-08-28T10:00:00 www.163.com 6000",
    "2019-08-28T10:00:10 www.163.com 7000",
    "2019-08-28T10:00:20 www.163.com 8000",
    "2019-08-28T10:00:30 www.sina.com 6100",
    "2019-08-28T10:00:40 www.sina.com 7100",
    "2019-08-28T10:01:00 www.163.com 9000",
    "2019-08-28T10:00:50 www.sina.com 8100",
    "2019-08-28T10:05:00 www.qq.com 50",
]
CH5_LINES = [
    f"15634520{j % 100:02d} 10.8.22.{j % 5} cpu{j % 3} {60 + (j * 13) % 40}.5"
    for j in range(40)
]


def small_cep_rules() -> None:
    """The chapter-4 and chapter-5 goldens of the JAX package's suites
    (tests/test_cep.py's chapter-4 job, tests/test_broadcast.py's
    threshold updates, window parameter and CEP predicate), each on the
    card equal to the same run on the CPU and to the oracle."""
    from tpustream_torch import (BoundedOutOfOrdernessTimestampExtractor, CEP,
                                 OutputTag, Pattern, RuleSet, RuleUpdate, Time,
                                 Tuple2)
    from tpustream_torch.cep import run_oracle
    from tpustream_torch.javacompat import Double
    from tpustream_torch.jobs import chapter4_cep_alert as ch4
    from tpustream_torch.jobs import chapter5_dynamic_rules as ch5
    from tpustream_torch.runtime.sources import ReplaySource
    from tpustream_torch.utils.timeutil import iso_local_to_epoch_sec

    recs = []
    for line in CH4_LINES:
        iso, chan, flow = line.split(" ")
        sec = iso_local_to_epoch_sec(iso)
        recs.append(((sec, chan, int(flow)), sec * 1000))
    m, t, _ = run_oracle(ch4.make_pattern(), [recs], delay_ms=5000)
    want = [f"({b0[1]},{b0[2] + b1[2] + b2[2]},{b0[0]},{b2[0]})" for b0, b1, b2 in m]
    want_t = sorted(repr(r) for r in cep_timeout_rows(
        [(n, s, [e + (0,) for e in evs]) for n, s, evs in t], 2, (0, None, 0)))
    out = []
    for dev in ("cuda", "cpu"):
        side = []

        def build(text):
            tag = OutputTag("breach-timeout")
            alerts = ch4.build(None, text, timeout_tag=tag)
            side.append(alerts.get_side_output(tag).collect())
            return alerts

        items, _, _ = run_env(build, CH4_LINES, dev, event_time=True, batch_size=8)
        out.append(([repr(x) for x in items], sorted(repr(x) for x in side[0].items)))
    if out[0] != out[1] or out[0] != (want, want_t):
        raise AssertionError(f"small run chapter4: card {out[0]}, CPU {out[1]}, "
                             f"oracle {(want, want_t)}")
    print(f"small run chapter4 golden: {len(want)} alerts, {len(want_t)} timeouts, "
          f"card equals CPU and the oracle")

    def ch5_run(dev, updates, batch):
        rules = ch5.make_rules()

        def build(text):
            return ch5.build(text.env, text, text.env.add_source(
                ReplaySource(ch5.control_lines(updates))), rules)

        items, _, _ = run_env(build, CH5_LINES, dev, batch_size=batch)
        return [tuple(x) for x in items], rules.version

    ch5_cases = ([([(17, 95.0)], b) for b in (3, 4, 16, 64)]
                 + [([(5, 95.0), (9, 70.0)], 16), ([(0, 75.0), (10_000, 99.0)], 8)]
                 + [([(13, 95.0), (29, 65.0)], b) for b in (2, 5, 40)])
    for updates, batch in ch5_cases:
        want = [tuple(x) for x in ch5.oracle(CH5_LINES, updates)]
        card, cpu = ch5_run("cuda", updates, batch), ch5_run("cpu", updates, batch)
        if card != cpu or card != (want, len(updates)):
            raise AssertionError(f"small run chapter5 {updates} at batch {batch}: "
                                 f"card {card}, CPU {cpu}, oracle {want}")
        print(f"small run chapter5 updates {updates} at batch {batch}: {len(want)} "
              f"rows, card equals CPU and the oracle")

    def window_param(dev, updates):
        rules = RuleSet()
        limit = rules.declare("sum_limit", 10.0, "f64")

        def build(text):
            text.env.from_collection(
                [RuleUpdate("sum_limit", v, pos) for pos, v in updates]
            ).broadcast(rules)
            return (text.map(lambda s: Tuple2(s.split(" ")[0],
                                              Double.parseDouble(s.split(" ")[1])))
                    .key_by(0).count_window(2).sum(1).filter(lambda x: x.f1 < limit))

        items, _, _ = run_env(build, [f"k {i}" for i in range(12)], dev, batch_size=4)
        return [repr(x) for x in items]

    for updates, want in (([(6, 100.0)], ["(k,1.0)", "(k,5.0)", "(k,9.0)", "(k,13.0)",
                                          "(k,17.0)", "(k,21.0)"]),
                          ([], ["(k,1.0)", "(k,5.0)", "(k,9.0)"])):
        card, cpu = window_param("cuda", updates), window_param("cpu", updates)
        if card != cpu or card != want:
            raise AssertionError(f"small run window parameter {updates}: card {card}, "
                                 f"CPU {cpu}, golden {want}")
        print(f"small run window parameter {updates}: {len(card)} rows, card equals "
              f"CPU and the golden")

    class SecExtractor(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.seconds(0))

        def extract_timestamp(self, element):
            return int(element.split(" ")[0]) * 1000

    vals = [30, 60, 80, 40, 70, 55, 90, 95, 20, 85]
    lines = [f"{100 + i} ch {v}" for i, v in enumerate(vals)]

    def cep_param(dev):
        rules = RuleSet()
        thr = rules.declare("flow_min", 50.0, "f64")

        def build(text):
            text.env.from_collection([RuleUpdate("flow_min", 75.0, 5)]).broadcast(rules)
            keyed = (text.assign_timestamps_and_watermarks(SecExtractor())
                     .map(lambda s: Tuple2(s.split(" ")[1], float(s.split(" ")[2])))
                     .key_by(0))
            pattern = (Pattern.begin("a").where(lambda r: r.f1 > thr)
                       .next("b").where(lambda r: r.f1 > thr))
            return CEP.pattern(keyed, pattern).select(lambda mm: mm["b"][0].f1)

        items, _, _ = run_env(build, lines, dev, event_time=True, batch_size=2)
        return sorted(items)

    card, cpu = cep_param("cuda"), cep_param("cpu")
    if card != cpu or card != [80.0, 95.0]:
        raise AssertionError(f"small run CEP rule predicate: card {card}, CPU {cpu}")
    print(f"small run CEP rule predicate: {card}, card equals CPU and the golden")


# -- phase sharded: keyed state over shards in one process ------------------

SHARDS = 8
SHARDED_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"
# the event time the sharded and multiproc flagships span, two lengths of
# the published 5 min window, so that windows fire full; their time is
# set by the window ends to fire (one fold a shard each), not by the lines
SHARDED_SPAN_S = 600


def check_rolling_calls(box: dict):
    """Hold every launch of the rolling kernel on the path against its
    plain version on the same inputs (bitwise: the emissions and the
    plane after), keeping the inputs of the second call for
    :func:`path_kernel_case`. The plain version is not the kernel, so
    the check adds no launch. Returns the undo."""
    import torch

    from tpustream_torch.ops import rolling
    from tpustream_torch.ops import seq_rolling as S

    plain = rolling.seq_rolling_reduce

    def checked(plane, keys, vals, op="max", bad_keys=None, fresh=None):
        p0, k0, v0 = plane.clone(), keys.clone(), vals.clone()
        f0 = None if fresh is None else fresh.clone()
        if box["calls"] == 1:
            box["call"] = (p0.clone(), k0, v0, op)
        out = plain(plane, keys, vals, op, bad_keys=bad_keys, fresh=fresh)
        if plane.is_cuda:
            bad = torch.zeros(1, dtype=torch.int32, device=plane.device)
            ref = S.seq_rolling_reduce_ref(p0, k0, v0, op, bad_keys=bad,
                                           fresh=f0)
            if not (same_bits(out, ref) and same_bits(plane, p0)):
                raise AssertionError(
                    f"sharded seq_rolling_reduce call {box['calls']}: kernel "
                    f"!= plain version")
            box["err"] = max(box["err"], float(
                (out - ref).abs().nan_to_num().max()))
            box["checked"] += 1
        box["calls"] += 1
        return out

    rolling.seq_rolling_reduce = checked
    return lambda: setattr(rolling, "seq_rolling_reduce", plain)


def check_scatter_calls(box: dict):
    """The same for the fixed-order float merge on the window path."""
    import torch

    from tpustream_torch.ops import ordered_scatter as O
    from tpustream_torch.runtime import window_program as W

    plain = W.ordered_scatter_add

    def checked(plane, cells, vals):
        p0, c0, v0 = plane.clone(), cells.clone(), vals.clone()
        if box["calls"] == 1:
            box["call"] = (p0.clone(), c0, v0)
        out = plain(plane, cells, vals)
        if plane.is_cuda:
            O.ordered_scatter_add_ref(p0, c0, v0)
            if not torch.equal(plane.view(torch.int32), p0.view(torch.int32)):
                raise AssertionError(
                    f"sharded ordered_scatter_add call {box['calls']}: kernel "
                    f"!= plain version")
            box["checked"] += 1
        box["calls"] += 1
        return out

    W.ordered_scatter_add = checked
    return lambda: setattr(W, "ordered_scatter_add", plain)


def shard_order(ids: np.ndarray, batch: int, shards: int) -> np.ndarray:
    """The order a sharded per-record job emits the records of a stream
    in: step by step (``batch`` records), and within a step shard by
    shard (the key's owner ``id % shards``), each shard's in arrival
    order."""
    step = np.arange(ids.size) // batch
    return np.lexsort((np.arange(ids.size), ids % shards, step))


def exchange_overflow_oracle(ids: np.ndarray, batch: int, shards: int,
                             capacity: int) -> int:
    """The records the keyBy drops: per step, per source shard's block of
    ``batch / shards`` rows, the records past ``capacity`` of each
    destination ``id % shards``."""
    blk, total = batch // shards, 0
    for start in range(0, ids.size, batch):
        step = ids[start:start + batch]
        for b in range(0, step.size, blk):
            counts = np.bincount(step[b:b + blk] % shards, minlength=shards)
            total += int(np.maximum(counts - capacity, 0).sum())
    return total


def sharded_flagship(n_lines: int) -> float:
    """The flagship's exact configuration at full width over SHARDS
    shards: every row against the host oracle (as a multiset: rows stack
    shard by shard within a step), the loss and exchange counters 0.
    Returns its events/s."""
    t0 = time.perf_counter()
    lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3,
                                              span_s=SHARDED_SPAN_S)
    want = sorted(f"({c},{v!r})" for c, v in flagship_oracle(ts, ch, flow))
    print(f"sharded flagship: {n_lines} lines over {SHARDED_SPAN_S} s of "
          f"event time, {len(want)} oracle rows "
          f"({time.perf_counter() - t0:.1f} s)")
    rows, m, wall = run_flagship(lines, SHARDED_DEVICE, parallelism=SHARDS)
    if sorted(rows) != want:
        raise AssertionError(f"sharded flagship: {len(rows)} rows vs "
                             f"{len(want)} from the oracle")
    losses = check_losses("sharded flagship", m, (
        "late_dropped", "alert_overflow", "evicted_unfired",
        "exchange_overflow"))
    print(f"sharded flagship: parallelism={SHARDS} B={B_MAIN} K={K_MAIN}: "
          f"{len(rows)} rows equal the oracle; {losses}; window_fires="
          f"{m.window_fires}; {check_native('sharded flagship', m)}")
    print(f"sharded flagship {wall_split(m, wall)}")
    return n_lines / wall


def sharded_rolling(n_lines: int, reps: int) -> dict:
    """The chapter-2 rolling max at full width over SHARDS shards: every
    row against the oracle in the sharded emission order, the kernel
    launched on every shard's plane and each launch held against its
    plain version."""
    from tpustream_torch.jobs import chapter2_max
    from tpustream_torch.ops import seq_rolling as S

    lines = make_lines(n_lines, K_MAIN, seed=7)
    ids = interned_ids(make_hosts(n_lines, K_MAIN, seed=7))
    oracle = oracle_rows(lines)
    want = [oracle[i] for i in shard_order(ids, B_MAIN, SHARDS)]
    box = {"calls": 0, "checked": 0, "err": 0.0}
    undo = check_rolling_calls(box)
    S.reset_launches()
    try:
        items, m, wall = run_job(chapter2_max, lines, SHARDED_DEVICE,
                                 "ComputeCpuMax", batch_size=B_MAIN,
                                 key_capacity=K_MAIN, parallelism=SHARDS)
    finally:
        undo()
    launches = S.seq_rolling_reduce.launches
    got = [tuple(t.values()) for t in items]
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(f"sharded rolling: {len(got)} rows vs "
                             f"{len(want)}, first difference at row {bad}")
    if SHARDED_DEVICE == "cuda" and (launches != SHARDS * m.steps
                                     or box["checked"] != launches):
        raise AssertionError(
            f"sharded rolling: {launches} launches over {m.steps} steps of "
            f"{SHARDS} shards, {box['checked']} held against the plain "
            f"version")
    check_losses("sharded rolling", m, ("exchange_overflow",))
    print(f"sharded rolling: parallelism={SHARDS} B={B_MAIN} K={K_MAIN}: "
          f"{len(got)} rows equal the oracle in the sharded order; "
          f"seq_rolling_reduce launches={launches} over {m.steps} steps, "
          f"each bitwise equal to the plain version "
          f"(max_abs_err={box['err']})")
    print(f"sharded rolling {wall_split(m, wall)}")
    out = {"launches": launches}
    if SHARDED_DEVICE == "cuda":
        out["case"] = path_kernel_case("sharded rolling", box["call"], reps)
        out["case"]["max_abs_err"] = max(out["case"]["max_abs_err"],
                                         box["err"])
    return out


def sharded_avg(n_lines: int, reps: int, shards: int = 4,
                per_minute: int = 100_000) -> dict:
    """The chapter-2 mean under float32 over ``shards`` shards: every
    row against the float32 arrival-order oracle, bitwise and in the
    sharded order (each minute's window, shard by shard, key ids
    ascending on a shard), the merge's kernels launched on every
    shard's merge and each call held against the plain version."""
    from tpustream_torch.jobs import chapter2_avg
    from tpustream_torch.ops import ordered_scatter as O

    hosts = make_hosts(n_lines, K_MAIN, seed=7)
    lines = make_lines(n_lines, K_MAIN, seed=7)
    usage = np.array([float(l.rsplit(" ", 1)[1]) for l in lines])
    minute = np.arange(n_lines) // per_minute
    key = interned_ids(hosts)
    order = np.lexsort((key // shards, key % shards, minute))
    cell = minute[order] * (1 << 21) + key[order]
    starts = np.r_[True, cell[1:] != cell[:-1]]
    group = np.empty(n_lines, np.int64)
    group[order] = np.cumsum(starts) - 1
    sums = np.zeros(int(starts.sum()), np.float32)
    np.add.at(sums, group, usage.astype(np.float32))
    want = sums.astype(np.float64) / np.bincount(group)
    box = {"calls": 0, "checked": 0}
    undo = check_scatter_calls(box)
    O.reset_launches()
    try:
        items, m, wall = run_job(
            chapter2_avg, with_minutes(lines, per_minute), SHARDED_DEVICE,
            "ComputeCpuAvg", batch_size=B_MAIN, key_capacity=K_MAIN,
            alert_capacity=1 << 18, acc_dtype="float32", parallelism=shards)
    finally:
        undo()
    launches = O.ordered_scatter_add.launches
    got = np.array(items, dtype=np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.flatnonzero(got != want)[0]) if got.shape == want.shape
               else None)
        raise AssertionError(f"sharded avg float32: {got.size} rows vs "
                             f"{want.size}, first difference at row {bad}")
    if SHARDED_DEVICE == "cuda" and (launches != shards * m.steps
                                     or box["checked"] != launches):
        raise AssertionError(
            f"sharded avg float32: {launches} launches over {m.steps} steps "
            f"of {shards} shards, {box['checked']} held against the plain "
            f"version")
    losses = check_losses("sharded avg float32", m, (
        "late_dropped", "alert_overflow", "evicted_unfired",
        "exchange_overflow"))
    print(f"sharded avg float32: parallelism={shards} B={B_MAIN} K={K_MAIN}: "
          f"{got.size} rows equal the float32 arrival-order oracle (bitwise, "
          f"in the sharded order); {losses}; ordered_scatter_add launches="
          f"{launches}, each call bitwise equal to the plain version")
    print(f"sharded avg float32 {wall_split(m, wall)}")
    out = {"launches": launches}
    if SHARDED_DEVICE == "cuda":
        out["case"] = scatter_case("on the sharded avg float32 path's call",
                                   *box["call"], reps, 3)
    return out


def sharded_restore(n_lines: int) -> None:
    """A snapshot of the chapter-2 job written at SHARDS shards, restored
    in fresh envs at 4 shards and at 1 into the uninterrupted run's
    remaining rows (as a multiset: the order depends on the shards)."""
    from tpustream_torch.jobs import chapter2_max
    from tpustream_torch.runtime.checkpoint import load_checkpoint

    lines = make_lines(n_lines, K_MAIN, seed=5)
    with tempfile.TemporaryDirectory() as d:
        full, m, wall = run_job(
            chapter2_max, lines, SHARDED_DEVICE, "ComputeCpuMax",
            batch_size=B_MAIN, key_capacity=K_MAIN, parallelism=SHARDS,
            checkpoint_dir=d, checkpoint_interval_batches=1)
        full = [repr(t) for t in full]
        snaps = sorted(f for f in os.listdir(d) if f.startswith("ckpt-"))
        snap = next(os.path.join(d, f) for f in snaps
                    if 0 < load_checkpoint(os.path.join(d, f)).emitted
                    < len(full))
        done = load_checkpoint(snap).emitted
        from tpustream_torch import StreamExecutionEnvironment
        from tpustream_torch.config import StreamConfig
        from tpustream_torch.runtime.sources import ReplaySource

        for p in (4, 1):
            t0 = time.perf_counter()
            env = StreamExecutionEnvironment(StreamConfig(
                device=SHARDED_DEVICE, batch_size=B_MAIN,
                key_capacity=K_MAIN, parallelism=p))
            env.restore_from_checkpoint(snap)
            h = chapter2_max.build(env, env.add_source(
                ReplaySource(lines))).collect()
            env.execute("restored")
            resumed = [repr(t) for t in h.items]
            if sorted(resumed) != sorted(full[done:]):
                raise AssertionError(
                    f"sharded restore at parallelism {p}: {len(resumed)} "
                    f"rows vs {len(full) - done} of the uninterrupted run")
            print(f"sharded restore: the snapshot after {done} rows, written "
                  f"at parallelism {SHARDS}, restored at parallelism {p}: "
                  f"{len(resumed)} rows equal the uninterrupted run's rest "
                  f"({time.perf_counter() - t0:.1f} s)")


def sharded_overflow(n_lines: int, factor: float = 0.5) -> None:
    """The chapter-2 job with a small ``exchange_capacity_factor``: the
    records the keyBy drops are counted, as many as the host computes."""
    from tpustream_torch.jobs import chapter2_max
    from tpustream_torch.parallel.exchange import exchange_capacity

    lines = make_lines(n_lines, K_MAIN, seed=9)
    ids = interned_ids(make_hosts(n_lines, K_MAIN, seed=9))
    cap = exchange_capacity(B_MAIN, SHARDS, factor)
    want = exchange_overflow_oracle(ids, B_MAIN, SHARDS, cap)
    items, m, wall = run_job(chapter2_max, lines, SHARDED_DEVICE,
                             "ComputeCpuMax", batch_size=B_MAIN,
                             key_capacity=K_MAIN, parallelism=SHARDS,
                             exchange_capacity_factor=factor)
    if m.exchange_overflow != want or want == 0 \
            or len(items) != n_lines - want:
        raise AssertionError(
            f"sharded overflow: exchange_overflow={m.exchange_overflow}, "
            f"{want} by the host, {len(items)} rows of {n_lines} lines")
    print(f"sharded overflow: exchange_capacity_factor={factor} "
          f"(capacity {cap} rows a destination): exchange_overflow="
          f"{m.exchange_overflow} equals the host's count, "
          f"{len(items)} rows emitted")


def sharded_phase(flagship_lines: int, n_lines: int, reps: int) -> dict:
    """Keyed state sharded over shards in one process (``parallelism``):
    the flagship at full width, the rolling max (the rolling kernel on
    every shard), the float32 mean at 4 shards (the ordered merge on
    every shard), a snapshot restored at 4 and 1, a counted overflow."""
    out = {}
    t0 = time.perf_counter()
    out["flagship_events_per_s"] = sharded_flagship(flagship_lines)
    print(f"sharded flagship: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["rolling"] = sharded_rolling(n_lines, reps)
    print(f"sharded rolling: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["avg"] = sharded_avg(n_lines, reps)
    print(f"sharded avg: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_restore(2 * B_MAIN)
    print(f"sharded restore: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_overflow(B_MAIN)
    print(f"sharded overflow: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase multiproc: one sharded job over two processes --------------------

MULTIPROC_DEVICE = "cuda"  # a CPU rehearsal sets "cpu"
MULTIPROC_TIMEOUT_S = 400.0
MULTIPROC_SNAPSHOT_LINES = 2 * B_MAIN


def track_meshes() -> list:
    """Every mesh the sharded programs build from here on, for the
    counters of their collectives that cross processes."""
    from tpustream_torch.runtime import sharded

    made = []
    plain = sharded.make_mesh

    def tracked(*a, **k):
        mesh = plain(*a, **k)
        made.append(mesh)
        return mesh

    sharded.make_mesh = tracked
    return made


def pair_stats(m, wall: float, n_lines: int, meshes: list) -> dict:
    """One process's run: events/s (its lines over its wall), the steps,
    their median after the first, the waits on the card a step, and the
    mesh's collectives that crossed processes (calls, seconds, bytes
    this process sent)."""
    rest = m.step_times_s[1:] or m.step_times_s
    return {
        "events_per_s": n_lines / wall, "wall_s": wall, "steps": m.steps,
        "step_ms_median": statistics.median(rest) * 1e3,
        "waits_per_step": m.d2h_syncs / max(1, m.steps),
        "xproc_calls": sum(x.xproc_calls for x in meshes),
        "xproc_s": sum(x.xproc_seconds for x in meshes),
        "xproc_bytes": sum(x.xproc_bytes for x in meshes),
    }


def _host_call(call) -> list:
    import torch

    return [x.cpu() if isinstance(x, torch.Tensor) else x for x in call]


def multiproc_worker(rank: int, port: int, out_dir: str) -> int:
    """One process of the pair (``--multiproc-worker RANK PORT``): join
    the group, run the phase's four runs at its shards on ``cuda:0``,
    and leave its rows and numbers in ``out_dir``."""
    global B_MAIN, K_MAIN, MULTIPROC_DEVICE
    import torch

    with open(os.path.join(out_dir, "config.json")) as f:
        conf = json.load(f)
    B_MAIN, K_MAIN = conf["batch"], conf["keys"]
    MULTIPROC_DEVICE = dev = conf["device"]
    n_lines, snap_lines = conf["lines"], conf["snapshot_lines"]
    from tpustream_torch.jobs import chapter2_avg, chapter2_max
    from tpustream_torch.ops import ordered_scatter as O
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.parallel import distributed

    distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank)
    out = {"rank": rank}
    meshes = track_meshes()
    # (a) the flagship exact at 8 shards, 4 a process; first its first
    # 1,024 lines (one batch at full width), untimed: a fresh process pays
    # CUDA's loading of each kernel's module and the allocator's first
    # allocation of the planes in its first step, which the one process
    # of phase sharded paid in earlier phases
    lines = make_flagship_input(n_lines, K_MAIN, seed=3,
                                span_s=SHARDED_SPAN_S)[0]
    t0 = time.perf_counter()
    run_flagship(lines[:1024], dev, batch=B_MAIN, keys=K_MAIN,
                 parallelism=SHARDS)
    cold_s = time.perf_counter() - t0
    meshes.clear()
    rows, m, wall = run_flagship(lines, dev, batch=B_MAIN, keys=K_MAIN,
                                 parallelism=SHARDS)
    out["flagship"] = dict(pair_stats(m, wall, n_lines, meshes), rows=rows,
                           cold_one_batch_s=cold_s,
                           exchange_overflow=m.exchange_overflow,
                           late_dropped=m.late_dropped,
                           alert_overflow=m.alert_overflow,
                           evicted_unfired=m.evicted_unfired)
    # (b) the chapter-2 rolling max at 8 shards: every launch held
    meshes.clear()
    lines = make_lines(n_lines, K_MAIN, seed=7)
    box = {"calls": 0, "checked": 0, "err": 0.0}
    undo = check_rolling_calls(box)
    S.reset_launches()
    try:
        items, m, wall = run_job(chapter2_max, lines, dev, "ComputeCpuMax",
                                 batch_size=B_MAIN, key_capacity=K_MAIN,
                                 parallelism=SHARDS)
    finally:
        undo()
    out["rolling"] = dict(pair_stats(m, wall, n_lines, meshes),
                          rows=[list(t.values()) for t in items],
                          launches=S.seq_rolling_reduce.launches,
                          checked=box["checked"], err=box["err"],
                          exchange_overflow=m.exchange_overflow)
    if rank == 0 and "call" in box:
        torch.save(_host_call(box["call"]),
                   os.path.join(out_dir, "rolling_call.pt"))
    # (c) the chapter-2 mean under float32 at 4 shards, 2 a process
    meshes.clear()
    box = {"calls": 0, "checked": 0}
    undo = check_scatter_calls(box)
    O.reset_launches()
    try:
        items, m, wall = run_job(
            chapter2_avg, with_minutes(lines, 100_000), dev, "ComputeCpuAvg",
            batch_size=B_MAIN, key_capacity=K_MAIN, alert_capacity=1 << 18,
            acc_dtype="float32", parallelism=4)
    finally:
        undo()
    out["avg"] = dict(pair_stats(m, wall, n_lines, meshes),
                      rows=[float(x) for x in items],
                      launches=O.ordered_scatter_add.launches,
                      checked=box["checked"],
                      exchange_overflow=m.exchange_overflow)
    if rank == 0 and "call" in box:
        torch.save(_host_call(box["call"]),
                   os.path.join(out_dir, "avg_call.pt"))
    # (d) a snapshot of the chapter-2 job at 8 shards, written by the
    # pair's coordinator alone
    lines = make_lines(snap_lines, K_MAIN, seed=5)
    items, m, wall = run_job(
        chapter2_max, lines, dev, "ComputeCpuMax", batch_size=B_MAIN,
        key_capacity=K_MAIN, parallelism=SHARDS,
        checkpoint_dir=os.path.join(out_dir, "ck"),
        checkpoint_interval_batches=1)
    out["snapshot"] = {"rows": len(items), "wall_s": wall}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"multiproc worker {rank}: done", flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _check_parts(label: str, parts: list, union_len: int) -> None:
    """Each process emitted a non-empty, strict part of the rows."""
    if not all(0 < len(p) < union_len for p in parts):
        raise AssertionError(f"multiproc {label}: the processes emitted "
                             f"{[len(p) for p in parts]} of {union_len} rows")


def multiproc_phase(n_lines: int, reps: int, sharded_eps=None) -> dict:
    """One sharded job over two processes (``parallel/distributed.py``):
    two workers of this script (``--multiproc-worker``) join a ``gloo``
    group over ``tcp://127.0.0.1`` and share ``cuda:0``, 4 of the 8
    shards each (2 of 4 for the mean). The union of both processes' rows
    against the host oracle for the flagship exact, the chapter-2
    rolling max (every kernel launch held against its plain version in
    the workers) and the float32 mean (every merge call likewise), each
    process emitting a non-empty, strict part; the pair's snapshot
    restored here at 4 shards and at 1. Both kernels and the native
    parser are built here first, so the workers only load them."""
    import torch

    from tpustream_torch import native
    from tpustream_torch.jobs import chapter2_max
    from tpustream_torch.runtime.checkpoint import load_checkpoint

    native.available()
    if MULTIPROC_DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pair_")
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"batch": B_MAIN, "keys": K_MAIN, "device": MULTIPROC_DEVICE,
                   "lines": n_lines,
                   "snapshot_lines": MULTIPROC_SNAPSHOT_LINES}, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multiproc-worker",
         str(r), str(port), "--multiproc-dir", out_dir],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in (0, 1)]
    try:
        # the oracles, while the pair runs
        lines, ts, ch, flow = make_flagship_input(n_lines, K_MAIN, seed=3,
                                                  span_s=SHARDED_SPAN_S)
        want_flagship = sorted(f"({c},{v!r})"
                               for c, v in flagship_oracle(ts, ch, flow))
        roll_lines = make_lines(n_lines, K_MAIN, seed=7)
        want_rolling = sorted(oracle_rows(roll_lines))
        hosts = make_hosts(n_lines, K_MAIN, seed=7)
        usage = np.array([float(l.rsplit(" ", 1)[1]) for l in roll_lines])
        key, minute = interned_ids(hosts), np.arange(n_lines) // 100_000
        order = np.lexsort((key // 4, key % 4, minute))
        cell = minute[order] * (1 << 21) + key[order]
        starts = np.r_[True, cell[1:] != cell[:-1]]
        group = np.empty(n_lines, np.int64)
        group[order] = np.cumsum(starts) - 1
        sums = np.zeros(int(starts.sum()), np.float32)
        np.add.at(sums, group, usage.astype(np.float32))
        want_avg = np.sort(sums.astype(np.float64) / np.bincount(group))
        snap_lines = make_lines(MULTIPROC_SNAPSHOT_LINES, K_MAIN, seed=5)
        want_snap = oracle_rows(snap_lines)
        deadline = t0 + MULTIPROC_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    pair_wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r in (0, 1):
            with open(os.path.join(out_dir, f"log{r}.txt")) as f:
                print(f"multiproc worker {r} (rc {rcs[r]}):\n"
                      + "".join(f.readlines()[-40:]))
        raise AssertionError(f"multiproc: worker exit codes {rcs}")
    res = []
    for r in (0, 1):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    card = card_line() if MULTIPROC_DEVICE == "cuda" else "cpu"
    print(f"multiproc: the pair ran in {pair_wall:.1f} s ({card})")

    def report(label, key_):
        for r, x in enumerate(res):
            st = x[key_]
            cold = st.get("cold_one_batch_s")
            if cold is not None:
                print(f"multiproc {label} process {r}: the untimed first "
                      f"run of its first 1,024 lines (a cold process) took "
                      f"{cold} s")
            print(f"multiproc {label} process {r}: events_per_s="
                  f"{st['events_per_s']} wall_s={st['wall_s']} steps="
                  f"{st['steps']} step_ms_median={st['step_ms_median']} "
                  f"waits_per_step={st['waits_per_step']} cross_process_"
                  f"collectives={st['xproc_calls']} cross_process_s="
                  f"{st['xproc_s']} cross_process_bytes={st['xproc_bytes']} "
                  f"({card})")
        pair = n_lines / max(x[key_]["wall_s"] for x in res)
        return pair

    # (a) the flagship
    parts = [x["flagship"]["rows"] for x in res]
    union = sorted(parts[0] + parts[1])
    if union != want_flagship:
        raise AssertionError(f"multiproc flagship: {len(union)} rows vs "
                             f"{len(want_flagship)} from the oracle")
    _check_parts("flagship", parts, len(union))
    for x in res:
        # check_losses reads Metrics' attributes
        check_losses("multiproc flagship", types.SimpleNamespace(**x["flagship"]), (
            "late_dropped", "alert_overflow", "evicted_unfired",
            "exchange_overflow"))
    pair_eps = report("flagship", "flagship")
    print(f"multiproc flagship: parallelism={SHARDS} over 2 processes, "
          f"B={B_MAIN} K={K_MAIN}: {len(union)} rows equal the oracle "
          f"(parts {[len(p) for p in parts]}); exchange_overflow=0; "
          f"pair events_per_s={pair_eps} (lines over the slower process's "
          f"wall) against one process's 8 shards in phase sharded "
          f"events_per_s={sharded_eps} ({card})")
    # (b) the rolling max
    parts = [[tuple(r) for r in x["rolling"]["rows"]] for x in res]
    union = sorted(parts[0] + parts[1])
    if union != want_rolling:
        raise AssertionError(f"multiproc rolling: {len(union)} rows vs "
                             f"{len(want_rolling)} from the oracle")
    _check_parts("rolling", parts, len(union))
    launches = 0
    for r, x in enumerate(res):
        st = x["rolling"]
        if MULTIPROC_DEVICE == "cuda" and (
                st["launches"] != (SHARDS // 2) * st["steps"]
                or st["checked"] != st["launches"]):
            raise AssertionError(
                f"multiproc rolling process {r}: {st['launches']} launches "
                f"over {st['steps']} steps of {SHARDS // 2} local shards, "
                f"{st['checked']} held against the plain version")
        if st["exchange_overflow"]:
            raise AssertionError("multiproc rolling: exchange_overflow")
        launches += st["launches"]
    report("rolling", "rolling")
    print(f"multiproc rolling: {len(union)} rows equal the oracle (parts "
          f"{[len(p) for p in parts]}); seq_rolling_reduce launches "
          f"{[x['rolling']['launches'] for x in res]}, each bitwise equal "
          f"to the plain version (max_abs_err="
          f"{max(x['rolling']['err'] for x in res)})")
    phase = {"rolling": {"launches": launches}}
    # (c) the float32 mean
    parts = [x["avg"]["rows"] for x in res]
    union = np.sort(np.array(parts[0] + parts[1], dtype=np.float64))
    if union.shape != want_avg.shape or union.tobytes() != want_avg.tobytes():
        raise AssertionError(f"multiproc avg float32: {union.size} rows vs "
                             f"{want_avg.size} from the oracle (bitwise)")
    _check_parts("avg float32", parts, union.size)
    launches = 0
    for r, x in enumerate(res):
        st = x["avg"]
        if MULTIPROC_DEVICE == "cuda" and (
                st["launches"] != 2 * st["steps"]
                or st["checked"] != st["launches"]):
            raise AssertionError(
                f"multiproc avg float32 process {r}: {st['launches']} "
                f"launches over {st['steps']} steps of 2 local shards, "
                f"{st['checked']} held against the plain version")
        launches += st["launches"]
    report("avg float32", "avg")
    print(f"multiproc avg float32: parallelism=4 over 2 processes: "
          f"{union.size} rows equal the float32 oracle (bitwise, as a "
          f"multiset); ordered_scatter_add launches "
          f"{[x['avg']['launches'] for x in res]}, each bitwise equal to "
          f"the plain version")
    phase["avg"] = {"launches": launches}
    if MULTIPROC_DEVICE == "cuda":
        call = [x.cuda() if isinstance(x, torch.Tensor) else x for x in
                torch.load(os.path.join(out_dir, "rolling_call.pt"))]
        phase["rolling"]["case"] = path_kernel_case("multiproc rolling",
                                                    call, reps)
        call = [x.cuda() for x in
                torch.load(os.path.join(out_dir, "avg_call.pt"))]
        phase["avg"]["case"] = scatter_case(
            "on the multiproc avg float32 path's call", *call, reps, 3)
    # (d) the pair's snapshot, restored here alone at 4 shards and at 1
    ckdir = os.path.join(out_dir, "ck")
    snaps = sorted(f for f in os.listdir(ckdir) if f.startswith("ckpt-"))
    total = sum(x["snapshot"]["rows"] for x in res)
    snap = next(os.path.join(ckdir, f) for f in snaps
                if 0 < load_checkpoint(os.path.join(ckdir, f)).emitted < total)
    ck = load_checkpoint(snap)
    if ck.parallelism != SHARDS or ck.emitted != ck.source_pos:
        raise AssertionError(
            f"multiproc snapshot: parallelism {ck.parallelism}, emitted "
            f"{ck.emitted} of {ck.source_pos} consumed lines (one row a line)")
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource

    for p in (4, 1):
        t1 = time.perf_counter()
        env = StreamExecutionEnvironment(StreamConfig(
            device=MULTIPROC_DEVICE, batch_size=B_MAIN, key_capacity=K_MAIN,
            parallelism=p))
        env.restore_from_checkpoint(snap)
        h = chapter2_max.build(env, env.add_source(
            ReplaySource(snap_lines))).collect()
        env.execute("restored")
        resumed = sorted(tuple(t.values()) for t in h.items)
        if not resumed or resumed != sorted(want_snap[ck.source_pos:]):
            raise AssertionError(
                f"multiproc restore at parallelism {p}: {len(resumed)} rows "
                f"vs {len(want_snap) - ck.source_pos} of the oracle's rest")
        print(f"multiproc restore: the pair's snapshot after {ck.emitted} "
              f"rows (parallelism {SHARDS}, written by the coordinator "
              f"alone) restored here at parallelism {p}: {len(resumed)} "
              f"rows equal the uninterrupted run's rest "
              f"({time.perf_counter() - t1:.1f} s)")
    return phase



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="kernel,job,flagship,chain,ch1,avg,median,session,count,"
                            "cep,rules,fleet,obs,pipeline,recovery,analysis,"
                            "acc32,sharded,multiproc,small")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--lines", type=int, default=786_432)
    ap.add_argument("--flagship-lines", type=int, default=786_432,
                    help="input of the flagship and chain phases")
    ap.add_argument("--new-lines", type=int, default=524_288,
                    help="input of the ch1, avg and median phases")
    ap.add_argument("--window-lines", type=int, default=786_432,
                    help="input of the session and count phases")
    ap.add_argument("--cep-lines", type=int, default=786_432,
                    help="input of the cep phase's two runs and the rules phase")
    ap.add_argument("--obs-lines", type=int, default=262_144,
                    help="input of the obs phase's runs and of the acc32 "
                         "phase's ledger-cost pairs")
    ap.add_argument("--pipeline-lines", type=int, default=327_680,
                    help="input of the pipeline phase's chapter-2, flagship "
                         "and chapter-4 runs")
    ap.add_argument("--sharded-lines", type=int, default=262_144,
                    help="input of the sharded phase's flagship, rolling and "
                         "mean runs")
    ap.add_argument("--multiproc-lines", type=int, default=262_144,
                    help="input of the multiproc phase's flagship, rolling "
                         "and mean runs")
    ap.add_argument("--multiproc-worker", nargs=2, type=int, default=None,
                    metavar=("RANK", "PORT"),
                    help="run as one process of the multiproc phase's pair")
    ap.add_argument("--multiproc-dir", default=None,
                    help="the multiproc phase's working directory (workers)")
    ap.add_argument("--dead-letter-lines", type=int, default=50_000,
                    help="chapter-1 input of the pipeline phase's dead "
                         "letters (one line in 10,000 malformed)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if args.multiproc_worker is not None:
        rank, port = args.multiproc_worker
        return multiproc_worker(rank, port, args.multiproc_dir)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import tpustream_torch  # noqa: F401 -- fails when run outside the repo

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_kernels()
    t_all = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    cases = timed("kernel", kernel_phase, args.reps) if "kernel" in phases else {}
    launches = timed("job", job_phase, args.lines) if "job" in phases else {}
    if "flagship" in phases:
        timed("flagship", flagship_phase, args.flagship_lines)
    chain_launches = (timed("chain", chain_phase, args.flagship_lines)
                      if "chain" in phases else {})
    if "ch1" in phases:
        timed("ch1", ch1_phase, args.new_lines)
    if "avg" in phases:
        timed("avg", avg_phase, args.new_lines)
    if "median" in phases:
        timed("median", median_phase, args.new_lines)
    if "session" in phases:
        timed("session", session_phase, args.window_lines)
    if "count" in phases:
        timed("count", count_phase, args.window_lines)
    if "cep" in phases:
        timed("cep", cep_phase, args.cep_lines, args.cep_lines)
    rules = (timed("rules", rules_phase, args.cep_lines, args.reps)
             if "rules" in phases else {})
    fleet = timed("fleet", fleet_phase, args.reps) if "fleet" in phases else {}
    if "obs" in phases:
        timed("obs", obs_phase, args.obs_lines)
    pipeline = (timed("pipeline", pipeline_phase, args.pipeline_lines,
                      args.pipeline_lines, args.dead_letter_lines, args.reps)
                if "pipeline" in phases else {})
    recovery = (timed("recovery", recovery_phase, args.lines,
                      args.flagship_lines)
                if "recovery" in phases else {})
    analysis = (timed("analysis", analysis_phase, args.obs_lines)
                if "analysis" in phases else {})
    acc32 = (timed("acc32", acc32_phase, args.flagship_lines,
                   args.window_lines, args.obs_lines, args.reps)
             if "acc32" in phases else {})
    sharded = (timed("sharded", sharded_phase, args.sharded_lines,
                     args.sharded_lines, args.reps)
               if "sharded" in phases else {})
    multiproc = (timed("multiproc", multiproc_phase, args.multiproc_lines,
                       args.reps, sharded.get("flagship_events_per_s"))
                 if "multiproc" in phases else {})
    if "small" in phases:
        timed("small", small_phase)
        small_windows()
        small_chains()
        small_cep_rules()
        small_subnormal()
    print(f"phases: {time.perf_counter() - t_all:.1f} s")
    # one entry a main path and dtype instantiation: float64 on the
    # chapter-2 job's and int64 on the chain's (the kernel phase's
    # uniform case at their shape), float64 on the rules phase's rolling
    # max (its rule-reading filter ahead of the max) and on the keyed
    # fleet's tenant-namespaced max (each path's own second call)
    entries = []
    for path, dtype, op, path_launches, case in (
            ("job", "float64", "max", launches.get("seq_rolling_reduce"),
             cases.get(("float64", "max", "uniform"))),
            ("chain", "int64", "max", chain_launches.get("int64"),
             cases.get(("int64", "max", "uniform"))),
            ("rules", "float64", "max", rules.get("launches"), rules.get("case")),
            ("fleet", "float64", "max", fleet.get("launches"), fleet.get("case")),
            ("pipeline", "float64", "max", pipeline.get("launches"),
             pipeline.get("case")),
            ("recovery", "float64", "max", recovery.get("launches"),
             recovery.get("case")),
            ("analysis", "float64", "max", analysis.get("launches"),
             analysis.get("case")),
            ("acc32_rolling", "float64", "sum",
             acc32.get("rolling", {}).get("launches"),
             acc32.get("rolling", {}).get("case")),
            ("sharded_rolling", "float64", "max",
             sharded.get("rolling", {}).get("launches"),
             sharded.get("rolling", {}).get("case")),
            ("multiproc_rolling", "float64", "max",
             multiproc.get("rolling", {}).get("launches"),
             multiproc.get("rolling", {}).get("case"))):
        if case is None:
            continue
        entries.append({
            "name": "seq_rolling_reduce",
            "path": path,
            "dtype": dtype,
            "route": "cuda",
            "source": "tpustream_torch/kernels/seq_rolling.cu",
            "replaces": "tpustream/ops/pallas_rolling.py:103",
            "launches": path_launches,
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": "bytes",
            # the fold is a parallel scan, not a chain of adds
            "chain_bound_ms": None,
            "library_ms": None,
            "device_launches_per_call": case.get("device_launches_per_call"),
        })
    # the fixed-order float merge: one entry a path it launches on, the
    # chapter-2 mean under float32, under int32 and under float32 with a
    # hot host (each path's own second call)
    for path, got in (("acc32_avg_float32", acc32.get("avg float32")),
                      ("acc32_avg_int32", acc32.get("avg int32")),
                      ("acc32_hot_host", acc32.get("hot host")),
                      ("sharded_avg_float32", sharded.get("avg")),
                      ("multiproc_avg_float32", multiproc.get("avg"))):
        got = got or {}
        case = got.get("case")
        if case is None:
            continue
        entries.append({
            "name": "ordered_scatter_add",
            "path": path,
            "dtype": "float32",
            "route": "cuda",
            "source": "tpustream_torch/kernels/ordered_scatter.cu",
            "replaces": OSC_REPLACES,
            "launches": got["launches"],
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "bytes_bound_ms": case["bytes_bound_ms"],
            "chain_bound_ms": case["chain_bound_ms"],
            "library_ms": case["library_ms"],
            "device_launches_per_call": case["device_launches_per_call"],
        })
    if entries:
        print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
