"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout, holds each
against its plain PyTorch version on the card, drives the chapter-2
rolling-max job through ``StreamExecutionEnvironment.execute`` at
1M keys, and checks every emitted row against a host oracle. Prints the
card's name and power limit, one line per kernel case (with a per-launch
device-time split from ``torch.profiler`` for the main case, a cold-L2
time and ``torch.sort`` as a reference point), a ``kernels`` JSON line
and, last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when there is no CUDA device, when the package is not beside
this script, or when any phase fails.

Options (the default runs everything): ``--phases kernel,job``,
``--reps N`` (timed repeats per kernel case), ``--lines N`` (job input).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import time

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
                             stored, torch.full_like(stored, S.IDENTITY[op]))
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
    S.seq_rolling_reduce.launches = 0
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernel,job")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--lines", type=int, default=1_000_000)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

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
    cases = kernel_phase(args.reps) if "kernel" in phases else {}
    launches = job_phase(args.lines) if "job" in phases else {}
    main_case = cases.get(("float64", "max", "uniform"))
    if main_case is not None:
        print(json.dumps({"kernels": [{
            "name": "seq_rolling_reduce",
            "route": "cuda",
            "source": "tpustream_torch/kernels/seq_rolling.cu",
            "replaces": "tpustream/ops/pallas_rolling.py:103",
            "launches": launches.get("seq_rolling_reduce"),
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "device_launches_per_call": main_case["device_launches_per_call"],
        }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
