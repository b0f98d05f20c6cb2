"""The traced run's device reading: ``torch.profiler`` over the timed
window, host stages named by ``record_function`` ranges that this file
wraps around the port's stage methods (no span is added inside the
port), and the reduction to busy seconds, device time by operation, and
idle time by the host stage that ran meanwhile."""

from __future__ import annotations

import functools
import importlib
import sys

import numpy as np

PREFIX = "streambench."
# range name: (module, class, method) of the port's host stages; a
# missing method leaves its stage unnamed ("other") and says so
STAGES = {
    "parse": ("tpustream_torch.runtime.executor", "HostStage", "process_raw"),
    "pack": ("tpustream_torch.runtime.executor", "Runner", "_pack_batch"),
    "step": ("tpustream_torch.runtime.step", "BaseProgram", "run_step"),
    "fetch": ("tpustream_torch.runtime.executor", "Runner", "_finish_group"),
    "emit": ("tpustream_torch.runtime.executor", "Runner", "_dispatch"),
}
OPEN, CLOSE = PREFIX + "window_open", PREFIX + "window_close"
IDLE_BIN_NS = 20_000  # resolution of the idle time's attribution
TOP = 10


class Tracer:
    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self._undo = []
        self.busy_s = self.window_s = None
        self.kernels = {}     # device op name -> [calls, seconds]
        self.idle_by_stage = {}

    def range(self, name: str):
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    def wrap_stages(self) -> None:
        for label, (mod, cls_name, meth) in STAGES.items():
            cls = getattr(importlib.import_module(mod), cls_name, None)
            plain = getattr(cls, meth, None) if cls is not None else None
            if plain is None:
                print(f"trace: no {mod}.{cls_name}.{meth}; stage {label} "
                      f"is read as other", file=sys.stderr)
                continue
            setattr(cls, meth, self._wrapped(plain, label))
            self._undo.append((cls, meth, plain))

    def _wrapped(self, plain, label: str):
        @functools.wraps(plain)
        def stage(*a, **k):
            with self.range(label):
                return plain(*a, **k)
        return stage

    def unwrap_stages(self) -> None:
        for cls, meth, plain in reversed(self._undo):
            setattr(cls, meth, plain)
        self._undo = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with self.range("window_open"):
            pass

    def stop(self) -> None:
        with self.range("window_close"):
            pass
        self.prof.stop()

    def reduce(self) -> None:
        """Busy seconds (the union of device intervals within the
        window), device seconds by operation, idle seconds by stage."""
        from torch.autograd import DeviceType

        dev, ranges, marks = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            name, t0 = e.name(), e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith(PREFIX) or e.is_user_annotation():
                    continue  # a host range mirrored on the device's timeline
                dev.append((t0, t1))
                k = self.kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += (t1 - t0) / 1e9
            elif name in (OPEN, CLOSE):
                marks[name] = t0
            elif name.startswith(PREFIX):
                ranges.append((t0, t1, name[len(PREFIX):]))
        self.prof = None
        w0, w1 = marks[OPEN], marks[CLOSE]
        self.window_s = (w1 - w0) / 1e9
        busy = np.zeros(max(1, -(-(w1 - w0) // IDLE_BIN_NS)), bool)
        total = 0
        end = w0
        for t0, t1 in sorted(dev):
            t0, t1 = max(t0, end, w0), min(t1, w1)
            if t1 > t0:
                total += t1 - t0
                end = t1
                busy[(t0 - w0) // IDLE_BIN_NS:-(-(t1 - w0) // IDLE_BIN_NS)] = True
        self.busy_s = total / 1e9
        # each bin named by the innermost stage range over it: ranges in
        # order of start, outer before inner, so the inner writes last
        names = ["other"] + sorted({r[2] for r in ranges})
        stage = np.zeros(busy.size, np.int16)
        for t0, t1, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            a = max(0, (t0 - w0) // IDLE_BIN_NS)
            b = min(busy.size, -(-(t1 - w0) // IDLE_BIN_NS))
            if b > a:
                stage[a:b] = names.index(name)
        idle = np.bincount(stage[~busy], minlength=len(names)) * IDLE_BIN_NS / 1e9
        self.idle_by_stage = {n: float(s) for n, s in zip(names, idle) if s > 0}

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle_by_stage.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def kernel(self, fragment: str):
        """``(calls, device seconds)`` of the device ops whose name holds
        ``fragment``."""
        calls = secs = 0
        for name, (c, s) in self.kernels.items():
            if fragment in name:
                calls, secs = calls + c, secs + s
        return calls, secs
