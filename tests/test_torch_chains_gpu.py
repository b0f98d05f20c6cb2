"""On the card: the int64 instantiation of the keyed-reduce kernel
against its plain version (bitwise, wrap-around included), and integer
rolling jobs and chained keyed stages on the card against the same jobs
on the CPU. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chains_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch
import tpustream_torch.api.windows as windows
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime.sources import ReplaySource

pytestmark = pytest.mark.gpu

I64_MAX = 2**63 - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_and_plain(dev, plane, keys, vals, op):
    pk, pr = plane.clone(), plane.clone()
    bk = torch.zeros(1, dtype=torch.int32, device=dev)
    br = torch.zeros(1, dtype=torch.int32, device=dev)
    before = S.seq_rolling_reduce.launches_by_dtype.get("int64", 0)
    ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bk)
    er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=br)
    torch.cuda.synchronize()
    assert S.seq_rolling_reduce.launches_by_dtype["int64"] == before + 1
    return (ek, pk, int(bk[0])), (er, pr, int(br[0]))


KEYS = {
    "uniform": lambda rng, B, K: rng.integers(-1, K, B),
    "skewed": lambda rng, B, K: np.where(rng.random(B) < 0.9, rng.integers(0, 64, B),
                                         rng.integers(0, K, B)),
    "one key": lambda rng, B, K: np.full(B, K - 1),
    "out of range": lambda rng, B, K: rng.integers(-1, K + 8, B),
}


@pytest.mark.parametrize("scale", ["small", "near-max"])
@pytest.mark.parametrize("dist", sorted(KEYS))
@pytest.mark.parametrize("op", ["max", "min", "sum"])
def test_int64_kernel_matches_plain(dev, op, dist, scale):
    rng = np.random.default_rng(len(dist) + len(op))
    B, K = 5000, 1 << 12
    keys = torch.from_numpy(KEYS[dist](rng, B, K).astype(np.int32)).to(dev)
    if scale == "small":
        v = rng.integers(-10**6, 10**6, B)
    else:
        v = rng.integers(I64_MAX - 2**40, I64_MAX, B, dtype=np.int64)
        v[::3] = -v[::3]
    vals = torch.from_numpy(v).to(dev)
    plane = torch.from_numpy(rng.integers(-100, 100, K)).to(dev)
    plane[::2] = S.IDENTITY[torch.int64][op]
    (ek, pk, bk), (er, pr, br) = _kernel_and_plain(dev, plane, keys, vals, op)
    assert torch.equal(ek, er) and torch.equal(pk, pr) and bk == br


def test_int64_sum_is_deterministic_and_wraps(dev):
    B, K = 131072, 1 << 20
    keys = torch.full((B,), 7, dtype=torch.int32, device=dev)
    vals = torch.full((B,), I64_MAX // 1000, dtype=torch.int64, device=dev)
    runs = []
    for _ in range(2):
        plane = torch.zeros(K, dtype=torch.int64, device=dev)
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        runs.append((S.seq_rolling_reduce(plane, keys, vals, "sum", bad_keys=bad), plane))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    want = (np.arange(1, B + 1, dtype=np.uint64) * np.uint64(I64_MAX // 1000)).view(np.int64)
    assert np.array_equal(runs[0][0].cpu().numpy(), want)
    assert int(runs[0][0].min()) < 0  # it wrapped


def _run(device, build, lines, event_time=False, **cfg):
    T = tpustream_torch
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, **cfg))
    if event_time:
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    h = build(env.add_source(ReplaySource(lines))).collect()
    env.execute("card-vs-cpu")
    return [repr(t) for t in h.items], env.metrics.summary()


def _parse3(line):
    items = line.split(" ")
    return tpustream_torch.Tuple3(items[1], items[2], int(items[3]))


def _add3(p, q):
    return tpustream_torch.Tuple3(p.f0, p.f1, p.f2 + q.f2)


class _Ts(tpustream_torch.BoundedOutOfOrdernessTimestampExtractor):
    def __init__(self):
        super().__init__(tpustream_torch.Time.milliseconds(1000))

    def extract_timestamp(self, value):
        return int(value.split(" ")[0])


def _stage1(text):
    return (text.assign_timestamps_and_watermarks(_Ts()).map(_parse3).key_by(0)
            .time_window(tpustream_torch.Time.seconds(10)).reduce(_add3))


CHAIN_LINES = [f"{1000 + 700 * i} h{i % 5} c{i % 3} {(i * 37) % 101}" for i in range(400)]

CHAINS = {
    "window then int rolling max": lambda t: _stage1(t).key_by(1).max(2),
    "window then int rolling sum": lambda t: _stage1(t).key_by(1).sum(2),
    "window then event-time window": lambda t: (
        _stage1(t).key_by(1).time_window(tpustream_torch.Time.seconds(30)).reduce(_add3)),
    "window then processing-time window": lambda t: (
        _stage1(t).key_by(1).window(windows.TumblingProcessingTimeWindows.of(
            tpustream_torch.Time.minutes(5))).reduce(_add3)),
    "window then computed key": lambda t: (
        _stage1(t).key_by(lambda r: r.f1 + "!").max(2)),
    "int rolling then event-time window": lambda t: (
        t.assign_timestamps_and_watermarks(_Ts()).map(_parse3).key_by(0).max(2)
        .key_by(1).time_window(tpustream_torch.Time.seconds(8)).reduce(_add3)),
}


@pytest.mark.parametrize("batch_size", [1, 64])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_on_card_equals_cpu(dev, name, batch_size):
    lines = CHAIN_LINES[:120] if batch_size == 1 else CHAIN_LINES
    kw = dict(event_time=True, batch_size=batch_size, key_capacity=16)
    S.reset_launches()
    card, m = _run("cuda", CHAINS[name], lines, **kw)
    launches = S.seq_rolling_reduce.launches_by_dtype.get("int64", 0)
    cpu, _ = _run("cpu", CHAINS[name], lines, **kw)
    assert card == cpu and card
    if "int rolling" in name or "computed" in name:
        assert launches > 0
    assert m["late_dropped"] == 0


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_int_rolling_job_on_card_equals_cpu(dev, kind):
    rng = np.random.default_rng(3)
    lines = [f"{i} h{h} {v}" for i, (h, v) in enumerate(
        zip(rng.integers(0, 50, 3000).tolist(),
            rng.integers(I64_MAX - 2**50, I64_MAX, 3000).tolist()))]

    def build(text):
        return getattr(text.map(lambda l: tpustream_torch.Tuple2(
            l.split(" ")[1], int(l.split(" ")[2]))).key_by(0), kind)(1)

    S.reset_launches()
    card, m = _run("cuda", build, lines, batch_size=256)
    assert S.seq_rolling_reduce.launches_by_dtype["int64"] == m["steps"]
    cpu, _ = _run("cpu", build, lines, batch_size=256)
    assert card == cpu
