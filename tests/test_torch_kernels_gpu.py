"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from tpustream_torch.ops import seq_rolling as S

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a) & torch.isnan(b)
    eq = (a == b) & (torch.signbit(a) == torch.signbit(b))
    return bool((eq | nan).all())


def _counter(dev):
    return torch.zeros(1, dtype=torch.int32, device=dev)


def _kernel_and_plain(dev, plane, keys, vals, op):
    """(emissions, plane after, out-of-range count) from the kernel and
    from the plain version, on copies of ``plane``."""
    pk, pr = plane.clone(), plane.clone()
    bk, br = _counter(dev), _counter(dev)
    before = S.seq_rolling_reduce.launches
    ek = S.seq_rolling_reduce(pk, keys, vals, op, bad_keys=bk)
    er = S.seq_rolling_reduce_ref(pr, keys, vals, op, bad_keys=br)
    torch.cuda.synchronize()
    assert S.seq_rolling_reduce.launches == before + 1
    return (ek, pk, int(bk[0])), (er, pr, int(br[0]))


def _sum_bound(plane, keys, vals):
    """Per row, 2*(m-1)*eps*sum|v| over the m terms of the key's running
    sum (the stored value and the key's rows so far): two summation
    orders of the same terms differ by at most that."""
    seen = {}
    m = np.empty(keys.numel(), np.int64)
    for i, k in enumerate(keys.tolist()):
        seen[k] = seen.get(k, 1) + 1
        m[i] = seen[k]
    abs_run = S.seq_rolling_reduce_ref(
        plane.abs().double(), keys, vals.abs().double(), "sum")
    m = torch.from_numpy(m).to(abs_run.device)
    return 2 * (m - 1).double() * torch.finfo(vals.dtype).eps * abs_run


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["max", "min", "sum"])
def test_seq_rolling_kernel_matches_plain(dev, op, dtype):
    # quarter-integers: every summation order is exact, so sum too must
    # match bit for bit; -1 keys are padding rows; B is not a multiple
    # of the kernel's 1024-row tile
    rng = np.random.default_rng(3)
    B, K = 4099, 1 << 12
    keys = torch.from_numpy(rng.integers(-1, K, B).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-400, 400, B) / 4).to(dev, dtype)
    plane = torch.from_numpy(rng.integers(-400, 400, K) / 4).to(dev, dtype)
    plane[::3] = S.IDENTITY[op]
    (ek, pk, _), (er, pr, _) = _kernel_and_plain(dev, plane, keys, vals, op)
    assert _same_bits(ek, er) and _same_bits(pk, pr)


# (name, B, K, key maker): tile and pass boundaries of the sort and scan
EDGES = [
    ("B=1", 1, 10, lambda rng, B, K: np.array([3])),
    ("B=tile+1", 1025, 300, lambda rng, B, K: rng.integers(-1, K, B)),
    ("B=3 tiles-1", 3071, 5000, lambda rng, B, K: rng.integers(-1, K, B)),
    ("all padding", 5000, 64, lambda rng, B, K: np.full(B, -1)),
    ("every key K-1", 7000, 100, lambda rng, B, K: np.full(B, K - 1)),
    ("K not a power of two", 4500, 1003, lambda rng, B, K: rng.integers(-2, K, B)),
    ("K=256 (2 passes)", 3000, 256, lambda rng, B, K: rng.integers(0, K, B)),
    ("K > 2^20", 9000, (1 << 21) + 5, lambda rng, B, K: rng.integers(-1, K, B)),
    ("K=2^24 (4 passes)", 4096, 1 << 24, lambda rng, B, K: rng.integers(0, K, B)),
    ("half one key", 8192, 1 << 20, lambda rng, B, K: np.where(
        rng.random(B) < 0.5, 77, rng.integers(0, K, B))),
]


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_seq_rolling_kernel_edges(dev, edge, op):
    _, B, K, make = edge
    rng = np.random.default_rng(B + K)
    keys = torch.from_numpy(make(rng, B, K).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-400, 400, B) / 4).to(dev)
    plane = torch.from_numpy(rng.integers(-400, 400, K) / 4).to(dev)
    plane[::2] = S.IDENTITY[op]
    (ek, pk, _), (er, pr, _) = _kernel_and_plain(dev, plane, keys, vals, op)
    assert _same_bits(ek, er) and _same_bits(pk, pr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seq_rolling_kernel_one_key_whole_batch(dev, dtype):
    # the main batch size on one key: one segment over 128 tiles
    rng = np.random.default_rng(9)
    B, K = 131072, 1 << 20
    keys = torch.full((B,), 12345, dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.integers(-400, 400, B) / 4).to(dev, dtype)
    plane = torch.full((K,), S.IDENTITY["max"], dtype=dtype, device=dev)
    (ek, pk, _), (er, pr, _) = _kernel_and_plain(dev, plane, keys, vals, "max")
    assert _same_bits(ek, er) and _same_bits(pk, pr)
    assert _same_bits(ek, torch.cummax(vals, 0).values)


def test_seq_rolling_kernel_sum_is_deterministic(dev):
    # arbitrary values and a hot key: the fixed tree order gives the same
    # bits on every launch
    rng = np.random.default_rng(10)
    B, K = 131072, 1 << 20
    keys = np.where(rng.random(B) < 0.5, 5, rng.integers(0, K, B))
    keys = torch.from_numpy(keys.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.standard_normal(B) * 1e3).to(dev, torch.float32)
    plane = torch.from_numpy(rng.standard_normal(K)).to(dev, torch.float32)
    outs = []
    for _ in range(3):
        p = plane.clone()
        outs.append((S.seq_rolling_reduce(p, keys, vals, "sum",
                                          bad_keys=_counter(dev)), p))
    torch.cuda.synchronize()
    for e, p in outs[1:]:
        assert torch.equal(e.view(torch.int32), outs[0][0].view(torch.int32))
        assert torch.equal(p.view(torch.int32), outs[0][1].view(torch.int32))


def test_seq_rolling_kernel_sum_is_the_sequential_fold(dev):
    # the kernel adds each key's rows in a tree order, not in arrival
    # order: it agrees with the sequential fold within 2*(m-1)*eps*sum|v|
    # per row, m the key's terms so far
    rng = np.random.default_rng(4)
    B, K = 5000, 37
    keys = rng.integers(0, K, B).astype(np.int32)
    vals = rng.standard_normal(B).astype(np.float32)
    p = np.full(K, -0.0, np.float32)
    want = np.empty_like(vals)
    for i, (k, v) in enumerate(zip(keys, vals)):
        p[k] = np.float32(p[k] + v)
        want[i] = p[k]
    plane = torch.full((K,), -0.0, dtype=torch.float32, device=dev)
    tkeys, tvals = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
    got = S.seq_rolling_reduce(plane, tkeys, tvals, "sum", bad_keys=_counter(dev))
    bound = _sum_bound(torch.full_like(plane, -0.0), tkeys, tvals).cpu().numpy()
    assert np.all(np.abs(got.cpu().numpy().astype(np.float64) - want) <= bound)
    last = {int(k): i for i, k in enumerate(keys)}
    for k, i in last.items():
        assert abs(float(plane[k]) - float(p[k])) <= bound[i]


def test_cuda_tensors_never_take_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(S, "seq_rolling_reduce_ref", refuse)
    plane = torch.full((8,), -float("inf"), dtype=torch.float64, device=dev)
    keys = torch.tensor([1, 1, 5], dtype=torch.int32, device=dev)
    vals = torch.tensor([2.0, 1.0, 3.0], dtype=torch.float64, device=dev)
    bad = _counter(dev)
    emis = S.seq_rolling_reduce(plane, keys, vals, "max", bad_keys=bad)
    assert emis.tolist() == [2.0, 2.0, 3.0]
    # out-of-range keys are counted on the card, not checked by the host:
    # they fold nothing and emit their own value
    emis = S.seq_rolling_reduce(plane, keys + 6, vals, "max", bad_keys=bad)
    assert emis.tolist() == [2.0, 2.0, 3.0] and int(bad[0]) == 1
    assert plane[7].item() == 2.0
    # without a counter a CUDA call is refused, not checked with a wait
    with pytest.raises(ValueError):
        S.seq_rolling_reduce(plane, keys, vals, "max")


def test_chapter2_job_on_card_matches_cpu_run(dev):
    # the whole job on the card, with the keyed planes growing past
    # key_capacity, gives the CPU run's rows; every step is a launch
    from tpustream_torch import StreamConfig, StreamExecutionEnvironment
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.runtime.sources import ReplaySource

    rng = np.random.default_rng(8)
    n = 3000
    hosts, cpus = rng.integers(0, 700, n), rng.integers(0, 8, n)
    usage = rng.integers(0, 10000, n) / 100
    lines = [f"{i} 10.0.{h >> 8}.{h & 255} cpu{c} {u}"
             for i, (h, c, u) in enumerate(zip(hosts, cpus, usage))]

    def run(device):
        env = StreamExecutionEnvironment(
            StreamConfig(batch_size=256, key_capacity=128, device=device))
        h = build(env, env.add_source(ReplaySource(lines))).collect()
        env.execute("ComputeCpuMax")
        return [repr(t) for t in h.items], env.metrics.steps

    want, _ = run("cpu")
    S.seq_rolling_reduce.launches = 0
    got, steps = run("cuda")
    assert got == want
    assert steps >= n // 256 and S.seq_rolling_reduce.launches == steps


def test_key_past_capacity_fails_the_step_on_card(dev, monkeypatch):
    # the device counter reaches the Runner with the step's fetch, which
    # raises before the step's rows reach the sink
    from tpustream_torch import StreamConfig, StreamExecutionEnvironment
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.runtime import executor
    from tpustream_torch.runtime.sources import ReplaySource

    monkeypatch.setattr(executor.Runner, "_check_capacity", lambda self: None)
    lines = [f"{i} 10.0.0.{i} cpu0 {i}.5" for i in range(6)]
    env = StreamExecutionEnvironment(
        StreamConfig(batch_size=3, key_capacity=4, device="cuda"))
    h = build(env, env.add_source(ReplaySource(lines))).collect()
    with pytest.raises(IndexError, match="capacity of 4"):
        env.execute("ComputeCpuMax")
    assert [repr(t) for t in h.items] == [
        f"(10.0.0.{i},cpu0,{i}.5)" for i in range(3)]
