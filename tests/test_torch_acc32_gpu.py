"""The fixed-order float32 scatter-add kernel (``kernels/ordered_scatter.cu``)
and the 32-bit accumulator configurations on the card. Every test here
needs a CUDA device and skips without one.

* The kernel against its plain version (``ordered_scatter_add_ref``) on
  the card, bitwise, on uniform, skewed and one-key cells, with values
  that are not integers; and twice on the same inputs, which must give
  the same bits (no atomics decide an order).
* A 32-bit window job (the chapter-2 mean under float32, and a rolling
  sum under float32) on the card against the same job on the CPU
  (tolerance: bitwise for the window; the rolling sum's in-batch prefix
  is the rolling kernel's float64 tree order on the card, not the CPU
  scan's, so a stored float32 word may round one ulp apart: rtol 1e-6).

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_acc32_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.ops import ordered_scatter as osc
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def _cells(case, b, n, gen):
    if case == "uniform":
        return torch.randint(0, n + 1, (b,), generator=gen)
    if case == "skewed":
        hot = torch.rand(b, generator=gen) < 0.5
        return torch.where(hot, torch.randint(0, 8, (b,), generator=gen),
                           torch.randint(0, n + 1, (b,), generator=gen))
    return torch.full((b,), 12345, dtype=torch.int64)


@pytest.mark.parametrize("case", ["uniform", "skewed", "one_key"])
def test_kernel_matches_its_plain_version_on_the_card(card, case):
    gen = torch.Generator().manual_seed(7)
    b, n = 1 << 15, 1 << 20
    cells = _cells(case, b, n, gen).to(torch.int64).to(card)
    vals = torch.randn(b, generator=gen).to(card)
    base = torch.randn(n + 1, generator=gen).to(card)
    osc.reset_launches()
    got = osc.ordered_scatter_add(base.clone(), cells, vals)
    again = osc.ordered_scatter_add(base.clone(), cells, vals)
    want = osc.ordered_scatter_add_ref(base.clone(), cells, vals)
    torch.cuda.synchronize()
    assert osc.ordered_scatter_add.launches == 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    # and the sequential fold on the host, np.add.at
    host = base.cpu().numpy().copy()
    c, v = cells.cpu().numpy(), vals.cpu().numpy()
    keep = c < n
    np.add.at(host, c[keep], v[keep])
    assert np.array_equal(got.cpu().numpy().view(np.int32), host.view(np.int32))


def _avg_lines(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(f"{1563452000 + i} 10.8.0.{int(rng.integers(0, 50))} "
                   f"cpu{i % 4} {float(rng.random() * 100.0)!r}")
        if i % 997 == 996:
            out.append(AdvanceProcessingTime(i * 40 + 30_000))
    return out + [AdvanceProcessingTime(n * 40 + 120_000)]


def _run_avg(device, lines, acc_dtype):
    from tpustream_torch.jobs import chapter2_avg

    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, batch_size=512, key_capacity=64, acc_dtype=acc_dtype))
    src = ReplaySource(lines, ms_per_record=40)
    h = chapter2_avg.build(env, env.add_source(src)).collect()
    env.execute("avg32")
    return [repr(t) for t in h.items]


def test_float32_mean_job_on_the_card_equals_the_cpu(card):
    lines = _avg_lines(6000, seed=3)
    osc.reset_launches()
    got = _run_avg(card, lines, "float32")
    assert osc.ordered_scatter_add.launches > 0
    want = _run_avg("cpu", lines, "float32")
    assert len(want) > 20 and got == want
    # the 32-bit sums are not the exact run's
    assert want != _run_avg("cpu", lines, "float64")


def test_float32_rolling_sum_on_the_card_agrees_with_the_cpu(card):
    from tpustream_torch.ops import seq_rolling

    rng = np.random.default_rng(4)
    lines = [f"{1563452000 + i} h{int(rng.integers(0, 40))} cpu0 "
             f"{float(rng.random() * 10.0)!r}" for i in range(4000)]

    def run(device):
        env = T.StreamExecutionEnvironment(T.StreamConfig(
            device=device, batch_size=256, key_capacity=64,
            acc_dtype="float32"))
        h = (env.add_source(ReplaySource(lines))
             .map(lambda l: T.Tuple2(l.split(" ")[1], float(l.split(" ")[3])))
             .key_by(0).sum(1).collect())
        env.execute("rolling32")
        return [t.f1 for t in h.items]

    seq_rolling.reset_launches()
    got = run(card)
    assert seq_rolling.seq_rolling_reduce.launches_by_dtype.get("float64", 0) > 0
    want = run("cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
