"""The fixed-order float32 scatter-add kernel (``kernels/ordered_scatter.cu``)
and the 32-bit accumulator configurations on the card. Every test here
needs a CUDA device and skips without one.

* The kernel against its plain version (``ordered_scatter_add_ref``) on
  the card, bitwise, on uniform, skewed and one-key cells, with values
  that are not integers; and twice on the same inputs, which must give
  the same bits (no atomics decide an order).
* The redesigned kernels' corners, each bitwise against the plain
  version and between two launches: subnormal values, sums that cancel
  into the subnormal range (flushed to signed zeros), a run longer than
  one block's staging buffer, many long runs of unequal length, a batch
  past one pass, a batch of only sink rows, one row, no rows; int64
  cells refused on the card, and the launches a call makes.
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
    return torch.full((b,), 12345, dtype=torch.int32)


@pytest.mark.parametrize("case", ["uniform", "skewed", "one_key"])
def test_kernel_matches_its_plain_version_on_the_card(card, case):
    gen = torch.Generator().manual_seed(7)
    b, n = 1 << 15, 1 << 20
    cells = _cells(case, b, n, gen).to(torch.int32).to(card)
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


def _kernel_case(card, plane, cells, vals):
    """The kernels against their plain version on the card and against
    a second launch, bitwise; returns the plane."""
    plane = plane.to(card)
    cells, vals = cells.to(card), vals.to(card)
    osc.reset_launches()
    got = osc.ordered_scatter_add(plane.clone(), cells, vals)
    again = osc.ordered_scatter_add(plane.clone(), cells, vals)
    want = osc.ordered_scatter_add_ref(plane.clone(), cells, vals)
    torch.cuda.synchronize()
    assert osc.ordered_scatter_add.launches == 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got.cpu()


TINY = float(np.finfo(np.float32).tiny)


def test_kernel_flushes_subnormal_values_on_the_card(card):
    gen = torch.Generator().manual_seed(11)
    b, n = 4096, 512
    cells = torch.randint(0, n + 1, (b,), generator=gen).to(torch.int32)
    vals = (torch.rand(b, generator=gen) - 0.5) * (4 * TINY)
    plane = (torch.rand(n + 1, generator=gen) - 0.5) * (4 * TINY)
    got = _kernel_case(card, plane, cells, vals)
    sub = (got != 0) & (got.abs() < TINY)
    assert not bool(sub.any())


def test_kernel_flushes_sums_that_cancel_into_subnormals_on_the_card(card):
    # +1.5e-38 then -1.4e-38 on one cell leaves 1e-39: a signed zero
    cells = torch.tensor([0, 0, 1, 1, 2, 2, 2], dtype=torch.int32)
    vals = torch.tensor([1.5e-38, -1.4e-38, -1.5e-38, 1.4e-38, 1.5e-38,
                         -1.4e-38, 3.0])
    plane = torch.zeros(4)
    got = _kernel_case(card, plane, cells, vals)
    assert got[0].item() == 0.0 and not torch.signbit(got[0])
    assert got[1].item() == 0.0 and torch.signbit(got[1])
    assert got[2].item() == 3.0


def test_kernel_folds_a_run_longer_than_a_staging_buffer(card):
    # 2048 rows a stage: 5000 rows on one cell cross three stages
    gen = torch.Generator().manual_seed(12)
    b, n = 20000, 1 << 16
    cells = torch.randint(0, n + 1, (b,), generator=gen)
    cells[torch.randperm(b, generator=gen)[:5000]] = 777
    vals = torch.randn(b, generator=gen)
    _kernel_case(card, torch.randn(n + 1, generator=gen), cells.to(torch.int32),
                 vals)


def test_kernel_folds_many_long_runs_of_unequal_length(card):
    # runs of every class: short (<= 32), medium (<= 2048) and long,
    # interleaved in arrival order
    gen = torch.Generator().manual_seed(13)
    lengths = [2, 31, 33, 500, 2048, 2049, 3000, 4100, 9000, 17]
    cells = torch.cat([torch.full((m,), 10 * i + 3, dtype=torch.int32)
                       for i, m in enumerate(lengths)])
    cells = cells[torch.randperm(cells.numel(), generator=gen)]
    vals = torch.randn(cells.numel(), generator=gen)
    _kernel_case(card, torch.randn(1 << 10, generator=gen), cells, vals)


def test_kernel_takes_a_batch_past_one_pass(card):
    # more rows than one pass holds: passes in order keep the order
    gen = torch.Generator().manual_seed(14)
    b, n = 300_000, 1 << 12
    cells = torch.randint(0, n + 1, (b,), generator=gen).to(torch.int32)
    _kernel_case(card, torch.randn(n + 1, generator=gen), cells,
                 torch.randn(b, generator=gen))


def test_kernel_takes_only_sink_rows_and_one_row(card):
    n = 100
    plane = torch.randn(n + 1, generator=torch.Generator().manual_seed(15))
    got = _kernel_case(card, plane, torch.full((64,), n, dtype=torch.int32),
                       torch.randn(64))
    assert torch.equal(got.view(torch.int32), plane.view(torch.int32))
    got = _kernel_case(card, plane, torch.tensor([7], dtype=torch.int32),
                       torch.tensor([0.25]))
    assert got[7].item() == np.float32(plane[7].item() + 0.25)
    _kernel_case(card, plane, torch.zeros(0, dtype=torch.int32), torch.zeros(0))


def test_kernel_takes_int32_cells_only_and_counts_its_launches(card):
    # the path passes int32 cells; int64 cells are the plain version's
    plane = torch.zeros(9, device=card)
    vals = torch.ones(3, device=card)
    with pytest.raises(TypeError, match="int32 cells"):
        osc.ordered_scatter_add(plane, torch.zeros(3, dtype=torch.int64,
                                                   device=card), vals)
    per_pass = osc.device_launches(1)
    assert per_pass == 5
    assert osc.device_launches(0) == 0
    assert osc.device_launches(300_000) == 3 * per_pass


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
