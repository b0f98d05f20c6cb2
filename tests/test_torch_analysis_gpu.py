"""The pre-flight analyzer and the subnormal repairs on the card: a
failing ``strict_analysis`` job refuses with nothing allocated or
launched, the chapter-2 job under the pre-flight gives its CPU run's
rows, ``seq_rolling.cu`` keeps the reference's rules for a batch of one
row and for a scan's zeros (bitwise against its plain version), and the
card's float64 ``sqrt`` is numpy's. Every
test here needs a CUDA device and skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_analysis_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.arith import reference_arithmetic
from tpustream_torch.config import ObsConfig
from tpustream_torch.jobs import chapter2_max
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime.sources import ReplaySource

pytestmark = pytest.mark.gpu

CH2 = [f"15634520{i % 60:02d} 10.8.22.{i % 7} cpu{i % 3} {(i * 37) % 100}.5"
       for i in range(40)]
TABLE = ["1563452000 10.8.0.1 cpu0 1e-309", "1563452001 10.8.0.1 cpu0 3e-309",
         "1563452002 10.8.0.2 cpu0 -2e-309"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view({8: np.int64, 4: np.int32}[a.itemsize])


def run_ch2(device, lines, **cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, **cfg))
    h = chapter2_max.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("ch2")
    return [repr(t) for t in h.items], env


def test_strict_analysis_refuses_with_no_allocation(card):
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=card, strict_analysis=True, batch_size=4, key_capacity=64))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    (env.add_source(ReplaySource(CH2)).map(chapter2_max.parse).key_by(0)
     .time_window(T.Time.seconds(5)).max(2).collect())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    S.reset_launches()
    with pytest.raises(T.PlanAnalysisError) as ei:
        env.execute("broken")
    torch.cuda.synchronize()
    assert "TSM002" in [f.code for f in ei.value.findings]
    assert torch.cuda.memory_allocated() == before
    assert S.seq_rolling_reduce.launches == 0
    assert env.metrics is None


def test_preflight_job_on_card_matches_cpu_run(card):
    cfg = dict(batch_size=8, key_capacity=64, strict_analysis=True,
               async_depth=2, fetch_group=4, obs=ObsConfig(enabled=True))
    S.reset_launches()
    rows, env = run_ch2(card, CH2, **cfg)
    assert S.seq_rolling_reduce.launches >= 1
    cpu_rows, _ = run_ch2("cpu", CH2, **cfg)
    assert rows == cpu_rows
    series = {s["labels"].get("code") for s in
              env.metrics.obs_snapshot()["metrics"]["series"]
              if s["name"] == "analysis_findings_total"}
    assert series == {"TSM009"}


@pytest.mark.parametrize("batch_size,want", [
    (1, ["(10.8.0.1,cpu0,1e-309)", "(10.8.0.1,cpu0,0.0)", "(10.8.0.2,cpu0,-2e-309)"]),
    (4, ["(10.8.0.1,cpu0,0.0)", "(10.8.0.1,cpu0,0.0)", "(10.8.0.2,cpu0,0.0)"]),
])
def test_subnormal_rolling_rows_on_card(card, batch_size, want):
    """The JAX package's rows (tests/test_torch_subnormal.py) from the
    card's job, through the kernel."""
    S.reset_launches()
    rows, _ = run_ch2(card, TABLE, batch_size=batch_size)
    assert S.seq_rolling_reduce.launches >= 1
    assert rows == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", ["max", "min", "sum"])
def test_kernel_one_row_and_scan_rules_match_plain(card, op, dtype):
    """The one-row rule and the scan's zeros in the kernel, bitwise against its plain version:
    one-row calls with ``fresh`` (a new key copies its subnormal, a seen
    key combines flushed) and scanned calls over zeros of both signs and
    subnormals, seen and new keys among them."""
    # subnormals, zeros of both signs and two normal values whose sums are
    # exact in any order, so the card's tree order of a sum cannot show
    tiny = torch.finfo(dtype).tiny
    pool = torch.tensor([tiny / 4, -tiny / 4, -0.0, 0.0, 1.5, -2.0], dtype=dtype)
    g = torch.Generator().manual_seed(3)
    K = 16
    plane0 = torch.full((K,), S.IDENTITY[dtype][op], dtype=dtype)
    plane0[::3] = pool[torch.randint(0, pool.numel(), (K,), generator=g)][::3]
    cases = [(torch.tensor([k], dtype=torch.int32),
              pool[i % pool.numel()].reshape(1), torch.tensor([fresh]))
             for i, (k, fresh) in enumerate([(1, True), (0, False), (3, False),
                                             (2, True)])]
    keys = torch.randint(0, K, (300,), generator=g, dtype=torch.int32)
    keys[::17] = -1  # padding rows
    vals = pool[torch.randint(0, pool.numel(), (300,), generator=g)]
    cases.append((keys, vals, None))
    for keys, vals, fresh in cases:
        pk, pr = plane0.clone().to(card), plane0.clone()
        bad = torch.zeros(1, dtype=torch.int32, device=card)
        ek = S.seq_rolling_reduce(pk, keys.to(card), vals.to(card), op,
                                  bad_keys=bad,
                                  fresh=None if fresh is None else fresh.to(card))
        er = S.seq_rolling_reduce_ref(pr, keys, vals, op, fresh=fresh)
        torch.cuda.synchronize()
        assert np.array_equal(_bits(ek), _bits(er)), (op, fresh, ek, er)
        assert np.array_equal(_bits(pk), _bits(pr)), (op, fresh, pk, pr)


def test_float64_sqrt_on_card_is_numpys(card):
    """The card's float64 (and float32) ``sqrt`` under
    ``reference_arithmetic`` gives numpy's correctly rounded root over a
    vector, bitwise."""
    rng = np.random.default_rng(0)
    for dtype in (np.float64, np.float32):
        x = np.concatenate([np.array([2.0, 3.0, 5.0, 0.5, -0.0, 0.0, np.inf],
                                     dtype),
                            (rng.random(200_000) * 1000).astype(dtype)])
        with reference_arithmetic():
            got = torch.sqrt(torch.from_numpy(x).to(card)).cpu().numpy()
        want = np.sqrt(x)
        assert np.array_equal(got.view(np.int64 if dtype == np.float64 else np.int32),
                              want.view(np.int64 if dtype == np.float64 else np.int32))
