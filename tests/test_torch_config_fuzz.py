"""The single-stage fuzz of tests/test_config_equivalence.py through the
PyTorch port, on the CPU: one randomized out-of-order event-time stream
with late stragglers and gaps (the suite's own ``_stream``), seeds 0-2,
at batch sizes 1, 16 and 64, in four execution strategies (plain,
``max_fires_per_step=2``, raw byte buffers through the native parser,
the ``int32`` accumulator), each against the JAX package's plain run of
the same seed and batch size (the JAX suite holds its own strategies
equal to that run). Tolerance: identical rows."""

import collections

import pytest

from tests.test_config_equivalence import DELAY_MS, _stream
from tests.test_torch_chains import run_job

STRATEGIES = {
    "plain": {},
    "fire_budget": {"max_fires_per_step": 2},
    "raw": {"raw": True},
    "int32": {"acc_dtype": "int32"},
}


def ts_extractor(ns):
    class TsExtractor(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(DELAY_MS))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    return TsExtractor()


def parse(ns):
    def fn(line):
        items = line.split(" ")
        return ns.pkg.Tuple3(int(items[0]), items[1], int(items[2]))
    return fn


def build(ns, text):
    return (
        text.assign_timestamps_and_watermarks(ts_extractor(ns))
        .map(parse(ns))
        .key_by(1)
        .time_window(ns.pkg.Time.seconds(10), ns.pkg.Time.seconds(2))
        .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
        .map(lambda t: ns.pkg.Tuple3(t.f1, t.f2, 0))
        .filter(lambda t: t.f1 >= 0)
    )


def run(side, lines, batch_size, raw=False, **cfg):
    rows, _ = run_job(side, build, lines, batch_size=batch_size,
                      raw_batch=batch_size if raw else None, **cfg)
    return collections.Counter(rows)


@pytest.mark.parametrize("batch_size", [1, 16, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_stage_fuzz_strategies(seed, batch_size):
    lines = _stream(seed, n=200)
    want = run("jax", lines, batch_size)
    assert sum(want.values()) > 20  # windows actually fired
    for name, cfg in STRATEGIES.items():
        got = run("torch", lines, batch_size, **cfg)
        assert got == want, f"{name} diverged from the JAX package (seed {seed})"
