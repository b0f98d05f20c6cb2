"""The PyTorch port's sharded programs at parallelism 4, side by side
with the JAX package at 4 on the suite's virtual CPU devices: every
keyed family (the flagship's case is in ``tests/test_torch_sharded.py``)
gives the same rows, ``print()`` bytes and counters, compared exactly,
with the inputs and harness of ``tests/test_torch_sharded.py``.
"""

import pytest

from test_torch_sessions import _side_items
from test_torch_sharded import (
    both,
    ch2_lines,
    cep_alert,
    cep_lines,
    count_process,
    count_reduce,
    kv_lines,
    median,
    median_items,
    rolling_max,
    session,
    sliding_count_reduce,
)


@pytest.mark.parametrize("name", ["rolling", "session", "session_process",
                                  "count", "sliding_count", "count_process",
                                  "median", "cep"])
def test_sharded_family_at_four_shards_matches_the_jax_package(name, capsys):
    """Each family at 4 shards."""
    build, items, kw = {
        "rolling": (rolling_max, ch2_lines(60), dict(event_time=False)),
        "session": (session("reduce"), _side_items("reduce", 3), {}),
        "session_process": (session("process"), _side_items("process", 5), {}),
        "count": (count_reduce, kv_lines(2, 60), dict(event_time=False)),
        "sliding_count": (sliding_count_reduce, kv_lines(2, 60),
                          dict(event_time=False)),
        "count_process": (count_process, kv_lines(2, 60),
                          dict(event_time=False)),
        "median": (median, median_items(120), dict(event_time=False,
                                                    proc_ms=400)),
        "cep": (cep_alert, cep_lines(100), {}),
    }[name]
    batch = 16 if "count" in name else 40
    rows = both(build, items, capsys, parallelism=4, batch_size=batch,
                key_capacity=64, alert_capacity=256, **kw)[0]
    assert rows
