"""State-memory accounting and key-skew gauges (``obs/memory.py``)
through the PyTorch port, on the CPU: the counterparts of
tests/test_obs_device.py's key-table, component-bytes and hot-key cases,
and the state's byte count against the JAX package's.

The port counts its state as it holds it on its device: every tensor
leaf, each keyed leaf with its trailing sink cell or row. The JAX
package counts every leaf of its state pytree, including the ones the
port keeps on the host (the pane ring's ``slot_pane``, the ring's five
scalar clocks) and an ``exchange_overflow`` counter the port has not.
The tests state that difference exactly. Tolerance: exact.
"""

import types

import pytest

import tpustream
import tpustream.config
import tpustream.runtime.sources
import tpustream_torch
import tpustream_torch.config
import tpustream_torch.runtime.sources
from tests.test_obs_device import _lines
from tpustream.jobs.chapter3_bandwidth_eventtime import build as jax_build_et
from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build as torch_build_et

PKGS = {
    "jax": types.SimpleNamespace(
        pkg=tpustream, config=tpustream.config, build_et=jax_build_et,
        sources=tpustream.runtime.sources, cfg={}),
    "torch": types.SimpleNamespace(
        pkg=tpustream_torch, config=tpustream_torch.config,
        build_et=torch_build_et, sources=tpustream_torch.runtime.sources,
        cfg={"device": "cpu"}),
}


def _run(lines, side="torch", **cfg_kw):
    ns = PKGS[side]
    cfg_kw.setdefault("batch_size", 16)
    cfg_kw.setdefault("key_capacity", 64)
    cfg = ns.config.StreamConfig(obs=ns.config.ObsConfig(enabled=True),
                                 **cfg_kw, **ns.cfg)
    env = ns.pkg.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    ns.build_et(env, env.add_source(ns.sources.ReplaySource(lines)),
                size=ns.pkg.Time.seconds(30), slide=ns.pkg.Time.seconds(10),
                delay=ns.pkg.Time.seconds(5)).collect()
    env.execute("device-obs")
    series = {}
    for s in env.metrics.obs_snapshot()["metrics"]["series"]:
        series.setdefault((s["name"], s["labels"].get("operator")), []).append(s)
    return env, series


def _one(series, name, operator="window"):
    (s,) = series[(name, operator)]
    return s["value"]


def test_key_table_gauges_track_inserts_in_the_port():
    _, series = _run(_lines(n=240, channels=5))
    assert _one(series, "operator_key_table_capacity") == 64
    assert _one(series, "operator_key_table_occupancy") == 5
    assert _one(series, "operator_key_table_load_factor") == 5 / 64
    assert _one(series, "operator_key_cardinality") == 5
    assert _one(series, "operator_key_updates") == 240


def test_component_bytes_sum_to_the_state_total_in_the_port():
    _, series = _run(_lines())
    total = _one(series, "operator_hbm_state_bytes")
    assert total > 0
    comps = series[("operator_state_component_bytes", "window")]
    assert sum(s["value"] for s in comps) == total
    by_comp = {s["labels"]["component"]: s["value"] for s in comps}
    assert by_comp["pane_ring"] > by_comp.get("scalars", 0)


def test_hot_key_skew_gauges_flag_the_hot_key_in_the_port():
    _, series = _run(_lines(n=300, channels=10, hot=0.6))
    share = _one(series, "operator_hot_key_share")
    assert 0.55 < share < 0.75
    hot_id = int(_one(series, "operator_hot_key_id"))
    _, balanced = _run(_lines(n=300, channels=10))
    bal_share = _one(balanced, "operator_hot_key_share")
    assert bal_share < share
    assert bal_share <= 0.2
    assert hot_id >= 0


def _port_state(env):
    (tracker,) = env.metrics.job_obs.state_trackers
    return tracker._runner


@pytest.mark.parametrize("acc_dtype", ["float64", "float32"])
def test_state_bytes_are_the_ports_leaves_and_differ_from_the_jax_package(
        acc_dtype):
    """``operator_hbm_state_bytes`` equals the bytes of the port's own
    tensor leaves, and differs from the JAX package's count by exactly
    the sink cells (one a flat plane and one for ``cnt``) less the
    leaves the port holds on the host (``slot_pane``: 8 bytes a slot;
    ``hi``, ``wm``, ``max_ts``, ``fired_through``, ``pending_fires``: 8
    each) and the JAX package's ``exchange_overflow`` (8)."""
    import torch

    from tpustream_torch.utils.tree import tree_leaves

    lines = _lines(n=120, channels=4)
    env, series = _run(lines, acc_dtype=acc_dtype)
    _, jax_series = _run(lines, side="jax", acc_dtype=acc_dtype)
    port_total = _one(series, "operator_hbm_state_bytes")
    jax_total = _one(jax_series, "operator_hbm_state_bytes")

    runner = _port_state(env)
    leaves = [l for l in tree_leaves(runner.state) if isinstance(l, torch.Tensor)]
    assert port_total == sum(l.numel() * l.element_size() for l in leaves)

    state = runner.state
    n_slots = runner.program.ring.n_slots
    sinks = sum(p.element_size() for p in state["planes"]) + 4  # + cnt's
    host = 8 * n_slots + 5 * 8
    assert port_total == jax_total + sinks - host - 8
    # the flagship's flow sum is one int32 plane under float32 (the
    # reference's compact32), two int32 words exact
    assert [p.dtype for p in state["planes"]] == (
        [torch.int32] if acc_dtype == "float32" else [torch.int32, torch.int32])


def test_rolling_state_bytes_shrink_under_float32():
    """The chapter-2 rolling max keeps its aggregated float64 field in
    one float32 plane under ``acc_dtype="float32"``: 4 bytes a key
    fewer, and the rest of the state as it was."""
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.runtime.sources import ReplaySource

    lines = [f"{1563452000 + i} 10.8.22.{i % 7} cpu{i % 2} {i * 1.25}"
             for i in range(50)]

    def total(acc_dtype):
        config = tpustream_torch.config
        env = tpustream_torch.StreamExecutionEnvironment(config.StreamConfig(
            device="cpu", batch_size=8, key_capacity=32, acc_dtype=acc_dtype,
            obs=config.ObsConfig(enabled=True)))
        build(env, env.add_source(ReplaySource(lines))).collect()
        env.execute("rolling-bytes")
        series = {(s["name"], s["labels"].get("operator")): s["value"]
                  for s in env.metrics.obs_snapshot()["metrics"]["series"]
                  if s["name"] == "operator_hbm_state_bytes"}
        return series[("operator_hbm_state_bytes", "rolling")]

    assert total("float64") - total("float32") == 4 * 32


def test_sharded_state_bytes_are_eight_one_device_states():
    """At parallelism 8 each shard holds a whole program state over
    ``key_capacity / 8`` keys, its sink cells and scalar leaves
    included: every shard's ``operator_hbm_state_bytes`` is a one-device
    run's at that capacity, and the total is their sum, so it exceeds
    the one-device total by seven states' fixed parts. The JAX package
    counts one global state pytree, whose total at parallelism 8 is its
    one-device total (``tests/test_obs_sharded.py``)."""
    lines = _lines(n=120, channels=4)

    def totals(side, **kw):
        _, series = _run(lines, side=side, **kw)
        return {s["labels"].get("shard"): s["value"]
                for s in series[("operator_hbm_state_bytes", "window")]}

    sharded = dict(parallelism=8, print_parallelism=1)
    port8, jax8 = totals("torch", **sharded), totals("jax", **sharded)
    one_state = totals("torch", key_capacity=8)[None]
    assert port8 == {None: 8 * one_state,
                     **{str(i): one_state for i in range(8)}}
    port1 = totals("torch")[None]
    assert port8[None] > port1
    assert jax8[None] == totals("jax")[None]
