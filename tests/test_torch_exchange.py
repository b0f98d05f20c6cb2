"""The PyTorch port's keyBy exchange and shard mesh
(``tpustream_torch/parallel/``), on the CPU, side by side with the JAX
package.

The same seeded numpy inputs go through ``tpustream.parallel.exchange
.exchange_by_key`` under ``shard_map`` on the suite's virtual CPU
devices and through the port's ``exchange_by_key`` on a CPU mesh of the
same number of shards (8 and 4), at the loss-free capacity and at a
small capacity factor that overflows: every received column, ``valid``,
``ts`` and each shard's overflow count are equal, bit for bit, in place
(the receive layout included). Also: the key-ownership helpers, the
capacity rule, the mesh's refusal of too few devices, and the group's
failure path (one shard raises inside a
collective, every shard fails, none hangs).

Tolerance: none.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

try:  # jax >= 0.6
    shard_map = jax.shard_map
except AttributeError:  # older jax
    from jax.experimental.shard_map import shard_map

from tpustream.parallel import exchange as jax_exchange
from tpustream.parallel import mesh as jax_mesh
from tpustream_torch.parallel import exchange as torch_exchange
from tpustream_torch.parallel import mesh as torch_mesh


def _inputs(b, seed, n_keys=37):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_keys, size=b).astype(np.int32),
            rng.normal(size=b),
            rng.integers(0, 1000, size=b).astype(np.int64),
            rng.random(b) > 0.2)


def _jax(s, keys, vals, ts, valid, cap):
    from jax.sharding import PartitionSpec as P

    AXIS = jax_mesh.AXIS
    mesh = jax_mesh.make_mesh(s)

    def core(keys, vals, ts, valid):
        cols, v, t, ovf = jax_exchange.exchange_by_key(
            [keys, vals], valid, ts, keys, s, cap)
        return cols[0], cols[1], t, v, ovf.reshape(1)

    f = jax.jit(shard_map(core, mesh=mesh,
                          in_specs=(P(AXIS),) * 4, out_specs=(P(AXIS),) * 5))
    return [np.asarray(x) for x in jax.device_get(f(keys, vals, ts, valid))]


def _run_shards(mesh, fn):
    """``fn(shard)`` on one thread a shard, as the sharded programs run
    them: the results in shard order, or the first error."""
    out, errs = [None] * mesh.size, []

    def work(i):
        try:
            out[i] = mesh.run_shard(fn, i)
        except BaseException as e:  # noqa: BLE001 - collected
            errs.append(e)
            mesh.abort()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a shard hung"
    return out, errs


def _torch(s, keys, vals, ts, valid, cap):
    mesh = torch_mesh.make_mesh(s, device="cpu")
    blk = keys.shape[0] // s

    def one(i):
        sl = slice(i * blk, (i + 1) * blk)
        k = torch.from_numpy(keys[sl].copy())
        cols, v, t, ovf = torch_exchange.exchange_by_key(
            [k, torch.from_numpy(vals[sl].copy())],
            torch.from_numpy(valid[sl].copy()),
            torch.from_numpy(ts[sl].copy()), k, s, cap, mesh, i)
        return cols[0], cols[1], t, v, ovf.reshape(1)

    out, errs = _run_shards(mesh, one)
    assert not errs
    return [torch.cat([o[j] for o in out]).numpy() for j in range(5)]


@pytest.mark.parametrize("s", [8, 4])
@pytest.mark.parametrize("factor", [None, 0.5], ids=["loss_free", "overflow"])
@pytest.mark.parametrize("n_keys", [37, 3])
def test_exchange_by_key_matches_the_jax_package(s, factor, n_keys):
    b = 64
    keys, vals, ts, valid = _inputs(b, seed=s + n_keys, n_keys=n_keys)
    cap = torch_exchange.exchange_capacity(b, s, factor)
    assert cap == jax_exchange.exchange_capacity(b, s, factor)
    want = _jax(s, keys, vals, ts, valid, cap)
    got = _torch(s, keys, vals, ts, valid, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    overflow = int(got[4].sum())
    if factor is None:
        assert overflow == 0
    elif n_keys == 3:
        assert overflow > 0
    # every received record is its receiving shard's, once
    ok, k2 = got[3], got[0]
    rows = len(k2) // s
    for d in range(s):
        assert all(int(k) % s == d for k in k2[d * rows:(d + 1) * rows][
            ok[d * rows:(d + 1) * rows]])
    assert int(ok.sum()) + overflow == int(valid.sum())


def test_exchange_capacity_and_buffer_bytes_match_the_jax_package():
    for b, s, f in [(131072, 8, None), (131072, 8, 1.5), (40, 8, 0.5),
                    (64, 4, 2.0), (16, 8, 0.01)]:
        assert (torch_exchange.exchange_capacity(b, s, f)
                == jax_exchange.exchange_capacity(b, s, f))
        cap = torch_exchange.exchange_capacity(b, s, f)
        kinds = ["str", "f64", "i64", "bool"]
        assert (torch_exchange.exchange_buffer_bytes(s, cap, kinds)
                == jax_exchange.exchange_buffer_bytes(s, cap, kinds))


def test_key_ownership_matches_the_jax_package():
    ids = np.arange(0, 257, dtype=np.int64)
    for s in (1, 2, 4, 8):
        for fn in ("owner_of", "local_slot"):
            assert np.array_equal(getattr(torch_mesh, fn)(ids, s),
                                  np.asarray(getattr(jax_mesh, fn)(ids, s)))
        shard, local = torch_mesh.owner_of(ids, s), torch_mesh.local_slot(ids, s)
        assert np.array_equal(torch_mesh.global_key(local, shard, s), ids)
        assert np.array_equal(torch_mesh.global_key(local, shard, s),
                              jax_mesh.global_key(local, shard, s))


def test_mesh_refuses_too_few_devices_and_wraps_defaults():
    with pytest.raises(RuntimeError, match="exceeds available devices"):
        torch_mesh.make_mesh(4, devices=[torch.device("cpu")] * 2)
    with pytest.raises(RuntimeError, match="exceeds available devices"):
        jax_mesh.make_mesh(4, devices=jax.devices()[:2])
    mesh = torch_mesh.make_mesh(8, device="cpu")
    assert mesh.size == 8
    assert {mesh.device_of(i) for i in range(8)} == {torch.device("cpu")}


def test_mesh_collectives():
    """``pmax``/``psum`` of host ints, host arrays and tensors, and
    ``all_to_all``'s source-shard order (``jax.lax.all_to_all`` with
    ``split_axis=concat_axis=0``)."""
    mesh = torch_mesh.make_mesh(4, device="cpu")

    def one(i):
        x = torch.arange(4 * 2).reshape(4, 2) + 100 * i
        return (mesh.pmax(i, i * 3), mesh.psum(i, np.array([i, 1])),
                mesh.pmax(i, torch.tensor(float(i))), mesh.all_to_all(i, x),
                mesh.axis_index(i))

    out, errs = _run_shards(mesh, one)
    assert not errs
    for i, (mx, sm, tmx, a2a, idx) in enumerate(out):
        assert mx == 9 and list(sm) == [6, 4] and float(tmx) == 3.0
        assert idx == i
        want = torch.cat([torch.tensor([2 * i, 2 * i + 1]) + 100 * src
                          for src in range(4)])
        assert torch.equal(a2a, want)


def test_mesh_failure_aborts_every_shard():
    """One shard raises while the others wait in a collective: the mesh
    is aborted, every shard fails, none hangs; a reset mesh runs again."""
    mesh = torch_mesh.make_mesh(8, device="cpu")

    def one(i):
        if i == 5:
            time.sleep(0.05)  # the others are waiting in the all-to-all
            raise ValueError("shard 5 failed")
        mesh.all_to_all(i, torch.zeros(8, 1))
        return i

    t0 = time.perf_counter()
    out, errs = _run_shards(mesh, one)
    assert time.perf_counter() - t0 < 30
    assert len(errs) == 8
    assert sum(isinstance(e, ValueError) for e in errs) == 1
    assert sum(isinstance(e, torch_mesh.MeshAborted) for e in errs) == 7
    mesh.reset()
    out, errs = _run_shards(mesh, lambda i: mesh.psum(i, 1))
    assert not errs and out == [8] * 8


def test_mesh_rendezvous_under_thread_switch_stress():
    """More shards than cores, a shortened interpreter switch interval and
    many rounds of collectives: every round's sum and maximum is exact (a
    lost or stale post to a slot would break them), and no shard hangs."""
    import os
    import sys

    n = max(16, 2 * (os.cpu_count() or 1))
    mesh = torch_mesh.make_mesh(n, device="cpu")
    rounds = 200
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def one(i):
            got = []
            for r in range(rounds):
                got.append((mesh.psum(i, i + r), mesh.pmax(i, (i * 7 + r) % n)))
            return got

        out, errs = _run_shards(mesh, one)
    finally:
        sys.setswitchinterval(prev)
    assert not errs
    total = n * (n - 1) // 2
    for got in out:
        assert [s for s, _ in got] == [total + n * r for r in range(rounds)]
        assert all(m == n - 1 for _, m in got)
