"""The PyTorch port's session ops against the JAX package's, on the CPU:
``ops/sessions.py`` (the pane-axis segmented scan, run propagation, the
session boundary predicate in its torch and numpy forms, run detection,
the ascending slot order, the intra-batch rescue closure and the ring
retarget, absolute and pane-relative) and the typed cell merge
``WindowProgram._scatter_cells``. The same seeded numpy inputs go
through both; every comparison is bitwise."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream  # noqa: F401 -- x64 on, as the package runs
import tpustream.ops.panes as jpanes
import tpustream.ops.sessions as jsess
import tpustream.runtime.window_program as jwp
import tpustream_torch.ops.panes as tpanes
import tpustream_torch.ops.sessions as tsess
import tpustream_torch.runtime.window_program as twp

GAP = 1_000


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _cells(seed, k=7, n=9, fill=0.6):
    """A ring of ``[K, N]`` session cells in ascending pane order:
    occupancy, per-cell min/max timestamps (pane p covers
    [p*GAP, (p+1)*GAP)), dirty flags."""
    rng = np.random.default_rng(seed)
    occ = rng.random((k, n)) < fill
    base = (np.arange(n, dtype=np.int64) + 500) * GAP
    a = base + rng.integers(0, GAP, (k, n))
    b = base + rng.integers(0, GAP, (k, n))
    mn = np.where(occ, np.minimum(a, b), tsess.TS_MAX)
    mx = np.where(occ, np.maximum(a, b), tpanes.W0)
    fired = rng.random((k, n)) < 0.3
    return occ, mn, mx, fired


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_scan_axis0_float_add_and_int(seed):
    """The float sum keeps the reference's combination order: bitwise."""
    rng = np.random.default_rng(seed)
    o, k = 13, 6
    vals = rng.standard_normal((o, k)) * 10.0 ** rng.integers(-3, 9, (o, k))
    ints = rng.integers(-50, 50, (o, k))
    absorb = rng.random((o, k)) < 0.7

    def comb(a, b):
        return (a[0] + b[0], a[1] + b[1])

    want = jsess.seg_scan_axis0([jnp.asarray(vals), jnp.asarray(ints)],
                                jnp.asarray(absorb), comb)
    got = tsess.seg_scan_axis0([torch.from_numpy(vals), torch.from_numpy(ints)],
                               torch.from_numpy(absorb), comb)
    for g, w in zip(got, want):
        _same(g, w)
    # a [O] flag broadcast over trailing dims
    want = jsess.seg_scan_axis0([jnp.asarray(vals)], jnp.asarray(absorb[:, 0]),
                                lambda a, b: (a[0] + b[0],))
    got = tsess.seg_scan_axis0([torch.from_numpy(vals)],
                               torch.from_numpy(absorb[:, 0]),
                               lambda a, b: (a[0] + b[0],))
    _same(got[0], want[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_links_runs_and_propagation(seed):
    occ, mn, mx, _ = _cells(seed)
    j = [jnp.asarray(x) for x in (occ, mn, mx)]
    t = [torch.from_numpy(x) for x in (occ, mn, mx)]
    jlink = jsess.session_links(*j, GAP)
    _same(tsess.session_links(*t, GAP), jlink)
    _same(tsess.session_links(occ, mn, mx, GAP, xp=np), jlink)
    _same(jsess.session_links(occ, mn, mx, GAP, xp=np), jlink)
    jl, jend = jsess.session_runs(*j, GAP)
    tl, tend = tsess.session_runs(*t, GAP)
    _same(tl, jl)
    _same(tend, jend)
    rng = np.random.default_rng(seed + 10)
    fire = np.asarray(jend) & (rng.random(occ.shape) < 0.5)
    _same(tsess.propagate_to_run(torch.from_numpy(fire), tl),
          jsess.propagate_to_run(jnp.asarray(fire), jl))


@pytest.mark.parametrize("hi", [-1, 0, 5, 33, 34, 1_000_003])
def test_ascending_slot_order(hi):
    ring = tpanes.make_ring_spec(GAP, GAP, 1_000, 0, 32)
    jslot, jpane = jsess.ascending_slot_order(jnp.asarray(hi, jnp.int64),
                                              jpanes.make_ring_spec(GAP, GAP, 1_000, 0, 32))
    slot, pane = tsess.ascending_slot_order(hi, ring.n_slots)
    assert np.array_equal(slot, np.asarray(jslot)) and np.array_equal(pane, np.asarray(jpane))
    x = torch.arange(3 * ring.n_slots).reshape(3, ring.n_slots)
    assert torch.equal(torch.roll(x, -(hi + 1) % ring.n_slots, 1), x[:, slot])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_rescue_closure(seed):
    rng = np.random.default_rng(seed)
    b = 48
    keys = rng.integers(0, 4, b).astype(np.int32)
    ts = rng.integers(0, 8 * GAP, b).astype(np.int64)
    ts[: b // 4] = ts[b // 4: b // 2]  # equal timestamps: ties in the sort
    mask = rng.random(b) < 0.85
    anchor = mask & (rng.random(b) < 0.3)
    want = jsess.batch_rescue_closure(jnp.asarray(keys), jnp.asarray(ts),
                                      jnp.asarray(mask), jnp.asarray(anchor), GAP)
    got = tsess.batch_rescue_closure(torch.from_numpy(keys), torch.from_numpy(ts),
                                     torch.from_numpy(mask), torch.from_numpy(anchor),
                                     GAP)
    _same(got, want)
    assert 0 < int(np.sum(want)) < int(np.sum(mask))


@pytest.mark.parametrize("rel,lateness,hi_from,hi_to", [
    (False, 0, 40, 47), (False, 3_000, 40, 80), (True, 0, 40, 47),
    (True, 2_000, 55, 61), (True, 0, -1, 12),
])
def test_session_retarget(rel, lateness, hi_from, hi_to):
    """The ring's advance from ``hi_from`` to ``hi_to``: cleared cells and
    the evicted count equal the reference's, with absolute int64 and
    pane-relative int32 boundary planes."""
    ring = tpanes.make_ring_spec(GAP, GAP, 1_000, lateness, 4)
    jring = jpanes.make_ring_spec(GAP, GAP, 1_000, lateness, 4)
    n, k = ring.n_slots, 5
    rng = np.random.default_rng(hi_to)
    slot_pane = tpanes.slot_targets(hi_from, ring)
    cnt = rng.integers(0, 3, (k, n)).astype(np.int32)
    off_a, off_b = rng.integers(0, GAP, (k, n)), rng.integers(0, GAP, (k, n))
    if rel:
        cmin = np.minimum(off_a, off_b).astype(np.int32)
        cmax = np.maximum(off_a, off_b).astype(np.int32)
        idents = (2**31 - 1, -(2**31))
        ts_base = slot_pane * GAP
    else:
        cmin = (slot_pane * GAP + np.minimum(off_a, off_b)).astype(np.int64)
        cmax = (slot_pane * GAP + np.maximum(off_a, off_b)).astype(np.int64)
        idents = (tsess.TS_MAX, tpanes.W0)
        ts_base = None
    acc = [rng.integers(-9, 9, (k, n)).astype(np.int64), rng.standard_normal((k, n))]
    inits = [np.int64(-5), np.float64(0.0)]
    fired = rng.random((k, n)) < 0.5
    wm = (hi_from - 3) * GAP
    want = jsess.session_retarget(
        [jnp.asarray(a) for a in acc], jnp.asarray(cnt), jnp.asarray(cmin),
        jnp.asarray(cmax), jnp.asarray(slot_pane), jnp.asarray(hi_to, jnp.int64),
        jnp.asarray(wm, jnp.int64), GAP, jring, [jnp.asarray(i) for i in inits],
        cell_fired=jnp.asarray(fired), lateness_ms=lateness,
        ts_base=None if ts_base is None else jnp.asarray(ts_base),
        mn_clear=idents[0], mx_clear=idents[1])
    t = [torch.from_numpy(x.copy()) for x in acc + [cnt, cmin, cmax, fired]]
    target, evicted = tsess.session_retarget(
        t[:2], t[2], t[3], t[4], slot_pane, hi_to, wm, GAP, ring,
        [int(inits[0]), float(inits[1])], cell_fired=t[5], lateness_ms=lateness,
        ts_base=rel, mn_clear=idents[0], mx_clear=idents[1])
    for g, w in zip(t[:2], want[0]):
        _same(g, w)
    for g, w in zip(t[2:], want[1:5]):
        _same(g, w)
    assert np.array_equal(target, np.asarray(want[5]))
    assert int(evicted) == int(want[6])


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_cells(seed):
    """The typed key-major cell merge (sort, segmented scan with a float
    sum and min/max leaves, old-cell merge, tail set-scatter)."""
    ring = tpanes.make_ring_spec(GAP, GAP, 1_000, 0, 2)
    jring = jpanes.make_ring_spec(GAP, GAP, 1_000, 0, 2)
    n, k, b = ring.n_slots, 6, 40
    rng = np.random.default_rng(seed)
    cnt = np.where(rng.random((k, n)) < 0.4, rng.integers(1, 4, (k, n)), 0).astype(np.int32)
    leaves = [rng.standard_normal((k, n)), rng.integers(0, 10**6, (k, n)).astype(np.int64),
              rng.random((k, n)) < 0.5]
    keys = rng.integers(0, k, b).astype(np.int32)
    pane = rng.integers(500, 500 + 2 * n, b).astype(np.int64)
    live = rng.random(b) < 0.8
    batch = [rng.standard_normal(b) * 1e3, rng.integers(0, 10**6, b).astype(np.int64),
             np.zeros(b, bool)]

    def comb(a, bb):
        return (a[0] + bb[0], (jnp if isinstance(a[1], jnp.ndarray) else torch).minimum(a[1], bb[1]),
                a[2] & bb[2])

    want, want_cnt, _, _ = jwp.WindowProgram._scatter_cells(
        SimpleNamespace(local_key_capacity=k, ring=jring),
        [jnp.asarray(x) for x in leaves], jnp.asarray(cnt), jnp.asarray(keys),
        tuple(jnp.asarray(x) for x in batch), jnp.asarray(live), jnp.asarray(pane), comb)

    def flat(x):
        x = np.asarray(x).reshape(-1)
        return torch.from_numpy(np.append(x, np.zeros(1, x.dtype)))

    t_leaves = [flat(x) for x in leaves]
    t_cnt = flat(cnt)
    twp.WindowProgram._scatter_cells(
        SimpleNamespace(ring=ring), t_leaves, t_cnt, k, torch.from_numpy(keys),
        tuple(torch.from_numpy(x) for x in batch), torch.from_numpy(live),
        torch.from_numpy(pane), comb)
    for g, w in zip(t_leaves, want):
        _same(g[: k * n].view(k, n), w)
    _same(t_cnt[: k * n].view(k, n), want_cnt)
