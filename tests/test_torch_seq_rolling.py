"""The port's record-at-a-time keyed reduce (tpustream_torch/ops/
seq_rolling.py) against the reference Pallas kernel and its sequential
oracle (tpustream/ops/pallas_rolling.py).

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel
itself is held against that version by tests/test_torch_kernels_gpu.py
and by ``chip_smoke.py``. Inputs come from numpy with a seed and go to
both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpustream.ops import pallas_rolling as P
from tpustream_torch.ops import seq_rolling as S

CPU = torch.device("cpu")


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal values and zero signs, NaN where the other has NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(np.all(
        (np.isnan(a) & np.isnan(b))
        | ((a == b) & (np.signbit(a) == np.signbit(b)))
    ))


def _port(plane, keys, vals, op):
    """(plane after, emissions) from the port's wrapper on CPU tensors."""
    p = torch.from_numpy(plane.reshape(-1).copy())
    emis = S.seq_rolling_reduce(
        p, torch.from_numpy(keys.reshape(-1).astype(np.int32)),
        torch.from_numpy(vals.reshape(-1).copy()), op)
    return p.numpy().reshape(plane.shape), emis.numpy().reshape(vals.shape)


def test_plain_matches_pallas_interpret():
    # the reference test's own shape (3 row-blocks x 2 key-blocks); one
    # interpret-mode case, each costs ~14 s
    rng = np.random.default_rng(7)
    B, K = 384, 256
    keys = rng.integers(0, K, B, dtype=np.int32).reshape(B // 128, 128)
    vals = (rng.random(B, dtype=np.float32) * 100).reshape(B // 128, 128)
    plane = np.full((K // 128, 128), -np.inf, dtype=np.float32)
    want_plane, want_emis = P.seq_rolling_reduce(
        jnp.asarray(plane), jnp.asarray(keys), jnp.asarray(vals),
        op="max", interpret=True,
    )
    got_plane, got_emis = _port(plane, keys, vals, "max")
    assert _same_bits(got_plane, np.asarray(want_plane))
    assert _same_bits(got_emis, np.asarray(want_emis))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["max", "min", "sum"])
def test_plain_matches_sequential_oracle(op, dtype):
    rng = np.random.default_rng(11)
    B, K = 512, 96
    keys = rng.integers(0, K, B).astype(np.int32)
    # quarter-integers below 2^10: every partial sum is exact in f32, so
    # the plain version's tree-ordered sum equals the sequential fold
    vals = (rng.integers(-400, 400, B) / 4).astype(dtype)
    plane = (rng.integers(-100, 100, K) / 4).astype(dtype)
    plane[rng.random(K) < 0.5] = S.IDENTITY[torch.float64][op]
    want_plane, want_emis = P.oracle(plane, keys, vals, op)
    got_plane, got_emis = _port(plane, keys, vals, op)
    assert _same_bits(got_plane, want_plane)
    assert _same_bits(got_emis, want_emis)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_sum_random_values_close_to_sequential(dtype):
    # arbitrary values: the log-step scan adds in another order than the
    # arrival-order fold, so the two agree to rounding: per row at most
    # 2*(m-1)*eps*sum|v| over the m terms of the key's running sum
    rng = np.random.default_rng(12)
    B, K = 600, 40
    keys = rng.integers(0, K, B).astype(np.int32)
    vals = (rng.standard_normal(B) * 1e3).astype(dtype)
    plane = np.full(K, -0.0, dtype)
    want_plane, want_emis = P.oracle(plane, keys, vals, "sum")
    got_plane, got_emis = _port(plane, keys, vals, "sum")
    _, abs_run = P.oracle(np.zeros(K), keys, np.abs(vals).astype(np.float64), "sum")
    mult = np.zeros(K, np.int64)
    m = np.empty(B, np.int64)
    for i, k in enumerate(keys):
        mult[k] += 1
        m[i] = mult[k]
    eps = np.finfo(dtype).eps
    diff = np.abs(got_emis.astype(np.float64) - want_emis.astype(np.float64))
    assert np.all(diff <= 2 * (m - 1) * eps * abs_run)
    assert np.allclose(got_plane, want_plane, rtol=4 * B * eps, atol=0)


def test_repeated_key_arrival_order():
    # many hits on one key in one batch: the emissions are the running
    # prefix in arrival order (the reference's repeated-key case)
    B, K = 256, 128
    keys = np.zeros(B, dtype=np.int32)
    vals = np.arange(B, dtype=np.float32)
    plane = np.full(K, -np.inf, dtype=np.float32)
    got_plane, got_emis = _port(plane, keys, vals, "max")
    assert np.array_equal(got_emis, np.arange(B, dtype=np.float32))
    assert got_plane[0] == B - 1 and np.all(np.isneginf(got_plane[1:]))
    # descending values: the running max stays at the first one
    _, emis = _port(plane, keys, vals[::-1].copy(), "max")
    assert np.all(emis == B - 1)


@pytest.mark.parametrize("op", ["max", "min"])
def test_nan_and_signed_zero_follow_jnp(op):
    # the reference rolling step folds with jnp.maximum / jnp.minimum:
    # a NaN sticks to its key, and +0.0 beats -0.0 under max (-0.0 under
    # min); its scan adds 0.0 to every value of the batch first (a -0.0
    # value folds as +0.0), and a stored -0.0 meets it. A sequential
    # fold with the jnp op of each value + 0.0 is the oracle
    red = {"max": jnp.maximum, "min": jnp.minimum}[op]
    pool = np.array([np.nan, 0.0, -0.0, 1.5, -2.0, np.inf, -np.inf])
    rng = np.random.default_rng(5)
    B, K = 48, 6
    keys = rng.integers(0, K, B).astype(np.int32)
    vals = pool[rng.integers(0, pool.size, B)].astype(np.float64)
    plane = np.full(K, S.IDENTITY[torch.float64][op], np.float64)
    plane[::2] = -0.0  # keys seen before, at -0.0
    p = plane.copy()
    want = np.empty(B)
    for i, (k, v) in enumerate(zip(keys, vals)):
        p[k] = float(red(jnp.float64(p[k]), jnp.float64(v) + 0.0))
        want[i] = p[k]
    got_plane, got_emis = _port(plane, keys, vals, op)
    assert np.isnan(want).any()
    assert _same_bits(got_emis, want)
    assert _same_bits(got_plane, p)


def test_sum_keeps_negative_zero():
    # the sum identity is -0.0 (0.0 + -0.0 would be 0.0), so a key that
    # has folded nothing keeps its plane row at -0.0, and where the
    # reference keeps a -0.0 the port does: a batch of one row without a
    # scan copies a new key's -0.0, and a seen key's stored -0.0 plus a
    # -0.0 is -0.0. A scanned batch adds 0.0 to every value first, as the
    # reference's scan does, so its -0.0 values fold as +0.0
    plane = np.full(4, S.IDENTITY[torch.float64]["sum"])
    p = torch.from_numpy(plane.copy())
    one = torch.tensor([-0.0], dtype=torch.float64)
    for fresh in (True, False):
        emis = S.seq_rolling_reduce(p, torch.tensor([3], dtype=torch.int32),
                                    one.clone(), "sum",
                                    fresh=torch.tensor([fresh]))
        assert _same_bits(emis.numpy(), np.array([-0.0]))
    assert _same_bits(p.numpy(), np.array([-0.0, -0.0, -0.0, -0.0]))
    keys = np.array([3, 3, 1, 3], np.int32)
    vals = np.array([-0.0, -0.0, 0.0, 2.0])
    got_plane, got_emis = _port(plane, keys, vals, "sum")
    assert _same_bits(got_emis, np.array([0.0, 0.0, 0.0, 2.0]))
    assert _same_bits(got_plane, np.array([-0.0, 0.0, -0.0, 2.0]))


def test_padding_rows_fold_nothing():
    keys = np.array([2, -1, 2, -1], np.int32)
    vals = np.array([5.0, 99.0, 1.0, 7.0])
    plane = np.full(4, -np.inf)
    got_plane, got_emis = _port(plane, keys, vals, "max")
    assert np.array_equal(got_emis, [5.0, 99.0, 5.0, 7.0])
    assert got_plane[2] == 5.0 and np.all(np.isneginf(got_plane[[0, 1, 3]]))


def test_wrapper_checks():
    plane = torch.zeros(8, dtype=torch.float64)
    keys = torch.tensor([1, 8], dtype=torch.int32)
    vals = torch.ones(2, dtype=torch.float64)
    # no counter: an out-of-range key raises at once on the CPU, where
    # checking costs no wait on a device
    with pytest.raises(IndexError):
        S.seq_rolling_reduce(plane, keys, vals, "max")
    with pytest.raises(ValueError):  # the counter must be one int32
        S.seq_rolling_reduce(plane, keys, vals, "max",
                             bad_keys=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        S.seq_rolling_reduce(plane, keys.long(), vals, "max")
    with pytest.raises(TypeError):
        S.seq_rolling_reduce(plane, keys, vals.float(), "max")
    with pytest.raises(ValueError):
        S.seq_rolling_reduce(plane, keys, vals, "avg")
    with pytest.raises(ValueError):
        S.seq_rolling_reduce(plane[::2], keys.clamp(max=3), vals, "max")
    # plain-version calls on the CPU are not kernel launches
    before = S.seq_rolling_reduce.launches
    S.seq_rolling_reduce(plane, keys.clamp(max=7), vals, "max")
    assert S.seq_rolling_reduce.launches == before



def test_out_of_range_keys_are_counted_not_folded():
    # with a counter the call does not raise: such rows fold nothing,
    # emit their own value and add to the count, as in the kernel
    plane = torch.full((4,), -float("inf"), dtype=torch.float64)
    keys = torch.tensor([1, 4, 1, 9, -1, 3], dtype=torch.int32)
    vals = torch.tensor([2.0, 50.0, 1.0, 60.0, 7.0, 3.0], dtype=torch.float64)
    bad = torch.zeros(1, dtype=torch.int32)
    emis = S.seq_rolling_reduce(plane, keys, vals, "max", bad_keys=bad)
    assert emis.tolist() == [2.0, 50.0, 2.0, 60.0, 7.0, 3.0]
    assert plane.tolist() == [-float("inf"), 2.0, -float("inf"), 3.0]
    assert int(bad[0]) == 2
    S.seq_rolling_reduce(plane, keys, vals, "max", bad_keys=bad)
    assert int(bad[0]) == 4  # the counter accumulates


@pytest.mark.parametrize("n_keys, passes", [
    (0, 1), (1, 1), (255, 1), (256, 2), (1000, 2), (65535, 2), (65536, 3),
    (1 << 20, 3), ((1 << 20) + 1, 3), ((1 << 24) - 1, 3), (1 << 24, 4),
    ((1 << 31) - 1, 4),
])
def test_sort_passes_cover_the_padding_key(n_keys, passes):
    # keys run 0..K-1 and padding sorts as K, so the passes must hold the
    # bits of K itself: K = 2^20 needs 21 bits, three 8-bit digits
    assert S.sort_passes(n_keys) == passes
    assert n_keys < 1 << (S.DIGIT_BITS * passes)


@pytest.mark.parametrize("n_rows, n_keys, itemsize", [
    (1, 1, 8), (1023, 100, 4), (1024, 100, 4), (4099, 1 << 12, 8),
    (131072, 1 << 20, 8), (131072, 1 << 20, 4), (131073, (1 << 21) + 5, 8),
])
def test_scratch_layout_regions(n_rows, n_keys, itemsize):
    # every region is 256-byte aligned, disjoint, in bounds, and as large
    # as the kernel's entry point says it must be
    offsets, total = S.scratch_layout(n_rows, n_keys, itemsize)
    offsets = dict(zip(S.SCRATCH_REGIONS, offsets, strict=True))
    tiles = -(-n_rows // S.TILE_ROWS)
    need = {
        "pairs_a": 8 * n_rows, "pairs_b": 8 * n_rows,
        "counts": 4 * S.sort_passes(n_keys) * tiles * 256,
        "xs": itemsize * n_rows, "agg_v": itemsize * tiles, "agg_f": 4 * tiles,
    }
    assert list(offsets) == list(need)
    spans = sorted((offsets[r], offsets[r] + need[r]) for r in need)
    assert all(lo % 256 == 0 for lo, _ in spans)
    assert all(a_hi <= b_lo for (_, a_hi), (b_lo, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= total < spans[-1][1] + 256
    if (n_rows, n_keys, itemsize) == (131072, 1 << 20, 8):
        # the main shape: 128 tiles, 3 passes, about 3.5 MB in all
        assert tiles == 128 and need["counts"] == 3 * 128 * 1024
        assert total == 3 * 131072 * 8 + 3 * 128 * 1024 + 1024 + 512
