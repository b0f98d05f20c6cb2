"""Keyed rolling aggregates: max/min/sum/max_by/min_by/reduce (PyTorch).

Implements Flink's rolling-aggregate semantics exactly as the golden
transcript proves them (reference chapter2/.../ComputeCpuMax.java:26,
chapter2/README.md:52-66): EVERY input record emits the current
aggregate for its key, only the aggregated field updates, and every
other field keeps the value from the key's FIRST-ever record.
``max_by``/``min_by`` instead keep the whole winning record (first wins
ties), and a user ``reduce`` folds whole records.

Counterpart of tpustream/ops/rolling.py, in two paths:

* :func:`rolling_step`, the commutative field aggregates (the
  reference's ``_rolling_step_commutative``) of a float64 or int64
  field. The aggregated column goes through one call of the keyed-reduce
  kernel
  (``ops/seq_rolling.py``), which does the reference's sort, segmented
  scan, stored-value gather and tail scatter and yields the emissions in
  arrival order. The keep-first leaves, the key column and the occupancy
  test stay plain tensor ops, as they are plain XLA ops in the
  reference.
* :func:`rolling_step_general`, every other combiner (the reference's
  general path, ``rolling_step`` lines 159-191), and max/min/sum of an
  interned-string or boolean field: a stable sort by key, a
  segmented scan with the combiner, a gather of the stored leaves, a
  ``where`` on seen keys and a set-scatter at segment tails, all torch
  ops. The reference leaves its emissions in key-sorted order for the
  host to un-permute; here the device gathers them back into arrival
  order with the inverse permutation.

State is dense per-key planes (ops/wordplanes.py) plus a ``seen``
bitmap. Unlike the reference, a commutative aggregate's plane starts at
the op's identity (``seq_rolling.IDENTITY``) rather than 0, so the
kernel's fold needs no occupancy test, and an int64 aggregated field
keeps ONE native int64 plane where the reference keeps two int32 words,
so the kernel folds it in place (:func:`plane_layout`);
:func:`state_from_jax_numpy` converts. The general path's state is the
reference's layout as it is.

``compact32`` (``StreamConfig.acc_dtype`` ``"int32"``/``"float32"``) stores
the aggregated leaf in ONE 32-bit plane, exactly as the reference does
(a float64 field rounds to float32, an int64 field wraps to int32, a
never-seen key holds 0). Each step widens that plane to float64 or
int64 (never-seen keys at the identity), runs the same kernel on the
wide plane, so the stored value and the batch's prefix combine in 64
bits as in the reference, and stores the plane back in 32 bits.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..arith import flush_subnormal
from ..records import F64, I64, STR
from .segments import inverse_permutation, segment_tails, segmented_scan, sort_by_key
from .seq_rolling import IDENTITY, seq_rolling_reduce
from .wordplanes import (
    TORCH_DTYPES,
    leaf_plane_slices,
    pack_words,
    plane_dtypes,
    unpack_words,
)

COMMUTATIVE = ("max", "min", "sum")
# the field kinds the kernel aggregates; max/min/sum of any other kind
# take rolling_step_general with make_combiner
KERNEL_KINDS = (F64, I64)


def kernel_path(kinds: Sequence[str], kind: str, pos: Optional[int]) -> bool:
    """Whether rolling ``kind`` of leaf ``pos`` runs through the kernel
    (:func:`rolling_step`) rather than :func:`rolling_step_general`."""
    return kind in COMMUTATIVE and kinds[pos] in KERNEL_KINDS


def _check_kind(kinds: Sequence[str], kind: str, pos: int) -> None:
    if kind in COMMUTATIVE and kinds[pos] not in KERNEL_KINDS:
        raise ValueError(
            f"rolling_step aggregates float64 and int64 fields; {kind} over "
            f"a {kinds[pos]!r} field takes rolling_step_general"
        )


def _compact_leaves(kinds: Sequence[str], pos: Optional[int],
                    compact32: bool) -> List[bool]:
    """The per-leaf 32-bit flags: only the aggregated leaf, and only when
    ``compact32``."""
    return [compact32 and i == pos for i in range(len(kinds))]


def plane_layout(kinds: Sequence[str], kind: str, pos: Optional[int],
                 compact32: bool = False):
    """``(plane dtypes, per-leaf plane slices)`` of a rolling state: the
    reference's word planes (ops/wordplanes.py), except that the kernel
    path's int64 aggregated leaf keeps one native int64 plane in place
    of its two int32 words. With ``compact32`` the aggregated leaf is
    one 32-bit plane, the reference's layout as it is."""
    c32 = _compact_leaves(kinds, pos, compact32)
    dtypes, slices = plane_dtypes(kinds, c32), leaf_plane_slices(kinds, c32)
    if compact32 or not (kind in COMMUTATIVE and kinds[pos] == I64):
        return dtypes, slices
    agg = slices[pos]
    dtypes = dtypes[:agg.start] + [torch.int64] + dtypes[agg.stop:]
    slices = [
        sl if i < pos
        else slice(sl.start, sl.start + 1) if i == pos
        else slice(sl.start - 1, sl.stop - 1)
        for i, sl in enumerate(slices)
    ]
    return dtypes, slices


def _combine_field_agg(pos: int, reducer: Callable):
    """Combiner for max/min/sum(pos): aggregate field ``pos``, keep-left rest."""

    def combine(a, b):
        out = list(a)
        out[pos] = reducer(a[pos], b[pos])
        return tuple(out)

    return combine


def _combine_by(pos: int, is_max: bool):
    """Combiner for max_by/min_by: keep the whole better record, first
    wins ties."""

    def combine(a, b):
        # the compared field as XLA reads it: its select between the two
        # values it compared becomes a max/min instruction, which flushes
        # them (the record's other fields are selected as they are)
        ka, kb = flush_subnormal(a[pos]), flush_subnormal(b[pos])
        better_b = kb > ka if is_max else kb < ka
        return tuple(
            torch.where(better_b, kb if i == pos else fb, ka if i == pos else fa)
            for i, (fa, fb) in enumerate(zip(a, b)))

    return combine


def make_combiner(kind: str, pos: int) -> Callable:
    """The leaf-tuple combiner of a built-in rolling aggregate."""
    if kind == "max":
        return _combine_field_agg(pos, torch.maximum)
    if kind == "min":
        return _combine_field_agg(pos, torch.minimum)
    if kind == "sum":
        return _combine_field_agg(pos, lambda a, b: a + b)
    if kind == "max_by":
        return _combine_by(pos, True)
    if kind == "min_by":
        return _combine_by(pos, False)
    raise ValueError(f"unknown rolling kind {kind}")


def init_rolling_state(
    key_capacity: int,
    kinds: List[str],
    kind: str,
    pos: int,
    sentinel_leaf: Optional[int] = None,
    device: torch.device = torch.device("cpu"),
    compact32: bool = False,
) -> dict:
    """Fresh state for ``key_capacity`` keys. A commutative ``kind`` of
    a float64 or int64 leaf (the kernel path) starts the aggregated
    leaf's plane at its identity (at 0 when ``compact32`` stores it in 32
    bits) and a ``sentinel_leaf`` (a keep-first STR leaf whose plane
    doubles as the occupancy test; interned ids are >= 0) at -1; every
    other plane, and every plane of the general path, starts at 0."""
    dtypes, slices = plane_layout(kinds, kind, pos, compact32)
    planes = [
        torch.zeros((key_capacity,), dtype=dt, device=device)
        for dt in dtypes
    ]
    if not kernel_path(kinds, kind, pos):
        return {
            "seen": torch.zeros((key_capacity,), dtype=torch.bool, device=device),
            "planes": planes,
        }
    if not compact32:
        agg = planes[slices[pos].start]
        agg.fill_(IDENTITY[agg.dtype][kind])
    if sentinel_leaf is not None:
        if kinds[sentinel_leaf] != STR:
            raise ValueError(
                f"sentinel_leaf must name a STR leaf (interned ids >= 0); "
                f"leaf {sentinel_leaf} is {kinds[sentinel_leaf]!r}"
            )
        planes[slices[sentinel_leaf].start].fill_(-1)
    return {
        "seen": torch.zeros((key_capacity,), dtype=torch.bool, device=device),
        "planes": planes,
    }


def grow_rolling_state(
    state: dict,
    key_capacity: int,
    kinds: List[str],
    kind: str,
    pos: int,
    sentinel_leaf: Optional[int] = None,
    compact32: bool = False,
) -> dict:
    """The same state at a larger ``key_capacity``: interned key ids are
    stable, so every old row is copied to the head of its new plane and
    the new rows start fresh."""
    device = state["seen"].device
    new = init_rolling_state(key_capacity, kinds, kind, pos, sentinel_leaf,
                             device, compact32)
    k = state["seen"].shape[0]
    new["seen"][:k] = state["seen"]
    for dst, src in zip(new["planes"], state["planes"]):
        dst[:k] = src
    return new


def state_from_jax_numpy(
    state_np: dict,
    kinds: List[str],
    kind: str,
    rolling_pos: int,
    sentinel_leaf: Optional[int],
    device: torch.device,
    compact32: bool = False,
) -> dict:
    """Turn the reference package's rolling state (``{"seen": bool[K],
    "planes": [...]}`` as numpy arrays, tpustream/ops/rolling.py
    init_rolling_state) into this module's state for a rolling ``kind``
    over leaf ``rolling_pos``.

    The general path (``max_by``, ``min_by``, a user reduce, and
    max/min/sum of a string or boolean leaf) keeps the reference's
    layout, so its planes and ``seen`` are copied as they are. On the
    kernel path the reference leaves the aggregated plane at 0 for a
    never-seen key and tests occupancy instead; here such rows take the
    identity, and an int64 aggregated leaf's two int32 words (low, high)
    become one int64 plane. With a ``sentinel_leaf`` the reference never
    updates ``seen`` (the sentinel plane is the occupancy test), so
    occupancy is read from that plane (``>= 0``) and ``seen`` is rebuilt
    from it. With ``compact32`` the aggregated leaf's 32-bit plane is the
    reference's as it is.
    """
    slices = leaf_plane_slices(kinds, _compact_leaves(kinds, rolling_pos,
                                                      compact32))
    planes = [np.array(p) for p in state_np["planes"]]
    if not kernel_path(kinds, kind, rolling_pos):
        seen = np.array(state_np["seen"], dtype=bool)
    elif sentinel_leaf is not None:
        seen = planes[slices[sentinel_leaf].start] >= 0
    else:
        seen = np.array(state_np["seen"], dtype=bool)
    if kernel_path(kinds, kind, rolling_pos) and not compact32:
        words = slices[rolling_pos]
        if kinds[rolling_pos] == I64:
            lo, hi = planes[words.start], planes[words.start + 1]
            agg = (lo.astype(np.int64) & 0xFFFFFFFF) | (hi.astype(np.int64) << 32)
            planes[words] = [agg]
        else:
            agg = planes[words.start]
        agg[~seen] = IDENTITY[torch.from_numpy(agg[:0]).dtype][kind]
    return {
        "seen": torch.from_numpy(seen).to(device),
        "planes": [torch.from_numpy(p).to(device) for p in planes],
    }


def rolling_step(
    state: dict,
    keys: torch.Tensor,
    cols: Tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    kinds: List[str],
    rolling_kind: str,
    rolling_pos: int,
    key_col: Optional[int] = None,
    key_emit: Optional[Callable] = None,
    sentinel_leaf: Optional[int] = None,
    bad_keys: Optional[torch.Tensor] = None,
    compact32: bool = False,
) -> Tuple[dict, Tuple[torch.Tensor, ...]]:
    """One batch through a rolling max/min/sum of leaf ``rolling_pos``.

    ``keys`` are int32 key ids (``< K``), ``cols`` the record leaves,
    ``valid`` the rows that carry records. Returns ``(state, emissions)``
    with the emission columns in ARRIVAL order (rows that are not valid
    carry unspecified values). The state's planes are updated in place
    and the same dict is returned.

    ``key_col``/``key_emit``: the keyed column, emitted straight from the
    key ids (``key_emit(keys)``) and never stored. ``sentinel_leaf``: a
    keep-first STR leaf whose plane doubles as the occupancy test.
    ``bad_keys``: a one-element int32 device counter that gains the
    number of valid rows whose key is ``>= K`` (see
    :func:`seq_rolling.seq_rolling_reduce`; required on CUDA). A step
    that counts any has void emissions and state: the caller must fail
    it. ``compact32``: the aggregated leaf's plane is 32-bit (see the
    module's note).
    """
    kind, pos = rolling_kind, rolling_pos
    _check_kind(kinds, kind, pos)
    planes = state["planes"]
    slices = plane_layout(kinds, kind, pos, compact32)[1]
    if key_col is not None and (key_emit is None or key_col == pos):
        key_col = None  # aggregating the keyed column: not key-invariant
    if sentinel_leaf is not None and (
        kinds[sentinel_leaf] != STR or sentinel_leaf in (pos, key_col)
    ):
        sentinel_leaf = None
    n = keys.shape[0]
    kid = torch.where(valid, keys.to(torch.int32), -1)
    # out-of-range keys are counted by the kernel; clamped here so that
    # no gather or scatter leaves the planes before the caller fails
    safe = kid.clamp(0, state["seen"].shape[0] - 1).long()

    def gather_leaf(i):
        words = [p[safe] for p in planes[slices[i]]]
        return unpack_words(words, [kinds[i]])[0]

    keep = [i for i in range(len(kinds)) if i != pos and i != key_col]
    stored_keep = [gather_leaf(i) for i in keep]
    if sentinel_leaf is not None:
        seen_rows = (stored_keep[keep.index(sentinel_leaf)] >= 0) & valid
    else:
        seen_rows = state["seen"][safe] & valid

    # the aggregated column: one kernel launch folds the batch into its
    # plane in arrival order and returns every row's running aggregate
    agg_plane = stored_plane = planes[slices[pos].start]
    if compact32:
        # the 32-bit words widened to 64 bits, never-seen keys at the
        # identity: the kernel combines stored value and prefix in 64
        # bits, as the reference does
        wide = TORCH_DTYPES[kinds[pos]]
        occupied = (planes[slices[sentinel_leaf].start] >= 0
                    if sentinel_leaf is not None else state["seen"])
        agg_plane = torch.where(occupied, stored_plane.to(wide),
                                IDENTITY[wide][kind])
    # a step of one row is a batch_size of 1 (the Runner never steps one
    # row alone otherwise): the reference's step has no scan there and
    # copies a new key's value
    new_rows = valid & ~seen_rows
    emis_agg = seq_rolling_reduce(
        agg_plane, kid, cols[pos].to(agg_plane.dtype).contiguous(), kind,
        bad_keys=bad_keys, fresh=new_rows if n == 1 else None,
    )

    # keep-first leaves change only for keys never seen before; a warm
    # key space skips the first-row search and the plane writes
    keep_emis = stored_keep
    if bool(new_rows.any()):
        rows = torch.arange(n, device=keys.device)
        # each key's first row in this batch: invalid rows offer n, the
        # scatter's initial value, so they never win
        first = torch.full((agg_plane.shape[0],), n, dtype=torch.int64,
                           device=keys.device)
        first.scatter_reduce_(0, safe, torch.where(valid, rows, n), "amin")
        first_row = torch.where(valid, first[safe], rows)
        is_first_new = new_rows & (first_row == rows)
        new_keys = safe[is_first_new]
        keep_emis = []
        for i, stored in zip(keep, stored_keep):
            first_vals = cols[i][first_row]
            keep_emis.append(torch.where(seen_rows, stored, first_vals))
            for p, w in zip(planes[slices[i]], pack_words([first_vals], [kinds[i]])):
                p[new_keys] = w[is_first_new]
        if sentinel_leaf is None:
            state["seen"][new_keys] = True
    if compact32:
        # back to 32 bits (float64 rounds, int64 wraps); a key still
        # never seen keeps 0, the reference's value
        occupied = (planes[slices[sentinel_leaf].start] >= 0
                    if sentinel_leaf is not None else state["seen"])
        # (a float32 subnormal flushed, as XLA's conversion flushes it)
        stored_plane.copy_(flush_subnormal(
            torch.where(occupied, agg_plane, 0).to(stored_plane.dtype)))

    emis = []
    kj = 0
    for i in range(len(kinds)):
        if i == pos:
            emis.append(emis_agg)
        elif i == key_col:
            emis.append(key_emit(kid))
        else:
            emis.append(keep_emis[kj])
            kj += 1
    return state, tuple(emis)


def rolling_step_general(
    state: dict,
    keys: torch.Tensor,
    cols: Tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    combine: Callable,
    kinds: List[str],
    bad_keys: Optional[torch.Tensor] = None,
) -> Tuple[dict, Tuple[torch.Tensor, ...]]:
    """One batch through a rolling aggregate with any associative
    ``combine(a_leaves, b_leaves) -> leaves`` (``max_by``, ``min_by``, a
    user reduce), the reference's general path.

    Returns ``(state, emissions)`` with the emission columns in ARRIVAL
    order, each of its leaf kind's dtype (rows that are not valid carry
    unspecified values); the planes and ``seen`` are updated in place.
    ``bad_keys`` (a one-element int32 counter) gains the valid rows
    whose key id is outside ``[0, K)``; those rows fold into nothing,
    and a step that counts any is void."""
    planes, seen_plane = state["planes"], state["seen"]
    k = seen_plane.shape[0]
    n = keys.shape[0]
    kid = keys.to(torch.int32)
    bad = valid & ((kid < 0) | (kid >= k))
    if bad_keys is not None:
        bad_keys += bad.sum(dtype=torch.int32)
    valid = valid & ~bad
    perm, sk, sv, seg_starts = sort_by_key(kid, valid, max_key=k)
    # within-batch inclusive per-key fold, arrival order kept by the
    # stable sort
    prefix = segmented_scan(tuple(c[perm] for c in cols), seg_starts, combine)
    safe = torch.where(sv, sk, 0).clamp(0, k - 1).to(torch.int64)
    seen = seen_plane[safe] & sv
    stored = tuple(unpack_words([p[safe] for p in planes], kinds))
    combined = combine(stored, prefix)
    emis_sorted = [
        torch.broadcast_to(torch.where(seen, c, p), (n,))
        for c, p in zip(combined, prefix)
    ]
    # one tail per key carries the key's new value into the planes
    rows = (segment_tails(seg_starts) & sv).nonzero().squeeze(1)
    tail_keys = safe[rows]
    for p, w in zip(planes, pack_words([e[rows] for e in emis_sorted], kinds)):
        p[tail_keys] = w.to(p.dtype)
    seen_plane[tail_keys] = True
    inv = inverse_permutation(perm)
    return state, tuple(
        e[inv].to(TORCH_DTYPES[kd]) for e, kd in zip(emis_sorted, kinds)
    )
