"""Keyed rolling aggregates max/min/sum (PyTorch).

Implements Flink's rolling-aggregate semantics exactly as the golden
transcript proves them (reference chapter2/.../ComputeCpuMax.java:26,
chapter2/README.md:52-66): EVERY input record emits the current
aggregate for its key, only the aggregated field updates, and every
other field keeps the value from the key's FIRST-ever record.

Counterpart of the commutative path of tpustream/ops/rolling.py
(``rolling_step`` -> ``_rolling_step_commutative``). The aggregated
column goes through one call of the keyed-reduce kernel
(``ops/seq_rolling.py``), which does the reference's sort, segmented
scan, stored-value gather and tail scatter and yields the emissions in
arrival order, so nothing is un-permuted here. The keep-first leaves, the key
column and the occupancy test stay plain tensor ops, as they are plain
XLA ops in the reference.

State is dense per-key planes (ops/wordplanes.py) plus a ``seen``
bitmap. Unlike the reference, the aggregated plane starts at the op's
identity (``seq_rolling.IDENTITY``) rather than 0, so the kernel's fold
needs no occupancy test; :func:`state_from_jax_numpy` converts.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..records import F64, STR
from .seq_rolling import IDENTITY, seq_rolling_reduce
from .wordplanes import leaf_plane_slices, pack_words, plane_dtypes, unpack_words

COMMUTATIVE = ("max", "min", "sum")


def _check_kind(kinds: Sequence[str], kind: str, pos: int) -> None:
    if kind not in COMMUTATIVE:
        raise NotImplementedError(
            f"rolling {kind!r} is not ported to the PyTorch runtime yet: "
            f"only the commutative field aggregates {COMMUTATIVE} are "
            f"(max_by/min_by and a user reduce need the general rolling path)"
        )
    if kinds[pos] != F64:
        raise NotImplementedError(
            f"rolling {kind} over a {kinds[pos]!r} field is not ported yet: "
            f"the kernel aggregates float64 fields only"
        )


def init_rolling_state(
    key_capacity: int,
    kinds: List[str],
    kind: str,
    pos: int,
    sentinel_leaf: Optional[int] = None,
    device: torch.device = torch.device("cpu"),
) -> dict:
    """Fresh state for ``key_capacity`` keys: the aggregated leaf's plane
    at the identity of ``kind``, a ``sentinel_leaf`` (a keep-first STR
    leaf whose plane doubles as the occupancy test; interned ids are
    >= 0) at -1, every other plane at 0."""
    _check_kind(kinds, kind, pos)
    planes = [
        torch.zeros((key_capacity,), dtype=dt, device=device)
        for dt in plane_dtypes(kinds)
    ]
    slices = leaf_plane_slices(kinds)
    planes[slices[pos].start].fill_(IDENTITY[kind])
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
) -> dict:
    """The same state at a larger ``key_capacity``: interned key ids are
    stable, so every old row is copied to the head of its new plane and
    the new rows start fresh."""
    device = state["seen"].device
    new = init_rolling_state(key_capacity, kinds, kind, pos, sentinel_leaf, device)
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
) -> dict:
    """Turn the reference package's rolling state (``{"seen": bool[K],
    "planes": [...]}`` as numpy arrays, tpustream/ops/rolling.py
    init_rolling_state) into this module's state for a rolling ``kind``
    over leaf ``rolling_pos``.

    The reference leaves the aggregated plane at 0 for a never-seen key
    and tests occupancy instead; here such rows take the identity. With
    a ``sentinel_leaf`` the reference never updates ``seen`` (the
    sentinel plane is the occupancy test), so occupancy is read from that
    plane (``>= 0``) and ``seen`` is rebuilt from it.
    """
    _check_kind(kinds, kind, rolling_pos)
    slices = leaf_plane_slices(kinds)
    planes = [np.array(p) for p in state_np["planes"]]
    if sentinel_leaf is not None:
        seen = planes[slices[sentinel_leaf].start] >= 0
    else:
        seen = np.array(state_np["seen"], dtype=bool)
    agg = planes[slices[rolling_pos].start]
    agg[~seen] = IDENTITY[kind]
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
    it.
    """
    kind, pos = rolling_kind, rolling_pos
    _check_kind(kinds, kind, pos)
    planes = state["planes"]
    slices = leaf_plane_slices(kinds)
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
    agg_plane = planes[slices[pos].start]
    emis_agg = seq_rolling_reduce(
        agg_plane, kid, cols[pos].to(agg_plane.dtype).contiguous(), kind,
        bad_keys=bad_keys,
    )

    # keep-first leaves change only for keys never seen before; a warm
    # key space skips the first-row search and the plane writes
    keep_emis = stored_keep
    new_rows = valid & ~seen_rows
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
