"""Keyed record exchange: the keyBy shuffle as an all-to-all.

Counterpart of tpustream/parallel/exchange.py, in torch ops. Per shard:
bucket the local records by destination ``key % n_shards`` into a
fixed-capacity ``[n_shards, capacity]`` send buffer (a stable sort by
destination, then the rank within the bucket), then one all-to-all per
column moves every bucket to its owner (:meth:`Mesh.all_to_all`). Fixed
capacity keeps the shapes, and so the receive layout, the reference's;
overflow is counted, never silently dropped (SURVEY.md §2.3).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from .mesh import Mesh


def exchange_capacity(
    batch_size: int, n_shards: int, capacity_factor: Optional[float] = None
) -> int:
    """Per-destination send-buffer rows for the keyBy all-to-all.

    ``None`` sizes the buffer for the loss-free worst case (every local
    record to one destination: the whole local batch); a factor shrinks
    it toward the uniform-keys expectation ``local_b / shards``, trading
    memory for counted overflow. One definition, so the sharded programs
    and the obs gauges report the same number."""
    local_b = batch_size // n_shards
    if capacity_factor is None:
        return local_b
    return min(local_b, max(1, math.ceil(local_b / n_shards * capacity_factor)))


# kind -> bytes per element of the post-exchange staging columns
# (STR columns travel as interned int32 ids)
_KIND_ITEMSIZE = {"f64": 8, "i64": 8, "bool": 1, "str": 4}


def exchange_buffer_bytes(n_shards: int, capacity: int, col_kinds) -> int:
    """Bytes the keyBy all-to-all stages per step and per shard: one
    ``[n_shards * capacity]`` post-exchange buffer per record column,
    plus the int64 timestamps and the bool valid mask (shared with the
    obs/memory.py gauge)."""
    rows = n_shards * capacity
    per_row = sum(_KIND_ITEMSIZE.get(k, 8) for k in col_kinds)
    return rows * (per_row + 8 + 1)  # + ts (int64) + valid (bool)


def exchange_by_key(
    cols: List[torch.Tensor],
    valid: torch.Tensor,
    ts: torch.Tensor,
    keys: torch.Tensor,
    n_shards: int,
    capacity: int,
    mesh: Mesh,
    shard: int,
):
    """Route shard ``shard``'s records to their key-owner shard.

    Returns ``(cols', valid', ts', overflow)`` with a leading dimension of
    ``n_shards * capacity``: the records this shard receives, source
    shard by source shard, each source's in its arrival order, then its
    unused rows (invalid, zero). ``overflow`` (int64, 0-d) counts the
    valid records that found their bucket full."""
    b = valid.shape[0]
    dev = valid.device
    dest = torch.where(valid, keys.to(torch.int32) % n_shards,
                       torch.tensor(n_shards, dtype=torch.int32, device=dev))
    pos = torch.arange(b, dtype=torch.int64, device=dev)
    perm = torch.sort(dest, stable=True).indices
    dest_s = dest[perm].to(torch.int64)
    valid_s = valid[perm]
    seg_starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            dest_s[1:] != dest_s[:-1]])
    # the first row of each bucket, carried forward (a max-scan)
    seg_first = torch.cummax(torch.where(seg_starts, pos, 0), dim=0).values
    rank = pos - seg_first
    fits = valid_s & (rank < capacity)
    overflow = (valid_s & ~fits).sum(dtype=torch.int64)
    rows = n_shards * capacity
    # rows that do not fit go to a trailing sink row (the reference's
    # mode="drop": an out-of-range index would poison a CUDA context)
    send_idx = torch.where(fits, dest_s * capacity + rank,
                           torch.tensor(rows, device=dev))

    def scatter(col):
        buf = torch.zeros((rows + 1,) + tuple(col.shape[1:]), dtype=col.dtype,
                          device=dev)
        buf[send_idx] = col[perm]
        return buf[:rows].reshape((n_shards, capacity) + tuple(col.shape[1:]))

    def a2a(x):
        return mesh.all_to_all(shard, x).reshape(
            (rows,) + tuple(x.shape[2:]))

    send_valid = torch.zeros(rows + 1, dtype=torch.bool, device=dev)
    send_valid[send_idx] = fits
    out_cols = [a2a(scatter(c)) for c in cols]
    out_ts = a2a(scatter(ts))
    out_valid = a2a(send_valid[:rows].reshape(n_shards, capacity))
    return out_cols, out_valid, out_ts, overflow
