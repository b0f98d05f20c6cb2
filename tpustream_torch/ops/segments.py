"""Segmented (per-key) batch combines via sort + associative scan (PyTorch).

Counterpart of tpustream/ops/segments.py: stable-sort records by key,
run a segmented scan with the user combiner, and scatter segment tails
into dense keyed state. Arrival order within a key is preserved by the
stable sort, so "first record wins" semantics hold exactly.

:func:`associative_scan` combines in ``jax.lax.associative_scan``'s own
order (neighbouring pairs, recursion on the pairs, then the even
elements), so a float combiner gives the reference's bits, not only
values within a tolerance. Combiners must be associative, the contract
Flink imposes on ``AggregateFunction.merge``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..arith import plus_zero


def sort_by_key(keys: torch.Tensor, valid: torch.Tensor, max_key: int = None):
    """Stable order: by key id, invalid rows last, ties by arrival position.

    Returns ``(perm, sorted_keys, sorted_valid, seg_starts)`` where
    ``seg_starts[i]`` is True at the first row of each key segment. When
    ``max_key`` fits int32 the sort runs on a 32-bit key."""
    n = keys.shape[0]
    if max_key is not None and max_key < 2**31 - 1:
        k32 = torch.where(valid, keys.to(torch.int32), max_key)
        perm = torch.sort(k32, stable=True).indices
    else:
        pos = torch.arange(n, dtype=torch.int64, device=keys.device)
        composite = torch.where(valid, keys.to(torch.int64), 1 << 40) * n + pos
        perm = torch.sort(composite, stable=True).indices
    sk = keys[perm]
    sv = valid[perm]
    seg_starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    seg_starts[1:] = sk[1:] != sk[:-1]
    return perm, sk, sv, seg_starts | ~sv  # invalid rows isolate


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] with len(a) - len(b) in {0, 1}. JAX pads
    each half with zeros and adds them, so a float comes out as XLA's
    ``x + 0.0``: a subnormal or a zero of either sign as +0.0
    (``arith.plus_zero``)."""
    out = torch.empty((a.shape[0] + b.shape[0],) + a.shape[1:],
                      dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return plus_zero(out)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan along dim 0 of a list of equal-length tensors, with
    ``fn(list_a, list_b) -> list`` applied in the combination order of
    ``jax.lax.associative_scan``."""
    elems = list(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def segmented_scan(
    values: Sequence[torch.Tensor],
    seg_starts: torch.Tensor,
    combine: Callable,
) -> tuple:
    """Inclusive per-segment scan of a tuple of [B] leaves;
    ``combine(a_tuple, b_tuple) -> tuple``."""
    def comb(a, b):
        fa, va = a[0], tuple(a[1:])
        fb, vb = b[0], tuple(b[1:])
        merged = combine(va, vb)
        out = [torch.where(fb, m, x) for m, x in zip(merged, vb)]
        return [fa & fb] + out

    scanned = associative_scan(comb, [~seg_starts] + list(values))
    return tuple(scanned[1:])


def segment_tails(seg_starts: torch.Tensor) -> torch.Tensor:
    """Mask of the last row of each segment."""
    tails = torch.ones_like(seg_starts)
    tails[:-1] = seg_starts[1:]
    return tails


def segment_ranks(seg_starts: torch.Tensor) -> torch.Tensor:
    """0-based rank of each row within its segment (int32), via a cummax
    of the segment-start positions."""
    n = seg_starts.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=seg_starts.device)
    seg_first = torch.cummax(torch.where(seg_starts, pos, 0), dim=0).values
    return pos - seg_first


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``inv`` with ``inv[perm[i]] == i`` (int64): gathering a sorted
    column with it puts its rows back in arrival order."""
    n = perm.shape[0]
    inv = torch.empty(n, dtype=torch.int64, device=perm.device)
    inv.scatter_(0, perm.to(torch.int64),
                 torch.arange(n, dtype=torch.int64, device=perm.device))
    return inv
