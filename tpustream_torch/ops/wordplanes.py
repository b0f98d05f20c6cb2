"""Typed accumulator leaves <-> storage planes (PyTorch).

Keyed state is a list of dense planes, one or two per record leaf, laid
out exactly as the reference package lays them
(tpustream/ops/wordplanes.py): an int64 leaf is stored as TWO int32
planes (lo, hi), a float64 leaf keeps one native float64 plane, and
interned strings and booleans are one int32 plane each. Keeping the
layout lets state move between the two packages plane by plane
(``ops/rolling.py::state_from_jax_numpy``,
``runtime/window_program.py::state_from_jax_numpy``).

``compact32`` is the lossy 32-bit accumulator mode
(``StreamConfig.acc_dtype`` ``"int32"`` or ``"float32"``): a 64-bit leaf
keeps ONE 32-bit plane (int64 wraps mod 2^32, float64 rounds to
float32). A per-leaf sequence restricts it to the leaves a combiner
aggregates (the window programs' and the rolling program's layouts).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..records import BOOL, F64, I64, STR

Compact = Union[bool, Sequence[bool]]

# the torch dtype of each leaf kind (interned strings are int32 ids)
TORCH_DTYPES = {
    F64: torch.float64, I64: torch.int64, STR: torch.int32, BOOL: torch.bool,
}


def _per_leaf(compact32: Compact, kinds: Sequence[str]) -> List[bool]:
    if isinstance(compact32, (list, tuple)):
        if len(compact32) != len(kinds):
            raise ValueError(
                f"per-leaf compact32 has {len(compact32)} entries for "
                f"{len(kinds)} leaf kinds"
            )
        return list(compact32)
    return [bool(compact32)] * len(kinds)


def plane_dtypes(kinds: Sequence[str], compact32: Compact = False) -> List[torch.dtype]:
    """Storage plane dtypes for a leaf-kind list (i64 -> two int32)."""
    out: List[torch.dtype] = []
    for k, c32 in zip(kinds, _per_leaf(compact32, kinds)):
        if k == I64:
            out.extend([torch.int32] if c32 else [torch.int32, torch.int32])
        elif k == F64:
            out.append(torch.float32 if c32 else torch.float64)
        else:  # STR (interned id), BOOL
            out.append(torch.int32)
    return out


def leaf_plane_slices(kinds: Sequence[str], compact32: Compact = False) -> List[slice]:
    """Per-leaf slice into the flat plane list (a non-compact i64 owns
    two planes, everything else one)."""
    out: List[slice] = []
    start = 0
    for k, c32 in zip(kinds, _per_leaf(compact32, kinds)):
        n = 2 if (k == I64 and not c32) else 1
        out.append(slice(start, start + n))
        start += n
    return out


def pack_words(
    cols: Sequence[torch.Tensor], kinds: Sequence[str], compact32: Compact = False
) -> List[torch.Tensor]:
    """Typed tensors -> storage plane tensors (i64 split as lo, hi)."""
    words: List[torch.Tensor] = []
    for col, kind, c32 in zip(cols, kinds, _per_leaf(compact32, kinds)):
        if kind == I64:
            v = col.to(torch.int64)
            if c32:
                words.append(v.to(torch.int32))  # wraps mod 2^32
                continue
            # low word: the bit pattern of the low 32 bits, as int32
            lo = v & 0xFFFFFFFF
            words.append(torch.where(lo >= 2**31, lo - 2**32, lo).to(torch.int32))
            words.append((v >> 32).to(torch.int32))
        elif kind == F64:
            words.append(col.to(torch.float32 if c32 else torch.float64))
        else:  # STR, BOOL
            words.append(col.to(torch.int32))
    return words


def unpack_words(
    words: Sequence[torch.Tensor], kinds: Sequence[str], compact32: Compact = False
) -> List[torch.Tensor]:
    """Inverse of :func:`pack_words`."""
    cols: List[torch.Tensor] = []
    w = 0
    for kind, c32 in zip(kinds, _per_leaf(compact32, kinds)):
        if kind == I64 and not c32:
            lo = words[w].to(torch.int64) & 0xFFFFFFFF
            hi = words[w + 1].to(torch.int64)
            cols.append(lo | (hi << 32))
            w += 2
            continue
        if kind == I64:
            cols.append(words[w].to(torch.int64))
        elif kind == F64:
            cols.append(words[w].to(torch.float64))
        elif kind == BOOL:
            cols.append(words[w].to(torch.bool))
        else:
            cols.append(words[w].to(torch.int32))
        w += 1
    return cols
