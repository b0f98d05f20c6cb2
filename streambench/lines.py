"""Render generated events as the text lines a job reads, with numpy.

A configuration's ``line`` is a list of parts, each a dict:

- ``{"part": "text", "text": " www."}``: constant bytes;
- ``{"part": "time", "format": "epoch_s"}``: the event time in epoch
  seconds, 10 digits; ``{"part": "time", "format": "iso",
  "utc_offset_h": 8}``: the local datetime ``YYYY-MM-DDTHH:MM:SS``;
- ``{"part": "key" | "sub" | "value", "format": "int"}``: the column in
  decimal, with ``"width"`` zero-padded to that many digits, with
  ``"shift"`` and ``"mask"`` of ``(v >> shift) & mask``;
  ``"format": "centi"`` renders ``v / 100`` as Python's ``repr`` of it
  does (``12.34``, ``12.3``, ``12.0``).

Each part fills fixed columns of a byte matrix, left-aligned, with zero
bytes after it; the line is the matrix row without its zero bytes. The
time part has a fixed width, and so has a key part with a ``"width"``:
:class:`Block` rewrites them in place when a block is replayed at a
later time, and with its keys dealt to other lines.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

ISO_WIDTH = 19
EPOCH_WIDTH = 10


def _ndigits(v: np.ndarray) -> np.ndarray:
    n = np.ones(v.shape, np.int64)
    p = 10
    while True:
        more = v >= p
        if not more.any():
            return n
        n += more
        p *= 10


def decimal(v: np.ndarray, width: int = 0) -> np.ndarray:
    """``[n, w]`` ASCII digits of the non-negative ints ``v``,
    left-aligned, zero bytes after them; ``width`` > 0 pads with ``0``
    digits to exactly that many."""
    v = np.asarray(v, np.int64)
    if v.size and v.min() < 0:
        raise ValueError("decimal() renders non-negative ints only")
    n = np.full(v.shape, width, np.int64) if width else _ndigits(v)
    if width and v.size and int(_ndigits(v).max()) > width:
        raise ValueError(f"a value has more than {width} digits")
    w = int(n.max()) if v.size else 1
    pos = np.arange(w)
    exp = n[:, None] - 1 - pos[None, :]
    digits = (v[:, None] // 10 ** np.maximum(exp, 0)) % 10
    return np.where(exp >= 0, 48 + digits, 0).astype(np.uint8)


def centi(v: np.ndarray) -> np.ndarray:
    """``v / 100`` as Python's ``repr`` prints it, for ints ``v`` >= 0:
    ``1234 -> 12.34``, ``1230 -> 12.3``, ``1200 -> 12.0``."""
    v = np.asarray(v, np.int64)
    whole = decimal(v // 100)
    frac = v % 100
    one = frac % 10 == 0  # one digit after the point
    f = np.empty((v.size, 2), np.uint8)
    f[:, 0] = 48 + frac // 10
    f[:, 1] = np.where(one, 0, 48 + frac % 10)
    dot = np.full((v.size, 1), ord("."), np.uint8)
    return np.concatenate([whole, dot, f], axis=1)


def iso_local(ts: np.ndarray, utc_offset_h: int) -> np.ndarray:
    """``[n, 19]`` bytes of each epoch second as a local
    ``YYYY-MM-DDTHH:MM:SS`` at ``utc_offset_h``; one ``datetime`` call a
    distinct second."""
    ts = np.asarray(ts, np.int64)
    uniq, inv = np.unique(ts, return_inverse=True)
    tz = datetime.timezone(datetime.timedelta(hours=utc_offset_h))
    table = np.frombuffer(b"".join(
        datetime.datetime.fromtimestamp(int(t), tz).strftime(
            "%Y-%m-%dT%H:%M:%S").encode() for t in uniq),
        np.uint8).reshape(uniq.size, ISO_WIDTH)
    return table[inv.reshape(-1)]


def time_bytes(ts: np.ndarray, part: dict) -> np.ndarray:
    if part["format"] == "iso":
        return iso_local(ts, int(part["utc_offset_h"]))
    if part["format"] == "epoch_s":
        return decimal(ts, EPOCH_WIDTH)
    raise ValueError(f"unknown time format {part['format']!r}")


def _column_bytes(col: np.ndarray, part: dict) -> np.ndarray:
    v = np.asarray(col, np.int64)
    if "shift" in part or "mask" in part:
        v = (v >> int(part.get("shift", 0))) & int(part.get("mask", -1))
    fmt = part.get("format", "int")
    if fmt == "int":
        return decimal(v, int(part.get("width", 0)))
    if fmt == "centi":
        return centi(v)
    raise ValueError(f"unknown column format {fmt!r}")


class Block:
    """One rendered block: ``buf`` (uint8, newline-terminated lines),
    each line's time field at ``time_pos``, and, where the key part has
    a fixed width, each line's key digits at ``key_pos``.
    :meth:`shifted` gives the bytes with every time moved on by some
    seconds, rewriting only the digit columns that change, and the keys
    rolled down by some lines."""

    def __init__(self, buf: np.ndarray, time_pos: np.ndarray,
                 ts: np.ndarray, time_part: dict,
                 key_pos: Optional[np.ndarray] = None,
                 key_digits: Optional[np.ndarray] = None):
        self.buf = buf
        self.time_pos = time_pos
        self.time_part = time_part
        self.ts_uniq, self.inv = np.unique(ts, return_inverse=True)
        self.inv = self.inv.reshape(-1)
        self.table = time_bytes(self.ts_uniq, time_part)  # as in buf now
        self.key_digits = key_digits  # [lines, width], as rendered
        self.key_at = (None if key_pos is None else
                       key_pos[:, None] + np.arange(key_digits.shape[1]))
        self.roll = 0  # the keys in buf now: key_digits rolled so far

    def shifted(self, seconds: int, roll: int = 0) -> bytes:
        """The block's bytes with every line's time ``seconds`` later
        than rendered, and line ``j``'s key the rendered key of line
        ``j - roll`` (modulo the block's lines)."""
        table = time_bytes(self.ts_uniq + seconds, self.time_part)
        for j in np.flatnonzero((table != self.table).any(axis=0)):
            self.buf[self.time_pos + j] = table[self.inv, j]
        self.table = table
        if roll != self.roll:
            if self.key_at is None:
                raise ValueError("keys are dealt anew only where the key "
                                 "part has a fixed width")
            self.buf[self.key_at] = np.roll(self.key_digits, roll, axis=0)
            self.roll = roll
        return self.buf.tobytes()


def render(parts: list, cols: dict) -> Block:
    """Lines of ``parts`` over the columns ``cols`` (``ts``, ``key``,
    ``sub``, ``value``: int64 arrays of one length)."""
    n = len(cols["ts"])
    mats, time_slot, time_part, key_slot = [], None, None, None
    for part in parts:
        kind = part["part"]
        if kind == "text":
            t = np.frombuffer(part["text"].encode(), np.uint8)
            mats.append(np.broadcast_to(t, (n, t.size)))
        elif kind == "time":
            if time_part is not None:
                raise ValueError("a line has one time part")
            time_slot, time_part = len(mats), part
            mats.append(time_bytes(cols["ts"], part))
        elif kind in ("key", "sub", "value"):
            if kind == "key":
                key_slot = len(mats) if part.get("width") else None
            mats.append(_column_bytes(cols[kind], part))
        else:
            raise ValueError(f"unknown line part {kind!r}")
    if time_part is None:
        raise ValueError("a line needs a time part")
    mat = np.concatenate(mats, axis=1)
    keep = mat != 0
    lengths = keep.sum(axis=1)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])

    def position(slot: int) -> np.ndarray:
        before = sum(m.shape[1] for m in mats[:slot])
        return starts + keep[:, :before].sum(axis=1)

    key_pos = key_digits = None
    if key_slot is not None and sum(p["part"] == "key" for p in parts) == 1:
        key_pos, key_digits = position(key_slot), mats[key_slot].copy()
    return Block(mat[keep], position(time_slot), np.asarray(cols["ts"]),
                 time_part, key_pos, key_digits)
