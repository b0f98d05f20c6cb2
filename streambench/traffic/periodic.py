"""Periodic polls from a fixed population of sources.

Every one of ``keys`` sources sends ``lines_per_poll`` lines (``sub``
0, 1, ...) together once every ``interval_s`` seconds of event time,
the sources spread evenly over the interval in an order drawn from the
seed, as a poller that walks its target list does. Each poll's time is
moved back by 0 to ``jitter_s`` seconds, drawn per line, so the stream
is out of order by up to that much. ``values`` says how each line's
value is drawn:

- ``{"dist": "uniform", "lo": a, "hi": b}``: ints ``a..b``;
- ``{"dist": "loguniform", "lo": a, "hi": b}``: ``floor(exp(u))``, ``u``
  uniform over ``[log a, log b)``;
- with ``"alert_every": m, "alert_lo": c, "alert_hi": d``, sources whose
  number is a multiple of ``m`` draw uniform ints ``c..d`` instead.

One interval of lines is drawn and rendered once, as blocks of the
cell's batch size; a later interval replays those blocks with each
line's time moved on by whole intervals, so set-up does not grow with
the run's length. With ``"redeal_keys": true`` (a key part of fixed
width), each later interval also deals each block's sources to its
lines anew: the keys of a block are rolled down by a number of polls
drawn from the seed, the interval and the block, so a source's value,
and whether it alerts, changes from interval to interval while every
block keeps its times, its values and its set of sources. The seed
draws the order, the jitter, the values and the rolls; every seed gives
the same polls and lines a block, from the same distributions, in
another order.
"""

from __future__ import annotations

import numpy as np

from streambench.lines import render


def draw_values(spec: dict, key: np.ndarray, rng) -> np.ndarray:
    n = key.size
    if spec["dist"] == "uniform":
        v = rng.integers(int(spec["lo"]), int(spec["hi"]) + 1, n)
    elif spec["dist"] == "loguniform":
        lo, hi = np.log(float(spec["lo"])), np.log(float(spec["hi"]))
        v = np.floor(np.exp(rng.uniform(lo, hi, n))).astype(np.int64)
        v = np.clip(v, int(spec["lo"]), int(spec["hi"]) - 1)
    else:
        raise ValueError(f"unknown value distribution {spec['dist']!r}")
    every = spec.get("alert_every")
    if every:
        alert = key % int(every) == 0
        low = rng.integers(int(spec["alert_lo"]), int(spec["alert_hi"]) + 1, n)
        v = np.where(alert, low, v)
    return v.astype(np.int64)


class Traffic:
    """The cell's stream as byte blocks of ``batch_size`` lines
    (:meth:`block`) and as the event arrays behind them
    (:meth:`events`)."""

    def __init__(self, params: dict, line: list, batch_size: int, seed: int):
        self.keys = int(params["keys"])
        self.lines_per_poll = int(params["lines_per_poll"])
        self.interval_s = int(params["interval_s"])
        self.jitter_s = int(params["jitter_s"])
        self.t0 = int(params["t0"])
        self.batch_size = int(batch_size)
        pool = self.keys * self.lines_per_poll  # lines of one interval
        if pool % self.batch_size:
            raise ValueError(
                f"an interval's {pool} lines are not whole blocks of "
                f"{self.batch_size}")
        self.pool_lines = pool
        self.pool_blocks = pool // self.batch_size
        self.seed = seed
        self.redeal = bool(params.get("redeal_keys", False))
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.keys)
        L = self.lines_per_poll
        self.key = np.repeat(order, L).astype(np.int64)
        self.sub = np.tile(np.arange(L, dtype=np.int64), self.keys)
        slot = (np.arange(self.keys, dtype=np.int64) * self.interval_s) // self.keys
        self.ts_rel = np.repeat(slot, L) - rng.integers(0, self.jitter_s + 1, pool)
        self.value = draw_values(params["values"], self.key, rng)
        B = self.batch_size
        self.pool = [
            render(line, {"ts": self.t0 + self.ts_rel[b * B:(b + 1) * B],
                          "key": self.key[b * B:(b + 1) * B],
                          "sub": self.sub[b * B:(b + 1) * B],
                          "value": self.value[b * B:(b + 1) * B]})
            for b in range(self.pool_blocks)
        ]
        if self.redeal and B % L:
            raise ValueError("keys are dealt anew in whole polls")

    def roll(self, i: int) -> int:
        """Lines by which block ``i``'s keys are rolled down from the
        pool's: 0 in the first interval and without ``redeal_keys``."""
        b, k = i % self.pool_blocks, i // self.pool_blocks
        if not self.redeal or k == 0:
            return 0
        polls = self.batch_size // self.lines_per_poll
        rng = np.random.default_rng((self.seed, k, b))
        return int(rng.integers(polls)) * self.lines_per_poll

    def block(self, i: int) -> bytes:
        """The bytes of block ``i`` of the stream (0, 1, ...)."""
        b, k = i % self.pool_blocks, i // self.pool_blocks
        return self.pool[b].shifted(k * self.interval_s, self.roll(i))

    def events(self, n_blocks: int) -> dict:
        """``ts`` (epoch s), ``key``, ``sub`` and ``value`` of every line
        of blocks ``0 .. n_blocks - 1``, in stream order."""
        B = self.batch_size
        g = np.arange(n_blocks * B, dtype=np.int64)
        p, k = g % self.pool_lines, g // self.pool_lines
        rolls = np.array([self.roll(i) for i in range(n_blocks)], np.int64)
        kp = (p // B) * B + (g % B - np.repeat(rolls, B)) % B
        return {"ts": self.t0 + k * self.interval_s + self.ts_rel[p],
                "key": self.key[kp], "sub": self.sub[p],
                "value": self.value[p]}

    def block_keys(self, i: int) -> np.ndarray:
        """The source numbers of block ``i``'s lines."""
        B = self.batch_size
        j = np.arange(B)
        return self.key[(i % self.pool_blocks) * B + (j - self.roll(i)) % B]
