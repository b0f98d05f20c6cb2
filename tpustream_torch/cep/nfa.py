"""Pattern -> dense NFA lowering.

A linear pattern compiles to L *steps* (``times(n)`` stages expand to n
copies). The NFA has states 0..L: state 0 is the always-active start,
state s (1 <= s < L) means "a partial match holding s events", state L
is accepting (matches emit immediately, so it is never stored). Per
step the table records which stage condition gates the transition into
it and whether the edge is strict (``next`` / ``consecutive``) or
relaxed (``followed_by`` / plain ``times``).

The device program (runtime/cep_program.py) keeps ONE register per
non-start state per key — occupancy bit, window-start timestamp, and the
captured event columns — and advances all keys' state vectors in a
single vectorized sweep: the per-event condition bits are gathered
through this table (a one-hot gather over the stage axis), shifted
register planes implement the transition, and the whole advance is a
handful of [B, L]-shaped vector ops per within-batch arrival rank.

``transition_table()`` materializes the classic dense form
``next_state[state, condition_fired]`` for docs/tests; the runtime
consumes the equivalent ``cond_of``/``strict`` vectors directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from .pattern import Pattern


@dataclass
class CompiledPattern:
    pattern: Pattern
    length: int                      # L: total expanded steps
    stage_names: List[str]           # per stage (not per step)
    conds: List[tuple]               # per stage: tuple of ANDed conditions
    stage_of: np.ndarray             # [L] int32: step -> stage index
    cond_of: np.ndarray              # [L] int32: step -> condition row (== stage)
    strict: np.ndarray               # [L] bool: edge INTO step s is strict
    within_ms: Optional[int] = None

    def transition_table(self) -> np.ndarray:
        """Dense ``next_state[state 0..L, cond_fired 0|1] -> state`` with
        -1 for "partial dies" (strict edge missed) and L for accept.
        State s's outgoing edge is step s (0-based step index s)."""
        L = self.length
        t = np.zeros((L + 1, 2), dtype=np.int32)
        for s in range(L):
            t[s, 1] = s + 1                        # condition fired: advance
            # on a miss, state s survives unless its outgoing edge
            # (step s, the edge s -> s+1) is strict; start always survives
            t[s, 0] = -1 if (s > 0 and self.strict[s]) else s
        t[L, 0] = t[L, 1] = L
        return t


def compile_pattern(pattern: Pattern) -> CompiledPattern:
    stages = pattern.stages
    if not stages:
        raise ValueError("empty pattern: call Pattern.begin(name) first")
    names = [s.name for s in stages]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate stage names in pattern: {names}")
    stage_of: List[int] = []
    strict: List[bool] = []
    for si, s in enumerate(stages):
        for rep in range(s.times):
            stage_of.append(si)
            strict.append(s.strict_entry if rep == 0 else s.strict_internal)
    L = len(stage_of)
    if L < 2:
        raise ValueError(
            "single-step patterns are a plain filter — use "
            ".filter(cond) instead of CEP (patterns need >= 2 steps)"
        )
    return CompiledPattern(
        pattern=pattern,
        length=L,
        stage_names=names,
        conds=[tuple(s.conds) for s in stages],
        stage_of=np.asarray(stage_of, dtype=np.int32),
        cond_of=np.asarray(stage_of, dtype=np.int32),
        strict=np.asarray(strict, dtype=bool),
        within_ms=pattern.within_ms,
    )
