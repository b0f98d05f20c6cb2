"""Dead-column elimination for windowed accumulators (PyTorch).

Counterpart of tpustream/ops/liveness.py, which decides on a jaxpr
(``jax.make_jaxpr``). Here the same decisions are made on a torch graph:
:func:`trace` runs the probe once under
``torch.fx.experimental.proxy_tensor.make_fx`` on fake 0-d tensors, one
placeholder per argument. A probe the tracer cannot follow (Python
control flow on a traced value, as ``make_jaxpr`` would also refuse)
raises; nothing falls back to storing every leaf.

* a leaf is LIVE if the post-window chain (finalize + maps/filters, the
  Mbps conversion at reference
  chapter3/.../BandwidthMonitorWithEventTime.java:48-55) reads it, and
  liveness closes over the combiner (fixpoint);
* a combiner output that is the placeholder itself passes its input
  through verbatim, so a ``reduce`` key leaf can be rebuilt from the
  cell index instead of stored;
* an output that is ``aten.add``/``aten.maximum``/``aten.minimum`` of
  exactly the two corresponding placeholders is ``add``/``max``/``min``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Set

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ..arith import reference_arithmetic

_ALGEBRAIC = {
    torch.ops.aten.add.Tensor: "add",
    torch.ops.aten.maximum.default: "max",
    torch.ops.aten.minimum.default: "min",
}


def trace(fn: Callable, dummies: Sequence[torch.Tensor]):
    """``(placeholders, outputs)`` of ``fn``'s graph: the fx nodes of its
    positional arguments and of the values it returns (a tuple)."""
    args = [d.clone() for d in dummies]  # one placeholder per argument
    with reference_arithmetic():
        gm = make_fx(lambda *a: tuple(fn(*a)), tracing_mode="fake")(*args)
    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    (outs,) = next(n for n in nodes if n.op == "output").args
    return placeholders, list(outs)


def _needed(outs) -> Set:
    needed, stack = set(), [o for o in outs if isinstance(o, torch.fx.Node)]
    while stack:
        n = stack.pop()
        if n not in needed:
            needed.add(n)
            stack.extend(n.all_input_nodes)
    return needed


def used_inputs(fn: Callable, dummies: Sequence) -> Set[int]:
    """Indices of ``fn``'s positional args its outputs depend on."""
    placeholders, outs = trace(fn, dummies)
    needed = _needed(outs)
    return {i for i, p in enumerate(placeholders) if p in needed}


def passthrough_outputs(fn: Callable, dummies: Sequence, arity: int) -> List[bool]:
    """For a two-record combiner ``fn(a_leaves..., b_leaves...)``: which
    output positions are literally one of the two corresponding inputs."""
    ph, outs = trace(fn, dummies)
    return [outs[i] is ph[i] or outs[i] is ph[arity + i] for i in range(arity)]


def leaf_algebraic_ops(
    combine_probe: Callable, dummies: Sequence, arity: int
) -> List[str]:
    """Per-output ``"add" | "min" | "max" | "first" | None``: a single
    commutative op on exactly the two corresponding input leaves, or the
    verbatim a-side leaf for ``first``."""
    ph, outs = trace(combine_probe, list(dummies) + list(dummies))
    out: List[str] = []
    for i in range(arity):
        ov, a, b = outs[i], ph[i], ph[arity + i]
        if ov is a:
            out.append("first")
            continue
        op = None
        if isinstance(ov, torch.fx.Node) and ov.op == "call_function":
            name = _ALGEBRAIC.get(ov.target)
            ins = [x for x in ov.args if isinstance(x, torch.fx.Node)]
            if (
                name is not None
                and not ov.kwargs
                and len(ins) == len(ov.args) == 2
                and {id(ins[0]), id(ins[1])} == {id(a), id(b)}
            ):
                op = name
        out.append(op)
    return out


def live_accumulator_leaves(
    result_probe: Callable,
    combine_probe: Callable,
    dummies: Sequence,
    arity: int,
) -> List[bool]:
    """Fixpoint liveness over accumulator leaves.

    ``result_probe(*leaves)`` maps accumulator leaves to everything that
    escapes the window (post-chain outputs + filter predicates).
    ``combine_probe(*a_leaves, *b_leaves)`` is the combiner on leaf pairs.
    """
    live = {i for i in used_inputs(result_probe, dummies) if i < arity}
    ph, outs = trace(combine_probe, list(dummies) + list(dummies))
    deps = []
    for i in range(arity):
        needed = _needed([outs[i]])
        deps.append({j % arity for j, p in enumerate(ph) if p in needed})
    changed = True
    while changed:
        changed = False
        for i in list(live):
            extra = deps[i] - live
            if extra:
                live |= extra
                changed = True
    return [i in live for i in range(arity)]
