"""The reference's arithmetic for user record functions.

Every call into a user record function (device chain ops, window
combiners, the liveness probes) runs under :func:`reference_arithmetic`,
which holds the arithmetic to the reference's bits:

* torch's default float dtype is float64 there, as the reference runs
  with x64 on, so ``int64 * 8.0`` is float64 in both packages;
* a tensor divided by a Python number is multiplied by the number's
  reciprocal: the reference's compiler (XLA) rewrites ``x / c`` into
  ``x * (1/c)``, which differs from an IEEE division in the last bit for
  about one value in eleven (the Mbps map's ``/ 60``);
* subnormal floats are flushed as XLA flushes them. XLA runs its CPU
  computations with flush-to-zero and denormals-are-zero, and the TPU
  keeps no float32 subnormals either: an arithmetic op, a comparison, a
  min/max, a reduction or a float conversion reads a subnormal input as
  a zero of the same sign and writes a subnormal result as a zero of the
  same sign. Data movement keeps the bits.

The op sets below were settled by running each op on subnormal inputs
through a jitted JAX function on the CPU
(``tests/test_torch_subnormal.py::test_subnormal_op_sets_match_jitted_xla``):

* :data:`FLUSHED` (float inputs and float outputs flushed): the
  arithmetic operators and their in-place and reflected forms, division
  and remainders, powers and roots, exponentials and logarithms,
  rounding (``floor``, ``ceil``, ``round``, ``trunc``), ``sign``,
  ``maximum``/``minimum``/``max``/``min``/``clamp``, and the reductions
  and scans (``sum``, ``mean``, ``prod``, ``cumsum``, ...); a
  two-tensor ``maximum``/``minimum`` also orders signed zeros as
  ``jnp.maximum``/``jnp.minimum`` do (+0.0 above -0.0), since a flushed
  pair of subnormals of opposite signs is such a tie;
* :data:`COMPARED` (float inputs flushed, the result is bool): ``==``,
  ``!=``, ``<``, ``<=``, ``>``, ``>=`` in every spelling;
* :data:`CONVERSIONS` (``to``, ``type``, ``float``, ``double``, ...):
  flushed on both sides when the dtype changes and a float is involved;
  a conversion to the same dtype is a copy;
* everything else passes the bits through: indexing, gathers,
  scatter-sets, concatenation, reshapes, clones, ``where``, and the
  sign-bit ops ``neg``, ``abs`` and ``copysign`` (XLA keeps a
  subnormal's bits through all three);
* :data:`IDENTITIES`: XLA's algebraic simplifier removes an op whose
  other operand is a compile-time constant identity, so the op keeps
  the bits of ``x``, a subnormal or a ``-0.0`` included. The set, each
  probed against a jitted JAX function
  (``test_subnormal_identities_match_jitted_xla``): ``x + 0``,
  ``0 + x``, ``x - 0`` (``0`` as ``0.0``, ``-0.0`` or the int ``0``),
  ``x * 1``, ``1 * x``, ``x / 1``, ``x ** 1`` and the clamps with
  infinite or absent bounds pass ``x``; ``x * -1``, ``-1 * x``,
  ``x / -1`` and ``-0.0 - x`` are ``-x``. Only a Python or numpy
  number counts as a constant, and only where the result keeps ``x``'s
  dtype: a ``0.0`` that arrives as a tensor is data, and XLA does not
  remove the op then either. ``0.0 - x`` and ``x * 0.0`` are computed.
* constant chains (``test_subnormal_constant_chains_match_jitted_xla``):
  the simplifier folds a chain of multiplications by constants (a
  division by ``c`` being a multiplication by ``1/c``, rounded in the
  tensor's dtype) or of additions and subtractions of constants into
  one op, the constants combined left to right in the tensor's dtype:
  ``x * c1 * c2`` is ``x * (c1 * c2)``, ``x + c1 - c2`` is
  ``x + (c1 - c2)``, ``(c1 - x) + c2`` is ``(c1 + c2) - x``. That changes
  the rounding of normal values too, and an identity that appears only
  after folding (``x * 0.5 * 2.0``) is removed. A multiplication after
  an addition is not folded (``(x + c1) * c2``), nor is ``c2 - (x +
  c1)``. A tensor made by ``x op c`` remembers ``(x, op, c)`` while
  neither changes in place;
* sorting (``test_subnormal_sort_matches_jitted_xla``): ``sort``,
  ``argsort`` and ``msort`` of a float tensor order the flushed values,
  stably, and move the original bits (``jnp.sort``): a subnormal ties
  with both zeros, ``-0.0`` with ``+0.0``, and NaNs of either sign go
  last (first when descending); the values of a descending sort reverse
  an ascending one, so their ties come last first. ``topk`` orders by
  IEEE's total order with no flush (``lax.top_k``: ``-0.0`` below
  ``+0.0``, subnormals by value, a negative NaN last), ties by index;
* a select of the two values it compares
  (``test_subnormal_select_of_compared_matches_jitted_xla``): XLA
  lowers ``where(a > b, a, b)`` and every other ``where`` of exactly the
  two tensors a ``>`` or ``<`` compared, in either order, to a max/min
  instruction, which returns the flushed operand. A comparison's result
  remembers which two tensors it compared (a copy the simplifier
  removed counts as its source). After ``>=``, ``<=``, ``==`` or
  ``!=``, or of any other values, the select keeps the bits. A select
  between a tensor and the Python number it was compared with is
  copied too (``_select_of_constant``): the bits are kept when the
  comparison can never hold, after ``==``/``!=`` and after
  ``>=``/``<=`` against ±0.0; otherwise the flushed operands are
  selected (ROADMAP 3.4 g).
* ``sqrt`` (and ``x ** 0.5``, which XLA computes as a square root) is
  correctly rounded, as XLA's is: torch's CPU ``sqrt`` and ``pow`` of
  float32 and float64 tensors are one ulp off for about one value in a
  hundred, so on the CPU the root is numpy's. XLA's ``rsqrt`` (which is
  also what it makes of ``1 / sqrt(x)``) is an approximation within one
  ulp that no torch op reproduces; it is not copied.

:func:`flush_subnormal` is the flush itself, for the framework's own
arithmetic outside user functions (the 32-bit narrowing in
``ops/wordplanes.py``, the ordered merge's plain version, the rolling
kernel's plain version). :func:`plus_zero` is XLA's ``x + 0.0``, which
``jax.lax.associative_scan`` applies to every float it interleaves:
``ops/segments.py`` and the rolling kernel copy it.

It sits below both ``ops`` and ``runtime``, which both use it.
"""

from __future__ import annotations

import contextlib
import math
import numbers
import threading

import numpy as np
import torch


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal float (``0 < |x| < finfo.tiny``) replaced
    by a zero of its sign, as XLA's flush-to-zero writes it. NaN, inf,
    zeros, normal floats and non-float tensors are returned as they are.
    Two plain torch ops on any device (it never sets the process's
    denormal mode); a new tensor unless ``x`` is not a float tensor."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    # hardshrink zeroes |x| <= the largest subnormal (as +0.0), copysign
    # puts the sign back; neither is in the flushed sets below, so the
    # flush reads the same under reference_arithmetic's mode
    return torch.copysign(
        torch.nn.functional.hardshrink(x, _largest_subnormal(x.dtype)), x)


def plus_zero(x: torch.Tensor) -> torch.Tensor:
    """``x + 0.0`` as XLA computes it, with denormals-are-zero: a
    subnormal or a zero of either sign becomes ``+0.0``; NaN, inf,
    normal floats and non-float tensors are as they are.
    ``jax.lax.associative_scan`` interleaves its halves by padding each
    with zeros and adding them, so every float a scan emits has passed
    through this."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    # hardshrink writes +0.0 for |x| <= the largest subnormal, -0.0
    # included: one op on any device
    return torch.nn.functional.hardshrink(x, _largest_subnormal(x.dtype))


_LARGEST_SUBNORMAL = {}


def _largest_subnormal(dtype: torch.dtype) -> float:
    lam = _LARGEST_SUBNORMAL.get(dtype)
    if lam is None:
        tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype)
        lam = _LARGEST_SUBNORMAL[dtype] = float(
            torch.nextafter(tiny, torch.zeros((), dtype=dtype)))
    return lam


def _flush_in_place(t: torch.Tensor) -> None:
    if t.is_floating_point():
        t.copy_(flush_subnormal(t))


# op names (``func.__name__``) whose float inputs and outputs are flushed
FLUSHED = frozenset(
    base + suffix
    for base in (
        "add", "sub", "subtract", "rsub", "mul", "multiply", "div", "divide",
        "true_divide", "floor_divide", "remainder", "fmod", "pow",
        "float_power", "square", "sqrt", "rsqrt", "reciprocal", "exp",
        "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos",
        "tan", "tanh", "sigmoid", "atan2", "hypot", "lerp", "addcmul",
        "addcdiv", "floor", "ceil", "round", "trunc", "frac", "fix",
        "sign", "sgn", "maximum", "minimum", "fmax", "fmin", "max", "min",
        "amax", "amin", "aminmax", "clamp", "clip", "clamp_min",
        "clamp_max", "sum", "nansum", "mean", "nanmean", "prod", "cumsum",
        "cumprod", "cummax", "cummin", "logcumsumexp", "std", "var",
        "matmul", "mm", "dot", "mv",
    )
    for suffix in ("", "_")
) | frozenset(
    f"__{p}{op}__"
    for op in ("add", "sub", "mul", "truediv", "div", "floordiv", "mod",
               "pow", "matmul")
    for p in ("", "r", "i")
)
# comparisons: float inputs flushed, a bool result
COMPARED = frozenset(
    base + suffix
    for base in ("eq", "ne", "lt", "le", "gt", "ge", "greater", "less",
                 "greater_equal", "less_equal", "not_equal")
    for suffix in ("", "_")
) | frozenset(f"__{op}__" for op in ("eq", "ne", "lt", "le", "gt", "ge"))
# conversions: flushed on both sides when a float dtype changes
CONVERSIONS = frozenset(
    ("to", "type", "type_as", "float", "double", "half", "bfloat16"))


def _is_number(c) -> bool:
    return isinstance(c, numbers.Real) and not isinstance(c, (bool, np.bool_))


def _number_is(c, *values) -> bool:
    return _is_number(c) and any(
        float(c) == v and math.copysign(1.0, float(c)) == math.copysign(1.0, v)
        for v in values)


# the ops XLA's simplifier removes with a constant operand (the module's
# note), by name
_ADD = ("add", "__add__", "__radd__", "add_", "__iadd__")
_SUB = ("sub", "subtract", "__sub__", "sub_", "__isub__")
_MUL = ("mul", "multiply", "__mul__", "__rmul__", "mul_", "__imul__")
IDENTITIES = frozenset(
    _ADD + _SUB + _MUL + ("__rsub__", "rsub", "pow", "pow_", "__pow__",
                          "__ipow__", "clamp", "clip", "clamp_", "clip_",
                          "clamp_min", "clamp_max", "clamp_min_",
                          "clamp_max_"))


def _identity(name: str, args: tuple, kwargs: dict):
    """``"x"`` or ``"neg"`` when XLA's simplifier removes this op (the
    module's note), else None."""
    if not (args and isinstance(args[0], torch.Tensor)
            and args[0].is_floating_point()):
        return None
    x, c = args[0], (args[1] if len(args) > 1 else None)
    if name.startswith("clamp") or name.startswith("clip"):
        if name.startswith("clamp_max"):
            lo, hi = None, kwargs.get("max", c)
        elif name.startswith("clamp_min"):
            lo, hi = kwargs.get("min", c), None
        else:
            lo = kwargs.get("min", c)
            hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        ok = ((lo is None or _number_is(lo, -math.inf))
              and (hi is None or _number_is(hi, math.inf)))
        return "x" if ok else None
    if kwargs or len(args) != 2 or not _is_number(c):
        return None
    if torch.result_type(x, c) != x.dtype:
        return None  # a conversion: XLA computes it
    if name in _ADD or name in _SUB:
        return "x" if _number_is(c, 0.0, -0.0) else None
    if name in _MUL:
        if _number_is(c, 1.0):
            return "x"
        return "neg" if _number_is(c, -1.0) else None
    if name in ("__rsub__", "rsub"):
        return "neg" if _number_is(c, -0.0) else None
    return "x" if _number_is(c, 1.0) else None  # pow


def _in_place(name: str) -> bool:
    return (name.endswith("_") and not name.startswith("__")
            or name.startswith("__i"))


def _apply_identity(kind: str, name: str, x: torch.Tensor) -> torch.Tensor:
    if _in_place(name):
        return x.neg_() if kind == "neg" else x
    if kind == "neg":
        return torch.neg(x)
    out = x.clone()
    # the simplifier's result IS x: a select of the two values a mask
    # compared (fault 3.4 g) sees through the copy
    root = _same_as(x)
    out._xla_same = (root, root._version, out._version)
    return out


def _same_as(t: torch.Tensor) -> torch.Tensor:
    """The tensor ``t`` is a removed identity op's copy of, unchanged
    since, else ``t``."""
    rec = getattr(t, "_xla_same", None)
    if rec is None or rec[2] != t._version or rec[0]._version != rec[1]:
        return t
    return rec[0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x`` (XLA's): numpy's on the
    CPU, where torch's vector path is one ulp off for some values;
    torch's own elsewhere (CUDA's ``sqrt`` is correctly rounded)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x)
    with np.errstate(invalid="ignore"):  # a negative root is NaN, as XLA's
        np.sqrt(x.numpy(), out=out.numpy())
    return out


def _pow_half(x: torch.Tensor) -> torch.Tensor:
    # pow(x, 0.5): the root, with pow's -0.0 -> +0.0, -inf -> +inf and a
    # positive NaN for a negative base (the root's NaN is negative)
    root = torch.where(x < 0, math.nan, plus_zero(_sqrt(x)))
    return torch.where(x == -math.inf, math.inf, root)


def _maximum(a, b):
    # jnp.maximum: NaN propagates, +0.0 wins a tie with -0.0
    out = torch.maximum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where(a == b, torch.where(torch.signbit(a), b, a), out)


def _minimum(a, b):
    # jnp.minimum: NaN propagates, -0.0 wins a tie with +0.0
    out = torch.minimum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where(a == b, torch.where(torch.signbit(a), a, b), out)


# the two-tensor min/max, with XLA's order of signed zeros (a flushed
# subnormal meets a zero of the other sign more often than a zero does)
_MINMAX = {"maximum": _maximum, "minimum": _minimum,
           "max": _maximum, "min": _minimum}


def _flush_arg(a):
    if isinstance(a, torch.Tensor):
        return flush_subnormal(a)
    if isinstance(a, (list, tuple)) and any(
            isinstance(x, torch.Tensor) for x in a):
        return type(a)(_flush_arg(x) for x in a)
    return a


def _flush_out(out):
    if isinstance(out, torch.Tensor):
        return flush_subnormal(out)
    if isinstance(out, tuple):
        # torch.return_types (max/min with a dim): fresh tensors, so the
        # flush may write them in place and keep the result's type
        for x in out:
            if isinstance(x, torch.Tensor):
                _flush_in_place(x)
    return out


_NP_FLOATS = {torch.float64: np.float64, torch.float32: np.float32}

# -- fault 3.4 e: sorting ----------------------------------------------------
SORTS = frozenset(("sort", "argsort", "msort", "topk"))


def _sort_args(name: str, args: tuple, kwargs: dict):
    """``(dim, descending)`` of a sort call, or None for a form the mode
    leaves alone (an ``out=``)."""
    if "out" in kwargs:
        return None
    if name == "msort":
        return 0, False
    pos = list(args[1:]) + [None, None]
    dim = kwargs.get("dim", pos[0] if pos[0] is not None else -1)
    desc = kwargs.get("descending", pos[1] if pos[1] is not None else False)
    return dim, bool(desc)


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer per float whose order is IEEE's total order: -NaN,
    -inf, ..., -0.0, +0.0, ..., +inf, +NaN, subnormals by value."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[x.dtype]
    bits = x.contiguous().view(ints)
    mask = torch.iinfo(ints).max
    return torch.where(bits < 0, bits ^ mask, bits)


def _sort(func, name: str, args: tuple, kwargs: dict):
    """XLA's sorts of a float tensor (fault 3.4 e), else None.
    ``jnp.sort``/``argsort`` compare the flushed values, so a subnormal
    ties with both zeros, and ``-0.0`` ties with ``+0.0``; NaNs of either
    sign go last (first when descending); ties keep their order (a stable
    sort), except in the values of a descending sort, which reverse an
    ascending one; the values keep their bits. ``lax.top_k`` orders by IEEE's
    total order without a flush (``-0.0`` below ``+0.0``, ``-NaN``
    last), ties by index."""
    x = args[0] if args else None
    if not (isinstance(x, torch.Tensor) and x.dtype in _NP_FLOATS):
        return None
    if name == "topk":
        if "out" in kwargs or len(args) < 2 and "k" not in kwargs:
            return None
        pos = list(args[1:]) + [None] * 4
        k = kwargs.get("k", pos[0])
        dim = kwargs.get("dim", pos[1] if pos[1] is not None else -1)
        largest = kwargs.get("largest", pos[2] if pos[2] is not None else True)
        idx = torch.sort(_total_order_key(x), dim=dim, descending=bool(largest),
                         stable=True).indices.narrow(dim, 0, int(k))
        return torch.return_types.topk((x.gather(dim, idx), idx))
    parsed = _sort_args(name, args, kwargs)
    if parsed is None:
        return None
    dim, desc = parsed
    key = flush_subnormal(x)
    idx = torch.sort(key, dim=dim, descending=desc, stable=True).indices
    if name == "argsort":
        return idx
    if desc:
        # jnp.sort(descending=True) reverses the ascending sort, so its
        # ties come out last first; jnp.argsort(descending=True) keeps
        # them in order
        values = x.gather(dim, torch.sort(key, dim=dim, stable=True)
                          .indices.flip(dim))
    else:
        values = x.gather(dim, idx)
    return values if name == "msort" else torch.return_types.sort((values, idx))


# -- fault 3.4 g: a select of the two values a mask compared -----------------
# the strict comparisons: XLA lowers ``where(a > b, a, b)`` and every
# other select of exactly the two compared tensors after ``>``/``<`` (in
# either order) to a max/min instruction, which returns the flushed
# operand; after ``>=``/``<=``/``==``/``!=`` the select keeps the bits.
# Against a Python number ``c`` (either side: Python hands ``c > x`` over
# as ``x < c``), taken in the tensor's dtype, the select of ``x`` and
# ``c`` follows the probed rules of ``_select_of_constant``.
_STRICT = frozenset(("gt", "lt", "greater", "less", "__gt__", "__lt__"))
_NON_STRICT = frozenset(("ge", "le", "greater_equal", "less_equal",
                         "__ge__", "__le__"))
# the comparisons that can never hold against +inf (``x > inf``) and -inf
_ABOVE, _BELOW = frozenset(("gt", "greater", "__gt__")), frozenset(
    ("lt", "less", "__lt__"))
_AS_STRICT = {"ge": torch.gt, "greater_equal": torch.gt, "__ge__": torch.gt,
              "le": torch.lt, "less_equal": torch.lt, "__le__": torch.lt}


def _dtype_number(c, dtype: torch.dtype):
    """The Python number ``c`` as the float ``dtype`` holds it (numpy
    scalar), or None for a non-float dtype."""
    np_dtype = _NP_FLOATS.get(dtype)
    if np_dtype is None or not _is_number(c):
        return None
    with np.errstate(over="ignore"):
        return np_dtype(c)


def _flush_number(c, dtype: torch.dtype):
    """A comparison's Python number as XLA reads it against a ``dtype``
    tensor: in that dtype, a subnormal read as a zero of its sign."""
    v = _dtype_number(c, dtype)
    if v is None or not (v != 0 and abs(v) < np.finfo(v.dtype).tiny):
        return c
    return math.copysign(0.0, float(v))


def _record_compared(name: str, args: tuple, kwargs: dict, out) -> None:
    if kwargs or len(args) != 2 or not isinstance(out, torch.Tensor):
        return
    a, b = args
    if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
        return
    if name in _STRICT and isinstance(b, torch.Tensor) and b.is_floating_point():
        out._xla_compared = (a, b, a._version, b._version, out._version)
    elif _dtype_number(b, a.dtype) is not None:
        out._xla_compared_const = (a, _dtype_number(b, a.dtype), name,
                                   a._version, out._version)


def _select_args(func, args: tuple, kwargs: dict):
    if kwargs or len(args) != 3:
        return None
    if func is torch.Tensor.where:
        u, cond, v = args
    else:
        cond, u, v = args
    return cond, u, v


def _select_of_compared(func, args: tuple, kwargs: dict):
    """``where(mask, u, v)`` of the two tensors ``mask`` compared
    strictly, unchanged since: the max/min instruction's select of the
    flushed operands (fault 3.4 g); of a tensor and the number it was
    compared with, :func:`_select_of_constant`. None for any other
    ``where``."""
    sel = _select_args(func, args, kwargs)
    if sel is None:
        return None
    cond, u, v = sel
    if getattr(cond, "_xla_compared_const", None) is not None:
        return _select_of_constant(cond, u, v)
    rec = getattr(cond, "_xla_compared", None)
    if rec is None or rec[4] != cond._version:
        return None
    p, q, pv, qv = rec[:4]
    if p._version != pv or q._version != qv:
        return None
    u0, v0, p, q = _same_as(u), _same_as(v), _same_as(p), _same_as(q)
    if not ((u0 is p and v0 is q) or (u0 is q and v0 is p)):
        return None
    return torch.where(cond, flush_subnormal(u), flush_subnormal(v))


def _select_of_constant(cond, u, v):
    """``where(x OP c, ...)`` selecting between ``x`` and the same number
    ``c``, as XLA's CPU backend computes it (probed against jitted JAX
    over float32 and float64, both sides, both orders, ``c`` in ±0.0,
    ±1.0, 0.5, -2, 3, ±inf, NaN and a subnormal): a comparison that can
    never hold (``x > inf``, ``x < -inf``, an ordered comparison with
    NaN, ``== NaN``), ``==`` and ``!=``, and ``>=``/``<=`` against ±0.0
    keep the bits; the strict comparisons, and ``>=``/``<=`` against any
    other number, select the flushed operands; against a subnormal ``c``
    (read as a zero) ``>=``/``<=`` select as ``>``/``<`` do. None when
    the select is not of ``x`` and ``c``."""
    x, c, name, xv, ov = cond._xla_compared_const
    if ov != cond._version or x._version != xv:
        return None
    x0 = _same_as(x)
    if _same_as(u) is x0:
        other = v
    elif _same_as(v) is x0:
        other = u
    else:
        return None
    o = _dtype_number(other, x.dtype)
    if o is None or o.tobytes() != c.tobytes():
        return None
    if name in _STRICT or name in _NON_STRICT:
        if math.isnan(c) or (name in _ABOVE and c == math.inf) or (
                name in _BELOW and c == -math.inf):
            return None  # never true: the false operand, its bits kept
    else:
        return None  # == and !=: the bits kept
    sub = c != 0 and abs(c) < np.finfo(c.dtype).tiny
    if name in _NON_STRICT and c == 0:
        return None
    if name in _NON_STRICT and sub:
        cond = _AS_STRICT[name](flush_subnormal(x), 0.0)
    return torch.where(cond, flush_subnormal(u) if isinstance(u, torch.Tensor)
                       else float(_flush_number(u, x.dtype)),
                       flush_subnormal(v) if isinstance(v, torch.Tensor)
                       else float(_flush_number(v, x.dtype)))


# -- fault 3.4 h: constant chains ----------------------------------------------
# XLA's simplifier folds a chain of multiplications (a division by a
# constant being a multiplication by its reciprocal) or of additions and
# subtractions with compile-time constants into one op: ``x * c1 * c2``
# is ``x * (c1 * c2)``, ``x + c1 - c2`` is ``x + (c1 - c2)`` and
# ``(c1 - x) + c2`` is ``(c1 + c2) - x``, the constants combined in the
# tensor's dtype. A tensor made by ``x op c`` remembers ``(x, op, c)``.
_RSUB = ("__rsub__", "rsub")


def _chain_step(name: str, args: tuple, kwargs: dict):
    """``(class, sign, c)`` of a ``x op c`` the simplifier can fold: class
    "mul" (``x * c``) or "add" (``sign * x + c``), else None."""
    if kwargs or len(args) != 2 or not _is_number(args[1]):
        return None
    x, c = args
    if not (isinstance(x, torch.Tensor) and x.dtype in _NP_FLOATS):
        return None
    if torch.result_type(x, c) != x.dtype:
        return None
    dt = _NP_FLOATS[x.dtype]
    if name in _MUL:
        return "mul", 1, dt(c)
    if name in _ADD:
        return "add", 1, dt(c)
    if name in _SUB:
        return "add", 1, -dt(c)
    if name in _RSUB:
        return "add", -1, dt(c)
    return None


def _chain_start(step, x: torch.Tensor):
    """The record a new chain ``x op c`` leaves on its result."""
    cls, sign, c = step
    return cls, x, x._version, sign, c


def _record_chain(out, rec) -> None:
    if rec and isinstance(out, torch.Tensor):
        out._xla_chain = rec + (out._version,)


def _fold(step, y: torch.Tensor):
    """``(func, types, args, record)`` of ``y op c`` folded into the op
    that made ``y``, or None when ``y`` was made otherwise (or changed
    since)."""
    rec = getattr(y, "_xla_chain", None)
    cls, sign, c = step
    if rec is None or rec[0] != cls or sign != 1 or rec[5] != y._version:
        return None
    _, x, xv, xsign, c0 = rec[:5]
    if x._version != xv or x.dtype != y.dtype:
        return None
    with np.errstate(over="ignore", invalid="ignore"):
        folded = c0 * c if cls == "mul" else c0 + c
    if cls == "mul":
        func = torch.mul
    else:
        func = torch.add if xsign == 1 else torch.rsub
    return func, (), (x, float(folded)), (cls, x, xv, xsign, folded)


class _ReferenceArithmetic(torch.overrides.TorchFunctionMode):
    """XLA's arithmetic on torch tensors: ``tensor / number`` as
    ``tensor * (1 / number)``, and (``flush``) subnormal floats flushed
    to signed zeros by arithmetic, comparisons and float conversions
    (see the module's note)."""

    def __init__(self, flush: bool = True):
        super().__init__()
        self.flush = flush

    _DIVISIONS = {torch.Tensor.__truediv__, torch.Tensor.div,
                  torch.Tensor.true_divide, torch.div, torch.true_divide}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (
            func in self._DIVISIONS
            and not kwargs
            and len(args) == 2
            and isinstance(args[0], torch.Tensor)
            and isinstance(args[1], numbers.Real)
            and not isinstance(args[1], (bool, np.bool_))
        ):
            d = float(args[1])
            inv = 1.0 / d if d != 0 else math.copysign(math.inf, d)
            np_dtype = _NP_FLOATS.get(args[0].dtype)
            if np_dtype is not None and d != 0:
                # the reciprocal of the constant as the tensor's own
                # dtype rounds it, as XLA folds it
                with np.errstate(over="ignore"):
                    inv = float(np_dtype(1.0) / np_dtype(d))
            func, args = torch.mul, (args[0], inv)
        name = getattr(func, "__name__", "") if self.flush else ""
        if name in SORTS:
            out = _sort(func, name, args, kwargs)
            if out is not None:
                return out
        if name == "where":
            out = _select_of_compared(func, args, kwargs)
            if out is not None:
                return out
        step = _chain_step(name, args, kwargs)
        if step is not None:
            folded = _fold(step, args[0])
            if folded is not None:
                out = self.__torch_function__(*folded[:2], args=folded[2])
                if _in_place(name):
                    out = args[0].copy_(out)
                _record_chain(out, folded[3])
                return out
        if name in IDENTITIES:
            kind = _identity(name, args, kwargs)
            if kind is not None:
                out = _apply_identity(kind, name, args[0])
                if step is not None:
                    _record_chain(out, _chain_start(step, args[0]))
                return out
        if (name in ("sqrt", "sqrt_", "pow", "pow_", "__pow__", "__ipow__")
                and len(args) >= 1 and isinstance(args[0], torch.Tensor)
                and args[0].is_floating_point() and not kwargs
                and (name.startswith("sqrt") and len(args) == 1
                     or len(args) == 2 and _number_is(args[1], 0.5))):
            root = (_sqrt if name.startswith("sqrt") else _pow_half)(
                flush_subnormal(args[0]))
            return args[0].copy_(root) if _in_place(name) else root
        if name in FLUSHED or name in COMPARED:
            in_place = _in_place(name)
            # an ``out=`` tensor is written, not read: flushed after
            kw = {k: v if k == "out" else _flush_arg(v)
                  for k, v in kwargs.items()}
            if in_place and isinstance(args[0], torch.Tensor):
                _flush_in_place(args[0])
                out = func(args[0], *(_flush_arg(a) for a in args[1:]), **kw)
                _flush_in_place(args[0])
                return out
            if (name in _MINMAX and not kwargs and len(args) == 2
                    and all(isinstance(a, torch.Tensor) for a in args)):
                func = _MINMAX[name]
            fargs = [_flush_arg(a) for a in args]
            if (name in COMPARED and len(fargs) == 2
                    and isinstance(args[0], torch.Tensor)):
                # a subnormal number reads as zero too
                fargs[1] = _flush_number(fargs[1], args[0].dtype)
            out = func(*fargs, **kw)
            if isinstance(kwargs.get("out"), torch.Tensor):
                _flush_in_place(kwargs["out"])
            if name in COMPARED:
                _record_compared(name, args, kwargs, out)
                return out
            out = _flush_out(out)
            if step is not None:
                _record_chain(out, _chain_start(step, args[0]))
            return out
        if name in CONVERSIONS and args and isinstance(args[0], torch.Tensor):
            out = func(*args, **kwargs)
            if (isinstance(out, torch.Tensor) and out.dtype != args[0].dtype
                    and (out.is_floating_point()
                         or args[0].is_floating_point())):
                if args[0].is_floating_point():
                    out = func(flush_subnormal(args[0]), *args[1:], **kwargs)
                return flush_subnormal(out)
            return out
        return func(*args, **kwargs)


@contextlib.contextmanager
def reference_arithmetic(flush: bool = True):
    """Run user record functions with the reference's arithmetic: float64
    as torch's default dtype (the reference's x64 mode), division by a
    constant as multiplication by its reciprocal, and XLA's flush of
    subnormal floats. ``flush=False`` leaves the flush out, here and in
    every ``reference_arithmetic`` entered inside (a combiner enters its
    own), for tracing a function's graph: ``ops/liveness.py`` reads
    which ops it applies, and the flush would hide them. The caller's
    default dtype is restored after."""
    outer = getattr(_ACTIVE, "flush", None)
    flush = flush and outer is not False
    _hold_float64()
    try:
        if outer == flush:
            # the outer mode already rewrites and flushes every op run
            # here: a second mode would flush each result again
            yield
        else:
            _ACTIVE.flush = flush
            try:
                with _ReferenceArithmetic(flush):
                    yield
            finally:
                _ACTIVE.flush = outer
    finally:
        _release_float64()


# whether this thread's innermost reference_arithmetic flushes (None
# outside any)
_ACTIVE = threading.local()

# torch's default dtype is one setting for the whole process, and the
# shards of a sharded program (runtime/sharded.py) run user functions on
# threads of their own: it is float64 while any thread is inside a
# reference_arithmetic and the caller's again when the last one leaves
# (the framework's own code names every dtype it makes)
_DTYPE_LOCK = threading.Lock()
_DTYPE_HOLD = {"threads": 0, "before": None}


def _hold_float64() -> None:
    with _DTYPE_LOCK:
        if _DTYPE_HOLD["threads"] == 0:
            _DTYPE_HOLD["before"] = torch.get_default_dtype()
            torch.set_default_dtype(torch.float64)
        _DTYPE_HOLD["threads"] += 1


def _release_float64() -> None:
    with _DTYPE_LOCK:
        _DTYPE_HOLD["threads"] -= 1
        if _DTYPE_HOLD["threads"] == 0:
            torch.set_default_dtype(_DTYPE_HOLD["before"])
