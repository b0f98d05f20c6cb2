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
  subnormal's bits through all three).

:func:`flush_subnormal` is the flush itself, for the framework's own
arithmetic outside user functions (the 32-bit narrowing in
``ops/wordplanes.py``, the ordered merge's plain version, the rolling
kernel's plain version).

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
            func, args = torch.mul, (args[0], inv)
        name = getattr(func, "__name__", "") if self.flush else ""
        if name in FLUSHED or name in COMPARED:
            in_place = (name.endswith("_") and not name.startswith("__")
                        or name.startswith("__i"))
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
            out = func(*(_flush_arg(a) for a in args), **kw)
            if isinstance(kwargs.get("out"), torch.Tensor):
                _flush_in_place(kwargs["out"])
            return out if name in COMPARED else _flush_out(out)
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
    prev = torch.get_default_dtype()
    outer = getattr(_ACTIVE, "flush", None)
    flush = flush and outer is not False
    torch.set_default_dtype(torch.float64)
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
        torch.set_default_dtype(prev)


# whether this thread's innermost reference_arithmetic flushes (None
# outside any)
_ACTIVE = threading.local()
