"""The reference's arithmetic for user record functions.

Every call into a user record function (device chain ops, window
combiners, the liveness probes) runs under :func:`reference_arithmetic`,
which holds the arithmetic to the reference's bits:

* torch's default float dtype is float64 there, as the reference runs
  with x64 on, so ``int64 * 8.0`` is float64 in both packages;
* a tensor divided by a Python number is multiplied by the number's
  reciprocal: the reference's compiler (XLA) rewrites ``x / c`` into
  ``x * (1/c)``, which differs from an IEEE division in the last bit for
  about one value in eleven (the Mbps map's ``/ 60``).

It sits below both ``ops`` and ``runtime``, which both use it.
"""

from __future__ import annotations

import contextlib
import math
import numbers

import numpy as np
import torch


class _ReciprocalDivision(torch.overrides.TorchFunctionMode):
    """``tensor / number`` as ``tensor * (1 / number)``, as XLA computes
    a division by a constant."""

    _DIVISIONS = {torch.Tensor.__truediv__, torch.Tensor.div,
                  torch.Tensor.true_divide, torch.div, torch.true_divide}

    def __torch_function__(self, func, types, args=(), kwargs=None):
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
            return torch.mul(args[0], inv)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def reference_arithmetic():
    """Run user record functions with the reference's arithmetic: float64
    as torch's default dtype (the reference's x64 mode) and division by a
    constant as multiplication by its reciprocal. The caller's default
    dtype is restored after."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with _ReciprocalDivision():
            yield
    finally:
        torch.set_default_dtype(prev)
