"""Record-at-a-time keyed rolling reduce: the CUDA kernel and its plain
PyTorch version.

Counterpart of tpustream/ops/pallas_rolling.py::seq_rolling_reduce. For
a ``[K]`` plane and ``[B]`` keys and values, in arrival order::

    plane[key[i]] = op(plane[key[i]], val[i]);  emis[i] = plane[key[i]]

``op`` is ``max``, ``min`` or ``sum``, over float32, float64 or int64.
Rows with a negative key (padding) fold nothing and emit their own
value. Subnormal floats are flushed as the reference's compiler flushes
them: each value folded and each stored value read as a zero of its
sign, each float sum flushed when formed (``arith.flush_subnormal``). A plane that starts at the op's identity (:data:`IDENTITY`)
makes every emission the running aggregate of its key: Flink's
rolling-aggregate contract. An int64 ``sum`` wraps in two's complement,
as the reference's int64 sum and Java's ``long`` do.

:func:`seq_rolling_reduce` launches the kernel in
``kernels/seq_rolling.cu`` for CUDA tensors and takes
:func:`seq_rolling_reduce_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..arith import flush_subnormal

OPS = ("max", "min", "sum")

# the plane value a never-seen key starts from, per plane dtype:
# op(IDENTITY[dtype][op], v) == v bit for bit (-0.0 + v keeps the sign
# of a -0.0 v; 0.0 + -0.0 would not)
_FLOAT_IDENTITY = {"max": float("-inf"), "min": float("inf"), "sum": -0.0}
IDENTITY = {
    torch.float32: _FLOAT_IDENTITY,
    torch.float64: _FLOAT_IDENTITY,
    torch.int64: {"max": -(2**63), "min": 2**63 - 1, "sum": 0},
}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}
_OP_CODES = {"max": 0, "min": 1, "sum": 2}


def _max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # jnp.maximum semantics: NaN propagates, +0.0 wins a tie with -0.0
    return torch.where(
        a == b, torch.where(torch.signbit(a), b, a), torch.maximum(a, b)
    )


def _min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # jnp.minimum semantics: NaN propagates, -0.0 wins a tie with +0.0
    return torch.where(
        a == b, torch.where(torch.signbit(a), a, b), torch.minimum(a, b)
    )


def _sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # operands come flushed; a subnormal sum is flushed when formed
    return flush_subnormal(a + b)


REDUCERS = {"max": _max, "min": _min, "sum": _sum}
# integers have no NaN and no signed zero; torch's int64 add wraps
INT_REDUCERS = {"max": torch.maximum, "min": torch.minimum, "sum": torch.add}


# The kernel's layout (kTile and kDigitBits in kernels/seq_rolling.cu),
# which sizes the scratch; checked against the library when it is bound.
TILE_ROWS = 1024
DIGIT_BITS = 8
_ALIGN = 256
# the scratch regions, in the order the kernel's entry point takes them
SCRATCH_REGIONS = ("pairs_a", "pairs_b", "counts", "xs", "agg_v", "agg_f")


def sort_passes(n_keys: int) -> int:
    """Radix passes that sort the keys ``0..n_keys``: ``n_keys`` itself is
    the sort key of padding and out-of-range rows, which sort last."""
    return max(1, -(-n_keys.bit_length() // DIGIT_BITS))


@functools.lru_cache(maxsize=64)
def scratch_layout(n_rows: int, n_keys: int, itemsize: int):
    """``(byte offset of each of SCRATCH_REGIONS, total bytes)`` of one
    call's scratch, each region aligned to 256 bytes and as large as the
    kernel's entry point says."""
    tiles = -(-n_rows // TILE_ROWS)
    sizes = (
        8 * n_rows,  # pairs_a
        8 * n_rows,  # pairs_b
        4 * sort_passes(n_keys) * tiles * (1 << DIGIT_BITS),  # counts
        itemsize * n_rows,  # xs
        itemsize * tiles,  # agg_v
        4 * tiles,  # agg_f
    )
    offsets, end = [], 0
    for size in sizes:
        offsets.append(end)
        end += -(-size // _ALIGN) * _ALIGN
    return tuple(offsets), end


def _check(plane, keys, vals, op, bad_keys):
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if plane.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"plane must be float32, float64 or int64, got {plane.dtype}")
    if vals.dtype != plane.dtype:
        raise TypeError(
            f"vals ({vals.dtype}) must have the plane's dtype ({plane.dtype})"
        )
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.shape != vals.shape:
        raise ValueError(
            f"keys {tuple(keys.shape)} and vals {tuple(vals.shape)} differ in shape"
        )
    if not (plane.is_contiguous() and keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("plane, keys and vals must be contiguous")
    if not (plane.device == keys.device == vals.device):
        raise ValueError(
            f"plane ({plane.device}), keys ({keys.device}) and vals "
            f"({vals.device}) must be on one device"
        )
    if bad_keys is not None and not (
        bad_keys.dtype == torch.int32 and bad_keys.numel() == 1
        and bad_keys.device == plane.device
    ):
        raise ValueError(
            "bad_keys must be one int32 element on the plane's device"
        )


def seq_rolling_reduce(
    plane: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
    op: str = "max", bad_keys: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fold ``vals`` into ``plane`` by ``keys`` in arrival order and
    return the per-row emissions (shaped like ``vals``).

    ``plane`` (float32, float64 or int64, any shape, read as flat ``[K]``) is
    updated IN PLACE, as the TPU kernel aliases its plane input to its
    output. ``keys`` are int32, ``vals`` have the plane's dtype; all
    three are contiguous and on one device.

    A key ``>= K`` is an error. With ``bad_keys`` (one int32 element on
    the plane's device) the call adds the number of such rows to it,
    which the caller reads when it next fetches from the device; those
    rows fold nothing and emit their own value. Without ``bad_keys`` a
    CPU call raises ``IndexError`` at once, and a CUDA call is refused:
    checking there would make the host wait on the card.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation; a refused launch raises). CPU tensors take the plain
    version. Any other device raises.
    """
    _check(plane, keys, vals, op, bad_keys)
    if plane.device.type == "cpu":
        return seq_rolling_reduce_ref(plane, keys, vals, op, bad_keys)
    if plane.device.type != "cuda":
        raise RuntimeError(f"no seq_rolling_reduce kernel for {plane.device}")
    if bad_keys is None:
        raise ValueError(
            "seq_rolling_reduce on CUDA needs bad_keys, the device counter "
            "of out-of-range keys"
        )
    emis = torch.empty_like(vals)
    launch(plane, keys, vals, op, emis, bad_keys)
    seq_rolling_reduce.launches += 1
    by_dtype = seq_rolling_reduce.launches_by_dtype
    name = str(plane.dtype).rsplit(".", 1)[-1]
    by_dtype[name] = by_dtype.get(name, 0) + 1
    return emis


def reset_launches() -> None:
    """Set the kernel's launch counts to 0: ``seq_rolling_reduce.launches``
    (all launches since) and ``seq_rolling_reduce.launches_by_dtype``
    (the same, by the plane's dtype name). Plain version calls are not
    counted."""
    seq_rolling_reduce.launches = 0
    seq_rolling_reduce.launches_by_dtype = {}


reset_launches()


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel library's entry point, built, loaded and bound once."""
    from ..kernels import load

    lib = load("seq_rolling")
    for name, want in (("seq_rolling_tile_rows", TILE_ROWS),
                       ("seq_rolling_digit_bits", DIGIT_BITS)):
        getter = getattr(lib, name)
        getter.argtypes = []
        getter.restype = ctypes.c_int
        got = getter()
        if got != want:
            raise RuntimeError(
                f"kernels/seq_rolling.cu has {name} {got}, the wrapper {want}"
            )
    fn = lib.seq_rolling_reduce_launch
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 7
    )
    fn.restype = ctypes.c_int
    return fn


def launch(
    plane: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor, op: str,
    emis: torch.Tensor, bad_keys: Optional[torch.Tensor] = None,
) -> None:
    """Launch the kernel into ``emis`` on the current stream, with none of
    :func:`seq_rolling_reduce`'s checks and without counting: for timing
    the kernel alone. The caller guarantees what the wrapper checks."""
    fn = _entry()
    n, k = keys.numel(), plane.numel()
    offsets, total = scratch_layout(n, k, vals.element_size())
    # freed on return: the caching allocator gives the block out again
    # only to work queued after this launch on the same stream
    scratch = torch.empty(total, dtype=torch.uint8, device=plane.device)
    base = scratch.data_ptr()
    with torch.cuda.device(plane.device):
        err = fn(
            _DTYPE_CODES[plane.dtype], _OP_CODES[op],
            keys.data_ptr(), vals.data_ptr(), plane.data_ptr(), emis.data_ptr(),
            None if bad_keys is None else bad_keys.data_ptr(),
            n, k, sort_passes(k), *(base + o for o in offsets),
            torch.cuda.current_stream(plane.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"seq_rolling_reduce launch failed: cudaError {err}")


def seq_rolling_reduce_ref(
    plane: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
    op: str = "max", bad_keys: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`seq_rolling_reduce`, on any device.

    A stable sort by key, a log-step segmented inclusive scan of each
    key's values, a combine with the stored plane row, the emissions put
    back in arrival order, and the plane written at each segment's tail.
    Updates ``plane`` in place. max/min and an int64 sum (which wraps)
    give the sequential fold's bits; a float sum adds in the scan's tree
    order, not in arrival order, so it agrees with the kernel and the
    sequential fold only to rounding. Subnormals are flushed as the
    kernel flushes them. Keys
    ``>= K`` are counted into ``bad_keys`` and treated as padding, or
    raise ``IndexError`` when there is no ``bad_keys``.
    """
    reducer = (REDUCERS if plane.dtype.is_floating_point else INT_REDUCERS)[op]
    flat = plane.view(-1)
    k = keys.reshape(-1).to(torch.int64)
    v = vals.reshape(-1)
    n = k.numel()
    emis = v.clone()  # rows with a negative key pass their value through
    if n == 0:
        return emis.view(vals.shape)
    over = k >= flat.numel()
    if bad_keys is None:
        if bool(over.any()):
            raise IndexError(
                f"key {int(k.max())} is out of range for a plane of "
                f"{flat.numel()} keys"
            )
    else:
        bad_keys += over.sum().to(bad_keys.dtype)
        k = torch.where(over, -1, k)
    sk, perm = torch.sort(k, stable=True)
    x = flush_subnormal(v[perm])
    starts = torch.ones(n, dtype=torch.bool, device=k.device)
    starts[1:] = sk[1:] != sk[:-1]
    tails = torch.ones_like(starts)
    tails[:-1] = starts[1:]
    # Hillis-Steele: after offset d, x[i] folds the last min(2d, run)
    # values of its segment up to i, earlier operand on the left
    flag = starts
    d = 1
    while d < n:
        folded = torch.where(flag[d:], x[d:], reducer(x[:-d], x[d:]))
        x = torch.cat([x[:d], folded])
        flag = torch.cat([flag[:d], flag[d:] | flag[:-d]])
        d *= 2
    valid = sk >= 0
    total = reducer(flush_subnormal(flat[sk.clamp(min=0)]), x)
    emis[perm] = torch.where(valid, total, v[perm])
    write = tails & valid
    flat[sk[write]] = total[write]
    return emis.view(vals.shape)
