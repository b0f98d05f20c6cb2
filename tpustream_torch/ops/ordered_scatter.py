"""Fixed-order float32 scatter-add: the CUDA kernels and their plain
PyTorch version.

For a flat float32 plane of ``N + 1`` cells, whose last cell is a sink
that masked rows point at, int32 cells ``[B]`` (int64 too in the plain
version) and float32 values ``[B]``, in arrival order::

    for i in range(B):  plane[cell[i]] = ftz(ftz(plane[cell[i]]) + ftz(val[i]))

(the sink, and any cell outside ``[0, N)``, takes nothing; ``ftz`` is
``arith.flush_subnormal``). This is the order, the rounding and the
flush of the JAX package's non-unique ``p.at[idx].add(v)`` into its
float32 window planes on the CPU (tpustream/runtime/window_program.py,
the fast path of ``_scatter_words``): duplicates add one by one in
arrival order, rounding to float32 after every add, under XLA's
flush-to-zero. PyTorch's CUDA scatter-adds add with atomics in no fixed
order, which is why this merge has kernels of its own
(``kernels/ordered_scatter.cu``).

:func:`ordered_scatter_add` launches them for CUDA tensors and takes
:func:`ordered_scatter_add_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..arith import flush_subnormal

_CELL_DTYPES = (torch.int32, torch.int64)


def _check(plane: torch.Tensor, cells: torch.Tensor, vals: torch.Tensor) -> None:
    if plane.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(
            f"plane ({plane.dtype}) and vals ({vals.dtype}) must be float32")
    if cells.dtype not in _CELL_DTYPES:
        raise TypeError(f"cells must be int32 or int64, got {cells.dtype}")
    if plane.dim() != 1 or plane.numel() < 1:
        raise ValueError(
            f"plane must be flat with a sink cell, got {tuple(plane.shape)}")
    if plane.numel() >= 2**31:
        raise ValueError(
            f"plane has {plane.numel()} cells: the kernels take int32 cells, "
            f"so a plane of 2^31 cells or more is refused")
    if cells.dim() != 1 or cells.shape != vals.shape:
        raise ValueError(
            f"cells {tuple(cells.shape)} and vals {tuple(vals.shape)} must "
            f"be flat and of one length")
    if not (plane.is_contiguous() and cells.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("plane, cells and vals must be contiguous")
    if not (plane.device == cells.device == vals.device):
        raise ValueError(
            f"plane ({plane.device}), cells ({cells.device}) and vals "
            f"({vals.device}) must be on one device")


def ordered_scatter_add(plane: torch.Tensor, cells: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Add ``vals`` into ``plane`` at ``cells`` IN PLACE, each cell's
    values in arrival order, rounding to float32 and flushing subnormals
    at every add; the last cell is the sink and takes nothing. Returns
    ``plane``.

    CUDA tensors take int32 cells only, and :func:`device_launches`
    launches on the current stream (no synchronisation; a refused launch
    raises). CPU tensors take the plain version, which also reads int64
    cells. Any other device raises."""
    _check(plane, cells, vals)
    if plane.device.type == "cpu":
        return ordered_scatter_add_ref(plane, cells, vals)
    if plane.device.type != "cuda":
        raise RuntimeError(f"no ordered_scatter_add kernel for {plane.device}")
    if cells.dtype != torch.int32:
        raise TypeError(f"the kernels take int32 cells, got {cells.dtype}")
    launch(plane, cells, vals)
    ordered_scatter_add.launches += 1
    return plane


def reset_launches() -> None:
    """Set ``ordered_scatter_add.launches`` (wrapper calls that launched
    the kernels since) to 0. Plain version calls are not counted."""
    ordered_scatter_add.launches = 0


reset_launches()


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built, loaded and bound once."""
    from ..kernels import load

    lib = load("ordered_scatter")
    for name in ("ordered_scatter_max_rows",
                 "ordered_scatter_launches_per_pass"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.ordered_scatter_scratch_words.argtypes = [ctypes.c_int64]
    lib.ordered_scatter_scratch_words.restype = ctypes.c_int64
    fn = lib.ordered_scatter_add_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                   + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def device_launches(n_rows: int) -> int:
    """Device launches (the scratch table's memset among them) one call
    of ``n_rows`` rows makes: a pass (five launches) a ``max_rows`` rows
    of the batch, none for no rows."""
    lib = _lib()
    per_pass = lib.ordered_scatter_launches_per_pass()
    return per_pass * -(-n_rows // lib.ordered_scatter_max_rows())


def launch(plane: torch.Tensor, cells: torch.Tensor,
           vals: torch.Tensor) -> None:
    """Launch the kernels on the current stream for int32 ``cells``,
    with none of :func:`ordered_scatter_add`'s checks and without
    counting: for timing them alone. The caller guarantees what the
    wrapper checks. The scratch is allocated here (``torch.empty``) and
    freed on return: the caching allocator gives its block out again
    only to work queued after these launches on the same stream."""
    lib = _lib()
    n = cells.numel()
    words = lib.ordered_scatter_scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=plane.device)
    args = (cells.data_ptr(), vals.data_ptr(), plane.data_ptr(), n,
            plane.numel(), scratch.data_ptr(), words,
            torch.cuda.current_stream(plane.device).cuda_stream)
    if plane.device.index == torch.cuda.current_device():
        err = lib.ordered_scatter_add_launch(*args)
    else:
        with torch.cuda.device(plane.device):
            err = lib.ordered_scatter_add_launch(*args)
    if err != 0:
        raise RuntimeError(f"ordered_scatter_add launch failed: cudaError {err}")


def ordered_scatter_add_ref(plane: torch.Tensor, cells: torch.Tensor,
                            vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ordered_scatter_add`, on any
    device: the cells outside ``[0, N)`` dropped, a stable sort of the
    rest, each row's rank within its cell's run, then one round a rank.
    The rows of one rank touch distinct cells, so each round adds
    exactly one value to each cell it touches, and the rounds go in rank
    order: the sequential fold. The values, each touched cell's old
    value and every sum are flushed explicitly (``flush_subnormal``; the
    process's denormal mode is left alone). Updates ``plane`` in place
    and returns it."""
    sink = plane.numel() - 1
    c = cells.to(torch.int64)
    keep = (c >= 0) & (c < sink)
    c, v = c[keep], flush_subnormal(vals[keep])
    n = c.numel()
    if n == 0:
        return plane
    sorted_cells, rows = torch.sort(c, stable=True)
    pos = torch.arange(n, device=c.device)
    starts = torch.ones(n, dtype=torch.bool, device=c.device)
    starts[1:] = sorted_cells[1:] != sorted_cells[:-1]
    first = torch.cummax(torch.where(starts, pos, 0), dim=0).values
    rank = pos - first
    # each touched cell's old value flushed once: later rounds read the
    # flushed sums the earlier ones wrote
    touched = sorted_cells[starts]
    plane[touched] = flush_subnormal(plane[touched])
    # the rows of each rank, contiguous and in rank order
    by_rank = torch.sort(rank, stable=True).indices
    bounds = torch.bincount(rank).cumsum(0).tolist()
    src = v[rows[by_rank]]
    dst = sorted_cells[by_rank]
    lo = 0
    for hi in bounds:
        d = dst[lo:hi]
        plane[d] = flush_subnormal(plane[d] + src[lo:hi])
        lo = hi
    return plane
