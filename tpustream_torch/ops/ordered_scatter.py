"""Fixed-order float32 scatter-add: the CUDA kernel and its plain
PyTorch version.

For a flat float32 plane of ``N + 1`` cells, whose last cell is a sink
that masked rows point at, int64 cells ``[B]`` and float32 values
``[B]``, in arrival order::

    for i in range(B):  plane[cell[i]] = float32(plane[cell[i]] + val[i])

(the sink, and any cell outside ``[0, N)``, takes nothing). This is
``np.add.at``'s order, and the order in which the JAX package's
non-unique ``p.at[idx].add(v)`` merges a batch into its float32 window
planes on the CPU (tpustream/runtime/window_program.py, the fast path of
``_scatter_words``). A float sum depends on its order, so every add
rounds where the sequential fold rounds; PyTorch's CUDA scatter-adds
add with atomics in no fixed order, which is why this merge has a
kernel of its own (``kernels/ordered_scatter.cu``).

:func:`ordered_scatter_add` sorts the cells stably and launches the
kernel for CUDA tensors, and takes :func:`ordered_scatter_add_ref` only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# the kernel's block size (kThreads in kernels/ordered_scatter.cu),
# checked against the library when it is bound
BLOCK_THREADS = 256


def _check(plane: torch.Tensor, cells: torch.Tensor, vals: torch.Tensor) -> None:
    if plane.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(
            f"plane ({plane.dtype}) and vals ({vals.dtype}) must be float32")
    if cells.dtype != torch.int64:
        raise TypeError(f"cells must be int64, got {cells.dtype}")
    if plane.dim() != 1 or plane.numel() < 1:
        raise ValueError(
            f"plane must be flat with a sink cell, got {tuple(plane.shape)}")
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
    values in arrival order, rounding to float32 after every add; the
    last cell is the sink and takes nothing. Returns ``plane``.

    CUDA tensors: a stable sort of the cells, then one launch of the
    kernel on the current stream (no synchronisation; a refused launch
    raises). CPU tensors take the plain version. Any other device
    raises."""
    _check(plane, cells, vals)
    if plane.device.type == "cpu":
        return ordered_scatter_add_ref(plane, cells, vals)
    if plane.device.type != "cuda":
        raise RuntimeError(f"no ordered_scatter_add kernel for {plane.device}")
    sorted_cells, rows = torch.sort(cells, stable=True)
    launch(plane, sorted_cells, rows, vals)
    ordered_scatter_add.launches += 1
    return plane


def reset_launches() -> None:
    """Set ``ordered_scatter_add.launches`` (kernel launches since) to 0.
    Plain version calls are not counted."""
    ordered_scatter_add.launches = 0


reset_launches()


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel library's entry point, built, loaded and bound once."""
    from ..kernels import load

    lib = load("ordered_scatter")
    getter = lib.ordered_scatter_block_threads
    getter.argtypes = []
    getter.restype = ctypes.c_int
    got = getter()
    if got != BLOCK_THREADS:
        raise RuntimeError(
            f"kernels/ordered_scatter.cu has ordered_scatter_block_threads "
            f"{got}, the wrapper {BLOCK_THREADS}")
    fn = lib.ordered_scatter_add_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(plane: torch.Tensor, sorted_cells: torch.Tensor,
           rows: torch.Tensor, vals: torch.Tensor) -> None:
    """Launch the kernel on the current stream for cells already sorted
    stably (``rows``: each sorted cell's row in the batch), with none of
    :func:`ordered_scatter_add`'s checks and without counting: for timing
    the kernel alone. The caller guarantees what the wrapper checks."""
    fn = _entry()
    with torch.cuda.device(plane.device):
        err = fn(sorted_cells.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                 plane.data_ptr(), sorted_cells.numel(), plane.numel(),
                 torch.cuda.current_stream(plane.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ordered_scatter_add launch failed: cudaError {err}")


def ordered_scatter_add_ref(plane: torch.Tensor, cells: torch.Tensor,
                            vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ordered_scatter_add`, on any
    device: a stable sort of the cells, each row's rank within its
    cell's run, then one ``index_add_`` a rank. The rows of one rank
    touch distinct cells, so each round adds exactly one value to each
    cell it touches, and the rounds go in rank order: the sequential
    fold's bits whatever order ``index_add_`` takes inside a round.
    Updates ``plane`` in place and returns it."""
    n = cells.numel()
    if n == 0:
        return plane
    sink = plane.numel() - 1
    sorted_cells, rows = torch.sort(cells, stable=True)
    pos = torch.arange(n, device=cells.device)
    starts = torch.ones(n, dtype=torch.bool, device=cells.device)
    starts[1:] = sorted_cells[1:] != sorted_cells[:-1]
    first = torch.cummax(torch.where(starts, pos, 0), dim=0).values
    rank = pos - first
    keep = (sorted_cells >= 0) & (sorted_cells < sink)
    rank, sorted_cells, rows = rank[keep], sorted_cells[keep], rows[keep]
    if rank.numel() == 0:
        return plane
    # the rows of each rank, contiguous and in rank order
    by_rank = torch.sort(rank, stable=True).indices
    bounds = torch.bincount(rank).cumsum(0).tolist()
    src = vals[rows[by_rank]]
    dst = sorted_cells[by_rank]
    lo = 0
    for hi in bounds:
        plane.index_add_(0, dst[lo:hi], src[lo:hi])
        lo = hi
    return plane
