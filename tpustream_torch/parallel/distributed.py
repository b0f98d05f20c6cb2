"""Multi-process initialization: the cluster side of the comm backend.

Counterpart of tpustream/parallel/distributed.py, which joins hosts with
``jax.distributed`` so that one SPMD program spans them. Here the
processes join a ``torch.distributed`` process group on the ``gloo``
backend, and a sharded job's mesh (``parallel/mesh.py``) spans them:
process ``p`` of ``P`` owns the contiguous shards ``p*S/P .. (p+1)*S/P
- 1`` and runs a thread for each, and every collective of the mesh is a
rendezvous of the process's shard threads followed by one call on the
group. ``gloo`` moves host tensors, so a collective that crosses
processes copies card -> host -> card; NCCL refuses two ranks on one
card, which is how a single-card machine runs a pair.

Usage on each process::

    from tpustream_torch.parallel import distributed
    distributed.initialize(coordinator="127.0.0.1:29500",
                           num_processes=2, process_id=me)
    mesh = distributed.global_mesh()
    cfg = StreamConfig(parallelism=mesh.size, ...)

With no arguments, ``initialize`` reads torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (the reference reads the
``JAX_*`` variables), and does nothing when they are absent: a
single-process run has nothing to join. Every process runs the same
executor over the same replayed source; each feeds its shards' rows and
dispatches its shards' emissions to its own sinks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from .mesh import RENDEZVOUS_TIMEOUT_S, Mesh, default_devices, make_mesh

_initialized = False
# the size of the group this process joined (0: none): a group that
# failed is torn down (``Mesh.abort``), and this process must not go on
# as if it ran alone
_joined = 0


def _dist():
    import torch.distributed as dist

    return dist


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this process to the group (idempotent). ``coordinator`` is
    ``host:port`` of process 0's rendezvous. A group whose peers do not
    all arrive, or whose collectives stall, fails after
    :data:`~tpustream_torch.parallel.mesh.RENDEZVOUS_TIMEOUT_S`."""
    global _initialized, _joined
    if _initialized:
        return
    dist = _dist()
    if dist.is_initialized():
        # a launcher joined the group already
        _initialized = True
        return
    env = os.environ
    if coordinator is None and num_processes is None and process_id is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            # single-process run: nothing to join
            _initialized = True
            return
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env.get("RANK", "0"))
    if num_processes is None or process_id is None or coordinator is None:
        raise ValueError(
            "initialize needs coordinator, num_processes and process_id "
            "together (or none of them, with torchrun's MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK set)")
    if int(num_processes) == 1:
        _initialized = True
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    _joined = int(num_processes)
    _initialized = True


def process_count() -> int:
    """Processes in the group (1 with no group). Raises once the group
    this process joined has failed and been torn down: the process then
    has no peers, and running alone would be another job."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if _joined > 1:
        raise RuntimeError(
            f"this process joined a group of {_joined} processes, which "
            "failed and was torn down: start the processes again")
    return 1


def process_index() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(n_shards: Optional[int] = None, device: str = "cuda") -> Mesh:
    """The mesh over every process's devices: each process contributes
    its devices of ``device``'s type (one card, shared by a pair on a
    one-card machine, counts once a process)."""
    devs = default_devices(device)
    return make_mesh(n_shards or len(devs) * process_count(), None, device)


# -- host collectives with multihost_utils.process_allgather's semantics ----

def allgather_array(a: np.ndarray) -> np.ndarray:
    """Every process's ``a`` (same shape and dtype everywhere), stacked
    as ``[P, *a.shape]`` in process order. Moves the raw bytes, so any
    dtype travels."""
    a = np.ascontiguousarray(a)
    n = process_count()
    if n == 1:
        return a[None]
    dist = _dist()
    raw = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(out, raw)
    return np.stack([o.numpy().view(a.dtype).reshape(a.shape) for o in out])


def allgather_objects(obj) -> list:
    """Every process's picklable ``obj``, in process order."""
    n = process_count()
    if n == 1:
        return [obj]
    out = [None] * n
    _dist().all_gather_object(out, obj)
    return out
