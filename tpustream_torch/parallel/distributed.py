"""Multi-process initialization: the cluster side of the comm backend.

Counterpart of tpustream/parallel/distributed.py, which joins hosts with
``jax.distributed`` so that one SPMD program spans them. The port runs a
sharded job in one process (``parallel/mesh.py``: S shards over the
process's devices). Joining several processes, with
``torch.distributed`` underneath, is ROADMAP item 12b; until it lands, a
start that names more than one process is refused here.
"""

from __future__ import annotations

from typing import Optional

from .mesh import Mesh, default_devices, make_mesh


def _refuse(num_processes) -> None:
    raise NotImplementedError(
        f"a sharded job over {num_processes} processes is not ported to the "
        "PyTorch runtime yet (ROADMAP item 12b): the port shards a job over "
        "the devices of one process (StreamConfig(parallelism=S))"
    )


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this process to the cluster. One process (no arguments, or
    ``num_processes=1``) has nothing to join; more than one raises
    ``NotImplementedError`` (ROADMAP item 12b)."""
    if num_processes not in (None, 1) or (
            coordinator is not None and num_processes is None):
        _refuse(num_processes or "several")


def global_mesh(n_shards: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A mesh over the process's devices (the only process)."""
    devs = default_devices(device)
    return make_mesh(n_shards or len(devs), None, device)


def process_index() -> int:
    return 0


def is_coordinator() -> bool:
    return True

