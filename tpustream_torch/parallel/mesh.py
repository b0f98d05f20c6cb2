"""The shard mesh of a sharded streaming job, in one process.

Counterpart of tpustream/parallel/mesh.py. The reference scales by
running N parallel subtasks with a key-hash exchange between them
(Flink's only shuffle, SURVEY.md §2.3); the mesh axis ``"shards"`` plays
the subtask role: keyed state is sharded over it, and ``keyBy`` becomes
an all-to-all. The reference builds a ``jax.sharding.Mesh`` and lets
``shard_map`` supply the collectives; here a :class:`Mesh` is S shards
of one process, shard ``i`` on ``devices[i % len(devices)]``, and it
carries the collectives itself: each shard's step runs on a host thread
of its own (``runtime/sharded.py``), and ``axis_index``, ``pmax``,
``psum`` and ``all_to_all`` are rendezvous points of those threads. On
one card all S shards sit on it, as the JAX package's tests put eight
virtual devices on one CPU.

If a shard fails, :meth:`Mesh.abort` breaks the rendezvous: every shard
waiting in a collective (or reaching one later) raises
:class:`MeshAborted`, so the group fails together instead of hanging.
Several processes are ROADMAP item 12b (``parallel/distributed.py``).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

AXIS = "shards"


class MeshAborted(RuntimeError):
    """A collective of a mesh whose group was aborted by a failing shard."""


def owner_of(key_id, n_shards: int):
    """Key ownership: the analog of Flink's ``hash(key) % parallelism``
    routing (chapter2/.../ComputeCpuMax.java:26). Interned ids are dense
    already, so plain modulo keeps each shard's state slots dense."""
    return key_id % n_shards


def local_slot(key_id, n_shards: int):
    return key_id // n_shards


def global_key(local_slot_id, shard_idx, n_shards: int):
    return local_slot_id * n_shards + shard_idx


def default_devices(device: str = "cuda") -> List[torch.device]:
    """The process's devices of ``device``'s type: the CUDA cards in
    order (or the one named), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# seconds a shard waits in a collective for the others before the mesh
# breaks: a shard that skips a collective the others make (a bug) fails
# the step instead of hanging it
RENDEZVOUS_TIMEOUT_S = 600.0


class Mesh:
    """S shards of one process over ``devices`` (shard ``i`` on
    ``devices[i % len(devices)]``), with the collectives ``shard_map``
    gives the reference. Every collective is called once by each of the
    S shards (their threads), with the caller's ``shard`` index."""

    def __init__(self, n_shards: int, devices: Sequence[torch.device]):
        self.size = int(n_shards)
        self.devices = [torch.device(d) for d in devices]
        self._slots: List = [None] * self.size
        self._barrier = threading.Barrier(self.size,
                                          timeout=RENDEZVOUS_TIMEOUT_S)
        # one shard's thread issues work at a time, from one collective
        # to the next (the host issue is serial under the interpreter
        # lock anyway; without the baton, S threads issuing small ops
        # hand the lock to each other after every op)
        self._baton = threading.Lock()
        self.axis_names = (AXIS,)

    def run_shard(self, fn, *args):
        """Run ``fn(*args)`` as one shard's step: holding the baton,
        which a collective hands on while it waits."""
        with self._baton:
            return fn(*args)

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard % len(self.devices)]

    # -- the group ------------------------------------------------------
    def abort(self) -> None:
        """Break the rendezvous: every shard in or entering a collective
        raises :class:`MeshAborted`."""
        self._barrier.abort()

    def reset(self) -> None:
        """A fresh rendezvous for the next step (after an abort)."""
        self._barrier = threading.Barrier(self.size,
                                          timeout=RENDEZVOUS_TIMEOUT_S)
        self._slots = [None] * self.size
        self._baton = threading.Lock()

    def _wait(self) -> None:
        self._baton.release()
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MeshAborted(
                "another shard of the mesh failed, or did not reach this "
                f"collective within {RENDEZVOUS_TIMEOUT_S} s") from None
        finally:
            self._baton.acquire()

    def _gather(self, shard: int, value) -> list:
        """Every shard's ``value``, in shard order, to every shard."""
        self._slots[shard] = value
        self._wait()  # all posted
        out = list(self._slots)
        self._wait()  # all read before any shard posts again
        return out

    # -- collectives ------------------------------------------------------
    def axis_index(self, shard: int) -> int:
        return shard

    def pmax(self, shard: int, x):
        """The largest of the shards' ``x`` (host ints, host arrays or
        tensors), elementwise."""
        vals = self._gather(shard, x)
        if isinstance(x, torch.Tensor):
            dev = x.device
            return torch.stack([v.to(dev) for v in vals]).max(dim=0).values
        if isinstance(x, np.ndarray):
            return np.max(np.stack(vals), axis=0)
        return max(vals)

    def psum(self, shard: int, x):
        """The sum of the shards' ``x``, added in shard order."""
        vals = self._gather(shard, x)
        if isinstance(x, torch.Tensor):
            dev = x.device
            out = vals[0].to(dev)
            for v in vals[1:]:
                out = out + v.to(dev)
            return out
        if isinstance(x, np.ndarray):
            return np.sum(np.stack(vals), axis=0)
        return sum(vals)

    def all_to_all(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0)``: with
        ``x`` of shape ``[S, cap, ...]`` on each shard, shard ``j`` gets
        the concatenation over source shards ``i = 0..S-1`` (in that
        order) of ``x_i[j]``."""
        parts = self._gather(shard, x)
        dev = x.device
        return torch.cat([p[shard].to(dev) for p in parts], dim=0)


def make_mesh(n_shards: int, devices: Optional[list] = None,
              device: str = "cuda") -> Mesh:
    """A mesh of ``n_shards`` over ``devices``; by default the process's
    devices of ``device``'s type (the card unless the caller asks for
    the CPU, CUDA devices in order). An explicit device list shorter
    than ``n_shards`` is refused, as the reference refuses it."""
    if devices is not None:
        devs = list(devices)
        if n_shards > len(devs):
            raise RuntimeError(
                f"parallelism {n_shards} exceeds available devices "
                f"({len(devs)}); use --xla_force_host_platform_device_count "
                "for CPU testing"
            )
        devs = devs[:n_shards]
    else:
        devs = default_devices(device)
    return Mesh(n_shards, devs)
