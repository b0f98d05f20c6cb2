"""The shard mesh of a sharded streaming job.

Counterpart of tpustream/parallel/mesh.py. The reference scales by
running N parallel subtasks with a key-hash exchange between them
(Flink's only shuffle, SURVEY.md §2.3); the mesh axis ``"shards"`` plays
the subtask role: keyed state is sharded over it, and ``keyBy`` becomes
an all-to-all. The reference builds a ``jax.sharding.Mesh`` and lets
``shard_map`` supply the collectives; here a :class:`Mesh` is S shards,
shard ``i`` on one of the process's ``devices``, and it carries the
collectives itself: each shard's step runs on a host thread of its own
(``runtime/sharded.py``), and ``axis_index``, ``pmax``, ``psum`` and
``all_to_all`` are rendezvous points of those threads. On one card all
S shards sit on it, as the JAX package's tests put eight virtual
devices on one CPU. Under a ``torch.distributed`` group
(``parallel/distributed.py``) the shards span the processes, each
process running the threads of its own contiguous block, and a
collective adds one call on the group to the threads' rendezvous.

If a shard fails, :meth:`Mesh.abort` breaks the rendezvous: every shard
waiting in a collective (or reaching one later) raises
:class:`MeshAborted`, so the group fails together instead of hanging.
"""

from __future__ import annotations

import threading
import time
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
    """S shards over ``devices`` (in one process, shard ``i`` on
    ``devices[i % len(devices)]``), with the collectives ``shard_map``
    gives the reference. Every collective is called once by each of the
    process's shards (their threads), with the caller's global
    ``shard`` index.

    Under a process group of ``P`` ranks (``parallel/distributed.py``)
    the S shards span the processes: rank ``p`` holds the contiguous
    shards :attr:`local_shards`, ``p*S/P .. (p+1)*S/P - 1`` (the
    reference sorts its devices by process for the same block). A
    collective is then a rendezvous of the process's shard threads and
    one call on the group, made by the thread that arrives last (the
    barrier's action), so the group is never called by two threads of
    a process at once; every result is in global shard order."""

    def __init__(self, n_shards: int, devices: Sequence[torch.device]):
        from .distributed import process_count, process_index

        self.size = int(n_shards)
        self.devices = [torch.device(d) for d in devices]
        self.n_procs = process_count()
        self.process = process_index()
        if self.size % self.n_procs:
            raise ValueError(
                f"parallelism ({self.size}) must divide evenly by the "
                f"process count ({self.n_procs})")
        self.n_local = self.size // self.n_procs
        self.first = self.process * self.n_local
        self.local_shards = range(self.first, self.first + self.n_local)
        self.axis_names = (AXIS,)
        # what the collectives that crossed processes cost: calls, wall
        # seconds and the bytes this process sent
        self.xproc_calls = 0
        self.xproc_seconds = 0.0
        self.xproc_bytes = 0
        self._aborted = False
        self._abort_lock = threading.Lock()
        self.reset()

    @property
    def multiprocess(self) -> bool:
        return self.n_procs > 1

    def run_shard(self, fn, *args):
        """Run ``fn(*args)`` as one shard's step: holding the baton,
        which a collective hands on while it waits."""
        with self._baton:
            return fn(*args)

    def device_of(self, shard: int) -> torch.device:
        return self.devices[(shard - self.first) % len(self.devices)]

    # -- the group ------------------------------------------------------
    def abort(self) -> None:
        """Break the rendezvous: every shard in or entering a collective
        raises :class:`MeshAborted`. Across processes the group is torn
        down too, so a peer waiting in a collective raises at once
        instead of waiting out its timeout (a pair that failed ends).
        Every failing shard calls this; one of them tears the group
        down, once."""
        self._barrier.abort()
        if not self.multiprocess:
            return
        with self._abort_lock:
            if self._aborted:
                return
            self._aborted = True
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def reset(self) -> None:
        """A fresh rendezvous for the next step (after an abort)."""
        self._barrier = threading.Barrier(
            self.n_local,
            action=self._cross if self.multiprocess else None,
            timeout=RENDEZVOUS_TIMEOUT_S)
        self._slots = [None] * self.n_local
        self._result = None
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

    def _rendezvous(self, shard: int, op: str, value):
        """Post ``value``; once every local shard posted, the result of
        ``op`` over all shards (a list in global shard order for
        ``gather``, this shard's block for ``a2a``)."""
        i = shard - self.first
        self._slots[i] = (op, value)
        self._wait()  # all posted (and, across processes, exchanged)
        if self.multiprocess:
            out = self._result
            out = out[i] if op == "a2a" else out
        else:
            out = [v for _, v in self._slots]
        self._wait()  # all read before any shard posts again
        return out

    def _gather(self, shard: int, value) -> list:
        """Every shard's ``value``, in global shard order, to every
        shard."""
        return self._rendezvous(shard, "gather", value)

    # -- the cross-process half (one thread a process) ---------------------
    def _cross(self) -> None:
        t0 = time.perf_counter()
        op = self._slots[0][0]
        vals = [v for _, v in self._slots]
        if op == "a2a":
            self._result = self._cross_all_to_all(vals)
        else:
            self._result = self._cross_gather(vals)
        self.xproc_calls += 1
        self.xproc_seconds += time.perf_counter() - t0

    def _cross_gather(self, vals: list) -> list:
        from .distributed import allgather_array, allgather_objects

        x = vals[0]
        if isinstance(x, torch.Tensor):
            host = torch.stack([v.detach().to("cpu") for v in vals]).numpy()
            self.xproc_bytes += host.nbytes
            g = allgather_array(host).reshape((-1,) + host.shape[1:])
            return list(torch.from_numpy(g).to(x.device).unbind(0))
        if isinstance(x, np.ndarray):
            host = np.stack(vals)
            self.xproc_bytes += host.nbytes
            g = allgather_array(host)
            return list(g.reshape((-1,) + host.shape[1:]))
        parts = allgather_objects(vals)
        return [v for part in parts for v in part]

    def _cross_all_to_all(self, vals: list) -> list:
        import torch.distributed as dist

        p, n = self.n_procs, self.n_local
        x = vals[0]
        rest = tuple(x.shape[1:])
        # [L (source), S (dest), ...] -> [P (dest process), L, L, ...]
        host = torch.stack([v.detach().to("cpu") for v in vals])
        host = host.reshape((n, p, n) + rest).transpose(0, 1).contiguous()
        send = host.reshape(-1).view(torch.uint8)
        recv = torch.empty_like(send)
        self.xproc_bytes += send.numel()
        dist.all_to_all_single(recv, send)
        got = recv.view(x.dtype).reshape((p, n, n) + rest)
        # shard j's block: source shards in global order, then rows
        return [got[:, :, j].reshape((self.size * rest[0],) + rest[1:])
                .to(vals[j].device) for j in range(n)]

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
        """The sum of the shards' ``x``, added in global shard order (a
        fixed float order, which ``gloo``'s own sum would not give)."""
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
        if self.multiprocess:
            return self._rendezvous(shard, "a2a", x)
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
