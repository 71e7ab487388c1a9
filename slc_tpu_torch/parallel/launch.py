"""Joining a cluster, global meshes and the host batch feed (port of
slc_tpu/parallel/launch.py on ``torch.distributed``).

slc_tpu runs one process per host that drives every device of the host
(``jax.distributed``). The port runs one process (rank) per device, so
it joins a ``torch.distributed`` process group: NCCL with the rank on
``cuda:{LOCAL_RANK % device_count}``, or gloo on the CPU when the caller
passes ``device="cpu"``. One process per rank, started by any launcher,
then::

    from slc_tpu_torch.parallel import launch
    ctx = launch.initialize()              # env-driven, or pass explicitly
    mesh = launch.global_tile_mesh(scan=2)
    rows = launch.local_scan_slice(mesh, n_scans)
    tile = launch.shard_host_batch(mesh, scans[rows], (SCAN, TILE_Y, TILE_X))

The environment contract is slc_tpu's:

* ``SLC_COORDINATOR``: ``host:port`` of rank 0 (or an init URL, e.g.
  ``file:///path``);
* ``SLC_NUM_PROCESSES``: the number of ranks;
* ``SLC_PROCESS_ID``: this rank.

:class:`LocalCluster` starts n ranks on this host for tests and
``entry.dryrun_multichip``: each a spawned process in a process group
with a timeout, torn down at the end.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from slc_tpu_torch.calib import resolve_device
from slc_tpu_torch.parallel import mesh as _mesh
from slc_tpu_torch.parallel.mesh import (SCAN, TILE_X, TILE_Y, axis_index,
                                         axis_size, mesh_device, tile_mesh)

#: Seconds a rank waits in the rendezvous or in one collective before it
#: fails, and a :class:`LocalCluster` call before it gives up.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What a rank needs to know about the cluster it joined."""

    process_index: int
    process_count: int
    device: torch.device
    backend: Optional[str]       # None: no process group (one rank)

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> DistributedContext:
    """Join (or stand alone as) a cluster and describe it.

    Each argument is taken from the call, else from its ``SLC_*``
    variable. With nothing in either (and no process group yet) the
    process stands alone: no process group, one rank, mesh ``None``.
    Otherwise it joins a process group of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port`` for TCP, or any init URL):
    NCCL on ``cuda:{LOCAL_RANK % device_count}`` (LOCAL_RANK defaults to
    the rank), or gloo when ``device`` is ``"cpu"``. ``timeout_s`` bounds
    the rendezvous and every collective. Safe to call again: later calls
    describe the group already joined."""
    coordinator_address = (coordinator_address
                           or os.environ.get("SLC_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("SLC_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SLC_PROCESS_ID")
        process_id = int(env) if env else None

    dev = torch.device(device)
    multi = coordinator_address is not None or (num_processes or 1) > 1
    if multi and not dist.is_initialized():
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "joining a cluster needs the coordinator address, the "
                "number of processes and this process's id (arguments or "
                "SLC_COORDINATOR / SLC_NUM_PROCESSES / SLC_PROCESS_ID)")
        if dev.type == "cuda":
            resolve_device(dev)
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=url,
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))

    if not dist.is_initialized():
        return DistributedContext(0, 1, resolve_device(dev), None)
    backend = dist.get_backend()
    here = (torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
    return DistributedContext(dist.get_rank(), dist.get_world_size(), here,
                              backend)


def shutdown() -> None:
    """Leave the process group, if any, and forget its meshes' groups."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh._TILE_GROUPS.clear()


def global_tile_mesh(scan: int = 1,
                     tiles: Optional[Tuple[int, int]] = None):
    """A (scan, ty, tx) mesh over every rank of the process group (the
    1x1x1 mesh ``None`` without one). The port's launchers put every rank
    on one host, so by default the tiles span them all; ``scan`` > 1
    splits them into scan groups of whole tile grids."""
    return tile_mesh(scan=scan, tiles=tiles)


def local_scan_slice(mesh, total_scans: int) -> slice:
    """Which rows of the global scan axis this rank should load: the
    scan axis split evenly over the mesh's scan groups, the block of this
    rank's group."""
    n_groups = axis_size(mesh, SCAN)
    if total_scans % n_groups:
        raise ValueError(
            f"{total_scans} scans not divisible by scan axis {n_groups}")
    per_group = total_scans // n_groups
    g = axis_index(mesh, SCAN)
    return slice(g * per_group, (g + 1) * per_group)


def shard_host_batch(mesh, local_data, spec: Sequence[Optional[str]] = (SCAN,),
                     device=None) -> torch.Tensor:
    """This rank's block of a global array, from the rows of the scan
    axis its process loaded (:func:`local_scan_slice`). ``spec`` names
    the mesh dim each leading dim is sharded over, as a PartitionSpec
    does: the scan dim is already this rank's; each ``TILE_Y`` /
    ``TILE_X`` dim is split by this rank's coordinate. On the rank's
    device (``device``, or the mesh's, or the card)."""
    x = torch.as_tensor(np.asarray(local_data))
    for dim, name in enumerate(spec):
        if name not in (TILE_Y, TILE_X):
            continue
        n = axis_size(mesh, name)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {name}={n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, name) * step, step)
    dev = device or mesh_device(mesh) or "cuda"
    return x.contiguous().to(resolve_device(dev))


def _rank_main(rank: int, n: int, init_method: str, device: str,
               timeout_s: float, tasks, results) -> None:
    """A :class:`LocalCluster` rank: join, report, then run each task
    (``(fn, args)``, None to stop) and report its result or traceback."""
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        initialize(init_method, n, rank, device=device, timeout_s=timeout_s)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


class LocalCluster:
    """``n`` ranks on this host, each a spawned process that joins one
    process group (gloo for ``device="cpu"``, else NCCL, a card per
    rank) through a file store in a fresh temporary directory, then runs
    the tasks :meth:`run` hands it. The ranks import only what the tasks'
    modules import.

    A rank that raises, dies or outlasts the timeout ends the whole
    cluster: :meth:`run` kills every rank and raises, so a fault fails
    its caller instead of leaving the others waiting in a collective.
    Use as a context manager, or call :meth:`close`."""

    def __init__(self, n: int, device="cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a cluster needs at least one rank, got {n}")
        if torch.device(device).type == "cuda":
            resolve_device(device)
            if torch.cuda.device_count() < n:
                raise ValueError(f"{n} ranks need {n} cards, this host "
                                 f"has {torch.cuda.device_count()}")
        self.n = n
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="slc_cluster_")
        init = "file://" + os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.SimpleQueue() for _ in range(n)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(rank, n, init, str(device), timeout_s,
                              self._tasks[rank], self._results))
            for rank in range(n)]
        for p in self._procs:
            p.start()
        self._collect("joining the process group", timeout_s)

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _collect(self, what: str, timeout_s: float) -> List[object]:
        """One result from every rank, by rank; on a fault, kill all."""
        out, deadline = {}, time.monotonic() + timeout_s
        while len(out) < self.n:
            dead = [r for r, p in enumerate(self._procs)
                    if p.exitcode is not None and r not in out]
            late = time.monotonic() > deadline
            try:
                # After a death, wait a little for what it sent last.
                rank, ok, value = self._results.get(
                    timeout=1.0 if dead or late else 0.2)
            except queue.Empty:
                if dead or late:
                    why = (f"rank {dead[0]} exited with code "
                           f"{self._procs[dead[0]].exitcode}" if dead
                           else f"no result within {timeout_s:g} s")
                    self.close(kill=True)
                    raise RuntimeError(f"cluster of {self.n} failed "
                                       f"{what}: {why}") from None
                continue
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed {what}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.n)]

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None
            ) -> List[object]:
        """``fn(*args)`` on every rank at once; the list of results by
        rank. ``fn`` must be a module-level function (the ranks import it
        by name) and its results picklable (CPU data)."""
        if not self._procs:
            raise RuntimeError("the cluster is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(f"in {fn.__name__}",
                             timeout_s or self.timeout_s)

    def close(self, kill: bool = False) -> None:
        """Stop every rank (``kill``: at once) and remove the store."""
        if kill:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
        else:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)


__all__ = ["DistributedContext", "initialize", "shutdown",
           "global_tile_mesh", "shard_host_batch", "local_scan_slice",
           "LocalCluster", "SCAN", "TILE_Y", "TILE_X"]
