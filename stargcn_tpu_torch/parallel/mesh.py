"""Device meshes over ``torch.distributed``.

The port of ``stargcn_tpu/parallel/mesh.py``.  The JAX package lays its
devices out as a ``jax.sharding.Mesh`` over ('data', 'model') and lets XLA
insert the collectives; here every rank is one process with one device,
the mesh lays the ranks of the world out on the same grid (rank ``r`` at
``(r // model, r % model)``, as ``np.asarray(devices).reshape(data,
model)`` places device ``r``), and the collectives are explicit calls on
one process group per axis (``parallel/collectives.py``):

* the 'model' group of a rank is its row of the grid (the ranks that
  share its data index): edge shards, bit-pack row shards and embedding
  row shards are split over it;
* the 'data' group is its column: the rating batch is split over it and
  the gradients are summed over it.

Every group exists even where its axis has one rank, and every collective
of a step is issued on it, so a 1 x 1 mesh on the card goes through NCCL
like any other.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from stargcn_tpu_torch.parallel.collectives import name_group

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'model') grid of the world's ranks.

    ``grid[i, j]`` is the global rank at data index ``i`` and model index
    ``j``; ``rank`` is this process's; ``groups`` holds this rank's process
    group of each axis, and under ``"all"`` the group of the whole grid.
    ``shape`` is ``{"data": d, "model": m}``, read as the JAX trainer
    reads ``mesh.shape["data"]``."""

    grid: np.ndarray
    rank: int
    groups: dict
    backend: str

    @property
    def shape(self) -> dict:
        return {"data": int(self.grid.shape[0]),
                "model": int(self.grid.shape[1])}

    @property
    def leader(self) -> bool:
        """Whether this rank is the grid's first (it writes the files)."""
        return self.rank == int(self.grid[0, 0])

    @property
    def coords(self):
        """``(data index, model index)`` of this rank."""
        i, j = np.argwhere(self.grid == self.rank)[0]
        return int(i), int(j)

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[AXES.index(axis)]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis`` ('data', 'model', or
        'all' for the whole grid)."""
        return self.groups[axis]


def default_backend(device) -> str:
    """NCCL for ranks on the card, gloo for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda", backend=None):
    """Join this process to a world of ``num_processes`` ranks, as rank
    ``process_id``; call once per process before ``make_mesh``.  A no-op
    when ``coordinator_address`` is None (a single-process run).

    ``coordinator_address`` is ``host:port`` of rank 0 (read as
    ``tcp://host:port``), or a ``torch.distributed`` init URL such as
    ``file:///shared/path`` used as it is.  ``backend`` defaults to NCCL on
    ``cuda`` and gloo on ``cpu``; two ranks that share one card must pass
    ``backend="gloo"`` (NCCL refuses two ranks on one device).  On
    ``cuda`` the process's card is ``process_id`` modulo the cards it
    sees."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else "tcp://" + coordinator_address)
    dist.init_process_group(
        backend or default_backend(dev), init_method=url,
        world_size=int(num_processes), rank=int(process_id))


def _world_of_one(device):
    """Open a world of one rank (no coordinator: an in-memory store)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    dist.init_process_group(default_backend(dev), store=dist.HashStore(),
                            world_size=1, rank=0)


def make_mesh(data: int = 1, model: int = 1, devices=None,
              device="cuda") -> Mesh:
    """Build a ('data', 'model') mesh over the world's ranks.

    ``data`` splits the rating batch (gradients are summed over it);
    ``model`` splits the edge arrays, the bit-pack rows and the embedding
    rows (partial sums are added over it).  ``devices`` lists the global
    ranks to lay out, ascending (default: all); the first ``data * model``
    fill the grid row by row, so each axis group's ranks run in the order
    of their positions on the axis, the order in which an all-gather
    stacks their slices.  Every rank of the world must call this with
    the same arguments (each axis group is created collectively); a rank
    past the grid takes no part in the mesh.

    In a process that never joined a world, ``make_mesh(1, 1)`` opens a
    world of one on ``device`` (NCCL on ``cuda``, gloo on ``cpu``)."""
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} ranks; this "
                "process joined no world (initialize_distributed)")
        _world_of_one(device)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    need = data * model
    if data < 1 or model < 1 or len(ranks) < need:
        raise ValueError(f"mesh {data}x{model} needs {need} ranks, have "
                         f"{len(ranks)}")
    if any(a >= b for a, b in zip(ranks, ranks[1:])):
        raise ValueError(f"devices must list ranks in ascending order, not "
                         f"{ranks}")
    grid = np.asarray(ranks[:need], np.int64).reshape(data, model)
    me = dist.get_rank()
    groups = {}
    # Every rank creates every group, in one order.
    for axis, lines in (("model", list(grid)), ("data", list(grid.T)),
                        ("all", [grid.ravel()])):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = g
                name_group(g, axis)
    return Mesh(grid=grid, rank=me, groups=groups,
                backend=dist.get_backend())


def rank_backend(device, world: int):
    """``(backend, shared)`` for ``world`` ranks on ``device``: NCCL with
    one card a rank; gloo on the CPU, and where the ranks would share a
    card (NCCL refuses two ranks on one device; ``shared`` is then true,
    and what those ranks time measures correctness, not scaling)."""
    if torch.device(device).type != "cuda":
        return "gloo", False
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    shared = torch.cuda.device_count() < world
    return ("gloo" if shared else "nccl"), shared


def _rank_entry(rank, world, url, device, backend, fn, args):
    torch.set_num_threads(2)
    initialize_distributed(url, world, rank, device=device, backend=backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by ``start_ranks``; ``wait`` joins them."""

    def __init__(self, ctx, name, world, timeout, own_dir):
        self.ctx, self.name, self.world = ctx, name, world
        self.timeout, self.own_dir = timeout, own_dir
        self.deadline = time.monotonic() + timeout

    def wait(self) -> None:
        """Raise when a rank raised or when the ranks outlive their
        timeout (they are killed then)."""
        try:
            while not self.ctx.join(
                    timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(
                        f"{self.name}: {self.world} ranks still running "
                        f"after {self.timeout:.0f} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            if self.own_dir:
                shutil.rmtree(self.own_dir, ignore_errors=True)


def start_ranks(fn, world: int, args=(), *, device, backend=None,
                timeout: float = 600.0, rendezvous_dir=None) -> Ranks:
    """Start ``fn(rank, *args)`` in ``world`` spawned processes joined into
    one world (``initialize_distributed`` on ``device`` through a
    rendezvous file in ``rendezvous_dir``, by default a temporary
    directory removed by ``wait``; ``backend`` as there), each capped at
    two torch threads, and return at once.  ``fn`` must be importable by
    name (a module-level function)."""
    import torch.multiprocessing as mp

    own = None
    if rendezvous_dir is None:
        rendezvous_dir = own = tempfile.mkdtemp(prefix="stargcn_ranks_")
    url = "file://" + os.path.join(
        str(rendezvous_dir), f"rdzv_{fn.__name__}_{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_entry, args=(world, url, device, backend, fn, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, fn.__name__, world, timeout, own)


def spawn_ranks(fn, world: int, args=(), *, device, backend=None,
                timeout: float = 600.0) -> None:
    """``start_ranks`` and wait: raises when a rank raises or when the
    ranks outlive ``timeout`` seconds."""
    start_ranks(fn, world, args, device=device, backend=backend,
                timeout=timeout).wait()
