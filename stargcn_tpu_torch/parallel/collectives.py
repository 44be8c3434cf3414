"""The collectives of the device mesh, as autograd functions in conjugate
pairs.

Where the JAX package annotates shardings and GSPMD inserts psums and
all-gathers, the port places them by hand, each paired with the transpose
autograd needs:

* ``enter``: identity forward, all-reduce backward, where a replicated
  tensor enters a computation split over an axis (each rank's partial
  cotangent is summed);
* ``leave``: all-reduce forward, identity backward, where the ranks'
  partial sums leave it (the cotangent is already whole on every rank);
* ``gather_rows``: all-gather of row shards forward, this rank's rows of
  the cotangent backward (the computation after it is replicated, so
  every rank holds the whole cotangent).

Replicated work is computed on every rank, and on the card it is not
bit-reproducible (``index_add_`` and row-gather gradients add with
atomics), so replicas would drift apart; ``from_first`` gives every rank
of a group its first rank's tensor (a broadcast), which keeps them
bit-equal.

A pair the wrong way round gives gradients off by a factor of the axis
size; ``tests/test_torch_mesh.py`` holds each against the single-process
function.

The module issues three collectives: ``all_reduce`` where partial sums
are added, ``all_gather`` where row shards are made whole (each rank
sends its own rows, so a gather moves ``1/m`` of what an all-reduce of the
whole tensor would) and ``broadcast`` for ``from_first`` and
``broadcast_``.  Every collective of the port goes through them, so
``counted()`` sees them all: while it is open, each call is recorded with
its kind, the mesh axis of its group (``make_mesh`` names them) and its
bytes (the reduced tensor, the gathered whole, the broadcast tensor),
which ``parallel/perfmodel.py:modeled_collectives`` states in advance.
The same calls serve NCCL, gloo on CUDA tensors (two ranks that share one card: NCCL
refuses two ranks on one device; gloo ran every collective it was given
on CUDA tensors, torch 2.11) and gloo on the CPU.  A reduced-precision
tensor is summed in float32.  Nothing is skipped on an axis of one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

# The mesh axis of each process group, by id (``name_group``), and the
# counters open now (``counted``).
_AXIS_OF = {}
_OPEN = []


def name_group(group, axis: str) -> None:
    """Record that ``group`` is a group of mesh ``axis`` ('data', 'model'
    or 'all'), under which ``counted`` files its collectives."""
    _AXIS_OF[id(group)] = axis


@dataclasses.dataclass
class CollectiveCounts:
    """The collectives issued while ``counted()`` was open: ``calls``
    holds ``(kind, axis, bytes)`` in issue order."""

    calls: list = dataclasses.field(default_factory=list)

    def by_kind(self) -> dict:
        """``{kind: {axis: [count, bytes]}}`` of the calls."""
        out = {}
        for kind, axis, nbytes in self.calls:
            entry = out.setdefault(kind, {}).setdefault(axis, [0, 0])
            entry[0] += 1
            entry[1] += nbytes
        return out

    @property
    def count(self) -> int:
        return len(self.calls)


@contextlib.contextmanager
def counted():
    """While open, every collective this module issues is recorded in the
    ``CollectiveCounts`` it yields (counters may nest)."""
    counts = CollectiveCounts()
    _OPEN.append(counts)
    try:
        yield counts
    finally:
        _OPEN.remove(counts)


def _record(kind, group, t: torch.Tensor) -> None:
    if _OPEN:
        call = (kind, _AXIS_OF.get(id(group), "other"),
                t.numel() * t.element_size())
        for counts in _OPEN:
            counts.calls.append(call)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd); returns ``t``."""
    if t.dtype in (torch.float16, torch.bfloat16):
        wide = t.float()
        _record("all_reduce", group, wide)
        dist.all_reduce(wide, group=group)
        return t.copy_(wide)
    _record("all_reduce", group, t)
    dist.all_reduce(t, group=group)
    return t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in a new tensor (no autograd)."""
    return all_reduce_(t.detach().contiguous().clone(), group)


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``local`` (the same shape on each) stacked along dim 0
    in the order of the ranks in ``group`` (no autograd)."""
    local = local.detach().contiguous()
    n, rows = dist.get_world_size(group), local.shape[0]
    out = local.new_empty((n * rows,) + tuple(local.shape[1:]))
    _record("all_gather", group, out)
    dist.all_gather([out[i * rows:(i + 1) * rows] for i in range(n)], local,
                    group=group)
    return out


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` (contiguous) with ``group``'s first rank's ``t`` in
    place (no autograd); returns ``t``.  Every rank gives a tensor of the
    same shape and dtype."""
    _record("broadcast", group, t)
    dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t


def from_first(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor of ``group``'s first rank on every rank of it, in a new
    tensor (no autograd): a broadcast, so the result is that rank's bits
    exactly."""
    if t.dtype in (torch.float16, torch.bfloat16):
        # float32 holds every value of these exactly.
        return broadcast_(t.detach().float(), group).to(t.dtype)
    return broadcast_(t.detach().contiguous().clone(), group)


def barrier(group, device) -> None:
    """Wait for every rank of ``group`` (an all-reduce of one value on
    ``device``, so no backend has to guess the rank's device)."""
    all_reduce_(torch.zeros(1, device=device), group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        rows = local.shape[0]
        lo = dist.get_rank(group) * rows
        ctx.rows = (lo, lo + rows)
        return all_gather_rows(local, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce over ``group`` backward."""
    return _Enter.apply(x, group)


def leave(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward, identity backward."""
    return _Leave.apply(x, group)


def gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """All-gather of row shards forward (``all_gather_rows``: the ranks'
    equal slices, in the order of the ranks in ``group``); this rank's
    rows of the cotangent backward."""
    return _GatherRows.apply(local, group)
