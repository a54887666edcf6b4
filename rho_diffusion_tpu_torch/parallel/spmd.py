"""Single-controller SPMD: one process runs every rank of a mesh.

The JAX package runs one program per device under ``shard_map`` or GSPMD,
and XLA inserts the collectives. The port drives every rank from one
process (``parallel/mesh.py``), and each rank's share of the work lives on
that rank's device and is computed there:

* without spatial sharding, a data rank is one call: its batch rows, run
  under the 1 x n mesh of its context ranks (so attention rings over them,
  ``parallel/context.py``);
* with spatial sharding (``training.spatial_sharding``, or a service whose
  context axis is > 1) the context ranks of a data rank each hold a depth
  slab of every 5-D activation, and run as threads in lockstep: the model
  code of every rank is the same, and where it needs its neighbours (the
  halo planes of a conv, GroupNorm's sums, attention's K/V) it calls
  ``exchange``, which hands every rank's value to one function of them all
  and gives each rank its part of the result.

The threads take turns: one rank runs at a time, up to its next exchange,
then hands over to the next; the last rank of the group runs the
exchange's function and hands back to the first. So the ranks' launches
reach the card in a fixed order (a run is as repeatable as one rank's), no
two threads touch the kernel wrappers' caches or counters at once, and no
rank ever blocks on the device. The exchanges are plain tensor operations
(copies between the ranks' devices, sums, concatenations) that autograd
records, so one ``backward()`` over the sum of the ranks' losses gives
every rank's gradients: nothing waits inside a backward.

A rank thread inherits the caller's grad mode and the caller's current
CUDA stream on every device of the mesh (a service launches on a stream of
its own).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from rho_diffusion_tpu_torch.parallel.mesh import Mesh, active_mesh

_LOCAL = threading.local()


class RankAborted(RuntimeError):
    """Raised in a rank whose group stopped because another rank failed."""


@dataclass(frozen=True)
class Rank:
    """The rank the calling thread runs: its mesh coordinates, its device,
    whether it holds a depth slab (``spatial``) and its context group."""

    data: int
    context: int
    device: torch.device
    spatial: bool
    group: "Group"


def current_rank() -> Optional[Rank]:
    """The rank the calling thread runs, or None outside ``run_ranks``."""
    return getattr(_LOCAL, "rank", None)


def spatial_rank() -> Optional[Rank]:
    """The calling thread's rank when it holds one of several depth slabs."""
    rank = current_rank()
    return rank if rank is not None and rank.spatial and rank.group.n > 1 else None


class Group:
    """The context ranks of one data rank, run as threads that take turns.

    Each rank waits on a semaphore of its own, and a hand-over releases only
    the next rank's: one thread wakes a turn, so a rank that launches
    kernels is not slowed by the others waking to check whose turn it is."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        self.devices = list(devices)
        self.n = len(self.devices)
        self._lock = threading.Lock()
        self._go = [threading.Semaphore(1 if r == 0 else 0) for r in range(self.n)]
        self._done = [False] * self.n
        self._inputs: list = [None] * self.n
        self._outputs: Optional[list] = None
        self._failed: Optional[BaseException] = None

    def _wait_turn(self, rank: int) -> None:
        self._go[rank].acquire()
        if self._failed is not None:
            raise RankAborted(f"context rank {rank} stopped: another rank failed "
                              f"({type(self._failed).__name__}: {self._failed})")

    def _pass(self, to: int) -> None:
        with self._lock:
            if self._done[to] and not all(self._done):
                self._failed = RuntimeError("the context ranks made different numbers of "
                                            "exchanges")
        if self._failed is not None:
            self._wake_all()
        else:
            self._go[to].release()

    def _wake_all(self) -> None:
        for go in self._go:
            go.release()

    def fail(self, error: BaseException) -> None:
        with self._lock:
            if self._failed is None:
                self._failed = error
        self._wake_all()

    @contextlib.contextmanager
    def turn(self, rank: int):
        """Run the body as rank ``rank``: from its first turn, handing over
        to the next rank at the end."""
        self._wait_turn(rank)
        yield
        with self._lock:
            self._done[rank] = True
        self._pass((rank + 1) % self.n)

    def exchange(self, rank: int, value: Any, fn: Callable[[list], list]) -> Any:
        """Rank ``rank``'s part of ``fn([value of rank 0, ..., of rank n-1])``.
        Every rank calls it at the same point of the same program; ``fn`` runs
        once, in the last rank's thread."""
        if self.n == 1:
            return fn([value])[0]
        self._inputs[rank] = value
        if rank == self.n - 1:
            try:
                outputs = fn(list(self._inputs))
            except BaseException as e:
                self.fail(e)
                raise
            if len(outputs) != self.n:
                raise ValueError(f"an exchange gave {len(outputs)} parts for {self.n} ranks")
            self._outputs = list(outputs)
            self._inputs = [None] * self.n
        self._pass((rank + 1) % self.n)
        self._wait_turn(rank)
        return self._outputs[rank]


def exchange(value: Any, fn: Callable[[list], list]) -> Any:
    """Inside a rank of ``run_ranks``: this rank's part of ``fn`` over every
    context rank's ``value`` (``Group.exchange``)."""
    rank = current_rank()
    if rank is None:
        raise RuntimeError("exchange() is called from inside a rank of run_ranks")
    return rank.group.exchange(rank.context, value, fn)


def sum_to_each(values: list) -> list:
    """Every rank's tensor summed, in rank order, the sum on each rank's
    device (the psum of a cross-rank reduction)."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(total.device)
    return [total.to(v.device) for v in values]


@contextlib.contextmanager
def _streams(streams: dict):
    with contextlib.ExitStack() as stack:
        for stream in streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        yield


@contextlib.contextmanager
def _as_rank(rank: Rank, grad: bool, streams: dict, mesh_of_thread: Mesh):
    prev = current_rank()
    _LOCAL.rank = rank
    try:
        with torch.set_grad_enabled(grad), _streams(streams), active_mesh(mesh_of_thread):
            yield
    finally:
        _LOCAL.rank = prev


def run_ranks(mesh: Mesh, fn: Callable[[Rank], Any], spatial: bool) -> list[list]:
    """``fn(rank)`` for every rank of ``mesh``: ``out[d][c]`` is context rank
    c of data rank d's result (one entry per data rank without ``spatial``).
    Data ranks run one after another; with ``spatial`` the context ranks of
    a data rank run as threads that take turns (module docstring). The
    first error of a rank is raised once every rank has stopped."""
    grad = torch.is_grad_enabled()
    streams = {d: torch.cuda.current_stream(d)
               for d in {dev for row in mesh.devices for dev in row} if d.type == "cuda"}
    results = []
    for d, row in enumerate(mesh.devices):
        if not spatial or len(row) == 1:
            group = Group(row[:1])
            rank = Rank(d, 0, row[0], spatial, group)
            with _as_rank(rank, grad, streams, Mesh([row])):
                results.append([fn(rank)])
            continue
        group = Group(row)
        out: list = [None] * len(row)
        errors: list = [None] * len(row)

        def body(c: int) -> None:
            try:
                with group.turn(c):
                    rank = Rank(d, c, row[c], True, group)
                    with _as_rank(rank, grad, streams, mesh):
                        out[c] = fn(rank)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[c] = e
                group.fail(e)

        threads = [threading.Thread(target=body, args=(c,), name=f"rank-{d}-{c}", daemon=True)
                   for c in range(len(row))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        real = [e for e in errors if e is not None and not isinstance(e, RankAborted)]
        if real or any(errors):
            raise (real or [e for e in errors if e is not None])[0]
        results.append(out)
    return results
