"""Device meshes for the port: a ("data", "context") grid of devices.

Port of ``rho_diffusion_tpu/parallel/mesh.py:25-91``: the axis names,
``make_mesh``, ``active_mesh`` and ``get_active_mesh``. PyTorch has no
``jax.sharding.Mesh``, so ``Mesh`` here is a small grid of
``torch.device``s; one process drives every rank of it (the JAX package's
single-controller model). A mesh may name one device several times: each
entry is a rank of its own, as the JAX package's tests run rings over the
virtual CPU devices of one host. Ranks on one card exchange K/V by
device-to-device copies; ranks on different cards by peer copies.

The active mesh is kept per thread, not per process as in JAX: the port
runs its model eagerly, and a sampling service's worker thread entering a
context mesh must not send another thread's model calls into a ring.

``batch_sharding``, ``replicated``, ``shard_batch``, ZeRO-1 and FSDP are not
ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
CONTEXT_AXIS = "context"


def canonical_device(device) -> torch.device:
    """``device`` with the index it stands for: "cuda" is the current card,
    "cpu:0" is "cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


class Mesh:
    """A ("data", "context") grid of ``torch.device``s: ``devices[i][j]`` is
    the rank at data index i and context index j."""

    axis_names = (DATA_AXIS, CONTEXT_AXIS)

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = [[canonical_device(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1 or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {DATA_AXIS: len(self.devices), CONTEXT_AXIS: len(self.devices[0])}

    def context_group(self, data_index: int = 0) -> list[torch.device]:
        """The devices of one ring: the context ranks at ``data_index``."""
        return list(self.devices[data_index])


_LOCAL = threading.local()


def get_active_mesh() -> Optional[Mesh]:
    """The mesh the calling thread is running under, or None."""
    return getattr(_LOCAL, "mesh", None)


@contextlib.contextmanager
def active_mesh(mesh: Optional[Mesh]):
    """Enter ``mesh`` as the calling thread's active mesh (read by the
    attention dispatcher to pick ring attention)."""
    prev = get_active_mesh()
    _LOCAL.mesh = mesh
    try:
        yield mesh
    finally:
        _LOCAL.mesh = prev


def make_mesh(data: int = -1, context: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("data", "context") mesh, context innermost. ``data=-1``
    uses all remaining ranks.

    ``devices=None`` means every CUDA card, one rank each, and raises
    without CUDA. An explicit ``devices`` list is used as given, one rank
    per entry, and may repeat a device. ``data * context`` must equal the
    number of ranks (JAX :66-72); the mesh is never shrunk to fit."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices spans every CUDA card, but "
                "torch.cuda.is_available() is False; pass devices (e.g. ['cpu'] * n)",
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    if data == -1:
        if context < 1 or n % context:
            raise ValueError(f"{n} devices not divisible by context={context}")
        data = n // context
    if data * context != n:
        raise ValueError(f"mesh {data}x{context} != {n} available devices")
    return Mesh([devices[i * context:(i + 1) * context] for i in range(data)])
