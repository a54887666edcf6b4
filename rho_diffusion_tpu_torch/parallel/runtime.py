"""Accelerator runtime introspection and the process group.

Port of ``rho_diffusion_tpu/parallel/runtime.py`` (:18-126): device
inventory (``accelerator_available``, ``parse_devices``), memory statistics
(``get_device_stats``), a cross-process ``barrier``, the launcher
environment (``mpi_world_from_env``, a copy of JAX's pure function) and
``runtime_summary``.

Where JAX asks ``jax.process_index()`` and ``jax.process_count()``, the port
asks ``torch.distributed``: ``process_index`` and ``process_count`` are 0 and
1 until ``parallel.mesh.initialize_distributed`` joins a group of several
processes. ``local_devices`` are the cards this process drives: every
visible card when it runs alone (or is the only process on its host), its
own share of them when several processes of a host each have a card, and
the card it shares otherwise (two processes on one card, as the CPU tests
run two processes on the one CPU).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# (local rank, processes on this host), set by initialize_distributed
_LOCAL_SLOT: dict = {}


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def set_local_slot(local_rank: Optional[int], local_size: Optional[int]) -> None:
    """Record this process's place among the processes of its host."""
    _LOCAL_SLOT.clear()
    if local_rank is not None:
        _LOCAL_SLOT.update(rank=int(local_rank), size=int(local_size or 1))


def local_devices() -> list[torch.device]:
    """The CUDA cards this process drives (module docstring); [] without
    CUDA."""
    if not torch.cuda.is_available():
        return []
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if process_count() == 1 or not _LOCAL_SLOT or _LOCAL_SLOT["size"] == 1:
        return cards
    rank, size = _LOCAL_SLOT["rank"], _LOCAL_SLOT["size"]
    if len(cards) >= size:
        share = len(cards) // size
        return cards[rank * share:(rank + 1) * share]
    return [cards[rank % len(cards)]]


def accelerator_available(platform: str = "cuda") -> bool:
    """Availability probe (JAX :18-23): "cuda" is a visible card, "cpu"
    always."""
    if platform == "cpu":
        return True
    return platform == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() > 0


def parse_devices(devices: Any = None) -> list[torch.device]:
    """Device-spec parsing (JAX :26-35): None/-1 -> every card (the CPU
    without CUDA), int n -> the first n, a list of ids -> those ids."""
    all_devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    if devices is None or devices == -1:
        return all_devices
    if isinstance(devices, int):
        return all_devices[:devices]
    return [all_devices[i] for i in devices]


def get_device_stats(device: Optional[Any] = None) -> dict:
    """Per-device memory statistics (JAX :38-49): the allocator's bytes in
    use and their peak, and the card's total memory as the limit; None on
    the CPU, which keeps no such statistics."""
    device = torch.device(device) if device is not None else parse_devices()[0]
    if device.type != "cuda":
        return {"platform": device.type, "device_kind": "cpu", "bytes_in_use": None,
                "peak_bytes_in_use": None, "bytes_limit": None}
    stats = torch.cuda.memory_stats(device)
    return {
        "platform": "cuda",
        "device_kind": torch.cuda.get_device_name(device),
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def barrier(name: str = "rho_barrier") -> None:
    """Cross-process synchronisation (JAX :52-58): ``torch.distributed``'s
    barrier when more than one process runs."""
    if process_count() > 1:
        dist.barrier()


def mpi_world_from_env(env: Optional[dict] = None) -> Optional[dict]:
    """Resolve world size / rank / coordinator from MPI-launcher env vars
    (JAX :61-116, copied): Intel MPI's PMI_* variables with Open MPI and
    torchrun fallbacks, the rendezvous host from HYDRA_BSTRAP_LOCALHOST or
    MASTER_ADDR (127.0.0.1 on one node), the port from MASTER_PORT (29600).

    Returns None when no launcher env is present (single-process run), else
    ``{num_processes, process_id, local_rank, local_size,
    coordinator_address}``. A launch that is provably multi-node (fewer
    local than global ranks) without a coordinator host raises."""
    env = os.environ if env is None else env

    def _first(*names: str) -> Optional[str]:
        for name in names:
            value = env.get(name)
            if value not in (None, ""):
                return value
        return None

    size = _first("PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE")
    if size is None or int(size) <= 1:
        return None
    rank = _first("PMI_RANK", "OMPI_COMM_WORLD_RANK", "RANK") or "0"
    local = _first("MPI_LOCALRANKID", "OMPI_COMM_WORLD_LOCAL_RANK", "LOCAL_RANK")
    local_size = _first(
        "MPI_LOCALNRANKS", "OMPI_COMM_WORLD_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
    )
    host = _first("HYDRA_BSTRAP_LOCALHOST", "MASTER_ADDR")
    if host is None:
        # a loopback rendezvous only works when every rank is on this node
        if local_size is not None and int(local_size) < int(size):
            raise RuntimeError(
                f"multi-node launch detected ({local_size} local of {size} "
                "global ranks) but no coordinator address: set MASTER_ADDR "
                "(and optionally MASTER_PORT) to rank 0's host, or launch "
                "with Intel MPI (HYDRA_BSTRAP_LOCALHOST).",
            )
        host = "127.0.0.1"
    port = _first("MASTER_PORT") or "29600"
    return {
        "num_processes": int(size),
        "process_id": int(rank),
        "local_rank": int(local) if local is not None else None,
        "local_size": int(local_size) if local_size is not None else None,
        "coordinator_address": f"{host}:{port}",
    }


def runtime_summary() -> dict:
    """JAX :119-126 with the port's words: the platform, the process
    group's backend ("nccl", "gloo", or None without a group), the ranks'
    devices and the processes."""
    local = local_devices()
    grouped = dist.is_available() and dist.is_initialized()
    return {
        "platform": "cuda" if local else "cpu",
        "backend": dist.get_backend() if grouped else None,
        "device_count": max(len(local), 1) * process_count(),
        "local_device_count": max(len(local), 1),
        "process_index": process_index(),
        "process_count": process_count(),
        "devices": [str(d) for d in local] or ["cpu"],
    }


def process_rows(n_local: int) -> slice:
    """This process's rows of a global batch whose every process holds
    ``n_local`` (``np.array_split``'s equal parts, in process order)."""
    return slice(process_index() * n_local, (process_index() + 1) * n_local)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend takes it: gloo takes only some
    collectives on CUDA tensors, so its are staged on the host."""
    return t.cpu() if dist.get_backend() == "gloo" else t


@torch.no_grad()
def all_reduce_(tensors: list, average: bool = False) -> None:
    """Sum (or average) ``tensors`` over the processes, in place, as one
    flat buffer."""
    if process_count() == 1 or not tensors:
        return
    device = tensors[0].device
    flat = _staged(torch.cat([t.reshape(-1).to(device) for t in tensors]))
    dist.all_reduce(flat)
    if average:
        flat /= process_count()
    flat = flat.to(device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


@torch.no_grad()
def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (all of one shape) concatenated along dim 0 in
    process order, on the host."""
    if process_count() == 1:
        return t.cpu()
    staged = t.cpu().contiguous()
    parts = [torch.empty_like(staged) for _ in range(process_count())]
    dist.all_gather(parts, staged)
    return torch.cat(parts)
