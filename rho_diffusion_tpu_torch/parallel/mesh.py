"""Device meshes for the port: a ("data", "context") grid of devices.

Port of ``rho_diffusion_tpu/parallel/mesh.py:25-91``: the axis names,
``make_mesh``, ``active_mesh`` and ``get_active_mesh``. PyTorch has no
``jax.sharding.Mesh``, so ``Mesh`` here is a small grid of
``torch.device``s; one process drives every rank of it (the JAX package's
single-controller model). A mesh may name one device several times: each
entry is a rank of its own, as the JAX package's tests run rings over the
virtual CPU devices of one host. K6's ring reads every rank's K/V shard
where it lies: on one card straight from the inputs, across cards over
NVLink.

The active mesh is kept per thread, not per process as in JAX: the port
runs its model eagerly, and a sampling service's worker thread entering a
context mesh must not send another thread's model calls into a ring.

Placement (JAX :93-168). A ``Sharding`` is JAX's ``NamedSharding``: the mesh
axis (or None) of each dim. ``Sharding.place`` cuts a global tensor into
the pieces each rank holds, each copied to its rank's device (a
``Placed``); ``Placed.full`` gathers it back. ``batch_sharding`` puts the
batch rows over "data" and, with ``spatial``, the depth of a [B, D, H, W,
C] volume over "context"; ``replicated`` puts the whole tensor on every
rank. ``replicate_state`` readies a training state for a mesh: one model
replica per distinct device of the mesh (the state's own model on the
first). ``shard_opt_state_zero1`` splits the optimizer state and the EMA
1/N over "data"; ``shard_state_fsdp`` splits the parameters too (FSDP,
ZeRO-3); both are ``training/sharded.py``'s ``ShardedOptimizer``, and
``create_state_fsdp`` builds a fresh state straight in those shards.
``initialize_distributed`` joins the process group of a multi-process run
(``parallel/runtime.py``).
"""
from __future__ import annotations

import contextlib
import copy
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


class Sharding:
    """JAX's ``NamedSharding``: ``spec[i]`` is the mesh axis dim i is split
    over ("data", "context" or None); dims past the spec are whole."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def spatial(self) -> bool:
        """True when dim 1 (a volume's depth) is split over "context"."""
        return len(self.spec) > 1 and self.spec[1] == CONTEXT_AXIS

    def _index(self, shape, d: int, c: int) -> tuple:
        index = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                index.append(slice(None))
                continue
            n, i = self.mesh.shape[axis], (d if axis == DATA_AXIS else c)
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split over the "
                                 f"{n} ranks of the {axis!r} axis")
            index.append(slice(i * (size // n), (i + 1) * (size // n)))
        return tuple(index)

    def place_rows(self, blocks: list) -> "Placed":
        """The placement of a tensor whose rows are already split: data rank
        d's rows ``blocks[d]`` (on its device) cut into its context ranks'
        pieces. The sharding must split dim 0 over "data"."""
        if not self.spec or self.spec[0] != DATA_AXIS:
            raise ValueError(f"place_rows needs rows over 'data', got the spec {self.spec}")
        inner = Sharding(self.mesh, (None, *self.spec[1:]))
        pieces = [[x[inner._index(x.shape, d, c)].to(dev) for c, dev in enumerate(row)]
                  for d, (row, x) in enumerate(zip(self.mesh.devices, blocks))]
        shape = (sum(x.shape[0] for x in blocks), *blocks[0].shape[1:])
        return Placed(pieces, self, shape)

    def place(self, x) -> "Placed":
        """Each rank's piece of ``x`` (a tensor or an array), on its device."""
        x = torch.as_tensor(x)
        pieces = [[x[self._index(x.shape, d, c)].to(dev) for c, dev in enumerate(row)]
                  for d, row in enumerate(self.mesh.devices)]
        return Placed(pieces, self, tuple(x.shape))


class Placed:
    """A global tensor held as per-rank pieces: ``pieces[d][c]`` lies on
    ``mesh.devices[d][c]``."""

    def __init__(self, pieces: list, sharding: Sharding, shape: tuple) -> None:
        self.pieces = pieces
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0][0].dtype

    def piece(self, d: int, c: int = 0) -> torch.Tensor:
        return self.pieces[d][c]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor gathered on ``device`` (the mesh's first)."""
        device = canonical_device(device) if device is not None else self.sharding.mesh.devices[0][0]
        spec = self.sharding.spec
        rows = []
        for row in self.pieces:
            if CONTEXT_AXIS in spec:
                rows.append(torch.cat([p.to(device) for p in row], dim=spec.index(CONTEXT_AXIS)))
            else:
                rows.append(row[0].to(device))
        if DATA_AXIS in spec:
            return torch.cat(rows, dim=spec.index(DATA_AXIS))
        return rows[0]


def batch_sharding(mesh: Mesh, spatial: bool = False) -> Sharding:
    """The batch rows over "data"; with ``spatial`` (and a context axis > 1)
    also dim 1, the depth of [B, D, H, W, C] volumes, over "context" (JAX
    :93-104)."""
    if spatial and mesh.shape[CONTEXT_AXIS] > 1:
        return Sharding(mesh, (DATA_AXIS, CONTEXT_AXIS))
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(batch: dict, mesh: Mesh, per_key: Optional[dict] = None) -> dict:
    """Place a batch on the mesh: rows over "data" (``per_key`` overrides the
    sharding of a key, e.g. the spatial one for "data"). None stays None,
    and a ``valid`` mask stays on the host, where it is read."""
    out = {}
    for k, v in batch.items():
        if v is None or k == "valid" or isinstance(v, Placed):
            out[k] = v
        else:
            out[k] = (per_key or {}).get(k, batch_sharding(mesh)).place(v)
    return out


def replicate_state(state, mesh: Mesh):
    """Ready ``state`` (a ``TrainState``) for steps over ``mesh``: the
    model stays where it is, on the mesh's first device, and every other
    distinct device of the mesh gets a replica (refreshed from it at each
    step; on one card there is none). Returns the state."""
    first = mesh.devices[0][0]
    model_device = canonical_device(next(state.model.parameters()).device)
    if model_device != first:
        raise ValueError(f"the model lies on {model_device}, but the mesh's first device is "
                         f"{first}: the model's own parameters are the first rank's replica")
    others = {dev for row in mesh.devices for dev in row} - {first}
    state.replicas = {dev: copy.deepcopy(state.model).to(dev) for dev in sorted(others, key=str)}
    state.mesh = mesh
    return state


def _shard_dim(shape, axis_size: int, blocked=()) -> Optional[int]:
    """The dim to shard over an ``axis_size``-way axis: the LARGEST
    divisible dim (ties -> trailing), skipping ``blocked`` dims; None if
    nothing fits (JAX :120-131)."""
    divisible = [i for i in range(len(shape))
                 if i not in blocked and shape[i] % axis_size == 0 and shape[i] >= axis_size]
    if not divisible:
        return None
    return max(divisible, key=lambda i: (shape[i], i))


def _data_axis_placer(mesh: Mesh):
    """Leaf placer over the data axis (JAX :134-163): ``place(leaf, axes,
    blocked)`` is the torch dim of ``leaf`` that ZeRO-1 or FSDP splits 1/N,
    or None for a leaf too small to split (it stays replicated). ``axes[j]``
    is the torch dim holding dim j of the JAX package's layout of the same
    weight (a conv's [k, k, k, Cin, Cout] is [Cout, Cin, k, k, k] here), so
    the rule picks the dim JAX picks and each rank holds the elements JAX's
    rank holds. ``blocked`` names the dims (of JAX's layout) a sharding the
    leaf already carries holds, e.g. TP's trailing dim over "context": the
    data axis takes a free dim, as JAX composes them."""
    n = mesh.shape[DATA_AXIS]

    def place(leaf: torch.Tensor, axes: Optional[Sequence[int]] = None,
              blocked: Sequence[int] = ()) -> Optional[int]:
        axes = tuple(range(leaf.ndim)) if axes is None else tuple(axes)
        dim = _shard_dim(tuple(leaf.shape[a] for a in axes), n, blocked)
        return None if dim is None else axes[dim]

    return place


def shard_opt_state_zero1(state, mesh: Mesh, include_ema: bool = True):
    """ZeRO-1 (JAX :144-168): each data rank keeps the optimizer state (and,
    with ``include_ema``, the EMA) of its 1/N slice of every leaf that
    splits, on its device, updates that slice, and the updated slices are
    gathered into every replica; parameters stay replicated. The state's
    optimizer state and EMA carry over. On a state already split by tensor
    parallelism the slices are cut from its pieces, on a dim other than
    TP's (``training.sharded``). Returns the state."""
    from rho_diffusion_tpu_torch.training.sharded import shard_state, sharding_of

    options = sharding_of(state)
    return shard_state(state, mesh, **{**options, "zero1": True, "include_ema": include_ema})


def shard_state_fsdp(state, mesh: Mesh, include_ema: bool = True):
    """Fully-sharded data parallelism, ZeRO-3 (JAX :191-221): the parameters,
    their optimizer state and (with ``include_ema``) the EMA each live 1/N
    per data rank, split along the largest divisible dim of JAX's layout;
    a step gathers each weight where its ranks read it and reduce-scatters
    its gradient back onto the slices (``training.sharded``). Composes with
    tensor parallelism: a leaf already split over "context" keeps that dim
    and takes the data axis on a free one. The state's values carry over
    (gathered first if it is sharded). Returns the state."""
    from rho_diffusion_tpu_torch.training.sharded import shard_state, sharding_of

    options = sharding_of(state)
    if options["zero1"]:
        raise ValueError("fsdp (ZeRO-3) already shards the optimizer state: not with zero1")
    return shard_state(state, mesh, **{**options, "fsdp": True, "include_ema": include_ema})


def fsdp_shardings(model, mesh: Mesh, include_ema: bool = True) -> dict:
    """JAX :224-250 for the port: per parameter name of ``model`` (a
    backbone, or a ``TrainState``), the torch dim FSDP splits over "data"
    (JAX's ``_shard_dim`` in JAX's layout), or None for a leaf that stays
    whole. The optimizer state follows its parameter, and so does the EMA
    with ``include_ema`` (else it stays whole)."""
    from rho_diffusion_tpu_torch.training.zero1 import zero1_dims

    return zero1_dims(getattr(model, "model", model), mesh)


def create_state_fsdp(create_fn, seed: int, mesh: Mesh, include_ema: bool = True):
    """A fresh training state straight in its FSDP shards (JAX :253-263):
    ``create_fn(seed=seed)`` (a pipeline's ``create_state``, built with its
    backbone on the host: ``build_pipeline_from_config(...,
    backbone_device="cpu")``) is cut on the host and each slice copied to its
    rank, so the whole parameters, moments and EMA never lie on a card. The
    values equal ``create_state``'s bitwise."""
    return shard_state_fsdp(create_fn(seed=seed), mesh, include_ema=include_ema)


def fsdp_abstract_state(create_fn, seed: int, mesh: Mesh, include_ema: bool = True):
    """The restore-side twin of ``create_state_fsdp`` (JAX :266-276): a state
    in its FSDP shards for ``CheckpointManager.restore`` to fill, which
    copies each rank's slices from the checkpoint read on the host. PyTorch
    has no abstract arrays, so its pieces are allocated (with the seeded
    values, overwritten by the restore)."""
    return create_state_fsdp(create_fn, seed, mesh, include_ema=include_ema)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           local_size: Optional[int] = None) -> None:
    """Join the process group (JAX :279-285). Without arguments the world is
    read from the launcher's environment (``runtime.mpi_world_from_env``).
    Does nothing for a single process or when the group is already
    initialised. ``local_rank`` and ``local_size`` place this process among
    the processes of its host (by default it is the only one). The backend
    is NCCL when every process of a host has a card of its own (each then
    drives its share, ``runtime.local_devices``), gloo otherwise (processes
    sharing a card, and the CPU)."""
    import datetime
    import os

    import torch.distributed as dist

    from rho_diffusion_tpu_torch.parallel import runtime

    if dist.is_initialized():
        return
    if coordinator_address is None:
        world = runtime.mpi_world_from_env()
        if world is None:
            return
        coordinator_address, num_processes = world["coordinator_address"], world["num_processes"]
        process_id, local_rank, local_size = (world["process_id"], world["local_rank"],
                                              world["local_size"])
    if not num_processes or int(num_processes) <= 1:
        return
    if local_rank is None:
        local_rank, local_size = 0, 1
    elif local_size is None:
        local_size = int(num_processes)
    runtime.set_local_slot(local_rank, local_size)
    if int(local_size) > 1:  # the host's cores shared out, as torchrun's OMP_NUM_THREADS does
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(local_size)))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    own_card = cards >= int(local_size) > 0 and cards > 0
    backend = "nccl" if own_card else "gloo"
    if own_card:
        torch.cuda.set_device(local_rank * (cards // int(local_size)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(minutes=10))
