"""Device-resident dataset cache: batches as gathers on the device.

Port of ``rho_diffusion_tpu/data/device_cache.py`` (:56-252) on one card.
The host loader builds every batch on the host and copies it to the device
each step; when the dataset fits in device memory that copy is overhead.
Here the collated dataset is materialised once (the same thread pool and
the same collate as the host loader), its tables are uploaded once as
tensors on the device, and each batch is an ``index_select`` on the device:
the only per-step host-to-device copy is the batch's int64 indices.

Batches follow the host loader's epoch order (``loader.iter_index_batches``:
the same permutation, the same mid-epoch start, the same wrap-padded last
batch and its ``valid`` mask, which stays a host array as ``to_device``
leaves it), so they are bitwise the host loader's for a deterministic
dataset.

Snapshot semantics: the dataset is read once. A dataset whose
``__getitem__`` draws at random (SphericalHarmonicDataset's (l, m)) is
frozen at one draw per index, and every epoch revisits that snapshot, as
training on a file that ``to_hdf5`` wrote would.

Over a mesh (``mesh=``, JAX :18-32, :99-125) each batch is placed as the
trainer places it: data rank d gathers its rows, and ``per_key`` cuts them
further (the volume's depth over "context" under spatial sharding). The
table lives on the first rank's device, or, with ``shard_over_data=True``
under a data axis of N >= 2, 1/N on each data rank's device (rows [d S,
(d + 1) S), S = ceil(rows / N)), so the budget is N x ``max_bytes``: a
batch row is then read from the rank that holds it and copied to the rank
that trains on it. Either way the batches are bitwise the host loader's.
``shard_over_data`` without a data axis of at least 2 raises
``ValueError``, as in JAX.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from rho_diffusion_tpu_torch.data.loader import DataLoader, default_collate
from rho_diffusion_tpu_torch.parallel.mesh import DATA_AXIS, batch_sharding
from rho_diffusion_tpu_torch.utils import resolve_device


class DeviceDatasetCache:
    """Upload a collated dataset to the device once; serve batches by gather.

    Args:
        dataset: map-style dataset (``__len__`` / ``__getitem__``).
        collate_fn: stacks samples into ``{"data": [N, ...], "labels": ...}``,
            the host loader's collate, so cached batches are bitwise the host
            loader's.
        device: where the tables live (CUDA unless ``"cpu"`` is asked for).
        max_bytes: refuse datasets beyond this device-memory budget
            (default 4 GiB).
        num_workers: threads for the one-time host materialisation.
        shard_over_data: split the rows over the data ranks of ``mesh``.
        mesh: place batches over this mesh (``parallel.mesh.Mesh``).
        per_key: the ``Sharding`` of a key where it is not plain batch
            sharding (e.g. the spatial one for "data").
    """

    def __init__(
        self,
        dataset,
        collate_fn=default_collate,
        device=None,
        max_bytes: int = 4 << 30,
        num_workers: int = 8,
        shard_over_data: bool = False,
        mesh=None,
        per_key: Optional[dict] = None,
    ) -> None:
        from rho_diffusion_tpu_torch.parallel import runtime

        if runtime.process_count() > 1:  # JAX data/device_cache.py:83-87
            raise ValueError(
                "DeviceDatasetCache is single-process only: over several processes each "
                "builds its own rows of every batch (data/loader.py's process split)")
        n_data = 1
        if shard_over_data:
            if mesh is None or mesh.shape[DATA_AXIS] < 2:
                raise ValueError(
                    'shard_over_data needs a mesh with a "data" axis of size >= 2 (got '
                    f"{None if mesh is None else mesh.shape})")
            n_data = mesh.shape[DATA_AXIS]
        self.mesh = mesh
        self.per_key = dict(per_key or {})
        self.shard_over_data = bool(shard_over_data)
        self.device = mesh.devices[0][0] if mesh is not None else resolve_device(device)
        n = len(dataset)
        if num_workers > 0:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                samples = list(pool.map(dataset.__getitem__, range(n)))
        else:
            samples = [dataset[i] for i in range(n)]
        host = collate_fn(samples)
        total = sum(np.asarray(v).nbytes for v in host.values() if v is not None)
        budget = max_bytes * n_data  # sharded rows: the pool is N devices
        if total > budget:
            raise ValueError(
                f"dataset is {total / 2**30:.2f} GiB collated, over the "
                f"{budget / 2**30:.2f} GiB device-cache budget — disable "
                f"training.device_cache (host streaming) or raise max_bytes.",
            )
        self.nbytes = total
        self._none_keys = [k for k, v in host.items() if v is None]
        tables = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()
                  if v is not None}
        if shard_over_data:
            self.rows_per_rank = -(-n // n_data)
            s = self.rows_per_rank
            self._shards = [{k: t[d * s:(d + 1) * s].to(mesh.devices[d][0])
                             for k, t in tables.items()} for d in range(n_data)]
            self._tables = None
        else:
            self._tables = {k: t.to(self.device) for k, t in tables.items()}

    @staticmethod
    def _index(idx, device: torch.device) -> torch.Tensor:
        index = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        if device.type == "cuda":
            return index.pin_memory().to(device, non_blocking=True)
        return index

    def _rows(self, idx: np.ndarray, device: torch.device) -> dict:
        """The table rows ``idx`` on ``device``: from the whole table, or
        each from the data rank whose shard holds it."""
        if self._tables is not None:
            index = self._index(idx, self._tables_device)
            return {k: torch.index_select(t, 0, index).to(device) for k, t in self._tables.items()}
        idx = np.asarray(idx, dtype=np.int64)
        owner = idx // self.rows_per_rank
        out = {k: torch.empty((len(idx), *t.shape[1:]), dtype=t.dtype, device=device)
               for k, t in self._shards[0].items()}
        for d, shard in enumerate(self._shards):
            at = np.nonzero(owner == d)[0]
            if not len(at):
                continue
            src = next(iter(shard.values())).device
            local = self._index(idx[at] - d * self.rows_per_rank, src)
            dest = self._index(at, device)
            for k, t in shard.items():
                out[k].index_copy_(0, dest, torch.index_select(t, 0, local).to(device))
        return out

    @property
    def _tables_device(self) -> torch.device:
        return next(iter(self._tables.values())).device

    def batch(self, idx: np.ndarray, valid: Optional[np.ndarray] = None) -> dict:
        """One batch gathered on the device from sample indices ``idx``; over
        a mesh, placed (each data rank's rows gathered onto its device)."""
        if self.mesh is not None:
            return self._placed_batch(idx, valid)
        out = self._rows(idx, self.device)
        for k in self._none_keys:
            out[k] = None
        if valid is not None:
            out["valid"] = valid
        return out

    def _placed_batch(self, idx: np.ndarray, valid: Optional[np.ndarray]) -> dict:
        n_data = self.mesh.shape[DATA_AXIS]
        if len(idx) % n_data:
            raise ValueError(f"a batch of {len(idx)} rows does not split over {n_data} data ranks")
        r = len(idx) // n_data
        blocks = [self._rows(idx[d * r:(d + 1) * r], self.mesh.devices[d][0])
                  for d in range(n_data)]
        out: dict = {}
        for k in blocks[0]:
            sharding = self.per_key.get(k, batch_sharding(self.mesh))
            out[k] = sharding.place_rows([b[k] for b in blocks])
        for k in self._none_keys:
            out[k] = None
        if valid is not None:
            out["valid"] = valid
        return out

    def batches(self, loader: DataLoader, start: int = 0) -> Iterator[dict]:
        """This epoch's batches from batch index ``start``, as device
        tensors. The gathers are queued on the device's stream, so the next
        batch's gather follows the current step without a prefetch thread."""
        for rec in loader.iter_index_batches(start):
            yield self.batch(rec["idx"], rec.get("valid"))
