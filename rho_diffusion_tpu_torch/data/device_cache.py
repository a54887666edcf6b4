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

The table lives whole on the one device. ``shard_over_data=True`` (rows
split over the cards of a data mesh) raises: it is ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from rho_diffusion_tpu_torch.data.loader import DataLoader, default_collate
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
        shard_over_data: split the rows over a data mesh; not ported (raises).
    """

    def __init__(
        self,
        dataset,
        collate_fn=default_collate,
        device=None,
        max_bytes: int = 4 << 30,
        num_workers: int = 8,
        shard_over_data: bool = False,
    ) -> None:
        if shard_over_data:
            raise NotImplementedError(
                "shard_over_data=True splits the table's rows over the cards of a data mesh, "
                "which is not ported (ROADMAP Queue 1 item 13); the port keeps the whole "
                "table on one card",
            )
        self.device = resolve_device(device)
        n = len(dataset)
        if num_workers > 0:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                samples = list(pool.map(dataset.__getitem__, range(n)))
        else:
            samples = [dataset[i] for i in range(n)]
        host = collate_fn(samples)
        total = sum(np.asarray(v).nbytes for v in host.values() if v is not None)
        if total > max_bytes:
            raise ValueError(
                f"dataset is {total / 2**30:.2f} GiB collated, over the "
                f"{max_bytes / 2**30:.2f} GiB device-cache budget — disable "
                f"training.device_cache (host streaming) or raise max_bytes.",
            )
        self.nbytes = total
        self._none_keys = [k for k, v in host.items() if v is None]
        self._tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                        for k, v in host.items() if v is not None}

    def batch(self, idx: np.ndarray, valid: Optional[np.ndarray] = None) -> dict:
        """One batch gathered on the device from sample indices ``idx``."""
        index = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        if self.device.type == "cuda":
            index = index.pin_memory().to(self.device, non_blocking=True)
        out = {k: torch.index_select(t, 0, index) for k, t in self._tables.items()}
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
