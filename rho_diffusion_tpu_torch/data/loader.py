"""Host-side data loading: batching, shuffling, threaded prefetch, and the
copy to the device.

Port of ``rho_diffusion_tpu/data/loader.py`` (:23-256) for one process:

* ``DataLoader`` draws each epoch's permutation from
  ``SeedSequence([seed, epoch])``, so a resumed run replays the same batches
  (``iter_batches(start)`` skips the first ``start`` without building them);
  with ``drop_last=False`` the short last batch is wrap-padded and carries a
  ``valid`` mask;
* a thread pool builds the samples of a batch (scipy's field work releases
  the GIL);
* ``prefetch_to_device`` copies each numpy batch through pinned host memory
  with ``non_blocking=True`` (on a CUDA device), keeping ``size`` batches in
  flight ahead of the consumer.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch


def default_collate(samples: list) -> dict:
    """Stack (data, label) tuples into {'data': [B, ...], 'labels': [B, ...]};
    dict samples are stacked key-wise ('spectrum' -> 'data', 'params' ->
    'labels')."""
    first = samples[0]
    if isinstance(first, dict):
        out = {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
        if "data" not in out and "spectrum" in out:
            out["data"] = out.pop("spectrum")
        if "labels" not in out:
            out["labels"] = out.pop("params", None)
        return out
    if isinstance(first, (tuple, list)):
        data = np.stack([np.asarray(s[0]) for s in samples])
        labels = None
        if len(first) > 1 and first[1] is not None:
            labels = np.stack([np.asarray(s[1]) for s in samples])
        return {"data": data, "labels": labels}
    return {"data": np.stack([np.asarray(s) for s in samples]), "labels": None}


class Subset:
    """Index-subset view of a dataset (train/val splits)."""

    def __init__(self, dataset, indices) -> None:
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.parameter_space = getattr(dataset, "parameter_space", None)
        self.use_emb_as_labels = getattr(dataset, "use_emb_as_labels", False)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


class DataLoader:
    """Map-style dataset -> iterator of numpy batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        collate_fn: Callable = default_collate,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            return rng.permutation(n)
        return np.arange(n)

    def _build_batch(self, idx: np.ndarray) -> dict:
        if self._pool is not None:
            samples = list(self._pool.map(self.dataset.__getitem__, idx))
        else:
            samples = [self.dataset[i] for i in idx]
        return self.collate_fn(samples)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0) -> Iterator[dict]:
        """This epoch's batches from batch index ``start`` on."""
        for rec in self.iter_index_batches(start):
            batch = self._build_batch(rec["idx"])
            if "valid" in rec:
                batch["valid"] = rec["valid"]
            yield batch

    def iter_index_batches(self, start: int = 0) -> Iterator[dict]:
        """The sample indices (and, for a wrap-padded last batch, the
        ``valid`` mask) of each of this epoch's batches from ``start`` on."""
        indices = self._epoch_indices()
        bs = self.batch_size
        for b in range(start, len(self)):
            chunk = indices[b * bs:(b + 1) * bs]
            n_real = len(chunk)
            if n_real < bs:
                if self.drop_last:
                    break
                # np.resize tiles cyclically, so even a dataset smaller than
                # the pad fills the batch
                chunk = np.concatenate([chunk, np.resize(indices, bs - n_real)])
            rec = {"idx": chunk}
            if n_real < bs:
                rec["valid"] = np.arange(bs) < n_real
            yield rec
        self.epoch += 1


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, keeping ``size`` items ready.
    A consumer that stops early (the trainer on a preemption signal) stops
    the producer after its current item and waits for it to finish."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    done = False
    try:
        while True:
            item = q.get()
            if item is sentinel:
                done = True
                if err:
                    raise err[0]
                return
            yield item
    finally:
        if not done:
            stop.set()
            while q.get() is not sentinel:  # unblock the producer's put
                pass
        thread.join()


def to_device(batch: dict, device: torch.device) -> dict:
    """Numpy arrays -> tensors on ``device``: on a CUDA device through
    pinned host memory with a non-blocking copy on the current stream.
    ``valid`` masks stay numpy on the host, where they are read."""
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if v is None or k == "valid" or isinstance(v, torch.Tensor):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
    return out


def prefetch_to_device(iterator: Iterator[dict], device: torch.device,
                       size: int = 2) -> Iterator[dict]:
    """Copy numpy batches onto ``device`` ``size`` batches ahead of their
    consumption."""
    buf: collections.deque = collections.deque()
    for batch in iterator:
        buf.append(to_device(batch, torch.device(device)))
        while len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
