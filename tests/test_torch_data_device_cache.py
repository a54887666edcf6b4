"""The port's device-resident dataset cache, on the CPU.

Mirrors the replicated half of tests/data/test_device_cache.py: cached
batches are bitwise the host loader's (drop_last both ways, a mid-epoch
start, None labels) and the JAX package's cache's; the budget raises;
``shard_over_data`` raises (a data mesh over several cards is ROADMAP
Queue 1 item 13); the cache runs on CUDA unless asked for the CPU; and a
Trainer with ``training.device_cache: true`` on ``config_smoke.json`` (its
dataset written to HDF5 first, so that an item is a function of its index)
logs the same losses as without it, bitwise.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rho_diffusion_tpu.data.device_cache import DeviceDatasetCache as JaxDeviceDatasetCache
from rho_diffusion_tpu.data.loader import DataLoader as JaxDataLoader
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.device_cache import DeviceDatasetCache
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
from rho_diffusion_tpu_torch.parallel.mesh import make_mesh
from rho_diffusion_tpu_torch.training.trainer import Trainer
from test_torch_training import SignalAtStep

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


class ArangeDataset:
    """Deterministic (data, label) pairs, so a mismatch names its rows."""

    def __init__(self, n=23, shape=(4, 4, 1)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(self.shape, float(i), np.float32), np.array([i, i * 2], np.float32)


class UnlabelledDataset(ArangeDataset):
    def __getitem__(self, i):
        return super().__getitem__(i)[0], None


def loader(ds, **kw):
    return DataLoader(ds, batch_size=8, shuffle=True, num_workers=0, **kw)


def assert_batches_equal(host, cached):
    assert len(host) == len(cached) > 0
    for hb, cb in zip(host, cached):
        assert sorted(hb) == sorted(cb)
        for k, v in hb.items():
            if v is None:
                assert cb[k] is None
            elif k == "valid":  # a host array on both paths
                np.testing.assert_array_equal(v, cb[k])
            else:
                assert cb[k].device.type == "cpu" and cb[k].dtype == torch.from_numpy(v).dtype
                np.testing.assert_array_equal(v, cb[k].numpy())


@pytest.mark.parametrize("drop_last", [True, False])
def test_cached_batches_match_host_batches(drop_last):
    ds = ArangeDataset()
    host = list(loader(ds, seed=3, drop_last=drop_last).iter_batches())
    cache = DeviceDatasetCache(ds, device="cpu", num_workers=0)
    cached = list(cache.batches(loader(ds, seed=3, drop_last=drop_last)))
    assert len(cached) == (2 if drop_last else 3)
    assert ("valid" in cached[-1]) == (not drop_last)
    assert_batches_equal(host, cached)
    # and the JAX package's cache over its own loader: the same rows
    jax_loader = JaxDataLoader(ds, batch_size=8, shuffle=True, seed=3, drop_last=drop_last,
                               num_workers=0, process_index=0, num_processes=1)
    for jb, cb in zip(JaxDeviceDatasetCache(ds, num_workers=0).batches(jax_loader), cached):
        np.testing.assert_array_equal(np.asarray(jb["data"]), cb["data"].numpy())
        np.testing.assert_array_equal(np.asarray(jb["labels"]), cb["labels"].numpy())


def test_index_iterator_epoch_semantics():
    """Host and cached runs advance the loader's epoch alike, so both see
    the same permutations epoch after epoch."""
    ds = ArangeDataset(n=16)
    a, b = loader(ds, seed=0), loader(ds, seed=0)
    cache = DeviceDatasetCache(ds, device="cpu", num_workers=2)
    for _ in range(2):
        assert_batches_equal(list(a.iter_batches()), list(cache.batches(b)))
    assert a.epoch == b.epoch == 2


def test_mid_epoch_start_matches_host():
    ds = ArangeDataset(n=24)
    host = list(loader(ds, seed=7).iter_batches(1))
    cached = list(DeviceDatasetCache(ds, device="cpu", num_workers=0).batches(
        loader(ds, seed=7), start=1))
    assert len(cached) == 2
    assert_batches_equal(host, cached)


def test_none_labels_roundtrip():
    cache = DeviceDatasetCache(UnlabelledDataset(n=8), device="cpu", num_workers=0)
    batch = cache.batch(np.arange(4))
    assert batch["labels"] is None
    np.testing.assert_array_equal(batch["data"][:, 0, 0, 0].numpy(), np.arange(4, dtype=np.float32))
    assert cache.nbytes == 8 * 16 * 4


def test_budget_enforced():
    with pytest.raises(ValueError, match="device-cache budget"):
        DeviceDatasetCache(ArangeDataset(n=64), device="cpu", max_bytes=128, num_workers=0)


def test_shard_over_data_raises():
    """JAX's rule: shard_over_data without a data axis of at least 2 raises
    ``ValueError``; over a data mesh of 2 it splits the rows (ported)."""
    with pytest.raises(ValueError, match="data"):
        DeviceDatasetCache(ArangeDataset(n=8), device="cpu", shard_over_data=True)
    with pytest.raises(ValueError, match="data"):
        DeviceDatasetCache(ArangeDataset(n=8), shard_over_data=True,
                           mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    cache = DeviceDatasetCache(ArangeDataset(n=8), shard_over_data=True, num_workers=0,
                               mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    assert cache.rows_per_rank == 4 and cache.device.type == "cpu"


def test_cache_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceDatasetCache(ArangeDataset(n=8), num_workers=0)


@pytest.fixture(scope="module")
def smoke_h5(tmp_path_factory):
    """config_smoke.json's dataset written to HDF5 (a snapshot of its random
    draws), so every item is a function of its index."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    path = tmp_path_factory.mktemp("smoke") / "smoke.h5"
    SphericalHarmonicDataset(**cfg["dataset"]["kwargs"]).to_hdf5(path)
    return path


def smoke_config(h5_path, **training) -> ExperimentConfig:
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["dataset"]["kwargs"]["h5_path"] = str(h5_path)
    cfg["training"].update(loggers=["jsonl"], **training)
    return ExperimentConfig.from_dict(cfg)


@pytest.mark.parametrize("val_fraction", [0.0, 0.25], ids=["whole", "with-validation"])
def test_trainer_device_cache_gives_the_same_losses(tmp_path, smoke_h5, val_fraction):
    """Two epochs of config_smoke.json with and without the cache: the same
    losses and gradient norms, bitwise (the cache changes how a batch
    reaches the device, not which rows it holds)."""
    logged = {}
    for flag in (False, True):
        work = tmp_path / f"cache_{flag}"
        trainer = Trainer(smoke_config(smoke_h5, device_cache=flag, val_fraction=val_fraction),
                          work_dir=work, device="cpu")
        trainer.fit()
        assert ("device_cache" in trainer.__dict__) == flag  # built only when asked for
        if flag:
            cache = trainer.device_cache
            n_train = len(trainer.loader.dataset)
            assert n_train == (12 if val_fraction else 16)
            assert cache.nbytes == n_train * (8 ** 3 + 256) * 4
        records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
        logged[flag] = [(r["train_loss"], r["grad_norm"]) for r in records if "train_loss" in r]
    assert len(logged[True]) == (2 if val_fraction else 4)
    assert logged[True] == logged[False]


def test_trainer_device_cache_resumes_mid_epoch(tmp_path, smoke_h5):
    """A cached run preempted at step 1 (mid-epoch) and resumed ends with
    the parameters of an uninterrupted cached run, bitwise: the resumed
    epoch's gathers start at the loader's cursor."""
    want = Trainer(smoke_config(smoke_h5, device_cache=True), work_dir=tmp_path / "a",
                   device="cpu").fit()
    first = Trainer(smoke_config(smoke_h5, device_cache=True), work_dir=tmp_path / "b",
                    device="cpu", loggers=["jsonl", SignalAtStep(1)])
    assert first.fit().step == 1
    again = Trainer(smoke_config(smoke_h5, device_cache=True), work_dir=tmp_path / "b",
                    device="cpu")
    state = again.init_state()
    assert state.step == 1
    got = again.fit(state)
    assert got.step == want.step == 4
    for name, w in want.model.state_dict().items():
        assert torch.equal(w, got.model.state_dict()[name]), name
