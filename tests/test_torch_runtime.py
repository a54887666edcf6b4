"""The port's multi-process runtime against the JAX package's, on the CPU.

* ``mpi_world_from_env`` on the ten launcher environments of
  tests/parallel/test_mpi_env.py: the same world (or the same refusal) as
  JAX's;
* the introspection (``runtime_summary``, ``parse_devices``,
  ``accelerator_available``, ``get_device_stats``, ``barrier``) of one
  process, and ``initialize_distributed`` doing nothing without a launcher;
* the loader's rows for each process of two against JAX's loader's;
* the Trainer's mesh without ``training.mesh``: every visible card (the
  device count patched), as JAX's trainer spans every device; over two
  processes (the process count patched) each gets its half of the data
  ranks, and the options not ported over processes raise;
* ``training_ddp`` without a launcher environment trains as one process.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rho_diffusion_tpu.data.loader import DataLoader as JaxDataLoader
from rho_diffusion_tpu.parallel.runtime import mpi_world_from_env as jax_world
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.parallel import (
    accelerator_available,
    barrier,
    get_device_stats,
    initialize_distributed,
    parse_devices,
    runtime,
    runtime_summary,
)
from rho_diffusion_tpu_torch.parallel.runtime import mpi_world_from_env
from rho_diffusion_tpu_torch.training import trainer as trainer_module

ROOT = Path(__file__).resolve().parents[1]

# tests/parallel/test_mpi_env.py's environments, in its order
ENVS = [
    {},
    {"PMI_SIZE": "1", "PMI_RANK": "0"},
    {"PMI_SIZE": "4", "PMI_RANK": "2", "MPI_LOCALRANKID": "1",
     "HYDRA_BSTRAP_LOCALHOST": "node0.cluster"},
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
    {"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.7",
     "MASTER_PORT": "12345"},
    {"PMI_SIZE": "2", "PMI_RANK": "0", "WORLD_SIZE": "16", "RANK": "9"},
    {"PMI_SIZE": "2"},
    {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "1",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4",
     "MASTER_ADDR": "10.0.0.3"},
]


def resolve(fn, env):
    try:
        return fn(env)
    except RuntimeError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("env", ENVS, ids=[f"env{i}" for i in range(len(ENVS))])
def test_mpi_world_from_env_matches_jax(env):
    assert resolve(mpi_world_from_env, env) == resolve(jax_world, env)


def test_one_process_runtime():
    """Without a process group: process 0 of 1, the CPU's introspection,
    a barrier that returns, and ``initialize_distributed`` (no launcher
    environment, or a world of one) joining nothing."""
    initialize_distributed()
    initialize_distributed(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert (runtime.process_index(), runtime.process_count()) == (0, 1)
    barrier()
    summary = runtime_summary()
    assert summary == {"platform": "cpu", "backend": None, "device_count": 1,
                       "local_device_count": 1, "process_index": 0, "process_count": 1,
                       "devices": ["cpu"]}
    assert accelerator_available("cpu") and not accelerator_available("cuda")
    assert parse_devices() == [torch.device("cpu")] == parse_devices(1)
    assert get_device_stats("cpu")["bytes_in_use"] is None


class Items:
    parameter_space = None

    def __len__(self):
        return 21

    def __getitem__(self, i):
        return np.full((2, 2, 1), float(i), np.float32), np.asarray([i], np.float32)


@pytest.mark.parametrize("processes", [2, 3])
def test_loader_rows_per_process_match_jax(processes):
    """Each process's rows of every batch of two epochs (a wrap-padded last
    one among them), as JAX's loader gives that process."""
    for index in range(processes):
        ours = DataLoader(Items(), batch_size=6, seed=4, drop_last=False, num_workers=0,
                          process_index=index, num_processes=processes)
        jaxs = JaxDataLoader(Items(), batch_size=6, seed=4, drop_last=False, num_workers=0,
                             process_index=index, num_processes=processes)
        assert ours.local_batch_size == jaxs.local_batch_size == 6 // processes
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            jaxs.set_epoch(epoch)
            for a, b in zip(ours, jaxs, strict=True):
                np.testing.assert_array_equal(a["data"], b["data"])
                np.testing.assert_array_equal(a.get("valid"), b.get("valid"))
    with pytest.raises(ValueError, match="divide across"):
        DataLoader(Items(), batch_size=5, num_processes=2, process_index=0)


def config(**training):
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["training"].update(training)
    return ExperimentConfig.from_dict(cfg)


def cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_mesh_without_training_mesh_spans_every_card(monkeypatch):
    """JAX's trainer spans every device when ``training.mesh`` is absent
    (its lr then scales by sqrt(their count)); so does the port's, over the
    visible cards (4 here). The CPU keeps its one rank."""
    cards(monkeypatch, 4)
    mesh = trainer_module.mesh_from_config(config(), torch.device("cuda", 0))
    assert mesh.shape == {"data": 4, "context": 1}
    assert [row[0].index for row in mesh.devices] == [0, 1, 2, 3]
    mesh = trainer_module.mesh_from_config(config(mesh={"context": 2}), torch.device("cuda", 0))
    assert mesh.shape == {"data": 2, "context": 2}
    mesh = trainer_module.mesh_from_config(config(mesh={"data": 2}), torch.device("cuda", 0))
    assert mesh.shape == {"data": 2, "context": 1}
    assert trainer_module.mesh_from_config(config(), torch.device("cpu")).shape == {
        "data": 1, "context": 1}


def test_two_processes_split_the_mesh(monkeypatch):
    """Over two processes (patched) each driving two cards, a global data
    4 x context 1 mesh gives each process 2 data ranks on its cards; a data
    count that does not split raises; device_cache raises as JAX's does,
    and zero1 and fsdp over processes name item 13c."""
    cards(monkeypatch, 2)
    monkeypatch.setattr(runtime, "process_count", lambda: 2)
    monkeypatch.setattr(runtime, "process_index", lambda: 1)
    mesh = trainer_module.mesh_from_config(config(mesh={"data": 4}), torch.device("cuda", 0))
    assert mesh.shape == {"data": 2, "context": 1}
    assert [row[0].index for row in mesh.devices] == [0, 1]
    with pytest.raises(ValueError, match="do not split over 2 processes"):
        trainer_module.mesh_from_config(config(mesh={"data": 3}), torch.device("cuda", 0))
    assert DataLoader(Items(), batch_size=6).process_index == 1
    from rho_diffusion_tpu_torch.data.device_cache import DeviceDatasetCache

    with pytest.raises(ValueError, match="single-process"):
        DeviceDatasetCache(Items(), device="cpu")
    for option in ({"zero1": True}, {"fsdp": True}):
        with pytest.raises(NotImplementedError, match="item 13c"):
            trainer_module.check_mesh_options(config(**option))


def test_training_ddp_without_launcher_is_one_process(tmp_path, monkeypatch, capsys):
    """No launcher environment: no process group, a one-process run of the
    training CLI's kind (its checkpoint, model.pth and metrics)."""
    from rho_diffusion_tpu_torch import training_ddp

    for name in ("WORLD_SIZE", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    state = training_ddp.main([str(ROOT / "examples" / "config_smoke.json"), "-d", "cpu",
                               "-e", "1", "--work-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    assert state.step == 2 and (tmp_path / "model.pth").exists()
    assert "'process_count': 1" in capsys.readouterr().out
    assert list((tmp_path / "checkpoints").glob("step_2.pt"))
