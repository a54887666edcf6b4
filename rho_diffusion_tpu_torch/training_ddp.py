"""Launcher-driven multi-process training (``mpiexec``, ``torchrun``).

    mpiexec -n N python -m rho_diffusion_tpu_torch.training_ddp CONFIG.json
        [-p WEIGHTS] [-e EPOCHS] [--work-dir DIR] [-d cuda|cpu]

Port of ``scripts/training_ddp.py``: the world comes from the launcher's
environment (``parallel.runtime.mpi_world_from_env``: Intel MPI's PMI_*,
Open MPI's, or torchrun's WORLD_SIZE/RANK/LOCAL_RANK/MASTER_ADDR), and every
process joins one ``torch.distributed`` group
(``parallel.mesh.initialize_distributed``: NCCL when each process of a host
has a card of its own, gloo otherwise). With that environment present a
failed rendezvous is fatal; without it the run is a single process, like
``python -m rho_diffusion_tpu_torch.training``. The ``Trainer`` then splits
the global mesh's data ranks over the processes, each process loads its
rows of every batch, gradients are averaged over the processes, the lr
scales by sqrt(the global rank count), and process 0 logs and writes the
checkpoints.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.training.state import TrainState


def train(config_path: Path, work_dir: Path, device: Optional[str], weights: Optional[str],
          epochs: Optional[int]) -> TrainState:
    """The Trainer's run in the joined group: a summary line from process
    0, then the fit."""
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.parallel import runtime
    from rho_diffusion_tpu_torch.training.trainer import Trainer

    if runtime.process_index() == 0:
        print(runtime.runtime_summary(), flush=True)
    config = ExperimentConfig.from_json(config_path)
    trainer = Trainer(config, work_dir=work_dir, device=device)
    state = trainer.init_state(weights_path=weights)
    return trainer.fit(state, max_epochs=epochs)


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("json_config", type=Path)
    p.add_argument("-p", dest="model_checkpoint_path", default=None)
    p.add_argument("-e", "--epochs", type=int, default=None)
    p.add_argument("--work-dir", type=Path, default=Path("."))
    p.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    import torch.distributed as dist

    from rho_diffusion_tpu_torch.parallel.mesh import initialize_distributed
    from rho_diffusion_tpu_torch.parallel.runtime import mpi_world_from_env

    args = parser(__doc__).parse_args(argv)
    world = mpi_world_from_env()
    if world is not None:
        # the launcher asks for several processes: init_process_group raises
        # on a failed rendezvous, and nothing here swallows it
        initialize_distributed(
            coordinator_address=world["coordinator_address"],
            num_processes=world["num_processes"], process_id=world["process_id"],
            local_rank=world["local_rank"], local_size=world["local_size"])
    try:
        return train(args.json_config, args.work_dir, args.device, args.model_checkpoint_path,
                     args.epochs)
    finally:
        if world is not None and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
