"""One process of tests/test_torch_multiprocess.py's two-process run.

    python tests/torch_multiprocess_worker.py RANK WORLD PORT DIR

Joins a gloo group of WORLD processes at 127.0.0.1:PORT, builds the tiny
2-D DDPM, loads the state DIR/state.pt holds (JAX's, carried across), and
takes two steps over 4 CPU ranks of its own with the global draws of
DIR/draws.pt, its rows of each batch from the port's loader. Prints one
line, ``RESULT {"losses": [...], "rows": [...]}``: the losses and, per
step, the sum of each of its rows' data.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rho_diffusion_tpu_torch.data.loader import DataLoader  # noqa: E402
from rho_diffusion_tpu_torch.diffusion import schedule  # noqa: E402
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM  # noqa: E402
from rho_diffusion_tpu_torch.parallel import runtime  # noqa: E402
from rho_diffusion_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed,
    make_mesh,
    replicate_state,
    shard_batch,
)
from rho_diffusion_tpu_torch.training.state import TrainState  # noqa: E402


class Fields:
    """Items that are a function of their index (the test's dataset)."""

    parameter_space = None

    def __len__(self):
        return 16

    def __getitem__(self, i):
        gen = torch.Generator().manual_seed(int(i))
        return (torch.rand((8, 8, 1), generator=gen).numpy() * 2 - 1,
                torch.rand((64,), generator=gen).numpy() * 2)


TINY = dict(dims=2, data_shape=[8, 8], in_channels=1, out_channels=1, model_channels=16,
            num_res_blocks=1, channel_mult=[1], attention_resolutions=[1], num_heads=2,
            num_classes=20, use_scale_shift_norm=True)


def pipeline():
    return DDPM("UNetv2", TINY, schedule.LinearSchedule(50, 1e-4, 2e-2), device="cpu",
                optimizer="AdamW", opt_kwargs={"lr": 1e-3}, ema_decay=0.999, world_size=8)


def run(pipe, state: TrainState, mesh, loader, draws) -> tuple[list, list]:
    """Two steps from ``state`` with the global ``draws``: the losses and
    the row sums of each local batch."""
    replicate_state(state, mesh)
    loader.set_epoch(0)
    losses, rows = [], []
    for batch, d in zip(loader, draws):
        metrics = pipe.training_step(state, shard_batch(batch, mesh), **d)
        losses.append(float(metrics["train_loss"]))
        rows.append(batch["data"].reshape(len(batch["data"]), -1).sum(axis=1).tolist())
    return losses, rows


def main() -> None:
    rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank, local_rank=rank, local_size=world)
    torch.set_num_threads(1)
    pipe = pipeline()
    state = pipe.create_state(seed=0)
    state.load_state_dict(torch.load(work / "state.pt", weights_only=True))
    draws = torch.load(work / "draws.pt", weights_only=True)
    loader = DataLoader(Fields(), batch_size=8, seed=0, num_workers=0)
    assert (loader.process_index, loader.num_processes) == (rank, world)
    losses, rows = run(pipe, state, make_mesh(8 // world, 1, devices=["cpu"] * (8 // world)),
                       loader, draws)
    runtime.barrier()
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps({"losses": losses, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
