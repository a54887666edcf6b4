"""Multi-host training with an explicit rendezvous.

    python -m rho_diffusion_tpu_torch.training_multihost CONFIG.json \\
        --coordinator HOST:PORT --num-processes N --process-id I \\
        [-p WEIGHTS] [-e EPOCHS] [--work-dir DIR] [-d cuda|cpu]

Port of ``scripts/training_multihost.py``: run once on each host, process I
of N, all naming process 0's ``HOST:PORT``. Without ``--coordinator`` the
world comes from the launcher's environment as in ``training_ddp`` (and a
single process without one). Everything after the rendezvous is
``training_ddp``'s run.
"""
from __future__ import annotations

from typing import Optional, Sequence

from rho_diffusion_tpu_torch.training.state import TrainState
from rho_diffusion_tpu_torch.training_ddp import parser, train


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    import torch.distributed as dist

    from rho_diffusion_tpu_torch.parallel.mesh import initialize_distributed

    p = parser(__doc__)
    p.add_argument("--coordinator", default=None, help="process 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    if args.coordinator:
        initialize_distributed(coordinator_address=args.coordinator,
                               num_processes=args.num_processes, process_id=args.process_id)
    else:
        initialize_distributed()
    try:
        return train(args.json_config, args.work_dir, args.device, args.model_checkpoint_path,
                     args.epochs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
