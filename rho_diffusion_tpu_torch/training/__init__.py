"""Training of the port: optimizers and LR schedules, EMA, the training
state, checkpoints, metric loggers and the Trainer
(``python -m rho_diffusion_tpu_torch.training``).

The submodules are imported where they are used: ``diffusion.base`` needs
the state, EMA and optimizers, and the trainer needs ``diffusion``.
"""
