"""The port's benchmark entries, each ``python -m
rho_diffusion_tpu_torch.benchmarks.<name> [-d cuda|cpu]``: the conv
bottleneck-isolation variants (K7-K9), the conv kernel against cuDNN per
shape, and the per-level conv profile beside the equal-FLOP matmul; the
serving load harness, the op table, the learned-variance twins; and the 3-D
Y_lm quality harnesses (``sampler_quality``, ``ema_ablation``,
``demo_min_snr``, ``demo_cfg``, ``sh_holdout``, ``demo_distill``,
``vit_ab``, ``demo64``) on their shared setup and scorer, ``_ylm``."""
