"""The port's benchmark entries, each ``python -m
rho_diffusion_tpu_torch.benchmarks.<name> [-d cuda|cpu]``: the conv
bottleneck-isolation variants (K7-K9), the conv kernel against cuDNN per
shape, and the per-level conv profile beside the equal-FLOP matmul."""
