"""Losses, training metrics, the VLB pieces, the Sinkhorn divergence and the
spectral comb metrics of the port (the names of the JAX package's
``metrics``)."""
from rho_diffusion_tpu_torch.metrics.losses import (  # noqa: F401
    discretized_gaussian_log_likelihood,
    normal_kl,
    psnr,
    resolve_loss,
)
from rho_diffusion_tpu_torch.metrics.geom import WassersteinWrapper, sinkhorn_divergence  # noqa: F401
from rho_diffusion_tpu_torch.metrics.spectral import comb_metrics, peak_stats  # noqa: F401
