"""Parallel layouts of the port: the device mesh and context-parallel
(ring) attention. Port of the parts of ``rho_diffusion_tpu/parallel/`` that
sampling under a context mesh runs; the rest waits for ROADMAP Queue 1
item 13."""
from rho_diffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    Mesh,
    active_mesh,
    get_active_mesh,
    make_mesh,
)
from rho_diffusion_tpu_torch.parallel.context import (  # noqa: F401
    context_sharded_attention,
    ring_attention,
)
