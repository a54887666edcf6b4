"""Parallel layouts of the port: the device mesh and its placements, the
single-controller rank runner, ring and Ulysses attention, and spatial
(depth) sharding. Port of ``rho_diffusion_tpu/parallel/`` but FSDP, tensor
parallelism and the multi-process runtime (ROADMAP Queue 1 item 13b)."""
from rho_diffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    Mesh,
    Placed,
    Sharding,
    active_mesh,
    batch_sharding,
    get_active_mesh,
    make_mesh,
    replicate_state,
    replicated,
    shard_batch,
    shard_opt_state_zero1,
)
from rho_diffusion_tpu_torch.parallel.context import (  # noqa: F401
    context_sharded_attention,
    ring_attention,
)
from rho_diffusion_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange,
    sharded_conv3d_local,
    spatial_sharded_conv3d,
)
from rho_diffusion_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_sharded_attention,
)
