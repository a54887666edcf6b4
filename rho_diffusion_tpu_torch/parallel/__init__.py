"""Parallel layouts of the port: the device mesh and its placements, the
single-controller rank runner, ring and Ulysses attention, spatial (depth)
sharding, ZeRO-1, FSDP, tensor parallelism and the multi-process runtime.
Port of ``rho_diffusion_tpu/parallel/``: every name it exports."""
from rho_diffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    Mesh,
    Placed,
    Sharding,
    active_mesh,
    batch_sharding,
    create_state_fsdp,
    fsdp_abstract_state,
    fsdp_shardings,
    get_active_mesh,
    initialize_distributed,
    make_mesh,
    replicate_state,
    replicated,
    shard_batch,
    shard_opt_state_zero1,
    shard_state_fsdp,
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
from rho_diffusion_tpu_torch.parallel.runtime import (  # noqa: F401
    accelerator_available,
    barrier,
    get_device_stats,
    parse_devices,
    runtime_summary,
)
from rho_diffusion_tpu_torch.parallel.tensor import (  # noqa: F401
    shard_params_for_tp,
    tp_sharding_summary,
)
