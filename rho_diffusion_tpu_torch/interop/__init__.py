"""Weight interop of the port: JAX params and reference .pth files."""
from rho_diffusion_tpu_torch.interop.jax_weights import (  # noqa: F401
    export_named_state_dict,
    export_unet_state_dict,
    load_jax_npz,
    load_state_dict_file,
)
