"""Weight interop of the port: JAX params, reference .pth files and
diffusers UNet2DModel checkpoints."""
from rho_diffusion_tpu_torch.interop.hf_unet_weights import (  # noqa: F401
    load_hf_unet2d_checkpoint,
    transplant_hf_unet2d_state_dict,
)
from rho_diffusion_tpu_torch.interop.jax_weights import (  # noqa: F401
    export_named_state_dict,
    export_unet_state_dict,
    load_jax_npz,
    load_state_dict_file,
)
