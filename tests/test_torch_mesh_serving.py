"""The sampling service over a mesh of CPU ranks against the data-1 service.

JAX's service under a mesh (rho_diffusion_tpu/serving.py:207-218,
:553-580) splits each launch's rows over the data ranks and, with context >
1, the volume's depth over the context ranks. The port's does the same,
rank by rank (``parallel.spmd``): each rank samples its rows and slab, the
slabs' convs exchange halos, GroupNorm sums over the slabs, attention rings
over the slabs' tokens, and each row's noise is that row's stream cut to
the slab. On the CPU the samples are the data-1 service's to rounding.
"""
import numpy as np
import pytest
import torch

from chip_smoke import random_state_dict
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.gaussian import GaussianDiffusionPipeline
from rho_diffusion_tpu_torch.diffusion.schedule import LinearSchedule
from rho_diffusion_tpu_torch.ops.convolution import record_conv_inputs
from rho_diffusion_tpu_torch.parallel.mesh import make_mesh
from rho_diffusion_tpu_torch.serving import SamplingService

torch.set_num_threads(1)
MODEL = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=1, model_channels=16,
             num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
             num_classes=4, use_scale_shift_norm=True)


def pipeline(kind: str, **over):
    kwargs = dict(MODEL, **over)
    if kind == "ddpm":
        pipe = DDPM("UNetv2", kwargs, LinearSchedule(8, 1e-4, 2e-3), device="cpu")
    else:
        pipe = GaussianDiffusionPipeline("UNetv2", kwargs, LinearSchedule(100, 1e-4, 2e-2),
                                         device="cpu")
    pipe.load_state_dict(random_state_dict(pipe.backbone, 1))
    return pipe


CONDS = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32)


@pytest.mark.parametrize("kind,data,context", [("ddpm", 2, 2), ("ddpm", 2, 1),
                                               ("gauss", 2, 2), ("ddpm", 1, 4)])
def test_meshed_service_rows_match_the_data1_service(kind, data, context):
    """A 5-row request (two launches of bucket 4, one padded) on the mesh
    against the same request on one rank; with context > 1 every 3x3x3
    conv saw a slab of D/context + 2 planes and no whole volume."""
    pipe = pipeline(kind)
    opts = dict(batch_buckets=(4,), max_delay_s=0.0, cond_dim=64)
    if kind == "gauss":
        opts.update(sampler="ddim", num_steps=5)
    with SamplingService(pipe, **opts) as one:
        want = one.generate(CONDS, seed=3).samples
    mesh = make_mesh(data, context, devices=["cpu"] * (data * context))
    with SamplingService(pipe, mesh=mesh, **opts) as meshed:
        with record_conv_inputs() as shapes:
            got = meshed.generate(CONDS, seed=3).samples
        assert meshed.stats()["mesh"] == {"data": data, "context": context}
    assert got.shape == want.shape == (5, 8, 8, 8, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert {s[1] for s in shapes} == {8 // context + 2 if context > 1 else 8}


def test_meshed_service_with_ulysses_attention():
    """The UNet's attention on the "ulysses" backend (2 heads over 2 context
    ranks): the all-to-all runs over the slabs' tokens, and the samples are
    the data-1 service's."""
    pipe = pipeline("ddpm", attention_backend="ulysses")
    opts = dict(batch_buckets=(2,), max_delay_s=0.0, cond_dim=64)
    with SamplingService(pipe, **opts) as one:
        want = one.generate(CONDS[:2], seed=5).samples
    with SamplingService(pipe, mesh=make_mesh(1, 2, devices=["cpu"] * 2), **opts) as meshed:
        got = meshed.generate(CONDS[:2], seed=5).samples
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_meshed_service_rules():
    """Every bucket divides by the data axis; the depth divides by the
    context axis; int8 under a depth-sharded service raises."""
    pipe = pipeline("ddpm")
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        SamplingService(pipe, batch_buckets=(2, 3), mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    with SamplingService(pipe, batch_buckets=(1,), max_delay_s=0.0, cond_dim=64,
                         mesh=make_mesh(1, 3, devices=["cpu"] * 3)) as svc:
        with pytest.raises(ValueError, match="does not split over 3 context ranks"):
            svc.generate(CONDS[:1], seed=0)
    with pytest.raises(NotImplementedError, match="spatial sharding"):
        SamplingService(pipe, batch_buckets=(1,), cond_dim=64, warmup=True, quantize="int8",
                        mesh=make_mesh(1, 2, devices=["cpu"] * 2))
