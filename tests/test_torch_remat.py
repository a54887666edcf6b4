"""Activation recomputation (``use_checkpoint``) in the port's UNetv2.

On the CPU, a small 3-D UNetv2 (8^3, model_channels 16, channel_mult (1, 2),
attention at the second level) with recomputation:

* gives a forward and parameter gradients bitwise equal to the same model
  without it (the recompute runs the same CPU ops on the same inputs), with
  the same state_dict keys, and runs each ResBlock's and AttentionBlock's
  forward a second time in the backward; in eval mode or without grad it
  does not;
* through the DDPM loss (fp32, nonzero weights), agrees with the JAX
  package's ``use_checkpoint=True`` UNet under ``jax.value_and_grad`` at
  the training parity bar of tests/test_torch_train_ops.py: loss within
  1e-5 relative, every gradient leaf within 1e-4 relative rms plus 1e-5 of
  the rms over all gradients.
"""
import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.models.unet import AttentionBlock, ResBlock, UNet

torch.set_num_threads(1)

SMALL = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=1, model_channels=16,
             num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
             num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=50, beta_1=1e-4, beta_T=2e-2)


def unet(use_checkpoint, seed=0):
    torch.manual_seed(seed)
    model = UNet(**SMALL, use_checkpoint=use_checkpoint)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():  # no zero-initialised layer: every gradient is nonzero
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)),
            torch.tensor([3, 41]),
            torch.from_numpy(rng.uniform(0, 2, size=(2, 64)).astype(np.float32)))


def forward_backward(model):
    model.train()
    out = model(*inputs())
    (out ** 2).mean().backward()
    return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.fixture
def block_calls(monkeypatch):
    """Counts of ResBlock and AttentionBlock forwards (first run or
    recompute)."""
    calls = {"res": 0, "attn": 0}
    for cls, key in ((ResBlock, "res"), (AttentionBlock, "attn")):
        block = cls.block

        def counted(self, *args, _block=block, _key=key):
            calls[_key] += 1
            return _block(self, *args)

        monkeypatch.setattr(cls, "block", counted)
    return calls


def test_recompute_is_bitwise_and_keeps_the_state_dict(block_calls):
    plain, remat = unet(False), unet(True)
    assert list(plain.state_dict()) == list(remat.state_dict())
    for k, v in plain.state_dict().items():
        assert torch.equal(v, remat.state_dict()[k]), k
    n_res = sum(isinstance(m, ResBlock) for m in plain.modules())
    n_attn = sum(isinstance(m, AttentionBlock) for m in plain.modules())
    assert n_res and n_attn

    out_plain, grads_plain = forward_backward(plain)
    assert block_calls == {"res": n_res, "attn": n_attn}
    out_remat, grads_remat = forward_backward(remat)
    # each block ran twice: once in the forward, once recomputed in the backward
    assert block_calls == {"res": 3 * n_res, "attn": 3 * n_attn}
    assert torch.equal(out_plain, out_remat)
    assert grads_plain.keys() == grads_remat.keys()
    for k in grads_plain:
        assert torch.equal(grads_plain[k], grads_remat[k]), k


def test_no_recompute_in_eval_or_without_grad(block_calls):
    model = unet(True)
    model.eval()
    x, t, y = inputs()
    with torch.no_grad():
        model(x, t, y)
    model.train()
    with torch.no_grad():
        model(x, t, y)
    n = sum(isinstance(m, (ResBlock, AttentionBlock)) for m in model.modules())
    assert block_calls["res"] + block_calls["attn"] == 2 * n


def perturbed_params(jpipe, seed=0):
    params = jpipe.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def test_recomputed_gradients_match_jax_use_checkpoint():
    kw = dict(SMALL, use_checkpoint=True)
    jpipe = JaxDDPM("UNetv2", kw, jax_schedule.LinearSchedule(**SCHEDULE))
    params = perturbed_params(jpipe)
    rng = np.random.default_rng(7)
    batch = {"data": rng.uniform(0, 1, size=(3, 8, 8, 8, 1)).astype(np.float32),
             "labels": rng.uniform(0, 2, size=(3, 64)).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jpipe.loss_and_metrics(p, batch, key), has_aux=True))(params)
    t_rng, n_rng = jax.random.split(key)
    t = np.array(jax.random.randint(t_rng, (3,), 0, 50))
    noise = np.array(jax.random.normal(n_rng, batch["data"].shape))

    pipe = DDPM("UNetv2", kw, schedule.LinearSchedule(**SCHEDULE), device="cpu")
    assert pipe.backbone.use_checkpoint
    sd = export_unet_state_dict(params, **arch_kwargs(kw))
    pipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    pipe.backbone.train()
    got_loss, _ = pipe.loss_and_metrics({k: torch.from_numpy(v) for k, v in batch.items()},
                                        t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    want = export_unet_state_dict(jax.tree_util.tree_map(np.asarray, grads), **arch_kwargs(kw))
    got = dict(pipe.backbone.named_parameters())
    assert set(got) == set(want)
    floor = 1e-5 * np.sqrt(np.mean(np.concatenate([w.ravel() for w in want.values()]) ** 2))
    for name, w in want.items():
        g = got[name].grad.numpy()
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-4 * np.sqrt(np.mean(w ** 2)) + floor, name
