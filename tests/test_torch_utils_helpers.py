"""The port's ``utils`` helpers and the bench's ``BENCH_FLAT_OPT`` against the
JAX package's, on the CPU.

* ``vector_to_embeddings`` and ``right_pad_dims_to`` (numpy arrays and torch
  tensors) equal ``rho_diffusion_tpu.utils``'s bitwise.
* ``plot_image_grid`` writes a PNG of the same pixel shape, and a figure of
  the same grid, as JAX's for [N, H, W] and [N, H, W, 1]; ``plot_tensor_images``
  draws a 2-D batch through it, as JAX's does.
* The fused AdamW step (``Optimizer.fused``, what ``BENCH_FLAT_OPT=1`` sets)
  over 3 updates of seeded parameters and gradients equals
  ``optax.flatten(optax.adamw(...))`` within 1e-6 relative (L2 over all
  parameters), and the port's unfused step within 1e-6; the classes without
  a fused update refuse it.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rho_diffusion_tpu import utils as jax_utils
from rho_diffusion_tpu_torch import utils
from rho_diffusion_tpu_torch.training.optimizers import build_optimizer

torch.set_num_threads(1)


@pytest.mark.parametrize("l", [128, 256, 64])
def test_vector_to_embeddings_bitwise(l):  # noqa: E741
    v = [0, 3, -2, 7.9, np.int64(12)]
    got = utils.vector_to_embeddings(v, "l", l=l)
    want = jax_utils.vector_to_embeddings(v, "l", l=l)
    assert got.dtype == want.dtype == np.float32 and got.shape == (5, max(l, 128))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,target", [((3,), 4), ((2, 5), 5), ((2, 5, 1), 2), ((), 3)])
def test_right_pad_dims_to_bitwise(shape, target):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_utils.right_pad_dims_to(jnp.asarray(x), target))
    got_np = utils.right_pad_dims_to(x, target)
    got_t = utils.right_pad_dims_to(torch.from_numpy(x), target)
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    for got in (got_np, got_t.numpy()):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if len(shape) >= target:
        assert utils.right_pad_dims_to(x, target) is x


@pytest.mark.parametrize("shape", [(5, 8, 8), (5, 8, 8, 1), (9, 6, 7, 1)],
                         ids=["nhw", "nhw1", "ragged"])
def test_plot_image_grid_matches_jax(tmp_path, shape):
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    imgs = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    figs, pngs = [], []
    for name, fn in (("port", utils.plot_image_grid), ("jax", jax_utils.plot_image_grid)):
        path = tmp_path / f"{name}.png"
        figs.append(fn(imgs, filename=str(path)))
        pngs.append(mpimg.imread(path))
        plt.close(figs[-1])
    port, jax_fig = figs
    assert pngs[0].shape == pngs[1].shape and pngs[0].size > 0
    assert len(port.axes) == len(jax_fig.axes) == 4 * -(-shape[0] // 4)
    assert tuple(port.get_size_inches()) == tuple(jax_fig.get_size_inches())
    assert sum(bool(ax.images) for ax in port.axes) == shape[0]
    # a 2-D batch through plot_tensor_images takes the same grid
    path = tmp_path / "tensor.png"
    plt.close(utils.plot_tensor_images(imgs[..., None] if len(shape) == 3 else imgs,
                                       filename=str(path)))
    assert mpimg.imread(path).shape == pngs[0].shape


SHAPES = [(16, 8, 3, 3, 3), (16,), (32, 16), (7,)]
LR, STEPS = 3e-3, 3


def seeded(seed: int) -> tuple[list, list]:
    """Parameters and STEPS gradients per parameter, from numpy."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(STEPS)]
    return params, grads


def port_adamw(params, grads, fused: bool) -> list:
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = build_optimizer("AdamW", {"lr": LR})
    opt.fused = fused
    optim = opt.make(ps)
    if fused:
        assert all(g["fused"] for g in optim.param_groups)
    for step, gs in enumerate(grads):
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        opt.set_lr(optim, step)
        optim.step()
    return [p.detach().numpy() for p in ps]


def rel_l2(got: list, want: list) -> float:
    num = sum(float(np.sum((np.float64(a) - np.float64(b)) ** 2)) for a, b in zip(got, want))
    return np.sqrt(num / sum(float(np.sum(np.float64(b) ** 2)) for b in want))


def test_fused_adamw_matches_optax_flatten():
    params, grads = seeded(3)
    tx = optax.flatten(optax.adamw(LR, weight_decay=0.01))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
    want = [np.asarray(p) for p in jp]
    fused = port_adamw(params, grads, fused=True)
    plain = port_adamw(params, grads, fused=False)
    moved = rel_l2(params, want)
    assert moved > 1e-4  # three steps of 3e-3 moved every parameter
    assert rel_l2(fused, want) < 1e-6, rel_l2(fused, want)
    assert rel_l2(fused, plain) < 1e-6, rel_l2(fused, plain)


@pytest.mark.parametrize("name", ["Lion", "RMSprop"])
def test_fused_refused_without_a_fused_update(name):
    opt = build_optimizer(name, {"lr": 1e-3})
    opt.fused = True
    with pytest.raises(ValueError, match="no fused update"):
        opt.make([torch.nn.Parameter(torch.zeros(3))])
