"""Ulysses sequence parallelism of the port against the JAX package's, on
CPU ranks (``["cpu"] * n``; JAX on its 8 virtual CPU devices).

* ``ulysses_sharded_attention`` (each rank's full-T attention through the
  port's flash Function, its plain version on the CPU) against JAX's, at
  context 2 and 4, values and q/k/v gradients, rel MSE < 1e-9;
* the "ulysses" backend under an active mesh, its fallback to full
  attention where the heads do not divide by the context ranks, and
  without a mesh (JAX :102-113);
* inside the ranks of a depth-sharded volume, Ulysses and its fallback
  over the slabs' tokens against full attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.ops.attention import xla_attention as jax_xla_attention
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel.ulysses import ulysses_sharded_attention as jax_ulysses
from rho_diffusion_tpu_torch.ops.attention import attention, xla_attention
from rho_diffusion_tpu_torch.parallel import spmd
from rho_diffusion_tpu_torch.parallel.mesh import active_mesh, batch_sharding, make_mesh
from rho_diffusion_tpu_torch.parallel.ulysses import ulysses_sharded_attention

torch.set_num_threads(1)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("data,context", [(4, 2), (2, 4)])
def test_ulysses_matches_jax(data, context):
    """4 heads of 16 over 64 tokens at batch 4: values and the gradients of
    a weighted sum in q, k and v."""
    q, k, v = qkv((4, 64, 4, 16), seed=context)
    w = np.random.default_rng(9).normal(size=(4, 64, 4, 16)).astype(np.float32)
    jmesh = jax_make_mesh(data=data, context=context)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_ulysses(jq, jk, jv, jmesh))
    want_grads = jax.grad(lambda a, b, c: jnp.sum(jax_ulysses(a, b, c, jmesh) * w),
                          argnums=(0, 1, 2))(jq, jk, jv)

    mesh = make_mesh(data, context, devices=["cpu"] * (data * context))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ulysses_sharded_attention(*ts, mesh)
    assert rel_mse(got.detach().numpy(), want) < 1e-9
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want_grads):
        assert rel_mse(t.grad.numpy(), np.asarray(g)) < 1e-9


def test_ulysses_backend_dispatch_and_fallback():
    """JAX's test_ulysses_backend_dispatch_and_fallback on the port: heads
    that divide the context axis run Ulysses, heads that do not (2 heads
    over 4 ranks) and calls without a mesh are full attention."""
    q, k, v = (torch.from_numpy(a) for a in qkv((2, 16, 2, 8), seed=4))
    ref = xla_attention(q, k, v)
    want = jax_xla_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    assert rel_mse(ref.numpy(), np.asarray(want)) < 1e-12
    with active_mesh(make_mesh(4, 2, devices=["cpu"] * 8)):
        assert rel_mse(attention(q, k, v, backend="ulysses").numpy(), ref.numpy()) < 1e-12
    with active_mesh(make_mesh(2, 4, devices=["cpu"] * 8)):
        np.testing.assert_array_equal(attention(q, k, v, backend="ulysses").numpy(), ref.numpy())
    np.testing.assert_array_equal(attention(q, k, v, backend="ulysses").numpy(), ref.numpy())


@pytest.mark.parametrize("heads,backend", [(4, "ulysses"), (2, "ulysses"), (4, "ring"),
                                           (4, "flash"), (4, "auto")])
def test_attention_over_slab_tokens(heads, backend):
    """Inside 2 x 4 ranks that each hold a contiguous token range (a depth
    slab's tokens): Ulysses (4 heads over 4 ranks), its fallback (2 heads),
    the ring, and the gathered flash path against full attention, values
    and gradients."""
    q, k, v = qkv((2, 32, heads, 8), seed=heads)
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    sharding = batch_sharding(mesh, spatial=True)  # tokens are dim 1, as a volume's depth
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    placed = [sharding.place(t) for t in ts]
    outs = spmd.run_ranks(
        mesh, lambda r: attention(*(p.piece(r.data, r.context) for p in placed), backend=backend),
        spatial=True)
    got = torch.cat([torch.cat(row, dim=1) for row in outs], dim=0)
    ref_in = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = xla_attention(*ref_in)
    assert rel_mse(got.detach().numpy(), ref.detach().numpy()) < 1e-9
    got.square().sum().backward()
    ref.square().sum().backward()
    for a, b in zip(ts, ref_in):
        assert rel_mse(a.grad.numpy(), b.grad.numpy()) < 1e-9
