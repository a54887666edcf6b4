"""The port's context-parallel attention against the JAX package's, on the CPU.

Ring attention over CPU ranks: the "rdma" ring (K6's protocol with its
plain step) against JAX's Pallas remote-DMA ring run in interpret mode on
the virtual CPU mesh, exactly as tests/parallel/test_parallel.py:493-544
runs it, at those tests' shapes and tolerances (fp32 atol 2e-5, bf16 atol
3e-2); the "xla" ring against JAX's ppermute ring, a data=2 x context=4
mesh included, and its gradients against full attention's (atol 5e-5); the
attention dispatcher; the mesh; and the whole sampling slice of a cut-down
flagship under a context=4 mesh with impl="rdma" against JAX's (relative
MSE < 1e-9). Inputs are made with numpy and handed to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from rho_diffusion_tpu.ops.attention import xla_attention as jax_xla_attention
from rho_diffusion_tpu.parallel import active_mesh as jax_active_mesh
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel.context import (
    context_sharded_attention as jax_context_sharded_attention,
)
from rho_diffusion_tpu_torch.ops import attention as attn_mod
from rho_diffusion_tpu_torch.ops.attention import attention, set_attention_backend, xla_attention
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import ring_attn_step
from rho_diffusion_tpu_torch.parallel import (
    Mesh,
    active_mesh,
    context_sharded_attention,
    get_active_mesh,
    make_mesh,
)

torch.set_num_threads(1)


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def cpu_mesh(data, context):
    return make_mesh(data=data, context=context, devices=["cpu"] * (data * context))


# ---------------------------------------------------------------------------
# K6 ("rdma") and the xla ring against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,n,dtype,atol", [
    ((2, 64, 2, 16), 8, "float32", 2e-5),   # test_ring_attention_rdma_parity
    ((2, 16, 2, 8), 2, "float32", 2e-5),    # test_ring_attention_rdma_two_ring_edge
    ((2, 32, 2, 8), 4, "bfloat16", 3e-2),   # test_ring_attention_rdma_bf16
], ids=["n8", "n2-edge", "n4-bf16"])
def test_rdma_ring_matches_jax(shape, n, dtype, atol):
    q, k, v = qkv(shape, seed=n)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("context",))
    jdt = jnp.dtype(dtype)
    want = jax_context_sharded_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                         jmesh, impl="rdma")
    tdt = getattr(torch, dtype)
    launch_counts.clear()
    got = context_sharded_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                    cpu_mesh(1, n), impl="rdma")
    assert sum(launch_counts.values()) == 0  # the plain step is no launch
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
    full = jax_xla_attention(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(full), atol=atol)


@pytest.mark.parametrize("shape,data,context", [
    ((2, 64, 2, 16), 1, 8),   # test_ring_attention_matches_full_attention
    ((4, 32, 2, 8), 2, 4),    # test_ring_attention_context4_data2
    ((3, 32, 2, 8), 2, 4),    # a batch that does not split over the data axis
], ids=["context8", "data2-context4", "data2-odd-batch"])
def test_xla_ring_matches_jax(shape, data, context):
    q, k, v = qkv(shape, seed=10 + context)
    want = jax_context_sharded_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         jax_make_mesh(data=data, context=context), impl="xla")
    got = context_sharded_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    cpu_mesh(data, context), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    got_rdma = context_sharded_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                         cpu_mesh(data, context), impl="rdma")
    np.testing.assert_allclose(got_rdma.numpy(), np.asarray(want), atol=2e-5)


def test_xla_ring_bf16_matches_jax():
    """The double-sqrt scaling in bf16 and the fp32 merge, as in JAX."""
    q, k, v = qkv((2, 32, 2, 8), seed=5)
    want = jax_context_sharded_attention(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                                         jax_make_mesh(data=2, context=4), impl="xla")
    got = context_sharded_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                    cpu_mesh(2, 4), impl="xla")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_xla_ring_gradients_match_full_attention():
    """test_ring_attention_grads_flow: d(sum o^2)/d(q, k, v) through the
    ring equals full attention's, and JAX's ring's."""
    q, k, v = qkv((1, 64, 2, 8), seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ring = torch.autograd.grad(
        context_sharded_attention(*leaves, cpu_mesh(1, 8), impl="xla").square().sum(), leaves)
    full = torch.autograd.grad(xla_attention(*leaves).square().sum(), leaves)
    jmesh = jax_make_mesh(data=1, context=8)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_context_sharded_attention(*a, jmesh) ** 2),
                      argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for got, want, jax_want in zip(ring, full, jgrads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), atol=5e-5)


def test_rdma_ring_step_protocol_matches_one_block():
    """The plain K6 step folds slots in any number: folding the whole K/V in
    one step (first and last) is full attention with K6's fp32 1/sqrt(d)."""
    q, k, v = (torch.from_numpy(x) for x in qkv((2, 24, 3, 16), seed=7))
    bh = 2 * 3
    m, l, acc = torch.empty(bh, 24), torch.empty(bh, 24), torch.empty(bh, 24, 16)
    o = torch.empty(2, 24, 3, 16)
    to_bh = lambda x: x.permute(0, 2, 1, 3).reshape(bh, 24, 16).contiguous()  # noqa: E731
    ring_attn_step(q, to_bh(k), to_bh(v), m, l, acc, o, 1.4426950408889634 / 4.0, True, True)
    np.testing.assert_allclose(o.numpy(), xla_attention(q, k, v).numpy(), atol=2e-6)


# ---------------------------------------------------------------------------
# Dispatch, flags and the mesh
# ---------------------------------------------------------------------------

def test_auto_dispatch_picks_ring_under_a_context_mesh(monkeypatch):
    q = torch.randn(2, 16, 2, 8)
    calls = []
    real = attn_mod.context_sharded_attention
    monkeypatch.setattr(attn_mod, "context_sharded_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a: calls.append("flash") or xla_attention(*a))
    attention(q, q, q)
    assert calls == ["flash"]  # no mesh: the flash kernel's route
    with active_mesh(cpu_mesh(1, 4)):
        assert get_active_mesh().shape == {"data": 1, "context": 4}
        out = attention(q, q, q)
        assert calls[-1] == {"plain": False}
        np.testing.assert_allclose(out.numpy(), xla_attention(q, q, q).numpy(), atol=2e-6)
        calls.clear()
        attention(torch.randn(2, 10, 2, 8), *(2 * [torch.randn(2, 10, 2, 8)]))
        assert calls == ["flash"]  # 10 tokens do not split over 4 ranks
        set_attention_backend("xla")
        try:
            attention(q, q, q)
            assert calls[-1] == {"plain": True}  # the plain ring
        finally:
            set_attention_backend("auto")
    with active_mesh(cpu_mesh(4, 1)):
        calls.clear()
        attention(q, q, q)
        assert calls == ["flash"]  # context axis 1: no ring
    assert get_active_mesh() is None


def test_ring_backend_without_a_mesh_is_full_attention():
    q, k, v = (torch.from_numpy(x) for x in qkv((1, 12, 2, 8), seed=3))
    np.testing.assert_array_equal(attention(q, k, v, backend="ring").numpy(),
                                  xla_attention(q, k, v).numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention(q, k, v, backend="ulysses")


def test_impl_flag_validation(monkeypatch):
    q = torch.zeros(4, 8, 1, 4)
    with pytest.raises(ValueError, match="impl"):
        context_sharded_attention(q, q, q, cpu_mesh(2, 2), impl="nope")
    monkeypatch.setenv("RHO_RING_ATTN_IMPL", "nope")
    with active_mesh(cpu_mesh(1, 2)), pytest.raises(ValueError, match="impl"):
        attention(q, q, q)


def test_k6_refuses_autograd():
    """K6 has no backward (as in JAX): the rdma ring under grad mode with an
    input that requires grad raises instead of cutting the graph."""
    q = torch.randn(1, 8, 1, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="grad mode"):
        context_sharded_attention(q, q, q, cpu_mesh(1, 2), impl="rdma")
    with torch.no_grad():
        context_sharded_attention(q, q, q, cpu_mesh(1, 2), impl="rdma")


def test_make_mesh_shapes_and_errors():
    mesh = cpu_mesh(2, 4)
    assert mesh.axis_names == ("data", "context")
    assert mesh.shape == {"data": 2, "context": 4} and mesh.context_group(1) == [mesh.devices[1][0]] * 4
    assert make_mesh(context=2, devices=["cpu"] * 8).shape == {"data": 4, "context": 2}
    assert make_mesh(context=3, devices=["cpu"] * 3).context_group(0) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_mesh(data=3, context=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(context=3, devices=["cpu"] * 8)
    assert Mesh([["cpu:0", "cpu"]]).devices == [[torch.device("cpu")] * 2]
    with pytest.raises(ValueError):
        Mesh([["cpu"], ["cpu", "cpu"]])


# ---------------------------------------------------------------------------
# The sampling slice under a context mesh
# ---------------------------------------------------------------------------

def test_reverse_process_under_context_mesh_matches_jax(monkeypatch):
    """A cut-down flagship (attention over 64 tokens) sampled under an
    active context=4 mesh with impl="rdma" on both sides, from a shared x_T
    with noise_factor=0: every attention call runs the ring (K6's plain step
    here, JAX's interpret-mode kernel there)."""
    from test_torch_ddpm import SPACE, pipelines

    monkeypatch.setenv("RHO_RING_ATTN_IMPL", "rdma")
    jpipe, params, tpipe = pipelines()
    cond = tpipe.conditions_from_parameter_space(
        SPACE, 2, random=False, as_hash_embeddings=True,
        embedding_dim=tpipe.condition_embedding_dim())
    x_T = np.random.default_rng(1).normal(size=(2, 4, 8, 8, 1)).astype(np.float32)
    shape = x_T.shape
    jmesh = JaxMesh(np.array(jax.devices()[:4]), ("context",))
    with jax_active_mesh(jmesh):
        want = jax.jit(lambda p, c, x: jpipe.reverse_process(
            p, jax.random.PRNGKey(0), shape, c, t_checkpoints=[0, 1, 2], x_T=x))(
            params, jnp.asarray(cond.numpy()), jnp.asarray(x_T))
    rings = []
    real = attn_mod.context_sharded_attention
    monkeypatch.setattr(attn_mod, "context_sharded_attention",
                        lambda q, *a, **kw: rings.append(q.shape) or real(q, *a, **kw))
    with active_mesh(cpu_mesh(1, 4)):
        got = tpipe.reverse_process(shape, cond, t_checkpoints=[0, 1, 2],
                                    x_T=torch.from_numpy(x_T))
    assert rings and all(s[1] == 64 for s in rings)  # 4 attention blocks x 7 forwards
    w = np.asarray(want["denoised"])
    assert np.abs(w - x_T).max() > 1e-2, "the model must move the sample"
    for g, ww in ((got["denoised"].numpy(), w),
                  (got["buffer"].numpy(), np.asarray(want["buffer"]))):
        assert np.mean((g - ww) ** 2) / np.mean(ww ** 2) < 1e-9
        np.testing.assert_allclose(g, ww, atol=1e-4)
