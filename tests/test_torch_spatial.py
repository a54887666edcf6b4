"""Spatial (depth) sharding of the port against the JAX package's, on CPU
ranks.

The port's ranks are ``["cpu"] * n`` (one process drives them,
``parallel.spmd``); JAX runs its ``shard_map`` over the 8 virtual CPU
devices tests/conftest.py makes. Inputs come from numpy seeds.

* ``halo_exchange`` and ``spatial_sharded_conv3d`` at context 2 and 4 (data
  4 and 2), values and gradients, against JAX's, rel MSE < 1e-9;
* GroupNorm32 on depth slabs against the whole volume;
* every conv route of the UNet on a slab (the K5 route, the input conv's
  direct route, the (1, 2, 2)-strided Downsample, a 1x1 conv) against the
  whole volume, with the hook showing each 3x3x3 conv saw D/n + 2 planes;
* int8 on a slab raises;
* the rank threads (``parallel.spmd``) under stress: more threads than
  cores, a microsecond switch interval, one rank at a time, an error
  stopping the group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel.spatial import halo_exchange as jax_halo_exchange
from rho_diffusion_tpu.parallel.spatial import spatial_sharded_conv3d as jax_spatial_conv
from rho_diffusion_tpu_torch.ops import quant
from rho_diffusion_tpu_torch.ops.convolution import ConvNd, Conv1x1, record_conv_inputs
from rho_diffusion_tpu_torch.ops.norm import GroupNorm32
from rho_diffusion_tpu_torch.parallel import spmd
from rho_diffusion_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from rho_diffusion_tpu_torch.parallel.spatial import halo_exchange, spatial_sharded_conv3d

torch.set_num_threads(1)
LAYOUTS = [(4, 2), (2, 4)]  # (data, context)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def volume(seed, shape=(4, 8, 4, 4, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("data,context", LAYOUTS)
def test_halo_exchange_matches_jax(data, context):
    """Every slab with its neighbours' planes (zeros at the global edges),
    bitwise JAX's ppermute halos; the gradient of a weighted sum of the
    haloed slabs sends each plane's gradient back to its rank."""
    from jax.sharding import PartitionSpec as P

    x = volume(0)
    w = np.random.default_rng(1).normal(size=(4, 8 + 2 * context, 4, 4, 8)).astype(np.float32)
    jmesh = jax_make_mesh(data=data, context=context)
    spec = P("data", "context")
    jfn = jax.shard_map(jax_halo_exchange, mesh=jmesh, in_specs=spec, out_specs=spec)
    want = np.asarray(jfn(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x)))

    dl = 8 // context
    xt = torch.from_numpy(x).requires_grad_()
    slabs = [xt[:, r * dl:(r + 1) * dl] for r in range(context)]
    got = torch.cat(halo_exchange(slabs), dim=1)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("data,context", LAYOUTS)
def test_spatial_sharded_conv3d_matches_jax(data, context):
    """The haloed slab through the port's SAME conv (``ConvNd``'s route, the
    one the UNet takes), cropped, against JAX's VALID-in-depth shard_map
    conv: values, and the gradients of the squared sum in x and the kernel,
    rel MSE < 1e-9; every rank's conv saw its slab's D/context + 2 planes."""
    x = volume(2)
    k = (np.random.default_rng(3).normal(size=(3, 3, 3, 8, 8)) * 0.2).astype(np.float32)
    jmesh = jax_make_mesh(data=data, context=context)
    want = np.asarray(jax_spatial_conv(jnp.asarray(x), jnp.asarray(k), jmesh))
    gx, gk = jax.grad(lambda a, b: jnp.sum(jax_spatial_conv(a, b, jmesh) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))

    mesh = make_mesh(data, context, devices=["cpu"] * (data * context))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.transpose(k, (4, 3, 0, 1, 2)).copy()).requires_grad_()
    with record_conv_inputs() as shapes:
        got = spatial_sharded_conv3d(xt, wt, mesh)
    assert len(shapes) == data * context and {s[1] for s in shapes} == {8 // context + 2}
    assert rel_mse(got.detach().numpy(), want) < 1e-9
    (got ** 2).sum().backward()
    assert rel_mse(xt.grad.numpy(), np.asarray(gx)) < 1e-9
    assert rel_mse(wt.grad.numpy(), np.transpose(np.asarray(gk), (4, 3, 0, 1, 2))) < 1e-9


def run_on_slabs(mesh, fn, *arrays):
    """``fn`` of each rank's depth slabs of ``arrays`` under
    ``run_ranks(spatial=True)``, the results gathered back to whole volumes."""
    sharding = batch_sharding(mesh, spatial=True)
    placed = [sharding.place(torch.as_tensor(a)) for a in arrays]
    outs = spmd.run_ranks(mesh, lambda r: fn(*(p.piece(r.data, r.context) for p in placed)),
                          spatial=True)
    return torch.cat([torch.cat(row, dim=1) for row in outs], dim=0)


@pytest.mark.parametrize("data,context", LAYOUTS)
def test_groupnorm_over_slabs_matches_the_whole_volume(data, context):
    """GroupNorm32 on depth slabs sums each slab's statistics over the
    context ranks: the whole volume's normalisation, and its gradients."""
    torch.manual_seed(0)
    norm = GroupNorm32(16)
    with torch.no_grad():
        norm.weight.normal_()
        norm.bias.normal_()
    x = volume(4, (4, 8, 4, 4, 16)) * 3 + 1
    mesh = make_mesh(data, context, devices=["cpu"] * (data * context))
    xt = torch.from_numpy(x).requires_grad_()
    got = run_on_slabs(mesh, norm, xt)
    want = norm(torch.from_numpy(x))
    assert rel_mse(got.detach().numpy(), want.detach().numpy()) < 1e-12
    g = torch.from_numpy(volume(5, (4, 8, 4, 4, 16)))
    (got * g).sum().backward()
    xw = torch.from_numpy(x).requires_grad_()
    (norm(xw) * g).sum().backward()
    assert rel_mse(xt.grad.numpy(), xw.grad.numpy()) < 1e-9


@pytest.mark.parametrize("conv", ["k5", "input", "downsample", "skip_1x1"])
def test_every_conv_route_on_a_slab(conv):
    """Each conv the UNet runs, on 2 x 2 ranks' slabs against the whole
    volume: the stride-1 3x3x3 conv (K5's route), the Cin-1 input conv (the
    direct route), the (1, 2, 2)-strided Downsample (``F.conv3d``) and a 1x1
    conv (no halo). Every 3x3x3 conv saw D/context + 2 planes, no whole
    volume."""
    torch.manual_seed(1)
    cin = 1 if conv == "input" else 8
    layer = {"k5": ConvNd(3, 8, 8, 3), "input": ConvNd(3, 1, 8, 3),
             "downsample": ConvNd(3, 8, 8, 3, stride=(1, 2, 2)),
             "skip_1x1": Conv1x1(8, 4, 3)}[conv]
    x = volume(6, (4, 8, 4, 4, cin))
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    xt = torch.from_numpy(x).requires_grad_()
    with record_conv_inputs() as shapes:
        got = run_on_slabs(mesh, layer, xt)
    want = layer(torch.from_numpy(x))
    assert rel_mse(got.detach().numpy(), want.detach().numpy()) < 1e-12
    if conv == "skip_1x1":
        assert shapes == []
    else:
        assert shapes and {s[1] for s in shapes} == {8 // 2 + 2}
    got.square().sum().backward()
    xw = torch.from_numpy(x).requires_grad_()
    layer(xw).square().sum().backward()
    assert rel_mse(xt.grad.numpy(), xw.grad.numpy()) < 1e-9


def test_int8_on_a_slab_raises():
    layer = ConvNd(3, 8, 8, 3)
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    quant.set_conv_quant("int8")
    try:
        with pytest.raises(NotImplementedError, match="spatial sharding"):
            run_on_slabs(mesh, layer, volume(7, (1, 8, 4, 4, 8)))
    finally:
        quant.set_conv_quant("off")


def test_rank_threads_take_turns_under_stress():
    """16 context ranks (more threads than the CPU has cores) over two data
    ranks, a switch interval of a microsecond, 200 exchanges each: every
    exchange sees every rank's value of that round and the ranks run one at
    a time (a shared counter bumped without a lock never loses an update);
    a rank that fails stops its group, whose error is raised."""
    import sys
    import threading

    n, rounds = 16, 200
    mesh = make_mesh(2, n, devices=["cpu"] * (2 * n))
    state = {"count": 0}

    def body(rank):
        total = 0
        for i in range(rounds):
            state["count"] += 1  # a read-modify-write: only one rank runs at a time
            total += spmd.exchange(rank.context * 1000 + i,
                                   lambda vals: [sum(vals)] * len(vals))
        return total

    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: out.update(r=spmd.run_ranks(mesh, body, True)))
        runner.start()
        runner.join(timeout=120)
        assert not runner.is_alive()
    finally:
        sys.setswitchinterval(interval)
    want = sum(sum(c * 1000 + i for c in range(n)) for i in range(rounds))
    assert out["r"] == [[want] * n, [want] * n]
    assert state["count"] == 2 * n * rounds

    def failing(rank):
        spmd.exchange(0, lambda vals: vals)
        if rank.context == 3:
            raise KeyError("rank 3")
        return spmd.exchange(0, lambda vals: vals)

    with pytest.raises(KeyError, match="rank 3"):
        spmd.run_ranks(make_mesh(1, 5, devices=["cpu"] * 5), failing, True)
