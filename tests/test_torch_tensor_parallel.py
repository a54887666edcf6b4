"""Tensor parallelism over a mesh of CPU ranks against the JAX package's
``shard_params_for_tp`` on the same 4 x 2 mesh of its 8 virtual CPU
devices.

* Placement: every leaf's TP dim is JAX's ``tp_spec_for`` (the trailing dim
  of JAX's layout) through the weight carrier, each context rank's piece of
  the parameters and the EMA holds bitwise JAX's addressable shard, and
  ``tp_sharding_summary`` counts as JAX's; with FSDP on top, each (data,
  context) piece is JAX's shard of ``shard_state_fsdp(shard_params_for_tp)``.
* ``column_forward``: a conv computed by output-channel blocks equals the
  whole conv, forward and backward.
* Steps: TP, TP + zero1 and TP + fsdp, two steps each from a JAX state
  carried over with JAX's draws, against the port's replicated steps and
  JAX's TP steps at JAX's bars (loss rtol 1e-5, grad norm rtol 1e-4,
  tests/parallel/test_parallel.py:114-170).
* The Trainer on the cut ``config_multichip.json`` with TP + zero1 (its
  MultiEmbeddings tables split too): a mid-epoch resume bitwise, its
  checkpoint read by a plain run and a plain one read by a TP run; TP under
  spatial sharding refused, naming item 13c.
"""
import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.parallel import active_mesh as jax_active_mesh
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel import shard_batch as jax_shard_batch
from rho_diffusion_tpu.parallel import shard_params_for_tp as jax_tp
from rho_diffusion_tpu.parallel import shard_state_fsdp as jax_fsdp
from rho_diffusion_tpu.parallel import tp_sharding_summary as jax_tp_summary
from rho_diffusion_tpu.parallel.tensor import tp_spec_for as jax_tp_spec_for
from rho_diffusion_tpu_torch.ops.convolution import ConvNd
from rho_diffusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    replicate_state,
    shard_batch,
    shard_opt_state_zero1,
    shard_state_fsdp,
)
from rho_diffusion_tpu_torch.parallel.tensor import (
    shard_params_for_tp,
    tp_dims,
    tp_sharding_summary,
)
from rho_diffusion_tpu_torch.training.sharded import ShardedOptimizer, column_forward, shadowed
from rho_diffusion_tpu_torch.training.trainer import Trainer
from rho_diffusion_tpu_torch.training.zero1 import jax_layout_axes
from test_torch_fsdp import (
    BATCH,
    assert_pieces_hold_jax_shards,
    assert_updates_close,
    jax_start,
    port_state_from,
    tiny_batch,
)
from test_torch_mesh_training import Volumes, cpu_mesh, multichip_config, step_draws
from test_torch_training import SignalAtStep

torch.set_num_threads(1)
MIN_DIM = 16


def test_tp_pieces_hold_jax_shards():
    """TP over the context axis of 4 x 2 (min_dim 16), then FSDP on top:
    each leaf's dims are JAX's, each rank's piece is JAX's shard, bitwise,
    and the summaries count alike."""
    jmesh = jax_make_mesh(data=4, context=2)
    _, js = jax_start()
    with jax_active_mesh(jmesh):
        jtp = jax_tp(js, jmesh, min_dim=MIN_DIM)
        jboth = jax_fsdp(jax_tp(js, jmesh, min_dim=MIN_DIM), jmesh)
    _, state = port_state_from(js)
    mesh = cpu_mesh()
    dims = tp_dims(state.model, mesh, MIN_DIM)
    modules = dict(state.model.named_modules())
    for name, p in state.model.named_parameters():
        module, attr = modules[name.rpartition(".")[0]], name.rpartition(".")[2]
        axes = jax_layout_axes(module, attr, p)
        spec = jax_tp_spec_for(tuple(p.shape[a] for a in axes), "context", 2, MIN_DIM)
        assert (dims[name] is not None) == any(s is not None for s in spec), name
    shard_params_for_tp(state, mesh, min_dim=MIN_DIM)
    assert isinstance(state.optimizer, ShardedOptimizer)
    assert {leaf.name: leaf.cdim for leaf in state.optimizer.leaves} == dims
    split = assert_pieces_hold_jax_shards(jtp.params, state, mesh, "params")
    assert_pieces_hold_jax_shards(jtp.ema_params, state, mesh, "ema")
    assert tp_sharding_summary(state) == jax_tp_summary(jtp.params) and split > 0
    shard_state_fsdp(state, mesh)
    assert any(leaf.pdim is not None for leaf in state.optimizer.leaves if leaf.cdim is not None)
    assert_pieces_hold_jax_shards(jboth.params, state, mesh, "params")
    assert_pieces_hold_jax_shards(jboth.ema_params, state, mesh, "ema")


def test_column_shards_conv_matches_the_whole_conv():
    """A 3x3x3 conv (the K5 route's plain version here) by two blocks of
    output channels, each from the whole input, against the whole conv:
    the output, the input's gradient (summed over the blocks) and each
    block's weight gradient."""
    gen = torch.Generator().manual_seed(0)
    conv = ConvNd(3, 8, 16, 3)
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    x = torch.randn((2, 4, 4, 4, 8), generator=gen, requires_grad=True)
    g = torch.randn((2, 4, 4, 4, 16), generator=gen)
    want = conv(x)
    want_dx, want_dw = torch.autograd.grad(want, (x, conv.weight), g)
    pieces = [conv.weight.detach()[i * 8:(i + 1) * 8].clone().requires_grad_() for i in (0, 1)]
    with shadowed(conv, {"forward": column_forward(conv, "weight", pieces, 0)}):
        got = conv(x)
        got_dx, *got_dw = torch.autograd.grad(got, (x, *pieces), g)
    assert "forward" not in conv.__dict__ and conv(x).shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(got_dw), want_dw, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_tp_steps():
    """JAX's TP state after two steps from ``jax_state``: the metrics and
    the draws of each step."""
    jmesh = jax_make_mesh(data=4, context=2)
    jpipe, js0 = jax_start()
    step = jpipe.make_train_step(donate=False)
    out = {"start": js0, "metrics": [], "draws": []}
    with jax_active_mesh(jmesh):
        js = jax_tp(js0, jmesh, min_dim=MIN_DIM)
        for i in (1, 2):
            b = tiny_batch(i)
            out["draws"].append(step_draws(js, b["data"].shape))
            js, m = step(js, jax_shard_batch(dict(b), jmesh))
            out["metrics"].append({k: float(v) for k, v in m.items()})
    return out


SETUPS = {
    "tp": lambda s, mesh: shard_params_for_tp(s, mesh, min_dim=MIN_DIM),
    "tp_zero1": lambda s, mesh: shard_opt_state_zero1(
        shard_params_for_tp(s, mesh, min_dim=MIN_DIM), mesh),
    "tp_fsdp": lambda s, mesh: shard_state_fsdp(
        shard_params_for_tp(s, mesh, min_dim=MIN_DIM), mesh),
}


@pytest.fixture(scope="module")
def replicated_steps(jax_tp_steps):
    return run_steps(jax_tp_steps, lambda s, mesh: replicate_state(s, mesh))


def run_steps(ref, setup):
    mesh = cpu_mesh()
    pipe, state = port_state_from(ref["start"])
    setup(state, mesh)
    metrics = [pipe.training_step(state, tiny_batch(i), **d)
               for i, d in zip((1, 2), ref["draws"])]
    return state, [{k: float(v) for k, v in m.items()} for m in metrics]


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_tp_steps_match_replicated_and_jax(setup, jax_tp_steps, replicated_steps):
    """Two steps of TP (alone, with ZeRO-1, with FSDP) against the port's
    replicated steps and JAX's TP steps, same weights and draws."""
    state, metrics = run_steps(jax_tp_steps, SETUPS[setup])
    rep, rep_metrics = replicated_steps
    opt = state.optimizer
    assert any(leaf.cdim is not None for leaf in opt.leaves)
    assert all(leaf.zero1 == (setup == "tp_zero1" and leaf.sdim is not None)
               for leaf in opt.leaves)
    for got, plain, want in zip(metrics, rep_metrics, jax_tp_steps["metrics"]):
        np.testing.assert_allclose(got["train_loss"], plain["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert_updates_close(state, rep)


def tp_config(**training):
    return multichip_config(tensor_parallel=True, tp_min_dim=MIN_DIM, spatial_sharding=False,
                            **training)


def test_tp_zero1_trainer_resumes_exactly_and_trades_checkpoints(tmp_path):
    """The Trainer with TP + zero1 on the 4 x 2 mesh: the epoch's 2 steps
    uninterrupted against 1, SIGTERM (mid-epoch) and a resumed run,
    bitwise; a plain one-rank Trainer reads its checkpoint, and a TP +
    zero1 Trainer reads a plain one."""
    def trainer(work, **kw):
        return Trainer(tp_config(max_epochs=1), dataset=Volumes(), work_dir=work, device="cpu",
                       mesh=cpu_mesh(), **kw)

    want = trainer(tmp_path / "a").fit()
    tables = [leaf for leaf in want.optimizer.leaves if "embedding_layers" in leaf.name]
    assert tables and all(leaf.cdim == 1 for leaf in tables)
    first = trainer(tmp_path / "b", loggers=["jsonl", SignalAtStep(1)])
    assert first.fit().step == 1
    again = trainer(tmp_path / "b")
    state = again.init_state()
    assert state.step == 1 and state.optimizer.zero1 and state.optimizer.tp_min_dim == MIN_DIM
    got = again.fit(state).state_dict()
    ref = want.state_dict()
    for part in ("params", "ema_params"):
        for name, v in ref[part].items():
            assert torch.equal(got[part][name], v), (part, name)
    plain = Trainer(multichip_config(zero1=False, spatial_sharding=False, mesh=None,
                                     max_epochs=1),
                    dataset=Volumes(), work_dir=tmp_path / "b", device="cpu")
    read = plain.init_state()
    assert read.step == 2
    for name, p in read.model.state_dict().items():
        assert torch.equal(p, got["params"][name]), name
    sharded = trainer(tmp_path / "b").init_state()
    for name, v in sharded.state_dict()["params"].items():
        assert torch.equal(v, read.model.state_dict()[name]), name


def test_tp_under_spatial_sharding_is_refused():
    """A TP state stepping on depth slabs raises, naming item 13c."""
    from test_torch_mesh_training import SCHEDULE, SMALL, batch

    from rho_diffusion_tpu_torch.diffusion import schedule
    from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM

    pipe = DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE), device="cpu",
                optimizer="AdamW", opt_kwargs={"lr": 1e-3})
    state = pipe.create_state(seed=0)
    mesh = cpu_mesh()
    shard_params_for_tp(state, mesh, min_dim=MIN_DIM)
    placed = shard_batch(batch(0), mesh, {"data": batch_sharding(mesh, spatial=True)})
    with pytest.raises(NotImplementedError, match="item 13c"):
        pipe.training_step(state, placed, t=torch.arange(BATCH))
