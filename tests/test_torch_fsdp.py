"""FSDP (ZeRO-3) over a mesh of CPU ranks against the JAX package's
``shard_state_fsdp`` on the same 4 x 2 mesh of its 8 virtual CPU devices.

* Placement: every parameter's and EMA leaf's FSDP dim is JAX's (its
  ``fsdp_shardings``/``_shard_dim`` in JAX's layout, through the weight
  carrier), and each rank's piece holds bitwise the elements of JAX's
  addressable shard on the device at the same mesh position.
* Steps: two FSDP steps from a JAX state carried over, with JAX's draws,
  against the port's replicated steps and JAX's FSDP steps at JAX's bar
  (loss and grad norm rtol 2e-5, tests/parallel/test_parallel.py:283-334),
  the parameters, moments and EMA after them against the replicated run's.
* The sharded init equals ``create_state`` bitwise, the model holds
  placeholders, and each rank holds 1/N of the split leaves (parameters,
  moments, EMA) at rest, rank 0 the whole ones too.
* The Trainer on the cut ``config_multichip.json`` with ``fsdp``: a
  mid-epoch resume bitwise equal to the run without a break, checkpoints
  read by plain runs and plain checkpoints by FSDP runs, and the config's
  spatial sharding under FSDP against the same run without it.

The tiny 2-D UNet keeps JAX's compile of its FSDP step to seconds; JAX's
starting state is made once a process (``jax_start``) and shared with the
TP and two-process tests.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu.interop.torch_weights import export_unet_state_dict as jax_export
from rho_diffusion_tpu.parallel import active_mesh as jax_active_mesh
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel import replicate_state as jax_replicate_state
from rho_diffusion_tpu.parallel import shard_batch as jax_shard_batch
from rho_diffusion_tpu.parallel import shard_state_fsdp as jax_fsdp
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.interop.jax_weights import (
    arch_kwargs,
    export_train_state,
    load_train_state,
)
from rho_diffusion_tpu_torch.parallel.mesh import (
    create_state_fsdp,
    fsdp_shardings,
    make_mesh,
    replicate_state,
    shard_state_fsdp,
)
from rho_diffusion_tpu_torch.training.sharded import ShardedOptimizer, cut
from rho_diffusion_tpu_torch.training.trainer import Trainer
from test_torch_mesh_training import (
    Volumes,
    assert_params_close,
    cpu_mesh,
    multichip_config,
    step_draws,
)
from test_torch_training import SignalAtStep, adam_moments

torch.set_num_threads(1)
TINY = dict(dims=2, data_shape=[8, 8], in_channels=1, out_channels=1, model_channels=16,
            num_res_blocks=1, channel_mult=[1], attention_resolutions=[1], num_heads=2,
            num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=50, beta_1=1e-4, beta_T=2e-2)
COMMON = dict(optimizer="AdamW", opt_kwargs={"lr": 1e-3}, ema_decay=0.999, world_size=8)
LR = 1e-3 * math.sqrt(8)
BATCH = 8


def tiny_batch(seed):
    rng = np.random.default_rng(seed)
    return {"data": rng.uniform(-1, 1, size=(BATCH, 8, 8, 1)).astype(np.float32),
            "labels": rng.uniform(0, 2, size=(BATCH, 64)).astype(np.float32)}


def jax_pipe():
    return JaxDDPM("UNetv2", TINY, jax_schedule.LinearSchedule(**SCHEDULE), **COMMON)


def port_pipe(**kw):
    return DDPM("UNetv2", TINY, schedule.LinearSchedule(**SCHEDULE), device="cpu", **COMMON, **kw)


def jax_state(jpipe):
    """JAX's state with its initial weights plus N(0, 0.05^2) (no layer at
    zero), on the host. The init is jitted: one compile instead of the
    flax init's op-by-op dispatch, the same values."""
    params = jax.jit(jpipe.init_params)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    return jpipe.create_state(jax.random.PRNGKey(1), params=params)


@functools.lru_cache(maxsize=None)
def jax_start():
    """JAX's pipeline and its ``jax_state``, made once a process (JAX's
    arrays are immutable, so every test may start from them)."""
    jpipe = jax_pipe()
    return jpipe, jax_state(jpipe)


def port_state_from(js, **kw):
    pipe = port_pipe(**kw)
    state = pipe.create_state(seed=0)
    load_train_state(state, export_train_state(jax.device_get(js), TINY))
    return pipe, state


def assert_pieces_hold_jax_shards(jtree, state, mesh, kind):
    """Each port rank's piece of every leaf of ``kind`` ("params" or "ema")
    holds bitwise the elements JAX's addressable shard on the device at the
    same (data, context) position holds: JAX's element ids, carried through
    the weight carrier, give each port element its JAX place."""
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    offsets = np.cumsum([0] + [leaf.size for leaf in leaves])
    ids = [np.arange(o, o + leaf.size).reshape(leaf.shape) for o, leaf in zip(offsets, leaves)]
    exported = jax_export(jax.tree_util.tree_unflatten(treedef, ids), **arch_kwargs(TINY))
    values = np.concatenate([np.asarray(leaf).ravel() for leaf in leaves])
    jmesh_pos = {}
    for (d, c), dev in np.ndenumerate(leaves[0].sharding.mesh.devices):
        jmesh_pos[dev] = (d, c)
    opt = state.optimizer
    n, m = mesh.shape["data"], mesh.shape["context"]
    split = 0
    for leaf in opt.leaves:
        arr = np.asarray(exported[leaf.name])
        k = int(np.searchsorted(offsets, int(arr.min()), side="right")) - 1
        grid = leaf.pieces if kind == "params" else state.ema.grid[leaf.name]
        ddim = leaf.pdim if kind == "params" else leaf.sdim
        for shard in leaves[k].addressable_shards:
            d, c = jmesh_pos[shard.device]
            key = (d if ddim is not None else 0, c if leaf.cdim is not None else 0)
            splits = ((ddim, key[0], n), (leaf.cdim, key[1], m))
            got_ids = cut(torch.from_numpy(arr), splits).numpy()
            assert set(got_ids.ravel().tolist()) == set(ids[k][shard.index].ravel().tolist()), (
                leaf.name, (d, c))
            np.testing.assert_array_equal(grid[key].detach().numpy(), values[got_ids])
        split += leaf.split
    return split


def test_fsdp_pieces_hold_jax_shards():
    """FSDP over data 4 x context 2: each leaf's dim is JAX's, each rank's
    piece of the parameters and of the EMA is JAX's shard, bitwise."""
    jmesh = jax_make_mesh(data=4, context=2)
    _, js = jax_start()
    with jax_active_mesh(jmesh):
        jsharded = jax_fsdp(jax_replicate_state(js, jmesh), jmesh)
    _, state = port_state_from(js)
    mesh = cpu_mesh()
    dims = fsdp_shardings(state, mesh)
    shard_state_fsdp(state, mesh)
    assert isinstance(state.optimizer, ShardedOptimizer)
    assert {leaf.name: leaf.pdim for leaf in state.optimizer.leaves} == dims
    split = assert_pieces_hold_jax_shards(jsharded.params, state, mesh, "params")
    assert_pieces_hold_jax_shards(jsharded.ema_params, state, mesh, "ema")
    assert split > len(state.optimizer.leaves) // 2
    assert all(p.numel() == 0 for leaf, p in zip(state.optimizer.leaves,
                                                  state.model.parameters()) if leaf.split)


@pytest.fixture(scope="module")
def jax_fsdp_steps():
    """JAX's FSDP state after two steps from ``jax_state``, the metrics and
    the draws of each step."""
    jmesh = jax_make_mesh(data=4, context=2)
    jpipe, js0 = jax_start()
    step = jpipe.make_train_step(donate=False)
    out = {"start": js0, "metrics": [], "draws": []}
    with jax_active_mesh(jmesh):
        js = jax_fsdp(jax_replicate_state(js0, jmesh), jmesh)
        for i in (1, 2):
            b = tiny_batch(i)
            out["draws"].append(step_draws(js, b["data"].shape))
            js, m = step(js, jax_shard_batch(dict(b), jmesh))
            out["metrics"].append({k: float(v) for k, v in m.items()})
    out["end"] = jax.device_get(js)
    return out


def port_steps(js0, draws, setup):
    pipe, state = port_state_from(js0)
    setup(state)
    metrics = [pipe.training_step(state, tiny_batch(i), **d) for i, d in zip((1, 2), draws)]
    return state, [{k: float(v) for k, v in m.items()} for m in metrics]


def test_fsdp_steps_match_replicated_and_jax(jax_fsdp_steps):
    """Two FSDP steps against the port's replicated ones and JAX's FSDP
    ones, same weights and draws."""
    ref = jax_fsdp_steps
    mesh = cpu_mesh()
    rep, rep_m = port_steps(ref["start"], ref["draws"], lambda s: replicate_state(s, mesh))
    fsdp, fsdp_m = port_steps(ref["start"], ref["draws"], lambda s: shard_state_fsdp(s, mesh))
    for got, plain, want in zip(fsdp_m, rep_m, ref["metrics"]):
        np.testing.assert_allclose(got["train_loss"], plain["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-5)
    assert_updates_close(fsdp, rep)


def assert_updates_close(state, rep):
    """The parameters and the EMA after the two steps against the port's
    replicated run's at tests/test_torch_mesh_training.py's bound (1e-3 of a
    step a step, or anywhere within 4 lr a step where the gradient is
    rounding noise, which Adam scales up to a full step: a conv bias before
    a GroupNorm), the moments in relative L2 over the whole model to 1e-5:
    the sharded step reorders sums only. (Against JAX the loss of the second
    step, which reads the first step's update, is held at JAX's bar.)"""
    assert state.step == rep.step == 2
    got, plain = state.state_dict(), rep.state_dict()
    moments = {key: adam_moments(s) for key, s in (("got", state), ("plain", rep))}
    v_hat = {k: v.numpy() / (1 - 0.999 ** 2) for k, v in moments["plain"]["exp_avg_sq"].items()}
    for part in ("params", "ema_params"):
        assert_params_close(got[part], {k: v.numpy() for k, v in plain[part].items()}, v_hat,
                            steps=2, lr=LR)
    for key in ("exp_avg", "exp_avg_sq"):
        a, b = moments["got"][key], moments["plain"][key]
        flat_a = torch.cat([a[k].ravel() for k in sorted(b)])
        flat_b = torch.cat([b[k].ravel() for k in sorted(b)])
        assert float((flat_a - flat_b).norm() / flat_b.norm()) < 1e-5, key


def test_fsdp_sharded_init_and_bytes_at_rest():
    """``create_state_fsdp`` from a pipeline whose backbone stays on the
    host: bitwise ``create_state``'s values, placeholders in the model, and
    each data rank's bytes at rest 1/4 of the split leaves' parameters,
    moments (after a step) and EMA, rank 0 the whole leaves' too."""
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    pipe = port_pipe(backbone_device="cpu")
    state = create_state_fsdp(pipe.create_state, 0, mesh)
    want = port_pipe().create_state(seed=0)
    got = state.state_dict()
    for name, p in want.model.named_parameters():
        assert torch.equal(got["params"][name], p.detach()), name
        assert torch.equal(got["ema_params"][name], want.ema[name]), name
    pipe.training_step(state, tiny_batch(1), t=torch.arange(BATCH) * 5,
                       noise=torch.from_numpy(np.random.default_rng(1).normal(
                           size=(BATCH, 8, 8, 1)).astype(np.float32)))
    opt = state.optimizer
    split = sum(4 * math.prod(leaf.shape) for leaf in opt.leaves if leaf.split)
    whole = sum(4 * math.prod(leaf.shape) for leaf in opt.leaves if not leaf.split)
    # parameters, Adam's two moments and the EMA: 4 copies of each element,
    # and each optimizer's step counters (one 4-byte scalar a shard)
    counters = {key: 4 * sum(1 for leaf in opt.leaves if key in leaf.shards)
                for key in opt.bytes_at_rest()}
    at_rest = opt.bytes_at_rest()
    for (d, c), n_bytes in at_rest.items():
        assert n_bytes - counters[(d, c)] == 4 * split // 4 + (4 * whole if d == 0 else 0)
    assert all(p.numel() == 0 for leaf, p in zip(opt.leaves, state.model.parameters())
               if leaf.split)


def fsdp_config(**training):
    return multichip_config(zero1=False, fsdp=True, **training)


def test_fsdp_trainer_resumes_exactly_and_trades_checkpoints_with_plain_runs(tmp_path):
    """The Trainer with ``fsdp`` on the 4 x 2 mesh (no spatial sharding):
    the epoch's 2 steps uninterrupted against 1, SIGTERM (mid-epoch, the
    slices gathered into the checkpoint) and a resumed run: bitwise. A
    plain one-rank Trainer reads the FSDP checkpoint, and an FSDP Trainer
    reads a plain one, bitwise."""
    def trainer(work, **kw):
        return Trainer(fsdp_config(spatial_sharding=False, max_epochs=1), dataset=Volumes(),
                       work_dir=work, device="cpu", mesh=cpu_mesh(), **kw)

    want = trainer(tmp_path / "a").fit()
    first = trainer(tmp_path / "b", loggers=["jsonl", SignalAtStep(1)])
    assert first.fit().step == 1
    again = trainer(tmp_path / "b")
    state = again.init_state()
    assert state.step == 1 and isinstance(state.optimizer, ShardedOptimizer)
    got = again.fit(state).state_dict()
    ref = want.state_dict()
    for part in ("params", "ema_params"):
        for name, v in ref[part].items():
            assert torch.equal(got[part][name], v), (part, name)
    assert all(torch.equal(v, got["opt_state"]["state"][i][k])
               for i, st in ref["opt_state"]["state"].items() for k, v in st.items())
    plain = Trainer(multichip_config(zero1=False, spatial_sharding=False, mesh=None,
                                     max_epochs=1),
                    dataset=Volumes(), work_dir=tmp_path / "b", device="cpu")
    read = plain.init_state()
    assert read.step == 2 and type(read.optimizer).__name__ == "AdamW"
    for name, p in read.model.state_dict().items():
        assert torch.equal(p, got["params"][name]), name
    sharded = trainer(tmp_path / "b").init_state()
    for name, v in sharded.state_dict()["params"].items():
        assert torch.equal(v, read.model.state_dict()[name]), name


def test_fsdp_under_spatial_sharding_trains_as_without_it(tmp_path):
    """The config's own options with ``fsdp`` for ``zero1``: spatial
    sharding and FSDP together, 2 steps against the same run without
    spatial sharding at JAX's FSDP bar (the slab convs and GroupNorm's
    exchanged sums reorder rounding only)."""
    runs = {}
    for spatial in (True, False):
        cfg = fsdp_config(spatial_sharding=spatial, max_epochs=1)
        trainer = Trainer(cfg, dataset=Volumes(), work_dir=tmp_path / str(spatial),
                          device="cpu", mesh=cpu_mesh())
        trainer.fit()
        runs[spatial] = [r["train_loss"] for r in map(
            __import__("json").loads,
            (tmp_path / str(spatial) / "metrics.jsonl").read_text().splitlines())
            if "train_loss" in r]
    assert len(runs[True]) == 2
    np.testing.assert_allclose(runs[True], runs[False], rtol=2e-5)
