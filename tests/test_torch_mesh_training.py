"""Training over a mesh: the port's sharded step against the JAX package's
GSPMD step on the same mesh, ZeRO-1, the Trainer on a cut
``config_multichip.json`` and the data-sharded device cache, on CPU ranks.

The port's mesh is ``make_mesh(4, 2, devices=["cpu"] * 8)``, JAX's the
same 4 x 2 over its 8 virtual CPU devices (tests/conftest.py):

* JAX's ``_shard_dim`` choice against the port's through the weight
  layout map: each data rank's ZeRO-1 slice of every leaf holds the very
  elements JAX's rank holds;
* one and two train steps with ``spatial_sharding`` and ``zero1`` (the
  learning rate scaled by sqrt(8) on both sides) from a JAX state carried
  over after one JAX step, with JAX's draws injected: loss and grad norm at
  JAX's own bar (rtol 2e-5, tests/parallel/test_parallel.py:211, :453),
  parameters, moments and EMA with ``assert_tree_close``; every 3x3x3 conv
  saw D/2 + 2 planes;
* ZeRO-1 with OptaxLAMB (its trust ratio needs each leaf's norm over all
  of its shards) against the unsharded port;
* the Trainer on ``config_multichip.json`` cut to 8^3, width 16: exact
  mid-epoch resume under the mesh (bitwise), JAX's refusals;
* the data-sharded device cache's batches bitwise those of the whole one.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu.interop.torch_weights import export_unet_state_dict as jax_export
from rho_diffusion_tpu.parallel import active_mesh as jax_active_mesh
from rho_diffusion_tpu.parallel import batch_sharding as jax_batch_sharding
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel import replicate_state as jax_replicate_state
from rho_diffusion_tpu.parallel import shard_opt_state_zero1 as jax_zero1
from rho_diffusion_tpu.parallel.mesh import _shard_dim as jax_shard_dim
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.device_cache import DeviceDatasetCache
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.interop.jax_weights import (
    arch_kwargs,
    export_train_state,
    load_train_state,
)
from rho_diffusion_tpu_torch.ops.convolution import record_conv_inputs
from rho_diffusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate_state,
    shard_batch,
    shard_opt_state_zero1,
)
from rho_diffusion_tpu_torch.training.trainer import Trainer
from rho_diffusion_tpu_torch.training.zero1 import zero1_dims
from test_torch_training import EPS, SignalAtStep, adam_moments, assert_tree_close, nu_hat

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=1, model_channels=16,
             num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
             num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=50, beta_1=1e-4, beta_T=2e-2)
LR = 1e-3
BATCH = 8


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"data": rng.uniform(-1, 1, size=(BATCH, 8, 8, 8, 1)).astype(np.float32),
            "labels": rng.uniform(0, 2, size=(BATCH, 64)).astype(np.float32)}


def assert_params_close(got_sd, want, v_hat, steps, lr):
    """tests/test_torch_training.py's bound on parameters after AdamW steps,
    at the learning rate ``lr``: 1e-3 of a step per step plus 1e-6
    relative, except where sqrt(nu_hat) < 1e3 eps (a gradient at the
    frameworks' rounding noise, e.g. a conv bias right before a GroupNorm,
    whose exact gradient is zero, whose entries may land anywhere within
    4 lr a step); fewer than 1% of the entries may be noise-bound."""
    n_noisy = n_all = 0
    for name, w in want.items():
        g = got_sd[name].detach().numpy()
        noisy = np.sqrt(v_hat[name]) < 1e3 * EPS
        bound = np.where(noisy, 4 * lr * steps, 1e-3 * lr * steps + 1e-6 * np.abs(w))
        assert (np.abs(g - w) <= bound).all(), (name, float(np.abs(g - w).max()))
        n_noisy += int(noisy.sum())
        n_all += noisy.size
    assert n_noisy < 0.01 * n_all


def step_draws(jstate, shape):
    """The timesteps and noise of one JAX train_step from ``jstate.rng``."""
    _, step_rng = jax.random.split(jstate.rng)
    t_rng, n_rng = jax.random.split(step_rng)
    t = np.asarray(jax.random.randint(t_rng, (shape[0],), 0, SCHEDULE["num_steps"]))
    return {"t": torch.from_numpy(t.copy()),
            "noise": torch.from_numpy(np.array(jax.random.normal(n_rng, shape)))}


def test_zero1_slices_hold_jax_elements():
    """For every parameter of the UNet, JAX's ``_shard_dim`` over 4 data
    ranks in JAX's layout, mapped through the weight carrier: each port
    rank's slice holds the elements JAX's rank holds. A JAX tree whose
    leaves number their elements (globally unique ids) goes through
    ``export_unet_state_dict``, which carries each id to where the port
    keeps it."""
    jpipe = JaxDDPM("UNetv2", SMALL, jax_schedule.LinearSchedule(**SCHEDULE))
    params = jax.device_get(jpipe.init_params(jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    offsets = np.cumsum([0] + [leaf.size for leaf in leaves])
    ids = [np.arange(o, o + leaf.size).reshape(leaf.shape) for o, leaf in zip(offsets, leaves)]
    exported = jax_export(jax.tree_util.tree_unflatten(treedef, ids), **arch_kwargs(SMALL))

    def rank_sets(arr, dim):
        return None if dim is None else [
            set(np.split(np.asarray(arr), 4, axis=dim)[d].ravel().tolist()) for d in range(4)]

    named = dict(DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE),
                      device="cpu").backbone.named_parameters())
    dims = zero1_dims_of(named)
    split = 0
    for name, arr in exported.items():
        assert arr.shape == tuple(named[name].shape), name
        k = int(np.searchsorted(offsets, int(np.asarray(arr).min()), side="right")) - 1
        want = rank_sets(ids[k], jax_shard_dim(ids[k].shape, 4))
        assert rank_sets(arr, dims[name]) == want, (name, dims[name])
        split += want is not None
    assert set(exported) == set(named) and split > len(named) // 2


def zero1_dims_of(named):
    model = DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE), device="cpu").backbone
    return zero1_dims(model, make_mesh(4, 1, devices=["cpu"] * 4))


def jax_state_after_one_step(jpipe, jmesh):
    """JAX's state under the mesh (ZeRO-1), its weights the initial ones
    plus N(0, 0.05^2), after one JAX step (nonzero moments)."""
    params = jpipe.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    with jax_active_mesh(jmesh):
        state = jax_zero1(jax_replicate_state(
            jpipe.create_state(jax.random.PRNGKey(1), params=params), jmesh), jmesh)
        step = jpipe.make_train_step(donate=False)
        state, _ = step(state, jax_batch(batch(0), jmesh))
    return state, step


def jax_batch(b, jmesh):
    return {"data": jax.device_put(b["data"], jax_batch_sharding(jmesh, spatial=True)),
            "labels": jax.device_put(b["labels"], jax_batch_sharding(jmesh))}


def test_spatial_zero1_steps_match_jax():
    """Two steps of a 4 x 2 ``spatial_sharding`` + ``zero1`` mesh against
    JAX's on the same mesh, weights and draws."""
    jmesh = jax_make_mesh(data=4, context=2)
    common = dict(optimizer="AdamW", opt_kwargs={"lr": LR}, ema_decay=0.999, world_size=8)
    jpipe = JaxDDPM("UNetv2", SMALL, jax_schedule.LinearSchedule(**SCHEDULE), **common)
    tpipe = DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE), device="cpu", **common)
    assert tpipe.optimizer.lr(0) == pytest.approx(LR * math.sqrt(8))
    js, step = jax_state_after_one_step(jpipe, jmesh)
    ts = tpipe.create_state(seed=0)
    load_train_state(ts, export_train_state(jax.device_get(js), SMALL))
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    shard_opt_state_zero1(replicate_state(ts, mesh), mesh)
    # each data rank keeps 1/4 of every leaf that splits
    zero = ts.optimizer
    split = [leaf for leaf in zero.leaves if leaf.zero1]
    assert split
    for leaf in split:
        sh = leaf.shards[(0, 0)]
        assert sh.numel() * 4 == math.prod(leaf.shape)
        assert zero.opts[(0, 0)].state[sh]["exp_avg"].numel() * 4 == math.prod(leaf.shape)
    per_key = {"data": batch_sharding(mesh, spatial=True)}
    for i in (1, 2):
        b = batch(i)
        inject = step_draws(js, b["data"].shape)
        with jax_active_mesh(jmesh):
            js, want = step(js, jax_batch(b, jmesh))
        with record_conv_inputs() as shapes:
            got = tpipe.training_step(ts, shard_batch(b, mesh, per_key), **inject)
        assert shapes and {s[1] for s in shapes} == {8 // 2 + 2}
        np.testing.assert_allclose(float(got["train_loss"]), float(want["train_loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=2e-5)
        np.testing.assert_allclose(float(got["psnr"]), float(want["psnr"]), rtol=1e-5)
    ex = export_train_state(jax.device_get(js), SMALL)
    assert ts.step == ex["step"] == 3
    v_hat = nu_hat(ex)
    assert_params_close(ts.model.state_dict(), {k: v.numpy() for k, v in ex["params"].items()},
                        v_hat, steps=2, lr=LR * math.sqrt(8))
    moments = adam_moments(ts)
    for key in ("exp_avg", "exp_avg_sq"):
        assert_tree_close(moments[key], {k: v.numpy() for k, v in ex[key].items()}, 1e-4, key)
    assert_params_close({k: ts.ema[k] for k in ts.ema},
                        {k: v.numpy() for k, v in ex["ema_params"].items()}, v_hat, steps=2,
                        lr=LR * math.sqrt(8))


def test_zero1_lamb_matches_the_unsharded_port():
    """LAMB's trust ratio reads each leaf's norms: under ZeRO-1 over 4 data
    ranks they are summed over the leaf's slices. Two steps against the
    same port state on the same mesh without ZeRO-1 (so the first step's
    gradients are the same sums, and only the optimizer's split differs).
    The norms' summation order moves an update by ~1e-7 of itself, which
    in the second step moves the gradients that sit at the rounding noise
    (sqrt(nu_hat) < 1e3 eps: a conv bias right before a GroupNorm, whose
    exact gradient is zero) anywhere within the update's reach, as in
    tests/test_torch_training.py; every other entry is held to 1e-3 of the
    lr a step (per-slice norms would be off by the slice's share of the
    leaf, O(1) of the update), and fewer than 1% may be noise-bound."""
    def pipe():
        return DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE), device="cpu",
                    optimizer="LAMB", opt_kwargs={"lr": 1e-2, "weight_decay": 0.01},
                    ema_decay=0.99)

    plain, sharded = pipe(), pipe()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # no zero-initialised layer, so every gradient is nonzero
        for p, q in zip(plain.backbone.parameters(), sharded.backbone.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
            q.copy_(p)
    a, b = plain.create_state(seed=0), sharded.create_state(seed=0)
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    replicate_state(a, mesh)
    shard_opt_state_zero1(replicate_state(b, mesh), mesh)
    for i in (1, 2):
        data = batch(i)
        inject = {"t": torch.arange(BATCH) * 5,
                  "noise": torch.from_numpy(np.random.default_rng(i).normal(
                      size=data["data"].shape).astype(np.float32))}
        ma = plain.training_step(a, data, **inject)
        mb = sharded.training_step(b, data, **inject)
        np.testing.assert_allclose(float(mb["train_loss"]), float(ma["train_loss"]), rtol=1e-6)
    lr, n_noisy, n_all = 1e-2, 0, 0
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        noisy = (torch.sqrt(a.optimizer.state[p]["nu"] / (1 - 0.999 ** 2)) < 1e3 * 1e-8).numpy()
        bound = np.where(noisy, 4 * lr * 2, 1e-3 * lr * 2 + 1e-6 * np.abs(p.detach().numpy()))
        diff = np.abs(q.detach().numpy() - p.detach().numpy())
        assert (diff <= bound).all(), (name, float(diff.max()))
        ema = np.abs(b.ema[name].numpy() - a.ema[name].numpy())
        assert (ema <= bound).all(), (name, float(ema.max()))
        n_noisy += int(noisy.sum())
        n_all += noisy.size
    assert n_noisy < 0.01 * n_all
    # the checkpoint payload is the unsharded optimizer's, and loads back
    sd = b.optimizer.state_dict()
    assert set(sd["state"]) == set(a.optimizer.state_dict()["state"])
    b.optimizer.load_state_dict(a.optimizer.state_dict())
    a_params = dict(a.model.named_parameters())
    for leaf in b.optimizer.leaves:
        if not leaf.zero1:
            continue
        want = a.optimizer.state[a_params[leaf.name]]["mu"]
        size = want.shape[leaf.sdim] // 4
        assert torch.equal(b.optimizer.opts[(1, 0)].state[leaf.shards[(1, 0)]]["mu"],
                           want.narrow(leaf.sdim, size, size))


class Volumes:
    """A dataset whose items are a function of their index (a resumed run
    sees the same samples) with the config's parameter space."""

    def __init__(self):
        from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace

        self.parameter_space = DiscreteParameterSpace({"l": [0, 1, 2], "m": [-1, 0, 1]})

    def __len__(self):
        return 16

    def __getitem__(self, i):
        rng = np.random.default_rng(int(i))
        return (rng.uniform(-1, 1, size=(8, 8, 8, 1)).astype(np.float32),
                np.asarray([i % 3, i % 3 - 1], np.float32))


def multichip_config(**training) -> ExperimentConfig:
    """``examples/config_multichip.json`` cut to 8^3, width 16, one res block
    a level, two levels, fp32; its mesh options as they are."""
    cfg = json.loads((ROOT / "examples" / "config_multichip.json").read_text())
    cfg["model"]["kwargs"].update(data_shape=[8, 8, 8], model_channels=16, num_res_blocks=1,
                                  channel_mult=[1, 2], attention_resolutions=[2], num_heads=2)
    cfg["noise_schedule"]["kwargs"] = dict(SCHEDULE)
    cfg["training"].update(dict(batch_size=8, max_epochs=2, save_checkpoint_every_n_epochs=1,
                                log_every_n_steps=1, dtype="float32", loggers=["jsonl"]),
                           **training)
    return ExperimentConfig.from_dict(cfg)


def cpu_mesh():
    return make_mesh(4, 2, devices=["cpu"] * 8)


def test_trainer_on_multichip_config_resumes_exactly(tmp_path):
    """4 uninterrupted steps under the 4 x 2 mesh (zero1, spatial) against 3
    steps, SIGTERM (checkpointed mid-epoch, ZeRO-1's slices gathered) and a
    new Trainer resuming (split again): bitwise the same parameters, EMA and
    moments."""
    ref = Trainer(multichip_config(), dataset=Volumes(), work_dir=tmp_path / "a", device="cpu",
                  mesh=cpu_mesh())
    assert ref.world_size == 8 and ref.on_mesh
    assert ref.pipeline.optimizer.lr(0) == pytest.approx(1e-4 * math.sqrt(8))
    want = ref.fit()
    assert want.step == 4
    first = Trainer(multichip_config(), dataset=Volumes(), work_dir=tmp_path / "b", device="cpu",
                    mesh=cpu_mesh(), loggers=["jsonl", SignalAtStep(3)])
    assert first.fit().step == 3
    again = Trainer(multichip_config(), dataset=Volumes(), work_dir=tmp_path / "b", device="cpu",
                    mesh=cpu_mesh())
    state = again.init_state()
    assert state.step == 3 and state.optimizer.zero1 and not state.optimizer.fsdp
    got = again.fit(state)
    assert got.step == 4
    for name, p in want.model.state_dict().items():
        assert torch.equal(p, got.model.state_dict()[name]), name
    for name in want.ema:
        assert torch.equal(want.ema[name], got.ema[name]), name
    for key in ("exp_avg", "exp_avg_sq"):
        a, b = adam_moments(want)[key], adam_moments(got)[key]
        assert all(torch.equal(a[k], b[k]) for k in a), key


def test_trainer_mesh_rules(tmp_path):
    """JAX's rules: a batch that does not divide by the data axis raises
    ValueError; fsdp with zero1 raises ValueError; fsdp, and tensor_parallel
    without spatial sharding, build a Trainer; tensor_parallel with spatial
    sharding raises NotImplementedError naming item 13c; the config's 4 x 2
    mesh without a mesh on a host of one device raises as JAX's make_mesh
    does."""
    with pytest.raises(ValueError, match="not divisible by the 4-rank data axis"):
        Trainer(multichip_config(batch_size=6), dataset=Volumes(), work_dir=tmp_path,
                device="cpu", mesh=cpu_mesh())
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(multichip_config(fsdp=True), dataset=Volumes(), work_dir=tmp_path, device="cpu",
                mesh=cpu_mesh())
    for option in ({"fsdp": True, "zero1": False},
                   {"tensor_parallel": True, "spatial_sharding": False}):
        trainer = Trainer(multichip_config(**option), dataset=Volumes(), work_dir=tmp_path,
                          device="cpu", mesh=cpu_mesh())
        assert trainer.on_mesh and trainer.world_size == 8
    with pytest.raises(NotImplementedError, match="item 13c"):
        Trainer(multichip_config(tensor_parallel=True), dataset=Volumes(), work_dir=tmp_path,
                device="cpu", mesh=cpu_mesh())
    with pytest.raises(ValueError, match="mesh 4x2 != 1 available devices"):
        Trainer(multichip_config(), dataset=Volumes(), work_dir=tmp_path, device="cpu")


class Rows:
    """Items that are a function of their index, labels included."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return (np.full((4, 2, 2, 1), float(i), np.float32) + np.arange(16, dtype=np.float32)
                .reshape(4, 2, 2, 1), np.asarray([i, -i], np.float32))


@pytest.mark.parametrize("data,context", [(2, 1), (4, 2)])
def test_sharded_device_cache_is_bitwise_the_whole_cache(data, context):
    """The table's rows 1/N over the data ranks (11 rows: a ragged last
    shard), every batch of two epochs (the wrap-padded last batch among
    them) gathered from the ranks that hold its rows: bitwise the whole
    table's batches, each rank's piece on its rank."""
    loader = DataLoader(Rows(), batch_size=4, shuffle=True, seed=3, drop_last=False)
    whole = DeviceDatasetCache(Rows(), collate_fn=loader.collate_fn, device="cpu", num_workers=0)
    mesh = make_mesh(data, context, devices=["cpu"] * (data * context))
    sharded = DeviceDatasetCache(Rows(), collate_fn=loader.collate_fn, num_workers=0, mesh=mesh,
                                 shard_over_data=True,
                                 per_key={"data": batch_sharding(mesh, spatial=True)})
    assert sharded.rows_per_rank == -(-11 // data)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for a, b in zip(whole.batches(loader), sharded.batches(loader)):
            assert b["data"].piece(0, 0).shape == (4 // data, 4 // context, 2, 2, 1)
            for k in ("data", "labels"):
                assert torch.equal(b[k].full(), a[k]), k
            np.testing.assert_array_equal(b.get("valid"), a.get("valid"))
