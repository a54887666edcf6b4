"""The port's training path against the JAX package's, on the CPU.

* two full ``train_step``s of a small 3-D UNet (fp32, sha512 condition
  embeddings, AdamW under a cosine LR schedule, EMA) against the JAX
  package's own jitted ``train_step``, from a JAX state carried over by
  ``interop.jax_weights.export_train_state`` after one JAX step (so the Adam
  moments are not zero), with the timesteps and noise reproduced from JAX's
  rng chain: loss, grad_norm, parameters, moments and EMA;
* one step with conditioning dropout and ``grad_accum=2`` the same way;
* the Trainer's checkpoint, preemption and exact mid-epoch resume (bitwise
  on the CPU), the training CLI end to end with a resume, the inference CLI
  reading the run's checkpoint back to its EMA weights, and the JAX
  package's ``load_torch_checkpoint`` reading the port's ``model.pth``.
"""
import json
import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu.interop.torch_weights import load_torch_checkpoint
from rho_diffusion_tpu.models.unet import UNet as JaxUNet
from rho_diffusion_tpu.training.optimizers import build_lr_schedule as jax_build_lr_schedule
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.interop.jax_weights import (
    arch_kwargs,
    export_train_state,
    export_unet_state_dict,
    load_train_state,
)
from rho_diffusion_tpu_torch.training.__main__ import main as train_main
from rho_diffusion_tpu_torch.training.checkpoint import save_model_weights
from rho_diffusion_tpu_torch.training.optimizers import build_lr_schedule
from rho_diffusion_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

SMALL = dict(
    dims=3, data_shape=[4, 8, 8], in_channels=1, out_channels=1, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
    num_classes=20, use_scale_shift_norm=True,
)
SCHEDULE = dict(num_steps=50, beta_1=1e-4, beta_T=2e-2)
LR, EPS = 1e-3, 1e-8
LR_SCHEDULE = ("CosineAnnealingLR", {"T_max": 2, "eta_min": 1e-4})


def make_pipelines(**kwargs):
    """The JAX and port DDPMs with AdamW at LR under a cosine schedule of
    two steps per epoch, and EMA 0.999."""
    name, lr_kw = LR_SCHEDULE
    common = dict(optimizer="AdamW", opt_kwargs={"lr": LR}, ema_decay=0.999, **kwargs)
    jpipe = JaxDDPM("UNetv2", SMALL, jax_schedule.LinearSchedule(**SCHEDULE),
                    learning_rate=jax_build_lr_schedule(name, LR, 2, lr_kw), **common)
    tpipe = DDPM("UNetv2", SMALL, schedule.LinearSchedule(**SCHEDULE), device="cpu",
                 learning_rate=build_lr_schedule(name, LR, 2, lr_kw), **common)
    return jpipe, tpipe


def jax_state(jpipe, seed=0):
    """A JAX state whose weights are the initial ones plus N(0, 0.05^2)
    (no zero-initialised layer, so every gradient is nonzero)."""
    params = jpipe.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    return jpipe.create_state(jax.random.PRNGKey(seed + 1), params=params)


def batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return {"data": rng.uniform(0, 1, size=(n, 4, 8, 8, 1)).astype(np.float32),
            "labels": rng.uniform(0, 2, size=(n, 128)).astype(np.float32)}


def draws(rng, shape, cond_dropout=0.0):
    """(cond_mask, t, noise) as DDPM.loss_and_metrics draws them from rng."""
    mask = None
    if cond_dropout > 0:
        rng, m_rng = jax.random.split(rng)
        mask = np.asarray(jax.random.bernoulli(m_rng, 1.0 - cond_dropout, (shape[0],)),
                          np.float32)
    t_rng, n_rng = jax.random.split(rng)
    t = np.asarray(jax.random.randint(t_rng, (shape[0],), 0, SCHEDULE["num_steps"]))
    return mask, t, np.asarray(jax.random.normal(n_rng, shape))


def step_draws(state, shape, accum=1, cond_dropout=0.0):
    """The draws of one JAX train_step from ``state.rng``, concatenated
    over its ``accum`` microbatches."""
    _, step_rng = jax.random.split(state.rng)
    rngs = [step_rng] if accum == 1 else list(jax.random.split(step_rng, accum))
    micro = (shape[0] // accum, *shape[1:])
    parts = [draws(r, micro, cond_dropout) for r in rngs]
    cat = [None if parts[0][i] is None else np.concatenate([p[i] for p in parts])
           for i in range(3)]
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in zip(("cond_mask", "t", "noise"), cat)}


def exported(jstate):
    return export_train_state(jax.device_get(jstate), SMALL)


def assert_params_close(got_sd, want, nu_hat, steps):
    """Parameters after AdamW steps. Each step moves an entry by about
    lr * m_hat / (sqrt(v_hat) + eps). Where sqrt(v_hat) < 1e3 * eps the
    gradient is at the rounding noise of the two frameworks (e.g. a conv
    bias right before a one-channel-per-group GroupNorm, whose exact
    gradient is zero), its sign is arbitrary, and the entry may land
    anywhere within the update's reach, 4 * lr per step. Every other entry
    must agree within 1e-3 * lr per step plus 1e-6 relative (the fp32
    rounding of the parameter itself). Fewer than 1% of the entries may be
    noise-bound."""
    n_noisy = n_all = 0
    for name, w in want.items():
        g = got_sd[name].numpy()
        noisy = np.sqrt(nu_hat[name]) < 1e3 * EPS
        bound = np.where(noisy, 4 * LR * steps, 1e-3 * LR * steps + 1e-6 * np.abs(w))
        assert (np.abs(g - w) <= bound).all(), (name, float(np.abs(g - w).max()))
        n_noisy += int(noisy.sum())
        n_all += noisy.size
    assert n_noisy < 0.01 * n_all


def assert_tree_close(got_sd, want, rtol, what):
    """Relative rms per leaf, plus 1e-5 of the rms over all leaves for the
    leaves whose exact gradient is zero and which carry only rounding noise
    (about 1e-6 of that rms)."""
    floor = 1e-5 * np.sqrt(np.mean(np.concatenate([w.ravel() for w in want.values()]) ** 2))
    for name, w in want.items():
        g = got_sd[name].numpy()
        err = np.sqrt(np.mean((g - w) ** 2))
        assert err <= rtol * np.sqrt(np.mean(w ** 2)) + floor, (what, name, float(err))


def adam_moments(state):
    names = {p: n for n, p in state.model.named_parameters()}
    out = {"exp_avg": {}, "exp_avg_sq": {}}
    for p, st in state.optimizer.state.items():
        for key in out:
            out[key][names[p]] = st[key].detach()
    return out


def nu_hat(ex):
    """Adam's bias-corrected second moment, by parameter name."""
    return {k: v.numpy() / (1 - 0.999 ** ex["count"]) for k, v in ex["exp_avg_sq"].items()}


def test_two_train_steps_match_jax():
    jpipe, tpipe = make_pipelines()
    step = jpipe.make_train_step(donate=False)
    js = jax_state(jpipe)
    js, _ = step(js, batch(0))  # one JAX step: nonzero moments, a nonzero count
    ts = tpipe.create_state(seed=0)
    load_train_state(ts, exported(js))
    assert ts.step == 1
    for i in (1, 2):
        b = batch(i)
        inject = step_draws(js, b["data"].shape)
        js, want = step(js, b)
        got = tpipe.training_step(ts, b, **inject)
        # fp32 on both sides: loss and gradient norm to 1e-5 relative
        np.testing.assert_allclose(float(got["train_loss"]), float(want["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    ex = exported(js)
    v_hat = nu_hat(ex)
    assert ts.step == ex["step"] == 3
    assert_params_close(ts.model.state_dict(), {k: v.numpy() for k, v in ex["params"].items()},
                        v_hat, steps=2)
    moments = adam_moments(ts)
    # the moments are (decayed) sums of the gradients and their squares:
    # 1e-4 relative rms, as the gradients themselves
    for key in ("exp_avg", "exp_avg_sq"):
        assert_tree_close(moments[key], {k: v.numpy() for k, v in ex[key].items()}, 1e-4, key)
    # EMA = 0.999-ish mix of the old EMA and the new parameters: the
    # parameters' bound, scaled by the weight the new parameters get
    assert_params_close(ts.ema, {k: v.numpy() for k, v in ex["ema_params"].items()},
                        v_hat, steps=2)


def test_cond_dropout_and_grad_accum_step_matches_jax():
    """One step with conditioning dropout 0.5 (the keep-masks JAX drew are
    injected) over two accumulated microbatches, from fresh moments."""
    jpipe, tpipe = make_pipelines(cond_dropout=0.5, grad_accum=2)
    js = jax_state(jpipe, seed=6)
    ts = tpipe.create_state(seed=0)
    load_train_state(ts, exported(js))
    b = batch(5)
    inject = step_draws(js, b["data"].shape, accum=2, cond_dropout=0.5)
    assert 0 < float(inject["cond_mask"].sum()) < 4  # both kinds of rows
    js, want = jpipe.make_train_step(donate=False)(js, b)
    got = tpipe.training_step(ts, b, **inject)
    np.testing.assert_allclose(float(got["train_loss"]), float(want["train_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    ex = exported(js)
    assert_params_close(ts.model.state_dict(), {k: v.numpy() for k, v in ex["params"].items()},
                        nu_hat(ex), steps=1)


class Fields:
    """A dataset whose items are a function of their index (so a resumed
    run sees the same samples), with sha512-width labels."""

    use_emb_as_labels = True
    parameter_space = None

    def __len__(self):
        return 8

    def __getitem__(self, i):
        rng = np.random.default_rng(int(i))
        return (rng.uniform(0, 1, size=(4, 8, 8, 1)).astype(np.float32),
                rng.uniform(0, 2, size=(128,)).astype(np.float32))


def small_config(**training):
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["model"]["kwargs"] = dict(SMALL, activation="SiLU")
    cfg["noise_schedule"]["kwargs"] = dict(SCHEDULE)
    cfg["training"].update(dict(batch_size=2, max_epochs=2, save_checkpoint_every_n_epochs=1,
                                log_every_n_steps=1, dtype="float32", loggers=["jsonl"]),
                           **training)
    return ExperimentConfig.from_dict(cfg)


class SignalAtStep:
    """A logger that sends this process SIGTERM once ``step`` is logged."""

    def __init__(self, step):
        self.step = step

    def log(self, record):
        if record.get("step") == self.step:
            os.kill(os.getpid(), signal.SIGTERM)

    def close(self):
        pass


def test_preemption_and_mid_epoch_resume_are_exact(tmp_path):
    """8 uninterrupted steps against 3 steps, SIGTERM (the state is
    checkpointed at step 3, mid-epoch), and a new Trainer resuming from
    that checkpoint: bitwise the same parameters, EMA and moments."""
    ref = Trainer(small_config(), dataset=Fields(), work_dir=tmp_path / "a", device="cpu")
    want = ref.fit()
    first = Trainer(small_config(), dataset=Fields(), work_dir=tmp_path / "b", device="cpu",
                    loggers=["jsonl", SignalAtStep(3)])
    stopped = first.fit()
    assert stopped.step == 3 and first.checkpoints.latest_step() == 3
    events = [json.loads(x) for x in (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert any(e.get("event") == "preempted" for e in events)
    again = Trainer(small_config(), dataset=Fields(), work_dir=tmp_path / "b", device="cpu")
    state = again.init_state()
    assert state.step == 3
    got = again.fit(state)
    assert got.step == want.step == 8
    for name, p in want.model.state_dict().items():
        assert torch.equal(p, got.model.state_dict()[name]), name
    for name, e in want.ema.items():
        assert torch.equal(e, got.ema[name]), name
    for key in ("exp_avg", "exp_avg_sq"):
        a, b = adam_moments(want)[key], adam_moments(got)[key]
        assert all(torch.equal(a[k], b[k]) for k in a), key
    assert again.checkpoints.all_steps() == [3, 4, 8]  # max_to_keep=3, 8 saved twice


def test_validation_split_is_evaluated(tmp_path):
    """A quarter of the samples held out: one validation record per epoch
    over the held-out rows only, with finite loss and PSNR."""
    trainer = Trainer(small_config(val_fraction=0.25, max_epochs=1), dataset=Fields(),
                      work_dir=tmp_path, device="cpu")
    assert len(trainer.loader.dataset) == 6 and len(trainer.val_ds) == 2
    state = trainer.fit()
    assert state.step == 3
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if r.get("event") == "validation"]
    assert len(val) == 1 and np.isfinite(val[0]["val_loss"]) and np.isfinite(val[0]["val_psnr"])


class SpaceFields(Fields):
    """Fields with a parameter space, so epoch-end sampling has conditions
    (sha512 embeddings of width 4 * model_channels)."""

    parameter_space = DiscreteParameterSpace(param_dict={"l": [0, 1], "m": [0]})


@pytest.mark.parametrize("sample_params", ["ema", "raw"])
def test_epoch_end_sampling_leaves_training_untouched(tmp_path, sample_params):
    """Sampling at an epoch's end (EMA weights swapped in, or the raw ones)
    writes its plot and changes nothing the training goes on with: the
    final weights equal those of a run without sampling, bitwise."""
    plain = Trainer(small_config(max_epochs=1), dataset=SpaceFields(),
                    work_dir=tmp_path / "plain", device="cpu").fit()
    cfg = small_config(max_epochs=1, sample_every_n_epochs=1)
    cfg.training.sample_params = sample_params
    sampled = Trainer(cfg, dataset=SpaceFields(), work_dir=tmp_path / "s", device="cpu").fit()
    assert (tmp_path / "s" / "output_0.png").exists()
    for name, p in plain.model.state_dict().items():
        assert torch.equal(p, sampled.model.state_dict()[name]), name
    assert any(not torch.equal(p, sampled.ema[k]) for k, p in sampled.model.named_parameters())


def test_non_finite_loss_raises(tmp_path):
    class NaNFields(Fields):
        def __getitem__(self, i):
            data, labels = super().__getitem__(i)
            return np.full_like(data, np.nan), labels

    with pytest.raises(RuntimeError, match="non-finite train_loss"):
        Trainer(small_config(), dataset=NaNFields(), work_dir=tmp_path, device="cpu").fit()


def test_training_cli_resumes_and_inference_reads_its_ema(tmp_path, capsys):
    """The CLI end to end on the CPU: 2 epochs, then one more epoch resumed
    from the work dir's checkpoint; the inference CLI then samples from
    that checkpoint's EMA weights, which equal the trainer's bitwise."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    # [l, m] labels through the config's MultiEmbeddings cond_fn (trained
    # here), at model_channels 32 to keep the run short
    cfg["model"]["kwargs"]["model_channels"] = 32
    cfg["dataset"]["kwargs"]["use_emb_as_labels"] = False
    cfg["training"]["loggers"] = ["jsonl"]
    cfg["inference"].update(cache_file=None, checkpoint=None)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    work = tmp_path / "run"
    first = train_main([str(path), "-d", "cpu", "--work-dir", str(work)])
    assert first.step == 4  # 16 samples / batch 8 x 2 epochs
    state = train_main([str(path), "-d", "cpu", "--work-dir", str(work), "-e", "1"])
    assert state.step == 6
    records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
    assert {"event": "resumed", "step": 4} in records
    steps = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    assert (work / "model.pth").exists()
    assert any(k.startswith("cond_fn.") for k in state.ema)

    config = ExperimentConfig.from_dict(cfg)
    pipe, _, messages = inference.build_inference_session(config, work_dir=work, device="cpu")
    assert messages == [f"loaded EMA weights from checkpoint step 6 in {work / 'checkpoints'}"]
    for name, p in pipe.backbone.named_parameters():
        assert torch.equal(p, state.ema[name]), name
    config.inference.use_ema = False
    pipe, _, _ = inference.build_inference_session(config, work_dir=work, device="cpu")
    for name, p in pipe.backbone.state_dict().items():
        assert torch.equal(p, state.model.state_dict()[name]), name
    capsys.readouterr()
    samples = inference.main([str(path), "-d", "cpu", "-n", "2", "--work-dir", str(work)])
    assert "loaded EMA weights from checkpoint step 6" in capsys.readouterr().out
    assert samples.shape == (2, 8, 8, 8, 1) and np.isfinite(samples).all()


def test_inference_names_an_orbax_directory(tmp_path):
    (tmp_path / "ckpt" / "10").mkdir(parents=True)
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    config = ExperimentConfig.from_dict(cfg)
    _, _, messages = inference.build_inference_session(
        config, checkpoint=tmp_path / "ckpt", work_dir=tmp_path, device="cpu")
    assert "orbax" in messages[-1] and "untrained" in messages[-1]


def test_jax_package_reads_the_ports_model_pth(tmp_path):
    """save_model_weights writes the reference layout: the JAX package's
    load_torch_checkpoint transplants it, and the JAX UNet's forward equals
    the port's (relative MSE < 1e-9, the bar of ROADMAP.md's parity
    ladder; fp32 on both sides)."""
    jpipe, tpipe = make_pipelines()
    ts = tpipe.create_state(seed=0)
    load_train_state(ts, exported(jax_state(jpipe)))
    tpipe.training_step(ts, batch(9))
    save_model_weights(ts.model, tmp_path / "model.pth")
    params = load_torch_checkpoint(tmp_path / "model.pth", **{
        k: v for k, v in arch_kwargs(SMALL).items() if k != "dims"})
    b = batch(10, n=2)
    t = np.array([3, 41])
    want = jax.jit(JaxUNet(**SMALL).apply)({"params": params}, b["data"], t, b["labels"])
    ts.model.eval()
    with torch.no_grad():
        got = ts.model(torch.from_numpy(b["data"]), torch.from_numpy(t),
                       torch.from_numpy(b["labels"])).numpy()
    want = np.asarray(want)
    assert np.mean((got - want) ** 2) / np.mean(want ** 2) < 1e-9
    sd = export_unet_state_dict(params, **arch_kwargs(SMALL))
    assert all(np.array_equal(sd[k], v.numpy()) for k, v in ts.model.state_dict().items())
