"""The port's evaluation layer on the CPU: the metrics against the JAX
package's, the evaluate and training CLIs on the learned-variance config, and
the learned-variance harness.

* ``sinkhorn_divergence`` (its defaults and the evaluate CLI's blur 0.05 /
  50 iterations, point clouds and 1-D samples) and ``WassersteinWrapper``
  against JAX's at rtol 1e-5; ``comb_metrics`` and ``peak_stats`` on the
  same arrays; the hypothesis strategies against JAX's spec resolution and
  by their draws.
* ``examples/config_learned_variance.json`` cut to CPU size (8^3, two levels,
  a 20-step schedule, 8 items at batch 4, fp32; width 64, as its sha512
  labels are 256 wide): ``training.main -d cpu -e 1`` trains it through the
  Trainer with validation, and ``python -m rho_diffusion_tpu_torch.evaluate
  -d cpu --bpd`` on its EMA checkpoint reports every key finite.
* ``LV_SMOKE=1 python -m rho_diffusion_tpu_torch.benchmarks.learned_variance
  -d cpu``: both twins trained, evaluated and sampled, its report in its
  work directory.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rho_diffusion_tpu import hypothesis_utils as jax_hyp
from rho_diffusion_tpu.metrics import geom as jax_geom
from rho_diffusion_tpu.metrics import spectral as jax_spectral
from rho_diffusion_tpu_torch import evaluate, hypothesis_utils
from rho_diffusion_tpu_torch.benchmarks import learned_variance
from rho_diffusion_tpu_torch.metrics import WassersteinWrapper, comb_metrics, peak_stats
from rho_diffusion_tpu_torch.metrics import sinkhorn_divergence
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.__main__ import main as train_main

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def clouds(n=8, m=6, d=16, seed=0, shift=0.7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(m, d)) + shift).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, {"blur": 0.05, "num_iters": 50}, {"blur": 0.5, "p": 2}],
                         ids=["default", "evaluate", "p2"])
def test_sinkhorn_divergence_matches_jax(kw):
    x, y = clouds()
    got = sinkhorn_divergence(torch.from_numpy(x), torch.from_numpy(y), **kw)
    want = jax_geom.sinkhorn_divergence(jnp.asarray(x), jnp.asarray(y), **kw)
    assert float(want) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # 1-D samples are clouds of scalars; a cloud against itself is 0
    np.testing.assert_allclose(sinkhorn_divergence(x[:, 0], y[:, 0], **kw).numpy(),
                               np.asarray(jax_geom.sinkhorn_divergence(x[:, 0], y[:, 0], **kw)),
                               rtol=1e-5)
    assert float(sinkhorn_divergence(x, x, **kw)) == 0.0


def test_wasserstein_wrapper_matches_jax_and_is_registered():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, size=(4, 8, 8, 8, 1)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    for kw in ({}, {"blur": 0.05, "num_iters": 50}):
        got = WassersteinWrapper(**kw)(torch.from_numpy(a), b)  # tensors and arrays
        want = jax_geom.WassersteinWrapper(**kw)(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert registry.get("layers", "WassersteinWrapper") is WassersteinWrapper
    with pytest.raises(AssertionError):
        WassersteinWrapper()(a, b[:2])


def spectra(n, seed, comb):
    rng = np.random.default_rng(seed)
    grid = np.arange(512)
    out = []
    for i in range(n):
        s = 0.01 * rng.normal(size=512)
        if comb or i % 2:
            spacing, start = rng.uniform(20, 40), rng.uniform(5, 20)
            for c in np.arange(start, 500, spacing):
                s += np.exp(-0.5 * ((grid - c) / 1.5) ** 2)
        out.append(s)
    return np.asarray(out, np.float32)


def test_comb_metrics_match_jax():
    gen, real = spectra(12, 2, comb=False), spectra(10, 3, comb=True)
    assert comb_metrics(gen, real) == jax_spectral.comb_metrics(gen, real)
    for s in (gen[0], gen[1], real[0], np.zeros(64, np.float32)):
        got, want = peak_stats(s), jax_spectral.peak_stats(s)
        assert got[0] == want[0] and (got[1] == want[1] or np.isnan(got[1]) and np.isnan(want[1]))


# ---------------------------------------------------------------------------
# Hypothesis strategies
# ---------------------------------------------------------------------------

def test_spec_resolution_matches_jax():
    """``from_range_value_or_choice`` asks the same strategy of ``draw`` as
    JAX's for every kind of spec."""
    def draw(strategy):
        return repr(strategy)

    default = st.sampled_from([np.float32, np.int32])
    for spec in (None, (1, 4), (0.5, 2.0), [3, 1, 2], {"b", "a"}, 7, np.float32):
        assert (hypothesis_utils.from_range_value_or_choice(draw, spec, default)
                == jax_hyp.from_range_value_or_choice(draw, spec, default))


@settings(max_examples=25, deadline=None)
@given(hypothesis_utils.torch_tensors(min_value=-3, max_value=3, max_dims=3, max_side=5))
def test_torch_tensors_draws(t):
    assert isinstance(t, torch.Tensor) and 1 <= t.ndim <= 3 and max(t.shape) <= 5
    assert t.dtype in (torch.float32, torch.int32)
    assert float(t.min()) >= -3 and float(t.max()) <= 3


@settings(max_examples=10, deadline=None)
@given(hypothesis_utils.torch_tensors(shape=(2, 3), dtype=[torch.bfloat16, np.int64],
                                      min_value=0, max_value=5),
       st.data())
def test_torch_tensors_fixed_shape_and_dtypes(t, data):
    assert tuple(t.shape) == (2, 3) and t.dtype in (torch.bfloat16, torch.int64)
    a = data.draw(jax_hyp.jnp_arrays(shape=(2, 3), dtype=np.int64, min_value=0, max_value=5))
    assert a.shape == tuple(t.shape)


# ---------------------------------------------------------------------------
# The CLIs on the learned-variance config
# ---------------------------------------------------------------------------

def lv_config(tmp_path) -> Path:
    cfg = json.loads((ROOT / "examples" / "config_learned_variance.json").read_text())
    cfg["model"]["kwargs"].update(data_shape=[8, 8, 8], num_res_blocks=1, channel_mult=[1, 2],
                                  attention_resolutions=[2], num_heads=2)
    cfg["dataset"]["kwargs"].update(grid_el=8, length=8)
    cfg["noise_schedule"]["kwargs"].update(num_steps=20, beta_1=2e-4, beta_T=1e-2)
    cfg["training"].update(dtype="float32", batch_size=4, val_fraction=0.5, loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None)
    path = tmp_path / "lv.json"
    path.write_text(json.dumps(cfg))
    return path


def test_training_and_evaluate_clis_on_learned_variance(tmp_path, capsys):
    path = lv_config(tmp_path)
    work = tmp_path / "run"
    state = train_main([str(path), "-d", "cpu", "-e", "1", "--work-dir", str(work)])
    assert state.step == 1  # 4 training items at batch 4, 4 held out
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "train_loss" in r]
    (val,) = [r for r in records if r.get("event") == "validation"]
    assert np.isfinite([steps[0]["train_loss"], val["val_loss"], val["val_psnr"]]).all()
    capsys.readouterr()
    report = evaluate.main([str(path), "-p", str(work / "checkpoints"), "-d", "cpu", "--bpd",
                            "--num-batches", "2", "--steps", "5"])
    out = capsys.readouterr().out
    assert "loaded EMA weights from checkpoint step 1" in out
    assert json.loads(out[out.index("{"):]) == report
    keys = ("val_loss", "val_psnr", "wasserstein_gen_vs_real", "total_bpd", "prior_bpd")
    assert all(np.isfinite(report[k]) for k in keys), report
    assert report["generated_finite"] and report["total_bpd"] > report["prior_bpd"] > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the refusal is not testable here")
        evaluate.main([str(path), "-p", str(work / "checkpoints")])


def test_learned_variance_harness_smoke(tmp_path, monkeypatch):
    monkeypatch.setenv("LV_SMOKE", "1")
    monkeypatch.setenv("LV_EPOCHS", "1")
    report = learned_variance.main(["-d", "cpu", "--work-dir", str(tmp_path)])
    assert json.loads((tmp_path / "learned_variance_bpd.json").read_text()) == report
    assert set(report["variants"]) == {"hybrid", "fixed"}
    for v in report["variants"].values():
        assert v["steps"] == 2 and v["ancestral_finite"]
        assert np.isfinite(v["ancestral_sinkhorn_vs_real"])
        cli = v["evaluate_cli"]
        assert all(np.isfinite(cli[k]) for k in ("val_loss", "total_bpd", "prior_bpd"))
