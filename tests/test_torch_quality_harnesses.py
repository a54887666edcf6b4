"""The port's 3-D Y_lm quality harnesses (``rho_diffusion_tpu_torch/benchmarks/``:
``_ylm`` and the eight entries) against the JAX package's scripts and
modules, on the CPU.

* Per harness, read from the JAX script's source with ``ast`` (the scripts
  run at import, so they are never imported): its report keys (the dict it
  dumps and the keys it adds after) equal the harness's ``REPORT_KEYS``, and
  the harness's report carries them, plus only ``device``,
  ``train_steps_per_s`` and the harness's own named extras; its env knobs'
  defaults equal the harness's settings with no knob set; its row lists
  (``sampler_quality``'s four, keyed by SQ_ROWS), sampler and seed tuples,
  arms, conditioners, held-out pairs and guidance scales equal the
  harness's; its backbone kwargs (evaluated at the script's GRID, bf16
  read as "bfloat16") equal the harness's.
* ``_ylm``'s physical pairs, sha512 condition rows and exact fields equal
  the JAX package's (its ``SphericalHarmonicDataset`` grid,
  ``compute_spherical_harmonic`` and ``calculate_sha512_embedding``)
  bitwise; the scorer's Sinkhorn divergence equals JAX's
  ``WassersteinWrapper`` within 1e-5 relative (both fp32 log-domain
  iterations, summed in another order) and its MSE numpy's.
* The slice as a whole: a JAX parameter tree of the harnesses' UNet at the
  smoke widths (``_ylm.SMOKE_CUT``: 4^3, one level, attention over 64
  tokens of head dim 64, fp32), initialised from seed 777 and perturbed
  (so the zero-initialised output convs act), carried into the port by
  ``export_unet_state_dict`` and through ``_ylm.sampling_pipeline``; x_T
  and every step's noise injected into both frameworks
  (``test_torch_gaussian_sampling.Injected``); ``sampler_quality``'s dpm++,
  ddim, ddpm and int8 ddim rows against JAX's ``reverse_process`` on the
  same draws over the 20-step smoke schedule. The float rows are held at
  relative MSE < 1e-9 and 1e-4 absolute (the sampling tests' bar; measured
  1.2e-13 to 3.8e-13, at most 1.3e-6 apart); the int8 row at relative MSE
  < 1e-3 (tests/test_torch_quant.py's sampling bar: a rounding flip of one
  int8 activation cascades; measured 3.6e-4), and it must move away from
  the float sample.
* Every harness runs its ``<PREFIX>_SMOKE=1`` cut on the CPU, every
  sampler capped at 4 steps (``YLM_MAX_STEPS``), and writes
  ``<work-dir>/<its JAX file name>`` equal to what ``main`` returns, with
  finite samples; no harness keeps its own copy of the shared pieces.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.data.synthetic import SphericalHarmonicDataset as JaxYlmDataset
from rho_diffusion_tpu.data.synthetic import compute_spherical_harmonic as jax_ylm
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.metrics.geom import WassersteinWrapper as JaxWasserstein
from rho_diffusion_tpu.ops.quant import conv_quant as jax_conv_quant
from rho_diffusion_tpu.utils import calculate_sha512_embedding as jax_sha512
from rho_diffusion_tpu_torch.benchmarks import (
    _ylm,
    demo64,
    demo_cfg,
    demo_distill,
    demo_min_snr,
    ema_ablation,
    sampler_quality,
    sh_holdout,
    vit_ab,
)
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.ops.quant import conv_quant
from test_torch_gaussian_sampling import Injected, jit_backbone

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

# harness -> (its knob prefix for the smoke cut, the report file it writes
# under the smoke cut, and its settings() key per JAX env knob)
HARNESSES = {
    "sampler_quality": (sampler_quality, "QUAL", "sampler_quality.json",
                        {"QUAL_GRID": "grid", "QUAL_BATCH": "batch", "QUAL_STEPS": "steps"}),
    "ema_ablation": (ema_ablation, "EMA", "ema_ablation.json",
                     {"EMA_GRID": "grid", "EMA_BATCH": "batch", "EMA_STEPS": "steps"}),
    "demo_min_snr": (demo_min_snr, "DEMO", "demo_min_snr_metrics.json",
                     {"DEMO_GRID": "grid", "DEMO_BATCH": "batch", "DEMO_STEPS": "steps",
                      "DEMO_GAMMA": "gamma", "DEMO_SAMPLER": "sampler",
                      "DEMO_NUM_STEPS": "num_steps"}),
    "demo_cfg": (demo_cfg, "DEMO", "demo_cfg_metrics.json",
                 {"DEMO_GRID": "grid", "DEMO_BATCH": "batch", "DEMO_STEPS": "steps",
                  "DEMO_DROPOUT": "dropout", "DEMO_SCALES": "scales"}),
    "sh_holdout": (sh_holdout, "SH", "sh_holdout_metrics.json",
                   {"SH_GRID": "grid", "SH_BATCH": "batch", "SH_STEPS": "steps"}),
    "demo_distill": (demo_distill, "DEMO", "demo_distill_4_metrics.json",
                     {"DEMO_GRID": "grid", "DEMO_BATCH": "batch", "DEMO_STEPS": "steps",
                      "DEMO_FROM": "from", "DEMO_TO": "to", "DEMO_UPDATES": "updates",
                      "DEMO_DISTILL_LR": "lr", "DEMO_SERVE": "serve"}),
    "vit_ab": (vit_ab, "VIT_AB", "vit_ab.json",
               {"VIT_AB_GRID": "grid", "VIT_AB_BATCH": "batch", "VIT_AB_WALL": "wall"}),
    "demo64": (demo64, "DEMO", "demo64_metrics.json",
               {"DEMO_GRID": "grid", "DEMO_BATCH": "batch", "DEMO_STEPS": "steps"}),
}
# what each port report adds beside the JAX keys
PORT_EXTRAS = {"device", "train_steps_per_s"}
OWN_EXTRAS = {"demo_cfg": {"ddim_steps"}, "sh_holdout": {"ddim_steps"},
              "demo64": {"sample_steps", "use_checkpoint", "plots", "train_peak_bytes",
                         "peak_bytes"}}
KNOB_PREFIXES = ("QUAL_", "SQ_", "EMA_", "DEMO_", "SH_", "VIT_AB_", "YLM_")


def jax_tree(name: str) -> ast.Module:
    return ast.parse((ROOT / "benchmarks" / f"{name}.py").read_text())


def jax_report_keys(name: str) -> tuple:
    """The keys of the dict the JAX script dumps (a dict literal, or a name
    assigned one), then the keys it assigns into that name afterwards."""
    tree = jax_tree(name)
    dumped = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute) and n.func.attr == "dump"]
    assert len(dumped) == 1, name
    target = dumped[0]
    if isinstance(target, ast.Dict):
        return tuple(k.value for k in target.keys)
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                getattr(t, "id", None) == target.id for t in node.targets):
            keys += [k.value for k in node.value.keys]
    later = sorted((node.lineno, t.slice.value) for node in ast.walk(tree)
                   if isinstance(node, ast.Assign) for t in node.targets
                   if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == target.id
                   and isinstance(t.slice, ast.Constant))
    return tuple(keys + [k for _, k in later])


def jax_env_defaults(name: str) -> dict:
    """The ``os.environ.get(NAME, default)`` calls of the JAX script: each
    knob's default literal."""
    out = {}
    for node in ast.walk(jax_tree(name)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and len(node.args) == 2
                and getattr(node.func.value, "attr", None) == "environ"):
            out[node.args[0].value] = ast.literal_eval(node.args[1])
    return out


def literal_loops(name: str) -> list:
    """The literal tuples the JAX script's ``for`` loops iterate over."""
    out = []
    for node in ast.walk(jax_tree(name)):
        if isinstance(node, ast.For):
            try:
                out.append(ast.literal_eval(node.iter))
            except ValueError:
                pass
    return out


def assigned(name: str, var: str):
    for node in ast.walk(jax_tree(name)):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == var
                                                for t in node.targets):
            return node.value
    raise AssertionError(f"no {var} in benchmarks/{name}.py")


def jax_kwargs(node: ast.AST, grid: int) -> dict:
    """A ``dict(...)`` of the JAX script evaluated at GRID, bf16 as a name."""
    jnp_names = type("jnp", (), {"bfloat16": "bfloat16", "float32": "float32"})
    return eval(compile(ast.Expression(node), "<jax>", "eval"),
                {"dict": dict, "GRID": grid, "MC": 64, "jnp": jnp_names})


def canonical(kw: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


# ---------------------------------------------------------------------------
# The JAX scripts' structure

@pytest.mark.parametrize("name", list(HARNESSES))
def test_report_keys_and_knob_defaults_are_the_jax_scripts(name, monkeypatch):
    module, _, _, knobs = HARNESSES[name]
    assert module.REPORT_KEYS == jax_report_keys(name)
    for k in list(__import__("os").environ):
        if k.startswith(KNOB_PREFIXES):
            monkeypatch.delenv(k)
    s = module.settings()
    defaults = jax_env_defaults(name)
    assert set(defaults) == set(knobs), sorted(set(defaults) ^ set(knobs))
    for knob, key in knobs.items():
        want = defaults[knob]
        if knob == "DEMO_SCALES":
            want = [float(x) for x in want.split(",")]
        elif knob == "DEMO_SERVE":
            want = bool(int(want))
        assert s[key] == want, (knob, s[key], want)


def test_sampler_quality_row_lists_are_the_jax_scripts():
    """Each SQ_ROWS branch's ``run(...)`` calls, as (sampler, steps, quant,
    spacing), in order."""
    lists = {}
    for node in ast.walk(jax_tree("sampler_quality")):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and "SQ_ROWS" in ast.unparse(node.test.left)):
            key = node.test.comparators[0].value
            for branch_key, body in ((key, node.body), (None, node.orelse)):
                if len(body) == 1 and isinstance(body[0], ast.Assign):
                    calls = body[0].value.elts
                    lists[branch_key] = [
                        (c.args[0].value, c.args[1].value,
                         *({kw.arg: kw.value.value for kw in c.keywords}.get(k)
                           for k in ("quant", "spacing"))) for c in calls]
    assert set(lists) == {None, "unipc", "stochastic", "karras"}
    assert lists == sampler_quality.ROWS


def test_loops_arms_and_pairs_are_the_jax_scripts():
    assert ema_ablation.SAMPLERS in literal_loops("ema_ablation")
    assert ema_ablation.SEEDS in literal_loops("ema_ablation")
    assert ema_ablation.EMA_DECAY == ast.literal_eval(
        assigned("ema_ablation", "report").values[2])
    assert vit_ab.SAMPLERS in literal_loops("vit_ab")
    assert demo_min_snr.ARMS in literal_loops("demo_min_snr")
    assert tuple(sh_holdout.CONDS) in literal_loops("sh_holdout")
    assert sh_holdout.HOLDOUT == ast.literal_eval(assigned("sh_holdout", "HOLDOUT"))
    assert vit_ab.EMB == ast.literal_eval(assigned("vit_ab", "EMB"))
    # the distillation's striding budgets and the teacher's DDIM-50
    for source in ((ROOT / "benchmarks" / "demo_distill.py").read_text(),
                   Path(demo_distill.__file__).read_text()):
        assert "for n in (16, 8, 4, 2) if" in source
    assert demo_distill.DDIM_STEPS == 50 and '"ddim", num_steps=50' in \
        (ROOT / "benchmarks" / "demo_distill.py").read_text()


@pytest.mark.parametrize("name", ["sampler_quality", "ema_ablation", "demo_min_snr", "demo_cfg",
                                  "sh_holdout", "demo_distill"])
def test_backbone_kwargs_are_the_jax_scripts(name):
    want = jax_kwargs(assigned(name, "backbone_kwargs"), 16)
    assert canonical(_ylm.backbone_kwargs(16)) == canonical(want)


def test_vit_ab_and_demo64_backbones_are_the_jax_scripts():
    node = assigned("vit_ab", "backbones")
    want = {k.value: (v.elts[0].value, jax_kwargs(v.elts[1], 16))
            for k, v in zip(node.keys, node.values)}
    got = vit_ab.backbones(16, smoke=False)
    assert {k: (b, canonical(kw)) for k, (b, kw) in got.items()} == \
        {k: (b, canonical(kw)) for k, (b, kw) in want.items()}
    want64 = jax_kwargs(assigned("demo64", "backbone_kwargs"), 64)
    assert canonical(demo64.backbone_kwargs(64, smoke=False)) == canonical(want64)


# ---------------------------------------------------------------------------
# _ylm against the JAX package

@pytest.mark.parametrize("grid,n", [(16, 8), (8, 16), (4, None)])
def test_pairs_rows_and_fields_equal_jax(grid, n):
    jd = JaxYlmDataset(max_l=5, grid_el=grid, length=16)
    want_pairs = [(l, m) for l in range(jd.max_l) for m in range(-l, l + 1)]  # noqa: E741
    want_pairs = want_pairs if n is None else want_pairs[:n]
    pairs = _ylm.physical_pairs(n)
    assert pairs == want_pairs and len(_ylm.physical_pairs()) == 25
    rows = _ylm.condition_rows(pairs)
    want_rows = np.stack([jax_sha512({"l": l, "m": m}, l=4 * 64) for l, m in want_pairs])
    assert rows.dtype == want_rows.dtype and rows.shape == (len(pairs), 256)
    np.testing.assert_array_equal(rows, want_rows)
    grid_kw = {k: jd.grid_kwargs[k] for k in ("x", "y", "z")}
    want_fields = np.stack([jax_ylm(**grid_kw, m=m, l=l)[1].astype(np.float32)[..., None]
                            for l, m in want_pairs])
    got = _ylm.exact_fields(_ylm.dataset(grid, 16), pairs)
    assert got.dtype == np.float32 and got.shape == (len(pairs), grid, grid, grid, 1)
    np.testing.assert_array_equal(got, want_fields)


def test_scorer_equals_jax_wasserstein_and_numpy_mse():
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, size=(8, 6, 6, 6, 1)).astype(np.float32)
    gen = (real + 0.4 * rng.normal(size=real.shape)).astype(np.float32)
    scorer = _ylm.Scorer(real)
    want = float(np.mean(np.asarray(JaxWasserstein()(jnp.asarray(gen), jnp.asarray(real)))))
    np.testing.assert_allclose(scorer.sinkhorn(gen), want, rtol=1e-5)
    np.testing.assert_allclose(scorer.sinkhorn(torch.from_numpy(gen)), want, rtol=1e-5)
    assert scorer.mse(gen) == float(np.mean((gen - real) ** 2))
    np.testing.assert_array_equal(scorer.per_pair_mse(gen),
                                  np.mean((gen - real) ** 2, axis=(1, 2, 3, 4)))
    q = scorer(gen)
    assert q["finite"] and q["matched_mse"] == scorer.mse(gen)
    noise = scorer.noise()
    assert noise["matched_mse"] > q["matched_mse"] and noise["sinkhorn"] > 0
    assert not scorer(np.full_like(gen, np.nan))["finite"]


# ---------------------------------------------------------------------------
# The slice as a whole: sampler_quality's rows against JAX's reverse_process

BATCH = 4
SMOKE_SHAPE = (BATCH, 4, 4, 4, 1)


@pytest.fixture(scope="module")
def carried():
    """(port sampling pipeline, JAX pipeline, JAX params): the harnesses'
    UNet at the smoke widths, JAX's seed-777 tree perturbed, carried in."""
    kw = _ylm.backbone_kwargs(_ylm.SMOKE_GRID, smoke=True)
    jkw = dict(kw, dtype=jnp.float32)
    jpipe = jg.GaussianDiffusionPipeline(
        "UNetv2", jkw, jax_schedule.LinearSchedule(**_ylm.SMOKE_SCHEDULE),
        model_mean_type="epsilon", model_var_type="fixed_large")
    params = jpipe.init_params(jax.random.PRNGKey(_ylm.INIT_SEED))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    jit_backbone(jpipe)
    sd = export_unet_state_dict(params, **arch_kwargs(kw))
    weights = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    tpipe = _ylm.sampling_pipeline("UNetv2", kw, weights, "cpu", smoke=True)
    return tpipe, jpipe, params


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


ROW_IDS = ["dpm++5", "ddim10", "ddpm1000", "ddim50-int8"]
HELD_ROWS = [sampler_quality.ROWS[None][i] for i in (0, 3, 7, 9)]


@pytest.mark.parametrize("row", HELD_ROWS, ids=ROW_IDS)
def test_sampler_quality_rows_match_jax_reverse_process(carried, monkeypatch, row):
    tpipe, jpipe, params = carried
    sampler, steps, quant, spacing = row
    conds = _ylm.condition_rows(_ylm.physical_pairs(BATCH))
    opts = dict(sampler=sampler, num_steps=steps, spacing=spacing)
    with monkeypatch.context() as m:
        inj = Injected(m, SMOKE_SHAPE)
        with conv_quant(quant or "off"):
            got = _ylm.as_numpy(_ylm.sample(tpipe, BATCH, conds, **opts))
        with jax_conv_quant(quant or "off"), jax.disable_jit():
            want = np.asarray(jpipe.reverse_process(params, jnp.asarray(0, jnp.int32),
                                                    SMOKE_SHAPE, jnp.asarray(conds), **opts))
        float_sample = _ylm.as_numpy(_ylm.sample(tpipe, BATCH, conds, **opts)) if quant else None
    x_T = inj.batch[0]
    assert got.shape == want.shape == SMOKE_SHAPE and np.isfinite(got).all()
    assert np.abs(want - x_T).max() > 0.1, "the model must move the sample"
    if sampler == "ddpm":  # x_T and one draw a step of the 20
        assert inj.port_draws == 1 + len(_ylm.schedule(smoke=True))
    if quant:
        assert rel_mse(got, want) < 1e-3, rel_mse(got, want)
        assert rel_mse(got, float_sample) > 1e-7  # int8 really ran
    else:
        assert rel_mse(got, want) < 1e-9, rel_mse(got, want)
        np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# Every harness on the CPU

def finite_flags(report) -> list:
    if isinstance(report, dict):
        return [v for k, v in report.items() if k == "finite"] + [
            f for v in report.values() for f in finite_flags(v)]
    if isinstance(report, list):
        return [f for v in report for f in finite_flags(v)]
    return []


@pytest.mark.parametrize("name", list(HARNESSES))
def test_smoke_cut_runs_and_writes_its_report(name, tmp_path, monkeypatch, capsys):
    module, prefix, filename, _ = HARNESSES[name]
    for k in list(__import__("os").environ):
        if k.startswith(KNOB_PREFIXES):
            monkeypatch.delenv(k)
    monkeypatch.setenv(f"{prefix}_SMOKE", "1")
    monkeypatch.setenv("YLM_MAX_STEPS", "4")
    report = module.main(["-d", "cpu", "--work-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu")
    written = json.loads((tmp_path / filename).read_text())
    assert written == report
    assert report["device"] == out[0]
    assert set(module.REPORT_KEYS) <= set(report)
    assert set(report) - set(module.REPORT_KEYS) == PORT_EXTRAS | OWN_EXTRAS.get(name, set())
    flags = finite_flags(report)
    assert flags and all(flags), flags
    sps = report["train_steps_per_s"]
    assert all(v > 0 for v in (sps.values() if isinstance(sps, dict) else [sps]))
    if name == "sampler_quality":
        assert [r["steps"] for r in report["rows"]] == [
            min(r[1], 4) for r in sampler_quality.ROWS[None]]
        assert [r.get("quant") for r in report["rows"]][-2:] == ["int8", "int8"]
    if name == "demo_distill":
        assert list(report["student"]) == ["4", "2"] and "teacher-ddim-4" in report["serving"]
        assert all(Path(p).is_file() for p in report["weights"].values())
    if name == "demo64":
        assert report["use_checkpoint"] is False and report["sample_steps"] == 4
    if name == "sh_holdout":
        assert set(report["conds"]) == {"embed", "fourier"}
        assert list(report["conds"]["embed"]["holdout_pair_mse"]) == ["(3, -2)", "(4, 1)"]
    if name == "vit_ab":
        assert set(report["backbones"]) == {"unet", "vit"}
        assert all(b["steps"] > 0 for b in report["backbones"].values())


@pytest.mark.parametrize("name", list(HARNESSES))
def test_harness_keeps_no_copy_of_the_shared_pieces(name):
    """The model, pairs, rows, fields, scorer and loop come from ``_ylm``."""
    source = Path(HARNESSES[name][0].__file__).read_text()
    assert "from rho_diffusion_tpu_torch.benchmarks import _ylm" in source
    for piece in ("WassersteinWrapper", "calculate_sha512_embedding",
                  "compute_spherical_harmonic", "prefetch_to_device(iter(loader)",
                  "model_channels=", "for l in range"):
        assert piece not in source, (name, piece)


def test_unknown_row_list_raises(monkeypatch):
    monkeypatch.setenv("SQ_ROWS", "fast")
    monkeypatch.setenv("QUAL_SMOKE", "1")
    with pytest.raises(ValueError, match="SQ_ROWS"):
        sampler_quality.main(["-d", "cpu"])
