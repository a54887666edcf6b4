"""The port's 2-D/1-D quality harnesses (``rho_diffusion_tpu_torch/benchmarks/``:
``_corpus`` and six entries) against the JAX package's scripts, on the CPU.

* Per harness, read from the JAX script's source with ``ast`` (the scripts
  run at import, so they are never imported): its report keys (the dict it
  dumps, then the keys it assigns into it; none for ``galaxy_dc_probe``,
  which only prints) equal the harness's ``REPORT_KEYS``; each env knob's
  default (a literal, or a ``SMOKE``-conditional pair of literals) equals
  the harness's setting with no knob set and under its smoke knob; the
  knobs that name directories are honoured (the port's defaults lie under
  its ``--work-dir``); the constants the scripts fix (seeds, batches,
  grids, held-out rows, sampler rows, the generalization grid) equal the
  harness's.
* ``demo_generalization``'s mismatch and per-axis partner indices and its
  four partitions, on the 900-row label grid of its corpus (the labels'
  order as the dataset reads them), equal the JAX script's ``partner``,
  ``partitions`` and ``axis_specs``, executed from its source.
* Every harness runs its ``*_SMOKE=1`` cut (``galaxy_dc_probe`` and
  ``spectro_rescore`` on the smoke runs' directories) with every sampler
  capped at 4 steps (``CORPUS_MAX_STEPS``; ``demo_generalization`` trained
  on the one (s, m) block its smoke cut evaluates) and writes ``<work-dir>/<its JAX
  file name>`` equal to what ``main`` returns, with finite samples, the JAX
  keys, and beside them ``device``, ``train_steps_per_s``, ``corpus_route``
  and its own named extras; the galaxy and spectra harnesses also on the
  memory route (the host's route made ``memory``), which gives the hdf5 route's
  report numbers.
* No new module imports jax or the JAX package.
"""
import ast
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rho_diffusion_tpu_torch.benchmarks import (
    _corpus,
    demo_galaxy2d,
    demo_generalization,
    demo_spectro1d,
    demo_spectro_cond,
    galaxy_dc_probe,
    spectro_rescore,
)
from test_torch_quality_harnesses import assigned, finite_flags, jax_tree

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

# harness -> (its module, its smoke knob, its JAX env knob -> settings key;
# a key in PATHS is a directory knob)
HARNESSES = {
    "demo_galaxy2d": (demo_galaxy2d, "DEMO_SMOKE",
                      {"DEMO_SMOKE": "smoke", "DEMO_EPOCHS": "epochs", "DEMO_BATCH": "batch",
                       "DEMO_RECIPE": "recipe", "DEMO_CAMERAS": "cameras",
                       "DEMO_WORKDIR": "workdir"}),
    "galaxy_dc_probe": (galaxy_dc_probe, None, {"GALAXY_WORKDIR": "workdir"}),
    "demo_spectro1d": (demo_spectro1d, "DEMO_SMOKE",
                       {"DEMO_SMOKE": "smoke", "DEMO_EPOCHS": "epochs", "DEMO_BATCH": "batch",
                        "DEMO_MOLECULES": "molecules", "DEMO_GRID": "grid",
                        "DEMO_RECIPE": "recipe", "DEMO_WORKDIR": "workdir"}),
    "spectro_rescore": (spectro_rescore, None, {"RESCORE_WORKDIR": "workdir"}),
    "demo_generalization": (demo_generalization, "GEN_SMOKE",
                            {"GEN_SMOKE": "smoke", "GEN_COND": "cond", "GEN_EPOCHS": "epochs",
                             "GEN_BATCH": "batch", "GEN_WORKDIR": "workdir",
                             "GEN_CORPUS_DIR": "corpus_dir"}),
    "demo_spectro_cond": (demo_spectro_cond, "SPECTRO_SMOKE",
                          {"SPECTRO_SMOKE": "smoke", "SPECTRO_COND": "cond",
                           "SPECTRO_EPOCHS": "epochs", "SPECTRO_WORKDIR": "workdir",
                           "SPECTRO_CORPUS_DIR": "corpus_dir"}),
}
PATHS = ("workdir", "corpus_dir")
KNOB_PREFIXES = ("DEMO_", "GALAXY_", "RESCORE_", "GEN_", "SPECTRO_", "CORPUS_")
PORT_EXTRAS = {"device", "train_steps_per_s", "corpus_route"}
OWN_EXTRAS = {
    "demo_galaxy2d": {"sampler", "finite", "plots", "trainer_dir"},
    "galaxy_dc_probe": {"frames", "data_mean", "data_std", "per_t", "weights", "finite"},
    "demo_spectro1d": {"sampler", "finite", "plots", "trainer_dir"},
    "spectro_rescore": {"weights"},
    "demo_generalization": {"sampler", "finite", "plots", "trainer_dir"},
    "demo_spectro_cond": {"sampler", "finite", "plots", "trainer_dir"},
}


def clear_knobs(monkeypatch) -> None:
    for k in list(os.environ):
        if k.startswith(KNOB_PREFIXES):
            monkeypatch.delenv(k)


def jax_report_keys(name: str) -> tuple:
    """The dumped dict's keys, then those assigned into it; () when the
    script dumps nothing."""
    tree = jax_tree(name)
    dumped = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute) and n.func.attr == "dump"]
    if not dumped:
        return ()
    (target,) = dumped
    if isinstance(target, ast.Dict):
        return tuple(k.value for k in target.keys)
    keys = [k.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Dict)
            and any(getattr(t, "id", None) == target.id for t in node.targets)
            for k in node.value.keys]
    later = sorted((node.lineno, t.slice.value) for node in ast.walk(tree)
                   if isinstance(node, ast.Assign) for t in node.targets
                   if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == target.id
                   and isinstance(t.slice, ast.Constant))
    return tuple(keys + [k for _, k in later])


def jax_knobs(name: str) -> dict:
    """knob -> its default: a literal, None (no default), ("smoke", on, off)
    for ``a if SMOKE else b``, or "path" for a computed directory."""
    out = {}
    for node in ast.walk(jax_tree(name)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and getattr(node.func.value, "attr", None) == "environ"):
            default = node.args[1] if len(node.args) == 2 else None
            if default is None:
                value = None
            elif isinstance(default, ast.IfExp) and getattr(default.test, "id", "") == "SMOKE":
                value = ("smoke", ast.literal_eval(default.body),
                         ast.literal_eval(default.orelse))
            else:
                try:
                    value = ast.literal_eval(default)
                except ValueError:
                    value = "path"
            out[node.args[0].value] = value
    return out


def typed(value, like):
    if isinstance(like, bool):
        return value == "1"
    return type(like)(value) if like is not None and value is not None else value


@pytest.mark.parametrize("name", list(HARNESSES))
def test_report_keys_and_knob_defaults_are_the_jax_scripts(name, monkeypatch, tmp_path):
    module, smoke_knob, knobs = HARNESSES[name]
    assert module.REPORT_KEYS == jax_report_keys(name)
    defaults = jax_knobs(name)
    assert set(defaults) == set(knobs), sorted(set(defaults) ^ set(knobs))
    clear_knobs(monkeypatch)
    plain = module.settings()
    smoke = None
    if smoke_knob:
        monkeypatch.setenv(smoke_knob, "1")
        smoke = module.settings()
        monkeypatch.delenv(smoke_knob)
    for knob, key in knobs.items():
        want = defaults[knob]
        if key in PATHS:  # JAX's /tmp default is the port's --work-dir or under build/
            assert want == "path" or str(want).startswith("/tmp/"), (knob, want)
            monkeypatch.setenv(knob, str(tmp_path / knob))
            assert str(module.settings()[key]) == str(tmp_path / knob), knob
            monkeypatch.delenv(knob)
        elif isinstance(want, tuple):
            assert smoke[key] == typed(want[1], smoke[key]), knob
            assert plain[key] == typed(want[2], plain[key]), knob
        else:
            assert plain[key] == typed(want, plain[key]), (knob, plain[key], want)


def constant(name: str, var: str):
    return ast.literal_eval(assigned(name, var))


def test_fixed_constants_are_the_jax_scripts(monkeypatch):
    assert demo_galaxy2d.DDIM_STEPS == 100 and "num_steps=100" in ast.unparse(
        jax_tree("demo_galaxy2d"))
    src = {n: ast.unparse(jax_tree(n)) for n in HARNESSES}
    for module, name, seed in ((demo_galaxy2d, "demo_galaxy2d", 1000),
                               (demo_spectro1d, "demo_spectro1d", 2000),
                               (spectro_rescore, "spectro_rescore", 2000),
                               (demo_generalization, "demo_generalization", 1000),
                               (demo_spectro_cond, "demo_spectro_cond", 3000)):
        assert module.SAMPLE_SEED == seed and f"PRNGKey({seed} +" in src[name], name
    assert demo_galaxy2d.corpus(False) == {"s_values": [0.25, 0.5, 1.0], "m_values": [1.0],
                                           "cameras": [0, 1], "size": 512}
    assert "np.roll(rows, 5)" in src["demo_galaxy2d"] and demo_galaxy2d.MISMATCH_ROLL == 5
    assert demo_spectro1d.LINEWIDTH == constant("demo_spectro1d", "LINEWIDTH")
    for var in ("GRID", "BATCH", "EPOCHS"):
        assert getattr(spectro_rescore, var) == constant("spectro_rescore", var)
    rows = [(ast.literal_eval(e.elts[0]), ast.literal_eval(e.elts[1]), ast.literal_eval(e.elts[2]))
            for n in ast.walk(jax_tree("spectro_rescore")) if isinstance(n, ast.For)
            and isinstance(n.iter, ast.List) for e in n.iter.elts]
    assert rows == list(spectro_rescore.ROWS)
    assert spectro_rescore.ANCESTRAL[0] in src["spectro_rescore"] and "1000)" in src[
        "spectro_rescore"]
    for var in ("S_VALUES", "M_VALUES", "CAMERAS", "HOLD_T", "TRAIN_CAMS", "HOLD_CAM"):
        assert getattr(demo_generalization, var) == constant("demo_generalization", var), var
    np.testing.assert_array_equal(demo_generalization.T_VALUES, np.arange(400.0, 521.0, 5.0))
    assert "sub[:180]" in src["demo_generalization"] and demo_generalization.SINKHORN_ROWS == 180
    assert demo_spectro_cond.BATCH == constant("demo_spectro_cond", "BATCH")
    assert demo_spectro_cond.LINEWIDTH == constant("demo_spectro_cond", "LINEWIDTH")
    assert "range(5, N_MOL, 8)" in src["demo_spectro_cond"]
    for smoke in (False, True):
        monkeypatch.setenv("SPECTRO_SMOKE", "1" if smoke else "0")
        s = demo_spectro_cond.settings()
        assert s["holdout"] == list(range(5, s["molecules"], 8))
        assert (s["molecules"], s["grid"]) == ((16, 256) if smoke else (64, 1024))
    assert galaxy_dc_probe.PROBE_T == next(
        ast.literal_eval(n.iter) for n in ast.walk(jax_tree("galaxy_dc_probe"))
        if isinstance(n, ast.For))
    assert "PRNGKey(7)" in src["galaxy_dc_probe"] and galaxy_dc_probe.NOISE_SEED == 7
    assert "min(len(ds), 25)" in src["galaxy_dc_probe"] and galaxy_dc_probe.MAX_FRAMES == 25


# ---------------------------------------------------------------------------
# demo_generalization's partners against the JAX script's

def jax_generalization_namespace(labels: np.ndarray) -> dict:
    """The JAX script's constants, ``row_of``, ``partner``, ``mis_idx``, the
    partitions and ``axis_specs``, executed from its source on ``labels``."""
    tree = jax_tree("demo_generalization")
    wanted = {"S_VALUES", "M_VALUES", "CAMERAS", "T_VALUES", "HOLD_T", "TRAIN_CAMS", "HOLD_CAM",
              "row_of", "t_list", "mis_idx", "is_hold_t", "is_hold_c", "partitions",
              "trained_rows", "axis_specs"}
    ns = {"np": np, "labels": labels, "SMOKE": 0}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "partner":
            exec(compile(ast.Module([node], []), "<jax>", "exec"), ns)
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", None) in wanted
                                                  for t in node.targets):
            exec(compile(ast.Module([node], []), "<jax>", "exec"), ns)
    return ns


def test_generalization_partners_and_partitions_are_the_jax_scripts():
    _corpus.clear_cache()
    spec = {**demo_generalization.corpus(False), "size": 8}
    frames = _corpus.GalaxyFrames(demo_generalization.eval_kwargs(), **spec)
    labels = frames.labels
    assert labels.shape == (900, 4)
    ns = jax_generalization_namespace(labels)
    np.testing.assert_array_equal(demo_generalization.mismatch_index(labels), ns["mis_idx"])
    parts = demo_generalization.partitions(labels)
    assert list(parts) == list(ns["partitions"])
    for k in parts:
        np.testing.assert_array_equal(parts[k], ns["partitions"][k])
    assert [int(parts[k].sum()) for k in parts] == [540, 135, 180, 45]
    trained = np.where(parts["trained"])[0]
    np.testing.assert_array_equal(trained, ns["trained_rows"])
    got = demo_generalization.axis_partners(labels, trained, smoke=False)
    assert list(got) == list(ns["axis_specs"]) == ["s", "m", "t", "c"]
    for name, (axis, values, delta) in ns["axis_specs"].items():
        want = np.array([ns["partner"](labels[i], axis, values, delta) for i in trained])
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert list(demo_generalization.axis_partners(labels, trained, smoke=True)) == ["t"]
    _corpus.clear_cache()


# ---------------------------------------------------------------------------
# Every harness on the CPU

SMOKE_RUNS = {  # name -> (env over the smoke knob, the report file)
    "demo_galaxy2d": ({"DEMO_SMOKE": "1", "DEMO_EPOCHS": "1", "DEMO_RECIPE": "reference"},
                      "demo_galaxy2d_reference_metrics.json"),
    "demo_galaxy2d_zero_snr": ({"DEMO_SMOKE": "1", "DEMO_EPOCHS": "1"},
                               "demo_galaxy2d_zero_snr_metrics.json"),
    "demo_spectro1d": ({"DEMO_SMOKE": "1", "DEMO_BATCH": "4"},
                       "demo_spectro1d_reference_metrics.json"),
    "demo_spectro1d_zero_snr": ({"DEMO_SMOKE": "1", "DEMO_BATCH": "4", "DEMO_EPOCHS": "1",
                                 "DEMO_RECIPE": "zero_snr"},
                                "demo_spectro1d_zero_snr_metrics.json"),
    "demo_generalization": ({"GEN_SMOKE": "1", "GEN_EPOCHS": "1", "GEN_BATCH": "60"},
                            "demo_generalization_galaxy_fourier_metrics.json"),
    "demo_spectro_cond": ({"SPECTRO_SMOKE": "1", "SPECTRO_COND": "embed"},
                          "demo_spectro_cond_embed_metrics.json"),
}


def run_harness(module, env: dict, work: Path, monkeypatch, argv=()) -> dict:
    with monkeypatch.context() as m:
        for k, v in {**env, "CORPUS_MAX_STEPS": "4"}.items():
            m.setenv(k, v)
        return module.main(["-d", "cpu", "--work-dir", str(work), *argv])


def check_report(name: str, module, report: dict, work: Path, filename: str) -> None:
    assert json.loads((work / filename).read_text()) == report
    assert report["device"].startswith("device=cpu")
    assert set(module.REPORT_KEYS) <= set(report)
    assert set(report) - set(module.REPORT_KEYS) == PORT_EXTRAS | OWN_EXTRAS[name]
    flags = finite_flags(report)
    assert flags and all(flags), flags
    if "plots" in report:
        assert Path(report["plots"]).is_file()


@pytest.mark.parametrize("run", list(SMOKE_RUNS))
def test_smoke_cut_runs_and_writes_its_report(run, tmp_path, monkeypatch):
    clear_knobs(monkeypatch)
    name = run.replace("_zero_snr", "")
    module = HARNESSES[name][0]
    env, filename = SMOKE_RUNS[run]
    if name == "demo_generalization":
        # the smoke cut evaluates the (s 0.5, m 1) block alone; training on
        # that block too keeps the case short (60 frames, not 540)
        monkeypatch.setattr(module, "S_VALUES", (0.5,))
        monkeypatch.setattr(module, "M_VALUES", (1.0,))
    report = run_harness(module, env, tmp_path, monkeypatch)
    check_report(name, module, report, tmp_path, filename)
    assert report["corpus_route"] == "hdf5"
    if "sampler" in report:
        assert report["sampler"].endswith("-4")
    if name != "demo_spectro_cond":  # 14 rotors at its fixed batch 16: no full batch
        assert report["train_steps_per_s"] > 0
    if name == "demo_generalization":
        assert report["frames_train"] == 60 and report["frames_eval"] == 100
        assert list(report["per_axis_separation_trained"]) == ["t"]
        assert len(report["partitions"]) == 4


def test_probe_and_rescore_read_the_smoke_runs_directories(tmp_path, monkeypatch):
    """demo_galaxy2d's and demo_spectro1d's reference runs, then the probe
    and the rescore on their directories; missing runs raise clearly."""
    clear_knobs(monkeypatch)
    env, _ = SMOKE_RUNS["demo_galaxy2d"]
    run_harness(demo_galaxy2d, env, tmp_path / "g", monkeypatch)
    env_s, _ = SMOKE_RUNS["demo_spectro1d"]
    trained = run_harness(demo_spectro1d, env_s, tmp_path / "s", monkeypatch)
    monkeypatch.setenv("GALAXY_WORKDIR", str(tmp_path / "g" / "reference"))
    probe = run_harness(galaxy_dc_probe, {}, tmp_path / "p", monkeypatch)
    check_report("galaxy_dc_probe", galaxy_dc_probe, probe, tmp_path / "p", "galaxy_dc_probe.json")
    assert list(probe["per_t"]) == [str(t) for t in galaxy_dc_probe.PROBE_T]
    assert probe["frames"] == 25 and probe["weights"].endswith("model.pth")
    monkeypatch.setenv("RESCORE_WORKDIR", str(tmp_path / "s" / "reference"))
    rescore = run_harness(spectro_rescore, {}, tmp_path / "r", monkeypatch)
    check_report("spectro_rescore", spectro_rescore, rescore, tmp_path / "r",
                 "spectro_rescore_metrics.json")
    # capped at 4: ancestral-20 -> 4, ddim-100/50 -> one ddim-4 row, the solvers at 4
    assert list(rescore["samplers"]) == ["ancestral_4", "ddim_4", "dpm++_4", "unipc_4",
                                         "sde-dpm++_4"]
    assert rescore["restored_step"] == trained["epochs"] * 2  # 8 rotors at batch 4
    assert rescore["molecules"] == 8 and rescore["grid"] == 256
    # -p: the trained run's model.pth (raw weights), no step
    with_p = run_harness(spectro_rescore, {}, tmp_path / "r2", monkeypatch,
                         argv=["-p", str(tmp_path / "s" / "reference" / "model.pth")])
    assert with_p["restored_step"] is None
    monkeypatch.setenv("RESCORE_WORKDIR", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="saved run not found"):
        run_harness(spectro_rescore, {}, tmp_path / "r3", monkeypatch)
    monkeypatch.setenv("GALAXY_WORKDIR", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="DEMO_RECIPE=reference"):
        run_harness(galaxy_dc_probe, {}, tmp_path / "p2", monkeypatch)


@pytest.mark.parametrize("run", ["demo_galaxy2d", "demo_spectro1d"])
def test_memory_route_gives_the_hdf5_routes_numbers(run, tmp_path, monkeypatch):
    clear_knobs(monkeypatch)
    module = HARNESSES[run][0]
    env, filename = SMOKE_RUNS[run]
    _corpus.clear_cache()
    with monkeypatch.context() as m:
        m.setattr(_corpus, "route", lambda: "memory")
        mem = run_harness(module, env, tmp_path / "m", monkeypatch)
    h5 = run_harness(module, env, tmp_path / "h", monkeypatch)
    assert mem["corpus_route"] == "memory" and h5["corpus_route"] == "hdf5"
    assert not list((tmp_path / "m").rglob("*.h5")) and list((tmp_path / "h").rglob("*.h5"))
    for key in ("matched_mse", "nn_mse", "sinkhorn", "mismatched_mse", "comb_fraction"):
        if key in mem:
            assert mem[key] == h5[key], key


NEW_MODULES = ("_corpus", "demo_galaxy2d", "galaxy_dc_probe", "demo_spectro1d",
               "spectro_rescore", "demo_generalization", "demo_spectro_cond", "conv_zfold",
               "conv_dimnum_sweep")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_module_imports_no_jax(name):
    source = (ROOT / "rho_diffusion_tpu_torch" / "benchmarks" / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|rho_diffusion_tpu\b(?!_torch))",
                         source, re.M), name


@pytest.mark.parametrize("name", NEW_MODULES[1:])
def test_entry_needs_cuda_unless_asked_for_the_cpu(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    clear_knobs(monkeypatch)
    module = __import__(f"rho_diffusion_tpu_torch.benchmarks.{name}", fromlist=["main"])
    for argv in ([], ["-d", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main(argv)
