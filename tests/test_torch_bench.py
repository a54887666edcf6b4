"""The port's bench entry, ``python -m rho_diffusion_tpu_torch.bench``, on the
CPU.

At the smoke sizes (``BENCH_SMOKE=1 ... -d cpu``) it prints exactly one
JSON line under the root ``bench.py``'s metric names, in the train and the
sample mode, with ``vs_baseline`` 1.0, and never opens or globs the TPU's
``BENCH_r*.json`` records (an audit hook watches every open and glob of the
run). Without ``-d cpu`` it needs CUDA; the knobs whose machinery was
queued run: realdata with and without the device cache, the train mode with
recomputation (``BENCH_REMAT=1``), the ViT and AdamW's fused step
(``BENCH_FLAT_OPT=1``); the new modules are among those the import rule
checks.
"""
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import rho_diffusion_tpu_torch
from rho_diffusion_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]

AUDITED_RUN = """
import runpy, sys
def watch(event, args):
    if event in ("open", "glob.glob", "pathlib.Path.glob") and args and "BENCH_r" in str(args[0]):
        print("TOUCHED", event, args[0], file=sys.stderr)
sys.addaudithook(watch)
sys.argv = ["bench", "-d", "cpu"]
runpy.run_module("rho_diffusion_tpu_torch.bench", run_name="__main__")
"""


def run_bench(**env_over) -> tuple[list, str]:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", BENCH_SMOKE="1", BENCH_STEPS="2",
               BENCH_WARMUP="1", BENCH_WINDOWS="1", **env_over)
    out = subprocess.run([sys.executable, "-c", AUDITED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines(), out.stderr


@pytest.mark.parametrize("mode,metric,unit", [
    ("train", "train_steps_per_sec_per_chip_smoke", "steps/sec/chip"),
    ("sample", "ddim10_sample_wall_clock_8cubed_b8", "seconds"),
])
def test_smoke_prints_one_json_line_under_bench_py_names(mode, metric, unit):
    assert list(ROOT.glob("BENCH_r*.json")), "the TPU records the entry must not read"
    lines, err = run_bench(BENCH_MODE=mode)
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert (result["metric"], result["unit"], result["vs_baseline"]) == (metric, unit, 1.0)
    assert result["value"] > 0
    assert "TOUCHED" not in err, err
    assert "device=cpu" in err
    # the names are the root bench.py's own
    source = (ROOT / "bench.py").read_text()
    assert '"train_steps_per_sec_per_chip_smoke"' in source
    assert 'f"{sampler}{steps}_sample_wall_clock_{gname}_b{n}"' in source


def test_sample_mode_takes_the_sampler_and_steps():
    lines, _ = run_bench(BENCH_MODE="sample", BENCH_SAMPLER="dpm++", BENCH_DDIM_STEPS="3")
    assert json.loads(lines[0])["metric"] == "dpm++3_sample_wall_clock_8cubed_b8"


def test_bench_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    for argv in ([], ["-d", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(argv)


@pytest.mark.parametrize("knob,match", [
    ({"BENCH_MODEL": "vit"}, None),
    ({"BENCH_REMAT": "1"}, None),
    ({"BENCH_MODE": "realdata", "BENCH_DEVICE_CACHE": "1"}, None),
    ({"BENCH_FLAT_OPT": "1"}, None),
], ids=["vit", "remat", "device-cache", "flat-opt"])
def test_queued_knobs_raise(monkeypatch, knob, match):
    """The knobs whose machinery was queued now run. BENCH_DEVICE_CACHE=1
    (the device-resident cache, ported) runs: realdata's batches are gathers
    from the uploaded table, and the run prints its one line. BENCH_REMAT=1
    (the UNet's use_checkpoint, ported) runs the train mode with every
    ResBlock and AttentionBlock recomputed in the backward, and prints its
    one line. BENCH_MODEL=vit (the VisionTransformer, ported) trains at the
    smoke widths and prints its one line; its sample mode exits with the
    root bench.py's message. BENCH_FLAT_OPT=1 (optax.flatten's counterpart,
    AdamW's fused step) trains the smoke and prints its one line; its
    arithmetic is held against optax in tests/test_torch_utils_helpers.py."""
    if knob == {"BENCH_FLAT_OPT": "1"}:
        lines, err = run_bench(**knob)
        assert len(lines) == 1, lines
        result = json.loads(lines[0])
        assert result["metric"] == "train_steps_per_sec_per_chip_smoke" and result["value"] > 0
        assert "flat_opt=True " in err and "finite=True " in err, err
        monkeypatch.setenv("BENCH_SMOKE", "1")
        monkeypatch.setenv("BENCH_FLAT_OPT", "1")
        s = bench.settings()
        pipe = bench.training_pipeline(s, torch.device("cpu"))
        optim = pipe.create_state(0).optimizer
        assert isinstance(optim, torch.optim.AdamW) and optim.param_groups[0]["fused"]
        return
    if knob == {"BENCH_MODEL": "vit"}:
        lines, err = run_bench(**knob)
        assert len(lines) == 1, lines
        result = json.loads(lines[0])
        assert result["metric"] == "train_steps_per_sec_per_chip_smoke" and result["value"] > 0
        assert "finite=True " in err and re.search(r" steps_run=3\b", err), err  # 1 + 1 x 2
        monkeypatch.setenv("BENCH_SMOKE", "1")
        monkeypatch.setenv("BENCH_MODEL", "vit")
        monkeypatch.setenv("BENCH_MODE", "sample")
        with pytest.raises(SystemExit, match="BENCH_MODEL=unet only"):
            bench.main(["-d", "cpu"])
        assert 'raise SystemExit("BENCH_MODE=sample supports BENCH_MODEL=unet only")' in \
            (ROOT / "bench.py").read_text()
        return
    if knob == {"BENCH_REMAT": "1"}:
        lines, err = run_bench(**knob)
        assert len(lines) == 1, lines
        result = json.loads(lines[0])
        assert result["metric"] == "train_steps_per_sec_per_chip_smoke" and result["value"] > 0
        assert "remat=True " in err and "finite=True " in err, err
        return
    lines, err = run_bench(**knob)
    assert len(lines) == 1, lines
    assert json.loads(lines[0])["metric"] == "train_steps_per_sec_per_chip_3d_unet_realdata"
    # the smoke's 256 fields of 8^3 and their 256-wide labels, fp32
    assert "device_cache_bytes=786432 " in err, err


def test_realdata_smoke_streams_from_the_host():
    """realdata without the cache at the smoke sizes: batches through the
    host loader (the smoke's width is 64, so the model's embedding matches
    the dataset's 256-wide sha512 labels)."""
    lines, err = run_bench(BENCH_MODE="realdata")
    assert len(lines) == 1, lines
    assert json.loads(lines[0])["metric"] == "train_steps_per_sec_per_chip_3d_unet_realdata"
    assert "device_cache_bytes=0 " in err, err


def test_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("BENCH_MODE", "serve")
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.main(["-d", "cpu"])


def test_new_modules_are_under_the_import_rule():
    """tests/test_torch_port_rules.py imports every module that
    pkgutil.walk_packages finds with JAX blocked; this slice's are among
    them."""
    names = {m.name for m in pkgutil.walk_packages(rho_diffusion_tpu_torch.__path__,
                                                   "rho_diffusion_tpu_torch.")}
    assert {"rho_diffusion_tpu_torch.bench", "rho_diffusion_tpu_torch.diffusion.gaussian",
            "rho_diffusion_tpu_torch.diffusion.solvers"} <= names


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_vit_settings_are_the_root_bench_py_widths(monkeypatch, smoke):
    """BENCH_MODEL=vit builds the root bench.py's ViT (:200-216): 32^3,
    patch 8, embedding 256, hidden 512, depth 8, 16 heads at full width;
    patch 4, 64, 128, depth 2, 4 heads at the smoke's 8^3; batch 32 (8),
    bf16, and the metric names its model."""
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_MODEL", "vit")
    if smoke:
        monkeypatch.setenv("BENCH_SMOKE", "1")
    s = bench.settings()
    grid = 8 if smoke else 32
    assert s["backbone"] == "VisionTransformer" and s["batch"] == (8 if smoke else 32)
    assert s["backbone_kwargs"] == dict(
        patch_size=4 if smoke else 8, input_shapes=(grid,) * 3, num_channels=1,
        embedding_dim=64 if smoke else 256, hidden_dim=128 if smoke else 512,
        transformer_depth=2 if smoke else 8, num_heads=4 if smoke else 16, dropout=0.0,
        dtype="bfloat16")
    pipe = bench.training_pipeline(s, "cpu")
    assert type(pipe.backbone).__name__ == "VisionTransformer"
    assert pipe.sample_shape(2) == (2, grid, grid, grid, 1)
    assert 'f"train_steps_per_sec_per_chip_{dims}d_{model}_{_grid_name(grid, dims)}_b{batch}"' \
        in (ROOT / "bench.py").read_text()
