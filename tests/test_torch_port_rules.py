"""Rules the PyTorch port keeps, checked on a machine without CUDA.

* It imports neither JAX nor the JAX package (a subprocess imports every
  module of the port, and chip_smoke, with those blocked).
* Its entry points run on CUDA unless asked for the CPU, and raise when CUDA
  is absent instead of falling back.
* Its kernel wrappers take the plain version only for CPU tensors; for any
  other device, or without a CUDA toolchain, they raise.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rho_diffusion_tpu_torch
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.schedule import LinearSchedule
from rho_diffusion_tpu_torch.ops.kernels import _build, launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention
from rho_diffusion_tpu_torch.utils import resolve_device

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PKG = Path(rho_diffusion_tpu_torch.__file__).parent

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "rho_diffusion_tpu")
# absent where the port runs, or imported only by the functions that need them
ABSENT = BLOCKED + ("pydantic", "h5py", "matplotlib")


def test_port_imports_without_jax_or_the_jax_package():
    code = f"""
import importlib, pkgutil, sys
for name in {ABSENT!r}:
    sys.modules[name] = None
import rho_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and (m.split(".")[0] in {ABSENT!r}))
print(len(names), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 20 and bad == "[]"


def test_port_sources_name_no_jax_module():
    """Tells ``rho_diffusion_tpu`` from ``rho_diffusion_tpu_torch``."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|rho_diffusion_tpu)(\.|\s|$)", re.M,
    )
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    for device in (None, "cuda", "tpu", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DDPM("UNetv2", dict(data_shape=[8], in_channels=1, out_channels=1, model_channels=8,
                            num_res_blocks=1, channel_mult=[1], dims=1),
             LinearSchedule(50))
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main([str(ROOT / "examples" / "config_smoke.json")])


def test_kernel_wrappers_raise_off_the_cpu():
    x = torch.empty((1, 4, 4, 4, 8), device="meta")
    w = torch.empty((8, 8, 3, 3, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        conv3d(x, w)
    q = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        conv3d(torch.zeros(1, 4, 4, 4, 8), torch.zeros(8, 8, 3, 3, 3, dtype=torch.float64))


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No toolchain means an error, never a silent plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("conv3d")
    assert _build.library_path("conv3d").parent == tmp_path / "kernels"


def test_cpu_calls_do_not_count_as_launches():
    launch_counts.clear()
    conv3d(torch.zeros(1, 3, 3, 3, 2), torch.zeros(2, 2, 3, 3, 3))
    q = torch.zeros(1, 5, 1, 8)
    flash_attention(q, q, q)
    assert sum(launch_counts.values()) == 0


def test_inference_entry_runs_on_cpu(tmp_path):
    """The CLI end to end at a tiny size on the CPU (asked for explicitly):
    config -> dataset -> DDPM -> HDF5 cache."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["model"]["kwargs"].update(data_shape=[4, 8, 8], model_channels=64, channel_mult=[1, 2],
                                  num_res_blocks=1, attention_resolutions=[2], num_heads=2)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = 25
    cfg["inference"]["cache_file"] = str(tmp_path / "out.h5")
    cfg["inference"]["plot_output_file"] = None
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    samples = inference.main([str(path), "-d", "cpu", "-n", "2", "--work-dir", str(tmp_path)])
    assert samples.shape == (2, 4, 8, 8, 1) and np.isfinite(samples).all()
    assert np.abs(samples).max() <= 1.0
    assert (tmp_path / "out.h5").exists()


@pytest.mark.parametrize("kwargs", [{"use_native": True}, {"h5_path": "fields.h5"}])
def test_inference_raises_for_unported_dataset_paths(tmp_path, kwargs):
    """A dataset path the port lacks stops the CLI instead of sampling
    without the config's conditioning."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["dataset"]["kwargs"].update(kwargs)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError):
        inference.main([str(path), "-d", "cpu", "-n", "1", "--work-dir", str(tmp_path)])
