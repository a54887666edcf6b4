"""Rules the PyTorch port keeps, checked on a machine without CUDA.

* It imports neither JAX nor the JAX package (a subprocess imports every
  module of the port, and chip_smoke, with those blocked).
* Its entry points run on CUDA unless asked for the CPU, and raise when CUDA
  is absent instead of falling back.
* Its kernel wrappers take the plain version only for CPU tensors; for any
  other device, or without a CUDA toolchain, they raise. Both kernel entry
  points are autograd Functions, and a raw kernel launch reached under grad
  mode with an input that requires grad raises instead of cutting the graph.
  The forward-only bottleneck-isolation kernels (K7-K9) raise the same way,
  and their benchmark entries need CUDA unless given ``-d cpu``.
* The training options that need more than one device raise, and so does
  the serving option not ported yet (a data axis > 1); ``--quant int8``
  serves on the CPU with the int8 plain versions and restores the mode.
"""
import http.client
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import rho_diffusion_tpu_torch
from chip_smoke import Int8Sites
from rho_diffusion_tpu_torch import bench, inference
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.schedule import LinearSchedule
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
from rho_diffusion_tpu_torch.distill import main as distill_main
from rho_diffusion_tpu_torch.benchmarks import (
    conv3d_ab,
    conv3d_variants,
    conv_int8_probe,
    conv_profile,
    demo64,
    demo_cfg,
    demo_distill,
    demo_min_snr,
    ema_ablation,
    sampler_quality,
    sh_holdout,
    vit_ab,
)
from rho_diffusion_tpu_torch.ops.kernels import _build, launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import Conv3d, conv3d, conv3d_kernel
from rho_diffusion_tpu_torch.ops.kernels.conv_int8 import (
    conv1d_s8_kernel,
    conv1d_s8_strided_kernel,
    conv2d_s8_kernel,
    conv2d_s8_strided_kernel,
    conv3d_s8_kernel,
    conv3d_s8_strided_kernel,
    conv_s8_general_kernel,
    int8_conv_route,
    quantize_rows_kernel,
)
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd_kernel,
    flash_attention_fwd_kernel,
)
from rho_diffusion_tpu_torch.ops.kernels.conv3d_variants import bigdot, conv_variant, dots_only
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import ring_attention_fold
from rho_diffusion_tpu_torch.ops.quant import get_conv_quant
from rho_diffusion_tpu_torch.parallel import context_sharded_attention, make_mesh
from rho_diffusion_tpu_torch.serve import build_server
from rho_diffusion_tpu_torch.training.__main__ import main as train_main
from rho_diffusion_tpu_torch.training import trainer as trainer_mod
from rho_diffusion_tpu_torch.training.trainer import Trainer
from rho_diffusion_tpu_torch.utils import resolve_device

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PKG = Path(rho_diffusion_tpu_torch.__file__).parent

QUALITY_HARNESSES = (sampler_quality, ema_ablation, demo_min_snr, demo_cfg, sh_holdout,
                     demo_distill, vit_ab, demo64)
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
    for argv in ([], ["-d", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main([str(ROOT / "examples" / "config_smoke.json"), *argv])
        with pytest.raises(RuntimeError, match="CUDA"):
            distill_main([str(ROOT / "examples" / "config_learned_variance.json"), *argv])
        # the 3-D Y_lm quality harnesses
        for harness in QUALITY_HARNESSES:
            with pytest.raises(RuntimeError, match="CUDA"):
                harness.main(argv)


def test_serve_and_mesh_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    config = str(ROOT / "examples" / "config_smoke.json")
    for argv in ([], ["-d", "cuda"], ["--context-parallel", "2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_server([config, "--port", "0", *argv])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(context=2)


@pytest.mark.parametrize("argv", [
    ["--data-parallel", "2"],
    ["--data-parallel", "2", "--context-parallel", "2"],
], ids=["data2", "data2-context2"])
def test_serve_options_not_ported_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_server([str(ROOT / "examples" / "config_smoke.json"), "-d", "cpu", "--port", "0",
                      *argv])


def test_serve_quant_int8_serves_on_the_cpu_and_restores_the_mode():
    """``serve --quant int8`` builds an int8 service that answers over HTTP
    (its convs and Dense sites int8, the plain versions on the CPU, no
    kernel launched); shutting it down restores the mode."""
    assert get_conv_quant() == "off"
    launch_counts.clear()
    server, svc = build_server([str(ROOT / "examples" / "config_smoke.json"), "-d", "cpu",
                                "--port", "0", "--buckets", "1", "--quant", "int8"],
                               log=lambda m: None)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert get_conv_quant() == "int8" and svc.quantize == "int8"
        with Int8Sites() as sites:
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=300)
            conn.request("POST", "/generate",
                         body=json.dumps({"conditions": [[1, 0]], "seed": 2}),
                         headers={"Content-Type": "application/json"})
            reply = json.loads(conn.getresponse().read())
            conn.close()
        assert reply.get("shape") == [1, 8, 8, 8, 1], reply
        assert np.isfinite(np.asarray(reply["samples"], np.float32)).all()
        assert sites.kinds().get("conv_int8")
        assert sum(launch_counts.values()) == 0
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(timeout=10)
    assert get_conv_quant() == "off"


def test_kernel_wrappers_raise_off_the_cpu():
    x = torch.empty((1, 4, 4, 4, 8), device="meta")
    w = torch.empty((8, 8, 3, 3, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        conv3d(x, w)
    q = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        ring_attention_fold([q], [q], [0], [q], [q], 1.0)
    with pytest.raises(TypeError):
        conv3d(torch.zeros(1, 4, 4, 4, 8), torch.zeros(8, 8, 3, 3, 3, dtype=torch.float64))


def test_int8_kernel_wrappers_raise_off_the_cpu_and_off_their_range():
    """S1-S3 take no tensor off the CPU and off CUDA, and a raw launch under
    grad mode raises first. The route function raises, naming the shape,
    where neither int8 conv covers a problem; on a CUDA tensor the wrapper
    calls it before any launch."""
    xq = torch.empty((1, 4, 4, 4, 32), dtype=torch.int8, device="meta")
    s = torch.empty((1,), device="meta")
    sw = torch.empty((16,), device="meta")
    w1 = torch.empty((16, 27, 32), dtype=torch.int8, device="meta")
    w2 = torch.empty((27, 8, 16), dtype=torch.int32, device="meta")
    x2 = torch.empty((1, 4, 4, 32), dtype=torch.int8, device="meta")
    w9 = torch.empty((16, 9, 32), dtype=torch.int8, device="meta")
    x1 = torch.empty((1, 64, 32), dtype=torch.int8, device="meta")
    w3 = torch.empty((16, 3, 32), dtype=torch.int8, device="meta")
    for launch in (lambda: conv3d_s8_kernel(xq, s, w1, sw, None),
                   lambda: conv3d_s8_strided_kernel(xq, s, w1, sw, None),
                   lambda: conv2d_s8_kernel(x2, s, w9, sw, None),
                   lambda: conv2d_s8_strided_kernel(x2, s, w9, sw, None),
                   lambda: conv1d_s8_kernel(x1, s, w3, sw, None),
                   lambda: conv1d_s8_strided_kernel(x1, s, w3, sw, None),
                   lambda: conv_s8_general_kernel(xq, s, w2, sw, None, (3, 3, 3), (1, 1, 1),
                                                  [(1, 1)] * 3),
                   lambda: quantize_rows_kernel(torch.empty((2, 8), device="meta"))):
        with pytest.raises(RuntimeError, match="no kernel"):
            launch()
    x = torch.empty((2, 8), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="grad mode"):
        quantize_rows_kernel(x)
    assert int8_conv_route((8, 32, 32, 32, 64), (3, 3, 3), (1, 1, 1), [(1, 1)] * 3, 64) == "s1"
    # the Downsample: S1's block with a strided x map
    assert int8_conv_route((8, 32, 32, 32, 64), (3, 3, 3), (1, 2, 2), [(1, 1)] * 3,
                           64) == "s1_strided"
    assert int8_conv_route((8, 32, 32, 32, 24), (3, 3, 3), (1, 1, 1), [(1, 1)] * 3, 64) == "s2"
    # the 2-D 3x3 convs: S1's block over the 1x3x3 taps, at stride 1 and 2
    assert int8_conv_route((8, 64, 64, 64), (3, 3), (2, 2), [(1, 1)] * 2, 64) == "s1_2d_strided"
    assert int8_conv_route((8, 64, 64, 64), (3, 3), (1, 1), [(1, 1)] * 2, 64) == "s1_2d"
    # the 1-D 3-tap convs: S1's block over the 1x1x3 taps, at stride 1 and 2
    assert int8_conv_route((8, 512, 64), (3,), (2,), [(1, 1)], 64) == "s1_1d_strided"
    # S2 keeps what the TMA routes do not take: Cin % 16 != 0 (also strided,
    # and in 2-D and 1-D), other kernels, strides and pads
    assert int8_conv_route((8, 32, 16, 16, 24), (3, 3, 3), (1, 2, 2), [(1, 1)] * 3, 48) == "s2"
    assert int8_conv_route((8, 64, 64, 24), (3, 3), (1, 1), [(1, 1)] * 2, 64) == "s2"
    assert int8_conv_route((8, 64, 64, 64), (3, 3), (1, 2), [(1, 1)] * 2, 64) == "s2"
    assert int8_conv_route((8, 64, 64, 64), (3, 3), (1, 1), [(0, 2)] * 2, 64) == "s2"
    assert int8_conv_route((8, 512, 64), (3,), (1,), [(1, 1)], 64) == "s1_1d"
    assert int8_conv_route((8, 512, 24), (3,), (1,), [(1, 1)], 64) == "s2"
    assert int8_conv_route((8, 512, 64), (3,), (3,), [(1, 1)], 64) == "s2"
    assert int8_conv_route((8, 32, 32, 32, 64), (3, 3, 3), (2, 2, 2), [(1, 1)] * 3, 64) == "s2"
    assert int8_conv_route((8, 32, 32, 32, 64), (3, 3, 3), (1, 2, 2), [(0, 1)] * 3, 64) == "s2"
    for shape, ksize, stride, pads, cout in (
            ((2, 4, 4, 4, 4, 32), (3,) * 4, (1,) * 4, [(1, 1)] * 4, 32),  # rank 4
            ((1, 8, 8, 8, 8192), (3, 3, 3), (1, 1, 1), [(1, 1)] * 3, 32),  # int32 sum overflow
            ((4096, 64, 64, 64, 64), (3, 3, 3), (1, 1, 1), [(1, 1)] * 3, 64)):  # past int32
        with pytest.raises(ValueError, match=r"no kernel covers it") as info:
            int8_conv_route(shape, ksize, stride, pads, cout)
        assert str(tuple(shape)) in str(info.value)


def test_kernel_entry_points_are_autograd_functions():
    """On the CPU too: the plain route runs the same Functions' backward."""
    x = torch.randn(1, 3, 3, 3, 2, requires_grad=True)
    w = torch.randn(2, 2, 3, 3, 3, requires_grad=True)
    assert type(conv3d(x, w).grad_fn).__name__ == f"{Conv3d.__name__}Backward"
    q = torch.randn(1, 5, 1, 8, requires_grad=True)
    assert type(flash_attention(q, q, q).grad_fn).__name__ == f"{FlashAttention.__name__}Backward"


def test_raw_kernel_launch_under_grad_mode_raises():
    """A launcher reached under grad mode with an input that requires grad
    (a kernel wired in without its autograd Function) raises before it
    launches, on any device; under no_grad the device check comes next."""
    x = torch.empty((1, 4, 4, 4, 8), device="meta", requires_grad=True)
    w = torch.empty((8, 8, 3, 3, 3), device="meta")
    q = torch.empty((1, 16, 2, 32), device="meta", requires_grad=True)
    for launch in (lambda: conv3d_kernel(x, w), lambda: flash_attention_fwd_kernel(q, q, q),
                   lambda: flash_attention_bwd_kernel(q, q, q, q, q[:, :, :, 0], q),
                   lambda: ring_attention_fold([q], [q], [0], [q], [q], 1.0)):
        with pytest.raises(RuntimeError, match="grad mode"):
            launch()
        with torch.no_grad(), pytest.raises(RuntimeError, match="no kernel"):
            launch()


@pytest.mark.parametrize("launch", [
    lambda x, km, p: conv_variant(x, km, "full"),
    lambda x, km, p: conv_variant(x, km, "nopatch"),
    lambda x, km, p: conv_variant(x, km, "nodma"),
    lambda x, km, p: bigdot(x, km, 2),
    lambda x, km, p: dots_only(p, km),
], ids=["full", "nopatch", "nodma", "bigdot", "dotsonly"])
def test_variant_kernels_raise_off_the_cpu_and_under_grad_mode(launch):
    """K7-K9 have no backward: under grad mode an input that requires grad
    raises before any launch; under no_grad a tensor off the CPU and off
    CUDA has no kernel."""
    x = torch.empty((1, 4, 4, 4, 8), device="meta")
    km = torch.empty((216, 8), device="meta")
    p = torch.empty((64, 24), device="meta")
    for grad_input in ("x", "km"):
        args = {"x": x, "km": km, "p": p}
        args[grad_input] = args[grad_input].clone().requires_grad_()
        if grad_input == "x":
            args["p"] = p.clone().requires_grad_()
        with pytest.raises(RuntimeError, match="grad mode"):
            launch(**args)
    with torch.no_grad(), pytest.raises(RuntimeError, match="no kernel"):
        launch(x, km, p)


@pytest.mark.parametrize("entry", [conv3d_variants, conv3d_ab, conv_profile, bench,
                                   conv_int8_probe],
                         ids=["conv3d_variants", "conv3d_ab", "conv_profile", "bench",
                              "conv_int8_probe"])
def test_benchmark_entries_need_cuda_unless_asked_for_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    for argv in ([], ["-d", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.main(argv)


@pytest.mark.parametrize("option", [
    {"fsdp": True}, {"zero1": True}, {"tensor_parallel": True}, {"spatial_sharding": True},
    {"device_cache": True}, {"mesh": {"data": 2, "context": 1}}, {"mesh": {"context": 2}},
], ids=lambda o: next(iter(o)))
def test_unsupported_trainer_options_raise(tmp_path, option):
    """The options that need more than one device raise. ``device_cache``
    (ported, the table on the one device) builds a Trainer, whose cache
    comes up at its first use on the device asked for."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["training"].update(option)
    if option == {"device_cache": True}:
        trainer = Trainer(ExperimentConfig.from_dict(cfg), work_dir=tmp_path, device="cpu")
        assert trainer.config.training.device_cache
        cache = trainer.device_cache
        assert cache.device.type == "cpu" and cache.nbytes == 16 * (8 ** 3 + 256) * 4
        return
    with pytest.raises(NotImplementedError):
        Trainer(ExperimentConfig.from_dict(cfg), work_dir=tmp_path, device="cpu")


def test_device_cache_over_a_data_mesh_raises(tmp_path):
    """``device_cache_shard`` splits the table over a data mesh of several
    cards: the mesh itself raises."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["training"].update(device_cache=True, device_cache_shard=True,
                           mesh={"data": 2, "context": 1})
    with pytest.raises(NotImplementedError, match="more than one device"):
        Trainer(ExperimentConfig.from_dict(cfg), work_dir=tmp_path, device="cpu")


def test_training_profile_and_other_pipelines_raise(tmp_path, monkeypatch):
    """``--profile DIR`` (ported) traces the run into DIR: a chrome trace
    holding the training step's ops. The diffusers pipeline trains one step
    from ``--pipeline``; a pipeline name the port does not know raises."""
    path = ROOT / "examples" / "config_smoke.json"
    state = train_main([str(path), "-d", "cpu", "--work-dir", str(tmp_path / "run"),
                        "--profile", str(tmp_path / "trace")])
    assert state.step == 4
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    # the optimizer's step and the port's conv and attention Functions
    assert {"Optimizer.step#AdamW.step", "Conv3d", "FlashAttention"} <= names
    # GaussianDiffusionPipeline trains (tests/test_torch_evaluate.py), and so
    # does the diffusers pipeline: one CPU step on the smoke config's 16 items
    cfg = json.loads(path.read_text())
    cfg["training"].update(batch_size=16, log_every_n_steps=1)
    cut = tmp_path / "diffusers.json"
    cut.write_text(json.dumps(cfg))
    built = []
    build = trainer_mod.build_pipeline_from_config
    monkeypatch.setattr(trainer_mod, "build_pipeline_from_config",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    state = train_main([str(cut), "-d", "cpu", "--work-dir", str(tmp_path / "diffusers"),
                        "--pipeline", "DiffusersDDPMPipeline", "-e", "1"])
    assert state.step == 1
    assert [type(p).__name__ for p in built] == ["DiffusersDDPMPipeline"]
    with pytest.raises(KeyError, match="unknown pipeline"):
        train_main([str(path), "-d", "cpu", "--work-dir", str(tmp_path), "--pipeline",
                    "NoSuchPipeline"])


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
    q = torch.zeros(1, 8, 1, 8)
    flash_attention(q, q, q)
    context_sharded_attention(q, q, q, make_mesh(context=2, devices=["cpu"] * 2), impl="rdma")
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
    """The dataset paths that raised until the data layer was ported (the
    C++ generator, an HDF5 file that ``to_hdf5`` wrote) now build the
    dataset, and the CLI samples with the config's conditioning."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    if "h5_path" in kwargs:
        kwargs = {"h5_path": str(tmp_path / kwargs["h5_path"])}
        SphericalHarmonicDataset(**cfg["dataset"]["kwargs"]).to_hdf5(kwargs["h5_path"],
                                                                   num_samples=4)
    cfg["dataset"]["kwargs"].update(kwargs)
    cfg["inference"].update(cache_file=None, plot_output_file=None)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    config = ExperimentConfig.from_json(path)
    pipe, dataset, _ = inference.build_inference_session(config, device="cpu")
    assert isinstance(dataset, SphericalHarmonicDataset) and pipe.cond_fn is not None
    samples = inference.main([str(path), "-d", "cpu", "-n", "1", "--work-dir", str(tmp_path)])
    assert samples.shape == (1, 8, 8, 8, 1) and np.isfinite(samples).all()
