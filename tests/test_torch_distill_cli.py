"""``python -m rho_diffusion_tpu_torch.distill`` on the CPU.

On ``examples/config_learned_variance.json`` cut to CPU size (8^3, two
levels, width 64 for its 256-wide sha512 labels, T 20, 8 items), given the
flagship's parameter space for sampling, with ``-d cpu``:

* the CLI cascades 8 -> 4 -> 2 from a port ``.pth`` teacher and writes the
  student ``.pth`` (and a sample grid); the inference CLI reads it with
  ``--sampler ddim --steps 2 --spacing trailing`` and its sample is the
  distiller's own ``sample`` from the same x_T;
* a JAX ``.npz`` of the same teacher (the JAX package's
  ``save_model_weights``) gives the same student, bitwise;
* a DDPM config and a config whose dataset cannot be built are refused
  with the JAX script's messages.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import random_state_dict
from rho_diffusion_tpu.interop.torch_weights import transplant_unet_state_dict
from rho_diffusion_tpu.training.checkpoint import save_model_weights as jax_save_model_weights
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion.distill import ProgressiveDistiller
from rho_diffusion_tpu_torch.distill import main as distill_main
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def lv_config(tmp_path) -> Path:
    cfg = json.loads((ROOT / "examples" / "config_learned_variance.json").read_text())
    cfg["model"]["kwargs"].update(data_shape=[8, 8, 8], num_res_blocks=1, channel_mult=[1, 2],
                                  attention_resolutions=[2], num_heads=2)
    cfg["dataset"]["kwargs"].update(grid_el=8, length=8)
    cfg["noise_schedule"]["kwargs"].update(num_steps=20, beta_1=2e-4, beta_T=1e-2)
    cfg["training"].update(dtype="float32", batch_size=4)
    space = json.loads((ROOT / "examples" / "config_spherical_harmonics.json").read_text())
    cfg["inference"].update(cache_file=None, plot_output_file=None, num_samples=2,
                            parameter_space=space["inference"]["parameter_space"])
    path = tmp_path / "lv.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """The cut config, and its seeded random weights as a port .pth and as
    the JAX package's .npz."""
    tmp = tmp_path_factory.mktemp("distill_cli")
    path = lv_config(tmp)
    cfg = ExperimentConfig.from_json(path)
    pipe = build_pipeline_from_config(cfg, device="cpu")
    sd = random_state_dict(pipe.backbone, 5)
    torch.save(sd, tmp / "teacher.pth")
    kw = {k: v for k, v in arch_kwargs(cfg.model.kwargs).items() if k != "dims"}
    jax_save_model_weights(transplant_unet_state_dict({k: v.numpy() for k, v in sd.items()},
                                                      **kw), tmp / "teacher.npz")
    return tmp, path


def run(path, teacher_file, out, *extra):
    return distill_main([str(path), "-p", str(teacher_file), "-d", "cpu", "--from", "8", "--to",
                         "2", "--updates", "2", "--lr", "1e-3", "-o", str(out), "--seed", "3",
                         *extra])


def test_distill_then_trailing_inference(teacher, capsys):
    tmp, path = teacher
    student_file, grid = tmp / "student.pth", tmp / "grid.png"
    student, info = run(path, tmp / "teacher.pth", student_file, "--sample-output", str(grid))
    out = capsys.readouterr().out
    assert "stage 8->4" in out and "stage 4->2" in out and f"wrote {student_file}" in out
    assert list(info) == ["8->4", "4->2"] and np.isfinite(sum(info.values(), [])).all()
    assert student_file.exists() and grid.exists() and "finite=True" in out
    saved = torch.load(student_file, weights_only=True)
    assert set(saved) == set(student.state_dict())
    assert any(not torch.equal(saved[k], v) for k, v in torch.load(
        tmp / "teacher.pth", weights_only=True).items())

    samples = inference.main([str(path), "-p", str(student_file), "-d", "cpu", "--sampler",
                              "ddim", "--steps", "2", "--spacing", "trailing", "-f"])
    assert samples.shape == (2, 8, 8, 8, 1) and np.isfinite(samples).all()
    config = ExperimentConfig.from_json(path)
    pipe, _, _ = inference.build_inference_session(config, checkpoint=student_file,
                                                   device="cpu")
    conds = pipe.conditions_from_parameter_space(config.inference.parameter_space, 2,
                                                 random=False, as_hash_embeddings=True,
                                                 embedding_dim=pipe.condition_embedding_dim())
    x_T = torch.randn((2, 8, 8, 8, 1),
                      generator=torch.Generator().manual_seed(config.inference.seed))
    want = ProgressiveDistiller(pipe).sample(pipe.backbone, (2, 8, 8, 8, 1), 2, conditions=conds,
                                             x_T=x_T)
    np.testing.assert_array_equal(samples, want.numpy())


def test_jax_npz_teacher_gives_the_same_student(teacher, capsys):
    tmp, path = teacher
    from_pth, _ = run(path, tmp / "teacher.pth", tmp / "a.pth")
    from_npz, _ = run(path, tmp / "teacher.npz", tmp / "b.pth")
    assert f"loaded weights from {tmp / 'teacher.npz'}" in capsys.readouterr().out
    for (k, a), b in zip(from_pth.state_dict().items(), from_npz.state_dict().values()):
        assert torch.equal(a, b), k


def test_ddpm_and_datasetless_configs_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="distillation needs the GaussianDiffusion pipeline "
                                         "family .*got DDPM"):
        distill_main([str(ROOT / "examples" / "config_smoke.json"), "-d", "cpu",
                      "--work-dir", str(tmp_path)])
    cfg = json.loads((ROOT / "examples" / "config_deep_galaxy.json").read_text())
    cfg["dataset"]["kwargs"]["path"] = str(tmp_path / "absent.h5")
    cfg["pipeline"] = {"name": "GaussianDiffusionPipeline", "kwargs": {}}
    cfg["model"]["kwargs"].update(data_shape=[16, 16], num_res_blocks=1)
    path = tmp_path / "galaxy.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="the configured dataset could not be constructed"):
        distill_main([str(path), "-d", "cpu", "--work-dir", str(tmp_path)])
