"""Weight interop of the port's checkpoints with the JAX package's, on the CPU.

* ``load_weights_auto`` on a JAX ``.npz`` gives the weights the JAX
  package's ``load_weights_auto`` gives on the same file (through the JAX
  package's own ``export_unet_state_dict``), bitwise; a reference ``.pth``
  loads as it is; a config without the architecture keys, a weight the
  model lacks, one it cannot place and a wrong shape raise with the JAX
  package's messages; a diffusers ``UNet2DModel`` layout loads into a
  ``UNet_Diffuser`` model and raises under UNetv2, naming UNet_Diffuser.
* Orbax: the JAX package's ``CheckpointManager`` writes a TrainState into
  a directory, and the test shows why numpy and the standard library alone
  cannot read it: no array is stored raw, the chunks are zstd frames (OCDBT
  nodes around them), and none of the standard library's decompressors
  takes a zstd frame. The port's inference session on that directory says
  so and names ``model.npz``; the ``model.npz`` the JAX trainer writes
  beside it loads into the port bitwise.
* The mlflow logger raises ImportError naming the package where it is
  absent.
"""
import bz2
import gzip
import json
import lzma
import os
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.config import ExperimentConfig as JaxExperimentConfig
from rho_diffusion_tpu.data import SphericalHarmonicDataset as JaxSphericalHarmonicDataset
from rho_diffusion_tpu.interop.torch_weights import (
    export_unet_state_dict as jax_export_unet_state_dict,
)
from rho_diffusion_tpu.models.unet import UNet as JaxUNet
from rho_diffusion_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from rho_diffusion_tpu.training.checkpoint import load_weights_auto as jax_load_weights_auto
from rho_diffusion_tpu.training.checkpoint import save_model_weights as jax_save_model_weights
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build_pipeline
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs
from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.models.unet_diffusers_compat import UNetDiffuser
from rho_diffusion_tpu_torch.training.checkpoint import load_model_weights, load_weights_auto
from rho_diffusion_tpu_torch.training.loggers import build_loggers
from test_torch_hf_unet_weights import hf_mirror

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "examples" / "config_smoke.json"
KW = dict(dims=3, data_shape=(4, 8, 8), in_channels=1, out_channels=1, model_channels=16,
          num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=[2], num_heads=2,
          num_classes=20, use_scale_shift_norm=True)
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def jax_params(seed=0):
    x = jnp.zeros((1, *KW["data_shape"], 1))
    y = jnp.zeros((1, 4 * KW["model_channels"]))
    t = jnp.zeros((1,), jnp.int32)
    params = jax.jit(JaxUNet(**KW).init)(jax.random.PRNGKey(seed), x, t, y)
    rng = np.random.default_rng(seed)  # no zero-initialised leaf
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(size=p.shape).astype(np.float32),
        params["params"])


def test_npz_matches_jax_load_weights_auto(tmp_path):
    params = jax_params()
    path = tmp_path / "model.npz"
    jax_save_model_weights(params, path)
    template = jax.tree_util.tree_map(np.zeros_like, params)
    want = jax_export_unet_state_dict(jax.tree_util.tree_map(
        np.asarray, jax_load_weights_auto(template, path)), **arch_kwargs(KW))
    model = UNet(**KW)
    got = load_weights_auto(model, path, KW)
    assert list(got) == list(model.state_dict())
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    model.load_state_dict(got, strict=True)
    # load_model_weights is the .npz path itself; a missing weight raises
    assert all(torch.equal(got[k], v) for k, v in load_model_weights(model, path, KW).items())
    with pytest.raises(KeyError, match="missing from"):
        load_model_weights({**model.state_dict(), "extra.weight": torch.zeros(1)}, path, KW)


def test_pth_loads_and_is_checked_both_ways(tmp_path):
    model = UNet(**KW)
    sd = {k: v + 1.0 for k, v in model.state_dict().items()}
    path = tmp_path / "model.pth"
    torch.save(sd, path)
    got = load_weights_auto(model, path, KW)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    # the architecture keys the JAX transplant needs: the same message
    with pytest.raises(ValueError) as ours:
        load_weights_auto(model, path, {"dims": 3})
    with pytest.raises(ValueError) as theirs:
        jax_load_weights_auto(jax_params(), path, {"dims": 3})
    assert str(ours.value) == str(theirs.value)
    assert "model_channels and num_res_blocks" in str(ours.value)
    # a weight the config cannot place (a conditioning block it omits)
    torch.save({**sd, "cond_fn.embed.weight": torch.zeros(3, 64)}, path)
    with pytest.raises(KeyError, match="cannot place.*cond_fn"):
        load_weights_auto(model, path, KW)
    missing = dict(sd)
    missing.pop("out.2.bias")
    torch.save(missing, path)
    with pytest.raises(KeyError, match="transplant missing weight 'out.2.bias'"):
        load_weights_auto(model, path, KW)
    torch.save({**sd, "out.2.bias": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="shape mismatch for 'out.2.bias'"):
        load_weights_auto(model, path, KW)


def test_diffusers_layout_raises_naming_item_9(tmp_path):
    """A UNet2DModel-layout .pth (ROADMAP Queue 1 item 9b's mapping) raises
    under UNetv2, naming UNet_Diffuser, and loads under UNet_Diffuser."""
    path = tmp_path / "unet2d.pth"
    torch.save({"down_blocks.0.resnets.0.conv1.weight": torch.zeros(4, 4, 3, 3)}, path)
    with pytest.raises(ValueError, match="UNet2DModel.*UNet_Diffuser"):
        load_weights_auto(UNet(**KW), path, KW)
    mirror = hf_mirror(seed=3)
    torch.save(mirror.state_dict(), path)
    kw = {"data_shape": [16, 16], "in_channels": 1, "num_res_blocks": 2}
    model = UNetDiffuser(**kw)
    sd = load_weights_auto(model, path, kw, "UNet_Diffuser")
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    with pytest.raises(ValueError, match="UNet_Diffuser"):
        load_weights_auto(UNet(**KW), path, KW)


@pytest.fixture(scope="module")
def orbax_run(tmp_path_factory):
    """The JAX package's smoke pipeline: its TrainState saved by its orbax
    CheckpointManager, and its model.npz beside."""
    work = tmp_path_factory.mktemp("jax_run")
    jconfig = JaxExperimentConfig.from_json(SMOKE)
    dataset = JaxSphericalHarmonicDataset(**jconfig.dataset.kwargs)
    jpipe = jax_build_pipeline(jconfig, dataset=dataset)
    state = jpipe.create_state(jax.random.PRNGKey(0))
    manager = JaxCheckpointManager(work / "checkpoints")
    manager.save(state, step=4, wait=True)
    manager.close()
    jax_save_model_weights(state.params, work / "model.npz")
    return work, jax.tree_util.tree_map(np.asarray, state.params)


def test_orbax_directory_is_not_readable_by_numpy(orbax_run):
    work, params = orbax_run
    step = work / "checkpoints" / "4"
    files = [Path(r) / f for r, _, fs in os.walk(step) for f in fs]
    blobs = {f: f.read_bytes() for f in files}
    # no array's bytes are stored as they are (arrays of one repeated value,
    # the norms' scales and the zero-initialised heads, left out: their bytes
    # are no evidence)
    leaves = [v for v in jax.tree_util.tree_leaves(params) if v.size >= 16 and v.std() > 0]
    assert leaves
    for leaf in leaves:
        raw = np.ascontiguousarray(leaf).tobytes()[:64]
        assert not any(raw in blob for blob in blobs.values())
    # OCDBT: its manifests and B-tree nodes, and the data files' zstd frames
    data = [b for f, b in blobs.items() if f.parent.name == "d"]
    assert any(f.name == "manifest.ocdbt" for f in files)
    assert any(b.startswith(ZSTD_MAGIC) for b in data)
    frame = next(b for b in data if b.startswith(ZSTD_MAGIC))
    for decompress in (zlib.decompress, gzip.decompress, bz2.decompress, lzma.decompress):
        with pytest.raises(Exception):
            decompress(frame)


def test_inference_names_model_npz_and_reads_it(orbax_run):
    work, params = orbax_run
    config = ExperimentConfig.from_dict(json.loads(SMOKE.read_text()))
    _, _, messages = inference.build_inference_session(
        config, checkpoint=work / "checkpoints", work_dir=work, device="cpu")
    assert "orbax" in messages[-1] and "untrained" in messages[-1]
    assert "model.npz" in messages[-1]
    pipe, _, messages = inference.build_inference_session(
        config, checkpoint=work / "model.npz", work_dir=work, device="cpu")
    assert messages[-1] == f"loaded weights from {work / 'model.npz'}"
    want = jax_export_unet_state_dict(params, **arch_kwargs(dict(config.model.kwargs)))
    got = pipe.backbone.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_mlflow_logger_raises_import_error_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mlflow", None)
    with pytest.raises(ImportError, match="'mlflow' package"):
        build_loggers(["mlflow"], tmp_path)
