"""The conv-phrasing study pieces against the JAX package, on the CPU.

* ``ops.convolution.conv3d_via_2d`` (the ``RHO_CONV3D_VIA_2D=1`` backend)
  against JAX's ``Conv3dVia2d`` on the same weights: the forward at strides
  (1, 1, 1) and (1, 2, 2) within atol 2e-5, and the weight and bias
  gradients of sum(out^2) within 5e-5 (JAX's own bars,
  tests/ops/test_conv3d_via_2d.py); a z-stride of 2 raises; a UNet built
  under the variable (in a child process: it is read at import) sends its
  3x3x3 convs, the (1, 2, 2) Downsample among them, through it and none
  through ``ops.kernels.conv3d``, and its forward matches the default
  backend's; int8 still wins over it (only the two layers int8 leaves
  float take it then).
* ``benchmarks/conv_zfold.py``'s ``zfold_conv`` against the port's, and each
  ``benchmarks/conv_dimnum_sweep.py`` phrasing (its JAX expression) against
  the port's counterpart, in fp32; both entries run with ``-d cpu`` at
  shrunk shapes.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.ops.convolution import Conv3dVia2d
from rho_diffusion_tpu_torch.benchmarks import conv_dimnum_sweep, conv_zfold
from rho_diffusion_tpu_torch.ops import convolution
from rho_diffusion_tpu_torch.ops.convolution import conv3d_via_2d

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def jax_script(name: str):
    """A JAX benchmark script's functions (its body runs under __main__)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def torch_weight(kernel) -> torch.Tensor:
    """flax [kz, kh, kw, Cin, Cout] -> torch [Cout, Cin, kz, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel),
                                                              (4, 3, 0, 1, 2))))


@pytest.mark.parametrize("strides", [(1, 1, 1), (1, 2, 2)])
def test_via_2d_forward_matches_jax(strides):
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 6, 8, 8, 4))
    alt = Conv3dVia2d(features=5, strides=strides)
    p = alt.init(jax.random.PRNGKey(1), x)["params"]
    p = {"kernel": p["kernel"], "bias": p["bias"] + 0.3}
    want = np.asarray(alt.apply({"params": p}, x))
    got = conv3d_via_2d(torch.from_numpy(np.asarray(x)), torch_weight(p["kernel"]),
                        torch.from_numpy(np.asarray(p["bias"])), strides)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_via_2d_gradients_match_jax():
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 4, 8, 8, 2))
    alt = Conv3dVia2d(features=3)
    p = alt.init(jax.random.PRNGKey(1), x)["params"]
    g = jax.grad(lambda pp: jnp.sum(alt.apply({"params": pp}, x) ** 2))(p)
    w = torch_weight(p["kernel"]).requires_grad_(True)
    b = torch.from_numpy(np.asarray(p["bias"])).requires_grad_(True)
    (conv3d_via_2d(torch.from_numpy(np.asarray(x)), w, b) ** 2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), torch_weight(g["kernel"]).numpy(), atol=5e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["bias"]), atol=5e-5)


def test_via_2d_rejects_a_z_stride():
    with pytest.raises(ValueError, match="z-stride"):
        conv3d_via_2d(torch.ones(1, 4, 4, 4, 2), torch.ones(2, 2, 3, 3, 3), None, (2, 1, 1))


CHILD = r"""
import json, sys
import torch
from rho_diffusion_tpu_torch.ops import convolution, quant
from rho_diffusion_tpu_torch.ops.kernels import conv3d as k5
from rho_diffusion_tpu_torch.registry import registry
calls = {"via": [], "k5": 0}
via = convolution.conv3d_via_2d
def spy(x, w, b, stride=(1, 1, 1)):
    calls["via"].append(list(stride))
    return via(x, w, b, stride)
convolution.conv3d_via_2d = spy
real_k5 = convolution.conv3d
def k5_spy(*a, **k):
    calls["k5"] += 1
    return real_k5(*a, **k)
convolution.conv3d = k5_spy
torch.manual_seed(0)
unet = registry.get("models", "UNetv2")(dims=3, in_channels=1, out_channels=1, model_channels=16,
    num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=[], num_heads=1,
    data_shape=(4, 8, 8), dtype="float32")
gen = torch.Generator().manual_seed(3)
for p in unet.parameters():
    p.data = 0.1 * torch.randn(p.shape, generator=gen)
x = torch.randn(2, 4, 8, 8, 1, generator=gen)
t = torch.tensor([3, 7])
with torch.no_grad():
    out = unet(x, t)
    int8_before = list(calls["via"])
    with quant.conv_quant("int8"):
        unet(x, t)
torch.save(out, sys.argv[1])
convs = sum(isinstance(m, convolution.ConvNd) and m.kernel_size == 3 for m in unet.modules())
print(json.dumps({"flag": convolution.CONV3D_VIA_2D, "via": int8_before,
                  "via_after_int8": len(calls["via"]) - len(int8_before), "k5": calls["k5"],
                  "convs": convs}))
"""


@pytest.mark.parametrize("flag", ["1", "0"])
def test_unet_under_the_variable_routes_its_convs_through_via_2d(flag, tmp_path):
    env = dict(os.environ, RHO_CONV3D_VIA_2D=flag, PYTHONPATH=str(ROOT))
    outs = {}
    for name, value in (("chosen", flag), ("default", "0")):
        env["RHO_CONV3D_VIA_2D"] = value
        r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path / f"{name}.pt")], env=env,
                           capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        outs[name] = (json.loads(r.stdout.strip().splitlines()[-1]),
                      torch.load(tmp_path / f"{name}.pt"))
    info, out = outs["chosen"]
    assert info["flag"] is (flag == "1")
    if flag == "1":
        # every 3x3x3 conv of the forward, the Downsample's among them
        assert info["k5"] == 0 and [1, 2, 2] in info["via"]
        assert len(info["via"]) == info["convs"] == 20
        # int8 wins over the study backend: only the two layers int8 leaves
        # float (the Cin 1 input conv, the Cout 1 head) still take it
        assert info["via_after_int8"] == 2
        np.testing.assert_allclose(out.numpy(), outs["default"][1].numpy(), atol=1e-5)
    else:
        assert info["via"] == [] and info["k5"] > 0
    assert convolution.CONV3D_VIA_2D is False  # this process never set it


# ---------------------------------------------------------------------------
# The studies

def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout", [(4, 4), (6, 3)])
def test_zfold_matches_the_jax_scripts(cin, cout):
    jax_zfold = jax_script("conv_zfold")
    x, k = rand((2, 5, 6, 7, cin), 1), rand((3, 3, 3, cin, cout), 2)
    want = np.asarray(jax_zfold.zfold_conv(jnp.asarray(x), jnp.asarray(k)))
    got = conv_zfold.zfold_conv(torch.from_numpy(x), torch_weight(k))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    native = np.asarray(jax_zfold.native_conv(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got.numpy(), native, rtol=1e-5, atol=1e-5)
    assert conv_zfold.LEVEL_SHAPES == jax_zfold.LEVEL_SHAPES
    assert conv_zfold.conv_flops(LEVEL := conv_zfold.LEVEL_SHAPES[0]) == \
        jax_zfold.conv_flops(*LEVEL)


def test_dimnum_phrasings_match_their_jax_expressions():
    """Each phrasing of conv_dimnum_sweep.py (its lines, evaluated here on
    one input) against the port's function of the same name."""
    sweep = jax_script("conv_dimnum_sweep")
    assert {k: v for k, v in conv_dimnum_sweep.LEVELS.items()} == sweep.LEVELS
    b, d, h, w, c = 2, 4, 5, 6, 3
    x, k = rand((b, d, h, w, c), 3), rand((3, 3, 3, c, c), 4)
    jx, jk = jnp.asarray(x), jnp.asarray(k)

    def conv(xx, kk, numbers=("NDHWC", "DHWIO", "NDHWC")):
        return jax.lax.conv_general_dilated(xx, kk, (1, 1, 1), "SAME", dimension_numbers=numbers)

    kf = jnp.flip(jk, (0, 1, 2)).swapaxes(3, 4)
    _, vjp = jax.vjp(lambda xx: conv(xx, jk), jx)
    x_nc = jnp.moveaxis(jx, -1, 1)
    k_oi = jnp.transpose(jk, (4, 3, 0, 1, 2))
    want = {
        "DHWIO": conv(jx, jk),
        "flip+OI (dgrad form)": conv(jx, kf, ("NDHWC", "DHWOI", "NDHWC")),
        "dgrad (autograd)": vjp(jx)[0],
        "NCDHW/OIDHW": conv(x_nc, k_oi, ("NCDHW", "OIDHW", "NCDHW")),
        "fold B into D": conv(jx.reshape(1, b * d, h, w, c), jk),
        "k5": conv(jx, jk),
    }
    tx = torch.from_numpy(x)
    for name, (f, channels_first) in conv_dimnum_sweep.phrasings(torch_weight(k)).items():
        arg = tx.movedim(-1, 1).contiguous() if channels_first else (
            tx.reshape(1, b * d, h, w, c) if name == "fold B into D" else tx)
        np.testing.assert_allclose(f(arg).numpy(), np.asarray(want[name]), atol=2e-5,
                                   err_msg=name)


def test_study_entries_run_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(conv_zfold, "LEVEL_SHAPES", [(2, 4, 6, 6, 8, 8), (2, 4, 6, 6, 16, 8)])
    rows = conv_zfold.main(["-d", "cpu", "1"])
    assert len(rows) == 1 and set(rows[0]["rows"]) == {"k5", "cudnn", "zfold", "via2d"}
    assert all(r["max_abs_err_vs_k5"] < 0.05 and r["fwd_peak_share"] is None
               for r in rows[0]["rows"].values())
    monkeypatch.setitem(conv_dimnum_sweep.LEVELS, "1", (2, 4, 6, 6, 8))
    sweep = conv_dimnum_sweep.main(["-d", "cpu"])
    assert [r["name"] for r in sweep] == list(conv_dimnum_sweep.phrasings(
        torch.zeros(8, 8, 3, 3, 3)))
    out = capsys.readouterr().out
    assert out.startswith("device=cpu") and "level=1" in out
