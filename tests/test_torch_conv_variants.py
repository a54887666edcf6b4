"""The conv's bottleneck-isolation kernels (K7-K9) against the JAX package's.

The JAX kernels live in ``benchmarks/conv3d_variants.py``, a script: it is
loaded unedited from its file, its ``pl`` is given ``pallas_call`` in
interpret mode (the TPU kernels' DMA, scratch and dots then run on the CPU),
and its module constants are shrunk. On the same numpy inputs, in fp32, the
port's K7 ``full``/``nopatch``, K8 (td 1 and 2) and K9 (the wrappers take
their plain versions for CPU tensors) match them at atol = rtol = 1e-4, the
JAX conv test's fp32 tolerance (tests/ops/test_conv3d_pallas.py). K7
``nodma`` is held against its own definition, and the dense GEMM's plan
(``dense_plan``) at the study's shapes. The port's benchmark entries run
here with ``-d cpu`` at shrunk shapes.
"""
import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rho_diffusion_tpu_torch.benchmarks import conv3d_ab, conv_profile
from rho_diffusion_tpu_torch.benchmarks import conv3d_variants as port_bench
from rho_diffusion_tpu_torch.benchmarks._timing import per_call_ms
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import SMEM_LIMIT, conv3d_plain, igemm_plan
from rho_diffusion_tpu_torch.ops.kernels.conv3d_variants import (
    bigdot, conv_variant, dense_plan, dots_only, nodma_pattern)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
# B, D, H, W, CIN, COUT; TD, TC; CPAD = 3 * CIN
SHRUNK = dict(B=2, D=8, H=4, W=4, CIN=8, COUT=8, TD=4, TC=8, CPAD=24)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_conv3d_variants", ROOT / "benchmarks" / "conv3d_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interpret = types.SimpleNamespace(**vars(pl))
    interpret.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interpret
    for name, value in SHRUNK.items():
        setattr(mod, name, value)
    mod.M = mod.TD * mod.H * mod.W
    return mod


def conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    s = SHRUNK
    x = rng.standard_normal((s["B"], s["D"], s["H"], s["W"], s["CIN"])).astype(np.float32)
    km = (0.2 * rng.standard_normal((9 * s["CPAD"], s["COUT"]))).astype(np.float32)
    return x, km


@pytest.mark.parametrize("variant", ["full", "nopatch"])
def test_conv_variant_matches_jax(jax_script, variant):
    x, km = conv_inputs()
    want = np.asarray(jax_script.make_conv(variant)(jnp.asarray(x), jnp.asarray(km)))
    got = conv_variant(torch.from_numpy(x), torch.from_numpy(km), variant)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("td", [1, 2])
def test_bigdot_matches_jax(jax_script, td):
    x, km = conv_inputs(1)
    want = np.asarray(jax_script.make_bigdot(td)(jnp.asarray(x), jnp.asarray(km)))
    got = bigdot(torch.from_numpy(x), torch.from_numpy(km), td)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_dots_only_matches_jax(jax_script):
    s = SHRUNK
    rng = np.random.default_rng(2)
    p = rng.standard_normal((s["B"] * (s["D"] // s["TD"]) * jax_script.M, s["CPAD"]))
    p = p.astype(np.float32)
    km = (0.2 * rng.standard_normal((9 * s["CPAD"], s["COUT"]))).astype(np.float32)
    want = np.asarray(jax_script.dots_only()(jnp.asarray(p), jnp.asarray(km)))
    got = dots_only(torch.from_numpy(p), torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), atol=TOL, rtol=TOL)


def test_full_variant_is_the_conv():
    """km [9*CPAD, Cout] is the DHWIO kernel flattened: ``full`` is the
    port's K5 conv with that kernel in torch layout."""
    x, km = conv_inputs(3)
    s = SHRUNK
    weight = torch.from_numpy(km).reshape(3, 3, 3, s["CIN"], s["COUT"]).permute(4, 3, 0, 1, 2)
    torch.testing.assert_close(conv_variant(torch.from_numpy(x), torch.from_numpy(km), "full"),
                               conv3d_plain(torch.from_numpy(x), weight), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape,cout", [
    ((1, 2, 4, 32, 128), 5),  # boxes of 128 consecutive voxels (32 x 4 x 1), Cin = 128
    ((1, 3, 5, 7, 24), 10),   # boxes 8 x 8 x 2 over a ragged volume, Cin = 24
], ids=["box-contiguous-cin128", "box-ragged-cin24"])
def test_nodma_is_the_pattern_product(shape, cout):
    """Not held against JAX: its ``nodma`` kernel reads uninitialised VMEM
    scratch, so its output is undefined (in interpret mode not even finite).
    The port's kernel (K5's block with A's loads dropped) holds
    f(r, c) = ((7r + 3c) mod 17 - 8)/64 in every ring stage, r the row in
    the block's box of 128 voxels (w fastest, then h, then d, sides from
    ``igemm_plan``) and c the channel in the 64-channel k-step, for every
    tap; the weights zero-fill channels past Cin. So out[v, n] =
    sum_tap sum_ci f(r(v), ci mod 64) km[tap*Cin + ci, n], computed here in
    numpy from the plan's box alone."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cin = shape[-1]
    km = torch.from_numpy(rng.standard_normal((27 * cin, cout)).astype(np.float32))
    plan = igemm_plan(shape, cout)
    assert plan.bw * plan.bh * plan.bd == 128
    _, d, h, w, _ = shape
    dd, hh, ww = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    r = ((dd % plan.bd) * plan.bh + hh % plan.bh) * plan.bw + ww % plan.bw
    c = np.arange(cin) % 64
    f = ((7 * r.reshape(-1, 1) + 3 * c[None, :]) % 17 - 8) / 64.0
    taps = km.numpy().astype(np.float64).reshape(27, cin, cout)
    want = np.einsum("vc,tcn->vn", f, taps).reshape(*shape[:-1], cout)
    got = conv_variant(x, km, "nodma")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert torch.equal(conv_variant(2 * x, km, "nodma"), got)  # x is never read
    pattern = nodma_pattern(shape, cout)
    assert pattern.shape == (int(np.prod(shape[:-1])), cin)
    assert torch.equal(pattern.bfloat16().float(), pattern)  # exact in bf16


@pytest.mark.parametrize("name,rows,batches,bn", [
    ("bigdot1", 1 * 16 * 16, 32, 64),      # 64 row tiles: two N tiles of 64 fill 128 SMs
    ("bigdot2", 2 * 16 * 16, 32, 128),
    ("bigdot4", 4 * 16 * 16, 32, 128),
    ("bigdot8", 8 * 16 * 16, 32, 128),
    ("dotsonly", 32 * 32 * 16 * 16, 1, 128),
])
def test_dense_plan_at_the_level1_shape(name, rows, batches, bn):
    """The dense GEMM's N tile at the study's shapes (Cout = 128) on the
    H100's 132 SMs: K5's cost rule (waves of blocks x (bn + 128)) takes
    one tile of 128 unless the row tiles leave most of the card idle
    (bigdot1). The ring fits in shared memory; the tiles cover Cout."""
    plan = dense_plan(rows, batches, 128, sms=132)
    assert plan.bn == bn
    assert plan.smem_bytes() <= SMEM_LIMIT and -(-128 // plan.bn) * plan.bn >= 128
    # the cost rule, written out: waves of 132 blocks times the k-step's rows of 128 bytes
    cost = {b: -(-batches * -(-rows // 128) * -(-128 // b) // 132) * (b + 128) for b in (64, 128)}
    assert cost[bn] == min(cost.values())


@pytest.mark.parametrize("cout,bn", [(10, 64), (72, 128), (192, 192), (384, 192), (1024, 256)])
def test_dense_plan_covers_cout_with_the_fewest_tiles(cout, bn):
    """With the card full of row tiles (4096 blocks), the fewest N tiles
    of at most 256 channels win: one up to 256, two of 192 for 384."""
    plan = dense_plan(4096 * 128, 1, cout, sms=132)
    assert plan.bn == bn and plan.bn % 64 == 0 and plan.bn * -(-cout // plan.bn) >= cout


@pytest.mark.parametrize("call,error", [
    (lambda x, km: conv_variant(x, km[:-1], "full"), ValueError),        # CPAD != 3*Cin
    (lambda x, km: conv_variant(x, km, "halo"), ValueError),             # no such variant
    (lambda x, km: conv_variant(x, km.double(), "full"), TypeError),
    (lambda x, km: bigdot(x, km, 3), ValueError),                        # td does not divide D
    (lambda x, km: bigdot(x, km, 0), ValueError),
    (lambda x, km: dots_only(x.reshape(-1, 8), km), ValueError),  # km rows != 9*CPAD
], ids=["cpad", "variant", "dtype", "td3", "td0", "dots-km"])
def test_wrappers_reject_what_the_functions_do_not_take(call, error):
    x, km = (torch.from_numpy(a) for a in conv_inputs())
    with pytest.raises(error):
        call(x, km)


def test_cpu_calls_take_the_plain_versions_and_count_nothing():
    x, km = (torch.from_numpy(a) for a in conv_inputs())
    launch_counts.clear()
    for v in ("full", "nopatch", "nodma"):
        conv_variant(x, km, v)
    bigdot(x, km, 2)
    dots_only(x.reshape(-1, 8), km[:72])
    assert sum(launch_counts.values()) == 0


def test_variants_entry_runs_on_cpu(monkeypatch, capsys):
    for name, value in SHRUNK.items():
        monkeypatch.setattr(port_bench, name, value)
    rows = port_bench.main(["-d", "cpu", "full", "nopatch", "nodma", "dotsonly", "bigdot2",
                            "bigdot"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "989 TF/s" not in out
    assert [r["variant"] for r in rows] == ["full", "nopatch", "nodma", "dotsonly", "bigdot2",
                                            "bigdot"]
    for r in rows:
        assert r["ms"] > 0 and r["tflops"] is None and r["kernels_ms"] is None
        assert f"{r['variant']:>9}: " in out
    assert rows[-1]["kernels"] == ["conv3d_bigdot_im2col", "conv3d_bigdot_gemm"]
    with pytest.raises(ValueError, match="unknown variant"):
        port_bench.main(["-d", "cpu", "bigdotx"])


def test_conv3d_ab_entry_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(conv3d_ab, "SHAPES", [(1, 4, 4, 4, 8, 8), (1, 4, 4, 4, 16, 8)])
    rows = conv3d_ab.main(["-d", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == 2 and "F.conv3d" in out and "maxerr" in out
    for r in rows:
        assert r["k5_ms"] > 0 and r["library_ms"] > 0 and r["k5_tflops"] is None
        assert r["rel"] < 2e-2  # the plain bf16 conv against the library's, rounding only
    assert len(conv3d_ab.main(["-d", "cpu", "1"])) == 1


def test_conv_profile_entry_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(conv_profile, "LEVEL_SHAPES", [(1, 4, 4, 4, 8, 8), (1, 4, 4, 4, 16, 8)])
    monkeypatch.setattr(conv_profile, "MATMUL_SHAPES", [(128, 216, 8), (64, 32, 64)])
    res = conv_profile.main(["-d", "cpu"])
    out = capsys.readouterr().out
    assert len(res["convs"]) == 2 and len(res["matmuls"]) == 2
    assert "fwd+dgrad" in out and "matmul 128x216x8" in out
    for r in res["convs"]:
        assert all(r[f"{n}_{k}_ms"] > 0 for n in ("k5", "library") for k in ("fwd", "fwdbwd"))


def test_per_call_device_time_scales_the_recorded_launches():
    """The profiler can miss launches (on the card one run recorded 5 of 10
    launches of one kernel): a call's device time is the recorded launches'
    mean duration times the launches one call makes, not their sum over the
    calls."""
    by_name = {"void (anonymous namespace)::conv3d_variant_full_kernel(...)": (6.0, 5),
               "conv3d_variant_full_kernel, another instance": (2.0, 3),
               "conv3d_bigdot_gemm_kernel": (9.0, 3)}
    assert per_call_ms(by_name, "conv3d_variant_full", 1) == (1.0, 8)
    assert per_call_ms(by_name, "conv3d_bigdot_gemm", 8) == (24.0, 3)
    assert per_call_ms(by_name, "conv3d_dotsonly", 1) == (None, 0)


def test_device_ms_counts_the_launches_of_one_call(monkeypatch):
    """``device_ms`` scales by the launches of one (warm-up) call, not by
    those of the profiled calls too."""
    from rho_diffusion_tpu_torch.benchmarks import _timing

    def fn():
        launch_counts["conv3d_bigdot_im2col"] += 2
        launch_counts["conv3d_bigdot_gemm"] += 2

    # 10 profiled calls, of which the profiler recorded 15 and 20 launches
    events = {"conv3d_bigdot_im2col_kernel": (15.0, 15), "conv3d_bigdot_gemm_kernel": (60.0, 20)}
    monkeypatch.setattr(_timing, "kernel_events", lambda f, iters: [f() for _ in range(iters)]
                        and events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    names = ("conv3d_bigdot_im2col", "conv3d_bigdot_gemm")
    assert _timing.device_ms(fn, names) == 2 * 1.0 + 2 * 3.0
    assert _timing.device_ms(fn, ("conv3d_dotsonly",)) is None
