#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phases env,build,kernels,main,hold,timings]
                          [--steps 25] [--samples 4] [--timing-batch 8]

Builds the port's CUDA kernels from ``rho_diffusion_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes the flagship UNet gives
it, drives the flagship sampling path (``examples/config_spherical_harmonics
.json`` at full width, random seeded weights loaded from a reference-layout
``.pth``) through ``rho_diffusion_tpu_torch.inference.main``, checks that the
path launched every kernel, holds one full-width UNet forward on the kernels
against the same forward on the plain versions, and times each kernel
against its plain version, a PyTorch library call and its bound, one UNet
forward (with a torch.profiler breakdown by kernel) and the whole reverse
process. Every phase
prints one JSON line; a failing phase exits non-zero. The last line is
``{"ok": true, "device": {...}}``, after the ``kernels`` line and the card's
``nvidia-smi`` name and power limit. A run whose ``--phases`` leave out any
of kernels, main and timings prints neither and exits 3.

Exits non-zero without a result when CUDA is unavailable or the script runs
outside a checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "examples" / "config_spherical_harmonics.json"
PHASES = ("env", "build", "kernels", "main", "hold", "timings")
# the phases whose numbers the kernels line carries
KERNELS_LINE_PHASES = ("kernels", "main", "timings")
DEVICE = "cuda"

# The card's published dense peaks (H100 SXM data sheet) and memory rate.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
MEM_RATE = 3.35e12

# Tolerances of a kernel against its plain version on the same inputs. The
# plain versions run in fp32 with TF32 off. The JAX package's own kernel
# tests hold fp32 at 1e-4 (conv, tests/ops/test_conv3d_pallas.py) and 2e-5
# (flash, tests/ops/test_flash_attention.py), and bf16 conv at 0.05.
# bf16 conv: bf16 products are exact in the fp32 accumulator, so the kernel
# differs from the plain sum only by summation order and by rounding its
# output to bf16 (half an ulp, at most 2^-8 relative): atol = rtol = 2^-6
# leaves four times that at the O(1) outputs of these inputs.
TOL_CONV_BF16 = 2.0 ** -6
TOL_CONV_FP32 = 1e-4
# flash: an output row is a softmax average over ~T/e keys, so its values
# are small (rms ~1/sqrt(T): 0.07 at T=512, 0.026 at T=4096) and a fixed atol
# would hide a wrong kernel. Both bounds scale with the reference:
#   every element  |got - want| <= tol * max|want|
#   the whole      rms(got - want) / rms(want) <= tol
# bf16: P is cast to bf16 before P.V (as in the TPU kernel) and the output is
# rounded to bf16, each a relative error of at most the unit roundoff 2^-8,
# so tol = 2^-7. A kernel that dropped one 64-key tile at T=4096 would be
# about 10% off in rms. fp32 (FMA, no TF32): the JAX tests' fp32 2e-5.
TOL_FLASH = {"bfloat16": 2.0 ** -7, "float32": 2e-5}
# The kernels inside the model, against the fp32 plain model: one
# full-width forward (batch 4) and a whole 25-step reverse process (batch 2,
# one x_T, one noise seed). bf16 alone moves the result away from fp32: the
# forward by ~2e-4 relative MSE, the sample by ~0.09, because the 25-step cut
# of the schedule multiplies each step's difference by up to
# 1/sqrt(alpha_t) ~ 2.2. So the bar is relative: the kernel model may be at
# most HOLD_FACTOR times as far from fp32 as the same bf16 model on the plain
# versions, and never further than HOLD_CAP, well below the O(1) of a wrong
# kernel.
HOLD_FACTOR = 3.0
HOLD_CAP = {"forward": 1e-2, "sample": 0.5}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_mem = flops / peak, nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------------

def flagship_config(steps: int) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["noise_schedule"]["kwargs"]["num_steps"] = steps
    cfg["inference"]["cache_file"] = None
    cfg["inference"]["plot_output_file"] = None
    cfg["inference"]["checkpoint"] = None
    return cfg


def random_state_dict(model, seed: int):
    """Every parameter from a seeded generator, small and nonzero: weights
    N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1 + N(0, 0.02^2), so the
    zero-init heads and projections carry every kernel's output into the
    sample."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        noise = torch.randn(p.shape, generator=gen)
        if name.endswith("bias"):
            sd[name] = 0.02 * noise
        elif p.dim() == 1:  # GroupNorm scale
            sd[name] = 1.0 + 0.02 * noise
        elif "embedding_layers" in name:
            sd[name] = noise / math.sqrt(p.shape[-1])
        else:
            sd[name] = noise / math.sqrt(p[0].numel())
    return sd


def build_pipeline(cfg: dict, dtype, device):
    """The flagship DDPM pipeline as the inference entry builds it."""
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
    from rho_diffusion_tpu_torch.inference import build_pipeline_from_config

    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    config.model.kwargs["dtype"] = dtype
    dataset = SphericalHarmonicDataset(**config.dataset.kwargs)
    return build_pipeline_from_config(config, dataset=dataset, device=device)


def build_unet(cfg: dict, dtype, device, seed: int = 0):
    """The flagship UNet with ``random_state_dict(seed)`` weights."""
    unet = build_pipeline(cfg, dtype, device).backbone
    unet.load_state_dict(random_state_dict(unet, seed))
    return unet


class CallRecorder:
    """Records the shapes a module-level kernel wrapper is called with."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.calls: list[tuple] = []

    def __enter__(self):
        def wrapped(*args):
            self.calls.append(tuple((tuple(a.shape), a.dtype) if a is not None else None
                                    for a in args))
            return self.orig(*args)

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def forward_shapes(unet, batch: int, device):
    """(conv calls, attention calls) of one UNet forward at ``batch``."""
    import torch

    from rho_diffusion_tpu_torch.ops import attention as attn_mod
    from rho_diffusion_tpu_torch.ops import convolution as conv_mod

    x, t, y = unet_inputs(unet, batch, device, seed=1)
    with CallRecorder(conv_mod, "conv3d") as conv_rec, \
            CallRecorder(attn_mod, "flash_attention") as attn_rec, torch.no_grad():
        unet(x, t, y)
    torch.cuda.synchronize()
    return conv_rec.calls, attn_rec.calls


def unet_inputs(unet, batch: int, device, seed: int):
    """x_t in [-1, 1], timesteps in [0, 1000) and sha512 condition rows."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch.utils import calculate_sha512_embedding

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, *unet.data_shape, 1), generator=gen).clamp(-1, 1)
    t = torch.randint(0, 1000, (batch,), generator=gen)
    emb = 4 * unet.model_channels
    y = torch.from_numpy(np.stack([
        calculate_sha512_embedding({"l": i % 5, "m": 0}, l=emb) for i in range(batch)
    ]))
    return x.to(device), t.to(device), y.to(device)


def randn(shape, seed: int, device, dtype, scale: float = 1.0):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)


def conv_key(call) -> tuple:
    (xs, dt), (ws, _), _ = call
    return (xs, ws[0], dt)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_env(state: dict) -> None:
    import torch

    smi = nvidia_smi_line()
    from rho_diffusion_tpu_torch.ops.kernels._build import nvcc_path

    nvcc = subprocess.run(
        [nvcc_path(), "--version"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    state["smi"] = smi
    emit("env", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc[-1] if nvcc else None, python=sys.version.split()[0])


def phase_build(state: dict) -> None:
    from rho_diffusion_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    total = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _build.build_log.items()
    }
    emit("build", seconds=round(total, 3), per_source={k: round(v, 3) for k, v in seconds.items()},
         ptxas=ptxas)


def check_conv(key, device, seed: int) -> dict:
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain

    xs, cout, dt = key
    cin = xs[-1]
    x = randn(xs, seed, device, dt)
    w = randn((cout, cin, 3, 3, 3), seed + 1, device, dt, 1 / math.sqrt(27 * cin))
    b = randn((cout,), seed + 2, device, dt, 0.1)
    got = conv3d(x, w, b).float()
    want = conv3d_plain(x.float(), w.float(), b.float())
    torch.cuda.synchronize()
    tol = TOL_CONV_BF16 if dt == torch.bfloat16 else TOL_CONV_FP32
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    return {"x": list(xs), "cout": cout, "dtype": str(dt).split(".")[-1],
            "kernel": "conv3d_igemm" if dt == torch.bfloat16 and cin % 8 == 0 else "conv3d_direct",
            "max_abs_err": float(err.max()), "max_abs_ref": float(want.abs().max()),
            "tol": tol, "ok": ok}


def flash_inputs(b: int, t: int, h: int, d: int, device, seed: int, dtype):
    """q, k, v as the UNet makes them: strided views of one fused qkv."""
    qkv = randn((b, t, h, 3 * d), seed, device, dtype)
    return qkv.split(d, dim=-1)


def check_flash(b, t, h, d, device, seed: int, dtype) -> dict:
    import torch

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

    q, k, v = flash_inputs(b, t, h, d, device, seed, dtype)
    got = flash_attention(q, k, v).float()
    want = xla_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = TOL_FLASH[name]
    err = (got - want).abs()
    max_ref = float(want.abs().max())
    rel_rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    ok = (bool(torch.isfinite(got).all()) and float(err.max()) <= tol * max_ref
          and rel_rms <= tol)
    return {"b": b, "t": t, "h": h, "d": d, "dtype": name, "max_abs_err": float(err.max()),
            "max_abs_ref": max_ref, "rel_rms_err": rel_rms, "tol": tol, "ok": ok}


def phase_kernels(state: dict) -> None:
    import torch

    device = torch.device(DEVICE)
    unet = build_unet(flagship_config(25), "bfloat16", device)
    conv_calls, attn_calls = forward_shapes(unet, 2, device)
    keys = sorted({conv_key(c) for c in conv_calls}, key=str)
    # the fp32 head shapes at both ends of the flagship
    for cin, cout in ((1, 64), (64, 1)):
        keys.append(((2, 32, 32, 32, cin), cout, torch.float32))
    results = [check_conv(k, device, seed=i) for i, k in enumerate(keys)]
    (qs, _), _, _ = attn_calls[0]
    _, t, h, d = qs  # the flagship's attention: T=512, 4 heads of 128
    flash = []
    for dt in (torch.bfloat16, torch.float32):
        flash += [
            check_flash(8, t, h, d, device, seed=100, dtype=dt),
            check_flash(8 if dt == torch.bfloat16 else 2, 4096, h, d, device, seed=101, dtype=dt),
            check_flash(2, 300, h, d, device, seed=102, dtype=dt),
            check_flash(2, 300, 2, 64, device, seed=103, dtype=dt),
        ]
    # per kernel and dtype: the largest error and its tolerance
    err: dict = {}
    for r in results + flash:
        worst = err.setdefault(r.get("kernel", "flash_attention"), {}).setdefault(
            r["dtype"], {"max_abs_err": 0.0})
        worst.update(max_abs_err=max(worst["max_abs_err"], r["max_abs_err"]), tol=r["tol"])
    state["err"] = err
    emit("kernels", conv=results, flash=flash,
         attention_calls_per_forward=len(attn_calls), conv_calls_per_forward=len(conv_calls))
    bad = [r for r in results + flash if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) outside tolerance: {bad[:3]}")


def phase_main(state: dict, steps: int, samples: int) -> None:
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    cfg = flagship_config(steps)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        unet = build_pipeline(cfg, "float32", "cpu").backbone
        pth = tmp / "model.pth"
        torch.save(random_state_dict(unet, seed=0), pth)
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference.main([str(cfg_path), "-p", str(pth), "-n", str(samples), "-d", DEVICE,
                              "-f", "--work-dir", str(tmp)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["launches"] = counts
    want_shape = (samples, *cfg["model"]["kwargs"]["data_shape"],
                  cfg["model"]["kwargs"]["in_channels"])
    finite = bool(np.isfinite(out).all())
    emit("main", shape=list(out.shape), finite=finite, wall_s=wall, steps=steps,
         forwards=steps - 1, launches=counts, sample_mean=float(out.mean()),
         sample_std=float(out.std()))
    if tuple(out.shape) != want_shape or not finite:
        fail(f"main path gave {out.shape}, finite={finite}; expected {want_shape}, finite")
    missing = [k for k in ("conv3d_igemm", "conv3d_direct", "flash_attention") if not counts.get(k)]
    if missing:
        fail(f"main path never launched {missing}; counts {counts}")


def phase_hold(state: dict) -> None:
    """The kernels against the plain versions inside the model: one
    full-width UNet forward, and a whole 25-step reverse process from one
    x_T and one noise seed."""
    import torch

    from rho_diffusion_tpu_torch.ops.attention import set_attention_backend
    from rho_diffusion_tpu_torch.ops.convolution import set_conv3d_backend

    device = torch.device(DEVICE)
    cfg = flagship_config(25)
    fast = build_pipeline(cfg, "bfloat16", device)
    sd = random_state_dict(fast.backbone, seed=0)
    fast.load_state_dict(sd)
    ref = build_pipeline(cfg, "float32", device)
    ref.load_state_dict(sd)
    x, t, y = unet_inputs(fast.backbone, 4, device, seed=5)
    shape = fast.sample_shape(2)
    cond = fast.conditions_from_parameter_space(
        cfg["inference"]["parameter_space"], 2, random=False, as_hash_embeddings=True,
        embedding_dim=fast.condition_embedding_dim())
    x_T = randn(shape, 9, device, torch.float32)

    def sample(pipe):
        gen = torch.Generator(device=device).manual_seed(11)
        return pipe.reverse_process(shape, cond, x_T=x_T, generator=gen)["denoised"]

    with torch.no_grad():
        got = {"forward": fast.apply(x, t, y), "sample": sample(fast)}
        set_conv3d_backend("plain")
        set_attention_backend("xla")
        try:
            plain_bf16 = {"forward": fast.apply(x, t, y), "sample": sample(fast)}
            plain_fp32 = {"forward": ref.apply(x, t, y), "sample": sample(ref)}
        finally:
            set_conv3d_backend("auto")
            set_attention_backend("auto")
    torch.cuda.synchronize()

    def rel_mse(a, b):
        return float(((a.float() - b.float()) ** 2).mean() / (b.float() ** 2).mean())

    fields, bad = {}, []
    for what in ("forward", "sample"):
        k = rel_mse(got[what], plain_fp32[what])
        p = rel_mse(plain_bf16[what], plain_fp32[what])
        fields[what] = {"kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
                        "kernels_vs_bf16_plain": rel_mse(got[what], plain_bf16[what]),
                        "bar": min(HOLD_FACTOR * p, HOLD_CAP[what])}
        if not k <= fields[what]["bar"]:
            bad.append(what)
    emit("hold", **fields, forward_batch=4, sample_batch=2, sample_steps=len(fast.schedule))
    if bad:
        fail(f"the kernels move {bad} further from the fp32 plain model than bf16 does: {fields}")


def conv_cost(key) -> tuple[float, float, float]:
    xs, cout, dt = key
    item = 2 if str(dt).endswith("bfloat16") else 4
    vox = math.prod(xs[:-1])
    cin = xs[-1]
    flops = 2.0 * vox * cout * 27 * cin
    nbytes = item * (vox * cin + 27 * cin * cout + vox * cout + cout)
    return flops, nbytes, PEAK_BF16 if item == 2 else PEAK_FP32


def phase_timings(state: dict, batch: int) -> None:
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

    device = torch.device(DEVICE)
    cfg = flagship_config(25)
    pipe = build_pipeline(cfg, "bfloat16", device)
    pipe.load_state_dict(random_state_dict(pipe.backbone, seed=0))
    unet = pipe.backbone
    conv_calls, attn_calls = forward_shapes(unet, batch, device)
    mult: dict = {}
    for c in conv_calls:
        mult[conv_key(c)] = mult.get(conv_key(c), 0) + 1

    rows = []
    for i, (key, n) in enumerate(sorted(mult.items(), key=lambda kv: str(kv[0]))):
        xs, cout, dt = key
        cin = xs[-1]
        x = randn(xs, 200 + 3 * i, device, dt)
        w = randn((cout, cin, 3, 3, 3), 201 + 3 * i, device, dt, 1 / math.sqrt(27 * cin))
        b = randn((cout,), 202 + 3 * i, device, dt, 0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        # library yardstick: cuDNN on the same channels-last data
        xc = x.movedim(-1, 1)
        k_ms = cuda_time_ms(lambda: conv3d(x, w, b), iters=10)
        p_ms = cuda_time_ms(lambda: conv3d_plain(xf, wf, bf), iters=3, warmup=1)
        l_ms = cuda_time_ms(lambda: F.conv3d(xc, w, b, padding=1), iters=10)
        flops, nbytes, peak = conv_cost(key)
        bnd, by = bound_ms(flops, nbytes, peak)
        rows.append({"x": list(xs), "cout": cout, "dtype": str(dt).split(".")[-1],
                     "kernel": "conv3d_igemm" if dt == torch.bfloat16 and cin % 8 == 0
                     else "conv3d_direct",
                     "calls_per_forward": n, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": bnd, "bound_by": by, "tflops": flops / k_ms / 1e9})
    emit("timings_conv", batch=batch, rows=rows)

    def flash_row(b, t, h, d, n, dtype=torch.bfloat16):
        q, k, v = flash_inputs(b, t, h, d, device, seed=300 + t, dtype=dtype)
        qf, kf, vf = q.float(), k.float(), v.float()
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        k_ms = cuda_time_ms(lambda: flash_attention(q, k, v), iters=10)
        p_ms = cuda_time_ms(lambda: xla_attention(qf, kf, vf), iters=3, warmup=1)
        l_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
        flops = 4.0 * b * h * t * t * d
        item = q.element_size()
        nbytes = item * 4.0 * b * t * h * d
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16 if item == 2 else PEAK_FP32)
        return {"b": b, "t": t, "h": h, "d": d, "dtype": str(dtype).split(".")[-1],
                "calls_per_forward": n, "ms": k_ms,
                "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bnd, "bound_by": by,
                "tflops": flops / k_ms / 1e9}

    (qs, _), _, _ = attn_calls[0]
    fl = flash_row(qs[0], qs[1], qs[2], qs[3], len(attn_calls))
    fl2 = flash_row(batch, 4096, qs[2], qs[3], 0)
    fl32 = flash_row(qs[0], qs[1], qs[2], qs[3], 0, dtype=torch.float32)
    emit("timings_flash", rows=[fl, fl2, fl32])

    x, t, y = unet_inputs(unet, batch, device, seed=7)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: unet(x, t, y), iters=5)
    emit("timings_unet", batch=batch, unet_forward_ms=fwd_ms,
         device_profile=profile_forward(unet, (x, t, y), fwd_ms))
    emit("timings_sample", **time_sampling(pipe, cfg, samples=4))

    state["timings"] = {"batch": batch, "conv": rows, "flash": fl, "flash_t4096": fl2,
                        "flash_fp32": fl32}


def kernels_line(state: dict) -> list:
    """The ``kernels`` line: each kernel's launches on the main path, its
    largest error against its plain version, and its times (one UNet forward
    at the timing batch) from the kernels, main and timings phases of this
    run."""
    timings = state["timings"]
    batch, rows = timings["batch"], timings["conv"]
    fl, fl2, fl32 = timings["flash"], timings["flash_t4096"], timings["flash_fp32"]

    def total(kernel, field):
        return sum(r[field] * r["calls_per_forward"] for r in rows if r["kernel"] == kernel)

    def accuracy(name):
        by_dtype = state["err"][name]
        return {"max_abs_err": max(v["max_abs_err"] for v in by_dtype.values()),
                "tol_by_dtype": {k: v["tol"] for k, v in by_dtype.items()},
                "max_abs_err_by_dtype": {k: v["max_abs_err"] for k, v in by_dtype.items()}}

    launches = state["launches"]
    kernels = []
    for name in ("conv3d_igemm", "conv3d_direct"):
        sel = [r for r in rows if r["kernel"] == name]
        ops_ms = sum(r["bound_ms"] * r["calls_per_forward"] for r in sel
                     if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": "rho_diffusion_tpu_torch/csrc/conv3d.cu",
            "replaces": "rho_diffusion_tpu/ops/pallas/conv3d.py:102",
            "launches": launches[name], **accuracy(name),
            "ms": total(name, "ms"), "plain_ms": total(name, "plain_ms"),
            "bound_ms": total(name, "bound_ms"),
            "bound_by": "operations" if ops_ms >= total(name, "bound_ms") / 2 else "bytes",
            "library_ms": total(name, "library_ms"),
            "per": f"one UNet forward at batch {batch}, "
                   f"{sum(r['calls_per_forward'] for r in sel)} calls",
        })
    # One CUDA kernel replaces both TPU forward kernels (K1 one-pass, K2
    # multi-block): its K/V-tile loop runs 8 times at T=512 and 64 at T=4096.
    n = fl["calls_per_forward"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "rho_diffusion_tpu_torch/csrc/flash_attention.cu",
        "replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:115",
        "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:59",
        "launches": launches["flash_attention"], **accuracy("flash_attention"),
        **{f: fl[f] * n for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": fl["bound_by"],
        "per": f"one UNet forward at batch {batch}, {n} calls at T={fl['t']}",
        "t4096": {f: fl2[f] for f in ("b", "h", "d", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
        "fp32_t512": {f: fl32[f] * n for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
    })
    return kernels


def device_time_by_kernel(fn) -> dict:
    """{kernel name: (device ms, launches)} of one call of ``fn``, from
    torch.profiler's CUDA events; empty when the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


NOT_PROFILED = {"status": "not measured: the profiler recorded no device events"}


def profile_forward(unet, inputs, fwd_ms: float) -> dict:
    """Device time of one UNet forward by kernel, and the device's busy
    share of the forward's CUDA-event time (kernels run on one stream, so
    their times add up without overlap)."""
    by_name = device_time_by_kernel(lambda: unet(*inputs))
    if not by_name:
        return NOT_PROFILED
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"busy_ms": busy, "busy_share_of_forward": busy / fwd_ms,
            "kernels": len(by_name), "launches": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:90], "ms": ms, "count": n} for k, (ms, n) in top]}


def time_sampling(pipe, cfg: dict, samples: int) -> dict:
    """Host-clock seconds of the whole reverse process (the main path's
    sampling loop, without model build or weight load), twice after one
    warm-up run, and the device's busy share of it (one more, profiled run;
    its device time over the faster unprofiled run)."""
    import torch

    device = pipe.device
    shape = pipe.sample_shape(samples)
    cond = pipe.conditions_from_parameter_space(
        cfg["inference"]["parameter_space"], samples, random=False, as_hash_embeddings=True,
        embedding_dim=pipe.condition_embedding_dim())

    def sample():
        pipe.reverse_process(shape, cond, generator=torch.Generator(device=device).manual_seed(0))

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    steps = len(pipe.schedule)
    by_name = device_time_by_kernel(sample)
    busy_s = sum(ms for ms, _ in by_name.values()) / 1e3
    return {"batch": samples, "steps": steps, "forwards": steps - 1, "sample_s": runs[1:],
            "warmup_s": runs[0], "ms_per_forward": 1e3 * min(runs[1:]) / (steps - 1),
            "device_busy_s": busy_s if by_name else None,
            "device_busy_share": busy_s / min(runs[1:]) if by_name else NOT_PROFILED["status"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--phases", default=",".join(PHASES))
    parser.add_argument("--steps", type=int, default=25,
                        help="noise_schedule num_steps of the main path (>= 21 keeps betas < 1)")
    parser.add_argument("--samples", type=int, default=4)
    parser.add_argument("--timing-batch", type=int, default=8)
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    if not (ROOT / "rho_diffusion_tpu_torch").is_dir() or not CONFIG.is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    state: dict = {}
    t0 = time.perf_counter()
    if "env" in phases:
        phase_env(state)
    if "build" in phases:
        phase_build(state)
    if "kernels" in phases:
        phase_kernels(state)
    if "main" in phases:
        phase_main(state, args.steps, args.samples)
    if "hold" in phases:
        phase_hold(state)
    if "timings" in phases:
        phase_timings(state, args.timing_batch)
    emit("done", seconds=time.perf_counter() - t0)
    if not set(KERNELS_LINE_PHASES) <= set(phases):
        print(f"chip_smoke: a run without all of {KERNELS_LINE_PHASES} prints no kernels "
              "line and no result", file=sys.stderr)
        return 3
    print(json.dumps({"kernels": kernels_line(state)}))
    print(state.get("smi") or nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
