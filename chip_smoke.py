#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phases env,build,kernels,main,train,hold,serve,timings]
                          [--steps 25] [--samples 4] [--timing-batch 8]

Builds the port's CUDA kernels from ``rho_diffusion_tpu_torch/csrc``, holds
each (forward and backward, bf16 and fp32) against its plain PyTorch version
at the shapes the flagship UNet gives it, and drives the port's two paths on
the flagship config (``examples/config_spherical_harmonics.json`` at full
width, random seeded weights loaded from a reference-layout ``.pth``):

* ``main``: sampling through ``rho_diffusion_tpu_torch.inference.main``;
* ``train``: five DDPM training steps at batch 32 through
  ``rho_diffusion_tpu_torch.training``'s ``main``, the checkpoint read back
  to the trainer's EMA weights, and one profiled step;
* ``serve``: the sampling service through ``rho_diffusion_tpu_torch.serve``'s
  ``build_server`` under a ("data", "context") mesh of 4 context ranks on
  the card, with ``RHO_RING_ATTN_IMPL=rdma``, so every attention call runs
  the ring with the kernel K6; buckets 1, 2, 4, 8 warmed up, three requests
  over HTTP (n = 1, 3 and 11, the last split across launches), a request
  alone against the same request co-batched, a sample held against the
  fp32 plain model with the plain ring, and a single-rank service (the
  flash kernel's route) against the ring service.

Each path's launch counts are cleared just before it and read just after,
and it fails if a kernel of the path never launched. ``hold`` holds one
full-width UNet forward, a reverse process and one training loss's
gradients on the kernels against the plain versions; ``timings`` holds each
kernel against its plain version again at the shapes of one UNet forward
(batch 8) and of one training step (batch 32), and times it there (its
device time from torch.profiler, and the wrapper call) beside the plain
version, a PyTorch library call and its bound; then one UNet forward (with
a torch.profiler breakdown by kernel) and the whole reverse process. Every
phase prints one JSON line; a failing phase exits
non-zero. The last line is ``{"ok": true, "device": {...}}``, after the
``kernels`` line and the card's ``nvidia-smi`` name and power limit. A run
whose ``--phases`` leave out any of kernels, main, train and timings prints
neither and exits 3.

Exits non-zero without a result when CUDA is unavailable or the script runs
outside a checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
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
PHASES = ("env", "build", "kernels", "main", "train", "hold", "serve", "timings")
# the phases whose numbers the kernels line carries
KERNELS_LINE_PHASES = ("kernels", "main", "train", "serve", "timings")
DEVICE = "cuda"
# the train phase: the flagship's batch, and steps cut to five
TRAIN_BATCH = 32
TRAIN_STEPS = 5
# the serve phase: context ranks of the ring, all on one card, and buckets
SERVE_CONTEXT = 4
SERVE_BUCKETS = (1, 2, 4, 8)
# device time of the profiled training step, grouped by kernel name
DEVICE_TIME_GROUPS = (
    ("conv3d_igemm (port, forward and dgrad)", ("conv3d_igemm",)),
    ("conv3d_direct (port, forward and dgrad)", ("conv3d_direct",)),
    ("flash attention (port, forward and backward)", ("flash_fwd", "flash_bwd")),
    ("conv weight gradients (cuDNN)", ("wgrad",)),
    ("strided Downsample conv (cuDNN)", ("xmma_fprop", "xmma_dgrad", "implicit_gemm",
                                         "conv2d", "conv3d_fprop")),
    ("matmuls (cuBLAS: qkv, proj_out, skip, time MLP)", ("gemm", "cutlass", "sm90_xmma_gemm")),
    ("AdamW and EMA (multi_tensor_apply)", ("multi_tensor_apply",)),
)

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
# flash backward (dq, dk, dv), the same two relative bounds against the fp32
# plain backward. bf16: the kernels round P and dS to bf16 before their
# products (mma.sync; the TPU kernels keep them fp32), the saved output O
# that delta = rowsum(dO O) reads is bf16, and each gradient is rounded to
# bf16: four roundings of at most 2^-9 relative each (2^-7 together), and
# twice that for the summation order, so tol = 2^-6. Dropping one of the
# eight key tiles at T=512 would be ~35% off in rms. fp32 (FMA, no TF32):
# the JAX package's own flash-gradient tolerance 5e-5
# (tests/ops/test_flash_attention.py), here relative.
TOL_FLASH_BWD = {"bfloat16": 2.0 ** -6, "float32": 5e-5}
# The kernels inside the model, against the fp32 plain model: one
# full-width forward (batch 4) and a whole 25-step reverse process (batch 2,
# one x_T, one noise seed). bf16 alone moves the result away from fp32: the
# forward by ~2e-4 relative MSE, the sample by ~0.09, because the 25-step cut
# of the schedule multiplies each step's difference by up to
# 1/sqrt(alpha_t) ~ 2.2. So the bar is relative: the kernel model may be at
# most HOLD_FACTOR times as far from fp32 as the same bf16 model on the plain
# versions, and never further than HOLD_CAP, well below the O(1) of a wrong
# kernel. The same rule holds the parameter gradients of one full-width
# training loss (batch 2), measured as the relative L2 over all gradients;
# its cap of 0.1 is a tenth of the distance of a gradient that a wrong or
# missing backward kernel would give.
HOLD_FACTOR = 3.0
HOLD_CAP = {"forward": 1e-2, "sample": 0.5, "train_gradients": 0.1}
# A served request alone against the same request co-batched, and the ring
# service against a single-rank one (flash attention, no ring), on the card:
# cuBLAS and cuDNN pick their algorithms by batch size, and the ring and flash
# kernels round differently, so the two bf16 runs round differently and the
# 25-step cut schedule amplifies it as it does bf16's own. Both are held by
# the sample hold's rule: at most HOLD_FACTOR times the serve phase's own
# measured bf16 spread (the bf16 plain sample against the fp32 plain one),
# and never above HOLD_CAP["sample"]. A row that drew another row's noise
# would be an independent sample, relative MSE about 2.


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
        def wrapped(*args, **kwargs):
            self.calls.append(tuple((tuple(a.shape), a.dtype) if a is not None else None
                                    for a in args))
            return self.orig(*args, **kwargs)

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
    # ptxas -v names each kernel (mangled) before its registers and spills
    ptxas = {
        name: [ln.split("'")[1] if "Compiling entry function" in ln else ln.strip()
               for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
        for name, log in _build.build_log.items()
    }
    emit("build", seconds=round(total, 3), per_source={k: round(v, 3) for k, v in seconds.items()},
         ptxas=ptxas)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def conv_error(got, want, tol: float) -> dict:
    """The conv check, elementwise: |got - want| <= tol (1 + |want|)."""
    import torch

    err = (got - want).abs()
    ratio = float((err / (tol * (1 + want.abs()))).max())
    return {"max_abs_err": float(err.max()), "max_abs_ref": float(want.abs().max()),
            "tol": tol, "check": "|err| <= tol * (1 + |want|) elementwise",
            "err_over_tol": ratio, "ok": bool(torch.isfinite(got).all()) and ratio <= 1}


def flash_error(got, want, tol: float) -> dict:
    """The flash check, relative to the reference: max |got - want| <=
    tol max |want| and rms(got - want) <= tol rms(want)."""
    import torch

    err = (got.float() - want).abs()
    mx, ref = float(err.max()), float(want.abs().max())
    rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    ratio = max(mx / (tol * ref), rms / tol)
    return {"max_abs_err": mx, "max_abs_ref": ref, "rel_rms_err": rms, "tol": tol,
            "check": "max|err| <= tol * max|want| and rms(err) <= tol * rms(want)",
            "err_over_tol": ratio, "ok": bool(torch.isfinite(got).all()) and ratio <= 1}


# the CUDA kernel (a substring of its name in the profiler) behind each count
CUDA_KERNEL = {"conv3d_igemm": "conv3d_igemm", "conv3d_direct": "conv3d_direct",
               "conv3d_dgrad_igemm": "conv3d_igemm", "conv3d_dgrad_direct": "conv3d_direct",
               "flash_attention": "flash_fwd", "flash_attention_bwd_dkv": "flash_bwd_dkv",
               "flash_attention_bwd_dq": "flash_bwd_dq", "ring_attention": "ring_step"}


def kernel_times(fn, kernel: str, iters: int = 10) -> dict:
    """``ms``: device time per call of ``fn`` in the CUDA kernel behind
    ``kernel``, from torch.profiler; ``call_ms``: CUDA-event time per call
    of the whole wrapper ``fn`` (its host work, weight repacks, pads and, for
    the flash backward, delta included). Without profiler events ``ms`` is
    ``call_ms``, and ``ms_of`` says so."""
    call_ms = cuda_time_ms(fn, iters)

    def repeat():
        for _ in range(iters):
            fn()

    by_name = device_time_by_kernel(repeat)
    hits = [ms for name, (ms, _) in by_name.items() if CUDA_KERNEL[kernel] in name]
    if not hits:
        return {"ms": call_ms, "ms_of": "the wrapper call (CUDA events)", "call_ms": call_ms}
    return {"ms": sum(hits) / iters, "ms_of": "the kernel's device time (torch.profiler)",
            "call_ms": call_ms}


def conv_kernel_name(kind: str, key) -> str:
    """The count a conv problem's launch goes to: the implicit GEMM for bf16
    whose own input channels are a multiple of 8, else the direct kernel."""
    import torch

    xs, _, dt = key
    route = "igemm" if dt == torch.bfloat16 and xs[-1] % 8 == 0 else "direct"
    return f"conv3d_{route}" if kind == "forward" else f"conv3d_dgrad_{route}"


def conv_keys(conv_calls, kind: str) -> list:
    """The conv problems of one forward, or (kind "dgrad") of its input
    gradients: every conv but the Cin=1 input conv (x_t needs no gradient),
    with the roles of its input and output channels swapped. A key is
    (input shape, output channels, dtype) of the conv the kernel runs."""
    keys = list(map(conv_key, conv_calls))
    if kind == "forward":
        return keys
    return [((*xs[:-1], cout), xs[-1], dt) for xs, cout, dt in keys if xs[-1] != 1]


def conv_problem(kind: str, key, device, seed: int):
    """Seeded inputs of one conv problem, and three calls on them: the
    kernel's wrapper, its plain version on fp32 copies, and the library's
    call for the same function (``F.conv3d``; ``conv3d_input`` for dgrad)."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.kernels.conv3d import (
        conv3d, conv3d_dgrad, conv3d_dgrad_plain, conv3d_plain)

    xs, cout, dt = key
    cin = xs[-1]
    x = randn(xs, seed, device, dt)
    if kind == "forward":
        w = randn((cout, cin, 3, 3, 3), seed + 1, device, dt, 1 / math.sqrt(27 * cin))
        b = randn((cout,), seed + 2, device, dt, 0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        return (lambda: conv3d(x, w, b), lambda: conv3d_plain(xf, wf, bf),
                lambda: F.conv3d(x.movedim(-1, 1), w, b, padding=1))
    # x is the gradient g of a forward conv cout -> cin, w that conv's weight
    w = randn((cin, cout, 3, 3, 3), seed + 1, device, dt, 1 / math.sqrt(27 * cin))
    xf, wf = x.float(), w.float()
    return (lambda: conv3d_dgrad(x, w), lambda: conv3d_dgrad_plain(xf, wf),
            lambda: torch.nn.grad.conv3d_input((xs[0], cout, *xs[1:-1]), w, x.movedim(-1, 1),
                                               padding=1))


def hold_conv(kind: str, key, device, seed: int, calls: int = 0, per: str = "") -> dict:
    """One conv problem: the kernel against its fp32 plain version on the
    same inputs; with ``calls`` (per ``per``) also its times and bound."""
    import torch

    run, plain, library = conv_problem(kind, key, device, seed)
    xs, cout, dt = key
    tol = TOL_CONV_BF16 if dt == torch.bfloat16 else TOL_CONV_FP32
    row = {"kind": kind, "x": list(xs), "cout": cout, "dtype": dtype_name(dt),
           "kernel": conv_kernel_name(kind, key), "variant": None,
           **conv_error(run().float(), plain(), tol)}
    if calls:
        flops, nbytes, peak = conv_cost(key)
        bnd, by = bound_ms(flops, nbytes, peak)
        row.update(calls=calls, per=per, **kernel_times(run, row["kernel"]),
                   plain_ms=cuda_time_ms(plain, iters=2, warmup=1),
                   library="F.conv3d (cuDNN)" if kind == "forward"
                   else "torch.nn.grad.conv3d_input (cuDNN)",
                   library_ms=cuda_time_ms(library, iters=10), bound_ms=bnd, bound_by=by)
        row["tflops"] = flops / row["ms"] / 1e9
    return row


def hold_convs(unet, batch: int, kind: str, device, seed: int, timed: bool) -> list:
    """Every distinct conv problem of one UNet forward (or its input
    gradients) at ``batch``, held against the plain version; with ``timed``
    also timed, each with its calls per forward or training step."""
    calls: dict = {}
    for key in conv_keys(forward_shapes(unet, batch, device)[0], kind):
        calls[key] = calls.get(key, 0) + 1
    per = f"one {'UNet forward' if kind == 'forward' else 'training step'} at batch {batch}"
    return [hold_conv(kind, key, device, seed + 3 * i, n if timed else 0, per)
            for i, (key, n) in enumerate(sorted(calls.items(), key=lambda kv: str(kv[0])))]


def record_errors(state: dict, rows: list) -> None:
    """Keep, per kernel and dtype, the largest error of ``rows`` and the
    worst ratio of error to the check's tolerance (1 is the limit)."""
    for r in rows:
        worst = state.setdefault("err", {}).setdefault(r["kernel"], {}).setdefault(
            r["dtype"], {"max_abs_err": 0.0, "err_over_tol": 0.0, "check": r["check"],
                         "tol": r["tol"], "holds": 0})
        worst["max_abs_err"] = max(worst["max_abs_err"], r["max_abs_err"])
        worst["err_over_tol"] = max(worst["err_over_tol"], r["err_over_tol"])
        worst["holds"] += 1


def fail_bad(what: str, rows: list) -> None:
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{what}: {len(bad)} kernel check(s) outside tolerance: {bad[:3]}")


def flash_inputs(b: int, t: int, h: int, d: int, device, seed: int, dtype):
    """q, k, v as the UNet makes them: strided views of one fused qkv."""
    qkv = randn((b, t, h, 3 * d), seed, device, dtype)
    return qkv.split(d, dim=-1)


def check_flash(b, t, h, d, device, seed: int, dtype) -> dict:
    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

    q, k, v = flash_inputs(b, t, h, d, device, seed, dtype)
    got = flash_attention(q, k, v)
    want = xla_attention(q.float(), k.float(), v.float())
    return {"kernel": "flash_attention", "b": b, "t": t, "h": h, "d": d,
            "dtype": dtype_name(dtype), **flash_error(got, want, TOL_FLASH[dtype_name(dtype)])}


def check_flash_bwd(b, t, h, d, device, seed: int, dtype) -> dict:
    """dq, dk, dv of the kernels (through the autograd Function, forward
    with LSE) against the fp32 plain backward on the same inputs; the kernels
    run twice and must agree bitwise."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain, flash_lse_plain)

    qkv = randn((b, t, h, 3 * d), seed, device, dtype).requires_grad_()
    do = randn((b, t, h, d), seed + 1, device, dtype)

    def grads():
        out = flash_attention(*qkv.split(d, dim=-1))
        return torch.autograd.grad(out, qkv, do)[0].split(d, dim=-1)

    got, again = grads(), grads()
    qf, kf, vf = (z.detach().float() for z in qkv.split(d, dim=-1))
    want = flash_attention_bwd_plain(qf, kf, vf, flash_attention_plain(qf, kf, vf),
                                     flash_lse_plain(qf, kf), do.float())
    name = dtype_name(dtype)
    grads_ = [{"grad": which, "dtype": name, "b": b, "t": t, "h": h, "d": d,
               "kernel": "flash_attention_bwd_dq" if which == "dq" else "flash_attention_bwd_dkv",
               **flash_error(g, w, TOL_FLASH_BWD[name])}
              for which, g, w in zip(("dq", "dk", "dv"), got, want)]
    repeatable = all(torch.equal(x, y) for x, y in zip(got, again))
    return {"b": b, "t": t, "h": h, "d": d, "dtype": name, "bitwise_repeatable": repeatable,
            "grads": grads_, "ok": repeatable and all(g["ok"] for g in grads_)}


def ring_mesh(n: int, device):
    """A ("data", "context") mesh of ``n`` context ranks, all on ``device``."""
    from rho_diffusion_tpu_torch.parallel import make_mesh

    return make_mesh(data=1, context=n, devices=[device] * n)


def ring_call(q, k, v, mesh, plain: bool = False):
    """One context-parallel attention call with the "rdma" ring: K6, or
    with ``plain`` the same ring with K6's plain step."""
    from rho_diffusion_tpu_torch.parallel import context_sharded_attention

    return context_sharded_attention(q, k, v, mesh, impl="rdma", plain=plain)


def check_ring(b, t, h, d, n, device, seed: int, dtype) -> list:
    """K6 in its ring of ``n`` ranks on one card (strided views of one qkv,
    as the UNet makes them), held on fp32 copies of the inputs against the
    same ring with the plain step, and against full attention without the
    ring (``xla_attention``), which shares none of the ring's slots, streams
    and events."""
    from rho_diffusion_tpu_torch.ops.attention import xla_attention

    q, k, v = flash_inputs(b, t, h, d, device, seed, dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    mesh = ring_mesh(n, device)
    got = ring_call(q, k, v, mesh)
    tol = TOL_FLASH[dtype_name(dtype)]
    row = {"kernel": "ring_attention", "b": b, "t": t, "n": n, "t_per_rank": t // n, "h": h,
           "d": d, "dtype": dtype_name(dtype)}
    return [{**row, "against": "the plain ring (fp32)",
             **flash_error(got, ring_call(qf, kf, vf, mesh, plain=True), tol)},
            {**row, "against": "xla_attention without the ring (fp32)",
             **flash_error(got, xla_attention(qf, kf, vf), tol)}]


def phase_kernels(state: dict) -> None:
    import torch

    device = torch.device(DEVICE)
    unet = build_unet(flagship_config(25), "bfloat16", device)
    conv_calls, attn_calls = forward_shapes(unet, 2, device)
    keys = sorted(set(conv_keys(conv_calls, "forward")), key=str)
    # the fp32 head shapes at both ends of the flagship
    for cin, cout in ((1, 64), (64, 1)):
        keys.append(((2, 32, 32, 32, cin), cout, torch.float32))
    conv = [hold_conv("forward", k, device, seed=i) for i, k in enumerate(keys)]
    conv += [hold_conv("dgrad", k, device, seed=50 + 2 * i)
             for i, k in enumerate(sorted(set(conv_keys(conv_calls, "dgrad")), key=str))]
    (qs, _), _, _ = attn_calls[0]
    _, t, h, d = qs  # the flagship's attention: T=512, 4 heads of 128
    flash, flash_bwd = [], []
    for dt in (torch.bfloat16, torch.float32):
        flash += [
            check_flash(8, t, h, d, device, seed=100, dtype=dt),
            check_flash(8 if dt == torch.bfloat16 else 2, 4096, h, d, device, seed=101, dtype=dt),
            check_flash(2, 300, h, d, device, seed=102, dtype=dt),
            check_flash(2, 300, 2, 64, device, seed=103, dtype=dt),
        ]
        # the training step's attention (B*H = 32*4 = 128) and a ragged T
        flash_bwd += [
            check_flash_bwd(32, t, h, d, device, seed=110, dtype=dt),
            check_flash_bwd(2, 300, h, d, device, seed=112, dtype=dt),
            check_flash_bwd(2, 300, 2, 64, device, seed=114, dtype=dt),
        ]
    # K6 at the serve shape (bucket 8 over 4 ranks: T/n = 128) and the 64^3
    # config's (T = 4096: T/n = 1024)
    ring = [row for dt in (torch.bfloat16, torch.float32) for i, tt in enumerate((t, 4096))
            for row in check_ring(8, tt, h, d, SERVE_CONTEXT, device, seed=120 + i, dtype=dt)]
    record_errors(state, conv + flash + ring + [g for r in flash_bwd for g in r["grads"]])
    emit("kernels", conv=conv, flash=flash, flash_bwd=flash_bwd, ring=ring,
         attention_calls_per_forward=len(attn_calls), conv_calls_per_forward=len(conv_calls))
    fail_bad("kernels", conv + flash + flash_bwd + ring)


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


def train_config(batch: int) -> dict:
    """The flagship config at full width with the train phase's cuts."""
    cfg = json.loads(CONFIG.read_text())
    cfg["dataset"]["kwargs"]["length"] = TRAIN_STEPS * batch
    cfg["training"].update(batch_size=batch, max_epochs=1,
                           save_checkpoint_every_n_epochs=1, log_every_n_steps=1,
                           loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    return cfg


TRAIN_CUTS = {
    "dataset.kwargs.length": f"1000 -> {TRAIN_STEPS} * batch (the dataset's default length)",
    "training.max_epochs": "1000 -> 1",
    "training.save_checkpoint_every_n_epochs": "10 -> 1",
    "training.log_every_n_steps": "50 -> 1",
    "training.loggers": "stdout, jsonl -> jsonl",
}


def phase_train(state: dict, batch: int) -> None:
    """The training path: ``python -m rho_diffusion_tpu_torch.training``'s
    main on the full-width flagship config from seeded random weights (a
    ``.pth`` through -p), TRAIN_STEPS steps at ``batch``; then the
    checkpoint read back through ``resolve_inference_params`` and one more
    step, profiled."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.loader import DataLoader, to_device
    from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.training.__main__ import main as train_main
    from rho_diffusion_tpu_torch.training.checkpoint import (
        CheckpointManager, resolve_inference_params)

    device = torch.device(DEVICE)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        sd0 = random_state_dict(build_pipeline(flagship_config(25), "float32", "cpu").backbone,
                                seed=0)
        pth = tmp / "model.pth"
        torch.save(sd0, pth)
        cfg = train_config(batch)
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        work = tmp / "run"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            st = train_main([str(cfg_path), "-p", str(pth), "-d", DEVICE,
                             "--work-dir", str(work), "--no-resume"])
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fail(f"train: batch {batch} did not fit in one pass (peak "
                 f"{torch.cuda.max_memory_allocated()} bytes allocated); the package's "
                 "answer is training.grad_accum 2")
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if "train_loss" in r]
        losses = [r["train_loss"] for r in steps]
        norms = [r["grad_norm"] for r in steps]
        step_s = [r["step_s"] for r in steps]
        changed = sum(not torch.equal(v.detach().cpu(), sd0[k])
                      for k, v in st.model.state_dict().items())
        latest = CheckpointManager(work / "checkpoints").latest_step()

        config = ExperimentConfig.from_dict(cfg)
        pipe = build_pipeline(cfg, "bfloat16", device)
        messages = resolve_inference_params(pipe, config, None, work)
        ema_equal = all(torch.equal(p, st.ema[k]) for k, p in pipe.backbone.named_parameters())
        ema_params = len(st.ema)
        del st
        torch.cuda.empty_cache()

        # one more step on the read-back weights: host time, then profiled
        dataset = SphericalHarmonicDataset(**config.dataset.kwargs)
        data = to_device(next(iter(DataLoader(dataset, batch, seed=1))), device)
        ts = pipe.create_state(seed=0)
        pipe.training_step(ts, data)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.training_step(ts, data)
        torch.cuda.synchronize()
        one_step_s = time.perf_counter() - t1
        by_name = device_time_by_kernel(lambda: pipe.training_step(ts, data))
        del ts, pipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    profiled = {"host_s": one_step_s, **NOT_PROFILED}
    if by_name:
        groups: dict = {}
        for name, (ms, n) in by_name.items():
            group = next((g for g, keys in DEVICE_TIME_GROUPS if any(k in name for k in keys)),
                         "other PyTorch ops (GroupNorm, SiLU, casts, copies, adds, reductions)")
            total, count = groups.get(group, (0.0, 0))
            groups[group] = (total + ms, count + n)
        profiled = {"host_s": one_step_s, **profile_summary(by_name)}
        profiled.update(device_busy_share=profiled["busy_ms"] / 1e3 / one_step_s,
                        by_group={g: {"ms": ms, "launches": n} for g, (ms, n)
                                  in sorted(groups.items(), key=lambda kv: -kv[1][0])})
    after_first = step_s[1:]
    median = float(np.median(after_first)) if after_first else None
    state["train_launches"] = counts
    emit("train", batch=batch, grad_accum=cfg["training"].get("grad_accum", 1),
         steps=len(steps), cuts=TRAIN_CUTS,
         losses=losses, grad_norms=norms, step_s=step_s, median_step_s_after_first=median,
         samples_per_s=batch / median if median else None, wall_s=wall,
         max_memory_allocated=peak, launches=counts, params_changed=changed,
         params=len(sd0), checkpoint_step=latest, inference_messages=messages,
         ema_read_back_bitwise=ema_equal, ema_params=ema_params, profiled_step=profiled)
    problems = []
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses + norms)):
        problems.append(f"{len(steps)} logged steps, losses {losses}, grad norms {norms}")
    if not changed:
        problems.append("no parameter changed")
    # every kernel of the sampling and training paths runs on the training path
    missing = [name for name, _, _, path in KERNELS if path != "serving" and not counts.get(name)]
    if missing:
        problems.append(f"the training path never launched {missing}; counts {counts}")
    if latest != TRAIN_STEPS or not ema_equal:
        problems.append(f"checkpoint step {latest}, EMA read back bitwise: {ema_equal}")
    if problems:
        fail("train: " + "; ".join(problems))


@contextlib.contextmanager
def plain_backends():
    """Send every conv and attention call to its plain version."""
    from rho_diffusion_tpu_torch.ops.attention import set_attention_backend
    from rho_diffusion_tpu_torch.ops.convolution import set_conv3d_backend

    set_conv3d_backend("plain")
    set_attention_backend("xla")
    try:
        yield
    finally:
        set_conv3d_backend("auto")
        set_attention_backend("auto")


def train_batch(batch: int, timesteps: int, device, seed: int):
    """A training batch of flagship fields with sha512 labels, and fixed
    timesteps and noise for it."""
    import torch

    from rho_diffusion_tpu_torch.data.loader import default_collate, to_device
    from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset

    ds = SphericalHarmonicDataset(max_l=5, length=batch, random_seed=seed)
    data = to_device(default_collate([ds[i] for i in range(batch)]), device)
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, timesteps, (batch,), generator=gen).to(device)
    noise = torch.randn(data["data"].shape, generator=gen).to(device)
    return data, t, noise


def train_gradients(pipe, data, t, noise) -> dict:
    """fp32 copies of every parameter gradient of one DDPM loss."""
    model = pipe.backbone
    model.zero_grad(set_to_none=True)
    model.train()
    loss, _ = pipe.loss_and_metrics(data, t=t, noise=noise)
    loss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def grad_distance(got: dict, want: dict) -> tuple[float, str, float]:
    """(relative L2 over all gradients, the parameter with the largest
    relative L2 among those holding at least 1e-3 of the total norm, that
    parameter's relative L2)."""
    import torch

    total = math.sqrt(sum(float(w.pow(2).sum()) for w in want.values()))
    diff = math.sqrt(sum(float((got[k] - w).pow(2).sum()) for k, w in want.items()))
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        norm = float(torch.linalg.vector_norm(w))
        if norm >= 1e-3 * total:
            rel = float(torch.linalg.vector_norm(got[k] - w)) / norm
            if rel > worst:
                worst, worst_name = rel, k
    return diff / total, worst_name, worst


def phase_hold(state: dict) -> None:
    """The kernels against the plain versions inside the model: one
    full-width UNet forward, a whole 25-step reverse process from one x_T
    and one noise seed, and the parameter gradients of one full-width
    training loss at batch 2."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

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
        with plain_backends():
            plain_bf16 = {"forward": fast.apply(x, t, y), "sample": sample(fast)}
            plain_fp32 = {"forward": ref.apply(x, t, y), "sample": sample(ref)}
    batch = train_batch(2, len(fast.schedule), device, seed=13)
    before = dict(launch_counts)
    grads = train_gradients(fast, *batch)
    launched = {k: v - before.get(k, 0) for k, v in launch_counts.items() if v > before.get(k, 0)}
    with plain_backends():
        grads_bf16_plain = train_gradients(fast, *batch)
        grads_fp32_plain = train_gradients(ref, *batch)
    torch.cuda.synchronize()

    fields, bad = {}, []
    for what in ("forward", "sample"):
        k = rel_mse(got[what], plain_fp32[what])
        p = rel_mse(plain_bf16[what], plain_fp32[what])
        fields[what] = {"kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
                        "kernels_vs_bf16_plain": rel_mse(got[what], plain_bf16[what]),
                        "bar": min(HOLD_FACTOR * p, HOLD_CAP[what])}
        if not k <= fields[what]["bar"]:
            bad.append(what)
    k, k_name, k_worst = grad_distance(grads, grads_fp32_plain)
    p, p_name, p_worst = grad_distance(grads_bf16_plain, grads_fp32_plain)
    fields["train_gradients"] = {
        "metric": "relative L2 over all parameter gradients",
        "kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
        "kernels_vs_bf16_plain": grad_distance(grads, grads_bf16_plain)[0],
        "worst_parameter_kernels": {"name": k_name, "rel_l2": k_worst},
        "worst_parameter_bf16_plain": {"name": p_name, "rel_l2": p_worst},
        "parameters": len(grads_fp32_plain),
        "bar": min(HOLD_FACTOR * p, HOLD_CAP["train_gradients"]),
        "kernel_launches": launched,
    }
    if not k <= fields["train_gradients"]["bar"]:
        bad.append("train_gradients")
    if set(grads) != set(grads_fp32_plain) or not all(
            bool(torch.isfinite(g).all()) for g in grads.values()):
        bad.append("train_gradients (missing or non-finite)")
    emit("hold", **fields, forward_batch=4, sample_batch=2, sample_steps=len(fast.schedule),
         train_batch=2)
    if bad:
        fail(f"the kernels move {bad} further from the fp32 plain model than bf16 does: {fields}")


SERVE_CUTS = {
    "noise_schedule.kwargs.num_steps": "1000 -> 25 (random weights; the sampler's loop is "
                                       "the same at any length)",
    "inference.cache_file, plot_output_file, checkpoint": "-> none (weights through -p)",
}


def rel_mse(a, b) -> float:
    """Relative MSE of ``a`` against ``b`` (tensors, in fp32, or arrays)."""
    if hasattr(a, "float"):
        a, b = a.float(), b.float()
    return float(((a - b) ** 2).mean() / (b ** 2).mean())


def serve_conditions(cfg: dict, n: int, start: int):
    """sha512 rows (width 256) of parameter-space rows [start, start + n),
    cycled, as the inference entry conditions the flagship."""
    import numpy as np

    from rho_diffusion_tpu_torch.utils import parameter_space_to_embeddings

    embs = parameter_space_to_embeddings(cfg["inference"]["parameter_space"], l=256)
    return embs[np.arange(start, start + n) % len(embs)]


def http_call(port: int, method: str, path: str, body=None) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"serve: {method} {path} answered {resp.status}: {reply}")
    return reply


def serve_argv(cfg_path: Path, pth: Path, work: Path, buckets, ring: bool) -> list:
    argv = [str(cfg_path), "-p", str(pth), "-d", DEVICE, "--port", "0", "--cond-dim", "256",
            "--buckets", ",".join(map(str, buckets)), "--work-dir", str(work)]
    if ring:
        argv += ["--warmup", "--context-parallel", str(SERVE_CONTEXT),
                 "--mesh-devices", ",".join([f"{DEVICE}:0"] * SERVE_CONTEXT)]
    return argv


def phase_serve(state: dict, steps: int) -> None:
    """The sampling service through ``serve.build_server`` on the full-width
    flagship under a context mesh of SERVE_CONTEXT ranks on the card, K6's
    ring in every attention call: warm-up, three HTTP requests, /stats, a
    request alone against co-batched, a sample hold against the fp32 plain
    model with the plain ring, and a single-rank service against the ring
    service."""
    import os
    import threading

    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import serve
    from rho_diffusion_tpu_torch.diffusion.sampling_rng import per_sample_keys
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.parallel import active_mesh

    device = torch.device(DEVICE)
    cfg = flagship_config(steps)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    impl_before = os.environ.get("RHO_RING_ATTN_IMPL")
    os.environ["RHO_RING_ATTN_IMPL"] = "rdma"
    t0 = time.perf_counter()
    messages: list = []
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        sd = random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0)
        pth = tmp / "model.pth"
        torch.save(sd, pth)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        server, service = serve.build_server(serve_argv(cfg_path, pth, tmp, SERVE_BUCKETS, True),
                                             log=messages.append)
        build_s = time.perf_counter() - t1
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            requests = []
            for n, seed in ((1, 1), (3, 2), (11, 3)):
                t2 = time.perf_counter()
                reply = http_call(port, "POST", "/generate",
                                  {"conditions": serve_conditions(cfg, n, seed).tolist(),
                                   "seed": seed})
                arr = np.asarray(reply["samples"], np.float32)
                requests.append({
                    "n": n, "seed": seed, "shape": reply["shape"], "bucket": reply["bucket"],
                    "latency_s": reply["latency_s"], "http_s": time.perf_counter() - t2,
                    "split_across_launches": n > SERVE_BUCKETS[-1],
                    "finite": bool(np.isfinite(arr).all()), "mean": float(arr.mean()),
                    "std": float(arr.std())})
            stats = http_call(port, "GET", "/stats")
            torch.cuda.synchronize()
            counts = dict(launch_counts)
            peak = torch.cuda.max_memory_allocated()

            # one request alone, then the same request co-batched with
            # another behind a full launch that keeps the worker busy
            conds4 = serve_conditions(cfg, 4, 20)
            before = dict(launch_counts)
            alone = service.generate(conds4[:1], seed=5)
            per_request = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                           if v > before.get(k, 0)}
            busy = service.submit(serve_conditions(cfg, 8, 30), seed=6)
            mine = service.submit(conds4[:1], seed=5)
            other = service.submit(conds4[1:], seed=7)
            busy.result()
            other.result()
            co = mine.result()
            same = {"alone_bucket": alone.bucket, "cobatched_bucket": co.bucket,
                    "max_abs_diff": float(np.abs(alone.samples - co.samples).max()),
                    "rel_mse": rel_mse(co.samples, alone.samples),
                    "check": "relative MSE of the co-batched rows against the alone ones"}

            # a 25-step batch-2 sample of the ring service against the plain
            # models (bf16 and fp32) with the plain ring, same rows' noise
            conds2 = serve_conditions(cfg, 2, 40)
            got = service.generate(conds2, seed=8).samples
            ref = {}
            with plain_backends(), active_mesh(service.mesh):
                for dt in ("bfloat16", "float32"):
                    pipe = build_pipeline(cfg, dt, device)
                    pipe.load_state_dict(sd)
                    ref[dt] = pipe.reverse_process(
                        pipe.sample_shape(2), torch.from_numpy(conds2).to(device),
                        row_keys=per_sample_keys(8, 2))["denoised"].float().cpu().numpy()
                    del pipe
            k, p = rel_mse(got, ref["float32"]), rel_mse(ref["bfloat16"], ref["float32"])
            bar = min(HOLD_FACTOR * p, HOLD_CAP["sample"])  # every sample check of this phase
            hold = {"kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
                    "kernels_vs_bf16_plain": rel_mse(got, ref["bfloat16"]), "bar": bar,
                    "batch": 2}
            same["bar"] = bar

            # one bucket-8 request: its host-clock time, then profiled
            conds8 = serve_conditions(cfg, 8, 50)
            t3 = time.perf_counter()
            service.generate(conds8, seed=9)
            bucket8_s = time.perf_counter() - t3
            by_name = device_time_by_kernel(lambda: service.generate(conds8, seed=9))
            bucket8 = {"request_s": bucket8_s, **NOT_PROFILED}
            if by_name:
                bucket8 = {"request_s": bucket8_s, **profile_summary(by_name)}
                bucket8.update(
                    device_busy_share=bucket8["busy_ms"] / 1e3 / bucket8_s,
                    ring_attention_ms=sum(ms for name, (ms, _) in by_name.items()
                                          if CUDA_KERNEL["ring_attention"] in name))
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
        ring_s = time.perf_counter() - t0

        # the single-rank service: no mesh, so attention takes the flash kernel
        before = dict(launch_counts)
        server1, single = serve.build_server(serve_argv(cfg_path, pth, tmp, (2,), False),
                                             log=messages.append)
        server1.server_close()
        try:
            flat = single.generate(conds2, seed=8).samples
        finally:
            single.close()
        single_launches = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                           if v > before.get(k, 0)}
        single_vs_ring = {"rel_mse": rel_mse(got, flat),
                          "max_abs_diff": float(np.abs(got - flat).max()),
                          "bar": bar, "launches": single_launches}
    finally:
        if impl_before is None:
            os.environ.pop("RHO_RING_ATTN_IMPL", None)
        else:
            os.environ["RHO_RING_ATTN_IMPL"] = impl_before
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    state["serve_launches"] = counts
    state["serve_per_request"] = per_request
    emit("serve", context_ranks=SERVE_CONTEXT, mesh=stats.get("mesh"), buckets=SERVE_BUCKETS,
         steps=steps, cuts=SERVE_CUTS, build_and_warmup_s=build_s, requests=requests,
         stats=stats, launches=counts, launches_per_bucket1_request=per_request,
         max_memory_allocated=peak, alone_vs_cobatched=same, sample_hold=hold,
         bucket8_request=bucket8,
         single_rank_vs_ring=single_vs_ring, messages=messages, ring_service_s=ring_s,
         seconds=time.perf_counter() - t0)
    problems = []
    for r in requests:
        if r["shape"] != [r["n"], *cfg["model"]["kwargs"]["data_shape"], 1] or not r["finite"]:
            problems.append(f"request {r}")
    missing = [k for k in ("ring_attention", "conv3d_igemm", "conv3d_direct") if not counts.get(k)]
    if missing:
        problems.append(f"the serve path never launched {missing}; counts {counts}")
    if counts.get("flash_attention"):
        problems.append(f"attention left the ring under the context mesh: {counts}")
    if co.bucket < 2 or not same["rel_mse"] <= bar:
        problems.append(f"alone vs co-batched: {same}")
    if not hold["kernels_vs_fp32_plain"] <= hold["bar"]:
        problems.append(f"sample hold: {hold}")
    if not single_launches.get("flash_attention") or single_launches.get("ring_attention") or \
            not single_vs_ring["rel_mse"] <= bar:
        problems.append(f"single-rank service: {single_vs_ring}")
    if problems:
        fail("serve: " + "; ".join(problems))


def conv_cost(key) -> tuple[float, float, float]:
    xs, cout, dt = key
    item = 2 if str(dt).endswith("bfloat16") else 4
    vox = math.prod(xs[:-1])
    cin = xs[-1]
    flops = 2.0 * vox * cout * 27 * cin
    nbytes = item * (vox * cin + 27 * cin * cout + vox * cout + cout)
    return flops, nbytes, PEAK_BF16 if item == 2 else PEAK_FP32


def phase_timings(state: dict, batch: int) -> None:
    """Every kernel at the shapes of one UNet forward at ``batch`` and of
    one training step at TRAIN_BATCH, each held against its plain version on
    the inputs it is timed on; one UNet forward and the reverse process."""
    import torch

    device = torch.device(DEVICE)
    cfg = flagship_config(25)
    pipe = build_pipeline(cfg, "bfloat16", device)
    pipe.load_state_dict(random_state_dict(pipe.backbone, seed=0))
    unet = pipe.backbone
    conv = hold_convs(unet, batch, "forward", device, seed=200, timed=True)
    emit("timings_conv", batch=batch, rows=conv)

    attn_calls = forward_shapes(unet, batch, device)[1]
    (qs, _), _, _ = attn_calls[0]
    b, t, h, d = qs
    n, per = len(attn_calls), f"one UNet forward at batch {batch}"
    flash = [flash_fwd_row(b, t, h, d, n, per, device, torch.bfloat16),
             flash_fwd_row(b, 4096, h, d, 1, per, device, torch.bfloat16,
                           variant="T=4096 (the 64^3 config's attention), one call"),
             flash_fwd_row(b, t, h, d, n, per, device, torch.float32, variant="fp32")]
    emit("timings_flash", rows=flash)
    per_ring = f"one UNet forward at batch {batch} under a context={SERVE_CONTEXT} mesh"
    ring = [ring_row(b, t, h, d, SERVE_CONTEXT, n, per_ring, device, torch.bfloat16),
            ring_row(b, t, h, d, SERVE_CONTEXT, n, per_ring, device, torch.float32,
                     variant="fp32"),
            ring_row(b, 4096, h, d, SERVE_CONTEXT, 1, per_ring, device, torch.bfloat16,
                     variant="T=4096 (the 64^3 config's attention, T/n = 1024), one call")]
    emit("timings_ring", rows=ring,
         launches_per_served_bucket1_request=state.get("serve_per_request"))

    x, t_, y = unet_inputs(unet, batch, device, seed=7)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: unet(x, t_, y), iters=5)
    emit("timings_unet", batch=batch, unet_forward_ms=fwd_ms,
         device_profile=profile_forward(unet, (x, t_, y), fwd_ms))
    emit("timings_sample", **time_sampling(pipe, cfg, samples=4))

    rows = conv + flash + ring + time_train_kernels(unet, TRAIN_BATCH, device)
    record_errors(state, rows)
    state["timings"] = rows
    fail_bad("timings", rows)


def flash_fwd_row(b, t, h, d, calls: int, per: str, device, dtype, variant=None) -> dict:
    """The forward kernel on [b, t, h, d] views of one qkv: held against the
    plain version, timed beside it, SDPA and its bound."""
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

    q, k, v = flash_inputs(b, t, h, d, device, seed=300 + t, dtype=dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    flops = 4.0 * b * h * t * t * d
    item = q.element_size()
    bnd, by = bound_ms(flops, item * 4.0 * b * t * h * d, PEAK_BF16 if item == 2 else PEAK_FP32)
    row = {"kernel": "flash_attention", "variant": variant, "b": b, "t": t, "h": h, "d": d,
           "dtype": dtype_name(dtype), "calls": calls, "per": per,
           **flash_error(flash_attention(q, k, v), xla_attention(qf, kf, vf),
                         TOL_FLASH[dtype_name(dtype)]),
           **kernel_times(lambda: flash_attention(q, k, v), "flash_attention"),
           "plain_ms": cuda_time_ms(lambda: xla_attention(qf, kf, vf), iters=3, warmup=1),
           "library": "scaled_dot_product_attention",
           "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                      iters=10),
           "bound_ms": bnd, "bound_by": by}
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def ring_row(b, t, h, d, n, calls: int, per: str, device, dtype, variant=None) -> dict:
    """K6 in its ring of ``n`` ranks on one card, [b, t, h, d] views of one
    qkv: held against the ring with the plain step, timed beside it (``ms``:
    the device time per call, the ring's n * n kernel durations summed;
    ``step_ms``: one kernel's duration;
    ``call_ms``: the whole call, copies and host work included), SDPA over
    the unsharded inputs, the function's bound and the design's own byte
    floor."""
    import torch.nn.functional as F

    q, k, v = flash_inputs(b, t, h, d, device, seed=700 + t, dtype=dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    mesh = ring_mesh(n, device)
    item = q.element_size()
    flops = 4.0 * b * h * t * t * d
    bnd, by = bound_ms(flops, item * 4.0 * b * t * h * d, PEAK_BF16 if item == 2 else PEAK_FP32)
    # what this design moves: q and the slot read at every rank-step, the
    # fp32 state (acc, m, l) read and written between steps, o written once,
    # and the n (n - 1) slot copies read and written by the copy engines
    shard = b * h * (t // n) * d
    state_bytes = 4 * shard + 8 * b * h * (t // n)
    design_bytes = (n * n * 3 * item * shard + 2 * n * (n - 1) * state_bytes + n * item * shard
                    + n * (n - 1) * 2 * 2 * item * shard)
    times = kernel_times(lambda: ring_call(q, k, v, mesh), "ring_attention")
    row = {"kernel": "ring_attention", "variant": variant, "b": b, "t": t, "h": h, "d": d, "n": n,
           "t_per_rank": t // n, "dtype": dtype_name(dtype), "calls": calls, "per": per,
           **flash_error(ring_call(q, k, v, mesh), ring_call(qf, kf, vf, mesh, plain=True),
                         TOL_FLASH[dtype_name(dtype)]),
           **times, "step_ms": times["ms"] / (n * n),
           "launches_per_call": n * n,
           "plain_ms": cuda_time_ms(lambda: ring_call(qf, kf, vf, mesh, plain=True), iters=3,
                                    warmup=1),
           "library": "scaled_dot_product_attention over the unsharded [B, H, T, D]",
           "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                      iters=10),
           "bound_ms": bnd, "bound_by": by, "design_bytes": design_bytes,
           "design_bytes_ms": design_bytes / MEM_RATE * 1e3}
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def flash_bwd_rows(b, t, h, d, calls: int, per: str, device, dtype, variant=None) -> list:
    """The dkv and dq kernels on [b, t, h, d] (the wrapper computes delta on
    each call, as in training): each held against its plain version on the
    kernel forward's output and LSE, timed beside it and its bound; for bf16
    also SDPA's backward (forward+backward less forward)."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq_plain, flash_attention_bwd_kernel,
        flash_attention_fwd_kernel)

    q, k, v = flash_inputs(b, t, h, d, device, seed=500, dtype=dtype)
    do = randn((b, t, h, d), 501, device, dtype)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    qf, kf, vf, of, dof = (z.float() for z in (q, k, v, o, do))
    lib_ms = None
    if dtype == torch.bfloat16:
        qt, kt, vt = (z.detach().transpose(1, 2).requires_grad_() for z in (q, k, v))
        dot = do.transpose(1, 2)

        def fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        with torch.no_grad():
            fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        lib_ms = cuda_time_ms(fwd_bwd, iters=10) - fwd_ms
    item = q.element_size()
    io = item * b * t * h * d  # one [B, T, H, D] tensor
    tol = TOL_FLASH_BWD[dtype_name(dtype)]
    rows = []
    for name, needs, products, plain, n_out in (
            ("flash_attention_bwd_dkv", (False, True, True), 4, flash_attention_bwd_dkv_plain, 2),
            ("flash_attention_bwd_dq", (True, False, False), 3, flash_attention_bwd_dq_plain, 1)):
        def run(needs=needs):
            return flash_attention_bwd_kernel(q, k, v, o, lse, do, needs)

        want = plain(qf, kf, vf, of, lse, dof)
        errs = [flash_error(g, w, tol) for g, w in
                zip([g for g in run() if g is not None], want if n_out == 2 else (want,))]
        # the kernel's own products of 2*T*T*D each; q, k, v, dO, lse,
        # delta read once, its gradients written once
        flops = products * 2.0 * b * h * t * t * d
        bnd, by = bound_ms(flops, 4 * io + 2 * 4 * b * h * t + n_out * io,
                           PEAK_BF16 if item == 2 else PEAK_FP32)
        row = {"kernel": name, "variant": variant, "b": b, "t": t, "h": h, "d": d,
               "dtype": dtype_name(dtype), "calls": calls, "per": per,
               **max(errs, key=lambda e: (not e["ok"], e["err_over_tol"])),
               **kernel_times(run, name),
               "plain_ms": cuda_time_ms(lambda: plain(qf, kf, vf, of, lse, dof), iters=3,
                                        warmup=1),
               "library": "scaled_dot_product_attention backward (dq, dk, dv together)",
               "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by}
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
    return rows


def time_train_kernels(unet, batch: int, device) -> list:
    """The kernels at the shapes of one training step at ``batch``: every
    forward conv held against its plain version; every dgrad conv and both
    flash backward kernels held and timed, per step."""
    import torch

    forward = hold_convs(unet, batch, "forward", device, seed=600, timed=False)
    dgrad = hold_convs(unet, batch, "dgrad", device, seed=400, timed=True)
    emit("timings_dgrad", batch=batch, rows=dgrad, forward_holds=forward)
    attn_calls = forward_shapes(unet, batch, device)[1]
    (qs, _), _, _ = attn_calls[0]
    n, per = len(attn_calls), f"one training step at batch {batch}"
    flash = (flash_bwd_rows(*qs, n, per, device, torch.bfloat16)
             + flash_bwd_rows(*qs, n, per, device, torch.float32, variant="fp32"))
    emit("timings_flash_bwd", rows=flash)
    return forward + dgrad + flash


# name, source in csrc/, the TPU kernel it replaces, and the path that runs it
KERNELS = (
    ("conv3d_igemm", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:102", "sampling"),
    ("conv3d_direct", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:102", "sampling"),
    # one CUDA kernel replaces both TPU forward kernels (K1 one-pass, K2
    # multi-block, :59): its K/V-tile loop runs 8 times at T=512, 64 at T=4096
    ("flash_attention", "flash_attention.cu",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:115", "sampling"),
    ("conv3d_dgrad_igemm", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:247", "training"),
    ("conv3d_dgrad_direct", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:247", "training"),
    ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "training"),
    ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:262", "training"),
    # K6: the ring's fold of one K/V slot; the ring itself is copies on the
    # ranks' comm streams (parallel/context_rdma.py)
    ("ring_attention", "ring_attention.cu", "rho_diffusion_tpu/parallel/context_rdma.py:50",
     "serving"),
)
TIME_FIELDS = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms")


def summed_times(rows: list) -> dict:
    """The times of ``rows`` summed over their calls, and what sets the
    summed bound."""
    out = {f: None if any(r[f] is None for r in rows) else sum(r[f] * r["calls"] for r in rows)
           for f in TIME_FIELDS}
    ops = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "operations")
    out["bound_by"] = "operations" if ops >= out["bound_ms"] / 2 else "bytes"
    out["ms_of"] = " / ".join(sorted({r["ms_of"] for r in rows}))
    return out


def kernels_line(state: dict) -> list:
    """The ``kernels`` line: per kernel, its launches on the path that runs
    it (sampling for the forward kernels, training for the backward ones,
    serving for K6; every path listed), its worst error against its plain version over every
    hold of this run and that error's ratio to the check's tolerance (at
    most 1), and its times summed over one UNet forward (timing batch) or
    one training step (TRAIN_BATCH); other dtypes and T as ``variants``."""
    launches = {"sampling": state["launches"], "training": state["train_launches"],
                "serving": state["serve_launches"]}
    out = []
    for name, source, replaces, path in KERNELS:
        rows = [r for r in state["timings"] if r["kernel"] == name and r.get("calls")]
        main = [r for r in rows if not r["variant"]]
        accuracy = state["err"][name]
        out.append({
            "name": name, "route": "cuda", "source": f"rho_diffusion_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[path].get(name, 0),
            "launches_by_path": {p: counts.get(name, 0) for p, counts in launches.items()},
            "max_abs_err": max(v["max_abs_err"] for v in accuracy.values()),
            "err_over_tol": max(v["err_over_tol"] for v in accuracy.values()),
            "accuracy_by_dtype": accuracy, **summed_times(main), "library": main[0]["library"],
            "per": f"{main[0]['per']}, {sum(r['calls'] for r in main)} calls",
            "variants": [{"variant": r["variant"], **summed_times([r])}
                         for r in rows if r["variant"]],
        })
    return out


def device_time_by_kernel(fn) -> dict:
    """{kernel name: (device ms, launches)} of one call of ``fn`` (in the
    caller's grad mode), from torch.profiler's CUDA events; empty when the
    profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    import torch

    with torch.no_grad():
        by_name = device_time_by_kernel(lambda: unet(*inputs))
    if not by_name:
        return NOT_PROFILED
    summary = profile_summary(by_name)
    return {**summary, "busy_share_of_forward": summary["busy_ms"] / fwd_ms}


def profile_summary(by_name: dict) -> dict:
    """Device-busy ms, kernels, launches and the 15 longest kernels of one
    ``device_time_by_kernel`` profile."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"busy_ms": sum(ms for ms, _ in by_name.values()), "kernels": len(by_name),
            "launches": sum(n for _, n in by_name.values()),
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
    # fp32 plain versions and fp32 library calls in full fp32 (the matmul
    # flag is torch's default). What the port runs is the same either way:
    # its only fp32 cuDNN call, the head's wgrad, turns TF32 off itself.
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
    if "train" in phases:
        phase_train(state, TRAIN_BATCH)
    if "hold" in phases:
        phase_hold(state)
    if "serve" in phases:
        phase_serve(state, args.steps)
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
