#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phases env,build,kernels,main,main64,gauss,vlb,train,data,hold,serve,load,utils,int8,vit,diffusers,quality,quality_2d1d,timings,fp32,bench]
                          [--steps 25] [--samples 4] [--timing-batch 8]

Builds the port's CUDA kernels from ``rho_diffusion_tpu_torch/csrc`` (and
prints the registers and spills of K5's, K7-K9's, the flash forward's and
the fused flash backward's instances from ptxas), holds each (forward and backward,
bf16 and fp32) against its plain PyTorch version at the shapes the
flagship UNet (and the 64^3 config's level 0 and attention) gives it, and
drives the port's paths on the flagship config
(``examples/config_spherical_harmonics.json`` at full width, random seeded
weights loaded from a reference-layout ``.pth``):

* ``main``: sampling through ``rho_diffusion_tpu_torch.inference.main``;
* ``main64``: the same entry on ``examples/config_spherical_harmonics_64.json``
  at full width (64^3 fields, MultiEmbeddings conditioning, 4 heads of 128
  over 4096 tokens, batch 8 as configured, bf16), its schedule cut to 21
  steps; a 64^3 forward held against the fp32 plain model at batch 1, and a
  batch-8 forward timed with its device-busy share;
* ``gauss``: GaussianDiffusion sampling at full width through three entry
  points: the bench entry ``python -m rho_diffusion_tpu_torch.bench`` (run
  through its ``main``: DDIM-50 and dpm++-10 samples of the flagship UNet at
  batch 8, and its train mode at batch 32; its JSON lines inside the
  phase's), the inference CLI on ``examples/config_learned_variance.json``
  (16^3, learned_range variance, attention over 256 tokens at head dim 64,
  its 'ddpm' sampler respaced to 50 steps, 16 samples) and the service
  (``serve.build_server`` on that config, ``--sampler ddim --steps 50``,
  buckets 1 and 8, a request of each over HTTP, a row alone against
  co-batched); held against the fp32 plain model: a flagship DDIM-50
  sample at batch 2 from one x_T, the learned-variance UNet's kernels at
  the CLI's batch-16 shapes (every conv, the Cout=2 fp32 head among them,
  and K1 at 256 tokens, D = 64), its forward per output channel (mean and
  variance) and its 'ddpm' sample with per-row keys, and a served DDIM-50
  sample; and per path the wall time, the UNet
  forward's share of a step, the sampler arithmetic's own device time per
  step (dynamic thresholding's torch.quantile included) and the device's
  busy share of one sample;
* ``vlb``: GaussianDiffusion's training half on
  ``examples/config_learned_variance.json`` at full width (16^3, width 64,
  channel_mult (1, 2, 4), attention over 256 tokens at head dim 64,
  learned_range variance, rescaled_mse, out_channels 2, bf16, batch 32):
  one epoch through ``rho_diffusion_tpu_torch.training``'s ``main`` with
  the dataset cut to 256 items (8 steps), its steps/s, peak memory and one
  profiled step's device busy share; ``rho_diffusion_tpu_torch.evaluate``
  with ``--bpd --num-batches 1`` on the trained EMA weights (validation,
  a DDIM-50 generate at batch 8, the 1000-step VLB loop at batch 4, each
  part timed); RePaint inpainting of 8 rows (ddpm respaced to 50, 2
  rounds a step, half the volume kept, that half checked exact) and DDIM-50
  encoding and decoding of 4 rows; held against the fp32 plain model: the
  hybrid loss and its parameter gradients at batch 2 and ``vb_terms_bpd``
  at t = 0, 1, 500 and 999; the head's Cin = 2 fp32 dgrad (the direct
  kernel's general configuration) against its plain version, timed beside
  conv3d_input; the fused K3/K4 at (B 32, T 256, H 4, D 64) twice
  (bitwise), and K1 and K3/K4 timed there beside SDPA;
* ``train``: five DDPM training steps at batch 32 through
  ``rho_diffusion_tpu_torch.training``'s ``main``, the checkpoint read back
  to the trainer's EMA weights, and one profiled step;
* ``data``: the data layer at full width. ``config_deep_galaxy.json``
  (2-D 128^2, MultiEmbeddings over (s, m, t, c), batch 64, bf16) and
  ``config_spectroscopy.json`` (1-D, 4096 points, batch 32) each trained
  through ``Trainer`` for whole epochs to at least DATA_TRAIN_STEPS steps
  from seeded random weights, on the port's DeepGalaxyDataset and
  SpectroscopyDataset over files its writers (galaxy_synth, spectro_synth)
  write where the host has h5py, else on the same items built in memory
  (``benchmarks._corpus``'s ``GalaxyFrames``, ``RotorSpectra``; the
  ``data_route`` line says which,
  and whether the native Ylm library built); each then sampled through the
  inference CLI from the trained weights (DDPM, the schedule cut to 21
  steps; DeepGalaxy's 63 rows of its ``inference.parameter_space``), its
  forward held against the fp32 plain model, its host's batch build timed
  and one step profiled; ``config_spherical_harmonics_quality.json``
  trained one epoch (31 steps) under its ``training.device_cache: true``;
  the bench entry's realdata mode without and with BENCH_DEVICE_CACHE=1,
  one run each, each mode's device time per step from two profiled runs; and K1
  and the fused K3/K4 held and timed at the 2-D and 1-D attention (D = 64,
  T = 256 and 512);
* ``serve``: the sampling service through ``rho_diffusion_tpu_torch.serve``'s
  ``build_server`` under a ("data", "context") mesh of 4 context ranks on
  the card, with ``RHO_RING_ATTN_IMPL=rdma``, so every attention call runs
  the ring with the kernel K6; buckets 1, 2, 4, 8 warmed up, three requests
  over HTTP (n = 1, 3 and 11, the last split across launches), a request
  alone against the same request co-batched, a sample held against the
  fp32 plain model with the plain ring, and a single-rank service (the
  flash kernel's route) against the ring service, bucket-1 latencies of
  both, and a profiled bucket-8 request (its device busy share);
* ``load``: the serving load harness
  (``rho_diffusion_tpu_torch.benchmarks.serve_bench``) at its defaults: its
  service (32^3 UNetv2 at full width, bf16, DDIM-50, buckets 1 and 8) over
  seeded random weights, 8 requests one at a time (p50 latency) and 32
  concurrent one-sample requests (volumes/s, mean occupancy, launches, the
  device's busy share), and one served row held against the fp32 plain
  model;
* ``utils``: the training utilities: the op table
  (``rho_diffusion_tpu_torch.benchmarks.op_table``) of the flagship's
  training step at batch 32 (device time by kernel group, by operator and
  GroupNorm32's share); 64^3 training through the bench entry's train mode
  with BENCH_REMAT=1 at batch 8, and at batch 4 with and without it
  (steps/s, peak bytes; K2 and the fused backward at T = 4096); one loss's
  gradients at 64^3 with recomputation against without (and peak bytes);
  the ten optax optimizers, three steps each on the flagship's distinct
  parameter shapes, on the card against the CPU; and the training CLI with
  ``--profile`` for two steps, its trace read back;
* ``int8``: W8A8 inference on the flagship at full width (bf16 model, int8
  convs and Dense sites): every int8 conv problem of a batch-8 forward on
  its kernel (S1, the s8 implicit GEMM on K5's block, for the stride-1
  convs; ``conv3d_s8_strided``, S1's block with a strided x map, for the
  three (1, 2, 2) Downsamples, also held bitwise against S2 and timed beside
  it), S2 at a 2-D, a 1-D and a Cin = 24 problem (its launches there are its
  count's, ``int8_s2``: no path runs S2), and S3 (the quantiser's
  two launches) at every activation shape and at fp32 weights, each held
  bitwise (int32 sums and dequantised output) against its plain version and
  timed beside its bound (int8 at 1,979 TOPS, or bytes), its plain version
  and, for S1, K5's bf16 conv of the same shape; the bf16 Cout = 1 head
  problem on K5's igemm; the Dense sites' ``torch._int_mm``; then the
  counted paths: the inference CLI with ``--quant int8`` (the schedule cut
  as ``main``'s; the strided route three times a forward and S2 never),
  its int8 sites per forward against the recorded forward's; the 2-D
  path, the same CLI on the 2-D DeepGalaxy config at full width (128^2,
  width 32, DATA_SAMPLE_STEPS steps, every int8 conv on S1's block over
  the 1x3x3 taps, ``conv2d_s8`` and ``conv2d_s8_strided``, and none on
  S2), and the 1-D path, the CLI on the 1-D Spectroscopy config (4096
  points, width 32, every int8 conv on S1's block over the 1x1x3 taps,
  ``conv1d_s8`` and ``conv1d_s8_strided``, and none on S2), each path's
  problems held bitwise (against S2 on the same inputs too) and timed
  (beside S2 and cuDNN's bf16 conv2d or conv1d), each path's own forward
  timed in bf16 and int8 with device profiles; a batch-4 int8
  forward on the kernels against the int8 plain model (the ``hold`` rule)
  and its distance to the fp32 float model; the batch-8 forward's time in
  bf16 and int8 (in turns) with device profiles; and the serving load
  harness at its defaults in bf16 and with SERVE_QUANT=int8, one after the
  other;
* ``vit``: the other backbones. The bench entry with BENCH_MODEL=vit at the
  root bench.py's full width (32^3, patch 8, embedding 256, hidden 512,
  depth 8, 16 heads: head dim 16 over 64 tokens, so the narrow flash
  forward and the small backward, one launch a call, and no mma.sync
  forward; batch 32, bf16, AdamW, EMA 0.9999); the same ViT at patch 4 (512
  tokens, past the small route: the narrow forward and the long backward,
  one launch a call each, and no dkv/dq pair launch),
  VIT_PATCH4_STEPS training steps; the training CLI on the flagship config with that ViT,
  FourierConditioning on the raw (l, m) rows (5 steps at batch 32, one
  checkpoint), then the inference CLI's DDPM-25 at batch 4 on it; the
  ViT's bf16 forward and one loss's gradients held against the fp32 plain
  model, the forward and the small backward held at (32, 64, 16, 16) and
  a ragged T = 50, the long backward at T = 256 and at patch 4's (32,
  512, 16, 16), each twice bitwise and against the pair on request too,
  the narrow forward with and without the LSE at T = 64, 512, a ragged 65
  and D = 32, twice bitwise and beside the mma.sync kernel on request,
  and timed at the ViT's attention beside SDPA and their bound (device
  time of whole calls from CUDA graphs too; the forward's bound the
  largest of its exponentials, products and bytes), the long backward
  (its bound likewise), the narrow forward, the mma.sync forward and the
  pair on request at patch 4's attention; the SimpleUNet
  ("UNet") in 3-D at 32^3 with JAX's default widths in bf16: 3 training
  steps at batch 8, a DDPM-25 sample at batch 2 through ``reverse_process``,
  its forward and gradients held, and its K5 problems (concat inputs of 512
  and 256 channels among them) held and timed, forward and dgrad;
* ``diffusers``: the diffusers-compatible backbone and pipeline, and
  progressive distillation. ``config_deep_galaxy.json`` (128^2, batch 64,
  bf16) with UNet_Diffuser for its model (UNet2DModel's (32, 64, 64)
  architecture, heads of 8 channels) and DiffusersDDPMPipeline for its
  pipeline (v prediction, fixed_small): DIFF_TRAIN_STEPS training steps
  through Trainer on the data phase's route (HDF5 or in memory) from seeded
  random weights, one more step timed and profiled (its attention's share
  of the device time), the inference CLI's DDIM-10 at batch 8 from the
  trained weights, the forward, one loss's gradients and a DDIM-10 sample
  held against the fp32 plain model; its attention (8 heads of 8, padded to
  16, over 64^2 and 32^2 tokens) runs the narrow forward and the long
  backward only, 11 of each a step, and each is held (its first rows
  against the plain version, twice bitwise) and timed at B*H 512 and T 4096
  and 1024 beside the plain version, SDPA and its exponentials' bound, with
  the long backward's memory at T 4096; then the distill CLI
  (``python -m rho_diffusion_tpu_torch.distill``) on
  ``config_learned_variance.json`` (8 -> 2, 3 updates a stage, from a
  seeded random teacher ``.pth``), each update three forwards and one
  backward on K5, K1 and the fused K3/K4 (counted against a training
  step's), the inference CLI on the student at DDIM-2 trailing, one
  update's loss and student gradients held, an update's time beside a
  training step's;
* ``quality``: the eight 3-D Y_lm quality harnesses
  (``python -m rho_diffusion_tpu_torch.benchmarks.<name>``, run through
  their ``main``) at full width on the card with their budgets cut
  (``QUALITY_RUNS``: tens of training steps, a distillation cascade of two
  stages, a wall budget of seconds for the ViT/UNet A/B, two 64^3 steps at
  batch 8 without recomputation, every sampler capped at
  ``QUALITY_MAX_STEPS`` steps); each report must carry the JAX script's
  keys and finite samples, and each harness's launches must include its
  kernels: K5 and the direct convs, K1 at T 256 (D 64) and the fused
  K3/K4 on the 16^3 model, K2 at T 4096 and K3/K4 on demo64's, the narrow
  forward at T 64 (D 32) and the small backward in the ViT's run, S1, its
  strided Downsample and S3 in sampler_quality's int8 rows, where S2 is
  counted and must stay at 0 (the 16^3 model's Cin 1 input and Cout 1 head
  stay float); then the 16^3 UNet's training step at batch 8 and 16 timed
  (CUDA events) beside its profiled device-busy time, and the kernels held
  at the harnesses' own shapes: K1 and the fused K3/K4 at B*H 32 (T 256, D
  64), the narrow forward and small backward at the ViT's D 32, T 64, the
  16^3 UNet's conv problems at batch 8 (forward and dgrad) and its int8
  convs and quantiser shapes (bitwise);
* ``quality_2d1d``: the six 2-D/1-D quality harnesses through their
  ``main`` at full width (the DeepGalaxy UNet at 128^2, width 32, batch 25
  and 30; the Spectroscopy UNet at grid 1024, width 32, batch 16) on their
  in-memory corpora (each rendered once), budgets cut (``CORPUS_RUNS``:
  one or two epochs, every sampler capped at ``CORPUS_RUN_STEPS`` steps;
  demo_galaxy2d in both recipes, galaxy_dc_probe on the reference run's
  weights, spectro_rescore on demo_spectro1d's checkpoint, both
  conditioners of demo_spectro_cond, demo_generalization's default one);
  each report
  must carry the JAX script's keys, finite samples and the memory route,
  and each run's launches: K1 six a forward (wgmma, T 256 in 2-D, 128 in
  1-D), the fused K3/K4 and its delta pre-pass once for each K1 launch of a
  training forward, no dkv/dq pair; then each training harness's step
  timed (CUDA events) beside its profiled device-busy time, and K1 and the
  fused K3/K4 held and timed at their shapes (D 64: B*H 100 and 120 at T
  256, 64 at T 128); the flagship in fp32 (a config whose ``training.dtype`` is
  float32): every distinct conv problem of a batch-8 forward and of a
  batch-32 step's dgrad (the 3xTF32 implicit GEMM where Cin % 4 == 0 and
  Cout > 1, its weight pre-pass, the direct kernel elsewhere), the flash
  forward (K6's 3xTF32 fold with one shard, and its K/V pre-pass) and
  backward (the 3xTF32 dkv/dq pair and its pre-pass) at batch 8 and 32,
  each beside the FMA kernels it replaced, and K6 at the serve shape (its
  3xTF32 fold and pre-pass), each held against its plain version and timed
  beside cuDNN (TF32 off) or SDPA in fp32 (its kernels named) and its
  bound (3xTF32: 3 flops at the TF32 peak; the FMA line beside it); the
  whole fp32 model (a forward and one loss's gradients at batch 2) against
  the fp32 plain model, beside the plain model with one TF32 product as
  the control; then the counted path: the bench entry with
  BENCH_DTYPE=float32 (train mode at batch 32, with the next batch down if
  it does not fit, one step profiled by group; a DDIM-10 sample at batch 8;
  each run fails if it never launched the fp32 flash routes' kernels)
  and one request to the fp32 service under the context=4 ring;
* ``bench``: the conv bottleneck-isolation entry
  (``python -m rho_diffusion_tpu_torch.benchmarks.conv3d_variants``) with
  every variant and bigdot at td 1, 2, 4 and 8 at the level-1 shape, so
  K7-K9 launch (all on K5's TMA/wgmma block); then each of their kernels
  held against its plain version on the inputs the entry times it on, and
  timed there; K7 ``full`` against K5 at that shape (the same code: equal
  outputs, times taken in turns), and K5's plan against other N tiles and
  ring depths per level;
  every plan of the flash forward's wgmma route and its old mma.sync
  kernel timed at K1's and K2's shapes (``bench_flash_plans``), and the
  fused flash backward against the mma.sync pair at the training step's
  and T = 4096 (``bench_flash_bwd_plans``); then the
  entry's two companions, K5 against cuDNN per shape
  (``conv3d_ab``) and per UNet level beside the equal-FLOP matmul
  (``conv_profile``); the two phrasing studies at level 1 (``conv_zfold``:
  K5, cuDNN, the z-fold, the 2-D decomposition, forward and with the input
  gradient; ``conv_dimnum_sweep``: cuDNN's phrasings beside K5); and one
  flagship forward in a child process under ``RHO_CONV3D_VIA_2D=1``, which
  must launch neither conv kernel and hold each of its 3x3x3 convs against
  K5 (or, strided, cuDNN) at the bf16 conv tolerance.

Each path's launch counts are cleared just before it and read just after,
and it fails if a kernel of the path never launched. ``hold`` holds one
full-width UNet forward, a reverse process and one training loss's
gradients on the kernels against the plain versions; ``timings`` holds each
kernel against its plain version again at the shapes of one UNet forward
(batch 8) and of one training step (batch 32), and times it there (its
device time from torch.profiler, and the wrapper call) beside the plain
version, a PyTorch library call and its bound; then one UNet forward (with
a torch.profiler breakdown by kernel) and the whole reverse process. The
``kernels`` phase also holds the flash forward at every plan of its wgmma
route (and its mma.sync kernel), with and without the LSE, at T = 512
(batch 4, 8, 32), 4096 (batch 8) and 300, D = 128 and 64, its narrow
route beside the mma.sync kernel at the ViT's (32, 64, 16, 16) and (32,
512, 16, 16) and a ragged (2, 300, 4, 32), and the
backward (the fused kernel for bf16 and the 3xTF32 pair for fp32 at D =
64 and 128, the FMA pair elsewhere) at the training step's attention,
T = 4096, T = 300 and D = 64, twice (bitwise) and against the pair each
replaced (mma.sync, FMA), K1 and the fused backward in bf16 at the data
phase's attention (D = 64: B*H 256 at T = 256, 128 at T = 512), the fp32
forward's 3xTF32 route with and without the LSE at T = 512 (batch 8, 32),
4096, 300 and D = 64 beside the FMA kernel, and the 3xTF32 pieces:
the products alone in both operand layouts (``tf32_probe``), all four
pre-passes bitwise against their plain versions, every fp32 conv problem of
the flagship at batch 2 and K6's fp32 fold at T = 512, 4096 and a ragged
300 (the FMA fold at D = 32 and 256). Every
phase prints one JSON line; a failing phase exits
non-zero. The last line is ``{"ok": true, "device": {...}}``, after the
``kernels`` line and the card's ``nvidia-smi`` name and power limit. A run
whose ``--phases`` leave out any of kernels, main, main64, gauss, vlb,
train, data, serve, load, utils, int8, vit, diffusers, quality, quality_2d1d, timings, fp32
and bench prints
neither and exits 3. The ``done`` line gives each phase's seconds.

Exits non-zero without a result when CUDA is unavailable or the script runs
outside a checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "examples" / "config_spherical_harmonics.json"
CONFIG64 = ROOT / "examples" / "config_spherical_harmonics_64.json"
GAUSS_CONFIG = ROOT / "examples" / "config_learned_variance.json"
DEEP_GALAXY_CONFIG = ROOT / "examples" / "config_deep_galaxy.json"
SPECTRO_CONFIG = ROOT / "examples" / "config_spectroscopy.json"
QUALITY_CONFIG = ROOT / "examples" / "config_spherical_harmonics_quality.json"
PHASES = ("env", "build", "kernels", "main", "main64", "gauss", "vlb", "train", "data", "hold",
          "serve", "load", "utils", "int8", "vit", "diffusers", "quality", "quality_2d1d",
          "timings", "fp32", "bench")
# the phases whose numbers the kernels line carries
KERNELS_LINE_PHASES = ("kernels", "main", "main64", "gauss", "vlb", "train", "data", "serve",
                       "load", "utils", "int8", "vit", "diffusers", "quality", "quality_2d1d",
                       "timings", "fp32", "bench")
DEVICE = "cuda"
# the train phase: the flagship's batch, and steps cut to five
TRAIN_BATCH = 32
TRAIN_STEPS = 5
# the serve phase: context ranks of the ring, all on one card, and buckets
SERVE_CONTEXT = 4
SERVE_BUCKETS = (1, 2, 4, 8)
# the 64^3 config's level-0 conv input at batch 1 (64 -> 64 channels)
LEVEL0_64 = (1, 64, 64, 64, 64)
# the main64 phase: the fewest steps at which the 64^3 config's linear betas
# (1e-3 to 0.02, scaled by 1000/T) stay below 1, and its hold's batch
MAIN64_STEPS = 21
MAIN64_HOLD_BATCH = 1
# the flash forward's holds at every plan: (batch, tokens, heads, head dim)
# of K1 at sampling batch 4, timing batch 8 and the training step's 32, of
# K2 at the 64^3 config's 4096 tokens, a ragged T and D = 64
# the narrow route's holds beside the mma.sync kernel: the ViT's attention
# at patch 8 and patch 4, and a ragged T at D = 32
NARROW_PLAN_SHAPES = ((32, 64, 16, 16), (32, 512, 16, 16), (2, 300, 4, 32))
FLASH_PLAN_SHAPES = ((4, 512, 4, 128), (8, 512, 4, 128), (32, 512, 4, 128), (8, 4096, 4, 128),
                     (2, 300, 4, 128), (2, 300, 2, 64))
# the kernels phase's holds at the data phase's attention (batch, tokens):
# DeepGalaxy's 16^2 tokens at batch 64, Spectroscopy's 512 at batch 32
DATA_ATTENTION = ((64, 256), (32, 512))
# the gauss phase: the bench entry's runs (environment over its defaults),
# the respaced steps of the CLI and the service, the service's buckets, and
# the batch of the sample holds (the flagship's DDIM-50, the CLI's ddpm)
GAUSS_BENCH_RUNS = (
    ("sample", {"BENCH_MODE": "sample"}),
    ("sample_dpmpp10", {"BENCH_MODE": "sample", "BENCH_SAMPLER": "dpm++",
                        "BENCH_DDIM_STEPS": "10"}),
    ("train", {"BENCH_MODE": "train"}),
)
GAUSS_STEPS = 50
GAUSS_BUCKETS = (1, 8)
GAUSS_HOLD_BATCH = 2
# the steps of a sampler loop whose device time is read as the arithmetic's
GAUSS_ARITH_STEPS = 5
# the bench phase: every variant of the bottleneck-isolation entry
BENCH_VARIANTS = ("full", "nopatch", "nodma", "dotsonly", "bigdot1", "bigdot2", "bigdot4",
                  "bigdot8")
# device time of the profiled training step, grouped by kernel name
DEVICE_TIME_GROUPS = (
    ("conv3d_igemm (port, forward and dgrad)", ("conv3d_igemm",)),
    # before the tf32 conv's group, whose "tf32_split" the flash pre-passes' names hold
    ("flash attention (port, forward and backward)", ("flash_fwd", "flash_bwd")),
    ("conv3d_tf32 (port, fp32 forward and dgrad, with its weight split)",
     ("conv3d_tf32", "tf32_split")),
    ("conv3d_direct (port, forward and dgrad)", ("conv3d_direct",)),
    ("conv weight gradients (cuDNN)", ("wgrad",)),
    ("strided Downsample conv (cuDNN)", ("xmma_fprop", "xmma_dgrad", "implicit_gemm",
                                         "conv2d", "conv3d_fprop")),
    ("matmuls (cuBLAS: qkv, proj_out, skip, time MLP)", ("gemm", "cutlass", "sm90_xmma_gemm")),
    ("AdamW and EMA (multi_tensor_apply)", ("multi_tensor_apply",)),
)

# The card's published dense peaks (H100 SXM data sheet) and memory rate;
# the special-function unit's ex2 throughput, 16 a clock an SM (the CUDA C
# programming guide's throughput table for compute capability 9.0).
SFU_EX2_PER_CLOCK_SM = 16
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
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
# the fused backward's delta pre-pass against flash_delta, the same two
# relative bounds: both sum the same exact fp32 products of bf16 inputs, in
# another order (~D 2^-24 of the terms, below 1e-5 of max |delta| here); a
# dropped channel or a wrong row would be off by O(1)
TOL_DELTA = 1e-4
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


def card_state() -> dict:
    """The card's SM and memory clocks, power draw, temperature and active
    clock-event reasons as nvidia-smi reports them now, the caching
    allocator's reserved bytes and allocation retries, and the host's side:
    this process's Python threads, its live child processes and the load
    average: what a time taken late in a run is compared by. nvidia-smi's
    refusal is recorded, not raised."""
    import multiprocessing
    import os
    import threading

    import torch

    fields = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    stats = torch.cuda.memory_stats()
    state = {"memory_reserved": torch.cuda.memory_reserved(),
             "alloc_retries": stats.get("num_alloc_retries", 0),
             "python_threads": threading.active_count(),
             "child_processes": len(multiprocessing.active_children()),
             "load_average_1m": os.getloadavg()[0]}
    if out.returncode:
        return {**state, "nvidia_smi": out.stderr.strip() or out.stdout.strip()}
    values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return {**state, **dict(zip(fields, values))}


@functools.cache
def sm_max_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it (``clocks.max.sm``):
    the clock at which the exponentials' bound is counted."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def exp_bound_ms(b: int, h: int, t: int, device) -> float:
    """The least time of an attention call's T^2 exponentials a batch*head
    on the special-function unit: SFU_EX2_PER_CLOCK_SM ex2 a clock an SM at
    the card's maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return b * h * t * t / (SFU_EX2_PER_CLOCK_SM * sms * sm_max_clock_hz()) * 1e3


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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events. The
    host's work is not in it, and no launch is missed as the profiler can."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_ms(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn``: the calls are issued while the card
    is kept busy (``torch.cuda._sleep``), so none waits for the device;
    ``calls`` is kept small enough that the launch queue never fills."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time ahead of the calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_mem = flops / peak, nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def dtype_bound(flops: float, nbytes: float, item: int) -> dict:
    """The least time of a function of ``flops`` and ``nbytes`` on this card
    in a dtype of ``item`` bytes. bf16: the tensor cores' peak. fp32: three
    TF32 products for each fp32 product (3xTF32, the split that keeps fp32's
    accuracy on the tensor cores), so 3 flops at the TF32 peak: the least
    time in which this card reaches fp32 accuracy; the CUDA cores' fp32 FMA
    line beside it (``bound_fma_ms``)."""
    if item == 2:
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        return {"bound_ms": bnd, "bound_by": by}
    bnd, by = bound_ms(3 * flops, nbytes, PEAK_TF32)
    return {"bound_ms": bnd, "bound_by": by, "bound_fma_ms": bound_ms(flops, nbytes, PEAK_FP32)[0]}


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
            self.calls.append(tuple((tuple(a.shape), a.dtype) if hasattr(a, "shape") else a
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
    # K5's instances (N tile x ring depth): registers and spills from ptxas -v
    k5 = [{"bn": int(m[1]), "stages": int(m[2]), **entry}
          for name, entry in ptxas_entries(_build.build_log.get("conv3d", "")).items()
          for m in [re.search(r"conv3d_igemm_wgmma_kernelILi(\d+)ELi(\d+)E", name)] if m]
    emit("k5_ptxas", kernels=k5 or "not built in this run (a cached library has no ptxas log)")
    # K7's variants and K8/K9's dense GEMM on K5's block, by N tile
    kv = [{"kernel": m[1], "bn": int(m[2]), **entry}
          for name, entry in ptxas_entries(_build.build_log.get("conv3d_variants", "")).items()
          for m in [re.search(r"(conv3d_(?:variant_\w+?|bigdot_gemm|dotsonly))_kernelILi(\d+)E",
                              name)] if m]
    emit("variants_ptxas",
         kernels=kv or "not built in this run (a cached library has no ptxas log)",
         spill_free=all(not e.get("spill_stores") and not e.get("spill_loads") for e in kv))
    # the flash forward's wgmma instances (head dim, query rows, keys a
    # tile), and any ptxas reports as serialising its wgmma
    log = _build.build_log.get("flash_attention", "")
    fa = [{"hd": int(m[1]), "bm": 64 * int(m[2]), "bn": int(m[3]), **entry}
          for name, entry in ptxas_entries(log).items()
          for m in [re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)] if m]
    # the narrow forward's instances (head dim 16 and 32; 64 query rows a
    # warpgroup, 64 keys a tile)
    fa += [{"kernel": "flash_fwd_narrow", "hd": int(m[1]), "bm": 64, "bn": 64, **entry}
           for name, entry in ptxas_entries(log).items()
           for m in [re.search(r"flash_fwd_narrow_kernelILi(\d+)E", name)] if m]
    serialized = [ln.split("'")[1] for ln in log.splitlines() if "C7512" in ln and "'" in ln]
    emit("flash_ptxas", kernels=fa or "not built in this run (a cached library has no ptxas log)",
         wgmma_serialized=serialized)
    # the fused flash backward's instances (head dim, its keys a block)
    log = _build.build_log.get("flash_attention_bwd", "")
    fb = [{"hd": int(m[1]), "bn": int(m[1]), **entry}
          for name, entry in ptxas_entries(log).items()
          for m in [re.search(r"flash_bwd_wgmma_kernelILi(\d+)E", name)] if m]
    # the small backward's instances (head dim 16 and 32, 64 keys a warpgroup)
    fb += [{"kernel": "flash_bwd_small", "hd": int(m[1]), "bn": 64, **entry}
           for name, entry in ptxas_entries(log).items()
           for m in [re.search(r"flash_bwd_small_kernelILi(\d+)E", name)] if m]
    # the long backward's (head dim 16 and 32, 128 keys a block)
    fb += [{"kernel": "flash_bwd_long", "hd": int(m[1]), "bn": 128, **entry}
           for name, entry in ptxas_entries(log).items()
           for m in [re.search(r"flash_bwd_long_kernelILi(\d+)E", name)] if m]
    serialized = [ln.split("'")[1] for ln in log.splitlines() if "C7512" in ln and "'" in ln]
    emit("flash_bwd_ptxas",
         kernels=fb or "not built in this run (a cached library has no ptxas log)",
         wgmma_serialized=serialized)
    # the 3xTF32 instances: K5's fp32 block by N tile and ring depth, K6's
    # fp32 fold by head dim
    tf = [{"kernel": "conv3d_tf32", "bn": int(m[1]), "stages": int(m[2]), **entry}
          for name, entry in ptxas_entries(_build.build_log.get("conv3d", "")).items()
          for m in [re.search(r"conv3d_tf32_kernelILi(\d+)ELi(\d+)E", name)] if m]
    tf += [{"kernel": "ring_attention_tf32", "hd": int(m[1]), **entry}
           for name, entry in ptxas_entries(_build.build_log.get("ring_attention", "")).items()
           for m in [re.search(r"ring_attention_tf32_kernelILi(\d+)E", name)] if m]
    # the flash forward's fold (K6's, one shard) and the backward pair, by head dim
    tf += [{"kernel": m[1], "hd": int(m[2]), **entry}
           for src in ("flash_attention", "flash_attention_bwd")
           for name, entry in ptxas_entries(_build.build_log.get(src, "")).items()
           for m in [re.search(r"(flash_fwd_tf32|flash_bwd_tf32_dkv|flash_bwd_tf32_dq)_kernelILi(\d+)E",
                               name)] if m]
    serialized = [ln.split("'")[1]
                  for src in ("conv3d", "ring_attention", "flash_attention", "flash_attention_bwd")
                  for ln in _build.build_log.get(src, "").splitlines()
                  if "C7512" in ln and "'" in ln]
    # the int8 kernels: S1's instances (N tile, stages, output kind, products
    # a stage, H/W stride: 2 is the strided Downsample's, taps: 9 the 2-D
    # convs', 3 the 1-D convs'), S2, S3
    log = "\n".join(_build.build_log.get(src, "") for src in (
        "conv_int8", "conv3d_s8_strided", "conv2d_s8", "conv2d_s8_strided", "conv1d_s8",
        "conv1d_s8_strided"))
    s8 = [{"kernel": m[1], **entry} for name, entry in ptxas_entries(log).items()
          for m in [re.search(r"(conv3d_s8_wgmma_kernelILi\d+ELi\d+ELi\d+ELi\d+ELi\d+ELi\d+E|"
                              r"conv_s8_general_kernel|quant_amax_kernel|quant_int8_kernel)",
                              name)] if m]
    emit("int8_ptxas", kernels=s8 or "not built in this run (a cached library has no ptxas log)",
         spill_free=all(not e.get("spill_stores") and not e.get("spill_loads") for e in s8),
         wgmma_serialized=[ln.split("'")[1] for ln in log.splitlines()
                           if "C7512" in ln and "'" in ln])
    emit("tf32_ptxas", kernels=tf or "not built in this run (a cached library has no ptxas log)",
         spill_free=all(not e.get("spill_stores") and not e.get("spill_loads") for e in tf),
         wgmma_serialized=serialized)


def ptxas_entries(log: str) -> dict:
    """{kernel entry (mangled name): registers and spill bytes} from the
    ``nvcc -Xptxas -v`` output of one source."""
    entries: dict = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entries[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            entries[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            entries[name]["registers"] = int(m[1])
    return entries


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


def batch_chunks(b: int, rows) -> list:
    """Slices of a batch of ``b``: the whole batch when ``rows`` is None,
    else ``rows`` rows at a time."""
    return [slice(None)] if rows is None else [slice(i, i + rows) for i in range(0, b, rows)]


def chunked_errors(got, plain, chunks, tol: float) -> list:
    """The flash check of each tensor of ``got`` against the matching one of
    ``plain(s)`` on every batch chunk ``s``: per tensor, the worst chunk's."""
    errs = [[flash_error(g[s], want, tol) for g, want in zip(got, plain(s))] for s in chunks]
    return [max(per, key=lambda e: (not e["ok"], e["err_over_tol"])) for per in zip(*errs)]


def bitwise_repeatable(run) -> bool:
    """Two calls of ``run`` give bitwise-equal outputs."""
    import torch

    first, again = run(), run()
    if torch.is_tensor(first):
        first, again = (first,), (again,)
    return all(x is None or torch.equal(x, y) for x, y in zip(first, again))


# the CUDA kernel (a substring of its name in the profiler) behind each count
CUDA_KERNEL = {"conv3d_igemm": "conv3d_igemm", "conv3d_direct": "conv3d_direct",
               "conv3d_dgrad_igemm": "conv3d_igemm", "conv3d_dgrad_direct": "conv3d_direct",
               "conv3d_tf32": "conv3d_tf32_kernel", "conv3d_dgrad_tf32": "conv3d_tf32_kernel",
               "conv3d_weight_split": "tf32_split_kernel",
               "ring_attention_tf32": "ring_attention_tf32_kernel",
               "ring_attention_tf32_split": "kv_split_kernel",
               "flash_attention": "flash_fwd", "flash_attention_bwd": "flash_bwd_wgmma",
               "flash_attention_fwd_narrow": "flash_fwd_narrow",
               "flash_attention_bwd_delta": "flash_bwd_delta",
               "flash_attention_bwd_dkv": "flash_bwd_dkv", "flash_attention_bwd_dq": "flash_bwd_dq",
               "flash_attention_bwd_small": "flash_bwd_small",
               "flash_attention_bwd_long": "flash_bwd_long",
               "flash_attention_tf32": "flash_fwd_tf32_kernel",
               "flash_attention_tf32_split": "flash_fwd_tf32_split",
               "flash_attention_bwd_tf32_dkv": "flash_bwd_tf32_dkv",
               "flash_attention_bwd_tf32_dq": "flash_bwd_tf32_dq",
               "flash_attention_bwd_tf32_split": "flash_bwd_tf32_split",
               "ring_attention": "ring_attention_",
               "conv3d_s8": "conv3d_s8_wgmma_kernel", "conv3d_s8_strided": "conv3d_s8_wgmma_kernel",
               "conv2d_s8": "conv3d_s8_wgmma_kernel", "conv2d_s8_strided": "conv3d_s8_wgmma_kernel",
               "conv1d_s8": "conv3d_s8_wgmma_kernel", "conv1d_s8_strided": "conv3d_s8_wgmma_kernel",
               "conv_s8_general": "conv_s8_general_kernel",
               "quantize_int8_amax": "quant_amax_kernel", "quantize_int8": "quant_int8_kernel",
               **{k: k for k in ("conv3d_variant_full", "conv3d_variant_nopatch",
                                 "conv3d_variant_nodma", "conv3d_bigdot_im2col",
                                 "conv3d_bigdot_gemm", "conv3d_dotsonly")}}


def kernel_times(fn, kernel: str, iters: int = 10) -> dict:
    """``ms``: device time per call of ``fn`` in the CUDA kernel behind
    ``kernel``, from torch.profiler: the mean duration of the launches it
    recorded times the launches one call makes (the wrapper's own count),
    since the profiler can miss launches (``profiled_launches`` against
    ``launches_made``); ``call_ms``: CUDA-event time per call of the whole
    wrapper ``fn`` (its host work, weight repacks, pads and, for the flash
    backward, delta included). When the profiler recorded no launch ``ms``
    is ``call_ms``, and ``ms_of`` says so."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks._timing import kernel_events, per_call_ms
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    call_ms = cuda_time_ms(fn, iters)
    before = launch_counts[kernel]
    fn()
    torch.cuda.synchronize()
    per_call = launch_counts[kernel] - before
    ms, recorded = per_call_ms(kernel_events(fn, iters), CUDA_KERNEL[kernel], per_call)
    times = {"call_ms": call_ms, "profiled_launches": recorded, "launches_made": per_call * iters}
    if ms is None:
        return {"ms": call_ms, "ms_of": "the wrapper call (CUDA events)", **times}
    return {"ms": ms, "ms_of": "the kernel's device time (torch.profiler)", **times}


def conv_kernel_name(kind: str, key) -> str:
    """The count a conv problem's launch goes to (``conv_route``: the
    implicit GEMM for bf16 whose own input channels are a multiple of 8, its
    3xTF32 form for fp32 with Cin % 4 == 0 and Cout > 1, else the direct
    kernel)."""
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv_route

    xs, cout, dt = key
    route = conv_route(dt, xs[-1], cout)
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
        flops, nbytes, item = conv_cost(key)
        bound = dtype_bound(flops, nbytes, item)
        row.update(calls=calls, per=per, **kernel_times(run, row["kernel"]),
                   plain_ms=cuda_time_ms(plain, iters=2, warmup=1),
                   library=("F.conv3d (cuDNN)" if kind == "forward"
                            else "torch.nn.grad.conv3d_input (cuDNN)")
                   + (", fp32 with TF32 off" if item == 4 else ""),
                   library_ms=cuda_time_ms(library, iters=10), **bound)
        if row["ms"] < bound["bound_ms"]:
            # faster than the card's peak: the profiler mistimed the launches
            # it recorded (it can, on the H100), so the call's time stands
            row.update(profiled_ms=row["ms"], ms=row["call_ms"],
                       ms_of="the wrapper call (CUDA events): the profiler's time was below "
                             "the bound")
        row["tflops"] = flops / row["ms"] / 1e9
        if row["kernel"].endswith("_tf32"):
            # the kernel's weights [Cout, 27, Cin] of the conv it runs (a
            # dgrad's are the flipped, IO-transposed forward weights)
            row["weight_split"] = weight_split_row(cout, xs[-1], seed)
    return row


def exact_error(got, want) -> dict:
    """A check that the kernel's output equals its plain version's bit for
    bit (the tf32 splits: the same rounding of the same values)."""
    import torch

    equal = bool(torch.equal(got, want))
    return {"max_abs_err": float((got - want).abs().max()), "max_abs_ref": float(want.abs().max()),
            "tol": 0.0, "check": "bitwise equal", "err_over_tol": 0.0 if equal else math.inf,
            "ok": equal}


def weight_split_row(cout: int, cin: int, seed: int) -> dict:
    """The tf32 conv route's weight pre-pass on a [Cout, 27, Cin] fp32
    weight (the kernel's layout of the conv it precedes): held bitwise
    against its plain version (``tf32_split``, lo rounded by
    ``tf32_round``), timed beside it and its byte bound (the weights read
    once, both terms written once)."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.conv3d import weight_split_kernel
    from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_round, tf32_split

    w = randn((cout, 27, cin), seed + 5, "cuda", torch.float32, 1 / math.sqrt(27 * cin))

    def plain():
        hi, lo = tf32_split(w)
        return hi, tf32_round(lo)

    got, want = weight_split_kernel(w), plain()
    nbytes = 3 * 4.0 * w.numel()
    return {"kernel": "conv3d_weight_split", "dtype": "float32",
            **exact_error(torch.stack(got), torch.stack(want)),
            **kernel_times(lambda: weight_split_kernel(w), "conv3d_weight_split"),
            "plain_ms": cuda_time_ms(plain, iters=5), "library": "none: no one PyTorch call "
            "rounds to TF32", "library_ms": None, "bound_ms": nbytes / MEM_RATE * 1e3,
            "bound_by": "bytes"}


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
    return {"kernel": fwd_kernel_name(d, dtype), "b": b, "t": t, "h": h, "d": d,
            "dtype": dtype_name(dtype), **flash_error(got, want, TOL_FLASH[dtype_name(dtype)])}


def check_flash_narrow(b, t, h, d, device, seed: int) -> list:
    """The narrow forward (bf16, padded D 16/32) on strided views of one qkv,
    with and without the LSE, against the plain version on fp32 copies
    (``TOL_FLASH``; the LSE within TOL_LSE of ``flash_lse_plain``), run
    twice and bitwise equal; and the mma.sync kernel on request
    (``MMA_SYNC_PLAN``) on the same inputs, held the same way and against
    the narrow output. One row per kernel and LSE setting."""
    import torch

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        MMA_SYNC_PLAN, NARROW_PLAN, flash_attention_fwd_kernel, flash_lse_plain, flash_plan)

    q, k, v = flash_inputs(b, t, h, d, device, seed, torch.bfloat16)
    want = xla_attention(q.float(), k.float(), v.float())
    want_lse = flash_lse_plain(q, k)
    rows, narrow = [], {}
    for plan in (NARROW_PLAN, MMA_SYNC_PLAN):
        for with_lse in (False, True):
            out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=with_lse, plan=plan)
            again, lse2 = flash_attention_fwd_kernel(q, k, v, with_lse=with_lse, plan=plan)
            out, again = out[..., :d], again[..., :d]
            row = {"kernel": fwd_kernel_name(d, torch.bfloat16, plan), "plan": plan_name(plan),
                   "b": b, "t": t, "h": h, "d": d, "dtype": "bfloat16", "with_lse": with_lse,
                   "route_chosen": flash_plan(b, h, t, t, d).route,
                   **flash_error(out, want, TOL_FLASH["bfloat16"]),
                   "bitwise_repeatable": bool(torch.equal(out, again)) and (
                       lse is None or bool(torch.equal(lse, lse2)))}
            row["ok"] = row["ok"] and row["bitwise_repeatable"]
            if with_lse:
                lse_err = float((lse - want_lse).abs().max())
                row.update(lse_max_abs_err=lse_err, lse_tol=TOL_LSE)
                row["ok"] = row["ok"] and lse_err <= TOL_LSE
            if plan == NARROW_PLAN:
                narrow[with_lse] = out
            else:
                row["narrow_against_this"] = flash_error(narrow[with_lse], out.float(),
                                                         TOL_FLASH["bfloat16"])
                row["ok"] = row["ok"] and row["narrow_against_this"]["ok"]
            rows.append(row)
    del q, k, v, want, want_lse
    return rows


def fwd_kernel_name(d: int, dtype, plan=None) -> str:
    """The count behind the forward's route (``flash_plan``'s, or
    ``plan``'s): the 3xTF32 fold for fp32 at padded head dims 64 and 128,
    the narrow kernel for bf16 at 16 and 32, else the flash forward
    kernels' (wgmma, mma.sync, FMA)."""
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_plan

    route = (plan or flash_plan(1, 1, 1, 1, d, dtype)).route
    return {"tf32": "flash_attention_tf32", "narrow": "flash_attention_fwd_narrow"}.get(
        route, "flash_attention")


def bwd_kernel_names(d: int, dtype, plan=None, t: int = 512) -> dict:
    """The count (and kernel) behind each gradient on the backward's route
    at T = ``t`` (``flash_bwd_plan``'s, or ``plan``): the fused kernel for
    bf16 at padded head dims 64 and 128, the small kernel for bf16 at 16
    and 32 with T <= 64 and the long kernel past it, the 3xTF32 pair for
    fp32 at 64 and 128, the dkv/dq pair elsewhere."""
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_bwd_plan

    route = (plan or flash_bwd_plan(1, 1, t, t, d, dtype)).route
    if route == "wgmma":
        return dict.fromkeys(("dq", "dk", "dv"), "flash_attention_bwd")
    if route in ("small", "long"):
        return dict.fromkeys(("dq", "dk", "dv"), f"flash_attention_bwd_{route}")
    pair = "flash_attention_bwd_tf32" if route == "tf32" else "flash_attention_bwd"
    return {"dq": f"{pair}_dq", "dk": f"{pair}_dkv", "dv": f"{pair}_dkv"}


def check_flash_bwd(b, t, h, d, device, seed: int, dtype) -> dict:
    """dq, dk, dv of the kernels (through the autograd Function, forward
    with LSE) against the fp32 plain backward on the same inputs; the kernels
    run twice and must agree bitwise. On the fused, small and long routes
    (bf16) the mma.sync pair, and on the 3xTF32 pair's (fp32) the FMA pair,
    runs on the same inputs too (``flash_attention_bwd_kernel(...,
    plan=...)``), held against the plain backward and the new route against
    it; in bf16 the delta pre-pass (the fused route's and the pair's) is
    held against ``flash_delta``."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        FP32_BWD_PLAN, MMA_SYNC_BWD_PLAN, flash_attention, flash_attention_bwd_kernel,
        flash_attention_bwd_plain, flash_attention_fwd_kernel, flash_attention_plain, flash_delta,
        flash_delta_kernel, flash_lse_plain)

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
    tol = TOL_FLASH_BWD[name]
    kernels = bwd_kernel_names(d, dtype, t=t)
    grads_ = [{"grad": which, "dtype": name, "b": b, "t": t, "h": h, "d": d,
               "kernel": kernels[which], **flash_error(g, w, tol)}
              for which, g, w in zip(("dq", "dk", "dv"), got, want)]
    repeatable = all(torch.equal(x, y) for x, y in zip(got, again))
    route = {"flash_attention_bwd": "fused", "flash_attention_bwd_small": "small",
             "flash_attention_bwd_long": "long",
             "flash_attention_bwd_tf32_dq": "tf32 pair"}.get(kernels["dq"], "pair")
    row = {"b": b, "t": t, "h": h, "d": d, "dtype": name, "bitwise_repeatable": repeatable,
           "route": route}
    if dtype == torch.bfloat16:
        with torch.no_grad():
            q, k, v = (z.detach() for z in qkv.split(d, dim=-1))
            o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
            grads_.append({"grad": "delta", "dtype": name, "b": b, "t": t, "h": h, "d": d,
                           "kernel": "flash_attention_bwd_delta",
                           **flash_error(flash_delta_kernel(o, do), flash_delta(o, do),
                                         TOL_DELTA)})
    if route != "pair":
        old_plan = MMA_SYNC_BWD_PLAN if route in ("fused", "small", "long") else FP32_BWD_PLAN
        with torch.no_grad():
            q, k, v = (z.detach() for z in qkv.split(d, dim=-1))
            o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
            new = flash_attention_bwd_kernel(q, k, v, o, lse, do)
            old = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=old_plan)
        pair = bwd_kernel_names(d, dtype, old_plan)
        grads_ += [{"grad": which, "dtype": name, "b": b, "t": t, "h": h, "d": d,
                    "kernel": pair[which], "plan": f"{old_plan.route} (the pair, on request)",
                    **flash_error(g, w, tol)} for which, g, w in zip(("dq", "dk", "dv"), old, want)]
        row["new_against_old_pair"] = [{"grad": which, **flash_error(g, w.float(), tol)}
                                       for which, g, w in zip(("dq", "dk", "dv"), new, old)]
    row["grads"] = grads_
    row["ok"] = repeatable and all(g["ok"] for g in grads_ + row.get("new_against_old_pair", []))
    return row


def long_bwd_memory_hold(b, t, h, d, device) -> dict:
    """One long-route backward at a large B*H*T: the device memory the call
    allocates, against dq, dk and dv and its fp32 dQ slots and counters
    (``long_bwd_scratch_bytes``, linear in T; a slot set for every 128 keys
    grew as Tq * Tk), finite gradients, and a second call bitwise equal."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_fwd_kernel, launch_counts,
        long_bwd_scratch_bytes, padded_head_dim)

    q, k, v = flash_inputs(b, t, h, d, device, seed=906, dtype=torch.bfloat16)
    do = randn((b, t, h, d), 907, device, torch.bfloat16)
    dk = padded_head_dim(d)
    with torch.no_grad():
        o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts["flash_attention_bwd_long"]
        got = flash_attention_bwd_kernel(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        again = flash_attention_bwd_kernel(q, k, v, o, lse, do)
        launches = launch_counts["flash_attention_bwd_long"] - n0
    # dq, dk, dv at the padded head dim, and below 16 the wrapper's padded
    # copies of q, k, v and dO (the forward's o is padded already)
    outputs, scratch = 3 * b * t * h * dk * 2, long_bwd_scratch_bytes(b * h, t, t, dk)
    pads = 4 * b * t * h * dk * 2 if dk != d else 0
    row = {"b": b, "t": t, "h": h, "d": d, "peak_bytes": peak, "outputs_bytes": outputs,
           "padded_inputs_bytes": pads, "scratch_bytes": scratch, "launches": launches,
           "finite": all(bool(torch.isfinite(g).all()) for g in got),
           "bitwise_repeatable": all(torch.equal(x, y) for x, y in zip(got, again))}
    row["ok"] = (peak <= outputs + pads + scratch + (1 << 20) and launches == 2 and row["finite"]
                 and row["bitwise_repeatable"])
    del q, k, v, do, o, lse, got, again
    torch.cuda.empty_cache()
    return row


def plan_name(plan) -> str:
    if plan.route != "wgmma":
        return (f"{plan.route} (the earlier kernel)" if plan.route in ("mma_sync", "fp32")
                else plan.route)
    return f"wgmma bm{plan.bm} bn{plan.bn}"


# the LSE against flash_lse_plain: fp32 scores of the same bf16 inputs on
# both sides, sums in another order and exp2f's last bits (~1e-6 relative
# of an LSE near log2(T) + max)
TOL_LSE = 1e-4


def check_flash_plans(device) -> tuple[list, list]:
    """The flash forward at every plan of its wgmma route and at its
    mma.sync kernel at FLASH_PLAN_SHAPES, and at its narrow route and the
    mma.sync kernel at NARROW_PLAN_SHAPES, with and without the LSE, on
    strided views of one qkv, each against the plain version on fp32
    copies. Returns (every hold, one summary row per shape: the worst ratio
    of error to tolerance per plan)."""
    import torch

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        MMA_SYNC_PLAN, NARROW_PLAN, WGMMA_PLANS, flash_attention_fwd_kernel, flash_lse_plain)

    rows, summary = [], []
    cases = ([(shape, [MMA_SYNC_PLAN, *WGMMA_PLANS]) for shape in FLASH_PLAN_SHAPES]
             + [(shape, [MMA_SYNC_PLAN, NARROW_PLAN]) for shape in NARROW_PLAN_SHAPES])
    for i, ((b, t, h, d), plans) in enumerate(cases):
        q, k, v = flash_inputs(b, t, h, d, device, seed=130 + i, dtype=torch.bfloat16)
        want = xla_attention(q.float(), k.float(), v.float())
        want_lse = flash_lse_plain(q, k)
        worst = {}
        for plan in plans:
            for with_lse in (False, True):
                out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=with_lse, plan=plan)
                out = out[..., :d]
                row = {"kernel": fwd_kernel_name(d, torch.bfloat16, plan),
                       "plan": plan_name(plan), "b": b, "t": t,
                       "h": h, "d": d, "dtype": "bfloat16", "with_lse": with_lse,
                       **flash_error(out, want, TOL_FLASH["bfloat16"])}
                if with_lse:
                    lse_err = float((lse - want_lse).abs().max())
                    row.update(lse_max_abs_err=lse_err, lse_tol=TOL_LSE)
                    row["ok"] = row["ok"] and lse_err <= TOL_LSE
                rows.append(row)
                name = plan_name(plan)
                worst[name] = max(worst.get(name, 0.0), row["err_over_tol"])
        summary.append({"b": b, "t": t, "h": h, "d": d, "err_over_tol_by_plan": worst})
        del q, k, v, want, want_lse
    return rows, summary


# the fp32 forward's holds on its 3xTF32 route: (batch, tokens, heads, head
# dim) of a batch-8 forward's and the training step's attention, the 64^3
# config's 4096 tokens, a ragged T and D = 64
FLASH_TF32_SHAPES = ((8, 512, 4, 128), (32, 512, 4, 128), (2, 4096, 4, 128), (2, 300, 4, 128),
                     (2, 300, 2, 64))


def check_flash_tf32(device) -> list:
    """The fp32 forward on its 3xTF32 route (K6's fold, one shard), with
    and without the LSE, at FLASH_TF32_SHAPES on strided views of one qkv,
    against the plain version, its LSE against ``flash_lse_plain``; and the
    FMA kernel it replaced (``plan=FP32_PLAN``) on the same inputs, held the
    same way."""
    import torch

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        FP32_PLAN, TF32_PLAN, flash_attention_fwd_kernel, flash_lse_plain)

    rows = []
    for i, (b, t, h, d) in enumerate(FLASH_TF32_SHAPES):
        q, k, v = flash_inputs(b, t, h, d, device, seed=170 + i, dtype=torch.float32)
        want, want_lse = xla_attention(q, k, v), flash_lse_plain(q, k)
        for plan, kernel in ((TF32_PLAN, "flash_attention_tf32"), (FP32_PLAN, "flash_attention")):
            for with_lse in (False, True):
                out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=with_lse, plan=plan)
                row = {"kernel": kernel, "plan": plan_name(plan), "b": b, "t": t, "h": h, "d": d,
                       "dtype": "float32", "with_lse": with_lse,
                       **flash_error(out[..., :d], want, TOL_FLASH["float32"])}
                if with_lse:
                    lse_err = float((lse - want_lse).abs().max())
                    row.update(lse_max_abs_err=lse_err, lse_tol=TOL_LSE)
                    row["ok"] = row["ok"] and lse_err <= TOL_LSE
                rows.append(row)
        del q, k, v, want, want_lse
    return rows


def flash_split_rows(device) -> list:
    """Both fp32 flash pre-passes on strided views (a ragged T at D = 64,
    Tq != Tk at D = 128), bitwise against their plain versions."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_split, flash_bwd_split_plain, flash_fwd_split, flash_split_plain)

    rows = []
    for i, (b, tq, tk, h, d) in enumerate(((2, 300, 300, 2, 64), (1, 70, 130, 3, 128))):
        q, do = (randn((b, tq, h, 2 * d), 180 + 4 * i + j, device, torch.float32)[..., :d]
                 for j in range(2))
        k, v = randn((b, tk, h, 2 * d), 182 + 4 * i, device, torch.float32).split(d, dim=-1)
        for kernel, got, want in (
                ("flash_attention_tf32_split", flash_fwd_split(k, v), flash_split_plain(k, v)),
                ("flash_attention_bwd_tf32_split", flash_bwd_split(q, do, k, v),
                 flash_bwd_split_plain(q, do, k, v))):
            rows.append({"kernel": kernel, "dtype": "float32", "b": b, "tq": tq, "tk": tk, "h": h,
                         "d": d, **exact_error(torch.cat([x.flatten() for x in got]),
                                               torch.cat([x.flatten() for x in want]))})
    return rows


def check_tf32_probe(device) -> list:
    """The tf32 route's 3xTF32 products alone (``tf32_probe``: one
    warpgroup, a [64, 32] by [n, 32]^T tile, in S = Q K^T's and in
    O += P V's operand layouts) against the fp32 product, at the flash
    tolerance, and the single TF32 product's distance beside it."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.ring_attention import tf32_probe
    from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_matmul

    rows = []
    for i, n in enumerate((32, 128)):
        a = randn((64, 32), 150 + i, device, torch.float32)
        b = randn((n, 32), 160 + i, device, torch.float32)
        want = a @ b.T
        got = tf32_probe(a, b)
        for form, name in enumerate(("S = Q K^T layouts", "O += P V layouts")):
            rows.append({"kernel": "tf32_probe", "dtype": "float32", "n": n, "form": name,
                         **flash_error(got[form], want, TOL_FLASH["float32"]),
                         "one_tf32_product": flash_error(tf32_matmul(a, b.T, terms=1), want,
                                                         TOL_FLASH["float32"])["rel_rms_err"]})
    return rows


def ring_mesh(n: int, device):
    """A ("data", "context") mesh of ``n`` context ranks, all on ``device``."""
    from rho_diffusion_tpu_torch.parallel import make_mesh

    return make_mesh(data=1, context=n, devices=[device] * n)


def ring_call(q, k, v, mesh, plain: bool = False):
    """One context-parallel attention call with the "rdma" ring: K6, or
    with ``plain`` the same ring folded by K6's plain version."""
    from rho_diffusion_tpu_torch.parallel import context_sharded_attention

    return context_sharded_attention(q, k, v, mesh, impl="rdma", plain=plain)


def ring_kernel_name(dtype, d: int) -> str:
    """The count a ring call's fold goes to: K6's 3xTF32 kernel for fp32 at
    kernel head dims 64 and 128, else its mma.sync or FMA kernel."""
    from rho_diffusion_tpu_torch.ops.kernels.ring_attention import kernel_head_dim, ring_route

    return ("ring_attention_tf32" if ring_route(dtype, kernel_head_dim(d)) == "tf32"
            else "ring_attention")


def check_ring(b, t, h, d, n, device, seed: int, dtype) -> list:
    """K6 in its ring of ``n`` ranks on one card (strided views of one qkv,
    as the UNet makes them), held on fp32 copies of the inputs against the
    same ring with the plain version, and against full attention without
    the ring (``xla_attention``), which shares none of the ring's code."""
    from rho_diffusion_tpu_torch.ops.attention import xla_attention

    q, k, v = flash_inputs(b, t, h, d, device, seed, dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    mesh = ring_mesh(n, device)
    got = ring_call(q, k, v, mesh)
    tol = TOL_FLASH[dtype_name(dtype)]
    row = {"kernel": ring_kernel_name(dtype, d), "b": b, "t": t, "n": n, "t_per_rank": t // n,
           "h": h, "d": d, "dtype": dtype_name(dtype)}
    return [{**row, "against": "the plain ring (fp32)",
             **flash_error(got, ring_call(qf, kf, vf, mesh, plain=True), tol)},
            {**row, "against": "xla_attention without the ring (fp32)",
             **flash_error(got, xla_attention(qf, kf, vf), tol)}]


def phase_kernels(state: dict) -> None:
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    device = torch.device(DEVICE)
    launch_counts.clear()
    unet = build_unet(flagship_config(25), "bfloat16", device)
    conv_calls, attn_calls = forward_shapes(unet, 2, device)
    keys = sorted(set(conv_keys(conv_calls, "forward")), key=str)
    # the fp32 head shapes at both ends of the flagship, and the 64^3
    # config's level-0 conv (K5's box of 64 x 2 voxels)
    for cin, cout in ((1, 64), (64, 1)):
        keys.append(((2, 32, 32, 32, cin), cout, torch.float32))
    # fp32 with Cin % 4 != 0 (the direct kernel), and a ragged tf32 conv
    keys += [((2, 9, 10, 11, 6), 10, torch.float32), ((1, 5, 7, 9, 12), 70, torch.float32)]
    keys.append((LEVEL0_64, 64, torch.bfloat16))
    # every conv problem of the fp32 flagship at batch 2, its interior
    # (64..1024 channels) among them, forward and dgrad
    unet32 = build_unet(flagship_config(25), "float32", device)
    conv32_calls = forward_shapes(unet32, 2, device)[0]
    del unet32
    keys += [k for k in sorted(set(conv_keys(conv32_calls, "forward")), key=str) if k not in keys]
    dgrad_keys = sorted(set(conv_keys(conv_calls, "dgrad")) | set(conv_keys(conv32_calls, "dgrad")),
                        key=str)
    conv = [hold_conv("forward", k, device, seed=i) for i, k in enumerate(keys)]
    conv += [hold_conv("dgrad", k, device, seed=50 + 2 * i) for i, k in enumerate(dgrad_keys)]
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
        # the training step's attention (B*H = 32*4 = 128), the 64^3
        # config's T = 4096, a ragged T and D = 64: the fused kernel (bf16)
        # or the 3xTF32 pair (fp32), each against the pair it replaced
        flash_bwd += [
            check_flash_bwd(32, t, h, d, device, seed=110, dtype=dt),
            check_flash_bwd(2, 4096, h, d, device, seed=116, dtype=dt),
            check_flash_bwd(2, 300, h, d, device, seed=112, dtype=dt),
            check_flash_bwd(2, 300, 2, 64, device, seed=114, dtype=dt),
        ]
    # the 2-D and 1-D configs' attention (D = 64): DeepGalaxy's training
    # step (B*H = 64*4, T = 256 at 16^2) and Spectroscopy's (32*4, T = 512)
    for i, (b, tt) in enumerate(DATA_ATTENTION):
        flash.append(check_flash(b, tt, 4, 64, device, seed=150 + i, dtype=torch.bfloat16))
        flash_bwd.append(check_flash_bwd(b, tt, 4, 64, device, seed=152 + 2 * i,
                                         dtype=torch.bfloat16))
    # the fp32 forward's 3xTF32 route with and without the LSE, against the
    # FMA kernel too; both fp32 flash pre-passes bitwise
    flash_tf32 = check_flash_tf32(device)
    flash_splits = flash_split_rows(device)
    # K6 at the serve shape (bucket 8 over 4 ranks: T/n = 128) and the 64^3
    # config's (T = 4096: T/n = 1024); fp32 at D = 128 takes the tf32 fold,
    # at D = 32 and 256 the FMA one; a ragged shard (T/n = 75)
    ring = [row for dt in (torch.bfloat16, torch.float32) for i, tt in enumerate((t, 4096))
            for row in check_ring(8, tt, h, d, SERVE_CONTEXT, device, seed=120 + i, dtype=dt)]
    ring += [row for dd in (32, 256, 64) for row in check_ring(2, 300, 2, dd, SERVE_CONTEXT,
                                                               device, 124, torch.float32)]
    # the tf32 products alone, in both operand layouts, and the pre-passes
    probe = check_tf32_probe(device)
    splits = [weight_split_row(cout, cin, 140 + i)
              for i, (cout, cin) in enumerate(((64, 64), (512, 1024), (10, 12)))]
    _, k8, v8 = flash_inputs(2, 300, 2, 64, device, 141, torch.float32)
    splits.append(ring_split_row(k8, v8, SERVE_CONTEXT, 0, "", None))
    plans, plans_summary = check_flash_plans(device)
    record_errors(state, conv + flash + ring + plans + probe + splits + flash_tf32 + flash_splits
                  + [g for r in flash_bwd for g in r["grads"]])
    counts = dict(launch_counts)
    state["kernels_launches"] = counts
    emit("kernels", conv=conv, flash=flash, flash_bwd=flash_bwd, ring=ring, tf32_probe=probe,
         tf32_splits=splits + flash_splits, flash_tf32=flash_tf32,
         flash_plans=plans_summary, flash_plan_holds=len(plans),
         flash_plan_failures=[r for r in plans if not r["ok"]],
         attention_calls_per_forward=len(attn_calls), conv_calls_per_forward=len(conv_calls),
         launches=counts)
    fail_bad("kernels", conv + flash + flash_bwd + ring + plans + probe + splits + flash_tf32
             + flash_splits)
    # the holds launch the mma.sync and FMA pairs too (no main path runs them)
    missing = [name for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
               if not counts.get(name)]
    if missing:
        fail(f"kernels: the holds never launched {missing}; counts {counts}")


def direct_conv_calls() -> CallRecorder:
    """Records every conv kernel launch (forward and dgrad) by its problem."""
    from rho_diffusion_tpu_torch.ops.kernels import conv3d as conv_kernels

    return CallRecorder(conv_kernels, "conv3d_kernel")


def conv_problem_name(kind: str, xs, cout: int, dtype: str) -> str:
    """A conv problem at any batch: "forward [B, 32, 32, 32, 1] -> 64 bfloat16"."""
    return f"{kind} [B, {', '.join(map(str, xs[1:]))}] -> {cout} {dtype}"


def direct_launches(calls) -> dict:
    """{problem: launches} of the direct conv among recorded conv3d_kernel
    calls (x, weight, bias[, kind]): those the igemm route does not take."""
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv_route

    out: dict = {}
    for call in calls:
        (xs, dt), (ws, _) = call[0], call[1]
        if conv_route(dt, xs[-1], ws[0]) != "direct":
            continue
        kind = "dgrad" if len(call) > 3 and call[3] == "conv3d_dgrad" else "forward"
        name = conv_problem_name(kind, xs, ws[0], dtype_name(dt))
        out[name] = out.get(name, 0) + 1
    return out


def phase_main(state: dict, steps: int, samples: int) -> None:
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_routes

    cfg = flagship_config(steps)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        unet = build_pipeline(cfg, "float32", "cpu").backbone
        pth = tmp / "model.pth"
        torch.save(random_state_dict(unet, seed=0), pth)
        launch_counts.clear()
        flash_routes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with direct_conv_calls() as direct:
            out = inference.main([str(cfg_path), "-p", str(pth), "-n", str(samples), "-d",
                                  DEVICE, "-f", "--work-dir", str(tmp)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        routes = dict(flash_routes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["launches"] = counts
    state["flash_routes"] = {"sampling": routes}
    state.setdefault("direct_launches", {})["sampling"] = direct_launches(direct.calls)
    want_shape = (samples, *cfg["model"]["kwargs"]["data_shape"],
                  cfg["model"]["kwargs"]["in_channels"])
    finite = bool(np.isfinite(out).all())
    emit("main", shape=list(out.shape), finite=finite, wall_s=wall, steps=steps,
         forwards=steps - 1, launches=counts, flash_routes=routes, sample_mean=float(out.mean()),
         sample_std=float(out.std()))
    if tuple(out.shape) != want_shape or not finite:
        fail(f"main path gave {out.shape}, finite={finite}; expected {want_shape}, finite")
    missing = [k for k in ("conv3d_igemm", "conv3d_direct", "flash_attention") if not counts.get(k)]
    if missing:
        fail(f"main path never launched {missing}; counts {counts}")


def config64(steps: int) -> dict:
    """The 64^3 config at full width with the main64 phase's cuts."""
    cfg = json.loads(CONFIG64.read_text())
    cfg["noise_schedule"]["kwargs"]["num_steps"] = steps
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    return cfg


MAIN64_CUTS = {
    "noise_schedule.kwargs.num_steps": f"1000 -> {MAIN64_STEPS} (the fewest steps whose "
                                       "1000/T-scaled betas stay below 1; random weights, the "
                                       "sampler's loop is the same at any length)",
    "inference.cache_file, plot_output_file, checkpoint": "-> none (weights through -p)",
}


def unet64_inputs(pipe, cfg: dict, batch: int, device, seed: int):
    """x_t in [-1, 1], timesteps in [0, 1000) and the MultiEmbeddings
    labels: raw (l, m) rows of the config's parameter space."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(pipe.sample_shape(batch), generator=gen).clamp(-1, 1)
    t = torch.randint(0, 1000, (batch,), generator=gen)
    y = pipe.conditions_from_parameter_space(cfg["inference"]["parameter_space"], batch,
                                             random=False).float()
    return x.to(device), t.to(device), y.to(device)


def phase_main64(state: dict) -> None:
    """The 64^3 config's sampling path: ``inference.main`` on the config at
    full width from seeded random weights (a ``.pth`` through -p), batch 8
    (its ``num_samples``); then one 64^3 forward at batch 1 on the kernels
    held against the fp32 plain model (the bf16 plain model's distance is
    the bar's unit, as in ``hold``), and one batch-8 forward timed with its
    device-busy share. The config's "ddim" sampler and ddim_steps do not
    apply to its DDPM pipeline, which the CLI samples as it is."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_routes

    device = torch.device(DEVICE)
    steps = MAIN64_STEPS
    cfg = config64(steps)
    samples = cfg["inference"]["num_samples"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_64_"))
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        sd = random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0)
        pth = tmp / "model.pth"
        torch.save(sd, pth)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        flash_routes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference.main([str(cfg_path), "-p", str(pth), "-n", str(samples), "-d", DEVICE,
                              "-f", "--work-dir", str(tmp)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = dict(launch_counts), dict(flash_routes)
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["main64_launches"] = counts
    state.setdefault("flash_routes", {})["sampling64"] = routes
    torch.cuda.empty_cache()

    fast = build_pipeline(cfg, "bfloat16", device)
    fast.load_state_dict(sd)
    ref = build_pipeline(cfg, "float32", device)
    ref.load_state_dict(sd)
    x, t, y = unet64_inputs(fast, cfg, MAIN64_HOLD_BATCH, device, seed=5)
    with torch.no_grad():
        got = fast.apply(x, t, y)
        with plain_backends():
            plain_bf16 = fast.apply(x, t, y)
            plain_fp32 = ref.apply(x, t, y)
    k, p = rel_mse(got, plain_fp32), rel_mse(plain_bf16, plain_fp32)
    hold = {"kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
            "kernels_vs_bf16_plain": rel_mse(got, plain_bf16),
            "bar": min(HOLD_FACTOR * p, HOLD_CAP["forward"]), "batch": MAIN64_HOLD_BATCH}
    del ref, got, plain_bf16, plain_fp32
    torch.cuda.empty_cache()
    unet = fast.backbone
    inputs = unet64_inputs(fast, cfg, samples, device, seed=7)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: unet(*inputs), iters=3, warmup=1)
    profile = profile_forward(unet, inputs, fwd_ms)
    del fast, unet, inputs
    torch.cuda.empty_cache()

    want_shape = (samples, *cfg["model"]["kwargs"]["data_shape"],
                  cfg["model"]["kwargs"]["in_channels"])
    finite = bool(np.isfinite(out).all())
    emit("main64", config=CONFIG64.name, shape=list(out.shape), finite=finite, wall_s=wall,
         steps=steps, forwards=steps - 1, cuts=MAIN64_CUTS, launches=counts, flash_routes=routes,
         max_memory_allocated=peak, sample_mean=float(out.mean()), sample_std=float(out.std()),
         hold_forward=hold, unet_forward_batch=samples, unet_forward_ms=fwd_ms,
         device_profile=profile)
    problems = []
    if tuple(out.shape) != want_shape or not finite:
        problems.append(f"the sample is {out.shape}, finite={finite}; expected {want_shape}")
    missing = [k for k in ("conv3d_igemm", "conv3d_direct", "flash_attention") if not counts.get(k)]
    if missing:
        problems.append(f"the path never launched {missing}; counts {counts}")
    if not routes.get("wgmma Tk=4096"):
        problems.append(f"attention at 4096 tokens never took the wgmma route: {routes}")
    if not hold["kernels_vs_fp32_plain"] <= hold["bar"]:
        problems.append(f"the 64^3 forward hold: {hold}")
    if problems:
        fail("main64: " + "; ".join(problems))


def gauss_config() -> dict:
    """``examples/config_learned_variance.json`` at full width with the
    gauss phase's cuts."""
    cfg = json.loads(GAUSS_CONFIG.read_text())
    space = json.loads(CONFIG.read_text())["inference"]["parameter_space"]
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None,
                            parameter_space=space)
    return cfg


GAUSS_CUTS = {
    "inference.parameter_space": "none -> the flagship's (l, m) grid: the config's UNet is "
                                 "class-conditional (num_classes 20) and names no condition "
                                 "rows, so its inference CLI (the JAX package's too) stops at "
                                 "'class-conditional model requires y'",
    "inference.cache_file, plot_output_file, checkpoint": "-> none (weights through -p)",
}


@contextlib.contextmanager
def bench_env(env: dict, prefix: str | tuple = "BENCH_"):
    """An entry's ``prefix`` variables (the bench entry's BENCH_*; a tuple
    for several prefixes) set to ``env`` (the others cleared) for the body,
    then put back."""
    import os

    saved = {k: v for k, v in os.environ.items() if k.startswith(prefix)}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(saved)


def counted(fn):
    """(fn's result, host seconds, launch counts, flash routes) of one
    call, the counts cleared just before it."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_routes

    launch_counts.clear()
    flash_routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(launch_counts), dict(flash_routes)


def sampling_breakdown(pipe, shape, conds, sampler: str, steps: int, sample=None,
                       wall_s=None) -> dict:
    """One sample's anatomy per step, on a path that has already run (and
    so warmed) it: one sample's host-clock time (``wall_s`` where the path
    timed it; and, when the caller's thread issues its launches, that
    thread's CPU time); its device time (torch.profiler over one more
    sample, a lower bound as the profiler can miss launches) and busy
    share; a UNet forward's device time and its share of the step's device
    time (its CUDA-event time too, which the host's launches set); and the
    sampler arithmetic's own device time per step: ``GAUSS_ARITH_STEPS``
    steps of the same loop with the model replaced by one stored output
    (the tables, dynamic thresholding's torch.quantile, whose sort kernels
    are listed, and the update). ``sample`` draws the sample timed and
    profiled (by default ``pipe.reverse_process`` on ``shape`` and
    ``conds``)."""
    import torch

    device = pipe.device

    def direct(n: int = steps):
        return pipe.reverse_process(shape, conds, sampler=sampler, num_steps=n,
                                    generator=torch.Generator(device=device).manual_seed(0))

    own = sample is None and wall_s is None
    sample = sample or direct
    t0 = time.perf_counter()
    wall = wall_s
    if wall is None:
        torch.cuda.synchronize()
        c0 = time.thread_time()
        sample()
        torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
    t_prof = time.perf_counter()
    by_name = device_time_by_kernel(sample)
    profile_s = time.perf_counter() - t_prof
    x = randn(shape, 3, device, torch.float32).clamp(-1, 1)
    t = torch.full((shape[0],), 500, dtype=torch.int64, device=device)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: pipe.apply(x, t, conds), iters=5, warmup=1)
        fwd = device_time_by_kernel(lambda: pipe.apply(x, t, conds))
        stored = pipe.apply(x, t, conds).float()
    n = GAUSS_ARITH_STEPS
    pipe._model_fn = lambda conditions, guidance_scale=None: (lambda x_, t_: stored)
    try:
        direct(n)  # its respaced tables built
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        direct(n)
        torch.cuda.synchronize()
        arith_host = time.perf_counter() - t1
        arith = device_time_by_kernel(lambda: direct(n))
    finally:
        del pipe._model_fn
    out = {"batch": shape[0], "sampler": sampler, "steps": steps, "sample_s": wall,
           **({"sample_thread_cpu_s": cpu} if own else {}),
           "step_ms": 1e3 * wall / steps, "unet_forward_event_ms": fwd_ms,
           "arithmetic_steps": n, "arithmetic_host_ms_per_step": 1e3 * arith_host / n,
           "profiled_sample_s": profile_s, "seconds": time.perf_counter() - t0}
    if not (by_name and fwd and arith):
        out["device"] = NOT_PROFILED["status"]
        return out
    step_dev = sum(ms for ms, _ in by_name.values()) / steps
    fwd_dev = sum(ms for ms, _ in fwd.values())
    arith_ms = sum(ms for ms, _ in arith.values()) / n
    out.update(
        step_device_ms=step_dev, device_busy_share=step_dev * steps / 1e3 / wall,
        unet_forward_device_ms=fwd_dev, unet_forward_share_of_step=fwd_dev / step_dev,
        arithmetic_device_ms_per_step=arith_ms, arithmetic_share_of_step=arith_ms / step_dev,
        arithmetic_sort_device_ms_per_step=sum(
            ms for name, (ms, _) in arith.items() if "sort" in name.lower()) / n,
        arithmetic_launches_per_step=sum(c for _, c in arith.values()) / n,
        arithmetic_top=profile_summary(arith)["top"][:6],
        sample_launches=sum(c for _, c in by_name.values()))
    return out


def hold_rows(got: dict, plain_bf16: dict, plain_fp32: dict, caps: dict) -> dict:
    """The hold rule for each output of ``got``: the kernels' relative MSE
    against the fp32 plain model at most ``HOLD_FACTOR`` times the bf16
    plain model's, and never above ``caps[output]``."""
    import torch

    rows = {}
    for what, value in got.items():
        k, p = rel_mse(value, plain_fp32[what]), rel_mse(plain_bf16[what], plain_fp32[what])
        row = {"kernels_vs_fp32_plain": k, "bf16_plain_vs_fp32_plain": p,
               "kernels_vs_bf16_plain": rel_mse(value, plain_bf16[what]),
               "bar": min(HOLD_FACTOR * p, caps[what]),
               "finite": bool(torch.isfinite(value).all())}
        rows[what] = {**row, "ok": row["finite"] and k <= row["bar"]}
    return rows


def phase_gauss(state: dict) -> None:
    """GaussianDiffusion sampling on the card at full width through three
    entry points, each path's launch counts cleared just before it and read
    just after: (a) the bench entry ``rho_diffusion_tpu_torch.bench`` (DDIM-50
    and dpm++-10 samples of the flagship UNet at batch 8, and its default
    train mode at batch 32); (b) the inference CLI on
    ``examples/config_learned_variance.json`` (16^3, learned_range, its
    'ddpm' sampler respaced to 50 steps, its 16 samples); (c) the service
    through ``serve.build_server`` on the same config with ``--sampler ddim
    --steps 50``, buckets 1 and 8, a request of each size over HTTP and a
    row alone against co-batched. Holds against the fp32 plain model: a
    flagship DDIM-50 sample at batch 2 from one x_T; the learned-variance
    UNet's kernels at the shapes of the CLI's batch-16 forward (every conv,
    the Cout=2 fp32 head among them, and K1 at its attention shapes); that
    UNet's forward, each output channel (the mean and the learned_range
    variance) on its own, and its 'ddpm' sample, which reads the variance
    channel, drawn with per-row keys; and a served DDIM-50 sample. Each
    path's per-step breakdown (``sampling_breakdown``)."""
    import io
    import re
    import threading

    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import bench, inference, serve
    from rho_diffusion_tpu_torch.diffusion.sampling_rng import per_sample_keys

    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    launches, routes, problems = {}, {}, []

    # (a) the bench entry, in-process; its one JSON line and its stderr
    # diagnostics (each timed sample's wall clock and thread CPU) captured
    runs, seconds = {}, {}
    for name, env in GAUSS_BENCH_RUNS:
        torch.cuda.empty_cache()
        captured, err = io.StringIO(), io.StringIO()
        with bench_env(env), contextlib.redirect_stdout(captured), \
                contextlib.redirect_stderr(err):
            result, wall, counts, fr = counted(lambda: bench.main(["-d", DEVICE]))
        lines = captured.getvalue().splitlines()
        diag = err.getvalue().strip()
        runs[name] = {"line": json.loads(lines[-1]) if lines else None, "lines": len(lines),
                      "entry_s": wall, "stderr": diag, "launches": counts, "flash_routes": fr}
        for key in ("sample_s", "thread_cpu_s"):
            found = re.search(rf"\b{key}=(\[[^\]]*\])", diag)
            if found:
                runs[name][key] = json.loads(found.group(1))
        launches[f"gauss_bench_{name}"], routes[f"gauss_bench_{name}"] = counts, fr
        want = ["flash_attention", "conv3d_igemm", "conv3d_direct"]
        if name == "train":
            want += ["flash_attention_bwd", "conv3d_dgrad_igemm"]
        missing = [k for k in want if not counts.get(k)]
        if missing or lines != [json.dumps(result)]:
            problems.append(f"bench {name}: missing {missing}, lines {lines}")
    with bench_env(dict(GAUSS_BENCH_RUNS[0][1])):
        s = bench.settings()
        pipe = bench.sampling_pipeline(s, device)
    torch.cuda.empty_cache()
    runs["sample"]["breakdown"] = sampling_breakdown(
        pipe, pipe.sample_shape(8), torch.zeros((8, 4 * s["mc"]), device=device), "ddim",
        GAUSS_STEPS, wall_s=runs["sample"]["line"]["value"])
    del pipe
    seconds["bench"] = time.perf_counter() - t0

    # the flagship DDIM-50 hold: kernels (bf16) against the fp32 plain model
    sd = random_state_dict(bench.sampling_pipeline(s, "cpu").backbone, seed=0)
    cond2 = torch.from_numpy(serve_conditions(json.loads(CONFIG.read_text()),
                                              GAUSS_HOLD_BATCH, 0)).to(device)
    pipes = {}
    for dt in ("bfloat16", "float32"):
        s_dt = {**s, "backbone_kwargs": {**s["backbone_kwargs"], "dtype": dt}}
        pipes[dt] = bench.sampling_pipeline(s_dt, device)
        pipes[dt].load_state_dict(sd)
    shape2 = pipes["bfloat16"].sample_shape(GAUSS_HOLD_BATCH)
    x_T = randn(shape2, 9, device, torch.float32)

    def ddim(p):
        return {"sample": p.reverse_process(shape2, cond2, sampler="ddim",
                                            num_steps=GAUSS_STEPS, x_T=x_T)}

    got = ddim(pipes["bfloat16"])
    with plain_backends():
        plain_bf16, plain_fp32 = ddim(pipes["bfloat16"]), ddim(pipes["float32"])
    hold = {**hold_rows(got, plain_bf16, plain_fp32, HOLD_CAP)["sample"],
            "batch": GAUSS_HOLD_BATCH, "sampler": "ddim", "steps": GAUSS_STEPS}
    if not hold["ok"]:
        problems.append(f"flagship DDIM-50 hold: {hold}")
    del pipes, got, plain_bf16, plain_fp32
    torch.cuda.empty_cache()
    seconds["hold"] = time.perf_counter() - t0 - sum(seconds.values())

    cfg = gauss_config()
    space_cfg = {"inference": {"parameter_space": cfg["inference"]["parameter_space"]}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gauss_"))
    messages: list = []
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        sd = random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0)
        pth = tmp / "model.pth"
        torch.save(sd, pth)

        # (b) the inference CLI
        out, cli_s, counts, fr = counted(lambda: inference.main(
            [str(cfg_path), "-p", str(pth), "-d", DEVICE, "-f", "--steps", str(GAUSS_STEPS),
             "--work-dir", str(tmp)]))
        launches["gauss_cli"], routes["gauss_cli"] = counts, fr
        mk = cfg["model"]["kwargs"]
        n_cli = cfg["inference"].get("num_samples", 16)
        want_shape = (n_cli, *mk["data_shape"], mk["in_channels"])
        sampler = cfg["inference"]["sampler"]
        cli = {"config": GAUSS_CONFIG.name, "cuts": GAUSS_CUTS, "shape": list(out.shape),
               "finite": bool(np.isfinite(out).all()), "sampler": sampler,
               "steps": GAUSS_STEPS, "wall_s": cli_s, "launches": counts, "flash_routes": fr,
               "sample_mean": float(out.mean()), "sample_std": float(out.std())}
        missing = [k for k in ("flash_attention", "conv3d_igemm", "conv3d_direct")
                   if not counts.get(k)]
        if missing or tuple(out.shape) != want_shape or not cli["finite"] or \
                not any(r.startswith("wgmma") for r in fr):
            problems.append(f"CLI: missing {missing}, {cli}")
        lv, lv32 = (build_pipeline(cfg, dt, device) for dt in ("bfloat16", "float32"))
        lv.load_state_dict(sd)
        lv32.load_state_dict(sd)
        # its kernels at the shapes of the CLI's batch-16 forward: every conv
        # (the Cin=1 input conv, the implicit GEMMs, the Cout=2 fp32 head) and
        # K1 at each attention shape (256 tokens, D = 64)
        conv_rows = hold_convs(lv.backbone, n_cli, "forward", device, seed=200, timed=False)
        attn = sorted({call[0] for call in forward_shapes(lv.backbone, n_cli, device)[1]},
                      key=str)
        flash_rows = [check_flash(*qs, device, seed=210 + i, dtype=dt)
                      for i, (qs, dt) in enumerate(attn)]
        record_errors(state, conv_rows + flash_rows)
        cli["kernel_holds"] = {"conv": conv_rows, "flash": flash_rows}
        bad = [r for r in conv_rows + flash_rows if not r["ok"]]
        if bad:
            problems.append(f"CLI kernels outside tolerance: {bad[:3]}")
        # the forward per output channel, and the 'ddpm' sample drawn with
        # per-row keys, on the kernels against the fp32 plain model
        x, t, y = unet_inputs(lv.backbone, GAUSS_HOLD_BATCH, device, seed=5)
        conds_h = torch.from_numpy(serve_conditions(space_cfg, GAUSS_HOLD_BATCH, 70)).to(device)

        def lv_outputs(p):
            with torch.no_grad():
                f = p.apply(x, t, y).float()
            return {"forward_mean_channel": f[..., 0], "forward_variance_channel": f[..., 1],
                    "sample": p.reverse_process(
                        p.sample_shape(GAUSS_HOLD_BATCH), conds_h, sampler=sampler,
                        num_steps=GAUSS_STEPS, row_keys=per_sample_keys(7, GAUSS_HOLD_BATCH))}

        got = lv_outputs(lv)
        with plain_backends():
            plain_bf16, plain_fp32 = lv_outputs(lv), lv_outputs(lv32)
        caps = {"forward_mean_channel": HOLD_CAP["forward"],
                "forward_variance_channel": HOLD_CAP["forward"], "sample": HOLD_CAP["sample"]}
        cli["hold"] = {**hold_rows(got, plain_bf16, plain_fp32, caps),
                       "batch": GAUSS_HOLD_BATCH, "sampler": sampler, "steps": GAUSS_STEPS}
        bad = [k for k in caps if not cli["hold"][k]["ok"]]
        if bad:
            problems.append(f"CLI hold {bad}: {cli['hold']}")
        del got, plain_bf16, plain_fp32
        conds_cli = torch.from_numpy(serve_conditions(space_cfg, n_cli, 0)).to(device)
        cli["breakdown"] = sampling_breakdown(lv, lv.sample_shape(n_cli), conds_cli, sampler,
                                              GAUSS_STEPS)
        seconds["cli"] = time.perf_counter() - t0 - sum(seconds.values())
        t_svc = time.perf_counter()

        # (c) the service over HTTP
        argv = [str(cfg_path), "-p", str(pth), "-d", DEVICE, "--port", "0", "--buckets",
                ",".join(map(str, GAUSS_BUCKETS)), "--sampler", "ddim", "--steps",
                str(GAUSS_STEPS), "--warmup", "--work-dir", str(tmp)]
        (server, service), build_s, warm_counts, _ = counted(
            lambda: serve.build_server(argv, log=messages.append))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            def requests():
                done = []
                for n, seed in ((1, 1), (8, 2)):
                    t2 = time.perf_counter()
                    reply = http_call(port, "POST", "/generate", {
                        "conditions": serve_conditions(space_cfg, n, seed).tolist(),
                        "seed": seed})
                    arr = np.asarray(reply["samples"], np.float32)
                    done.append({"n": n, "shape": reply["shape"], "bucket": reply["bucket"],
                                 "latency_s": reply["latency_s"],
                                 "http_s": time.perf_counter() - t2,
                                 "finite": bool(np.isfinite(arr).all())})
                return done

            reqs, _, counts, fr = counted(requests)
            launches["gauss_service"], routes["gauss_service"] = counts, fr
            latency = {f"bucket{b}_s": [service.generate(
                serve_conditions(space_cfg, b, 60), seed=60).latency_s for _ in range(2)]
                for b in GAUSS_BUCKETS}
            conds4 = serve_conditions(space_cfg, 4, 20)
            alone = service.generate(conds4[:1], seed=5)
            busy = service.submit(serve_conditions(space_cfg, 8, 30), seed=6)
            mine = service.submit(conds4[:1], seed=5)
            other = service.submit(conds4[1:], seed=7)
            busy.result()
            other.result()
            co = mine.result()
            conds2 = serve_conditions(space_cfg, 2, 40)
            served = service.generate(conds2, seed=8).samples
            # a bucket-8 request's anatomy: timed and profiled through the service
            conds8 = serve_conditions(space_cfg, 8, 50)
            bucket8 = sampling_breakdown(
                lv, lv.sample_shape(8), torch.from_numpy(conds8).to(device), "ddim",
                GAUSS_STEPS, sample=lambda: service.generate(conds8, seed=9))
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
        with plain_backends():
            plain_bf16, plain_fp32 = ({"sample": pl.reverse_process(
                pl.sample_shape(2), torch.from_numpy(conds2).to(device), sampler="ddim",
                num_steps=GAUSS_STEPS, row_keys=per_sample_keys(8, 2)).float().cpu()}
                for pl in (lv, lv32))
        sample_hold = {**hold_rows({"sample": torch.from_numpy(served)}, plain_bf16, plain_fp32,
                                   HOLD_CAP)["sample"], "batch": 2}
        bar = sample_hold["bar"]
        same = {"alone_bucket": alone.bucket, "cobatched_bucket": co.bucket,
                "max_abs_diff": float(np.abs(alone.samples - co.samples).max()),
                "rel_mse": rel_mse(co.samples, alone.samples), "bar": bar,
                "check": "relative MSE of the co-batched row against the alone one"}
        svc = {"buckets": GAUSS_BUCKETS, "sampler": "ddim", "steps": GAUSS_STEPS,
               "build_and_warmup_s": build_s, "warmup_launches": warm_counts,
               "requests": reqs, "launches": counts, "flash_routes": fr,
               "latency_s": latency, "alone_vs_cobatched": same, "sample_hold": sample_hold,
               "breakdown": {**bucket8, "of": "one bucket-8 request through the service"},
               "messages": messages, "seconds": time.perf_counter() - t_svc}
        missing = [k for k in ("flash_attention", "conv3d_igemm", "conv3d_direct")
                   if not counts.get(k)]
        shapes_ok = all(r["shape"] == [r["n"], *mk["data_shape"], 1] and r["finite"]
                        for r in reqs)
        if missing or not shapes_ok:
            problems.append(f"service: missing {missing}, requests {reqs}")
        if co.bucket < 2 or not same["rel_mse"] <= bar:
            problems.append(f"service alone vs co-batched: {same}")
        if not sample_hold["ok"]:
            problems.append(f"service sample hold: {sample_hold}")
        del lv, lv32
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    state["gauss_launches"] = launches
    state.setdefault("flash_routes", {}).update(routes)
    seconds["service"] = svc["seconds"]
    emit("gauss", bench=runs, hold_ddim50=hold, cli=cli, service=svc,
         seconds_by_part=seconds, seconds=time.perf_counter() - t0)
    if problems:
        fail("gauss: " + "; ".join(problems))


# the vlb phase: config_learned_variance.json at full width, its dataset cut
# to VLB_LENGTH items (VLB_LENGTH / 32 steps of one epoch at the config's
# batch 32), evaluated with --bpd on VLB_EVAL_BATCHES batches; inpainting
# (ddpm respaced to VLB_STEPS, VLB_RESAMPLE rounds a step) of
# VLB_INPAINT_ROWS rows, DDIM-VLB_STEPS encoding and decoding of
# VLB_ENCODE_ROWS rows; the holds at VLB_HOLD_BATCH and at the timesteps
# VLB_HOLD_T; the attention of the config's training step (B, T, H, D)
VLB_LENGTH = 256
VLB_EVAL_BATCHES = 1
VLB_STEPS = 50
VLB_RESAMPLE = 2
VLB_INPAINT_ROWS = 8
VLB_ENCODE_ROWS = 4
VLB_HOLD_BATCH = 2
VLB_HOLD_T = (0, 1, 500, 999)
VLB_ATTENTION = (32, 256, 4, 64)
# the kernel instances the vlb phase must see in its profiled training step
VLB_INSTANCES = {"flash forward (K1) at D = 64": r"flash_fwd_wgmma_kernel<64\b",
                 "fused flash backward (K3/K4) at D = 64": r"flash_bwd_wgmma_kernel<64>",
                 "direct conv, general configuration (the Cin = 2 head dgrad)":
                     r"conv3d_direct_kernel<float, ?8, ?16, ?4>"}
# the counts the vlb phase's training must launch
VLB_TRAIN_KERNELS = ("conv3d_igemm", "conv3d_dgrad_igemm", "conv3d_tf32", "conv3d_weight_split",
                     "conv3d_direct", "conv3d_dgrad_direct", "flash_attention",
                     "flash_attention_bwd", "flash_attention_bwd_delta")
VLB_CUTS = {
    "dataset.kwargs.length": f"2048 -> {VLB_LENGTH} (one epoch of {VLB_LENGTH // 32} steps)",
    "training.max_epochs": "40 -> 1",
    "training.save_checkpoint_every_n_epochs": "20 -> 1",
    "training.log_every_n_steps, benchmark_mode, loggers": "50, false, default -> 1, true, "
                                                           "jsonl",
    **GAUSS_CUTS,
}


def vlb_config() -> dict:
    """``examples/config_learned_variance.json`` at full width with the vlb
    phase's cuts."""
    cfg = gauss_config()
    cfg["dataset"]["kwargs"]["length"] = VLB_LENGTH
    cfg["training"].update(max_epochs=1, save_checkpoint_every_n_epochs=1, log_every_n_steps=1,
                           benchmark_mode=True, loggers=["jsonl"])
    return cfg


@contextlib.contextmanager
def timed_methods(cls, names):
    """Host seconds and calls of each method ``names`` of ``cls`` for the
    body (the card synchronised around each call)."""
    import torch

    times = {n: {"s": 0.0, "calls": 0} for n in names}
    saved = {n: getattr(cls, n) for n in names}
    own = {n for n in names if n in vars(cls)}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name]["s"] += time.perf_counter() - t0
            times[name]["calls"] += 1
            return out
        return timed

    for n in names:
        setattr(cls, n, wrap(n, saved[n]))
    try:
        yield times
    finally:
        for n in names:
            if n in own:
                setattr(cls, n, saved[n])
            else:
                delattr(cls, n)


def instances_seen(by_name: dict) -> dict:
    """Which of VLB_INSTANCES the profiled kernel names hold."""
    return {what: sorted({name[:120] for name in by_name if re.search(pattern, name)})
            for what, pattern in VLB_INSTANCES.items()}


def vb_elements(pipe, model_fn, x0, x_t, t):
    """``vb_terms_bpd`` before its mean over each sample: per element, the
    KL in bits, at t = 0 the discretised decoder's NLL in bits."""
    import torch

    from rho_diffusion_tpu_torch.diffusion.gaussian import (
        p_mean_variance, q_posterior_mean_variance)
    from rho_diffusion_tpu_torch.metrics.losses import (
        discretized_gaussian_log_likelihood, normal_kl)

    true_mean, _, true_log_var = q_posterior_mean_variance(pipe.coeffs, x0, x_t, t)
    out = p_mean_variance(pipe.coeffs, model_fn, x_t, t, pipe.model_mean_type,
                          pipe.model_var_type, clip_denoised=False)
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    nll = -discretized_gaussian_log_likelihood(x0, out["mean"], 0.5 * out["log_variance"])
    first = (t == 0).reshape(-1, *(1,) * (x0.ndim - 1))
    return torch.where(first, nll, kl) / math.log(2.0)


def vlb_holds(cfg: dict, data: dict, device) -> dict:
    """The kernels against the fp32 plain model on the learned-variance UNet
    (random seeded weights), by the hold rule on element-wise terms (a mean
    over a few samples is one number, whose bf16 distance from fp32 can
    cancel to nothing by chance; the terms it averages cannot):

    * the hybrid loss at VLB_HOLD_BATCH with injected t and noise: its two
      integrands, the squared error of the mean half (the config's epsilon
      target) and the ``vb`` term's per-element bits (times T/1000 under
      rescaled_mse), the loss being their means summed; and the parameter
      gradients of the loss (``loss_and_metrics``, backward);
    * ``vb_terms_bpd``'s per-element bits of a real row at each of
      VLB_HOLD_T.

    The scalar losses and each row's ``vb_terms_bpd`` are printed beside."""
    import torch

    from rho_diffusion_tpu_torch.diffusion.gaussian import LossType, q_sample, vb_terms_bpd
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    pipes = {dt: build_pipeline(cfg, dt, device) for dt in ("bfloat16", "float32")}
    sd = random_state_dict(pipes["float32"].backbone, seed=0)
    for p in pipes.values():
        p.load_state_dict(sd)
    fast, ref = pipes["bfloat16"], pipes["float32"]
    b = VLB_HOLD_BATCH
    gen = torch.Generator().manual_seed(21)
    x0, y = data["data"][:b], data["labels"][:b]
    t = torch.tensor([1, fast.coeffs.num_timesteps - 1])[:b].to(device)
    noise = torch.randn(x0.shape, generator=gen).to(device)
    batch = {"data": x0, "labels": y}
    n_t = len(VLB_HOLD_T)
    xs, ys = data["data"][:n_t], data["labels"][:n_t]
    tt = torch.tensor(VLB_HOLD_T, device=device)
    nz = torch.randn(xs.shape, generator=gen).to(device)
    scale = fast.coeffs.num_timesteps / 1000.0 if fast.loss_type == LossType.RESCALED_MSE \
        else 1.0

    def terms(p):
        with torch.no_grad():
            x_t = q_sample(p.coeffs, x0, t, noise)
            out = p._train_model_fn(y)(x_t, p.coeffs.timestep_map[t])
            ch = x0.shape[-1]
            got = {"loss_mse_elements": (noise - out[..., :ch]) ** 2,
                   "loss_vb_elements": scale * vb_elements(p, lambda *_: out, x0, x_t, t)}
            xs_t = q_sample(p.coeffs, xs, tt, nz)
            vb_el = vb_elements(p, p._model_fn(ys), xs, xs_t, tt)
            got.update({f"vb_terms_bpd_t{t_}_elements": vb_el[i]
                        for i, t_ in enumerate(VLB_HOLD_T)})
            _, m = p.loss_and_metrics(batch, t=t, noise=noise)
            values = {k: float(m[k]) for k in ("train_loss", "vb", "mse")}
            values["vb_terms_bpd"] = vb_terms_bpd(p.coeffs, p._model_fn(ys), xs, xs_t, tt,
                                                  p.model_mean_type, p.model_var_type)[
                "output"].tolist()
        return got, values

    before = dict(launch_counts)
    got, values = terms(fast)
    grads = train_gradients(fast, batch, t, noise)
    launched = {k: v - before.get(k, 0) for k, v in launch_counts.items() if v > before.get(k, 0)}
    with plain_backends():
        plain_bf16, _ = terms(fast)
        plain_fp32, values_fp32 = terms(ref)
        grads_bf16_plain = train_gradients(fast, batch, t, noise)
        grads_fp32_plain = train_gradients(ref, batch, t, noise)
    torch.cuda.synchronize()
    rows = hold_rows(got, plain_bf16, plain_fp32, dict.fromkeys(got, HOLD_CAP["forward"]))
    k_, k_name, k_worst = grad_distance(grads, grads_fp32_plain)
    p_, p_name, p_worst = grad_distance(grads_bf16_plain, grads_fp32_plain)
    rows["hybrid_loss_gradients"] = {
        "metric": "relative L2 over all parameter gradients",
        "kernels_vs_fp32_plain": k_, "bf16_plain_vs_fp32_plain": p_,
        "kernels_vs_bf16_plain": grad_distance(grads, grads_bf16_plain)[0],
        "worst_parameter_kernels": {"name": k_name, "rel_l2": k_worst},
        "worst_parameter_bf16_plain": {"name": p_name, "rel_l2": p_worst},
        "parameters": len(grads_fp32_plain),
        "bar": min(HOLD_FACTOR * p_, HOLD_CAP["train_gradients"]),
        "kernel_launches": launched,
        "finite": set(grads) == set(grads_fp32_plain) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())}
    g = rows["hybrid_loss_gradients"]
    g["ok"] = g["finite"] and k_ <= g["bar"]
    del pipes, fast, ref, grads, grads_bf16_plain, grads_fp32_plain
    torch.cuda.empty_cache()
    return {**rows, "values_kernels": values, "values_fp32_plain": values_fp32,
            "loss_batch": b, "loss_t": t.tolist(), "vb_terms_t": list(VLB_HOLD_T)}


def phase_vlb(state: dict) -> None:
    """GaussianDiffusion's training half on the card at full width, on
    ``examples/config_learned_variance.json`` (learned_range variance,
    rescaled_mse, out_channels 2, batch 32, bf16), each path's launch counts
    cleared just before it and read just after: (a) one epoch through
    ``python -m rho_diffusion_tpu_torch.training``'s main (the dataset cut
    to VLB_LENGTH items), from seeded random weights, and one profiled step
    on the trained EMA weights; (b) ``python -m
    rho_diffusion_tpu_torch.evaluate --bpd`` on those weights (validation,
    a DDIM-VLB_STEPS generate at batch 8, the 1000-step VLB loop at batch
    4), each part timed; (c) RePaint inpainting of VLB_INPAINT_ROWS real
    rows (ddpm respaced to VLB_STEPS, VLB_RESAMPLE rounds, the first half
    of the volume kept), the kept half checked exact, and DDIM encoding and
    decoding of VLB_ENCODE_ROWS rows. Holds against the fp32 plain model
    (``vlb_holds``); the head's Cin = 2 fp32 dgrad against its plain
    version, timed beside conv3d_input and its bound; the fused K3/K4 at
    VLB_ATTENTION twice (bitwise) and K1 and K3/K4 timed there beside SDPA
    and their bounds."""
    import io

    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import evaluate
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.loader import DataLoader, to_device
    from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
    from rho_diffusion_tpu_torch.diffusion.gaussian import GaussianDiffusionPipeline
    from rho_diffusion_tpu_torch.ops import attention as attn_mod
    from rho_diffusion_tpu_torch.training.__main__ import main as train_main
    from rho_diffusion_tpu_torch.training.checkpoint import resolve_inference_params

    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    launches, problems, seconds = {}, [], {}
    cfg = vlb_config()
    batch_size = cfg["training"]["batch_size"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_vlb_"))
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        sd0 = random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0)
        pth = tmp / "random.pth"
        torch.save(sd0, pth)
        work = tmp / "run"

        # (a) one epoch through the training CLI
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with direct_conv_calls() as direct, \
                CallRecorder(attn_mod, "flash_attention") as attn_rec:
            st, train_wall, counts, fr = counted(lambda: train_main(
                [str(cfg_path), "-p", str(pth), "-d", DEVICE, "--work-dir", str(work),
                 "--no-resume"]))
        train_peak = torch.cuda.max_memory_allocated()
        launches["vlb_training"], state.setdefault("flash_routes", {})["vlb_training"] = \
            counts, fr
        logged = trained_records(work)
        changed = sum(not torch.equal(v.detach().cpu(), sd0[k])
                      for k, v in st.model.state_dict().items())
        per_step = len(attn_rec.calls) // max(logged["steps"], 1)
        attn_shapes = sorted({c[0][0] for c in attn_rec.calls})
        direct_problems = direct_launches(direct.calls)
        del st
        torch.cuda.empty_cache()
        config = ExperimentConfig.from_dict(cfg)
        dataset = SphericalHarmonicDataset(**config.dataset.kwargs)
        data = to_device(next(iter(DataLoader(dataset, batch_size, shuffle=False))), device)
        pipe = build_pipeline(cfg, "bfloat16", device)
        messages = resolve_inference_params(pipe, config, str(work / "checkpoints"), work)
        ts = pipe.create_state(seed=0)
        pipe.training_step(ts, data)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.training_step(ts, data)
        torch.cuda.synchronize()
        one_step_s = time.perf_counter() - t1
        by_name = device_time_by_kernel(lambda: pipe.training_step(ts, data))
        profiled = profiled_step(by_name, one_step_s)
        seen = instances_seen(by_name) if by_name else NOT_PROFILED["status"]
        del ts
        resolve_inference_params(pipe, config, str(work / "checkpoints"), work)  # EMA again
        median = logged["median_step_s_after_first"]
        train = {**logged, "wall_s": train_wall, "batch": batch_size,
                 "steps_per_s": 1 / median if median else None,
                 "samples_per_s": batch_size / median if median else None,
                 "max_memory_allocated": train_peak, "params_changed": changed,
                 "params": len(sd0), "launches": counts, "flash_routes": fr,
                 "direct_conv_problems": direct_problems,
                 "attention_shapes_b_t_h_d": attn_shapes, "attention_calls_per_step": per_step,
                 "read_back": messages, "profiled_step": profiled,
                 "profiled_instances": seen}
        head_dgrad = conv_problem_name("dgrad", (batch_size, 16, 16, 16, 2), 64, "float32")
        missing = [k for k in VLB_TRAIN_KERNELS if not counts.get(k)]
        if logged["steps"] != VLB_LENGTH // batch_size or not all(
                np.isfinite(logged["losses"] + logged["grad_norms"])):
            problems.append(f"training logged {logged}")
        if missing or not changed:
            problems.append(f"training never launched {missing} (changed {changed}): {counts}")
        if not flash_counts_ok(counts, per_step, logged["steps"], training=True):
            problems.append(f"training flash launches {counts}, {per_step} attention calls a "
                            "step")
        if not direct_problems.get(head_dgrad):
            problems.append(f"the head's Cin = 2 dgrad never ran direct: {direct_problems}")
        if attn_shapes != [VLB_ATTENTION]:
            problems.append(f"attention shapes {attn_shapes}, expected [{VLB_ATTENTION}]")
        if isinstance(seen, dict) and not all(seen.values()):
            problems.append(f"the profiled step shows no launch of {seen}")
        seconds["train"] = time.perf_counter() - t0

        # (b) the evaluate CLI with --bpd on the trained EMA weights
        captured = io.StringIO()
        with timed_methods(GaussianDiffusionPipeline,
                           ("validation_step", "generate", "calc_bpd")) as parts, \
                contextlib.redirect_stdout(captured):
            report, eval_wall, counts, fr = counted(lambda: evaluate.main(
                [str(cfg_path), "-p", str(work / "checkpoints"), "-d", DEVICE, "--bpd",
                 "--num-batches", str(VLB_EVAL_BATCHES)]))
        launches["vlb_evaluate"], state["flash_routes"]["vlb_evaluate"] = counts, fr
        keys = ("val_loss", "val_psnr", "wasserstein_gen_vs_real", "total_bpd", "prior_bpd")
        evaluation = {"report": report, "wall_s": eval_wall, "parts_s": parts,
                      "launches": counts, "flash_routes": fr,
                      "printed": captured.getvalue().splitlines()[:3]}
        if not all(np.isfinite(report.get(k, np.nan)) for k in keys) or \
                not report.get("generated_finite"):
            problems.append(f"evaluate report {report}")
        missing = [k for k in ("conv3d_igemm", "conv3d_direct", "conv3d_tf32", "flash_attention")
                   if not counts.get(k)]
        if missing or counts.get("flash_attention_bwd"):
            problems.append(f"evaluate launches {counts}")
        seconds["evaluate"] = time.perf_counter() - t0 - sum(seconds.values())

        # (c) inpainting and encoding on the trained EMA weights
        n = VLB_INPAINT_ROWS
        known, conds = data["data"][:n], data["labels"][:n]
        depth = known.shape[1]
        mask = torch.zeros((1, depth, 1, 1, 1), device=device)
        mask[:, :depth // 2] = 1.0
        out, inpaint_s, counts, fr = counted(lambda: pipe.inpaint(
            known, mask, conds, sampler="ddpm", num_steps=VLB_STEPS,
            resample_steps=VLB_RESAMPLE, generator=torch.Generator(device=device).manual_seed(3)))
        launches["vlb_inpaint"] = counts
        keep = mask.expand_as(known).bool()
        inpaint = {"rows": n, "sampler": "ddpm", "steps": VLB_STEPS,
                   "resample_steps": VLB_RESAMPLE, "model_calls": VLB_STEPS * VLB_RESAMPLE,
                   "mask": f"depth planes [0, {depth // 2}) of {depth} kept",
                   "wall_s": inpaint_s, "launches": counts,
                   "known_region_exact": bool(torch.equal(out[keep], known[keep])),
                   "finite": bool(torch.isfinite(out).all()),
                   "generated_region_rel_mse_vs_known": rel_mse(out[~keep], known[~keep])}
        m = VLB_ENCODE_ROWS
        lat, enc_s, enc_counts, _ = counted(
            lambda: pipe.encode(known[:m], conds[:m], num_steps=VLB_STEPS))
        back, dec_s, dec_counts, _ = counted(lambda: pipe.reverse_process(
            (m, *known.shape[1:]), conds[:m], sampler="ddim", num_steps=VLB_STEPS, x_T=lat))
        launches["vlb_encode"], launches["vlb_decode"] = enc_counts, dec_counts
        encode = {"rows": m, "steps": VLB_STEPS, "encode_s": enc_s, "decode_s": dec_s,
                  "latent_std": float(lat.std()), "finite": bool(torch.isfinite(back).all()),
                  "round_trip_rel_mse": rel_mse(back, known[:m]),
                  "launches": {"encode": enc_counts, "decode": dec_counts}}
        if not (inpaint["known_region_exact"] and inpaint["finite"] and encode["finite"]):
            problems.append(f"inpaint {inpaint}, encode {encode}")
        for name, c in (("inpaint", counts), ("encode", enc_counts), ("decode", dec_counts)):
            if not c.get("flash_attention") or not c.get("conv3d_igemm"):
                problems.append(f"{name} launches {c}")
        del pipe, out, lat, back
        torch.cuda.empty_cache()
        seconds["inpaint_encode"] = time.perf_counter() - t0 - sum(seconds.values())

        # the holds on the kernels against the fp32 plain model
        holds = vlb_holds(cfg, data, device)
        bad = [k for k, v in holds.items() if isinstance(v, dict) and v.get("ok") is False]
        if bad:
            problems.append(f"holds {bad}: {holds}")
        seconds["holds"] = time.perf_counter() - t0 - sum(seconds.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    # the head's Cin = 2 fp32 dgrad, and K1 and K3/K4 at the training
    # step's attention: held against their plain versions and timed
    per = f"one training step at batch {batch_size}"
    conv_rows = [hold_conv("dgrad", ((batch_size, 16, 16, 16, 2), 64, torch.float32), device,
                           seed=700, calls=1, per=per)]
    conv_rows[0]["variant"] = f"vlb: the learned-variance head's dgrad (Cin = 2), {per}"
    b_, t_, h_, d_ = VLB_ATTENTION
    variant = f"vlb: T={t_}, D={d_}, B*H={b_ * h_}, {per}"
    bwd_hold = check_flash_bwd(b_, t_, h_, d_, device, seed=710, dtype=torch.bfloat16)
    flash_rows = ([flash_fwd_row(b_, t_, h_, d_, per_step, per, device, torch.bfloat16,
                                 variant=variant)]
                  + flash_bwd_rows(b_, t_, h_, d_, per_step, per, device, torch.bfloat16,
                                   variant=variant))
    rows = conv_rows + flash_rows
    record_errors(state, rows + bwd_hold["grads"])
    if not bwd_hold["ok"]:
        problems.append(f"fused backward hold {bwd_hold}")
    seconds["kernel_rows"] = time.perf_counter() - t0 - sum(seconds.values())
    state["vlb"] = rows
    state["vlb_launches"] = launches
    emit("vlb", config=GAUSS_CONFIG.name, cuts=VLB_CUTS, train=train, evaluate=evaluation,
         inpaint=inpaint, encode=encode, holds=holds, flash_bwd_hold=bwd_hold, rows=rows,
         seconds_by_part=seconds, seconds=time.perf_counter() - t0)
    if problems:
        fail("vlb: " + "; ".join(problems))
    fail_bad("vlb", rows)


def profiled_step(by_name: dict, host_s: float) -> dict:
    """One profiled training step: its host seconds, the device's busy
    share, and the device time by DEVICE_TIME_GROUPS."""
    if not by_name:
        return {"host_s": host_s, **NOT_PROFILED}
    groups: dict = {}
    for name, (ms, n) in by_name.items():
        group = next((g for g, keys in DEVICE_TIME_GROUPS if any(k in name for k in keys)),
                     "other PyTorch ops (GroupNorm, SiLU, casts, copies, adds, reductions)")
        total, count = groups.get(group, (0.0, 0))
        groups[group] = (total + ms, count + n)
    out = {"host_s": host_s, **profile_summary(by_name)}
    out.update(device_busy_share=out["busy_ms"] / 1e3 / host_s,
               by_group={g: {"ms": ms, "launches": n} for g, (ms, n)
                         in sorted(groups.items(), key=lambda kv: -kv[1][0])})
    return out


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
            with direct_conv_calls() as direct:
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

    profiled = profiled_step(by_name, one_step_s)
    flash_bwd_profiled = {name[:90]: {"ms": ms, "launches": n}
                          for name, (ms, n) in by_name.items() if "flash_bwd" in name}
    after_first = step_s[1:]
    median = float(np.median(after_first)) if after_first else None
    state["train_launches"] = counts
    state.setdefault("direct_launches", {})["training"] = direct_launches(direct.calls)
    emit("train", batch=batch, grad_accum=cfg["training"].get("grad_accum", 1),
         steps=len(steps), cuts=TRAIN_CUTS,
         losses=losses, grad_norms=norms, step_s=step_s, median_step_s_after_first=median,
         samples_per_s=batch / median if median else None, wall_s=wall,
         max_memory_allocated=peak, launches=counts, params_changed=changed,
         params=len(sd0), checkpoint_step=latest, inference_messages=messages,
         ema_read_back_bitwise=ema_equal, ema_params=ema_params, profiled_step=profiled,
         profiled_flash_bwd_kernels=flash_bwd_profiled)
    problems = []
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses + norms)):
        problems.append(f"{len(steps)} logged steps, losses {losses}, grad norms {norms}")
    if not changed:
        problems.append("no parameter changed")
    # every kernel of the sampling and training paths runs on the training path
    missing = [name for name, _, _, path in KERNELS
               if path in ("sampling", "training") and not counts.get(name)]
    if missing:
        problems.append(f"the training path never launched {missing}; counts {counts}")
    # the flagship's bf16 attention (D = 128) takes the fused backward: one
    # launch per forward with the LSE, and never the dkv/dq pair
    pair = [name for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq") if counts.get(name)]
    if pair or not (counts.get("flash_attention_bwd") == counts.get("flash_attention_bwd_delta")
                    == counts.get("flash_attention")):
        problems.append(f"the backward's launches {counts} are not one fused launch per forward")
    if any("flash_bwd_dkv" in name or "flash_bwd_dq" in name for name in flash_bwd_profiled):
        problems.append(f"the profiled step ran the dkv/dq pair: {flash_bwd_profiled}")
    if latest != TRAIN_STEPS or not ema_equal:
        problems.append(f"checkpoint step {latest}, EMA read back bitwise: {ema_equal}")
    if problems:
        fail("train: " + "; ".join(problems))


@contextlib.contextmanager
def plain_backends(int8: bool = True):
    """Send every conv and attention call, and (unless ``int8`` is False)
    every int8 piece, to its plain version."""
    from rho_diffusion_tpu_torch.ops.attention import set_attention_backend
    from rho_diffusion_tpu_torch.ops.convolution import set_conv3d_backend

    from rho_diffusion_tpu_torch.ops.quant import set_int8_backend

    set_conv3d_backend("plain")
    set_attention_backend("xla")
    set_int8_backend("plain" if int8 else "auto")
    try:
        yield
    finally:
        set_conv3d_backend("auto")
        set_attention_backend("auto")
        set_int8_backend("auto")


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

    fields = hold_rows(got, plain_bf16, plain_fp32, HOLD_CAP)
    bad = [what for what, row in fields.items() if not row["ok"]]
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
            ring_b1 = [alone.latency_s] + [service.generate(conds4[:1], seed=5).latency_s
                                           for _ in range(2)]
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
        server1, single = serve.build_server(serve_argv(cfg_path, pth, tmp, (1, 2), False),
                                             log=messages.append)
        server1.server_close()
        try:
            flat = single.generate(conds2, seed=8).samples
            single_b1 = [single.generate(conds4[:1], seed=5).latency_s for _ in range(3)][1:]
        finally:
            single.close()
        single_launches = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                           if v > before.get(k, 0)}
        single_vs_ring = {"rel_mse": rel_mse(got, flat),
                          "max_abs_diff": float(np.abs(got - flat).max()),
                          "bar": bar, "launches": single_launches}
        bucket1 = {"ring_latency_s": ring_b1, "single_rank_latency_s": single_b1,
                   "ring_over_single_rank": min(ring_b1) / min(single_b1),
                   "of": "one 25-step request of one row, enqueue to fulfilment; the "
                         "single-rank service's first call is its warm-up and is left out"}
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
         bucket8_device_busy_share=bucket8.get("device_busy_share", NOT_PROFILED["status"]),
         bucket1_request=bucket1, single_rank_vs_ring=single_vs_ring, messages=messages,
         ring_service_s=ring_s,
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


def conv_cost(key) -> tuple[float, float, int]:
    """(flops, bytes, bytes an element) of one conv problem: x and the
    weights read once, the output written once."""
    xs, cout, dt = key
    item = 2 if str(dt).endswith("bfloat16") else 4
    vox = math.prod(xs[:-1])
    cin = xs[-1]
    flops = 2.0 * vox * cout * 27 * cin
    nbytes = item * (vox * cin + 27 * cin * cout + vox * cout + cout)
    return flops, nbytes, item


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
    conv.append({**hold_conv("forward", (LEVEL0_64, 64, torch.bfloat16), device, seed=290,
                             calls=1, per="one call"),
                 "variant": "the 64^3 config's level-0 conv, batch 1"})
    emit("timings_conv", batch=batch, rows=conv)

    attn_calls = forward_shapes(unet, batch, device)[1]
    (qs, _), _, _ = attn_calls[0]
    b, t, h, d = qs
    n, per = len(attn_calls), f"one UNet forward at batch {batch}"
    flash = [flash_fwd_row(b, t, h, d, n, per, device, torch.bfloat16),
             flash_fwd_row(b, 4096, h, d, 1, per, device, torch.bfloat16,
                           variant="T=4096 (the 64^3 config's attention), one call")]
    emit("timings_flash", rows=flash)
    per_ring = f"one UNet forward at batch {batch} under a context={SERVE_CONTEXT} mesh"
    ring = [ring_row(b, t, h, d, SERVE_CONTEXT, n, per_ring, device, torch.bfloat16),
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


def flash_fwd_row(b, t, h, d, calls: int, per: str, device, dtype, variant=None,
                  plan=None, plain_rows=None, full_check=False) -> dict:
    """The forward kernel on [b, t, h, d] views of one qkv (through the
    autograd Function, or at ``plan`` through the launcher: the route a new
    one replaced): held against the plain version, timed beside it, SDPA and
    its bound: the largest of its T^2 exponentials a batch*head on the
    special-function unit (``exp_bound_ms``), its two products and its
    bytes. On the fp32 3xTF32 route the kernel is the fold, whose K/V
    pre-pass has a row of its own (``flash_fwd_split_row``). With
    ``plain_rows`` the plain version is held and timed that many batch rows
    at a time, over the whole batch (where its fp32 scores do not fit at
    once); with ``full_check`` the kernel is also run twice and held bitwise
    to itself, and the wrapper's and SDPA's device work are timed from CUDA
    graphs."""
    import torch.nn.functional as F

    import torch

    from rho_diffusion_tpu_torch.ops.attention import xla_attention
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_kernel, flash_plan)

    q, k, v = flash_inputs(b, t, h, d, device, seed=300 + t, dtype=dtype)
    if plan is None:
        plan = flash_plan(b, h, t, t, d, dtype, torch.cuda.get_device_properties(device)
                          .multi_processor_count)
        run = functools.partial(flash_attention, q, k, v)
    else:
        def run():
            return flash_attention_fwd_kernel(q, k, v, plan=plan)[0][..., :d]
    name = fwd_kernel_name(d, dtype, plan)
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    chunks = batch_chunks(b, plain_rows)

    def plain(s):
        return (xla_attention(qf[s], kf[s], vf[s]),)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)

    flops = 4.0 * b * h * t * t * d
    item = q.element_size()
    row = {"kernel": name, "variant": variant, "b": b, "t": t, "h": h, "d": d,
           "dtype": dtype_name(dtype), "calls": calls, "per": per, "flash_route": plan.route,
           "plan": plan_name(plan),
           **chunked_errors((run(),), plain, chunks, TOL_FLASH[dtype_name(dtype)])[0],
           **kernel_times(run, name), "host_ms": host_ms(run),
           "plain_ms": cuda_time_ms(lambda: [plain(s) for s in chunks], iters=3, warmup=1),
           "library": "scaled_dot_product_attention", "library_ms": cuda_time_ms(sdpa, iters=10),
           "library_kernels": kernel_names(sdpa),
           **dtype_bound(flops, item * 4.0 * b * t * h * d, item)}
    if plain_rows is not None:
        row["plain_ms_of"] = f"the plain version over the batch, {plain_rows} rows at a time"
    if full_check:
        row.update(bitwise_repeatable=bitwise_repeatable(run),
                   wrapper_device_ms=graph_ms(run, calls=10),
                   library_device_ms=graph_ms(sdpa, calls=10))
        row["ok"] = row["ok"] and row["bitwise_repeatable"]
    exp_ms = exp_bound_ms(b, h, t, device)
    if exp_ms > row["bound_ms"]:
        row.update(bound_ms=exp_ms, bound_by="operations")
    row.update(bound_exp_ms=exp_ms, bound_products_ms=bound_ms(flops, 0, PEAK_BF16)[0]
               if item == 2 else bound_ms(3 * flops, 0, PEAK_TF32)[0],
               bound_bytes_ms=item * 4.0 * b * t * h * d / MEM_RATE * 1e3,
               sm_clock_mhz=sm_max_clock_hz() / 1e6, exponentials=b * h * t * t,
               bound_of=("the largest of: T^2 exponentials a batch*head at "
                         f"{SFU_EX2_PER_CLOCK_SM} ex2 a clock an SM, the two products at the "
                         "dtype's peak, the bytes at 3.35 TB/s"))
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def flash_fwd_split_row(b, t, h, d, calls: int, per: str, device, variant=None) -> dict:
    """The fp32 forward's K/V pre-pass on the same views as its fold's row:
    held bitwise against its plain version, timed beside it and its byte
    bound (k and v read once, both terms of each written once)."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd_split, flash_split_plain)

    _, k, v = flash_inputs(b, t, h, d, device, seed=300 + t, dtype=torch.float32)
    got, want = flash_fwd_split(k, v), flash_split_plain(k, v)
    return {"kernel": "flash_attention_tf32_split", "variant": variant, "dtype": "float32",
            "b": b, "t": t, "h": h, "d": d, "calls": calls, "per": per,
            **exact_error(torch.cat([x.flatten() for x in got]),
                          torch.cat([x.flatten() for x in want])),
            **kernel_times(lambda: flash_fwd_split(k, v), "flash_attention_tf32_split"),
            "plain_ms": cuda_time_ms(lambda: flash_split_plain(k, v), iters=5),
            "library": "none: no one PyTorch call rounds to TF32", "library_ms": None,
            "bound_ms": 3 * 2 * 4.0 * k.numel() / MEM_RATE * 1e3, "bound_by": "bytes"}


def kernel_names(fn) -> dict:
    """{CUDA kernel name: launches recorded} of two calls of ``fn``: which
    kernels a library call runs."""
    from rho_diffusion_tpu_torch.benchmarks._timing import kernel_events

    return {name[:120]: n for name, (_, n) in kernel_events(fn, 2).items()}


OPS_CALLS = 10  # ring calls whose operations ring_row lists
COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat")


def ops_of(fn, iters: int) -> tuple[dict, dict]:
    """({CUDA operation: count}, {host copy or cat op: count}) over
    ``iters`` calls of ``fn`` under torch.profiler."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks._timing import device_events, trace_events

    events = trace_events(fn, iters)
    device, copies = {}, {}
    for e in device_events(events):
        device[e.name()] = device.get(e.name(), 0) + 1
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in COPY_OPS:
            copies[e.name()] = copies.get(e.name(), 0) + 1
    return device, copies


def ring_row(b, t, h, d, n, calls: int, per: str, device, dtype, variant=None) -> dict:
    """K6 in its ring of ``n`` ranks on one card, [b, t, h, d] views of one
    qkv: held against the ring with the plain version, timed beside it
    (``ms``: the device time per call; ``call_ms``: the whole call, host work
    included), SDPA over the unsharded inputs, the function's bound and the
    design's own byte floor. ``device_ops_in_calls`` and ``copy_ops_in_calls``
    count the device operations and the host's copy or concatenation ops
    that torch.profiler recorded over OPS_CALLS calls (it misses some device
    operations at the start of its window): the ring kernel's launches and
    nothing else, no copy between ranks."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    q, k, v = flash_inputs(b, t, h, d, device, seed=700 + t, dtype=dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    mesh = ring_mesh(n, device)
    item = q.element_size()
    flops = 4.0 * b * h * t * t * d
    name = ring_kernel_name(dtype, d)
    tf32 = name == "ring_attention_tf32"
    # what this design moves: q read once, every rank's K/V shard read by
    # each of the n ranks, o written once; the tf32 route's pre-pass reads
    # k and v once and writes both terms of each, which the n ranks read
    shard = b * h * (t // n) * d
    design_bytes = item * (n * shard + n * n * (4 if tf32 else 2) * shard + n * shard)
    expected = {name: 1, **({"ring_attention_tf32_split": 1} if tf32 else {})}
    before = dict(launch_counts)
    ring_call(q, k, v, mesh)
    torch.cuda.synchronize()
    launches = {key: launch_counts[key] - before.get(key, 0) for key in expected}
    ops, copies = ops_of(lambda: ring_call(q, k, v, mesh), OPS_CALLS)
    times = kernel_times(lambda: ring_call(q, k, v, mesh), name)
    row = {"kernel": name, "variant": variant, "b": b, "t": t, "h": h, "d": d, "n": n,
           "t_per_rank": t // n, "dtype": dtype_name(dtype), "calls": calls, "per": per,
           **flash_error(ring_call(q, k, v, mesh), ring_call(qf, kf, vf, mesh, plain=True),
                         TOL_FLASH[dtype_name(dtype)]),
           **times, "launches_per_call": launches[name], "device_ops_in_calls": ops,
           "copy_ops_in_calls": copies, "ops_calls": OPS_CALLS,
           "plain_ms": cuda_time_ms(lambda: ring_call(qf, kf, vf, mesh, plain=True), iters=3,
                                    warmup=1),
           "library": "scaled_dot_product_attention over the unsharded [B, H, T, D]",
           "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                      iters=10),
           "library_kernels": kernel_names(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
           **dtype_bound(flops, item * 4.0 * b * t * h * d, item), "design_bytes": design_bytes,
           "design_bytes_ms": design_bytes / MEM_RATE * 1e3}
    row["tflops"] = flops / row["ms"] / 1e9
    if tf32:
        row["pre_pass"] = ring_split_row(k, v, n, calls, per, variant)
    kernels = [CUDA_KERNEL[key] for key in expected]
    others = [op for op in ops if not any(kn in op for kn in kernels)]
    if launches != expected or others or copies:
        row["ok"] = False
        row["fault"] = (f"a ring call on one card made the launches {launches}, the device "
                        f"operations {ops} and the copies {copies}; expected {expected} and "
                        "nothing else")
    return row


def ring_split_row(k, v, n: int, calls: int, per: str, variant) -> dict:
    """K6's tf32 pre-pass on the n shards of k and v (the ring's split of
    the tokens): held bitwise against its plain version, timed beside it
    and its byte bound (k and v read once, both terms of each written
    once)."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.ring_attention import ring_split, ring_split_plain

    ks, vs = k.split(k.shape[1] // n, dim=1), v.split(v.shape[1] // n, dim=1)
    got, want = ring_split(ks, vs), ring_split_plain(ks, vs)
    nbytes = 3 * 2 * 4.0 * k.numel()
    return {"kernel": "ring_attention_tf32_split", "variant": variant, "dtype": "float32",
            "b": k.shape[0], "t": k.shape[1], "n": n, "calls": calls, "per": per,
            **exact_error(torch.cat([x.flatten() for x in got]),
                          torch.cat([x.flatten() for x in want])),
            **kernel_times(lambda: ring_split(ks, vs), "ring_attention_tf32_split"),
            "plain_ms": cuda_time_ms(lambda: ring_split_plain(ks, vs), iters=5),
            "library": "none: no one PyTorch call rounds to TF32", "library_ms": None,
            "bound_ms": nbytes / MEM_RATE * 1e3, "bound_by": "bytes"}


def sdpa_backward_ms(q, k, v, do) -> dict:
    """SDPA's backward (dq, dk, dv together) on [B, H, T, D] views of the
    same inputs. ``library_ms``: its device time per call, a CUDA graph of
    forward+backward less a graph of the same forward (``graph_ms``: no
    host work, no launch missed), as the port's own rows take theirs when
    the profiler misses launches. Beside it, torch.profiler's recorded
    durations over ``autograd.grad`` calls on one forward's graph (each CUDA
    operation's mean, once a call: an assumption, since the profiler misses
    some launches) and the CUDA-event difference of forward+backward less
    forward, host work included."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.benchmarks._timing import kernel_events

    qt, kt, vt = (z.detach().transpose(1, 2).requires_grad_() for z in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    def fwd():  # with grad, as in fwd_bwd: the forward that saves its LSE
        F.scaled_dot_product_attention(qt, kt, vt)

    graph_fwd_bwd_ms, graph_fwd_ms = graph_ms(fwd_bwd, calls=10), graph_ms(fwd, calls=10)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
    event_ms = cuda_time_ms(fwd_bwd, iters=10) - fwd_ms
    out = F.scaled_dot_product_attention(qt, kt, vt)
    iters = 10
    by_name = kernel_events(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                            iters)
    return {"library_ms": graph_fwd_bwd_ms - graph_fwd_ms,
            "library_ms_of": "device time: a CUDA graph of forward+backward less one of the "
                             "forward",
            "library_graph_ms": {"forward_backward": graph_fwd_bwd_ms, "forward": graph_fwd_ms},
            "library_profiled_ms": (sum(ms / n for ms, n in by_name.values()) if by_name
                                    else None),
            "library_event_ms": event_ms,
            "library_launches_recorded": {name[:60]: n for name, (_, n) in by_name.items()},
            "library_calls_profiled": iters}


def flash_bwd_rows(b, t, h, d, calls: int, per: str, device, dtype, variant=None,
                   old_variant=None, plain_rows=None, full_check=False) -> list:
    """The backward on [b, t, h, d] views of one qkv (the wrapper computes
    delta on each call, as in training), each kernel held against its plain
    version on the kernel forward's output and LSE, timed beside it, its
    bound and SDPA's backward. For bf16 at D = 64 and 128: the fused kernel
    at its plan, then the mma.sync pair on the same inputs (``plan=`` the
    pair's: the old route, launched on request only); for bf16 at D = 16
    and 32 with T <= 64 the small kernel (the wrapper's whole device work
    too), then the pair on request; past T = 64 the long kernel (its bound
    the largest of its exponentials, products and bytes; the wrapper's
    whole device work too), then the pair it replaced on request (its rows
    the pair's main rows, its whole device work on the dkv row); for fp32 at 64 and 128: the 3xTF32 pair
    and its pre-pass, then the FMA pair on request (its rows under
    ``old_variant``); elsewhere the pair of the dtype (bf16: the wrapper's
    whole device work, its delta pre-pass included, on the dkv row).
    ``plain_rows`` and ``full_check`` as in ``flash_fwd_row``."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        FLASH_BWD_BM, FP32_BWD_PLAN, MMA_SYNC_BWD_PLAN, SMALL_BWD_WARPGROUPS,
        flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq_plain, flash_attention_bwd_kernel, flash_attention_bwd_plain,
        flash_attention_fwd_kernel, flash_bwd_plan, flash_bwd_split, flash_bwd_split_plain,
        flash_delta, flash_delta_kernel, LONG_BWD_PLAN, long_bwd_groups,
        long_bwd_scratch_bytes, padded_head_dim)

    q, k, v = flash_inputs(b, t, h, d, device, seed=500, dtype=dtype)
    do = randn((b, t, h, d), 501, device, dtype)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)  # o at the padded head dim
    qf, kf, vf, of, dof = (z.float() for z in (q, k, v, o[..., :d], do))
    chunks = batch_chunks(b, plain_rows)

    def args(s):
        """The plain versions' inputs on batch rows ``s``."""
        return qf[s], kf[s], vf[s], of[s], lse[s], dof[s]

    library = sdpa_backward_ms(q, k, v, do)
    item = q.element_size()
    io = item * b * t * h * d  # one [B, T, H, D] tensor
    stats = 2 * 4 * b * h * t  # lse and delta, fp32
    tol = TOL_FLASH_BWD[dtype_name(dtype)]
    plan = flash_bwd_plan(b, h, t, t, d, dtype)
    rows = []

    def row(name, run, plain, flops, nbytes, row_tol=tol, row_library=None, row_variant=variant,
            plain_ms=None, **extra):
        """A kernel's row: ``run``'s outputs held against ``plain(s)``'s on
        every batch chunk ``s``, the plain version timed over them all
        (unless ``plain_ms`` is given)."""
        got = [g for g in run() if g is not None]
        errs = chunked_errors(got, plain, chunks, row_tol)
        if plain_ms is None:
            plain_ms = cuda_time_ms(lambda: [plain(s) for s in chunks], iters=3, warmup=1)
        r = {"kernel": name, "variant": row_variant, "b": b, "t": t, "h": h, "d": d,
             "dtype": dtype_name(dtype), "calls": calls, "per": per,
             **max(errs, key=lambda e: (not e["ok"], e["err_over_tol"])),
             **kernel_times(run, name), "host_ms": host_ms(run, calls=20), "plain_ms": plain_ms,
             "library": "scaled_dot_product_attention backward (dq, dk, dv together)",
             **(row_library or library), **dtype_bound(flops, nbytes, item), **extra}
        if plain_rows is not None:
            r["plain_ms_of"] = f"the plain version over the batch, {plain_rows} rows at a time"
        if full_check:
            r["bitwise_repeatable"] = bitwise_repeatable(run)
            r["ok"] = r["ok"] and r["bitwise_repeatable"]
        if not r["profiled_launches"]:
            r.update(ms=graph_ms(run, calls=10), ms_of="device time (a CUDA graph of the wrapper "
                     "replayed; the profiler recorded no launch)")
        r["tflops"] = flops / r["ms"] / 1e9
        rows.append(r)

    def pair_rows(prefix: str, pair_plan, row_variant, note=None) -> None:
        """The rows of a dkv/dq pair (``prefix``_dkv and _dq) at
        ``pair_plan`` (None: the backward's own plan)."""
        for which, needs, products, plain, n_out in (
                ("dkv", (False, True, True), 4, flash_attention_bwd_dkv_plain, 2),
                ("dq", (True, False, False), 3, flash_attention_bwd_dq_plain, 1)):
            # the kernel's own products of 2*T*T*D each; q, k, v, dO, lse,
            # delta read once, its gradients written once
            row(f"{prefix}_{which}",
                lambda needs=needs: flash_attention_bwd_kernel(q, k, v, o, lse, do, needs,
                                                               plan=pair_plan),
                lambda s, plain=plain, n_out=n_out: (plain(*args(s)) if n_out == 2
                                                     else (plain(*args(s)),)),
                products * 2.0 * b * h * t * t * d, 4 * io + stats + n_out * io,
                row_variant=row_variant, **({"route_note": note} if note else {}))

    if plan.route == "wgmma":
        # five products of 2*T*T*D; q, k, v, dO, lse, delta read once, dq,
        # dk, dv written once; the design also moves dQ's fp32 share of
        # every key tile to or from its accumulator
        key_tiles = -(-t // plan.bn)
        acc = ((key_tiles if key_tiles > 1 else 0) * 4 * b * h * -(-t // FLASH_BWD_BM)
               * FLASH_BWD_BM * d)
        row("flash_attention_bwd", lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do),
            lambda s: flash_attention_bwd_plain(*args(s)),
            5 * 2.0 * b * h * t * t * d, 4 * io + stats + 3 * io, plan=f"bn{plan.bn}",
            design_bytes=4 * io + stats + 3 * io + acc,
            design_bytes_ms=(4 * io + stats + 3 * io + acc) / MEM_RATE * 1e3)
        # its delta pre-pass: dO and O read once, delta written once; no one
        # PyTorch call computes it (flash_delta is five kernels)
        row("flash_attention_bwd_delta", lambda: (flash_delta_kernel(o, do),),
            lambda s: (flash_delta(of[s], dof[s]),), 2.0 * b * h * t * d, 2 * io + 4 * b * h * t,
            row_tol=TOL_DELTA,
            row_library={"library": "none: flash_delta (the plain version) is five kernels",
                         "library_ms": None},
            plain_ms=cuda_time_ms(lambda: flash_delta(o, do), iters=10))
        # like for like against SDPA's backward, which computes rowsum(dO O)
        # itself: the fused kernel with its pre-pass, and the wrapper's whole
        # device work a call (the counters' zeroing too) from a CUDA graph
        fused, pre_pass = rows[-2:]
        fused["ms_with_pre_pass"] = fused["ms"] + pre_pass["ms"]
        fused["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do), calls=10)
        pair_plan, pair_note = MMA_SYNC_BWD_PLAN, "the mma.sync pair on request (plan=mma_sync)"
        # the pair's own main rows are the ViT's (D = 16, the vit phase)
        variant = variant or f"the mma.sync pair on request at T={t}, D={d}, B*H={b * h}"
    elif plan.route == "small":
        # five products of 2*T*T*D; q, k, v, o, dO and lse read once (delta
        # is computed inside), dq, dk, dv written once
        row("flash_attention_bwd_small", lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do),
            lambda s: flash_attention_bwd_plain(*args(s)),
            5 * 2.0 * b * h * t * t * d, 5 * io + 4 * b * h * t + 3 * io,
            plan=f"one warpgroup a batch*head, {SMALL_BWD_WARPGROUPS} a block")
        # like for like against SDPA's backward: the wrapper's whole device
        # work a call, from a CUDA graph
        rows[-1]["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do), calls=10)
        pair_plan, pair_note = MMA_SYNC_BWD_PLAN, "the mma.sync pair on request (plan=mma_sync)"
        # the pair's own main rows are the ViT's at patch 4 (the vit phase)
        variant = variant or f"the mma.sync pair on request at T={t}, D={d}, B*H={b * h}"
    elif plan.route == "long":
        # three floors, the largest its bound: T^2 exponentials a batch*head
        # on the special-function unit (exp_bound_ms), five products of
        # 2*T*T*D on the tensor cores, and q, k, v, o, dO and lse read once,
        # dq, dk, dv written once (delta is computed inside); the design
        # also writes and reads back the blocks' fp32 dQ slots, at the
        # padded head dim: a slot set written by every chunk of keys but a
        # lone block's last, read by every chunk but a block's first, and
        # each block's read once more by the sum
        flops, nbytes = 5 * 2.0 * b * h * t * t * d, 5 * io + 4 * b * h * t + 3 * io
        exp_ms = exp_bound_ms(b, h, t, device)
        products_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / MEM_RATE * 1e3
        key_chunks, groups = -(-t // LONG_BWD_PLAN.bn), long_bwd_groups(b * h, t)
        slot_sets = 0 if key_chunks == 1 else (
            key_chunks - (groups == 1) + key_chunks - groups + (groups if groups > 1 else 0))
        dpad = padded_head_dim(d)
        acc = slot_sets * 4 * b * h * -(-t // 64) * 64 * dpad
        row("flash_attention_bwd_long", lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do),
            lambda s: flash_attention_bwd_plain(*args(s)), flops, nbytes,
            plan=(f"{groups} blocks a batch*head over its {key_chunks} chunks of "
                  f"{LONG_BWD_PLAN.bn} keys; scratch {long_bwd_scratch_bytes(b * h, t, t, dpad)} "
                  f"bytes at the padded head dim {dpad}"),
            design_bytes=nbytes + acc, design_bytes_ms=(nbytes + acc) / MEM_RATE * 1e3)
        long_row = rows[-1]
        long_row.update(
            bound_ms=max(exp_ms, products_ms, bytes_ms),
            bound_by="bytes" if bytes_ms > max(exp_ms, products_ms) else "operations",
            bound_of=("the largest of: T^2 exponentials a batch*head at "
                      f"{SFU_EX2_PER_CLOCK_SM} ex2 a clock an SM, the five products at the bf16 "
                      "peak, the bytes at 3.35 TB/s"),
            bound_exp_ms=exp_ms, bound_products_ms=products_ms, bound_bytes_ms=bytes_ms,
            sm_clock_mhz=sm_max_clock_hz() / 1e6, exponentials=b * h * t * t)
        # like for like against SDPA's backward: the wrapper's whole device
        # work a call (the counters' zeroing too), from a CUDA graph
        long_row["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do), calls=10)
        # the pair it replaced, on request, stays the pair's main row here;
        # its whole device work (delta pre-pass, dkv, dq) from a CUDA graph
        pair_rows("flash_attention_bwd", MMA_SYNC_BWD_PLAN, variant,
                  "the mma.sync pair on request (plan=mma_sync): the route this replaced")
        rows[-2]["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=MMA_SYNC_BWD_PLAN),
            calls=10)
        return rows
    elif plan.route == "tf32":
        # the 3xTF32 pair: each kernel's own products (dkv 4, dq 3) of
        # 2*T*T*D, three TF32 products each, on the wrapper's call (its
        # pre-pass and delta in call_ms)
        pair_rows("flash_attention_bwd_tf32", None, variant)
        # its pre-pass: q, dO, k, v read once, both terms of each written once
        qs_kvs = flash_bwd_split(q, do, k, v)
        want = flash_bwd_split_plain(q, do, k, v)
        split = {"kernel": "flash_attention_bwd_tf32_split", "variant": variant,
                 "dtype": "float32", "b": b, "t": t, "h": h, "d": d, "calls": calls, "per": per,
                 **exact_error(torch.cat([x.flatten() for x in qs_kvs]),
                               torch.cat([x.flatten() for x in want])),
                 **kernel_times(lambda: flash_bwd_split(q, do, k, v),
                                "flash_attention_bwd_tf32_split"),
                 "plain_ms": cuda_time_ms(lambda: flash_bwd_split_plain(q, do, k, v), iters=3,
                                          warmup=1),
                 "library": "none: no one PyTorch call rounds to TF32", "library_ms": None,
                 "bound_ms": 12 * io / MEM_RATE * 1e3, "bound_by": "bytes"}
        del qs_kvs, want
        rows.append(split)
        # like for like against SDPA's backward: the pair with its pre-pass,
        # and the wrapper's whole device work a call (delta too), from a
        # CUDA graph
        dkv, dq = rows[-3:-1]
        dkv["ms_with_pre_pass"] = dkv["ms"] + dq["ms"] + split["ms"]
        dkv["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do), calls=10)
        pair_plan, pair_note = FP32_BWD_PLAN, "the FMA pair on request (plan=fp32)"
        variant = old_variant
    else:
        pair_plan, pair_note = None, None
    pair_rows("flash_attention_bwd", pair_plan, variant, pair_note)
    if plan.route == "mma_sync":
        # like for like against SDPA's backward: the pair's whole device work
        # a call (its delta pre-pass too), from a CUDA graph, on its dkv row
        rows[-2]["wrapper_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do), calls=10)
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
    _, t, h, d = qs
    flash = (flash_bwd_rows(*qs, n, per, device, torch.bfloat16)
             + flash_bwd_rows(8, 4096, h, d, 1, per, device, torch.bfloat16,
                              variant="T=4096 (the 64^3 config's attention, batch 8), one call"))
    emit("timings_flash_bwd", rows=flash)
    return forward + dgrad + flash


def bench_rows(device) -> list:
    """Each K7-K9 kernel at the level-1 shape, on the inputs the variant
    entry times it on: held against its plain version (fp32, TF32 off),
    timed beside it (``ms``: its device time per call, summed over
    bigdot's passes; ``call_ms``: the wrapper call), beside one library call
    and its bound. K7's library call is ``F.conv3d`` on x with km as the
    conv's weights (nopatch and nodma compute other functions with the same
    FLOPs); K8's GEMM and K9 are held beside cuBLAS on [B*D*H*W, 27*Cin]
    x [27*Cin, Cout]: the whole patch matrix for K8, p tiled 9 times (the
    same function) for K9. K8's im2col is data movement, bound by its
    bytes, and has no library call; both of K8's rows carry the output hold
    of the pair, and the conv's own bound and the design's byte floor (the
    patch written and read back) beside their own bounds."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.benchmarks import conv3d_variants as cv
    from rho_diffusion_tpu_torch.ops.kernels import sm_count
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import igemm_plan
    from rho_diffusion_tpu_torch.ops.kernels.conv3d_variants import (
        VARIANTS, bigdot_plain, conv_variant_plain, dense_plan, dots_only_plain, im2col_plain)

    ins = cv.inputs(device)
    sms = sm_count(device.index or 0)
    x, km, p, km_tc = ins["x"], ins["km"], ins["p"], ins["km_tc"]
    xf, kmf, pf, km_tcf = x.float(), km.float(), p.float(), km_tc.float()
    b, d, h, w, cin = x.shape
    cout, k = km.shape[1], 27 * cin
    vox = b * d * h * w
    conv_flops = cv.conv_flops()
    conv_bound, _ = bound_ms(conv_flops, 0, PEAK_BF16)
    weight = km.view(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    per = f"one call at the level-1 shape [{b},{d},{h},{w},{cin}] -> {cout}"
    rows = []

    def row(name, variant, run, want, plain, library, library_ms, flops, nbytes, **extra):
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        r = {"kernel": name, "variant": variant, "dtype": "bfloat16", "calls": 1, "per": per,
             **conv_error(run().float(), want, TOL_CONV_BF16), **kernel_times(run, name),
             "plain_ms": cuda_time_ms(plain, iters=2, warmup=1), "library": library,
             "library_ms": library_ms, "bound_ms": bnd, "bound_by": by, **extra}
        r["tflops"] = flops / r["ms"] / 1e9 if flops else None
        rows.append(r)

    lib_conv_ms = cuda_time_ms(lambda: F.conv3d(x.movedim(-1, 1), weight, padding=1), iters=10)
    for v in VARIANTS:
        plain = functools.partial(conv_variant_plain, xf, kmf, v)
        x_bytes = 0 if v == "nodma" else x.numel()
        row(f"conv3d_variant_{v}", None, cv.kernel_call(v, ins), plain(), plain,
            "F.conv3d (cuDNN), the full conv", lib_conv_ms, conv_flops,
            2.0 * (x_bytes + km.numel() + vox * cout),
            plan=igemm_plan(tuple(x.shape), cout, sms=sms)._asdict())
    patch = torch.cat([im2col_plain(x, d0, 1) for d0 in range(d)]).to(torch.bfloat16)
    lib_gemm_ms = cuda_time_ms(lambda: patch @ km, iters=10)
    del patch
    patch_bytes = 2.0 * vox * k
    for td in (4, 1, 2, 8):
        variant = None if td == 4 else f"td={td}"
        run = cv.kernel_call(f"bigdot{td}", ins)
        want = bigdot_plain(xf, kmf, td)
        floor = {"conv_bound_ms": conv_bound,
                 "design_bytes_ms": (2 * patch_bytes + 2.0 * (x.numel() + km.numel()
                                                              + vox * cout)) / MEM_RATE * 1e3,
                 "td": td, "passes": d // td}
        row("conv3d_bigdot_im2col", variant, run, want,
            lambda td=td: [im2col_plain(xf, d0, td) for d0 in range(0, d, td)], None, None, 0,
            2.0 * x.numel() + patch_bytes, **floor)
        row("conv3d_bigdot_gemm", variant, run, want,
            functools.partial(bigdot_plain, xf, kmf, td),
            "torch.matmul (cuBLAS) [B*D*H*W, 27*Cin] x [27*Cin, Cout] on the whole patch",
            lib_gemm_ms, conv_flops, patch_bytes + 2.0 * (km.numel() + vox * cout), **floor,
            plan=dense_plan(td * h * w, b, cout, sms)._asdict())
    p9 = p.repeat(1, 9)
    dots_flops = 2.0 * p.shape[0] * p.shape[1] * 9 * km_tc.shape[1]
    row("conv3d_dotsonly", None, cv.kernel_call("dotsonly", ins),
        dots_only_plain(pf, km_tcf), functools.partial(dots_only_plain, pf, km_tcf),
        "torch.matmul (cuBLAS): p tiled 9 times [P, 9*CPAD] x km [9*CPAD, Cout]",
        cuda_time_ms(lambda: p9 @ km_tc, iters=10), dots_flops,
        2.0 * (p.numel() + km_tc.numel() + p.shape[0] * km_tc.shape[1]),
        plan=dense_plan(p.shape[0], 1, km_tc.shape[1], sms)._asdict())
    return rows


def k7_full_is_k5(device) -> dict:
    """K7 ``full`` against K5 on the variant entry's level-1 inputs: one
    block body under two kernel names on one plan, so the outputs must be
    equal and the times agree within the host's noise. Timed in turns K7,
    K5, K5, K7 (CUDA events, ms per call)."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks import conv3d_variants as cv
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d_kernel

    ins = cv.inputs(device)
    x, km = ins["x"], ins["km"]
    cin, cout = x.shape[-1], km.shape[1]
    weight = km.view(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    k7, k5 = cv.kernel_call("full", ins), lambda: conv3d_kernel(x, weight)
    times = {"k7": [], "k5": []}
    for name in ("k7", "k5", "k5", "k7"):
        times[name].append(cuda_time_ms(k7 if name == "k7" else k5, iters=10))
    equal = bool(torch.equal(k7(), k5()))
    if not equal:
        fail("bench_k7_full_is_k5: K7 full and K5 differ on the same inputs")
    return {"shape": list(x.shape), "cout": cout, "equal": equal, "k7_full_ms": times["k7"],
            "k5_ms": times["k5"], "k7_over_k5": min(times["k7"]) / min(times["k5"])}


def k5_tiles(device) -> list:
    """K5's tile study at the conv_profile level shapes (batch 32): its
    plan (4 stages), the same tile at 3 stages, and 128-channel N tiles at
    4 and 3 stages (A delivered once per 128 output channels instead of
    once per Cout up to 256). ms per call (CUDA events), each plan timed
    twice, in the order given and then reversed."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks.conv3d_ab import conv_flops, conv_inputs
    from rho_diffusion_tpu_torch.benchmarks.conv_profile import LEVEL_SHAPES
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d_kernel, igemm_plan

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for shape in LEVEL_SHAPES:
        x, weight, _ = conv_inputs(shape, device)
        cout = shape[-1]
        base = igemm_plan(x.shape, cout, sms=sms)
        plans = {"plan": base, "3 stages": base._replace(stages=3),
                 "bn 128": igemm_plan(x.shape, cout, bn_max=128, sms=sms),
                 "bn 128, 3 stages": igemm_plan(x.shape, cout, bn_max=128, stages=3, sms=sms)}
        times: dict = {name: [] for name in plans}
        for name in [*plans, *reversed(plans)]:
            times[name].append(cuda_time_ms(
                functools.partial(conv3d_kernel, x, weight, plan=plans[name]), iters=10))
        rows.append({"shape": list(shape), "plans": {
            name: {"plan": list(plans[name]), "ms": times[name],
                   "tflops": conv_flops(shape) / min(times[name]) / 1e9}
            for name in plans}})
        del x, weight
    return rows


def flash_plan_study(device) -> list:
    """The flash forward at K1's shape (T = 512, one of a batch-8 forward's
    six calls) and K2's (T = 4096, batch 8): every plan of the wgmma route
    and the earlier mma.sync kernel, on the same strided views of one qkv,
    each timed twice (the plans in order, then reversed): the device time
    per call (``graph_ms``: calls captured in a CUDA graph, so the host's
    work is out of it) and the wrapper call's time (CUDA events), beside
    the bound and the plan ``flash_plan`` picks."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        MMA_SYNC_PLAN, WGMMA_PLANS, flash_attention_fwd_kernel, flash_plan)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for b, t, h, d in ((8, 512, 4, 128), (8, 4096, 4, 128)):
        q, k, v = flash_inputs(b, t, h, d, device, seed=900 + t, dtype=torch.bfloat16)
        plans = {plan_name(p): p for p in (MMA_SYNC_PLAN, *WGMMA_PLANS)}
        times: dict = {name: {"ms": [], "call_ms": []} for name in plans}
        for name in [*plans, *reversed(plans)]:
            run = functools.partial(flash_attention_fwd_kernel, q, k, v, plan=plans[name])
            times[name]["ms"].append(graph_ms(run))
            times[name]["call_ms"].append(cuda_time_ms(run, iters=10))
        flops = 4.0 * b * h * t * t * d
        bnd, by = bound_ms(flops, 2 * 4.0 * b * t * h * d, PEAK_BF16)
        rows.append({"b": b, "t": t, "h": h, "d": d, "bound_ms": bnd, "bound_by": by,
                     "plan_chosen": plan_name(flash_plan(b, h, t, t, d, sms=sms)),
                     "plans": {name: {**times[name], "tflops": flops / min(times[name]["ms"]) / 1e9}
                               for name in plans}})
        del q, k, v
    return rows


def flash_bwd_plan_study(device) -> list:
    """The backward at the training step's attention (batch 32, T = 512) and
    the 64^3 config's (batch 8, T = 4096): the fused kernel at its plan (the
    head dim's only one) and the mma.sync pair, on the same strided views of
    one qkv and the kernel forward's output and LSE, each timed twice (in
    order, then reversed): the device time per call (``graph_ms``) and the
    wrapper call's time (CUDA events, delta included), beside the bound
    (five products)."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        MMA_SYNC_BWD_PLAN, flash_attention_bwd_kernel, flash_attention_fwd_kernel, flash_bwd_plan)

    rows = []
    for b, t, h, d in ((32, 512, 4, 128), (8, 4096, 4, 128)):
        q, k, v = flash_inputs(b, t, h, d, device, seed=950 + t, dtype=torch.bfloat16)
        do = randn((b, t, h, d), 951, device, torch.bfloat16)
        o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
        chosen = flash_bwd_plan(b, h, t, t, d)
        plans = {"mma_sync pair": MMA_SYNC_BWD_PLAN, f"fused bn{chosen.bn}": chosen}
        times: dict = {name: {"ms": [], "call_ms": []} for name in plans}
        for name in [*plans, *reversed(plans)]:
            run = functools.partial(flash_attention_bwd_kernel, q, k, v, o, lse, do,
                                    plan=plans[name])
            times[name]["ms"].append(graph_ms(run, calls=5))
            times[name]["call_ms"].append(cuda_time_ms(run, iters=10))
        flops = 5 * 2.0 * b * h * t * t * d
        bnd, by = bound_ms(flops, 2 * 7.0 * b * t * h * d + 8.0 * b * h * t, PEAK_BF16)
        rows.append({"b": b, "t": t, "h": h, "d": d, "bound_ms": bnd, "bound_by": by,
                     "plan_chosen": f"fused bn{chosen.bn}",
                     "plans": {name: {**times[name], "tflops": flops / min(times[name]["ms"]) / 1e9}
                               for name in plans}})
        del q, k, v, do, o, lse
    return rows


FP32_BATCH = 8  # the fp32 forward's batch: a sampling forward's
FP32_HOLD_BATCH = 2
# the whole fp32 model against the fp32 plain model on the same weights,
# inputs and noise: one forward (relative MSE) and the parameter gradients
# of one loss (relative L2 over all of them). fp32 FMA and 3xTF32 products
# differ from the plain fp32 sums by summation order and the split's dropped
# a_lo b_lo term (~2^-22 relative): ~1e-12 relative MSE, ~1e-6 relative L2.
# One TF32 product (10 mantissa bits, ~2^-11 relative a product) is ~1e-6
# and ~1e-3: the bars sit between, so a route that multiplied in 1xTF32
# fails them. The plain model with TF32 matmuls is printed beside as that
# control, and the bars must sit below it.
FP32_MODEL_BAR = {"forward": 1e-8, "train_gradients": 1e-4}
# the bench entry in fp32, fewer steps and windows than the bf16 runs:
# the train mode at TRAIN_BATCH (the next batch down if it does not fit in
# the card's memory) and a DDIM sample at batch 8
# the launches each fp32 bench run must make: the flash forward's 3xTF32
# fold and pre-pass (train and sample), the backward's pair and pre-pass
# (train)
FP32_FLASH_COUNTS = {
    "train": ("flash_attention_tf32", "flash_attention_tf32_split", "flash_attention_bwd_tf32_dkv",
              "flash_attention_bwd_tf32_dq", "flash_attention_bwd_tf32_split"),
    "sample": ("flash_attention_tf32", "flash_attention_tf32_split"),
}
FP32_BENCH_RUNS = (
    ("train", {"BENCH_MODE": "train", "BENCH_DTYPE": "float32", "BENCH_STEPS": "3",
               "BENCH_WARMUP": "1", "BENCH_WINDOWS": "1"}),
    ("sample", {"BENCH_MODE": "sample", "BENCH_DTYPE": "float32", "BENCH_DDIM_STEPS": "10"}),
)


@contextlib.contextmanager
def tf32_matmuls():
    """torch's matmuls in one TF32 product (10 mantissa bits) for the body."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def fp32_model_hold(device) -> dict:
    """The whole fp32 flagship model on the kernels against the fp32 plain
    model (every conv and attention call on its plain version) on the same
    weights, inputs and noise: one forward at FP32_HOLD_BATCH and the
    parameter gradients of one DDPM loss; beside it the plain model with
    TF32 matmuls (the 1xTF32 control), and the kernels each launched."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    pipe = build_pipeline(flagship_config(25), "float32", device)
    pipe.load_state_dict(random_state_dict(pipe.backbone, seed=0))
    x, t, y = unet_inputs(pipe.backbone, FP32_HOLD_BATCH, device, seed=21)
    batch = train_batch(FP32_HOLD_BATCH, len(pipe.schedule), device, seed=23)
    before = dict(launch_counts)
    with torch.no_grad():
        got = pipe.apply(x, t, y)
    grads = train_gradients(pipe, *batch)
    launched = {k: v - before.get(k, 0) for k, v in launch_counts.items() if v > before.get(k, 0)}
    with plain_backends():
        with torch.no_grad():
            want = pipe.apply(x, t, y)
        grads_plain = train_gradients(pipe, *batch)
        with tf32_matmuls():
            with torch.no_grad():
                control = pipe.apply(x, t, y)
            grads_tf32 = train_gradients(pipe, *batch)
    torch.cuda.synchronize()
    rows = {"forward": {"metric": "relative MSE", "kernels_vs_plain": rel_mse(got, want),
                        "tf32_plain_vs_plain": rel_mse(control, want)}}
    k, k_name, k_worst = grad_distance(grads, grads_plain)
    rows["train_gradients"] = {
        "metric": "relative L2 over all parameter gradients", "kernels_vs_plain": k,
        "tf32_plain_vs_plain": grad_distance(grads_tf32, grads_plain)[0],
        "worst_parameter_kernels": {"name": k_name, "rel_l2": k_worst},
        "finite": all(bool(torch.isfinite(g).all()) for g in grads.values())
        and set(grads) == set(grads_plain)}
    for what, row in rows.items():
        bar = FP32_MODEL_BAR[what]
        row.update(bar=bar, ok=row["kernels_vs_plain"] <= bar < row["tf32_plain_vs_plain"]
                   and row.get("finite", True))
    return {**rows, "batch": FP32_HOLD_BATCH, "kernel_launches": launched}


def split_total(rows: list, variant, per: str) -> dict:
    """The tf32 conv route's weight pre-pass summed over the convs of
    ``rows`` (each problem's ``weight_split`` times its calls), as one row
    of one call ``per``."""
    splits = [(r["weight_split"], r["calls"]) for r in rows if "weight_split" in r]
    total = {f: sum(w[f] * n for w, n in splits) for f in ("ms", "call_ms", "plain_ms", "bound_ms")}
    worst = max((w for w, _ in splits), key=lambda w: w["err_over_tol"])
    return {"kernel": "conv3d_weight_split", "variant": variant, "dtype": "float32", "calls": 1,
            "per": per, "convs": sum(n for _, n in splits), **total, "bound_by": "bytes",
            "ms_of": " / ".join(sorted({w["ms_of"] for w, _ in splits})),
            "library": worst["library"], "library_ms": None,
            **{f: worst[f] for f in ("max_abs_err", "max_abs_ref", "tol", "check",
                                     "err_over_tol")},
            "ok": all(w["ok"] for w, _ in splits)}


def fp32_ring_request() -> tuple[dict, dict]:
    """One request to the service on the fp32 flagship (``training.dtype``
    float32) under a context mesh of SERVE_CONTEXT ranks on the card, with
    ``RHO_RING_ATTN_IMPL=rdma``: its result and the launches of the build
    (bucket 1 warmed up) and the request."""
    import os
    import threading

    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import serve
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    cfg = flagship_config(25)
    cfg["training"]["dtype"] = "float32"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fp32_serve_"))
    impl_before = os.environ.get("RHO_RING_ATTN_IMPL")
    os.environ["RHO_RING_ATTN_IMPL"] = "rdma"
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        pth = tmp / "model.pth"
        torch.save(random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0), pth)
        launch_counts.clear()
        server, service = serve.build_server(serve_argv(cfg_path, pth, tmp, (1,), True),
                                             log=lambda *_: None)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            reply = http_call(server.server_address[1], "POST", "/generate",
                              {"conditions": serve_conditions(cfg, 1, 60).tolist(), "seed": 60})
            torch.cuda.synchronize()
            counts = dict(launch_counts)
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if impl_before is None:
            os.environ.pop("RHO_RING_ATTN_IMPL", None)
        else:
            os.environ["RHO_RING_ATTN_IMPL"] = impl_before
    arr = np.asarray(reply["samples"], np.float32)
    return ({"shape": reply["shape"], "bucket": reply["bucket"], "latency_s": reply["latency_s"],
             "finite": bool(np.isfinite(arr).all()), "std": float(arr.std())}, counts)


def phase_fp32(state: dict) -> None:
    """The flagship in fp32 (a model whose ``training.dtype`` is float32):
    every fp32 kernel body at the model's shapes against its plain version,
    timed beside its library call and bound; the whole fp32 model held
    against the plain one; and the path whose launches are counted: the
    bench entry with BENCH_DTYPE=float32 (the train mode, profiled by
    group, and a DDIM sample) and one request to the fp32 service under a
    context mesh (K6's fp32 route)."""
    import io

    import torch

    from rho_diffusion_tpu_torch import bench
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import FP32_PLAN

    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    unet = build_unet(flagship_config(25), "float32", device)
    conv = hold_convs(unet, FP32_BATCH, "forward", device, seed=1000, timed=True)
    dgrad = hold_convs(unet, TRAIN_BATCH, "dgrad", device, seed=1100, timed=True)
    attn_calls = forward_shapes(unet, FP32_BATCH, device)[1]
    del unet
    torch.cuda.empty_cache()
    for r in conv + dgrad:  # the tf32 kernels run fp32 only: their rows are their main ones
        r["variant"] = None if r["kernel"].endswith("_tf32") else "fp32"
    split = [split_total(conv, None, f"one UNet forward at batch {FP32_BATCH}: the weights of "
                                     "its tf32 convs"),
             split_total(dgrad, "dgrad", f"one training step at batch {TRAIN_BATCH}: the "
                                         "weights of its tf32 dgrad convs")]
    emit("fp32_conv", forward_batch=FP32_BATCH, dgrad_batch=TRAIN_BATCH, rows=conv + dgrad,
         weight_split=split)
    (qs, _), _, _ = attn_calls[0]
    _, t, h, d = qs
    n = len(attn_calls)
    per_fwd, per_step = (f"one UNet forward at batch {FP32_BATCH}",
                         f"one training step at batch {TRAIN_BATCH}")
    # the forward's 3xTF32 fold (fp32 only: its batch-8 rows are its main
    # ones), its K/V pre-pass, and the FMA kernel it replaced on request
    flash = []
    for batch, per, variant in ((FP32_BATCH, per_fwd, None),
                                (TRAIN_BATCH, per_step, f"batch {TRAIN_BATCH}")):
        flash += [flash_fwd_row(batch, t, h, d, n, per, device, torch.float32, variant=variant),
                  flash_fwd_split_row(batch, t, h, d, n, per, device, variant=variant),
                  flash_fwd_row(batch, t, h, d, n, per, device, torch.float32,
                                variant=f"fp32 FMA kernel on request (plan=fp32), batch {batch}",
                                plan=FP32_PLAN)]
    # the backward's 3xTF32 pair and its pre-pass (main at the training
    # step's batch), and the FMA pair it replaced on request
    flash_bwd = (flash_bwd_rows(TRAIN_BATCH, t, h, d, n, per_step, device, torch.float32,
                                old_variant="fp32 FMA pair on request (plan=fp32)")
                 + flash_bwd_rows(FP32_BATCH, t, h, d, n, per_fwd.replace("forward", "backward"),
                                  device, torch.float32, variant=f"batch {FP32_BATCH}",
                                  old_variant=f"fp32 FMA pair on request (plan=fp32), batch "
                                              f"{FP32_BATCH}"))
    ring = [ring_row(FP32_BATCH, t, h, d, SERVE_CONTEXT, n,
                     f"one UNet forward at batch {FP32_BATCH} under a context={SERVE_CONTEXT} "
                     "mesh", device, torch.float32)]
    ring += [ring[0].pop("pre_pass")] if "pre_pass" in ring[0] else []
    emit("fp32_attention", flash=flash, flash_bwd=flash_bwd, ring=ring)
    hold = fp32_model_hold(device)
    emit("fp32_hold", **hold)
    torch.cuda.empty_cache()

    # the bench entry in fp32 (the counted path), then one profiled step
    runs, launches = {}, {}
    for name, env in FP32_BENCH_RUNS:
        for batch in ((TRAIN_BATCH, TRAIN_BATCH // 2) if name == "train" else (None,)):
            env_b = {**env, **({"BENCH_BATCH": str(batch)} if batch else {})}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            captured, err = io.StringIO(), io.StringIO()
            try:
                with bench_env(env_b), contextlib.redirect_stdout(captured), \
                        contextlib.redirect_stderr(err):
                    result, wall, counts, fr = counted(lambda: bench.main(["-d", DEVICE]))
            except torch.cuda.OutOfMemoryError:
                runs[f"{name}_b{batch}"] = "out of memory: the next batch down follows"
                continue
            runs[name] = {"line": result, "entry_s": wall, "stderr": err.getvalue().strip(),
                          "env": env_b, "max_memory_allocated": torch.cuda.max_memory_allocated(),
                          "launches": counts, "flash_routes": fr}
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            break
    if "train" in runs:
        env_b = runs["train"]["env"]
        with bench_env(env_b):
            s = bench.settings()
        torch.cuda.empty_cache()
        pipe = bench.training_pipeline(s, device)
        ts = pipe.create_state(777)
        rng = torch.Generator().manual_seed(0)
        data = {"data": torch.rand((s["batch"], *(s["grid"],) * 3, 1), generator=rng).to(device),
                "labels": torch.rand((s["batch"], 4 * s["mc"]), generator=rng).to(device)}
        pipe.training_step(ts, data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.training_step(ts, data)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        runs["train"]["profiled_step"] = profiled_step(
            device_time_by_kernel(lambda: pipe.training_step(ts, data)), host_s)
        del pipe, ts, data
        torch.cuda.empty_cache()
    # one served fp32 request under the context mesh: K6's fp32 route
    served, counts = fp32_ring_request()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    state["fp32_launches"] = launches
    rows = conv + dgrad + split + flash + flash_bwd + ring
    record_errors(state, rows)
    state["fp32"] = rows
    emit("fp32", bench=runs, served_ring_request=served, launches=launches,
         seconds=time.perf_counter() - t0)
    problems = [f"fp32 model hold {what}: {row}" for what, row in hold.items()
                if isinstance(row, dict) and "ok" in row and not row["ok"]]
    if "train" not in runs or "sample" not in runs:
        problems.append(f"the fp32 bench runs did not all finish: {runs}")
    # each bench run on its own: the fp32 flash routes' counts (3xTF32)
    for name, kernels in FP32_FLASH_COUNTS.items():
        counts = runs.get(name, {}).get("launches", {}) if isinstance(runs.get(name), dict) else {}
        never = [k for k in kernels if not counts.get(k)]
        if never:
            problems.append(f"the fp32 bench {name} run never launched {never}; counts {counts}")
    if not served["finite"]:
        problems.append(f"the served fp32 ring request: {served}")
    missing = [name for name, _, _, path in KERNELS if path == "fp32" and not launches.get(name)]
    if missing:
        problems.append(f"the fp32 path never launched {missing}; counts {launches}")
    if problems:
        fail("fp32: " + "; ".join(problems))
    fail_bad("fp32", rows)


# the bench phase's forward under the study backend RHO_CONV3D_VIA_2D=1 (a
# child process: the variable is read at import): the flagship UNet at
# batch VIA_2D_BATCH, every 3x3x3 conv recorded and held against K5 (the
# strided Downsample against cuDNN, the port's path for it); TF32 off, as
# in this script
VIA_2D_BATCH = 2
VIA_2D_SEEDS = (11, 12)  # weights, inputs
VIA_2D_CHILD = r"""
import json, sys
import torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from rho_diffusion_tpu_torch.ops import convolution
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
calls = []
via = convolution.conv3d_via_2d
def record(x, w, b, stride=(1, 1, 1)):
    out = via(x, w, b, stride)
    calls.append((x, w, b, tuple(stride), out))
    return out
convolution.conv3d_via_2d = record
device = torch.device(sys.argv[6])
unet = cs.build_unet(cs.flagship_config(25), torch.bfloat16, device, seed=int(sys.argv[3]))
inputs = cs.unet_inputs(unet, int(sys.argv[4]), device, seed=int(sys.argv[5]))
launch_counts.clear()
with torch.no_grad():
    out = unet(*inputs).float().cpu()
counts = dict(launch_counts)
holds = []
with torch.no_grad():
    for x, w, b, stride, got in calls:
        if stride == (1, 1, 1):
            want = conv3d(x, w, b)
        else:
            want = F.conv3d(x.movedim(-1, 1), w, b, stride=stride, padding=1).movedim(1, -1)
        tol = cs.TOL_CONV_BF16 if x.dtype == torch.bfloat16 else cs.TOL_CONV_FP32
        # the decomposition rounds each depth tap's partial sum to the dtype
        # before adding them, so a result that cancels between taps carries
        # the partials' rounding: its error is bounded by tol against the
        # sum of |x| |w| over the taps, not against the result
        mag = via(x.float().abs(), w.float().abs(), None if b is None else b.float().abs(),
                  stride)
        err = (got.float() - want.float()).abs()
        holds.append({"x": list(x.shape), "cout": int(w.shape[0]), "stride": list(stride),
                      "dtype": str(x.dtype).replace("torch.", ""),
                      **cs.conv_error(got.float(), want.float(), tol),
                      "err_over_tol_of_abs_sum": float((err / (tol * (1 + mag))).max())})
torch.save(out, sys.argv[2])
print(json.dumps({"flag": convolution.CONV3D_VIA_2D, "counts": counts, "holds": holds}))
"""


def via_2d_forward(device) -> dict:
    """One flagship forward in a child process under RHO_CONV3D_VIA_2D=1:
    its launches (no conv3d_igemm or conv3d_direct may run), each of its
    3x3x3 convs held at the bf16 (fp32 for the head) conv tolerance against
    its taps' sum of |x| |w| (the rounded partials; how many also meet it
    against |want| is counted), and the whole forward against the K5 forward
    of this process on the same weights and inputs: its relative MSE at most
    HOLD_CAP["forward"] (the model hold's cap: bf16 differences of 47 convs
    add up past the one-conv tolerance, which is reported beside it)."""
    import os

    import torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_via_2d_") as tmp:
        out_path = Path(tmp) / "out.pt"
        env = dict(os.environ, RHO_CONV3D_VIA_2D="1")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", VIA_2D_CHILD, str(ROOT), str(out_path),
                            str(VIA_2D_SEEDS[0]), str(VIA_2D_BATCH), str(VIA_2D_SEEDS[1]),
                            str(device)],
                           env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"the RHO_CONV3D_VIA_2D=1 forward failed: {r.stderr[-3000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        via_out = torch.load(out_path)
    unet = build_unet(flagship_config(25), torch.bfloat16, device, seed=VIA_2D_SEEDS[0])
    with torch.no_grad():
        k5_out = unet(*unet_inputs(unet, VIA_2D_BATCH, device, seed=VIA_2D_SEEDS[1]))
    k5_out = k5_out.float().cpu()
    del unet
    torch.cuda.empty_cache()
    forward = conv_error(via_out, k5_out, TOL_CONV_BF16)
    out = {"child_wall_s": wall, "flag": child["flag"], "launches": child["counts"],
           "convs": len(child["holds"]), "strided_convs": sum(h["stride"] != [1, 1, 1]
                                                             for h in child["holds"]),
           "worst_conv": max(child["holds"], key=lambda h: h["err_over_tol_of_abs_sum"]),
           "convs_within_k5_conv_tol": sum(h["ok"] for h in child["holds"]),
           "forward_vs_k5": forward, "forward_rel_mse_vs_k5": rel_mse(via_out, k5_out),
           "forward_cap": HOLD_CAP["forward"]}
    out["ok"] = bool(child["flag"] and not child["counts"].get("conv3d_igemm")
                     and not child["counts"].get("conv3d_direct")
                     and child["counts"].get("flash_attention")
                     and all(h["err_over_tol_of_abs_sum"] <= 1 for h in child["holds"])
                     and out["strided_convs"] > 0
                     and out["forward_rel_mse_vs_k5"] <= HOLD_CAP["forward"])
    return out


def phase_bench(state: dict) -> None:
    """The bottleneck-isolation path: the variant entry's ``main`` with
    every variant (the counted run), then ``bench_rows``, then the
    conv3d_ab and conv_profile entries, the phrasing studies at level 1 and
    the forward under RHO_CONV3D_VIA_2D=1 (``via_2d_forward``)."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks import (
        conv3d_ab, conv_dimnum_sweep, conv_profile, conv_zfold)
    from rho_diffusion_tpu_torch.benchmarks import conv3d_variants as cv
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    device = torch.device(DEVICE)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch_counts.clear()
    torch.cuda.synchronize()
    variants = cv.main(["-d", DEVICE, *BENCH_VARIANTS])
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    state["bench_launches"] = counts
    emit("bench_variants", rows=variants, launches=counts)
    rows = bench_rows(device)
    emit("bench_kernels", rows=rows)
    emit("bench_k7_full_is_k5", **k7_full_is_k5(device))
    emit("bench_k5_tiles", rows=k5_tiles(device))
    emit("bench_flash_plans", rows=flash_plan_study(device))
    emit("bench_flash_bwd_plans", rows=flash_bwd_plan_study(device))
    t1 = time.perf_counter()
    emit("bench_conv3d_ab", rows=conv3d_ab.main(["-d", DEVICE]))
    t2 = time.perf_counter()
    emit("bench_conv_profile", **conv_profile.main(["-d", DEVICE]))
    t3 = time.perf_counter()
    emit("bench_conv_zfold", rows=conv_zfold.main(["-d", DEVICE, "1"]))
    emit("bench_conv_dimnum_sweep", rows=conv_dimnum_sweep.main(["-d", DEVICE, "1"]))
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    via = via_2d_forward(device)
    emit("bench_via_2d", **via)
    record_errors(state, rows)
    state["bench"] = rows
    emit("bench", seconds=time.perf_counter() - t0, variants_and_holds_s=t1 - t0,
         conv3d_ab_s=t2 - t1, conv_profile_s=t3 - t2, phrasing_studies_s=t4 - t3,
         via_2d_s=time.perf_counter() - t4)
    if not via["ok"]:
        fail(f"the RHO_CONV3D_VIA_2D=1 forward: {via}")
    missing = [name for name, _, _, path in KERNELS if path == "bench" and not counts.get(name)]
    if missing:
        fail(f"bench path never launched {missing}; counts {counts}")
    fail_bad("bench", rows)


# ---------------------------------------------------------------------------
# The data phase: the 2-D and 1-D configs, and the device-resident cache
# ---------------------------------------------------------------------------

# the synthetic stand-in corpora the data phase trains on: the writers'
# defaults (python -m rho_diffusion_tpu_torch.data.galaxy_synth / spectro_synth)
GALAXY_CORPUS = {"s_values": (0.25, 0.5, 1.0), "m_values": (1.0,), "cameras": (0,), "size": 512}
SPECTRA_CORPUS = {"n_molecules": 64, "seed": 0}
# the data phase: at least DATA_TRAIN_STEPS training steps (whole epochs) of
# each config, its samples on DATA_SAMPLE_STEPS steps (the fewest whose
# 1000/T-scaled linear betas stay below 1), the forward hold's batch, and
# the quality config's epochs (one: 31 steps of its 1000 fields at batch 32)
DATA_TRAIN_STEPS = 6
DATA_SAMPLE_STEPS = 21
DATA_HOLD_BATCH = 2
QUALITY_EPOCHS = 1
# the bench entry's realdata mode without and with the device cache, in turns
REALDATA_RUNS = (("host", {"BENCH_MODE": "realdata"}),
                 ("device_cache", {"BENCH_MODE": "realdata", "BENCH_DEVICE_CACHE": "1"}))
# the timed steps of the two profiled runs of each realdata mode
REALDATA_PROFILE_STEPS = (5, 15)
DATA_CUTS = {
    "training.max_epochs": f"-> whole epochs to at least {DATA_TRAIN_STEPS} steps "
                           "(Trainer.fit(max_epochs=N))",
    "training.log_every_n_steps, benchmark_mode, loggers": "-> 1, true, jsonl (every "
                                                            "step's host time logged)",
    "noise_schedule.kwargs.num_steps (sampling only)": f"-> {DATA_SAMPLE_STEPS} (the fewest "
                                                        "steps whose 1000/T-scaled betas stay "
                                                        "below 1; random weights)",
    "inference.cache_file, plot_output_file, checkpoint": "-> none (weights through -p)",
}
DATA_CORPUS_NOTE = {
    "deep_galaxy": "the DeepGalaxy corpus is not redistributable: the galaxy_synth stand-in "
                   "with its defaults (s 0.25, 0.5, 1; m 1; camera 0; t 300..650 by 5; "
                   "512^2 frames), 75 frames inside the config's t_lim",
    "spectroscopy": "the molecular corpus is not redistributable: the spectro_synth stand-in "
                    "with its defaults (64 rigid rotors, seed 0)",
}


def data_dataset(key: str, cfg: dict, route: str, work: Path):
    """The config's dataset on this host's route: the class the config
    names on a file the port's writer wrote (``hdf5``, its path put into
    ``cfg``), or the in-memory items (``memory``)."""
    from rho_diffusion_tpu_torch.benchmarks._corpus import GalaxyFrames, RotorSpectra
    from rho_diffusion_tpu_torch.data.galaxy_synth import write_deep_galaxy_h5
    from rho_diffusion_tpu_torch.data.spectro_synth import write_rotor_spectra_h5
    from rho_diffusion_tpu_torch.registry import registry

    kwargs = cfg["dataset"]["kwargs"]
    if route == "memory":
        return (GalaxyFrames(kwargs, **GALAXY_CORPUS) if key == "deep_galaxy"
                else RotorSpectra(kwargs, **SPECTRA_CORPUS))
    work.mkdir(parents=True, exist_ok=True)
    if key == "deep_galaxy":
        kwargs["path"] = write_deep_galaxy_h5(str(work / "galaxies.h5"), **GALAXY_CORPUS)
    else:
        kwargs["h5_path"] = write_rotor_spectra_h5(str(work / "spectra.h5"), **SPECTRA_CORPUS)
    return registry.get("datasets", cfg["dataset"]["name"])(**kwargs)


def data_pipeline(cfg: dict, dataset, dtype: str, device):
    """A config's pipeline as its trainer builds it, in ``dtype``."""
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config

    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    config.model.kwargs["dtype"] = dtype
    return build_pipeline_from_config(config, dataset=dataset, device=device)


def trained_records(work: Path) -> dict:
    """Losses, gradient norms and host step times the trainer logged."""
    import numpy as np

    records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "train_loss" in r]
    step_s = [r["step_s"] for r in steps]
    after_first = step_s[1:]
    return {"steps": len(steps), "losses": [r["train_loss"] for r in steps],
            "grad_norms": [r.get("grad_norm") for r in steps], "step_s": step_s,
            "median_step_s_after_first": float(np.median(after_first)) if after_first else None}


def flash_counts_ok(counts: dict, per_step: int, steps: int, training: bool) -> bool:
    """K1 launched ``per_step`` times a step (a forward), and in training
    the fused backward and its pre-pass once per forward launch, never the
    dkv/dq pair."""
    fwd = counts.get("flash_attention", 0)
    if fwd != per_step * steps:
        return False
    if not training:
        return not counts.get("flash_attention_bwd")
    return (counts.get("flash_attention_bwd") == counts.get("flash_attention_bwd_delta") == fwd
            and not counts.get("flash_attention_bwd_dkv") and not counts.get("flash_attention_bwd_dq"))


def run_data_config(key: str, cfg_file: Path, route: str, work: Path, device) -> dict:
    """One shipped config at full width: a training run through Trainer
    (seeded random weights through ``init_state(weights_path=...)``), its
    host's batch build, one profiled step; a DDPM sample through the
    inference CLI from the trained weights, timed and profiled once more;
    the forward held against the fp32 plain model; the attention shapes of
    a training forward."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.loader import to_device
    from rho_diffusion_tpu_torch.ops import attention as attn_mod
    from rho_diffusion_tpu_torch.training.trainer import Trainer

    cfg = json.loads(cfg_file.read_text())
    dataset = data_dataset(key, cfg, route, work)
    cfg["training"].update(log_every_n_steps=1, benchmark_mode=True, loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    sd = random_state_dict(data_pipeline(cfg, dataset, "float32", "cpu").backbone, seed=0)
    pth = work / "random.pth"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(sd, pth)
    run_dir = work / "run"
    trainer = Trainer(config, dataset=dataset, work_dir=run_dir, device=DEVICE)
    steps_per_epoch = len(trainer.loader)
    epochs = -(-DATA_TRAIN_STEPS // steps_per_epoch)
    state0 = trainer.init_state(resume=False, weights_path=str(pth))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, train_wall, train_counts, train_routes = counted(
        lambda: trainer.fit(state0, max_epochs=epochs))
    train_peak = torch.cuda.max_memory_allocated()
    logged = trained_records(run_dir)
    changed = sum(not torch.equal(v.detach().cpu(), sd[k]) for k, v in st.model.state_dict().items())

    # the host's work for one batch (the loader's threads and collate), and
    # one step on a batch already on the card: its host time and profile
    t0 = time.perf_counter()
    host_batch = next(iter(trainer.loader.iter_batches()))
    host_batch_s = time.perf_counter() - t0
    batch = to_device(host_batch, device)
    pipe = trainer.pipeline
    with CallRecorder(attn_mod, "flash_attention") as attn_rec:
        pipe.training_step(st, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe.training_step(st, batch)
    torch.cuda.synchronize()
    one_step_s = time.perf_counter() - t1
    profiled = profiled_step(device_time_by_kernel(lambda: pipe.training_step(st, batch)),
                             one_step_s)
    median = logged["median_step_s_after_first"]
    loop_busy = (profiled["busy_ms"] / 1e3 / median
                 if median and "busy_ms" in profiled else NOT_PROFILED["status"])
    attn_shapes = sorted({c[0][0] for c in attn_rec.calls})
    per_step = len(attn_rec.calls)
    del trainer, pipe, st, state0, batch
    torch.cuda.empty_cache()

    # sampling through the inference CLI, from the trained raw weights
    s_cfg = json.loads(json.dumps(cfg))
    s_cfg["noise_schedule"]["kwargs"]["num_steps"] = DATA_SAMPLE_STEPS
    s_path = work / "sample_config.json"
    s_path.write_text(json.dumps(s_cfg))
    space = s_cfg["inference"].get("parameter_space")
    n = math.prod(len(v) for v in space.values()) if space else s_cfg["inference"].get(
        "num_samples", 16)
    trained = run_dir / "model.pth"
    torch.cuda.reset_peak_memory_stats()
    out, sample_wall, sample_counts, sample_routes = counted(lambda: inference.main(
        [str(s_path), "-p", str(trained), "-n", str(n), "-d", DEVICE, "-f",
         "--work-dir", str(work)]))
    sample_peak = torch.cuda.max_memory_allocated()
    s_config = ExperimentConfig.from_json(s_path)
    pipe, _, messages = inference.build_inference_session(s_config, checkpoint=trained,
                                                          device=device)

    def sample():
        return pipe.generate(torch.Generator(device=device).manual_seed(0), batch_size=n,
                             parameter_space=space, random=False)

    sample()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sample()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t2
    by_name = device_time_by_kernel(sample)
    sample_busy_s = sum(ms for ms, _ in by_name.values()) / 1e3
    del pipe
    torch.cuda.empty_cache()

    # the forward on the kernels against the fp32 plain model
    fast = data_pipeline(cfg, dataset, "bfloat16", device)
    fast.load_state_dict(sd)
    ref = data_pipeline(cfg, dataset, "float32", device)
    ref.load_state_dict(sd)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(fast.sample_shape(DATA_HOLD_BATCH), generator=gen).clamp(-1, 1).to(device)
    t = torch.randint(0, len(fast.schedule), (DATA_HOLD_BATCH,), generator=gen).to(device)
    y = fast.conditions_from_parameter_space(space, DATA_HOLD_BATCH, random=False)
    y = y.float() if y is not None else None
    with torch.no_grad():
        got = fast.apply(x, t, y)
        with plain_backends():
            plain_bf16, plain_fp32 = fast.apply(x, t, y), ref.apply(x, t, y)
    hold = {**hold_rows({"forward": got}, {"forward": plain_bf16}, {"forward": plain_fp32},
                        HOLD_CAP)["forward"], "batch": DATA_HOLD_BATCH}
    del fast, ref, got, plain_bf16, plain_fp32
    torch.cuda.empty_cache()

    want_shape = (n, *cfg["model"]["kwargs"]["data_shape"], cfg["model"]["kwargs"]["in_channels"])
    finite = bool(np.isfinite(out).all())
    problems = []
    if logged["steps"] != epochs * steps_per_epoch or not all(
            np.isfinite(logged["losses"] + logged["grad_norms"])):
        problems.append(f"training logged {logged}")
    if not changed:
        problems.append("no parameter changed")
    if not flash_counts_ok(train_counts, per_step, logged["steps"], training=True):
        problems.append(f"training launches {train_counts}, {per_step} attention calls a step")
    if not flash_counts_ok(sample_counts, per_step, DATA_SAMPLE_STEPS - 1, training=False):
        problems.append(f"sampling launches {sample_counts}, {per_step} attention calls a "
                        "forward")
    if tuple(out.shape) != want_shape or not finite:
        problems.append(f"the sample is {out.shape}, finite={finite}; expected {want_shape}")
    if not hold["ok"]:
        problems.append(f"forward hold {hold}")
    return {
        "config": cfg_file.name, "route": route, "corpus": DATA_CORPUS_NOTE[key],
        "items": len(dataset), "batch": cfg["training"]["batch_size"],
        "steps_per_epoch": steps_per_epoch, "epochs": epochs,
        "attention_shapes_b_t_h_d": attn_shapes, "attention_calls_per_forward": per_step,
        "train": {**logged, "wall_s": train_wall,
                  "steps_per_s": 1 / logged["median_step_s_after_first"]
                  if logged["median_step_s_after_first"] else None,
                  "max_memory_allocated": train_peak, "params_changed": changed,
                  "launches": train_counts, "flash_routes": train_routes,
                  "host_batch_build_s": host_batch_s, "profiled_step": profiled,
                  "device_busy_share_of_logged_step": loop_busy},
        "sample": {"n": n, "steps": DATA_SAMPLE_STEPS, "forwards": DATA_SAMPLE_STEPS - 1,
                   "cli_wall_s": sample_wall, "sample_s": sample_s,
                   "device_busy_s": sample_busy_s if by_name else None,
                   "device_busy_share": sample_busy_s / sample_s if by_name
                   else NOT_PROFILED["status"],
                   "max_memory_allocated": sample_peak, "launches": sample_counts,
                   "flash_routes": sample_routes, "messages": messages,
                   "shape": list(out.shape), "finite": finite,
                   "mean": float(out.mean()), "std": float(out.std())},
        "hold_forward": hold, "problems": problems,
    }


def run_quality_cache(work: Path, device) -> dict:
    """``config_spherical_harmonics_quality.json`` (the flagship model with
    cond_dropout 0.1 and min-SNR weighting) trained through Trainer with its
    ``training.device_cache: true``: the dataset uploaded once, every batch
    a gather on the card; one more step profiled on a cached batch."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.training.trainer import Trainer

    cfg = json.loads(QUALITY_CONFIG.read_text())
    cfg["training"].update(log_every_n_steps=1, benchmark_mode=True, loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    work.mkdir(parents=True, exist_ok=True)
    sd = random_state_dict(build_pipeline(cfg, "float32", "cpu").backbone, seed=0)
    pth = work / "random.pth"
    torch.save(sd, pth)
    trainer = Trainer(config, work_dir=work / "run", device=DEVICE)
    steps_per_epoch = len(trainer.loader)
    state0 = trainer.init_state(resume=False, weights_path=str(pth))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, wall, counts, routes = counted(lambda: trainer.fit(state0, max_epochs=QUALITY_EPOCHS))
    peak = torch.cuda.max_memory_allocated()
    logged = trained_records(work / "run")
    cache = trainer.device_cache
    batch = cache.batch(np.arange(config.training.batch_size))
    pipe = trainer.pipeline
    pipe.training_step(st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.training_step(st, batch)
    torch.cuda.synchronize()
    one_step_s = time.perf_counter() - t0
    profiled = profiled_step(device_time_by_kernel(lambda: pipe.training_step(st, batch)),
                             one_step_s)
    median = logged["median_step_s_after_first"]
    out = {"config": QUALITY_CONFIG.name, "items": len(trainer.dataset),
           "batch": config.training.batch_size, "epochs": QUALITY_EPOCHS,
           "steps_per_epoch": steps_per_epoch,
           "cache_nbytes": cache.nbytes,
           "cache_tables": {k: [list(t.shape), str(t.dtype), str(t.device)]
                            for k, t in cache._tables.items()},
           **logged, "wall_s": wall, "steps_per_s": 1 / median if median else None,
           "max_memory_allocated": peak, "launches": counts, "flash_routes": routes,
           "profiled_step": profiled,
           "device_busy_share_of_logged_step": (profiled["busy_ms"] / 1e3 / median
                                                if median and "busy_ms" in profiled
                                                else NOT_PROFILED["status"])}
    del trainer, pipe, st, state0, batch, cache
    torch.cuda.empty_cache()
    problems = []
    if logged["steps"] != QUALITY_EPOCHS * steps_per_epoch or not all(
            np.isfinite(logged["losses"])):
        problems.append(f"training logged {logged}")
    missing = [k for k in ("conv3d_igemm", "conv3d_dgrad_igemm", "flash_attention",
                           "flash_attention_bwd") if not counts.get(k)]
    per_step = counts.get("flash_attention", 0) // max(logged["steps"], 1)
    if missing or not flash_counts_ok(counts, per_step, logged["steps"], training=True):
        problems.append(f"the cached training path's launches {counts}")
    out["problems"] = problems
    return out


def realdata_bench(device) -> dict:
    """The bench entry in realdata mode without and with
    BENCH_DEVICE_CACHE=1, in turns (host, cache, cache, host), each run's
    steps/s and launches; then each mode profiled at REALDATA_PROFILE_STEPS
    timed steps: the difference of two runs' device time over the
    difference of their steps is the device time of a steady step (the
    warm-up, the pipeline's build and the dataset's materialisation cancel),
    whose product with the unprofiled steps/s is the device's busy share of
    a timed step."""
    import io
    import re

    import torch

    from rho_diffusion_tpu_torch import bench

    def run_bench(env: dict, profile: bool):
        captured, err = io.StringIO(), io.StringIO()
        torch.cuda.empty_cache()
        with bench_env(env), contextlib.redirect_stdout(captured), \
                contextlib.redirect_stderr(err):
            if profile:
                return device_time_by_kernel(lambda: bench.main(["-d", DEVICE]))
            result, wall, counts, _ = counted(lambda: bench.main(["-d", DEVICE]))
        lines = captured.getvalue().splitlines()
        if lines != [json.dumps(result)]:
            fail(f"data: the bench entry printed {lines}")
        return {"line": result, "entry_s": wall, "launches": counts,
                "stderr": err.getvalue().strip()}

    runs = {name: [] for name, _ in REALDATA_RUNS}
    for name, env in REALDATA_RUNS + REALDATA_RUNS[::-1]:
        runs[name].append(run_bench(env, False))
    out = {}
    for name, env in REALDATA_RUNS:
        device_ms = [sum(ms for ms, _ in run_bench({**env, "BENCH_STEPS": str(n)}, True).values())
                     for n in REALDATA_PROFILE_STEPS]
        lo, hi = REALDATA_PROFILE_STEPS
        per_step_ms = (device_ms[1] - device_ms[0]) / (hi - lo) if all(device_ms) else None
        values = [r["line"]["value"] for r in runs[name]]
        found = re.search(r"device_cache_bytes=(\d+)", runs[name][0]["stderr"])
        out[name] = {"steps_per_s": values, "metric": runs[name][0]["line"]["metric"],
                     "device_cache_bytes": int(found.group(1)) if found else None,
                     "profiled_device_ms": dict(zip(map(str, REALDATA_PROFILE_STEPS), device_ms)),
                     "device_ms_per_step": per_step_ms,
                     "device_busy_share": ([per_step_ms * v / 1e3 for v in values]
                                           if per_step_ms else NOT_PROFILED["status"]),
                     "launches": runs[name][0]["launches"],
                     "stderr": [r["stderr"] for r in runs[name]]}
    return out


def data_kernel_rows(shapes: dict, device) -> list:
    """K1 and the fused K3/K4 (with its delta pre-pass, and the mma.sync
    pair it replaced on request) at each config's attention shape, held
    against the plain versions and timed beside SDPA and the bound, per
    training step."""
    import torch

    rows = []
    for key, ((b, t, h, d), calls, batch) in shapes.items():
        per = f"one training step of {key} at batch {batch} ({calls} attention calls)"
        variant = f"{key}: T={t}, D={d}, B*H={b * h}, one training step"
        rows.append(flash_fwd_row(b, t, h, d, calls, per, device, torch.bfloat16,
                                  variant=variant))
        rows += flash_bwd_rows(b, t, h, d, calls, per, device, torch.bfloat16, variant=variant)
    return rows


def phase_data(state: dict) -> None:
    """The data layer's paths on the card at full width: DeepGalaxy (2-D)
    and Spectroscopy (1-D) trained and sampled (``run_data_config``) on
    the port's datasets over files its writers wrote where the host has
    h5py, else on the same items built in memory (``GalaxyFrames``,
    ``RotorSpectra``); the quality config trained under the device cache;
    the bench entry's realdata mode without and with the cache; K1 and the
    fused K3/K4 held and timed at the 2-D and 1-D attention shapes. Each
    path's launch counts are cleared just before it and read just after."""
    import importlib.util

    import torch

    from rho_diffusion_tpu_torch.native import get_ylm_lib, library_path

    device = torch.device(DEVICE)
    route = "hdf5" if importlib.util.find_spec("h5py") is not None else "memory"
    t0 = time.perf_counter()
    native = get_ylm_lib() is not None
    emit("data_route", route=route, h5py=route == "hdf5",
         native_ylm={"built": native, "seconds": time.perf_counter() - t0,
                     "library": str(library_path().relative_to(ROOT)) if native else None})
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    launches, problems, seconds, shapes = {}, [], {}, {}
    try:
        for key, cfg_file in (("deep_galaxy", DEEP_GALAXY_CONFIG),
                              ("spectroscopy", SPECTRO_CONFIG)):
            t1 = time.perf_counter()
            run = run_data_config(key, cfg_file, route, tmp / key, device)
            seconds[key] = time.perf_counter() - t1
            emit(f"data_{key}", **run, cuts=DATA_CUTS, seconds=seconds[key])
            launches[f"{key}_training"] = run["train"]["launches"]
            launches[f"{key}_sampling"] = run["sample"]["launches"]
            problems += [f"{key}: {p}" for p in run["problems"]]
            (shape,) = run["attention_shapes_b_t_h_d"]
            shapes[key] = (shape, run["attention_calls_per_forward"], run["batch"])
        t1 = time.perf_counter()
        quality = run_quality_cache(tmp / "quality", device)
        seconds["quality"] = time.perf_counter() - t1
        emit("data_quality_device_cache", **quality, cuts={
            "training.max_epochs": f"1000 -> {QUALITY_EPOCHS}",
            **{k: v for k, v in DATA_CUTS.items() if k.startswith("training.log")}},
            seconds=seconds["quality"])
        launches["quality_training_device_cache"] = quality["launches"]
        problems += [f"quality: {p}" for p in quality["problems"]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    realdata = realdata_bench(device)
    seconds["realdata_bench"] = time.perf_counter() - t1
    emit("data_realdata_bench", **realdata, seconds=seconds["realdata_bench"])
    for name, run in realdata.items():
        launches[f"bench_realdata_{name}"] = run["launches"]
    t1 = time.perf_counter()
    rows = data_kernel_rows(shapes, device)
    seconds["kernel_rows"] = time.perf_counter() - t1
    emit("data_kernels", rows=rows)
    record_errors(state, rows)
    state["data"] = rows
    state["data_launches"] = launches
    emit("data", seconds=seconds, launches=launches)
    if problems:
        fail("data: " + "; ".join(problems))
    fail_bad("data", rows)



# name, source in csrc/, the TPU kernel it replaces, and the path that runs it
# the load phase: the serving load harness (benchmarks/serve_bench.py) at its
# defaults, serving seeded random weights (the harness's own seeded init
# zeroes the heads, so the UNet would output zeros and a hold of the served
# row would hold nothing), and the seed of the held request
LOAD_HOLD_SEED = 3
# the kernels of the sampling path, and of the training path besides
SAMPLING_KERNELS = ("conv3d_igemm", "conv3d_direct", "flash_attention")
TRAINING_KERNELS = SAMPLING_KERNELS + ("conv3d_dgrad_igemm", "conv3d_dgrad_direct",
                                       "flash_attention_bwd", "flash_attention_bwd_delta")


def phase_load(state: dict) -> None:
    """The serving load harness: ``benchmarks.serve_bench``'s service (32^3
    UNetv2 at full width, bf16, DDIM-50, buckets (1, 8)) over seeded random
    weights, its latency phase (8 requests, one at a time) and its load
    phase (32 concurrent one-sample requests) with the device's busy share;
    then one served row held against the fp32 plain model (the same row
    keys) by ``hold_rows``."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch.benchmarks import serve_bench
    from rho_diffusion_tpu_torch.diffusion.sampling_rng import per_sample_keys
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_routes

    device = torch.device(DEVICE)
    with bench_env({}, prefix="SERVE_"):
        s = serve_bench.settings()
    sd = random_state_dict(serve_bench.pipeline(s, "cpu").backbone, seed=0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    service = serve_bench.build_service(s, device, params=sd)
    build_s = time.perf_counter() - t0
    conds1 = np.zeros((1, 4 * s["mc"]), np.float32)
    try:
        launch_counts.clear()
        flash_routes.clear()
        measured, busy = serve_bench.measure(service, s, device)
        counts, routes = dict(launch_counts), dict(flash_routes)
        served = service.generate(conds1, seed=LOAD_HOLD_SEED)
    finally:
        service.close()
    del service
    torch.cuda.empty_cache()
    plain = {}
    with plain_backends():
        for dt in ("bfloat16", "float32"):
            pipe = serve_bench.pipeline(s, device, dtype=dt)
            pipe.load_state_dict(sd)
            plain[dt] = {"sample": pipe.reverse_process(
                pipe.sample_shape(1), torch.from_numpy(conds1).to(device), sampler=s["sampler"],
                num_steps=s["steps"], row_keys=per_sample_keys(LOAD_HOLD_SEED, 1)).float().cpu()}
            del pipe
    hold = {**hold_rows({"sample": torch.from_numpy(served.samples)}, plain["bfloat16"],
                        plain["float32"], HOLD_CAP)["sample"],
            "request": {"n": 1, "seed": LOAD_HOLD_SEED, "bucket": served.bucket}}
    state["load_launches"] = counts
    emit("load", workload=measured["workload"], buckets=s["buckets"], steps=s["steps"],
         build_and_warmup_s=build_s, result=measured, device_busy_share_of_load_phase=busy,
         p50_latency_s=measured["single_request_latency_p50_s"],
         volumes_per_s=measured["throughput_volumes_per_s"],
         mean_occupancy=measured["mean_batch_occupancy"],
         load_phase_launches=measured["load_phase_launches"], launches=counts,
         flash_routes=routes, hold=hold)
    problems = []
    if not measured["all_finite"] or not 0 < measured["mean_batch_occupancy"] <= 1:
        problems.append(f"served samples or occupancy: {measured}")
    if measured["load_phase_launches"] < math.ceil(s["n_load"] / max(s["buckets"])):
        problems.append(f"{measured['load_phase_launches']} launches for {s['n_load']} requests")
    missing = [k for k in SAMPLING_KERNELS if not counts.get(k)]
    if missing:
        problems.append(f"the served path never launched {missing}; counts {counts}")
    if not hold["ok"]:
        problems.append(f"served row hold: {hold}")
    if problems:
        fail("load: " + "; ".join(problems))


# the utils phase: 64^3 training through the bench entry (recomputed at batch
# 8, and at batch 4 both ways), the remat hold's batch, and the optimizers'
# base learning rates (each moves the parameters visibly in three steps: LARS's
# trust ratio scales its step by 1e-3) and bar: the relative L2 distance of the
# card's parameter displacement from the CPU's
TRAIN64_RUNS = (
    ("remat_b8", {"BENCH_GRID": "64", "BENCH_BATCH": "8", "BENCH_REMAT": "1"}),
    ("remat_b4", {"BENCH_GRID": "64", "BENCH_BATCH": "4", "BENCH_REMAT": "1"}),
    ("plain_b4", {"BENCH_GRID": "64", "BENCH_BATCH": "4"}),
)
TRAIN64_TIMING = {"BENCH_STEPS": "5", "BENCH_WINDOWS": "2", "BENCH_WARMUP": "2"}
REMAT_HOLD_BATCH = 2
REMAT_HOLD_GRID = 64
OPTIMIZER_LR = {"Adamax": 1e-3, "NAdam": 1e-3, "RAdam": 1e-3, "RMSprop": 1e-3, "Adagrad": 1e-2,
                "Adadelta": 1.0, "Adafactor": 1e-2, "Lion": 1e-3, "LAMB": 1e-3, "LARS": 1.0}
OPTIMIZER_STEPS = 3
OPTIMIZER_BAR = 1e-3
PROFILE_STEPS = 2


def remat_hold(device) -> dict:
    """One DDPM loss's parameter gradients at 64^3 (the bench's model,
    batch REMAT_HOLD_BATCH) with recomputation against without, on the same
    seeded weights and inputs; the bar is HOLD_FACTOR times the distance of
    two runs without it (the step's own repeatability), or bitwise where
    that is 0. Peak bytes allocated during each gradient."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import bench

    pipes = {}
    for name, remat in (("plain", "0"), ("remat", "1")):
        with bench_env({"BENCH_GRID": str(REMAT_HOLD_GRID),
                        "BENCH_BATCH": str(REMAT_HOLD_BATCH), "BENCH_REMAT": remat}):
            pipes[name] = bench.training_pipeline(bench.settings(), device)
    sd = random_state_dict(pipes["plain"].backbone, seed=4)
    for pipe in pipes.values():
        pipe.load_state_dict(sd)
    rng = np.random.default_rng(5)
    unet = pipes["plain"].backbone
    shape = (REMAT_HOLD_BATCH, *unet.data_shape, 1)
    data = {"data": torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device),
            "labels": torch.from_numpy(rng.uniform(
                0, 1, (REMAT_HOLD_BATCH, 4 * unet.model_channels)).astype(np.float32)).to(device)}
    t = torch.tensor([17, 803], device=device)[:REMAT_HOLD_BATCH]
    noise = randn(shape, 6, device, torch.float32)
    grads, peaks = {}, {}
    for key, name in (("plain", "plain"), ("plain_again", "plain"), ("remat", "remat")):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads[key] = train_gradients(pipes[name], data, t, noise)
        torch.cuda.synchronize()
        peaks[key] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                      "peak_over_start_bytes": torch.cuda.max_memory_allocated() - base}
    floor = grad_distance(grads["plain_again"], grads["plain"])
    got = grad_distance(grads["remat"], grads["plain"])
    bitwise = all(torch.equal(grads["remat"][k], v) for k, v in grads["plain"].items())
    ok = (bitwise if floor[0] == 0.0 else got[0] <= HOLD_FACTOR * floor[0]) \
        and all(bool(torch.isfinite(v).all()) for v in grads["remat"].values())
    return {"batch": REMAT_HOLD_BATCH, "grid": REMAT_HOLD_GRID, "remat_vs_plain_rel_l2": got[0],
            "worst_param": got[1], "worst_param_rel_l2": got[2],
            "plain_vs_plain_rel_l2": floor[0], "bitwise": bitwise,
            "bar": HOLD_FACTOR * floor[0], "peaks": peaks, "ok": ok}


def optimizer_holds(device) -> list:
    """Each of the ten optax optimizers: OPTIMIZER_STEPS steps on the
    flagship's distinct parameter shapes (one parameter per shape, seeded
    values and gradients) on the card and on the CPU; the card's
    displacement held against the CPU's."""
    import torch

    from rho_diffusion_tpu_torch.training.optimizers import build_optimizer

    model = build_pipeline(flagship_config(25), "bfloat16", "cpu").backbone
    shapes = sorted({tuple(p.shape) for p in model.parameters()})
    gen = torch.Generator().manual_seed(11)
    start = [0.05 * torch.randn(shape, generator=gen) for shape in shapes]
    grads = [[torch.randn(shape, generator=gen) for shape in shapes]
             for _ in range(OPTIMIZER_STEPS)]
    rows = []
    for name, lr in sorted(OPTIMIZER_LR.items()):
        opt = build_optimizer(name, {"lr": lr})
        moved = {}
        for key, where in (("card", device), ("cpu", "cpu")):
            params = [torch.nn.Parameter(p.to(where, copy=True)) for p in start]
            torch_opt = opt.make(params)
            t0 = time.perf_counter()
            for i in range(OPTIMIZER_STEPS):
                for p, g in zip(params, grads[i]):
                    p.grad = g.to(where)
                opt.set_lr(torch_opt, i)
                torch_opt.step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            moved[key] = (torch.cat([(p.detach().cpu() - s0).flatten()
                                     for p, s0 in zip(params, start)]), seconds)
            del params, torch_opt
        diff = float(torch.linalg.vector_norm(moved["card"][0] - moved["cpu"][0]))
        size = float(torch.linalg.vector_norm(moved["cpu"][0]))
        rel_moved = size / float(torch.linalg.vector_norm(torch.cat([s.flatten() for s in start])))
        rows.append({"optimizer": name, "lr": lr, "rel_l2_of_displacement": diff / size,
                     "displacement_rel_to_params": rel_moved, "bar": OPTIMIZER_BAR,
                     "card_s": moved["card"][1], "cpu_s": moved["cpu"][1],
                     "ok": diff / size <= OPTIMIZER_BAR and rel_moved > 0})
    return rows


def profiled_training(device) -> dict:
    """``python -m rho_diffusion_tpu_torch.training`` with ``--profile`` on
    the flagship config at full width for PROFILE_STEPS steps; the chrome
    trace it writes, read back: its device (kernel) events."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.training.__main__ import main as train_main

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    try:
        cfg = train_config(TRAIN_BATCH)
        cfg["dataset"]["kwargs"]["length"] = PROFILE_STEPS * TRAIN_BATCH
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        torch.cuda.empty_cache()
        launch_counts.clear()
        t0 = time.perf_counter()
        st = train_main([str(cfg_path), "-d", DEVICE, "--work-dir", str(tmp / "run"),
                         "--no-resume", "--profile", str(tmp / "trace")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        steps = int(st.step)
        del st
        traces = sorted((tmp / "trace").glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if traces else []
        kernels = [e for e in events if e.get("cat") == "kernel"]
        return {"steps": steps, "wall_s": wall, "trace_files": [t.name for t in traces],
                "trace_bytes": sum(t.stat().st_size for t in traces), "events": len(events),
                "kernel_events": len(kernels),
                "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
                "port_kernel_events": sum(1 for e in kernels if any(
                    k in e.get("name", "") for k in ("conv3d_", "flash_"))),
                "launches": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_utils(state: dict) -> None:
    """The training utilities on the card: (a) the op table of the
    flagship's training step at batch 32 (``benchmarks.op_table`` at its
    defaults); (b) 64^3 training through the bench entry's train mode with
    BENCH_REMAT=1 at batch 8, and at batch 4 with and without it (steps/s,
    peak bytes); (c) the recomputed gradients held against plain ones; (d)
    the ten optax optimizers on the card against the CPU; (e) the training
    CLI with ``--profile``."""
    import torch

    from rho_diffusion_tpu_torch import bench
    from rho_diffusion_tpu_torch.benchmarks import op_table
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_routes

    device = torch.device(DEVICE)
    problems = []
    launches: dict = {}
    seconds: dict = {}
    t0 = time.perf_counter()

    torch.cuda.empty_cache()
    launch_counts.clear()
    with bench_env({}, prefix="XPROF_"):
        table = op_table.main([])
    launches["utils_op_table"] = dict(launch_counts)
    torch.cuda.empty_cache()
    group_sum = sum(g["ms"] for g in table["groups"])
    seconds["op_table"] = time.perf_counter() - t0
    window = table["window_ms"]
    if not window > 0 or abs(group_sum - window) > 0.01 * window:
        problems.append(f"op table: groups {group_sum} ms of a {table['window_ms']} ms window")

    train64 = {}
    for name, env in TRAIN64_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        flash_routes.clear()
        t1 = time.perf_counter()
        with bench_env({**env, **TRAIN64_TIMING}):
            line = bench.main([])
        train64[name] = {"env": env, "line": line, "peak_bytes": torch.cuda.max_memory_allocated(),
                         "wall_s": time.perf_counter() - t1, "launches": dict(launch_counts),
                         "flash_routes": dict(flash_routes)}
        launches[f"utils_train64_{name}"] = dict(launch_counts)
    seconds["train64"] = time.perf_counter() - t0 - sum(seconds.values())

    torch.cuda.empty_cache()
    hold = remat_hold(device)
    torch.cuda.empty_cache()
    seconds["remat_hold"] = time.perf_counter() - t0 - sum(seconds.values())
    optimizers = optimizer_holds(device)
    seconds["optimizers"] = time.perf_counter() - t0 - sum(seconds.values())
    profiled = profiled_training(device)
    launches["utils_profile"] = profiled["launches"]
    seconds["profile"] = time.perf_counter() - t0 - sum(seconds.values())

    state["utils_launches"] = launches
    emit("utils", op_table={k: table[k] for k in ("workload", "device", "steps", "window_ms",
                                                  "per_step_ms", "launches", "groups",
                                                  "scopes", "annotations_left_out_ms")},
         op_table_group_sum_ms=group_sum, train64=train64, remat_hold=hold,
         optimizers=optimizers, profiled_training=profiled, launches=launches, seconds=seconds)
    for name in ("utils_op_table", *(f"utils_train64_{n}" for n, _ in TRAIN64_RUNS),
                 "utils_profile"):
        missing = [k for k in TRAINING_KERNELS if not launches[name].get(k)]
        if missing:
            problems.append(f"{name} never launched {missing}")
    for name, run in train64.items():
        if not run["flash_routes"] or not all("Tk=4096" in r for r in run["flash_routes"]):
            problems.append(f"train64 {name}: flash routes {run['flash_routes']}")
    if not hold["ok"]:
        problems.append(f"remat hold: {hold}")
    bad = [r for r in optimizers if not r["ok"]]
    if bad:
        problems.append(f"optimizers card vs CPU: {bad}")
    if profiled["steps"] != PROFILE_STEPS or not profiled["port_kernel_events"]:
        problems.append(f"profiled training: {profiled}")
    if problems:
        fail("utils: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# int8 (W8A8) inference

# the int8 phase: the timing and hold batches, the extra S2 problems (a 2-D,
# a 1-D and a ragged Cin = 24 conv: (x, Cout, kernel, stride, pads); the
# last, a case only S2 takes, is its main row), the fp32 weight shape S3 is
# held at, and the int8 kernels a path must launch
INT8_TIMING_BATCH = 8
INT8_HOLD_BATCH = 4
INT8_S2_EXTRA = (
    ((8, 64, 64, 64), 64, (3, 3), (2, 2), ((1, 1),) * 2, "2-D stride 2 (DeepGalaxy-like)"),
    ((8, 4096, 64), 64, (3,), (1,), ((1, 1),), "1-D (Spectroscopy-like)"),
    ((8, 32, 16, 16, 24), 48, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, "ragged Cin = 24"),
)
INT8_WEIGHT_SHAPE = (512, 1024 * 27)
# the flagship's int8 path: S1, the strided Downsample on S1's block, S3
INT8_KERNELS = ("conv3d_s8", "conv3d_s8_strided", "quantize_int8_amax", "quantize_int8")
# the 2-D convs' path: the 2-D DeepGalaxy config under int8 through the
# inference CLI; the 1-D convs': the 1-D Spectroscopy config the same way
INT8_2D_SAMPLES = 8
INT8_1D_SAMPLES = 8
# the int8 conv routes each CLI path's quantised conv sites take
INT8_PATH_ROUTES = {"2d": ("s1_2d", "s1_2d_strided"), "1d": ("s1_1d", "s1_1d_strided")}
PEAK_INT8 = 1979e12


class Int8Sites:
    """Records the int8 mode's conv and Dense sites of the forwards run in
    its body (``ops.quant.conv_int8``/``dense_int8``): per call the input
    shape and dtype, the layer's channels, kernel, stride and pads, the
    output dtype and the route ("s1", "s1_strided", "s1_2d",
    "s1_2d_strided", "s1_1d", "s1_1d_strided", "s2", "int_mm" or "float").
    The CPU tests count sites with it too."""

    def __init__(self):
        self.calls: list[dict] = []

    def kinds(self) -> dict:
        """Calls by site and kind: conv_int8, conv_float, dense_int8,
        dense_float."""
        out: dict = {}
        for c in self.calls:
            key = f"{c['site']}_{'float' if c['route'] == 'float' else 'int8'}"
            out[key] = out.get(key, 0) + 1
        return out

    def __enter__(self):
        from rho_diffusion_tpu_torch.ops import quant
        from rho_diffusion_tpu_torch.ops.kernels.conv_int8 import int8_conv_route

        self.quant = quant
        self.orig = quant.conv_int8, quant.dense_int8

        def conv(module, x):
            cout = module.weight.shape[0]
            ks = (module.kernel_size,) * module.dims
            pads = tuple(tuple(p) for p in module._pads())
            small = quant.is_small(x.shape[-1], cout)
            self.calls.append({
                "site": "conv", "x": tuple(x.shape), "x_dtype": x.dtype, "cout": cout,
                "kernel": ks, "stride": tuple(module.stride), "pads": pads,
                "out_dtype": module.dtype or x.dtype,
                "route": "float" if small else int8_conv_route(tuple(x.shape), ks,
                                                               module.stride, pads, cout)})
            return self.orig[0](module, x)

        def dense(module, x):
            cout = module.weight.shape[0]
            small = quant.is_small(x.shape[-1], cout)
            self.calls.append({"site": "dense", "x": tuple(x.shape), "x_dtype": x.dtype,
                               "cout": cout, "out_dtype": module.dtype or x.dtype,
                               "route": "float" if small else "int_mm"})
            return self.orig[1](module, x)

        quant.conv_int8, quant.dense_int8 = conv, dense
        return self

    def __exit__(self, *exc):
        self.quant.conv_int8, self.quant.dense_int8 = self.orig


def int8_operands(xs, cout: int, ksize, seed: int, device):
    """Seeded int8 x and weights [Cout, Cin, *K] over the whole range, the
    scales the quantiser would give (small, positive) and a bias."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    cin = xs[-1]

    def q(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int32).to(torch.int8)

    xq, wq = q(tuple(xs)), q((cout, cin, *ksize))
    s_x = torch.rand(xs[0], generator=gen, device=device) * 1e-2 + 1e-3
    s_w = torch.rand(cout, generator=gen, device=device) * 1e-3 + 1e-4
    bias = 0.1 * torch.randn(cout, generator=gen, device=device)
    return xq, wq, s_x, s_w, bias


def int8_problems(sites: list) -> tuple[dict, dict]:
    """The distinct S1/S2 problems of a forward's int8 sites (``Int8Sites``),
    and its quantised activations' (shape, dtype), each with its calls."""
    problems: dict = {}
    acts: dict = {}
    for c in sites:
        if c["route"] in ("s1", "s1_strided", "s2"):
            key = (c["route"], c["x"], c["cout"], c["kernel"], c["stride"], c["pads"],
                   c["out_dtype"])
            problems[key] = problems.get(key, 0) + 1
        if c["route"] != "float":
            acts[(c["x"], c["x_dtype"])] = acts.get((c["x"], c["x_dtype"]), 0) + 1
    return problems, acts


def int8_conv_row(route: str, xs, cout: int, ksize, stride, pads, out_dtype, device, seed: int,
                  calls: int, per: str, variant=None) -> dict:
    """One int8 conv problem on its kernel (S1, the strided route on S1's
    block, the 2-D and 1-D routes on it, or S2): its int32 sums and its
    dequantised ``out_dtype`` output held bitwise against the plain version
    on the same inputs (the strided, 2-D and 1-D routes' against S2's too),
    then (with ``calls``) timed beside its bound (int8 operations at 1,979
    TOPS or bytes), the plain version and K5's bf16 conv of the same shape
    (S1's problems) or cuDNN's bf16 ``F.conv2d`` (the 2-D routes') or
    ``F.conv1d`` (the 1-D routes') as the yardstick; the strided, 2-D and
    1-D routes beside S2 on the same inputs (``s2_ms``)."""
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k
    from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d_kernel

    xq, wq, s_x, s_w, bias = int8_operands(xs, cout, ksize, seed, device)
    if route in k.S1_ROUTES:
        layout = (k.s1_2d_weights if route.startswith("s1_2d") else
                  k.s1_1d_weights if route.startswith("s1_1d") else k.s1_weights)
        w = layout(wq)
        name = k.S1_ROUTES[route][0]
        launch = {"s1": k.conv3d_s8_kernel, "s1_strided": k.conv3d_s8_strided_kernel,
                  "s1_2d": k.conv2d_s8_kernel, "s1_2d_strided": k.conv2d_s8_strided_kernel,
                  "s1_1d": k.conv1d_s8_kernel,
                  "s1_1d_strided": k.conv1d_s8_strided_kernel}[route]

        def run(dt=out_dtype):
            return launch(xq, s_x, w, s_w, bias, dt)
    else:
        w = k.s2_weights(wq)
        name = "conv_s8_general"

        def run(dt=out_dtype):
            return k.conv_s8_general_kernel(xq, s_x, w, s_w, bias, ksize, stride, pads, dt)

    def plain():
        return k.conv_int8_plain(xq, s_x, wq, s_w, bias, stride, pads, out_dtype)

    acc = k.conv_int32_plain(xq, wq, stride, pads)
    sums_equal = bool(torch.equal(run(torch.int32), acc))
    got, want = run(), k.dequantize_plain(acc, s_x, s_w, bias, out_dtype)
    check = exact_error(got.float(), want.float())
    check["ok"] = check["ok"] and sums_equal
    check["check"] = "bitwise equal: the int32 sums and the dequantised output"
    beside_s2 = route in ("s1_strided", "s1_2d", "s1_2d_strided", "s1_1d", "s1_1d_strided")
    if beside_s2:
        w2 = k.s2_weights(wq)

        def run_s2():
            return k.conv_s8_general_kernel(xq, s_x, w2, s_w, bias, ksize, stride, pads,
                                            out_dtype)

        check["equal_s2"] = bool(torch.equal(got, run_s2()))
        check["ok"] = check["ok"] and check["equal_s2"]
        check["check"] += ", and the output equal to S2's on the same inputs"
    row = {"kind": "forward", "x": list(xs), "cout": cout, "kernel_size": list(ksize),
           "stride": list(stride), "pads": [list(p) for p in pads], "kernel": name,
           "dtype": f"int8->{dtype_name(out_dtype)}", "int32_sums_equal": sums_equal,
           "variant": variant, **check}
    if calls:
        vox_out = math.prod(acc.shape[:-1])
        ops = 2.0 * vox_out * cout * math.prod(ksize) * xs[-1]
        item = torch.empty((), dtype=out_dtype).element_size()
        nbytes = math.prod(xs) + wq.numel() + vox_out * cout * item + 4 * (xs[0] + 2 * cout)
        bnd, by = bound_ms(ops, nbytes, PEAK_INT8)
        row.update(calls=calls, per=per, **kernel_times(run, name),
                   plain_ms=cuda_time_ms(plain, iters=2, warmup=1),
                   library="none: PyTorch has no int8 conv on CUDA", library_ms=None,
                   bound_ms=bnd, bound_by=by)
        row["tops"] = ops / row["ms"] / 1e9
        if beside_s2:
            s2 = kernel_times(run_s2, "conv_s8_general", iters=3)
            row.update(s2_ms=s2["ms"], s2_call_ms=s2["call_ms"], s2_over_this=s2["ms"] / row["ms"])
        if route.startswith(("s1_2d", "s1_1d")):
            # the yardstick: cuDNN's bf16 conv of the same shape (no int8 conv on CUDA)
            conv = F.conv2d if route.startswith("s1_2d") else F.conv1d
            xb = randn(xs, seed + 1, device, torch.bfloat16).movedim(-1, 1)
            wb = randn((cout, xs[-1], *ksize), seed + 2, device, torch.bfloat16, 0.02)
            with torch.no_grad():
                cudnn = cuda_time_ms(lambda: conv(xb, wb, bias.bfloat16(), stride=stride,
                                                  padding=1), iters=10)
            row.update(cudnn_bf16_ms=cudnn, cudnn_bf16_of=f"F.{conv.__name__} in bf16, "
                       "channels-first (CUDA events; a yardstick, not the same function)",
                       s8_over_cudnn_bf16=row["ms"] / cudnn)
        if route == "s1":
            xb = randn(xs, seed + 1, device, torch.bfloat16)
            wb = randn((cout, xs[-1], 3, 3, 3), seed + 2, device, torch.bfloat16, 0.02)
            with torch.no_grad():
                k5 = kernel_times(lambda: conv3d_kernel(xb, wb, bias.bfloat16()),
                                  "conv3d_igemm")
            row.update(k5_bf16_ms=k5["ms"], k5_bf16_call_ms=k5["call_ms"],
                       s8_over_k5=row["ms"] / k5["ms"])
    return row


def quantize_rows_row(xs, dtype, device, seed: int, calls: int, per: str, variant=None) -> list:
    """S3 on one activation shape: q and the scales held bitwise against
    ``quantize_rows_plain``; with ``calls`` its two launches timed apart
    (the max pass bound by reading x once, the quantise pass by reading x
    and writing q once), beside the plain version."""
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    gen = torch.Generator(device=device).manual_seed(seed)
    scale = torch.rand((xs[0],) + (1,) * (len(xs) - 1), generator=gen, device=device) * 4 + 0.1
    x = (torch.randn(xs, generator=gen, device=device) * scale).to(dtype)
    q, s = k.quantize_rows_kernel(x)
    qp, sp = k.quantize_rows_plain(x)
    check = exact_error(torch.cat([q.flatten().float(), s]), torch.cat([qp.flatten().float(), sp]))
    base = {"kind": "quantize", "x": list(xs), "dtype": f"{dtype_name(dtype)}->int8",
            "variant": variant, **check, "check": "bitwise equal: q and the scales"}
    rows = [{**base, "kernel": name} for name in ("quantize_int8_amax", "quantize_int8")]
    if calls:
        plain_ms = cuda_time_ms(lambda: k.quantize_rows_plain(x), iters=3)
        n, item = x.numel(), x.element_size()
        for row, nbytes in zip(rows, (n * item, n * (item + 1) + 4 * xs[0])):
            row.update(calls=calls, per=per,
                       **kernel_times(lambda: k.quantize_rows_kernel(x), row["kernel"]),
                       plain_ms=plain_ms, library="none: no one PyTorch call quantizes per row",
                       library_ms=None, bound_ms=nbytes / MEM_RATE * 1e3, bound_by="bytes")
    return rows


def dense_site_rows(sites: list, device, seed: int) -> list:
    """The Dense sites' int8 products: ``torch._int_mm`` (cuBLASLt, the
    library product JAX leaves to XLA) per distinct (M, K, N), timed beside
    its bound and held exact against an int64 product."""
    import torch

    from rho_diffusion_tpu_torch.ops import quant

    shapes: dict = {}
    for c in sites:
        if c["site"] == "dense" and c["route"] == "int_mm":
            key = (math.prod(c["x"][:-1]), c["x"][-1], c["cout"])
            shapes[key] = shapes.get(key, 0) + 1
    rows = []
    gen = torch.Generator(device=device).manual_seed(seed)
    for (m, kk, n), calls in sorted(shapes.items()):
        a = torch.randint(-127, 128, (m, kk), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-127, 128, (n, kk), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        exact = bool(torch.equal(quant.int_mm(a, b),
                                 (a.double() @ b.double().T).to(torch.int32)))
        bnd, by = bound_ms(2.0 * m * kk * n, m * kk + kk * n + 4 * m * n, PEAK_INT8)
        rows.append({"m": m, "k": kk, "n": n, "calls": calls, "exact": exact,
                     "int_mm_ms": cuda_time_ms(lambda: quant.int_mm(a, b), iters=10),
                     "bound_ms": bnd, "bound_by": by})
    return rows


def int8_model_hold(cfg: dict, sd: dict, device) -> dict:
    """A full-width int8 forward held against the int8 plain model (every
    int8 piece and float kernel on its plain version), in three parts.

    S1-S3 alone: the forward with the int8 kernels and every float layer on
    its plain version must equal the int8 plain model bitwise, since each of
    S1-S3 is bitwise its plain version. The float kernels alone: the forward
    with the float kernels and the int8 plain versions must equal the
    all-kernels forward bitwise, so the whole gap between the kernels and
    the int8 plain model is the float kernels' (the bf16 input conv,
    attention). That gap is held within HOLD_FACTOR of the int8 model's own
    bf16 spread (the int8 plain model in bf16 against it in fp32) and under
    HOLD_CAP: one bf16 rounding that moves an activation across a boundary
    of round(x / s) moves the next layer's int8 input by a whole quantum,
    and the network carries such flips forward, so the float kernels'
    rounding reaches the int8 output amplified; beside it the same kernels'
    gap in the float model, the float model's bf16 spread and the bar it
    would give, and the int8 model's distance to the fp32 float model."""
    import torch

    from rho_diffusion_tpu_torch.ops.quant import conv_quant, set_int8_backend

    fast = build_pipeline(cfg, "bfloat16", device)
    fast.load_state_dict(sd)
    ref = build_pipeline(cfg, "float32", device)
    ref.load_state_dict(sd)
    x, t, y = unet_inputs(fast.backbone, INT8_HOLD_BATCH, device, seed=21)
    with torch.no_grad():
        with conv_quant("int8"):
            got = fast.apply(x, t, y)
            with plain_backends(int8=False):
                int8_kernels_only = fast.apply(x, t, y)
            set_int8_backend("plain")
            try:
                float_kernels_only = fast.apply(x, t, y)
            finally:
                set_int8_backend("auto")
            with plain_backends():
                plain_int8 = fast.apply(x, t, y)
                plain_int8_fp32 = ref.apply(x, t, y)
        float_kernels = fast.apply(x, t, y)
        with plain_backends():
            plain_bf16 = fast.apply(x, t, y)
            plain_fp32 = ref.apply(x, t, y)
    k = rel_mse(got, plain_int8)
    spread, p = rel_mse(plain_int8, plain_int8_fp32), rel_mse(plain_bf16, plain_fp32)
    row = {"int8_kernels_only_equal_int8_plain": bool(torch.equal(int8_kernels_only,
                                                                  plain_int8)),
           "float_kernels_only_equal_kernels": bool(torch.equal(float_kernels_only, got)),
           "kernels_vs_int8_plain": k, "int8_plain_bf16_vs_int8_plain_fp32": spread,
           "bar": min(HOLD_FACTOR * spread, HOLD_CAP["forward"]),
           "float_model_kernels_vs_plain": rel_mse(float_kernels, plain_bf16),
           "bf16_plain_vs_fp32_plain": p, "bar_of_the_float_spread": HOLD_FACTOR * p,
           "int8_kernels_vs_fp32_plain": rel_mse(got, plain_fp32),
           "int8_plain_vs_fp32_plain": rel_mse(plain_int8, plain_fp32),
           "int8_kernels_vs_bf16_plain": rel_mse(got, plain_bf16),
           "finite": bool(torch.isfinite(got).all()), "batch": INT8_HOLD_BATCH}
    row["ok"] = (row["finite"] and row["int8_kernels_only_equal_int8_plain"]
                 and row["float_kernels_only_equal_kernels"] and k <= row["bar"])
    return row


def int8_forward_times(cfg: dict, sd: dict, batch: int, device) -> dict:
    """The UNet forward at ``batch`` in bf16 and under int8 (CUDA events,
    the same module), each with its device profile's busy share."""
    import torch

    from rho_diffusion_tpu_torch.ops.quant import conv_quant

    pipe = build_pipeline(cfg, "bfloat16", device)
    pipe.load_state_dict(sd)
    unet = pipe.backbone
    inputs = unet_inputs(unet, batch, device, seed=7)
    out = {}
    with torch.no_grad():
        for name, mode in (("bf16", "off"), ("int8", "int8"), ("bf16_again", "off"),
                           ("int8_again", "int8")):
            with conv_quant(mode):
                ms = cuda_time_ms(lambda: unet(*inputs), iters=5)
                out[f"{name}_forward_ms"] = ms
                if not name.endswith("again"):
                    out[f"{name}_profile"] = profile_forward(unet, inputs, ms)
    out["int8_over_bf16"] = (out["int8_forward_ms"] + out["int8_again_forward_ms"]) / (
        out["bf16_forward_ms"] + out["bf16_again_forward_ms"])
    return out


def int8_serve_load(device) -> dict:
    """``benchmarks.serve_bench`` at its defaults under bf16 and under int8
    (SERVE_QUANT=int8), on the same seeded random weights (the ``load``
    phase's), one after the other; each run's p50, volumes/s, occupancy,
    load-phase launches and busy share, and its kernel launches."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks import serve_bench
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.quant import get_conv_quant

    runs = {}
    sd = None
    for name, env in (("bf16", {}), ("int8", {"SERVE_QUANT": "int8"})):
        with bench_env(env, prefix="SERVE_"):
            s = serve_bench.settings()
        if sd is None:
            sd = random_state_dict(serve_bench.pipeline(s, "cpu").backbone, seed=0)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        service = serve_bench.build_service(s, device, params=sd)
        build_s = time.perf_counter() - t0
        try:
            launch_counts.clear()
            measured, busy = serve_bench.measure(service, s, device)
            counts = dict(launch_counts)
        finally:
            service.close()
        del service
        runs[name] = {"result": measured, "build_and_warmup_s": build_s,
                      "device_busy_share_of_load_phase": busy,
                      "p50_latency_s": measured["single_request_latency_p50_s"],
                      "volumes_per_s": measured["throughput_volumes_per_s"],
                      "launches": counts, "mode_after_close": get_conv_quant()}
    return runs


class FirstCall:
    """Keeps the first call of ``cls.forward`` in its body: the module and
    its arguments (so the model a CLI builds can be timed after it
    returns)."""

    def __init__(self, cls):
        self.cls, self.orig, self.call = cls, cls.forward, None

    def __enter__(self):
        orig = self.orig

        def forward(module, *args, **kwargs):
            if self.call is None:
                self.call = (module, args, kwargs)
            return orig(module, *args, **kwargs)

        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


def int8_cli_path(device, which: str) -> dict:
    """A CLI path under int8: the inference CLI with ``--quant int8`` on
    the 2-D DeepGalaxy config (``which`` "2d": 128^2, width 32) or the 1-D
    Spectroscopy config ("1d": 4096 points, width 32), at full width, the
    schedule cut to DATA_SAMPLE_STEPS, INT8_2D_SAMPLES or INT8_1D_SAMPLES
    samples, from seeded random weights, the dataset standing in as its
    class's parameter space as in the CLI. Counts cleared just before, read
    just after. Every quantised conv site must take the routes of
    INT8_PATH_ROUTES (2-D: the 3x3 convs on S1's block at stride 1 and 2;
    1-D: the 3-tap convs on it at stride 1 and 2), with S2's launches
    exactly its sites' (none). The first UNet call is kept (``model_call``)
    for the forward's device time."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference, registry
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.models.unet import UNet
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.kernels.conv_int8 import S1_ROUTES

    cfg_file, samples = {"2d": (DEEP_GALAXY_CONFIG, INT8_2D_SAMPLES),
                         "1d": (SPECTRO_CONFIG, INT8_1D_SAMPLES)}[which]
    cfg = json.loads(cfg_file.read_text())
    cfg["noise_schedule"]["kwargs"]["num_steps"] = DATA_SAMPLE_STEPS
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    space = inference.declared_dataset(registry.get("datasets", config.dataset.name),
                                       config.dataset.kwargs)
    data_shape = tuple(cfg["model"]["kwargs"]["data_shape"])
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_int8_{which}_"))
    try:
        cfg_path, pth = tmp / "config.json", tmp / "model.pth"
        cfg_path.write_text(json.dumps(cfg))
        torch.save(random_state_dict(data_pipeline(cfg, space, "float32", "cpu").backbone, 0),
                   pth)
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Int8Sites() as sites, FirstCall(UNet) as first:
            out = inference.main([str(cfg_path), "-p", str(pth), "-n", str(samples),
                                  "-d", DEVICE, "-f", "--work-dir", str(tmp), "--quant", "int8"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    routes, problems = {}, {}
    for c in sites.calls:
        if c["site"] == "conv":
            key = f"{c['route']} stride {c['stride']}"
            routes[key] = routes.get(key, 0) + 1
        if c["route"] in ("s1_2d", "s1_2d_strided", "s1_1d", "s1_1d_strided", "s2"):
            key = (c["route"], c["x"], c["cout"], c["kernel"], c["stride"], c["pads"],
                   c["out_dtype"])
            problems[key] = problems.get(key, 0) + 1
    finite = bool(np.isfinite(out).all())
    want = INT8_PATH_ROUTES[which]
    off_route = sorted({r for r in (c["route"] for c in sites.calls if c["site"] == "conv")
                        if r not in (*want, "float")})
    s2_sites = sum(n for key, n in problems.items() if key[0] == "s2")
    ok = (finite and tuple(out.shape) == (samples, *data_shape, 1) and not off_route
          and all(counts.get(S1_ROUTES[r][0] if r != "s2" else "conv_s8_general", 0) > 0
                  for r in want)
          and counts.get("conv_s8_general", 0) == s2_sites
          and not counts.get("conv3d_s8") and not counts.get("conv3d_s8_strided"))
    return {"config": cfg_file.name, "steps": DATA_SAMPLE_STEPS,
            "forwards": DATA_SAMPLE_STEPS - 1, "shape": list(out.shape), "finite": finite,
            "wall_s": wall, "launches": counts, "conv_sites_by_route": routes,
            "routes_wanted": list(want), "sites_off_route": off_route,
            "s2_sites": s2_sites, "ok": ok, "problems": problems, "model_call": first.call}


def int8_path_forward_times(call) -> dict:
    """One forward of a CLI path's own UNet on its first call's inputs, in
    bf16 and under int8, in turns (CUDA events), each profiled once: its
    device time by kernel, and the int8 convs' share of it."""
    import torch

    from rho_diffusion_tpu_torch.ops.quant import conv_quant

    model, args, kwargs = call
    out = {"inputs": [list(a.shape) for a in args if hasattr(a, "shape")]}
    with torch.no_grad():
        for name, mode in (("bf16", "off"), ("int8", "int8"), ("bf16_again", "off"),
                           ("int8_again", "int8")):
            with conv_quant(mode):
                ms = cuda_time_ms(lambda: model(*args, **kwargs), iters=5)
                out[f"{name}_forward_ms"] = ms
                if name.endswith("again"):
                    continue
                by_name = device_time_by_kernel(lambda: model(*args, **kwargs))
                if not by_name:
                    out[f"{name}_profile"] = NOT_PROFILED
                    continue
                summary = profile_summary(by_name)
                out[f"{name}_profile"] = {**summary, "busy_share_of_forward":
                                          summary["busy_ms"] / ms}
                out[f"{name}_int8_conv_device_ms"] = sum(
                    t for kname, (t, _) in by_name.items()
                    if "conv3d_s8_wgmma" in kname or "conv_s8_general" in kname)
    out["int8_over_bf16"] = (out["int8_forward_ms"] + out["int8_again_forward_ms"]) / (
        out["bf16_forward_ms"] + out["bf16_again_forward_ms"])
    return out


def phase_int8(state: dict, steps: int, samples: int) -> None:
    """int8 W8A8 inference on the flagship at full width: every int8 conv
    problem of a batch-8 forward on S1 or S2, the Downsample and the extra
    S2 problems, S3 at every activation shape, all bitwise against their
    plain versions and timed; the bf16 Cout = 1 head problem on K5's igemm;
    the Dense sites' int8 products; the path (the inference CLI with
    ``--quant int8``, its counts); the 2-D path (DeepGalaxy, its 3x3 convs
    on S1's block at stride 1 and 2) and the 1-D path (Spectroscopy, its
    3-tap convs on S1's block at stride 1 and 2), each path's problems held
    bitwise (against S2 too) and timed (beside S2 and cuDNN's bf16 conv),
    each path's forward in bf16 and int8; the int8 forward against the int8 plain model; the forward's
    time at batch 8 in bf16 and int8; and the serving load harness in bf16
    and int8."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.ops import quant
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts
    from rho_diffusion_tpu_torch.ops.quant import conv_quant, get_conv_quant

    device = torch.device(DEVICE)
    cfg = flagship_config(steps)
    unet = build_unet(cfg, "bfloat16", device)
    sd = {k: v.cpu() for k, v in unet.state_dict().items()}
    x, t, y = unet_inputs(unet, INT8_TIMING_BATCH, device, seed=1)
    with Int8Sites() as rec, conv_quant("int8"), torch.no_grad():
        unet(x, t, y)
    torch.cuda.synchronize()
    sites = rec.calls
    del unet
    per = f"one UNet forward at batch {INT8_TIMING_BATCH}"
    problems, acts = int8_problems(sites)
    rows = []
    for i, ((route, xs, cout, ks, st, pads, odt), n) in enumerate(sorted(problems.items(),
                                                                        key=str)):
        rows.append(int8_conv_row(route, xs, cout, ks, st, pads, odt, device, 300 + 7 * i, n,
                                  per))
    # S2 runs on no path: its launches are these holds' (its count's path)
    launch_counts.clear()
    for i, (xs, cout, ks, st, pads, what) in enumerate(INT8_S2_EXTRA):
        rows.append(int8_conv_row("s2", xs, cout, ks, st, pads, torch.bfloat16, device,
                                  400 + 7 * i, 1, f"one call ({what})",
                                  variant=None if i == len(INT8_S2_EXTRA) - 1 else what))
    state["int8_s2_launches"] = dict(launch_counts)
    for i, ((xs, dt), n) in enumerate(sorted(acts.items(), key=str)):
        rows += quantize_rows_row(xs, dt, device, 500 + i, n, per)
    rows += quantize_rows_row(INT8_WEIGHT_SHAPE, torch.float32, device, 590, 1, "one call",
                              variant="fp32 weights [512, 27 x 1024] (once per module)")
    head = {**hold_conv("forward", ((INT8_TIMING_BATCH, 32, 32, 32, 64), 1, torch.bfloat16),
                        device, seed=600),
            "variant": "bf16 Cout = 1 head on K5's igemm (off the flagship's int8 path: "
                       "both packages cast to fp32 before the head)"}
    dense = dense_site_rows(sites, device, seed=610)
    record_errors(state, rows + [head])
    state["int8"] = rows
    summary = {
        "sites_per_forward": {r: sum(1 for c in sites if c["route"] == r)
                              for r in ("s1", "s1_strided", "s2", "int_mm", "float")},
        "float_sites": [{"site": c["site"], "x": c["x"], "cout": c["cout"],
                         "dtype": dtype_name(c["out_dtype"])}
                        for c in sites if c["route"] == "float"],
    }
    emit("int8_kernels", batch=INT8_TIMING_BATCH, **summary, rows=rows, head=head,
         dense_sites=dense)
    fail_bad("int8", rows + [head])
    if not all(r["exact"] for r in dense):
        fail(f"int8: torch._int_mm was not exact: {dense}")
    small = [c for c in sites if c["route"] == "float"
             and not quant.is_small(c["x"][-1], c["cout"])]
    if small:
        fail(f"int8: layers with >= {quant.MIN_QUANT_CHANNELS} channels stayed float: {small}")

    # the path: the inference CLI with --quant int8, its launches counted
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_int8_"))
    try:
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        pth = tmp / "model.pth"
        torch.save(sd, pth)
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Int8Sites() as path_sites:
            out = inference.main([str(cfg_path), "-p", str(pth), "-n", str(samples), "-d",
                                  DEVICE, "-f", "--work-dir", str(tmp), "--quant", "int8"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, site_counts = dict(launch_counts), path_sites.kinds()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["int8_launches"] = counts
    # the 2-D and the 1-D convs' paths (S1's block), and their problems a
    # forward there held and timed (their main rows), S2 beside them on the
    # same inputs; each path's forward timed on its own model
    paths, path_rows, path_forward = {}, {}, {}
    for which, samples_, seed0 in (("2d", INT8_2D_SAMPLES, 700), ("1d", INT8_1D_SAMPLES, 800)):
        path_ = int8_cli_path(device, which)
        state[f"int8_{which}_launches"] = path_["launches"]
        per_ = (f"one {'2-D DeepGalaxy' if which == '2d' else '1-D Spectroscopy'} UNet forward "
                f"at batch {samples_}")
        path_rows[which] = [
            int8_conv_row(route, xs, cout, ks, st, pads, odt, device, seed0 + 7 * i,
                          n / path_["forwards"], per_)
            for i, ((route, xs, cout, ks, st, pads, odt), n) in enumerate(
                sorted(path_.pop("problems").items(), key=str))]
        path_forward[which] = int8_path_forward_times(path_.pop("model_call"))
        rows_ = path_rows[which]
        path_forward[which]["kernel_rows_ms"] = {
            "this": sum(r["ms"] * r["calls"] for r in rows_),
            "s2": sum(r["s2_ms"] * r["calls"] for r in rows_),
            "bound": sum(r["bound_ms"] * r["calls"] for r in rows_),
            "cudnn_bf16": sum(r["cudnn_bf16_ms"] * r["calls"] for r in rows_),
            "of": f"the path's int8 conv problems summed over {per_}"}
        paths[which] = path_
        torch.cuda.empty_cache()
    path_kernel_rows = path_rows["2d"] + path_rows["1d"]
    record_errors(state, path_kernel_rows)
    state["int8"] += path_kernel_rows
    fail_bad("int8 (the 2-D and 1-D paths' problems)", path_kernel_rows)
    path_2d = paths["2d"]
    forwards = steps - 1
    finite = bool(np.isfinite(out).all())
    path = {"shape": list(out.shape), "finite": finite, "wall_s": wall, "steps": steps,
            "forwards": forwards, "launches": counts, "site_counts": site_counts,
            "mode_after": get_conv_quant(), "sample_mean": float(out.mean()),
            "sample_std": float(out.std())}
    hold = int8_model_hold(cfg, sd, device)
    times = int8_forward_times(cfg, sd, INT8_TIMING_BATCH, device)
    load = int8_serve_load(device)
    emit("int8", path=path, path_2d=path_2d, path_1d=paths["1d"], path_rows=path_kernel_rows,
         path_forward=path_forward, hold=hold, forward=times, load=load)
    problems_found = []
    if not finite or path["mode_after"] != "off":
        problems_found.append(f"the int8 path: {path}")
    missing = [k for k in INT8_KERNELS if not counts.get(k)]
    if missing:
        problems_found.append(f"the int8 path never launched {missing}; counts {counts}")
    # every forward of the path: the same sites as the recorded one; the
    # three Downsamples on the strided route, and S2 never
    per_fwd = summary["sites_per_forward"]
    if (per_fwd["s1_strided"] != 3 or counts.get("conv3d_s8_strided") != 3 * forwards
            or counts.get("conv_s8_general", 0) or per_fwd["s2"]):
        problems_found.append(f"the int8 path's Downsamples: {per_fwd['s1_strided']} strided "
                              f"sites a forward, launches {counts} over {forwards} forwards "
                              "(want 3 conv3d_s8_strided a forward, no conv_s8_general)")
    # every quantised conv site of the 2-D and 1-D paths on S1's block (S2
    # on none of them)
    for which, path_ in paths.items():
        if not path_["ok"]:
            problems_found.append(f"the {which} int8 path: {path_}")
    want_sites = {"conv_int8": (per_fwd["s1"] + per_fwd["s1_strided"] + per_fwd["s2"]) * forwards,
                  "dense_int8": per_fwd["int_mm"] * forwards,
                  "conv_float": per_fwd["float"] * forwards}
    if {k: site_counts.get(k, 0) for k in want_sites} != want_sites \
            or site_counts.get("dense_float"):
        problems_found.append(f"int8 sites on the path {site_counts}, expected {want_sites}")
    if not hold["ok"]:
        problems_found.append(f"int8 model hold: {hold}")
    for name, run in load.items():
        r = run["result"]
        if not r["all_finite"] or not 0 < r["mean_batch_occupancy"] <= 1 \
                or run["mode_after_close"] != "off":
            problems_found.append(f"serve load {name}: {run}")
    if not all(load["int8"]["launches"].get(k) for k in INT8_KERNELS):
        problems_found.append(f"the int8 service never launched {INT8_KERNELS}: "
                              f"{load['int8']['launches']}")
    if problems_found:
        fail("int8: " + "; ".join(problems_found))


# ---------------------------------------------------------------------------
# The other backbones: the ViT at the bench entry's full width, the SimpleUNet
# ---------------------------------------------------------------------------

# the ViT of the root bench.py's BENCH_MODEL=vit (32^3, patch 8, embedding
# 256, hidden 512, depth 8, 16 heads: head dim 16 over 64 tokens), here
# class-conditional through FourierConditioning on the dataset's raw (l, m)
# rows, as the training and inference CLIs build it
VIT_MODEL = {"patch_size": 8, "input_shapes": [32, 32, 32], "num_channels": 1,
             "embedding_dim": 256, "hidden_dim": 512, "transformer_depth": 8, "num_heads": 16,
             "dropout": 0.0, "num_classes": 20, "cond_fn": "FourierConditioning"}
# its attention at the bench's batch 32, and a ragged T for the holds
VIT_ATTENTION = (32, 64, 16, 16)
VIT_RAGGED = (2, 50, 16, 16)
# the long route's holds past the small route's T (the pair on request
# beside it), and its path: the bench's ViT at patch 4 (512 tokens; its
# attention at the bench's batch 32), steps counted after one warm-up step
VIT_PAIR_HOLD = (2, 256, 16, 16)
VIT_PATCH4_ATTENTION = (32, 512, 16, 16)
# the narrow forward's holds (twice bitwise, with and without the LSE, the
# mma.sync kernel beside): the ViT's attention at patch 8 and 4, a ragged
# T and D = 32
VIT_NARROW_HOLDS = (VIT_ATTENTION, VIT_PATCH4_ATTENTION, (2, 65, 16, 16), (4, 512, 8, 32))
VIT_LONG_MEMORY = (64, 4096, 16, 16)  # the long backward's memory at B*H 1024, T 4096
VIT_PATCH4_STEPS = 2
VIT_SAMPLE_STEPS = 25
VIT_SAMPLES = 4
VIT_HOLD_BATCH = 4
VIT_GRAD_BATCH = 2
VIT_CUTS = {
    "model": "UNetv2 -> VisionTransformer at the root bench.py's full width, with "
             "num_classes 20 and cond_fn FourierConditioning",
    "dataset.kwargs": "use_emb_as_labels false (the raw (l, m) rows FourierConditioning "
                      "reads); length 1000 -> TRAIN_STEPS * batch",
    "training.max_epochs": "1000 -> 1",
    "training.save_checkpoint_every_n_epochs": "10 -> 1",
    "training.log_every_n_steps": "50 -> 1",
    "training.loggers": "stdout, jsonl -> jsonl",
    "noise_schedule.kwargs.num_steps": "1000 for training; 1000 -> 25 for the inference CLI",
    "inference.cache_file, plot_output_file, checkpoint": "-> none (the trained checkpoint)",
}
# the SimpleUNet ("UNet") in 3-D at JAX's default widths: down (64, 128,
# 256), up (256, 128, 64), time embedding 32, ReLU, residual convs, every
# block at full resolution
SIMPLE_MODEL = {"input_channels": 1, "block_type": "UNetBlock3d", "dtype": "bfloat16"}
SIMPLE_GRID = 32
SIMPLE_TRAIN_BATCH = 8
SIMPLE_TRAIN_STEPS = 3
SIMPLE_SAMPLE_BATCH = 2
SIMPLE_SAMPLE_STEPS = 25
SIMPLE_HOLD_BATCH = 2


def vit_config(batch: int, steps: int) -> dict:
    """The flagship config with the ViT for its model and the vit phase's cuts."""
    cfg = json.loads(CONFIG.read_text())
    cfg["model"] = {"name": "VisionTransformer", "kwargs": dict(VIT_MODEL)}
    cfg["dataset"]["kwargs"].update(use_emb_as_labels=False, length=TRAIN_STEPS * batch)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = steps
    cfg["training"].update(batch_size=batch, max_epochs=1, save_checkpoint_every_n_epochs=1,
                           log_every_n_steps=1, loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    return cfg


def raw_rows(n: int, device):
    """The first ``n`` raw (l, m) rows of the flagship's parameter space."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch.utils import sample_from_discrete_parameter_space

    space = json.loads(CONFIG.read_text())["inference"]["parameter_space"]
    rows = sample_from_discrete_parameter_space(space, n, random=False,
                                                rng=np.random.default_rng(0))
    return torch.as_tensor(np.asarray(rows, np.float32), device=device)


def model_holds(fast, ref, inputs: tuple, grad_batch: dict) -> tuple[dict, list]:
    """The hold rule on a backbone's forward (``inputs``) and on one DDPM
    loss's parameter gradients (``grad_batch``: data, labels, t, noise):
    the kernels against the fp32 plain model, at most HOLD_FACTOR times as
    far as the bf16 plain model, capped. Returns (fields, failed)."""
    import torch

    with torch.no_grad():
        got = {"forward": fast.apply(*inputs)}
        with plain_backends():
            plain_bf16 = {"forward": fast.apply(*inputs)}
            plain_fp32 = {"forward": ref.apply(*inputs)}
    fields = hold_rows(got, plain_bf16, plain_fp32, HOLD_CAP)
    bad = [what for what, row in fields.items() if not row["ok"]]
    data, t, noise = grad_batch["data"], grad_batch["t"], grad_batch["noise"]
    grads = train_gradients(fast, data, t, noise)
    with plain_backends():
        grads_bf16 = train_gradients(fast, data, t, noise)
        grads_fp32 = train_gradients(ref, data, t, noise)
    k, k_name, k_worst = grad_distance(grads, grads_fp32)
    p, _, _ = grad_distance(grads_bf16, grads_fp32)
    row = {"metric": "relative L2 over all parameter gradients", "kernels_vs_fp32_plain": k,
           "bf16_plain_vs_fp32_plain": p, "worst_parameter_kernels": {"name": k_name,
                                                                        "rel_l2": k_worst},
           "parameters": len(grads_fp32),
           "bar": min(HOLD_FACTOR * p, HOLD_CAP["train_gradients"])}
    row["ok"] = (k <= row["bar"] and set(grads) == set(grads_fp32)
                 and all(bool(torch.isfinite(g).all()) for g in grads.values()))
    fields["train_gradients"] = row
    if not row["ok"]:
        bad.append("train_gradients")
    return fields, bad


def simple_unet_conv_rows(unet, batch: int, device) -> tuple[list, dict]:
    """Every distinct K5 problem of one SimpleUNet forward at ``batch`` and
    of its input gradients, held against the plain version and timed, with
    their calls per forward or step; and the forward's problems by name."""
    import torch

    from rho_diffusion_tpu_torch.ops import convolution as conv_mod

    gen = torch.Generator().manual_seed(40)
    x = torch.randn((batch, *(SIMPLE_GRID,) * 3, 1), generator=gen).to(device)
    t = torch.randint(0, 1000, (batch,), generator=gen).to(device)
    with CallRecorder(conv_mod, "conv3d") as rec, torch.no_grad():
        unet(x, t)
    torch.cuda.synchronize()
    rows, problems = [], {}
    for kind, seed in (("forward", 800), ("dgrad", 850)):
        calls: dict = {}
        for key in conv_keys(rec.calls, kind):
            calls[key] = calls.get(key, 0) + 1
        per = (f"one SimpleUNet {'forward' if kind == 'forward' else 'training step'} at "
               f"batch {batch}")
        for i, (key, n) in enumerate(sorted(calls.items(), key=lambda kv: str(kv[0]))):
            name = conv_problem_name(kind, key[0], key[1], dtype_name(key[2]))
            problems[name] = n
            row = hold_conv(kind, key, device, seed + 3 * i, n, per)
            row["variant"] = f"SimpleUNet 32^3 {kind}: {name}, {per}"
            rows.append(row)
    return rows, problems


def run_vit_clis(device) -> dict:
    """The training CLI on the ViT config (TRAIN_STEPS steps at TRAIN_BATCH
    from the seeded initialisation, one checkpoint), then the inference
    CLI's DDPM-25 at batch VIT_SAMPLES on that checkpoint's EMA weights;
    each path's counts cleared just before it and read just after."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.training.__main__ import main as train_main
    from rho_diffusion_tpu_torch.training.checkpoint import CheckpointManager

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_vit_"))
    try:
        work = tmp / "run"
        train_cfg, sample_cfg = tmp / "train.json", tmp / "sample.json"
        train_cfg.write_text(json.dumps(vit_config(TRAIN_BATCH, 1000)))
        sample_cfg.write_text(json.dumps(vit_config(TRAIN_BATCH, VIT_SAMPLE_STEPS)))
        torch.cuda.empty_cache()
        st, train_s, train_counts, train_routes = counted(lambda: train_main(
            [str(train_cfg), "-d", DEVICE, "--work-dir", str(work), "--no-resume"]))
        records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if "train_loss" in r]
        latest = CheckpointManager(work / "checkpoints").latest_step()
        del st
        torch.cuda.empty_cache()
        out, sample_s, sample_counts, sample_routes = counted(lambda: inference.main(
            [str(sample_cfg), "-n", str(VIT_SAMPLES), "-d", DEVICE, "-f", "--work-dir",
             str(work)]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [r["train_loss"] for r in steps]
    return {
        "train": {"steps": len(steps), "losses": losses, "step_s": [r["step_s"] for r in steps],
                  "grad_norms": [r["grad_norm"] for r in steps], "wall_s": train_s,
                  "checkpoint_step": latest, "launches": train_counts,
                  "flash_routes": train_routes,
                  "ok": len(steps) == TRAIN_STEPS and bool(np.isfinite(losses).all())
                  and latest == TRAIN_STEPS},
        "sample": {"shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
                   "sample_std": float(out.std()), "wall_s": sample_s, "steps": VIT_SAMPLE_STEPS,
                   "batch": VIT_SAMPLES, "launches": sample_counts, "flash_routes": sample_routes,
                   "ok": tuple(out.shape) == (VIT_SAMPLES, 32, 32, 32, 1)
                   and bool(np.isfinite(out).all())},
    }


def phase_vit(state: dict) -> None:
    """The other backbones on the card. (a) The bench entry with
    BENCH_MODEL=vit at full width (32^3, patch 8, 256/512, depth 8, 16
    heads, batch 32, bf16, AdamW with EMA 0.9999, LinearSchedule(1000)): its
    train mode's windows and its one JSON line. (b) The training CLI on the
    ViT config (FourierConditioning on raw (l, m) rows), then the inference
    CLI's DDPM-25 at batch 4 on its checkpoint. Every ViT path runs the
    narrow forward and no mma.sync forward (the ``flash_attention`` count).
    (a2) The long backward's path: the bench's ViT at patch 4 (512 tokens
    of head dim 16, past the small route), VIT_PATCH4_STEPS training steps,
    no dkv/dq pair launch. (c) Holds: the ViT's bf16 forward and one loss's
    gradients against the fp32 plain model; the forward and the small
    backward at the ViT's attention and at a ragged T, the long backward at
    T = 256 and at patch 4's attention, against their plain versions, twice
    bitwise, and against the pair on request; the narrow forward at
    VIT_NARROW_HOLDS, twice bitwise, beside the mma.sync kernel on request.
    (d) The narrow forward and the small backward timed at the ViT's
    attention beside SDPA (device time from CUDA graphs too) and their
    bound, with their launches per step and per sample; the narrow forward
    and the long backward at patch 4's attention; the mma.sync forward and
    the pair it replaced on request at both. (e) The SimpleUNet in 3-D at 32^3 with JAX's default
    widths in bf16: SIMPLE_TRAIN_STEPS training steps at batch 8, a DDPM-25
    sample at batch 2 through ``reverse_process``, its forward and gradients
    held, and its K5 problems held and timed."""
    import io

    import numpy as np
    import torch
    import torch.nn.functional as F

    from rho_diffusion_tpu_torch import bench
    from rho_diffusion_tpu_torch.diffusion import DDPM, LinearSchedule
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        MMA_SYNC_PLAN, flash_attention, flash_bwd_plan, flash_plan)

    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    launches, problems, seconds = {}, [], {}

    # (a) the bench entry, in-process
    torch.cuda.empty_cache()
    captured, err = io.StringIO(), io.StringIO()
    with bench_env({"BENCH_MODEL": "vit"}), contextlib.redirect_stdout(captured), \
            contextlib.redirect_stderr(err):
        result, wall, counts, routes = counted(lambda: bench.main(["-d", DEVICE]))
    lines = captured.getvalue().splitlines()
    with bench_env({"BENCH_MODEL": "vit"}):
        s = bench.settings()
    ran = re.search(r" steps_run=(\d+)", err.getvalue())
    bench_steps = int(ran.group(1)) if ran else 0
    if not ran:
        problems.append(f"bench: no steps_run in its stderr {err.getvalue()!r}")
    bench_run = {"line": json.loads(lines[-1]) if lines else None, "lines": len(lines),
                 "entry_s": wall, "stderr": err.getvalue().strip(), "steps": bench_steps,
                 "launches": counts, "flash_routes": routes,
                 "launches_per_step": {k: v / max(bench_steps, 1) for k, v in counts.items()}}
    launches["vit_bench"] = counts
    small = ("flash_attention_fwd_narrow", "flash_attention_bwd_small")
    # no mma.sync (nor wgmma) forward: ``flash_attention`` counts those
    others = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_delta",
              "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    per_step = s["backbone_kwargs"]["transformer_depth"]
    if lines != [json.dumps(result)] or any(counts.get(k) != per_step * bench_steps
                                            for k in small) or any(counts.get(k) for k in others):
        problems.append(f"bench: lines {lines}, launches {counts} (want {per_step} of each of "
                        f"{small} a step over {bench_steps} steps, none of {others})")
    # the bench's pipeline again: the host's seconds a step over 10 steps,
    # then one step profiled (the device's busy share against that, its
    # launches, its time by kernel group)
    with bench_env({"BENCH_MODEL": "vit"}):
        pipe = bench.training_pipeline(s, device)
    ts = pipe.create_state(777)
    gen = torch.Generator().manual_seed(0)
    shape = (s["batch"], *s["backbone_kwargs"]["input_shapes"], 1)
    batch = {"data": torch.rand(shape, generator=gen).to(device), "labels": None}
    for _ in range(3):
        pipe.training_step(ts, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        pipe.training_step(ts, batch)
    torch.cuda.synchronize()
    bench_run["profiled_step"] = profiled_step(
        device_time_by_kernel(lambda: pipe.training_step(ts, batch)),
        (time.perf_counter() - t1) / 10)
    del pipe, ts, batch
    torch.cuda.empty_cache()
    seconds["bench"] = time.perf_counter() - t0

    # (a2) the long backward's path: the bench's ViT at patch 4 (512 tokens)
    s4 = {**s, "backbone_kwargs": {**s["backbone_kwargs"], "patch_size": 4}}
    pipe = bench.training_pipeline(s4, device)
    ts = pipe.create_state(778)
    batch = {"data": torch.rand(shape, generator=gen).to(device), "labels": None}
    pipe.training_step(ts, batch)
    metrics, p4_s, counts, routes4 = counted(
        lambda: [pipe.training_step(ts, batch) for _ in range(VIT_PATCH4_STEPS)])
    launches["vit_patch4"] = counts
    long = ("flash_attention_fwd_narrow", "flash_attention_bwd_long")
    none = ("flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq", "flash_attention_bwd_small", "flash_attention_bwd")
    patch4 = {"tokens": (s["grid"] // 4) ** 3, "steps": VIT_PATCH4_STEPS, "wall_s": p4_s,
              "losses": [float(m["train_loss"]) for m in metrics], "launches": counts,
              "launches_per_step": {k: v / VIT_PATCH4_STEPS for k, v in counts.items()},
              "flash_routes": routes4}
    if any(counts.get(k) != per_step * VIT_PATCH4_STEPS for k in long) \
            or any(counts.get(k) for k in none) or not np.isfinite(patch4["losses"]).all():
        problems.append(f"patch-4 ViT: {patch4} (want {per_step} of each of {long} a step, "
                        f"none of {none})")
    del pipe, ts, batch
    torch.cuda.empty_cache()
    seconds["patch4"] = time.perf_counter() - t0 - sum(seconds.values())

    # (b) the training and inference CLIs
    clis = run_vit_clis(device)
    launches["vit_train_cli"] = clis["train"]["launches"]
    launches["vit_sample_cli"] = clis["sample"]["launches"]
    for what, want in (("train", small), ("sample", ("flash_attention_fwd_narrow",))):
        missing = [k for k in want if not clis[what]["launches"].get(k)]
        if missing or not clis[what]["ok"] or clis[what]["launches"].get("flash_attention"):
            problems.append(f"{what} CLI: missing {missing} (or an mma.sync forward), "
                            f"{clis[what]}")
    seconds["clis"] = time.perf_counter() - t0 - sum(seconds.values())

    # (c) holds: the model, then the kernels at the ViT's attention and a ragged T
    cfg = vit_config(TRAIN_BATCH, 1000)
    fast = build_pipeline(cfg, "bfloat16", device)
    sd = random_state_dict(fast.backbone, seed=0)
    fast.load_state_dict(sd)
    ref = build_pipeline(cfg, "float32", device)
    ref.load_state_dict(sd)
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((VIT_HOLD_BATCH, 32, 32, 32, 1), generator=gen).clamp(-1, 1).to(device)
    t = torch.randint(0, 1000, (VIT_HOLD_BATCH,), generator=gen).to(device)
    y = raw_rows(VIT_HOLD_BATCH, device)
    g = VIT_GRAD_BATCH
    grad_batch = {"data": {"data": x[:g], "labels": y[:g]}, "t": t[:g],
                  "noise": torch.randn((g, 32, 32, 32, 1), generator=gen).to(device)}
    vit_hold, bad = model_holds(fast, ref, (x, t, y), grad_batch)
    if bad:
        problems.append(f"vit hold {bad}: {vit_hold}")
    del fast, ref
    torch.cuda.empty_cache()
    b, tt, h, d = VIT_ATTENTION
    holds = [check_flash(*VIT_ATTENTION, device, 900, torch.bfloat16),
             check_flash(*VIT_RAGGED, device, 901, torch.bfloat16)]
    bwd_holds = [check_flash_bwd(*VIT_ATTENTION, device, 902, torch.bfloat16),
                 check_flash_bwd(*VIT_RAGGED, device, 903, torch.bfloat16),
                 check_flash_bwd(*VIT_PAIR_HOLD, device, 904, torch.bfloat16),
                 check_flash_bwd(*VIT_PATCH4_ATTENTION, device, 905, torch.bfloat16)]
    if [r["route"] for r in bwd_holds] != ["small", "small", "long", "long"]:
        problems.append(f"flash backward routes at D = 16: {[r['route'] for r in bwd_holds]}")
    long_memory = long_bwd_memory_hold(*VIT_LONG_MEMORY, device)
    if not long_memory["ok"]:
        problems.append(f"long backward memory: {long_memory}")
    narrow_holds = [row for i, shape in enumerate(VIT_NARROW_HOLDS)
                    for row in check_flash_narrow(*shape, device, 910 + i)]
    if [r["route_chosen"] for r in narrow_holds] != ["narrow"] * len(narrow_holds):
        problems.append(f"flash forward routes at D = 16/32: "
                        f"{[r['route_chosen'] for r in narrow_holds]}")
    record_errors(state, holds + narrow_holds + [gr for row in bwd_holds for gr in row["grads"]])
    bad = ([r for r in holds + narrow_holds if not r["ok"]]
           + [r for r in bwd_holds if not r["ok"]])
    if bad:
        problems.append(f"flash holds at D = 16: {bad}")
    seconds["holds"] = time.perf_counter() - t0 - sum(seconds.values())

    # (d) the narrow forward (its main row at the ViT's attention, patch
    # 4's a variant) and the small backward timed at the ViT's attention,
    # per training step; the long backward (its main rows, and the pair's
    # on request) at patch 4's; the mma.sync forward on request at both
    per = f"one ViT training step at batch {b} ({per_step} attention calls)"
    per4 = f"one patch-4 ViT training step at batch {b} ({per_step} attention calls)"
    t4 = patch4["tokens"]
    assert VIT_PATCH4_ATTENTION == (b, t4, h, d)

    def mma_sync_row(t_, per_):
        return flash_fwd_row(b, t_, h, d, per_step, per_, device, torch.bfloat16,
                             variant=f"the mma.sync kernel on request at T={t_}, D={d}, "
                                     f"B*H={b * h}, {per_}", plan=MMA_SYNC_PLAN)

    fwd64 = flash_fwd_row(b, tt, h, d, per_step, per, device, torch.bfloat16)
    fwd512 = flash_fwd_row(b, t4, h, d, per_step, per4, device, torch.bfloat16,
                           variant=f"vit patch 4: T={t4}, D={d}, B*H={b * h}, {per4}")
    rows = ([fwd64, mma_sync_row(tt, per)]
            + flash_bwd_rows(b, tt, h, d, per_step, per, device, torch.bfloat16)
            + [fwd512, mma_sync_row(t4, per4)]
            + flash_bwd_rows(b, t4, h, d, per_step, per4, device, torch.bfloat16))
    routes_here = {"forward": flash_plan(b, h, tt, tt, d).route,
                   "forward_at_patch4": flash_plan(b, h, t4, t4, d).route,
                   "backward": flash_bwd_plan(b, h, tt, tt, d).route,
                   "backward_at_patch4": flash_bwd_plan(b, h, t4, t4, d).route}
    if (routes_here["forward"], routes_here["forward_at_patch4"]) != ("narrow", "narrow"):
        problems.append(f"the ViT's forward routes: {routes_here}")
    # like for like: the device time of a whole call (CUDA graphs, no host
    # work) of the wrapper and of SDPA, on the inputs of the rows above
    # (the backward's SDPA time is already so)
    for row, t_ in ((fwd64, tt), (fwd512, t4)):
        q, k, v = flash_inputs(b, t_, h, d, device, seed=300 + t_, dtype=torch.bfloat16)
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        row["wrapper_device_ms"] = graph_ms(lambda: flash_attention(q, k, v), calls=10)
        row["library_device_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), calls=10)
        del q, k, v, qt, kt, vt
    seconds["kernel_rows"] = time.perf_counter() - t0 - sum(seconds.values())

    # (e) the SimpleUNet
    simple = {}
    pipe = DDPM(backbone="UNet", backbone_kwargs=dict(SIMPLE_MODEL),
                schedule=LinearSchedule(1000), optimizer="AdamW", opt_kwargs={"lr": 1e-4},
                ema_decay=0.9999, device=device, seed=0)
    gen = torch.Generator().manual_seed(31)
    shape = (SIMPLE_TRAIN_BATCH, *(SIMPLE_GRID,) * 3, 1)
    batch = {"data": torch.rand(shape, generator=gen).to(device), "labels": None}
    ts = pipe.create_state(seed=1)
    torch.cuda.reset_peak_memory_stats()
    metrics, train_s, counts, _ = counted(
        lambda: [pipe.training_step(ts, batch) for _ in range(SIMPLE_TRAIN_STEPS)])
    losses = [float(m["train_loss"]) for m in metrics]
    launches["simple_unet_train"] = counts
    t1 = time.perf_counter()
    pipe.training_step(ts, batch)
    torch.cuda.synchronize()
    simple["train"] = {"batch": SIMPLE_TRAIN_BATCH, "steps": SIMPLE_TRAIN_STEPS,
                       "losses": losses, "wall_s": train_s, "one_more_step_s":
                       time.perf_counter() - t1, "launches": counts,
                       "peak_bytes": torch.cuda.max_memory_allocated()}
    want = ("conv3d_igemm", "conv3d_direct", "conv3d_dgrad_igemm")
    missing = [k for k in want if not counts.get(k)]
    if missing or not np.isfinite(losses).all():
        problems.append(f"SimpleUNet training: missing {missing}, losses {losses}")
    sampler = DDPM(backbone="UNet", backbone_kwargs=dict(SIMPLE_MODEL),
                   schedule=LinearSchedule(SIMPLE_SAMPLE_STEPS), device=device, seed=0)
    sampler.load_state_dict({k: v.detach() for k, v in ts.model.state_dict().items()})
    del ts, pipe
    torch.cuda.empty_cache()
    sample_shape = (SIMPLE_SAMPLE_BATCH, *(SIMPLE_GRID,) * 3, 1)
    out, sample_s, counts, _ = counted(lambda: sampler.reverse_process(
        sample_shape, None, generator=torch.Generator(device=device).manual_seed(5))["denoised"])
    launches["simple_unet_sample"] = counts
    finite = bool(torch.isfinite(out).all())
    simple["sample"] = {"shape": list(out.shape), "finite": finite, "wall_s": sample_s,
                        "steps": SIMPLE_SAMPLE_STEPS, "launches": counts}
    missing = [k for k in ("conv3d_igemm", "conv3d_direct") if not counts.get(k)]
    if missing or not finite or tuple(out.shape) != sample_shape:
        problems.append(f"SimpleUNet sample: missing {missing}, {simple['sample']}")
    gen = torch.Generator().manual_seed(32)
    x8 = torch.randn((SIMPLE_TRAIN_BATCH, *(SIMPLE_GRID,) * 3, 1), generator=gen).to(device)
    t8 = torch.randint(0, 1000, (SIMPLE_TRAIN_BATCH,), generator=gen).to(device)
    with torch.no_grad():
        simple["forward_ms"] = {"batch": SIMPLE_TRAIN_BATCH, "ms": cuda_time_ms(
            lambda: sampler.backbone(x8, t8), iters=5)}
    del x8, t8
    conv_rows, conv_problems = simple_unet_conv_rows(sampler.backbone, SIMPLE_TRAIN_BATCH,
                                                     device)
    simple["conv_problems"] = conv_problems
    del sampler
    torch.cuda.empty_cache()
    ref_kw = {**SIMPLE_MODEL, "dtype": "float32"}
    fast = DDPM(backbone="UNet", backbone_kwargs=dict(SIMPLE_MODEL),
                schedule=LinearSchedule(1000), device=device, seed=0)
    ref = DDPM(backbone="UNet", backbone_kwargs=ref_kw, schedule=LinearSchedule(1000),
               device=device, seed=0)
    sd = random_state_dict(fast.backbone, seed=2)
    fast.load_state_dict(sd)
    ref.load_state_dict(sd)
    gen = torch.Generator().manual_seed(33)
    hb = SIMPLE_HOLD_BATCH
    x = torch.randn((hb, *(SIMPLE_GRID,) * 3, 1), generator=gen).clamp(-1, 1).to(device)
    t = torch.randint(0, 1000, (hb,), generator=gen).to(device)
    grad_batch = {"data": {"data": x, "labels": None}, "t": t,
                  "noise": torch.randn(x.shape, generator=gen).to(device)}
    simple["hold"], bad = model_holds(fast, ref, (x, t), grad_batch)
    if bad:
        problems.append(f"SimpleUNet hold {bad}: {simple['hold']}")
    del fast, ref
    torch.cuda.empty_cache()
    seconds["simple_unet"] = time.perf_counter() - t0 - sum(seconds.values())

    rows += conv_rows
    record_errors(state, rows)
    state["vit"] = rows
    state["vit_launches"] = launches
    emit("vit", cuts=VIT_CUTS, bench=bench_run, clis=clis, hold=vit_hold,
         patch4=patch4, flash_holds=holds, flash_narrow_holds=narrow_holds,
         flash_bwd_holds=bwd_holds,
         long_bwd_memory=long_memory, routes_at_vit_attention=routes_here,
         kernel_rows=rows, simple_unet=simple, seconds=seconds,
         launches_per_sample={k: v / VIT_SAMPLES for k, v in clis["sample"]["launches"].items()},
         wall_s=time.perf_counter() - t0)
    fail_bad("vit", rows)
    if problems:
        fail("vit: " + "; ".join(problems))


# the diffusers phase: DeepGalaxy's config (2-D 128^2, MultiEmbeddings over
# (s, m, t, c), batch 64, bf16) with UNet_Diffuser for its model and
# DiffusersDDPMPipeline (v prediction, fixed_small) for its pipeline: steps
# of training, a DDIM sample through the inference CLI, the holds' batch
DIFF_PIPELINE = {"prediction_type": "v_prediction", "variance_type": "fixed_small"}
DIFF_TRAIN_STEPS = 3
DIFF_SAMPLES = 8
DIFF_SAMPLE_STEPS = 10
DIFF_HOLD_BATCH = 2
# UNet_Diffuser's attention at batch 64: 8 heads of 8 channels over 64^2
# tokens (ds 2, 5 calls a forward) and over 32^2 (ds 4, 6 calls)
DIFF_ATTENTION = (((64, 4096, 8, 8), 5), ((64, 1024, 8, 8), 6))
DIFF_MEMORY = (64, 4096, 8, 8)  # the long backward's memory at B*H 512, T 4096
# the plain versions hold and time the full-batch calls this many rows at a
# time, over the whole batch: its fp32 scores at T 4096 (34 GB) do not fit
# twice
DIFF_PLAIN_ROWS = 4
# progressive distillation on the learned-variance config: the cascade
# 8 -> 4 -> 2, 3 updates a stage, its dataset cut; the student's sample
DISTILL_FROM, DISTILL_TO, DISTILL_UPDATES = 8, 2, 3
DISTILL_LENGTH = 256
DISTILL_SAMPLES = 8
# an update's time: distill_stage at 1 and 1 + DISTILL_TIMED updates, the
# difference over DISTILL_TIMED (the stage's copies and optimizer left out)
DISTILL_TIMED = 5
DIFF_CUTS = {
    "model.name": "UNetv2 -> UNet_Diffuser (its kwargs as configured; the pinned "
                  "architecture ignores channel_mult, attention_resolutions, num_heads, "
                  "use_scale_shift_norm, model_channels)",
    "pipeline": "DDPM -> DiffusersDDPMPipeline (prediction_type v_prediction, "
                "variance_type fixed_small; the config's LinearSchedule(500) as its schedule)",
    "training.max_epochs": f"-> whole epochs to {DIFF_TRAIN_STEPS} steps",
    "training.log_every_n_steps, benchmark_mode, loggers": "-> 1, true, jsonl",
    "inference": f"DDIM-{DIFF_SAMPLE_STEPS} at batch {DIFF_SAMPLES} (the first rows of its "
                 "parameter_space) through --sampler/--steps; cache and plot files -> none",
    "distillation (config_learned_variance.json)": (
        f"dataset length 2048 -> {DISTILL_LENGTH}; --from {DISTILL_FROM} --to {DISTILL_TO} "
        f"--updates {DISTILL_UPDATES} at the config's batch 32; random seeded teacher; the "
        f"student sampled at DDIM-{DISTILL_TO} trailing, batch {DISTILL_SAMPLES}, over the "
        "flagship's parameter_space"),
}


def diffusers_config() -> dict:
    """DeepGalaxy's config with UNet_Diffuser and DiffusersDDPMPipeline."""
    cfg = json.loads(DEEP_GALAXY_CONFIG.read_text())
    cfg["model"]["name"] = "UNet_Diffuser"
    cfg["pipeline"] = {"name": "DiffusersDDPMPipeline", "kwargs": dict(DIFF_PIPELINE)}
    cfg["training"].update(log_every_n_steps=1, benchmark_mode=True, loggers=["jsonl"])
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    return cfg


def run_diffusers_backbone(work: Path, route: str, device) -> dict:
    """UNet_Diffuser under DiffusersDDPMPipeline at full width: a training
    run through Trainer (as the training CLI builds it) from seeded random
    weights, one more step timed and profiled; the inference CLI's DDIM
    sample from the trained weights; the forward, one loss's gradients and
    a DDIM sample held against the fp32 plain model. Each path's counts are
    cleared just before it and read just after."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.loader import to_device
    from rho_diffusion_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    cfg = diffusers_config()
    dataset = data_dataset("deep_galaxy", cfg, route, work)
    dataset_s = time.perf_counter() - t0
    config = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    sd = random_state_dict(data_pipeline(cfg, dataset, "float32", "cpu").backbone, seed=0)
    pth = work / "random.pth"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(sd, pth)
    run_dir = work / "run"
    trainer = Trainer(config, dataset=dataset, work_dir=run_dir, device=DEVICE)
    steps_per_epoch = len(trainer.loader)
    epochs = -(-DIFF_TRAIN_STEPS // steps_per_epoch)
    state0 = trainer.init_state(resume=False, weights_path=str(pth))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, train_wall, train_counts, train_routes = counted(
        lambda: trainer.fit(state0, max_epochs=epochs))
    train_peak = torch.cuda.max_memory_allocated()
    logged = trained_records(run_dir)
    pipe = trainer.pipeline
    batch = to_device(next(iter(trainer.loader.iter_batches())), device)
    pipe.training_step(st, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe.training_step(st, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    by_name = device_time_by_kernel(lambda: pipe.training_step(st, batch))
    profiled = profiled_step(by_name, step_s)
    attention_ms = sum(ms for name, (ms, _) in by_name.items()
                       if "flash_fwd_narrow" in name or "flash_bwd_long" in name)
    if "busy_ms" in profiled:
        profiled.update(attention_ms=attention_ms,
                        attention_share_of_busy=attention_ms / profiled["busy_ms"])
    del trainer, pipe, st, state0, batch
    torch.cuda.empty_cache()

    # the inference CLI's DDIM sample from the trained weights
    s_path = work / "sample_config.json"
    s_path.write_text(json.dumps(cfg))
    trained = run_dir / "model.pth"
    out, sample_wall, sample_counts, sample_routes = counted(lambda: inference.main(
        [str(s_path), "-p", str(trained), "-n", str(DIFF_SAMPLES), "-d", DEVICE, "-f",
         "--sampler", "ddim", "--steps", str(DIFF_SAMPLE_STEPS), "--work-dir", str(work)]))

    # the forward, one loss's gradients and a DDIM sample on the kernels
    # against the fp32 plain model, beside the bf16 plain model
    fast = data_pipeline(cfg, dataset, "bfloat16", device)
    fast.load_state_dict(sd)
    ref = data_pipeline(cfg, dataset, "float32", device)
    ref.load_state_dict(sd)
    gen = torch.Generator().manual_seed(7)
    hb = DIFF_HOLD_BATCH
    shape = fast.sample_shape(hb)
    x = torch.randn(shape, generator=gen).clamp(-1, 1).to(device)
    t = torch.randint(0, len(fast.schedule), (hb,), generator=gen).to(device)
    space = cfg["inference"]["parameter_space"]
    y = fast.conditions_from_parameter_space(space, hb, random=False).float()
    grad_batch = {"data": {"data": x, "labels": y}, "t": t,
                  "noise": torch.randn(shape, generator=gen).to(device)}
    hold, bad = model_holds(fast, ref, (x, t, y), grad_batch)
    x_T = torch.randn(shape, generator=gen).to(device)

    def sample(p):
        return p.reverse_process(shape, y, sampler="ddim", num_steps=DIFF_SAMPLE_STEPS, x_T=x_T)

    got = {"sample": sample(fast)}
    with plain_backends():
        plain_bf16, plain_fp32 = {"sample": sample(fast)}, {"sample": sample(ref)}
    hold.update(hold_rows(got, plain_bf16, plain_fp32, HOLD_CAP))
    bad += [] if hold["sample"]["ok"] else ["sample"]
    del fast, ref, got, plain_bf16, plain_fp32
    torch.cuda.empty_cache()

    narrow, long = "flash_attention_fwd_narrow", "flash_attention_bwd_long"
    others = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_delta",
              "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "flash_attention_bwd_small")
    per_step = sum(calls for _, calls in DIFF_ATTENTION)
    problems = []
    finite = bool(np.isfinite(out).all())
    if logged["steps"] != DIFF_TRAIN_STEPS or not np.isfinite(
            logged["losses"] + logged["grad_norms"]).all():
        problems.append(f"training logged {logged}")
    if (train_counts.get(narrow) != per_step * logged["steps"]
            or train_counts.get(long) != per_step * logged["steps"]
            or any(train_counts.get(k) for k in others)):
        problems.append(f"training launches {train_counts} (want {per_step} of {narrow} and "
                        f"{long} a step, none of {others})")
    if (sample_counts.get(narrow) != per_step * DIFF_SAMPLE_STEPS
            or any(sample_counts.get(k) for k in others + (long,))):
        problems.append(f"sampling launches {sample_counts} (want {per_step} of {narrow} a "
                        f"step over {DIFF_SAMPLE_STEPS}, nothing else of flash attention)")
    if tuple(out.shape) != (DIFF_SAMPLES, *cfg["model"]["kwargs"]["data_shape"], 1) or not finite:
        problems.append(f"the sample is {out.shape}, finite={finite}")
    if bad:
        problems.append(f"holds {bad}: {hold}")
    return {
        "config": f"{DEEP_GALAXY_CONFIG.name} with UNet_Diffuser and DiffusersDDPMPipeline",
        "route": route, "items": len(dataset), "dataset_s": dataset_s,
        "batch": cfg["training"]["batch_size"], "steps_per_epoch": steps_per_epoch,
        "epochs": epochs, "attention_calls_per_forward": per_step,
        "train": {**logged, "wall_s": train_wall, "max_memory_allocated": train_peak,
                  "launches": train_counts, "flash_routes": train_routes,
                  "launches_per_step": {k: c / max(logged["steps"], 1)
                                        for k, c in train_counts.items()},
                  "one_more_step_s": step_s, "profiled_step": profiled},
        "sample": {"n": DIFF_SAMPLES, "steps": DIFF_SAMPLE_STEPS, "cli_wall_s": sample_wall,
                   "launches": sample_counts, "flash_routes": sample_routes,
                   "shape": list(out.shape), "finite": finite, "std": float(out.std())},
        "hold": hold, "problems": problems,
    }


def distill_config(work: Path) -> Path:
    """The learned-variance config with its dataset cut, the flagship's
    parameter space for sampling and no cache or plot files."""
    cfg = json.loads(GAUSS_CONFIG.read_text())
    cfg["dataset"]["kwargs"]["length"] = DISTILL_LENGTH
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None,
                            parameter_space=json.loads(CONFIG.read_text())["inference"][
                                "parameter_space"])
    path = work / "learned_variance.json"
    work.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    return path


def run_distillation(work: Path, device) -> dict:
    """The distill CLI's cascade on the learned-variance config from a
    seeded random teacher (.pth), then the inference CLI's trailing DDIM on
    the student; each path's counts against a training step's forward
    (three forwards and one backward an update); one update's loss and
    student gradients held against the fp32 plain model; an update's time
    beside a training step's at the same batch."""
    import numpy as np
    import torch

    from rho_diffusion_tpu_torch import inference
    from rho_diffusion_tpu_torch.config import ExperimentConfig
    from rho_diffusion_tpu_torch.data.loader import DataLoader, to_device
    from rho_diffusion_tpu_torch.diffusion.distill import ProgressiveDistiller
    from rho_diffusion_tpu_torch.distill import main as distill_main
    from rho_diffusion_tpu_torch.registry import registry

    path = distill_config(work)
    cfg = json.loads(path.read_text())
    config = ExperimentConfig.from_json(path)
    dataset = registry.get("datasets", config.dataset.name)(**config.dataset.kwargs)
    sd = random_state_dict(data_pipeline(cfg, dataset, "float32", "cpu").backbone, seed=1)
    teacher = work / "teacher.pth"
    torch.save(sd, teacher)
    student_file = work / "student.pth"
    updates = DISTILL_UPDATES * int(math.log2(DISTILL_FROM // DISTILL_TO))
    torch.cuda.empty_cache()
    (student, info), cli_wall, cli_counts, _ = counted(lambda: distill_main(
        [str(path), "-p", str(teacher), "--from", str(DISTILL_FROM), "--to", str(DISTILL_TO),
         "--updates", str(DISTILL_UPDATES), "-o", str(student_file), "-d", DEVICE,
         "--work-dir", str(work)]))
    del student
    torch.cuda.empty_cache()
    out, sample_wall, sample_counts, _ = counted(lambda: inference.main(
        [str(path), "-p", str(student_file), "-n", str(DISTILL_SAMPLES), "-d", DEVICE, "-f",
         "--sampler", "ddim", "--steps", str(DISTILL_TO), "--spacing", "trailing",
         "--work-dir", str(work)]))

    # a training step's launches (one forward, one backward) at the CLI's batch
    fast = data_pipeline(cfg, dataset, "bfloat16", device)
    fast.load_state_dict(sd)
    batch = to_device(next(iter(DataLoader(dataset, batch_size=cfg["training"]["batch_size"],
                                           num_workers=0))), device)
    ts = fast.create_state(0)
    fast.training_step(ts, batch)
    step_metrics, _, step_counts, _ = counted(lambda: fast.training_step(ts, batch))
    del ts
    fast.load_state_dict(sd)  # the steps trained the pipeline's own backbone
    # the fp32 head (Cout 2) takes the 3xTF32 conv and its weight pre-pass
    forward = ("flash_attention", "conv3d_igemm", "conv3d_direct", "conv3d_tf32",
               "conv3d_weight_split")
    backward = ("flash_attention_bwd", "flash_attention_bwd_delta", "conv3d_dgrad_igemm",
                "conv3d_dgrad_direct")
    want = {**{k: 3 * step_counts.get(k, 0) * updates for k in forward},
            **{k: step_counts.get(k, 0) * updates for k in backward}}
    problems = []
    if any(cli_counts.get(k, 0) != n for k, n in want.items()) or not all(
            step_counts.get(k) for k in ("flash_attention", "flash_attention_bwd",
                                         "conv3d_igemm", "conv3d_dgrad_igemm")):
        problems.append(f"distill launches {cli_counts}, want {want} (a training step's "
                        f"{step_counts}: three forwards and one backward an update)")
    losses = [x for v in info.values() for x in v]
    if list(info) != [f"{DISTILL_FROM}->{DISTILL_FROM // 2}", f"{DISTILL_FROM // 2}->{DISTILL_TO}"] \
            or not np.isfinite(losses).all():
        problems.append(f"stages {info}")
    finite = bool(np.isfinite(out).all())
    if not sample_counts.get("flash_attention") or not finite or tuple(out.shape) != (
            DISTILL_SAMPLES, *cfg["model"]["kwargs"]["data_shape"], 1):
        problems.append(f"student sample {out.shape}, finite={finite}, launches {sample_counts}")

    # one update's loss and student gradients on the kernels against the
    # fp32 plain model, beside the bf16 plain model. The student has weights
    # of its own: at the teacher's (a stage's start) the loss is the
    # rounding-sized gap between one student step and two teacher steps,
    # and its gradients differ by O(1) between any two roundings
    ref = data_pipeline(cfg, dataset, "float32", device)
    ref.load_state_dict(sd)
    student_sd = random_state_dict(ref.backbone, seed=2)
    hb = DIFF_HOLD_BATCH
    hold_batch = {"data": batch["data"][:hb], "labels": batch["labels"][:hb]}
    gen = torch.Generator().manual_seed(8)
    j = torch.randint(0, DISTILL_FROM // 2, (hb,), generator=gen).to(device)
    noise = torch.randn(hold_batch["data"].shape, generator=gen).to(device)

    def update_grads(pipe):
        student = copy.deepcopy(pipe.backbone)
        student.load_state_dict(student_sd)
        loss = ProgressiveDistiller(pipe).stage_loss(student, pipe.backbone, hold_batch,
                                                     DISTILL_FROM, j=j, noise=noise)
        loss.backward()
        return loss.detach().float(), {n: p.grad.float() for n, p in student.named_parameters()}

    got_loss, got_grads = update_grads(fast)
    with plain_backends():
        bf16_loss, bf16_grads = update_grads(fast)
        fp32_loss, fp32_grads = update_grads(ref)
    hold = hold_rows({"forward": got_loss}, {"forward": bf16_loss}, {"forward": fp32_loss},
                     HOLD_CAP)
    hold = {"update_loss": {**hold["forward"], "cap_of": "HOLD_CAP['forward']"}}
    k_dist, k_name, k_worst = grad_distance(got_grads, fp32_grads)
    p_dist, _, _ = grad_distance(bf16_grads, fp32_grads)
    row = {"metric": "relative L2 over all student gradients", "kernels_vs_fp32_plain": k_dist,
           "bf16_plain_vs_fp32_plain": p_dist,
           "worst_parameter_kernels": {"name": k_name, "rel_l2": k_worst},
           "bar": min(HOLD_FACTOR * p_dist, HOLD_CAP["train_gradients"])}
    row["ok"] = k_dist <= row["bar"] and all(bool(torch.isfinite(g).all())
                                             for g in got_grads.values())
    hold["update_gradients"] = row
    bad = [k for k, v in hold.items() if not v["ok"]]
    if bad:
        problems.append(f"distill holds {bad}: {hold}")
    del ref, got_grads, bf16_grads, fp32_grads
    torch.cuda.empty_cache()

    # an update of the CLI's own loop (ProgressiveDistiller.distill_stage:
    # two teacher forwards, the student's forward and backward, AdamW at the
    # stage's learning rate) against a training step, at the CLI's batch, in
    # turns; the card's clocks and the allocator after each turn
    d = ProgressiveDistiller(fast)
    gen = torch.Generator(device=device).manual_seed(9)

    def stage(updates):
        return lambda: d.distill_stage(fast.backbone, [batch], DISTILL_FROM, updates,
                                       generator=gen)

    ts = fast.create_state(1)
    times = {"stage_ms": [], f"stage_{1 + DISTILL_TIMED}_ms": [], "update_ms": [],
             "train_step_ms": [], "train_step_busy_ms": [], "card": []}
    for _ in range(2):
        one = cuda_time_ms(stage(1), iters=2, warmup=1)
        more = cuda_time_ms(stage(1 + DISTILL_TIMED), iters=1, warmup=0)
        times["stage_ms"].append(one)
        times[f"stage_{1 + DISTILL_TIMED}_ms"].append(more)
        times["update_ms"].append((more - one) / DISTILL_TIMED)
        times["train_step_ms"].append(cuda_time_ms(lambda: fast.training_step(ts, batch),
                                                   iters=5, warmup=1))
        times["card"].append(card_state())
        by_name = device_time_by_kernel(lambda: fast.training_step(ts, batch))
        times["train_step_busy_ms"].append(profile_summary(by_name)["busy_ms"] if by_name
                                           else None)
    del fast, ts, batch
    torch.cuda.empty_cache()
    return {
        "config": GAUSS_CONFIG.name, "batch": cfg["training"]["batch_size"],
        "cascade": f"{DISTILL_FROM} -> {DISTILL_TO}, {DISTILL_UPDATES} updates a stage",
        "stage_losses": info, "cli_wall_s": cli_wall, "launches": cli_counts,
        "launches_per_update": {k: c / updates for k, c in cli_counts.items()},
        "training_step_launches": step_counts,
        "training_step_loss": float(step_metrics["train_loss"]),
        "sample": {"n": DISTILL_SAMPLES, "steps": DISTILL_TO, "spacing": "trailing",
                   "cli_wall_s": sample_wall, "launches": sample_counts, "finite": finite,
                   "shape": list(out.shape)},
        "hold": hold, **times,
        "update_ms_of": (f"distill_stage at {1 + DISTILL_TIMED} updates less at 1, over "
                         f"{DISTILL_TIMED}"),
        "update_over_train_step": min(times["update_ms"]) / min(times["train_step_ms"]),
        "problems": problems,
    }


def phase_diffusers(state: dict) -> None:
    """The diffusers-compatible backbone and pipeline and progressive
    distillation on the card. (a) UNet_Diffuser under DiffusersDDPMPipeline
    on DeepGalaxy's config at full width (128^2, batch 64, bf16): training
    steps, the inference CLI's DDIM sample, holds against the fp32 plain
    model (``run_diffusers_backbone``); its attention (8 heads of 8 at T 4096
    and 1024) on the narrow forward and the long backward only, 11 of each a
    step, held on the whole batch, twice bitwise, and timed at the full batch
    (``flash_fwd_row``, ``flash_bwd_rows``: the mma.sync pair the long kernel
    replaced beside it) and the long backward's memory at T 4096. (b) The distill CLI on the
    learned-variance config and the inference CLI on its student
    (``run_distillation``): K5, K1 and the fused K3/K4 on its path."""
    import importlib.util

    import torch

    device = torch.device(DEVICE)
    route = "hdf5" if importlib.util.find_spec("h5py") is not None else "memory"
    t0 = time.perf_counter()
    seconds, launches, problems = {}, {}, []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_diffusers_"))
    try:
        backbone = run_diffusers_backbone(tmp / "backbone", route, device)
        seconds["backbone"] = time.perf_counter() - t0
        launches["diffusers_train"] = backbone["train"]["launches"]
        launches["diffusers_sample"] = backbone["sample"]["launches"]
        problems += [f"backbone: {p}" for p in backbone["problems"]]
        emit("diffusers_backbone", **backbone, cuts=DIFF_CUTS, seconds=seconds["backbone"])
        distill = run_distillation(tmp / "distill", device)
        seconds["distill"] = time.perf_counter() - t0 - sum(seconds.values())
        launches["distill_cli"] = distill["launches"]
        launches["distill_sample"] = distill["sample"]["launches"]
        problems += [f"distill: {p}" for p in distill["problems"]]
        emit("diffusers_distill", **distill, seconds=seconds["distill"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = []
    for (b, t, h, d), calls in DIFF_ATTENTION:
        per = f"one UNet_Diffuser training step at batch {b} ({calls} calls at T={t})"
        variant = (f"UNet_Diffuser at DeepGalaxy's 128^2: T={t}, D={d} (padded to 16), "
                   f"B*H={b * h}, {per}")
        rows.append(flash_fwd_row(b, t, h, d, calls, per, device, torch.bfloat16,
                                  variant=variant, plain_rows=DIFF_PLAIN_ROWS, full_check=True))
        rows += flash_bwd_rows(b, t, h, d, calls, per, device, torch.bfloat16, variant=variant,
                               plain_rows=DIFF_PLAIN_ROWS, full_check=True)
        torch.cuda.empty_cache()
    memory = long_bwd_memory_hold(*DIFF_MEMORY, device)
    if not memory["ok"]:
        problems.append(f"long backward memory at D 8: {memory}")
    seconds["kernel_rows"] = time.perf_counter() - t0 - sum(seconds.values())
    record_errors(state, rows)
    state["diffusers"] = rows
    state["diffusers_launches"] = launches
    emit("diffusers", kernel_rows=rows, long_bwd_memory=memory, seconds=seconds,
         wall_s=time.perf_counter() - t0)
    fail_bad("diffusers", rows)
    if problems:
        fail("diffusers: " + "; ".join(problems))


# the quality phase: each 3-D Y_lm harness with its budget cut (its knobs
# over the JAX script's defaults), and every sampler capped at
# QUALITY_MAX_STEPS steps (YLM_MAX_STEPS)
QUALITY_MAX_STEPS = 10
QUALITY_RUNS = (
    ("sampler_quality", {"QUAL_STEPS": "20"}),
    ("ema_ablation", {"EMA_STEPS": "20"}),
    ("demo_min_snr", {"DEMO_STEPS": "20"}),
    ("demo_cfg", {"DEMO_STEPS": "20"}),
    ("sh_holdout", {"SH_STEPS": "20"}),
    ("demo_distill", {"DEMO_STEPS": "20", "DEMO_FROM": "8", "DEMO_UPDATES": "3"}),
    ("vit_ab", {"VIT_AB_WALL": "3"}),
    ("demo64", {"DEMO_STEPS": "2"}),
)
QUALITY_KNOBS = ("QUAL_", "SQ_", "EMA_", "DEMO_", "SH_", "VIT_AB_", "YLM_")
# the batches the harnesses train the 16^3 UNet at, whose step is timed
QUALITY_STEP_BATCHES = (8, 16)
# attention shapes of the harnesses that no other phase holds: (b, t, h, d),
# calls a forward, and the run they are the shapes of
QUALITY_ATTENTION = (((8, 256, 4, 64), 6, "the 16^3 harness UNet at batch 8"),
                     ((8, 64, 8, 32), 8, "vit_ab's ViT at patch 4, batch 8"))
# the kernels each harness's run must launch (every one trains the 16^3
# UNet but vit_ab's ViT half and demo64, whose flagship runs K2 at 4096
# tokens); the flash forward's routes by key length
UNET_KERNELS = ("conv3d_igemm", "conv3d_dgrad_igemm", "conv3d_direct", "conv3d_dgrad_direct",
                "flash_attention", "flash_attention_bwd", "flash_attention_bwd_delta")
QUALITY_KERNELS = {
    "sampler_quality": UNET_KERNELS + ("conv3d_s8", "conv3d_s8_strided", "quantize_int8_amax",
                                       "quantize_int8"),
    "vit_ab": UNET_KERNELS + ("flash_attention_fwd_narrow", "flash_attention_bwd_small"),
}
QUALITY_ROUTES = {"demo64": ("wgmma Tk=4096",), "vit_ab": ("wgmma Tk=256", "narrow Tk=64")}
QUALITY_CUTS = {
    "budgets": {name: env for name, env in QUALITY_RUNS},
    "YLM_MAX_STEPS": f"{QUALITY_MAX_STEPS}: every sampler's steps (DDPM-1000, DDIM-50, "
                     "DDIM-100 and dpm++-15 among them) capped",
    "widths": "as published: the 16^3 UNet (width 64, mult 1/2/4, 4 heads at ds 4), the ViT "
              "(patch 4, 256 wide, 8 heads, depth 8), the 64^3 flagship at batch 8",
}


def harness_kernel_rows(device) -> list:
    """The kernels at the harnesses' shapes no other phase gives them: K1
    and the fused K3/K4 at the 16^3 UNet's batch 8 (B*H 32) and the narrow
    forward and small backward at vit_ab's ViT (D 32, T 64), each held and
    timed (``flash_fwd_row``, ``flash_bwd_rows``); every conv problem of the
    16^3 UNet's forward and dgrad at batch 8 held (K5, the direct kernel);
    and under int8 its S1, strided S1 and S2 problems and its quantiser's
    shapes held bitwise and timed (``int8_conv_row``, ``quantize_rows_row``).
    Every row is a variant: the kernels line's main rows stay the timings
    phase's."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks import _ylm
    from rho_diffusion_tpu_torch.ops.quant import conv_quant
    from rho_diffusion_tpu_torch.registry import registry

    rows = []
    for (b, t, h, d), calls, what in QUALITY_ATTENTION:
        per = f"one forward of {what} ({calls} attention calls)"
        variant = f"{what}: T={t}, D={d}, B*H={b * h}"
        rows.append(flash_fwd_row(b, t, h, d, calls, per, device, torch.bfloat16,
                                  variant=variant))
        rows += flash_bwd_rows(b, t, h, d, calls, per, device, torch.bfloat16, variant=variant)
    batch = QUALITY_STEP_BATCHES[0]
    variant = f"the 16^3 harness UNet at batch {batch}"
    unet = registry.get("models", "UNetv2")(**_ylm.backbone_kwargs(16))
    unet.load_state_dict(random_state_dict(unet, 7))
    unet.to(device).eval()
    holds = (hold_convs(unet, batch, "forward", device, seed=700, timed=False)
             + hold_convs(unet, batch, "dgrad", device, seed=800, timed=False))
    x, t, y = unet_inputs(unet, batch, device, seed=2)
    with Int8Sites() as rec, conv_quant("int8"), torch.no_grad():
        unet(x, t, y)
    torch.cuda.synchronize()
    del unet
    problems, acts = int8_problems(rec.calls)
    per = f"one int8 forward of {variant}"
    for i, ((route, xs, cout, ks, st, pads, odt), n) in enumerate(sorted(problems.items(),
                                                                        key=str)):
        rows.append(int8_conv_row(route, xs, cout, ks, st, pads, odt, device, 900 + 7 * i, n,
                                  per, variant=variant))
    for i, ((xs, dt), n) in enumerate(sorted(acts.items(), key=str)):
        rows += quantize_rows_row(xs, dt, device, 990 + i, n, per, variant=variant)
    torch.cuda.empty_cache()
    return [{**r, "variant": r.get("variant") or variant} for r in holds] + rows


def harness_step_times(device) -> dict:
    """The 16^3 harness UNet's DDPM training step (``_ylm``'s model, AdamW,
    EMA) at each of QUALITY_STEP_BATCHES: its time from CUDA events over 10
    steps after 2, the device's busy time of one profiled step, and the
    card's state after."""
    import torch

    from rho_diffusion_tpu_torch.benchmarks import _ylm
    from rho_diffusion_tpu_torch.data.loader import DataLoader, to_device
    from rho_diffusion_tpu_torch.diffusion import DDPM

    pipe = DDPM("UNetv2", _ylm.backbone_kwargs(16), _ylm.schedule(), optimizer="AdamW",
                opt_kwargs={"lr": 1e-4}, ema_decay=0.9999, device=device, seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(16, 64)
    out = {}
    for b in QUALITY_STEP_BATCHES:
        batch = to_device(next(iter(DataLoader(dset, batch_size=b, num_workers=0))), device)
        ms = cuda_time_ms(lambda: pipe.training_step(state, batch), iters=10, warmup=2)
        by_name = device_time_by_kernel(lambda: pipe.training_step(state, batch))
        summary = profile_summary(by_name) if by_name else NOT_PROFILED
        out[f"batch_{b}"] = {"step_ms": ms, "busy_ms": summary.get("busy_ms"),
                             "launches": summary.get("launches"),
                             "busy_share": summary["busy_ms"] / ms if by_name else None,
                             "card": card_state()}
    del pipe, state
    torch.cuda.empty_cache()
    return out


def finite_flags(report) -> list:
    """Every ``finite`` value anywhere in a harness report."""
    if isinstance(report, dict):
        return [v for k, v in report.items() if k == "finite"] + [
            f for v in report.values() for f in finite_flags(v)]
    if isinstance(report, list):
        return [f for v in report for f in finite_flags(v)]
    return []


def phase_quality(state: dict) -> None:
    """The eight 3-D Y_lm harnesses on the card through their entry points,
    budgets cut (QUALITY_RUNS, QUALITY_MAX_STEPS): each report's keys, its
    samples finite, its launches (QUALITY_KERNELS, QUALITY_ROUTES) and, for
    demo64 at batch 8 without recomputation, the allocator's peak; then the
    16^3 UNet's training step timed and profiled at batch 8 and 16, and the
    kernels held (and the flash and int8 ones timed) at the harnesses'
    shapes no other phase gives them (``harness_kernel_rows``)."""
    import importlib

    import torch

    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    t0 = time.perf_counter()
    total, runs, problems = {}, {}, []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        for name, env in QUALITY_RUNS:
            module = importlib.import_module(f"rho_diffusion_tpu_torch.benchmarks.{name}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with bench_env({**env, "YLM_MAX_STEPS": str(QUALITY_MAX_STEPS)},
                           prefix=QUALITY_KNOBS):
                report, wall, counts, routes = counted(lambda: module.main(
                    ["-d", DEVICE, "--work-dir", str(tmp / name)]))
            launch_counts.clear()
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            missing_keys = sorted(set(module.REPORT_KEYS) - set(report))
            flags = finite_flags(report)
            unlaunched = [k for k in QUALITY_KERNELS.get(name, UNET_KERNELS) if not counts.get(k)]
            unrouted = [r for r in QUALITY_ROUTES.get(name, ("wgmma Tk=256",)) if not routes.get(r)]
            runs[name] = {"wall_s": wall, "launches": counts, "flash_routes": routes,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "train_steps_per_s": report.get("train_steps_per_s"),
                          "finite_flags": len(flags), "s2_launches": counts.get(
                              "conv_s8_general", 0)}
            if name == "demo64":
                runs[name].update({k: report[k] for k in ("train_peak_bytes", "peak_bytes",
                                                          "use_checkpoint", "batch",
                                                          "sinkhorn_generated_vs_real")})
            if name == "sampler_quality":
                runs[name]["rows"] = report["rows"]
            if missing_keys or not flags or not all(flags) or unlaunched or unrouted:
                problems.append(f"{name}: missing keys {missing_keys}, finite {flags}, "
                                f"unlaunched {unlaunched}, unrouted {unrouted}")
            if counts.get("conv_s8_general"):
                problems.append(f"{name}: S2 launched {counts['conv_s8_general']} times")
            emit("quality_run", harness=name, env=env, **runs[name])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["quality_launches"] = total
    device = torch.device(DEVICE)
    steps = harness_step_times(device)
    rows = harness_kernel_rows(device)
    record_errors(state, rows)
    state["quality"] = [r for r in rows if r.get("calls")]
    emit("quality", runs={k: {f: v[f] for f in ("wall_s", "peak_bytes", "train_steps_per_s")}
                          for k, v in runs.items()},
         launches=total, step_16cubed=steps, kernel_rows=rows, cuts=QUALITY_CUTS,
         wall_s=time.perf_counter() - t0)
    fail_bad("quality", rows)
    if problems:
        fail("quality: " + "; ".join(problems))


# the quality_2d1d phase: the six 2-D/1-D harnesses with their budgets cut
# (their knobs over the JAX scripts' defaults), every sampler capped at
# CORPUS_RUN_STEPS steps (CORPUS_MAX_STEPS); the probe and the rescore read
# the reference runs' directories
CORPUS_RUN_STEPS = 10
CORPUS_RUNS = (
    ("demo_galaxy2d", {"DEMO_RECIPE": "reference", "DEMO_EPOCHS": "2"}),
    ("demo_galaxy2d", {"DEMO_RECIPE": "zero_snr", "DEMO_EPOCHS": "2"}),
    ("galaxy_dc_probe", {}),
    ("demo_spectro1d", {"DEMO_EPOCHS": "2"}),
    ("spectro_rescore", {}),
    ("demo_generalization", {"GEN_COND": "fourier", "GEN_EPOCHS": "1"}),
    ("demo_spectro_cond", {"SPECTRO_COND": "fourier", "SPECTRO_EPOCHS": "2"}),
    ("demo_spectro_cond", {"SPECTRO_COND": "embed", "SPECTRO_EPOCHS": "2"}),
)
CORPUS_KNOBS = ("DEMO_", "GALAXY_", "RESCORE_", "GEN_", "SPECTRO_", "CORPUS_")
# the flash forward's route and key length in each family's UNet (attention
# at ds 8: 16^2 tokens of the 128^2 frames, 128 of the 1024-point spectra)
CORPUS_ROUTES = {"galaxy": "wgmma Tk=256", "spectro": "wgmma Tk=128"}
CORPUS_FWD_CALLS = 6  # attention blocks a forward: 2 encoder, the middle, 3 decoder
CORPUS_ATTENTION = (((25, 256, 4, 64), "the DeepGalaxy UNet at batch 25"),
                    ((30, 256, 4, 64), "the DeepGalaxy UNet at batch 30"),
                    ((16, 128, 4, 64), "the Spectroscopy UNet at grid 1024, batch 16"))
# the training harnesses whose step is timed: (module, its knobs)
CORPUS_STEP_RUNS = (("demo_galaxy2d", {}), ("demo_spectro1d", {}),
                    ("demo_generalization", {}), ("demo_spectro_cond", {}))
CORPUS_CUTS = {
    "budgets": [{"harness": name, **env} for name, env in CORPUS_RUNS],
    "CORPUS_MAX_STEPS": f"{CORPUS_RUN_STEPS}: every sampler's steps (DDPM-500 and -1000, "
                        "DDIM-100 and -50 among them) capped",
    "widths": "as published: config_deep_galaxy.json (128^2, width 32, 4 heads of 64 at "
              "ds 8) at batch 25 and 30, config_spectroscopy.json at grid 1024 (width 32) "
              "at batch 16",
    "demo_generalization": "its default conditioner (fourier) alone: embed is the config's "
                           "MultiEmbeddings, which demo_galaxy2d's runs train; both are held "
                           "on the CPU (tests/test_torch_corpus_slice.py)",
}


def corpus_kernel_rows(device) -> list:
    """K1 and the fused K3/K4 at the 2-D/1-D harnesses' attention shapes
    (CORPUS_ATTENTION), held against their plain versions and timed beside
    SDPA (``flash_fwd_row``, ``flash_bwd_rows``); every row a variant."""
    import torch

    rows = []
    for (b, t, h, d), what in CORPUS_ATTENTION:
        per = f"one forward of {what} ({CORPUS_FWD_CALLS} attention calls)"
        variant = f"{what}: T={t}, D={d}, B*H={b * h}"
        rows.append(flash_fwd_row(b, t, h, d, CORPUS_FWD_CALLS, per, device, torch.bfloat16,
                                  variant=variant))
        rows += flash_bwd_rows(b, t, h, d, CORPUS_FWD_CALLS, per, device, torch.bfloat16,
                               variant=variant)
        torch.cuda.empty_cache()
    return rows


def corpus_step_times(device) -> dict:
    """Each training harness's step at its published width and batch, on
    its in-memory corpus: CUDA-event time over 10 steps after 2, the
    device's busy time of one profiled step, the card's state after."""
    import importlib

    import torch

    from rho_diffusion_tpu_torch.benchmarks import _corpus
    from rho_diffusion_tpu_torch.data.loader import DataLoader, to_device
    from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config

    out = {}
    for name, env in CORPUS_STEP_RUNS:
        module = importlib.import_module(f"rho_diffusion_tpu_torch.benchmarks.{name}")
        with bench_env(env, prefix=CORPUS_KNOBS):
            s = module.settings()
            cfg = module.config(s)
        kwargs = cfg.dataset.kwargs
        if name in ("demo_galaxy2d", "demo_generalization"):
            dset = _corpus.GalaxyFrames(kwargs, **module.corpus(False))
        else:
            dset = _corpus.RotorSpectra(kwargs, n_molecules=s["molecules"], seed=0)
        pipe = build_pipeline_from_config(cfg, dataset=dset, device=device)
        state = pipe.create_state(cfg.training.seed)
        b = cfg.training.batch_size
        batch = to_device(next(iter(DataLoader(dset, batch_size=b, num_workers=0))), device)
        ms = cuda_time_ms(lambda: pipe.training_step(state, batch), iters=10, warmup=2)
        by_name = device_time_by_kernel(lambda: pipe.training_step(state, batch))
        summary = profile_summary(by_name) if by_name else NOT_PROFILED
        out[name] = {"batch": b, "pipeline": type(pipe).__name__, "step_ms": ms,
                     "busy_ms": summary.get("busy_ms"), "launches": summary.get("launches"),
                     "busy_share": summary["busy_ms"] / ms if by_name else None,
                     "card": card_state()}
        del pipe, state
        torch.cuda.empty_cache()
    return out


def corpus_launch_problems(name: str, counts: dict, routes: dict, trains: bool) -> list:
    """What is wrong with one harness run's launches: K1 six a forward on its
    family's route only, the fused backward and its pre-pass once for each
    K1 launch of a training forward (none without training), no pair."""
    fwd, bwd = counts.get("flash_attention", 0), counts.get("flash_attention_bwd", 0)
    family = "galaxy" if "galaxy" in name or "generalization" in name else "spectro"
    problems = []
    if not fwd or fwd % CORPUS_FWD_CALLS:
        problems.append(f"K1 launched {fwd} times, not a positive multiple of "
                        f"{CORPUS_FWD_CALLS}")
    if set(routes) != {CORPUS_ROUTES[family]}:
        problems.append(f"flash routes {routes}, expected {CORPUS_ROUTES[family]} alone")
    if bwd != counts.get("flash_attention_bwd_delta", 0) or bwd % CORPUS_FWD_CALLS \
            or bwd >= fwd or (trains and not bwd) or (not trains and bwd):
        problems.append(f"fused backward {bwd} and pre-pass "
                        f"{counts.get('flash_attention_bwd_delta', 0)} against K1 {fwd}")
    for pair in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        if counts.get(pair):
            problems.append(f"{pair} launched {counts[pair]} times")
    return problems


def phase_quality_2d1d(state: dict) -> None:
    """The six 2-D/1-D quality harnesses on the card through their entry
    points, budgets cut (CORPUS_RUNS, CORPUS_RUN_STEPS): each report's keys,
    its samples finite, its corpus built in memory (the card's host has no
    h5py), its launches (``corpus_launch_problems``); then each training
    harness's step timed and profiled, and K1 and the fused K3/K4 held and
    timed at the harnesses' attention shapes."""
    import importlib

    import torch

    from rho_diffusion_tpu_torch.benchmarks import _corpus
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    t0 = time.perf_counter()
    total, runs, problems, seconds = {}, [], [], {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_2d1d_"))
    dirs = {"GALAXY_WORKDIR": str(tmp / "demo_galaxy2d" / "reference"),
            "RESCORE_WORKDIR": str(tmp / "demo_spectro1d" / "reference")}
    try:
        for name, env in CORPUS_RUNS:
            module = importlib.import_module(f"rho_diffusion_tpu_torch.benchmarks.{name}")
            torch.cuda.empty_cache()
            with bench_env({**env, **dirs, "CORPUS_MAX_STEPS": str(CORPUS_RUN_STEPS)},
                           prefix=CORPUS_KNOBS):
                report, wall, counts, routes = counted(lambda: module.main(
                    ["-d", DEVICE, "--work-dir", str(tmp / name)]))
            launch_counts.clear()
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            trains = report["train_steps_per_s"] is not None
            flags = finite_flags(report)
            missing = sorted(set(module.REPORT_KEYS) - set(report))
            bad = corpus_launch_problems(name, counts, routes, trains)
            if missing or not flags or not all(flags) or report["corpus_route"] != "memory":
                bad.append(f"missing keys {missing}, finite {flags}, route "
                           f"{report['corpus_route']}")
            run = {"harness": name, "env": env, "wall_s": wall, "launches": counts,
                   "flash_routes": routes, "train_steps_per_s": report["train_steps_per_s"],
                   "corpus_route": report["corpus_route"],
                   "quality": {k: report[k] for k in report if k not in (
                       "device", "train_steps_per_s", "corpus_route", "finite", "plots",
                       "trainer_dir", "weights")}}
            runs.append(run)
            seconds[f"{name} {' '.join(env.values())}".strip()] = wall
            if bad:
                problems.append(f"{name} {env}: " + "; ".join(bad))
            emit("quality_2d1d_run", **run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["quality_2d1d_launches"] = total
    device = torch.device(DEVICE)
    t1 = time.perf_counter()
    try:
        steps = corpus_step_times(device)  # on the corpora the runs rendered
    finally:
        _corpus.clear_cache()
    seconds["step_times"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rows = corpus_kernel_rows(device)
    seconds["kernel_rows"] = time.perf_counter() - t1
    record_errors(state, rows)
    state["quality_2d1d"] = [r for r in rows if r.get("calls")]
    emit("quality_2d1d", launches=total, steps=steps, kernel_rows=rows, cuts=CORPUS_CUTS,
         seconds=seconds, wall_s=time.perf_counter() - t0)
    fail_bad("quality_2d1d", rows)
    if problems:
        fail("quality_2d1d: " + "; ".join(problems))


KERNELS = (
    # K5's implicit GEMM: the kernel in conv3d_wgmma.cuh, its launcher in conv3d.cu
    ("conv3d_igemm", "conv3d_wgmma.cuh", "rho_diffusion_tpu/ops/pallas/conv3d.py:102",
     "sampling"),
    ("conv3d_direct", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:102", "sampling"),
    # one CUDA kernel replaces both TPU forward kernels (K1 one-pass, K2
    # multi-block, :59): its K/V-tile loop runs 4 times at T=512, 32 at T=4096
    # (128-key tiles); the launcher is in flash_attention.cu
    ("flash_attention", "flash_attention_wgmma.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:115", "sampling"),
    # the narrow forward (bf16 at D = 16, 32): one kernel for both TPU
    # forward kernels a call at every T, the ViT's forward (the vit phase's
    # bench entry at 64 tokens; its patch-4 run at 512 runs it too); its
    # launcher is in flash_attention.cu
    ("flash_attention_fwd_narrow", "flash_attention_fwd_narrow.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:115", "vit_bench"),
    ("conv3d_dgrad_igemm", "conv3d_wgmma.cuh", "rho_diffusion_tpu/ops/pallas/conv3d.py:247",
     "training"),
    ("conv3d_dgrad_direct", "conv3d.cu", "rho_diffusion_tpu/ops/pallas/conv3d.py:247", "training"),
    # one fused CUDA kernel replaces both TPU backward kernels (K3 dK/dV,
    # and K4 dQ, :262) for bf16 at D = 64 and 128; its launcher is in
    # flash_attention_bwd.cu
    ("flash_attention_bwd", "flash_attention_bwd_wgmma.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "training"),
    # its delta pre-pass, where the TPU path leaves rowsum(dO O) to XLA
    ("flash_attention_bwd_delta", "flash_attention_bwd_wgmma.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:308", "training"),
    # the small backward (bf16 at D = 16, 32 with T <= 64): one kernel for
    # both TPU backward kernels (and delta) a call, the ViT's backward at
    # head dim 16 over 64 patches (the vit phase's bench entry); its
    # launcher is in flash_attention_bwd.cu
    ("flash_attention_bwd_small", "flash_attention_bwd_small.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "vit_bench"),
    # the long backward (bf16 at D = 16, 32 past T = 64): one kernel for
    # both TPU backward kernels (and delta) a call, the ViT's backward at
    # patch 4 (512 tokens, the vit phase's patch-4 run); its launcher is in
    # flash_attention_bwd.cu
    ("flash_attention_bwd_long", "flash_attention_bwd_long.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "vit_patch4"),
    # the mma.sync and FMA pairs (bf16 at D = 256, fp32 at D = 16, 32, 256)
    # run on no main path: their launches are the kernels phase's holds
    # (the pair on request beside each route that replaced it); their
    # times the pair's on request at the ViT's patch-4 attention
    ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "kernels"),
    ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:262", "kernels"),
    # K6: one launch per device folds every rank's K/V shard in the ring's
    # order (the ring's host side: parallel/context_rdma.py)
    ("ring_attention", "ring_attention.cu", "rho_diffusion_tpu/parallel/context_rdma.py:50",
     "serving"),
    # fp32 on the tensor cores (3xTF32), the fp32 flagship's path: K5's
    # block with split operands (conv3d_tf32.cuh, launched from conv3d.cu)
    # after its weight pre-pass; K6's fold (ring_attention_tf32.cuh, launched
    # from ring_attention.cu) after its K/V pre-pass
    ("conv3d_tf32", "conv3d_tf32.cuh", "rho_diffusion_tpu/ops/pallas/conv3d.py:102", "fp32"),
    ("conv3d_dgrad_tf32", "conv3d_tf32.cuh", "rho_diffusion_tpu/ops/pallas/conv3d.py:247",
     "fp32"),
    ("conv3d_weight_split", "conv3d_tf32.cuh", "rho_diffusion_tpu/ops/pallas/conv3d.py:102",
     "fp32"),
    ("ring_attention_tf32", "ring_attention_tf32.cuh",
     "rho_diffusion_tpu/parallel/context_rdma.py:50", "fp32"),
    ("ring_attention_tf32_split", "ring_attention_tf32.cuh",
     "rho_diffusion_tpu/parallel/context_rdma.py:50", "fp32"),
    # the fp32 flash forward at head dims 64/128: K6's fold with one shard
    # (launched from flash_attention.cu as flash_fwd_tf32_kernel) after its
    # K/V pre-pass; the backward: a 3xTF32 dkv/dq pair after its q/dO/k/v
    # pre-pass (flash_attention_bwd_tf32.cuh, launched from
    # flash_attention_bwd.cu)
    ("flash_attention_tf32", "ring_attention_tf32.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:115", "fp32"),
    ("flash_attention_tf32_split", "ring_attention_tf32.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:115", "fp32"),
    ("flash_attention_bwd_tf32_dkv", "flash_attention_bwd_tf32.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "fp32"),
    ("flash_attention_bwd_tf32_dq", "flash_attention_bwd_tf32.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:262", "fp32"),
    ("flash_attention_bwd_tf32_split", "flash_attention_bwd_tf32.cuh",
     "rho_diffusion_tpu/ops/pallas/flash_attention.py:209", "fp32"),
    # K7-K9: K5's block (conv3d_wgmma.cuh) with one factor changed, launched
    # from conv3d_variants.cu and run by the bottleneck-isolation entry; K8
    # is two kernels, the patch matrix and its dense GEMM
    ("conv3d_variant_full", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:51", "bench"),
    ("conv3d_variant_nopatch", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:51",
     "bench"),
    ("conv3d_variant_nodma", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:51", "bench"),
    ("conv3d_bigdot_im2col", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:104",
     "bench"),
    ("conv3d_bigdot_gemm", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:104", "bench"),
    ("conv3d_dotsonly", "conv3d_variants.cu", "benchmarks/conv3d_variants.py:154", "bench"),
    # W8A8 inference (no TPU kernel: JAX's ConvInt8 and quantize_int8 are
    # plain jnp that XLA lowers; "replaces" names those lines): S1, the s8
    # implicit GEMM on K5's block, and the strided Downsample on that block;
    # the 2-D 3x3 convs on that block at stride 1 and 2 (the 2-D config's
    # path, launched from conv2d_s8.cu and conv2d_s8_strided.cu); the 1-D
    # 3-tap convs on it at stride 1 and 2 (the 1-D config's path, launched
    # from conv1d_s8.cu and conv1d_s8_strided.cu); S2, the general int8 conv
    # (on no path: its launches are the int8 phase's S2 holds); S3, the
    # quantiser's two launches, all launched from conv_int8.cu
    ("conv3d_s8", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143", "int8"),
    ("conv3d_s8_strided", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143", "int8"),
    ("conv2d_s8", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143", "int8_2d"),
    ("conv2d_s8_strided", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143",
     "int8_2d"),
    ("conv1d_s8", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143", "int8_1d"),
    ("conv1d_s8_strided", "conv3d_s8_wgmma.cuh", "rho_diffusion_tpu/ops/quant.py:143",
     "int8_1d"),
    ("conv_s8_general", "conv_int8.cu", "rho_diffusion_tpu/ops/quant.py:143", "int8_s2"),
    ("quantize_int8_amax", "conv_int8.cu", "rho_diffusion_tpu/ops/quant.py:94", "int8"),
    ("quantize_int8", "conv_int8.cu", "rho_diffusion_tpu/ops/quant.py:96", "int8"),
)
TIME_FIELDS = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms")
# the fused backward's device time with its delta pre-pass (profiler; the
# 3xTF32 pair's: both kernels and its split pre-pass) and the wrapper's
# whole device work (CUDA graph): what SDPA's library_ms does
FUSED_BWD_FIELDS = ("ms_with_pre_pass", "wrapper_device_ms")
# a forward row's device time of SDPA (CUDA graph) and its bound's parts
FWD_FIELDS = ("library_device_ms", "bound_exp_ms", "bound_products_ms", "bound_bytes_ms")


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
    it (sampling for the forward kernels, training for the fused backward,
    the vit phase's bench entry for the small backward and its patch-4 run
    for the long one, the kernels phase's holds for the dkv/dq pairs, the
    2-D int8 CLI for the 2-D int8 convs, the 1-D one for the 1-D int8 convs,
    the int8 phase's S2 holds for S2, serving for
    K6, bench for K7-K9; every path listed), its worst error
    against its plain version over every hold of this run and that error's
    ratio to the check's tolerance (at most 1), and its times summed over
    one UNet forward (timing batch) or one training step (TRAIN_BATCH), or
    per call at the level-1 shape (K7-K9, bigdot at td 4); other dtypes, T
    and td as ``variants``."""
    launches = {"sampling": state["launches"], "sampling64": state["main64_launches"],
                "training": state["train_launches"], "serving": state["serve_launches"],
                "bench": state["bench_launches"], "kernels": state["kernels_launches"],
                "fp32": state["fp32_launches"], "load": state["load_launches"],
                "int8": state["int8_launches"], "int8_2d": state["int8_2d_launches"],
                "int8_1d": state["int8_1d_launches"], "int8_s2": state["int8_s2_launches"],
                **state["gauss_launches"], **state["vlb_launches"], **state["data_launches"],
                **state["utils_launches"], **state["vit_launches"],
                **state["diffusers_launches"], "quality": state["quality_launches"],
                "quality_2d1d": state["quality_2d1d_launches"]}
    out = []
    for name, source, replaces, path in KERNELS:
        rows = [r for r in state["timings"] + state["bench"] + state["fp32"] + state["data"]
                + state["vlb"] + state["int8"] + state["vit"] + state["diffusers"]
                + state["quality"] + state["quality_2d1d"]
                if r["kernel"] == name and r.get("calls")]
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
            "variants": [{"variant": r["variant"], **summed_times([r]),
                          **{f: r[f] * r["calls"] for f in FUSED_BWD_FIELDS + FWD_FIELDS
                             if f in r},
                          **({"flash_route": r["flash_route"], "plan": r["plan"]}
                             if "flash_route" in r else {})}
                         for r in rows if r["variant"]],
            **({"flash_route": main[0]["flash_route"], "plan": main[0]["plan"],
                "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:59",
                "launcher": "rho_diffusion_tpu_torch/csrc/flash_attention.cu",
                "launches_by_route": state["flash_routes"]}
               if name == "flash_attention" else {}),
            **({"by_problem": direct_by_problem(main, state["direct_launches"][path])}
               if name.endswith("_direct") else {}),
            **({"plan": main[0]["plan"],
                "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:262",
                "launcher": "rho_diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
                "library_ms_of": main[0]["library_ms_of"],
                **{f: sum(r[f] * r["calls"] for r in main) for f in FUSED_BWD_FIELDS},
                "library_profiled_ms": (main[0]["library_profiled_ms"] * main[0]["calls"]
                                        if main[0]["library_profiled_ms"] is not None else None),
                "library_event_ms": main[0]["library_event_ms"] * main[0]["calls"]}
               if name == "flash_attention_bwd" else {}),
            **({"flash_route": main[0]["flash_route"], "plan": main[0]["plan"],
                "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:59",
                "launcher": "rho_diffusion_tpu_torch/csrc/flash_attention.cu"}
               if name == "flash_attention_tf32" else {}),
            **({"flash_route": main[0]["flash_route"], "plan": main[0]["plan"],
                "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:59",
                "launcher": "rho_diffusion_tpu_torch/csrc/flash_attention.cu",
                "bound_of": main[0]["bound_of"], "sm_clock_mhz": main[0]["sm_clock_mhz"],
                **{f: sum(r[f] * r["calls"] for r in main)
                   for f in ("bound_exp_ms", "bound_products_ms", "bound_bytes_ms",
                             "wrapper_device_ms", "library_device_ms")},
                "library_device_ms_of": "SDPA's device time from a CUDA graph"}
               if name == "flash_attention_fwd_narrow" else {}),
            **({"launcher": "rho_diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
                "library_ms_of": main[0]["library_ms_of"],
                **{f: sum(r[f] * r["calls"] for r in main) for f in FUSED_BWD_FIELDS}}
               if name == "flash_attention_bwd_tf32_dkv" else {}),
            **({"plan": main[0]["plan"],
                "also_replaces": "rho_diffusion_tpu/ops/pallas/flash_attention.py:262",
                "launcher": "rho_diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
                "library_ms_of": main[0]["library_ms_of"],
                "wrapper_device_ms": sum(r["wrapper_device_ms"] * r["calls"] for r in main)}
               if name in ("flash_attention_bwd_small", "flash_attention_bwd_long") else {}),
            **({"bound_of": main[0]["bound_of"], "sm_clock_mhz": main[0]["sm_clock_mhz"],
                **{f: sum(r[f] * r["calls"] for r in main)
                   for f in ("bound_exp_ms", "bound_products_ms", "bound_bytes_ms")}}
               if name == "flash_attention_bwd_long" else {}),
            **({"wrapper_device_ms": sum(r["wrapper_device_ms"] * r["calls"] for r in main),
                "wrapper_device_ms_of": "the pair's whole device work (delta pre-pass, dkv, "
                                        "dq) from a CUDA graph"}
               if name == "flash_attention_bwd_dkv" else {}),
        })
    return out


def direct_by_problem(rows: list, launches: dict) -> list:
    """The direct conv's timed problems one by one (the input conv, the
    head, the head's dgrad), each with its times, bound, library time and
    its launches on the path."""
    return [{"problem": conv_problem_name(r["kind"], r["x"], r["cout"], r["dtype"]),
             "calls": r["calls"], "per": r["per"], **summed_times([r]),
             "launches": launches.get(conv_problem_name(r["kind"], r["x"], r["cout"], r["dtype"]),
                                      0)}
            for r in rows]


def device_time_by_kernel(fn) -> dict:
    """{kernel name: (device ms, launches recorded)} of one call of ``fn``
    (in the caller's grad mode), from torch.profiler's CUDA events; empty
    when the profiler saw none. Sums over what the profiler recorded, which
    can miss launches: a lower bound of the device's busy time."""
    from rho_diffusion_tpu_torch.benchmarks._timing import kernel_events

    return kernel_events(fn, 1)


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
    phase_seconds = {}

    def run(name, phase, *args_):
        if name in phases:
            t1 = time.perf_counter()
            phase(state, *args_)
            phase_seconds[name] = time.perf_counter() - t1

    run("env", phase_env)
    run("build", phase_build)
    run("kernels", phase_kernels)
    run("main", phase_main, args.steps, args.samples)
    run("main64", phase_main64)
    run("gauss", phase_gauss)
    run("vlb", phase_vlb)
    run("train", phase_train, TRAIN_BATCH)
    run("data", phase_data)
    run("hold", phase_hold)
    run("serve", phase_serve, args.steps)
    run("load", phase_load)
    run("utils", phase_utils)
    run("int8", phase_int8, args.steps, args.samples)
    run("vit", phase_vit)
    run("diffusers", phase_diffusers)
    run("quality", phase_quality)
    run("quality_2d1d", phase_quality_2d1d)
    run("timings", phase_timings, args.timing_batch)
    run("fp32", phase_fp32)
    run("bench", phase_bench)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=phase_seconds)
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
