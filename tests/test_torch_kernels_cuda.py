"""The port's hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (with its reason) where there is no CUDA
device, so on a CPU-only machine this file counts no passes. On the card,
whose Python has no JAX, run it without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover the ragged edges the flagship does not reach: voxel counts off
the implicit GEMM's 128-voxel boxes, volumes off their power-of-two sides,
Cout off its N tiles, Cin off its 64-channel chunks (zero-filled by the
hardware), every tile and ring depth it has, and the flagship's own boxes
(W = 64, a box over 8 depth planes, Cin = 1024, four N tiles); Cin=1
and Cout=1, fp32, strided q/k/v, padded head dims and Tq != Tk, for both
dtypes of the flash kernel; the flash forward's wgmma route at every plan
(T = 512, 4096 and a ragged 300, D = 64 and 128, with and without the LSE),
its P V product alone, against the mma.sync kernel, and the route each head
dim and dtype takes; the narrow forward at D = 16 and 32 (T = 1 to 4096,
ragged, Tq != Tk, a padded head dim) with and without the LSE, bitwise
repeatable and beside the mma.sync kernel; the fp32 forward's and backward's 3xTF32 routes
(T = 512 at batch 8 and 32, 4096, a ragged 300, D = 64, Tq != Tk), their
pre-passes bitwise, the backward twice bitwise and beside the FMA pair; the
fused backward at every plan (T = 512, 4096, 300
and Tq != Tk, D = 64 and 128, strided qkv and head-major views), against
the mma.sync pair, bitwise repeatable, and the plans it refuses; the small
and long backward at D = 16 and 32 (T up to 64, and past it to 4096) against
the plain version and the pair, bitwise repeatable, and the long route's
device memory at T = 4096 and 16384 (linear in T); the narrow forward and
the long backward at head dim 8 (UNet_Diffuser's, padded to 16) at T = 1024
and 4096; the direct conv's three flagship convs at full
width and shapes off its 8 x 32 voxel tile; and the ring-attention kernel
(K6, one launch per card) in its ring of 2 and 4 ranks on one card at T/n =
128 and 1024, ragged shards and a padded head dim, and with one rank per
card where there are two or more.
The conv's bottleneck-isolation kernels (K7-K9, on K5's block) at the
level-1 widths and off their tiles (K7 ``full`` bitwise K5), and what they
refuse. The int8 kernels (S1 on K5's block with s8 operands, S2, S3) bitwise
against their plain versions: S1 at the flagship's levels, a half-filled
channel chunk, four N tiles, ragged volumes and Cout and the largest Cin its
int32 sums allow; the 2-D convs on S1's block at stride 1 and 2 (DeepGalaxy's
levels at batch 8, ragged planes) and the 1-D convs on it (Spectroscopy's
levels at batch 8, ragged lengths) against the plain version and S2; S2 on the Downsample, 2-D, 1-D, Cin = 17 and an even
kernel; S3 in bf16 and fp32, ragged rows and weights. The plain versions run in fp32 with
TF32 off; tolerances are chip_smoke.py's.
"""
import math

import pytest
import torch

from rho_diffusion_tpu_torch.ops.attention import xla_attention
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import (
    IGEMM_BN, IGEMM_STAGES, TF32_STAGES, IgemmPlan, conv3d, conv3d_dgrad, conv3d_dgrad_plain,
    conv3d_kernel, conv3d_plain, igemm_plan, tf32_plan, weight_split_kernel)
from rho_diffusion_tpu_torch.ops.kernels.conv3d_variants import (
    bigdot, bigdot_plain, conv_variant, conv_variant_plain, dots_only, dots_only_plain)
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    FP32_BWD_PLAN, FP32_PLAN, LONG_BWD_BLOCKS, LONG_BWD_PLAN, MMA_SYNC_BWD_PLAN, MMA_SYNC_PLAN,
    NARROW_PLAN, SMALL_BWD_PLAN, TF32_BWD_PLAN, TF32_PLAN,
    WGMMA_BWD_PLANS, WGMMA_PLANS, FlashBwdPlan, FlashPlan, flash_attention,
    flash_attention_bwd_kernel, flash_attention_bwd_plain, flash_attention_fwd_kernel,
    flash_attention_plain, flash_bwd_plan, flash_bwd_split, flash_bwd_split_plain, flash_delta,
    flash_delta_kernel, flash_fwd_split, flash_lse_plain, flash_plan, flash_routes,
    flash_split_plain, long_bwd_scratch_bytes, padded_head_dim, wgmma_pv_probe)
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import (
    ring_attention_fold, ring_attention_fold_plain, ring_split, ring_split_plain, tf32_probe)
from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_matmul, tf32_round, tf32_split
from rho_diffusion_tpu_torch.parallel import context_sharded_attention, make_mesh

pytestmark = pytest.mark.cuda

TOL_BF16 = 2.0 ** -6  # bf16 output rounding (2^-8 relative) plus summation order
TOL_FP32 = 1e-4
# flash, relative to the reference's max (per element) and rms (overall):
# outputs are softmax averages of rms ~1/sqrt(T), so a fixed atol would hide
# a dropped key tile
TOL_FLASH = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}
# flash backward, the same two bounds (chip_smoke.py derives them): bf16 P
# and dS before their products, the bf16 O in delta and the bf16 gradients
TOL_FLASH_BWD = {torch.bfloat16: 2.0 ** -6, torch.float32: 5e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(shape, seed, device, dtype, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)


@pytest.mark.parametrize(
    "shape,cout,dtype,kernel",
    [
        ((2, 5, 6, 7, 64), 64, torch.bfloat16, "conv3d_igemm"),    # M off the 128 tile
        ((1, 3, 5, 4, 8), 72, torch.bfloat16, "conv3d_igemm"),     # K=216 off 32, Cout off 64
        ((3, 4, 4, 4, 24), 10, torch.bfloat16, "conv3d_igemm"),    # odd Cout (scalar stores)
        ((2, 8, 8, 8, 192), 64, torch.bfloat16, "conv3d_igemm"),
        ((3, 5, 6, 7, 128), 96, torch.bfloat16, "conv3d_igemm"),   # 630 voxels, Cout off BN
        ((2, 6, 9, 10, 24), 64, torch.bfloat16, "conv3d_igemm"),   # Cin 24: 40 channels zero-filled
        ((1, 7, 6, 5, 8), 16, torch.bfloat16, "conv3d_igemm"),     # Cin 8: 56 channels zero-filled
        ((1, 64, 64, 64, 64), 64, torch.bfloat16, "conv3d_igemm"),  # 64^3 level 0: box (64, 2, 1)
        ((2, 32, 4, 4, 512), 512, torch.bfloat16, "conv3d_igemm"),  # level 3: box over 8 planes
        ((2, 32, 4, 4, 1024), 512, torch.bfloat16, "conv3d_igemm"),  # Cin 1024: 16 chunks a tap
        ((2, 6, 6, 6, 1), 64, torch.bfloat16, "conv3d_direct"),    # the UNet's input conv
        ((2, 6, 6, 6, 12), 5, torch.bfloat16, "conv3d_direct"),    # Cin % 8 != 0
        ((2, 6, 6, 6, 1), 64, torch.float32, "conv3d_direct"),
        ((2, 6, 6, 6, 64), 1, torch.float32, "conv3d_direct"),     # the fp32 output head
        # the flagship's direct convs at full width (32^3), batch 2
        ((2, 32, 32, 32, 1), 64, torch.bfloat16, "conv3d_direct"),  # input conv
        ((2, 32, 32, 32, 64), 1, torch.float32, "conv3d_direct"),   # output head
        # voxels off the 8 x 32 tile, Cout off the 64-channel tile
        ((2, 5, 9, 33, 1), 24, torch.float32, "conv3d_direct"),
        ((1, 3, 10, 35, 20), 1, torch.float32, "conv3d_direct"),    # Cin off the 8-deep chunk
        ((2, 4, 5, 6, 6), 1, torch.bfloat16, "conv3d_direct"),
        ((1, 3, 17, 40, 5), 7, torch.bfloat16, "conv3d_direct"),    # odd Cout (scalar stores)
    ],
)
def test_conv3d_kernel_matches_plain(cuda, shape, cout, dtype, kernel):
    cin = shape[-1]
    x = randn(shape, 0, cuda, dtype)
    w = randn((cout, cin, 3, 3, 3), 1, cuda, dtype, 1 / math.sqrt(27 * cin))
    b = randn((cout,), 2, cuda, dtype, 0.1)
    launch_counts.clear()
    got = conv3d(x, w, b)
    torch.cuda.synchronize()
    assert launch_counts == {kernel: 1}
    assert got.dtype == dtype and got.shape == (*shape[:-1], cout)
    want = conv3d_plain(x.float(), w.float(), b.float())
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_FP32
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    no_bias = conv3d(x, w)
    torch.testing.assert_close(no_bias.float(), conv3d_plain(x.float(), w.float()),
                               atol=tol, rtol=tol)


def test_conv3d_direct_reads_an_unaligned_x(cuda):
    """An fp32 x that is contiguous but starts off a 16-byte boundary takes
    the direct kernel's scalar staging instead of its 16-byte loads (Cin 6:
    fp32 with Cin % 4 != 0 stays on the direct kernel)."""
    shape, cout = (1, 4, 9, 33, 6), 3
    x = randn((math.prod(shape) + 1,), 0, cuda, torch.float32)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = randn((cout, shape[-1], 3, 3, 3), 1, cuda, torch.float32, 1 / math.sqrt(27 * 6))
    launch_counts.clear()
    got = conv3d(x, w)
    torch.cuda.synchronize()
    assert launch_counts == {"conv3d_direct": 1}
    torch.testing.assert_close(got, conv3d_plain(x, w), atol=TOL_FP32, rtol=TOL_FP32)


def test_conv3d_kernel_rejects_what_it_does_not_take(cuda):
    x = randn((1, 4, 4, 4, 8), 0, cuda, torch.float16)
    with pytest.raises(TypeError):
        conv3d(x, x.new_zeros((8, 8, 3, 3, 3)))
    x = randn((1, 4, 4, 8, 4), 0, cuda, torch.bfloat16).transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d(x, x.new_zeros((8, 8, 3, 3, 3)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,tq,tk,h,d",
    [
        (2, 512, 512, 4, 128),   # the flagship: one 64-row tile sweep over 8 K/V tiles
        (1, 300, 300, 2, 64),    # ragged last tile
        (1, 70, 130, 3, 32),     # Tq != Tk
        (2, 64, 64, 2, 100),     # head dim padded to 128
        (1, 1000, 1000, 1, 256),
    ],
)
def test_flash_kernel_matches_plain(cuda, b, tq, tk, h, d, dtype):
    q = randn((b, tq, h, d), 3, cuda, dtype)
    kv = randn((b, tk, h, 2 * d), 4, cuda, dtype)
    k, v = kv.split(d, dim=-1)  # strided views, as the UNet's qkv split
    launch_counts.clear()
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts == fwd_launches(d, dtype)
    assert got.shape == (b, tq, h, d) and got.dtype == dtype
    want = xla_attention(q.float(), k.float(), v.float())
    err = got.float() - want
    tol = TOL_FLASH[dtype]
    assert float(err.abs().max()) <= tol * float(want.abs().max())
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= tol


def assert_flash_close(got, want, dtype):
    err = got.float() - want
    tol = TOL_FLASH[dtype]
    assert float(err.abs().max()) <= tol * float(want.abs().max())
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= tol


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
def test_wgmma_pv_product_matches_matmul(cuda, bn, hd):
    """The forward's O += P V alone on one 64 x bn x hd tile: A = P from
    registers, B = V by TMA in the transposed (MN-major) form. bf16 products
    are exact in fp32, so only the summation order differs."""
    p = randn((64, bn), 30, cuda, torch.float32).abs().to(torch.bfloat16)
    v = randn((bn, hd), 31, cuda, torch.bfloat16)
    got = wgmma_pv_probe(p, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, p.float() @ v.float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,t,h,d", [
    (4, 512, 4, 128),    # the flagship's attention at sampling batch 4
    (1, 4096, 2, 128),   # the 64^3 config's 4096 tokens: 32 or 64 K/V tiles
    (2, 300, 3, 64),     # ragged Tq and Tk, D = 64
])
@pytest.mark.parametrize("plan", WGMMA_PLANS, ids=lambda p: f"bm{p.bm}-bn{p.bn}")
def test_flash_wgmma_every_plan_matches_plain(cuda, plan, b, t, h, d):
    """Every plan the wgmma route has, on strided views of one qkv, with
    and without the LSE the backward reads."""
    qkv = randn((b, t, h, 3 * d), 32, cuda, torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    want = xla_attention(q.float(), k.float(), v.float())
    flash_routes.clear()
    for with_lse in (False, True):
        out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=with_lse, plan=plan)
        torch.cuda.synchronize()
        assert_flash_close(out, want, torch.bfloat16)
    assert flash_routes == {f"wgmma Tk={t}": 2}
    # fp32 scores of bf16 inputs on both sides; the sums differ in order and
    # exp2f's last bits: ~1e-6 relative of an LSE near log2(T) + max
    torch.testing.assert_close(lse, flash_lse_plain(q, k), rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,t", [(4, 512), (8, 512), (32, 512), (8, 4096), (2, 300)])
def test_flash_wgmma_matches_the_mma_sync_kernel(cuda, b, t):
    """The new kernel against the old on the same inputs, at the plan the
    UNet gets: both within the flash bound of the plain version, and of each
    other."""
    qkv = randn((b, t, 4, 384), 33, cuda, torch.bfloat16)
    q, k, v = qkv.split(128, dim=-1)
    plan = flash_plan(b, 4, t, t, 128)
    assert plan.route == "wgmma"
    new, new_lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    old, old_lse = flash_attention_fwd_kernel(q, k, v, with_lse=True, plan=MMA_SYNC_PLAN)
    torch.cuda.synchronize()
    want = xla_attention(q.float(), k.float(), v.float())
    assert_flash_close(new, want, torch.bfloat16)
    assert_flash_close(old, want, torch.bfloat16)
    assert_flash_close(new, old.float(), torch.bfloat16)
    torch.testing.assert_close(new_lse, old_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d,dtype,route", [
    (128, torch.bfloat16, "wgmma"), (64, torch.bfloat16, "wgmma"), (100, torch.bfloat16, "wgmma"),
    (32, torch.bfloat16, "narrow"), (16, torch.bfloat16, "narrow"),
    (256, torch.bfloat16, "mma_sync"), (128, torch.float32, "tf32"), (64, torch.float32, "tf32"),
    (32, torch.float32, "fp32"),
])
def test_flash_route_follows_the_plan(cuda, d, dtype, route):
    q = randn((1, 200, 2, d), 34, cuda, dtype)
    kv = randn((1, 150, 2, 2 * d), 35, cuda, dtype)
    k, v = kv.split(d, dim=-1)
    assert flash_plan(1, 2, 200, 150, d, dtype).route == route
    flash_routes.clear()
    launch_counts.clear()
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_routes == {f"{route} Tk=150": 1} and launch_counts == fwd_launches(d, dtype)
    assert_flash_close(got, xla_attention(q.float(), k.float(), v.float()), dtype)


def test_flash_kernel_reads_head_major_views(cuda):
    """q, k, v as [B, T, H, D] views of [B, H, T, D] tensors (the head
    stride above the token stride)."""
    q, k, v = (randn((2, 4, 256, 128), 36 + i, cuda, torch.bfloat16).transpose(1, 2)
               for i in range(3))
    assert_flash_close(flash_attention(q, k, v), xla_attention(q.float(), k.float(), v.float()),
                       torch.bfloat16)


def test_flash_wgmma_refuses_a_plan_it_does_not_take(cuda):
    qkv = randn((1, 128, 2, 384), 37, cuda, torch.bfloat16)
    q, k, v = qkv.split(128, dim=-1)
    for plan in (FlashPlan("wgmma", 96, 128), FlashPlan("wgmma", 128, 256),
                 FlashPlan("wgmma", 64, 128), FlashPlan("wgmma", 256, 128)):
        with pytest.raises(RuntimeError, match="plan"):
            flash_attention_fwd_kernel(q, k, v, plan=plan)
    q32 = randn((1, 128, 2, 32), 38, cuda, torch.bfloat16)
    with pytest.raises(RuntimeError, match="plan"):
        flash_attention_fwd_kernel(q32, q32, q32, plan=FlashPlan("wgmma", 64, 64))
    with pytest.raises(ValueError, match="route"):
        flash_attention_fwd_kernel(q.float(), k.float(), v.float(), plan=MMA_SYNC_PLAN)


@pytest.mark.parametrize("b,tq,tk,h,d", [
    (32, 64, 64, 16, 16),     # the ViT at patch 8: one K/V tile, 128 blocks of four items
    (32, 512, 512, 16, 16),   # the ViT at patch 4: eight K/V tiles through the ring
    (2, 65, 65, 16, 16),      # a ragged second tile of one key
    (4, 512, 512, 8, 32),     # D = 32: two k-steps a score product
    (2, 300, 300, 4, 32),     # ragged T at D = 32
    (1, 1, 1, 2, 16),         # one query, one key
    (2, 200, 150, 3, 16),     # Tq != Tk, the ring's stages refilled
    (1, 4096, 4096, 2, 16),   # 64 K/V tiles
    (1, 70, 9, 2, 20),        # head dim padded to 32, fewer keys than a tile
])
def test_flash_narrow_matches_plain(cuda, b, tq, tk, h, d):
    """The narrow forward (bf16 at padded head dims 16 and 32) on strided
    views, with and without the LSE: one launch a call, within the flash
    tolerance of the plain version, bitwise the same on a second call and
    without the LSE, its LSE within 1e-4 of the plain one's, and beside the
    mma.sync kernel (the plan it replaced, on request)."""
    q = randn((b, tq, h, d), 62, cuda, torch.bfloat16)
    k, v = randn((b, tk, h, 2 * d), 63, cuda, torch.bfloat16).split(d, dim=-1)
    assert flash_plan(b, h, tq, tk, d) == NARROW_PLAN
    launch_counts.clear()
    flash_routes.clear()
    out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    again, lse2 = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    bare, none = flash_attention_fwd_kernel(q, k, v)
    old, old_lse = flash_attention_fwd_kernel(q, k, v, with_lse=True, plan=MMA_SYNC_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_fwd_narrow": 3, "flash_attention": 1}
    assert flash_routes == {f"narrow Tk={tk}": 3, f"mma_sync Tk={tk}": 1}
    assert none is None and torch.equal(out, again) and torch.equal(lse, lse2)
    assert torch.equal(out, bare)
    want = xla_attention(q.float(), k.float(), v.float())
    assert_flash_close(out[..., :d], want, torch.bfloat16)
    assert_flash_close(old[..., :d], want, torch.bfloat16)
    assert_flash_close(out[..., :d], old[..., :d].float(), torch.bfloat16)
    torch.testing.assert_close(lse, flash_lse_plain(q, k), rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, old_lse, rtol=0, atol=1e-4)


def test_flash_narrow_refuses_what_it_does_not_take(cuda):
    """The narrow route at a head dim it has no instance of, or in fp32,
    raises and names it."""
    q64 = randn((1, 64, 2, 64), 64, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="narrow"):
        flash_attention_fwd_kernel(q64, q64, q64, plan=NARROW_PLAN)
    q16 = randn((1, 64, 2, 16), 65, cuda, torch.float32)
    with pytest.raises(ValueError, match="route"):
        flash_attention_fwd_kernel(q16, q16, q16, plan=NARROW_PLAN)


def test_flash_kernel_rejects_float16(cuda):
    q = randn((1, 8, 1, 32), 0, cuda, torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q, q, q)


def fwd_launches(d, dtype) -> dict:
    """The forward's launches by route: fp32 at padded head dims 64 and 128
    the 3xTF32 fold and its K/V pre-pass, bf16 at padded 16 and 32 the
    narrow kernel, one kernel of the ``flash_attention`` count elsewhere."""
    if dtype == torch.float32 and padded_head_dim(d) in (64, 128):
        return {"flash_attention_tf32": 1, "flash_attention_tf32_split": 1}
    if dtype == torch.bfloat16 and padded_head_dim(d) in (16, 32):
        return {"flash_attention_fwd_narrow": 1}
    return {"flash_attention": 1}


def bwd_launches(d, dtype, tq=512, tk=512) -> dict:
    """The backward's launches by route: at padded head dims 64 and 128 the
    fused kernel and its delta pre-pass for bf16, the 3xTF32 pair and its
    pre-pass for fp32; bf16 at padded 16 and 32 the small kernel alone with
    Tq, Tk <= 64 and the long kernel alone past it (delta inside both); the
    dkv/dq pair elsewhere, for bf16 after the delta pre-pass."""
    if padded_head_dim(d) in (64, 128):
        if dtype == torch.bfloat16:
            return {"flash_attention_bwd": 1, "flash_attention_bwd_delta": 1}
        return {"flash_attention_bwd_tf32_split": 1, "flash_attention_bwd_tf32_dkv": 1,
                "flash_attention_bwd_tf32_dq": 1}
    if dtype == torch.bfloat16 and padded_head_dim(d) in (16, 32):
        return {f"flash_attention_bwd_{'small' if max(tq, tk) <= 64 else 'long'}": 1}
    pair = {"flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    return {**pair, "flash_attention_bwd_delta": 1} if dtype == torch.bfloat16 else pair


def flash_grads(q, kv, do, d):
    """dq and d(kv) of flash_attention(q, *kv.split(d)) through autograd."""
    out = flash_attention(q, *kv.split(d, dim=-1))
    return torch.autograd.grad(out, (q, kv), do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,tq,tk,h,d",
    [
        (2, 512, 512, 4, 128),   # the flagship's attention
        (1, 300, 300, 2, 64),    # ragged last tile of both sweeps
        (1, 70, 130, 3, 32),     # Tq != Tk
        (2, 64, 64, 2, 100),     # head dim padded to 128
        (1, 200, 136, 1, 256),
        (1, 40, 90, 2, 16),
        (32, 64, 64, 16, 16),    # the ViT's attention: the small route (bf16)
        (2, 50, 50, 16, 16),     # ragged T on it
        (1, 40, 64, 2, 32),      # Tq != Tk, D = 32
        (3, 37, 37, 5, 20),      # head dim padded to 32
    ],
)
def test_flash_backward_kernels_match_plain(cuda, b, tq, tk, h, d, dtype):
    q = randn((b, tq, h, d), 5, cuda, dtype).requires_grad_()
    kv = randn((b, tk, h, 2 * d), 6, cuda, dtype).requires_grad_()
    do = randn((b, tq, h, d), 7, cuda, dtype)
    launch_counts.clear()
    dq, dkv = flash_grads(q, kv, do, d)
    torch.cuda.synchronize()
    assert launch_counts == {**fwd_launches(d, dtype), **bwd_launches(d, dtype, tq, tk)}
    assert dq.dtype == dtype and dkv.dtype == dtype
    qf, kf, vf = q.detach().float(), *(z.float() for z in kv.detach().split(d, dim=-1))
    want = flash_attention_bwd_plain(qf, kf, vf, flash_attention_plain(qf, kf, vf),
                                     flash_lse_plain(qf, kf), do.float())
    tol = TOL_FLASH_BWD[dtype]
    for got, ref in zip((dq, *dkv.split(d, dim=-1)), want):
        err = got.float() - ref
        assert float(err.abs().max()) <= tol * float(ref.abs().max())
        assert float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    q = randn((2, 300, 4, 128), 8, cuda, dtype).requires_grad_()
    kv = randn((2, 300, 4, 256), 9, cuda, dtype).requires_grad_()
    do = randn((2, 300, 4, 128), 10, cuda, dtype)
    first = flash_grads(q, kv, do, 128)
    second = flash_grads(q, kv, do, 128)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def bwd_inputs(b, tq, tk, h, d, layout, seed, device):
    """q, k, v, dO in bf16: strided views of one qkv (the UNet's; q apart
    and k, v views of one kv where Tq != Tk), or [B, T, H, D] views of
    head-major [B, H, T, D] tensors."""
    if layout == "qkv" and tq == tk:
        q, k, v = randn((b, tq, h, 3 * d), seed, device, torch.bfloat16).split(d, dim=-1)
    elif layout == "qkv":
        q = randn((b, tq, h, d), seed, device, torch.bfloat16)
        k, v = randn((b, tk, h, 2 * d), seed + 1, device, torch.bfloat16).split(d, dim=-1)
    else:
        q = randn((b, h, tq, d), seed, device, torch.bfloat16).transpose(1, 2)
        k, v = (randn((b, h, tk, d), seed + i, device, torch.bfloat16).transpose(1, 2)
                for i in (1, 2))
    return q, k, v, randn((b, tq, h, d), seed + 3, device, torch.bfloat16)


def assert_bwd_close(got, q, k, v, do):
    """dq, dk, dv within TOL_FLASH_BWD of the fp32 plain backward."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_attention_bwd_plain(qf, kf, vf, flash_attention_plain(qf, kf, vf),
                                     flash_lse_plain(qf, kf), do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert_flash_close_bwd(g, w)


def assert_flash_close_bwd(got, want):
    err = got.float() - want
    tol = TOL_FLASH_BWD[torch.bfloat16]
    assert float(err.abs().max()) <= tol * float(want.abs().max())
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= tol


BWD_SHAPES = [
    (4, 512, 512, 4, 128),    # the flagship's attention: 4 or 8 key tiles add to each dQ tile
    (1, 4096, 4096, 2, 128),  # the 64^3 config's 4096 tokens: 32 or 64 key tiles
    (2, 300, 300, 2, 64),     # ragged Tq and Tk, D = 64
    (2, 300, 300, 3, 128),
    (1, 70, 130, 3, 64),      # Tq != Tk
    (1, 130, 70, 2, 128),
    (2, 64, 64, 2, 100),      # head dim padded to 128, one key tile (no accumulator)
    (1, 200, 40, 2, 128),     # fewer keys than a block: one key tile, half of it masked
]


@pytest.mark.parametrize("layout", ["qkv", "head_major"])
@pytest.mark.parametrize("plan,b,tq,tk,h,d", [
    (WGMMA_BWD_PLANS[padded_head_dim(shape[-1])], *shape) for shape in BWD_SHAPES
], ids=lambda x: f"bn{x.bn}" if isinstance(x, FlashBwdPlan) else None)
def test_flash_bwd_fused_every_plan_matches_plain(cuda, plan, b, tq, tk, h, d, layout):
    """The fused kernel at the plan of each head dim (the only plans it
    takes), on strided-qkv and head-major views, against the fp32 plain
    backward on the same inputs."""
    q, k, v, do = bwd_inputs(b, tq, tk, h, d, layout, 40, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=plan)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd": 1, "flash_attention_bwd_delta": 1}
    assert all(g.shape == t.shape for g, t in zip(got, (q, k, v)))
    assert_bwd_close(got, q, k, v, do)


@pytest.mark.parametrize("b,t,h,d", [(32, 512, 4, 128), (2, 4096, 4, 128), (2, 300, 2, 64)])
def test_flash_bwd_fused_matches_the_pair(cuda, b, t, h, d):
    """The fused kernel against the mma.sync pair on the same inputs, at the
    plan the UNet gets: both within the backward's bound of the plain
    version, and of each other."""
    q, k, v, do = bwd_inputs(b, t, t, h, d, "qkv", 41, cuda)
    assert flash_bwd_plan(b, h, t, t, d).route == "wgmma"
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    new = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    old = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=MMA_SYNC_BWD_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd": 1, "flash_attention_bwd_delta": 2,
                             "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    assert_bwd_close(new, q, k, v, do)
    assert_bwd_close(old, q, k, v, do)
    for a, e in zip(new, old):
        assert_flash_close_bwd(a, e.float())


@pytest.mark.parametrize("b,t", [(32, 512), (2, 4096)])
def test_flash_bwd_fused_is_bitwise_repeatable(cuda, b, t):
    """dQ is added across key tiles in a fixed order: two runs at the
    flagship's training shape and at T = 4096 agree bit for bit."""
    q, k, v, do = bwd_inputs(b, t, t, 4, 128, "qkv", 42, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    first = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    second = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, e) for a, e in zip(first, second))


@pytest.mark.parametrize("b,t,h,d", [(32, 512, 4, 128), (2, 300, 3, 64), (1, 70, 2, 128),
                                     (2, 300, 3, 16), (1, 70, 3, 32), (1, 130, 2, 256),
                                     (32, 64, 16, 16)])
def test_flash_delta_kernel_matches_plain(cuda, b, t, h, d):
    """The pre-pass of the fused route and the bf16 pair, at every padded
    head dim (8 and 16 lanes a row at D = 16 and 32, rows of a block past
    the end), against flash_delta on the forward's own output and a strided
    dO view: fp32 sums of exact bf16 products, in another order."""
    q, k, v, _ = bwd_inputs(b, t, t, h, d, "qkv", 46, cuda)
    o, _ = flash_attention_fwd_kernel(q, k, v)
    do = randn((b, t, h, 2 * d), 47, cuda, torch.bfloat16)[..., :d]
    launch_counts.clear()
    got = flash_delta_kernel(o, do)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_delta": 1}
    want = flash_delta(o, do)
    assert got.shape == want.shape == (b, h, t) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


SMALL_SHAPES = [
    (32, 64, 64, 16, 16),   # the ViT's attention: 512 batch*heads, 256 blocks
    (2, 50, 50, 16, 16),    # ragged T
    (3, 64, 64, 5, 16),     # odd B*H: the last block's second warpgroup has none
    (1, 3, 5, 1, 16),       # a few tokens, Tq != Tk
    (1, 40, 64, 2, 32),     # Tq != Tk, D = 32
    (2, 64, 23, 3, 32),     # fewer keys than queries
    (3, 37, 37, 5, 20),     # head dim padded to 32
    (2, 64, 64, 4, 9),      # head dim padded to 16
]


@pytest.mark.parametrize("layout", ["qkv", "head_major"])
@pytest.mark.parametrize("b,tq,tk,h,d", SMALL_SHAPES)
def test_flash_bwd_small_matches_plain(cuda, b, tq, tk, h, d, layout):
    """The small route (one launch a backward, delta inside) on strided-qkv
    and head-major views against the fp32 plain backward on the same
    inputs, at the pair's tolerance; its gradients at the caller's layout."""
    q, k, v, do = bwd_inputs(b, tq, tk, h, d, layout, 50, cuda)
    assert flash_bwd_plan(b, h, tq, tk, d) == SMALL_BWD_PLAN
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_small": 1}
    assert all(g.shape == t.shape for g, t in zip(got, (q, k, v)))
    assert_bwd_close(got, q, k, v, do)


@pytest.mark.parametrize("b,t,h,d", [(32, 64, 16, 16), (2, 50, 16, 16), (4, 64, 8, 32)])
def test_flash_bwd_small_matches_the_pair(cuda, b, t, h, d):
    """The small kernel against the mma.sync pair on the same inputs (the
    pair on request): the same roundings (P and dS to bf16 before their
    products, fp32 sums), so the two agree within the backward's bound;
    and two runs of the small kernel agree bit for bit."""
    q, k, v, do = bwd_inputs(b, t, t, h, d, "qkv", 51, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    new = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    old = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=MMA_SYNC_BWD_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_small": 2, "flash_attention_bwd_delta": 1,
                             "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    assert all(torch.equal(a, e) for a, e in zip(new, again))
    assert_bwd_close(old, q, k, v, do)
    for a, e in zip(new, old):
        assert_flash_close_bwd(a, e.float())


def test_flash_bwd_small_refuses_what_it_does_not_take(cuda):
    """The small route on request past its range raises and names the
    shape: T past one 64-row tile, a padded head dim other than 16 or 32,
    fp32; the plan never sends such a shape there."""
    q, k, v, do = bwd_inputs(1, 65, 65, 2, 16, "qkv", 52, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    assert flash_bwd_plan(1, 2, 65, 65, 16) == LONG_BWD_PLAN
    with pytest.raises(ValueError, match=r"\(1, 65, 2, 16\)"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=SMALL_BWD_PLAN)
    q, k, v, do = bwd_inputs(1, 64, 64, 2, 64, "qkv", 53, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match=r"\(1, 64, 2, 64\)"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=SMALL_BWD_PLAN)
    q, k, v, do = (t.float() for t in bwd_inputs(1, 64, 64, 2, 16, "qkv", 54, cuda))
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=SMALL_BWD_PLAN)


LONG_SHAPES = [
    (32, 512, 512, 16, 16),   # the ViT at patch 4: 512 batch*heads, 4 key blocks, 8 query tiles
    (2, 65, 65, 16, 16),      # one row past the small route: 2 query tiles, one key block
    (1, 4096, 4096, 2, 16),   # 32 key blocks add to each dQ tile
    (2, 300, 300, 3, 32),     # ragged Tq and Tk, D = 32
    (1, 70, 130, 3, 16),      # Tq != Tk: a second key block of 2 keys
    (1, 200, 40, 2, 32),      # fewer keys than a block: its second warpgroup has none
    (3, 100, 100, 5, 20),     # head dim padded to 32
    (2, 129, 257, 2, 9),      # head dim padded to 16, 3 key blocks
    (4, 2048, 2048, 16, 16),  # B*H 64: 16 chunks of 128 keys over 5 blocks, 4 or 3 each
    (17, 300, 300, 16, 16),   # B*H 272 fills the card: one block of 3 chunks, no counter
]


@pytest.mark.parametrize("layout", ["qkv", "head_major"])
@pytest.mark.parametrize("b,tq,tk,h,d", LONG_SHAPES)
def test_flash_bwd_long_matches_plain(cuda, b, tq, tk, h, d, layout):
    """The long route (one launch a backward, delta inside, dQ added across
    key blocks in a fixed order) on strided-qkv and head-major views against
    the fp32 plain backward on the same inputs, at the backward's
    tolerance; its gradients at the caller's layout."""
    q, k, v, do = bwd_inputs(b, tq, tk, h, d, layout, 55, cuda)
    assert flash_bwd_plan(b, h, tq, tk, d) == LONG_BWD_PLAN
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_long": 1}
    assert all(g.shape == t.shape for g, t in zip(got, (q, k, v)))
    assert_bwd_close(got, q, k, v, do)


@pytest.mark.parametrize("b,t,h,d", [(32, 512, 16, 16), (2, 300, 16, 16), (4, 256, 8, 32),
                                     (17, 300, 16, 16)])
def test_flash_bwd_long_matches_the_pair(cuda, b, t, h, d):
    """The long kernel against the mma.sync pair it replaces, on the same
    inputs (the pair on request): the same roundings, so the two agree
    within the backward's bound; and two runs of the long kernel agree bit
    for bit (dQ's shares added in the key blocks' order)."""
    q, k, v, do = bwd_inputs(b, t, t, h, d, "qkv", 56, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    new = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    old = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=MMA_SYNC_BWD_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_long": 2, "flash_attention_bwd_delta": 1,
                             "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    assert all(torch.equal(a, e) for a, e in zip(new, again))
    assert_bwd_close(old, q, k, v, do)
    for a, e in zip(new, old):
        assert_flash_close_bwd(a, e.float())


@pytest.mark.parametrize("b,t,h", [(64, 4096, 16), (1, 16384, 16)])
def test_flash_bwd_long_memory_is_linear_in_t(cuda, b, t, h):
    """The long route's device memory at a large B*H*T: the call allocates
    dq, dk and dv and its fp32 dQ slots and counters (long_bwd_scratch_bytes,
    linear in T), and nothing that grows as Tq * Tk (a slot set for every
    128 keys took 8.6 GB at B*H 1024, T 4096 and 2.1 GB at B*H 16, T
    16384); and two calls agree bit for bit."""
    d = 16
    q, k, v, do = bwd_inputs(b, t, t, h, d, "head_major", 60, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    scratch = long_bwd_scratch_bytes(b * h, t, t, d)
    assert launch_counts == {"flash_attention_bwd_long": 1}
    assert peak <= 3 * b * t * h * d * 2 + scratch + (1 << 20)
    assert scratch < (b * h + LONG_BWD_BLOCKS) * t * d * 4 + 4 * b * h
    assert all(bool(torch.isfinite(g).all()) for g in got)
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    assert all(torch.equal(a, e) for a, e in zip(got, again))


# UNet_Diffuser's attention at DeepGalaxy's 128^2: 8 heads of 8 channels over
# 32^2 and 64^2 tokens (batch cut from 64; chip_smoke's diffusers phase holds
# and times the full batch)
D8_SHAPES = [(4, 1024, 8, 8), (2, 4096, 8, 8)]


@pytest.mark.parametrize("b,t,h,d", D8_SHAPES)
def test_flash_head_dim_8_matches_plain(cuda, b, t, h, d):
    """Head dim 8, padded to 16 (scores at 1/sqrt(8)): the narrow forward
    and the long backward, one launch each, on strided views of one qkv,
    within the flash tolerances of the plain versions, the LSE within 1e-4,
    both bitwise the same on a second call; and the autograd Function takes
    exactly these two kernels."""
    q, k, v, do = bwd_inputs(b, t, t, h, d, "qkv", 70, cuda)
    assert padded_head_dim(d) == 16
    assert flash_plan(b, h, t, t, d) == NARROW_PLAN
    assert flash_bwd_plan(b, h, t, t, d) == LONG_BWD_PLAN
    launch_counts.clear()
    out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    again, lse2 = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    got = flash_attention_bwd_kernel(q, k, v, out, lse, do)
    got2 = flash_attention_bwd_kernel(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_fwd_narrow": 2, "flash_attention_bwd_long": 2}
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert all(torch.equal(a, e) for a, e in zip(got, got2))
    assert_flash_close(out[..., :d], xla_attention(q.float(), k.float(), v.float()),
                       torch.bfloat16)
    torch.testing.assert_close(lse, flash_lse_plain(q, k), rtol=0, atol=1e-4)
    assert all(g.shape == x.shape for g, x in zip(got, (q, k, v)))
    assert_bwd_close(got, q, k, v, do)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    launch_counts.clear()
    grads = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_fwd_narrow": 1, "flash_attention_bwd_long": 1}
    assert all(torch.equal(a, e) for a, e in zip(grads, got))


def test_flash_bwd_long_refuses_what_it_does_not_take(cuda):
    """The long route on request outside its range raises and names the
    shape: T within one 64-row tile (the small route's), a padded head dim
    other than 16 or 32, fp32; the plan never sends such a shape there."""
    q, k, v, do = bwd_inputs(1, 64, 64, 2, 16, "qkv", 57, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    assert flash_bwd_plan(1, 2, 64, 64, 16) == SMALL_BWD_PLAN
    with pytest.raises(ValueError, match=r"\(1, 64, 2, 16\)"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=LONG_BWD_PLAN)
    q, k, v, do = bwd_inputs(1, 128, 128, 2, 64, "qkv", 58, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match=r"\(1, 128, 2, 64\)"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=LONG_BWD_PLAN)
    q, k, v, do = (t.float() for t in bwd_inputs(1, 128, 128, 2, 16, "qkv", 59, cuda))
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=LONG_BWD_PLAN)


def test_flash_bwd_fused_refuses_a_plan_it_does_not_take(cuda):
    q, k, v, do = bwd_inputs(1, 256, 256, 2, 128, "qkv", 43, cuda)
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    # the block's keys are the head dim: one warpgroup per 64 keys and per
    # 64-channel chunk of dQ
    for plan in (FlashBwdPlan("wgmma", 256), FlashBwdPlan("wgmma", 64),
                 FlashBwdPlan("wgmma", 96)):
        with pytest.raises(RuntimeError, match="plan"):
            flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=plan)
    q64, k64, v64, do64 = bwd_inputs(1, 256, 256, 2, 64, "qkv", 44, cuda)
    o64, lse64 = flash_attention_fwd_kernel(q64, k64, v64, with_lse=True)
    with pytest.raises(RuntimeError, match="plan"):
        flash_attention_bwd_kernel(q64, k64, v64, o64, lse64, do64, plan=WGMMA_BWD_PLANS[128])
    q32 = randn((1, 64, 2, 32), 45, cuda, torch.bfloat16)
    o32, lse32 = flash_attention_fwd_kernel(q32, q32, q32, with_lse=True)
    with pytest.raises(RuntimeError, match="plan"):  # no instance at D = 32
        flash_attention_bwd_kernel(q32, q32, q32, o32, lse32, q32,
                                   plan=FlashBwdPlan("wgmma", 32))
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd_kernel(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                   plan=MMA_SYNC_BWD_PLAN)


@pytest.mark.parametrize(
    "gshape,cin,dtype,kernel",
    [
        ((2, 5, 6, 7, 64), 64, torch.bfloat16, "conv3d_dgrad_igemm"),
        ((1, 3, 5, 4, 72), 8, torch.bfloat16, "conv3d_dgrad_igemm"),   # Cin off the 64 tile
        ((2, 4, 4, 4, 24), 10, torch.bfloat16, "conv3d_dgrad_igemm"),  # odd Cin
        ((32, 32, 4, 4, 512), 1024, torch.bfloat16, "conv3d_dgrad_igemm"),  # Cout' 1024: 4 N tiles
        ((2, 6, 6, 6, 12), 5, torch.bfloat16, "conv3d_dgrad_direct"),  # Cout % 8 != 0
        ((2, 6, 6, 6, 1), 64, torch.float32, "conv3d_dgrad_direct"),   # the fp32 head's dgrad
        ((2, 5, 6, 7, 16), 24, torch.float32, "conv3d_dgrad_tf32"),    # 3xTF32 since Cout % 4 == 0
        ((2, 5, 6, 7, 6), 24, torch.float32, "conv3d_dgrad_direct"),   # Cout % 4 != 0
        ((2, 32, 32, 32, 1), 64, torch.float32, "conv3d_dgrad_direct"),  # the head's, at 32^3
        # the fp32 flagship's dgrad at its levels 0 and 3, batch 2
        ((2, 32, 32, 32, 64), 64, torch.float32, "conv3d_dgrad_tf32"),
        ((2, 32, 4, 4, 512), 1024, torch.float32, "conv3d_dgrad_tf32"),
    ],
)
def test_conv3d_dgrad_kernel_matches_plain(cuda, gshape, cin, dtype, kernel):
    cout = gshape[-1]
    g = randn(gshape, 11, cuda, dtype)
    w = randn((cout, cin, 3, 3, 3), 12, cuda, dtype, 1 / math.sqrt(27 * cout))
    launch_counts.clear()
    got = conv3d_dgrad(g, w)
    torch.cuda.synchronize()
    assert launch_counts == {kernel: 1, **({"conv3d_weight_split": 1}
                                           if kernel.endswith("_tf32") else {})}
    assert got.dtype == dtype and got.shape == (*gshape[:-1], cin)
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_FP32
    torch.testing.assert_close(got.float(), conv3d_dgrad_plain(g.float(), w.float()),
                               atol=tol, rtol=tol)


def test_conv3d_dgrad_1024_runs_four_n_tiles(cuda):
    """The bottleneck's dgrad at batch 32 (1024 output channels) takes four
    N tiles of 256 over the same A boxes."""
    plan = igemm_plan((32, 32, 4, 4, 512), 1024,
                      sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.bn == 256 and plan.grid((32, 32, 4, 4, 512), 1024)[-1] == 4


@pytest.mark.parametrize("stages", IGEMM_STAGES)
@pytest.mark.parametrize("bn", IGEMM_BN)
def test_conv3d_igemm_every_plan_matches_plain(cuda, bn, stages):
    """Every N tile and ring depth the kernel has, on ragged voxels and a
    Cout that leaves part of the last N tile empty."""
    shape, cout = (2, 9, 5, 12, 72), 200
    x = randn(shape, 20, cuda, torch.bfloat16)
    w = randn((cout, 72, 3, 3, 3), 21, cuda, torch.bfloat16, 1 / math.sqrt(27 * 72))
    b = randn((cout,), 22, cuda, torch.bfloat16, 0.1)
    plan = igemm_plan(shape, cout, stages=stages)._replace(bn=bn)
    launch_counts.clear()
    got = conv3d_kernel(x, w, b, plan=plan)
    torch.cuda.synchronize()
    assert launch_counts == {"conv3d_igemm": 1}
    torch.testing.assert_close(got.float(), conv3d_plain(x.float(), w.float(), b.float()),
                               atol=TOL_BF16, rtol=TOL_BF16)


def test_conv3d_igemm_refuses_a_bad_plan(cuda):
    x = randn((1, 4, 4, 4, 16), 23, cuda, torch.bfloat16)
    w = randn((16, 16, 3, 3, 3), 24, cuda, torch.bfloat16)
    for plan in (IgemmPlan(4, 4, 4, 64, 4), IgemmPlan(4, 4, 8, 96, 4),
                 IgemmPlan(4, 4, 8, 64, 5), IgemmPlan(4, 4, 8, 256, 6)):
        with pytest.raises(RuntimeError, match="plan"):
            conv3d_kernel(x, w, plan=plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_function_gradients_match_plain(cuda, dtype):
    """dx (the dgrad kernel), dw (the library's wgrad) and db of the conv
    Function against the plain route of the same Function."""
    x = randn((2, 4, 6, 5, 16), 13, cuda, dtype)
    w = randn((24, 16, 3, 3, 3), 14, cuda, dtype, 1 / math.sqrt(27 * 16))
    b = randn((24,), 15, cuda, dtype, 0.1)
    g = randn((2, 4, 6, 5, 24), 16, cuda, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    got = torch.autograd.grad(conv3d(*leaves), leaves, g)
    ref = [t.float().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(conv3d(*ref, plain=True), ref, g.float())
    tol = TOL_BF16 * 4 if dtype == torch.bfloat16 else TOL_FP32
    for a, e in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), e, atol=tol * float(e.abs().max()), rtol=tol)


@pytest.mark.parametrize("num_heads,head_dim,shape", [
    (2, 32, (4, 16, 16)), (2, 32, (4, 8, 8)), (1, 64, (4, 8, 8))],
    ids=["d32-mma_sync-pair", "d32-small", "d64-fused"])
def test_unet_training_step_reaches_every_parameter(cuda, num_heads, head_dim, shape):
    """One bf16 loss.backward() of a small 3-D UNet on the card: every
    parameter gets a finite gradient (no kernel cuts the graph), and the
    step went through the forward and backward kernels: at head dim 32 the
    narrow forward, and the long backward over 256 tokens and the small
    backward over 64; at 64 the wgmma forward and the fused backward."""
    from rho_diffusion_tpu_torch.models.unet import UNet

    torch.manual_seed(0)
    unet = UNet(data_shape=shape, in_channels=1, model_channels=32, out_channels=1,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                dims=3, num_heads=num_heads, use_scale_shift_norm=True,
                dtype="bfloat16").to(cuda)
    with torch.no_grad():
        for p in unet.parameters():  # no zero-initialised heads
            p.copy_(torch.randn_like(p) / math.sqrt(p[0].numel() if p.dim() > 1 else 50))
    x = randn((2, *shape, 1), 17, cuda, torch.float32)
    t = torch.tensor([3, 700], device=cuda)
    launch_counts.clear()
    unet.train()
    loss = unet(x, t).square().mean()
    loss.backward()
    torch.cuda.synchronize()
    for name, p in unet.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert float(p.grad.abs().max()) > 0, name
    tokens = shape[0] * (shape[1] // 2) * (shape[2] // 2)  # attention after one Downsample
    bwd = bwd_launches(head_dim, torch.bfloat16, tokens, tokens)
    fwd = fwd_launches(head_dim, torch.bfloat16)
    for kernel in ("conv3d_igemm", "conv3d_direct", "conv3d_dgrad_igemm", "conv3d_dgrad_direct",
                   *fwd, *bwd):
        assert launch_counts[kernel] > 0, kernel
    assert not launch_counts[({"flash_attention", "flash_attention_fwd_narrow"} - set(fwd)).pop()]
    others = {"flash_attention_bwd", "flash_attention_bwd_delta", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq", "flash_attention_bwd_small",
              "flash_attention_bwd_long"} - set(bwd)
    assert not any(launch_counts[kernel] for kernel in others)


def ring_inputs(b, t, h, d, dtype, device, seed):
    """q, k, v as the UNet makes them: strided views of one fused qkv."""
    return randn((b, t, h, 3 * d), seed, device, dtype).split(d, dim=-1)



def ring_launches(dtype, cards: int) -> dict:
    """A ring call's launches, one fold per card: bf16's mma.sync kernel, or
    at fp32 (head dims padded to 64 or 128 here) the 3xTF32 fold and its
    pre-pass."""
    if dtype == torch.bfloat16:
        return {"ring_attention": cards}
    return {"ring_attention_tf32": cards, "ring_attention_tf32_split": cards}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "n,b,tl,h,d",
    [
        (4, 8, 128, 4, 128),   # the flagship's serve shape: bucket 8, 4 ranks
        (2, 8, 128, 4, 128),   # n = 2
        (4, 2, 1024, 4, 128),  # the 64^3 config's T/n = 1024
        (2, 1, 150, 3, 100),   # ragged key tiles, head dim padded to 128
    ],
)
def test_ring_attention_kernel_matches_plain(cuda, n, b, tl, h, d, dtype):
    """K6 in its ring of n ranks on one card against the same ring with the
    plain version (fp32 inputs) and against full attention."""
    q, k, v = ring_inputs(b, n * tl, h, d, dtype, cuda, seed=20)
    mesh = make_mesh(data=1, context=n, devices=[cuda] * n)
    launch_counts.clear()
    got = context_sharded_attention(q, k, v, mesh, impl="rdma")
    torch.cuda.synchronize()
    # one fold for the card's n ranks (fp32 at these head dims: the 3xTF32
    # fold, after its pre-pass)
    assert launch_counts == ring_launches(dtype, 1)
    assert got.shape == q.shape and got.dtype == dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    assert_flash_close(got, context_sharded_attention(qf, kf, vf, mesh, impl="rdma", plain=True),
                       dtype)
    assert_flash_close(got, xla_attention(qf, kf, vf), dtype)


def test_ring_attention_kernel_one_rank_per_card(cuda):
    """The ring over separate cards: each card's launch reads the other
    ranks' shards over NVLink, one launch per card."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    n = min(count, 4)
    devices = [torch.device("cuda", i) for i in range(n)]
    q, k, v = ring_inputs(8, n * 128, 4, 128, torch.bfloat16, cuda, seed=21)
    launch_counts.clear()
    got = context_sharded_attention(q, k, v, make_mesh(context=n, devices=devices), impl="rdma")
    torch.cuda.synchronize()
    assert launch_counts == {"ring_attention": n}
    assert_flash_close(got, xla_attention(q.float(), k.float(), v.float()), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_attention_kernel_ranks_shared_across_cards(cuda, dtype):
    """Four ranks over two cards, alternating: each card's one launch folds
    its two ranks, reading the other card's shards over NVLink."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    devices = [torch.device("cuda", i % 2) for i in range(4)]
    q, k, v = ring_inputs(2, 4 * 150, 3, 100, dtype, cuda, seed=22)
    launch_counts.clear()
    got = context_sharded_attention(q, k, v, make_mesh(context=4, devices=devices), impl="rdma")
    torch.cuda.synchronize()
    assert launch_counts == ring_launches(dtype, 2)
    assert got.shape == q.shape and got.dtype == dtype
    assert_flash_close(got, xla_attention(q.float(), k.float(), v.float()), dtype)


def test_ring_attention_kernel_refuses_autograd(cuda):
    q = randn((1, 64, 2, 64), 22, cuda, torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="grad mode"):
        context_sharded_attention(q, q, q, make_mesh(context=2, devices=[cuda] * 2), impl="rdma")


@pytest.mark.parametrize("variant", ["full", "nopatch", "nodma"])
@pytest.mark.parametrize(
    "shape,cout",
    [
        ((2, 4, 16, 16, 128), 128),  # the level-1 widths
        ((1, 3, 5, 7, 32), 72),      # voxels off the 128 tile, Cout off 64
        ((2, 4, 4, 4, 24), 10),      # K = 648 off the 32-deep slice, odd Cout
    ],
)
def test_conv_variant_kernels_match_plain(cuda, shape, cout, variant):
    cin = shape[-1]
    x = randn(shape, 30, cuda, torch.bfloat16)
    km = randn((27 * cin, cout), 31, cuda, torch.bfloat16, 1 / math.sqrt(27 * cin))
    launch_counts.clear()
    got = conv_variant(x, km, variant)
    torch.cuda.synchronize()
    assert launch_counts == {f"conv3d_variant_{variant}": 1}
    assert got.dtype == torch.bfloat16 and got.shape == (*shape[:-1], cout)
    torch.testing.assert_close(got.float(), conv_variant_plain(x.float(), km.float(), variant),
                               atol=TOL_BF16, rtol=TOL_BF16)


def test_full_variant_is_k5_bitwise(cuda):
    """``full`` is K5's block (csrc/conv3d_wgmma.cuh) under another kernel
    name, on K5's plan and weight layout: its output is K5's bit for bit."""
    x = randn((2, 4, 16, 16, 128), 32, cuda, torch.bfloat16)
    km = randn((27 * 128, 128), 33, cuda, torch.bfloat16, 1 / math.sqrt(27 * 128))
    weight = km.view(3, 3, 3, 128, 128).permute(4, 3, 0, 1, 2)
    assert torch.equal(conv_variant(x, km, "full"), conv3d(x, weight))


@pytest.mark.parametrize(
    "shape,cout,td",
    [((2, 8, 16, 16, 32), 64, td) for td in (1, 2, 4, 8)]
    + [((1, 4, 8, 16, 128), 128, 1), ((3, 6, 8, 8, 64), 128, 2)]
    # off the tiles: Cout 48 (one N tile of 64, odd columns past Cout), and
    # 64 rows a batch (each 128-row tile reads the next batch's rows, unwritten)
    + [((1, 4, 8, 16, 32), 48, 1), ((2, 4, 4, 4, 32), 64, 1), ((2, 4, 4, 4, 24), 10, 2)],
)
def test_bigdot_kernels_match_plain(cuda, shape, cout, td):
    cin = shape[-1]
    x = randn(shape, 34, cuda, torch.bfloat16)
    km = randn((27 * cin, cout), 35, cuda, torch.bfloat16, 1 / math.sqrt(27 * cin))
    launch_counts.clear()
    got = bigdot(x, km, td)
    torch.cuda.synchronize()
    passes = shape[1] // td
    assert launch_counts == {"conv3d_bigdot_im2col": passes, "conv3d_bigdot_gemm": passes}
    want = bigdot_plain(x.float(), km.float(), td)
    torch.testing.assert_close(got.float(), want, atol=TOL_BF16, rtol=TOL_BF16)
    torch.testing.assert_close(want, conv_variant_plain(x.float(), km.float(), "full"))


@pytest.mark.parametrize("rows,cpad,cout", [(1024, 384, 128), (256, 32, 64), (384, 96, 192),
                                            (100, 32, 40), (300, 24, 72)])
def test_dots_only_kernel_matches_plain(cuda, rows, cpad, cout):
    p = randn((rows, cpad), 36, cuda, torch.bfloat16)
    km = randn((9 * cpad, cout), 37, cuda, torch.bfloat16, 1 / math.sqrt(9 * cpad))
    launch_counts.clear()
    got = dots_only(p, km)
    torch.cuda.synchronize()
    assert launch_counts == {"conv3d_dotsonly": 1}
    torch.testing.assert_close(got.float(), dots_only_plain(p.float(), km.float()),
                               atol=TOL_BF16, rtol=TOL_BF16)


def test_variant_kernels_reject_what_they_do_not_take(cuda):
    x = randn((1, 4, 8, 16, 32), 38, cuda, torch.bfloat16)
    km = randn((27 * 32, 64), 39, cuda, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        conv_variant(x.float(), km.float(), "full")
    with pytest.raises(ValueError, match="contiguous"):
        conv_variant(x.transpose(2, 3), km, "full")
    unaligned = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        conv_variant(unaligned, km, "full")
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_variant(x[..., :12].contiguous(), km[:27 * 12], "full")
    with pytest.raises(ValueError, match="3\\*Cin"):
        conv_variant(x, km[:-1], "full")
    with pytest.raises(ValueError, match="multiple of 8"):  # the patch's chunks cross taps
        bigdot(x[..., :12].contiguous(), km[:27 * 12], 1)
    with pytest.raises(ValueError, match="multiple of 8"):  # p's rows off 16 bytes
        dots_only(randn((128, 36), 40, cuda, torch.bfloat16), km[:324])
    with pytest.raises(RuntimeError, match="grad mode"):
        conv_variant(x, km.clone().requires_grad_(), "full")


# ---- fp32 on the tensor cores: 3xTF32 (conv3d_tf32.cuh, ring_attention_tf32.cuh) ----


@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 9, 12), 70),       # ragged voxels, Cin 12 (20 channels zero-filled), Cout off 64
    ((2, 3, 5, 4, 4), 2),         # Cin 4, Cout 2 (the learned-variance head's Cout)
    ((2, 9, 5, 12, 72), 200),     # Cin off 32, two N tiles, the last partly empty
    ((2, 32, 32, 32, 64), 64),    # the fp32 flagship's level 0, batch 2
    ((2, 32, 4, 4, 1024), 512),   # its level 3 (Cin 1024: 32 chunks a tap), four N tiles
    ((2, 32, 16, 16, 384), 128),  # a decoder conv of level 1
])
def test_conv3d_tf32_matches_plain(cuda, shape, cout):
    """fp32 with Cin % 4 == 0 and Cout > 1 takes the 3xTF32 block, after
    its weight pre-pass, and holds fp32's tolerance."""
    cin = shape[-1]
    x = randn(shape, 30, cuda, torch.float32)
    w = randn((cout, cin, 3, 3, 3), 31, cuda, torch.float32, 1 / math.sqrt(27 * cin))
    b = randn((cout,), 32, cuda, torch.float32, 0.1)
    launch_counts.clear()
    got = conv3d(x, w, b)
    torch.cuda.synchronize()
    assert launch_counts == {"conv3d_tf32": 1, "conv3d_weight_split": 1}
    torch.testing.assert_close(got, conv3d_plain(x, w, b), atol=TOL_FP32, rtol=TOL_FP32)


@pytest.mark.parametrize("bn", sorted(TF32_STAGES))
def test_conv3d_tf32_every_plan_matches_plain(cuda, bn):
    shape, cout = (2, 9, 5, 12, 72), 200
    x = randn(shape, 33, cuda, torch.float32)
    w = randn((cout, 72, 3, 3, 3), 34, cuda, torch.float32, 1 / math.sqrt(27 * 72))
    plan = tf32_plan(shape, cout)._replace(bn=bn, stages=TF32_STAGES[bn])
    got = conv3d_kernel(x, w, plan=plan)
    torch.testing.assert_close(got, conv3d_plain(x, w), atol=TOL_FP32, rtol=TOL_FP32)


def test_conv3d_tf32_refuses_what_it_does_not_take(cuda):
    x = randn((1, 4, 4, 4, 16), 35, cuda, torch.float32)
    w = randn((16, 16, 3, 3, 3), 36, cuda, torch.float32)
    for plan in (IgemmPlan(4, 4, 8, 192, 3), IgemmPlan(4, 4, 8, 64, 3), IgemmPlan(4, 4, 4, 64, 4)):
        with pytest.raises(RuntimeError, match="plan"):
            conv3d_kernel(x, w, plan=plan)
    shape = (1, 4, 4, 4, 16)
    unaligned = randn((math.prod(shape) + 1,), 37, cuda, torch.float32)[1:].view(shape)
    with pytest.raises(ValueError, match="aligned"):
        conv3d(unaligned, w)


@pytest.mark.parametrize("shape", [(64, 27, 64), (1024, 27, 512), (3, 5, 7)])
def test_weight_split_kernel_is_the_plain_split(cuda, shape):
    """hi = tf32(w), lo = tf32(w - hi), bit for bit."""
    w = randn(shape, 38, cuda, torch.float32, 0.3)
    hi, lo = weight_split_kernel(w)
    want_hi, want_lo = tf32_split(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, tf32_round(want_lo))


@pytest.mark.parametrize("n,b,tl,h,d", [(4, 8, 128, 4, 128), (3, 2, 75, 3, 64), (1, 1, 300, 2, 128)])
def test_ring_split_kernel_is_the_plain_split(cuda, n, b, tl, h, d):
    """K6's tf32 pre-pass on strided shards (views of one qkv), ragged
    shard lengths padded to 8, V^T's keys permuted: bit for bit its plain
    version."""
    _, k, v = ring_inputs(b, n * tl, h, d, torch.float32, cuda, seed=39)
    ks, vs = k.split(tl, dim=1), v.split(tl, dim=1)
    for got, want in zip(ring_split(ks, vs), ring_split_plain(ks, vs)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [32, 128])
def test_tf32_probe_products_in_both_layouts(cuda, n):
    """The 3xTF32 products alone in S = Q K^T's and O += P V's operand
    layouts: at the flash tolerance of the fp32 product, where one TF32
    product misses it."""
    a = randn((64, 32), 40, cuda, torch.float32)
    b = randn((n, 32), 41, cuda, torch.float32)
    want = a @ b.T
    got = tf32_probe(a, b)
    assert_flash_close(got[0], want, torch.float32)
    assert_flash_close(got[1], want, torch.float32)
    with pytest.raises(AssertionError):
        assert_flash_close(tf32_matmul(a, b.T, terms=1), want, torch.float32)


@pytest.mark.parametrize("s", [128, 1024, 13])
def test_ring_tf32_fold_matches_plain_over_long_shards(cuda, s):
    """The 3xTF32 fold with one rank of a ring of 4 (the others' shards
    read where they lie) at shard lengths 128, 1024 (T = 4096: the
    accumulator's drift over many keys) and a ragged 13."""
    n, b, h, d = 4, 2, 2, 128
    q, k, v = ring_inputs(b, n * s, h, d, torch.float32, cuda, seed=42)
    ks, vs = k.split(s, dim=1), v.split(s, dim=1)
    qs = [q[:, :s].contiguous()]
    scale_log2 = 1.4426950408889634 / math.sqrt(d)
    got, want = [torch.empty_like(qs[0])], [torch.empty_like(qs[0])]
    launch_counts.clear()
    ring_attention_fold(qs, got, [2], ks, vs, scale_log2)
    torch.cuda.synchronize()
    assert launch_counts == ring_launches(torch.float32, 1)
    ring_attention_fold_plain(qs, want, [2], ks, vs, scale_log2)
    assert_flash_close(got[0], want[0], torch.float32)


# ---- the fp32 flash routes on 3xTF32 (ring_attention_tf32.cuh's fold, flash_attention_bwd_tf32.cuh) ----

@pytest.mark.parametrize("b,tq,tk,h,d", [
    (8, 512, 512, 4, 128), (32, 512, 512, 4, 128),  # a batch-8 forward's and the training step's
    (2, 4096, 4096, 4, 128),                        # the 64^3 config's tokens
    (2, 300, 300, 4, 128), (2, 300, 300, 2, 64),    # ragged, and D = 64
    (1, 70, 130, 3, 64),                            # Tq != Tk
])
def test_flash_tf32_forward_matches_plain(cuda, b, tq, tk, h, d):
    """The 3xTF32 forward with and without the LSE, on strided views, within
    fp32's flash tolerance of the plain version, the same output either way,
    its LSE within 1e-4 of the plain one's, and beside the FMA kernel (the
    plan it replaced, on request)."""
    q = randn((b, tq, h, d), 60, cuda, torch.float32)
    k, v = randn((b, tk, h, 2 * d), 61, cuda, torch.float32).split(d, dim=-1)
    assert flash_plan(b, h, tq, tk, d, torch.float32) == TF32_PLAN
    launch_counts.clear()
    out, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    bare, none = flash_attention_fwd_kernel(q, k, v)
    old, old_lse = flash_attention_fwd_kernel(q, k, v, with_lse=True, plan=FP32_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_tf32": 2, "flash_attention_tf32_split": 2,
                             "flash_attention": 1}
    assert none is None and torch.equal(out, bare)
    want = xla_attention(q, k, v)
    assert_flash_close(out, want, torch.float32)
    assert_flash_close(old, want, torch.float32)
    torch.testing.assert_close(lse, flash_lse_plain(q, k), rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, old_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 300, 300, 2, 64), (1, 70, 130, 3, 128)])
def test_flash_tf32_pre_passes_are_the_plain_split(cuda, b, tq, tk, h, d):
    """The forward's K/V pre-pass and the backward's q/dO/k/v pre-pass,
    on strided views, bitwise their plain versions."""
    q, do = (randn((b, tq, h, 2 * d), 62 + i, cuda, torch.float32)[..., :d] for i in range(2))
    k, v = randn((b, tk, h, 2 * d), 64, cuda, torch.float32).split(d, dim=-1)
    launch_counts.clear()
    got = (*flash_fwd_split(k, v), *flash_bwd_split(q, do, k, v))
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_tf32_split": 1, "flash_attention_bwd_tf32_split": 1}
    want = (*flash_split_plain(k, v), *flash_bwd_split_plain(q, do, k, v))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,t,h,d", [(32, 512, 4, 128), (2, 4096, 4, 128), (2, 300, 2, 64),
                                     (1, 130, 2, 128)])
def test_flash_bwd_tf32_matches_plain_and_the_fma_pair(cuda, b, t, h, d):
    """The 3xTF32 pair at the training step's attention, T = 4096, a ragged
    T at D = 64: within fp32's backward tolerance of the plain backward,
    bitwise the same on a second run, and beside the FMA pair on request."""
    q, k, v = randn((b, t, h, 3 * d), 65, cuda, torch.float32).split(d, dim=-1)
    do = randn((b, t, h, d), 66, cuda, torch.float32)
    assert flash_bwd_plan(b, h, t, t, d, torch.float32) == TF32_BWD_PLAN
    o, lse = flash_attention_fwd_kernel(q, k, v, with_lse=True)
    launch_counts.clear()
    new = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    old = flash_attention_bwd_kernel(q, k, v, o, lse, do, plan=FP32_BWD_PLAN)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention_bwd_tf32_split": 2, "flash_attention_bwd_tf32_dkv": 2,
                             "flash_attention_bwd_tf32_dq": 2, "flash_attention_bwd_dkv": 1,
                             "flash_attention_bwd_dq": 1}
    assert all(torch.equal(a, e) for a, e in zip(new, again))
    want = flash_attention_bwd_plain(q, k, v, flash_attention_plain(q, k, v), flash_lse_plain(q, k),
                                     do)
    for got in (new, old):
        for g, w in zip(got, want):
            err = g - w
            assert float(err.abs().max()) <= 5e-5 * float(w.abs().max())
            assert float(err.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()) <= 5e-5


def test_flash_tf32_routes_refuse_what_they_do_not_take(cuda):
    """The pre-passes take fp32 of matching shapes only, and the tf32
    launchers only head dims 64 and 128: a bf16 input, a mismatched k, or
    the tf32 plan at D = 32 raises instead of launching."""
    q = randn((1, 64, 2, 64), 67, cuda, torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        flash_fwd_split(q.to(torch.bfloat16), q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="fp32"):
        flash_bwd_split(q, q, q, q[:, :, :1])
    q32 = randn((1, 64, 2, 32), 68, cuda, torch.float32)
    with pytest.raises(RuntimeError, match="plan"):
        flash_attention_fwd_kernel(q32, q32, q32, plan=TF32_PLAN)
    o, lse = flash_attention_fwd_kernel(q32, q32, q32, with_lse=True)
    with pytest.raises(RuntimeError, match="plan"):
        flash_attention_bwd_kernel(q32, q32, q32, o, lse, q32, plan=TF32_BWD_PLAN)


# ---------------------------------------------------------------------------
# int8 W8A8: S1 (s8 wgmma conv), S2 (general int8 conv), S3 (the quantiser),
# each bitwise against its plain version: the int32 sums and the output

def _int8_operands(xs, cout, ksize, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rq = lambda shape: torch.randint(-127, 128, shape, generator=gen, device="cuda",  # noqa: E731
                                     dtype=torch.int32).to(torch.int8)
    return (rq(tuple(xs)), rq((cout, xs[-1], *ksize)),
            torch.rand(xs[0], generator=gen, device="cuda") * 1e-2 + 1e-3,
            torch.rand(cout, generator=gen, device="cuda") * 1e-3 + 1e-4,
            torch.randn(cout, generator=gen, device="cuda"))


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 32, 32, 32, 64), 64), ((2, 32, 16, 16, 192), 128), ((1, 32, 4, 4, 1024), 512),
    ((1, 5, 6, 7, 48), 40), ((3, 3, 9, 17, 16), 300), ((1, 4, 4, 4, 4896), 16)])
def test_int8_s1_matches_plain(cuda, shape, cout, out_dtype):
    """S1 at the flagship's levels, a half-filled channel chunk (192), Cin =
    1024 over four N tiles, ragged volumes and Cout, and the largest Cin its
    int32 sums allow."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands(shape, cout, (3, 3, 3), seed=sum(shape) + cout)
    before = launch_counts["conv3d_s8"]
    got = k.conv3d_s8_kernel(xq, s_x, k.s1_weights(wq), s_w, bias, out_dtype)
    want = k.conv_int8_plain(xq, s_x, wq, s_w, bias, (1, 1, 1), [(1, 1)] * 3, out_dtype)
    assert launch_counts["conv3d_s8"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,ksize,stride,pads", [
    ((2, 32, 32, 32, 64), 64, (3, 3, 3), (1, 2, 2), ((1, 1),) * 3),
    ((2, 9, 10, 24), 32, (3, 3), (2, 2), ((1, 1),) * 2),
    ((2, 33, 20), 24, (3,), (1,), ((1, 1),)),
    ((1, 5, 5, 5, 17), 16, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3),
    ((1, 6, 6, 6, 32), 20, (2, 2, 2), (1, 1, 1), ((0, 1),) * 3)])
def test_int8_s2_matches_plain(cuda, shape, cout, ksize, stride, pads, out_dtype):
    """S2 on the Downsample (kept on request: the route takes S1's block
    there), 2-D, 1-D, a ragged Cin (17: byte loads) and an even kernel with
    XLA's asymmetric SAME pads."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands(shape, cout, ksize, seed=len(shape) + cout)
    got = k.conv_s8_general_kernel(xq, s_x, k.s2_weights(wq), s_w, bias, ksize, stride, pads,
                                   out_dtype)
    want = k.conv_int8_plain(xq, s_x, wq, s_w, bias, stride, pads, out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((8, 32, 32, 32, 64), 64), ((8, 32, 16, 16, 128), 128), ((8, 32, 8, 8, 256), 256),
    ((2, 5, 13, 11, 32), 48), ((1, 3, 7, 9, 16), 300), ((1, 4, 4, 4, 1024), 512)])
def test_int8_strided_matches_plain_and_s2(cuda, shape, cout, out_dtype):
    """The Downsample on S1's block (stride (1, 2, 2), pads (1, 1)): the
    flagship's three at batch 8, ragged odd H and W, Cout over N tiles and
    a wide Cin, bitwise against the plain version and against S2 on the
    same inputs."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands(shape, cout, (3, 3, 3), seed=sum(shape) + cout + 1)
    stride, pads = (1, 2, 2), [(1, 1)] * 3
    assert k.int8_conv_route(shape, (3, 3, 3), stride, pads, cout) == "s1_strided"
    launch_counts.clear()
    got = k.conv3d_s8_strided_kernel(xq, s_x, k.s1_weights(wq), s_w, bias, out_dtype)
    assert launch_counts == {"conv3d_s8_strided": 1}
    want = k.conv_int8_plain(xq, s_x, wq, s_w, bias, stride, pads, out_dtype)
    s2 = k.conv_s8_general_kernel(xq, s_x, k.s2_weights(wq), s_w, bias, (3, 3, 3), stride, pads,
                                  out_dtype)
    assert torch.equal(got, want) and torch.equal(got, s2)


def test_int8_strided_refuses_what_it_does_not_take(cuda):
    """Cin off the 16-byte multiple raises and names it; S2 keeps that case."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands((1, 4, 8, 8, 24), 32, (3, 3, 3), seed=5)
    with pytest.raises(ValueError, match="Cin % 16 == 0"):
        k.conv3d_s8_strided_kernel(xq, s_x, k.s1_weights(wq), s_w, bias)
    assert k.int8_conv_route(tuple(xq.shape), (3, 3, 3), (1, 2, 2), [(1, 1)] * 3, 32) == "s2"


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,cout", [
    ((8, 128, 128, 32), 32), ((8, 64, 64, 96), 64), ((8, 32, 32, 384), 128),
    ((8, 16, 16, 512), 256), ((2, 13, 11, 48), 40), ((1, 8, 8, 16), 300), ((1, 9, 7, 1024), 16)])
def test_int8_2d_matches_plain_and_s2(cuda, shape, cout, stride, out_dtype):
    """The 2-D 3x3 convs on S1's block (the 1x3x3 taps over x as a depth-1
    volume) at stride 1 and the Downsample's 2: DeepGalaxy's levels at batch
    8, ragged odd H and W, an 8 x 8 plane (half of each box past the
    volume), Cout over N tiles and a wide Cin, bitwise against the plain
    version and against S2 on the same inputs."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands(shape, cout, (3, 3), seed=sum(shape) + cout + stride)
    strides, pads = (stride,) * 2, [(1, 1)] * 2
    route = k.int8_conv_route(shape, (3, 3), strides, pads, cout)
    assert route == ("s1_2d" if stride == 1 else "s1_2d_strided")
    name = "conv2d_s8" if stride == 1 else "conv2d_s8_strided"
    launch = k.conv2d_s8_kernel if stride == 1 else k.conv2d_s8_strided_kernel
    launch_counts.clear()
    got = launch(xq, s_x, k.s1_2d_weights(wq), s_w, bias, out_dtype)
    assert launch_counts == {name: 1}
    want = k.conv_int8_plain(xq, s_x, wq, s_w, bias, strides, pads, out_dtype)
    s2 = k.conv_s8_general_kernel(xq, s_x, k.s2_weights(wq), s_w, bias, (3, 3), strides, pads,
                                  out_dtype)
    assert got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(got, s2)


def test_int8_2d_refuses_what_it_does_not_take(cuda):
    """Cin off the 16-byte multiple and 3-D operands raise and name them;
    S2 keeps the first."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands((1, 8, 8, 24), 32, (3, 3), seed=6)
    for launch in (k.conv2d_s8_kernel, k.conv2d_s8_strided_kernel):
        with pytest.raises(ValueError, match="Cin % 16 == 0"):
            launch(xq, s_x, k.s1_2d_weights(wq), s_w, bias)
    assert k.int8_conv_route(tuple(xq.shape), (3, 3), (1, 1), [(1, 1)] * 2, 32) == "s2"
    x3, w3, s_x, s_w, bias = _int8_operands((1, 4, 8, 8, 32), 32, (3, 3, 3), seed=7)
    with pytest.raises(ValueError, match=r"w \[Cout,9,Cin\]"):
        k.conv2d_s8_kernel(x3, s_x, k.s1_weights(w3), s_w, bias)


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,cout", [
    ((8, 4096, 32), 32), ((8, 2048, 64), 64), ((8, 1024, 192), 128), ((8, 512, 512), 256),
    ((2, 37, 48), 40), ((1, 100, 16), 300), ((1, 33, 1024), 16)])
def test_int8_1d_matches_plain_and_s2(cuda, shape, cout, stride, out_dtype):
    """The 1-D 3-tap convs on S1's block (the 1x1x3 taps over x as the
    volume [B, 1, 1, W, Cin], strided along W alone) at stride 1 and the
    Downsample's 2: Spectroscopy's levels at batch 8 (level 3: 32 boxes,
    Cout split into N tiles), ragged lengths, Cout over N tiles and a wide
    Cin, bitwise against the plain version and against S2 on the same
    inputs."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands(shape, cout, (3,), seed=sum(shape) + cout + stride)
    strides, pads = (stride,), [(1, 1)]
    route = k.int8_conv_route(shape, (3,), strides, pads, cout)
    assert route == ("s1_1d" if stride == 1 else "s1_1d_strided")
    name = "conv1d_s8" if stride == 1 else "conv1d_s8_strided"
    launch = k.conv1d_s8_kernel if stride == 1 else k.conv1d_s8_strided_kernel
    launch_counts.clear()
    got = launch(xq, s_x, k.s1_1d_weights(wq), s_w, bias, out_dtype)
    assert launch_counts == {name: 1}
    want = k.conv_int8_plain(xq, s_x, wq, s_w, bias, strides, pads, out_dtype)
    s2 = k.conv_s8_general_kernel(xq, s_x, k.s2_weights(wq), s_w, bias, (3,), strides, pads,
                                  out_dtype)
    assert got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(got, s2)


def test_int8_1d_refuses_what_it_does_not_take(cuda):
    """Cin off the 16-byte multiple and 2-D operands raise and name them;
    S2 keeps the first."""
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    xq, wq, s_x, s_w, bias = _int8_operands((1, 64, 24), 32, (3,), seed=8)
    for launch in (k.conv1d_s8_kernel, k.conv1d_s8_strided_kernel):
        with pytest.raises(ValueError, match="Cin % 16 == 0"):
            launch(xq, s_x, k.s1_1d_weights(wq), s_w, bias)
    assert k.int8_conv_route(tuple(xq.shape), (3,), (1,), [(1, 1)], 32) == "s2"
    x2, w2, s_x, s_w, bias = _int8_operands((1, 8, 8, 32), 32, (3, 3), seed=9)
    with pytest.raises(ValueError, match=r"w \[Cout,3,Cin\]"):
        k.conv1d_s8_kernel(x2, s_x, k.s1_2d_weights(w2), s_w, bias)


@pytest.mark.parametrize("shape,dtype", [
    ((8, 32, 32, 32, 64), torch.bfloat16), ((1, 32, 4, 4, 1024), torch.bfloat16),
    ((3, 7, 5, 24), torch.float32), ((4, 17), torch.float32), ((2, 9, 9, 9, 33), torch.bfloat16),
    ((512, 27 * 1024), torch.float32)])
def test_int8_s3_matches_plain(cuda, shape, dtype):
    from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k

    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device="cuda") * torch.rand(
        (shape[0],) + (1,) * (len(shape) - 1), generator=gen, device="cuda") * 3
    x = x.to(dtype)
    q, s = k.quantize_rows_kernel(x)
    qp, sp = k.quantize_rows_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
