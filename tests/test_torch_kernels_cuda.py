"""The port's hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (with its reason) where there is no CUDA
device, so on a CPU-only machine this file counts no passes. On the card,
whose Python has no JAX, run it without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover the ragged edges the flagship does not reach: voxel counts and
Cout off the 128 x 64 tiles, reduction depths off the 32-deep stage, Cin=1
and Cout=1, fp32, strided q/k/v, padded head dims and Tq != Tk, for both
dtypes of the flash kernel; and the ring-attention kernel (K6) in its ring
of 2 and 4 ranks on one card at T/n = 128 and 1024, ragged shards and a
padded head dim, and with one rank per card where there are two or more.
The plain versions run in fp32 with TF32 off; tolerances are
chip_smoke.py's.
"""
import math

import pytest
import torch

from rho_diffusion_tpu_torch.ops.attention import xla_attention
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import (
    conv3d, conv3d_dgrad, conv3d_dgrad_plain, conv3d_plain)
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_plain, flash_lse_plain)
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
        ((2, 6, 6, 6, 1), 64, torch.bfloat16, "conv3d_direct"),    # the UNet's input conv
        ((2, 6, 6, 6, 12), 5, torch.bfloat16, "conv3d_direct"),    # Cin % 8 != 0
        ((2, 6, 6, 6, 1), 64, torch.float32, "conv3d_direct"),
        ((2, 6, 6, 6, 64), 1, torch.float32, "conv3d_direct"),     # the fp32 output head
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
    assert launch_counts == {"flash_attention": 1}
    assert got.shape == (b, tq, h, d) and got.dtype == dtype
    want = xla_attention(q.float(), k.float(), v.float())
    err = got.float() - want
    tol = TOL_FLASH[dtype]
    assert float(err.abs().max()) <= tol * float(want.abs().max())
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= tol


def test_flash_kernel_rejects_float16(cuda):
    q = randn((1, 8, 1, 32), 0, cuda, torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q, q, q)


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
    ],
)
def test_flash_backward_kernels_match_plain(cuda, b, tq, tk, h, d, dtype):
    q = randn((b, tq, h, d), 5, cuda, dtype).requires_grad_()
    kv = randn((b, tk, h, 2 * d), 6, cuda, dtype).requires_grad_()
    do = randn((b, tq, h, d), 7, cuda, dtype)
    launch_counts.clear()
    dq, dkv = flash_grads(q, kv, do, d)
    torch.cuda.synchronize()
    assert launch_counts == {"flash_attention": 1, "flash_attention_bwd_dkv": 1,
                             "flash_attention_bwd_dq": 1}
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


@pytest.mark.parametrize(
    "gshape,cin,dtype,kernel",
    [
        ((2, 5, 6, 7, 64), 64, torch.bfloat16, "conv3d_dgrad_igemm"),
        ((1, 3, 5, 4, 72), 8, torch.bfloat16, "conv3d_dgrad_igemm"),   # Cin off the 64 tile
        ((2, 4, 4, 4, 24), 10, torch.bfloat16, "conv3d_dgrad_igemm"),  # odd Cin
        ((2, 6, 6, 6, 12), 5, torch.bfloat16, "conv3d_dgrad_direct"),  # Cout % 8 != 0
        ((2, 6, 6, 6, 1), 64, torch.float32, "conv3d_dgrad_direct"),   # the fp32 head's dgrad
        ((2, 5, 6, 7, 16), 24, torch.float32, "conv3d_dgrad_direct"),
    ],
)
def test_conv3d_dgrad_kernel_matches_plain(cuda, gshape, cin, dtype, kernel):
    cout = gshape[-1]
    g = randn(gshape, 11, cuda, dtype)
    w = randn((cout, cin, 3, 3, 3), 12, cuda, dtype, 1 / math.sqrt(27 * cout))
    launch_counts.clear()
    got = conv3d_dgrad(g, w)
    torch.cuda.synchronize()
    assert launch_counts == {kernel: 1}
    assert got.dtype == dtype and got.shape == (*gshape[:-1], cin)
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_FP32
    torch.testing.assert_close(got.float(), conv3d_dgrad_plain(g.float(), w.float()),
                               atol=tol, rtol=tol)


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


def test_unet_training_step_reaches_every_parameter(cuda):
    """One bf16 loss.backward() of a small 3-D UNet on the card: every
    parameter gets a finite gradient (no kernel cuts the graph), and the
    step went through the forward and backward kernels."""
    from rho_diffusion_tpu_torch.models.unet import UNet

    torch.manual_seed(0)
    unet = UNet(data_shape=(4, 8, 8), in_channels=1, model_channels=32, out_channels=1,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                dims=3, num_heads=2, use_scale_shift_norm=True, dtype="bfloat16").to(cuda)
    with torch.no_grad():
        for p in unet.parameters():  # no zero-initialised heads
            p.copy_(torch.randn_like(p) / math.sqrt(p[0].numel() if p.dim() > 1 else 50))
    x = randn((2, 4, 8, 8, 1), 17, cuda, torch.float32)
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
    for kernel in ("conv3d_igemm", "conv3d_direct", "conv3d_dgrad_igemm", "conv3d_dgrad_direct",
                   "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert launch_counts[kernel] > 0, kernel


def ring_inputs(b, t, h, d, dtype, device, seed):
    """q, k, v as the UNet makes them: strided views of one fused qkv."""
    return randn((b, t, h, 3 * d), seed, device, dtype).split(d, dim=-1)


def assert_flash_close(got, want, dtype):
    err = got.float() - want
    tol = TOL_FLASH[dtype]
    assert float(err.abs().max()) <= tol * float(want.abs().max())
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "n,b,tl,h,d",
    [
        (4, 8, 128, 4, 128),   # the flagship's serve shape: bucket 8, 4 ranks
        (2, 8, 128, 4, 128),   # n = 2: one send, no backpressure
        (4, 2, 1024, 4, 128),  # the 64^3 config's T/n = 1024
        (2, 1, 150, 3, 100),   # ragged key tiles, head dim padded to 128
    ],
)
def test_ring_attention_kernel_matches_plain(cuda, n, b, tl, h, d, dtype):
    """K6 in its ring of n ranks on one card against the same ring with the
    plain step (fp32 inputs) and against full attention."""
    q, k, v = ring_inputs(b, n * tl, h, d, dtype, cuda, seed=20)
    mesh = make_mesh(data=1, context=n, devices=[cuda] * n)
    launch_counts.clear()
    got = context_sharded_attention(q, k, v, mesh, impl="rdma")
    torch.cuda.synchronize()
    assert launch_counts == {"ring_attention": n * n}
    assert got.shape == q.shape and got.dtype == dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    assert_flash_close(got, context_sharded_attention(qf, kf, vf, mesh, impl="rdma", plain=True),
                       dtype)
    assert_flash_close(got, xla_attention(qf, kf, vf), dtype)


def test_ring_attention_kernel_one_rank_per_card(cuda):
    """The ring over separate cards: peer copies between the ranks."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    n = min(count, 4)
    devices = [torch.device("cuda", i) for i in range(n)]
    q, k, v = ring_inputs(8, n * 128, 4, 128, torch.bfloat16, cuda, seed=21)
    launch_counts.clear()
    got = context_sharded_attention(q, k, v, make_mesh(context=n, devices=devices), impl="rdma")
    torch.cuda.synchronize()
    assert launch_counts == {"ring_attention": n * n}
    assert_flash_close(got, xla_attention(q.float(), k.float(), v.float()), torch.bfloat16)


def test_ring_attention_kernel_refuses_autograd(cuda):
    q = randn((1, 64, 2, 64), 22, cuda, torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="grad mode"):
        context_sharded_attention(q, q, q, make_mesh(context=2, devices=[cuda] * 2), impl="rdma")
