"""The port's hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (with its reason) where there is no CUDA
device, so on a CPU-only machine this file counts no passes. On the card,
whose Python has no JAX, run it without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover the ragged edges the flagship does not reach: voxel counts and
Cout off the 128 x 64 tiles, reduction depths off the 32-deep stage, Cin=1
and Cout=1, fp32, strided q/k/v, padded head dims and Tq != Tk, for both
dtypes of the flash kernel. The plain versions run in fp32 with TF32 off;
tolerances are chip_smoke.py's.
"""
import math

import pytest
import torch

from rho_diffusion_tpu_torch.ops.attention import xla_attention
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

pytestmark = pytest.mark.cuda

TOL_BF16 = 2.0 ** -6  # bf16 output rounding (2^-8 relative) plus summation order
TOL_FP32 = 1e-4
# flash, relative to the reference's max (per element) and rms (overall):
# outputs are softmax averages of rms ~1/sqrt(T), so a fixed atol would hide
# a dropped key tile
TOL_FLASH = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}


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
