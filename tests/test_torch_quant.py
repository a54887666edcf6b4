"""The port's int8 W8A8 inference (``rho_diffusion_tpu_torch/ops/quant.py``)
against the JAX package's ``rho_diffusion_tpu/ops/quant.py``, on the CPU.

Inputs are made with numpy; the JAX side runs its modules unchanged. On the
CPU each of the port's kernels is its plain version (``ops/kernels/
conv_int8.py``), which is what these hold; on the card chip_smoke's ``int8``
phase holds S1-S3 bitwise against the same plain versions.

* ``quantize_int8``, the int8 conv (dims 1, 2 and 3, strided, zero-init,
  ragged Cin = 24) and the int8 Dense (a [b, tokens, c] input of <= 16 rows,
  so the padding of the int8 product runs) equal JAX's bit for bit, in fp32
  and in bf16.
* The Downsample's route on the card (``conv3d_s8_strided``, S1's block
  with x's tensor map walked every other voxel along H and W) emulated in
  numpy box by box: ``igemm_plan``'s boxes on the output's shape, each
  tap's origin, TMA's element-stride gather with its zero fill, 128-channel
  chunks; its int32 sums equal JAX's ``ConvInt8`` product and, dequantised
  as the epilogue does, its output, bit for bit, on the flagship's three
  Downsamples cut to batch 1 and depth 4, and a ragged H and W. The 2-D
  routes (``conv2d_s8`` and ``conv2d_s8_strided``: S1's block over x as a
  depth-1 volume with the 1x3x3 tap set, weights ``s1_2d_weights``) are
  walked the same way against JAX's 2-D ``ConvInt8`` at DeepGalaxy's 2-D
  shapes cut to batch 1, and every int8 conv of the 2-D DeepGalaxy UNet
  (128^2, width 32) is on its route: every 3x3 conv with Cin % 16 == 0 on
  a 2-D route, S2 on none (its Cin = 1 input conv stays float, and S2 is
  its route were it quantised).
* Layers under 16 channels stay float in ``self.dtype or x.dtype``. A
  float conv sums its products in another order than XLA's, so these are
  held at fp32's summation error (1e-5 relative to the largest output) in
  fp32 and within one bf16 rounding (2^-8 relative) in bf16, where at
  least 99 % of the elements are equal.
* Per-sample activation scales: a row alone equals the row co-batched with
  a 1e3-scaled one, bitwise. int8 wins over ``set_conv3d_backend``. The
  training step raises. The weight cache quantises again after an in-place
  update and after ``load_state_dict``.
* A tiny UNetv2 (width 16, so its layers really quantize; 3-D, attention)
  int8 forward against JAX's int8 forward, row by row over 12 draws of
  (x_t, t). The float layers (GroupNorm, SiLU, attention, the time MLP)
  round differently in the two frameworks, and where that moves an
  activation across a rounding boundary of round(x / s) the two sides pick
  neighbouring integers; the network carries such a flip forward, and the
  later quantizers flip more values. So both sides' 31 activation
  quantizers are recorded a forward, and the port runs a second time on
  JAX's int8 activations (and scales). Held: each quantizer's input within
  1e-5 of its row's max of JAX's (measured 8.3e-7), the scales within
  1e-6, and every int8 value that differs one quantum away at a near tie
  (both sides' x / s within 1e-3 of each other, measured 2.7e-5, on either
  side of the half-integer between them; at most 16 a forward, measured 0
  to 4); on JAX's activations every row at relative MSE < 1e-6 (measured
  5.1e-14 to 1.4e-13), and a row whose quantizers never flipped likewise
  when the port runs free. Running free, 7 of the 24 rows flipped and
  reached up to 1.2e-3, against the int8 model's own distance to the float
  one of 1.7e-3 to 2.8e-3.
* DDIM sampling (eta 0 from a shared x_T, and eta 0.5 with x_T and every
  step's noise injected into both frameworks) against JAX's: six steps give
  a flip nearly every row a chance to cascade, so the sample is held at
  relative MSE < 1e-3 (measured 1.0e-4 to 2.9e-4, about the int8 model's
  distance to the float one at this size): it holds the sampler over the
  int8 model end to end; the model's own agreement is the forward test's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Int8Sites, random_state_dict
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.ops import quant as jax_quant
from rho_diffusion_tpu.ops.convolution import conv_nd as jax_conv_nd
from rho_diffusion_tpu.ops.quant import (ConvInt8, DenseInt8, conv_quant as jax_conv_quant,
                                         dense as jax_dense, quantize_int8 as jax_quantize_int8)
from rho_diffusion_tpu_torch.benchmarks import conv_int8_probe
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.ops import convolution
from rho_diffusion_tpu_torch.ops import quant
from rho_diffusion_tpu_torch.ops.convolution import Conv1x1, ConvNd, set_conv3d_backend
from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k
from rho_diffusion_tpu_torch.ops.kernels.conv3d import igemm_plan
from rho_diffusion_tpu_torch.ops.quant import conv_quant, get_conv_quant, quantize_int8
from test_torch_gaussian_sampling import Injected, jax_params, jit_backbone

torch.set_num_threads(1)

REL_MSE_MODEL = 1e-6
REL_MSE_SAMPLE = 1e-3
FORWARD_DRAWS = 12
TIE = 1e-3  # quanta: how far apart two sides' x / s may lie at a flip
FLIPS_PER_FORWARD = 16


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def as_np(t) -> np.ndarray:
    """A torch or JAX array as fp32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def inputs(shape, seed: int, spread: bool = True) -> np.ndarray:
    """Gaussian values, each row scaled differently (so per-sample scales
    differ), with some exact multiples of a half quantum to hit the
    round-half-to-even ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if spread:
        x *= rng.uniform(0.1, 10.0, size=(shape[0],) + (1,) * (len(shape) - 1)).astype(np.float32)
    flat = x.reshape(shape[0], -1)
    flat[:, 0] = 127.0  # amax = 127: the scale is exactly 1 ...
    flat[:, 1:6] = [0.5, 1.5, -2.5, 3.5, -0.5]  # ... and these are ties
    return flat.reshape(shape)


def pair_dtype(x: np.ndarray, dtype: str):
    """The same values in both frameworks, cast to ``dtype`` (RNE on both)."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


# ---------------------------------------------------------------------------
# quantize_int8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,dims", [((3, 5, 6, 7, 24), (1, 2, 3, 4)), ((4, 33), (1,)),
                                        ((6, 2, 3, 3, 3), (1, 2, 3, 4)), ((48, 32), (1,)),
                                        ((5, 7, 16), (0, 1))],
                         ids=["activation-3d", "rows", "weight", "dense-weight", "leading"])
def test_quantize_int8_bitwise(shape, dims, dtype):
    t, j = pair_dtype(inputs(shape, seed=len(shape) + dims[0]), dtype)
    q, s = quantize_int8(t, dims)
    jq, js = jax_quantize_int8(j, dims)
    assert q.dtype == torch.int8 and q.abs().max() <= 127
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if dims[0] == 1:  # the per-row form the kernels use
        qr, sr = k.quantize_rows(t)
        assert torch.equal(qr, q) and torch.equal(sr, s.reshape(-1))


# ---------------------------------------------------------------------------
# the int8 conv

def conv_pair(dims: int, cin: int, cout: int, stride, dtype: str, zero_init: bool = False,
              seed: int = 0):
    """(port ConvNd, JAX module, JAX variables) with the same weights; the
    JAX module built as ``conv_nd`` builds it under int8."""
    rng = np.random.default_rng(seed)
    kernel = np.zeros((*(3,) * dims, cin, cout), np.float32) if zero_init else (
        rng.normal(size=(*(3,) * dims, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    port = ConvNd(dims, cin, cout, 3, stride=stride, dtype=tdt, zero_init=zero_init)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel).permute(dims + 1, dims, *range(dims)))
        port.bias.copy_(torch.from_numpy(bias))
    with jax_conv_quant("int8"):
        jmod = jax_conv_nd(dims, cout, 3, stride=stride, zero_init=zero_init,
                           dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    return port, jmod, {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}


CONV_CASES = {
    "1d": (1, (2, 20), 32, 48, 1),
    "2d": (2, (2, 9, 10), 32, 48, 1),
    "3d": (3, (2, 6, 5, 7), 32, 48, 1),
    "2d-stride2": (2, (2, 8, 8), 32, 32, 2),
    "3d-stride122": (3, (2, 4, 8, 8), 32, 32, (1, 2, 2)),
    "3d-zero-init": (3, (2, 4, 4, 4), 32, 32, 1),
    "3d-cin24": (3, (2, 5, 6, 7), 24, 40, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_int8_bitwise_against_jax(case, dtype):
    dims, spatial, cin, cout, stride = CONV_CASES[case]
    port, jmod, variables = conv_pair(dims, cin, cout, stride, dtype,
                                      zero_init=case.endswith("zero-init"))
    assert isinstance(jmod, ConvInt8)
    t, j = pair_dtype(inputs((*spatial, cin), seed=dims), dtype)
    want = jmod.apply(variables, j)
    with conv_quant("int8"), torch.no_grad():
        got = port(t)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(as_np(got), as_np(want))
    if case.endswith("zero-init"):
        np.testing.assert_array_equal(as_np(got), np.broadcast_to(as_np(port.bias.to(got.dtype)),
                                                                  got.shape))
    else:
        assert np.abs(as_np(want)).max() > 0.1


def strided_route_sums(xq: np.ndarray, wq: np.ndarray, sw: int = 2) -> np.ndarray:
    """The int32 sums of the Downsample's route on the card, walked as the
    kernel walks them: xq [B, D, H, W, Cin] int8, wq [Cout, Cin, 3, 3, 3]
    int8, the conv at stride (1, 2, 2) with pads (1, 1). Each block is one
    of ``igemm_plan``'s boxes of bw x bh x bd = 128 output voxels (W
    fastest), taken on the output's shape. For each of the 27 taps the x
    map's box starts at (2 w0 + dx - 1, 2 h0 + dy - 1, d0 + dz - 1) and
    spans 2 bw x 2 bh x bd voxels with element strides (2, 2, 1), so TMA
    brings ceil(2 bw / 2) = bw voxels along W (likewise H), zero outside x;
    the products run over 128-channel chunks (zero past Cin). Rows of a box
    past the output are dropped. The 2-D routes' walk: xq [B, H, W, Cin]
    and wq [Cout, Cin, 3, 3], at stride (sw, sw), as the depth-1 volume
    [B, 1, H, W, Cin] over the 9 taps of the 1x3x3 set (dz the centre
    plane) with the [Cout, 9, Cin] weights of ``s1_2d_weights``. The 1-D
    routes' walk: xq [B, W, Cin] and wq [Cout, Cin, 3], at stride sw along
    W alone (x's map strides W, not H), as the volume [B, 1, 1, W, Cin]
    over the 3 taps of the 1x1x3 set (dz and dy the centre) with the [Cout,
    3, Cin] weights of ``s1_1d_weights``."""
    rank = xq.ndim
    xq = xq.reshape(xq.shape[0], *(1,) * (5 - rank), *xq.shape[1:])
    taps = {5: 27, 4: 9, 3: 3}[rank]
    b_, d_, h_, w_, cin = xq.shape
    cout = wq.shape[0]
    kd, kh = (3, 3) if taps == 27 else (1, 3) if taps == 9 else (1, 1)
    sh = sw if kh == 3 else 1  # the stride along H: none in 1-D
    out_sp = k.conv_out_spatial((d_, h_, w_), (kd, kh, 3), (1, sh, sw),
                                ((kd // 2, kd // 2), (kh // 2, kh // 2), (1, 1)))
    plan = igemm_plan((b_, *out_sp, cin), cout)
    bw, bh, bd = plan.bw, plan.bh, plan.bd
    assert bw * bh * bd == 128 and max(sw * bw, sh * bh) <= 256  # TMA's box extents
    assert -(-sw * bw // sw) == bw and -(-sh * bh // sh) == bh
    layout = {27: k.s1_weights, 9: k.s1_2d_weights, 3: k.s1_1d_weights}[taps]
    w1 = layout(torch.from_numpy(wq)).numpy().astype(np.int64)  # [Cout, taps, Cin]
    assert w1.shape == (cout, taps, cin)
    chunks = -(-cin // 128)
    wt = np.zeros((cout, taps, chunks * 128), np.int64)
    wt[..., :cin] = w1
    r = np.arange(128)
    dd, hh, ww = r // (bw * bh), r // bw % bh, r % bw
    out = np.zeros((b_, *out_sp, cout), np.int64)
    for b in range(b_):
        for d0 in range(0, out_sp[0], bd):
            for h0 in range(0, out_sp[1], bh):
                for w0 in range(0, out_sp[2], bw):
                    acc = np.zeros((128, cout), np.int64)
                    for tap in range(taps):
                        dz = tap // 9 if taps == 27 else 1
                        dy = tap // 3 % 3 if taps != 3 else 1
                        dx = tap % 3
                        z = d0 + dz - 1 + dd
                        y = sh * h0 + dy - 1 + sh * hh
                        x = sw * w0 + dx - 1 + sw * ww
                        inside = (z >= 0) & (z < d_) & (y >= 0) & (y < h_) & (x >= 0) & (x < w_)
                        a = np.zeros((128, chunks * 128), np.int64)
                        a[inside, :cin] = xq[b, z[inside], y[inside], x[inside]]
                        for c in range(chunks):
                            cs = slice(128 * c, 128 * (c + 1))
                            acc += a[:, cs] @ wt[:, tap, cs].T
                    keep = (d0 + dd < out_sp[0]) & (h0 + hh < out_sp[1]) & (w0 + ww < out_sp[2])
                    out[b, (d0 + dd)[keep], (h0 + hh)[keep], (w0 + ww)[keep]] = acc[keep]
    assert np.abs(out).max() < 2**31
    return out.reshape(b_, *out_sp[5 - rank:], cout).astype(np.int32)


@pytest.mark.parametrize("shape,cout", [
    ((1, 4, 32, 32, 64), 64),     # the flagship's level-0 Downsample, batch 1, depth 4
    ((1, 4, 16, 16, 128), 128),   # level 1
    ((1, 4, 8, 8, 256), 256),     # level 2: one box over 8 depth planes, 4 of them past D
    ((2, 3, 13, 11, 32), 48),     # ragged H and W: odd sides, boxes past the output
])
def test_strided_route_box_walk_against_jax(shape, cout):
    """The Downsample's route is "s1_strided"; its box walk's int32 sums
    equal the integer product of JAX's ``ConvInt8`` (ops/quant.py:143-153,
    as ``conv_nd`` builds it for a strided SAME conv: pads k // 2), and
    dequantised as the kernel's epilogue does (``dequantize_plain``) they
    equal ``ConvInt8``'s output bit for bit, in fp32 and in bf16."""
    assert k.int8_conv_route(shape, (3, 3, 3), (1, 2, 2), [(1, 1)] * 3, cout) == "s1_strided"
    rng = np.random.default_rng(sum(shape) + cout)
    x = inputs(shape, seed=sum(shape))
    kernel = (rng.normal(size=(3, 3, 3, shape[-1], cout)) / np.sqrt(27 * shape[-1])).astype(
        np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    with jax_conv_quant("int8"):
        jmod = jax_conv_nd(3, cout, 3, stride=(1, 2, 2))
    assert isinstance(jmod, ConvInt8) and tuple(map(tuple, jmod.padding)) == ((1, 1),) * 3
    # the quantised operands, as ConvInt8 makes them
    w_q, s_w = jax_quantize_int8(jnp.asarray(kernel), axes=(0, 1, 2, 3))
    x_q, s_x = jax_quantize_int8(jnp.asarray(x), axes=(1, 2, 3, 4))
    want = np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, (1, 2, 2), jmod.padding, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        preferred_element_type=jnp.int32))
    wq = np.ascontiguousarray(np.asarray(w_q).transpose(4, 3, 0, 1, 2))  # [Cout, Cin, 3, 3, 3]
    got = strided_route_sums(np.asarray(x_q), wq)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.bfloat16 if dtype == "bfloat16" else None
        with jax_conv_quant("int8"):
            jmod = jax_conv_nd(3, cout, 3, stride=(1, 2, 2), dtype=jdt)
        y = jmod.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                       jnp.asarray(x))
        deq = k.dequantize_plain(torch.from_numpy(got), torch.from_numpy(np.array(s_x)),
                                 torch.from_numpy(np.array(s_w)), torch.from_numpy(bias),
                                 torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(as_np(deq), as_np(y))


@pytest.mark.parametrize("shape,cout,stride", [
    ((1, 128, 128, 32), 32, 1),    # DeepGalaxy's level 0 (128^2, width 32), batch 1
    ((1, 128, 128, 32), 32, 2),    # its level-0 Downsample
    ((1, 64, 64, 96), 64, 1),      # a decoder concat at level 1
    ((1, 32, 32, 192), 128, 1),
    ((1, 16, 16, 512), 256, 1),    # level 3: 512 channels, four 128-channel chunks
    ((2, 13, 11, 48), 40, 2),      # ragged H and W at stride 2: boxes past the output
    ((2, 9, 10, 32), 48, 1),       # ragged, Cout off the N tiles
])
def test_2d_routes_box_walk_against_jax(shape, cout, stride):
    """The 2-D 3x3 convs' routes are "s1_2d" (stride 1) and "s1_2d_strided"
    (stride 2, the 2-D Downsample; JAX pads k // 2); their box walk over
    the 1x3x3 taps with ``s1_2d_weights``' layout sums to the integer
    product of JAX's 2-D ``ConvInt8`` (ops/quant.py:143-153), and
    dequantised as the epilogue does it equals ``ConvInt8``'s output bit
    for bit, in fp32 and in bf16."""
    route = {1: "s1_2d", 2: "s1_2d_strided"}[stride]
    assert k.int8_conv_route(shape, (3, 3), (stride,) * 2, [(1, 1)] * 2, cout) == route
    rng = np.random.default_rng(sum(shape) + cout + stride)
    x = inputs(shape, seed=sum(shape) + stride)
    kernel = (rng.normal(size=(3, 3, shape[-1], cout)) / np.sqrt(9 * shape[-1])).astype(
        np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    with jax_conv_quant("int8"):
        jmod = jax_conv_nd(2, cout, 3, stride=stride)
    # JAX's stride-1 3x3 "SAME" is pads (1, 1); its strided one pads k // 2
    assert isinstance(jmod, ConvInt8)
    assert (jmod.padding == "SAME" if stride == 1
            else tuple(map(tuple, jmod.padding)) == ((1, 1),) * 2)
    w_q, s_w = jax_quantize_int8(jnp.asarray(kernel), axes=(0, 1, 2))
    x_q, s_x = jax_quantize_int8(jnp.asarray(x), axes=(1, 2, 3))
    want = np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, (stride,) * 2, jmod.padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    wq = np.ascontiguousarray(np.asarray(w_q).transpose(3, 2, 0, 1))  # [Cout, Cin, 3, 3]
    w9 = k.s1_2d_weights(torch.from_numpy(wq))
    assert tuple(w9.shape) == (cout, 9, shape[-1])
    assert torch.equal(w9[:, 3 * 2 + 1], torch.from_numpy(wq[:, :, 2, 1]))  # tap dy*3+dx
    got = strided_route_sums(np.asarray(x_q), wq, sw=stride)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.bfloat16 if dtype == "bfloat16" else None
        with jax_conv_quant("int8"):
            jmod = jax_conv_nd(2, cout, 3, stride=stride, dtype=jdt)
        y = jmod.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                       jnp.asarray(x))
        deq = k.dequantize_plain(torch.from_numpy(got), torch.from_numpy(np.array(s_x)),
                                 torch.from_numpy(np.array(s_w)), torch.from_numpy(bias),
                                 torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(as_np(deq), as_np(y))


@pytest.mark.parametrize("shape,cout,stride", [
    ((1, 4096, 32), 32, 1),    # Spectroscopy's level 0 (4096 points, width 32), batch 1
    ((1, 4096, 32), 32, 2),    # its level-0 Downsample
    ((1, 2048, 96), 64, 1),    # a decoder concat at level 1
    ((1, 512, 512), 256, 1),   # level 3: 512 channels, four 128-channel chunks
    ((2, 37, 48), 40, 2),      # ragged length at stride 2: a box past the output
    ((2, 100, 16), 300, 1),    # a box past the volume along W, Cout off the N tiles
])
def test_1d_routes_box_walk_against_jax(shape, cout, stride):
    """The 1-D 3-tap convs' routes are "s1_1d" (stride 1) and
    "s1_1d_strided" (stride 2, the 1-D Downsample; JAX pads k // 2); the
    tap-major [Cout, 3, Cin] layout of ``s1_1d_weights``, summed tap by tap
    as the kernel's box walk sums it over the 1x1x3 taps, equals the integer
    product of JAX's 1-D ``ConvInt8`` (ops/quant.py:143-153) and
    ``conv_int8_plain``'s int32 sums, and dequantised as the epilogue does
    it equals ``ConvInt8``'s output bit for bit, in fp32 and in bf16."""
    route = {1: "s1_1d", 2: "s1_1d_strided"}[stride]
    assert k.int8_conv_route(shape, (3,), (stride,), [(1, 1)], cout) == route
    rng = np.random.default_rng(sum(shape) + cout + stride)
    x = inputs(shape, seed=sum(shape) + stride)
    kernel = (rng.normal(size=(3, shape[-1], cout)) / np.sqrt(3 * shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    with jax_conv_quant("int8"):
        jmod = jax_conv_nd(1, cout, 3, stride=stride)
    assert isinstance(jmod, ConvInt8)
    assert (jmod.padding == "SAME" if stride == 1 else tuple(map(tuple, jmod.padding)) == ((1, 1),))
    w_q, s_w = jax_quantize_int8(jnp.asarray(kernel), axes=(0, 1))
    x_q, s_x = jax_quantize_int8(jnp.asarray(x), axes=(1, 2))
    want = np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, (stride,), jmod.padding, dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32))
    wq = np.ascontiguousarray(np.asarray(w_q).transpose(2, 1, 0))  # [Cout, Cin, 3]
    w3 = k.s1_1d_weights(torch.from_numpy(wq))
    assert tuple(w3.shape) == (cout, 3, shape[-1])
    assert torch.equal(w3[:, 2], torch.from_numpy(wq[:, :, 2]))  # tap dx
    got = strided_route_sums(np.asarray(x_q), wq, sw=stride)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plain = k.conv_int32_plain(torch.from_numpy(np.array(x_q)), torch.from_numpy(wq),
                               (stride,), [(1, 1)])
    np.testing.assert_array_equal(got, plain.numpy())
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.bfloat16 if dtype == "bfloat16" else None
        with jax_conv_quant("int8"):
            jmod = jax_conv_nd(1, cout, 3, stride=stride, dtype=jdt)
        y = jmod.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                       jnp.asarray(x))
        deq = k.dequantize_plain(torch.from_numpy(got), torch.from_numpy(np.array(s_x)),
                                 torch.from_numpy(np.array(s_w)), torch.from_numpy(bias),
                                 torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(as_np(deq), as_np(y))


# The 23 distinct int8 conv problems of a 2-D DeepGalaxy UNet forward at
# batch 8 (x, Cout, stride; 3x3, pads (1, 1)) with their calls a forward:
# S2's whole 2-D path before the 2-D routes, as the card's int8 phase
# listed it
DEEP_GALAXY_2D_SITES = {
    ((8, 128, 128, 32), 32, 1): 7, ((8, 128, 128, 32), 32, 2): 1,
    ((8, 128, 128, 64), 32, 1): 2, ((8, 128, 128, 64), 64, 1): 1,
    ((8, 128, 128, 96), 32, 1): 1, ((8, 16, 16, 128), 256, 1): 1,
    ((8, 16, 16, 256), 256, 1): 10, ((8, 16, 16, 384), 256, 1): 1,
    ((8, 16, 16, 512), 256, 1): 2, ((8, 32, 32, 128), 128, 1): 6,
    ((8, 32, 32, 128), 128, 2): 1, ((8, 32, 32, 192), 128, 1): 1,
    ((8, 32, 32, 256), 128, 1): 1, ((8, 32, 32, 256), 256, 1): 1,
    ((8, 32, 32, 384), 128, 1): 1, ((8, 32, 32, 64), 128, 1): 1,
    ((8, 64, 64, 128), 128, 1): 1, ((8, 64, 64, 128), 64, 1): 1,
    ((8, 64, 64, 192), 64, 1): 1, ((8, 64, 64, 32), 64, 1): 1,
    ((8, 64, 64, 64), 64, 1): 6, ((8, 64, 64, 64), 64, 2): 1,
    ((8, 64, 64, 96), 64, 1): 1,
}


def test_deep_galaxy_2d_sites_take_the_2d_routes():
    """Every int8 conv site of the 2-D DeepGalaxy UNet (examples/
    config_deep_galaxy.json at full width, 128^2, batch 1 on the CPU) and
    the route it takes on the card: the 23 problems S2 ran before, each 3x3
    with pads (1, 1) and Cin % 16 == 0, now on "s1_2d" (stride 1) or
    "s1_2d_strided" (the three Downsamples), none on S2. The Cin = 1 input
    conv and the Cout = 1 output conv stay float (the small-layer rule);
    quantised, the input conv would be S2's (Cin % 16 != 0), as Cin 24
    is; a 1-D 3-tap conv with Cin % 16 == 0 takes the 1-D routes."""
    import json
    from pathlib import Path

    from rho_diffusion_tpu_torch.models.unet import UNet

    cfg = json.loads((Path(__file__).resolve().parents[1] / "examples" /
                      "config_deep_galaxy.json").read_text())
    kw = {k_: v for k_, v in cfg["model"]["kwargs"].items() if k_ not in ("num_classes", "cond_fn")}
    unet = UNet(**kw).eval()
    x = torch.from_numpy(inputs((1, 128, 128, 1), seed=8))
    with Int8Sites() as sites, conv_quant("int8"), torch.no_grad():
        out = unet(x, torch.tensor([5]))
    assert tuple(out.shape) == (1, 128, 128, 1) and bool(torch.isfinite(out).all())
    convs = [c for c in sites.calls if c["site"] == "conv"]
    found: dict = {}
    for c in convs:
        if c["route"] == "float":
            continue
        assert c["kernel"] == (3, 3) and c["pads"] == ((1, 1), (1, 1)), c
        key = ((8, *c["x"][1:]), c["cout"], c["stride"][0])
        found[key] = found.get(key, 0) + 1
        assert c["route"] == ("s1_2d" if c["stride"] == (1, 1) else "s1_2d_strided"), c
    assert found == DEEP_GALAXY_2D_SITES
    assert sum(found.values()) == 50  # 50 S2 launches a forward before
    floats = sorted((c["x"][-1], c["cout"]) for c in convs if c["route"] == "float")
    assert floats == [(1, 32), (32, 1)]
    assert k.int8_conv_route((8, 128, 128, 1), (3, 3), (1, 1), [(1, 1)] * 2, 32) == "s2"
    assert k.int8_conv_route((8, 128, 128, 24), (3, 3), (1, 1), [(1, 1)] * 2, 32) == "s2"
    assert k.int8_conv_route((8, 4096, 32), (3,), (1,), [(1, 1)], 32) == "s1_1d"


# The 23 distinct int8 conv problems of a 1-D Spectroscopy UNet forward at
# batch 8 (x, Cout, stride; 3 taps, pads (1, 1)) with their calls a forward:
# S2's whole 1-D path before the 1-D routes, as the card's int8 phase
# listed it
SPECTROSCOPY_1D_SITES = {
    ((8, 4096, 32), 32, 1): 7, ((8, 4096, 32), 32, 2): 1, ((8, 4096, 64), 32, 1): 2,
    ((8, 4096, 64), 64, 1): 1, ((8, 4096, 96), 32, 1): 1, ((8, 2048, 32), 64, 1): 1,
    ((8, 2048, 64), 64, 1): 6, ((8, 2048, 64), 64, 2): 1, ((8, 2048, 96), 64, 1): 1,
    ((8, 2048, 128), 64, 1): 1, ((8, 2048, 128), 128, 1): 1, ((8, 2048, 192), 64, 1): 1,
    ((8, 1024, 64), 128, 1): 1, ((8, 1024, 128), 128, 1): 6, ((8, 1024, 128), 128, 2): 1,
    ((8, 1024, 192), 128, 1): 1, ((8, 1024, 256), 128, 1): 1, ((8, 1024, 256), 256, 1): 1,
    ((8, 1024, 384), 128, 1): 1, ((8, 512, 128), 256, 1): 1, ((8, 512, 256), 256, 1): 10,
    ((8, 512, 384), 256, 1): 1, ((8, 512, 512), 256, 1): 2,
}


def test_spectroscopy_1d_sites_take_the_1d_routes():
    """Every int8 conv site of the 1-D Spectroscopy UNet (examples/
    config_spectroscopy.json at full width, 4096 points, batch 1 on the
    CPU) and the route it takes on the card: the 23 problems S2 ran before,
    each 3 taps with pads (1, 1) and Cin % 16 == 0, now on "s1_1d" (stride
    1: 47 sites) or "s1_1d_strided" (the three Downsamples), none on S2.
    The Cin = 1 input conv and the Cout = 1 output conv stay float (the
    small-layer rule); a 1-D conv with Cin 24 would be S2's."""
    import json
    from pathlib import Path

    from rho_diffusion_tpu_torch.models.unet import UNet

    cfg = json.loads((Path(__file__).resolve().parents[1] / "examples" /
                      "config_spectroscopy.json").read_text())
    kw = {k_: v for k_, v in cfg["model"]["kwargs"].items() if k_ not in ("num_classes", "cond_fn")}
    unet = UNet(**kw).eval()
    x = torch.from_numpy(inputs((1, 4096, 1), seed=9))
    with Int8Sites() as sites, conv_quant("int8"), torch.no_grad():
        out = unet(x, torch.tensor([5]))
    assert tuple(out.shape) == (1, 4096, 1) and bool(torch.isfinite(out).all())
    convs = [c for c in sites.calls if c["site"] == "conv"]
    found: dict = {}
    routes: dict = {}
    for c in convs:
        if c["route"] == "float":
            continue
        assert c["kernel"] == (3,) and c["pads"] == ((1, 1),), c
        key = ((8, *c["x"][1:]), c["cout"], c["stride"][0])
        found[key] = found.get(key, 0) + 1
        assert c["route"] == ("s1_1d" if c["stride"] == (1,) else "s1_1d_strided"), c
        routes[c["route"]] = routes.get(c["route"], 0) + 1
    assert found == SPECTROSCOPY_1D_SITES
    assert routes == {"s1_1d": 47, "s1_1d_strided": 3}  # 50 S2 launches a forward before
    floats = sorted((c["x"][-1], c["cout"]) for c in convs if c["route"] == "float")
    assert floats == [(1, 32), (32, 1)]
    assert k.int8_conv_route((8, 4096, 24), (3,), (1,), [(1, 1)], 32) == "s2"
    assert k.int8_conv_route((8, 4096, 32), (5,), (1,), [(2, 2)], 32) == "s2"


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_plain_int8_conv_is_exact(out_dtype):
    """The plain version's int32 sums equal an int64 sum of the products;
    its dequantisation is float(acc) * (s_x * s_w) + bias, in that order."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 3, 4, 5, 40)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 40, 3, 3, 3)).astype(np.int8))
    s_x, s_w = torch.rand(2) * 1e-2, torch.rand(24) * 1e-2
    bias = torch.randn(24)
    got = k.conv_int8_plain(xq, s_x, wq, s_w, bias, (1, 1, 1), [(1, 1)] * 3, out_dtype)
    xp = torch.nn.functional.pad(xq.long(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((2, 3, 4, 5, 24), dtype=torch.long)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                acc += torch.einsum("bdhwc,oc->bdhwo", xp[:, dz:dz + 3, dy:dy + 4, dx:dx + 5],
                                    wq[:, :, dz, dy, dx].long())
    if out_dtype == torch.int32:
        assert torch.equal(got, acc.to(torch.int32))
    else:
        want = (acc.float() * (s_x.reshape(2, 1, 1, 1, 1) * s_w) + bias).to(out_dtype)
        assert torch.equal(got, want)


def test_s2_weight_packing_round_trips():
    """S2's words hold channel 4g + i in byte i; channels past Cin are 0."""
    wq = torch.from_numpy(np.random.default_rng(4).integers(-127, 128, (5, 6, 3, 3))
                          .astype(np.int8))
    words = k.s2_weights(wq)
    assert tuple(words.shape) == (9, 2, 5) and words.dtype == torch.int32
    unpacked = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], -1)
    unpacked = unpacked.to(torch.uint8).view(torch.int8).permute(0, 1, 3, 2).reshape(9, 8, 5)
    assert torch.equal(unpacked[:, :6].permute(2, 1, 0).reshape(5, 6, 3, 3), wq)
    assert not unpacked[:, 6:].any()
    s1 = k.s1_weights(torch.zeros((4, 32, 3, 3, 3), dtype=torch.int8))
    assert tuple(s1.shape) == (4, 27, 32)


# ---------------------------------------------------------------------------
# the int8 Dense

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((2, 5, 32), 48), ((3, 64, 32), 96)],
                         ids=["rows-padded", "rows-64"])
def test_dense_int8_bitwise_against_jax(shape, cout, dtype):
    rng = np.random.default_rng(5)
    cin = shape[-1]
    kernel = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    with jax_conv_quant("int8"):
        jmod = jax_dense(cout, dtype=jdt)
    assert isinstance(jmod, DenseInt8)
    port = Conv1x1(cin, cout, 1, dtype=torch.bfloat16 if dtype == "bfloat16" else None)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.T.copy()).reshape(cout, cin, 1))
        port.bias.copy_(torch.from_numpy(bias))
    t, j = pair_dtype(inputs(shape, seed=6), dtype)
    want = jmod.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, j)
    calls = []
    real = torch._int_mm
    with conv_quant("int8"), torch.no_grad(), pytest.MonkeyPatch.context() as m:
        m.setattr(torch, "_int_mm", lambda a, b: calls.append(tuple(a.shape)) or real(a, b))
        got = port(t)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    rows = shape[0] * shape[1]
    assert calls == [(max(rows, quant.INT_MM_MIN_ROWS), cin)]


def test_int_mm_pads_rows_exactly():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 24)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (16, 24)).astype(np.int8))
    got = quant.int_mm(a, b)
    assert tuple(got.shape) == (3, 16) and got.dtype == torch.int32
    assert torch.equal(got, (a.long() @ b.long().T).to(torch.int32))


# ---------------------------------------------------------------------------
# the small-layer rule, per-sample scales, dispatch, training, the cache

@pytest.mark.parametrize("case", ["cin1-bf16", "cout1-fp32", "cout1-bf16"])
def test_small_layers_stay_float_in_the_input_dtype(case):
    """Cin = 1 (the UNet's input conv, layer dtype bf16) and Cout = 1 (its
    head, no layer dtype): float in ``self.dtype or x.dtype``, the bias
    added after the conv in that dtype, as JAX's ConvInt8. Both sum the
    same products in another order: in fp32 the outputs differ by at most
    1.4e-6 of an O(1) output (found here; held at 1e-5 of the largest); in
    bf16 both round the fp32 sum to bf16 and add the bias in bf16, held
    within one bf16 rounding (2^-8 relative) and equal at >= 99 % of the
    elements."""
    cin, cout, dtype = {"cin1-bf16": (1, 32, "bfloat16"), "cout1-fp32": (32, 1, "float32"),
                        "cout1-bf16": (32, 1, "bfloat16")}[case]
    rng = np.random.default_rng(8)
    kernel = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    layer_bf16 = case == "cin1-bf16"
    port = ConvNd(3, cin, cout, 3, dtype=torch.bfloat16 if layer_bf16 else None)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel).permute(4, 3, 0, 1, 2))
        port.bias.copy_(torch.from_numpy(bias))
    jmod = ConvInt8(features=cout, kernel_size=(3, 3, 3), strides=(1, 1, 1), padding="SAME",
                    dtype=jnp.bfloat16 if layer_bf16 else None)
    t, j = pair_dtype(inputs((2, 4, 5, 6, cin), seed=9, spread=False), dtype)
    want = as_np(jmod.apply({"params": {"kernel": jnp.asarray(kernel),
                                        "bias": jnp.asarray(bias)}}, j))
    with Int8Sites() as sites, conv_quant("int8"), torch.no_grad():
        got_t = port(t)
    assert sites.kinds() == {"conv_float": 1}
    assert got_t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = as_np(got_t)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=2.0 ** -8)
        assert np.mean(got == want) >= 0.99


def test_activation_scale_is_per_sample():
    port, _, _ = conv_pair(3, 32, 48, 1, "float32")
    row = torch.from_numpy(inputs((1, 4, 5, 6, 32), seed=10))
    huge = 1e3 * torch.from_numpy(inputs((1, 4, 5, 6, 32), seed=11))
    with conv_quant("int8"), torch.no_grad():
        alone = port(row)
        batched = port(torch.cat([row, huge]))
    assert torch.equal(alone[0], batched[0])


def test_int8_wins_over_the_conv3d_backend(monkeypatch):
    """Under int8 a stride-1 3x3x3 conv with >= 16 channels never reaches
    the float conv3d route, whichever backend is set."""
    port, _, _ = conv_pair(3, 32, 32, 1, "float32")
    x = torch.from_numpy(inputs((1, 4, 4, 4, 32), seed=12))

    def refuse(*args, **kwargs):
        raise AssertionError("the float conv3d route ran under int8")

    monkeypatch.setattr(convolution, "conv3d", refuse)
    for backend in ("plain", "auto"):
        set_conv3d_backend(backend)
        with conv_quant("int8"), torch.no_grad():
            port(x)
    with pytest.raises(AssertionError, match="float conv3d route"):
        port(x)  # and the float mode does


def test_conv_quant_mode_rules():
    assert get_conv_quant() == "off"
    with conv_quant("int8"):
        assert get_conv_quant() == "int8"
        with pytest.raises(ValueError, match="conv quant mode"):
            quant.set_conv_quant("int4")
    assert get_conv_quant() == "off"


def test_training_refused_while_quantized():
    pipe = DDPM("UNetv2", dict(data_shape=[8, 8], dims=2, in_channels=1, out_channels=1,
                               model_channels=16, num_res_blocks=1, channel_mult=[1, 2],
                               attention_resolutions=[4], num_heads=2),
                schedule.LinearSchedule(10, 2e-5, 1e-3), device="cpu")
    state = pipe.create_state()
    with conv_quant("int8"), pytest.raises(RuntimeError, match="inference-only"):
        pipe.training_step(state, {"data": np.zeros((2, 8, 8, 1), np.float32), "labels": None})


def test_weight_cache_quantizes_again_after_an_update():
    port, _, _ = conv_pair(3, 32, 32, 1, "float32")
    x = torch.from_numpy(inputs((1, 4, 4, 4, 32), seed=13))

    def fresh_output(module):
        twin, _, _ = conv_pair(3, 32, 32, 1, "float32")
        twin.load_state_dict(module.state_dict())
        with conv_quant("int8"), torch.no_grad():
            return twin(x)

    with conv_quant("int8"), torch.no_grad():
        first = port(x)
        assert torch.equal(port(x), first)  # cached, the same
        cached = port._int8_cache["wq"]
        port.weight.mul_(-0.5)  # an optimizer's in-place step
        second = port(x)
        assert port._int8_cache["wq"] is not cached
    assert not torch.equal(second, first)
    assert torch.equal(second, fresh_output(port))
    sd = {name: v.clone() for name, v in port.state_dict().items()}
    sd["weight"] = torch.flip(sd["weight"], dims=[2])
    port.load_state_dict(sd)
    with conv_quant("int8"), torch.no_grad():
        third = port(x)
    assert torch.equal(third, fresh_output(port))
    assert not torch.equal(third, second)


# ---------------------------------------------------------------------------
# the whole model

KW = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=2, model_channels=16,
          num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
          num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=20, beta_1=1e-4, beta_T=5e-3)
TYPES = dict(model_mean_type="epsilon", model_var_type="learned_range")
SHAPE = (2, 8, 8, 8, 1)
STEPS = 6
# the same UNet in 1-D (32 points): every int8 conv on the 1-D routes
KW_1D = {**KW, "dims": 1, "data_shape": [32]}
SHAPE_1D = (2, 32, 1)


def make_int8_pair(kw):
    """(port pipeline, JAX pipeline, JAX params), the JAX UNet call jitted
    under int8 (JAX reads the mode when it traces)."""
    tpipe = tg.GaussianDiffusionPipeline("UNetv2", kw, schedule.LinearSchedule(**SCHEDULE),
                                         device="cpu", **TYPES)
    sd = random_state_dict(tpipe.backbone, 0)
    tpipe.load_state_dict(sd)
    jpipe = jg.GaussianDiffusionPipeline("UNetv2", kw, jax_schedule.LinearSchedule(**SCHEDULE),
                                         **TYPES)
    jit_backbone(jpipe)
    return tpipe, jpipe, jax_params(sd, kw)


@pytest.fixture(scope="module")
def int8_pair():
    return make_int8_pair(KW)


def conditions(n: int = 2, width: int = 64) -> np.ndarray:
    return np.random.default_rng(2).normal(size=(n, width)).astype(np.float32)


class JaxQuantizers:
    """JAX's int8 UNet call, jitted, returning beside its output the (x, q,
    s) of every activation quantizer in call order (``quantize_int8`` with
    the batch axis kept; the weights' quantizers reduce over axis 0 and are
    left out)."""

    def __init__(self, jpipe, monkeypatch):
        orig = jax_quant.quantize_int8
        records: list = []

        def recording(w, axes):
            q, s = orig(w, axes)
            if 0 not in axes:
                records.append((w, q, s))
            return q, s

        monkeypatch.setattr(jax_quant, "quantize_int8", recording)
        net = jpipe.backbone

        @jax.jit
        def run(params, x, t, y):
            records.clear()  # at trace time: the records are of this trace
            out = net.apply({"params": params}, x, t, y, False)
            return out, list(records)

        self.run = run

    def __call__(self, params, x, t, y):
        with jax_conv_quant("int8"):
            out, recs = self.run(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return np.asarray(out), [tuple(np.array(a) for a in r) for r in recs]


class PortQuantizers:
    """The port's activation quantizers (``quantize_rows``) recorded in call
    order as (x, q, s); with ``inject``, each call returns the given (q, s)
    instead of its own. The module's weights must be cached already, so
    that every call is an activation's."""

    def __init__(self, monkeypatch):
        self.calls: list = []
        self.inject = None
        orig = k.quantize_rows

        def recording(x, plain=False):
            q, s = orig(x, plain)
            self.calls.append((x.float().numpy(), q.numpy(), s.numpy()))
            if self.inject is None:
                return q, s
            qj, sj = self.inject[len(self.calls) - 1]
            return torch.from_numpy(qj).reshape(q.shape), torch.from_numpy(sj).reshape(-1)

        monkeypatch.setattr(k, "quantize_rows", recording)

    def run(self, backbone, x, t, y, inject=None) -> tuple[np.ndarray, list]:
        self.calls, self.inject = [], inject
        with conv_quant("int8"), torch.no_grad():
            out = backbone(torch.from_numpy(x), torch.from_numpy(t).long(), y).numpy()
        return out, self.calls


def quantizer_flips(port_calls: list, jax_calls: list) -> list:
    """Hold each activation quantizer of the port against JAX's on the same
    call: the inputs within fp32 rounding of the float layers (1e-5 of the
    row's max), the scales within 1e-6, and every int8 value that differs
    one quantum away, at a near tie: both sides' x / s within TIE of each
    other and on either side of the half-integer between the two values.
    Returns the flipped count of each call."""
    assert len(port_calls) == len(jax_calls)
    flips = []
    for i, ((xt, qt, st), (xj, qj, sj)) in enumerate(zip(port_calls, jax_calls)):
        assert xt.size == xj.size and xt.shape[0] == xj.shape[0], (i, xt.shape, xj.shape)
        xj, qj, sj = xj.reshape(xt.shape), qj.reshape(qt.shape), sj.reshape(st.shape)
        rows = xt.shape[0]
        amax = np.abs(xj).reshape(rows, -1).max(axis=1)
        gap = np.abs(xt - xj).reshape(rows, -1).max(axis=1)
        assert (gap <= 1e-5 * amax).all(), (i, gap / amax)
        np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)
        per_row = (1,) * (xt.ndim - 1)
        vt = xt.astype(np.float32) / st.reshape(-1, *per_row).astype(np.float32)
        vj = xj.astype(np.float32) / sj.reshape(-1, *per_row).astype(np.float32)
        diff = qt.astype(np.int32) != qj.astype(np.int32)
        lo = np.minimum(qt, qj).astype(np.float32)[diff]
        assert (np.abs(qt.astype(np.int32) - qj)[diff] == 1).all(), i
        assert (np.abs(vt - vj)[diff] <= TIE).all(), (i, np.abs(vt - vj)[diff])
        assert ((vt[diff] - lo - 0.5) * (vj[diff] - lo - 0.5) <= 0).all(), i
        flips.append(int(diff.sum()))
    return flips


def test_tiny_unet_int8_forward_against_jax(int8_pair, monkeypatch):
    int8_forward_against_jax(int8_pair, monkeypatch, SHAPE)


def test_tiny_unet_1d_int8_forward_against_jax(monkeypatch):
    """The same rule at rank 1: a 1-D UNet under int8 against JAX's
    ``ops/quant.py``, every quantised conv site of it on the 1-D routes
    ("s1_1d", and "s1_1d_strided" for its Downsample) and none on S2."""
    sites = int8_forward_against_jax(make_int8_pair(KW_1D), monkeypatch, SHAPE_1D)
    routes = {c["route"] for c in sites.calls if c["site"] == "conv" and c["route"] != "float"}
    assert routes == {"s1_1d", "s1_1d_strided"}


def int8_forward_against_jax(pair, monkeypatch, shape):
    """A tiny UNet's int8 forward against JAX's over FORWARD_DRAWS draws,
    row by row: both sides' activation quantizers recorded, every flip one
    quantum at a near tie, and the port rerun on JAX's int8 values at rel
    MSE < REL_MSE_MODEL on every row. Returns the first forward's sites."""
    tpipe, jpipe, params = pair
    backbone = tpipe.backbone
    rng = np.random.default_rng(14)
    y = torch.from_numpy(conditions())
    jax_run, port = JaxQuantizers(jpipe, monkeypatch), None
    free_errs, forced_errs, float_dist, flipped_rows = [], [], [], 0
    for draw in range(FORWARD_DRAWS):
        x = rng.normal(size=shape).astype(np.float32)
        t = rng.integers(0, SCHEDULE["num_steps"], shape[0]).astype(np.int32)
        if port is None:  # the first forward caches every module's int8 weights
            with Int8Sites() as sites, conv_quant("int8"), torch.no_grad():
                backbone(torch.from_numpy(x), torch.from_numpy(t).long(), y)
            counts = sites.kinds()
            # every conv but the input conv and the head, and every Dense
            # site, ran int8
            assert counts["conv_float"] == 2 and counts["conv_int8"] >= 10
            assert counts["dense_int8"] >= 3 and not counts.get("dense_float")
            port = PortQuantizers(monkeypatch)
        want, jax_calls = jax_run(params, x, t, y.numpy())
        got, free_calls = port.run(backbone, x, t, y)
        # the port run on JAX's int8 activations: the flips are the one
        # difference, each held to one quantum at a near tie
        forced, forced_calls = port.run(backbone, x, t, y, inject=[c[1:] for c in jax_calls])
        flips = quantizer_flips(forced_calls, jax_calls)
        with torch.no_grad():
            float_out = backbone(torch.from_numpy(x), torch.from_numpy(t).long(), y).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        for i in range(shape[0]):
            row_flipped = any((c[1][i] != j[1].reshape(c[1].shape)[i]).any()
                              for c, j in zip(free_calls, jax_calls))
            flipped_rows += row_flipped
            free_errs.append(rel_mse(got[i], want[i]))
            forced_errs.append(rel_mse(forced[i], want[i]))
            float_dist.append(rel_mse(got[i], float_out[i]))
            if not row_flipped:  # the same int8 values all the way: the same row
                assert free_errs[-1] < REL_MSE_MODEL, (draw, i, free_errs[-1])
        assert sum(flips) <= FLIPS_PER_FORWARD, flips
    assert max(forced_errs) < REL_MSE_MODEL, sorted(forced_errs)
    # int8 changes the model far more than the frameworks differ
    assert max(forced_errs) < 1e-6 * min(float_dist), (max(forced_errs), min(float_dist))
    print(f"int8 UNet vs JAX, rel MSE a row: {len(forced_errs)} rows on JAX's int8 "
          f"activations {min(forced_errs):.2e}..{max(forced_errs):.2e}; free-running "
          f"{min(free_errs):.2e}..{max(free_errs):.2e} ({flipped_rows} rows with a flip); "
          f"int8 vs float {min(float_dist):.2e}..{max(float_dist):.2e}")
    return sites


@pytest.mark.parametrize("eta", [0.0, 0.5], ids=["eta0-shared-xT", "eta0.5-injected"])
def test_ddim_int8_sample_against_jax(int8_pair, monkeypatch, eta):
    tpipe, jpipe, params = int8_pair
    c = conditions()
    opts = dict(sampler="ddim", num_steps=STEPS, eta=eta)
    with monkeypatch.context() as m:
        inj = Injected(m, SHAPE)
        x_T = inj.batch[0]
        with conv_quant("int8"):
            got = tpipe.reverse_process(SHAPE, torch.from_numpy(c),
                                        generator=torch.Generator().manual_seed(0),
                                        **opts).numpy()
        with jax_conv_quant("int8"), jax.disable_jit():
            want = np.asarray(jpipe.reverse_process(params, jnp.asarray(0, jnp.int32), SHAPE,
                                                    jnp.asarray(c), **opts))
        float_sample = tpipe.reverse_process(SHAPE, torch.from_numpy(c),
                                             generator=torch.Generator().manual_seed(0),
                                             **opts).numpy()
    assert np.isfinite(got).all() and np.abs(want - x_T).max() > 0.1
    assert rel_mse(got, want) < REL_MSE_SAMPLE, rel_mse(got, want)
    assert rel_mse(got, float_sample) > 1e-5  # int8 really ran


def test_conv_int8_probe_runs_on_the_cpu(monkeypatch, capsys):
    """The probe's rows at shrunk shapes with the plain versions (``-d
    cpu``: host-clock times, no device rate), S1's sums exact."""
    monkeypatch.setattr(conv_int8_probe, "LEVEL_SHAPES", [(2, 4, 4, 4, 16, 16),
                                                          (2, 4, 2, 2, 32, 32)])
    monkeypatch.setattr(conv_int8_probe, "ITERS", 1)
    rows = conv_int8_probe.main(["-d", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu") and len(out) == 3
    assert [r["shape"] for r in rows] == [[2, 4, 4, 4, 16, 16], [2, 4, 2, 2, 32, 32]]
    for r in rows:
        assert r["s1_int32_exact"] and r["s8_tops"] is None
        assert r["s8_bound_ms"] > 0 and r["quant_bound_ms"] > 0 and r["k5_ms"] > 0
