"""3x3x3 stride-1 SAME convolution on channels-last volumes, differentiable.

``conv3d(x, weight, bias)`` is the autograd Function ``Conv3d``, the port of
the JAX package's ``conv3d`` custom VJP (``rho_diffusion_tpu/ops/pallas/
conv3d.py:225-253``). x: [B, D, H, W, Cin]; weight: torch layout
[Cout, Cin, 3, 3, 3]; bias: [Cout] or None; output [B, D, H, W, Cout] in the
input dtype, accumulated in fp32.

* forward: the hand-written CUDA kernel (``csrc/conv3d.cu``, which replaces
  the TPU kernel ``conv3d_pallas``) on CUDA tensors, ``conv3d_plain`` on CPU
  tensors;
* dgrad: the same kernels on the spatially flipped, IO-transposed weights
  (the JAX package reuses its Pallas kernel the same way), counted apart as
  ``conv3d_dgrad_igemm``/``conv3d_dgrad_direct``; ``conv3d_dgrad_plain`` on
  the CPU. Skipped when x needs no gradient (the UNet's input conv);
* wgrad: ``torch.nn.grad.conv3d_weight`` on the card, as the JAX package
  leaves it to XLA; the 27 tap matmuls of ``conv3d_wgrad_plain`` on the CPU.
  cuDNN would run an fp32 wgrad (on the flagship only the fp32 Cout=1
  head's) in TF32 under torch's default; ``conv3d_wgrad`` turns
  ``torch.backends.cudnn.allow_tf32`` off for its call, so fp32 stays fp32
  in every direction, as in the kernels;
* the bias gradient is a sum over the voxels.

``plain=True`` sends both directions to the plain versions on any device (a
reference run on the card). The plain backward is written out rather than
left to autograd: autograd through ``conv3d_plain`` would save a copy of the
input for each of its 27 taps.

On the card the route goes by dtype and channels (``conv_route``): bf16
with Cin % 8 == 0 (the dgrad's own input channels, i.e. the forward's Cout,
for a dgrad) takes the tensor-core implicit GEMM (``conv3d_igemm``: TMA
boxes of 128 voxels with the hardware's zero fill as the SAME padding, an
mbarrier ring, ``wgmma`` over up to 256 output channels; ``igemm_plan``
chooses the box, the N tile and the ring's depth); fp32 with Cin % 4 == 0
and Cout > 1 the same block in 3xTF32 (``conv3d_tf32``: each fp32 operand
split into two TF32 terms, three ``wgmma`` products for each, so fp32
accuracy on the tensor cores; ``tf32_plan``), after a pre-pass that splits
the weights (counted as ``conv3d_weight_split``); every other conv (the
UNet's Cin=1 input conv, its fp32 Cout=1 output head and that head's
dgrad) takes the direct kernel (``conv3d_direct``: a shared-memory halo
tile per 8 x 32 voxels and fp32 FMAs, with its own tile shapes for Cin=1
and for Cout=1). The weights are repacked per call into the layout each
kernel reads.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import (
    _build, check_no_autograd, launch_counts, sm_count)

_INT32_MAX = 2**31 - 1
_TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]

# The implicit GEMM's tiles (csrc/conv3d_wgmma.cuh): a block owns one TMA
# box of IGEMM_BM voxels and reads IGEMM_BK channels (64 bf16 = the 128-byte
# swizzle span) per k-step, over N tiles of one of IGEMM_BN output channels,
# through a ring of one of IGEMM_STAGES stages in at most SMEM_LIMIT bytes.
IGEMM_BM = 128
IGEMM_BK = 64
IGEMM_BN = (64, 128, 192, 256)
IGEMM_STAGES = (3, 4)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100


# The 3xTF32 block (csrc/conv3d_tf32.cuh): TF32_BK fp32 channels (128 bytes)
# a k-step, so A is 16 KB a stage as in bf16, and B two terms of BN x 128
# bytes; N tiles of at most TF32_BN_MAX channels (a k-step's partial sum
# beside the total takes BN registers a thread) and the ring's depth at
# each, 4 stages in at most SMEM_LIMIT.
TF32_BK = 32
TF32_BN_MAX = 128
TF32_STAGES = {64: 4, 128: 4}


class IgemmPlan(NamedTuple):
    """The box of voxels one block owns (bw x bh x bd = IGEMM_BM), its
    output channels (bn) and the depth of its TMA ring (stages)."""

    bw: int
    bh: int
    bd: int
    bn: int
    stages: int

    def smem_bytes(self) -> int:
        """The ring (A and B tiles per stage), its barriers and the 1024
        bytes that align it to the swizzle: conv3d_wgmma.cuh's smem_bytes."""
        return self.stages * 2 * IGEMM_BK * (IGEMM_BM + self.bn) + 16 * self.stages + 1024

    def grid(self, x_shape, cout: int) -> tuple[int, int, int, int, int]:
        """(batch, boxes along D, H and W, N tiles): the launch's blocks."""
        b, d, h, w, _ = x_shape
        return (b, -(-d // self.bd), -(-h // self.bh), -(-w // self.bw), -(-cout // self.bn))


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=1024)
def igemm_plan(x_shape, cout: int, bn_max: int = 256, stages: int = 4,
               sms: int = 132) -> IgemmPlan:
    """The implicit GEMM's plan for x [B, D, H, W, Cin] -> cout channels on
    a card of ``sms`` multiprocessors (132: the H100 SXM).

    The box spans W first (up to the next power of two of W), then H, then
    D, so that its 128 voxels are as contiguous in x as the volume allows:
    (32, 4, 1) at 32^2 planes, (8, 8, 2) at 8^2, (4, 4, 8) at 4^2. Ragged
    volumes take the next power of two and the kernel drops the rows
    outside. The N tiles split Cout into tiles of a multiple of 64 and at
    most ``bn_max`` channels: as few as fill the card, since one block runs
    per SM. Each split costs its waves of blocks times (bn + 128), the
    bytes of B and A a k-step brings in, in rows of 128 bytes; the cheapest
    wins, the fewest tiles on a tie. So one tile up to 256 channels, two of
    192 for 384, four of 256 for 1024; but two of 128 for the 64 boxes of a
    batch-8 level-3 conv, which one tile of 256 would leave on 64 SMs.
    Four stages: on the H100 a deeper ring (8 at BN = 64, 6 at 128) was no
    faster, and three lose 7-12 % at BN <= 128. Cached: the wrapper asks
    for the same few plans on every step."""
    b, d, h, w, _ = x_shape
    bw = min(_pow2_at_least(w), IGEMM_BM)
    bh = min(_pow2_at_least(h), IGEMM_BM // bw)
    bd = IGEMM_BM // (bw * bh)
    boxes = b * -(-d // bd) * -(-h // bh) * -(-w // bw)
    return IgemmPlan(bw, bh, bd, n_tile(boxes, cout, bn_max, sms), stages)


def n_tile(m_blocks: int, cout: int, bn_max: int = 256, sms: int = 132) -> int:
    """The N tile (a multiple of 64, at most ``bn_max``) for ``m_blocks``
    blocks of 128 rows: each split of Cout costs its waves of blocks on
    ``sms`` multiprocessors times (bn + 128), the bytes of B and A a k-step
    brings in, in rows of 128 bytes; the cheapest wins, the fewest tiles on
    a tie (``igemm_plan`` says what it gives)."""
    best = None
    for n_tiles in range(-(-cout // bn_max), -(-cout // 64) + 1):
        bn = -(-cout // (n_tiles * 64)) * 64
        if -(-cout // bn) != n_tiles:
            continue  # the same tile as a split already costed
        cost = -(-m_blocks * n_tiles // sms) * (bn + IGEMM_BM)
        if best is None or cost < best[0]:
            best = (cost, bn)
    return best[1]


def tf32_plan(x_shape, cout: int, sms: int = 132) -> IgemmPlan:
    """The 3xTF32 implicit GEMM's plan: ``igemm_plan``'s box and N tile
    (K5's cost rule) of at most TF32_BN_MAX channels, with the ring's depth
    for that tile (``TF32_STAGES``)."""
    plan = igemm_plan(tuple(x_shape), cout, bn_max=TF32_BN_MAX, sms=sms)
    return plan._replace(stages=TF32_STAGES[plan.bn])


def tf32_smem_bytes(plan: IgemmPlan) -> int:
    """Shared memory of a 3xTF32 block: per stage the A box (128 voxels x
    32 fp32) and both weight terms (BN x 32 fp32 each), the barriers and the
    1024 bytes that align the ring to the swizzle (conv3d_tf32.cuh's
    smem_bytes)."""
    return plan.stages * 4 * TF32_BK * (IGEMM_BM + 2 * plan.bn) + 16 * plan.stages + 1024


def conv_route(dtype, cin: int, cout: int) -> str:
    """The kernel a conv of ``cin`` -> ``cout`` channels takes on the card:
    "igemm" (bf16, Cin % 8 == 0), "tf32" (fp32, Cin % 4 == 0, Cout > 1) or
    "direct" (the rest: Cin = 1, fp32 Cout = 1, ragged channels)."""
    if dtype == torch.bfloat16 and cin % 8 == 0:
        return "igemm"
    if dtype == torch.float32 and cin % 4 == 0 and cout > 1:
        return "tf32"
    return "direct"


# ctypes signatures of the launchers in csrc/conv3d.cu, set once on load
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_LAUNCHERS = {
    "conv3d_igemm_bf16": [_PTR] * 4 + [_INT] * 11 + [_PTR],
    "conv3d_igemm_tf32": [_PTR] * 5 + [_INT] * 11 + [_PTR],
    "conv3d_weight_split": [_PTR] * 3 + [ctypes.c_longlong, _PTR],
    "conv3d_direct_bf16": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "conv3d_direct_f32": [_PTR] * 4 + [_INT] * 6 + [_PTR],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/conv3d.cu's library with its launchers' signatures set."""
    lib = _build.load("conv3d")
    for fn, argtypes in _LAUNCHERS.items():
        launcher = getattr(lib, fn)
        launcher.restype = ctypes.c_int
        launcher.argtypes = argtypes
    return lib


def conv3d_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: the 27-tap sum of channel matmuls over shifted
    views of the zero-padded input, in fp32, cast to the input dtype. Exact
    on the CPU and independent of cuDNN."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = weight.float()
    out = torch.zeros((b * d * h * w, cout), dtype=torch.float32, device=x.device)
    for dz, dy, dx in _TAPS:
        tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
        out.addmm_(tap, wf[:, :, dz, dy, dx].T)
    if bias is not None:
        out += bias.float()
    return out.reshape(b, d, h, w, cout).to(x.dtype)


def dgrad_weight(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3, 3] -> the dgrad conv's [Cin, Cout, 3, 3, 3]:
    spatially flipped, input and output channels swapped."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def conv3d_dgrad_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain input gradient: ``conv3d_plain`` on the flipped,
    IO-transposed weights, in g's dtype."""
    return conv3d_plain(g, dgrad_weight(weight).to(g.dtype))


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain weight gradient [Cout, Cin, 3, 3, 3]: for each tap,
    g^T times the shifted input, in fp32, cast to x's dtype."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gt = g.float().reshape(-1, cout).T
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    for dz, dy, dx in _TAPS:
        dw[:, :, dz, dy, dx] = gt @ xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
    return dw.to(x.dtype)


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient on the card: the library's conv weight gradient
    on channels-last views (no copy), in x's dtype, without TF32."""
    shape = (g.shape[-1], x.shape[-1], 3, 3, 3)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.grad.conv3d_weight(x.movedim(-1, 1), shape, g.movedim(-1, 1), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 5 or weight.dim() != 5 or tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(
            f"conv3d takes x [B,D,H,W,Cin] and weight [Cout,Cin,3,3,3]; got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}",
        )
    if weight.shape[1] != x.shape[-1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3d: x, weight and bias must be on one device")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(
            f"conv3d: weight and bias must have x's dtype {x.dtype}; got "
            f"{[t.dtype for t in tensors]}",
        )
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Cout {weight.shape[0]}")


def conv3d_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    kind: str = "conv3d", plan: Optional[IgemmPlan] = None,
) -> torch.Tensor:
    """Launch the CUDA conv of ``conv_route`` (igemm, tf32 or direct, as the
    module docstring says) and count it as ``<kind>_<route>``. ``plan``
    overrides the route's own (``igemm_plan``'s or ``tf32_plan``'s: tile
    studies and tests)."""
    check_no_autograd(kind, x, weight, bias)
    _check(x, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d has no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3d kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3d kernel needs a contiguous channels-last x")
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    if max(x.numel(), b * d * h * w * cout, 27 * cin * cout) > _INT32_MAX:
        raise ValueError(f"conv3d: shape {tuple(x.shape)} -> {cout} is out of the kernel's range")
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    extra = ()
    route = conv_route(x.dtype, cin, cout)
    if route in ("igemm", "tf32"):
        if x.data_ptr() % 16:
            raise ValueError("conv3d kernel needs a 16-byte aligned x")
        # [Cout, Cin, dz, dy, dx] -> [Cout, 27, Cin], tap = (dz*3+dy)*3+dx
        wk = weight.permute(0, 2, 3, 4, 1).reshape(cout, 27, cin).contiguous()
        if route == "igemm":
            extra = tuple(plan or igemm_plan(x.shape, cout, sms=sm_count(x.device.index)))
            fn = "conv3d_igemm_bf16"
        else:
            extra = tuple(plan or tf32_plan(x.shape, cout, sm_count(x.device.index)))
            fn = "conv3d_igemm_tf32"
        name = f"{kind}_{route}"
    else:
        # [Cout, Cin, dz, dy, dx] -> [27*Cin, Cout]
        wk = weight.permute(2, 3, 4, 1, 0).reshape(27 * cin, cout).contiguous()
        fn = "conv3d_direct_bf16" if x.dtype == torch.bfloat16 else "conv3d_direct_f32"
        name = f"{kind}_direct"
    bk = bias.contiguous() if bias is not None else None
    # the tf32 route reads the weights' two tf32 terms
    weights = weight_split_kernel(wk) if route == "tf32" else (wk,)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = getattr(lib, fn)(
            x.data_ptr(), *(t.data_ptr() for t in weights),
            bk.data_ptr() if bk is not None else None,
            out.data_ptr(), b, d, h, w, cin, cout, *extra, stream,
        )
    _build.check(code, lib, "conv3d_error_string",
                 f"{fn}({tuple(x.shape)} -> {cout}{', plan ' + str(extra) if extra else ''})")
    launch_counts[name] += 1
    return out


def weight_split_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32 route's pre-pass on the card: fp32 ``w`` split into its
    tf32 terms (hi, lo), each shaped as ``w``, contiguous. Its plain
    version: ``tf32_split(w)`` with lo rounded by ``tf32_round``."""
    if w.device.type != "cuda" or w.dtype != torch.float32:
        raise ValueError(f"conv3d_weight_split takes a CUDA fp32 tensor, got {w.device} {w.dtype}")
    w = w.contiguous()
    split = torch.empty((2, *w.shape), dtype=torch.float32, device=w.device)
    lib = _library()
    with torch.cuda.device(w.device):
        code = lib.conv3d_weight_split(w.data_ptr(), split[0].data_ptr(), split[1].data_ptr(),
                                       w.numel(), torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(code, lib, "conv3d_error_string", f"conv3d_weight_split({tuple(w.shape)})")
    launch_counts["conv3d_weight_split"] += 1
    return split[0], split[1]


def conv3d_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Input gradient of the conv: the CUDA kernels on the flipped,
    IO-transposed weights on the card, the plain version on the CPU."""
    if g.device.type == "cpu":
        return conv3d_dgrad_plain(g, weight)
    return conv3d_kernel(g.contiguous(), dgrad_weight(weight).to(g.dtype), None, "conv3d_dgrad")


class Conv3d(torch.autograd.Function):
    """The conv with the kernels' (or the plain versions') forward, dgrad
    and wgrad."""

    @staticmethod
    def forward(ctx, x, weight, bias, plain: bool):
        ctx.plain = plain or x.device.type == "cpu"
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        if ctx.plain:
            return conv3d_plain(x, weight, bias)
        return conv3d_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = conv3d_dgrad_plain(g, weight) if ctx.plain else conv3d_dgrad(g, weight)
        if need_w:
            dw = conv3d_wgrad_plain(x, g) if ctx.plain else conv3d_wgrad(x, g)
        if ctx.has_bias and need_b:
            db = g.float().sum(dim=(0, 1, 2, 3)).to(g.dtype)
        return dx, dw, db, None


def conv3d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """3x3x3 SAME stride-1 conv, differentiable: the CUDA kernels on the
    card, the plain versions on the CPU (or everywhere with ``plain``)."""
    _check(x, weight, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv3d has no kernel for device {x.device}")
    return Conv3d.apply(x, weight, bias, plain)
