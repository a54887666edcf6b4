"""The conv's bottleneck-isolation kernels (K7-K9), forward only, as in JAX.

Ports of the TPU kernels of ``benchmarks/conv3d_variants.py`` onto the
port's own conv GEMM: every kernel of ``csrc/conv3d_variants.cu`` is K5's
Hopper block (``csrc/conv3d_wgmma.cuh``: TMA loads into an mbarrier ring,
two consumer warpgroups on ``wgmma``) with one factor changed, with those
functions' layouts:

* ``conv_variant(x, km, variant)``: K7. x [B, D, H, W, Cin]; km
  [9*CPAD, Cout] with CPAD = 3*Cin, row ``(dz*3+dy)*CPAD + dx*Cin + ci``
  (DHWIO flattened); out [B, D, H, W, Cout]. It runs on K5's plan
  (``igemm_plan``). ``"full"`` is the conv (bit for bit K5's),
  ``"nopatch"`` reads the (dz, dy) = (0, 0) rows for every tap (keeping
  dx), ``"nodma"`` reads no x at all: its A operand is the fixed pattern
  ``nodma_pattern`` (a deviation: the TPU kernel reads uninitialised
  scratch, so its output is undefined).
* ``bigdot(x, km, td)``: K8, the conv as an explicit patch matrix of ``td``
  output depth slices (device memory on the card) and one GEMM with
  K = 27*Cin per pass, D/td passes.
* ``dots_only(p, km)``: K9. p [P, CPAD]; out [P, Cout] (JAX's
  [P/M, M, Cout] is the same memory) = sum over the 9 row blocks of km of
  ``p @ km[j*CPAD:(j+1)*CPAD]``.

K8's GEMM and K9 are one dense GEMM on the same block (A a 2-D tensor map,
the weights [Cout, taps, C] a 3-D one), its N tile from ``dense_plan``.

Each wrapper takes its plain version (``*_plain``: fp32, cast to the input
dtype) for CPU tensors; for a CUDA tensor it launches its kernels, counted
in ``launch_counts`` as ``conv3d_variant_<variant>``, ``conv3d_bigdot_im2col``
and ``conv3d_bigdot_gemm`` (one each per pass), and ``conv3d_dotsonly``, or
raises. The kernels take bf16 only, with channel counts (Cin, CPAD) that are
multiples of 8: the tensor maps' rows are 16-byte multiples.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts, sm_count
from rho_diffusion_tpu_torch.ops.kernels.conv3d import IGEMM_BK, IGEMM_BM, igemm_plan, n_tile

VARIANTS = ("full", "nopatch", "nodma")
_TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]
_INT32_MAX = 2**31 - 1

# ctypes signatures of the launchers in csrc/conv3d_variants.cu, set once on load
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCHERS = {
    "conv3d_variant": [_INT] + [_PTR] * 3 + [_INT] * 11 + [_PTR],
    "conv3d_bigdot_im2col": [_PTR] * 2 + [_INT] * 7 + [_PTR],
    "conv3d_dense_gemm": [_INT, _PTR, _INT, _INT, _PTR, _PTR, _INT, _LONG, _INT, _INT, _INT, _PTR],
}


DENSE_STAGES = 4  # the dense GEMM's ring: K5's plan's depth (csrc/conv3d_variants.cu)


class DensePlan(NamedTuple):
    """The dense GEMM's N tile."""

    bn: int

    def smem_bytes(self) -> int:
        """The ring and its barriers, aligned to the swizzle's 1024 bytes:
        conv3d_wgmma.cuh's smem_bytes, as ``IgemmPlan.smem_bytes``."""
        return DENSE_STAGES * (2 * IGEMM_BK * (IGEMM_BM + self.bn) + 16) + 1024


def dense_plan(rows: int, batches: int, cout: int, sms: int = 132) -> DensePlan:
    """The dense GEMM's plan for ``batches`` x ``rows`` output rows of
    ``cout`` channels on a card of ``sms`` multiprocessors.

    A block owns 128 rows of one batch (ceil(rows / 128) a batch) and one N
    tile; one block runs per SM. The N tile follows K5's cost rule
    (``n_tile``): each split of Cout costs its waves of blocks times
    (bn + 128), the bytes of B and A a k-step brings in. So at the level-1
    shape (Cout = 128, 132 SMs) K9's 2048 row tiles and bigdot's passes of
    td >= 2 (128 to 512 blocks) take one tile of 128, while bigdot1's 64
    blocks (two row tiles per batch element) take two of 64: 128 blocks in
    one wave, where one tile of 128 would leave 68 SMs idle. The ring is
    K5's 4 stages (128 KB of A and B in flight a block at BN = 128)."""
    return DensePlan(n_tile(batches * -(-rows // IGEMM_BM), cout, sms=sms))


def nodma_pattern(x_shape, cout: int, device=None) -> torch.Tensor:
    """The ``nodma`` kernel's A operand as the conv sees it, fp32
    [B*D*H*W, Cin]: voxel v's channel ci reads f(r(v), ci mod 64), with
    f(r, c) = ((7 r + 3 c) mod 17 - 8) / 64, exact in bf16. The kernel
    writes f into every stage of its ring once: r is the row of the voxel
    in its block's box (``igemm_plan(x_shape, cout)``; w fastest, then h,
    then d) and c the channel in the 64-channel k-step, whatever the tap."""
    b, d, h, w, cin = x_shape
    plan = igemm_plan(tuple(x_shape), cout)

    def side(n: int, box: int) -> torch.Tensor:
        return torch.arange(n, device=device).remainder(box)

    r = ((side(d, plan.bd)[:, None, None] * plan.bh + side(h, plan.bh)[None, :, None]) * plan.bw
         + side(w, plan.bw)[None, None, :]).reshape(-1, 1)
    c = torch.arange(cin, device=device).remainder(IGEMM_BK)[None, :]
    return (((7 * r + 3 * c).remainder(17) - 8).float() / 64).repeat(b, 1)


def _taps(x: torch.Tensor, d0: int, td: int, nopatch: bool = False) -> list:
    """The 27 shifted fp32 views of zero-padded x at output depths
    [d0, d0 + td), in km's row order; with ``nopatch`` every tap's (dz, dy)
    is (0, 0)."""
    _, _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    return [xp[:, d0 + (0 if nopatch else dz):d0 + (0 if nopatch else dz) + td,
               (0 if nopatch else dy):(0 if nopatch else dy) + h, dx:dx + w]
            for dz, dy, dx in _TAPS]


def conv_variant_plain(x: torch.Tensor, km: torch.Tensor, variant: str) -> torch.Tensor:
    """K7's plain version: the 27-tap sum of channel products in fp32
    (``nodma``: the pattern times the weights), cast to x's dtype."""
    _check_conv(x, km)
    _check_variant(variant)
    b, d, h, w, cin = x.shape
    cout = km.shape[1]
    kf = km.float()
    m = b * d * h * w
    if variant == "nodma":
        # every tap reads the same pattern: sum the taps' weights first
        out = nodma_pattern(x.shape, cout, x.device) @ kf.view(27, cin, cout).sum(0)
    else:
        out = torch.zeros((m, cout), dtype=torch.float32, device=x.device)
        for tap, view in enumerate(_taps(x, 0, d, nopatch=variant == "nopatch")):
            out.addmm_(view.reshape(m, cin), kf[tap * cin:(tap + 1) * cin])
    return out.reshape(b, d, h, w, cout).to(x.dtype)


def im2col_plain(x: torch.Tensor, d0: int, td: int) -> torch.Tensor:
    """The plain patch of output depths [d0, d0 + td): fp32
    [B*td*H*W, 27*Cin], column ``tap*Cin + ci``."""
    b, _, h, w, cin = x.shape
    return torch.cat(_taps(x, d0, td), dim=-1).reshape(b * td * h * w, 27 * cin)


def bigdot_plain(x: torch.Tensor, km: torch.Tensor, td: int) -> torch.Tensor:
    """K8's plain version: per pass of ``td`` depths the fp32 patch times
    km, cast to x's dtype."""
    _check_conv(x, km)
    _check_td(x, td)
    b, d, h, w, _ = x.shape
    cout = km.shape[1]
    kf = km.float()
    out = torch.empty((b, d, h, w, cout), dtype=torch.float32, device=x.device)
    for d0 in range(0, d, td):
        out[:, d0:d0 + td] = (im2col_plain(x, d0, td) @ kf).reshape(b, td, h, w, cout)
    return out.to(x.dtype)


def dots_only_plain(p: torch.Tensor, km: torch.Tensor) -> torch.Tensor:
    """K9's plain version: the 9 products of p with km's row blocks, summed
    in fp32, cast to p's dtype."""
    _check_dots(p, km)
    cpad = p.shape[1]
    pf = p.float()
    out = torch.zeros((p.shape[0], km.shape[1]), dtype=torch.float32, device=p.device)
    for j in range(9):
        out.addmm_(pf, km[j * cpad:(j + 1) * cpad].float())
    return out.to(p.dtype)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"conv variant {variant!r} is not one of {VARIANTS}")


def _check_same(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"{name}: inputs on {a.device} and {b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: inputs of dtypes {a.dtype} and {b.dtype}")


def _check_conv(x: torch.Tensor, km: torch.Tensor) -> None:
    if x.dim() != 5 or km.dim() != 2:
        raise ValueError(f"conv variants take x [B,D,H,W,Cin] and km [9*CPAD, Cout]; got "
                         f"{tuple(x.shape)} and {tuple(km.shape)}")
    if km.shape[0] != 27 * x.shape[-1]:
        raise ValueError(f"km {tuple(km.shape)} needs 9*CPAD rows with CPAD = 3*Cin = "
                         f"{3 * x.shape[-1]}")
    _check_same("conv variants", x, km)


def _check_td(x: torch.Tensor, td: int) -> None:
    if td < 1 or x.shape[1] % td:
        raise ValueError(f"bigdot: td={td} must divide D={x.shape[1]}")


def _check_dots(p: torch.Tensor, km: torch.Tensor) -> None:
    if p.dim() != 2 or km.dim() != 2 or km.shape[0] != 9 * p.shape[1]:
        raise ValueError(f"dots_only takes p [P, CPAD] and km [9*CPAD, Cout]; got "
                         f"{tuple(p.shape)} and {tuple(km.shape)}")
    _check_same("dots_only", p, km)


def _check_kernel_input(name: str, *tensors) -> None:
    """What every kernel here takes: contiguous, 16-byte aligned bf16 on
    the card, every index in 32 bits."""
    if tensors[0].device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {tensors[0].device}")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned inputs")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{name}: {tuple(t.shape)} is out of the kernel's range")


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/conv3d_variants.cu's library with its launchers' signatures set."""
    lib = _build.load("conv3d_variants")
    for fn, argtypes in _LAUNCHERS.items():
        launcher = getattr(lib, fn)
        launcher.restype = ctypes.c_int
        launcher.argtypes = argtypes
    return lib


def _launch(fn: str, *args) -> None:
    lib = _library()
    _build.check(getattr(lib, fn)(*args), lib, "conv3d_variants_error_string", fn)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def conv_variant(x: torch.Tensor, km: torch.Tensor, variant: str) -> torch.Tensor:
    """K7 ``variant`` of the conv: the plain version on the CPU, the kernel
    ``conv3d_variant_<variant>`` on the card."""
    _check_conv(x, km)
    _check_variant(variant)
    if x.device.type == "cpu":
        return conv_variant_plain(x, km, variant)
    name = f"conv3d_variant_{variant}"
    check_no_autograd(name, x, km)
    _check_kernel_input(name, x, km)
    b, d, h, w, cin = x.shape
    cout = km.shape[1]
    if cin % 8:
        raise ValueError(f"{name}: Cin={cin} must be a multiple of 8")
    if b * d * h * w * cout > _INT32_MAX:
        raise ValueError(f"{name}: {tuple(x.shape)} -> {cout} is out of the kernel's range")
    plan = igemm_plan(tuple(x.shape), cout, sms=sm_count(x.device.index))
    wk = km.t().contiguous()  # [Cout, 27*Cin] = K5's [Cout, 27, Cin]
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("conv3d_variant", VARIANTS.index(variant), x.data_ptr(), wk.data_ptr(),
                out.data_ptr(), b, d, h, w, cin, cout, *plan, _stream(x))
    launch_counts[name] += 1
    return out


def bigdot(x: torch.Tensor, km: torch.Tensor, td: int = 4) -> torch.Tensor:
    """K8: per pass of ``td`` output depths, ``conv3d_bigdot_im2col`` writes
    the patch [B*td*H*W, 27*Cin] to device memory and ``conv3d_bigdot_gemm``
    multiplies it by km; the plain version on the CPU."""
    _check_conv(x, km)
    _check_td(x, td)
    if x.device.type == "cpu":
        return bigdot_plain(x, km, td)
    check_no_autograd("conv3d_bigdot", x, km)
    _check_kernel_input("conv3d_bigdot", x, km)
    b, d, h, w, cin = x.shape
    cout, k = km.shape[1], 27 * cin
    if cin % 8:  # im2col's 16-byte chunks stay within one tap
        raise ValueError(f"conv3d_bigdot: Cin={cin} must be a multiple of 8")
    if b * td * h * w * k > _INT32_MAX or b * d * h * w * cout > _INT32_MAX:
        raise ValueError(f"conv3d_bigdot: {tuple(x.shape)}, td={td} is out of the kernel's range")
    plan = dense_plan(td * h * w, b, cout, sm_count(x.device.index))
    wk = km.t().contiguous()  # [Cout, K]: one tap of K columns
    patch = torch.empty((b * td * h * w, k), dtype=x.dtype, device=x.device)
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    stream = _stream(x)
    with torch.cuda.device(x.device):
        for d0 in range(0, d, td):
            _launch("conv3d_bigdot_im2col", x.data_ptr(), patch.data_ptr(), b, d, h, w, cin, d0,
                    td, stream)
            launch_counts["conv3d_bigdot_im2col"] += 1
            _launch("conv3d_dense_gemm", 0, patch.data_ptr(), k, 1, wk.data_ptr(),
                    out[:, d0].data_ptr(), cout, d * h * w * cout, td * h * w, b, plan.bn, stream)
            launch_counts["conv3d_bigdot_gemm"] += 1
    return out


def dots_only(p: torch.Tensor, km: torch.Tensor) -> torch.Tensor:
    """K9: ``conv3d_dotsonly``, the dense GEMM over 9 taps of CPAD columns
    whose A box is at the same columns for every tap; the plain version on
    the CPU."""
    _check_dots(p, km)
    if p.device.type == "cpu":
        return dots_only_plain(p, km)
    check_no_autograd("conv3d_dotsonly", p, km)
    _check_kernel_input("conv3d_dotsonly", p, km)
    rows, cpad = p.shape
    cout = km.shape[1]
    if cpad % 8:  # p's rows in the tensor map are 16-byte multiples
        raise ValueError(f"conv3d_dotsonly: CPAD={cpad} must be a multiple of 8")
    if rows * cout > _INT32_MAX:
        raise ValueError(f"conv3d_dotsonly: {rows} x {cout} is out of the kernel's range")
    plan = dense_plan(rows, 1, cout, sm_count(p.device.index))
    wk = km.t().contiguous()  # [Cout, 9*CPAD] = [Cout, 9, CPAD]
    out = torch.empty((rows, cout), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        _launch("conv3d_dense_gemm", 1, p.data_ptr(), cpad, 9, wk.data_ptr(), out.data_ptr(),
                cout, 0, rows, 1, plan.bn, _stream(p))
    launch_counts["conv3d_dotsonly"] += 1
    return out
