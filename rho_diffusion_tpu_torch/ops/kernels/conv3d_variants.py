"""The conv's bottleneck-isolation kernels (K7-K9), forward only, as in JAX.

Ports of the TPU kernels of ``benchmarks/conv3d_variants.py`` onto the
port's own conv GEMM (``csrc/conv3d_variants.cu``, which shares K5's block
through ``csrc/conv3d_igemm.cuh``), with those functions' layouts:

* ``conv_variant(x, km, variant)``: K7. x [B, D, H, W, Cin]; km
  [9*CPAD, Cout] with CPAD = 3*Cin, row ``(dz*3+dy)*CPAD + dx*Cin + ci``
  (DHWIO flattened); out [B, D, H, W, Cout]. ``"full"`` is the conv,
  ``"nopatch"`` reads the (dz, dy) = (0, 0) rows for every tap (keeping dx),
  ``"nodma"`` reads no x at all: its A operand is the fixed pattern
  ``nodma_pattern`` (a deviation: the TPU kernel reads uninitialised
  scratch, so its output is undefined).
* ``bigdot(x, km, td)``: K8, the conv as an explicit patch matrix of ``td``
  output depth slices (device memory on the card) and one GEMM with
  K = 27*Cin per pass, D/td passes.
* ``dots_only(p, km)``: K9. p [P, CPAD]; out [P, Cout] (JAX's
  [P/M, M, Cout] is the same memory) = sum over the 9 row blocks of km of
  ``p @ km[j*CPAD:(j+1)*CPAD]``.

Each wrapper takes its plain version (``*_plain``: fp32, cast to the input
dtype) for CPU tensors; for a CUDA tensor it launches its kernels, counted
in ``launch_counts`` as ``conv3d_variant_<variant>``, ``conv3d_bigdot_im2col``
and ``conv3d_bigdot_gemm`` (one each per pass), and ``conv3d_dotsonly``, or
raises. The kernels take bf16 only.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts

VARIANTS = ("full", "nopatch", "nodma")
_TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]
_INT32_MAX = 2**31 - 1
# the dense GEMM's tile (csrc/conv3d_igemm.cuh): rows, output channels, depth
_BM, _BN, _BK = 128, 64, 32


def nodma_pattern(rows: int, cols: int, device=None) -> torch.Tensor:
    """The ``nodma`` kernel's A operand, fp32 [rows, cols]: element (m, k) is
    ((7 (m mod 128) + 3 (k mod 32)) mod 17 - 8) / 64, exact in bf16. The
    kernel writes it into both shared-memory stages once; each 128-row tile
    and 32-deep slice of A reads the same values."""
    r = torch.arange(rows, device=device).remainder(_BM)[:, None]
    c = torch.arange(cols, device=device).remainder(_BK)[None, :]
    return ((7 * r + 3 * c).remainder(17) - 8).float() / 64


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
        # rows repeat with period 128, so one tile's product is every tile's
        tile = nodma_pattern(_BM, 27 * cin, x.device) @ kf
        out = tile.repeat(-(-m // _BM), 1)[:m]
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


def _launch(fn: str, argtypes: list, *args) -> None:
    lib = _build.load("conv3d_variants")
    launcher = getattr(lib, fn)
    launcher.restype = ctypes.c_int
    launcher.argtypes = argtypes
    _build.check(launcher(*args), lib, "conv3d_variants_error_string", fn)


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
    wk = km.t().contiguous()  # [Cout, 27*Cin]: K5's k = tap*Cin + ci
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("conv3d_variant", [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                + [ctypes.c_void_p], VARIANTS.index(variant), x.data_ptr(), wk.data_ptr(),
                out.data_ptr(), b, d, h, w, cin, cout, _stream(x))
    launch_counts[name] += 1
    return out


_GEMM_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check_gemm(name: str, rows: int, cout: int, depth: int, batches: int) -> None:
    """The dense GEMM has no predicates: every tile is full."""
    if rows % _BM or cout % _BN or depth % _BK or batches > 65535:
        raise ValueError(
            f"{name}: the dense GEMM needs rows per batch % {_BM} == 0 (got {rows}), "
            f"Cout % {_BN} == 0 (got {cout}), a row length % {_BK} == 0 (got {depth}) "
            f"and at most 65535 batches (got {batches})")


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
    _check_gemm("conv3d_bigdot", td * h * w, cout, k, b)
    if b * td * h * w * k > _INT32_MAX or b * d * h * w * cout > _INT32_MAX:
        raise ValueError(f"conv3d_bigdot: {tuple(x.shape)}, td={td} is out of the kernel's range")
    wk = km.t().contiguous()
    patch = torch.empty((b * td * h * w, k), dtype=x.dtype, device=x.device)
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    stream = _stream(x)
    with torch.cuda.device(x.device):
        for d0 in range(0, d, td):
            _launch("conv3d_bigdot_im2col", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p], x.data_ptr(), patch.data_ptr(), b, d, h, w, cin, d0, td,
                    stream)
            launch_counts["conv3d_bigdot_im2col"] += 1
            _launch("conv3d_dense_gemm", _GEMM_ARGTYPES, 0, patch.data_ptr(), k,
                    td * h * w * k, wk.data_ptr(), k,
                    out[:, d0].data_ptr(), cout, d * h * w * cout, td * h * w, b, stream)
            launch_counts["conv3d_bigdot_gemm"] += 1
    return out


def dots_only(p: torch.Tensor, km: torch.Tensor) -> torch.Tensor:
    """K9: ``conv3d_dotsonly``, the dense GEMM with A's column at k mod
    CPAD over K = 9*CPAD; the plain version on the CPU."""
    _check_dots(p, km)
    if p.device.type == "cpu":
        return dots_only_plain(p, km)
    check_no_autograd("conv3d_dotsonly", p, km)
    _check_kernel_input("conv3d_dotsonly", p, km)
    rows, cpad = p.shape
    cout = km.shape[1]
    _check_gemm("conv3d_dotsonly", rows, cout, cpad, 1)
    if rows * cout > _INT32_MAX:
        raise ValueError(f"conv3d_dotsonly: {rows} x {cout} is out of the kernel's range")
    wk = km.t().contiguous()  # [Cout, 9*CPAD]
    out = torch.empty((rows, cout), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        _launch("conv3d_dense_gemm", _GEMM_ARGTYPES, 1, p.data_ptr(), cpad, 0, wk.data_ptr(),
                9 * cpad, out.data_ptr(), cout, 0, rows, 1, _stream(p))
    launch_counts["conv3d_dotsonly"] += 1
    return out
