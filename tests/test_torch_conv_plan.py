"""The implicit-GEMM conv's box plan (``igemm_plan``), on the CPU, and the
fp32 route's (``conv_route``, ``tf32_plan``).

The kernel (csrc/conv3d_wgmma.cuh) runs only on the card; what it is given
is decided here. The plan is held at every conv problem the flagship UNet
(32^3) and the 64^3 config give the kernel, at batch 1, 8 and 32, forward
and dgrad, and at the ragged shapes of tests/test_torch_kernels_cuda.py:
a box of 128 voxels whose sides the TMA unit takes, 64 channels a k-step
(the 128-byte swizzle span), boxes that cover the volume, N tiles that
cover Cout, and a ring that fits in shared memory. The problems are
recorded from a forward of the same UNet at a narrow width and a small
grid, then scaled: every channel count is a multiple of model_channels and
every level halves H and W.
"""
import json
import math
from pathlib import Path

import pytest
import torch

from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.ops import convolution as conv_mod
from rho_diffusion_tpu_torch.ops.kernels.conv3d import (
    IGEMM_BK, IGEMM_BM, IGEMM_BN, IGEMM_STAGES, SMEM_LIMIT, TF32_BK, TF32_BN_MAX, TF32_STAGES,
    conv_route, igemm_plan, tf32_plan, tf32_smem_bytes)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"32^3": "config_spherical_harmonics.json", "64^3": "config_spherical_harmonics_64.json"}
SMALL_MC, SMALL_HW = 8, 24  # the recording's width and inner grid (24 -> 3 at level 3)
# the flagship's boxes (bw, bh, bd) by W (D stays 32 or 64)
BOXES = {64: (64, 2, 1), 32: (32, 4, 1), 16: (16, 8, 1), 8: (8, 8, 2), 4: (4, 4, 8)}


def recorded_problems(config: str) -> list:
    """(D, H, W, Cin, Cout) of every 3x3x3 conv of one forward of the
    config's UNet at full width, in order."""
    kw = json.loads((ROOT / "examples" / CONFIGS[config]).read_text())["model"]["kwargs"]
    mc, (d, h, _) = kw["model_channels"], kw["data_shape"]
    small = {k: v for k, v in kw.items() if k not in ("num_classes", "cond_fn")}
    small.update(model_channels=SMALL_MC, data_shape=(2, SMALL_HW, SMALL_HW))
    unet = UNet(**small).eval()
    calls = []
    real = conv_mod.conv3d

    def record(x, weight, *args, **kwargs):
        calls.append((x.shape[2], x.shape[-1], weight.shape[0]))
        return real(x, weight, *args, **kwargs)

    conv_mod.conv3d = record
    try:
        with torch.no_grad():
            unet(torch.zeros(1, 2, SMALL_HW, SMALL_HW, 1), torch.zeros(1, dtype=torch.long))
    finally:
        conv_mod.conv3d = real
    scale = mc // SMALL_MC
    out = []
    for hs, cin, cout in calls:
        level = int(math.log2(SMALL_HW // hs))
        out.append((d, h >> level, h >> level, cin if cin == 1 else cin * scale,
                    cout if cout == 1 else cout * scale))
    return out


@pytest.fixture(scope="module")
def problems():
    return {name: recorded_problems(name) for name in CONFIGS}


def igemm_problems(problems, config: str, batch: int, kind: str) -> list:
    """The (x shape, Cout) the implicit GEMM gets: every conv but the Cin=1
    input conv and the fp32 Cout=1 head, which take the direct kernel; for
    dgrad the same convs with input and output channels swapped."""
    out = set()
    for d, h, w, cin, cout in problems[config]:
        if cin == 1 or cout == 1:
            continue
        if kind == "dgrad":
            cin, cout = cout, cin
        out.add(((batch, d, h, w, cin), cout))
    return sorted(out)


def check_plan(x_shape, cout: int, sms: int = 132):
    plan = igemm_plan(x_shape, cout, sms=sms)
    _, d, h, w, cin = x_shape
    assert plan.bw * plan.bh * plan.bd == IGEMM_BM == 128
    assert all(1 <= s <= 256 for s in (plan.bw, plan.bh, plan.bd))  # TMA box sides
    assert IGEMM_BK * 2 == 128  # one k-step's channels span the 128-byte swizzle
    batch, tiles_d, tiles_h, tiles_w, n_tiles = plan.grid(x_shape, cout)
    for size, box, tiles in ((d, plan.bd, tiles_d), (h, plan.bh, tiles_h), (w, plan.bw, tiles_w)):
        assert tiles * box >= size > (tiles - 1) * box  # covered, and no box wholly outside
    assert plan.bn in IGEMM_BN and plan.bn <= 256 and plan.bn % 64 == 0
    assert n_tiles == math.ceil(cout / plan.bn) and (n_tiles - 1) * plan.bn < cout
    assert plan.stages in IGEMM_STAGES
    assert plan.smem_bytes() <= SMEM_LIMIT == 232448  # 227 KB
    assert batch == x_shape[0]
    return plan


def test_recorded_problems_are_the_flagships(problems):
    """At 32^3 the kernel sees Cin in {64, ..., 1024} and Cout in {64, 128,
    256, 512} (and the reverse in dgrad); D stays 32, W halves per level."""
    fwd = igemm_problems(problems, "32^3", 8, "forward")
    assert {x[-1] for x, _ in fwd} == {64, 128, 192, 256, 384, 512, 768, 1024}
    assert {c for _, c in fwd} == {64, 128, 256, 512}
    assert {x[3] for x, _ in fwd} == {32, 16, 8, 4} and {x[1] for x, _ in fwd} == {32}
    dgrad = igemm_problems(problems, "32^3", 8, "dgrad")
    assert {c for _, c in dgrad} == {x[-1] for x, _ in fwd}
    assert {x[3] for x, _ in igemm_problems(problems, "64^3", 1, "forward")} == {64, 32, 16, 8}
    # the flagship's convs in one forward: 47 on the kernel path, + input conv and head
    assert len(problems["32^3"]) == 49


@pytest.mark.parametrize("kind", ["forward", "dgrad"])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_igemm_plan_holds_at_every_flagship_problem(problems, config, batch, kind):
    for x_shape, cout in igemm_problems(problems, config, batch, kind):
        plan = check_plan(x_shape, cout)
        assert (plan.bw, plan.bh, plan.bd) == BOXES[x_shape[3]]
        assert plan.stages == 4


def test_igemm_plan_n_tiles_fill_the_card():
    """Wide N tiles where the boxes fill the card, narrower ones where they
    do not: at batch 32 one tile up to 256 channels, two of 192 for 384,
    four of 256 for the bottleneck dgrad's 1024; at batch 8 the level-3
    conv's 64 boxes take two tiles of 128 over 128 SMs, not 64 on 64."""
    assert igemm_plan((32, 32, 32, 32, 64), 64).bn == 64
    assert igemm_plan((32, 32, 16, 16, 128), 128).bn == 128
    assert igemm_plan((32, 32, 8, 8, 256), 256).bn == 256
    assert igemm_plan((32, 32, 8, 8, 192), 384).bn == 192
    assert igemm_plan((32, 32, 4, 4, 512), 512).bn == 256
    assert igemm_plan((32, 32, 4, 4, 512), 1024).bn == 256
    assert igemm_plan((8, 32, 4, 4, 512), 512).bn == 128
    assert igemm_plan((8, 32, 4, 4, 512), 512, sms=64).bn == 256
    assert igemm_plan((8, 32, 4, 4, 512), 512, bn_max=64).bn == 64


@pytest.mark.parametrize("x_shape,cout", [
    # tests/test_torch_kernels_cuda.py's implicit-GEMM forward cases
    ((2, 5, 6, 7, 64), 64), ((1, 3, 5, 4, 8), 72), ((3, 4, 4, 4, 24), 10),
    ((2, 8, 8, 8, 192), 64), ((3, 5, 6, 7, 128), 96), ((2, 6, 9, 10, 24), 64),
    ((1, 7, 6, 5, 8), 16), ((1, 64, 64, 64, 64), 64), ((2, 32, 4, 4, 512), 512),
    ((2, 32, 4, 4, 1024), 512), ((2, 9, 5, 12, 72), 200),
    # and its dgrad cases, as the kernel sees them (g's channels in, Cin out)
    ((2, 5, 6, 7, 64), 64), ((1, 3, 5, 4, 72), 8), ((2, 4, 4, 4, 24), 10),
    ((32, 32, 4, 4, 512), 1024),
])
def test_igemm_plan_holds_at_ragged_shapes(x_shape, cout):
    plan = check_plan(x_shape, cout)
    assert plan.bw == min(1 << (x_shape[3] - 1).bit_length(), 128)


# ---- the fp32 route: 3xTF32 on K5's block (csrc/conv3d_tf32.cuh) ----


def fp32_problems(problems, config: str, batch: int, kind: str) -> list:
    """Every fp32 conv problem of the config's UNet run in fp32, as the
    kernels see them (x shape, Cout): the input conv and the head too."""
    out = set()
    for d, h, w, cin, cout in problems[config]:
        if kind == "dgrad":
            if cin == 1:
                continue  # x_t needs no gradient
            cin, cout = cout, cin
        out.add(((batch, d, h, w, cin), cout))
    return sorted(out)


def check_tf32_plan(x_shape, cout: int):
    plan = tf32_plan(x_shape, cout)
    assert plan[:4] == igemm_plan(x_shape, cout, bn_max=TF32_BN_MAX)[:4]  # K5's box and N tile
    assert plan.stages == TF32_STAGES[plan.bn]
    assert -(-cout // plan.bn) * plan.bn >= cout > (-(-cout // plan.bn) - 1) * plan.bn
    assert TF32_BK * 4 == 128  # a k-step's fp32 channels span the 128-byte swizzle
    # per stage: A's 16 KB box and both weight terms, BN rows of 128 bytes each
    assert tf32_smem_bytes(plan) == plan.stages * (16384 + 2 * plan.bn * 128) + 16 * plan.stages + 1024
    assert tf32_smem_bytes(plan) <= SMEM_LIMIT
    return plan


def test_tf32_tiles_and_stages_fit():
    """N tiles of 64 or 128 channels (a k-step's partial sum beside the
    total holds 2 x BN/2 fp32 a consumer thread), with 4 stages: 128 and
    192 KB of the 227 KB."""
    assert TF32_BN_MAX == 128 and TF32_STAGES == {64: 4, 128: 4}
    for bn, stages in TF32_STAGES.items():
        plan = tf32_plan((8, 32, 32, 32, 64), 64)._replace(bn=bn, stages=stages)
        assert tf32_smem_bytes(plan) <= SMEM_LIMIT
    assert tf32_smem_bytes(plan) == 4 * (16384 + 2 * 128 * 128) + 64 + 1024


def test_tf32_plan_n_tiles():
    """K5's cost rule with N tiles of at most 128 channels: Cout 64 one tile
    of 64, Cout 256 two of 128, the bottleneck dgrad's 1024 eight; 70
    channels over 5 boxes two of 64, which costs less than one of 128."""
    assert tf32_plan((32, 32, 32, 32, 64), 64).bn == 64
    assert tf32_plan((32, 32, 8, 8, 256), 256).bn == 128
    assert tf32_plan((32, 32, 4, 4, 512), 1024).bn == 128
    assert tf32_plan((8, 32, 16, 16, 384), 128).bn == 128
    assert tf32_plan((1, 5, 7, 9, 12), 70).bn == 64


@pytest.mark.parametrize("kind", ["forward", "dgrad"])
@pytest.mark.parametrize("batch", [2, 8, 32])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fp32_route_at_every_flagship_problem(problems, config, batch, kind):
    """In fp32 every conv of the UNet but the Cin=1 input conv and the
    Cout=1 head (and the head's Cin'=1 dgrad) takes the 3xTF32 block, with
    K5's box and a ring that fits; those take the direct kernel."""
    routes = {}
    for x_shape, cout in fp32_problems(problems, config, batch, kind):
        route = conv_route(torch.float32, x_shape[-1], cout)
        routes[(x_shape[-1], cout)] = route
        if x_shape[-1] == 1 or cout == 1:
            assert route == "direct"
        else:
            assert route == "tf32"
            plan = check_tf32_plan(x_shape, cout)
            assert (plan.bw, plan.bh, plan.bd) == BOXES[x_shape[3]]
    assert "tf32" in routes.values() and "direct" in routes.values()


@pytest.mark.parametrize("dtype,cin,cout,route", [
    (torch.float32, 64, 64, "tf32"), (torch.float32, 4, 2, "tf32"),
    (torch.float32, 12, 70, "tf32"), (torch.float32, 64, 2, "tf32"),  # the learned-variance head
    (torch.float32, 6, 10, "direct"), (torch.float32, 1, 64, "direct"),
    (torch.float32, 64, 1, "direct"), (torch.float32, 2, 64, "direct"),
    (torch.bfloat16, 64, 1, "igemm"), (torch.bfloat16, 12, 64, "direct"),
    (torch.bfloat16, 1, 64, "direct"),
])
def test_conv_route_goes_by_dtype_and_channels(dtype, cin, cout, route):
    assert conv_route(dtype, cin, cout) == route


@pytest.mark.parametrize("x_shape,cout", [
    # tests/test_torch_kernels_cuda.py's 3xTF32 cases: ragged volumes and
    # channels, Cin % 32 != 0 (zero-filled channels past Cin), Cout off 64
    ((1, 5, 7, 9, 12), 70), ((2, 3, 5, 4, 4), 2), ((2, 9, 5, 12, 72), 200),
    ((2, 32, 4, 4, 1024), 512), ((32, 32, 4, 4, 512), 1024), ((2, 32, 32, 32, 64), 64),
])
def test_tf32_plan_holds_at_ragged_shapes(x_shape, cout):
    check_tf32_plan(x_shape, cout)
