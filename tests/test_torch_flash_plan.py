"""The flash forward's plan (``flash_plan``) and the backward's
(``flash_bwd_plan``), on the CPU.

The wgmma kernel (csrc/flash_attention_wgmma.cuh) runs only on the card;
what it is given is decided here. The plan is held at every attention
problem the flagship (32^3) and the 64^3 config give the kernel, recorded
from a forward of the same UNet at a narrow width and a small grid and then
scaled (tokens with the grid, the head dim with the width), at batch 1, 4,
8 and 32, and at the ragged shapes of tests/test_torch_kernels_cuda.py:
TMA boxes of 64 channels (128 bytes, the swizzle span) by at most 256
tokens, a block in 232,448 bytes of shared memory after the 1024-byte
alignment, 64 or 128 query rows a block, the card filled as far as the
problem allows (the busiest SM's query rows the least of the two tiles),
and the route each head dim and dtype takes (fp32: the 3xTF32 routes at
padded head dims 64 and 128, the FMA kernels elsewhere). The backward's plan
(csrc/flash_attention_bwd_wgmma.cuh, the fused kernel) is held the same way:
at every attention problem of both configs at batch 1, 2, 8 and 32, its
route by head dim and dtype, every instance within shared memory with the
byte count written out, and no route off the card. The small route
(csrc/flash_attention_bwd_small.cuh: bf16 at padded head dims 16 and 32
with Tq, Tk <= 64, the ViT's attention) is held by head dim, dtype and T,
its shared memory written out, and the delta pre-pass's head dims against
the launcher's instances.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.ops import attention as attn_mod
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    FLASH_BM, FLASH_BWD_BM, FP32_BWD_PLAN, FP32_PLAN, HEAD_DIMS, MMA_SYNC_BWD_PLAN,
    SMALL_BWD_HEAD_DIMS, SMALL_BWD_PLAN, SMALL_BWD_T, SMALL_BWD_WARPGROUPS, SMEM_LIMIT,
    TF32_BWD_PLAN, TF32_PLAN, WGMMA_BWD_PLANS, WGMMA_HEAD_DIMS, WGMMA_PLANS, WGMMA_TILES,
    FlashBwdPlan, FlashPlan, busiest_sm_rows, flash_bwd_plan, flash_plan, padded_head_dim)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"32^3": "config_spherical_harmonics.json", "64^3": "config_spherical_harmonics_64.json"}
SMALL_MC, SMALL_D, SMALL_HW = 8, 2, 16  # the recording's width and grid
SMS = 132  # the H100 SXM's multiprocessors
BOX_CHANNELS = 64  # a box's inner extent: 64 bf16 = 128 bytes


def recorded_problems(config: str) -> list:
    """(tokens, heads, head dim) of every attention call of one forward of
    the config's UNet at full width, in order."""
    kw = json.loads((ROOT / "examples" / CONFIGS[config]).read_text())["model"]["kwargs"]
    mc, (d, h, _) = kw["model_channels"], kw["data_shape"]
    small = {k: v for k, v in kw.items() if k not in ("num_classes", "cond_fn")}
    small.update(model_channels=SMALL_MC, data_shape=(SMALL_D, SMALL_HW, SMALL_HW))
    unet = UNet(**small).eval()
    calls = []
    real = attn_mod.flash_attention

    def record(q, k, v):
        calls.append(tuple(q.shape[1:]))
        return real(q, k, v)

    attn_mod.flash_attention = record
    try:
        with torch.no_grad():
            unet(torch.zeros(1, SMALL_D, SMALL_HW, SMALL_HW, 1), torch.zeros(1, dtype=torch.long))
    finally:
        attn_mod.flash_attention = real
    grid = (d // SMALL_D) * (h // SMALL_HW) ** 2  # tokens scale with the volume
    return [(t * grid, heads, hd * mc // SMALL_MC) for t, heads, hd in calls]


@pytest.fixture(scope="module")
def problems():
    return {name: recorded_problems(name) for name in CONFIGS}


def test_recorded_problems_are_the_configs_attention(problems):
    """Six attention blocks of 4 heads of 128 at ds = 8: 32 x 4 x 4 = 512
    tokens on the flagship, 64 x 8 x 8 = 4096 on the 64^3 config."""
    assert problems["32^3"] == [(512, 4, 128)] * 6
    assert problems["64^3"] == [(4096, 4, 128)] * 6


def check_wgmma_plan(plan: FlashPlan, b: int, h: int, t: int, d: int) -> None:
    assert plan.route == "wgmma"
    assert plan.bm in FLASH_BM and (plan.bm, plan.bn) in WGMMA_TILES
    # TMA boxes: 64 channels (128 bytes, the 128-byte swizzle span) by BM
    # query rows or BN keys, every side at most 256
    assert BOX_CHANNELS * 2 == 128 and max(plan.bm, plan.bn, BOX_CHANNELS) <= 256
    assert padded_head_dim(d) % BOX_CHANNELS == 0
    # Q, the K/V ring and its barriers, after the 1024-byte alignment
    assert plan.smem_bytes(padded_head_dim(d)) <= SMEM_LIMIT
    # the card filled: blocks are dealt out to the SMs (two consumer
    # warpgroups on each: one block of 128 rows or two of 64), and the
    # busiest SM's share of query rows is the least either tile gives
    # (the larger tile on a tie), so a problem with at least as many 64-row
    # tiles as SMs keeps every SM busy for the first wave
    rows = {m: busiest_sm_rows(m, b, h, t, SMS) for m in FLASH_BM}
    assert rows[plan.bm] == min(rows.values())
    assert plan.bm == 128 or rows[64] < rows[128]
    # K/V tiles as long as the query tile (64 where there are no more keys):
    # the tile study's choice on the H100
    assert plan.bn in (plan.bm, 64)


@pytest.mark.parametrize("batch", [1, 4, 8, 32])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plan_at_every_config_problem(problems, config, batch):
    for t, h, d in set(problems[config]):
        plan = flash_plan(batch, h, t, t, d, sms=SMS)
        check_wgmma_plan(plan, batch, h, t, d)
        # fp32 at the configs' head dim 128: the 3xTF32 fold (one shard)
        assert flash_plan(batch, h, t, t, d, torch.float32, sms=SMS) == TF32_PLAN


@pytest.mark.parametrize("b,t,h,d,bm", [
    (4, 512, 4, 128, 64),     # sampling batch 4: 16 heads; 64 blocks of 128 rows fill half the SMs
    (8, 512, 4, 128, 128),    # 128 blocks of 128 rows: one a busy SM, as 256 of 64 give two
    (32, 512, 4, 128, 128),   # the training step: 512 blocks of 128 rows
    (8, 4096, 4, 128, 128),   # the 64^3 config: 1024 blocks of 128 rows
    (1, 4096, 4, 128, 128),   # 128 blocks of 128 rows
    (1, 4096, 2, 128, 64),    # 64 blocks of 128 rows would idle half the SMs
])
def test_plan_rows_a_block(b, t, h, d, bm):
    plan = flash_plan(b, h, t, t, d, sms=SMS)
    assert plan == FlashPlan("wgmma", bm, bm)
    check_wgmma_plan(plan, b, h, t, d)


@pytest.mark.parametrize("b,tq,tk,h,d", [
    (2, 300, 300, 4, 128), (2, 300, 300, 2, 64), (1, 300, 300, 2, 64), (1, 70, 130, 3, 64),
    (2, 64, 64, 2, 100), (1, 40, 40, 1, 64),
])
def test_plan_at_ragged_shapes(b, tq, tk, h, d):
    plan = flash_plan(b, h, tq, tk, d, sms=SMS)
    check_wgmma_plan(plan, b, h, tq, d)
    assert plan.bn == (64 if tk <= 64 else plan.bm)


@pytest.mark.parametrize("d", list(range(1, 257, 7)) + list(HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_route_by_head_dim_and_dtype(d, dtype):
    if dtype == torch.float16:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            flash_plan(2, 4, 512, 512, d, dtype, sms=SMS)
        return
    plan = flash_plan(2, 4, 512, 512, d, dtype, sms=SMS)
    if dtype == torch.float32:
        # 3xTF32 at padded head dims 64 and 128, the FMA kernel elsewhere
        assert plan == (TF32_PLAN if padded_head_dim(d) in (64, 128) else FP32_PLAN)
    elif padded_head_dim(d) in WGMMA_HEAD_DIMS:
        assert plan.route == "wgmma"
    else:
        assert plan.route == "mma_sync"


@pytest.mark.parametrize("d", WGMMA_HEAD_DIMS)
def test_every_tile_of_the_kernel_fits(d):
    """Every instance the launcher has (BM x BN, a ring of two stages) fits
    in shared memory, the largest at D = 128 in 164,920 bytes; and at
    64 x 64 two blocks fit on one SM."""
    sizes = {(p.bm, p.bn): p.smem_bytes(d) for p in WGMMA_PLANS}
    assert max(sizes.values()) <= SMEM_LIMIT
    assert 2 * sizes[(64, 64)] <= SMEM_LIMIT
    if d == 128:
        assert sizes[(128, 128)] == 164920


def test_kernel_wrappers_have_no_cpu_route():
    """On the CPU the forward's kernel wrapper and the P V probe raise: only
    ``flash_attention`` (the autograd Function) takes the plain versions."""
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd_kernel, wgmma_pv_probe)

    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_attention_fwd_kernel(q, q, q, plan=flash_plan(1, 1, 8, 8, 64))
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        wgmma_pv_probe(torch.zeros(64, 64, dtype=torch.bfloat16), q[0, :, 0].repeat(8, 1))


# ---------------------------------------------------------------------------
# The backward's plan (the fused kernel's tiles)
# ---------------------------------------------------------------------------

def check_bwd_plan(plan: FlashBwdPlan, d: int) -> None:
    dk = padded_head_dim(d)
    assert plan.route == "wgmma" and plan == WGMMA_BWD_PLANS[dk]
    # 64 keys a consumer warpgroup, each taking one 64-channel chunk of dQ:
    # as many keys a block as channels, whatever the shape
    assert plan.bn == dk
    # TMA boxes of 64 channels by at most 256 rows
    assert dk % BOX_CHANNELS == 0 and max(FLASH_BWD_BM, plan.bn) <= 256
    assert plan.smem_bytes() <= SMEM_LIMIT


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bwd_plan_at_every_config_problem(problems, config, batch):
    """The flagship's T = 512 and the 64^3 config's T = 4096, 4 heads of
    128: the fused kernel at 128 keys a block; fp32 takes the 3xTF32 pair."""
    for t, h, d in set(problems[config]):
        plan = flash_bwd_plan(batch, h, t, t, d)
        check_bwd_plan(plan, d)
        assert plan == FlashBwdPlan("wgmma", 128)
        assert flash_bwd_plan(batch, h, t, t, d, torch.float32) == TF32_BWD_PLAN


@pytest.mark.parametrize("b,tq,tk,h,d,bn", [
    (2, 300, 300, 4, 128, 128), (2, 300, 300, 2, 64, 64), (1, 70, 130, 3, 64, 64),
    (1, 130, 70, 3, 128, 128), (2, 64, 64, 2, 100, 128), (1, 200, 40, 2, 128, 128),
])
def test_bwd_plan_at_ragged_shapes(b, tq, tk, h, d, bn):
    """Short and ragged key ranges keep the head dim's tile (the keys past
    Tk are masked)."""
    plan = flash_bwd_plan(b, h, tq, tk, d)
    check_bwd_plan(plan, d)
    assert plan.bn == bn


@pytest.mark.parametrize("t", [512, 64])
@pytest.mark.parametrize("d", list(range(1, 257, 7)) + list(HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_bwd_route_by_head_dim_and_dtype(d, dtype, t):
    """As the forward's: the fused kernel for bf16 at padded head dims 64
    and 128; for bf16 at padded 16 and 32 the small route where T fits one
    64-row tile and the mma.sync pair past it, for bf16 at 256 the pair;
    for fp32 the 3xTF32 pair at padded head dims 64 and 128 and the FMA
    pair elsewhere, whatever T; and no route at all (never one off the
    card) for other dtypes."""
    if dtype == torch.float16:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            flash_bwd_plan(2, 4, t, t, d, dtype)
        return
    plan = flash_bwd_plan(2, 4, t, t, d, dtype)
    assert plan.route in ("wgmma", "small", "mma_sync", "tf32", "fp32")
    if dtype == torch.float32:
        tf32 = padded_head_dim(d) in (64, 128)
        assert plan == (TF32_BWD_PLAN if tf32 else FP32_BWD_PLAN)
        assert flash_plan(2, 4, t, t, d, dtype, sms=SMS).route == ("tf32" if tf32 else "fp32")
    elif padded_head_dim(d) in WGMMA_HEAD_DIMS:
        assert plan.route == "wgmma"
        assert flash_plan(2, 4, t, t, d, dtype, sms=SMS).route == "wgmma"
    elif padded_head_dim(d) in (16, 32) and t <= 64:
        assert plan == SMALL_BWD_PLAN
    else:
        assert plan == MMA_SYNC_BWD_PLAN


@pytest.mark.parametrize("tq,tk,route", [
    (64, 64, "small"), (50, 50, "small"), (1, 1, "small"), (64, 17, "small"), (17, 64, "small"),
    (65, 64, "mma_sync"), (64, 65, "mma_sync"), (65, 65, "mma_sync"), (256, 256, "mma_sync"),
])
@pytest.mark.parametrize("d", [16, 32, 9, 20])
def test_bwd_small_route_by_t(tq, tk, route, d):
    """The small route takes bf16 at padded head dims 16 and 32 (9 pads to
    16, 20 to 32) when every key and every query of a batch*head fits one
    64-row wgmma tile, whatever B and H (the ViT's B 32 x H 16 among
    them); one row past it on either side goes to the pair, by the shape
    and never by a failure."""
    assert SMALL_BWD_HEAD_DIMS == (16, 32) and SMALL_BWD_T == 64
    for b, h in ((32, 16), (2, 16), (1, 1), (256, 3)):
        plan = flash_bwd_plan(b, h, tq, tk, d)
        assert plan.route == route
        assert plan == (SMALL_BWD_PLAN if route == "small" else MMA_SYNC_BWD_PLAN)


def test_bwd_small_instances_fit():
    """The small kernel's block at D = 16 and 32 alike (one instance each,
    the same tiles): two warpgroups, each with K, V, Q, dO and the dS^T tile
    as 128-byte swizzled [64][64] bf16 tiles (5 x 8192 bytes), the lse and
    delta rows (2 x 4 x 64), rounded up to 1024 bytes (41,984), then 1024
    bytes of alignment: 84,992 bytes, so two blocks (four batch*heads) fit
    an SM and the ViT's 512 batch*heads take one wave of 132 SMs."""
    region = 5 * 64 * 128 + 2 * 4 * 64
    assert region == 41472
    region = -(-region // 1024) * 1024
    assert region == 41984 and SMALL_BWD_WARPGROUPS == 2
    written_out = 2 * 41984 + 1024
    assert SMALL_BWD_PLAN.smem_bytes() == written_out == 84992
    assert 2 * (written_out + 1024) <= 233472  # the SM's 228 KB, 1 KB reserved a block
    assert 2 * 2 * SMS >= 32 * 16


def test_delta_kernel_head_dims():
    """The delta pre-pass has an instance at every padded head dim, so every
    bf16 route that takes it (the fused route at 64 and 128, the mma.sync
    pair at 16, 32 and 256, and at 64 and 128 on request) finds one: the
    launcher's switch (csrc/flash_attention_bwd.cu) against HEAD_DIMS."""
    src = (ROOT / "rho_diffusion_tpu_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    launcher = src[src.index("int flash_attention_bwd_delta("):]
    launcher = launcher[:launcher.index("\n}\n")]
    instances = {int(x) for x in re.findall(r"launch_delta<(\d+)>", launcher)}
    assert instances == set(HEAD_DIMS) == {16, 32, 64, 128, 256}
    accepted = {int(x) for x in re.findall(r"D == (\d+)", launcher)}
    assert accepted == set(HEAD_DIMS)
    for d in HEAD_DIMS:
        assert flash_bwd_plan(2, 4, 512, 512, d).route in ("wgmma", "mma_sync")


@pytest.mark.parametrize("d", WGMMA_HEAD_DIMS)
def test_every_bwd_instance_fits(d):
    """The fused launcher's instance at D = 64 and at 128 fits in shared
    memory, the byte count written out: K and V (2 x 2 d bn), the Q and dO
    rings (2 stages x 2 x 2 d bm), the bf16 dS^T tile (2 bn bm), dQ's two
    fp32 shares (2 x 4 bm d), the lse and delta rows (2 stages x 2 x 4 bm),
    3 mbarriers of 8 bytes and 1024 bytes of alignment, with bn = d keys and
    bm = 64 query rows. The flagship's block at D = 128 takes 215,064 bytes
    (one block an SM); at D = 64 two blocks fit."""
    plan, bm = WGMMA_BWD_PLANS[d], FLASH_BWD_BM
    assert plan.bn == d and bm == 64
    written_out = (2 * 2 * d * plan.bn + 2 * 2 * 2 * d * bm + 2 * plan.bn * bm
                   + 2 * 4 * bm * d + 2 * 2 * 4 * bm + 8 * 3 + 1024)
    assert plan.smem_bytes() == written_out <= SMEM_LIMIT
    if d == 128:
        assert plan.smem_bytes() == 215064
    else:
        assert 2 * plan.smem_bytes() <= SMEM_LIMIT


def test_bwd_kernel_wrapper_has_no_cpu_route():
    """On the CPU the backward's kernel wrapper raises, with or without a
    plan, and so does its delta pre-pass; only the autograd Function takes
    the plain versions there."""
    from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_delta_kernel)

    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    for plan in (None, *WGMMA_BWD_PLANS.values(), MMA_SYNC_BWD_PLAN, SMALL_BWD_PLAN):
        with pytest.raises(RuntimeError, match="no kernel for device cpu"):
            flash_attention_bwd_kernel(q, q, q, q, lse, q, plan=plan)
    q16 = torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_attention_bwd_kernel(q16, q16, q16, q16, lse, q16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_delta_kernel(q, q)
