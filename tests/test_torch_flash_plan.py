"""The flash forward's plan (``flash_plan``), on the CPU.

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
and the route each head dim and dtype takes.
"""
import json
from pathlib import Path

import pytest
import torch

from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.ops import attention as attn_mod
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    FLASH_BM, HEAD_DIMS, SMEM_LIMIT, WGMMA_HEAD_DIMS, WGMMA_PLANS, WGMMA_TILES, FlashPlan,
    busiest_sm_rows, flash_plan, padded_head_dim)

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
        assert flash_plan(batch, h, t, t, d, torch.float32, sms=SMS).route == "fp32"


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
        assert plan.route == "fp32"
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
