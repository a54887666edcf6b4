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
with Tq, Tk <= 64, the ViT's attention) and the long route past it
(csrc/flash_attention_bwd_long.cuh: the ViT at patch 4, 512 patches) are
held by head dim, dtype and T, their shared memory written out, the long
route's blocks a batch*head and its scratch (linear in T), and the delta
pre-pass's head dims against the launcher's instances.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from rho_diffusion_tpu_torch.benchmarks import flash_fwd_narrow_ablation as fwd_ablation
from rho_diffusion_tpu_torch.benchmarks._ablation import patched
from rho_diffusion_tpu_torch.benchmarks.flash_bwd_long_ablation import SOURCE as ABLATED
from rho_diffusion_tpu_torch.benchmarks.flash_bwd_long_ablation import VARIANTS
from rho_diffusion_tpu_torch.ops.kernels._build import CSRC

from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.ops import attention as attn_mod
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    FLASH_BM, FLASH_BWD_BM, FP32_BWD_PLAN, FP32_PLAN, HEAD_DIMS, LONG_BWD_BM, LONG_BWD_PLAN,
    LONG_BWD_BLOCKS, LONG_BWD_STAGES, LONG_BWD_WARPGROUPS, MMA_SYNC_BWD_PLAN, MMA_SYNC_PLAN,
    NARROW_HEAD_DIMS, NARROW_PLAN, NARROW_STAGES, NARROW_WARPGROUPS, SMALL_BWD_HEAD_DIMS, SMALL_BWD_PLAN, SMALL_BWD_T, SMALL_BWD_WARPGROUPS, SMEM_LIMIT,
    TF32_BWD_PLAN, TF32_PLAN, WGMMA_BWD_PLANS, WGMMA_HEAD_DIMS, WGMMA_PLANS, WGMMA_TILES,
    FlashBwdPlan, FlashPlan, busiest_sm_rows, flash_bwd_plan, flash_plan, long_bwd_groups,
    long_bwd_scratch_bytes, narrow_fwd_smem_bytes, padded_head_dim)
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import _LAUNCHERS as FLASH_LAUNCHERS

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
    elif padded_head_dim(d) in NARROW_HEAD_DIMS:
        assert plan == NARROW_PLAN
    else:
        assert plan == MMA_SYNC_PLAN


@pytest.mark.parametrize("t", [1, 64, 65, 300, 512, 4096])
@pytest.mark.parametrize("d", [16, 32, 8, 20, 256])
def test_narrow_route_at_every_t(d, t):
    """bf16 at padded head dims 16 and 32 (the ViT's 16) takes the narrow
    kernel at every T, one tile or many, ragged or not, Tq = Tk or not; bf16
    at 256 keeps the mma.sync kernel; fp32 keeps its CUDA-core kernel."""
    for b, h, tk in ((32, 16, t), (2, 4, t), (1, 3, max(1, t // 3))):
        plan = flash_plan(b, h, t, tk, d, sms=SMS)
        assert plan == (MMA_SYNC_PLAN if d == 256 else NARROW_PLAN)
        assert flash_plan(b, h, t, tk, d, torch.float32, sms=SMS) == FP32_PLAN


@pytest.mark.parametrize("d", NARROW_HEAD_DIMS)
def test_narrow_instances_fit(d):
    """The narrow kernel's block at D = 16 and 32 (one instance each): two
    warpgroups, each with Q and three K stages as K-major [64][d] slots and
    three V stages as MN-major ones, 2 d bytes of each 128-byte row of a
    swizzled [64][64] region (8192 bytes; 4 slots a region at D = 16, 2 at
    32), then 1024 bytes of alignment: 33,792 bytes at D = 16 (a region of
    Q and K, one of V, a warpgroup) and 66,560 at D = 32 (two and two). So
    six blocks fit an SM at D = 16 and three at 32: the registers, held to
    three and two blocks an SM, set how many run. The header's constants
    are these, and the launcher's ctypes signature is the mma.sync
    kernel's (12 values of strides behind one pointer)."""
    slots = 128 // (2 * d)
    regions = -(-(1 + NARROW_STAGES) // slots) + -(-NARROW_STAGES // slots)
    written_out = NARROW_WARPGROUPS * regions * 64 * 128 + 1024
    assert narrow_fwd_smem_bytes(d) == written_out == {16: 33792, 32: 66560}[d] <= SMEM_LIMIT
    fit = {16: 6, 32: 3}[d]  # blocks an SM: the SM's 228 KB, 1 KB reserved a block
    assert fit * (written_out + 1024) <= 233472 < (fit + 1) * (written_out + 1024)
    assert (NARROW_PLAN.bm, NARROW_PLAN.bn) == (64, 64)
    header = (CSRC / "flash_attention_fwd_narrow.cuh").read_text()
    constants = dict(re.findall(r"constexpr int (\w+) = (\d+);", header))
    assert (int(constants["BM"]), int(constants["BN"])) == (NARROW_PLAN.bm, NARROW_PLAN.bn)
    assert int(constants["WGS"]) == NARROW_WARPGROUPS and int(constants["STAGES"]) == NARROW_STAGES
    assert (int(constants["MIN_BLOCKS_16"]), int(constants["MIN_BLOCKS_32"])) == (3, 2)
    assert fit >= int(constants[f"MIN_BLOCKS_{d}"])
    launchers = FLASH_LAUNCHERS["flash_attention"]
    assert launchers["flash_attention_fwd_narrow"] == launchers["flash_attention_fwd_bf16"]
    source = (CSRC / "flash_attention.cu").read_text()
    entry = source[source.index("int flash_attention_fwd_narrow("):]
    entry = entry[:entry.index(")")]
    assert entry.count(",") + 1 == len(launchers["flash_attention_fwd_narrow"]) == 13
    with pytest.raises(ValueError, match="narrow route"):
        narrow_fwd_smem_bytes(64)


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
    64-row tile and the long route past it, for bf16 at 256 the mma.sync
    pair;
    for fp32 the 3xTF32 pair at padded head dims 64 and 128 and the FMA
    pair elsewhere, whatever T; and no route at all (never one off the
    card) for other dtypes."""
    if dtype == torch.float16:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            flash_bwd_plan(2, 4, t, t, d, dtype)
        return
    plan = flash_bwd_plan(2, 4, t, t, d, dtype)
    assert plan.route in ("wgmma", "small", "long", "mma_sync", "tf32", "fp32")
    if dtype == torch.float32:
        tf32 = padded_head_dim(d) in (64, 128)
        assert plan == (TF32_BWD_PLAN if tf32 else FP32_BWD_PLAN)
        assert flash_plan(2, 4, t, t, d, dtype, sms=SMS).route == ("tf32" if tf32 else "fp32")
    elif padded_head_dim(d) in WGMMA_HEAD_DIMS:
        assert plan.route == "wgmma"
        assert flash_plan(2, 4, t, t, d, dtype, sms=SMS).route == "wgmma"
    elif padded_head_dim(d) in (16, 32):
        assert plan == (SMALL_BWD_PLAN if t <= 64 else LONG_BWD_PLAN)
    else:
        assert plan == MMA_SYNC_BWD_PLAN


@pytest.mark.parametrize("tq,tk,route", [
    (64, 64, "small"), (50, 50, "small"), (1, 1, "small"), (64, 17, "small"), (17, 64, "small"),
    (65, 64, "long"), (64, 65, "long"), (65, 65, "long"), (256, 256, "long"),
    (512, 512, "long"), (4096, 4096, "long"), (512, 65, "long"), (1, 4096, "long"),
])
@pytest.mark.parametrize("d", [16, 32, 9, 20])
def test_bwd_small_route_by_t(tq, tk, route, d):
    """The small route takes bf16 at padded head dims 16 and 32 (9 pads to
    16, 20 to 32) when every key and every query of a batch*head fits one
    64-row wgmma tile, whatever B and H (the ViT's B 32 x H 16 among
    them); one row past it on either side goes to the long route (T = 65,
    the ViT's 512 at patch 4, 4096), by the shape and never by a failure;
    the mma.sync pair takes neither."""
    assert SMALL_BWD_HEAD_DIMS == (16, 32) and SMALL_BWD_T == 64
    for b, h in ((32, 16), (2, 16), (1, 1), (256, 3)):
        plan = flash_bwd_plan(b, h, tq, tk, d)
        assert plan.route == route
        assert plan == (SMALL_BWD_PLAN if route == "small" else LONG_BWD_PLAN)
        assert plan != MMA_SYNC_BWD_PLAN


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


@pytest.mark.parametrize("d", SMALL_BWD_HEAD_DIMS)
def test_bwd_long_instances_fit(d):
    """The long kernel's block at D = 16 and 32 (one instance each): two
    warpgroups of 64 keys, so 128 keys a block; six 128-byte swizzled
    [64][64] bf16 tiles of 8192 bytes for K, V and the dS^T tile of 128
    keys, and per ring stage (s: 3 at D = 16, 2 at 32) two for Q and dO,
    the O tile (2 x 64 d), the lse row (4 x 64) and each warpgroup's delta
    row (2 x 4 x 64); one fp32 dQ share (4 x 64 d) and 1024 bytes of
    alignment: 111,872 bytes at D = 16 and 100,864 at D = 32, so two blocks
    fit an SM at both (a third stage would not at D = 32), and the ViT's
    patch-4 backward (B*H 512, T 512: 4 chunks of 128 keys a batch*head)
    is 512 blocks, one a batch*head, about two waves of two blocks on 132
    SMs."""
    assert LONG_BWD_PLAN.bn == 128 and LONG_BWD_WARPGROUPS == 2
    assert LONG_BWD_BM == 64 and LONG_BWD_STAGES == {16: 3, 32: 2}
    s = LONG_BWD_STAGES[d]
    written_out = ((6 + 2 * s) * 8192 + 4 * 64 * d + s * (2 * 64 * d + 4 * 64 + 2 * 4 * 64)
                   + 1024)
    assert LONG_BWD_PLAN.smem_bytes(d) == written_out == {16: 111872, 32: 100864}[d]
    deeper = written_out + 2 * 8192 + 2 * 64 * d + 3 * 4 * 64
    assert d == 16 or 2 * (deeper + 1024) > 233472
    assert 2 * (written_out + 1024) <= 233472  # the SM's 228 KB, 1 KB reserved a block
    assert written_out <= SMEM_LIMIT == 232448
    assert -(-512 // LONG_BWD_PLAN.bn) == 4
    assert 32 * 16 * long_bwd_groups(32 * 16, 512) == 512
    with pytest.raises(ValueError, match="head dims"):
        LONG_BWD_PLAN.smem_bytes(64)


@pytest.mark.parametrize("bh,tq,tk,groups", [
    (512, 512, 512, 1),       # the ViT at patch 4: one block of four chunks a batch*head
    (512, 65, 65, 1),         # one chunk: dQ written directly, no slots, no counter
    (1024, 4096, 4096, 1),    # B*H fills the card: one block of 32 chunks, no counter
    (1024, 16384, 16384, 1),  # the ViT on DeepGalaxy's 2-D config at patch 1
    (64, 2048, 2048, 5),      # 16 chunks over 5 blocks: 4 or 3 chunks each
    (16, 16384, 16384, 17),   # 128 chunks over 17 blocks
    (1, 4096, 4096, 32),      # one batch*head: a block a chunk
    (3, 100, 300, 3),         # Tq != Tk, 3 chunks
])
def test_bwd_long_groups_keep_scratch_linear(bh, tq, tk, groups):
    """The long route's blocks a batch*head: enough for LONG_BWD_BLOCKS (a
    wave of two blocks an SM on 132 SMs) in all, at most the chunks of 128
    keys; and so its fp32 dQ slots (one [64, D] tile a query tile a block,
    only where there is more than one chunk) and counters (only where
    there is more than one block) grow with T and not T^2: under (B*H +
    LONG_BWD_BLOCKS) * Tq' * D * 4 bytes, written out, with Tq' rounded up
    to 64 rows; dQ's own size in fp32 where B*H fills the card."""
    assert LONG_BWD_BLOCKS == 2 * SMS
    chunks = -(-tk // 128)
    assert long_bwd_groups(bh, tk) == groups == min(chunks, -(-264 // bh))
    tq_pad = -(-tq // 64) * 64
    for d in SMALL_BWD_HEAD_DIMS:
        got = long_bwd_scratch_bytes(bh, tq, tk, d)
        slots = bh * groups * tq_pad * d * 4 if chunks > 1 else 0
        assert got == slots + (4 * bh if groups > 1 else 0)
        assert got <= (bh + LONG_BWD_BLOCKS) * tq_pad * d * 4 + 4 * bh
        if bh >= LONG_BWD_BLOCKS and chunks > 1:
            assert got == bh * tq_pad * d * 4
    # the ViT at patch 4 at D = 16: 16.8 MB, where a slot set for every
    # 128 keys took 67.1 MB; and at T = 16384 with B*H 1024, 1.07 GB where
    # that took 137 GB
    assert long_bwd_scratch_bytes(512, 512, 512, 16) == 16_777_216
    assert long_bwd_scratch_bytes(1024, 16384, 16384, 16) == 1_073_741_824


def test_delta_kernel_head_dims():
    """The delta pre-pass has an instance at every padded head dim, so every
    bf16 route that takes it (the fused route at 64 and 128, the mma.sync
    pair at 256, and at 16, 32, 64 and 128 on request) finds one: the
    launcher's switch (csrc/flash_attention_bwd.cu) against HEAD_DIMS. The
    long route at 16 and 32 computes delta inside."""
    src = (ROOT / "rho_diffusion_tpu_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    launcher = src[src.index("int flash_attention_bwd_delta("):]
    launcher = launcher[:launcher.index("\n}\n")]
    instances = {int(x) for x in re.findall(r"launch_delta<(\d+)>", launcher)}
    assert instances == set(HEAD_DIMS) == {16, 32, 64, 128, 256}
    accepted = {int(x) for x in re.findall(r"D == (\d+)", launcher)}
    assert accepted == set(HEAD_DIMS)
    for d in HEAD_DIMS:
        route = flash_bwd_plan(2, 4, 512, 512, d).route
        assert route == ("long" if d in SMALL_BWD_HEAD_DIMS else
                         "mma_sync" if d == 256 else "wgmma")


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
    for plan in (None, *WGMMA_BWD_PLANS.values(), MMA_SYNC_BWD_PLAN, SMALL_BWD_PLAN,
                 LONG_BWD_PLAN):
        with pytest.raises(RuntimeError, match="no kernel for device cpu"):
            flash_attention_bwd_kernel(q, q, q, q, lse, q, plan=plan)
    q16 = torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_attention_bwd_kernel(q16, q16, q16, q16, lse, q16)
    q16 = torch.zeros(1, 512, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_attention_bwd_kernel(q16, q16, q16, q16, torch.zeros(1, 1, 512), q16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_delta_kernel(q, q)


@pytest.mark.parametrize("variant", sorted(fwd_ablation.VARIANTS))
def test_fwd_narrow_ablation_edits_apply(variant):
    """Each variant of the narrow forward's ablation
    (benchmarks/flash_fwd_narrow_ablation.py) finds every text it edits in
    the kernel's source exactly as often as it says; no_exp leaves no ex2
    call in the kernel's body; the base variant is the source itself."""
    text = (CSRC / fwd_ablation.SOURCE).read_text()
    out = patched(text, fwd_ablation.VARIANTS[variant], fwd_ablation.SOURCE)
    assert (out == text) == (variant == "base")
    body = out[out.index("flash_fwd_narrow_kernel("):]
    assert ("ex2(" in body) == (variant != "no_exp")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bwd_long_ablation_edits_apply(variant):
    """Each variant of the long backward's ablation
    (benchmarks/flash_bwd_long_ablation.py) finds every text it edits in
    the kernel's source exactly as often as it says, so the ablation
    measures the kernel as it is; the base variant is the source itself."""
    text = (CSRC / ABLATED).read_text()
    out = patched(text, VARIANTS[variant], ABLATED)
    assert (out == text) == (variant == "base")
    with pytest.raises(ValueError, match="occurs 0 times"):
        patched(text, [("no such text", "", 1)], ABLATED)
