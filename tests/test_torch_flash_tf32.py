"""The fp32 flash routes on the tensor cores (3xTF32), on the CPU.

The flash forward at fp32 head dims 64 and 128 runs K6's 3xTF32 fold with
one shard (csrc/ring_attention_tf32.cuh) after its K/V pre-pass, and the
backward a 3xTF32 dkv/dq pair (csrc/flash_attention_bwd_tf32.cuh) after a
pre-pass that splits q, dO, k and v. Both run only on the card; here their
design is held with plain versions in ``ops/kernels/flash_attention.py``:

* the layouts both pre-passes write (``flash_split_plain``,
  ``flash_bwd_split_plain``; chip_smoke.py and the card's tests hold the
  pre-pass kernels against them bitwise), and a forward folded from the
  forward's split terms, with its base-2 LSE;
* the arithmetic (``flash_tf32_plain``, ``flash_bwd_tf32_plain``: every
  product three TF32 products, summed in the kernels' chunks of 32) against
  the plain flash forward and backward in fp64 at the JAX package's fp32
  tolerances (2e-5 forward, 5e-5 gradients; relative to the reference's max
  and rms, as chip_smoke.py checks), which one TF32 product a term misses;
* the same against the JAX package's Pallas flash attention in interpret
  mode and its ``jax.grad``, on the same numpy inputs;
* every new kernel instance within the H100's shared memory, and no CPU
  route in the new wrappers.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    LOG2E, SMEM_LIMIT, TF32_BWD_BN, TF32_BWD_PLAN, TF32_BWD_STAGES, TF32_PLAN, flash_attention,
    flash_attention_bwd_kernel, flash_attention_bwd_plain, flash_attention_plain, flash_bwd_split,
    flash_bwd_split_plain, flash_bwd_tf32_plain, flash_fwd_split, flash_lse_plain,
    flash_split_plain, flash_tf32_plain, tf32_bwd_smem_bytes)
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import tf32_smem_bytes, tf32_split_shape
from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_round, tf32_split

torch.set_num_threads(1)
TOL_FWD = 2e-5  # chip_smoke.py's TOL_FLASH["float32"], the JAX package's fp32 flash test's
TOL_BWD = 5e-5  # chip_smoke.py's TOL_FLASH_BWD["float32"], its flash-gradient tolerance


def ratio(got, want, tol: float) -> float:
    """chip_smoke.py's flash check as a ratio to ``tol`` (at most 1 holds):
    max |got - want| against tol max |want|, and the relative rms error."""
    got, want = (torch.from_numpy(np.array(x, dtype=np.float64)) for x in (got, want))
    err = (got - want).abs()
    rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    return max(float(err.max()) / (tol * float(want.abs().max())), rms / tol)


def inputs(seed: int, b: int, tq: int, tk: int, h: int, d: int):
    """q, dO [b, tq, h, d] and k, v [b, tk, h, d], fp32 from numpy."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, tq, h, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, d)).astype(np.float32))
            for _ in range(2))
    return q, k, v, do


# ---------------------------------------------------------------------------
# The pre-passes' layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,tk,h,d", [(2, 512, 4, 128), (1, 300, 2, 64), (1, 13, 3, 64)])
def test_forward_split_plain_is_one_shard_of_the_ring_split(b, tk, h, d):
    """The forward's pre-pass writes K6's layouts with one shard: K's terms
    [2, B*H, Tk8, D], V^T's [2, B*H, D, Tk8] (Tk8 = Tk rounded up to 8, the
    rest zero), V^T's keys in each aligned 8 in the tf32 A operand's order
    0, 2, 4, 6, 1, 3, 5, 7; hi and the rounded lo of each value."""
    _, k, v, _ = inputs(tk + d, b, 1, tk, h, d)
    kt, vt = flash_split_plain(k, v)
    k_shape, v_shape = tf32_split_shape(1, b, h, tk, d)
    assert tuple(kt.shape) == k_shape and tuple(vt.shape) == v_shape
    t8 = -(-tk // 8) * 8
    perm = (0, 2, 4, 6, 1, 3, 5, 7)
    bh = b * h - 1
    bb, hh = divmod(bh, h)
    for key in sorted({0, 5, tk - 1, t8 - 1}):
        hi, lo = tf32_split(k[bb, key, hh]) if key < tk else (torch.zeros(d), torch.zeros(d))
        assert torch.equal(kt[0, bh, key], hi)
        assert torch.equal(kt[1, bh, key], tf32_round(lo.contiguous()))
        src = key // 8 * 8 + perm[key % 8]
        vhi, vlo = tf32_split(v[bb, src, hh]) if src < tk else (torch.zeros(d), torch.zeros(d))
        assert torch.equal(vt[0, bh, :, key], vhi)
        assert torch.equal(vt[1, bh, :, key], tf32_round(vlo.contiguous()))


@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 512, 512, 4, 128), (1, 300, 300, 2, 64),
                                         (1, 70, 130, 3, 64)])
def test_backward_split_plain_layout(b, tq, tk, h, d):
    """The backward's pre-pass: q and dO as [2 (q, dO), 2 (hi, lo), B*H, Tq,
    D], k and v as [2 (k, v), 2, B*H, Tk, D], each row of each (batch, head)
    as it lies (no padding, no transposed copy), hi = tf32(x) and lo =
    tf32(x - hi)."""
    q, k, v, do = inputs(tq + tk, b, tq, tk, h, d)
    qs, kvs = flash_bwd_split_plain(q, do, k, v)
    assert tuple(qs.shape) == (2, 2, b * h, tq, d) and tuple(kvs.shape) == (2, 2, b * h, tk, d)
    for terms, tensors, t in ((qs, (q, do), tq), (kvs, (k, v), tk)):
        for which, x in enumerate(tensors):
            for bh in (0, b * h - 1):
                bb, hh = divmod(bh, h)
                for row in (0, t // 2, t - 1):
                    hi, lo = tf32_split(x[bb, row, hh].contiguous())
                    assert torch.equal(terms[which, 0, bh, row], hi)
                    assert torch.equal(terms[which, 1, bh, row], tf32_round(lo))
                    assert torch.equal(terms[which, 0, bh, row] + lo, x[bb, row, hh])


@pytest.mark.parametrize("tq,tk,d", [(300, 300, 64), (70, 130, 128)])
def test_forward_folded_from_the_split_terms(tq, tk, d):
    """The fold the forward kernel computes, written from the pre-pass's
    terms (S from Q's split in registers against K's terms, masked past Tk;
    P V over V^T's permuted terms), against the plain forward in fp32 at the
    flash tolerance, and its base-2 LSE against ``flash_lse_plain`` (at
    1e-4, chip_smoke.py's TOL_LSE): the one-shard layout loses nothing."""
    q, k, v, _ = inputs(tq * d, 1, tq, tk, 2, d)
    kt, vt = flash_split_plain(k, v)
    t8 = -(-tk // 8) * 8
    inv = torch.argsort(torch.tensor([0, 2, 4, 6, 1, 3, 5, 7]))
    vcols = (torch.arange(t8).view(-1, 8)[:, inv]).reshape(-1)[:tk]
    want, want_lse = flash_attention_plain(q, k, v), flash_lse_plain(q, k)
    for bh in range(2):
        q_hi, q_lo = tf32_split(q[0, :, bh].contiguous())
        k_hi, k_lo = kt[0, bh, :tk], kt[1, bh, :tk]
        s = (tf32_round(q_lo) @ k_hi.T + q_hi @ k_lo.T + q_hi @ k_hi.T) * (LOG2E / math.sqrt(d))
        lse = torch.logsumexp(s * math.log(2), dim=-1) * LOG2E
        p_hi, p_lo = tf32_split(torch.exp2(s - lse[:, None]).contiguous())
        v_hi, v_lo = vt[0, bh][:, vcols].T, vt[1, bh][:, vcols].T
        got = tf32_round(p_lo) @ v_hi + p_hi @ v_lo + p_hi @ v_hi
        assert ratio(got, want[0, :, bh].double(), TOL_FWD) <= 0.5
        assert float((lse - want_lse[0, bh]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The arithmetic: 3xTF32 holds the fp32 tolerances, 1xTF32 misses them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d", [(512, 128), (300, 64), (128, 128)])
def test_3xtf32_forward_meets_the_fp32_tolerance_and_1xtf32_misses(t, d):
    """The flagship's attention (T = 512, D = 128), a ragged T at D = 64
    and a short one: the tf32 forward's arithmetic holds 2e-5 against the
    fp64 forward, its LSE 1e-4; one TF32 product a term misses 2e-5."""
    q, k, v, _ = inputs(t + d, 1, t, t, 2, d)
    qd, kd, vd = q.double(), k.double(), v.double()
    want = flash_attention_plain(qd, kd, vd)
    o, lse = flash_tf32_plain(q, k, v)
    assert ratio(o, want, TOL_FWD) <= 0.5
    assert float((lse.double() - flash_lse_plain(qd, kd)).abs().max()) <= 1e-4
    assert ratio(flash_tf32_plain(q, k, v, terms=1)[0], want, TOL_FWD) > 1


@pytest.mark.parametrize("t,d", [(512, 128), (300, 64), (128, 128)])
def test_3xtf32_backward_meets_the_fp32_tolerance_and_1xtf32_misses(t, d):
    """The backward pair's products in the kernels' order (S and dP per
    32-channel chunk, dV and dK per 32 queries, dQ per 32 keys, P read back
    from its two terms for dS), on the tf32 forward's own output and LSE:
    each gradient within 5e-5 of the fp64 plain backward; with one TF32
    product a term each misses it."""
    q, k, v, do = inputs(t * d, 1, t, t, 2, d)
    qd, kd, vd, dod = q.double(), k.double(), v.double(), do.double()
    want = flash_attention_bwd_plain(qd, kd, vd, flash_attention_plain(qd, kd, vd),
                                     flash_lse_plain(qd, kd), dod)
    o, lse = flash_tf32_plain(q, k, v)
    got = flash_bwd_tf32_plain(q, k, v, o, lse, do)
    control = flash_bwd_tf32_plain(q, k, v, o, lse, do, terms=1)
    for name, g, c, w in zip(("dq", "dk", "dv"), got, control, want):
        assert g.shape == w.shape, name
        assert ratio(g, w, TOL_BWD) <= 0.5, name
        assert ratio(c, w, TOL_BWD) > 1, name


def test_backward_products_from_the_split_terms():
    """dQ as the dq kernel forms it from the pre-pass's K terms (dS's terms
    against K's hi and lo over each stage of 32 keys, dQ^T = K^T dS^T read
    at transposed positions), equal to the plain arithmetic's dQ to fp32
    summation order, and dV as the dkv kernel forms it from dO's terms."""
    q, k, v, do = inputs(11, 1, 96, 80, 2, 64)
    o, lse = flash_tf32_plain(q, k, v)
    want_dq, _, want_dv = flash_bwd_tf32_plain(q, k, v, o, lse, do)
    qs, kvs = flash_bwd_split_plain(q, do, k, v)
    scale = 1 / math.sqrt(64)
    for bh in range(2):
        qb, kb, vb, dob = (x[0, :, bh] for x in (q, k, v, do))
        s = sum(tf32_round(tf32_split(qb[:, c:c + 32].contiguous())[1]) @ kvs[0, 0, bh, :, c:c + 32].T
                + tf32_split(qb[:, c:c + 32].contiguous())[0] @ kvs[0, 1, bh, :, c:c + 32].T
                + tf32_split(qb[:, c:c + 32].contiguous())[0] @ kvs[0, 0, bh, :, c:c + 32].T
                for c in range(0, 64, 32))
        p = torch.exp2(s * (scale * LOG2E) - lse[0, bh][:, None])
        dp = sum(tf32_round(tf32_split(dob[:, c:c + 32].contiguous())[1]) @ kvs[1, 0, bh, :, c:c + 32].T
                 + tf32_split(dob[:, c:c + 32].contiguous())[0] @ kvs[1, 1, bh, :, c:c + 32].T
                 + tf32_split(dob[:, c:c + 32].contiguous())[0] @ kvs[1, 0, bh, :, c:c + 32].T
                 for c in range(0, 64, 32))
        p_hi, p_lo = tf32_split(p.contiguous())
        delta = (do[0, :, bh] * o[0, :, bh]).sum(-1)
        ds_hi, ds_lo = tf32_split(((p_hi + tf32_round(p_lo)) * (dp - delta[:, None])).contiguous())
        dq = sum(tf32_round(ds_lo[:, c:c + 32]) @ kvs[0, 0, bh, c:c + 32]
                 + ds_hi[:, c:c + 32] @ kvs[0, 1, bh, c:c + 32]
                 + ds_hi[:, c:c + 32] @ kvs[0, 0, bh, c:c + 32] for c in range(0, 80, 32)) * scale
        torch.testing.assert_close(dq, want_dq[0, :, bh], rtol=1e-5, atol=1e-6)
        pt_hi, pt_lo = tf32_split(p.T.contiguous())
        dv = sum(tf32_round(pt_lo[:, c:c + 32]) @ qs[1, 0, bh, c:c + 32]
                 + pt_hi[:, c:c + 32] @ qs[1, 1, bh, c:c + 32]
                 + pt_hi[:, c:c + 32] @ qs[1, 0, bh, c:c + 32] for c in range(0, 96, 32))
        torch.testing.assert_close(dv, want_dv[0, :, bh], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,d", [(1, 256, 2, 64), (1, 200, 2, 128)])
def test_tf32_arithmetic_against_the_jax_flash_attention(b, t, h, d):
    """The tf32 routes' arithmetic against the JAX package's Pallas flash
    attention in interpret mode (block 128, so T = 256 sweeps two key
    blocks and T = 200 a ragged second one) and its ``jax.grad``, fp32 on
    the same numpy inputs: the forward within 2e-5, the gradients of
    sum(o * g) within 5e-5, relative as chip_smoke.py checks."""
    rng = np.random.default_rng(t + d)
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, 128, 128, True) * g)

    want_o = np.asarray(jax_flash_attention(q, k, v, 128, 128, True))
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = flash_tf32_plain(qt, kt, vt)
    assert ratio(o, want_o, TOL_FWD) <= 0.5
    got = flash_bwd_tf32_plain(qt, kt, vt, o, lse, gt)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert ratio(x, np.asarray(w), TOL_BWD) <= 0.5, name


# ---------------------------------------------------------------------------
# Fit, and no CPU route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dkv", [True, False], ids=["dkv", "dq"])
def test_every_tf32_bwd_instance_fits(d, dkv):
    """Each instance of the pair fits in shared memory, the byte count
    written out: the two warpgroups' A lo terms (2 x 64 rows x 4 d), two
    ring stages of 32 rows of two tensors' two terms (2 x 4 x 32 x 4 d),
    the [64][32] fp32 tiles (dq: dS's two terms; dkv: P^T's and dS^T's),
    4 mbarriers of 8 bytes and 1024 bytes of alignment. A stage row is 32
    fp32, the 128-byte swizzle span; a block is 64 rows, wgmma's M. The
    dkv block at D = 128 takes 230,432 bytes, the dq block 214,048."""
    rows = TF32_BWD_PLAN.bn
    assert rows == 64 and TF32_BWD_BN * 4 == 128 and TF32_BWD_STAGES == 2
    written_out = (2 * rows * 4 * d + 2 * 4 * TF32_BWD_BN * 4 * d + (4 if dkv else 2) * 64 * 32 * 4
                   + 8 * 4 + 1024)
    assert tf32_bwd_smem_bytes(d, dkv) == written_out <= SMEM_LIMIT
    if d == 128:
        assert tf32_bwd_smem_bytes(d, dkv) == (230432 if dkv else 214048)


@pytest.mark.parametrize("d", [64, 128])
def test_tf32_forward_block_fits(d):
    """The forward's block is K6's tf32 fold (128 query rows, 32-key
    stages): Q's lo terms and two stages in 193 KB at D = 128."""
    assert (TF32_PLAN.bm, TF32_PLAN.bn) == (128, 32)
    assert tf32_smem_bytes(d) <= SMEM_LIMIT
    if d == 128:
        assert tf32_smem_bytes(d) == 197664


def test_tf32_wrappers_have_no_cpu_route():
    """Both pre-passes and the backward's tf32 plan raise on the CPU; the
    autograd Function there takes the plain versions, and launches nothing."""
    q = torch.zeros(1, 8, 1, 64)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_fwd_split(q, q)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_bwd_split(q, q, q, q)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        flash_attention_bwd_kernel(q, q, q, q, lse, q, plan=TF32_BWD_PLAN)
    launch_counts.clear()
    qs, k, v, do = inputs(3, 1, 40, 40, 2, 128)
    leaves = [x.clone().requires_grad_() for x in (qs, k, v)]
    out = flash_attention(*leaves)
    (out * do).sum().backward()
    assert not launch_counts
    want = flash_attention_plain(qs, k, v)
    assert torch.equal(out.detach(), want)
