"""The fp32 routes on the tensor cores (3xTF32), on the CPU.

The conv's and K6's fp32 kernels (csrc/conv3d_tf32.cuh,
csrc/ring_attention_tf32.cuh) split each fp32 operand into two TF32 terms
and take three TF32 products for each fp32 one. They run only on the card;
here the numerical design is held with its plain version
(``ops/kernels/tf32.py``): the split itself, and 3xTF32 products against
fp64 at the JAX package's fp32 kernel tolerances (conv 1e-4, elementwise
against 1 + |want|; flash 2e-5, relative to the reference's max and rms),
which a single TF32 product misses. Beside them, K6's route by dtype and
head dim, its shared memory, and the layout its pre-pass writes
(``ring_split_plain``, which chip_smoke.py and the card's tests hold the
pre-pass kernel against bitwise).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels.conv3d import SMEM_LIMIT
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import FP32_PLAN, TF32_PLAN, flash_plan
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import (
    HEAD_DIMS, TF32_HEAD_DIMS, kernel_head_dim, ring_attention_fold_plain, ring_route,
    ring_split_plain, tf32_smem_bytes, tf32_split_shape)
from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_matmul, tf32_round, tf32_split

torch.set_num_threads(1)
TOL_CONV_FP32 = 1e-4  # chip_smoke.py's, the JAX package's fp32 conv test's
TOL_FLASH_FP32 = 2e-5  # chip_smoke.py's, the JAX package's fp32 flash test's
LOW_BITS = (1 << 13) - 1  # the fp32 mantissa bits TF32 drops


def values(seed: int, n: int = 4096) -> torch.Tensor:
    """fp32 values over many binades, both signs, with zeros and ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    x[:8] = [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -12, 2.0 ** -126]
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_is_exact_and_small(seed):
    """hi has its low 13 mantissa bits zero, hi + lo == a exactly, and
    |lo| <= 2^-11 |a| (half of TF32's last place)."""
    a = values(seed)
    hi, lo = tf32_split(a)
    assert int((hi.view(torch.int32) & LOW_BITS).abs().max()) == 0
    assert torch.equal(hi + lo, a)
    assert bool((lo.abs() <= 2.0 ** -11 * a.abs()).all())
    # lo's own TF32 term loses at most 2^-11 of lo: 2^-22 of a
    assert bool(((tf32_round(lo) - lo).abs() <= 2.0 ** -22 * a.abs()).all())


def test_tf32_round_is_to_nearest_ties_away():
    """cvt.rna.tf32.f32: to nearest, ties away from zero, as the kernels'
    split rounds."""
    ulp = 2.0 ** -10  # TF32's last place at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      1 + ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    assert torch.equal(tf32_round(torch.tensor([math.inf, -math.inf])),
                       torch.tensor([math.inf, -math.inf]))


def conv_tf32(x: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """The 3x3x3 SAME conv x [B, D, H, W, Cin] * w [Cout, Cin, 3, 3, 3] as
    the tf32 kernel sums it: per tap, the TF32 terms' products with exact
    fp32 products and fp32 sums."""
    b, d, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros((b * d * h * wd, w.shape[0]), dtype=torch.float32)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + wd].reshape(-1, cin)
                out += tf32_matmul(tap, w[:, :, dz, dy, dx].T.contiguous(), terms)
    return out.reshape(b, d, h, wd, -1)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (32, 48)])
def test_3xtf32_conv_meets_the_fp32_tolerance_and_1xtf32_misses(cin, cout):
    """At the flagship's level-0 and level-1 widths (K = 27 Cin products an
    output, weights N(0, 1/K) as chip_smoke's holds draw them), 3xTF32 sums
    stay within 1e-4 (1 + |want|) of the fp64 conv; one TF32 product a term
    does not."""
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.standard_normal((1, 6, 8, 8, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3))
                          / math.sqrt(27 * cin)).astype(np.float32))
    want = F.conv3d(x.double().movedim(-1, 1), w.double(), padding=1).movedim(1, -1)

    def ratio(got):
        return float(((got.double() - want).abs() / (TOL_CONV_FP32 * (1 + want.abs()))).max())

    assert ratio(conv_tf32(x, w, 3)) <= 0.05
    assert ratio(conv_tf32(x, w, 1)) > 1


def attention_tf32(q, k, v, terms: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v [T, D] with both products in TF32 terms,
    the softmax in fp32, as K6's tf32 fold computes it (one shard)."""
    s = tf32_matmul(q, k.T.contiguous(), terms) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return tf32_matmul(p, v, terms)


def flash_ratio(got, want) -> float:
    err = (got.double() - want).abs()
    rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    return max(float(err.max()) / (TOL_FLASH_FP32 * float(want.abs().max())), rms / TOL_FLASH_FP32)


@pytest.mark.parametrize("t,d", [(512, 128), (300, 64), (128, 128)])
def test_3xtf32_attention_meets_the_fp32_tolerance_and_1xtf32_misses(t, d):
    """The flagship's attention (T = 512, D = 128), a ragged T and the
    serve shape's shard length: 3xTF32 products hold the flash tolerance
    against fp64 attention; one TF32 product a term does not."""
    rng = np.random.default_rng(t + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)) for _ in range(3))
    qd, kd, vd = q.double(), k.double(), v.double()
    want = torch.softmax(qd @ kd.T / math.sqrt(d), dim=-1) @ vd
    assert flash_ratio(attention_tf32(q, k, v, 3), want) <= 0.5
    assert flash_ratio(attention_tf32(q, k, v, 1), want) > 1


@pytest.mark.parametrize("d", [16, 20, 32, 48, 64, 100, 128, 200, 256])
def test_ring_route_by_dtype_and_head_dim(d):
    """fp32 at kernel head dims 64 and 128 takes K6's tf32 fold (the
    flagship's and the 64^3 config's 128, and the ragged 100 padded to it);
    other fp32 head dims the FMA fold; bf16 the mma.sync fold."""
    dk = kernel_head_dim(d)
    assert dk in HEAD_DIMS and dk >= d
    assert ring_route(torch.float32, dk) == ("tf32" if dk in TF32_HEAD_DIMS else "f32")
    assert ring_route(torch.bfloat16, dk) == "bf16"
    with pytest.raises(TypeError):
        ring_route(torch.float16, dk)


@pytest.mark.parametrize("d", TF32_HEAD_DIMS)
def test_ring_tf32_block_fits_shared_memory(d):
    """Q's lo terms (128 rows) and two stages of 32 keys (K's and V^T's
    two terms each): 193 KB at D = 128, under the H100's 227 KB."""
    assert tf32_smem_bytes(d) == 128 * d * 4 + 2 * 4 * 32 * d * 4 + 32 + 1024
    assert tf32_smem_bytes(d) <= SMEM_LIMIT
    assert tf32_smem_bytes(d, stages=3) > SMEM_LIMIT or d < 128


@pytest.mark.parametrize("n,b,s,h,d", [(4, 8, 128, 4, 128), (3, 2, 13, 2, 64), (1, 1, 512, 4, 128)])
def test_ring_split_plain_layout(n, b, s, h, d):
    """The pre-pass's layout: K's terms [2, B*H, n*S8, D] and V^T's [2, B*H,
    D, n*S8], shard j at keys [j S8, j S8 + S) (zeros to S8), V^T's keys in
    each aligned 8 in the tf32 A operand's order 0, 2, 4, 6, 1, 3, 5, 7; hi
    and the rounded lo of each value."""
    rng = np.random.default_rng(n * s)
    ks = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)) for _ in range(n)]
    vs = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)) for _ in range(n)]
    kt, vt = ring_split_plain(ks, vs)
    k_shape, v_shape = tf32_split_shape(n, b, h, s, d)
    assert tuple(kt.shape) == k_shape and tuple(vt.shape) == v_shape
    s8 = -(-s // 8) * 8
    perm = (0, 2, 4, 6, 1, 3, 5, 7)
    for j, (k, v) in enumerate(zip(ks, vs)):
        for key in (0, s - 1, s8 - 1, min(9, s - 1)):
            src = key // 8 * 8 + perm[key % 8]
            bh = min(h + 1, b * h - 1)
            bb, hh = divmod(bh, h)
            hi, lo = tf32_split(k[bb, key, hh]) if key < s else (torch.zeros(d), torch.zeros(d))
            assert torch.equal(kt[0, bh, j * s8 + key], hi)
            assert torch.equal(kt[1, bh, j * s8 + key], tf32_round(lo.contiguous()))
            vhi, vlo = (tf32_split(v[bb, src, hh]) if src < s
                        else (torch.zeros(d), torch.zeros(d)))
            assert torch.equal(vt[0, bh, :, j * s8 + key], vhi)
            assert torch.equal(vt[1, bh, :, j * s8 + key], tf32_round(vlo.contiguous()))


def test_ring_fold_from_split_terms_matches_the_plain_fold():
    """The fold K6's tf32 kernel computes, written from the pre-pass's
    terms (S = the three TF32 products over the split K, masked per shard;
    P V over the split V^T with P's columns in the permuted k order), for
    rank r in the ring's order, against ``ring_attention_fold_plain`` in
    fp32, at the flash tolerance: the split's layouts lose nothing."""
    rng = np.random.default_rng(7)
    n, b, s, h, d, tq = 3, 1, 13, 2, 64, 20
    scale_log2 = 1.4426950408889634 / math.sqrt(d)
    ks = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)) for _ in range(n)]
    vs = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)) for _ in range(n)]
    q = torch.from_numpy(rng.standard_normal((b, tq, h, d)).astype(np.float32))
    kt, vt = ring_split_plain(ks, vs)
    s8 = -(-s // 8) * 8
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    inv = torch.argsort(perm)  # V^T position -> the key in its aligned 8
    for r in range(n):
        want = torch.empty_like(q)
        ring_attention_fold_plain([q], [want], [r], ks, vs, scale_log2)
        for bh in range(b * h):
            bb, hh = divmod(bh, h)
            q_hi, q_lo = tf32_split(q[bb, :, hh].contiguous())
            order = [(r - i) % n for i in range(n)]
            cols = torch.cat([torch.arange(j * s8, j * s8 + s) for j in order])
            k_hi, k_lo = kt[0, bh, cols], kt[1, bh, cols]
            sc = (tf32_round(q_lo) @ k_hi.T + q_hi @ k_lo.T + q_hi @ k_hi.T) * scale_log2
            p = torch.softmax(sc * math.log(2), dim=-1)
            # V^T's columns back in key order, then the same keys as the scores
            vcols = torch.cat([j * s8 + (torch.arange(s8).view(-1, 8)[:, inv]).reshape(-1)[:s]
                               for j in order])
            v_hi, v_lo = vt[0, bh][:, vcols].T, vt[1, bh][:, vcols].T
            p_hi, p_lo = tf32_split(p.contiguous())
            got = tf32_round(p_lo) @ v_hi + p_hi @ v_lo + p_hi @ v_hi
            ref = want[bb, :, hh].double()
            assert flash_ratio(got, ref) <= 0.5


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_forward_fp32_stays_on_its_fma_route(d):
    """The flash forward's fp32 route follows K6's: head dims 64 and 128
    (the flagship's) take the 3xTF32 fold with one shard, the other head
    dims stay on the CUDA-core kernel's plan."""
    want = TF32_PLAN if d in TF32_HEAD_DIMS else FP32_PLAN
    assert flash_plan(8, 4, 512, 512, d, torch.float32) == want
    assert (want.route == "tf32") == (ring_route(torch.float32, d) == "tf32")
