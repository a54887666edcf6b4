// K3/K4 in fp32 on Hopper's tensor cores: the flash backward as a pair of
// kernels, dK/dV over key blocks and dQ over query blocks (the TPU's own
// split), with every product split into three TF32 products (3xTF32) on
// wgmma (launched from flash_attention_bwd.cu).
//
// Replaces, for fp32 at head dims 64 and 128, the TPU kernels
// `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel` (K4) in
// rho_diffusion_tpu/ops/pallas/flash_attention.py:209/262 (pallas_call at
// :313/:341). Per (batch, head), as flash_attention_bwd.cu states:
//   P  = exp2(S log2(e)/sqrt(D) - lse2),  S = Q K^T   (keys >= Tk masked)
//   dV = P^T dO,  dS = P (dO V^T - delta),  dK = dS^T Q / sqrt(D),
//   dQ = dS K / sqrt(D)
// in fp32: each product a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (a_hi =
// tf32(a), a_lo = tf32(a - a_hi)), the small terms first, as K6's fold
// (ring_attention_tf32.cuh); the softmax and dS in fp32 registers.
//
// What bounds it on the H100: the pair does seven products of 2 T^2 D
// flops per (batch, head) (S and dP in both kernels), three TF32 products
// each, against 7 T D fp32 values of inputs and outputs (q, k, v, dO; dq,
// dk, dv), so tensor-core operations: at the flagship's training shape (B*H = 128, T = 512, D =
// 128) 180 GFLOP of TF32 products, 0.365 ms at 495 TFLOP/s (the five
// products a fused kernel would need: 0.26 ms).
//
// What the design does about it, within what 3xTF32 costs: every operand
// has two terms, and tf32 wgmma takes its operands K-major only (wgmma.cuh),
// so the bf16 fused kernel's layout (K, V resident, dS^T as an MN-major A)
// does not carry over: at D = 128, the two terms of K and V alone fill 128
// KB, and dK, dV, their partial sums and P fill a warpgroup's registers.
//   * A pre-pass (`flash_bwd_tf32_split_kernel`) writes the two tf32 terms
//     of Q, dO, K and V in [2][B*H][T][D] (hi, then lo). A kernel streams
//     the other side's two tensors from these by TMA, in 128-byte swizzled
//     boxes of 32 rows x 32 channels, through a 2-stage mbarrier ring of
//     BN = 32 rows (dq: K and V; dkv: Q and dO; 512 D bytes a stage).
//   * One block of ROWS = 64 rows (dkv: keys, dq: queries) and two
//     warpgroups that split the scores' two products: warpgroup 0 takes
//     S (dkv: S^T = K Q^T), warpgroup 1 dP (dkv: dP^T = V dO^T), each with
//     its 64 rows' hi terms in registers and lo terms in shared memory
//     (the fold's Q scheme, its `qk_product`). Warpgroup 0 writes P (dkv:
//     P^T) as both tf32 terms into a 128-byte swizzled [64][32] tile;
//     warpgroup 1 reads P back (hi + lo, 2^-22 of P), forms dS (dS^T) and
//     writes its terms into a tile the same way.
//   * No transposed copies: the gradient products take the transposed
//     operand as a register A operand, which each thread loads from the
//     ring stage's boxes at the transposed positions (`at_fragment`):
//     dQ^T = K^T dS^T (dq), dV^T = dO^T P and dK^T = Q^T dS (dkv), each
//     with the tile as the K-major B operand. Both warpgroups do them:
//     at D = 128 warpgroup g takes channels [64 g, 64 g + 64), at D = 64
//     rows [32 g, 32 g + 32) of the tile. A gradient accumulator is then
//     32 registers a thread (64 x 64), so dkv holds dK^T, dV^T, the A hi
//     terms (64), one partial sum and the A fragments in ~200.
//   * Partial sums: the tensor cores' fp32 accumulator does not round to
//     nearest, so (as in K6's fold) each product group sums at most 12
//     products there (S and dP per 32-channel chunk, a gradient per stage of
//     32 rows) and the group's sum joins the total in fp32 registers.
//   * 256 threads, no producer warps: thread 0 issues every load, into the
//     stage both warpgroups have just released (the fold's scheme). Named
//     barriers order the tiles: P ready (1), dS ready (2), and the tiles
//     free again (3: warpgroup 1's products of the last stage are done).
//   * Deterministic: every gradient element is summed by one thread in a
//     fixed order; no atomics. Rows past Tq have lse = +inf (P = 0); keys
//     past Tk and stage rows past the end (zero-filled by TMA) are masked
//     to P = 0.
// Shared memory at D = 128: the two A lo terms 64 KB, the ring 128 KB, the
// tiles 16 KB (dq) or 32 KB (dkv): one block an SM. Every mbarrier wait
// traps after ~5 s (tma.cuh).

#pragma once

#include <stdint.h>

#include "ring_attention_tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace fbt {

constexpr int ROWS = 64;           // a block's rows: one warpgroup's M
constexpr int BN = 32;             // rows a ring stage: one 128-byte row of fp32 (rt::BN)
constexpr int STAGES = 2;          // the ring's depth
constexpr int THREADS = 256;       // two warpgroups
constexpr int SPLIT_ROWS = 32;     // rows a pre-pass block
constexpr int BOX = BN * 128;      // a [BN rows][32 channels] box of a stage term
constexpr int TILE = ROWS * 128;   // a [64 rows][32 columns] tile of P or dS
constexpr int BAR_P = 1, BAR_DS = 2, BAR_FREE = 3;  // named barriers
static_assert(BN == rt::BN, "the scores' products are the fold's");

__host__ __device__ constexpr int a_lo_bytes(int hd) { return ROWS * hd * 4; }
__host__ __device__ constexpr int term_bytes(int hd) { return BN * hd * 4; }
__host__ __device__ constexpr int stage_bytes(int hd) { return 4 * term_bytes(hd); }
// the two warpgroups' A lo terms, the ring, the tiles (dq: dS's two terms;
// dkv: P^T's and dS^T's), the barriers, and room to align to 1024 bytes
__host__ __device__ constexpr int smem_bytes(int hd, bool dkv) {
  return 2 * a_lo_bytes(hd) + STAGES * stage_bytes(hd) + (dkv ? 4 : 2) * TILE + 16 * STAGES +
         1024;
}

// One launch of either kernel. dq: rows are queries (Tq), the ring streams
// keys (K, V), a0/a1 = q/dout, g0 = dq. dkv: rows are keys (Tk), the ring
// streams queries (Q, dO), a0/a1 = k/v, g0/g1 = dk/dv.
struct BwdTf32Problem {
  int H, Tq, Tk, BH;
  int rows, cols, tiles;           // the block's side, the streamed side, ceil(cols / BN)
  const float* a0;                 // the scores' A operands, raw [B, T, H, D]
  const float* a1;
  long long a0_sb, a0_st, a0_sh, a1_sb, a1_st, a1_sh;
  const float* lse;                // base 2, [B*H][Tq]
  const float* delta;              // rowsum(dO O), [B*H][Tq]
  float* g0;                       // the gradients, [B, T, H, D]
  float* g1;
  long long g0_sb, g0_st, g0_sh, g1_sb, g1_st, g1_sh;
  float scale;                     // 1/sqrt(true head dim)
  float scale_log2;                // scale * log2(e)
};

// The pre-pass's sources (q, dout, k, v in turn) and their split terms.
struct SplitSrc {
  const float* x[4];
  long long sb[4], st[4], sh[4];
  float* dst[4];                   // [2][B*H][T][D]: hi, then lo
};

// The pre-pass: SPLIT_ROWS rows of one (batch, head) of tensor blockIdx.z
// (q and dout have Tq rows, k and v Tk), 16 bytes a thread at a time.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_tf32_split_kernel(const __grid_constant__ SplitSrc src, int H, int Tq, int Tk, int BH) {
  const int z = blockIdx.z, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int T = z < 2 ? Tq : Tk;
  const int row0 = blockIdx.x * SPLIT_ROWS;
  if (row0 >= T) return;
  const float* x = src.x[z] + b * src.sb[z] + h * src.sh[z];
  uint32_t* hi = reinterpret_cast<uint32_t*>(src.dst[z]) + (long long)bh * T * HD;
  uint32_t* lo = hi + (long long)BH * T * HD;
  for (int i = threadIdx.x; i < SPLIT_ROWS * HD / 4; i += blockDim.x) {
    const int r = i / (HD / 4), c = (i - r * (HD / 4)) * 4, t = row0 + r;
    if (t >= T) break;
    const float4 v = *reinterpret_cast<const float4*>(x + t * src.st[z] + c);
    uint4 vh, vl;
    wg::split_tf32(v.x, vh.x, vl.x);
    wg::split_tf32(v.y, vh.y, vl.y);
    wg::split_tf32(v.z, vh.z, vl.z);
    wg::split_tf32(v.w, vh.w, vl.w);
    *reinterpret_cast<uint4*>(hi + (long long)t * HD + c) = vh;
    *reinterpret_cast<uint4*>(lo + (long long)t * HD + c) = vl;
  }
}

// Thread 0 loads stage j: BN rows from j * BN of both streamed tensors,
// hi and lo terms, HD/32 boxes each.
template <int HD>
__device__ __forceinline__ void load_stage(int j, int bh, int BH, const CUtensorMap& b0,
                                           const CUtensorMap& b1, uint8_t* ring, uint64_t* full) {
  constexpr int TERM = term_bytes(HD);
  const int s = j % STAGES;
  uint8_t* st = ring + s * stage_bytes(HD);
  wg::mbar_expect_tx(&full[s], stage_bytes(HD));
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    wg::tma_load_3d(st + c * BOX, &b0, &full[s], c * 32, j * BN, bh);
    wg::tma_load_3d(st + TERM + c * BOX, &b0, &full[s], c * 32, j * BN, BH + bh);
    wg::tma_load_3d(st + 2 * TERM + c * BOX, &b1, &full[s], c * 32, j * BN, bh);
    wg::tma_load_3d(st + 3 * TERM + c * BOX, &b1, &full[s], c * 32, j * BN, BH + bh);
  }
}

// This warpgroup's 64 rows of a (rows past `valid` zero), split: hi terms
// into registers in the tf32 A layout, lo terms into shared memory as
// HD/32 swizzled chunks of [64][32] (K6's fold loads Q so).
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&ah)[HD / 8][4], uint8_t* a_lo, const float* a,
                                       long long st, int row0, int valid, int r0, int qd) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8, col = 8 * kk + qd + (e >> 1) * 4, t = row0 + row;
      uint32_t lo;
      wg::split_tf32(t < valid ? a[t * st + col] : 0.f, ah[kk][e], lo);
      *reinterpret_cast<uint32_t*>(a_lo + (col / 32) * (64 * 128) +
                                   wg::sw128_offset(row, (col % 32) / 4) + (col % 4) * 4) = lo;
    }
}

// (row, col) of a [64][32] fp32 tile with the 128-byte swizzle, in bytes.
__device__ __forceinline__ uint32_t tile_at(int row, int col) {
  return wg::sw128_offset(row, col / 4) + (col % 4) * 4;
}

// The register A fragment of k8 step kk of X^T, X a stage term [BN rows][HD
// channels] in HD/32 boxes: the product's rows are channels d and d + 8 (in
// one box), its k the stage's rows 8 kk + qd and 8 kk + qd + 4.
__device__ __forceinline__ void at_fragment(uint32_t (&a)[4], const uint8_t* term, int d, int kk,
                                            int qd) {
  const uint8_t* box = term + (d / 32) * BOX;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ch = d % 32 + (e & 1) * 8, row = 8 * kk + qd + (e >> 1) * 4;
    a[e] = *reinterpret_cast<const uint32_t*>(box + tile_at(row, ch));
  }
}

// acc[64 x NW] += X^T B^T over the stage's BN rows, 3xTF32 (12 products,
// summed in `part`, then added in registers): A = X^T's channels from d
// (the stage term's hi and lo, x_hi and x_lo), B = NW rows of a tile's two
// terms (b_hi, b_lo: K-major, the stage's rows along the row).
template <int NW>
__device__ __forceinline__ void grad_product(float (&acc)[NW / 2], float (&part)[NW / 2],
                                             const uint8_t* x_hi, const uint8_t* x_lo, int d,
                                             int qd, uint32_t b_hi, uint32_t b_lo) {
  uint32_t ah[BN / 8][4], al[BN / 8][4];
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    at_fragment(ah[kk], x_hi, d, kk, qd);
    at_fragment(al[kk], x_lo, d, kk, qd);
  }
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) part[i] = 0.f;
  wg::fence_regs(ah);
  wg::fence_regs(al);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk)
    wg::WgmmaTf32RS<NW>::mma(part, al[kk], wg::sw128_desc(b_hi + kk * 32), kk > 0 ? 1 : 0);
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk)
    wg::WgmmaTf32RS<NW>::mma(part, ah[kk], wg::sw128_desc(b_lo + kk * 32));
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk)
    wg::WgmmaTf32RS<NW>::mma(part, ah[kk], wg::sw128_desc(b_hi + kk * 32));
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(part);
  wg::fence_regs(ah);
  wg::fence_regs(al);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] += part[i];
}

// Writes a gradient accumulator (rows: channels from 64 dhalf; columns: the
// block's rows from n0) to g [B, T, H, D], times `scale`.
template <int NW>
__device__ __forceinline__ void store_grad(const float (&acc)[NW / 2], float* g, long long st,
                                           int row0, int n0, int valid, int d, int qd,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row0 + n0 + 8 * j + 2 * qd + (e & 1);
      if (t < valid) g[t * st + d + 8 * (e >> 1)] = acc[4 * j + e] * scale;
    }
}

// One block of either kernel (the header says what each does).
template <int HD, bool DKV>
__device__ __forceinline__ void bwd_block(const CUtensorMap& b0_map, const CUtensorMap& b1_map,
                                          const BwdTf32Problem& p) {
  constexpr int TERM = term_bytes(HD);
  constexpr int STAGE = stage_bytes(HD);
  constexpr int NW = HD == 128 ? 64 : 32;  // the tile's rows a warpgroup's products take
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + 2 * a_lo_bytes(HD);
  uint8_t* tiles = ring + STAGES * STAGE;  // P (dkv) or dS (dq) hi, lo; dkv: then dS^T hi, lo
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + (DKV ? 4 : 2) * TILE);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int row0 = blockIdx.x * ROWS;
  const int group = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5, qd = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0 and r0 + 8 of the 64

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    wg::prefetch_map(&b0_map);
    wg::prefetch_map(&b1_map);
    for (int j = 0; j < STAGES && j < p.tiles; ++j)
      load_stage<HD>(j, bh, p.BH, b0_map, b1_map, ring, full);
  }
  // warpgroup 0 scores with a0 (dq: Q; dkv: K), warpgroup 1 with a1 (dO; V)
  uint8_t* my_a_lo = smem + group * a_lo_bytes(HD);
  uint32_t ah[HD / 8][4];
  if (group == 0)
    load_a<HD>(ah, my_a_lo, p.a0 + b * p.a0_sb + h * p.a0_sh, p.a0_st, row0, p.rows, r0, qd);
  else
    load_a<HD>(ah, my_a_lo, p.a1 + b * p.a1_sb + h * p.a1_sh, p.a1_st, row0, p.rows, r0, qd);
  wg::fence_proxy_async();
  __syncthreads();

  const uint32_t a_lo_base = wg::smem_u32(my_a_lo);
  const uint32_t ring_base = wg::smem_u32(ring);
  const uint32_t tile_base = wg::smem_u32(tiles);
  uint8_t* p_tile = tiles;                         // P's (dq: then dS's) two terms
  uint8_t* ds_tile = DKV ? tiles + 2 * TILE : tiles;
  const uint32_t ds_base = DKV ? tile_base + 2 * TILE : tile_base;
  const int n0 = HD == 128 ? 0 : 32 * group;      // the tile rows this warpgroup's products take
  const int d = (HD == 128 ? 64 * group : 0) + r0;  // its gradient channels d, d + 8
  const float* row_stat = group == 0 ? p.lse : p.delta;  // lse (warpgroup 0) or delta (1)
  const long long stat0 = (long long)bh * p.Tq;
  // dq: the rows' lse or delta (rows past Tq: lse +inf, so P = 0)
  float stat_r[2] = {0.f, 0.f};
  if (!DKV)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = row0 + r0 + 8 * e;
      stat_r[e] = t < p.Tq ? row_stat[stat0 + t] : (group == 0 ? __int_as_float(0x7f800000) : 0.f);
    }
  const bool row_ok[2] = {row0 + r0 < p.rows, row0 + r0 + 8 < p.rows};

  float g0[NW / 2], g1[DKV ? NW / 2 : 1];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) g0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? NW / 2 : 1); ++i) g1[i] = 0.f;
  float s_acc[BN / 2], s_part[BN / 2], g_part[NW / 2];

  for (int j = 0; j < p.tiles; ++j) {
    const int s = j % STAGES;
    const int col0 = j * BN;
    const uint32_t st = ring_base + s * STAGE;
    const uint8_t* stp = ring + s * STAGE;
    // dkv: the tile's columns' lse or delta (columns past Tq: lse +inf)
    float stat_c[BN / 4];
    if (DKV)
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        const int t = col0 + 8 * (i / 2) + 2 * qd + (i & 1);
        stat_c[i] = t < p.Tq ? row_stat[stat0 + t]
                             : (group == 0 ? __int_as_float(0x7f800000) : 0.f);
      }
    wg::mbar_wait(&full[s], (j / STAGES) & 1);
    // S (dkv: S^T) or dP (dP^T) over the head dim, 3xTF32
    wg::fence_regs(ah);
    rt::qk_product<HD>(s_acc, s_part, ah, a_lo_base, st + (group == 0 ? 0 : 2 * TERM),
                       st + (group == 0 ? TERM : 3 * TERM));
    wg::fence_regs(ah);
    if (group == 0) {
      // P = exp2(S scale log2(e) - lse), masked; its terms into the P tile
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int jj = i / 4, e = i % 4, c = 8 * jj + 2 * qd + (e & 1);
        const float lse = DKV ? stat_c[2 * jj + (e & 1)] : stat_r[e >> 1];
        const bool ok = DKV ? row_ok[e >> 1] && col0 + c < p.Tq : col0 + c < p.Tk;
        s_acc[i] = ok ? exp2f(s_acc[i] * p.scale_log2 - lse) : 0.f;
      }
      if (j > 0) wg::named_barrier(BAR_FREE, THREADS);  // the last stage's products are done
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int jj = i / 4, e = i % 4;
        const uint32_t at = tile_at(r0 + 8 * (e >> 1), 8 * jj + 2 * qd + (e & 1));
        uint32_t hi, lo;
        wg::split_tf32(s_acc[i], hi, lo);
        *reinterpret_cast<uint32_t*>(p_tile + at) = hi;
        *reinterpret_cast<uint32_t*>(p_tile + TILE + at) = lo;
      }
      if (DKV) wg::fence_proxy_async();  // P^T is a B operand too
      wg::named_barrier_arrive(BAR_P, THREADS);
    } else {
      // dS = P (dP - delta) from the P tile; its terms into the dS tile
      wg::named_barrier(BAR_P, THREADS);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int jj = i / 4, e = i % 4;
        const uint32_t at = tile_at(r0 + 8 * (e >> 1), 8 * jj + 2 * qd + (e & 1));
        const float pv = __uint_as_float(*reinterpret_cast<const uint32_t*>(p_tile + at)) +
                         __uint_as_float(*reinterpret_cast<const uint32_t*>(p_tile + TILE + at));
        const float delta = DKV ? stat_c[2 * jj + (e & 1)] : stat_r[e >> 1];
        uint32_t hi, lo;
        wg::split_tf32(pv * (s_acc[i] - delta), hi, lo);
        *reinterpret_cast<uint32_t*>(ds_tile + at) = hi;
        *reinterpret_cast<uint32_t*>(ds_tile + TILE + at) = lo;
      }
      wg::fence_proxy_async();
    }
    wg::named_barrier(BAR_DS, THREADS);
    // the gradients' products over the stage's BN rows
    if constexpr (DKV) {
      // dV^T += dO^T P (dO: stage terms 2, 3), dK^T += Q^T dS (Q: 0, 1)
      grad_product<NW>(g1, g_part, stp + 2 * TERM, stp + 3 * TERM, d, qd,
                       tile_base + n0 * 128, tile_base + TILE + n0 * 128);
      grad_product<NW>(g0, g_part, stp, stp + TERM, d, qd, ds_base + n0 * 128,
                       ds_base + TILE + n0 * 128);
    } else {
      // dQ^T += K^T dS^T (K: stage terms 0, 1)
      grad_product<NW>(g0, g_part, stp, stp + TERM, d, qd, ds_base + n0 * 128,
                       ds_base + TILE + n0 * 128);
    }
    if (threadIdx.x % 128 == 0) wg::mbar_arrive(&empty[s]);
    if (group == 1 && j + 1 < p.tiles) wg::named_barrier_arrive(BAR_FREE, THREADS);
    // the stage both warpgroups have released takes stage j + STAGES
    if (threadIdx.x == 0 && j + STAGES < p.tiles) {
      wg::mbar_wait(&empty[s], (j / STAGES) & 1);
      load_stage<HD>(j + STAGES, bh, p.BH, b0_map, b1_map, ring, full);
    }
  }

  // dq: dQ = dQ^T^T / sqrt(D); dkv: dK likewise, dV
  store_grad<NW>(g0, p.g0 + b * p.g0_sb + h * p.g0_sh, p.g0_st, row0, n0, p.rows, d, qd, p.scale);
  if constexpr (DKV)
    store_grad<NW>(g1, p.g1 + b * p.g1_sb + h * p.g1_sh, p.g1_st, row0, n0, p.rows, d, qd, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_tf32_dkv_kernel(__grid_constant__ const CUtensorMap q_map,
                          __grid_constant__ const CUtensorMap do_map, const BwdTf32Problem p) {
  bwd_block<HD, true>(q_map, do_map, p);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_tf32_dq_kernel(__grid_constant__ const CUtensorMap k_map,
                         __grid_constant__ const CUtensorMap v_map, const BwdTf32Problem p) {
  bwd_block<HD, false>(k_map, v_map, p);
}

}  // namespace fbt
