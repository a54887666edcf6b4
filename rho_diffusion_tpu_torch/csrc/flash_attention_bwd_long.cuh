// The flash backward at small head dims (bf16, padded D = 16 or 32) past
// the small route's 64 keys and queries: ONE launch a call, a block per
// (batch, head) and 128 keys, all five products on wgmma (launched from
// flash_attention_bwd.cu).
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel` (K4)
// in rho_diffusion_tpu/ops/pallas/flash_attention.py:209/262 (pallas_call at
// :313/:341) at the ViT's attention past 64 patches: 16 heads of width 16
// over 512 patches at patch 4, where the JAX ViT's dispatcher sends T >= 512
// to those kernels (rho_diffusion_tpu/ops/attention.py:34, :82). It computes
// what flash_attention_bwd_small.cuh computes, at any Tq and Tk:
//   P  = exp2(S log2(e) / sqrt(D) - lse2),  S = Q K^T     (keys >= Tk masked)
//   dV = P^T dO
//   dS = P (dO V^T - delta),  delta = rowsum(dO O)
//   dK = dS^T Q / sqrt(D)
//   dQ = dS K / sqrt(D)
// with lse2 the forward's base-2 log-sum-exp (fp32 [B, H, Tq]). Numerics as
// the small kernel's: S, P, dP, dS and delta in fp32, P and dS rounded to
// bf16 before their products with fp32 accumulation, each gradient rounded
// once to bf16.
//
// What bounds it on the H100: at D = 16 neither the tensor cores nor the
// bytes. At the ViT's patch-4 shape (B 32, T 512, H 16, D 16) P needs T^2
// exponentials a (batch, head), 134 M in all; the special-function unit
// computes 16 ex2 a clock an SM, 4.2 T/s over 132 SMs at the H100 SXM's
// 1,980 MHz maximum SM clock, so 0.032 ms. The five products are 21.5
// GFLOP (0.022 ms at 989 TFLOP/s), and q, k, v, o, dO in and dq, dk, dv
// out 67 MB (0.020 ms at 3.35 TB/s). The
// mma.sync pair it replaces recomputes P in both kernels (twice the
// exponentials) and takes delta from a third launch. The design:
//   * A block owns chunks of 128 keys of one (batch, head): two warpgroups,
//     64 keys each, with K and V resident in 128-byte-swizzled tiles
//     (16-byte cp.async, rows past Tk zero-filled: rows of 32 or 64 bytes
//     keep TMA's 128-byte swizzle span out, as in the small kernel). Two
//     blocks an SM. A (batch, head) has `groups` blocks, neighbours in the
//     grid, so they run together and read its Q, dO and O through L2 once;
//     block j takes the chunks j, j + groups, ... in turn. The host picks
//     groups so that the grid holds a wave of blocks (flash_attention.py's
//     long_bwd_groups): one where B*H fills the card, more where it does
//     not. At the ViT's patch-4 shape one block of four chunks a (batch,
//     head) took 0.174 ms, two of two 0.192 and four of one 0.190 (H100):
//     each block's later chunks add to its slots in place of more blocks
//     each writing its own and one summing them all.
//   * Q, dO and O stream through a ring of 64-query tiles (3 stages at
//     D = 16, 2 at 32: what two blocks an SM leave room for; Q and dO
//     swizzled for wgmma, O as plain rows) with the tile's lse row, loaded
//     by every thread with cp.async, refilled once both warpgroups are done
//     with a stage.
//   * delta inside: each warpgroup computes the stage's 64 delta rows from
//     the O and dO tiles (two threads a row) while its score products run,
//     so the warpgroups need no block-wide barrier for it.
//   * The small kernel's five products per stage: S^T = K Q^T and dP^T =
//     V dO^T on m64n64k16 (K-major), P^T and dS^T rounded to bf16 pairs as
//     the register A of dV += P^T dO and dK += dS^T Q (B MN-major, N = D:
//     wgmma reads an MN-major B only as far as its first N channels), and
//     dQ's share over the warpgroup's own 64 keys, dS K from the dS^T tile
//     (MN-major A) against K (MN-major B); the three gradient products are
//     issued together and waited for once. No product sits under a branch
//     (ptxas fences every wgmma under one).
//   * dQ crosses key chunks, summed in a fixed order with no block waiting
//     on another: warpgroup 0 adds warpgroup 1's share to its own (in that
//     order) through shared memory, then adds the result to the block's
//     fp32 slot of that query tile in device memory (its chunks in turn:
//     the first chunk writes the slot, a later one reads it while the
//     tile's gradient products run, adds and writes it back; the slot is
//     the thread's own, so no fence; one thread fetches each slot tile into
//     L2 a tile ahead). With one block a (batch, head), its
//     last chunk writes dQ, scaled and rounded once. With more, at its end
//     a block counts itself in (one fence and one atomic add a block), and
//     the block that arrives last for its (batch, head), whichever it is,
//     sums the blocks' slots of every query tile in block order and writes
//     dQ. The gradients repeat bit for bit (at a given B*H: groups, and so
//     the order, follow it). The slots are B*H * groups * ceil(Tq/64) * 64
//     * D floats; with groups at most ceil(264 / (B*H)), that is under
//     (B*H + 264) * ceil(Tq/64) * 64 * D * 4 bytes, linear in T, and dQ's
//     own size in fp32 where B*H >= 264 (the ViT at patch 4: B*H 512, one
//     block, 16.8 MB). A first design added each share to one accumulator
//     in the key blocks' order, as the fused kernel does (a counter a query
//     tile, bulk adds): its waits, bulk completions and GPU-scope fences
//     sat on every tile's path and the kernel took 0.207 ms at the patch-4
//     shape (H100), 6.5x its bound. A second gave every 128 keys a slot set
//     of their own, with no wait, but its scratch grew as Tq * Tk.
// Left for later: a persistent schedule, and one warpgroup's exponentials
// overlapped with the other's products.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd_small.cuh"
#include "flash_attention_bwd_wgmma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace fbl {

constexpr int BM = 64;                   // query rows a ring stage
constexpr int WGS = 2;                   // warpgroups a block, 64 keys each
constexpr int BN = 64 * WGS;             // keys a block
constexpr int THREADS = 128 * WGS;
constexpr int TILE = 64 * 128;           // a 128-byte-swizzled [64][up to 64 bf16] tile

// the Q/dO/O ring's depth: as deep as two blocks an SM leave room for
__host__ __device__ constexpr int stages(int hd) { return hd == 16 ? 3 : 2; }
__host__ __device__ constexpr int o_bytes(int hd) { return BM * hd * 2; }
__host__ __device__ constexpr int dq_floats(int hd) { return BM * hd; }
// The swizzled tiles (K and V of BN keys, the Q and dO rings, the dS^T tile
// of BN keys), warpgroup 1's dQ share, the O ring, the lse rows and each
// warpgroup's delta rows, and room to align to the swizzle's 1024 bytes.
__host__ __device__ constexpr int smem_bytes(int hd) {
  return (3 * WGS + 2 * stages(hd)) * TILE + dq_floats(hd) * 4 + stages(hd) * o_bytes(hd) +
         stages(hd) * BM * 4 + stages(hd) * WGS * BM * 4 + 1024;
}

// One launch: q, k, v, o, dout in and dq, dk, dv out, [B, T, H, D] with D
// contiguous; st holds their (batch, token, head) element strides in that
// order.
struct LongProblem {
  const __nv_bfloat16* in[5];  // q, k, v, o, dout
  __nv_bfloat16* out[3];       // dq, dk, dv
  long long st[24];
  const float* lse;  // [B*H, Tq], base 2
  float* dq_part;    // [B*H, groups, q_tiles, BM * HD] fp32 in fragment order (kv_chunks > 1)
  int* arrived;      // [B*H] blocks done (zeroed; groups > 1)
  int H, Tq, Tk;
  int q_tiles;    // ceil(Tq / BM)
  int kv_chunks;  // ceil(Tk / BN)
  int groups;     // the blocks of one (batch, head), neighbours in the grid: 1 .. kv_chunks
  float scale;       // 1/sqrt(true head dim)
  float scale_log2;  // scale * log2(e)
};

// A block's row pointers: each tensor's rows of its (batch, head), lse's
// row, the block's dQ slots and dQ's rows. They live in shared memory and
// are read at each use: at D = 32 registers are the limit, and held across
// the chunk loop these took enough of them to spill.
struct Rows {
  const __nv_bfloat16* in[5];  // q, k, v, o, dout
  const float* lse;
  float* part;
  __nv_bfloat16* dq;
};

// The bytes at `src` (a multiple of 16) fetched into L2, issued by one
// thread and waited for by none.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's first float4 of a [64 x HD] fp32 tile in fragment order:
// fragment (warp, column group jj, lane) is a thread's 4 accumulator values
// as one float4, a warp's 32 side by side (the next jj 32 float4 on).
template <int HD>
__device__ __forceinline__ float4* frag_at(float* tile, int warp, int lane) {
  return reinterpret_cast<float4*>(tile) + warp * (HD / 8) * 32 + lane;
}

// Rows [0, ROWS) of one [T, D] slice (row stride `ld` elements) into a
// swizzled tile, rows past `limit` zero-filled; every thread of the block.
template <int HD, int ROWS>
__device__ __forceinline__ void load_swizzled(uint32_t tile, const __nv_bfloat16* src,
                                              long long ld, int limit) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int x = threadIdx.x; x < ROWS * CH; x += THREADS) {
    const int r = x / CH, c = x % CH;
    const bool in = r < limit;
    fbs::cp_async16(tile + wg::sw128_offset(r, c), in ? src + r * ld + c * 8 : src, in);
  }
}

// The same as plain [BM][HD] rows (the O tile, read only by the delta rows).
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t tile, const __nv_bfloat16* src, long long ld,
                                          int limit) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int x = threadIdx.x; x < BM * CH; x += THREADS) {
    const int r = x / CH, c = x % CH;
    const bool in = r < limit;
    fbs::cp_async16(tile + x * 16, in ? src + r * ld + c * 8 : src, in);
  }
}

// Query tile i into ring stage s: Q, dO, O and the lse row (zero past Tq:
// Q and dO rows are zero there, so P^T dO and dS^T Q add nothing, and dQ's
// rows past Tq are never written).
template <int HD>
__device__ __forceinline__ void load_stage(int i, int s, const Rows& rows, const long long* st,
                                           int Tq,
                                           uint32_t q_ring, uint32_t do_ring, uint32_t o_ring,
                                           float* lse_s) {
  const int q0 = i * BM, left = Tq - q0;
  load_swizzled<HD, BM>(q_ring + s * TILE, rows.in[0] + q0 * st[1], st[1], left);
  load_swizzled<HD, BM>(do_ring + s * TILE, rows.in[4] + q0 * st[13], st[13], left);
  load_rows<HD>(o_ring + s * o_bytes(HD), rows.in[3] + q0 * st[10], st[10], left);
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    fab::cp_async4(lse_s + s * BM + r, rows.lse + (r < left ? q0 + r : 0), r < left);
  }
}

// Block blockIdx.x: (batch, head) blockIdx.x / groups, and of its key
// chunks of BN keys j, j + groups, ... with j = blockIdx.x % groups, each
// against all its queries.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2) flash_bwd_long_kernel(const LongProblem p) {
  static_assert(HD == 16 || HD == 32, "the long route takes padded head dims 16 and 32");
  constexpr int STAGES = stages(HD);
  constexpr int CH = HD / 8;   // 16-byte chunks a row
  constexpr int DCH = HD / 16;  // ... a delta thread's half of a row
  constexpr int NJ = HD / 8;   // 8-column groups of a dQ fragment
  constexpr int DQ = dq_floats(HD);
  __shared__ int last_block;  // this block arrived last for its (batch, head)
  __shared__ Rows rows;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t k_base = wg::smem_u32(smem);
  const uint32_t v_base = k_base + WGS * TILE;
  const uint32_t q_ring = v_base + WGS * TILE;
  const uint32_t do_ring = q_ring + STAGES * TILE;
  const uint32_t ds_base = do_ring + STAGES * TILE;
  float* dq_buf = reinterpret_cast<float*>(smem + (3 * WGS + 2 * STAGES) * TILE);  // [DQ]
  const uint32_t o_ring = wg::smem_u32(dq_buf + DQ);
  float* lse_s = reinterpret_cast<float*>(smem + (3 * WGS + 2 * STAGES) * TILE + DQ * 4 +
                                          STAGES * o_bytes(HD));  // STAGES x [BM]
  float* dlt_s = lse_s + STAGES * BM;                             // STAGES x WGS x [BM]

  const int tid = threadIdx.x, group = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, q4 = lane & 3;
  const int bh = blockIdx.x / p.groups, j = blockIdx.x - bh * p.groups;
  const int b = bh / p.H, h = bh - b * p.H;
  const long long* st = p.st;
  if (tid == 0) {  // (the chunk loop's first barrier makes them visible)
#pragma unroll
    for (int x = 0; x < 5; ++x) rows.in[x] = p.in[x] + b * st[3 * x] + h * st[3 * x + 2];
    rows.lse = p.lse + (long long)bh * p.Tq;
    rows.part = p.dq_part + ((long long)bh * p.groups + j) * p.q_tiles * DQ;
    rows.dq = p.out[0] + b * st[15] + h * st[17];
  }
  const uint32_t k_mine = k_base + group * TILE, v_mine = v_base + group * TILE;
  const uint32_t ds_mine = ds_base + group * TILE;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's accumulator rows: r0, r0 + 8
  const int drow = t >> 1, dhalf = t & 1;  // delta: two threads a query row

  for (int c = j; c < p.kv_chunks; c += p.groups) {
    const int n0 = c * BN;
    const bool first = c == j;                 // this block's first chunk writes its slots
    const bool last = c + p.groups >= p.kv_chunks;
    const bool to_dq = p.groups == 1 && last;  // ... and with one block its last writes dQ
    __syncthreads();  // everyone is done with the last chunk's tiles

    // ---- K and V of the chunk's keys, then the first query tiles; K, V
    // and tile 0 are one cp.async group, each later tile one more ----
    load_swizzled<HD, BN>(k_base, rows.in[1] + n0 * st[4], st[4], p.Tk - n0);
    load_swizzled<HD, BN>(v_base, rows.in[2] + n0 * st[7], st[7], p.Tk - n0);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < p.q_tiles)
        load_stage<HD>(s, s, rows, st, p.Tq, q_ring, do_ring, o_ring, lse_s);
      cp_async_commit();
    }

    if (!first && tid == 0) prefetch_l2(rows.part, DQ * 4);  // tile 0's slot, read below
    const int keys_mine = p.Tk - n0 - 64 * group;  // this warpgroup's keys that exist
    const bool kin0 = r0 < keys_mine, kin1 = r0 + 8 < keys_mine;
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

    for (int i = 0; i < p.q_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t q_base = q_ring + s * TILE, do_base = do_ring + s * TILE;
      // the next tile's slot into L2 a tile ahead of its read: the slots
      // of a batch*head's later chunks outgrow L2 at D = 32
      if (!first && tid == 0 && i + 1 < p.q_tiles)
        prefetch_l2(rows.part + (long long)(i + 1) * DQ, DQ * 4);
      cp_async_wait<STAGES - 1>();  // this thread's copies of tile i
      wg::fence_proxy_async();      // ... made visible to wgmma's reads
      __syncthreads();              // ... and everyone's to everyone

      // ---- S^T = K Q^T and dP^T = V dO^T: rows this warpgroup's keys ----
      float s_acc[32], dp_acc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s_acc[x] = dp_acc[x] = 0.f;
      wg::fence_regs(s_acc);
      wg::fence_regs(dp_acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wg::Wgmma<64>::mma(s_acc, wg::sw128_desc(k_mine + kk * 32),
                           wg::sw128_desc(q_base + kk * 32), kk > 0 ? 1 : 0);
        wg::Wgmma<64>::mma(dp_acc, wg::sw128_desc(v_mine + kk * 32),
                           wg::sw128_desc(do_base + kk * 32), kk > 0 ? 1 : 0);
      }
      wg::wgmma_commit();

      // ---- meanwhile this warpgroup's copy of the tile's delta rows ----
      float* dl = dlt_s + (s * WGS + group) * BM;
      {
        const uint32_t o_row = o_ring + s * o_bytes(HD) + drow * (HD * 2);
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < DCH; ++cc)
          sum = fbs::dot8(fbs::ld_shared_v4(o_row + (dhalf * DCH + cc) * 16),
                          fbs::ld_shared_v4(do_base + wg::sw128_offset(drow, dhalf * DCH + cc)),
                          sum);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (dhalf == 0) dl[drow] = sum;
      }
      wg::named_barrier(1 + group, 128);
      wg::wgmma_wait<0>();
      wg::fence_regs(s_acc);
      wg::fence_regs(dp_acc);

      // ---- P^T and dS^T in fp32, then bf16 A operands (slice kk: queries
      // 16kk .. 16kk + 15), and dS^T rows to this warpgroup's swizzled tile ----
      const float* ls = lse_s + s * BM;
      uint32_t pf[4][4], dsf[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * q4);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * jj + 2 * q4);
        const float p0 = kin0 ? fab::ex2(s_acc[4 * jj] * p.scale_log2 - l2.x) : 0.f;
        const float p1 = kin0 ? fab::ex2(s_acc[4 * jj + 1] * p.scale_log2 - l2.y) : 0.f;
        const float p2 = kin1 ? fab::ex2(s_acc[4 * jj + 2] * p.scale_log2 - l2.x) : 0.f;
        const float p3 = kin1 ? fab::ex2(s_acc[4 * jj + 3] * p.scale_log2 - l2.y) : 0.f;
        pf[jj / 2][(jj & 1) * 2] = wg::pack_bf16(p0, p1);
        pf[jj / 2][(jj & 1) * 2 + 1] = wg::pack_bf16(p2, p3);
        dsf[jj / 2][(jj & 1) * 2] = wg::pack_bf16(p0 * (dp_acc[4 * jj] - d2.x),
                                                  p1 * (dp_acc[4 * jj + 1] - d2.y));
        dsf[jj / 2][(jj & 1) * 2 + 1] = wg::pack_bf16(p2 * (dp_acc[4 * jj + 2] - d2.x),
                                                      p3 * (dp_acc[4 * jj + 3] - d2.y));
        // row r0 (and r0 + 8), 16-byte chunk jj ^ (row & 7): (r0 + 8) & 7 == r0 & 7 == lane >> 2
        const uint32_t at = ((jj ^ (lane >> 2)) << 4) + 4 * q4;
        fab::st_shared_u32(ds_mine + r0 * 128 + at, dsf[jj / 2][(jj & 1) * 2]);
        fab::st_shared_u32(ds_mine + (r0 + 8) * 128 + at, dsf[jj / 2][(jj & 1) * 2 + 1]);
      }
      wg::fence_proxy_async();
      wg::named_barrier(1 + group, 128);  // this warpgroup's dS^T rows are stored

      // warpgroup 0, past the block's first chunk: the slot's sum so far,
      // read while the gradient products run (the score accumulators are
      // dead by now, so the registers are free)
      float4* slot = frag_at<HD>(rows.part + (long long)i * DQ, warp, lane);
      float4 prev[NJ];
      if (group == 0 && !first) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) prev[jj] = __ldcg(slot + jj * 32);
      }

      // ---- dV += P^T dO, dK += dS^T Q (A in registers, B MN-major) and dQ's
      // share over this warpgroup's keys, dS K (A = its dS^T rows and B = its
      // K rows, both MN-major), N = HD ----
      float dq_acc[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) dq_acc[x] = 0.f;
      wg::fence_regs(dv_acc);
      wg::fence_regs(dk_acc);
      wg::fence_regs(dq_acc);
      wg::fence_regs(pf);
      wg::fence_regs(dsf);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::WgmmaRS<HD>::mma(dv_acc, pf[kk], wg::sw128_mn_desc(do_base + kk * 2048, TILE));
        wg::WgmmaRS<HD>::mma(dk_acc, dsf[kk], wg::sw128_mn_desc(q_base + kk * 2048, TILE));
        wg::WgmmaT<HD>::mma(dq_acc, wg::sw128_mn_desc(ds_mine + kk * 2048, 0),
                            wg::sw128_mn_desc(k_mine + kk * 2048, TILE), kk > 0 ? 1 : 0);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(dv_acc);
      wg::fence_regs(dk_acc);
      wg::fence_regs(dq_acc);
      wg::fence_regs(pf);
      wg::fence_regs(dsf);

      // ---- warpgroup 1's dQ share to the buffer (warpgroup 0 read the
      // last one before the barrier at this tile's start) ----
      float4* frag = frag_at<HD>(dq_buf, warp, lane);
      if (group == 1) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          frag[jj * 32] = make_float4(dq_acc[4 * jj], dq_acc[4 * jj + 1], dq_acc[4 * jj + 2],
                                      dq_acc[4 * jj + 3]);
      }
      __syncthreads();  // the share is written; both warpgroups are done with stage s
      if (i + STAGES < p.q_tiles)
        load_stage<HD>(i + STAGES, s, rows, st, p.Tq, q_ring, do_ring, o_ring, lse_s);
      cp_async_commit();
      if (group != 0) continue;

      // ---- warpgroup 0: the chunk's share of dQ tile i, its own keys'
      // then warpgroup 1's, after the block's earlier chunks' sum, to its
      // slot (or dQ itself) ----
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 o = frag[jj * 32];
        dq_acc[4 * jj] += o.x;
        dq_acc[4 * jj + 1] += o.y;
        dq_acc[4 * jj + 2] += o.z;
        dq_acc[4 * jj + 3] += o.w;
      }
      if (!first) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          dq_acc[4 * jj] = prev[jj].x + dq_acc[4 * jj];
          dq_acc[4 * jj + 1] = prev[jj].y + dq_acc[4 * jj + 1];
          dq_acc[4 * jj + 2] = prev[jj].z + dq_acc[4 * jj + 2];
          dq_acc[4 * jj + 3] = prev[jj].w + dq_acc[4 * jj + 3];
        }
      }
      if (to_dq) {
        fbs::store_rows<HD>(rows.dq + (long long)i * BM * st[16], st[16], dq_acc, r0, q4,
                            p.Tq - i * BM, p.scale);
        continue;
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        __stcg(slot + jj * 32, make_float4(dq_acc[4 * jj], dq_acc[4 * jj + 1], dq_acc[4 * jj + 2],
                                           dq_acc[4 * jj + 3]));
    }

    // ---- dK / sqrt(D) and dV of this warpgroup's keys, rounded once ----
    const long long key_base = n0 + 64 * group;
    fbs::store_rows<HD>(p.out[1] + b * st[18] + h * st[20] + key_base * st[19], st[19], dk_acc,
                        r0, q4, keys_mine, p.scale);
    fbs::store_rows<HD>(p.out[2] + b * st[21] + h * st[23] + key_base * st[22], st[22], dv_acc,
                        r0, q4, keys_mine, 1.f);
  }
  if (p.groups == 1) return;

  // ---- the block that arrives last for this (batch, head) sums every
  // query tile's slots in block order and writes dQ ----
  __threadfence();  // this thread's slot stores, before the block counts itself in
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(p.arrived + bh, 1) == p.groups - 1;
    if (last_block) __threadfence();  // ... and the others' before this block reads them
  }
  __syncthreads();
  if (!last_block) return;
  const float* slots = p.dq_part + (long long)bh * p.groups * p.q_tiles * DQ;
  for (int i = group; i < p.q_tiles; i += WGS) {
    float dq_acc[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dq_acc[x] = 0.f;
#pragma unroll 4  // four blocks' loads in flight at a time
    for (int k = 0; k < p.groups; ++k) {
      const float4* slot =
          frag_at<HD>(const_cast<float*>(slots) + ((long long)k * p.q_tiles + i) * DQ, warp, lane);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 a = __ldcg(slot + jj * 32);
        dq_acc[4 * jj] += a.x;
        dq_acc[4 * jj + 1] += a.y;
        dq_acc[4 * jj + 2] += a.z;
        dq_acc[4 * jj + 3] += a.w;
      }
    }
    fbs::store_rows<HD>(rows.dq + (long long)i * BM * st[16], st[16], dq_acc, r0, q4,
                        p.Tq - i * BM, p.scale);
  }
}

}  // namespace fbl
