// The flash forward at small head dims (bf16, padded D = 16 or 32) on
// Hopper: ONE launch a call, one warpgroup a (batch, head) and 64 query
// rows, both products on wgmma (launched from flash_attention.cu).
//
// Replaces the TPU kernels `_fwd_kernel_onepass` (K1, K/V in one block) and
// `_fwd_kernel` (K2, online softmax over K/V blocks) in
// rho_diffusion_tpu/ops/pallas/flash_attention.py:115/59 (pallas_call at
// :158/:177) at the ViT's attention: 16 heads of width 16 over 64 patches
// (patch 8) or 512 (patch 4, where the JAX ViT's dispatcher sends T >= 512
// to those kernels, rho_diffusion_tpu/ops/attention.py:34, :82). It computes
// what the mma.sync kernel of flash_attention.cu computes, per (batch, head):
//   O = softmax(Q K^T / sqrt(D)) V
// with the scores and the softmax in fp32, keys at or past Tk masked, P
// rounded to bf16 before P V with fp32 accumulation, 1/max(l, 1e-30) at the
// end and O rounded once; and, when `lse` is not null, the base-2
// log-sum-exp lse2 = m + log2(max(l, 1e-30)) of the scaled scores, fp32
// [B*H, Tq], the layout and base flash_attention_bwd_small.cuh and
// flash_attention_bwd_long.cuh read (flash_attention.cu's header states
// the contract).
//
// What bounds it on the H100: at D = 16 the exponentials, not the tensor
// cores or the bytes. At the ViT's patch-4 shape (B 32, T 512, H 16) P needs
// T^2 exponentials a (batch, head), 134 M in all; the special-function unit
// computes 16 ex2 a clock an SM, so 0.032 ms over 132 SMs at the H100 SXM's
// 1,980 MHz maximum SM clock. The two products are 8.6 GFLOP (0.009 ms at
// 989 TFLOP/s) and q, k, v in and o out 33.6 MB (0.010 ms at 3.35 TB/s). At
// the bench width (T 64) the bytes bound it: 4.2 MB, 1.25 us. What held the
// mma.sync kernel it replaces at these shapes: one block of four warps a
// (batch, head) and 64 query rows, one shared-memory buffer whose every
// cp.async load was waited for in full (no load overlapped the math). The
// design:
//   * A warpgroup owns 64 query rows of one (batch, head) (an item); a block
//     holds WGS = 2 of them, items in order, so a block's warpgroups read
//     the same K/V tiles at about the same time. The warpgroups share
//     nothing and synchronise on their own named barriers: no block-wide
//     barrier sits on the softmax's path, and while one warpgroup's
//     exponentials run on the special-function unit another's products and
//     loads run.
//   * Loads by 16-byte cp.async into 128-byte-swizzled regions (row r,
//     chunk c at r * 128 + ((c ^ (r & 7)) << 4)), the layout the wgmma
//     descriptors read, as flash_attention_bwd_small.cuh and _long.cuh load
//     theirs: q, k and v are strided views of the ViT's fused qkv
//     projection and a row is 32 or 64 bytes, a fraction of TMA's 128-byte
//     swizzle span. Rows past Tq or Tk are zero-filled by the copy. A
//     [64][D] tile takes a slot of 2 D bytes in each row of a region (four
//     slots a region at D = 16, two at 32), so Q, three K and three V
//     stages take two regions (16 KB) a warpgroup at D = 16. Q once; K and V of 64 keys through the warpgroup's
//     own ring of STAGES (3) stages, each refilled as soon as the
//     warpgroup's P V product of it is done (a wgmma completes for the
//     whole warpgroup, so no barrier is needed there).
//   * The registers set how many warpgroups run an SM: held to 80 at D = 16
//     (three blocks of two, six warpgroups an SM; two blocks at D = 32).
//     At the patch-4 shape on the H100 the time follows that count more
//     than any one part of a tile's work (benchmarks/
//     flash_fwd_narrow_ablation.py builds and times the variants: without
//     its exponentials, without either product or the refills, at four or
//     eight warpgroups an SM; PERF.md gives the times). The first version
//     gave each tile a region of its own, so one block of four warpgroups
//     filled an SM, and ran slower; so did a loop that issued tile j + 1's
//     scores before tile j's P V, at 101 registers.
//   * S = Q K^T on wgmma m64n64k16, both operands K-major (one k-step at
//     D = 16, two at 32). The online softmax in registers (a row's values in
//     the 4 threads of a quad, two shuffles for its max and sum), ex2 on the
//     special-function unit, the scale folded into one FMA with the max.
//     Columns at or past Tk are set to -inf before the max: a uniform branch
//     around the masking in the last tile, never around a product (ptxas
//     fences every wgmma under a branch).
//   * O += P V on wgmma m64nDk16 (WgmmaRS at N = 16 and 32): P, the score
//     accumulator rounded to bf16 pairs, is the register A operand as it
//     lies (it never passes through shared memory); V is the MN-major B, read
//     only as far as its first D channels.
//   * Epilogue: O / l rounded once to bf16 pairs from registers; rows at or
//     past Tq are not written.
// Left for later: fewer registers a warpgroup (more warpgroups an SM), K/V
// tiles shared by a block's warpgroups, 16-byte stores of O through shared
// memory, and a persistent schedule.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace fan {

constexpr int BM = 64;       // query rows a warpgroup (an item)
constexpr int BN = 64;       // keys a K/V tile
constexpr int WGS = 2;       // warpgroups (items) a block
// blocks an SM the registers are held to, at D = 16 and 32
constexpr int MIN_BLOCKS_16 = 3;
constexpr int MIN_BLOCKS_32 = 2;
constexpr int STAGES = 3;    // the K/V ring's depth, per warpgroup
constexpr int TILE = 64 * 128;  // one 128-byte-swizzled [64][64 bf16] region
constexpr float NEG_BIG = -1e30f;

// A [64][HD] tile is a slot of HD * 2 bytes in every row of a region: 4
// slots a region at HD = 16, 2 at 32. Slot i of a region holds its 16-byte
// chunks (i * HD / 8 ...) of each row, at their swizzled places, and a
// wgmma descriptor reaches it by the slot's byte offset along the row, as a
// k-step reaches the next 16 channels (so the swizzle, a function of the
// address bits, lines up for both operand majors).
__host__ __device__ constexpr int slots(int hd) { return 128 / (2 * hd); }
// Q and the K stages (K-major slots), then the V stages (MN-major slots)
__host__ __device__ constexpr int k_regions(int hd) { return (1 + STAGES + slots(hd) - 1) / slots(hd); }
__host__ __device__ constexpr int v_regions(int hd) { return (STAGES + slots(hd) - 1) / slots(hd); }
// one warpgroup's share of shared memory, and a block's (with room to
// align to the swizzle's 1024 bytes)
__host__ __device__ constexpr int region_bytes(int hd) {
  return (k_regions(hd) + v_regions(hd)) * TILE;
}
__host__ __device__ constexpr int smem_bytes(int hd) { return WGS * region_bytes(hd) + 1024; }

// One launch: q, k, v in and o out, [B, T, H, D] with D contiguous; st
// holds their (batch, token, head) element strides in that order.
struct NarrowProblem {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // null, or [B*H, Tq] fp32, base 2
  long long st[12];
  long long items;  // B*H * q_tiles
  int H, Tq, Tk;
  int q_tiles;   // ceil(Tq / BM)
  int kv_tiles;  // ceil(Tk / BN)
  float scale_log2;  // log2(e) / sqrt(true head dim)
};

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes to shared memory, zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The region and first chunk of slot i of a warpgroup's K-major slots
// (0: Q, 1 + s: K stage s) or of its MN-major ones (s: V stage s).
template <int HD>
__device__ __forceinline__ uint32_t slot_region(uint32_t base, int i) {
  return base + (i / slots(HD)) * TILE;
}
template <int HD>
__device__ __forceinline__ int slot_chunk(int i) {
  return (i % slots(HD)) * (HD / 8);
}
// The byte address a descriptor of slot i starts at: its region plus the
// slot's offset along the row.
template <int HD>
__device__ __forceinline__ uint32_t slot_addr(uint32_t base, int i) {
  return slot_region<HD>(base, i) + slot_chunk<HD>(i) * 16;
}

// Rows [0, 64) of one [T, D] slice (row stride `ld` elements) into slot i
// of the regions at `base`, rows past `limit` zero-filled; the warpgroup's
// 128 threads (t its thread), HD / 8 chunks a row.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t base, int i, const __nv_bfloat16* src,
                                          long long ld, int limit, int t) {
  constexpr int CH = HD / 8;
  const uint32_t region = slot_region<HD>(base, i);
  const int c0 = slot_chunk<HD>(i);
#pragma unroll
  for (int x = t; x < 64 * CH; x += 128) {
    const int r = x / CH, c = x % CH;
    const bool in = r < limit;
    cp_async16(region + wg::sw128_offset(r, c0 + c), in ? src + r * ld + c * 8 : src, in);
  }
}

// Key tile j's K and V rows into ring stage s.
template <int HD>
__device__ __forceinline__ void load_kv(int j, int s, uint32_t k_base, uint32_t v_base,
                                        const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                        const long long* st, int Tk, int t) {
  const int n0 = j * BN;
  load_tile<HD>(k_base, 1 + s, kb + n0 * st[4], st[4], Tk - n0, t);
  load_tile<HD>(v_base, s, vb + n0 * st[7], st[7], Tk - n0, t);
}

// Warpgroup `threadIdx.x / 128` of block blockIdx.x: item blockIdx.x * WGS
// + group, query rows [64 qt, 64 qt + 64) of (batch, head) bh, with item =
// bh * q_tiles + qt, against all its keys.
template <int HD>
__global__ void __launch_bounds__(WGS * 128, HD == 16 ? MIN_BLOCKS_16 : MIN_BLOCKS_32)
flash_fwd_narrow_kernel(const NarrowProblem p) {
  static_assert(HD == 16 || HD == 32, "the narrow route takes padded head dims 16 and 32");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const int group = threadIdx.x / 128, t = threadIdx.x & 127;
  const long long item = (long long)blockIdx.x * WGS + group;
  if (item >= p.items) return;  // the whole warpgroup: it shares no barrier with the others
  const int bar = 1 + group;    // this warpgroup's named barrier
  const long long bh = item / p.q_tiles;
  const int qt = (int)(item - bh * p.q_tiles);
  const int b = (int)(bh / p.H), h = (int)(bh - (long long)b * p.H);
  const long long* st = p.st;
  const int q0 = qt * BM;

  const uint32_t k_base = wg::smem_u32(smem + group * region_bytes(HD));  // Q and K slots
  const uint32_t v_base = k_base + k_regions(HD) * TILE;                  // V slots
  const __nv_bfloat16* kb = p.k + b * st[3] + h * st[5];
  const __nv_bfloat16* vb = p.v + b * st[6] + h * st[8];

  // ---- Q and the first STAGES key tiles: Q with tile 0 one cp.async
  // group, each later tile one more ----
  load_tile<HD>(k_base, 0, p.q + b * st[0] + h * st[2] + q0 * st[1], st[1], p.Tq - q0, t);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < p.kv_tiles) load_kv<HD>(s, s, k_base, v_base, kb, vb, st, p.Tk, t);
    cp_async_commit();
  }

  const int lane = t & 31, q4 = lane & 3;
  const uint32_t q_at = slot_addr<HD>(k_base, 0);
  float o_acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o_acc[x] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG};  // rows r0 and r0 + 8: their running max (scaled, base 2)
  float l_r[2] = {0.f, 0.f};          // ... and this thread's share of their sums

  for (int j = 0; j < p.kv_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t k_at = slot_addr<HD>(k_base, 1 + s), v_at = slot_addr<HD>(v_base, s);
    cp_async_wait<STAGES - 1>();  // this thread's copies of tile j (and Q)
    wg::fence_proxy_async();      // ... made visible to wgmma's reads
    wg::named_barrier(bar, 128);  // ... and everyone's in the warpgroup

    // ---- S = Q K^T: rows this warpgroup's queries, columns the tile's keys ----
    float s_acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s_acc[x] = 0.f;
    wg::fence_regs(s_acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wg::Wgmma<64>::mma(s_acc, wg::sw128_desc(q_at + kk * 32), wg::sw128_desc(k_at + kk * 32),
                         kk > 0 ? 1 : 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s_acc);

    // ---- the online softmax: columns past Tk to -inf, the rows' max, P =
    // 2^(s log2(e)/sqrt(D) - m) in fp32, the rows' sums ----
    const int keys = p.Tk - j * BN;  // the tile's keys that exist (>= 1)
    if (keys < BN) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * jj + 2 * q4 + (e & 1) >= keys) s_acc[4 * jj + e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s_acc[4 * jj], s_acc[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(s_acc[4 * jj + 2], s_acc[4 * jj + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m_r[0], mx0 * p.scale_log2);
    mx1 = fmaxf(m_r[1], mx1 * p.scale_log2);
    const float alpha0 = ex2(m_r[0] - mx0), alpha1 = ex2(m_r[1] - mx1);
    m_r[0] = mx0;
    m_r[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pf[4][4];  // P as the A operand of the k16 slices: slice kk, keys 16kk ..
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p0 = ex2(fmaf(s_acc[4 * jj], p.scale_log2, -mx0));
      const float p1 = ex2(fmaf(s_acc[4 * jj + 1], p.scale_log2, -mx0));
      const float p2 = ex2(fmaf(s_acc[4 * jj + 2], p.scale_log2, -mx1));
      const float p3 = ex2(fmaf(s_acc[4 * jj + 3], p.scale_log2, -mx1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[jj / 2][(jj & 1) * 2] = wg::pack_bf16(p0, p1);
      pf[jj / 2][(jj & 1) * 2 + 1] = wg::pack_bf16(p2, p3);
    }
    l_r[0] = l_r[0] * alpha0 + rs0;
    l_r[1] = l_r[1] * alpha1 + rs1;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      o_acc[4 * jj] *= alpha0;
      o_acc[4 * jj + 1] *= alpha0;
      o_acc[4 * jj + 2] *= alpha1;
      o_acc[4 * jj + 3] *= alpha1;
    }

    // ---- O += P V: A = P in registers, B = the V tile, MN-major, N = HD ----
    wg::fence_regs(o_acc);
    wg::fence_regs(pf);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::WgmmaRS<HD>::mma(o_acc, pf[kk], wg::sw128_mn_desc(v_at + kk * 2048, TILE));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(o_acc);
    wg::fence_regs(pf);

    // ---- stage s is free: key tile j + STAGES into it ----
    if (j + STAGES < p.kv_tiles) load_kv<HD>(j + STAGES, s, k_base, v_base, kb, vb, st, p.Tk, t);
    cp_async_commit();
  }

  // ---- epilogue: O / l, rounded once to bf16; the base-2 LSE ----
  float l0 = l_r[0], l1 = l_r[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int warp = t >> 5;
  const int t0 = q0 + 16 * warp + (lane >> 2);  // this thread's rows: t0 and t0 + 8
  if (p.lse != nullptr && q4 == 0) {  // the quad's 4 lanes hold the same rows
    float* lrow = p.lse + bh * p.Tq;
    if (t0 < p.Tq) lrow[t0] = m_r[0] + log2f(fmaxf(l0, 1e-30f));
    if (t0 + 8 < p.Tq) lrow[t0 + 8] = m_r[1] + log2f(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16* ob = p.o + b * st[9] + h * st[11];
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const int col = 8 * jj + 2 * q4;
    if (t0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + t0 * st[10] + col) =
          __floats2bfloat162_rn(o_acc[4 * jj] * inv0, o_acc[4 * jj + 1] * inv0);
    if (t0 + 8 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + 8) * st[10] + col) =
          __floats2bfloat162_rn(o_acc[4 * jj + 2] * inv1, o_acc[4 * jj + 3] * inv1);
  }
}

}  // namespace fan
