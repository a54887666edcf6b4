// The flash backward at small head dims (bf16, padded D = 16 or 32) where
// every key and query of a (batch, head) fits one tile (Tq, Tk <= 64): ONE
// launch, one warpgroup a (batch, head), all five products on wgmma
// (launched from flash_attention_bwd.cu).
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel` (K4)
// in rho_diffusion_tpu/ops/pallas/flash_attention.py:209/262 (pallas_call at
// :313/:341) at the ViT's attention: 16 heads of width 16 over 64 patches
// (the JAX ViT reaches no Pallas kernel at T < 512,
// rho_diffusion_tpu/ops/attention.py:34/:82, so what it computes is theirs
// and SDPA's backward is the yardstick). Per (batch, head):
//   P  = exp2(S log2(e) / sqrt(D) - lse2),  S = Q K^T     (keys >= Tk masked)
//   dV = P^T dO
//   dS = P (dO V^T - delta),  delta = rowsum(dO O)
//   dK = dS^T Q / sqrt(D)
//   dQ = dS K / sqrt(D)
// with lse2 the forward's base-2 log-sum-exp (fp32 [B, H, Tq]). Numerics as
// the pair's (flash_attention_bwd.cu): S, P, dP, dS and delta in fp32, P
// and dS rounded to bf16 before their products with fp32 accumulation
// (FlashAttention-2's choice), each gradient rounded once to bf16.
//
// What bounds it on the H100: bytes. At the ViT's shape (B 32, T 64, H 16,
// D 16) q, k, v, o and dO in (5.24 MB), lse (0.13 MB) and dq, dk, dv out
// (3.15 MB) are 8.5 MB, 2.5 us at 3.35 TB/s; the five products are 0.34
// GFLOP, 0.34 us at the bf16 peak. What held the mma.sync pair it replaces
// here: seven launches (delta as five PyTorch kernels, then dkv and dq, each
// recomputing S and dP: 7 products) whose every load is waited for, and at
// B*H = 512 each launch is a chain of latencies, not of work. The design:
//   * One warpgroup owns one (batch, head); a block holds WGS = 2 of them,
//     so 512 (batch, head)s are 256 blocks of 85 KB shared memory, two
//     blocks an SM: one wave over the 132 SMs. The warpgroups share nothing
//     and synchronise on their own named barriers.
//   * Inputs by 16-byte cp.async, not TMA: q, k and v are strided views of
//     the ViT's fused qkv and a row is 32 or 64 bytes, so a box would be a
//     fraction of TMA's 128-byte swizzle span, and four tensor maps encoded
//     on the host every call would add to a step that is already host-bound.
//     Each row lands at its place in a 128-byte-swizzled tile (row r, 16-byte
//     chunk c at r * 128 + ((c ^ (r & 7)) << 4)), the layout the wgmma
//     descriptors of the other kernels read: channels past D are never read.
//     Rows past Tq or Tk are zero-filled by the copy itself.
//   * delta in the kernel: while Q, K, V and dO are in flight each thread
//     loads half an O row from device memory, then multiplies it with the
//     dO row in shared memory (two threads a query row, fp32). The pair's
//     five-kernel expression goes away with its launches.
//   * The transposed scores, as the fused kernel's (flash_attention_bwd_
//     wgmma.cuh): S^T = K Q^T and dP^T = V dO^T on m64n64k16 (both operands
//     K-major; one k-step at D = 16, two at 32), rows keys. P^T and dS^T
//     rounded to bf16 pairs are the register A operand of dV = P^T dO and
//     dK = dS^T Q, whose B (dO, Q) is the same tile read MN-major with
//     N = D. dS^T also goes to a swizzled [keys][queries] tile, read
//     MN-major as the A of dQ = dS K against K MN-major (N = D). All three
//     gradient products are issued together and waited for once.
//   * No sum crosses a warpgroup: dQ is whole in one, so the gradients are
//     bitwise the same from run to run, with no accumulator in device
//     memory and no counters.
// Left for later: staging the gradients through shared memory for 16-byte
// stores (each thread writes 4-byte pairs), and larger T (a key loop).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd_wgmma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace fbs {

constexpr int T_MAX = 64;  // keys and queries a (batch, head): one M / N tile
constexpr int WGS = 2;     // warpgroups (batch*heads) a block
constexpr int TILE = T_MAX * 128;  // one 128-byte-swizzled [64][up to 64 bf16] tile
// K, V, Q, dO, dS^T, then the lse and delta rows, rounded up to the swizzle's
// 1024 bytes: one warpgroup's share of shared memory
constexpr int REGION = (5 * TILE + 2 * T_MAX * 4 + 1023) / 1024 * 1024;
constexpr int SMEM = WGS * REGION + 1024;  // and room to align to 1024

// One launch: q, k, v, o, dout in and dq, dk, dv out, [B, T, H, D] with D
// contiguous; st holds their (batch, token, head) element strides in that
// order.
struct SmallProblem {
  const __nv_bfloat16* in[5];  // q, k, v, o, dout
  __nv_bfloat16* out[3];       // dq, dk, dv
  long long st[24];
  const float* lse;  // [B*H, Tq], base 2
  int BH, H, Tq, Tk;
  float scale;       // 1/sqrt(true head dim)
  float scale_log2;  // scale * log2(e)
};

// 16 bytes to shared memory, zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// sum over 8 bf16 pairs' products of a and b, in fp32, added to acc in order
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// Rows [0, 64) of one [T, D] slice (row stride `ld` elements) into a
// swizzled tile; rows past `limit` zero-filled. 128 threads, HD / 8 chunks a row.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, long long ld,
                                          int limit, int tid) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = tid; i < T_MAX * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    const bool in = r < limit;
    cp_async16(tile + wg::sw128_offset(r, c), in ? src + r * ld + c * 8 : src, in);
  }
}

// Two fp32 accumulator values rounded to a bf16 pair, written at `at`.
__device__ __forceinline__ void store_pair(__nv_bfloat16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}

// Rows r0 and r0 + 8 of a [64 x HD] accumulator (columns 8j + 2q, + 1) to
// [T, D] rows `base + row * ld`, times `mul`, rows past `limit` dropped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld, const float (&acc)[HD / 2],
                                           int r0, int q4, int limit, float mul) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * q4;
    if (r0 < limit) store_pair(base + r0 * ld + col, acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < limit)
      store_pair(base + (r0 + 8) * ld + col, acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// Warpgroup `threadIdx.x / 128` of block blockIdx.x: (batch, head)
// blockIdx.x * WGS + group, all its keys against all its queries.
template <int HD>
__global__ void __launch_bounds__(WGS * 128, 2) flash_bwd_small_kernel(const SmallProblem p) {
  static_assert(HD == 16 || HD == 32, "the small route takes padded head dims 16 and 32");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const int group = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int bh = blockIdx.x * WGS + group;
  if (bh >= p.BH) return;  // the whole warpgroup: it shares no barrier with the other
  const int bar = 1 + group;  // this warpgroup's named barrier
  const int b = bh / p.H, h = bh - b * p.H;
  const long long* st = p.st;

  uint8_t* region = smem + group * REGION;
  const uint32_t k_base = wg::smem_u32(region);
  const uint32_t v_base = k_base + TILE, q_base = k_base + 2 * TILE, do_base = k_base + 3 * TILE;
  const uint32_t ds_base = k_base + 4 * TILE;
  float* lse_s = reinterpret_cast<float*>(region + 5 * TILE);
  float* dlt_s = lse_s + T_MAX;

  // ---- Q, K, V, dO into shared memory; half an O row into registers ----
  const __nv_bfloat16* row0[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) row0[x] = p.in[x] + b * st[3 * x] + h * st[3 * x + 2];
  load_tile<HD>(q_base, row0[0], st[1], p.Tq, tid);
  load_tile<HD>(k_base, row0[1], st[4], p.Tk, tid);
  load_tile<HD>(v_base, row0[2], st[7], p.Tk, tid);
  load_tile<HD>(do_base, row0[4], st[13], p.Tq, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // delta: two threads a query row, each HD / 2 channels (HD / 16 chunks)
  constexpr int DCH = HD / 16;
  const int drow = tid >> 1, dhalf = tid & 1;
  const bool din = drow < p.Tq;
  uint4 o_part[DCH];
#pragma unroll
  for (int c = 0; c < DCH; ++c)
    o_part[c] = din ? *reinterpret_cast<const uint4*>(row0[3] + drow * st[10] + (dhalf * DCH + c) * 8)
                    : make_uint4(0, 0, 0, 0);
  if (dhalf == 1) lse_s[drow] = din ? p.lse[(long long)bh * p.Tq + drow] : INFINITY;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  wg::fence_proxy_async();  // the copies' writes, for wgmma's reads
  wg::named_barrier(bar, 128);
  {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
      sum = dot8(o_part[c], ld_shared_v4(do_base + wg::sw128_offset(drow, dhalf * DCH + c)), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (dhalf == 0) dlt_s[drow] = din ? sum : 0.f;
  }

  // ---- S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries ----
  float s_acc[32], dp_acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) s_acc[x] = dp_acc[x] = 0.f;
  wg::fence_regs(s_acc);
  wg::fence_regs(dp_acc);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wg::Wgmma<64>::mma(s_acc, wg::sw128_desc(k_base + kk * 32), wg::sw128_desc(q_base + kk * 32),
                       kk > 0 ? 1 : 0);
    wg::Wgmma<64>::mma(dp_acc, wg::sw128_desc(v_base + kk * 32),
                       wg::sw128_desc(do_base + kk * 32), kk > 0 ? 1 : 0);
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(s_acc);
  wg::fence_regs(dp_acc);
  wg::named_barrier(bar, 128);  // the lse and delta rows are written

  // ---- P^T and dS^T in fp32, then bf16 A operands (slice kk: queries
  // 16kk .. 16kk + 15), and dS^T rows to the swizzled tile ----
  const int warp = tid >> 5, lane = tid & 31, q4 = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's accumulator rows: r0, r0 + 8
  const bool kin0 = r0 < p.Tk, kin1 = r0 + 8 < p.Tk;
  uint32_t pf[4][4], dsf[4][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * q4);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + 8 * jj + 2 * q4);
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
    fab::st_shared_u32(ds_base + r0 * 128 + at, dsf[jj / 2][(jj & 1) * 2]);
    fab::st_shared_u32(ds_base + (r0 + 8) * 128 + at, dsf[jj / 2][(jj & 1) * 2 + 1]);
  }
  wg::fence_proxy_async();
  wg::named_barrier(bar, 128);  // every dS^T row is stored

  // ---- dV = P^T dO, dK = dS^T Q (A in registers, B MN-major) and dQ =
  // dS K (A = the dS^T tile and B = K, both MN-major), N = HD ----
  float dv_acc[HD / 2], dk_acc[HD / 2], dq_acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dv_acc[x] = dk_acc[x] = dq_acc[x] = 0.f;
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
    wg::WgmmaT<HD>::mma(dq_acc, wg::sw128_mn_desc(ds_base + kk * 2048, 0),
                        wg::sw128_mn_desc(k_base + kk * 2048, TILE), kk > 0 ? 1 : 0);
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(dv_acc);
  wg::fence_regs(dk_acc);
  wg::fence_regs(dq_acc);
  wg::fence_regs(pf);
  wg::fence_regs(dsf);

  // ---- dQ, dK / sqrt(D) and dV, rounded once to bf16 ----
  store_rows<HD>(p.out[0] + b * st[15] + h * st[17], st[16], dq_acc, r0, q4, p.Tq, p.scale);
  store_rows<HD>(p.out[1] + b * st[18] + h * st[20], st[19], dk_acc, r0, q4, p.Tk, p.scale);
  store_rows<HD>(p.out[2] + b * st[21] + h * st[23], st[22], dv_acc, r0, q4, p.Tk, 1.f);
}

}  // namespace fbs
