// K3/K4 on Hopper: the flash backward as ONE kernel, its tiles delivered by
// TMA and its five products on wgmma (launched from flash_attention_bwd.cu).
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel` (K4)
// in rho_diffusion_tpu/ops/pallas/flash_attention.py:209/262 (pallas_call at
// :313/:341, launched by `_flash_backward`, :304-359). Per (batch, head):
//   P  = exp2(S log2(e) - lse2),  S = Q K^T / sqrt(D)   (keys >= Tk masked)
//   dV = P^T dO
//   dS = P (dO V^T - delta)
//   dK = dS^T Q / sqrt(D)
//   dQ = dS K / sqrt(D)
// with lse2 the forward's base-2 log-sum-exp and delta = rowsum(dO O) (both
// fp32 [B, H, Tq]; flash_attention_bwd.cu's header states the contract).
// Numerics as the mma.sync pair's: S, P, dP and dS in fp32, P and dS rounded
// to bf16 before their products with fp32 accumulation, each gradient
// rounded once to bf16. bf16, D = 64 or 128.
//
// What bounds it on the H100: five products of 2 T^2 D flops per (batch,
// head) against ~14 T D bytes of inputs and outputs, so operations on the
// tensor cores once S and dP stay on chip (T = 512, B*H = 128, D = 128:
// 42.9 GFLOP, 0.043 ms at the bf16 peak); the design adds dQ's fp32
// accumulator, T D 4 bytes per key tile. What held the mma.sync pair (K3 at
// 5.8x, K4 at 4.9x that bound): mma.sync, one cp.async buffer whose every
// load was waited for, and the split into two kernels, which computes S and
// dP twice (7 products). The design:
//   * One block per (batch*head, BN = D keys), with no producer warps: one
//     consumer warpgroup per 64 keys (one at D = 64, two at D = 128).
//     K and V of the block are loaded once by TMA and stay in shared
//     memory; Q and dO tiles of BM = 64 query rows stream through a 2-stage
//     mbarrier ring (4-D tensor maps over the [B, T, H, D] views as they
//     lie, zero-filled past Tq). Thread 0 refills a stage as soon as every
//     consumer has passed the barrier that follows its last read, and warp
//     0 stages the tile's lse and delta rows with cp.async tracked by the
//     same mbarrier (zero past Tq: Q and dO rows are zero there, so those
//     rows add nothing). No producer warps: with one beside two consumers
//     (288 threads) ptxas held every thread to 168 registers, the cap of a
//     producer warpgroup's 384 threads, which setmaxnreg did not lift; a
//     consumer needs ~220, so that spilled and serialised the wgmma.
//   * The transposed scores: each consumer owns 64 keys and computes
//     S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major). The
//     accumulator's rows are keys, so P^T and dS^T rounded to bf16 pairs
//     are the register A operand of dV += P^T dO and dK += dS^T Q, whose B
//     (dO, Q) is the same tile read MN-major: dK and dV stay in fp32
//     registers for the whole sweep (128 a thread at D = 128).
//   * dQ = dS K needs queries as rows: each consumer stores its dS^T rows
//     to a 128-byte-swizzled tile (conflict-free 32-bit stores), and an SS
//     wgmma reads it as an MN-major A against K as an MN-major B. Each
//     consumer takes one 64-channel chunk of dQ over all BN keys (so BN =
//     D: at D = 128 the two consumers split dQ's two halves).
//   * dQ across the key tiles of a (batch, head), deterministically: each
//     query tile's fp32 share goes to an accumulator in device memory in
//     the fixed order of the key tiles. A counter per (batch*head, query
//     tile) says how many have added; key tile j waits until it reads j.
//     The first copies its share there and the middle ones add it, each as
//     one bulk copy or bulk add of the tile from a double-buffered share in
//     shared memory, issued by thread 0, whose completion releases the
//     counter one tile later; the last key tile adds its share to what it
//     reads there and writes dQ, scaled and rounded once to bf16 (with one
//     key tile dQ is written directly). The grid runs key tile j of every
//     (batch, head) before key tile j + 1 of any, so a block waits only on
//     blocks launched before it. At the flagship's shape on the H100 the
//     order's waits cost ~1 % of the kernel's time, and the adds with their
//     counter releases (a GPU-scope fence each) ~15 %.
// Every mbarrier and counter wait traps after ~5 s (tma.cuh). Left for
// later: a persistent schedule, and the consumers' softmax overlapped with
// the other's products by ping-pong barriers.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace fab {

constexpr int BM = 64;      // query rows a ring stage: the N of S^T, the M of dQ
constexpr int STAGES = 2;   // the Q/dO ring's depth
constexpr int DQ_BUFS = 2;  // dQ's shares in flight to device memory

// One launch's shape (the keys a block are the template's head dim).
struct BwdProblem {
  int H, Tq, Tk;
  int q_tiles;   // ceil(Tq / BM)
  int kv_tiles;  // ceil(Tk / BN): the blocks of one (batch, head), and the adders of a dQ tile
  const float* lse;    // [B*H, Tq], base 2
  const float* delta;  // [B*H, Tq], from flash_bwd_delta_kernel
  float* dq_acc;       // [B*H, q_tiles, BM * HD] fp32 in fragment order (kv_tiles > 1)
  int* dq_order;       // [B*H, q_tiles] key tiles that have added (zeroed; kv_tiles > 1)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dq_st[3], dk_st[3], dv_st[3];  // (batch, token, head) element strides
  float scale;       // 1/sqrt(true head dim)
  float scale_log2;  // scale * log2(e)
};

__host__ __device__ constexpr int kv_bytes(int hd) { return hd * hd * 2; }  // BN = hd keys
__host__ __device__ constexpr int q_bytes(int hd) { return BM * hd * 2; }
__host__ __device__ constexpr int dq_bytes(int hd) { return BM * hd * 4; }
// K and V, the Q and dO rings, the dS^T tile, dQ's fp32 shares, the lse and
// delta rows, the barriers, and room to align to the swizzle's 1024 bytes
__host__ __device__ constexpr int smem_bytes(int hd) {
  return 2 * kv_bytes(hd) + 2 * STAGES * q_bytes(hd) + hd * BM * 2 + DQ_BUFS * dq_bytes(hd) +
         2 * STAGES * BM * 4 + 8 * (1 + STAGES) + 1024;
}

// 2^x on the MUFU (relative error ~2^-22; results below 2^-126 flush to 0,
// terms under 1e-38 of a gradient's sum): at T = 4096 on the H100 the kernel
// took 10 % longer with exp2f
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 4 bytes to shared memory, zero-filled when !pred; tracked by an mbarrier
// through cp_async_arrive
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(wg::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(wg::smem_u32(bar))
               : "memory");
}

// Wait until *flag reads `value` (acquire); trap after ~5 s.
__device__ __forceinline__ void wait_flag(const int* flag, int value) {
  const long long t0 = clock64();
  while (true) {
    int seen;
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(seen) : "l"(flag) : "memory");
    if (seen == value) return;
    if (clock64() - t0 > wg::WATCHDOG_CYCLES) __trap();
    __nanosleep(32);
  }
}

// Release this thread's completed writes, then count one more adder.
__device__ __forceinline__ void release_flag(int* flag) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag)
               : "memory");
}

// dQ's share from shared memory to its accumulator tile in device memory,
// one bulk copy (the first key tile) or bulk add, as its own bulk group.
__device__ __forceinline__ void bulk_to_global(float* dst, uint32_t src, uint32_t bytes, bool add) {
  if (add)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N bulk groups are in flight, their writes done and
// ordered before this thread's next accesses.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\nfence.proxy.async.global;\n" ::"n"(N) : "memory");
}

// S^T (or dP^T) = A B^T over the head dim: A = this consumer's 64 keys of K
// (or V), B = the stage's 64 query rows of Q (or dO), both [rows][64
// channels] per 64-channel chunk, K-major.
template <int HD>
__device__ __forceinline__ void scores_t(float (&d)[32], uint32_t a_base, uint32_t a_chunk,
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t c = kk / 4, off = (kk % 4) * 32;
    wg::Wgmma<64>::mma(d, wg::sw128_desc(a_base + c * a_chunk + off),
                       wg::sw128_desc(b_base + c * (BM * 128) + off), kk > 0 ? 1 : 0);
  }
}

// acc[64 x HD] += A B: A = bf16 pairs in registers (4 k16 slices of 16
// queries), B = the stage's Q or dO tile read MN-major (a k16 step is 16
// query rows, 2048 bytes; channels past 64 in the next chunk).
template <int HD>
__device__ __forceinline__ void grad_product(float (&acc)[HD / 2], const uint32_t (&a)[4][4],
                                             uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::WgmmaRS<HD>::mma(acc, a[kk], wg::sw128_mn_desc(b_base + kk * 2048, BM * 128));
}

// Query tile i into its ring stage: Q and dO by TMA (thread 0), the lse and
// delta rows by cp.async (warp 0), all completing on the stage's barrier.
template <int HD>
__device__ __forceinline__ void load_tile(int i, const CUtensorMap* q_map, const CUtensorMap* do_map,
                                          uint8_t* q_ring, uint8_t* do_ring, float* lse_s,
                                          float* dlt_s, uint64_t* full, const float* lrow,
                                          const float* drow, int Tq, int h, int b) {
  constexpr int Q_BYTES = q_bytes(HD);
  const int s = i % STAGES, tid = threadIdx.x;
  if (tid == 0) {
    wg::mbar_expect_tx(&full[s], 2 * Q_BYTES);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      wg::tma_load_4d(q_ring + s * Q_BYTES + c * (BM * 128), q_map, &full[s], c * 64, h, i * BM, b);
      wg::tma_load_4d(do_ring + s * Q_BYTES + c * (BM * 128), do_map, &full[s], c * 64, h, i * BM, b);
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int r = tid; r < BM; r += 32) {
      const int t = i * BM + r;
      cp_async4(lse_s + s * BM + r, lrow + (t < Tq ? t : 0), t < Tq);
      cp_async4(dlt_s + s * BM + r, drow + (t < Tq ? t : 0), t < Tq);
    }
    cp_async_arrive(&full[s]);
  }
}

// delta = rowsum(dO O) in fp32 for every query row, [B*H, Tq]: the fused
// backward's and the bf16 mma.sync pair's pre-pass. It replaces no TPU
// kernel: `_flash_backward` leaves it to XLA
// (rho_diffusion_tpu/ops/pallas/flash_attention.py:308-311), which fuses it
// into one pass, where PyTorch takes five kernels and ~230 MB of traffic at
// the flagship's shape. Bound by bytes on the H100 (dO and O read once, 2
// flops a 4-byte pair). LANES lanes a row (a whole warp at D >= 64, D / 2 at
// 16 and 32), each reading PER channels of dO and O (4 to 16 bytes); the
// row's lanes sum their fp32 products.
template <int HD>
struct DeltaShape {
  static constexpr int PER = HD >= 64 ? HD / 32 : 2;  // channels a lane
  static constexpr int LANES = HD / PER;              // lanes a row
  static constexpr int ROWS = 256 / LANES;            // rows a block of 256 threads
};

template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Tq, long long rows, long long o_sb,
                       long long o_st, long long o_sh, long long d_sb, long long d_st,
                       long long d_sh) {
  using S = DeltaShape<HD>;
  const long long row = (long long)blockIdx.x * S::ROWS + threadIdx.x / S::LANES;
  const int lane = threadIdx.x % S::LANES;
  // rows past the end add nothing, but their lanes stay for the shuffles
  const bool in = row < rows;
  const long long bh = in ? row / Tq : 0;
  const int t = in ? (int)(row - bh * Tq) : 0;
  const int b = (int)(bh / H), h = (int)(bh - (long long)b * H);
  const __nv_bfloat16* orow = o + b * o_sb + t * o_st + h * o_sh + lane * S::PER;
  const __nv_bfloat16* drow = dout + b * d_sb + t * d_st + h * d_sh + lane * S::PER;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < S::PER; c += 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
#pragma unroll
  for (int off = S::LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (in && lane == 0) delta[row] = sum;
}

// One block: the BN = HD keys of key tile blockIdx.y of (batch, head)
// blockIdx.x against all its query rows; every thread is a consumer, one
// warpgroup per 64 keys and per 64-channel chunk of dQ.
template <int HD>
__global__ void __launch_bounds__(2 * HD, HD == 64 ? 2 : 1)
flash_bwd_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap k_map,
                       __grid_constant__ const CUtensorMap v_map,
                       __grid_constant__ const CUtensorMap do_map, const BwdProblem p) {
  constexpr int BN = HD;
  constexpr int THREADS = 2 * HD;  // 128 a consumer warpgroup
  constexpr int CHUNKS = HD / 64;
  constexpr int KV_BYTES = kv_bytes(HD);
  constexpr int Q_BYTES = q_bytes(HD);
  constexpr uint32_t KV_CHUNK = BN * 128;  // one 64-channel box of the K or V tile
  constexpr int DQ_N = 64;                 // dQ columns a consumer owns
  constexpr int NJ = DQ_N / 8;             // their 8-column groups
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern follows shared-memory address bits: align to 1024
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_tile = smem;                         // CHUNKS x [BN][64]
  uint8_t* v_tile = k_tile + KV_BYTES;            // the same
  uint8_t* q_ring = v_tile + KV_BYTES;            // STAGES x CHUNKS x [BM][64]
  uint8_t* do_ring = q_ring + STAGES * Q_BYTES;   // the same
  uint8_t* ds_tile = do_ring + STAGES * Q_BYTES;  // [BN keys][BM queries] bf16, swizzled
  float* dq_s = reinterpret_cast<float*>(ds_tile + BN * BM * 2);  // DQ_BUFS x [BM * HD]
  float* lse_s = dq_s + DQ_BUFS * BM * HD;                        // STAGES x [BM]
  float* dlt_s = lse_s + STAGES * BM;                             // STAGES x [BM]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dlt_s + STAGES * BM);
  uint64_t* full = kv_full + 1;

  // every (batch, head)'s key tile j is launched before any one's key tile
  // j + 1, so the tile a block waits on ran a wave earlier
  const int bh = blockIdx.x;
  const int j = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int n0 = j * BN;
  const int tid = threadIdx.x;
  const int group = tid / 128, warp = (tid & 127) >> 5, lane = tid & 31, q4 = lane & 3;
  const float* lrow = p.lse + (long long)bh * p.Tq;
  const float* drow = p.delta + (long long)bh * p.Tq;

  if (tid == 0) {
    wg::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) wg::mbar_init(&full[s], 1 + 32);  // thread 0, warp 0's lanes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    wg::prefetch_map(&q_map);
    wg::prefetch_map(&k_map);
    wg::prefetch_map(&v_map);
    wg::prefetch_map(&do_map);
    wg::mbar_expect_tx(kv_full, 2 * KV_BYTES);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      wg::tma_load_4d(k_tile + c * KV_CHUNK, &k_map, kv_full, c * 64, h, n0, b);
      wg::tma_load_4d(v_tile + c * KV_CHUNK, &v_map, kv_full, c * 64, h, n0, b);
    }
  }
  for (int i = 0; i < STAGES && i < p.q_tiles; ++i)
    load_tile<HD>(i, &q_map, &do_map, q_ring, do_ring, lse_s, dlt_s, full, lrow, drow, p.Tq, h, b);

  const uint32_t k_base = wg::smem_u32(k_tile), v_base = wg::smem_u32(v_tile);
  const uint32_t mine = group * (64 * 128);  // this consumer's 64 rows of a K or V chunk
  const uint32_t ds_base = wg::smem_u32(ds_tile);
  const int r0 = 16 * warp + (lane >> 2);  // this thread's accumulator rows: r0, r0 + 8
  const int key0 = n0 + 64 * group + r0;
  const bool kin0 = key0 < p.Tk, kin1 = key0 + 8 < p.Tk;
  // this consumer's dQ columns: its 64-channel chunk of K
  const uint32_t dq_b = k_base + group * KV_CHUNK;
  const int dq_col0 = group * 64;
  const bool last = j == p.kv_tiles - 1;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  wg::mbar_wait(kv_full, 0);

  for (int i = 0; i < p.q_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t q_base = wg::smem_u32(q_ring) + s * Q_BYTES;
    const uint32_t do_base = wg::smem_u32(do_ring) + s * Q_BYTES;
    wg::mbar_wait(&full[s], (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns the tile's queries
    float s_acc[32], dp_acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s_acc[x] = dp_acc[x] = 0.f;
    wg::fence_regs(s_acc);
    wg::fence_regs(dp_acc);
    wg::wgmma_fence();
    scores_t<HD>(s_acc, k_base + mine, KV_CHUNK, q_base);
    scores_t<HD>(dp_acc, v_base + mine, KV_CHUNK, do_base);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s_acc);
    wg::fence_regs(dp_acc);

    // P^T and dS^T in fp32, then as bf16 A operands: slice kk holds
    // queries 16kk .. 16kk + 15
    const float* ls = lse_s + s * BM;
    const float* dl = dlt_s + s * BM;
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * q4);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * jj + 2 * q4);
      const float p0 = kin0 ? ex2(s_acc[4 * jj] * p.scale_log2 - l2.x) : 0.f;
      const float p1 = kin0 ? ex2(s_acc[4 * jj + 1] * p.scale_log2 - l2.y) : 0.f;
      const float p2 = kin1 ? ex2(s_acc[4 * jj + 2] * p.scale_log2 - l2.x) : 0.f;
      const float p3 = kin1 ? ex2(s_acc[4 * jj + 3] * p.scale_log2 - l2.y) : 0.f;
      // accumulator (row r0 / r0 + 8, query 8jj + 2q4 + {0, 1}) -> A slice jj / 2
      pf[jj / 2][(jj & 1) * 2] = wg::pack_bf16(p0, p1);
      pf[jj / 2][(jj & 1) * 2 + 1] = wg::pack_bf16(p2, p3);
      dsf[jj / 2][(jj & 1) * 2] = wg::pack_bf16(p0 * (dp_acc[4 * jj] - d2.x),
                                            p1 * (dp_acc[4 * jj + 1] - d2.y));
      dsf[jj / 2][(jj & 1) * 2 + 1] = wg::pack_bf16(p2 * (dp_acc[4 * jj + 2] - d2.x),
                                                p3 * (dp_acc[4 * jj + 3] - d2.y));
    }

    // dS^T rows to the swizzled tile: row key, 16-byte chunk jj ^ (row & 7)
    {
      const uint32_t row = 64 * group + r0;  // (row + 8) & 7 == row & 7 == lane >> 2
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t at = ((jj ^ (lane >> 2)) << 4) + 4 * q4;
        st_shared_u32(ds_base + row * 128 + at, dsf[jj / 2][(jj & 1) * 2]);
        st_shared_u32(ds_base + (row + 8) * 128 + at, dsf[jj / 2][(jj & 1) * 2 + 1]);
      }
    }
    wg::fence_proxy_async();

    // dV += P^T dO and dK += dS^T Q; P^T and dS^T leave the registers
    // before dQ's accumulator takes them
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    wg::fence_regs(pf);
    wg::fence_regs(dsf);
    wg::wgmma_fence();
    grad_product<HD>(dv_acc, pf, do_base);
    grad_product<HD>(dk_acc, dsf, q_base);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    wg::fence_regs(pf);
    wg::fence_regs(dsf);

    // every dS^T row is stored, and every consumer is done with stage s:
    // refill it with tile i + STAGES
    wg::named_barrier(1, THREADS);
    if (i + STAGES < p.q_tiles)
      load_tile<HD>(i + STAGES, &q_map, &do_map, q_ring, do_ring, lse_s, dlt_s, full, lrow, drow,
                    p.Tq, h, b);

    // dQ = dS K over the block's BN keys: A = dS^T and B = K, both MN-major
    float dq_acc[DQ_N / 2];
#pragma unroll
    for (int x = 0; x < DQ_N / 2; ++x) dq_acc[x] = 0.f;
    wg::fence_regs(dq_acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wg::WgmmaT<DQ_N>::mma(dq_acc, wg::sw128_mn_desc(ds_base + kk * 2048, 0),
                            wg::sw128_mn_desc(dq_b + kk * 2048, KV_CHUNK), kk > 0 ? 1 : 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dq_acc);

    // dQ tile i: this key tile's share, in the fixed order of the key tiles.
    // Fragment (consumer, warp, column group jj, lane) is a thread's 4 values
    // as one float4; a warp's 32 float4 lie side by side.
    const long long tile = (long long)bh * p.q_tiles + i;
    float4* share = reinterpret_cast<float4*>(dq_s + (i % DQ_BUFS) * (BM * HD) +
                                              group * (64 * DQ_N)) + warp * NJ * 32 + lane;
    float4* acc = reinterpret_cast<float4*>(p.dq_acc + tile * (BM * HD) + group * (64 * DQ_N)) +
                  warp * NJ * 32 + lane;
    if (!last) {
      // (the bulk group that last read this buffer completed at tile i - 1)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        share[jj * 32] = make_float4(dq_acc[4 * jj], dq_acc[4 * jj + 1], dq_acc[4 * jj + 2],
                                     dq_acc[4 * jj + 3]);
      wg::fence_proxy_async();
      // (also: every consumer's dQ product is done with the dS^T tile)
      wg::named_barrier(2, THREADS);
      if (tid == 0) {
        if (j > 0) wait_flag(p.dq_order + tile, j);
        bulk_to_global(p.dq_acc + tile * (BM * HD), wg::smem_u32(dq_s + (i % DQ_BUFS) * (BM * HD)),
                       BM * HD * 4, j > 0);
        // tile i - 1's group is done: release its counter
        bulk_wait<1>();
        if (i > 0) release_flag(p.dq_order + tile - 1);
      }
    } else {
      if (p.kv_tiles > 1 && tid == 0) wait_flag(p.dq_order + tile, j);
      // (also: every consumer's dQ product is done with the dS^T tile)
      wg::named_barrier(2, THREADS);
      if (p.kv_tiles > 1) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 a = __ldcg(acc + jj * 32);
          dq_acc[4 * jj] += a.x;
          dq_acc[4 * jj + 1] += a.y;
          dq_acc[4 * jj + 2] += a.z;
          dq_acc[4 * jj + 3] += a.w;
        }
      }
      const int t0 = i * BM + r0;
      __nv_bfloat16* dqb = p.dq + b * p.dq_st[0] + h * p.dq_st[2];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = dq_col0 + jj * 8 + 2 * q4;
        if (t0 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(dqb + t0 * p.dq_st[1] + col) =
              __floats2bfloat162_rn(dq_acc[4 * jj] * p.scale, dq_acc[4 * jj + 1] * p.scale);
        if (t0 + 8 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(dqb + (t0 + 8) * p.dq_st[1] + col) =
              __floats2bfloat162_rn(dq_acc[4 * jj + 2] * p.scale, dq_acc[4 * jj + 3] * p.scale);
      }
    }
  }
  if (!last && tid == 0) {
    bulk_wait<0>();
    release_flag(p.dq_order + (long long)bh * p.q_tiles + p.q_tiles - 1);
  }

  // ---- epilogue: dK / sqrt(D) and dV, rounded once to bf16 ----
  __nv_bfloat16* dkb = p.dk + b * p.dk_st[0] + h * p.dk_st[2];
  __nv_bfloat16* dvb = p.dv + b * p.dv_st[0] + h * p.dv_st[2];
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const int col = jj * 8 + 2 * q4;
    if (kin0) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * p.dk_st[1] + col) =
          __floats2bfloat162_rn(dk_acc[4 * jj] * p.scale, dk_acc[4 * jj + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * p.dv_st[1] + col) =
          __floats2bfloat162_rn(dv_acc[4 * jj], dv_acc[4 * jj + 1]);
    }
    if (kin1) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (key0 + 8) * p.dk_st[1] + col) =
          __floats2bfloat162_rn(dk_acc[4 * jj + 2] * p.scale, dk_acc[4 * jj + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (key0 + 8) * p.dv_st[1] + col) =
          __floats2bfloat162_rn(dv_acc[4 * jj + 2], dv_acc[4 * jj + 3]);
    }
  }
}

}  // namespace fab
