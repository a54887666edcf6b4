// K1/K2 on Hopper: the flash forward with its tiles delivered by TMA and both
// products on wgmma (launched from flash_attention.cu).
//
// Replaces the TPU kernels `_fwd_kernel_onepass` (K/V in one block, K1) and
// `_fwd_kernel` (online softmax over K/V blocks, K2) in
// rho_diffusion_tpu/ops/pallas/flash_attention.py:115/59 (pallas_call at
// :158/:177). Per (batch, head):
//   O = softmax(Q K^T / sqrt(D)) V
// with the scores in fp32, P rounded to bf16 before P V with fp32
// accumulation, keys at or past the true Tk masked to -1e30, 1/max(l, 1e-30)
// at the end, and, when `lse` is not null, the base-2 log-sum-exp
// lse2 = m + log2(max(l, 1e-30)) that flash_attention_bwd.cu reads
// (flash_attention.cu's header states that contract). bf16, D = 64 or 128.
//
// What bounds it on the H100: 4 T D flops per query row against 4 D bytes of
// Q, K, V and O, so operations on the tensor cores once the T x T scores
// stay on chip (T = 4096, B*H = 32: 275 GFLOP, 0.278 ms at the bf16 peak).
// What held the mma.sync kernel (flash_attention.cu, 23 % of the peak at
// T = 4096): one K/V buffer whose every load was waited for in full, and
// mma.sync's reach. The design:
//   * Warp specialisation: one producer warpgroup, of which one thread
//     issues every TMA load, and CONSUMERS (1 or 2) warpgroups of 64 query
//     rows each, so BM = 64 or 128; with two, setmaxnreg moves registers
//     from the producer to the consumers.
//   * Q, K and V by TMA: each a 4-D tensor map (D, H, T, B) over the
//     [B, T, H, D] view as it lies (the UNet's q, k, v are strided views of
//     one qkv projection). A box is 64 channels (128 bytes, the swizzle span)
//     x BM or BN tokens; D = 128 takes two. Q is loaded once; K and V go
//     through a ring of STAGES (2) stages with their own `full` barriers and
//     one `empty` barrier a stage. Tokens past Tq or Tk are zero-filled by
//     the hardware; a zero key still scores 0, so columns at or past Tk are
//     masked to -1e30 in the last tile.
//   * S = Q K^T on wgmma m64nBNk16, both operands K-major from shared memory.
//   * O += P V on wgmma m64nDk16 with A = P from registers: the S accumulator
//     rounded to bf16 pairs is the A operand as it lies. B is the V tile,
//     which is MN-major for this product (channels contiguous): the
//     descriptor's transposed-B form.
//   * The online softmax in registers: a row's values sit in the 4 threads of
//     a quad, so its max and sum take two shuffles. Exponents in base 2.
//   * Each product is waited for; the block's two consumer warpgroups (or
//     two blocks of one) overlap each other's softmax and products. On the
//     H100 this beat a third ring stage and FlashAttention-3's
//     intra-warpgroup overlap (tile j+1's Q K^T issued before tile j's
//     softmax) at every shape the UNet gives; at 128 x 128 tiles and
//     D = 128 ptxas spilled the overlap and serialised its products.
//   * Epilogue: O / l rounded once to bf16 from registers; rows at or past
//     Tq are not written.
// Every mbarrier wait traps after ~5 s (tma.cuh). Left for later: the two
// consumer warpgroups ping-ponging on named barriers, a persistent schedule
// and a TMA store of O.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace fa {

constexpr float NEG_BIG = -1e30f;
constexpr int STAGES = 2;  // the K/V ring's depth

// One launch's shape (the plan's tiles are template parameters).
struct FwdProblem {
  int H, Tq, Tk;
  int kv_tiles;                    // ceil(Tk / BN)
  long long o_sb, o_st, o_sh;      // o's element strides (batch, token, head)
  float scale_log2;                // log2(e) / sqrt(true head dim)
};

__host__ __device__ constexpr int q_bytes(int hd, int bm) { return bm * hd * 2; }
__host__ __device__ constexpr int kv_bytes(int hd, int bn) { return bn * hd * 2; }
// Q, the K and V rings, their barriers, and room to align to the swizzle's 1024 bytes
__host__ __device__ constexpr int smem_bytes(int hd, int bm, int bn) {
  return q_bytes(hd, bm) + 2 * STAGES * kv_bytes(hd, bn) + 8 * (1 + 3 * STAGES) + 1024;
}

// S = Q K^T over the head dim: A = this warpgroup's 64 rows of Q, B = the
// stage's BN keys, both [rows][64 channels] per 64-channel chunk.
template <int HD, int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], uint32_t q_base, uint32_t q_chunk,
                                           uint32_t k_base, uint32_t k_chunk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t c = kk / 4, off = (kk % 4) * 32;
    wg::Wgmma<BN>::mma(s, wg::sw128_desc(q_base + c * q_chunk + off),
                       wg::sw128_desc(k_base + c * k_chunk + off), kk > 0 ? 1 : 0);
  }
}

// O += P V: A = P (bf16 pairs in registers), B = the stage's V tile,
// MN-major; a k16 step is 16 keys (2048 bytes), channels past 64 continue
// in the next chunk, v_chunk bytes further.
template <int HD, int BN>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], const uint32_t (&p)[BN / 16][4],
                                           uint32_t v_base, uint32_t v_chunk) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wg::WgmmaRS<HD>::mma(o, p[kk], wg::sw128_mn_desc(v_base + kk * 2048, v_chunk));
}

// The online softmax over one tile of scores (columns col0 .. col0 + BN):
// scales to base 2, masks columns at or past Tk, updates the running max m
// and this thread's share of the row sums l, leaves exp2(s - m) in s, and
// returns the factors alpha that rescale what was accumulated before.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int col0, int Tk, float scale_log2) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] *= scale_log2;
  if (col0 + BN > Tk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col0 + j * 8 + 2 * q + (e & 1) >= Tk) s[4 * j + e] = NEG_BIG;
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  alpha[0] = exp2f(m[0] - mx0);
  alpha[1] = exp2f(m[1] - mx1);
  m[0] = mx0;
  m[1] = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = exp2f(s[4 * j] - mx0);
    s[4 * j + 1] = exp2f(s[4 * j + 1] - mx0);
    s[4 * j + 2] = exp2f(s[4 * j + 2] - mx1);
    s[4 * j + 3] = exp2f(s[4 * j + 3] - mx1);
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * alpha[0] + rs0;
  l[1] = l[1] * alpha[1] + rs1;
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P as the A operand of the k16 slices: slice kk holds columns 16kk..16kk+15.
template <int BN>
__device__ __forceinline__ void to_bf16(const float (&s)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = wg::pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = wg::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = wg::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = wg::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One block: BM = 64 * CONSUMERS query rows of one (batch, head) against
// all its keys. Threads [0, 128 * CONSUMERS) are the consumer warpgroups,
// the last 128 the producer warpgroup, of which one thread issues every load.
template <int HD, int CONSUMERS, int BN>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap k_map,
                       __grid_constant__ const CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const FwdProblem p) {
  constexpr int BM = 64 * CONSUMERS;
  constexpr int CHUNKS = HD / 64;
  constexpr int Q_BYTES = q_bytes(HD, BM);
  constexpr int KV_BYTES = kv_bytes(HD, BN);
  constexpr uint32_t Q_CHUNK = BM * 128;   // one 64-channel box of the Q tile
  constexpr uint32_t KV_CHUNK = BN * 128;  // one 64-channel box of a K or V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern follows shared-memory address bits: align to 1024
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_tile = smem;                          // CHUNKS x [BM][64]
  uint8_t* k_ring = smem + Q_BYTES;                // STAGES x CHUNKS x [BN][64]
  uint8_t* v_ring = k_ring + STAGES * KV_BYTES;    // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_ring + STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform by construction (the broadcast tells the compiler so, which
  // it needs before it gives the consumers the registers setmaxnreg frees)
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == CONSUMERS) {
    // ---- producer: one thread loads Q, then keeps the K/V ring full ----
    if constexpr (CONSUMERS == 2) wg::regs_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      wg::prefetch_map(&q_map);
      wg::prefetch_map(&k_map);
      wg::prefetch_map(&v_map);
      wg::mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        wg::tma_load_4d(q_tile + c * Q_CHUNK, &q_map, q_full, c * 64, h, q0, b);
      for (int j = 0; j < p.kv_tiles; ++j) {
        const int s = j % STAGES;
        wg::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // the first round finds every stage free
        wg::mbar_expect_tx(&k_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          wg::tma_load_4d(k_ring + s * KV_BYTES + c * KV_CHUNK, &k_map, &k_full[s], c * 64, h,
                          j * BN, b);
        wg::mbar_expect_tx(&v_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          wg::tma_load_4d(v_ring + s * KV_BYTES + c * KV_CHUNK, &v_map, &v_full[s], c * 64, h,
                          j * BN, b);
      }
    }
  } else {
    // ---- consumers: rows [q0 + 64 * group, q0 + 64 * group + 64) ----
    if constexpr (CONSUMERS == 2) wg::regs_inc<232>();
    const bool leader = threadIdx.x % 128 == 0;  // releases stages for its warpgroup
    const uint32_t q_base = wg::smem_u32(q_tile) + group * (64 * 128);
    const uint32_t k_base = wg::smem_u32(k_ring), v_base = wg::smem_u32(v_ring);
    float o_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
    float s_acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.f;
    uint32_t pf[BN / 16][4] = {};
    float m_r[2] = {NEG_BIG, NEG_BIG};  // rows lane/4 and lane/4 + 8 of this warp
    float l_r[2] = {0.f, 0.f};          // this thread's share of their sums
    float alpha[2];
    const int n = p.kv_tiles;
    wg::mbar_wait(q_full, 0);

    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      const uint32_t phase = (j / STAGES) & 1;
      wg::mbar_wait(&k_full[s], phase);
      wg::fence_regs(s_acc);
      wg::wgmma_fence();
      qk_product<HD, BN>(s_acc, q_base, Q_CHUNK, k_base + s * KV_BYTES, KV_CHUNK);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(s_acc);
      softmax_tile<BN>(s_acc, m_r, l_r, alpha, j * BN, p.Tk, p.scale_log2);
      rescale<HD>(o_acc, alpha);
      to_bf16<BN>(s_acc, pf);
      wg::mbar_wait(&v_full[s], phase);
      wg::fence_regs(o_acc);
      wg::fence_regs(pf);
      wg::wgmma_fence();
      pv_product<HD, BN>(o_acc, pf, v_base + s * KV_BYTES, KV_CHUNK);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(o_acc);
      wg::fence_regs(pf);
      if (leader) wg::mbar_arrive(&empty[s]);
    }

    // ---- epilogue: O / l, rounded once to bf16; the base-2 LSE ----
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    float l0 = l_r[0], l1 = l_r[1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int t0 = q0 + group * 64 + warp * 16 + (lane >> 2);
    if (lse != nullptr && (lane & 3) == 0) {  // the quad's 4 lanes hold the same row
      float* lrow = lse + (long long)bh * p.Tq;
      if (t0 < p.Tq) lrow[t0] = m_r[0] + log2f(fmaxf(l0, 1e-30f));
      if (t0 + 8 < p.Tq) lrow[t0 + 8] = m_r[1] + log2f(fmaxf(l1, 1e-30f));
    }
    __nv_bfloat16* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      if (t0 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + t0 * p.o_st + col) =
            __floats2bfloat162_rn(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
      if (t0 + 8 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + 8) * p.o_st + col) =
            __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1, o_acc[4 * j + 3] * inv1);
    }
  }
}

// The register-A, transposed-B product alone, for testing its layouts:
// out[64 x HD] (fp32, row-major) = P[64 x BN] (bf16, row-major, read into
// the A operand's registers) times V[BN x HD] (bf16, by TMA as one [BN]
// token tile of v_map, MN-major). One warpgroup.
template <int HD, int BN>
__global__ void __launch_bounds__(128, 1)
wgmma_pv_probe_kernel(__grid_constant__ const CUtensorMap v_map,
                      const __nv_bfloat16* __restrict__ pm, float* __restrict__ out) {
  constexpr int KV_BYTES = kv_bytes(HD, BN);
  constexpr uint32_t KV_CHUNK = BN * 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* v_tile = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(v_tile + KV_BYTES);
  if (threadIdx.x == 0) {
    wg::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(full, KV_BYTES);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      wg::tma_load_4d(v_tile + c * KV_CHUNK, &v_map, full, c * 64, 0, 0, 0);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2), q = lane & 3;
  uint32_t pf[BN / 16][4];
  const uint32_t* prow0 = reinterpret_cast<const uint32_t*>(pm + r * BN);
  const uint32_t* prow1 = reinterpret_cast<const uint32_t*>(pm + (r + 8) * BN);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pf[kk][0] = prow0[kk * 8 + q];
    pf[kk][1] = prow1[kk * 8 + q];
    pf[kk][2] = prow0[kk * 8 + 4 + q];
    pf[kk][3] = prow1[kk * 8 + 4 + q];
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  wg::mbar_wait(full, 0);
  wg::fence_regs(acc);
  wg::fence_regs(pf);
  wg::wgmma_fence();
  pv_product<HD, BN>(acc, pf, wg::smem_u32(v_tile), KV_CHUNK);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  wg::fence_regs(pf);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * q;
    out[r * HD + col] = acc[4 * j];
    out[r * HD + col + 1] = acc[4 * j + 1];
    out[(r + 8) * HD + col] = acc[4 * j + 2];
    out[(r + 8) * HD + col + 1] = acc[4 * j + 3];
  }
}

}  // namespace fa
