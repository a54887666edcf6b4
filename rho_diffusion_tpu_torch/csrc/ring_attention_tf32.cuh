// K6 in fp32 on Hopper's tensor cores: the ring's fold with every product
// split into three TF32 products (3xTF32), on wgmma (launched from
// ring_attention.cu's `ring_attention_tf32`).
//
// Replaces, for fp32 at head dims 64 and 128, the TPU kernel `_kernel` /
// `ring_attention_rdma` (rho_diffusion_tpu/parallel/context_rdma.py:50/147,
// pallas_call at :166): each rank r folds the K/V shards of all n ranks in
// the ring's order r, r-1, ..., r-n+1 (mod n) into its rows' online-softmax
// state (m, l, acc) in fp32, base 2, and writes o = acc / l (the function
// ring_attention.cu states). A single shard (n = 1) is the flash forward:
// flash_attention.cu launches this fold so (`flash_fwd_tf32_kernel`, after
// its own launch of the pre-pass) for fp32 at head dims 64 and 128, with
// each row's base-2 log-sum-exp written when the problem's `lse` is set.
//
// What bounds it on the H100: 4 T D flops a query row against 4 D fp32
// values of q, k, v and o, so operations once the scores stay on chip. One
// TF32 product keeps 10 mantissa bits and misses the fp32 tolerance of the
// JAX package's attention tests (2e-5), so the kernel splits each operand
// a = a_hi + a_lo (a_hi = tf32(a), a_lo = tf32(a - a_hi)) and takes
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in the fp32 accumulator (the small
// terms first), dropping only a_lo b_lo (~2^-22 relative): three TF32
// products at 495 TFLOP/s, 165 TFLOP/s of fp32 work against the CUDA cores'
// 67 (the FMA kernel this replaces ran at ~12). At the flagship's serve
// shape (bucket 8, n = 4: B*H = 32, T = 512, D = 128) the bound is 0.026 ms
// a call.
//
// The design:
//   * wgmma takes tf32 only K-major, so both products need their reduction
//     dimension contiguous: D for S = Q K^T, the keys for O += P V. A
//     pre-pass (`kv_split_kernel`, one block per 32 keys of a shard and
//     (batch, head)) reads every shard where it lies and writes K's hi and lo
//     terms [2][B*H][n S8][D] and V^T's [2][B*H][D][n S8] on the launch's
//     device (S8: the shard's keys rounded up to 8, shard j at keys
//     [j S8, j S8 + S), the rest zero). The main kernel reads them by TMA in
//     128-byte swizzled boxes of 32 fp32 through a ring of STAGES stages of
//     BN = 32 keys: K's hi and lo ([32 keys][32 channels] a box) and V^T's
//     ([D channels][32 keys]), 512 D bytes a stage. A tile that runs past
//     its shard's S keys is masked per shard, as the bf16 kernel masks it.
//   * Q: each consumer thread loads its A fragments of q from device memory
//     once, keeps Q's hi terms in registers (the A operand of two of S's
//     three products, D/2 registers) and writes Q's lo terms into shared
//     memory in the swizzled layout (the A operand of the third).
//   * P as the A operand of P V from registers: the S accumulator holds
//     columns 2q, 2q + 1 where a tf32 A fragment holds k = q, q + 4
//     (wgmma.cuh), so the pre-pass stores V^T's keys in each aligned 8 in
//     that order (`tf32_k_perm`) and the accumulator is the A operand
//     without a shuffle. P's split is in registers.
//   * Two warpgroups of 64 query rows each (BM = 128) and no producer warps:
//     thread 0 issues every load, the next tile into the stage both
//     warpgroups have just released (the fused backward's scheme). A
//     consumer thread holds Q's hi terms (D/2), O (D/2), O's partial sum and
//     P's terms, ~200 registers at D = 128: with a producer warpgroup (384
//     threads) or warp (288) one of the SM's four register partitions holds
//     three warps, which caps a thread at 168 registers, and the kernel
//     spilled 472 bytes; 256 threads allow 255. Shared memory at D = 128:
//     Q's lo terms 64 KB and two 64 KB stages. One launch covers every rank
//     on the device (grid z), as the bf16 and FMA kernels do.
//   * The online softmax in registers, exponents in base 2 (the flash
//     forward's `softmax_tile`).
// Every mbarrier wait traps after ~5 s (tma.cuh).

#pragma once

#include <stdint.h>

#include "flash_attention_wgmma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace rt {

constexpr int BM = 128;        // query rows a block: two consumer warpgroups of 64
constexpr int BN = 32;         // keys a ring stage: one 128-byte row of V^T
constexpr int STAGES = 2;      // the K/V ring's depth
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS;
constexpr int SPLIT_KEYS = 32;  // keys a pre-pass block

__host__ __device__ constexpr int q_lo_bytes(int hd) { return BM * hd * 4; }
// one term of a K tile (HD/32 boxes of [BN][32]) or of a V^T tile ([HD][BN])
__host__ __device__ constexpr int term_bytes(int hd) { return BN * hd * 4; }
__host__ __device__ constexpr int stage_bytes(int hd) { return 4 * term_bytes(hd); }
// Q's lo terms, the ring, its barriers, and room to align to the swizzle's 1024 bytes
__host__ __device__ constexpr int smem_bytes(int hd) {
  return q_lo_bytes(hd) + STAGES * stage_bytes(hd) + 8 * 2 * STAGES + 1024;
}

constexpr int MAX_SHARDS = 16;  // ranks of one ring (ring_attention.cu MAX_RING)

// One launch: R ranks of a ring of `shards`, each shard S keys.
struct Tf32Problem {
  int H, Tq;
  int BH;                          // batch * heads: the lo terms' offset in the split tensors
  int shards, S, S8;               // ring ranks; keys a shard, and rounded up to 8
  int tiles_per_shard;             // ceil(S / BN)
  const float* q[MAX_SHARDS];      // the launch's ranks (grid z): queries, outputs, ring index
  float* o[MAX_SHARDS];
  int rank[MAX_SHARDS];
  long long q_sb, q_st, q_sh;      // q's element strides (batch, token, head), every rank's
  long long o_sb, o_st, o_sh;
  float scale_log2;                // log2(e) / sqrt(true head dim)
  // null (the ring), or fp32 [R][B*H][Tq] for each row's base-2 log-sum-exp
  // m + log2(max(l, 1e-30)) (the flash forward's, flash_attention.cu)
  float* lse;
};

// Every rank's K and V shard [B, S, H, D] (one stride set each), read by
// the pre-pass where they lie.
struct Tf32Shards {
  const float* k[MAX_SHARDS];
  const float* v[MAX_SHARDS];
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

// The pre-pass: K's and V^T's tf32 hi and lo terms (layouts above) for
// SPLIT_KEYS keys of shard blockIdx.z and one (batch, head) a block; keys
// in [S, S8) of a shard are zero in both.
// (The body of `kv_split_kernel`, which the flash forward's pre-pass
// shares; a block of 256 threads.)
template <int HD>
__device__ __forceinline__ void kv_split(const Tf32Shards& src, float* __restrict__ ks,
                                         float* __restrict__ vts, int H, int S, int S8, int BH,
                                         int shards) {
  __shared__ float vtile[SPLIT_KEYS][HD + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, j = blockIdx.z;
  const int key0 = blockIdx.x * SPLIT_KEYS;
  const long long keys = (long long)shards * S8;  // a (batch, head)'s keys in the split tensors
  const float* kb = src.k[j] + b * src.k_sb + h * src.k_sh;
  const float* vb = src.v[j] + b * src.v_sb + h * src.v_sh;
  for (int i = threadIdx.x; i < SPLIT_KEYS * HD; i += blockDim.x) {
    const int r = i / HD, c = i - r * HD, key = key0 + r;
    if (key < S8) {
      uint32_t hi = 0, lo = 0;
      if (key < S) wg::split_tf32(kb[key * src.k_st + c], hi, lo);
      const long long at = ((long long)bh * keys + (long long)j * S8 + key) * HD + c;
      reinterpret_cast<uint32_t*>(ks)[at] = hi;
      reinterpret_cast<uint32_t*>(ks)[at + (long long)BH * keys * HD] = lo;
    }
    vtile[r][c] = key < S ? vb[key * src.v_st + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPLIT_KEYS * HD; i += blockDim.x) {
    const int c = i / SPLIT_KEYS, jj = i - c * SPLIT_KEYS, key = key0 + jj;
    if (key >= S8) continue;
    uint32_t hi, lo;
    wg::split_tf32(vtile[(jj & ~7) + wg::tf32_k_perm(jj & 7)][c], hi, lo);
    const long long at = ((long long)bh * HD + c) * keys + (long long)j * S8 + key;
    reinterpret_cast<uint32_t*>(vts)[at] = hi;
    reinterpret_cast<uint32_t*>(vts)[at + (long long)BH * HD * keys] = lo;
  }
}

template <int HD>
__global__ void __launch_bounds__(256)
kv_split_kernel(const __grid_constant__ Tf32Shards src, float* __restrict__ ks,
                float* __restrict__ vts, int H, int S, int S8, int BH, int shards) {
  kv_split<HD>(src, ks, vts, H, S, S8, BH, shards);
}

// The shard rank `rank` folds at its j-th tile: r, r-1, ..., r-n+1 (mod n).
__device__ __forceinline__ int shard_of(int rank, int j, const Tf32Problem& p) {
  const int back = j / p.tiles_per_shard;
  return (rank - back % p.shards + p.shards) % p.shards;
}

// The tensor cores' fp32 accumulator rounds toward zero, so a sum of many
// products in it drifts: S over D = 128 (48 products) and O over T = 4096
// keys (1536 products) fail the fp32 tolerance (measured on the H100, where
// one-accumulator versions of these products were 1.6x it at T = 4096). So
// each product group below sums at most 12 products in the accumulator
// (one 32-channel chunk of S, one tile's 32 keys of a 64-channel half of
// O) into `part`, and the group's sum joins the total in registers, rounded
// to nearest.

// S = Q K^T over the head dim, 3xTF32, per 32-channel chunk the small terms
// first: A = Q's lo terms from shared memory, then Q's hi terms from
// registers; B = the stage's K terms, HD/32 boxes of [BN keys][32 channels].
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], float (&part)[BN / 2],
                                           const uint32_t (&qh)[HD / 8][4], uint32_t q_lo,
                                           uint32_t k_hi, uint32_t k_lo) {
  constexpr uint32_t Q_CHUNK = 64 * 128, K_CHUNK = BN * 128;
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    // the first product overwrites `part`; zeros here (not a fence) let the
    // compiler give its registers to other values between the groups
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 4 * c; kk < 4 * c + 4; ++kk)
      wg::WgmmaTf32<BN>::mma(part, wg::sw128_desc(q_lo + c * Q_CHUNK + (kk % 4) * 32),
                             wg::sw128_desc(k_hi + c * K_CHUNK + (kk % 4) * 32), kk > 4 * c ? 1 : 0);
#pragma unroll
    for (int kk = 4 * c; kk < 4 * c + 4; ++kk)
      wg::WgmmaTf32RS<BN>::mma(part, qh[kk], wg::sw128_desc(k_lo + c * K_CHUNK + (kk % 4) * 32));
#pragma unroll
    for (int kk = 4 * c; kk < 4 * c + 4; ++kk)
      wg::WgmmaTf32RS<BN>::mma(part, qh[kk], wg::sw128_desc(k_hi + c * K_CHUNK + (kk % 4) * 32));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = c == 0 ? part[i] : s[i] + part[i];
  }
}

// O += P V, 3xTF32, per 64-channel half the small terms first: A = P's
// terms in registers, B = the stage's V^T terms [HD][BN keys] (a half is 64
// rows, 8 KB, further); a k8 step is 8 keys, 32 bytes along the row.
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], float (&part)[32],
                                           const uint32_t (&ph)[BN / 8][4],
                                           const uint32_t (&pl)[BN / 8][4], uint32_t v_hi,
                                           uint32_t v_lo) {
#pragma unroll
  for (int half = 0; half < HD / 64; ++half) {
    const uint32_t vh = v_hi + half * 64 * 128, vl = v_lo + half * 64 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
      wg::WgmmaTf32RS<64>::mma(part, pl[kk], wg::sw128_desc(vh + kk * 32), kk > 0 ? 1 : 0);
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) wg::WgmmaTf32RS<64>::mma(part, ph[kk], wg::sw128_desc(vl + kk * 32));
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) wg::WgmmaTf32RS<64>::mma(part, ph[kk], wg::sw128_desc(vh + kk * 32));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[32 * half + i] += part[i];
  }
}

// P's tf32 terms as the A operand of the k8 slices: slice kk holds keys
// 8kk..8kk+7, k = q from column 2q and k = q + 4 from column 2q + 1.
__device__ __forceinline__ void split_p(const float (&s)[BN / 2], uint32_t (&ph)[BN / 8][4],
                                        uint32_t (&pl)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    wg::split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);      // (r, q)
    wg::split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);  // (r + 8, q)
    wg::split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);  // (r, q + 4)
    wg::split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);  // (r + 8, q + 4)
  }
}

// Thread 0 loads tile j of the ring's order into stage j % STAGES.
template <int HD>
__device__ __forceinline__ void load_tile(int j, int rank, int bh, const Tf32Problem& p,
                                          const CUtensorMap& k_map, const CUtensorMap& v_map,
                                          uint8_t* ring, uint64_t* full) {
  constexpr int TERM = term_bytes(HD);
  constexpr uint32_t K_CHUNK = BN * 128;  // one 32-channel box of a K term
  const int s = j % STAGES;
  const int key0 = shard_of(rank, j, p) * p.S8 + (j % p.tiles_per_shard) * BN;
  uint8_t* st = ring + s * stage_bytes(HD);
  wg::mbar_expect_tx(&full[s], stage_bytes(HD));
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    wg::tma_load_3d(st + c * K_CHUNK, &k_map, &full[s], c * 32, key0, bh);
    wg::tma_load_3d(st + TERM + c * K_CHUNK, &k_map, &full[s], c * 32, key0, p.BH + bh);
  }
  wg::tma_load_3d(st + 2 * TERM, &v_map, &full[s], key0, 0, bh);
  wg::tma_load_3d(st + 3 * TERM, &v_map, &full[s], key0, 0, p.BH + bh);
}

// One block: BM query rows of one (batch, head) of rank p.rank[z] against
// every shard's keys in the ring's order: two warpgroups of 64 rows, thread
// 0 also issuing every load. (The body of `ring_attention_tf32_kernel`,
// which the flash forward's kernel shares: flash_attention.cu.)
template <int HD>
__device__ __forceinline__ void tf32_fold(const CUtensorMap& k_map, const CUtensorMap& v_map,
                                          const Tf32Problem& p) {
  constexpr int TERM = term_bytes(HD);
  constexpr int STAGE = stage_bytes(HD);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern follows shared-memory address bits: align to 1024
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_lo = smem;                        // CONSUMERS x CHUNKS x [64][32]
  uint8_t* ring = smem + q_lo_bytes(HD);       // STAGES x (K hi, K lo, V^T hi, V^T lo)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;
  const int z = blockIdx.z, rank = p.rank[z];
  const int tiles = p.shards * p.tiles_per_shard;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    wg::prefetch_map(&k_map);
    wg::prefetch_map(&v_map);
    for (int j = 0; j < STAGES && j < tiles; ++j)
      load_tile<HD>(j, rank, bh, p, k_map, v_map, ring, full);
  }
  __syncthreads();

  // ---- rows [q0 + 64 * group, q0 + 64 * group + 64) ----
  const bool leader = threadIdx.x % 128 == 0;  // releases stages for its warpgroup
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5, qd = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0 and r0 + 8 of the 64
  // Q's A fragments: hi terms kept in registers, lo terms to shared memory
  uint8_t* my_q_lo = q_lo + group * (64 * HD * 4);
  uint32_t qh[HD / 8][4];
  const float* qb = p.q[z] + b * p.q_sb + h * p.q_sh;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8, col = 8 * kk + qd + (e >> 1) * 4;
      const int t = q0 + group * 64 + row;
      uint32_t lo;
      wg::split_tf32(t < p.Tq ? qb[t * p.q_st + col] : 0.f, qh[kk][e], lo);
      *reinterpret_cast<uint32_t*>(my_q_lo + (col / 32) * (64 * 128) +
                                   wg::sw128_offset(row, (col % 32) / 4) + (col % 4) * 4) = lo;
    }
  wg::fence_proxy_async();
  wg::named_barrier(1 + group, 128);

  const uint32_t q_lo_base = wg::smem_u32(my_q_lo);
  const uint32_t ring_base = wg::smem_u32(ring);
  float o_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
  float s_acc[BN / 2], s_part[BN / 2], o_part[32];
  uint32_t ph[BN / 8][4] = {}, pl[BN / 8][4] = {};
  float m_r[2] = {fa::NEG_BIG, fa::NEG_BIG};  // rows r0 and r0 + 8
  float l_r[2] = {0.f, 0.f};                  // this thread's share of their sums
  float alpha[2];

  for (int j = 0; j < tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t st = ring_base + s * STAGE;
    wg::mbar_wait(&full[s], (j / STAGES) & 1);
    wg::fence_regs(qh);
    qk_product<HD>(s_acc, s_part, qh, q_lo_base, st, st + TERM);
    wg::fence_regs(qh);
    // columns past the shard's S keys are masked
    fa::softmax_tile<BN>(s_acc, m_r, l_r, alpha, (j % p.tiles_per_shard) * BN, p.S,
                         p.scale_log2);
    fa::rescale<HD>(o_acc, alpha);
    split_p(s_acc, ph, pl);
    wg::fence_regs(ph);
    wg::fence_regs(pl);
    pv_product<HD>(o_acc, o_part, ph, pl, st + 2 * TERM, st + 3 * TERM);
    wg::fence_regs(ph);
    wg::fence_regs(pl);
    if (leader) wg::mbar_arrive(&empty[s]);
    // the stage both warpgroups have released takes tile j + STAGES
    if (threadIdx.x == 0 && j + STAGES < tiles) {
      wg::mbar_wait(&empty[s], (j / STAGES) & 1);
      load_tile<HD>(j + STAGES, rank, bh, p, k_map, v_map, ring, full);
    }
  }

  // ---- epilogue: O / l in fp32 ----
  float l0 = l_r[0], l1 = l_r[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int t0 = q0 + group * 64 + r0;
  if (p.lse != nullptr && qd == 0) {  // the quad's 4 lanes hold the same rows
    float* lrow = p.lse + ((long long)z * p.BH + bh) * p.Tq;
    if (t0 < p.Tq) lrow[t0] = m_r[0] + log2f(fmaxf(l0, 1e-30f));
    if (t0 + 8 < p.Tq) lrow[t0 + 8] = m_r[1] + log2f(fmaxf(l1, 1e-30f));
  }
  float* ob = p.o[z] + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + qd * 2;
    if (t0 < p.Tq)
      *reinterpret_cast<float2*>(ob + t0 * p.o_st + col) =
          make_float2(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
    if (t0 + 8 < p.Tq)
      *reinterpret_cast<float2*>(ob + (t0 + 8) * p.o_st + col) =
          make_float2(o_acc[4 * j + 2] * inv1, o_acc[4 * j + 3] * inv1);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
ring_attention_tf32_kernel(__grid_constant__ const CUtensorMap k_map,
                           __grid_constant__ const CUtensorMap v_map, const Tf32Problem p) {
  tf32_fold<HD>(k_map, v_map, p);
}

// The 3xTF32 products alone, one warpgroup on one tile, for testing their
// layouts: out[2][64][N] (fp32) = A[64][32] B[N][32]^T (fp32, row-major),
// twice. out[0]: A's fragments in the register A layout, B's terms written
// into shared memory in the swizzled K-major layout (S = Q K^T's operands);
// out[1]: A read in the accumulator's layout and B's k in each aligned 8 in
// `tf32_k_perm` order (O += P V's operands). Both with the small terms first.
template <int N>
__global__ void __launch_bounds__(128, 1)
tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                  float* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_hi = smem;                // [N][32], then the permuted copy
  uint8_t* b_lo = smem + 2 * N * 128;  // the same
  for (int i = threadIdx.x; i < N * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    const int kp = (k & ~7) + wg::tf32_k_perm(k & 7);  // the permuted copy's key at k
    uint32_t hi, lo, hp, lp;
    wg::split_tf32(bm[n * 32 + k], hi, lo);
    wg::split_tf32(bm[n * 32 + kp], hp, lp);
    const uint32_t at = wg::sw128_offset(n, k / 4) + (k % 4) * 4;
    *reinterpret_cast<uint32_t*>(b_hi + at) = hi;
    *reinterpret_cast<uint32_t*>(b_lo + at) = lo;
    *reinterpret_cast<uint32_t*>(b_hi + N * 128 + at) = hp;
    *reinterpret_cast<uint32_t*>(b_lo + N * 128 + at) = lp;
  }
  wg::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, qd = lane & 3;
  const int r = warp * 16 + (lane >> 2);
  for (int form = 0; form < 2; ++form) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + (e & 1) * 8;
        // form 0: the A layout's k = q + 4 (e >> 1); form 1: the
        // accumulator's column 2q + (e >> 1), which the A layout reads as k
        const int col = 8 * kk + (form == 0 ? qd + (e >> 1) * 4 : 2 * qd + (e >> 1));
        wg::split_tf32(a[row * 32 + col], ah[kk][e], al[kk][e]);
      }
    const uint32_t bh = wg::smem_u32(b_hi) + form * N * 128, bl = wg::smem_u32(b_lo) + form * N * 128;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    wg::fence_regs(acc);
    wg::fence_regs(ah);
    wg::fence_regs(al);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::WgmmaTf32RS<N>::mma(acc, al[kk], wg::sw128_desc(bh + kk * 32));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::WgmmaTf32RS<N>::mma(acc, ah[kk], wg::sw128_desc(bl + kk * 32));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::WgmmaTf32RS<N>::mma(acc, ah[kk], wg::sw128_desc(bh + kk * 32));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    wg::fence_regs(ah);
    wg::fence_regs(al);
    float* o = out + form * 64 * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = j * 8 + 2 * qd;
      o[r * N + col] = acc[4 * j];
      o[r * N + col + 1] = acc[4 * j + 1];
      o[(r + 8) * N + col] = acc[4 * j + 2];
      o[(r + 8) * N + col + 1] = acc[4 * j + 3];
    }
  }
}

}  // namespace rt
