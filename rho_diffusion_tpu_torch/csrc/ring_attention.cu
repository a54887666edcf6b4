// Ring attention (K6) for Hopper (sm_90a): a whole ring call in one launch
// per device, bf16 or fp32 in and out, fp32 softmax state in registers.
//
// Replaces the TPU kernel `_kernel` / `ring_attention_rdma` in
// rho_diffusion_tpu/parallel/context_rdma.py:50-189. That kernel keeps a
// rank's K/V shard in a 2-slot VMEM buffer, starts an async remote copy of
// slot `cur` to the right neighbour's slot `nxt`, and folds slot `cur` into
// the rank's running online-softmax state (m, l, acc), kept in f32 VMEM for
// all n steps (:92-107); after n steps it writes acc / l in the input dtype
// (:140-144). At step s rank r holds the shard of rank (r - s) mod n.
//
// This kernel computes the same function without the slots. One launch
// covers every rank that lives on one device: its grid is (query tiles of 64
// rows) x B*H x (ranks on the device). Each block folds the K/V shards of all
// n ranks in the ring's order r, r-1, ..., r-n+1 (mod n), reading each shard
// where it lies: the shard table (passed by value, so it sits in the
// kernel's constant parameter bank; no copy and no allocation per call)
// holds every rank's K and V base pointers; on one card they are strided
// views of the UNet's fused qkv, across cards each points into its own
// card's memory and is read over NVLink (peer access, enabled by
// `ring_attention_enable_peer`). The block keeps its rows' m, l and acc in
// registers across all n shards and writes o once. K/V tiles of 64 keys are
// double-buffered in shared memory with cp.async, so tile i+1 loads while
// tile i is multiplied. The TPU's copies between ranks, its semaphores and
// the state's round trip through memory between steps have no counterpart:
// on the H100 every rank's block can read every shard, so rotating the
// shards would only add traffic.
//
//   s      = (q k^T) * log2(e)/sqrt(D)         fp32 (K6's single 1/sqrt(D)
//                                              scale, :93, :100; base 2)
//   m_new  = max(m, rowmax(s))
//   p      = exp2(s - m_new),  corr = exp2(m - m_new)
//   l      = l * corr + rowsum(p)
//   acc    = acc * corr + p v
//   o      = acc / l                            after the last shard
//
// The state is kept in base-2 units (m of the pre-scaled scores), the same
// function as the TPU kernel's natural-log form; the plain version
// (ops/kernels/ring_attention.py) does the same arithmetic.
//
// Layouts: q and o of each launched rank, and k and v of each shard, are
// [B, rows, H, D] with D contiguous and (batch, token, head) element strides
// shared by all ranks (one stride set each for q, o, k, v), in multiples of
// 16 bytes, at 16-byte aligned addresses. D is a template parameter (16..256,
// a multiple of 16); the caller pads other head dims with zeros. Every shard
// holds S keys; a 64-key tile that runs past S is masked per shard.
//
// bf16 (`ring_attention_bf16_kernel`): four warps own 64 query rows, 16 each:
// S = Q K^T and acc += P V on mma.sync m16n8k16 with fp32 accumulation. q k^T
// is exact in fp32 (bf16 products), as in the TPU kernel's f32 cast; P is
// rounded to bf16 for the P V product (the TPU kernel keeps P in f32), one
// rounding of at most 2^-9 relative, as in the flash forward (K1). fp32
// (`ring_attention_f32_kernel`): fp32 FMAs on the CUDA cores, eight threads to
// a query row, 16 rows and 32-key tiles per block.
//
// What bounds it on the H100. At the flagship's serve shape (bucket 8, n = 4
// ranks: B*H = 32, T = 512, T/n = S = 128, D = 128) a ring call does
// 4*B*H*T*T*D = 4.29 GFLOP: 4.3 us at the 989 TFLOP/s bf16 tensor-core peak,
// 64 us at the 67 TFLOP/s fp32 peak. The function's own bytes (q, k, v read
// once, o written once: 16.8 MB in bf16) take 5.0 us at 3.35 TB/s, so the
// bf16 ring is bound by bytes, at about 5 us. This design reads q once
// (4.2 MB), every shard once per rank (n times: 16.8 MB each for k and v at
// n = 4, mostly from L2) and writes o once (4.2 MB): 41.9 MB, 12.5 us.
// At the 64^3 config's attention (T = 4096, T/n = 1024) the call does 275
// GFLOP, 0.28 ms at the bf16 peak: the operations bound it, and each block
// walks 4096 keys as the flash forward's (K2) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_attention_tf32.cuh"

namespace {

constexpr int MAX_RING = 16;  // ranks of one ring
constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BKV = 64;       // keys per K/V tile
constexpr int THREADS = 128;
constexpr float NEG_BIG = -1e30f;

// Base pointers (as integers): k[j], v[j] of rank j's shard, in rank order;
// q[z], o[z] and rank[z] of the z-th rank of this launch.
struct RingTable {
  long long k[MAX_RING], v[MAX_RING], q[MAX_RING], o[MAX_RING], rank[MAX_RING];
};

// Element strides (batch, token, head) of q, o, k, v.
struct RingStrides {
  long long q[3], o[3], k[3], v[3];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Every group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragment (16 x 8, k-major) of a row-major [k][n] tile in shared memory.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the cp.async copies of K/V tile `it` of this block's fold (shard
// (r - it / tiles) mod n, keys from (it % tiles) * KT) into `ks`, `vs`. Each
// thread copies 16-byte chunks of EL elements; keys past S are zero-filled.
template <typename T, int HD, int KT, int LD>
__device__ __forceinline__ void load_kv_tile(T* ks, T* vs, const RingTable& tab,
                                             const RingStrides& st, int it, int tiles, int r,
                                             int n, int b, int h, int S) {
  constexpr int EL = 16 / sizeof(T);
  constexpr int CH = HD / EL;  // 16-byte chunks per row
  const int s = it / tiles;
  const int kv0 = (it - s * tiles) * KT;
  int j = r - s;
  if (j < 0) j += n;
  const T* kb = reinterpret_cast<const T*>(tab.k[j]) + b * st.k[0] + h * st.k[2];
  const T* vb = reinterpret_cast<const T*>(tab.v[j]) + b * st.v[0] + h * st.v[2];
  for (int c = threadIdx.x; c < KT * CH; c += THREADS) {
    const int row = c / CH, cc = c % CH;
    const bool p = kv0 + row < S;
    cp_async16(&ks[row * LD + cc * EL], p ? kb + (long long)(kv0 + row) * st.k[1] + cc * EL : kb, p);
    cp_async16(&vs[row * LD + cc * EL], p ? vb + (long long)(kv0 + row) * st.v[1] + cc * EL : vb, p);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
ring_attention_bf16_kernel(const __grid_constant__ RingTable tab,
                           const __grid_constant__ RingStrides st, int n, int H, int Tq, int S,
                           float scale_log2) {
  constexpr int LD = HD + 8;  // padded smem row: conflict-free fragment loads
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int ND = HD / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;       // [2][BKV * LD]
  __nv_bfloat16* Vs = Ks + 2 * BKV * LD;  // [2][BKV * LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int z = blockIdx.z;
  const int r = (int)tab.rank[z];
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(tab.q[z]) + b * st.q[0] + h * st.q[2];

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int row = c / CH, cc = c % CH;
    const bool p = q0 + row < Tq;
    cp_async16(&Qs[row * LD + cc * 8], p ? qb + (long long)(q0 + row) * st.q[1] + cc * 8 : qb, p);
  }
  const int tiles = (S + BKV - 1) / BKV;
  const int total = n * tiles;
  load_kv_tile<__nv_bfloat16, HD, BKV, LD>(Ks, Vs, tab, st, 0, tiles, r, n, b, h, S);
  cp_async_commit();  // group 0: Q and tile 0

  // This thread's rows of the state: t0 and t0 + 8; its columns of each n8
  // tile: (lane & 3) * 2 and + 1.
  const int qrow = warp * 16 + (lane >> 2);
  const int t0 = q0 + qrow;
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_i[2] = {NEG_BIG, NEG_BIG};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    __syncthreads();  // tile it - 1, in the other buffer, is fully consumed
    if (it + 1 < total)
      load_kv_tile<__nv_bfloat16, HD, BKV, LD>(Ks + (buf ^ 1) * BKV * LD, Vs + (buf ^ 1) * BKV * LD,
                                               tab, st, it + 1, tiles, r, n, b, h, S);
    cp_async_commit();
    cp_async_wait_prev();  // Q and tile it have landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BKV * LD;
    const __nv_bfloat16* Vt = Vs + buf * BKV * LD;
    const int kv0 = (it % tiles) * BKV;

    // S = Q K^T for this warp's 16 rows x 64 keys, fp32.
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks * 16 + (lane & 3) * 2;
      uint32_t a[4];
      a[0] = lds32(&Qs[qrow * LD + c]);
      a[1] = lds32(&Qs[(qrow + 8) * LD + c]);
      a[2] = lds32(&Qs[qrow * LD + c + 8]);
      a[3] = lds32(&Qs[(qrow + 8) * LD + c + 8]);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const int nn = ni * 8 + (lane >> 2);
        uint32_t bfr[2] = {lds32(&Kt[nn * LD + c]), lds32(&Kt[nn * LD + c + 8])};
        mma_bf16_16816(s[ni], a, bfr);
      }
    }

    // Online softmax in base 2; keys past the shard's S are masked.
    float mx0 = m_i[0], mx1 = m_i[1];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + ni * 8 + (lane & 3) * 2 + (e & 1);
        s[ni][e] = col < S ? s[ni][e] * scale_log2 : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[ni][0], s[ni][1]));
      mx1 = fmaxf(mx1, fmaxf(s[ni][2], s[ni][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float corr0 = exp2f(m_i[0] - mx0);
    const float corr1 = exp2f(m_i[1] - mx1);
    m_i[0] = mx0;
    m_i[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      s[ni][0] = exp2f(s[ni][0] - mx0);
      s[ni][1] = exp2f(s[ni][1] - mx0);
      s[ni][2] = exp2f(s[ni][2] - mx1);
      s[ni][3] = exp2f(s[ni][3] - mx1);
      rs0 += s[ni][0] + s[ni][1];
      rs1 += s[ni][2] + s[ni][3];
    }
    l_i[0] = l_i[0] * corr0 + rs0;
    l_i[1] = l_i[1] * corr1 + rs1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= corr0;
      acc[d][1] *= corr0;
      acc[d][2] *= corr1;
      acc[d][3] *= corr1;
    }

    // acc += P V: two adjacent n8 score tiles form one k16 A fragment.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = &Vt[(kk * 16 + (lane & 15)) * LD];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t vfr[2];
        ldmatrix_x2_trans(vfr, vrow + d * 8);
        mma_bf16_16816(acc[d], pa, vfr);
      }
    }
  }

  float l0 = l_i[0], l1 = l_i[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(tab.o[z]) + b * st.o[0] + h * st.o[2];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    if (t0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)t0 * st.o[1] + col) =
          __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
    if (t0 + 8 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(t0 + 8) * st.o[1] + col) =
          __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

constexpr int F32_BQ = 16;            // query rows per block, 8 threads each
constexpr int F32_BKV = 32;           // keys per K/V tile, 4 per thread
constexpr int F32_PLD = F32_BKV + 8;  // P row: a warp's 4 rows on distinct banks

template <int HD>
__global__ void __launch_bounds__(THREADS)
ring_attention_f32_kernel(const __grid_constant__ RingTable tab,
                          const __grid_constant__ RingStrides st, int n, int H, int Tq, int S,
                          float scale_log2) {
  constexpr int LD = HD + 4;  // 16-byte rows; the 8 keys read together hit 8 bank groups
  constexpr int CH = HD / 4;  // 16-byte chunks per row
  constexpr int KPT = F32_BKV / 8;  // keys scored per thread per tile
  constexpr int DPT = HD / 8;       // state columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BQ * LD;       // [2][F32_BKV * LD]
  float* Vs = Ks + 2 * F32_BKV * LD;  // [2][F32_BKV * LD]
  float* Ps = Vs + 2 * F32_BKV * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // this thread's query row in the tile
  const int sub = tid & 7;   // its place among the row's 8 threads (adjacent lanes)
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int z = blockIdx.z;
  const int r = (int)tab.rank[z];
  const int q0 = blockIdx.x * F32_BQ;
  const int t = q0 + row;
  const float* qb = reinterpret_cast<const float*>(tab.q[z]) + b * st.q[0] + h * st.q[2];

  for (int c = tid; c < F32_BQ * CH; c += THREADS) {
    const int rr = c / CH, cc = c % CH;
    const bool p = q0 + rr < Tq;
    cp_async16(&Qs[rr * LD + cc * 4], p ? qb + (long long)(q0 + rr) * st.q[1] + cc * 4 : qb, p);
  }
  const int tiles = (S + F32_BKV - 1) / F32_BKV;
  const int total = n * tiles;
  load_kv_tile<float, HD, F32_BKV, LD>(Ks, Vs, tab, st, 0, tiles, r, n, b, h, S);
  cp_async_commit();

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m_i = NEG_BIG;  // the row's running max (the same in its 8 threads)
  float l_i = 0.f;      // this thread's share of the row sum

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    __syncthreads();  // tile it - 1 is fully consumed
    if (it + 1 < total)
      load_kv_tile<float, HD, F32_BKV, LD>(Ks + (buf ^ 1) * F32_BKV * LD,
                                           Vs + (buf ^ 1) * F32_BKV * LD, tab, st, it + 1, tiles,
                                           r, n, b, h, S);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* Kt = Ks + buf * F32_BKV * LD;
    const float* Vt = Vs + buf * F32_BKV * LD;
    const int kv0 = (it % tiles) * F32_BKV;

    // Scores of keys sub, sub + 8, ... of this tile against this row.
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[row * LD + c]);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&Kt[(sub + 8 * i) * LD + c]);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mx = m_i;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = kv0 + sub + 8 * i < S ? s[i] * scale_log2 : NEG_BIG;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float corr = exp2f(m_i - mx);
    m_i = mx;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = exp2f(s[i] - mx);
      rs += p;
      Ps[row * F32_PLD + sub + 8 * i] = p;
    }
    l_i = l_i * corr + rs;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
    __syncwarp();  // the row's 8 threads share one warp

#pragma unroll 4
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = Ps[row * F32_PLD + j];
      const float* vr = &Vt[j * LD + sub];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[8 * d], acc[d]);
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  float l = l_i;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (t >= Tq) return;
  const float inv = 1.f / l;
  float* orow = reinterpret_cast<float*>(tab.o[z]) + b * st.o[0] + h * st.o[2] +
                (long long)t * st.o[1] + sub;
#pragma unroll
  for (int d = 0; d < DPT; ++d) orow[8 * d] = acc[d] * inv;
}

template <int HD>
int launch_bf16(const RingTable& tab, const RingStrides& st, int n, int R, int B, int H, int Tq,
                int S, float scale_log2, void* stream) {
  const int smem = (BQ + 4 * BKV) * (HD + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(ring_attention_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)(B * H), (unsigned)R);
  ring_attention_bf16_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tab, st, n, H, Tq, S, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const RingTable& tab, const RingStrides& st, int n, int R, int B, int H, int Tq,
               int S, float scale_log2, void* stream) {
  const int smem = ((F32_BQ + 4 * F32_BKV) * (HD + 4) + F32_BQ * F32_PLD) * 4;
  cudaError_t err = cudaFuncSetAttribute(ring_attention_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + F32_BQ - 1) / F32_BQ), (unsigned)(B * H), (unsigned)R);
  ring_attention_f32_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tab, st, n, H, Tq, S, scale_log2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tf32 route (ring_attention_tf32.cuh): 3xTF32 on wgmma for fp32

// The launchers' own error codes (CUDA's are positive).
constexpr int ERR_PLAN = -1;       // a shape the tf32 route does not take
constexpr int ERR_ENCODE_FN = -2;  // cuTensorMapEncodeTiled not found
constexpr int ERR_MAP = -3;        // cuTensorMapEncodeTiled refused a tensor map

// The problem of one tf32 launch (S8 = S rounded up to 8, as the pre-pass lays out shards).
rt::Tf32Problem tf32_problem(const RingTable& tab, const RingStrides& st, int n, int R, int B,
                             int H, int Tq, int S, float scale_log2) {
  rt::Tf32Problem p;
  p.H = H, p.Tq = Tq, p.BH = B * H, p.shards = n, p.S = S, p.S8 = (S + 7) / 8 * 8;
  p.tiles_per_shard = (S + rt::BN - 1) / rt::BN;
  for (int z = 0; z < R; ++z) {
    p.q[z] = reinterpret_cast<const float*>(tab.q[z]);
    p.o[z] = reinterpret_cast<float*>(tab.o[z]);
    p.rank[z] = (int)tab.rank[z];
  }
  p.q_sb = st.q[0], p.q_st = st.q[1], p.q_sh = st.q[2];
  p.o_sb = st.o[0], p.o_st = st.o[1], p.o_sh = st.o[2];
  p.scale_log2 = scale_log2;
  p.lse = nullptr;  // the ring writes no log-sum-exp
  return p;
}

template <int HD>
int launch_tf32_split(const RingTable& tab, const RingStrides& st, const rt::Tf32Problem& p,
                      void* ks, void* vts, cudaStream_t stream) {
  rt::Tf32Shards src;
  for (int j = 0; j < p.shards; ++j) {
    src.k[j] = reinterpret_cast<const float*>(tab.k[j]);
    src.v[j] = reinterpret_cast<const float*>(tab.v[j]);
  }
  src.k_sb = st.k[0], src.k_st = st.k[1], src.k_sh = st.k[2];
  src.v_sb = st.v[0], src.v_st = st.v[1], src.v_sh = st.v[2];
  rt::kv_split_kernel<HD><<<dim3((p.S8 + rt::SPLIT_KEYS - 1) / rt::SPLIT_KEYS, p.BH, p.shards),
                            256, 0, stream>>>(src, (float*)ks, (float*)vts, p.H, p.S, p.S8, p.BH,
                                              p.shards);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tf32(const rt::Tf32Problem& p, int R, const void* ks, const void* vts,
                cudaStream_t stream) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  const unsigned long long keys = (unsigned long long)p.shards * p.S8;
  CUtensorMap k_map, v_map;
  if (!wg::encode_f32_3d(encode, &k_map, ks, HD, keys, 2ull * p.BH, rt::BN) ||
      !wg::encode_f32_3d(encode, &v_map, vts, keys, HD, 2ull * p.BH, HD))
    return ERR_MAP;
  constexpr int smem = rt::smem_bytes(HD);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  auto kernel = rt::ring_attention_tf32_kernel<HD>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)((p.Tq + rt::BM - 1) / rt::BM), (unsigned)p.BH, (unsigned)R),
           rt::THREADS, smem, stream>>>(k_map, v_map, p);
  return (int)cudaGetLastError();
}

// The tf32 route's checks: fp32 at D = 64 or 128, 4-byte aligned shards
// and 16-byte aligned scratch; the fold also 4-byte aligned q and 8-byte
// aligned o with even strides.
bool split_ok(const RingTable& tab, int n, int B, int H, int S, int D, const void* ks,
              const void* vts) {
  bool ok = (D == 64 || D == 128) && B >= 1 && H >= 1 && S >= 1 && (long long)B * H <= 65535 &&
            ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vts)) & 15) == 0;
  for (int j = 0; j < n; ++j) ok = ok && ((tab.k[j] | tab.v[j]) & 3) == 0;
  return ok;
}

bool fold_ok(const RingTable& tab, const RingStrides& st, int R, int Tq) {
  bool ok = Tq >= 1;
  for (int i = 0; i < 3; ++i) ok = ok && st.o[i] % 2 == 0;
  for (int z = 0; z < R; ++z) ok = ok && (tab.o[z] & 7) == 0 && (tab.q[z] & 3) == 0;
  return ok;
}

template <int N>
int launch_tf32_probe(const void* a, const void* b, void* out, cudaStream_t stream) {
  constexpr int smem = 4 * N * 128 + 1024;
  static unsigned long long ready = 0;
  auto kernel = rt::tf32_probe_kernel<N>;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, stream>>>((const float*)a, (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}

// table: 5 * MAX_RING values laid out as RingTable; strides: 12 values as RingStrides.
bool unpack(const long long* table, const long long* strides, int n, int R, RingTable* tab,
            RingStrides* st) {
  if (n < 1 || n > MAX_RING || R < 1 || R > MAX_RING) return false;
  const long long* src = table;
  for (long long* dst : {tab->k, tab->v, tab->q, tab->o, tab->rank}) {
    for (int i = 0; i < MAX_RING; ++i) dst[i] = src[i];
    src += MAX_RING;
  }
  for (int i = 0; i < 3; ++i) {
    st->q[i] = strides[i];
    st->o[i] = strides[3 + i];
    st->k[i] = strides[6 + i];
    st->v[i] = strides[9 + i];
  }
  return true;
}

}  // namespace

extern "C" {

// One launch on `stream` over R ranks of a ring of n; see RingTable.
int ring_attention_bf16(const long long* table, const long long* strides, int n, int R, int B,
                        int H, int Tq, int S, int D, float scale_log2, void* stream) {
  RingTable tab;
  RingStrides st;
  if (!unpack(table, strides, n, R, &tab, &st)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_bf16<16>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 32: return launch_bf16<32>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 64: return launch_bf16<64>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 128: return launch_bf16<128>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 256: return launch_bf16<256>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ring_attention_f32(const long long* table, const long long* strides, int n, int R, int B,
                       int H, int Tq, int S, int D, float scale_log2, void* stream) {
  RingTable tab;
  RingStrides st;
  if (!unpack(table, strides, n, R, &tab, &st)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_f32<16>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 32: return launch_f32<32>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 64: return launch_f32<64>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 128: return launch_f32<128>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    case 256: return launch_f32<256>(tab, st, n, R, B, H, Tq, S, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tf32 route, two launches on `stream`. ring_attention_tf32_split
// writes every shard's K and V^T tf32 terms into ks and vts: fp32 scratch of
// 2 * B*H * n*S8 * D elements each (S8 = S rounded up to 8) on the launch's
// device, 16-byte aligned, any contents; ring_attention_tf32 then folds them
// into the R ranks' rows (the split reads no q or o). Both take the table
// and strides as above, fp32 at D = 64 or 128, and return ERR_PLAN for a
// shape they do not take.
int ring_attention_tf32_split(const long long* table, const long long* strides, int n, int R,
                              int B, int H, int Tq, int S, int D, void* ks, void* vts,
                              void* stream) {
  RingTable tab;
  RingStrides st;
  if (!unpack(table, strides, n, R, &tab, &st)) return (int)cudaErrorInvalidValue;
  if (!split_ok(tab, n, B, H, S, D, ks, vts)) return ERR_PLAN;
  const rt::Tf32Problem p = tf32_problem(tab, st, n, R, B, H, Tq, S, 0.f);
  cudaStream_t s = (cudaStream_t)stream;
  return D == 128 ? launch_tf32_split<128>(tab, st, p, ks, vts, s)
                  : launch_tf32_split<64>(tab, st, p, ks, vts, s);
}

int ring_attention_tf32(const long long* table, const long long* strides, int n, int R, int B,
                        int H, int Tq, int S, int D, float scale_log2, const void* ks,
                        const void* vts, void* stream) {
  RingTable tab;
  RingStrides st;
  if (!unpack(table, strides, n, R, &tab, &st)) return (int)cudaErrorInvalidValue;
  if (!split_ok(tab, n, B, H, S, D, ks, vts) || !fold_ok(tab, st, R, Tq)) return ERR_PLAN;
  const rt::Tf32Problem p = tf32_problem(tab, st, n, R, B, H, Tq, S, scale_log2);
  cudaStream_t s = (cudaStream_t)stream;
  return D == 128 ? launch_tf32<128>(p, R, ks, vts, s) : launch_tf32<64>(p, R, ks, vts, s);
}

// The tf32 route's products alone (ring_attention_tf32.cuh's
// tf32_probe_kernel): out [2, 64, n] fp32 = a [64, 32] times b [n, 32]^T,
// all fp32 contiguous, n 32 or 128. A test of the operand layouts.
int tf32_probe(const void* a, const void* b, void* out, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 32) return launch_tf32_probe<32>(a, b, out, s);
  if (n == 128) return launch_tf32_probe<128>(a, b, out, s);
  return ERR_PLAN;
}

// Let `device` read `peer`'s memory (once per pair; an already enabled pair
// is not an error). Restores the calling thread's current device.
int ring_attention_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it, or the next launch's check would report it
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}

const char* ring_attention_error_string(int code) {
  switch (code) {
    case ERR_PLAN: return "the tf32 launcher refused the shape";
    case ERR_ENCODE_FN: return "cuTensorMapEncodeTiled could not be found in libcuda";
    case ERR_MAP: return "cuTensorMapEncodeTiled refused a tensor map of the split K or V";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
