// Flash attention backward (non-causal) for Hopper (sm_90a), bf16 or fp32 in
// and out (the gradients in the input dtype).
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel` (K4) of
// rho_diffusion_tpu/ops/pallas/flash_attention.py:209-301, launched by
// `_flash_backward` (:304-359). P is recomputed from the forward's
// log-sum-exp instead of being stored:
//   P   = exp(S - lse),  S = Q K^T / sqrt(D)   (keys past Tk masked out)
//   dV  = P^T dO
//   dP  = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dK  = dS^T Q / sqrt(D)
//   dQ  = dS K / sqrt(D)
// The TPU path leaves delta to XLA (:308-311); here the small and long
// routes compute it in their one kernel, the fused route and the bf16 pair
// take it from a
// pre-pass kernel (flash_attention_bwd_delta) and the fp32 pairs from a
// PyTorch expression, all but the small route's computed by the caller. lse
// is the forward's base-2 log-sum-exp of the scaled scores
// (flash_attention.cu), so P = exp2(S * log2(e) - lse2).
//
// Six routes, chosen by the caller (ops/kernels/flash_attention.py
// `flash_bwd_plan`) by head dim, dtype and, at D = 16 and 32, T; never by
// a failure:
//
//   flash_attention_bwd_small      bf16, D = 16 or 32 with Tq, Tk <= 64 (the
//     ViT's attention: 16 heads of width 16 over 64 patches): ONE kernel a
//     backward, one warpgroup a batch*head, delta inside, all five products
//     on wgmma, in flash_attention_bwd_small.cuh (its header says what
//     bounds it and what its design does about that).
//   flash_attention_bwd_long       bf16, D = 16 or 32 past 64 keys or
//     queries (the ViT at patch 4: 512 patches): ONE kernel a backward,
//     `groups` blocks a batch*head taking its chunks of 128 keys in turn,
//     Q, dO and O streamed, delta inside, all five products on wgmma, dQ
//     summed across chunks in a fixed order, in flash_attention_bwd_long.cuh
//     (its header says what bounds it and what its design does about
//     that). The caller picks groups, allocates the blocks' fp32 slots of
//     dQ (linear in Tq) and zeroes the counters of the blocks that have
//     finished.
//   flash_attention_bwd_wgmma      bf16, D = 64 or 128 (the UNet's 128): ONE
//     fused kernel for both TPU kernels, in flash_attention_bwd_wgmma.cuh
//     (TMA ring, wgmma for all five products, dQ added across key tiles in a
//     fixed order; its header says what bounds it and what its design does
//     about that). The plan's keys a block come from the caller and are
//     checked here (one instance per head dim: 64 keys at D = 64, 128 at
//     D = 128); the tensor maps are encoded per call. The caller allocates the fp32 dQ accumulator and zeroes the
//     counters that order its additions.
//   flash_attention_bwd_delta      the fused route's and the bf16 pair's
//     pre-pass: delta in fp32 (32 lanes a query row at D >= 64, 8 or 16 at
//     D = 16 or 32; the PyTorch expression is five kernels).
//   flash_attention_bwd_{dkv,dq}_bf16   bf16, D = 256 (at 16, 32, 64 and
//     128 only when a plan asks for them: the old side of the
//     old-against-new comparisons): the mma.sync pair below.
//   flash_attention_bwd_tf32_{split,dkv,dq}   fp32, D = 64 or 128 (the
//     UNet's 128): a pair of kernels whose every product is three TF32
//     products on wgmma (3xTF32), after a pre-pass that writes the tf32
//     terms of q, dout, k and v, in flash_attention_bwd_tf32.cuh (its
//     header says what bounds it and what its design does about that).
//     The caller allocates the split terms and computes delta.
//   flash_attention_bwd_{dkv,dq}_f32    fp32, D = 16, 32 or 256 (at 64 and
//     128 only when a plan asks for them, as the bf16 pair): below.
//
// The pair:
// * dkv: one block per (batch*head, 64-key tile). Each of the 4 warps owns 16
//   keys; the K and V tile stays in shared memory while the block sweeps all
//   query tiles (64 rows, 32 at head dims >= 128 to bound the registers), and
//   dK, dV accumulate in fp32 registers.
// * dq: one block per (batch*head, 64-query tile). Each warp owns 16 queries;
//   Q and dO stay in shared memory while the block sweeps the 64-key K/V tiles,
//   and dQ accumulates in fp32 registers.
// No route adds in arrival order: every gradient element is summed in a
// fixed order (the fused kernel's dQ through its counters), so the gradients
// are bitwise the same from run to run. Query rows past Tq get lse = +inf, so
// their P is exactly 0 and they add nothing; key rows past Tk are masked to
// P = 0 as the TPU kernels mask them to -inf (:233-234, :284-285).
//
// Numerics (bf16): S, P, dP and dS are fp32, as in the TPU kernels. The
// products run on the tensor cores (fp32 accumulation), so P and dS are
// rounded to bf16 before P^T dO, dS^T Q and dS K; the TPU kernels keep those
// products in fp32 (:224, :238-254, :293-297). That is FlashAttention-2's
// choice: each rounding is a relative error of at most 2^-9 per term, and the
// gradients are rounded to bf16 at the end as in JAX. The fp32 instances
// (`*_f32_kernel`) do every product in fp32 FMAs on the CUDA cores (no TF32),
// in the same order of operations.
//
// What bounds the pair on the H100: dkv does 4 products of 2*T*T*D flops per
// batch*head (S^T, dP^T, dV, dK) and dq 3 (S, dP, dQ), against ~16*T*D bytes
// of inputs and outputs, so at the UNet's shapes (T = 512, D = 128) both are
// bound by tensor-core operations once the T x T matrices stay on chip. The
// split recomputes S and dP in both kernels: 7 products where the fused
// kernel does 5.
//
// Layout: q, k, v, dout, dq, dk, dv are [B, T, H, D] with D contiguous and any
// B, T, H strides (multiples of 16 bytes), so the UNet's strided q/k/v views
// are read in place. lse and delta are fp32 [B, H, Tq], contiguous. D is a
// template parameter (16..256, multiple of 16); the wrapper pads other dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd_long.cuh"
#include "flash_attention_bwd_small.cuh"
#include "flash_attention_bwd_tf32.cuh"
#include "flash_attention_bwd_wgmma.cuh"
#include "tma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BKV = 64;  // keys per tile (dkv: per block; dq: per sweep step)
constexpr int BQ = 64;   // query rows per block (dq)

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  int H, Tq, Tk;
  float scale;       // 1/sqrt(D) of the true head dim
  float scale_log2;  // scale * log2(e)
  // (batch, token, head) element strides of q, k, v, dout, dq, dk, dv in turn
  long long st[21];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// Copy `rows` rows of a [T, D] slice (row stride `ld_g` elements) starting at
// token t0 into a padded shared tile; rows past `limit` are zero-filled.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld_g, int t0, int rows,
                                          int limit) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = HD / PER;
  for (int c = threadIdx.x; c < rows * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool p = t0 + r < limit;
    cp_async16(&dst[r * LD + cc * PER], p ? src + (t0 + r) * ld_g + cc * PER : src, p);
  }
}

// A fragment (16 x 16) of rows r0 and r0 + 8 at column c of a padded bf16 tile.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int ld, int r0,
                                       int c) {
  a[0] = lds32(&tile[r0 * ld + c]);
  a[1] = lds32(&tile[(r0 + 8) * ld + c]);
  a[2] = lds32(&tile[r0 * ld + c + 8]);
  a[3] = lds32(&tile[(r0 + 8) * ld + c + 8]);
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_bf16_kernel(const BwdArgs<__nv_bfloat16> a) {
  constexpr int LD = HD + 8;  // padded smem row: conflict-free fragment loads
  constexpr int ND = HD / 8;  // n8 tiles of dK and dV
  constexpr int BQB = HD >= 128 ? 32 : 64;  // query columns per sweep step
  constexpr int NQ = BQB / 8;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* Os = Qs + BQB * LD;  // dO
  float* lse_s = reinterpret_cast<float*>(Os + BQB * LD);
  float* dlt_s = lse_s + BQB;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kv0 = blockIdx.x * BKV;
  const long long* st = a.st;
  const bf16* qb = a.q + b * st[0] + h * st[2];
  const bf16* kb = a.k + b * st[3] + h * st[5];
  const bf16* vb = a.v + b * st[6] + h * st[8];
  const bf16* ob = a.dout + b * st[9] + h * st[11];
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* dltb = a.delta + (long long)bh * a.Tq;

  load_rows<bf16, HD, LD>(Ks, kb, st[4], kv0, BKV, a.Tk);
  load_rows<bf16, HD, LD>(Vs, vb, st[7], kv0, BKV, a.Tk);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  const int krow = warp * 16 + (lane >> 2);  // this thread's key rows: krow, krow + 8
  const bool kin0 = kv0 + krow < a.Tk;
  const bool kin1 = kv0 + krow + 8 < a.Tk;

  for (int q0 = 0; q0 < a.Tq; q0 += BQB) {
    __syncthreads();  // the previous query tile is fully consumed
    load_rows<bf16, HD, LD>(Qs, qb, st[1], q0, BQB, a.Tq);
    load_rows<bf16, HD, LD>(Os, ob, st[10], q0, BQB, a.Tq);
    cp_async_commit();
    if (tid < BQB) {
      const int t = q0 + tid;
      lse_s[tid] = t < a.Tq ? lseb[t] : INFINITY;  // P = 0 for padded query rows
      dlt_s[tid] = t < a.Tq ? dltb[t] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQB queries.
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int ni = 0; ni < NQ; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks * 16 + (lane & 3) * 2;
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, krow, c);
      load_a(va, Vs, LD, krow, c);
#pragma unroll
      for (int ni = 0; ni < NQ; ++ni) {
        const int n = ni * 8 + (lane >> 2);
        uint32_t qf[2] = {lds32(&Qs[n * LD + c]), lds32(&Qs[n * LD + c + 8])};
        uint32_t of[2] = {lds32(&Os[n * LD + c]), lds32(&Os[n * LD + c + 8])};
        mma_bf16_16816(s[ni], ka, qf);
        mma_bf16_16816(dp[ni], va, of);
      }
    }

    // P^T (into s) and dS^T (into dp), fp32.
#pragma unroll
    for (int ni = 0; ni < NQ; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + (lane & 3) * 2 + (e & 1);
        const bool kin = e < 2 ? kin0 : kin1;
        const float p = kin ? exp2f(s[ni][e] * a.scale_log2 - lse_s[col]) : 0.f;
        s[ni][e] = p;
        dp[ni][e] = p * (dp[ni][e] - dlt_s[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: two adjacent n8 score tiles form one
    // k16 A fragment; dO and Q are the k-major B operands.
#pragma unroll
    for (int kk = 0; kk < BQB / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const bf16* orow = &Os[(kk * 16 + (lane & 15)) * LD];
      const bf16* qrow = &Qs[(kk * 16 + (lane & 15)) * LD];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t f[2];
        ldmatrix_x2_trans(f, orow + d * 8);
        mma_bf16_16816(dv_acc[d], pa, f);
        ldmatrix_x2_trans(f, qrow + d * 8);
        mma_bf16_16816(dk_acc[d], sa, f);
      }
    }
  }

  bf16* dkb = a.dk + b * st[15] + h * st[17];
  bf16* dvb = a.dv + b * st[18] + h * st[20];
  const int t0 = kv0 + krow;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    if (kin0) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + t0 * st[16] + col) =
          __floats2bfloat162_rn(dk_acc[d][0] * a.scale, dk_acc[d][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + t0 * st[19] + col) =
          __floats2bfloat162_rn(dv_acc[d][0], dv_acc[d][1]);
    }
    if (kin1) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (t0 + 8) * st[16] + col) =
          __floats2bfloat162_rn(dk_acc[d][2] * a.scale, dk_acc[d][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (t0 + 8) * st[19] + col) =
          __floats2bfloat162_rn(dv_acc[d][2], dv_acc[d][3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_bf16_kernel(const BwdArgs<__nv_bfloat16> a) {
  constexpr int LD = HD + 8;
  constexpr int ND = HD / 8;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQ * LD;  // dO
  bf16* Ks = Os + BQ * LD;
  bf16* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const long long* st = a.st;
  const bf16* qb = a.q + b * st[0] + h * st[2];
  const bf16* kb = a.k + b * st[3] + h * st[5];
  const bf16* vb = a.v + b * st[6] + h * st[8];
  const bf16* ob = a.dout + b * st[9] + h * st[11];

  load_rows<bf16, HD, LD>(Qs, qb, st[1], q0, BQ, a.Tq);
  load_rows<bf16, HD, LD>(Os, ob, st[10], q0, BQ, a.Tq);
  cp_async_commit();

  const int qrow = warp * 16 + (lane >> 2);  // this thread's query rows: qrow, qrow + 8
  const long long lrow = (long long)bh * a.Tq + q0 + qrow;
  const bool qin0 = q0 + qrow < a.Tq, qin1 = q0 + qrow + 8 < a.Tq;
  const float lse0 = qin0 ? a.lse[lrow] : INFINITY, lse1 = qin1 ? a.lse[lrow + 8] : INFINITY;
  const float dl0 = qin0 ? a.delta[lrow] : 0.f, dl1 = qin1 ? a.delta[lrow + 8] : 0.f;

  float dq_acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[d][e] = 0.f;

  for (int kv0 = 0; kv0 < a.Tk; kv0 += BKV) {
    __syncthreads();  // the previous K/V tile is fully consumed
    load_rows<bf16, HD, LD>(Ks, kb, st[4], kv0, BKV, a.Tk);
    load_rows<bf16, HD, LD>(Vs, vb, st[7], kv0, BKV, a.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks * 16 + (lane & 3) * 2;
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, LD, qrow, c);
      load_a(oa, Os, LD, qrow, c);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const int n = ni * 8 + (lane >> 2);
        uint32_t kf[2] = {lds32(&Ks[n * LD + c]), lds32(&Ks[n * LD + c + 8])};
        uint32_t vf[2] = {lds32(&Vs[n * LD + c]), lds32(&Vs[n * LD + c + 8])};
        mma_bf16_16816(s[ni], qa, kf);
        mma_bf16_16816(dp[ni], oa, vf);
      }
    }

    // dS = P * (dP - delta), fp32 (into s).
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + ni * 8 + (lane & 3) * 2 + (e & 1);
        const float p = col < a.Tk ? exp2f(s[ni][e] * a.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[ni][e] = p * (dp[ni][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K: K is the k-major B operand.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* krow = &Ks[(kk * 16 + (lane & 15)) * LD];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t f[2];
        ldmatrix_x2_trans(f, krow + d * 8);
        mma_bf16_16816(dq_acc[d], sa, f);
      }
    }
  }

  bf16* dqb = a.dq + b * st[12] + h * st[14];
  const int t0 = q0 + qrow;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    if (qin0)
      *reinterpret_cast<__nv_bfloat162*>(dqb + t0 * st[13] + col) =
          __floats2bfloat162_rn(dq_acc[d][0] * a.scale, dq_acc[d][1] * a.scale);
    if (qin1)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (t0 + 8) * st[13] + col) =
          __floats2bfloat162_rn(dq_acc[d][2] * a.scale, dq_acc[d][3] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// fp32, CUDA-core FMAs (no TF32). Eight adjacent lanes own one key (dkv) or
// one query row (dq); lane `sub` of the eight owns columns sub + 8 i, so the
// eight lanes of a row read eight consecutive words of a shared row, and the
// row's dot products are finished by three shuffles within the eight.
// ---------------------------------------------------------------------------

constexpr int F32_ROWS = 16;  // keys (dkv) or query rows (dq) per block
constexpr int F32_TILE = 64;  // rows of the swept operand staged per step

__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32_kernel(const BwdArgs<float> a) {
  constexpr int LD = HD + 4;  // 16-byte rows
  constexpr int CPT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + F32_TILE * LD;  // dO
  float* lse_s = Os + F32_TILE * LD;
  float* dlt_s = lse_s + F32_TILE;

  const int tid = threadIdx.x;
  const int row = tid >> 3, sub = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int key = blockIdx.x * F32_ROWS + row;
  const bool kin = key < a.Tk;
  const long long* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[2];
  const float* ob = a.dout + b * st[9] + h * st[11];
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* dltb = a.delta + (long long)bh * a.Tq;

  float kr[CPT], vr[CPT], dk[CPT], dv[CPT];
  const float* krow = a.k + b * st[3] + h * st[5] + (kin ? key : 0) * st[4];
  const float* vrow = a.v + b * st[6] + h * st[8] + (kin ? key : 0) * st[7];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    kr[i] = kin ? krow[sub + 8 * i] : 0.f;
    vr[i] = kin ? vrow[sub + 8 * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  for (int q0 = 0; q0 < a.Tq; q0 += F32_TILE) {
    __syncthreads();
    load_rows<float, HD, LD>(Qs, qb, st[1], q0, F32_TILE, a.Tq);
    load_rows<float, HD, LD>(Os, ob, st[10], q0, F32_TILE, a.Tq);
    cp_async_commit();
    if (tid < F32_TILE) {
      const int t = q0 + tid;
      lse_s[tid] = t < a.Tq ? lseb[t] : INFINITY;
      dlt_s[tid] = t < a.Tq ? dltb[t] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    const int nq = min(F32_TILE, a.Tq - q0);
    for (int j = 0; j < nq; ++j) {
      const float* qj = &Qs[j * LD + sub];
      const float* oj = &Os[j * LD + sub];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        s = fmaf(kr[i], qj[8 * i], s);
        dpv = fmaf(vr[i], oj[8 * i], dpv);
      }
      s = sum8(s);
      dpv = sum8(dpv);
      const float p = kin ? exp2f(s * a.scale_log2 - lse_s[j]) : 0.f;
      const float ds = p * (dpv - dlt_s[j]);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        dv[i] = fmaf(p, oj[8 * i], dv[i]);
        dk[i] = fmaf(ds, qj[8 * i], dk[i]);
      }
    }
  }
  if (kin) {
    float* dkr = a.dk + b * st[15] + h * st[17] + key * st[16] + sub;
    float* dvr = a.dv + b * st[18] + h * st[20] + key * st[19] + sub;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dkr[8 * i] = dk[i] * a.scale;
      dvr[8 * i] = dv[i];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(const BwdArgs<float> a) {
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + F32_TILE * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 3, sub = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = blockIdx.x * F32_ROWS + row;
  const bool tin = t < a.Tq;
  const long long* st = a.st;
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
  const float* qrow = a.q + b * st[0] + h * st[2] + (tin ? t : 0) * st[1];
  const float* orow = a.dout + b * st[9] + h * st[11] + (tin ? t : 0) * st[10];
  const float lse = tin ? a.lse[(long long)bh * a.Tq + t] : INFINITY;
  const float dl = tin ? a.delta[(long long)bh * a.Tq + t] : 0.f;

  float qr[CPT], orr[CPT], dq[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    qr[i] = tin ? qrow[sub + 8 * i] : 0.f;
    orr[i] = tin ? orow[sub + 8 * i] : 0.f;
    dq[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < a.Tk; kv0 += F32_TILE) {
    __syncthreads();
    load_rows<float, HD, LD>(Ks, kb, st[4], kv0, F32_TILE, a.Tk);
    load_rows<float, HD, LD>(Vs, vb, st[7], kv0, F32_TILE, a.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int nk = min(F32_TILE, a.Tk - kv0);  // keys past Tk never enter
    for (int j = 0; j < nk; ++j) {
      const float* kj = &Ks[j * LD + sub];
      const float* vj = &Vs[j * LD + sub];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        s = fmaf(qr[i], kj[8 * i], s);
        dpv = fmaf(orr[i], vj[8 * i], dpv);
      }
      s = sum8(s);
      dpv = sum8(dpv);
      const float ds = exp2f(s * a.scale_log2 - lse) * (dpv - dl);
#pragma unroll
      for (int i = 0; i < CPT; ++i) dq[i] = fmaf(ds, kj[8 * i], dq[i]);
    }
  }
  if (tin) {
    float* dqr = a.dq + b * st[12] + h * st[14] + t * st[13] + sub;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dqr[8 * i] = dq[i] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
BwdArgs<T> make_args(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* dk, void* dv, int H,
                     int Tq, int Tk, const long long* strides, float scale, float scale_log2) {
  BwdArgs<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.dout = (const T*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = (T*)dq;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.scale = scale;
  a.scale_log2 = scale_log2;
  for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
  return a;
}

// `ready`: the calling instance's own set of devices where the kernel's
// shared-memory limit is already set (tma.cuh, smem_attribute_once).
template <typename Kernel, typename Args>
int run(Kernel kernel, const Args& a, int smem, dim3 grid, void* stream,
        unsigned long long* ready) {
  cudaError_t err = wg::smem_attribute_once(kernel, smem, ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_bf16(const BwdArgs<__nv_bfloat16>& a, int BH, void* stream) {
  constexpr int BQB = HD >= 128 ? 32 : 64;
  const int smem = (2 * BKV + 2 * BQB) * (HD + 8) * 2 + 2 * BQB * 4;
  static unsigned long long ready = 0;
  return run(flash_bwd_dkv_bf16_kernel<HD>, a, smem, dim3((a.Tk + BKV - 1) / BKV, BH), stream, &ready);
}

template <int HD>
int dq_bf16(const BwdArgs<__nv_bfloat16>& a, int BH, void* stream) {
  const int smem = (2 * BQ + 2 * BKV) * (HD + 8) * 2;
  static unsigned long long ready = 0;
  return run(flash_bwd_dq_bf16_kernel<HD>, a, smem, dim3((a.Tq + BQ - 1) / BQ, BH), stream, &ready);
}

template <int HD>
int dkv_f32(const BwdArgs<float>& a, int BH, void* stream) {
  const int smem = (2 * F32_TILE * (HD + 4) + 2 * F32_TILE) * 4;
  static unsigned long long ready = 0;
  return run(flash_bwd_dkv_f32_kernel<HD>, a, smem,
             dim3((a.Tk + F32_ROWS - 1) / F32_ROWS, BH), stream, &ready);
}

template <int HD>
int dq_f32(const BwdArgs<float>& a, int BH, void* stream) {
  const int smem = 2 * F32_TILE * (HD + 4) * 4;
  static unsigned long long ready = 0;
  return run(flash_bwd_dq_f32_kernel<HD>, a, smem,
             dim3((a.Tq + F32_ROWS - 1) / F32_ROWS, BH), stream, &ready);
}

#define DISPATCH_D(FN, ARGS)                                   \
  switch (D) {                                                 \
    case 16: return FN<16>(ARGS, B * H, stream);               \
    case 32: return FN<32>(ARGS, B * H, stream);               \
    case 64: return FN<64>(ARGS, B * H, stream);               \
    case 128: return FN<128>(ARGS, B * H, stream);             \
    case 256: return FN<256>(ARGS, B * H, stream);             \
    default: return (int)cudaErrorInvalidValue;                \
  }

// ---------------------------------------------------------------------------
// The wgmma route (flash_attention_bwd_wgmma.cuh)

// The launcher's own error codes.
constexpr int ERR_PLAN = -1;       // a plan or shape the fused kernel does not take
constexpr int ERR_ENCODE_FN = -2;  // cuTensorMapEncodeTiled not found
constexpr int ERR_MAP = -3;        // cuTensorMapEncodeTiled refused a tensor map

// The plans flash_bwd_plan returns: HD keys a block, one consumer
// warpgroup per 64 of them.
template <int HD>
int launch_wgmma(const CUtensorMap (&maps)[4], const fab::BwdProblem& p, int BH,
                 cudaStream_t stream) {
  constexpr int smem = fab::smem_bytes(HD);
  static_assert(smem <= wg::SMEM_LIMIT, "the tiles do not fit in shared memory");
  auto kernel = fab::flash_bwd_wgmma_kernel<HD>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  // (batch*head) fastest: every head's key tile j launches before key tile j + 1
  kernel<<<dim3((unsigned)BH, (unsigned)p.kv_tiles), 2 * HD, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The small route (flash_attention_bwd_small.cuh)

template <int HD>
int launch_small(const fbs::SmallProblem& p, cudaStream_t stream) {
  static_assert(fbs::SMEM <= wg::SMEM_LIMIT, "the tiles do not fit in shared memory");
  auto kernel = fbs::flash_bwd_small_kernel<HD>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, fbs::SMEM, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((p.BH + fbs::WGS - 1) / fbs::WGS), fbs::WGS * 128, fbs::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The long route (flash_attention_bwd_long.cuh): the blocks of a
// batch*head are neighbours in the grid.

template <int HD>
int launch_long(const fbl::LongProblem& p, long long BH, cudaStream_t stream) {
  constexpr int smem = fbl::smem_bytes(HD);
  static_assert(smem <= wg::SMEM_LIMIT, "the tiles do not fit in shared memory");
  auto kernel = fbl::flash_bwd_long_kernel<HD>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(BH * p.groups), fbl::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The delta pre-pass's instances: 32 lanes a row at D >= 64, else D / 2
// (two channels a lane), 256 threads a block.
template <int HD>
int launch_delta(const void* o, const void* dout, void* delta, int H, int Tq, long long rows,
                 const long long* st, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + fab::DeltaShape<HD>::ROWS - 1) / fab::DeltaShape<HD>::ROWS));
  fab::flash_bwd_delta_kernel<HD><<<grid, 256, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta, H, Tq, rows, st[0],
      st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tf32 route (flash_attention_bwd_tf32.cuh): 3xTF32 on wgmma for fp32

template <int HD>
int launch_tf32_split(const fbt::SplitSrc& src, int BH, int H, int Tq, int Tk,
                      cudaStream_t stream) {
  const int rows = Tq > Tk ? Tq : Tk;
  fbt::flash_bwd_tf32_split_kernel<HD>
      <<<dim3((rows + fbt::SPLIT_ROWS - 1) / fbt::SPLIT_ROWS, BH, 4), 256, 0, stream>>>(
          src, H, Tq, Tk, BH);
  return (int)cudaGetLastError();
}

// One kernel of the pair: dkv reads the split Q and dO by TMA (a [2][B*H][Tq]
// [D] each), dq the split K and V ([2][B*H][Tk][D] each).
template <int HD, bool DKV>
int launch_tf32(const fbt::BwdTf32Problem& p, const float* b0, const float* b1,
                cudaStream_t stream) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  CUtensorMap m0, m1;
  if (!wg::encode_f32_3d(encode, &m0, b0, HD, p.cols, 2ull * p.BH, fbt::BN) ||
      !wg::encode_f32_3d(encode, &m1, b1, HD, p.cols, 2ull * p.BH, fbt::BN))
    return ERR_MAP;
  constexpr int smem = fbt::smem_bytes(HD, DKV);
  static_assert(smem <= wg::SMEM_LIMIT, "the tiles do not fit in shared memory");
  auto kernel = DKV ? fbt::flash_bwd_tf32_dkv_kernel<HD> : fbt::flash_bwd_tf32_dq_kernel<HD>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)((p.rows + fbt::ROWS - 1) / fbt::ROWS), (unsigned)p.BH), fbt::THREADS,
           smem, stream>>>(m0, m1, p);
  return (int)cudaGetLastError();
}

template <bool DKV>
int tf32_pair(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, const void* qs, const void* kvs,
              int B, int H, int Tq, int Tk, int D, const long long* st, float scale,
              float scale_log2, void* stream) {
  bool ok = (D == 64 || D == 128) && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 &&
            (long long)B * H <= 65535 &&
            ((reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(kvs)) & 15) == 0;
  const void* ptrs[6] = {q, k, v, dout, DKV ? dk : dq, DKV ? dv : dq};
  for (const void* t : ptrs) ok = ok && t != nullptr && (reinterpret_cast<uintptr_t>(t) & 3) == 0;
  if (!ok) return ERR_PLAN;
  fbt::BwdTf32Problem p;
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.BH = B * H;
  p.rows = DKV ? Tk : Tq;
  p.cols = DKV ? Tq : Tk;
  p.tiles = (p.cols + fbt::BN - 1) / fbt::BN;
  // the scores' A operands (dkv: k, v; dq: q, dout) and the gradients
  const int a0 = DKV ? 3 : 0, a1 = DKV ? 6 : 9, g0 = DKV ? 15 : 12, g1 = DKV ? 18 : 12;
  p.a0 = (const float*)(DKV ? k : q);
  p.a1 = (const float*)(DKV ? v : dout);
  p.a0_sb = st[a0], p.a0_st = st[a0 + 1], p.a0_sh = st[a0 + 2];
  p.a1_sb = st[a1], p.a1_st = st[a1 + 1], p.a1_sh = st[a1 + 2];
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.g0 = (float*)(DKV ? dk : dq);
  p.g1 = (float*)(DKV ? dv : dq);
  p.g0_sb = st[g0], p.g0_st = st[g0 + 1], p.g0_sh = st[g0 + 2];
  p.g1_sb = st[g1], p.g1_st = st[g1 + 1], p.g1_sh = st[g1 + 2];
  p.scale = scale;
  p.scale_log2 = scale_log2;
  // the streamed side's split terms: q and dout (dkv) or k and v (dq)
  const float* b0 = (const float*)(DKV ? qs : kvs);
  const float* b1 = b0 + 2ll * p.BH * p.cols * D;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 128 ? launch_tf32<128, DKV>(p, b0, b1, s) : launch_tf32<64, DKV>(p, b0, b1, s);
}

}  // namespace

extern "C" {

// The pair's four entry points take the same arguments. strides: 21 values, the
// (batch, token, head) element strides of q, k, v, dout, dq, dk, dv in turn.
// lse (base 2) and delta: fp32 [B, H, Tq], contiguous. The dkv entries write
// dk and dv, the dq entries dq; the other outputs may be null.
#define BWD_PARAMS                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,            \
      const void *delta, void *dq, void *dk, void *dv, int B, int H, int Tq, int Tk, int D, \
      const long long *strides, float scale, float scale_log2, void *stream
#define BWD_ARGS(T) \
  make_args<T>(q, k, v, dout, lse, delta, dq, dk, dv, H, Tq, Tk, strides, scale, scale_log2)

int flash_attention_bwd_dkv_bf16(BWD_PARAMS) { DISPATCH_D(dkv_bf16, BWD_ARGS(__nv_bfloat16)) }
int flash_attention_bwd_dq_bf16(BWD_PARAMS) { DISPATCH_D(dq_bf16, BWD_ARGS(__nv_bfloat16)) }
int flash_attention_bwd_dkv_f32(BWD_PARAMS) { DISPATCH_D(dkv_f32, BWD_ARGS(float)) }
int flash_attention_bwd_dq_f32(BWD_PARAMS) { DISPATCH_D(dq_f32, BWD_ARGS(float)) }

// The fused route: bf16, D = 64 or 128, the strides as above (multiples of 8
// elements for q, k, v, dout), 16-byte aligned q, k, v, dout; delta from
// flash_attention_bwd_delta. The plan: bn keys a block, equal to D (query
// rows stream in ring stages of 64). With more than one key tile (Tk > bn),
// dq_acc is fp32 scratch of B*H * ceil(Tq/64) * 64 * D elements (any
// contents, 16-byte aligned) and dq_order int32 [B*H, ceil(Tq/64)], zeroed;
// both may be null otherwise.
// Writes dq, dk, dv. Returns ERR_PLAN for a plan or shape it does not take.
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, void* dk, void* dv,
                              void* dq_acc, void* dq_order, int B, int H, int Tq, int Tk, int D,
                              const long long* strides, float scale, float scale_log2, int bn,
                              void* stream) {
  bool ok = (D == 64 || D == 128) && bn == D && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 &&
            (long long)B * H <= 65535;
  ok = ok && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
  const int kv_tiles = (Tk + bn - 1) / bn;
  ok = ok && kv_tiles <= 65535 &&
       (kv_tiles == 1 || (dq_acc != nullptr && dq_order != nullptr &&
                          (reinterpret_cast<uintptr_t>(dq_acc) & 15) == 0));
  if (!ok) return ERR_PLAN;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  CUtensorMap maps[4];
  if (!wg::encode_bthd(encode, &maps[0], q, B, Tq, H, D, strides, fab::BM) ||
      !wg::encode_bthd(encode, &maps[1], k, B, Tk, H, D, strides + 3, bn) ||
      !wg::encode_bthd(encode, &maps[2], v, B, Tk, H, D, strides + 6, bn) ||
      !wg::encode_bthd(encode, &maps[3], dout, B, Tq, H, D, strides + 9, fab::BM))
    return ERR_MAP;
  fab::BwdProblem p;
  p.H = H, p.Tq = Tq, p.Tk = Tk;
  p.q_tiles = (Tq + fab::BM - 1) / fab::BM;
  p.kv_tiles = kv_tiles;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.dq_acc = (float*)dq_acc;
  p.dq_order = (int*)dq_order;
  p.dq = (__nv_bfloat16*)dq;
  p.dk = (__nv_bfloat16*)dk;
  p.dv = (__nv_bfloat16*)dv;
  for (int i = 0; i < 3; ++i) {
    p.dq_st[i] = strides[12 + i];
    p.dk_st[i] = strides[15 + i];
    p.dv_st[i] = strides[18 + i];
  }
  p.scale = scale;
  p.scale_log2 = scale_log2;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_wgmma<64>(maps, p, B * H, s) : launch_wgmma<128>(maps, p, B * H, s);
}

// The small route: bf16, D = 16 or 32, 1 <= Tq, Tk <= 64. q, k, v, o, dout
// [B, T, H, D] (o the forward's output, T = Tq) with 16-byte aligned data
// and strides that are multiples of 8 elements; dq, dk, dv written at their
// own strides (multiples of 2 elements, 4-byte aligned). strides: 24
// values, the (batch, token, head) element strides of q, k, v, o, dout, dq,
// dk, dv in turn. lse (base 2): fp32 [B, H, Tq], contiguous. delta is
// computed inside. Returns ERR_PLAN for a shape it does not take.
int flash_attention_bwd_small(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dq, void* dk, void* dv,
                              int B, int H, int Tq, int Tk, int D, const long long* strides,
                              float scale, float scale_log2, void* stream) {
  const void* in[5] = {q, k, v, o, dout};
  void* out[3] = {dq, dk, dv};
  bool ok = (D == 16 || D == 32) && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 &&
            Tq <= fbs::T_MAX && Tk <= fbs::T_MAX && (long long)B * H <= 2147483647LL &&
            lse != nullptr;
  for (int i = 0; i < 5; ++i)
    ok = ok && in[i] != nullptr && (reinterpret_cast<uintptr_t>(in[i]) & 15) == 0;
  for (int i = 0; i < 3; ++i)
    ok = ok && out[i] != nullptr && (reinterpret_cast<uintptr_t>(out[i]) & 3) == 0;
  for (int i = 0; i < 15; ++i) ok = ok && strides[i] % 8 == 0;
  for (int i = 15; i < 24; ++i) ok = ok && strides[i] % 2 == 0;
  if (!ok) return ERR_PLAN;
  fbs::SmallProblem p;
  for (int i = 0; i < 5; ++i) p.in[i] = (const __nv_bfloat16*)in[i];
  for (int i = 0; i < 3; ++i) p.out[i] = (__nv_bfloat16*)out[i];
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  p.lse = (const float*)lse;
  p.BH = B * H, p.H = H, p.Tq = Tq, p.Tk = Tk;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 16 ? launch_small<16>(p, s) : launch_small<32>(p, s);
}

// The long route: bf16, D = 16 or 32, any Tq, Tk >= 1; the arguments as
// the small route's, with groups the blocks a batch*head (1 .. ceil(Tk/128),
// each taking every groups-th chunk of 128 keys); with more than one chunk
// dq_part, fp32 scratch of B*H * groups * ceil(Tq/64) * 64 * D elements (any
// contents, 16-byte aligned), and with more than one group arrived, int32
// [B*H] zeroed; each may be null otherwise. Returns ERR_PLAN for a shape it
// does not take.
int flash_attention_bwd_long(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* dk, void* dv,
                             void* dq_part, void* arrived, int groups, int B, int H, int Tq,
                             int Tk, int D, const long long* strides, float scale,
                             float scale_log2, void* stream) {
  const void* in[5] = {q, k, v, o, dout};
  void* out[3] = {dq, dk, dv};
  const long long bh = (long long)B * H;
  const int kv_chunks = Tk >= 1 ? (Tk + fbl::BN - 1) / fbl::BN : 0;
  bool ok = (D == 16 || D == 32) && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && groups >= 1 &&
            groups <= kv_chunks && bh * groups <= 2147483647LL && lse != nullptr &&
            (kv_chunks == 1 || (dq_part != nullptr &&
                                (reinterpret_cast<uintptr_t>(dq_part) & 15) == 0)) &&
            (groups == 1 || arrived != nullptr);
  for (int i = 0; i < 5; ++i)
    ok = ok && in[i] != nullptr && (reinterpret_cast<uintptr_t>(in[i]) & 15) == 0;
  for (int i = 0; i < 3; ++i)
    ok = ok && out[i] != nullptr && (reinterpret_cast<uintptr_t>(out[i]) & 3) == 0;
  for (int i = 0; i < 15; ++i) ok = ok && strides[i] % 8 == 0;
  for (int i = 15; i < 24; ++i) ok = ok && strides[i] % 2 == 0;
  if (!ok) return ERR_PLAN;
  fbl::LongProblem p;
  for (int i = 0; i < 5; ++i) p.in[i] = (const __nv_bfloat16*)in[i];
  for (int i = 0; i < 3; ++i) p.out[i] = (__nv_bfloat16*)out[i];
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  p.lse = (const float*)lse;
  p.dq_part = (float*)dq_part;
  p.arrived = (int*)arrived;
  p.H = H, p.Tq = Tq, p.Tk = Tk;
  p.q_tiles = (Tq + fbl::BM - 1) / fbl::BM;
  p.kv_chunks = kv_chunks;
  p.groups = groups;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 16 ? launch_long<16>(p, bh, s) : launch_long<32>(p, bh, s);
}

// The pre-pass of the fused route and the bf16 pair: delta = rowsum(dout o),
// fp32 [B, H, Tq] contiguous, from bf16 o and dout [B, Tq, H, D] (D = 16,
// 32, 64, 128 or 256, D contiguous, 4-byte aligned rows) with strides: 6
// values, the (batch, token, head) element strides of o, then dout.
int flash_attention_bwd_delta(const void* o, const void* dout, void* delta, int B, int H, int Tq,
                              int D, const long long* strides, void* stream) {
  bool ok = (D == 16 || D == 32 || D == 64 || D == 128 || D == 256) && B >= 1 && H >= 1 &&
            Tq >= 1;
  ok = ok && ((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) & 3) == 0;
  for (int i = 0; i < 6; ++i) ok = ok && strides[i] % 2 == 0;
  if (!ok) return ERR_PLAN;
  const long long rows = (long long)B * H * Tq;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_delta<16>(o, dout, delta, H, Tq, rows, strides, s);
    case 32: return launch_delta<32>(o, dout, delta, H, Tq, rows, strides, s);
    case 64: return launch_delta<64>(o, dout, delta, H, Tq, rows, strides, s);
    case 128: return launch_delta<128>(o, dout, delta, H, Tq, rows, strides, s);
    default: return launch_delta<256>(o, dout, delta, H, Tq, rows, strides, s);
  }
}

// The tf32 route, three launches on `stream`. flash_attention_bwd_tf32_split
// writes the tf32 terms of q and dout into qs ([2 (q, dout)][2 (hi, lo)][B*H]
// [Tq][D] fp32) and of k and v into kvs ([2 (k, v)][2][B*H][Tk][D]), both
// 16-byte aligned, any contents; strides: 12 values, the (batch, token, head)
// element strides of q, dout, k, v in turn, multiples of 4, with 16-byte
// aligned data. The pair then reads them: flash_attention_bwd_tf32_dkv
// writes dk and dv, flash_attention_bwd_tf32_dq writes dq; both take the
// pair's arguments (strides: 21 values as above; lse, base 2, and delta
// fp32 [B, H, Tq] contiguous) and the split terms. fp32 at D = 64 or 128;
// each returns ERR_PLAN for a shape it does not take.
int flash_attention_bwd_tf32_split(const void* q, const void* dout, const void* k, const void* v,
                                   void* qs, void* kvs, int B, int H, int Tq, int Tk, int D,
                                   const long long* strides, void* stream) {
  bool ok = (D == 64 || D == 128) && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 &&
            (long long)B * H <= 65535 &&
            ((reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(kvs) |
              reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
              reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 4 == 0;
  if (!ok) return ERR_PLAN;
  fbt::SplitSrc src;
  const void* xs[4] = {q, dout, k, v};
  const long long bh = (long long)B * H;
  for (int z = 0; z < 4; ++z) {
    src.x[z] = (const float*)xs[z];
    src.sb[z] = strides[3 * z], src.st[z] = strides[3 * z + 1], src.sh[z] = strides[3 * z + 2];
  }
  src.dst[0] = (float*)qs;
  src.dst[1] = (float*)qs + 2 * bh * Tq * D;
  src.dst[2] = (float*)kvs;
  src.dst[3] = (float*)kvs + 2 * bh * Tk * D;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 128 ? launch_tf32_split<128>(src, B * H, H, Tq, Tk, s)
                  : launch_tf32_split<64>(src, B * H, H, Tq, Tk, s);
}

#define TF32_PARAMS                                                                          \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,            \
      const void *delta, void *dq, void *dk, void *dv, int B, int H, int Tq, int Tk, int D, \
      const long long *strides, float scale, float scale_log2, const void *qs,               \
      const void *kvs, void *stream
#define TF32_ARGS                                                                             \
  q, k, v, dout, lse, delta, dq, dk, dv, qs, kvs, B, H, Tq, Tk, D, strides, scale, scale_log2, \
      stream

int flash_attention_bwd_tf32_dkv(TF32_PARAMS) { return tf32_pair<true>(TF32_ARGS); }
int flash_attention_bwd_tf32_dq(TF32_PARAMS) { return tf32_pair<false>(TF32_ARGS); }

const char* flash_attention_bwd_error_string(int code) {
  switch (code) {
    case ERR_PLAN: return "the wgmma, small, long, delta or tf32 launcher refused the plan or shape";
    case ERR_ENCODE_FN: return "cuTensorMapEncodeTiled could not be found in libcuda";
    case ERR_MAP: return "cuTensorMapEncodeTiled refused a tensor map of q, k, v or dout (or their split terms)";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
