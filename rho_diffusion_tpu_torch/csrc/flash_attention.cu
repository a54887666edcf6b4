// Flash attention forward (non-causal) for Hopper (sm_90a), bf16 or fp32 in
// and out (the output in the input dtype).
//
// Replaces the TPU kernels `_fwd_kernel_onepass` (whole K/V in one block) and
// `_fwd_kernel` (online softmax over K blocks) in
// rho_diffusion_tpu/ops/pallas/flash_attention.py:59-175: per (batch, head)
//   O = softmax(Q K^T / sqrt(D)) V
// with fp32 scores, P cast to the V dtype before P.V, fp32 accumulation, the
// row sum divided out at the end as 1/max(l, 1e-30), and key columns past the
// true length masked to -1e30.
//
// Log-sum-exp: when the call will be differentiated the caller passes an fp32
// `lse` [B, H, Tq] and each row's log-sum-exp is written there IN BASE 2 of
// the scaled scores, lse2 = m + log2(max(l, 1e-30)) with m and l the online
// softmax's running max and sum (both in base-2 units, since the scores are
// pre-multiplied by log2(e)/sqrt(D)). It is the natural-log LSE of the TPU
// kernel (`with_lse`, :107-112) times log2(e), and the backward kernels
// (flash_attention_bwd.cu) recompute P = exp2(s * log2(e)/sqrt(D) - lse2) in
// the same base. The sampling path passes a null `lse` and writes nothing,
// as the TPU's primal path skips it (with_lse=False, :374-380).
//
// Three routes, chosen by the caller (ops/kernels/flash_attention.py
// `flash_plan`) by head dim and dtype, never by a failure:
//
//   flash_attention_fwd_wgmma  bf16, D = 64 or 128 (the UNet's 128): the
//     Hopper kernel in flash_attention_wgmma.cuh (TMA ring, wgmma for
//     Q K^T and P V, warp-specialised; its header says what bounds it and
//     what its design does about that). The plan (query rows a block, keys
//     a K/V tile) comes from the caller and is checked here; the tensor
//     maps are encoded per call. One kernel covers both TPU kernels: a sequence
//     that fits one K/V tile runs its loop once.
//   flash_attention_fwd_bf16   bf16, D = 16, 32 or 256: the mma.sync kernel
//     below (at 64 and 128 only when a plan asks for it: the old side of
//     the old-against-new comparison). What bounds it on the H100: at the UNet's shapes attention does
//     4*T*D flops per query row against 4*D bytes of Q and O, so it is bound
//     by operations on the tensor cores once the T x T scores stay out of
//     device memory. One block of four warps owns 64 query rows (16 per
//     warp); it streams 64-key tiles of K and V through one shared-memory
//     buffer (cp.async, each load waited for), computes S = Q K^T and
//     O += P V with mma.sync m16n8k16 bf16 products, and keeps the running
//     max, row sum and the output accumulator in registers. A ragged last
//     tile is zero-filled by the copy and masked.
//   flash_attention_fwd_f32    fp32, any of the head dims: below.
//
// fp32 (`flash_fwd_f32_kernel`, the UNet run in fp32): the same online
// softmax in fp32 FMAs on the CUDA cores, since the tensor cores' fp32 input
// (TF32) would round Q, K, V and P to 10 mantissa bits. Eight threads own one
// query row: each scores 8 of a 64-key tile's keys, the row's probabilities
// pass through shared memory, and each accumulates D/8 output columns. It is
// bound by the fp32 peak, about 15x below the bf16 tensor-core rate.
//
// Layout: q, k, v and o are [B, T, H, D] with D contiguous; any strides on
// B, T, H (multiples of 16 bytes), so the UNet's fused qkv projection is read
// in place. D is a template parameter (16..256, multiple of 16); the Python
// wrapper pads other head dims with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block (16 per warp)
constexpr int BKV = 64;   // keys per K/V tile
constexpr int THREADS = 128;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh, long long v_sb,
                      long long v_st, long long v_sh, long long o_sb, long long o_st,
                      long long o_sh, float scale_log2) {
  constexpr int LD = HD + 8;  // padded smem row: conflict-free fragment loads
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int ND = HD / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool p = q0 + r < Tq;
    cp_async16(&Qs[r * LD + cc * 8], p ? qb + (q0 + r) * q_st + cc * 8 : qb, p);
  }
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_i[2] = {NEG_BIG, NEG_BIG};  // rows lane/4 and lane/4 + 8 of this warp
  float l_i[2] = {0.f, 0.f};          // this thread's share of the row sums

  const int qrow = warp * 16 + (lane >> 2);
  for (int kv0 = 0; kv0 < Tk; kv0 += BKV) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const bool p = kv0 + r < Tk;
      cp_async16(&Ks[r * LD + cc * 8], p ? kb + (kv0 + r) * k_st + cc * 8 : kb, p);
      cp_async16(&Vs[r * LD + cc * 8], p ? vb + (kv0 + r) * v_st + cc * 8 : vb, p);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

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
        const int n = ni * 8 + (lane >> 2);
        uint32_t bfr[2] = {lds32(&Ks[n * LD + c]), lds32(&Ks[n * LD + c + 8])};
        mma_bf16_16816(s[ni], a, bfr);
      }
    }

    // Online softmax in base 2 (scores pre-multiplied by log2(e)/sqrt(D)).
    float mx0 = m_i[0], mx1 = m_i[1];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + ni * 8 + (lane & 3) * 2 + (e & 1);
        s[ni][e] = col < Tk ? s[ni][e] * scale_log2 : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[ni][0], s[ni][1]));
      mx1 = fmaxf(mx1, fmaxf(s[ni][2], s[ni][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m_i[0] - mx0);
    const float alpha1 = exp2f(m_i[1] - mx1);
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
    l_i[0] = l_i[0] * alpha0 + rs0;
    l_i[1] = l_i[1] * alpha1 + rs1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // O += P V: two adjacent n8 score tiles form one k16 A fragment.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = &Vs[(kk * 16 + (lane & 15)) * LD];
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
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  const int t0 = q0 + qrow;
  if (lse != nullptr && (lane & 3) == 0) {  // the quad's 4 lanes hold the same row
    float* lrow = lse + (long long)blockIdx.y * Tq;
    if (t0 < Tq) lrow[t0] = m_i[0] + log2f(fmaxf(l0, 1e-30f));
    if (t0 + 8 < Tq) lrow[t0 + 8] = m_i[1] + log2f(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    if (t0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + t0 * o_st + col) =
          __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
    if (t0 + 8 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + 8) * o_st + col) =
          __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Tq,
           int Tk, const long long* st, float scale_log2, void* stream) {
  const int smem = (BQ + 2 * BKV) * (HD + 8) * 2;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(flash_fwd_bf16_kernel<HD>, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd_bf16_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

constexpr int F32_BQ = 16;   // query rows per block, 8 threads each
constexpr int F32_BKV = 64;  // keys per K/V tile, 8 per thread
constexpr int F32_PLD = F32_BKV + 8;  // P row: a warp's 4 rows on distinct banks

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     long long q_sb, long long q_st, long long q_sh, long long k_sb,
                     long long k_st, long long k_sh, long long v_sb, long long v_st,
                     long long v_sh, long long o_sb, long long o_st, long long o_sh,
                     float scale_log2) {
  constexpr int LD = HD + 4;  // 16-byte rows; the 8 keys read together hit 8 bank groups
  constexpr int CH = HD / 4;  // 16-byte chunks per row
  constexpr int KPT = F32_BKV / 8;  // keys scored per thread per tile
  constexpr int DPT = HD / 8;       // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BQ * LD;
  float* Vs = Ks + F32_BKV * LD;
  float* Ps = Vs + F32_BKV * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // this thread's query row in the tile
  const int sub = tid & 7;   // its place among the row's 8 threads (adjacent lanes)
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * F32_BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int c = tid; c < F32_BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool p = q0 + r < Tq;
    cp_async16(&Qs[r * LD + cc * 4], p ? qb + (q0 + r) * q_st + cc * 4 : qb, p);
  }
  cp_async_commit();

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m_i = NEG_BIG;  // the row's running max (the same in its 8 threads)
  float l_i = 0.f;      // this thread's share of the row sum

  for (int kv0 = 0; kv0 < Tk; kv0 += F32_BKV) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < F32_BKV * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const bool p = kv0 + r < Tk;
      cp_async16(&Ks[r * LD + cc * 4], p ? kb + (kv0 + r) * k_st + cc * 4 : kb, p);
      cp_async16(&Vs[r * LD + cc * 4], p ? vb + (kv0 + r) * v_st + cc * 4 : vb, p);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // Scores of keys sub, sub + 8, ... of this tile against this row.
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[row * LD + c]);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[(sub + 8 * i) * LD + c]);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    // Online softmax in base 2 (scores pre-multiplied by log2(e)/sqrt(D)).
    float mx = m_i;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = kv0 + sub + 8 * i < Tk ? s[i] * scale_log2 : NEG_BIG;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = exp2f(m_i - mx);
    m_i = mx;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = exp2f(s[i] - mx);
      rs += p;
      Ps[row * F32_PLD + sub + 8 * i] = p;
    }
    l_i = l_i * alpha + rs;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
    __syncwarp();  // the row's 8 threads share one warp

    // O += P V over the tile's keys; this thread's columns are sub + 8 d.
#pragma unroll 4
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = Ps[row * F32_PLD + j];
      const float* vr = &Vs[j * LD + sub];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[8 * d], acc[d]);
    }
  }

  float l = l_i;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int t = q0 + row;
  if (lse != nullptr && sub == 0 && t < Tq)
    lse[(long long)blockIdx.y * Tq + t] = m_i + log2f(fmaxf(l, 1e-30f));
  if (t < Tq) {
    float* orow = o + b * o_sb + h * o_sh + t * o_st + sub;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[8 * d] = acc[d] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int Tq, int Tk, const long long* st, float scale_log2, void* stream) {
  const int smem = ((F32_BQ + 2 * F32_BKV) * (HD + 4) + F32_BQ * F32_PLD) * 4;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(flash_fwd_f32_kernel<HD>, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + F32_BQ - 1) / F32_BQ), (unsigned)(B * H));
  flash_fwd_f32_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, Tq, Tk,
      st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wgmma route (flash_attention_wgmma.cuh)

// The launcher's own error codes.
constexpr int ERR_PLAN = -1;       // a plan or shape the wgmma kernel does not take
constexpr int ERR_ENCODE_FN = -2;  // cuTensorMapEncodeTiled not found
constexpr int ERR_MAP = -3;        // cuTensorMapEncodeTiled refused a tensor map

struct WgmmaLaunch {
  CUtensorMap q, k, v;
  void* o;
  void* lse;
  fa::FwdProblem p;
  int B;
  cudaStream_t stream;
};

// The plans flash_plan returns: 64 x 64, 128 x 128, and 128 x 64 (keys <= 64).
template <int HD, int CONSUMERS, int BN>
int launch_wgmma(const WgmmaLaunch& a) {
  constexpr int BM = 64 * CONSUMERS;
  constexpr int smem = fa::smem_bytes(HD, BM, BN);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  auto kernel = fa::flash_fwd_wgmma_kernel<HD, CONSUMERS, BN>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.p.Tq + BM - 1) / BM), (unsigned)(a.B * a.p.H));
  kernel<<<grid, 128 * (CONSUMERS + 1), smem, a.stream>>>(
      a.q, a.k, a.v, (__nv_bfloat16*)a.o, (float*)a.lse, a.p);
  return (int)cudaGetLastError();
}

template <int HD>
int by_plan(int bm, int bn, const WgmmaLaunch& a) {
  if (bm == 64) return launch_wgmma<HD, 1, 64>(a);
  return bn == 128 ? launch_wgmma<HD, 2, 128>(a) : launch_wgmma<HD, 2, 64>(a);
}

template <int HD, int BN>
int launch_pv_probe(const CUtensorMap& v_map, const void* p, void* out, cudaStream_t stream) {
  constexpr int smem = fa::kv_bytes(HD, BN) + 8 + 1024;
  static unsigned long long ready = 0;
  auto kernel = fa::wgmma_pv_probe_kernel<HD, BN>;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, stream>>>(v_map, (const __nv_bfloat16*)p, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 values, (batch, token, head) element strides of q, k, v, o in turn.
// lse: null, or fp32 [B, H, Tq] (contiguous) for the base-2 log-sum-exp.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Tq, int Tk, int D, const long long* strides,
                             float scale_log2, void* stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 32: return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 64: return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 256: return launch<256>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wgmma route: q, k, v, o bf16 [B, T, H, D] with D = 64 or 128, D
// contiguous, B/T/H element strides that are multiples of 8 (16 bytes) and
// 16-byte aligned data; lse as above. The plan: bm query rows a block (64
// or 128: one or two consumer warpgroups) and bn keys a K/V tile (bn = bm,
// or 64 at bm = 128). Returns ERR_PLAN for a plan or shape it does not take.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int Tq, int Tk, int D, const long long* strides,
                              float scale_log2, int bm, int bn, void* stream) {
  bool ok = (D == 64 || D == 128) && ((bm == 64 && bn == 64) || (bm == 128 && (bn == 64 ||
            bn == 128))) && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && (long long)B * H <= 65535;
  ok = ok && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  for (int i = 0; i < 9; ++i) ok = ok && strides[i] % 8 == 0;
  if (!ok) return ERR_PLAN;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  WgmmaLaunch a;
  if (!wg::encode_bthd(encode, &a.q, q, B, Tq, H, D, strides, bm) ||
      !wg::encode_bthd(encode, &a.k, k, B, Tk, H, D, strides + 3, bn) ||
      !wg::encode_bthd(encode, &a.v, v, B, Tk, H, D, strides + 6, bn))
    return ERR_MAP;
  a.o = o;
  a.lse = lse;
  a.p.H = H, a.p.Tq = Tq, a.p.Tk = Tk, a.p.kv_tiles = (Tk + bn - 1) / bn;
  a.p.o_sb = strides[9], a.p.o_st = strides[10], a.p.o_sh = strides[11];
  a.p.scale_log2 = scale_log2;
  a.B = B;
  a.stream = (cudaStream_t)stream;
  return D == 128 ? by_plan<128>(bm, bn, a) : by_plan<64>(bm, bn, a);
}

// The register-A, transposed-B product of the wgmma route alone:
// out [64, hd] fp32 = p [64, bn] bf16 times v [bn, hd] bf16, all contiguous
// (bn 64 or 128, hd 64 or 128). A test of the operand layouts.
int flash_wgmma_pv_probe(const void* p, const void* v, void* out, int bn, int hd, void* stream) {
  if ((bn != 64 && bn != 128) || (hd != 64 && hd != 128) ||
      (reinterpret_cast<uintptr_t>(v) & 15) || (reinterpret_cast<uintptr_t>(p) & 3))
    return ERR_PLAN;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  CUtensorMap v_map;
  const long long st[3] = {(long long)bn * hd, hd, hd};  // one batch, bn tokens, one head
  if (!wg::encode_bthd(encode, &v_map, v, 1, bn, 1, hd, st, bn)) return ERR_MAP;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 128) return bn == 128 ? launch_pv_probe<128, 128>(v_map, p, out, s)
                                  : launch_pv_probe<128, 64>(v_map, p, out, s);
  return bn == 128 ? launch_pv_probe<64, 128>(v_map, p, out, s)
                   : launch_pv_probe<64, 64>(v_map, p, out, s);
}

int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int Tq, int Tk, int D, const long long* strides,
                            float scale_log2, void* stream) {
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 32: return launch_f32<32>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 64: return launch_f32<64>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 128: return launch_f32<128>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    case 256: return launch_f32<256>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  switch (code) {
    case ERR_PLAN: return "the wgmma launcher refused the plan or shape";
    case ERR_ENCODE_FN: return "cuTensorMapEncodeTiled could not be found in libcuda";
    case ERR_MAP: return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
