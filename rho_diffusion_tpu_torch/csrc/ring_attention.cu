// One step of ring attention (K6) for Hopper (sm_90a), bf16 or fp32 in and
// out, fp32 softmax state.
//
// Replaces the compute of the TPU kernel `_kernel` / `ring_attention_rdma`
// in rho_diffusion_tpu/parallel/context_rdma.py:50-189. That kernel keeps a
// rank's K/V shard in a 2-slot VMEM buffer, starts an async remote copy of
// slot `cur` to the right neighbour's slot `nxt`, and folds slot `cur` into
// the rank's running online-softmax state (m, l, acc) in f32 (:92-107);
// after n steps it writes acc / l in the input dtype (:140-144). Here the
// ring (the slots, the copies between ranks and their ordering) lives
// outside the kernel, on each rank's streams with CUDA events for the
// semaphores (parallel/context_rdma.py of the port). This kernel is one
// rank's fold of one slot:
//
//   s      = (q k^T) * log2(e)/sqrt(D)         fp32 (K6's single 1/sqrt(D)
//                                              scale, :93, :100; base 2)
//   m_new  = max(m, rowmax(s))
//   p      = exp2(s - m_new),  corr = exp2(m - m_new)
//   l      = l * corr + rowsum(p)
//   acc    = acc * corr + p v
//
// `first` starts from m = -inf (-1e30 here), l = 0, acc = 0 without reading
// the state (:86-90); `last` writes o = acc / l in the input dtype and not
// the state, so the ring's last step needs no extra launch. The state is
// kept in base-2 units (m of the pre-scaled scores), the same function as
// the TPU kernel's natural-log form; the plain version
// (ops/kernels/ring_attention.py) does the same arithmetic.
//
// Layouts: q is [B, Tq, H, D] with D contiguous and any (batch, token, head)
// strides in multiples of 16 bytes (the UNet's fused qkv is read in place);
// the slot's k and v are contiguous [B*H, S, D]; m and l are fp32 [B*H, Tq],
// acc fp32 [B*H, Tq, D]; o is [B, Tq, H, D] with its own strides. D is a
// template parameter (16..256, a multiple of 16); the caller pads other head
// dims with zeros.
//
// bf16 (`ring_step_bf16_kernel`): one block of four warps owns 64 query rows
// of one (b, h), 16 rows per warp, and sweeps the slot's keys in 64-key tiles
// through shared memory: S = Q K^T and acc += P V on mma.sync m16n8k16 with
// fp32 accumulation. q k^T is exact in fp32 (bf16 products), as in the TPU
// kernel's f32 cast; P is rounded to bf16 for the P V product (the TPU
// kernel keeps P in f32), one rounding of at most 2^-9 relative, the same as
// the flash forward (K1). fp32 (`ring_step_f32_kernel`): fp32 FMAs on the
// CUDA cores, eight threads to a query row, as the fp32 flash forward.
//
// What bounds it on the H100. At the flagship's serve shape (bucket 8, n = 4
// ranks: B*H = 32, T = 512, T/n = S = 128, D = 128) a ring call runs n*n = 16
// of these steps and does 4*B*H*T*T*D = 4.29 GFLOP: 4.3 us at the 989
// TFLOP/s bf16 tensor-core peak, 64 us at the 67 TFLOP/s fp32 peak. The
// function's own bytes (q, k, v read once, o written once: 16.8 MB in bf16)
// take 5.0 us at 3.35 TB/s, so the ring as a function is bound by bytes,
// at about 5 us. This design moves more: every rank-step reads q (1.05 MB)
// and the slot (2.1 MB), every step but the first reads the fp32 state
// (acc, m, l: 2.13 MB) and every step but the last writes it, and the last
// writes o: 106 MB over the 16 rank-steps, 32 us at 3.35 TB/s, plus the 12
// slot copies (25 MB, read and written by the copy engines). So the design
// is bound by its fp32 state's round trip through device memory, about 6x
// the function's bound; at these sizes a step's state for the four ranks
// (8.5 MB) stays in the 50 MB L2, which the device-memory figure does not
// credit. Keeping acc in registers across steps (a persistent kernel that
// waits for each slot) removes that traffic; that is later work. At the
// 64^3 config's attention (T = 4096, T/n = 1024) the call does 275 GFLOP,
// 0.28 ms at the bf16 peak, and the operations bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
ring_step_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, float* __restrict__ m_g,
                      float* __restrict__ l_g, float* __restrict__ acc_g,
                      __nv_bfloat16* __restrict__ o, int H, int Tq, int S, long long q_sb,
                      long long q_st, long long q_sh, long long o_sb, long long o_st,
                      long long o_sh, float scale_log2, int first, int last) {
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
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + (long long)bh * S * HD;
  const __nv_bfloat16* vb = v + (long long)bh * S * HD;
  float* accb = acc_g + (long long)bh * Tq * HD;
  float* mb = m_g + (long long)bh * Tq;
  float* lb = l_g + (long long)bh * Tq;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool p = q0 + r < Tq;
    cp_async16(&Qs[r * LD + cc * 8], p ? qb + (q0 + r) * q_st + cc * 8 : qb, p);
  }
  cp_async_commit();

  // This thread's rows of the state: t0 and t0 + 8; its columns of each n8
  // tile: (lane & 3) * 2 and + 1.
  const int qrow = warp * 16 + (lane >> 2);
  const int t0 = q0 + qrow;
  const bool in0 = t0 < Tq, in1 = t0 + 8 < Tq;
  float acc[ND][4];
  float m_i[2] = {NEG_BIG, NEG_BIG};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
  if (first) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  } else {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + (lane & 3) * 2;
      const float2 a0 = in0 ? *reinterpret_cast<const float2*>(accb + (long long)t0 * HD + col)
                            : make_float2(0.f, 0.f);
      const float2 a1 = in1 ? *reinterpret_cast<const float2*>(accb + (long long)(t0 + 8) * HD + col)
                            : make_float2(0.f, 0.f);
      acc[d][0] = a0.x;
      acc[d][1] = a0.y;
      acc[d][2] = a1.x;
      acc[d][3] = a1.y;
    }
    if (in0) m_i[0] = mb[t0];
    if (in1) m_i[1] = mb[t0 + 8];
    // the quad's four lanes share a row: one of them carries the stored sum
    if ((lane & 3) == 0) {
      if (in0) l_i[0] = lb[t0];
      if (in1) l_i[1] = lb[t0 + 8];
    }
  }

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const bool p = kv0 + r < S;
      cp_async16(&Ks[r * LD + cc * 8], p ? kb + (long long)(kv0 + r) * HD + cc * 8 : kb, p);
      cp_async16(&Vs[r * LD + cc * 8], p ? vb + (long long)(kv0 + r) * HD + cc * 8 : vb, p);
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

    // Online softmax in base 2; keys past S are masked.
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
  if (last) {
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + (lane & 3) * 2;
      if (in0)
        *reinterpret_cast<__nv_bfloat162*>(ob + t0 * o_st + col) =
            __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
      if (in1)
        *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + 8) * o_st + col) =
            __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
    }
    return;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    if (in0)
      *reinterpret_cast<float2*>(accb + (long long)t0 * HD + col) = make_float2(acc[d][0], acc[d][1]);
    if (in1)
      *reinterpret_cast<float2*>(accb + (long long)(t0 + 8) * HD + col) =
          make_float2(acc[d][2], acc[d][3]);
  }
  if ((lane & 3) == 0) {
    if (in0) {
      mb[t0] = m_i[0];
      lb[t0] = l0;
    }
    if (in1) {
      mb[t0 + 8] = m_i[1];
      lb[t0 + 8] = l1;
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* m, void* l, void* acc, void* o,
                int B, int H, int Tq, int S, const long long* st, float scale_log2, int first,
                int last, void* stream) {
  const int smem = (BQ + 2 * BKV) * (HD + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(ring_step_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)(B * H));
  ring_step_bf16_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (float*)m,
      (float*)l, (float*)acc, (__nv_bfloat16*)o, H, Tq, S, st[0], st[1], st[2], st[3], st[4],
      st[5], scale_log2, first, last);
  return (int)cudaGetLastError();
}

constexpr int F32_BQ = 16;   // query rows per block, 8 threads each
constexpr int F32_BKV = 64;  // keys per K/V tile, 8 per thread
constexpr int F32_PLD = F32_BKV + 8;  // P row: a warp's 4 rows on distinct banks

template <int HD>
__global__ void __launch_bounds__(THREADS)
ring_step_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ m_g,
                     float* __restrict__ l_g, float* __restrict__ acc_g, float* __restrict__ o,
                     int H, int Tq, int S, long long q_sb, long long q_st, long long q_sh,
                     long long o_sb, long long o_st, long long o_sh, float scale_log2, int first,
                     int last) {
  constexpr int LD = HD + 4;  // 16-byte rows; the 8 keys read together hit 8 bank groups
  constexpr int CH = HD / 4;  // 16-byte chunks per row
  constexpr int KPT = F32_BKV / 8;  // keys scored per thread per tile
  constexpr int DPT = HD / 8;       // state columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BQ * LD;
  float* Vs = Ks + F32_BKV * LD;
  float* Ps = Vs + F32_BKV * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // this thread's query row in the tile
  const int sub = tid & 7;   // its place among the row's 8 threads (adjacent lanes)
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * F32_BQ;
  const int t = q0 + row;
  const bool in = t < Tq;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + (long long)bh * S * HD;
  const float* vb = v + (long long)bh * S * HD;
  float* accr = acc_g + ((long long)bh * Tq + t) * HD + sub;  // columns sub + 8 d
  float* mb = m_g + (long long)bh * Tq;
  float* lb = l_g + (long long)bh * Tq;

  for (int c = tid; c < F32_BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool p = q0 + r < Tq;
    cp_async16(&Qs[r * LD + cc * 4], p ? qb + (q0 + r) * q_st + cc * 4 : qb, p);
  }
  cp_async_commit();

  float acc[DPT];
  float m_i = NEG_BIG;  // the row's running max (the same in its 8 threads)
  float l_i = 0.f;      // this thread's share of the row sum
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = (!first && in) ? accr[8 * d] : 0.f;
  if (!first && in) {
    m_i = mb[t];
    if (sub == 0) l_i = lb[t];  // one of the row's threads carries the stored sum
  }

  for (int kv0 = 0; kv0 < S; kv0 += F32_BKV) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < F32_BKV * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const bool p = kv0 + r < S;
      cp_async16(&Ks[r * LD + cc * 4], p ? kb + (long long)(kv0 + r) * HD + cc * 4 : kb, p);
      cp_async16(&Vs[r * LD + cc * 4], p ? vb + (long long)(kv0 + r) * HD + cc * 4 : vb, p);
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
      const float* vr = &Vs[j * LD + sub];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[8 * d], acc[d]);
    }
  }

  float l = l_i;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (!in) return;
  if (last) {
    const float inv = 1.f / l;
    float* orow = o + b * o_sb + h * o_sh + t * o_st + sub;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[8 * d] = acc[d] * inv;
    return;
  }
#pragma unroll
  for (int d = 0; d < DPT; ++d) accr[8 * d] = acc[d];
  if (sub == 0) {
    mb[t] = m_i;
    lb[t] = l;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* m, void* l, void* acc, void* o,
               int B, int H, int Tq, int S, const long long* st, float scale_log2, int first,
               int last, void* stream) {
  const int smem = ((F32_BQ + 2 * F32_BKV) * (HD + 4) + F32_BQ * F32_PLD) * 4;
  cudaError_t err = cudaFuncSetAttribute(ring_step_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + F32_BQ - 1) / F32_BQ), (unsigned)(B * H));
  ring_step_f32_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)m, (float*)l, (float*)acc,
      (float*)o, H, Tq, S, st[0], st[1], st[2], st[3], st[4], st[5], scale_log2, first, last);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 6 values, the (batch, token, head) element strides of q, then o.
// o may be null unless `last`.
int ring_attn_step_bf16(const void* q, const void* k, const void* v, void* m, void* l, void* acc,
                        void* o, int B, int H, int Tq, int S, int D, const long long* strides,
                        float scale_log2, int first, int last, void* stream) {
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 32: return launch_bf16<32>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 64: return launch_bf16<64>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 128: return launch_bf16<128>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 256: return launch_bf16<256>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ring_attn_step_f32(const void* q, const void* k, const void* v, void* m, void* l, void* acc,
                       void* o, int B, int H, int Tq, int S, int D, const long long* strides,
                       float scale_log2, int first, int last, void* stream) {
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 32: return launch_f32<32>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 64: return launch_f32<64>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 128: return launch_f32<128>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    case 256: return launch_f32<256>(q, k, v, m, l, acc, o, B, H, Tq, S, strides, scale_log2, first, last, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ring_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
