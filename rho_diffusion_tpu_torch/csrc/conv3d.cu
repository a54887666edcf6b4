// 3x3x3 stride-1 SAME convolution on channels-last volumes, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_conv3d_kernel` / `conv3d_pallas`
// (rho_diffusion_tpu/ops/pallas/conv3d.py:102/140), forward direction; dgrad
// (:242-250) runs the same entry points on flipped, IO-transposed weights:
//   out[b,d,h,w,co] = bias[co] + sum_{dz,dy,dx,ci} x[b,d+dz-1,h+dy-1,w+dx-1,ci] * W[co,ci,dz,dy,dx]
// with zero padding, fp32 accumulation, output in the input dtype.
//
// Three entry points:
//   conv3d_igemm_bf16   bf16, Cin % 8 == 0: the implicit GEMM on TMA and
//                       wgmma (conv3d_wgmma.cuh says what bounds it and what
//                       its design does about that). The box plan comes from
//                       the caller (ops/kernels/conv3d.py `igemm_plan`) and is
//                       checked here; the tensor maps are encoded per call.
//   conv3d_igemm_tf32   fp32, Cin % 4 == 0, Cout > 1: the same block in
//                       3xTF32 (conv3d_tf32.cuh) on the weights' tf32 terms,
//                       which `conv3d_weight_split` writes before it; its
//                       plan from `tf32_plan`.
//   conv3d_direct_*     any Cin, bf16 or fp32: the tiled direct conv below.
//                       Carries the UNet's Cin=1 input conv, its fp32 output
//                       head (Cout=1) and that head's dgrad (Cin'=1), which do
//                       not fit the GEMM tiles, and fp32 with Cin % 4 != 0.
// Each launches on the caller's stream, allocates nothing, and returns 0, a
// CUDA error code, or a negative code of its own (conv3d_error_string names
// both) so the Python wrapper can raise.

#include "conv3d_tf32.cuh"
#include "conv3d_wgmma.cuh"

namespace {

template <int BN, int STAGES>
int launch_wgmma(const CUtensorMap& x_map, const CUtensorMap& w_map, const void* bias, void* out,
                 const wg::Problem& p, cudaStream_t stream) {
  constexpr int smem = wg::smem_bytes(BN, STAGES);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  auto kernel = wg::conv3d_igemm_wgmma_kernel<BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks(), wg::THREADS, smem, stream>>>(
      x_map, w_map, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, p);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES>
int launch_tf32(const CUtensorMap& x_map, const CUtensorMap& whi_map, const CUtensorMap& wlo_map,
                const void* bias, void* out, const wg::Problem& p, cudaStream_t stream) {
  constexpr int smem = ct::smem_bytes(BN, STAGES);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  auto kernel = ct::conv3d_tf32_kernel<BN, STAGES>;
  static unsigned long long ready = 0;
  cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks(), wg::THREADS, smem, stream>>>(x_map, whi_map, wlo_map,
                                                              (const float*)bias, (float*)out, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The direct conv (`conv3d_direct_kernel`): fp32 FMAs from shared memory.
//
// Its design points are the UNet's two convs at the ends of the volume:
//
//   Cin = 1 -> Cout = 64: the bf16 input conv [8,32,32,32,1] -> 64 (sampling)
//     and the fp32 head's dgrad [32,32,32,32,1] -> 64 (training). 27 FMAs per
//     output from one input value each, so it is bound by writing the output:
//     268 MB in fp32 at batch 32 is 0.080 ms at 3.35 TB/s, 33.5 MB in bf16 at
//     batch 8 is 0.010 ms. Config <CC=1, COT=64, CPT=16>.
//   Cin = 64 -> Cout = 1: the fp32 head [8,32,32,32,64] -> 1. 27*64 FMAs per
//     output, bound by reading x (67 MB, 0.020 ms); its 0.9 GFLOP take 0.0135
//     ms at the 67 TFLOP/s fp32 peak, and every FMA reads one x value from
//     shared memory, which caps it near a quarter of that peak.
//     Config <CC=8, COT=1, CPT=1>.
//   Everything else the direct route takes (bf16 with Cin % 8 != 0, any other
//     fp32 conv) runs config <CC=8, COT=16, CPT=4>: correct, not tuned.
//
// A block owns one output tile of TH x TW = 8 x 32 voxels of one depth slice
// and COT output channels. For each chunk of CC input channels it stages in
// shared memory, as fp32, the tile's input halo (3 x 10 x 34 positions x CC
// channels, zero-filled outside the volume and past Cin, so the inner loop
// has no bounds tests) and the chunk's 27 x CC x COT weights. Each of the 256
// threads then keeps a register block of VPT = COT / CPT voxels x CPT output
// channels: for every tap and input channel it reads VPT x values and CPT
// weights (broadcasts, conflict-free: rows of the halo are padded to CC + 4
// floats) and does VPT * CPT FMAs. A thread's channels are interleaved in
// groups of G = 4 so that the NCG = COT / CPT threads of one voxel store
// 4 * NCG contiguous channels with 16-byte (fp32) or 8-byte (bf16) vectors.

constexpr int DIRECT_THREADS = 256;
constexpr int TH = 8, TW = 32;                          // output tile (one depth slice)
constexpr int HALO = 3 * (TH + 2) * (TW + 2);           // 1020 staged positions

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// Stores G consecutive channels; `vec` when all are in range and aligned.
template <typename T, int G>
__device__ __forceinline__ void store_group(T* p, const float* v, bool vec, int valid) {
  if constexpr (G == 4) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p) = u;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < G; ++e)
    if (e < valid) p[e] = from_f32<T>(v[e]);
}

// Floats per staged halo position: CC, padded so that the float4 reads of
// neighbouring voxels fall on distinct bank groups.
__host__ __device__ constexpr int halo_ld(int cc) { return cc == 1 ? 1 : cc + 4; }

__host__ __device__ constexpr int direct_smem_bytes(int cc, int cot) {
  return (HALO * halo_ld(cc) + 27 * cc * cot) * 4;
}

// x: [B, D, H, W, Cin]; w: [27*Cin, Cout] (k-major, Cout contiguous); bias:
// [Cout] or null; out: [B, D, H, W, Cout]. Grid: (B * D * tiles_h * tiles_w,
// ceil(Cout / COT)). The wrapper guarantees every element index fits in 32
// bits.
template <typename T, int CC, int COT, int CPT>
__global__ void __launch_bounds__(DIRECT_THREADS)
conv3d_direct_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                     T* __restrict__ out, int D, int H, int W, int Cin, int Cout, int tiles_h,
                     int tiles_w) {
  constexpr int NCG = COT / CPT;                 // channel groups = threads per voxel
  constexpr int NVG = DIRECT_THREADS / NCG;      // voxel groups
  constexpr int VPT = (TH * TW) / NVG;           // voxels per thread
  constexpr int G = CPT >= 4 ? 4 : CPT;          // channels stored together
  constexpr int XLD = halo_ld(CC);
  static_assert(COT % CPT == 0 && CPT % G == 0 && (TH * TW) % NVG == 0, "bad direct config");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [HALO][XLD]
  float* ws = smem + HALO * XLD;                 // [27][CC][COT]

  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  t /= tiles_h;
  const int d = t % D;
  const int b = t / D;
  const int h0 = th * TH, w0 = tw * TW;
  const int co0 = blockIdx.y * COT;
  const int cg = tid % NCG, vg = tid / NCG;

  float acc[VPT][CPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // the previous chunk is fully consumed
    bool staged = false;
    if constexpr (sizeof(T) == 4 && CC % 4 == 0) {
      // 16-byte loads, 4 channels of one position each, where x allows them
      if (Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
        for (int idx = tid; idx < HALO * (CC / 4); idx += DIRECT_THREADS) {
          const int pos = idx / (CC / 4), c4 = (idx % (CC / 4)) * 4;
          const int px = pos % (TW + 2), py = (pos / (TW + 2)) % (TH + 2);
          const int pz = pos / ((TW + 2) * (TH + 2));
          const int dd = d + pz - 1, hh = h0 + py - 1, ww = w0 + px - 1;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + c4 < Cin)
            v = *reinterpret_cast<const float4*>(
                x + ((((long long)b * D + dd) * H + hh) * W + ww) * Cin + c0 + c4);
          *reinterpret_cast<float4*>(&xs[pos * XLD + c4]) = v;
        }
        staged = true;
      }
    }
    if (!staged) {
      for (int idx = tid; idx < HALO * CC; idx += DIRECT_THREADS) {
        const int pos = idx / CC, ci = idx % CC;
        const int px = pos % (TW + 2), py = (pos / (TW + 2)) % (TH + 2);
        const int pz = pos / ((TW + 2) * (TH + 2));
        const int dd = d + pz - 1, hh = h0 + py - 1, ww = w0 + px - 1;
        float v = 0.f;
        if (dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + ci < Cin)
          v = to_f32(x[((((long long)b * D + dd) * H + hh) * W + ww) * Cin + c0 + ci]);
        xs[pos * XLD + ci] = v;
      }
    }
    for (int idx = tid; idx < 27 * CC * COT; idx += DIRECT_THREADS) {
      const int col = idx % COT, ci = (idx / COT) % CC, tap = idx / (COT * CC);
      float v = 0.f;
      if (c0 + ci < Cin && co0 + col < Cout) v = to_f32(w[(tap * Cin + c0 + ci) * Cout + co0 + col]);
      ws[idx] = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      int base[VPT];
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = vg + NVG * i;
        base[i] = ((dz * (TH + 2) + v / TW + dy) * (TW + 2) + v % TW + dx) * XLD;
      }
      const float* wt = ws + tap * CC * COT;
#pragma unroll
      for (int ci = 0; ci < CC; ci += (CC % 4 == 0 ? 4 : 1)) {
        constexpr int CV = CC % 4 == 0 ? 4 : 1;
        float xv[VPT][CV];
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          if constexpr (CV == 4) {
            const float4 q = *reinterpret_cast<const float4*>(&xs[base[i] + ci]);
            xv[i][0] = q.x;
            xv[i][1] = q.y;
            xv[i][2] = q.z;
            xv[i][3] = q.w;
          } else {
            xv[i][0] = xs[base[i] + ci];
          }
        }
#pragma unroll
        for (int e = 0; e < CV; ++e) {
          const float* wr = wt + (ci + e) * COT + cg * G;
          float wv[CPT];
#pragma unroll
          for (int g = 0; g < CPT / G; ++g) {
            if constexpr (G == 4) {
              const float4 q = *reinterpret_cast<const float4*>(wr + g * NCG * G);
              wv[g * 4 + 0] = q.x;
              wv[g * 4 + 1] = q.y;
              wv[g * 4 + 2] = q.z;
              wv[g * 4 + 3] = q.w;
            } else {
#pragma unroll
              for (int k = 0; k < G; ++k) wv[g * G + k] = wr[g * NCG * G + k];
            }
          }
#pragma unroll
          for (int i = 0; i < VPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv[i][e], wv[j], acc[i][j]);
        }
      }
    }
  }

  // Epilogue: bias, then the thread's groups of G channels for each voxel.
  const bool vec_out = G == 4 && Cout % 4 == 0;
#pragma unroll
  for (int g = 0; g < CPT / G; ++g) {
    const int col = co0 + g * NCG * G + cg * G;  // first channel of this group
    float bv[G];
#pragma unroll
    for (int k = 0; k < G; ++k) bv[k] = (bias && col + k < Cout) ? to_f32(bias[col + k]) : 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = vg + NVG * i;
      const int hh = h0 + v / TW, ww = w0 + v % TW;
      if (hh >= H || ww >= W || col >= Cout) continue;
      float r[G];
#pragma unroll
      for (int k = 0; k < G; ++k) r[k] = acc[i][g * G + k] + bv[k];
      T* p = out + ((((long long)b * D + d) * H + hh) * W + ww) * Cout + col;
      store_group<T, G>(p, r, vec_out && col + G <= Cout, Cout - col);
    }
  }
}

template <typename T, int CC, int COT, int CPT>
int launch_direct_cfg(const void* x, const void* w, const void* bias, void* out, int B, int D,
                      int H, int W, int Cin, int Cout, void* stream) {
  constexpr int smem = direct_smem_bytes(CC, COT);
  auto kernel = conv3d_direct_kernel<T, CC, COT, CPT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  dim3 grid((unsigned)((long long)B * D * tiles_h * tiles_w), (unsigned)((Cout + COT - 1) / COT));
  kernel<<<grid, DIRECT_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, D, H, W, Cin, Cout, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

// The three configurations; the choice depends on the channel counts only.
template <typename T>
int launch_direct(const void* x, const void* w, const void* bias, void* out, int B, int D, int H,
                  int W, int Cin, int Cout, void* stream) {
  if (Cout == 1)
    return launch_direct_cfg<T, 8, 1, 1>(x, w, bias, out, B, D, H, W, Cin, Cout, stream);
  if (Cin == 1)
    return launch_direct_cfg<T, 1, 64, 16>(x, w, bias, out, B, D, H, W, Cin, Cout, stream);
  return launch_direct_cfg<T, 8, 16, 4>(x, w, bias, out, B, D, H, W, Cin, Cout, stream);
}

}  // namespace

extern "C" {

// x, w and the plan as `wg::conv_setup` takes them; bias: [Cout] bf16 or
// null; out: [B, D, H, W, Cout] bf16.
int conv3d_igemm_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                      int H, int W, int Cin, int Cout, int bw, int bh, int bd, int bn, int stages,
                      void* stream) {
  CUtensorMap x_map, w_map;
  wg::Problem p;
  const int err = wg::conv_setup(x, w, B, D, H, W, Cin, Cout, bw, bh, bd, bn, stages, &x_map,
                                 &w_map, &p);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn * 10 + stages) {
    case 643: return launch_wgmma<64, 3>(x_map, w_map, bias, out, p, s);
    case 644: return launch_wgmma<64, 4>(x_map, w_map, bias, out, p, s);
    case 1283: return launch_wgmma<128, 3>(x_map, w_map, bias, out, p, s);
    case 1284: return launch_wgmma<128, 4>(x_map, w_map, bias, out, p, s);
    case 1923: return launch_wgmma<192, 3>(x_map, w_map, bias, out, p, s);
    case 1924: return launch_wgmma<192, 4>(x_map, w_map, bias, out, p, s);
    case 2563: return launch_wgmma<256, 3>(x_map, w_map, bias, out, p, s);
    default: return launch_wgmma<256, 4>(x_map, w_map, bias, out, p, s);
  }
}

// fp32 x [B, D, H, W, Cin] (16-byte aligned, Cin % 4 == 0), w_hi and w_lo
// [Cout, 27, Cin] fp32 contiguous and 16-byte aligned (conv3d_weight_split's
// terms of the weights), bias [Cout] fp32 or null, out [B, D, H, W, Cout]
// fp32. The plan: the box as for conv3d_igemm_bf16, bn 64 or 128 with 4
// stages.
int conv3d_igemm_tf32(const void* x, const void* w_hi, const void* w_lo, const void* bias,
                      void* out, int B, int D, int H, int W, int Cin, int Cout, int bw, int bh,
                      int bd, int bn, int stages, void* stream) {
  CUtensorMap x_map, whi_map, wlo_map;
  wg::Problem p;
  const int err = ct::conv_setup(x, w_hi, w_lo, B, D, H, W, Cin, Cout, bw, bh, bd, bn, stages,
                                 &x_map, &whi_map, &wlo_map, &p);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return bn == 64 ? launch_tf32<64, 4>(x_map, whi_map, wlo_map, bias, out, p, s)
                  : launch_tf32<128, 4>(x_map, whi_map, wlo_map, bias, out, p, s);
}

// The tf32 route's pre-pass: n fp32 values of w split into their tf32 terms
// hi = tf32(w) and lo = tf32(w - hi), elementwise.
int conv3d_weight_split(const void* w, void* hi, void* lo, long long n, void* stream) {
  if (n < 1) return wg::ERR_PLAN;
  const long long blocks = (n + 255) / 256;
  ct::tf32_split_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                          (cudaStream_t)stream>>>((const float*)w, (float*)hi, (float*)lo, n);
  return (int)cudaGetLastError();
}

int conv3d_direct_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                       int H, int W, int Cin, int Cout, void* stream) {
  return launch_direct<__nv_bfloat16>(x, w, bias, out, B, D, H, W, Cin, Cout, stream);
}

int conv3d_direct_f32(const void* x, const void* w, const void* bias, void* out, int B, int D,
                      int H, int W, int Cin, int Cout, void* stream) {
  return launch_direct<float>(x, w, bias, out, B, D, H, W, Cin, Cout, stream);
}

const char* conv3d_error_string(int code) { return wg::error_string(code); }

}  // extern "C"
