// W8A8 inference on Hopper (sm_90a): the int8 convs and the activation
// quantiser of the port's `ops/quant.py`.
//
// None of these replaces a TPU kernel. The JAX package's int8 path
// (rho_diffusion_tpu/ops/quant.py) is plain jnp: `quantize_int8` (:90-98) and
// `ConvInt8`'s integer `conv_general_dilated` (:101-154) are left to XLA,
// which has an int8 conv on the TPU; PyTorch has none on CUDA, so the port
// writes its own.
//
// Entry points (each launches on the caller's stream, allocates nothing, and
// returns 0, a CUDA error code, or a negative code of its own, which
// conv_int8_error_string names):
//   conv3d_s8          S1: the 3x3x3 stride-1 SAME conv on the s8 tensor
//                      cores, K5's block (conv3d_s8_wgmma.cuh says what bounds
//                      it and what its design does), Cin % 16 == 0.
//                      (The strided Downsample on the same block has its own
//                      source, conv3d_s8_strided.cu, and so do the 2-D convs
//                      on it, conv2d_s8.cu and conv2d_s8_strided.cu, so
//                      they build in parallel.)
//   conv_s8_general    S2: any int8 conv of rank 1-3 (as 3-D with unit dims),
//                      any kernel size, stride and explicit padding, Cin >= 1:
//                      1-D convs, Cin % 16 != 0, other kernel sizes and
//                      strides. One thread an output element,
//                      int32 sums of __dp4a over four channels a word, the
//                      weights repacked [taps, ceil(Cin/4), Cout] words so a
//                      warp's weight loads are one 128-byte line and its x
//                      loads one broadcast. Bound by those loads from L1/L2,
//                      not by the dp4a rate: simple and exact rather than
//                      fast.
//   quantize_int8_rows S3: per leading index (a sample, or an output
//                      channel of a weight), the symmetric int8 quantisation
//                      of the rest, bitwise as `quantize_int8`: two launches,
//                        1. |x| max of each block's share of a row into
//                           partial[row, block] (max is exact in any order,
//                           and a partial per block needs no zeroed buffer,
//                           so no third launch clears one);
//                        2. each block reduces its row's partials, scale =
//                           max(amax, 1e-12) / 127 (IEEE division) and
//                           q = clamp(rint(x / scale), -127, 127), half to
//                           even as jnp.round; block 0 writes the scale.
//                      Bound by bytes: x read twice, q written once.
// S1 and S2 share the epilogue: an int32 output mode writes the sums; the
// fp32 and bf16 modes dequantise as JAX does, float(acc) * (s_x[b] *
// s_w[co]) + bias[co] with every operation rounded on its own (no FMA), then
// round once to the output type.

#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3d_s8_wgmma.cuh"

namespace {

constexpr int ERR_SHAPE = wg::ERR_S8_ARGS;

// ---------------------------------------------------------------------------
// S2: the general int8 conv.

struct Geometry {
  int B, D, H, W, Cin, G, Cout;  // G = ceil(Cin / 4) words of channels
  int KD, KH, KW, SD, SH, SW, PD, PH, PW;
  int OD, OH, OW;
};

// Four int8 channels [4g, 4g + 4) of one voxel's row as a dp4a word (byte i
// holds channel 4g + i, as the packed weights do); channels past Cin are 0.
template <bool ALIGNED>
__device__ __forceinline__ int x_word(const int8_t* row, int g, int cin) {
  if (ALIGNED) return reinterpret_cast<const int*>(row)[g];
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * g + i;
    if (c < cin) v |= (uint32_t)(uint8_t)row[c] << (8 * i);
  }
  return (int)v;
}

template <int OUT, bool ALIGNED>
__global__ void __launch_bounds__(256)
conv_s8_general_kernel(const int8_t* __restrict__ x, const int* __restrict__ wp,
                       const float* __restrict__ s_x, const float* __restrict__ s_w,
                       const float* __restrict__ bias, typename wg::S8Store<OUT>::T* __restrict__ out,
                       const Geometry g, long long voxels) {
  const int co = blockIdx.y * 64 + threadIdx.x;
  const long long v = (long long)blockIdx.x * 4 + threadIdx.y;
  if (co >= g.Cout || v >= voxels) return;
  long long t = v;
  const int ow = (int)(t % g.OW);
  t /= g.OW;
  const int oh = (int)(t % g.OH);
  t /= g.OH;
  const int od = (int)(t % g.OD);
  const int b = (int)(t / g.OD);
  int acc = 0;
  for (int kz = 0; kz < g.KD; ++kz) {
    const int iz = od * g.SD - g.PD + kz;
    if (iz < 0 || iz >= g.D) continue;
    for (int ky = 0; ky < g.KH; ++ky) {
      const int iy = oh * g.SH - g.PH + ky;
      if (iy < 0 || iy >= g.H) continue;
      for (int kx = 0; kx < g.KW; ++kx) {
        const int ix = ow * g.SW - g.PW + kx;
        if (ix < 0 || ix >= g.W) continue;
        const int8_t* row = x + ((((long long)b * g.D + iz) * g.H + iy) * g.W + ix) * g.Cin;
        const int* wr = wp + (long long)((kz * g.KH + ky) * g.KW + kx) * g.G * g.Cout + co;
        for (int w = 0; w < g.G; ++w)
          acc = __dp4a(x_word<ALIGNED>(row, w, g.Cin), wr[(long long)w * g.Cout], acc);
      }
    }
  }
  wg::S8Store<OUT>::one(out + v * g.Cout + co, acc, s_x ? s_x[b] : 0.f, s_w ? s_w[co] : 0.f,
                        bias, co);
}

template <int OUT>
int launch_general(const void* x, const void* wp, const float* s_x, const float* s_w,
                   const float* bias, void* out, const Geometry& g, cudaStream_t stream) {
  const long long voxels = (long long)g.B * g.OD * g.OH * g.OW;
  const long long gx = (voxels + 3) / 4;
  if (gx > 2147483647LL) return ERR_SHAPE;
  const dim3 grid((unsigned)gx, (unsigned)((g.Cout + 63) / 64));
  const dim3 block(64, 4);
  using T = typename wg::S8Store<OUT>::T;
  if (g.Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0)
    conv_s8_general_kernel<OUT, true><<<grid, block, 0, stream>>>(
        (const int8_t*)x, (const int*)wp, s_x, s_w, bias, (T*)out, g, voxels);
  else
    conv_s8_general_kernel<OUT, false><<<grid, block, 0, stream>>>(
        (const int8_t*)x, (const int*)wp, s_x, s_w, bias, (T*)out, g, voxels);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S3: the exact per-row int8 quantiser.

constexpr int QT = 256;  // threads a block

template <typename T, int VEC>
struct Vec;  // VEC values of T loaded as one 16-byte access

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
  }
};

template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) {
    if constexpr (sizeof(T) == 2)
      v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    else
      v[0] = *reinterpret_cast<const float*>(p);
  }
};

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Launch 1: partial[row * P + p] = max |x| over block p's share of the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(QT) quant_amax_kernel(const T* __restrict__ x, long long n,
                                                        float* __restrict__ partial) {
  const T* xr = x + (long long)blockIdx.y * n;
  float m = 0.f;
  for (long long i = ((long long)blockIdx.x * QT + threadIdx.x) * VEC; i < n;
       i += (long long)gridDim.x * QT * VEC) {
    float v[VEC];
    Vec<T, VEC>::load(xr + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  __shared__ float warps[QT / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max(threadIdx.x < QT / 32 ? warps[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = m;
  }
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* q, const int8_t (&v)[VEC]);
template <>
__device__ __forceinline__ void store_q<8>(int8_t* q, const int8_t (&v)[8]) {
  *reinterpret_cast<uint2*>(q) = *reinterpret_cast<const uint2*>(v);
}
template <>
__device__ __forceinline__ void store_q<4>(int8_t* q, const int8_t (&v)[4]) {
  *reinterpret_cast<uint32_t*>(q) = *reinterpret_cast<const uint32_t*>(v);
}
template <>
__device__ __forceinline__ void store_q<1>(int8_t* q, const int8_t (&v)[1]) {
  *q = v[0];
}

// Launch 2: the row's scale from its P partials, then q for block p's share.
template <typename T, int VEC>
__global__ void __launch_bounds__(QT)
quant_int8_kernel(const T* __restrict__ x, long long n, const float* __restrict__ partial, int P,
                  int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const long long row = blockIdx.y;
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    float m = 0.f;
    for (int i = threadIdx.x; i < P; i += 32) m = fmaxf(m, partial[row * P + i]);
    m = warp_max(m);
    if (threadIdx.x == 0) {
      const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
      s_scale = scale;
      if (blockIdx.x == 0) scale_out[row] = scale;
    }
  }
  __syncthreads();
  const float scale = s_scale;
  const T* xr = x + row * n;
  int8_t* qr = q + row * n;
  for (long long i = ((long long)blockIdx.x * QT + threadIdx.x) * VEC; i < n;
       i += (long long)gridDim.x * QT * VEC) {
    float v[VEC];
    Vec<T, VEC>::load(xr + i, v);
    int8_t out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v[e], scale)), -127.f), 127.f);
    store_q<VEC>(qr + i, out);
  }
}

template <typename T, int VEC>
int launch_quant(const void* x, long long rows, long long n, int P, int Q, float* partial,
                 void* q, float* scale, cudaStream_t stream) {
  quant_amax_kernel<T, VEC><<<dim3(P, (unsigned)rows), QT, 0, stream>>>((const T*)x, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_int8_kernel<T, VEC><<<dim3(Q, (unsigned)rows), QT, 0, stream>>>(
      (const T*)x, n, partial, P, (int8_t*)q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1. xq [B, D, H, W, Cin] int8 (16-byte aligned, Cin % 16 == 0), wq [Cout,
// 27, Cin] int8 contiguous, s_x [B] and s_w [Cout] fp32, bias [Cout] fp32 or
// null, out [B, D, H, W, Cout] of `out_kind` (0 int32: the sums, s_x, s_w
// and bias unused; 1 fp32; 2 bf16). The plan (box, bn; 4 stages) is
// `igemm_plan`'s, as for K5.
int conv3d_s8(const void* xq, const void* wq, const void* s_x, const void* s_w, const void* bias,
              void* out, int B, int D, int H, int W, int Cin, int Cout, int bw, int bh, int bd,
              int bn, int stages, int out_kind, void* stream) {
  return wg::conv3d_s8_at<1>(xq, wq, s_x, s_w, bias, out, B, D, H, W, Cin, Cout, bw, bh, bd, bn,
                             stages, out_kind, stream);
}

// S2. xq [B, D, H, W, Cin] int8 contiguous; wp [KD*KH*KW, ceil(Cin/4), Cout]
// int32 words (four channels each, byte i = channel 4g + i, channels past
// Cin zero); `dims` = {B, D, H, W, Cin, Cout, KD, KH, KW, SD, SH, SW, PD,
// PH, PW, OD, OH, OW} (PD, PH, PW the leading pads); out [B, OD, OH, OW,
// Cout] of `out_kind` as for conv3d_s8.
int conv_s8_general(const void* xq, const void* wp, const void* s_x, const void* s_w,
                    const void* bias, void* out, const int* dims, int out_kind, void* stream) {
  Geometry g;
  g.B = dims[0], g.D = dims[1], g.H = dims[2], g.W = dims[3], g.Cin = dims[4], g.Cout = dims[5];
  g.KD = dims[6], g.KH = dims[7], g.KW = dims[8], g.SD = dims[9], g.SH = dims[10], g.SW = dims[11];
  g.PD = dims[12], g.PH = dims[13], g.PW = dims[14], g.OD = dims[15], g.OH = dims[16],
  g.OW = dims[17];
  g.G = (g.Cin + 3) / 4;
  const int* all = dims;
  for (int i = 0; i < 18; ++i)
    if (all[i] < (i >= 12 && i < 15 ? 0 : 1)) return ERR_SHAPE;
  if (out_kind != wg::kS8Int32 && (s_x == nullptr || s_w == nullptr)) return ERR_SHAPE;
  const float *sx = (const float*)s_x, *sw = (const float*)s_w, *bs = (const float*)bias;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case wg::kS8Int32: return launch_general<wg::kS8Int32>(xq, wp, sx, sw, bs, out, g, s);
    case wg::kS8Float: return launch_general<wg::kS8Float>(xq, wp, sx, sw, bs, out, g, s);
    case wg::kS8Bf16: return launch_general<wg::kS8Bf16>(xq, wp, sx, sw, bs, out, g, s);
    default: return ERR_SHAPE;
  }
}

// S3. x [rows, n] fp32 (is_bf16 0) or bf16 (1), contiguous; partial [rows,
// P] fp32 scratch; q [rows, n] int8; scale [rows] fp32. `vec` is 4 (fp32) or
// 8 (bf16) when n is a multiple of it and x is 16-byte aligned, else 1. P
// blocks a row find its max, Q blocks a row quantise it.
int quantize_int8_rows(const void* x, int is_bf16, long long rows, long long n, int vec, int P,
                       int Q, void* partial, void* q, void* scale, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || P < 1 || Q < 1 || Q > 65535) return ERR_SHAPE;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(q) & 7) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  float *pt = (float*)partial, *sc = (float*)scale;
  if (is_bf16) {
    if (vec == 8 && n % 8 == 0 && aligned)
      return launch_quant<__nv_bfloat16, 8>(x, rows, n, P, Q, pt, q, sc, s);
    if (vec != 1) return ERR_SHAPE;
    return launch_quant<__nv_bfloat16, 1>(x, rows, n, P, Q, pt, q, sc, s);
  }
  if (vec == 4 && n % 4 == 0 && aligned) return launch_quant<float, 4>(x, rows, n, P, Q, pt, q, sc, s);
  if (vec != 1) return ERR_SHAPE;
  return launch_quant<float, 1>(x, rows, n, P, Q, pt, q, sc, s);
}

const char* conv_int8_error_string(int code) {
  return code == ERR_SHAPE ? "the launcher refused the shape or arguments" : wg::error_string(code);
}

}  // extern "C"
