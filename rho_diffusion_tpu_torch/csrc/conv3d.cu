// 3x3x3 stride-1 SAME convolution on channels-last volumes, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_conv3d_kernel` / `conv3d_pallas`
// (rho_diffusion_tpu/ops/pallas/conv3d.py:102-212), forward direction:
//   out[b,d,h,w,co] = bias[co] + sum_{dz,dy,dx,ci} x[b,d+dz-1,h+dy-1,w+dx-1,ci] * W[co,ci,dz,dy,dx]
// with zero padding, fp32 accumulation, output in the input dtype.
//
// What bounds it on the H100: at the UNet's shapes the conv is an implicit GEMM
// with M = output voxels, N = Cout, K = 27*Cin, and 27*Cin multiply-adds per
// output element read from ~Cin input values -- well above the card's ~295 flop
// per byte ridge, so it is bound by tensor-core operations, not by device
// memory. The design keeps the arithmetic on the tensor cores and never
// materialises the 27x im2col matrix or a padded copy of x: each block stages a
// 128-voxel x 32-deep slice of the implicit im2col matrix straight from x into
// shared memory (16-byte cp.async, halo taps outside the volume zero-filled by
// the copy itself), plus a 64-Cout x 32-deep slice of the repacked weights,
// double-buffered so the next slice's copies overlap the current slice's
// mma.sync bf16 products. The TPU kernel's W-tap pre-fold, 128-lane padding
// and tile plan exist for Mosaic and VMEM limits and are not carried over.
// wgmma/TMA and a persistent schedule are later work.
//
// Two entry points:
//   conv3d_igemm_bf16   bf16, Cin % 8 == 0: the tensor-core implicit GEMM.
//   conv3d_direct_*     any Cin, bf16 or fp32: one thread per output element,
//                       plain fp32 FMAs. Carries the UNet's Cin=1 input conv and
//                       its fp32 output head (Cout=1), which are a few percent
//                       of the flops and do not fit the GEMM tiles.
// Each launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise.

#include "conv3d_igemm.cuh"

namespace {

using igemm::BM;
using igemm::BN;
using igemm::THREADS;

// x: [B, D, H, W, Cin] bf16; w: [Cout, 27*Cin] bf16 with k = ((dz*3+dy)*3+dx)*Cin + ci;
// bias: [Cout] bf16 or null; out: [B, D, H, W, Cout] bf16. The block's body
// (gather, mainloop, epilogue) is conv3d_igemm.cuh's.
__global__ void __launch_bounds__(THREADS)
conv3d_igemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         int B, int D, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) igemm::ATile As[2];
  __shared__ __align__(16) igemm::BTile Bs[2];
  igemm::conv3d_igemm_block<igemm::kFull>(As, Bs, x, w, bias, out, B, D, H, W, Cin, Cout);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// x: [B, D, H, W, Cin]; w: [27*Cin, Cout] (k-major, Cout contiguous); out: [B, D, H, W, Cout].
// One thread per output element, Cout fastest so a warp's weight reads coalesce.
// The wrapper guarantees every index fits in 32 bits, so no 64-bit division.
template <typename T>
__global__ void __launch_bounds__(256)
conv3d_direct_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                     T* __restrict__ out, int B, int D, int H, int W, int Cin, int Cout) {
  const int total = B * D * H * W * Cout;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % Cout;
  int t = idx / Cout;
  const int ow = t % W;
  t /= W;
  const int oh = t % H;
  t /= H;
  const int od = t % D;
  const int b = t / D;
  float acc = 0.f;
  for (int tap = 0; tap < 27; ++tap) {
    const int dd = od + tap / 9 - 1, hh = oh + (tap / 3) % 3 - 1, ww = ow + tap % 3 - 1;
    if (dd < 0 || dd >= D || hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    const T* xp = x + (((b * D + dd) * H + hh) * W + ww) * Cin;
    const T* wp = w + tap * Cin * Cout + co;
    for (int ci = 0; ci < Cin; ++ci) acc = fmaf(to_f32(xp[ci]), to_f32(wp[ci * Cout]), acc);
  }
  if (bias) acc += to_f32(bias[co]);
  out[idx] = from_f32<T>(acc);
}

template <typename T>
int launch_direct(const void* x, const void* w, const void* bias, void* out, int B, int D, int H,
                  int W, int Cin, int Cout, void* stream) {
  const long long total = (long long)B * D * H * W * Cout;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  conv3d_direct_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, B, D, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv3d_igemm_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                      int H, int W, int Cin, int Cout, void* stream) {
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3d_igemm_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)out, B, D, H, W, Cin, Cout);
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

const char* conv3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
