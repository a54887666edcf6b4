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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output voxels per block
constexpr int BN = 64;           // output channels per block
constexpr int BK = 32;           // reduction depth per stage
constexpr int LDS = BK + 8;      // padded smem row (80 bytes): conflict-free fragment loads
constexpr int THREADS = 128;     // 4 warps, 2 (M) x 2 (N), each a 64 x 32 warp tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x: [B, D, H, W, Cin] bf16; w: [Cout, 27*Cin] bf16 with k = ((dz*3+dy)*3+dx)*Cin + ci;
// bias: [Cout] bf16 or null; out: [B, D, H, W, Cout] bf16.
__global__ void __launch_bounds__(THREADS)
conv3d_igemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         int B, int D, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const long long M = (long long)B * D * H * W;
  const int K = 27 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Copy assignment: every thread moves one 16-byte chunk (8 channels) per row
  // it owns; chunk = tid % 4 covers the 32-deep slice, rows tid/4 + 32*i.
  const int chunk = tid & 3;
  const int row = tid >> 2;
  int a_d[4], a_h[4], a_w[4];
  long long a_b[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long m = m0 + row + 32 * i;
    a_ok[i] = m < M;
    long long t = a_ok[i] ? m : 0;
    a_w[i] = (int)(t % W);
    t /= W;
    a_h[i] = (int)(t % H);
    t /= H;
    a_d[i] = (int)(t % D);
    a_b[i] = t / D;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k = kt * BK + chunk * 8;
    const bool kin = k < K;
    const int tap = kin ? k / Cin : 0;
    const int ci = k - tap * Cin;
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dd = a_d[i] + dz, hh = a_h[i] + dy, ww = a_w[i] + dx;
      const bool p = kin && a_ok[i] && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src =
          p ? x + ((((a_b[i] * D + dd) * H + hh) * (long long)W + ww) * Cin + ci) : x;
      cp_async16(&As[stage][row + 32 * i][chunk * 8], src, p);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + row + 32 * j;
      const bool p = kin && n < Cout;
      const __nv_bfloat16* src = p ? w + ((long long)n * K + k) : w;
      cp_async16(&Bs[stage][row + 32 * j][chunk * 8], src, p);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int KT = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int c = kk + (lane & 3) * 2;
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane >> 2);
        af[mi][0] = lds32(&As[s][r][c]);
        af[mi][1] = lds32(&As[s][r + 8][c]);
        af[mi][2] = lds32(&As[s][r][c + 8]);
        af[mi][3] = lds32(&As[s][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + (lane >> 2);
        bf[ni][0] = lds32(&Bs[s][n][c]);
        bf[ni][1] = lds32(&Bs[s][n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Epilogue: fp32 accumulator + bias, rounded once to bf16.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      __nv_bfloat16* orow = out + m * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        float v0 = acc[mi][ni][half * 2 + 0];
        float v1 = acc[mi][ni][half * 2 + 1];
        if (n + 1 < Cout && (Cout & 1) == 0) {
          if (bias) {
            v0 += __bfloat162float(bias[n]);
            v1 += __bfloat162float(bias[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < Cout) orow[n] = __float2bfloat16(v0 + (bias ? __bfloat162float(bias[n]) : 0.f));
          if (n + 1 < Cout)
            orow[n + 1] = __float2bfloat16(v1 + (bias ? __bfloat162float(bias[n + 1]) : 0.f));
        }
      }
    }
  }
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
