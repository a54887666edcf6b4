// Bottleneck isolation of the conv's tensor-core GEMM (K5, conv3d.cu), for
// Hopper (sm_90a): variants of K5 that each take one factor out, run at the
// UNet's level-1 conv, x [32, 32, 16, 16, 128] -> 128 channels in bf16.
//
// Replaces the TPU kernels of benchmarks/conv3d_variants.py, which isolate
// the Pallas conv's factors on the TPU (halo-slab DMA, patch builds, dots).
// The TPU kernels' slab DMA, W-tap pre-fold (`xw`) and 128-lane padding are
// Mosaic's and are not carried over: every variant here is K5's own block
// (conv3d_igemm.cuh: 128x64x32 tile, 4 warps, 2-stage cp.async, mma.sync
// m16n8k16 bf16, fp32 accumulators) with one factor changed, so that the
// card's conv GEMM, not the TPU's, is taken apart.
//
//   conv3d_variant_full     K7 `make_conv.kern` "full" (:51): K5's forward
//                           mainloop as it is. Its weight operand is km
//                           transposed: km's rows (dz*3+dy)*CPAD + dx*Cin + ci
//                           are K5's k = tap*Cin + ci when CPAD = 3*Cin.
//   conv3d_variant_nopatch  K7 "nopatch": the A gather drops each tap's
//                           (dz, dy) offset and keeps dx, so all 9 (dz, dy)
//                           slices read the (0, 0) tap's rows. Isolates the
//                           variety of the gather's addresses and halo tests.
//   conv3d_variant_nodma    K7 "nodma": A is never read from device memory;
//                           both A stages hold a fixed pattern
//                           ((7r + 3c) mod 17 - 8)/64 of the row r in the tile
//                           and the column c in the k-slice, written once.
//                           B as in full. Isolates the A gather's loads.
//   conv3d_bigdot_im2col +  K8 `make_bigdot.kern` (:104): an explicit patch
//   conv3d_bigdot_gemm      matrix, then one dense GEMM with K = 27*Cin. The
//                           patch does not fit in shared memory as it did in
//                           VMEM (one 128-row tile of it is 884 KB), so
//                           im2col writes the patch rows of td output depth
//                           slices of the whole batch to device memory, and the
//                           GEMM reads them back, D/td passes of both.
//                           Isolates the gather from the mainloop: the GEMM's A
//                           rows are contiguous and aligned, with no predicates.
//   conv3d_dotsonly         K9 `dots_only.kern` (:154): the same dense GEMM
//                           with A = p [P, CPAD] and K = 9*CPAD, A's column at
//                           k mod CPAD: 9 dots on one patch, so a block's A
//                           tile comes from L2 after its first pass: the
//                           mainloop's ceiling without the gather.
//
// What bounds them on the H100: the conv does 2*M*Cout*27*Cin = 231.9 GFLOP at
// the level-1 shape, 0.234 ms at 989 TFLOP/s, against 134 MB of its own
// input and output (0.040 ms at 3.35 TB/s): operations. K9's own bytes are
// 269 MB (0.080 ms), still operations. K8's design moves the 1.81 GB patch
// through device memory twice (written, read): 1.08 ms, its own floor, above
// the conv's bound. Nothing here is tuned: a variant that differed from K5 in
// more than its one factor would measure nothing.
//
// Each launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError(). The Python wrapper checks shapes, alignment and the
// divisibility the dense GEMM needs (rows per batch % 128, Cout % 64,
// K % 32, CPAD % 32).

#include "conv3d_igemm.cuh"

namespace {

using igemm::BK;
using igemm::BM;
using igemm::BN;
using igemm::THREADS;

// K5's kernel under another name: the same signature and body (the bias
// pointer is a run-time argument, null here, as it is for K5's dgrad), so
// `full` compiles to K5's code, registers and occupancy included.
#define CONV_VARIANT_KERNEL(NAME, GATHER)                                                       \
  __global__ void __launch_bounds__(THREADS)                                                    \
  NAME(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,                \
       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int D,  \
       int H, int W, int Cin, int Cout) {                                                       \
    __shared__ __align__(16) igemm::ATile As[2];                                                \
    __shared__ __align__(16) igemm::BTile Bs[2];                                                \
    igemm::conv3d_igemm_block<GATHER>(As, Bs, x, w, bias, out, B, D, H, W, Cin, Cout);          \
  }

CONV_VARIANT_KERNEL(conv3d_variant_full_kernel, igemm::kFull)
CONV_VARIANT_KERNEL(conv3d_variant_nopatch_kernel, igemm::kNoPatch)
CONV_VARIANT_KERNEL(conv3d_variant_nodma_kernel, igemm::kNoDma)

// patch[((b*td + t)*H + h)*W + w][tap*Cin + ci] = x[b, d0+t+dz-1, h+dy-1, w+dx-1, ci],
// zero outside the volume; one thread per 16-byte chunk (8 channels), so a
// warp writes 512 contiguous bytes of a patch row.
__global__ void __launch_bounds__(256)
conv3d_bigdot_im2col_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ patch,
                            int B, int D, int H, int W, int Cin, int d0, int td) {
  const int K = 27 * Cin;
  const int chunks = K / 8;
  const long long total = (long long)B * td * H * W * chunks;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx % chunks) * 8;
  long long r = idx / chunks;
  const int tap = k / Cin, ci = k - tap * Cin;
  long long t = r;
  const int w = (int)(t % W);
  t /= W;
  const int h = (int)(t % H);
  t /= H;
  const int dd = (int)(t % td);
  const long long b = t / td;
  const int d = d0 + dd + tap / 9 - 1, hh = h + (tap / 3) % 3 - 1, ww = w + tap % 3 - 1;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (d >= 0 && d < D && hh >= 0 && hh < H && ww >= 0 && ww < W)
    v = *reinterpret_cast<const uint4*>(x + ((((b * D + d) * H + hh) * (long long)W + ww) * Cin + ci));
  *reinterpret_cast<uint4*>(patch + r * K + k) = v;
}

// out[z][m][n] = sum_k a[z][m][k mod lda] * w[n][k] for k < K: batch z's A
// rows lda apart from a + z*a_bstride, its output rows N apart from
// out + z*o_bstride. Every tile is full: no predicates.
__device__ __forceinline__ void dense_gemm_block(igemm::ATile* As, igemm::BTile* Bs,
                                                 const __nv_bfloat16* __restrict__ a, int lda,
                                                 long long a_bstride,
                                                 const __nv_bfloat16* __restrict__ w, int K,
                                                 __nv_bfloat16* __restrict__ out, int N,
                                                 long long o_bstride) {
  const int tid = threadIdx.x;
  const int chunk = tid & 3;
  const int row = tid >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* arow = a + blockIdx.z * a_bstride + (m0 + row) * lda + chunk * 8;
  const __nv_bfloat16* wrow = w + (long long)(n0 + row) * K + chunk * 8;
  __nv_bfloat16* obase = out + blockIdx.z * o_bstride;

  auto load_stage = [&](int stage, int kt) {
    const int k = kt * BK;
    const int ka = k % lda;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      igemm::cp_async16(&As[stage][row + 32 * i][chunk * 8], arow + 32LL * i * lda + ka, true);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      igemm::cp_async16(&Bs[stage][row + 32 * j][chunk * 8], wrow + 32LL * j * K + k, true);
  };

  float acc[4][4][4];
  igemm::mainloop(As, Bs, acc, K / BK, load_stage);
  igemm::epilogue(acc, m0, m0 + BM, n0, N, nullptr,
                  [&](long long m) { return obase + m * N; });
}

#define DENSE_GEMM_KERNEL(NAME)                                                                 \
  __global__ void __launch_bounds__(THREADS)                                                    \
  NAME(const __nv_bfloat16* __restrict__ a, int lda, long long a_bstride,                       \
       const __nv_bfloat16* __restrict__ w, int K, __nv_bfloat16* __restrict__ out, int N,      \
       long long o_bstride) {                                                                   \
    __shared__ __align__(16) igemm::ATile As[2];                                                \
    __shared__ __align__(16) igemm::BTile Bs[2];                                                \
    dense_gemm_block(As, Bs, a, lda, a_bstride, w, K, out, N, o_bstride);                       \
  }

DENSE_GEMM_KERNEL(conv3d_bigdot_gemm_kernel)
DENSE_GEMM_KERNEL(conv3d_dotsonly_kernel)

typedef void (*ConvVariantKernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                                  const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
                                  int);

}  // namespace

extern "C" {

// variant: 0 full, 1 nopatch, 2 nodma. x: [B, D, H, W, Cin]; w: [Cout, 27*Cin];
// out: [B, D, H, W, Cout]; all bf16, Cin % 8 == 0.
int conv3d_variant(int variant, const void* x, const void* w, void* out, int B, int D, int H,
                   int W, int Cin, int Cout, void* stream) {
  static const ConvVariantKernel kernels[3] = {
      conv3d_variant_full_kernel, conv3d_variant_nopatch_kernel, conv3d_variant_nodma_kernel};
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  kernels[variant]<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, nullptr, (__nv_bfloat16*)out, B, D, H, W,
      Cin, Cout);
  return (int)cudaGetLastError();
}

// The patch rows of output depths [d0, d0 + td) of every batch:
// patch [B*td*H*W, 27*Cin] bf16.
int conv3d_bigdot_im2col(const void* x, void* patch, int B, int D, int H, int W, int Cin, int d0,
                         int td, void* stream) {
  const long long total = (long long)B * td * H * W * (27 * Cin / 8);
  const int threads = 256;
  conv3d_bigdot_im2col_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                                (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)patch, B, D, H, W, Cin, d0, td);
  return (int)cudaGetLastError();
}

// kernel: 0 bigdot's GEMM, 1 dots-only. `batches` x (`rows` x N) outputs;
// rows % 128 == 0, N % 64 == 0, K % 32 == 0, lda % 32 == 0.
int conv3d_dense_gemm(int kernel, const void* a, int lda, long long a_bstride, const void* w,
                      int K, void* out, int N, long long o_bstride, int rows, int batches,
                      void* stream) {
  dim3 grid((unsigned)(rows / BM), (unsigned)(N / BN), (unsigned)batches);
  auto fn = kernel == 0 ? conv3d_bigdot_gemm_kernel : conv3d_dotsonly_kernel;
  fn<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)a, lda, a_bstride,
                                                 (const __nv_bfloat16*)w, K,
                                                 (__nv_bfloat16*)out, N, o_bstride);
  return (int)cudaGetLastError();
}

const char* conv3d_variants_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
