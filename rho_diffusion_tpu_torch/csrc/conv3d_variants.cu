// Bottleneck isolation of the conv's tensor-core GEMM (K5, conv3d.cu), for
// Hopper (sm_90a): variants of K5 that each take one factor out, run at the
// UNet's level-1 conv, x [32, 32, 16, 16, 128] -> 128 channels in bf16.
//
// Replaces the TPU kernels of benchmarks/conv3d_variants.py, which isolate
// the Pallas conv's factors on the TPU (halo-slab DMA, patch builds, dots).
// The TPU kernels' slab DMA, W-tap pre-fold (`xw`) and 128-lane padding are
// Mosaic's and are not carried over: every kernel here is K5's own block
// (conv3d_wgmma.cuh: one producer thread issuing TMA loads into a 4-stage
// mbarrier ring, two consumer warpgroups on wgmma m64nBNk16, setmaxnreg, the
// 128-byte swizzle, K5's plan and epilogue) with one factor changed, so that
// the card's conv GEMM, not the TPU's, is taken apart.
//
//   conv3d_variant_full     K7 `make_conv.kern` "full" (:51): K5's block as it
//                           is, under another name (the profiler tells the
//                           two apart); its output is K5's bit for bit. Its
//                           weight operand is km transposed: km's rows
//                           (dz*3+dy)*CPAD + dx*Cin + ci are K5's
//                           [Cout, 27, Cin] when CPAD = 3*Cin.
//   conv3d_variant_nopatch  K7 "nopatch": every tap's box drops its (dz, dy)
//                           offset and keeps dx, so the 27 loads a block
//                           issues come from 3 box addresses. Isolates the
//                           variety of the boxes' addresses.
//   conv3d_variant_nodma    K7 "nodma": A is never loaded. Before the
//                           mainloop the consumers write every ring stage
//                           with ((7r + 3c) mod 17 - 8)/64 of the row r in the
//                           box and the channel c in the k-step, swizzled as
//                           a TMA box; only B arrives by TMA. Isolates A's
//                           delivery from L2.
//   conv3d_bigdot_im2col +  K8 `make_bigdot.kern` (:104): an explicit patch
//   conv3d_bigdot_gemm      matrix, then one dense GEMM with K = 27*Cin. The
//                           patch does not fit in shared memory as it did in
//                           VMEM (one 128-row tile of it is 884 KB), so
//                           im2col writes the patch rows of td output depth
//                           slices of the whole batch to device memory, and the
//                           GEMM reads them back, D/td passes of both.
//                           Isolates the gather from the mainloop: the GEMM's A
//                           is a 2-D map, one box a k-step.
//   conv3d_dotsonly         K9 `dots_only.kern` (:154): the same dense GEMM
//                           with A = p [P, CPAD] and B = km^T as [Cout, 9,
//                           CPAD]: tap j's k-steps load A's box at the same
//                           columns as every other tap's, so 9 dots on one
//                           patch, a block's A from L2 after its first tap:
//                           the mainloop's ceiling without the gather.
//
// The dense GEMM (`dense_gemm_block`): A is a 2-D map [rows_total, C] read in
// boxes of 64 columns x 128 rows, B a 3-D map [Cout, taps, C] in boxes of
// (64, 1, BN), both with the 128-byte swizzle; k-step (tap, chunk) loads A
// at (chunk*64, row0) and B at (chunk*64, tap, n0). Zero fill past C ends
// each tap's columns, so no k-step crosses into the next tap and C needs no
// alignment beyond the map's (C % 8 == 0: 16-byte row strides). Batch z's
// rows start at A row z*rows and go to out + z*o_bstride; rows past `rows`
// and columns past Cout are not written.
//
// What bounds them on the H100: the conv does 2*M*Cout*27*Cin = 231.9 GFLOP at
// the level-1 shape, 0.234 ms at 989 TFLOP/s, against 134 MB of its own
// input and output (0.040 ms at 3.35 TB/s): operations. K9's own bytes are
// 269 MB (0.080 ms), still operations; its A comes from L2 at 64 flop per
// L2 byte, as K5's does at level 1 (BN = 128). K8's GEMM reads the 1.81 GB
// patch once: 0.561 ms, so it is bound by device memory (128 flop per patch
// byte at BN = Cout = 128, under the ~295 ridge); a 4-stage ring of 32 KB
// stages on each of 132 SMs keeps ~17 MB in flight. K8's design moves the
// patch twice (written, read): 1.08 ms, its own floor, above the conv's
// bound. Nothing here is tuned: a variant that differed from K5 in more than
// its one factor would measure nothing.
//
// Each launcher runs on the caller's stream, allocates nothing and returns 0,
// a CUDA error code or one of conv3d_wgmma.cuh's ERR_ codes
// (conv3d_variants_error_string names both).

#include "conv3d_wgmma.cuh"

namespace {

using wg::A_BYTES;
using wg::BK;
using wg::BM;
using wg::CONSUMERS;
using wg::THREADS;

constexpr int STAGES = 4;  // K5's plan's ring; the dense GEMM's too

// K7: K5's block with one factor changed; the bias pointer is a run-time
// argument (null here, as for K5's dgrad), so `full` is K5's code.
#define CONV_VARIANT_KERNEL(NAME, VARIANT)                                                     \
  template <int BN>                                                                           \
  __global__ void __launch_bounds__(THREADS, 1)                                               \
  NAME(__grid_constant__ const CUtensorMap x_map, __grid_constant__ const CUtensorMap w_map,  \
       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,               \
       const wg::Problem p) {                                                                 \
    wg::conv3d_igemm_block<BN, STAGES, VARIANT>(x_map, w_map, bias, out, p);                  \
  }

CONV_VARIANT_KERNEL(conv3d_variant_full_kernel, wg::kFull)
CONV_VARIANT_KERNEL(conv3d_variant_nopatch_kernel, wg::kNoPatch)
CONV_VARIANT_KERNEL(conv3d_variant_nodma_kernel, wg::kNoDma)

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

// One dense GEMM launch (checked by the launcher).
struct DenseProblem {
  int rows;             // A rows, and output rows, per batch
  int N;                // output channels
  int m_tiles;          // ceil(rows / BM)
  int n_tiles;          // ceil(N / BN)
  int taps;             // B's taps: k-steps of each A column chunk
  int cchunks;          // ceil(C / BK)
  long long o_bstride;  // elements between two batches' outputs
};

// One block: rows [m0, m0 + 128) of batch z times output channels
// [n0, n0 + BN); the threads' roles as in K5's block.
template <int BN>
__device__ __forceinline__ void dense_gemm_block(const CUtensorMap& a_map, const CUtensorMap& w_map,
                                                 __nv_bfloat16* __restrict__ out,
                                                 const DenseProblem& q) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const wg::Ring<BN, STAGES> ring(smem_raw);

  int t = blockIdx.x;  // N tiles fastest, as in K5: they share the A tile in L2
  const int n0 = (t % q.n_tiles) * BN;
  t /= q.n_tiles;
  const int m0 = (t % q.m_tiles) * BM;
  const int z = t / q.m_tiles;
  const int ksteps = q.taps * q.cchunks;

  ring.init();
  const int group = threadIdx.x / 128;
  if (group == CONSUMERS) {
    wg::regs_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      wg::prefetch_map(&a_map);
      wg::prefetch_map(&w_map);
      wg::produce(ring, ksteps, A_BYTES + wg::b_bytes(BN), [&](int ks, int s) {
        const int tap = ks / q.cchunks;
        const int c0 = (ks - tap * q.cchunks) * BK;
        wg::tma_load_2d(ring.a + s * A_BYTES, &a_map, &ring.full[s], c0, z * q.rows + m0);
        wg::tma_load_3d(ring.b + s * wg::b_bytes(BN), &w_map, &ring.full[s], c0, tap, n0);
      });
    }
  } else {
    wg::regs_inc<232>();
    float acc[BN / 2];
    wg::consume(acc, ring, ksteps, group);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wg::acc_row(half);
      if (m >= q.rows) continue;
      wg::store_row<BN>(out + z * q.o_bstride + (long long)m * q.N, acc, half, n0, q.N, nullptr);
    }
  }
}

#define DENSE_GEMM_KERNEL(NAME)                                                                \
  template <int BN>                                                                           \
  __global__ void __launch_bounds__(THREADS, 1)                                               \
  NAME(__grid_constant__ const CUtensorMap a_map, __grid_constant__ const CUtensorMap w_map,  \
       __nv_bfloat16* __restrict__ out, const DenseProblem q) {                               \
    dense_gemm_block<BN>(a_map, w_map, out, q);                                               \
  }

DENSE_GEMM_KERNEL(conv3d_bigdot_gemm_kernel)
DENSE_GEMM_KERNEL(conv3d_dotsonly_kernel)

template <int BN>
int launch_variant(int variant, const CUtensorMap& x_map, const CUtensorMap& w_map, void* out,
                   const wg::Problem& p, cudaStream_t stream) {
  constexpr int smem = wg::smem_bytes(BN, STAGES);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  static unsigned long long ready[3];
  auto kernel = variant == wg::kFull      ? conv3d_variant_full_kernel<BN>
                : variant == wg::kNoPatch ? conv3d_variant_nopatch_kernel<BN>
                                          : conv3d_variant_nodma_kernel<BN>;
  const cudaError_t err = wg::smem_attribute_once(kernel, smem, &ready[variant]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks(), THREADS, smem, stream>>>(x_map, w_map, nullptr,
                                                          (__nv_bfloat16*)out, p);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_dense(int kernel, const CUtensorMap& a_map, const CUtensorMap& w_map, void* out,
                 const DenseProblem& q, long long blocks, cudaStream_t stream) {
  constexpr int smem = wg::smem_bytes(BN, STAGES);
  static_assert(smem <= wg::SMEM_LIMIT, "the ring does not fit in shared memory");
  static unsigned long long ready[2];
  auto fn = kernel == 0 ? conv3d_bigdot_gemm_kernel<BN> : conv3d_dotsonly_kernel<BN>;
  const cudaError_t err = wg::smem_attribute_once(fn, smem, &ready[kernel]);
  if (err != cudaSuccess) return (int)err;
  fn<<<(unsigned)blocks, THREADS, smem, stream>>>(a_map, w_map, (__nv_bfloat16*)out, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 full, 1 nopatch, 2 nodma. x: [B, D, H, W, Cin]; w: [Cout, 27*Cin]
// (km transposed); out: [B, D, H, W, Cout]; all bf16. The plan is K5's
// (ops/kernels/conv3d.py `igemm_plan`), checked as K5's launcher checks it;
// only its 4-stage ring has instances here.
int conv3d_variant(int variant, const void* x, const void* w, void* out, int B, int D, int H,
                   int W, int Cin, int Cout, int bw, int bh, int bd, int bn, int stages,
                   void* stream) {
  if (variant < 0 || variant > 2 || stages != STAGES) return wg::ERR_PLAN;
  CUtensorMap x_map, w_map;
  wg::Problem p;
  const int err = wg::conv_setup(x, w, B, D, H, W, Cin, Cout, bw, bh, bd, bn, stages, &x_map,
                                 &w_map, &p);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return launch_variant<64>(variant, x_map, w_map, out, p, s);
    case 128: return launch_variant<128>(variant, x_map, w_map, out, p, s);
    case 192: return launch_variant<192>(variant, x_map, w_map, out, p, s);
    default: return launch_variant<256>(variant, x_map, w_map, out, p, s);
  }
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

// kernel: 0 bigdot's GEMM, 1 dots-only. out[z][m][n] = sum over taps j and
// c < C of a[z*rows + m][c] * w[n][j][c], for `batches` x `rows` rows:
// a [batches*rows, C], w [N, taps, C], all bf16, a and w 16-byte aligned,
// C % 8 == 0; output row m of batch z at out + z*o_bstride + m*N. bn: the N
// tile (64, 128, 192 or 256; ops/kernels/conv3d_variants.py `dense_plan`).
int conv3d_dense_gemm(int kernel, const void* a, int C, int taps, const void* w, void* out, int N,
                      long long o_bstride, int rows, int batches, int bn, void* stream) {
  const bool bn_ok = bn == 64 || bn == 128 || bn == 192 || bn == 256;
  if (kernel < 0 || kernel > 1 || !bn_ok || C < 8 || C % 8 || taps < 1 || N < 1 || rows < 1 ||
      batches < 1 || (long long)rows * batches > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(a) & 15) || (reinterpret_cast<uintptr_t>(w) & 15))
    return wg::ERR_PLAN;
  DenseProblem q;
  q.rows = rows, q.N = N, q.taps = taps, q.o_bstride = o_bstride;
  q.m_tiles = (rows + BM - 1) / BM;
  q.n_tiles = (N + bn - 1) / bn;
  q.cchunks = (C + BK - 1) / BK;
  const long long blocks = (long long)batches * q.m_tiles * q.n_tiles;
  if (blocks > 2147483647LL) return wg::ERR_PLAN;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return wg::ERR_ENCODE_FN;

  CUtensorMap a_map, w_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)C, (cuuint64_t)rows * batches};
  const cuuint64_t a_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t a_box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a), a_dims, a_strides,
             a_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return wg::ERR_X_MAP;
  if (!wg::encode_weights(encode, &w_map, w, N, taps, C, bn)) return wg::ERR_W_MAP;

  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return launch_dense<64>(kernel, a_map, w_map, out, q, blocks, s);
    case 128: return launch_dense<128>(kernel, a_map, w_map, out, q, blocks, s);
    case 192: return launch_dense<192>(kernel, a_map, w_map, out, q, blocks, s);
    default: return launch_dense<256>(kernel, a_map, w_map, out, q, blocks, s);
  }
}

const char* conv3d_variants_error_string(int code) { return wg::error_string(code); }

}  // extern "C"
