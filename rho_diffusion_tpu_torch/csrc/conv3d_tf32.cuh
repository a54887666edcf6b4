// K5 in fp32 on Hopper's tensor cores: the implicit GEMM of
// conv3d_wgmma.cuh with every product split into three TF32 products
// (3xTF32), launched from conv3d.cu's `conv3d_igemm_tf32`.
//
// Replaces, for fp32 with Cin % 4 == 0 and Cout > 1, the TPU kernel
// `_conv3d_kernel` / `conv3d_pallas` (rho_diffusion_tpu/ops/pallas/
// conv3d.py:102/140, pallas_call at :180), forward and, on flipped
// IO-transposed weights, dgrad (:242-250):
//   out[b,d,h,w,co] = bias[co] + sum_{dz,dy,dx,ci} x[b,d+dz-1,h+dy-1,w+dx-1,ci] * W[co,ci,dz,dy,dx]
// in fp32. Before it the direct kernel (conv3d.cu) ran these convs on the
// CUDA cores at 2-33 TFLOP/s, its rate falling with each UNet level as its
// blocks of 8 x 32 voxels x 16 channels left the card idle.
//
// What bounds it on the H100: 27 Cin multiply-adds an output against ~Cin
// inputs read, so operations. One TF32 product keeps 10 mantissa bits and
// misses the fp32 tolerance of the JAX package's tests (1e-4), so each
// operand is split a = a_hi + a_lo (a_hi = tf32(a), a_lo = tf32(a - a_hi))
// and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, in the
// fp32 accumulator, which drops only a_lo b_lo (~2^-22 relative): three
// TF32 products at 495 TFLOP/s, 165 TFLOP/s of fp32 work, 2.5x the CUDA
// cores' fp32 peak. A batch-8 UNet forward's convs (3.94 TFLOP) take at
// least 23.9 ms so, 58.9 at the FMA peak.
//
// The design is K5's block (conv3d_wgmma.cuh) with fp32 operands:
//   * A is the same TMA box of 128 voxels (zero fill as SAME padding), now
//     32 fp32 channels a k-step: 128 bytes, the swizzle span, 16 KB a stage.
//     wgmma takes tf32 only K-major and A cannot be split by TMA, so each
//     consumer thread reads its A fragments (16 values a k-step) from the
//     swizzled stage into registers, splits them there and feeds both terms
//     to wgmma from registers.
//   * B, the weights [Cout, 27, Cin], is split once a call by
//     `tf32_split_kernel` (conv3d.cu) into w_hi and w_lo; both arrive by TMA
//     (32 channels, one tap, BN outputs a box), 2 BN 128 bytes a stage. The
//     ring: BN 64 or 128 with 4 stages (128 or 192 KB); the plan
//     (ops/kernels/conv3d.py `tf32_plan`) picks BN by K5's cost rule.
//   * Twelve m64nBNk8 products a k-step into a partial sum, waited for before
//     the stage is released (a first version that keeps no group in flight;
//     the two consumer warpgroups overlap each other's fragment loads and
//     products); the partial sum is then added to the total in registers.
//     The tensor cores' fp32 accumulator rounds toward zero: summing all 27
//     Cin/8 x 3 products in it drifts by up to ~1e-4 relative at Cin = 512
//     (measured on the H100), past the fp32 tolerance; a k-step's 12 drift
//     ~1e-6. The partial sum costs BN/2 registers, which caps BN at 128.
//   * Epilogue: the fp32 sum plus bias; rows outside the volume and columns
//     past Cout are not written.
// Every mbarrier wait traps after ~5 s (tma.cuh).

#pragma once

#include <stdint.h>

#include "conv3d_wgmma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace ct {

constexpr int BK = 32;                  // fp32 channels a k-step: 128 bytes
constexpr int A_BYTES = wg::BM * BK * 4;  // 16 KB a stage

__host__ __device__ constexpr int term_bytes(int bn) { return bn * BK * 4; }
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + 2 * term_bytes(bn); }
// the ring, its barriers, and room to align the ring to the swizzle's 1024 bytes
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return stages * stage_bytes(bn) + 2 * stages * 8 + 1024;
}

// A weight tensor [Cout, 27, C] fp32 as a 3-D map read in boxes of 32
// channels, one tap and `bn` outputs; channels past C read as zeros.
inline bool encode_weights(wg::EncodeTiled encode, CUtensorMap* map, const void* w, int Cout,
                           int C, int bn) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, 27, (cuuint64_t)Cout};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)C * 4 * 27};
  const cuuint32_t box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)bn};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks one fp32 conv and its plan, and encodes its three tensor maps and
// its Problem. x: [B, D, H, W, Cin] fp32, 16-byte aligned, Cin % 4 == 0;
// w_hi, w_lo: [Cout, 27, Cin] fp32, contiguous, 16-byte aligned. The plan:
// a box of bw x bh x bd = 128 voxels and BN 64 or 128 with 4 stages.
// Returns 0 or a wg::ERR_ code.
inline int conv_setup(const void* x, const void* w_hi, const void* w_lo, int B, int D, int H,
                      int W, int Cin, int Cout, int bw, int bh, int bd, int bn, int stages,
                      CUtensorMap* x_map, CUtensorMap* whi_map, CUtensorMap* wlo_map,
                      wg::Problem* p) {
  const bool box_ok = bw >= 1 && bh >= 1 && bd >= 1 && bw <= 256 && bh <= 256 && bd <= 256 &&
                      bw * bh * bd == wg::BM;
  const bool plan_ok = (bn == 64 || bn == 128) && stages == 4;
  if (!box_ok || !plan_ok || Cin < 4 || Cin % 4 || Cout < 1 || B < 1 || D < 1 || H < 1 || W < 1 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_hi) |
        reinterpret_cast<uintptr_t>(w_lo)) & 15))
    return wg::ERR_PLAN;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return wg::ERR_ENCODE_FN;

  const cuuint64_t c4 = (cuuint64_t)Cin * 4;  // bytes per voxel
  const cuuint64_t x_dims[5] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                                (cuuint64_t)B};
  const cuuint64_t x_strides[4] = {c4, c4 * W, c4 * W * H, c4 * W * H * D};
  const cuuint32_t x_box[5] = {(cuuint32_t)BK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  // OOB_FILL_NONE: elements outside the tensor read as zeros (SAME padding)
  if (encode(x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x), x_dims, x_strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return wg::ERR_X_MAP;
  if (!encode_weights(encode, whi_map, w_hi, Cout, Cin, bn) ||
      !encode_weights(encode, wlo_map, w_lo, Cout, Cin, bn))
    return wg::ERR_W_MAP;

  p->B = B, p->D = D, p->H = H, p->W = W, p->Cout = Cout;
  p->bw = bw, p->bh = bh, p->bd = bd;
  p->tiles_w = (W + bw - 1) / bw, p->tiles_h = (H + bh - 1) / bh, p->tiles_d = (D + bd - 1) / bd;
  p->n_tiles = (Cout + bn - 1) / bn;
  p->cchunks = (Cin + BK - 1) / BK;
  return p->blocks() > 2147483647LL ? wg::ERR_PLAN : 0;
}

// x split for the tensor cores, elementwise: hi = tf32(x), lo = tf32(x - hi).
__global__ void tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h, l;
    wg::split_tf32(x[i], h, l);
    reinterpret_cast<uint32_t*>(hi)[i] = h;
    reinterpret_cast<uint32_t*>(lo)[i] = l;
  }
}

// One k-step's products for this warpgroup: its 64 rows of the A stage
// (read in the tf32 register A layout and split in registers) times both
// weight terms, 4 k8 slices of 32 bytes each, the small terms first, into
// `part` (overwritten).
template <int BN>
__device__ __forceinline__ void kstep_products(float (&part)[BN / 2], uint32_t a_stage,
                                               uint32_t b_hi, uint32_t b_lo) {
  const int lane = threadIdx.x & 31, qd = lane & 3;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // (row, k) = (r0 + 8 (e & 1), 8 kk + qd + 4 (e >> 1)): 16-byte chunk
      // 2 kk + (e >> 1) of the row, word qd in it
      float v;
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(a_stage + wg::sw128_offset(r0 + (e & 1) * 8, 2 * kk + (e >> 1)) + qd * 4));
      wg::split_tf32(v, ah[kk][e], al[kk][e]);
    }
  // the first product overwrites `part`; zeros here (not a fence) let the
  // compiler give its registers to other values between the k-steps
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
  wg::fence_regs(ah);
  wg::fence_regs(al);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::WgmmaTf32RS<BN>::mma(part, al[kk], wg::sw128_desc(b_hi + kk * 32), kk > 0 ? 1 : 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::WgmmaTf32RS<BN>::mma(part, ah[kk], wg::sw128_desc(b_lo + kk * 32));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::WgmmaTf32RS<BN>::mma(part, ah[kk], wg::sw128_desc(b_hi + kk * 32));
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(part);
  wg::fence_regs(ah);
  wg::fence_regs(al);
}

// Writes the accumulator row `half` of this thread to output row `orow`,
// columns [n0, n0 + BN): the fp32 sum plus bias (or none); columns past Cout
// are not written.
template <int BN>
__device__ __forceinline__ void store_row(float* orow, const float (&acc)[BN / 2], int half,
                                          int n0, int Cout, const float* bias) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + (lane & 3) * 2;
    const float v0 = acc[j * 4 + half * 2] + (bias && n < Cout ? bias[n] : 0.f);
    const float v1 = acc[j * 4 + half * 2 + 1] + (bias && n + 1 < Cout ? bias[n + 1] : 0.f);
    if (n + 1 < Cout && (Cout & 1) == 0) {
      *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
    } else {
      if (n < Cout) orow[n] = v0;
      if (n + 1 < Cout) orow[n + 1] = v1;
    }
  }
}

// One block: the box of 128 voxels at (b, d0, h0, w0) times output channels
// [n0, n0 + BN). Threads 0-255 are the two consumer warpgroups, 256-383 the
// producer warpgroup, of which one thread issues every load.
template <int BN, int STAGES>
__global__ void __launch_bounds__(wg::THREADS, 1)
conv3d_tf32_kernel(__grid_constant__ const CUtensorMap x_map,
                   __grid_constant__ const CUtensorMap whi_map,
                   __grid_constant__ const CUtensorMap wlo_map, const float* __restrict__ bias,
                   float* __restrict__ out, const wg::Problem p) {
  constexpr int TERM = term_bytes(BN);
  constexpr int STAGE = stage_bytes(BN);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern follows shared-memory address bits: align to 1024
  uint8_t* ring = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  int t = blockIdx.x;  // N tiles fastest: the tiles of one box run together and share its A in L2
  const int n0 = (t % p.n_tiles) * BN;
  t /= p.n_tiles;
  const int w0 = (t % p.tiles_w) * p.bw;
  t /= p.tiles_w;
  const int h0 = (t % p.tiles_h) * p.bh;
  t /= p.tiles_h;
  const int d0 = (t % p.tiles_d) * p.bd;
  const int b = t / p.tiles_d;
  const int ksteps = 27 * p.cchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], wg::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == wg::CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    wg::regs_dec<40>();
    if (threadIdx.x == wg::CONSUMERS * 128) {
      wg::prefetch_map(&x_map);
      wg::prefetch_map(&whi_map);
      wg::prefetch_map(&wlo_map);
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % STAGES;
        wg::mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);  // the first round finds every stage free
        wg::mbar_expect_tx(&full[s], STAGE);
        const int tap = ks / p.cchunks;
        const int c0 = (ks - tap * p.cchunks) * BK;
        uint8_t* st = ring + s * STAGE;
        wg::tma_load_5d(st, &x_map, &full[s], c0, w0 + tap % 3 - 1, h0 + (tap / 3) % 3 - 1,
                        d0 + tap / 9 - 1, b);
        wg::tma_load_3d(st + A_BYTES, &whi_map, &full[s], c0, tap, n0);
        wg::tma_load_3d(st + A_BYTES + TERM, &wlo_map, &full[s], c0, tap, n0);
      }
    }
  } else {
    // ---- consumers: rows [64 * group, 64 * group + 64) of the box ----
    wg::regs_inc<232>();
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t base = wg::smem_u32(ring);
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % STAGES;
      wg::mbar_wait(&full[s], (ks / STAGES) & 1);
      const uint32_t st = base + s * STAGE;
      kstep_products<BN>(part, st + group * (64 * BK * 4), st + A_BYTES, st + A_BYTES + TERM);
      if (threadIdx.x % 128 == 0) wg::mbar_arrive(&empty[s]);
      // the k-step's 12 products were summed in the tensor cores' accumulator,
      // which rounds toward zero; their sum joins the total here, rounded to
      // nearest, so that bias does not grow with K
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // ---- epilogue: rows outside the volume are not written ----
    const int boxhw = p.bw * p.bh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wg::acc_row(half);
      const int dd = d0 + r / boxhw, hh = h0 + (r / p.bw) % p.bh, ww = w0 + r % p.bw;
      if (dd >= p.D || hh >= p.H || ww >= p.W) continue;
      store_row<BN>(out + ((((long long)b * p.D + dd) * p.H + hh) * p.W + ww) * p.Cout, acc, half,
                    n0, p.Cout, bias);
    }
  }
}

}  // namespace ct
