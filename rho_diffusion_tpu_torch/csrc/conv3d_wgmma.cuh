// K5 on Hopper: the 3x3x3 stride-1 SAME conv as an implicit GEMM whose
// operands arrive by TMA and whose products run on wgmma.
//
// Replaces the TPU kernel `_conv3d_kernel` / `conv3d_pallas`
// (rho_diffusion_tpu/ops/pallas/conv3d.py:102/140, pallas_call at :180),
// forward and, on flipped IO-transposed weights, dgrad (:242-250):
//   out[b,d,h,w,co] = bias[co] + sum_{dz,dy,dx,ci} x[b,d+dz-1,h+dy-1,w+dx-1,ci] * W[co,ci,dz,dy,dx]
// in bf16 with fp32 accumulation. The GEMM: M = voxels, N = Cout,
// K = 27 taps x Cin.
//
// What bounds it on the H100. Its operations: 27*Cin multiply-adds per output
// against ~Cin input values read from device memory, far above the card's
// ~295 flop per byte ridge, so device memory is not the limit. What the
// earlier mma.sync block (128x64 tiles, 2-stage cp.async) was held by is
// operand delivery from L2 into shared memory -- a per-thread gather that
// re-read A once per 64 output channels (43 flop per L2 byte) -- and
// mma.sync's reach, near 34 % of the bf16 peak even with no A loads.
// The design:
//   * A comes from TMA boxes. x is a 5-D tensor map [B, D, H, W, Cin]
//     (innermost first); a block owns a box of bw x bh x bd = 128 voxels of
//     one batch element, and k-step (tap, channel chunk) loads the box at
//     (c0, w0+dx-1, h0+dy-1, d0+dz-1, b) with 64 channels. The hardware
//     zero-fills what lies outside the tensor, negative coordinates and
//     channels past Cin included, which is exactly SAME padding: no address
//     arithmetic, predicates or registers are spent on the gather. The box
//     lands as 128 rows of 128 bytes with the 128-byte swizzle, the K-major
//     layout wgmma reads.
//   * B comes from TMA too: the weights as a 3-D map [Cout, 27, Cin], box
//     (64 channels, one tap, BN outputs), so channels past Cin zero-fill per
//     tap as they do in A.
//   * Wide N tiles: BN = Cout up to 256 (Cout 384 and 512: two tiles; 768
//     and 1024: three and four), so each A byte brought from L2 serves up to
//     256 outputs. BM = 128: two consumer warpgroups each issue
//     wgmma.mma_async m64nBNk16 on their 64 rows, the sum in registers
//     (BN/2 fp32 a thread).
//   * An mbarrier ring of STAGES (3 or 4) stages; one producer thread issues
//     the TMA loads against `full` barriers, the consumers release a stage
//     on its `empty` barrier once the wgmma group that read it retired,
//     keeping one group in flight. setmaxnreg moves registers from the
//     producer warpgroup to the consumers.
//   * Epilogue: fp32 sum plus bias, rounded once to bf16; rows outside the
//     volume and columns past Cout are not written.
// What it leaves for later: a persistent schedule (one block per SM walking
// tiles, so one tile's epilogue overlaps the next one's loads); B multicast
// to a 2-CTA cluster; and reusing one halo box across the (dz, dy) taps as
// row offsets where bw = W and W % 8 == 0 (today each of the 27 taps loads
// its own box, so A moves 27 times its size from L2). A Cout = 64 conv
// (level 0) can stay bound by L2 bandwidth: there each A byte serves only 64
// outputs (43 flop per byte).
//
// The conv study (conv3d_variants.cu, K7-K9) runs this block too: K7's
// variants are `conv3d_igemm_block` with one factor changed (VARIANT), and
// its dense GEMM (K8, K9) is the same ring, mainloop and epilogue over 2-D
// and 3-D maps (`Ring`, `consume`, `produce`, `store_row`).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace wg {

constexpr int BM = 128;                        // voxels per block: one box of x
constexpr int BK = 64;                         // channels per k-step: 128 bytes, one swizzle span
constexpr int CONSUMERS = 2;                   // warpgroups issuing wgmma, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1); // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;           // 16 KB a stage

__host__ __device__ constexpr int b_bytes(int bn) { return bn * BK * 2; }
// the ring, its barriers, and room to align the ring to the swizzle's 1024 bytes
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return stages * (A_BYTES + b_bytes(bn)) + 2 * stages * 8 + 1024;
}

// What the block computes: K5's conv (kFull), or one of K7's variants of it.
//   kNoPatch  every tap's box drops its (dz, dy) offset and keeps dx: 27
//             loads from 3 box addresses;
//   kNoDma    A is never loaded: every ring stage holds `nodma_value`,
//             written once by the consumers; only B arrives by TMA.
enum Variant : int { kFull = 0, kNoPatch = 1, kNoDma = 2 };

// The launchers' own error codes (CUDA's are positive).
constexpr int ERR_PLAN = -1;      // a plan or shape the kernel does not take
constexpr int ERR_ENCODE_FN = -2; // cuTensorMapEncodeTiled not found
constexpr int ERR_X_MAP = -3;     // cuTensorMapEncodeTiled refused the A operand's map
constexpr int ERR_W_MAP = -4;     // cuTensorMapEncodeTiled refused the weights' map

inline const char* error_string(int code) {
  switch (code) {
    case ERR_PLAN: return "the launcher refused the plan or shape";
    case ERR_ENCODE_FN: return "cuTensorMapEncodeTiled could not be found in libcuda";
    case ERR_X_MAP: return "cuTensorMapEncodeTiled refused the A operand's tensor map";
    case ERR_W_MAP: return "cuTensorMapEncodeTiled refused the weights' tensor map";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

// The conv and the box plan one launch runs (chosen by the Python wrapper,
// checked by `conv_setup`).
struct Problem {
  int B, D, H, W, Cout;
  int bw, bh, bd;                  // the box: bw * bh * bd = BM voxels
  int tiles_w, tiles_h, tiles_d;   // boxes along W, H, D
  int n_tiles;                     // ceil(Cout / BN)
  int cchunks;                     // ceil(Cin / BK)

  long long blocks() const { return (long long)B * tiles_d * tiles_h * tiles_w * n_tiles; }
};

// A weight tensor [Cout, taps, C] bf16 as a 3-D map read in boxes of 64
// channels, one tap and `bn` outputs; channels past C read as zeros, so no
// k-step crosses from one tap into the next.
inline bool encode_weights(EncodeTiled encode, CUtensorMap* map, const void* w, int Cout, int taps,
                           int C, int bn) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)Cout};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * 2 * taps};
  const cuuint32_t box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)bn};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks one conv and its plan, and encodes its two tensor maps and its
// Problem. x: [B, D, H, W, Cin] bf16, 16-byte aligned, Cin % 8 == 0; w:
// [Cout, 27, Cin] bf16 (tap = (dz*3+dy)*3+dx), contiguous. The plan: a box
// of bw x bh x bd = 128 voxels, BN output channels a block (64, 128, 192 or
// 256), a ring of 3 or 4 stages. Returns 0 or an ERR_ code.
inline int conv_setup(const void* x, const void* w, int B, int D, int H, int W, int Cin, int Cout,
                      int bw, int bh, int bd, int bn, int stages, CUtensorMap* x_map,
                      CUtensorMap* w_map, Problem* p) {
  const bool box_ok = bw >= 1 && bh >= 1 && bd >= 1 && bw <= 256 && bh <= 256 && bd <= 256 &&
                      bw * bh * bd == BM;
  const bool bn_ok = bn == 64 || bn == 128 || bn == 192 || bn == 256;
  if (!box_ok || !bn_ok || (stages != 3 && stages != 4) || Cin < 8 || Cin % 8 || Cout < 1 ||
      B < 1 || D < 1 || H < 1 || W < 1 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;

  const cuuint64_t c2 = (cuuint64_t)Cin * 2;  // bytes per voxel
  const cuuint64_t x_dims[5] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                                (cuuint64_t)B};
  const cuuint64_t x_strides[4] = {c2, c2 * W, c2 * W * H, c2 * W * H * D};
  const cuuint32_t x_box[5] = {(cuuint32_t)BK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  // OOB_FILL_NONE: elements outside the tensor read as zeros (SAME padding)
  if (encode(x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), x_dims, x_strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_X_MAP;
  if (!encode_weights(encode, w_map, w, Cout, 27, Cin, bn)) return ERR_W_MAP;

  p->B = B, p->D = D, p->H = H, p->W = W, p->Cout = Cout;
  p->bw = bw, p->bh = bh, p->bd = bd;
  p->tiles_w = (W + bw - 1) / bw, p->tiles_h = (H + bh - 1) / bh, p->tiles_d = (D + bd - 1) / bd;
  p->n_tiles = (Cout + bn - 1) / bn;
  p->cchunks = (Cin + BK - 1) / BK;
  return p->blocks() > 2147483647LL ? ERR_PLAN : 0;
}

// The ring in dynamic shared memory, aligned to the swizzle's 1024 bytes:
// STAGES A tiles [BM][BK], STAGES B tiles [BN][BK], then the `full` and
// `empty` barriers of each stage.
template <int BN, int STAGES>
struct Ring {
  static constexpr int B_BYTES = b_bytes(BN);
  uint8_t* a;
  uint8_t* b;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(uint8_t* smem_raw) {
    // the swizzle pattern follows shared-memory address bits: align to 1024
    a = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    b = a + STAGES * A_BYTES;
    full = reinterpret_cast<uint64_t*>(b + STAGES * B_BYTES);
    empty = full + STAGES;
  }

  // Thread 0 sets up the barriers; the whole block waits for it.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The producer thread's loop: k-step ks waits for its stage to be free (the
// first round finds every stage free), announces `tx` bytes on its `full`
// barrier and calls load(ks, stage), which issues the stage's TMA loads.
template <int BN, int STAGES, typename Load>
__device__ __forceinline__ void produce(const Ring<BN, STAGES>& ring, int ksteps, uint32_t tx,
                                        Load load) {
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&ring.empty[s], ((ks / STAGES) & 1) ^ 1);
    mbar_expect_tx(&ring.full[s], tx);
    load(ks, s);
  }
}

// The consumers' mainloop: acc = this warpgroup's 64 rows of A times B^T
// over `ksteps` stages. Each k-step waits for its stage, issues 4 wgmma
// (16 channels = 32 bytes along the swizzled rows each), keeps one group in
// flight and releases the previous k-step's stage once its group retired.
template <int BN, int STAGES>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], const Ring<BN, STAGES>& ring,
                                        int ksteps, int group) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_base = smem_u32(ring.a) + group * (64 * BK * 2);
  const uint32_t b_base = smem_u32(ring.b);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&ring.full[s], (ks / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::mma(acc, sw128_desc(a_base + s * A_BYTES + kk * 32),
                     sw128_desc(b_base + s * Ring<BN, STAGES>::B_BYTES + kk * 32));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous k-step's products are done: release its stage
    fence_regs(acc);
    if (ks > 0 && threadIdx.x % 128 == 0) mbar_arrive(&ring.empty[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// The accumulator row this consumer thread holds for `half` (0: the row,
// 1: the row 8 below), within the block's 128 rows.
__device__ __forceinline__ int acc_row(int half) {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x / 128) * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2) + half * 8;
}

// Writes that row's columns [n0, n0 + BN) of the output row `orow`: the fp32
// sum plus bias (or none), rounded once to bf16; columns past Cout are not
// written.
template <int BN>
__device__ __forceinline__ void store_row(__nv_bfloat16* orow, const float (&acc)[BN / 2],
                                          int half, int n0, int Cout,
                                          const __nv_bfloat16* bias) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + (lane & 3) * 2;
    float v0 = acc[j * 4 + half * 2];
    float v1 = acc[j * 4 + half * 2 + 1];
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

// K7 nodma's A operand: element (r, c) of a ring stage, r the row in the box
// (0-127) and c the channel in the k-step (0-63); exact in bf16.
__device__ __forceinline__ float nodma_value(int r, int c) {
  return (float)((7 * r + 3 * c) % 17 - 8) * (1.f / 64);
}

// The consumers (threads 0-255) write nodma's A into every ring stage, in
// the 128-byte swizzled layout a TMA box would have, 16 bytes a store, and
// make the writes visible to wgmma (the async proxy) before the first
// product.
template <int STAGES>
__device__ __forceinline__ void write_nodma_pattern(uint8_t* a_ring) {
  for (int i = threadIdx.x; i < STAGES * BM * 8; i += CONSUMERS * 128) {
    const int chunk = i & 7, r = (i >> 3) % BM, s = i / (BM * 8);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = pack_bf16(nodma_value(r, chunk * 8 + 2 * e), nodma_value(r, chunk * 8 + 2 * e + 1));
    *reinterpret_cast<uint4*>(a_ring + s * A_BYTES + sw128_offset(r, chunk)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  fence_proxy_async();
  named_barrier(1, CONSUMERS * 128);
}

// One block: the box of 128 voxels at (b, d0, h0, w0) times output channels
// [n0, n0 + BN). Threads 0-255 are the two consumer warpgroups, 256-383 the
// producer warpgroup, of which one thread issues every load.
template <int BN, int STAGES, int VARIANT>
__device__ __forceinline__ void conv3d_igemm_block(const CUtensorMap& x_map,
                                                   const CUtensorMap& w_map,
                                                   const __nv_bfloat16* __restrict__ bias,
                                                   __nv_bfloat16* __restrict__ out,
                                                   const Problem& p) {
  constexpr int B_BYTES = b_bytes(BN);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring<BN, STAGES> ring(smem_raw);

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

  ring.init();
  const int group = threadIdx.x / 128;
  if (group == CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    regs_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      if constexpr (VARIANT != kNoDma) prefetch_map(&x_map);
      prefetch_map(&w_map);
      constexpr uint32_t tx = VARIANT == kNoDma ? B_BYTES : A_BYTES + B_BYTES;
      produce(ring, ksteps, tx, [&](int ks, int s) {
        const int tap = ks / p.cchunks;
        const int c0 = (ks - tap * p.cchunks) * BK;
        if constexpr (VARIANT != kNoDma) {
          const int dz = VARIANT == kNoPatch ? 0 : tap / 9;
          const int dy = VARIANT == kNoPatch ? 0 : (tap / 3) % 3;
          tma_load_5d(ring.a + s * A_BYTES, &x_map, &ring.full[s], c0, w0 + tap % 3 - 1,
                      h0 + dy - 1, d0 + dz - 1, b);
        }
        tma_load_3d(ring.b + s * B_BYTES, &w_map, &ring.full[s], c0, tap, n0);
      });
    }
  } else {
    // ---- consumers: rows [64 * group, 64 * group + 64) of the box ----
    regs_inc<232>();
    if constexpr (VARIANT == kNoDma) write_nodma_pattern<STAGES>(ring.a);
    float acc[BN / 2];
    consume(acc, ring, ksteps, group);

    // ---- epilogue: rows outside the volume are not written ----
    const int boxhw = p.bw * p.bh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half);
      const int dd = d0 + r / boxhw, hh = h0 + (r / p.bw) % p.bh, ww = w0 + r % p.bw;
      if (dd >= p.D || hh >= p.H || ww >= p.W) continue;
      store_row<BN>(out + ((((long long)b * p.D + dd) * p.H + hh) * p.W + ww) * p.Cout, acc, half,
                    n0, p.Cout, bias);
    }
  }
}

// K5 (forward and dgrad), launched from conv3d.cu.
template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_igemm_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                          __grid_constant__ const CUtensorMap w_map,
                          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                          const Problem p) {
  conv3d_igemm_block<BN, STAGES, kFull>(x_map, w_map, bias, out, p);
}

}  // namespace wg
