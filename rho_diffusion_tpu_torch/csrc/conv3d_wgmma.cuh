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
// earlier block (conv3d_igemm.cuh: 128x64 tiles, 2-stage cp.async, mma.sync)
// was held by is operand delivery from L2 into shared memory -- a per-thread
// gather that re-read A once per 64 output channels (43 flop per L2 byte) --
// and mma.sync's reach, near 34 % of the bf16 peak even with no A loads.
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

// The conv and the box plan one launch runs (chosen by the Python wrapper,
// checked by the launcher).
struct Problem {
  int B, D, H, W, Cout;
  int bw, bh, bd;                  // the box: bw * bh * bd = BM voxels
  int tiles_w, tiles_h, tiles_d;   // boxes along W, H, D
  int n_tiles;                     // ceil(Cout / BN)
  int cchunks;                     // ceil(Cin / BK)
};

// One block: the box of 128 voxels at (b, d0, h0, w0) times output channels
// [n0, n0 + BN). Threads 0-255 are the two consumer warpgroups, 256-383 the
// producer warpgroup, of which one thread issues every load.
template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_igemm_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                          __grid_constant__ const CUtensorMap w_map,
                          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                          const Problem p) {
  constexpr int B_BYTES = b_bytes(BN);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern follows shared-memory address bits: align to 1024
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;                         // STAGES x [BM][BK]
  uint8_t* b_ring = smem + STAGES * A_BYTES;      // STAGES x [BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + STAGES * B_BYTES);
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
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    regs_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&x_map);
      prefetch_map(&w_map);
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % STAGES;
        mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);  // the first round finds every stage free
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        const int tap = ks / p.cchunks;
        const int c0 = (ks - tap * p.cchunks) * BK;
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        tma_load_5d(a_ring + s * A_BYTES, &x_map, &full[s], c0, w0 + dx - 1, h0 + dy - 1,
                    d0 + dz - 1, b);
        tma_load_3d(b_ring + s * B_BYTES, &w_map, &full[s], c0, tap, n0);
      }
    }
  } else {
    // ---- consumers: rows [64 * group, 64 * group + 64) of the box ----
    regs_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a_base = smem_u32(a_ring) + group * (64 * BK * 2);
    const uint32_t b_base = smem_u32(b_ring);
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(&full[s], (ks / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 channels = 32 bytes along the swizzled row
        Wgmma<BN>::mma(acc, sw128_desc(a_base + s * A_BYTES + kk * 32),
                       sw128_desc(b_base + s * B_BYTES + kk * 32));
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous k-step's products are done: release its stage
      fence_regs(acc);
      if (ks > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: fp32 + bias, rounded once to bf16 ----
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const int boxhw = p.bw * p.bh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = group * 64 + warp * 16 + (lane >> 2) + half * 8;  // row in the box
      const int dd = d0 + r / boxhw, hh = h0 + (r / p.bw) % p.bh, ww = w0 + r % p.bw;
      if (dd >= p.D || hh >= p.H || ww >= p.W) continue;
      __nv_bfloat16* orow = out + ((((long long)b * p.D + dd) * p.H + hh) * p.W + ww) * p.Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + (lane & 3) * 2;
        float v0 = acc[j * 4 + half * 2];
        float v1 = acc[j * 4 + half * 2 + 1];
        if (n + 1 < p.Cout && (p.Cout & 1) == 0) {
          if (bias) {
            v0 += __bfloat162float(bias[n]);
            v1 += __bfloat162float(bias[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < p.Cout) orow[n] = __float2bfloat16(v0 + (bias ? __bfloat162float(bias[n]) : 0.f));
          if (n + 1 < p.Cout)
            orow[n + 1] = __float2bfloat16(v1 + (bias ? __bfloat162float(bias[n + 1]) : 0.f));
        }
      }
    }
  }
}

}  // namespace wg
