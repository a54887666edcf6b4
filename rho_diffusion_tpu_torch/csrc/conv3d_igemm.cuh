// The tensor-core GEMM mainloop of the 3x3x3 conv (K5), shared by conv3d.cu
// and the bottleneck-isolation variants in conv3d_variants.cu, so that every
// variant runs K5's own tile, pipeline and epilogue and differs from it only
// in the factor it isolates.
//
// The GEMM: acc[BM x BN] = A[BM x K] * B[BN x K]^T over K in BK-deep stages.
// 4 warps, 2 (M) x 2 (N), each a 64 x 32 warp tile of mma.sync m16n8k16 bf16
// products into fp32 accumulators; a 2-stage cp.async pipeline in shared
// memory, so stage kt+1's copies overlap stage kt's products. Who fills a
// stage (the implicit-im2col gather of K5, a dense matrix, nothing) is the
// caller's `load_stage(stage, kt)`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int BM = 128;          // output rows (voxels) per block
constexpr int BN = 64;           // output channels per block
constexpr int BK = 32;           // reduction depth per stage
constexpr int LDS = BK + 8;      // padded smem row (80 bytes): conflict-free fragment loads
constexpr int THREADS = 128;     // 4 warps, 2 (M) x 2 (N), each a 64 x 32 warp tile

using ATile = __nv_bfloat16[BM][LDS];
using BTile = __nv_bfloat16[BN][LDS];

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

// acc = sum over KT stages of As[s] * Bs[s]^T, the stages double-buffered.
template <class LoadStage>
__device__ __forceinline__ void mainloop(ATile* As, BTile* Bs, float (&acc)[4][4][4], int KT,
                                         LoadStage load_stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

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
}

// fp32 accumulator + bias, rounded once to bf16. Rows m0 + r >= M are not
// written; out_row(m) is row m's first output channel.
template <class OutRow>
__device__ __forceinline__ void epilogue(const float (&acc)[4][4][4], long long m0, long long M,
                                         int n0, int Cout, const __nv_bfloat16* __restrict__ bias,
                                         OutRow out_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      __nv_bfloat16* orow = out_row(m);
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

// What fills the A operand of the conv's implicit GEMM.
enum Gather {
  kFull = 0,     // K5: tap (dz, dy, dx) reads x[b, d+dz-1, h+dy-1, w+dx-1, :]
  kNoPatch = 1,  // every tap reads the (dz, dy) = (0, 0) rows, keeping its dx
  kNoDma = 2,    // A is never read from x: both stages hold nodma_value once
};

// The no-DMA variant's A: exact in bf16, a function of the row in the tile
// and the column in the k-slice only.
__device__ __forceinline__ float nodma_value(int r, int c) {
  return (float)((7 * r + 3 * c) % 17 - 8) * (1.f / 64.f);
}

// The conv as an implicit GEMM with M = voxels, N = Cout, K = 27*Cin.
// x: [B, D, H, W, Cin] bf16 (Cin % 8 == 0); w: [Cout, 27*Cin] bf16 with
// k = ((dz*3+dy)*3+dx)*Cin + ci; bias: [Cout] bf16 or null;
// out: [B, D, H, W, Cout] bf16. One block per 128-voxel x 64-channel tile.
template <int G>
__device__ __forceinline__ void conv3d_igemm_block(
    ATile* As, BTile* Bs, const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int D, int H,
    int W, int Cin, int Cout) {
  const int tid = threadIdx.x;
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
    if (G != kNoDma) {
      const int tap = kin ? k / Cin : 0;
      const int ci = k - tap * Cin;
      const int dz = G == kNoPatch ? -1 : tap / 9 - 1;
      const int dy = G == kNoPatch ? -1 : (tap / 3) % 3 - 1;
      const int dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dd = a_d[i] + dz, hh = a_h[i] + dy, ww = a_w[i] + dx;
        const bool p = kin && a_ok[i] && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const __nv_bfloat16* src =
            p ? x + ((((a_b[i] * D + dd) * H + hh) * (long long)W + ww) * Cin + ci) : x;
        cp_async16(&As[stage][row + 32 * i][chunk * 8], src, p);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + row + 32 * j;
      const bool p = kin && n < Cout;
      const __nv_bfloat16* src = p ? w + ((long long)n * K + k) : w;
      cp_async16(&Bs[stage][row + 32 * j][chunk * 8], src, p);
    }
  };

  if (G == kNoDma) {
    // ordered before the first products by the mainloop's first __syncthreads
    for (int i = tid; i < 2 * BM * BK; i += THREADS) {
      const int r = (i / BK) % BM, c = i % BK;
      As[i / (BM * BK)][r][c] = __float2bfloat16(nodma_value(r, c));
    }
  }

  float acc[4][4][4];
  mainloop(As, Bs, acc, (K + BK - 1) / BK, load_stage);
  epilogue(acc, m0, M, n0, Cout, bias, [&](long long m) { return out + m * Cout; });
}

}  // namespace igemm
