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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BM = 128;                        // voxels per block: one box of x
constexpr int BK = 64;                         // channels per k-step: 128 bytes, one swizzle span
constexpr int CONSUMERS = 2;                   // warpgroups issuing wgmma, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1); // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;           // 16 KB a stage
constexpr int SMEM_LIMIT = 232448;             // what one block may use on the H100
// a wait that outlasts this many cycles (~5 s) is a deadlock: trap instead of hanging
constexpr long long WATCHDOG_CYCLES = 10000000000LL;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products that write them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d[64 x N] += A[64 x 16] * B[N x 16]^T, both K-major SW128 in shared memory.
// Accumulator layout: 4 floats per 8 columns j: (row, 2q), (row, 2q+1),
// (row+8, 2q), (row+8, 2q+1) with row = 16 * warp + lane / 4, q = lane % 4.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
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
