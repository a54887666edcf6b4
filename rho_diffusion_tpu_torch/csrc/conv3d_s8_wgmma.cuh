// S1 on Hopper: the int8 x int8 -> int32 3x3x3 stride-1 SAME conv of W8A8
// inference, as K5's implicit GEMM (conv3d_wgmma.cuh) on s8 operands, with
// the dequantisation in its epilogue; and on the same block the UNet's
// strided Downsample, the 3x3x3 conv at stride (1, 2, 2) with pads (1, 1)
// (`conv3d_s8_strided`, the SW = 2 instances, launched from
// conv3d_s8_strided.cu; below), the 2-D UNet's 3x3 convs at stride 1 and 2
// (`conv2d_s8`, `conv2d_s8_strided`, the TAPS = 9 instances, launched from
// conv2d_s8.cu and conv2d_s8_strided.cu; below), and the 1-D UNet's
// 3-tap convs at stride 1 and 2 (`conv1d_s8`, `conv1d_s8_strided`, the
// TAPS = 3 instances, launched from conv1d_s8.cu and conv1d_s8_strided.cu;
// below).
//
// Replaces no TPU kernel: the JAX package's `ConvInt8`
// (rho_diffusion_tpu/ops/quant.py:101-154, its product at :143-153) leaves
// the integer conv to XLA's `conv_general_dilated(...,
// preferred_element_type=int32)`, and PyTorch has no int8 conv on CUDA
// (`F.conv3d` on int8 tensors returns int8 and wraps). It computes
//   acc[b,d,h,w,co] = sum_{dz,dy,dx,ci} xq[b,d+dz-1,h+dy-1,w+dx-1,ci] * wq[co,dz,dy,dx,ci]
//   out             = round_to_out(acc * (s_x[b] * s_w[co]) + bias[co])
// with xq, wq int8 in [-127, 127], exact int32 sums (|acc| <= 127^2 27 Cin,
// below 2^31 for Cin <= 4912), and the dequantisation in JAX's order.
//
// What bounds it on the H100: its operations, at the int8 tensor cores'
// 1,979 TOPS (twice bf16's 989), 2 * 27 * Cin per output; its bytes are
// half of K5's (int8 operands, the same outputs). So the same analysis as
// K5's holds with half the time per product.
// The design is K5's block with the operands changed, because in bytes an
// s8 tile is a bf16 tile:
//   * TMA boxes of 128 voxels whose hardware zero fill is the SAME padding,
//     rows of 128 bytes with the 128-byte swizzle: here 128 channels a
//     k-step (S8_BK) where K5 takes 64, so a ring stage holds the same 16 KB
//     of A and BN x 128 bytes of B, and `Ring`, `produce` and `acc_row` are
//     K5's. TMA has no signed 8-bit type: both maps are UINT8, and byte 0 is
//     int8 0, so the zero fill stays exact. Global strides must be multiples
//     of 16 bytes, so the launcher takes Cin % 16 == 0 (S2 takes the rest).
//   * wgmma.mma_async m64nBNk32.s32.s8.s8, 32 bytes of each row a product as
//     bf16's k16: four products a stage, both operands K-major (8-bit wgmma
//     has no transpose; x's box, channels innermost, and the weights
//     [Cout, 27, Cin] already are). The sum is int32, BN/2 a thread.
//   * A partly filled channel chunk (Cin = 64 at level 0, or the last
//     chunk of Cin = 192) still loads a whole 128-channel box, whose
//     channels past Cin are zero fill, not memory traffic. Where Cin <= 64
//     every chunk is such a chunk, and the kernel's KK = 2 instances issue
//     only the two products that reach a real channel; elsewhere KK = 4
//     products a stage, and a partial last chunk multiplies its zero fill
//     (exact; at Cin = 192 a quarter of the products). A run-time choice per
//     k-step would put the products under a branch, and ptxas then fences
//     every wgmma (its C7519 note): a first version did, and ran 1.18-1.45x
//     this one's time at levels 1-3 (H100, batch 8). What Cin = 64 costs:
//     each stage moves K5's 16 KB of A and BN x 128 bytes of B through TMA
//     and shared memory, half of it zero fill, so level 0 keeps K5's
//     delivery and takes about K5's time (1.04-1.10x at batch 8).
//   * A block owns a box of one batch element (K5's plan, `igemm_plan`), so
//     s_x is one scalar a block.
//   * Epilogue, per output element, rounded as JAX rounds, with no FMA
//     contraction: acc_f = __int2float_rn(acc), scale = __fmul_rn(s_x[b],
//     s_w[co]), y = __fadd_rn(__fmul_rn(acc_f, scale), bias[co]), then one
//     rounding to the output type (fp32 or bf16). An int32 output mode
//     writes acc itself (the holds' check of the products alone).
// What it leaves for later: everything K5 leaves (a persistent schedule, B
// multicast, one halo box across taps), and fusing the activation's
// quantisation (S3, conv_int8.cu) into the producer's path.
//
// The strided Downsample (SW = 2). JAX's conv_nd turns a strided "SAME" into
// pads of k // 2 (rho_diffusion_tpu/ops/convolution.py:116-119), so output
// voxel (d, h, w) reads x[d + dz - 1, 2h + dy - 1, 2w + dx - 1]. It replaces
// S2 (one thread an output, __dp4a, 65-80x its bound at the flagship's three
// Downsamples, batch 8, H100), which had no design for this card. Bound by
// operations as S1 (2 * 27 * Cin an output, at 1,979 TOPS). The design is
// S1's block with the A box strided: x's map takes element strides
// (1, 2, 2, 1, 1) over (C, W, H, D, B) and a box of 128 channels x 2 bw x 2
// bh x bd, so TMA walks every other voxel along W and H and brings bw x bh x
// bd = 128 voxels, the inputs of the block's 128 outputs for one tap, into
// the same 16 KB of the ring as S1's box; the tap's origin is (2 w0 + dx -
// 1, 2 h0 + dy - 1, d0 + dz - 1), and the hardware zero fill at -1 and past
// the edge is the padding (int8 zero, exact). The plan (`igemm_plan`) is
// taken on the output's shape and the epilogue writes the output's layout.
// The stride is a template parameter, not a run-time branch around the
// products, for the ptxas fencing the KK note above describes.
//
// The 2-D convs (TAPS = 9). The 2-D UNet's (the DeepGalaxy config, 128^2)
// 3x3 convs with pads (1, 1) and Cin % 16 == 0, at stride (1, 1) and its
// Downsample's (2, 2) (JAX pads k // 2 there too), replacing S2 on them (at
// batch 8, 6.69-7.17 ms of a forward against a 0.120 ms byte bound, 25-80x
// each conv's bound, H100). The input x [B, H, W, Cin] is the volume
// [B, 1, H, W, Cin] and the taps are the 1x3x3 set: the tap set is a
// template parameter (TAPS = 27: 3x3x3; TAPS = 9: dz fixed at the centre),
// so a 2-D conv walks 9 taps of k-steps where a depth-1 3-D map would walk
// 27, two thirds of them on zero fill, and no branch sits around a product.
// The weights are [Cout, 9, Cin] (tap = dy*3+dx), their map 9 taps deep;
// the box, the ring, the mainloop and the epilogue are S1's, so the output
// is bitwise the plain version's. Bound by operations as S1 (2 * 9 * Cin an
// output at 1,979 TOPS) where Cin is large; the level-0 convs (Cin 32-96,
// 128^2) move more bytes than they compute.
//
// The 1-D convs (TAPS = 3). The 1-D UNet's (the Spectroscopy config, 4096
// points) 3-tap convs with pads (1, 1) and Cin % 16 == 0, at stride 1 and
// its Downsample's 2, replacing S2 on them (at batch 8, 2.24-2.31 ms of a
// forward against a 0.054 ms byte bound, 41x, H100). x [B, W, Cin] is the
// volume [B, 1, 1, W, Cin] and the taps the 1x1x3 set (dz and dy fixed at
// the centre), weights [Cout, 3, Cin] (tap = dx), so a 1-D conv walks 3
// taps of k-steps, not the 9 of a 2-D map with H = 1 (exact through the
// zero fill, but three times the products and the ring's stages). The
// stride walks W alone: x's map takes element strides (1, SW, 1, 1, 1) and
// a box of 128 channels x SW bw x bh x bd, so no strided walk runs along
// an H of one. The plan (`igemm_plan` on [B, 1, 1, W_out, Cin]) takes boxes
// of 128 points along W; where a level gives fewer boxes than the card has
// SMs (batch 8, 512 points at Cout 256: 32 boxes) its N tiles split Cout.
// Bound by bytes at most of that config's convs: 6 Cin Cout operations a
// point against about Cin + 2 Cout bytes (512 a byte at 256 -> 256, under
// the card's 590 int8 operations a byte).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3d_wgmma.cuh"

namespace wg {

constexpr int S8_BK = 128;  // int8 channels a k-step: 128 bytes, K5's 64 bf16
static_assert(S8_BK == BK * 2, "an s8 stage must be a bf16 stage in bytes");

// The output the epilogue writes.
enum S8Out : int { kS8Int32 = 0, kS8Float = 1, kS8Bf16 = 2 };

template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] += A[64 x 32] * B[N x 32]^T on s8, both K-major SW128 in shared
// memory, int32 accumulators in the layout of the fp32 ones (wgmma.cuh).
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int32_t (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int32_t (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<192> {
  static __device__ __forceinline__ void mma(int32_t (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void mma(int32_t (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
};

// An int8 tensor [outer..., C] as the tensor map TMA reads (UINT8: TMA has no
// signed 8-bit type, and byte 0 is int8 0, so its zero fill is exact),
// walked with the given element strides (all 1 but the strided conv's W, H).
inline CUresult encode_u8(EncodeTiled encode, CUtensorMap* map, const void* base, int rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, const cuuint32_t* elem_strides,
                          CUtensorMapL2promotion promotion) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Checks one int8 conv and its plan (K5's: a box of bw x bh x bd = 128
// output voxels, BN 64/128/192/256, a ring of 4 stages) and encodes its two
// maps and its Problem. xq: [B, D, H, W, Cin] int8, 16-byte aligned, Cin %
// 16 == 0; wq: [Cout, taps, Cin] int8 (taps 27: tap = (dz*3+dy)*3+dx; 9, a
// 2-D conv with D = 1: tap = dy*3+dx; 3, a 1-D conv with D = H = 1: tap =
// dx), contiguous. `sw` is the stride along H and W (along W alone at 3
// taps; 1: S1; 2: the Downsample), the output [B, D, (H - 1) / sh + 1,
// (W - 1) / sw + 1, Cout] (pads 1; sh = sw, or 1 at 3 taps). Returns 0 or
// an ERR_ code.
inline int s8_setup(const void* x, const void* w, int B, int D, int H, int W, int Cin, int Cout,
                    int bw, int bh, int bd, int bn, int stages, int sw, int taps,
                    CUtensorMap* x_map, CUtensorMap* w_map, Problem* p) {
  const int sh = taps == 3 ? 1 : sw;  // the stride along H: none in 1-D
  const bool box_ok = bw >= 1 && bh >= 1 && bd >= 1 && sw * bw <= 256 && sh * bh <= 256 &&
                      bd <= 256 && bw * bh * bd == BM && (sw == 1 || sw == 2);
  const bool bn_ok = bn == 64 || bn == 128 || bn == 192 || bn == 256;
  // |sum| <= 127^2 taps Cin stays below 2^31; a 2-D conv has depth 1, a
  // 1-D conv depth and height 1
  const bool taps_ok =
      taps == 27 ? Cin <= 4912
      : taps == 9 ? D == 1 && 127LL * 127 * 9 * Cin <= 2147483647LL
                  : taps == 3 && D == 1 && H == 1 && 127LL * 127 * 3 * Cin <= 2147483647LL;
  if (!box_ok || !bn_ok || !taps_ok || stages != 4 || Cin < 16 || Cin % 16 || Cout < 1 ||
      B < 1 || D < 1 || H < 1 || W < 1 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_ENCODE_FN;
  const cuuint64_t c = (cuuint64_t)Cin;  // bytes per voxel
  const cuuint64_t x_dims[5] = {c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t x_strides[4] = {c, c * W, c * W * H, c * W * H * D};
  // sw x bw voxels along W walked every sw-th: bw of them land in the box
  // (likewise sh x bh along H)
  const cuuint32_t x_box[5] = {(cuuint32_t)S8_BK, (cuuint32_t)(sw * bw), (cuuint32_t)(sh * bh),
                               (cuuint32_t)bd, 1};
  const cuuint32_t x_elem[5] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1, 1};
  if (encode_u8(encode, x_map, x, 5, x_dims, x_strides, x_box, x_elem,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B) != CUDA_SUCCESS)
    return ERR_X_MAP;
  const cuuint64_t w_dims[3] = {c, (cuuint64_t)taps, (cuuint64_t)Cout};
  const cuuint64_t w_strides[2] = {c, c * taps};
  const cuuint32_t w_box[3] = {(cuuint32_t)S8_BK, 1, (cuuint32_t)bn};
  const cuuint32_t w_elem[3] = {1, 1, 1};
  if (encode_u8(encode, w_map, w, 3, w_dims, w_strides, w_box, w_elem,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) != CUDA_SUCCESS)
    return ERR_W_MAP;
  // the output's volume: the plan's boxes tile it
  H = (H - 1) / sh + 1;
  W = (W - 1) / sw + 1;
  p->B = B, p->D = D, p->H = H, p->W = W, p->Cout = Cout;
  p->bw = bw, p->bh = bh, p->bd = bd;
  p->tiles_w = (W + bw - 1) / bw, p->tiles_h = (H + bh - 1) / bh, p->tiles_d = (D + bd - 1) / bd;
  p->n_tiles = (Cout + bn - 1) / bn;
  p->cchunks = (Cin + S8_BK - 1) / S8_BK;
  return p->blocks() > 2147483647LL ? ERR_PLAN : 0;
}

// The consumers' mainloop on s8: K5's `consume` with int32 sums and KK k32
// products a stage (4: the whole 128-channel chunk; 2: its first 64
// channels, where Cin <= 64 and the rest of every stage is zero fill).
template <int BN, int STAGES, int KK>
__device__ __forceinline__ void consume_s8(int32_t (&acc)[BN / 2], const Ring<BN, STAGES>& ring,
                                           int ksteps, int group) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_base = smem_u32(ring.a) + group * (64 * S8_BK);
  const uint32_t b_base = smem_u32(ring.b);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&ring.full[s], (ks / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      WgmmaS8<BN>::mma(acc, sw128_desc(a_base + s * A_BYTES + kk * 32),
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

// One output element of W8A8, in JAX's order (ops/quant.py:151-153) and with
// no contraction into an FMA: float(acc) * (s_x * s_w) + bias, in fp32.
__device__ __forceinline__ float s8_dequant(int32_t acc, float sx, float sw, const float* bias,
                                            int n) {
  const float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw));
  return bias ? __fadd_rn(y, bias[n]) : y;
}

template <int OUT>
struct S8Store;

template <>
struct S8Store<kS8Int32> {
  using T = int32_t;
  static __device__ __forceinline__ void pair(T* o, int32_t a0, int32_t a1, float, float, float,
                                              const float*, int) {
    *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
  }
  static __device__ __forceinline__ void one(T* o, int32_t a, float, float, const float*, int) {
    *o = a;
  }
};

template <>
struct S8Store<kS8Float> {
  using T = float;
  static __device__ __forceinline__ void pair(T* o, int32_t a0, int32_t a1, float sx, float sw0,
                                              float sw1, const float* bias, int n) {
    *reinterpret_cast<float2*>(o) =
        make_float2(s8_dequant(a0, sx, sw0, bias, n), s8_dequant(a1, sx, sw1, bias, n + 1));
  }
  static __device__ __forceinline__ void one(T* o, int32_t a, float sx, float sw,
                                             const float* bias, int n) {
    *o = s8_dequant(a, sx, sw, bias, n);
  }
};

template <>
struct S8Store<kS8Bf16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void pair(T* o, int32_t a0, int32_t a1, float sx, float sw0,
                                              float sw1, const float* bias, int n) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
        s8_dequant(a0, sx, sw0, bias, n), s8_dequant(a1, sx, sw1, bias, n + 1));
  }
  static __device__ __forceinline__ void one(T* o, int32_t a, float sx, float sw,
                                             const float* bias, int n) {
    *o = __float2bfloat16_rn(s8_dequant(a, sx, sw, bias, n));
  }
};

// Writes this thread's columns [n0, n0 + BN) of output row `orow` (half 0:
// its row, 1: the row 8 below); columns past Cout are not written.
template <int BN, int OUT>
__device__ __forceinline__ void store_row_s8(typename S8Store<OUT>::T* orow,
                                             const int32_t (&acc)[BN / 2], int half, int n0,
                                             int Cout, float sx, const float* __restrict__ s_w,
                                             const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + (lane & 3) * 2;
    const int32_t a0 = acc[j * 4 + half * 2], a1 = acc[j * 4 + half * 2 + 1];
    if (n + 1 < Cout && (Cout & 1) == 0) {
      S8Store<OUT>::pair(orow + n, a0, a1, sx, s_w[n], s_w[n + 1], bias, n);
    } else {
      if (n < Cout) S8Store<OUT>::one(orow + n, a0, sx, s_w[n], bias, n);
      if (n + 1 < Cout) S8Store<OUT>::one(orow + n + 1, a1, sx, s_w[n + 1], bias, n + 1);
    }
  }
}

// S1: one block is the box of 128 output voxels at (b, d0, h0, w0) times
// output channels [n0, n0 + BN), K5's block (conv3d_igemm_block) on s8, at
// stride SW along H and W (along W alone at TAPS = 3; 1: S1; 2: the
// Downsample, its x map strided to match) over TAPS taps (27: 3x3x3; 9:
// 1x3x3, the 2-D convs; 3: 1x1x3, the 1-D convs). Threads 0-255 are the
// consumer warpgroups, 256-383 the producer warpgroup.
template <int BN, int STAGES, int OUT, int KK, int SW, int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_s8_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                       __grid_constant__ const CUtensorMap w_map, const float* __restrict__ s_x,
                       const float* __restrict__ s_w, const float* __restrict__ bias,
                       typename S8Store<OUT>::T* __restrict__ out, const Problem p) {
  constexpr int B_BYTES = b_bytes(BN);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring<BN, STAGES> ring(smem_raw);

  int t = blockIdx.x;  // N tiles fastest, as in K5
  const int n0 = (t % p.n_tiles) * BN;
  t /= p.n_tiles;
  const int w0 = (t % p.tiles_w) * p.bw;
  t /= p.tiles_w;
  const int h0 = (t % p.tiles_h) * p.bh;
  t /= p.tiles_h;
  const int d0 = (t % p.tiles_d) * p.bd;
  const int b = t / p.tiles_d;
  static_assert(TAPS == 27 || TAPS == 9 || TAPS == 3, "the 3x3x3, 1x3x3 or 1x1x3 tap set");
  constexpr int SH = TAPS == 3 ? 1 : SW;  // the stride along H: none in 1-D
  const int ksteps = TAPS * p.cchunks;

  ring.init();
  const int group = threadIdx.x / 128;
  if (group == CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    regs_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&x_map);
      prefetch_map(&w_map);
      produce(ring, ksteps, A_BYTES + B_BYTES, [&](int ks, int s) {
        const int tap = ks / p.cchunks;
        const int c0 = (ks - tap * p.cchunks) * S8_BK;
        // the 1x3x3 set: the centre plane; the 1x1x3 set: the centre row too
        const int dz = TAPS == 27 ? tap / 9 : 1, dy = TAPS == 3 ? 1 : (tap / 3) % 3;
        tma_load_5d(ring.a + s * A_BYTES, &x_map, &ring.full[s], c0, SW * w0 + tap % 3 - 1,
                    SH * h0 + dy - 1, d0 + dz - 1, b);
        tma_load_3d(ring.b + s * B_BYTES, &w_map, &ring.full[s], c0, tap, n0);
      });
    }
  } else {
    // ---- consumers: rows [64 * group, 64 * group + 64) of the box ----
    regs_inc<232>();
    int32_t acc[BN / 2];
    consume_s8<BN, STAGES, KK>(acc, ring, ksteps, group);
    const float sx = s_x ? s_x[b] : 0.f;
    const int boxhw = p.bw * p.bh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half);
      const int dd = d0 + r / boxhw, hh = h0 + (r / p.bw) % p.bh, ww = w0 + r % p.bw;
      if (dd >= p.D || hh >= p.H || ww >= p.W) continue;
      store_row_s8<BN, OUT>(out + ((((long long)b * p.D + dd) * p.H + hh) * p.W + ww) * p.Cout,
                            acc, half, n0, p.Cout, sx, s_w, bias);
    }
  }
}

// a shape or argument the int8 entry points do not take
constexpr int ERR_S8_ARGS = -5;

// One instance's launch on `stream` (the dynamic shared-memory limit set
// once per device).
template <int BN, int OUT, int KK, int SW, int TAPS>
int launch_s8(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* s_x,
              const float* s_w, const float* bias, void* out, const Problem& p,
              cudaStream_t stream) {
  constexpr int smem = smem_bytes(BN, 4);
  static_assert(smem <= SMEM_LIMIT, "the ring does not fit in shared memory");
  auto kernel = conv3d_s8_wgmma_kernel<BN, 4, OUT, KK, SW, TAPS>;
  static unsigned long long ready = 0;
  cudaError_t err = smem_attribute_once(kernel, smem, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks(), THREADS, smem, stream>>>(
      x_map, w_map, s_x, s_w, bias, (typename S8Store<OUT>::T*)out, p);
  return (int)cudaGetLastError();
}

// KK products a stage: 2 where Cin <= 64 (every stage half zero fill), else 4.
template <int OUT, int SW, int TAPS>
int launch_s8_bn(int bn, int cin, const CUtensorMap& x_map, const CUtensorMap& w_map,
                 const float* s_x, const float* s_w, const float* bias, void* out,
                 const Problem& p, cudaStream_t s) {
  const bool half = cin <= 64;
  switch (bn) {
    case 64:
      return half ? launch_s8<64, OUT, 2, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s)
                  : launch_s8<64, OUT, 4, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s);
    case 128:
      return half ? launch_s8<128, OUT, 2, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s)
                  : launch_s8<128, OUT, 4, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s);
    case 192:
      return half ? launch_s8<192, OUT, 2, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s)
                  : launch_s8<192, OUT, 4, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s);
    default:
      return half ? launch_s8<256, OUT, 2, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s)
                  : launch_s8<256, OUT, 4, SW, TAPS>(x_map, w_map, s_x, s_w, bias, out, p, s);
  }
}

// S1 (SW = 1, conv_int8.cu) or the strided Downsample (SW = 2,
// conv3d_s8_strided.cu), the 2-D convs at either stride (TAPS = 9,
// conv2d_s8.cu and conv2d_s8_strided.cu, with D = 1) and the 1-D convs at
// either stride (TAPS = 3, conv1d_s8.cu and conv1d_s8_strided.cu, with D =
// H = 1): the maps, then the instance of the plan's N tile and the output
// kind; the launchers' C entry points.
template <int SW, int TAPS = 27>
int conv3d_s8_at(const void* xq, const void* wq, const void* s_x, const void* s_w,
                 const void* bias, void* out, int B, int D, int H, int W, int Cin, int Cout,
                 int bw, int bh, int bd, int bn, int stages, int out_kind, void* stream) {
  CUtensorMap x_map, w_map;
  Problem p;
  const int err = s8_setup(xq, wq, B, D, H, W, Cin, Cout, bw, bh, bd, bn, stages, SW, TAPS,
                           &x_map, &w_map, &p);
  if (err != 0) return err;
  if (out_kind != kS8Int32 && (s_x == nullptr || s_w == nullptr)) return ERR_S8_ARGS;
  const float *sx = (const float*)s_x, *sw = (const float*)s_w, *bs = (const float*)bias;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case kS8Int32:
      return launch_s8_bn<kS8Int32, SW, TAPS>(bn, Cin, x_map, w_map, sx, sw, bs, out, p, s);
    case kS8Float:
      return launch_s8_bn<kS8Float, SW, TAPS>(bn, Cin, x_map, w_map, sx, sw, bs, out, p, s);
    case kS8Bf16:
      return launch_s8_bn<kS8Bf16, SW, TAPS>(bn, Cin, x_map, w_map, sx, sw, bs, out, p, s);
    default: return ERR_S8_ARGS;
  }
}

}  // namespace wg
