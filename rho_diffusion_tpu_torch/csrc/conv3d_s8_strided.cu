// The UNet's strided Downsample under W8A8 inference on Hopper (sm_90a): the
// int8 3x3x3 conv at stride (1, 2, 2) with pads (1, 1), on S1's block.
//
// Replaces no TPU kernel: JAX's `ConvInt8` (rho_diffusion_tpu/ops/quant.py:
// 101-154, its product at :143-153) leaves the strided integer conv to XLA,
// and PyTorch has no int8 conv on CUDA. It replaces S2 on this conv
// (conv_int8.cu `conv_s8_general_kernel`, one thread an output, 65-80x its
// bound at the flagship's three Downsamples, batch 8, H100). What bounds it
// and what its design does about that: conv3d_s8_wgmma.cuh (the SW = 2
// instances: x's tensor map walked every other voxel along H and W, the
// plan on the output's shape). Its own source so that its 24 instances build
// in parallel with S1's in conv_int8.cu.
//
// Entry point (launches on the caller's stream, allocates nothing, returns
// 0, a CUDA error code, or a negative code of its own, which
// conv3d_s8_strided_error_string names):
//   conv3d_s8_strided  conv_int8.cu's conv3d_s8 arguments, with D, H, W the
//                      input's volume; out [B, D, (H - 1) / 2 + 1,
//                      (W - 1) / 2 + 1, Cout] of `out_kind` (0 int32: the
//                      sums; 1 fp32; 2 bf16, dequantised as JAX does). The
//                      plan (box, bn; 4 stages) is `igemm_plan`'s on the
//                      output's shape.

#include "conv3d_s8_wgmma.cuh"

extern "C" {

int conv3d_s8_strided(const void* xq, const void* wq, const void* s_x, const void* s_w,
                      const void* bias, void* out, int B, int D, int H, int W, int Cin, int Cout,
                      int bw, int bh, int bd, int bn, int stages, int out_kind, void* stream) {
  return wg::conv3d_s8_at<2>(xq, wq, s_x, s_w, bias, out, B, D, H, W, Cin, Cout, bw, bh, bd, bn,
                             stages, out_kind, stream);
}

const char* conv3d_s8_strided_error_string(int code) {
  return code == wg::ERR_S8_ARGS ? "the launcher refused the shape or arguments"
                                 : wg::error_string(code);
}

}  // extern "C"
