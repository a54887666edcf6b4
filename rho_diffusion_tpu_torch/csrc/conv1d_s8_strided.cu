// The 1-D UNet's strided Downsample under W8A8 inference on Hopper
// (sm_90a): the int8 3-tap conv at stride 2 with pads (1, 1) (JAX turns the
// strided "SAME" into pads of k // 2, rho_diffusion_tpu/ops/
// convolution.py:116-119), Cin % 16 == 0, on S1's block.
//
// Replaces no TPU kernel: JAX's `ConvInt8` (rho_diffusion_tpu/ops/quant.py:
// 101-154, its product at :143-153) leaves the strided integer conv to XLA,
// and PyTorch has no int8 conv on CUDA. It replaces S2 on this conv
// (conv_int8.cu `conv_s8_general_kernel`). What bounds it and what its
// design does about that: conv3d_s8_wgmma.cuh (the SW = 2, TAPS = 3
// instances: x as the volume [B, 1, 1, W, Cin] walked every other point
// along W alone, the 1x1x3 tap set, the plan on the output's shape). Its
// own source so that its 24 instances build in parallel with the other
// int8 sources.
//
// Entry point (launches on the caller's stream, allocates nothing, returns
// 0, a CUDA error code, or a negative code of its own, which
// conv1d_s8_strided_error_string names):
//   conv1d_s8_strided  conv1d_s8's arguments, with W the input's; out
//                      [B, (W - 1) / 2 + 1, Cout]. The plan (box, bn; 4
//                      stages) is `igemm_plan`'s on the output's shape.

#include "conv3d_s8_wgmma.cuh"

extern "C" {

int conv1d_s8_strided(const void* xq, const void* wq, const void* s_x, const void* s_w,
                      const void* bias, void* out, int B, int D, int H, int W, int Cin, int Cout,
                      int bw, int bh, int bd, int bn, int stages, int out_kind, void* stream) {
  return wg::conv3d_s8_at<2, 3>(xq, wq, s_x, s_w, bias, out, B, D, H, W, Cin, Cout, bw, bh, bd,
                                bn, stages, out_kind, stream);
}

const char* conv1d_s8_strided_error_string(int code) {
  return code == wg::ERR_S8_ARGS ? "the launcher refused the shape or arguments"
                                 : wg::error_string(code);
}

}  // extern "C"
