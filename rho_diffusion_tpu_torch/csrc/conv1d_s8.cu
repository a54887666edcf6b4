// The 1-D UNet's 3-tap stride-1 convs under W8A8 inference on Hopper
// (sm_90a): the int8 conv with pads (1, 1) and Cin % 16 == 0, on S1's block.
//
// Replaces no TPU kernel: JAX's `ConvInt8` (rho_diffusion_tpu/ops/quant.py:
// 101-154, its product at :143-153) leaves the integer conv to XLA, and
// PyTorch has no int8 conv on CUDA. It replaces S2 on these convs
// (conv_int8.cu `conv_s8_general_kernel`, one thread an output, 41x its
// bound on the 1-D Spectroscopy config at batch 8, H100). What bounds it and
// what its design does about that: conv3d_s8_wgmma.cuh (the TAPS = 3
// instances: x as the volume [B, 1, 1, W, Cin], the 1x1x3 tap set, the plan
// `igemm_plan`'s on that volume). Its own source so that its 24 instances
// build in parallel with the other int8 sources.
//
// Entry point (launches on the caller's stream, allocates nothing, returns
// 0, a CUDA error code, or a negative code of its own, which
// conv1d_s8_error_string names):
//   conv1d_s8  conv_int8.cu's conv3d_s8 arguments with D = H = 1: xq [B, W,
//              Cin] int8 (16-byte aligned, Cin % 16 == 0), wq [Cout, 3, Cin]
//              int8 (tap = dx), out [B, W, Cout] of `out_kind` (0 int32: the
//              sums; 1 fp32; 2 bf16, dequantised as JAX does).

#include "conv3d_s8_wgmma.cuh"

extern "C" {

int conv1d_s8(const void* xq, const void* wq, const void* s_x, const void* s_w, const void* bias,
              void* out, int B, int D, int H, int W, int Cin, int Cout, int bw, int bh, int bd,
              int bn, int stages, int out_kind, void* stream) {
  return wg::conv3d_s8_at<1, 3>(xq, wq, s_x, s_w, bias, out, B, D, H, W, Cin, Cout, bw, bh, bd,
                                bn, stages, out_kind, stream);
}

const char* conv1d_s8_error_string(int code) {
  return code == wg::ERR_S8_ARGS ? "the launcher refused the shape or arguments"
                                 : wg::error_string(code);
}

}  // extern "C"
