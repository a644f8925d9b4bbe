// K1 int8_conv3x3_epilogue: int8 x int8 -> int32 3x3 same-pad convolution
// on NHWC codes with the dequant / affine / ReLU / requant epilogue fused:
// y = relu(__fadd_rn(__fmul_rn(acc, mult[c]), off[c])), then either
// __float2int_rn(y / s) (the quotient correctly rounded) clamped to +-127
// -> int8, or __float2bfloat16_rn(y) -> bf16.
//
// Replaces insarseg/models/unet_int8.py::_conv_i8 (_conv_acc + _epilogue),
// which XLA:TPU compiled into one convolution fusion writing s8 codes.
//
// Bound on an H100 SXM: the 18 convolutions of one U-Net-CA forward
// (standard layout) do 367 G integer operations and move 263 MB of int8
// activations per 512^2 tile: ~186 us at the 1,979 TOP/s dense int8
// tensor-core rate against ~78 us of traffic at 3.35 TB/s, so the function
// is compute-bound. K1 is K5a (conv_i8.cu) with k = 3, stride 1, dilation 1,
// ReLU, no identity and an s8 or bf16 exit, so it runs the same
// tensor-core implicit GEMM (igemm_i8.cuh: wgmma m64nNk32 s8 on K-major
// swizzled tiles of a 6-stage cp.async ring); only its own two exits are
// instantiated here. TMA im2col loads with warp specialisation, and fusing
// the 2x2 max-pool (K3) into this epilogue, are later work.
//
// Layouts: x (B, H, W, Cin) int8 with Cin % 16 == 0 (the wrapper pads
// Cin = 1 or 2 with zero codes, which is exact); w (Cout, 3, 3, Cin) int8;
// mult, off (Cout) f32; out (B, H, W, Cout) int8 or bf16.

#include "igemm_i8.cuh"

extern "C" int insarseg_conv3x3_i8(const void* x, const void* w,
                                   const void* mult, const void* off,
                                   void* out, int B, int H, int W, int Cin,
                                   int Cout, float out_s, int bf16_out,
                                   int bn, void* stream) {
  igemm::Conv a;
  if (!igemm::make_conv(a, x, w, mult, off, nullptr, out, B, H, W, Cin, H, W,
                        Cout, 3, 1, 1, 1, 1.0f, out_s, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16_out)
    return (int)igemm::launch_exit<igemm::IDN_NONE, igemm::EXIT_BF16>(a, bn,
                                                                     s);
  return (int)igemm::launch_exit<igemm::IDN_NONE, igemm::EXIT_S8>(a, bn, s);
}

extern "C" const char* insarseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
