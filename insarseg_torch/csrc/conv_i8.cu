// K5a int8_conv_epilogue: int8 x int8 -> int32 k x k convolution (k = 1 or
// 3) with stride, dilation and symmetric zero padding d*(k-1)/2 on NHWC
// codes, with a generalized fused epilogue:
//   y = acc * mult[c] + off[c]            (__fmul_rn, then __fadd_rn)
//   y = y + idn                           (optional residual; idn is either
//                                          int8 codes * in_s (__fmul_rn) or
//                                          an f32 tensor; __fadd_rn)
//   y = max(y, 0)                         (optional ReLU)
//   exit: int8 clip(rint(y / out_s), +-127) (a correctly rounded
//         division, then __float2int_rn), or f32 y, or bf16
//         __float2bfloat16_rn(y).
// The roundings are those of the JAX graph, in its order.
//
// Replaces insarseg/models/resnet_int8.py::_conv_i8 and the residual add of
// _block_i8 (resnet_int8.py:270), which XLA:TPU compiled into one
// convolution fusion per conv: every backbone, ASPP and head conv of the
// DeepLabV3 / FCN int8 engines.
//
// Bound on an H100 SXM at its 700 W power limit: operations,
// 2*B*Ho*Wo*Cin*Cout*k^2 at the 1,979 TOP/s dense int8 tensor-core rate
// (one FCN-CA and one DeepLabV3 forward at 512^2, batch 8, are together
// about 6.4 T int-ops: ~3.2 ms), against bytes (input, weights, output and
// identity once) at 3.35 TB/s: the 3x3 convs (FCN's 2048 -> 512 head, the
// dilated ASPP branches) are far on the operations side, the 1x1 convs on
// the bytes side.
// Design: the tensor-core implicit GEMM of igemm_i8.cuh (wgmma m64nNk32
// s8 on K-major swizzled tiles of a 6-stage cp.async ring, one im2col
// gather for every stride and dilation, the epilogue on a tile staged
// through shared memory, the identity prefetched to L2); this file
// instantiates it for the three identity kinds x three exits x BN 64 / 128.
// TMA im2col loads with warp specialisation and a persistent tile loop are
// later work.
//
// Layouts: x (B, H, W, Cin) int8 with Cin % 16 == 0 (the wrapper pads with
// zero codes, which is exact); w (Cout, k, k, Cin) int8; mult, off (Cout)
// f32; idn (B, Ho, Wo, Cout) int8 or f32; out (B, Ho, Wo, Cout) int8, f32
// or bf16.

#include "igemm_i8.cuh"

extern "C" int insarseg_conv_i8(const void* x, const void* w,
                                const void* mult, const void* off,
                                const void* idn, void* out, int B, int H,
                                int W, int Cin, int Ho, int Wo, int Cout,
                                int K, int stride, int dilation, int relu,
                                int idn_kind, float in_s, float out_s,
                                int exit_kind, int bn, void* stream) {
  igemm::Conv a;
  if (idn_kind < 0 || idn_kind > 2 || exit_kind < 0 || exit_kind > 2 ||
      !igemm::make_conv(a, x, w, mult, off, idn, out, B, H, W, Cin, Ho, Wo,
                        Cout, K, stride, dilation, relu, in_s, out_s, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (idn_kind == igemm::IDN_NONE)
    return (int)igemm::launch<igemm::IDN_NONE>(a, exit_kind, bn, s);
  if (idn_kind == igemm::IDN_S8)
    return (int)igemm::launch<igemm::IDN_S8>(a, exit_kind, bn, s);
  return (int)igemm::launch<igemm::IDN_F32>(a, exit_kind, bn, s);
}
