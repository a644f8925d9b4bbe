// K5b se_residual_i8: the tail of an SE bottleneck on int8 codes, one
// elementwise pass:
//   out = clip(rint(relu(y3q * gate[b, c] + idn) / out_s), +-127)
// where y3q is conv3's int8 codes at the pre-SE scale, gate the (B, C) f32
// excite gain (sigmoid(MLP(squeeze)) * pre_s, computed in torch) and idn
// the identity: the block's input codes * in_s, or the f32 output of the
// downsample conv. Roundings in the JAX order: __fmul_rn for the excite
// (and for the identity's dequant), __fadd_rn for the add, a true
// __fdiv_rn and __float2int_rn for the requant.
//
// Replaces the SE branch of insarseg/models/resnet_int8.py::_block_i8
// (resnet_int8.py:262-271), one XLA:TPU elementwise fusion per block.
//
// Bound on an H100 SXM at its 700 W power limit: bytes. It reads 1 byte
// of codes plus 1 (int8 identity) or 4 (f32 identity) bytes and writes 1
// byte per element, at 3.35 TB/s; its few operations per element are far below any compute
// bound. Design: one thread per 16 channels of one pixel, with 16-byte
// loads and stores; the 16 gains of a thread come from L1/L2 (the (B, C)
// gate is tiny).
//
// Layouts: y3q, idn, out (B, H, W, C) with C % 16 == 0; gate (B, C) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool IDN_F32>
__global__ void __launch_bounds__(THREADS) se_residual_i8_kernel(
    const int8_t* __restrict__ y3q, const float* __restrict__ gate,
    const void* __restrict__ idn, int8_t* __restrict__ out, long long nvec,
    long long HWC, int C, float in_s, float out_s) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const long long e = i * 16;
  const long long b = e / HWC;
  const int c0 = (int)(e % C);
  __align__(16) int8_t q[16];
  *reinterpret_cast<int4*>(q) = *reinterpret_cast<const int4*>(y3q + e);
  float id[16];
  if (IDN_F32) {
    const float4* f = reinterpret_cast<const float4*>(
        static_cast<const float*>(idn) + e);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = f[k];
      id[4 * k] = v.x;
      id[4 * k + 1] = v.y;
      id[4 * k + 2] = v.z;
      id[4 * k + 3] = v.w;
    }
  } else {
    __align__(16) int8_t r[16];
    *reinterpret_cast<int4*>(r) =
        *reinterpret_cast<const int4*>(static_cast<const int8_t*>(idn) + e);
#pragma unroll
    for (int k = 0; k < 16; ++k) id[k] = __fmul_rn((float)r[k], in_s);
  }
  const float4* g = reinterpret_cast<const float4*>(gate + b * C + c0);
  __align__(16) int8_t pack[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 gv = g[k];
    const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * k + j;
      float y = __fadd_rn(__fmul_rn((float)q[n], gs[j]), id[n]);
      y = fmaxf(y, 0.0f);
      const int r = __float2int_rn(__fdiv_rn(y, out_s));
      pack[n] = (int8_t)max(-127, min(127, r));
    }
  }
  *reinterpret_cast<int4*>(out + e) = *reinterpret_cast<const int4*>(pack);
}

}  // namespace

extern "C" int insarseg_se_residual_i8(const void* y3q, const void* gate,
                                       const void* idn, void* out,
                                       long long nvec, long long HWC, int C,
                                       int idn_f32, float in_s, float out_s,
                                       void* stream) {
  if (C % 16) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nvec + THREADS - 1) / THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(y3q);
  const float* g = static_cast<const float*>(gate);
  int8_t* o = static_cast<int8_t*>(out);
  if (idn_f32)
    se_residual_i8_kernel<true><<<blocks, THREADS, 0, s>>>(
        q, g, idn, o, nvec, HWC, C, in_s, out_s);
  else
    se_residual_i8_kernel<false><<<blocks, THREADS, 0, s>>>(
        q, g, idn, o, nvec, HWC, C, in_s, out_s);
  return (int)cudaGetLastError();
}
