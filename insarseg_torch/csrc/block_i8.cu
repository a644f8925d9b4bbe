// K5b se_residual_i8: the tail of an SE bottleneck on int8 codes, one
// elementwise pass:
//   out = clip(rint(relu(y3q * gate[b, c] + idn) / out_s), +-127)
// where y3q is conv3's int8 codes at the pre-SE scale, gate the (B, C) f32
// excite gain (sigmoid(MLP(squeeze)) * pre_s, computed in torch) and idn
// the identity: the block's input codes * in_s, or the f32 output of the
// downsample conv. Roundings in the JAX order: __fmul_rn for the excite
// (and for the identity's dequant), __fadd_rn for the add, then the
// quotient RN(y / out_s) and round half to even.
//
// Replaces the SE branch of insarseg/models/resnet_int8.py::_block_i8
// (resnet_int8.py:262-271), one XLA:TPU elementwise fusion per block.
//
// Bound on an H100 SXM at its 700 W power limit: bytes. It reads 1 byte
// of codes plus 1 (int8 identity) or 4 (f32 identity) bytes and writes 1
// byte per element, at 3.35 TB/s: 1.1 G elements a ms with an int8
// identity. At that rate the SM's 16-a-clock conversion pipe would bind a
// kernel that converts twice or three times an element (int8 -> f32, and
// f32 -> int for the code), and a division by __fdiv_rn would too. So:
//   - codes become floats by a byte permute and one exact subtraction:
//     byte k of w ^ 0x80808080 (the code + 128) placed under the exponent
//     of 2^23 is the float 2^23 + 128 + code;
//   - the quotient is requant_i8.cuh's div_rn with r = __frcp_rn(out_s)
//     (once a thread), no division;
//   - y is clamped to [0, lim], lim = RN(127 * out_s): the ReLU, and a
//     bound that keeps the quotient finite (div_rn of y >= 2^128 * out_s
//     would be NaN). RN(y / out_s) of a y above lim rounds to the code 127
//     anyway, and lim / out_s lies within an ulp of 127, so the clamp
//     changes no code;
//   - the code is rint(q) for q in [0, 127 + an ulp]: q + 1.5 * 2^23 rounds
//     to an integer (half to even, as __float2int_rn), which is the low
//     byte of its bits; byte permutes pack four codes a word;
//   - bytes in flight: a thread loads V vectors of 16 elements (16-byte
//     loads of each operand; V = 4 with an int8 identity, 2 with an f32
//     one: 128 or 160 bytes a thread) before it computes any; the 16 gains
//     of a vector are four float4 loads that hit L1 (the (B, C) gate is at
//     most 64 KB and a block reads a few rows of it).
//
// Layouts: y3q, idn, out (B, H, W, C) with C % 16 == 0; gate (B, C) f32;
// every pointer 16-byte aligned; fewer than 2^31 vectors of 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant_i8.cuh"

namespace {

constexpr int THREADS = 256;

// the four codes of a word (int8 lanes) as exact floats
__device__ __forceinline__ void codes_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128, as an unsigned byte
#pragma unroll
  for (int k = 0; k < 4; ++k)  // [byte k of u, 0, 0, 0x4B] = 2^23 + u_k
    f[k] = __fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)),
        8388736.0f);  // 2^23 + 128
}

template <bool IDN_F32>
struct Idn;

template <>
struct Idn<false> {  // int8 codes at in_s
  uint4 v;
  __device__ __forceinline__ void load(const void* p, size_t e) {
    v = __ldg(reinterpret_cast<const uint4*>(static_cast<const int8_t*>(p) +
                                             e));
  }
  __device__ __forceinline__ void get(float* id, float in_s) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) codes_f32(w[j], id + 4 * j);
#pragma unroll
    for (int k = 0; k < 16; ++k) id[k] = __fmul_rn(id[k], in_s);
  }
};

template <>
struct Idn<true> {  // f32
  float4 v[4];
  __device__ __forceinline__ void load(const void* p, size_t e) {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(f + j);
  }
  __device__ __forceinline__ void get(float* id, float) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      id[4 * j] = v[j].x;
      id[4 * j + 1] = v[j].y;
      id[4 * j + 2] = v[j].z;
      id[4 * j + 3] = v[j].w;
    }
  }
};

// the code of one element, as the low byte of the result
__device__ __forceinline__ uint32_t code(float q, float g, float id, float s,
                                         float r, float lim) {
  float y = __fadd_rn(__fmul_rn(q, g), id);
  y = fminf(fmaxf(y, 0.0f), lim);
  return __float_as_uint(
      __fadd_rn(div_rn(y, s, r), 12582912.0f));  // + 1.5 * 2^23
}

template <bool IDN_F32, int V>
__global__ void __launch_bounds__(THREADS) se_residual_i8_kernel(
    const int8_t* __restrict__ y3q, const float* __restrict__ gate,
    const void* __restrict__ idn, int8_t* __restrict__ out, unsigned nvec,
    unsigned vec_per_image, unsigned vec_per_pixel, float in_s, float out_s) {
  const float r = __frcp_rn(out_s);
  const float lim = __fmul_rn(127.0f, out_s);
  const unsigned C = vec_per_pixel * 16;
  const unsigned i0 = blockIdx.x * (THREADS * V) + threadIdx.x;
  uint4 qv[V];
  Idn<IDN_F32> id[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const unsigned i = i0 + v * THREADS;
    if (i < nvec) {
      qv[v] = __ldg(reinterpret_cast<const uint4*>(y3q + (size_t)i * 16));
      id[v].load(idn, (size_t)i * 16);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const unsigned i = i0 + v * THREADS;
    if (i >= nvec) break;
    const float4* g4 = reinterpret_cast<const float4*>(
        gate + (size_t)(i / vec_per_image) * C + (i % vec_per_pixel) * 16);
    float q[16], d[16], g[16];
    const uint32_t w[4] = {qv[v].x, qv[v].y, qv[v].z, qv[v].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      codes_f32(w[j], q + 4 * j);
      const float4 gj = __ldg(g4 + j);
      g[4 * j] = gj.x;
      g[4 * j + 1] = gj.y;
      g[4 * j + 2] = gj.z;
      g[4 * j + 3] = gj.w;
    }
    id[v].get(d, in_s);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t c0 = code(q[4 * j], g[4 * j], d[4 * j], out_s, r, lim);
      const uint32_t c1 =
          code(q[4 * j + 1], g[4 * j + 1], d[4 * j + 1], out_s, r, lim);
      const uint32_t c2 =
          code(q[4 * j + 2], g[4 * j + 2], d[4 * j + 2], out_s, r, lim);
      const uint32_t c3 =
          code(q[4 * j + 3], g[4 * j + 3], d[4 * j + 3], out_s, r, lim);
      o[j] = __byte_perm(__byte_perm(c0, c1, 0x0040),
                         __byte_perm(c2, c3, 0x0040), 0x5410);
    }
    *reinterpret_cast<uint4*>(out + (size_t)i * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <bool IDN_F32, int V>
cudaError_t launch(const int8_t* q, const float* g, const void* idn,
                   int8_t* o, unsigned nvec, unsigned vpi, unsigned vpp,
                   float in_s, float out_s, cudaStream_t s) {
  const unsigned blocks = (nvec + THREADS * V - 1) / (THREADS * V);
  se_residual_i8_kernel<IDN_F32, V><<<blocks, THREADS, 0, s>>>(
      q, g, idn, o, nvec, vpi, vpp, in_s, out_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int insarseg_se_residual_i8(const void* y3q, const void* gate,
                                       const void* idn, void* out,
                                       long long nvec, long long HWC, int C,
                                       int idn_f32, float in_s, float out_s,
                                       void* stream) {
  if (C % 16 || HWC % 16 || nvec >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (nvec == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(y3q);
  const float* g = static_cast<const float*>(gate);
  int8_t* o = static_cast<int8_t*>(out);
  const unsigned vpi = (unsigned)(HWC / 16), vpp = (unsigned)(C / 16);
  return (int)(idn_f32 ? launch<true, 2>(q, g, idn, o, (unsigned)nvec, vpi,
                                         vpp, in_s, out_s, s)
                       : launch<false, 4>(q, g, idn, o, (unsigned)nvec, vpi,
                                          vpp, in_s, out_s, s));
}
