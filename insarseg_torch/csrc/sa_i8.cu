// K4a sa_stats_i8 + K4b sa_gate_i8: the U-Net-SA spatial gate on int8
// codes.
//
// Replaces insarseg/models/unet_int8.py::_sa_gate_i8, which computes, on a
// decoder concat's codes q (B, H, W, C) at scale s:
//   m = [mean_c(q * s), max_c(q * s)]      (B, H, W, 2) f32   -> K4a
//   g = sigmoid(DoubleConv(2 -> 1)(m))     (B, H, W)   f32   -> torch
//   out = clip(rint(q * g), +-127)         (B, H, W, C) s8   -> K4b
// The two tiny f32 3x3 convs and the sigmoid stay torch ops, as XLA
// computed them outside any fusion worth a kernel.
//
// Bound on an H100 SXM: both passes are pure bandwidth. K4a reads the codes
// once and writes 8 bytes a pixel; K4b reads the codes and a 4-byte gate a
// pixel and writes the codes once. At U-Net-SA base 64, 512^2 b8 the four
// gates read 503 MB of codes per forward: ~0.15 ms (K4a) and ~0.30 ms (K4b)
// at 3.35 TB/s. Design:
//   - K4a: 8 lanes per pixel (4 pixels a warp), 16-byte loads, neighbouring
//     lanes on neighbouring addresses. Each lane keeps an exact integer sum
//     (__dp4a with 0x01010101 adds the four signed bytes of a word) and a
//     packed per-byte max (__vmaxs4); shuffles reduce the 8 lanes. Then
//     mean = __fdiv_rn(__fmul_rn((float)S, s), (float)C) and
//     max = __fmul_rn((float)maxq, s). The max equals JAX's max(q * s) bit
//     for bit (a positive scale commutes with max and rounding is
//     monotone); the mean differs from JAX's f32 mean(q * s) only by the
//     reduction order. S is exact in the float while 127 * C < 2^24.
//   - K4b: one thread per 16-byte vector of codes (16 channels of one
//     pixel); the pixel's gate comes from L1/L2 as a broadcast.
//     __float2int_rn(__fmul_rn(q, g)) clamped to +-127, as the plain
//     torch.round(q * g).clamp(-127, 127).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;  // lanes per pixel in K4a
constexpr int PIX_PER_BLOCK = THREADS / LANES;

__device__ __forceinline__ int byte_at(unsigned word, int k) {
  return (int)(word << (24 - 8 * k)) >> 24;  // sign-extended byte k
}

__global__ void __launch_bounds__(THREADS) sa_stats_i8_kernel(
    const int8_t* __restrict__ x, float2* __restrict__ out, long long P,
    int C, float s) {
  const long long pix =
      (long long)blockIdx.x * PIX_PER_BLOCK + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  int sum = 0;
  unsigned mx = 0x80808080u;  // four bytes of -128
  if (pix < P) {
    const int8_t* p = x + pix * C;
    const int nv = C / 16;
#pragma unroll 4
    for (int v = lane; v < nv; v += LANES) {
      const int4 q = *reinterpret_cast<const int4*>(p + v * 16);
      sum = __dp4a(q.x, 0x01010101, sum);
      sum = __dp4a(q.y, 0x01010101, sum);
      sum = __dp4a(q.z, 0x01010101, sum);
      sum = __dp4a(q.w, 0x01010101, sum);
      mx = __vmaxs4(mx, (unsigned)q.x);
      mx = __vmaxs4(mx, (unsigned)q.y);
      mx = __vmaxs4(mx, (unsigned)q.z);
      mx = __vmaxs4(mx, (unsigned)q.w);
    }
  }
  int m = max(max(byte_at(mx, 0), byte_at(mx, 1)),
              max(byte_at(mx, 2), byte_at(mx, 3)));
  // every lane of the warp takes part in the shuffles (no early return)
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (pix < P && lane == 0) {
    float2 r;
    r.x = __fdiv_rn(__fmul_rn((float)sum, s), (float)C);
    r.y = __fmul_rn((float)m, s);
    out[pix] = r;
  }
}

__global__ void __launch_bounds__(THREADS) sa_gate_i8_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ gate,
    int8_t* __restrict__ out, long long nvec, int C) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const long long e = i * 16;
  const float g = gate[e / C];
  const int4 v = *reinterpret_cast<const int4*>(x + e);
  const unsigned words[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                             (unsigned)v.w};
  __align__(16) int8_t pack[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int q =
        __float2int_rn(__fmul_rn((float)byte_at(words[k / 4], k % 4), g));
    pack[k] = (int8_t)max(-127, min(127, q));
  }
  *reinterpret_cast<int4*>(out + e) = *reinterpret_cast<const int4*>(pack);
}

}  // namespace

// x (P, C) int8 codes with C % 16 == 0 (P = B*H*W pixels) at scale s ->
// out (P, 2) f32 [mean, max] of the dequantized codes over C.
extern "C" int insarseg_sa_stats_i8(const void* x, void* out, long long P,
                                    int C, float s, void* stream) {
  const unsigned blocks =
      (unsigned)((P + PIX_PER_BLOCK - 1) / PIX_PER_BLOCK);
  sa_stats_i8_kernel<<<blocks, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<float2*>(out), P, C, s);
  return (int)cudaGetLastError();
}

// x (P, C) int8 codes with C % 16 == 0, gate (P) f32 -> out (P, C) int8.
extern "C" int insarseg_sa_gate_i8(const void* x, const void* gate, void* out,
                                   long long nvec, int C, void* stream) {
  const unsigned blocks = (unsigned)((nvec + THREADS - 1) / THREADS);
  sa_gate_i8_kernel<<<blocks, THREADS, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(gate),
      static_cast<int8_t*>(out), nvec, C);
  return (int)cudaGetLastError();
}
