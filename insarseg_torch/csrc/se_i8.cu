// K2 se_squeeze_i8 + se_excite_i8: the squeeze-excite tail of an int8
// DoubleConv.
//
// Replaces the SE tail of insarseg/models/unet_int8.py::_dc_i8: the
// squeeze (mean over H, W of the int8 codes) and the one elementwise pass
// that excites and either requantizes to int8 or exits to bf16. The tiny
// fc1 -> ReLU -> fc2 -> sigmoid MLP between them stays a torch matmul, as
// XLA computed it outside any fusion.
//
// Bound on an H100 SXM: both passes are pure bandwidth (one read of the
// codes; the excite pass also writes them once, as int8 or bf16), so the
// bound is bytes / 3.35 TB/s. Design:
//   - squeeze: a grid of (splits of H*W) x batch blocks; each thread reads
//     16 channels with one 16-byte load per pixel and keeps 16 int32 sums;
//     a block reduces in shared memory and adds its partial sums to the
//     (B, C) int32 result with atomics. Integer sums are exact and
//     order-independent, so any split of H*W gives the same answer. (The
//     JAX package sums in f32, exact only while 127*H*W < 2^24; at 512^2
//     the integer sum is the more exact one.) The division by H*W and the
//     scale stay in torch on the (B, C) result.
//   - excite: one thread per 16-byte vector of codes; the per-(b, c) gain
//     comes from L1/L2. int8 exit: __float2int_rn(q * gain) clamped to
//     +-127; bf16 exit: __float2bfloat16_rn(q * gain_bf16), exact in f32
//     before the one rounding, as the bf16 product of the JAX graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int byte_at(int word, int k) {
  return (int)((unsigned)word << (24 - 8 * k)) >> 24;  // sign-extended byte k
}

__global__ void __launch_bounds__(THREADS) se_squeeze_i8_kernel(
    const int8_t* __restrict__ x, int* __restrict__ sums, int HW, int C,
    int pix_per_block) {
  extern __shared__ int ssum[];  // C ints
  const int nv = C / 16;
  const int ppi = THREADS / nv;
  const int lane_v = threadIdx.x % nv, lane_p = threadIdx.x / nv;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C; i += THREADS) ssum[i] = 0;
  __syncthreads();

  if (lane_p < ppi) {
    int s[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = 0;
    const int p0 = blockIdx.x * pix_per_block;
    const int p1 = min(HW, p0 + pix_per_block);
    const int8_t* xb = x + (size_t)b * HW * C + lane_v * 16;
    for (int p = p0 + lane_p; p < p1; p += ppi) {
      const int4 v = *reinterpret_cast<const int4*>(xb + (size_t)p * C);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] += byte_at(v.x, k);
        s[4 + k] += byte_at(v.y, k);
        s[8 + k] += byte_at(v.z, k);
        s[12 + k] += byte_at(v.w, k);
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) atomicAdd(&ssum[lane_v * 16 + k], s[k]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += THREADS)
    atomicAdd(&sums[(size_t)b * C + i], ssum[i]);
}

template <bool BF16_OUT>
__global__ void __launch_bounds__(THREADS) se_excite_i8_kernel(
    const int8_t* __restrict__ x, const void* __restrict__ gain,
    void* __restrict__ out, long long nvec, long long HWC, int C) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const long long e = i * 16;
  const long long b = e / HWC;
  const int c0 = (int)(e % C);
  const int4 v = *reinterpret_cast<const int4*>(x + e);
  const int words[4] = {v.x, v.y, v.z, v.w};
  if (BF16_OUT) {
    const __nv_bfloat16* g =
        reinterpret_cast<const __nv_bfloat16*>(gain) + b * C + c0;
    __align__(16) __nv_bfloat16 pack[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      pack[k] = __float2bfloat16_rn(__fmul_rn(
          (float)byte_at(words[k / 4], k % 4), __bfloat162float(g[k])));
    uint4* o = reinterpret_cast<uint4*>(
        reinterpret_cast<__nv_bfloat16*>(out) + e);
    o[0] = reinterpret_cast<const uint4*>(pack)[0];
    o[1] = reinterpret_cast<const uint4*>(pack)[1];
  } else {
    const float* g = reinterpret_cast<const float*>(gain) + b * C + c0;
    __align__(16) int8_t pack[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int q = __float2int_rn(
          __fmul_rn((float)byte_at(words[k / 4], k % 4), g[k]));
      pack[k] = (int8_t)max(-127, min(127, q));
    }
    *reinterpret_cast<int4*>(reinterpret_cast<int8_t*>(out) + e) =
        *reinterpret_cast<const int4*>(pack);
  }
}

}  // namespace

extern "C" int insarseg_se_squeeze_i8(const void* x, void* sums, int B,
                                      int HW, int C, int splits,
                                      int pix_per_block, void* stream) {
  const dim3 grid(splits, B);
  se_squeeze_i8_kernel<<<grid, THREADS, C * sizeof(int),
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int*>(sums), HW, C,
      pix_per_block);
  return (int)cudaGetLastError();
}

extern "C" int insarseg_se_excite_i8(const void* x, const void* gain,
                                     void* out, long long nvec, long long HWC,
                                     int C, int bf16_out, void* stream) {
  const unsigned blocks = (unsigned)((nvec + THREADS - 1) / THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  if (bf16_out)
    se_excite_i8_kernel<true><<<blocks, THREADS, 0, s>>>(xi, gain, out, nvec,
                                                         HWC, C);
  else
    se_excite_i8_kernel<false><<<blocks, THREADS, 0, s>>>(xi, gain, out,
                                                          nvec, HWC, C);
  return (int)cudaGetLastError();
}
