// K2 se_squeeze_i8 + se_excite_i8: the squeeze-excite tail of an int8
// DoubleConv.
//
// Replaces the SE tail of insarseg/models/unet_int8.py::_dc_i8: the
// squeeze (mean over H, W of the int8 codes) and the one elementwise pass
// that excites and either requantizes to int8 or exits to bf16. The tiny
// fc1 -> ReLU -> fc2 -> sigmoid MLP between them stays a torch matmul, as
// XLA computed it outside any fusion. The ResNet engines' squeezes (the SE
// bottlenecks and the ASPP image pool) are the same squeeze.
//
// Bound on an H100 SXM: both passes are pure bandwidth (one read of the
// codes; the excite pass also writes them once, as int8 or bf16), so the
// bound is bytes / 3.35 TB/s. The squeeze's calls are 8-134 MB at b8 (2.5-
// 40 us), so a fixed cost of a few us per call matters. Design:
//   - squeeze: one launch, no memset and no atomics on the result. A block
//     takes the channel group g (Cg <= 256 channels, a divisor of C) of image
//     b over `per` of its pixels; each thread reads 16 channels, 16 bytes a
//     pixel, in batches of SQ_UNROLL loads in flight (128 bytes a thread, 32
//     KB a block, 4 blocks an SM; the host makes `per` a whole number of
//     batches where it can). A byte costs about one integer operation: the
//     word w ^ 0x80808080 holds each code + 128 as an unsigned byte; its even
//     and its odd bytes, masked into the two 16-bit lanes of two u32, are
//     summed with plain adds and flushed into int32 sums every FLUSH = 256
//     pixels (256 * 255 < 2^16); 128 * count comes off at the end. The block's
//     threads reduce in shared memory in a fixed order. Across the blocks of
//     one (image, group), the last block to finish sums the others' partial
//     sums from a scratch buffer in a fixed order; a per-(image, group)
//     counter finds it, and it resets the counter for the next launch. (A
//     thread block cluster of 8-16 blocks that summed the partial sums in
//     distributed shared memory was slower or no faster on every main-path
//     shape on an H100, e.g. 0.080 against 0.052 ms at b8 256x512x128: a
//     cluster a (batch, group) left the grid too small or too lumpy for 132
//     SMs.) Integer sums are exact and any order gives the one exact answer.
//     (The JAX package sums in f32, exact while 127*H*W < 2^24; the division
//     by H*W and the scale stay in torch on the (B, C) result.)
//   - excite: one thread per 16-byte vector of codes; the per-(b, c) gain
//     comes from L1/L2. int8 exit: __float2int_rn(q * gain) clamped to
//     +-127; bf16 exit: __float2bfloat16_rn(q * gain_bf16), exact in f32
//     before the one rounding, as the bf16 product of the JAX graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SQ_UNROLL = 8;  // 16-byte loads a thread keeps in flight
constexpr int FLUSH = 256;    // pixels a 16-bit lane sums before a flush

__device__ __forceinline__ int byte_at(int word, int k) {
  return (int)((unsigned)word << (24 - 8 * k)) >> 24;  // sign-extended byte k
}

struct Squeeze {
  const int8_t* x;     // (B, HW, C) codes
  int* out;            // (B, C) sums
  int* scratch;        // (B, G, splits, Cg) partial sums
  unsigned* counters;  // (B, G) blocks done, 0 between launches
  int HW, C, Cg, splits, per;  // per: pixels a block (the last, fewer)
};

// The 16 codes of v (code + 128 in each byte after the XOR), added into
// the 16-bit lanes of acc: acc[2j] holds channels 4j and 4j + 2, acc[2j + 1]
// channels 4j + 1 and 4j + 3.
__device__ __forceinline__ void add_lanes(uint32_t (&acc)[8], const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] += (w[j] ^ 0x80808080u) & 0x00FF00FFu;
    acc[2 * j + 1] += ((w[j] >> 8) ^ 0x00808080u) & 0x00FF00FFu;
  }
}

__device__ __forceinline__ void flush_lanes(uint32_t (&acc)[8],
                                            int (&tot)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tot[4 * j] += (int)(acc[2 * j] & 0xFFFFu);
    tot[4 * j + 2] += (int)(acc[2 * j] >> 16);
    tot[4 * j + 1] += (int)(acc[2 * j + 1] & 0xFFFFu);
    tot[4 * j + 3] += (int)(acc[2 * j + 1] >> 16);
    acc[2 * j] = acc[2 * j + 1] = 0;
  }
}

__global__ void __launch_bounds__(THREADS) se_squeeze_i8_kernel(
    const Squeeze a) {
  __shared__ __align__(16) int red[THREADS * 16];  // the threads' sums
  __shared__ bool last;
  const int nv = a.Cg / 16;  // 16-byte lanes of a pixel in the group
  const int ppi = THREADS / nv;
  const int tid = threadIdx.x;
  const int lane_v = tid % nv, lane_p = tid / nv;
  const int b = blockIdx.y;
  const int g = blockIdx.x / a.splits, s = blockIdx.x % a.splits;
  const int p0 = s * a.per, p1 = min(a.HW, p0 + a.per);

  if (lane_p < ppi) {
    int tot[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) tot[k] = 0;
    const int first = p0 + lane_p;
    const int count = first < p1 ? (p1 - first + ppi - 1) / ppi : 0;
    const size_t step = (size_t)ppi * a.C;
    const int8_t* ptr =
        a.x + ((size_t)b * a.HW + first) * a.C + g * a.Cg + lane_v * 16;
    uint32_t acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0;
    for (int done = 0; done < count; done += FLUSH) {
      const int n = min(count - done, FLUSH);
      for (int k = 0; k < n; k += SQ_UNROLL) {
        // a batch of loads in flight; a slot past the thread's pixels
        // holds codes -128, which add 0 to the biased lanes
        uint4 v[SQ_UNROLL];
#pragma unroll
        for (int u = 0; u < SQ_UNROLL; ++u)
          v[u] = k + u < n
                     ? __ldg(reinterpret_cast<const uint4*>(ptr + u * step))
                     : make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                                  0x80808080u);
        ptr += SQ_UNROLL * step;
#pragma unroll
        for (int u = 0; u < SQ_UNROLL; ++u) add_lanes(acc, v[u]);
      }
      flush_lanes(acc, tot);
    }
    int4* r = reinterpret_cast<int4*>(red + tid * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = make_int4(tot[4 * k] - 128 * count, tot[4 * k + 1] - 128 * count,
                       tot[4 * k + 2] - 128 * count,
                       tot[4 * k + 3] - 128 * count);
  }
  __syncthreads();
  // red[p * Cg + c] holds pixel lane p's sum of channel c
  int sum = 0;
  if (tid < a.Cg)
    for (int p = 0; p < ppi; ++p) sum += red[p * a.Cg + tid];
  int* out = a.out + (size_t)b * a.C + g * a.Cg;

  if (a.splits == 1) {
    if (tid < a.Cg) out[tid] = sum;
    return;
  }
  const int bg = b * (a.C / a.Cg) + g;
  int* mine = a.scratch + (size_t)bg * a.splits * a.Cg;
  if (tid < a.Cg) mine[s * a.Cg + tid] = sum;
  __threadfence();  // the partial sums are visible before the count
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.counters + bg, 1u) == (unsigned)(a.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the splits' partial sums, in a fixed order
  if (tid < a.Cg) {
    int total = 0;
#pragma unroll 8
    for (int j = 0; j < a.splits; ++j) total += __ldcg(mine + j * a.Cg + tid);
    out[tid] = total;
  }
  if (tid == 0) a.counters[bg] = 0;  // ready for the next launch
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

// Blocks of `per` pixels, `splits` of them an (image, channel group).
extern "C" int insarseg_se_squeeze_i8(const void* x, void* sums, void* scratch,
                                      void* counters, int B, int HW, int C,
                                      int Cg, int splits, int per,
                                      void* stream) {
  if (B < 1 || HW < 1 || C % 16 || Cg % 16 || Cg < 16 || Cg > THREADS ||
      C % Cg || splits < 1 || per < 1 || (long long)splits * per < HW)
    return (int)cudaErrorInvalidValue;
  const Squeeze a = {static_cast<const int8_t*>(x), static_cast<int*>(sums),
                     static_cast<int*>(scratch),
                     static_cast<unsigned*>(counters), HW, C, Cg, splits,
                     per};
  const dim3 grid((C / Cg) * splits, B);
  se_squeeze_i8_kernel<<<grid, THREADS, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(a);
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
