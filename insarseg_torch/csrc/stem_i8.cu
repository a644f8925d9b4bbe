// K7 stem_pool_i8: the exit of the int8 ResNet's bf16 stem in one pass:
//   out[b, oh, ow, c] = clip(rint(max_{3x3 window} y[b, c, :, :] / s), +-127)
// a 3x3 / stride-2 / pad-1 max-pool (the padding acts as -inf) on the bf16
// stem output, the requant to the first block's scale, and the int8 NHWC
// codes the bottlenecks take. The stem output lies as the conv leaves it,
// and cuDNN picks the layout by shape (its one-channel input is contiguous
// in both formats): NCHW at 512^2 b8 on the H100, channels-last (NHWC
// memory) at 64^2 b2. Both are taken, each by its own kernel.
//
// Replaces insarseg/models/resnet_int8.py::resnet_int8_apply lines 278-280
// (max_pool_2d, astype(f32), _requant), an XLA:TPU fusion; in PyTorch it
// was a max-pool, two layout copies, an f32 cast and the requant passes.
// The max is exact, so the codes are requant(max_pool2d(y)) bit for bit:
// the quotient is requant_i8.cuh's div_rn (RN(y / s)), after y is clamped
// to [-lim, lim], lim = RN(127 s) (a y outside gives +-127 either way, and
// the quotient stays finite). Finite inputs: the stem's output after its
// ReLU.
//
// Bound on an H100 SXM (700 W): bytes. At 512^2 b8 it reads the
// (8, 64, 256, 256) bf16 map once (67 MB) and writes (8, 128, 128, 64)
// int8 (8.4 MB): 0.023 ms at 3.35 TB/s.
//
// Channels-last input: one thread per output pixel and 8 channels takes
// the max of nine 16-byte loads (neighbouring threads read neighbouring
// channels; the window overlap hits L1 / L2) and stores 8 codes.
//
// NCHW input: the transpose goes through shared memory. A block takes
// one output row of 64 output columns and up to 64 channels of one image.
// Phase 1:
// each thread takes one output column and a quarter of the channels, and
// reads the nine window values of each channel along the NCHW rows (a
// warp's 32 columns read one 128-byte span of each input row; the
// overlapping windows hit L1, and the next output row's block finds the
// shared input row in L2); the codes go to a shared tile [column][channel]
// (rows padded to 68 bytes: a warp's byte stores land in 32 banks). Phase
// 2: the tile leaves as 16-byte NHWC vectors, 64 contiguous channels of a
// column.
//
// Layouts: y (B, C, H, W) bf16, NCHW or channels-last, 16-byte aligned;
// out (B, Ho, Wo, C) int8 with Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
// C % 16 == 0; out 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant_i8.cuh"

namespace {

constexpr int THREADS = 256, TW = 64, TC = 64, ROW = TC + 4;

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// channels-last y: thread i takes output pixel i / (C / 8), channels
// 8 * (i % (C / 8)) ... + 7
__global__ void __launch_bounds__(THREADS) stem_pool_nhwc_i8_kernel(
    const __nv_bfloat16* __restrict__ y, int8_t* __restrict__ out, int C,
    int H, int W, int Ho, int Wo, long long nvec, float s) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const int nv = C / 8;
  const int cv = (int)(i % nv);
  long long px = i / nv;
  const int ow = (int)(px % Wo);
  px /= Wo;
  const int oh = (int)(px % Ho);
  const long long b = px / Ho;
  const float r = __frcp_rn(s);
  const float lim = __fmul_rn(127.0f, s);
  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
  for (int dr = 0; dr < 3; ++dr) {
    const int hh = 2 * oh - 1 + dr;
    if (hh < 0 || hh >= H) continue;
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      const int ww = 2 * ow - 1 + dc;
      if (ww < 0 || ww >= W) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          y + ((b * H + hh) * (size_t)W + ww) * C + cv * 8));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[2 * k] = fmaxf(m[2 * k], bf_lo(u[k]));
        m[2 * k + 1] = fmaxf(m[2 * k + 1], bf_hi(u[k]));
      }
    }
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float q = fminf(fmaxf(m[k], -lim), lim);
    w[k / 4] |= (uint32_t)(uint8_t)requant(q, s, r) << (8 * (k % 4));
  }
  *reinterpret_cast<uint2*>(out + i * 8) = make_uint2(w[0], w[1]);
}

__global__ void __launch_bounds__(THREADS) stem_pool_i8_kernel(
    const __nv_bfloat16* __restrict__ y, int8_t* __restrict__ out, int C,
    int H, int W, int Ho, int Wo, int cgroups, float s) {
  __shared__ __align__(16) int8_t tile[TW * ROW];
  const int tid = threadIdx.x;
  const int ow0 = blockIdx.x * TW, oh = blockIdx.y;
  const int b = blockIdx.z / cgroups, c0 = (blockIdx.z % cgroups) * TC;
  const int nc = min(TC, C - c0);
  const float r = __frcp_rn(s);
  const float lim = __fmul_rn(127.0f, s);

  const int ol = tid & (TW - 1), ow = ow0 + ol;
  if (ow < Wo) {
    const int h0 = 2 * oh - 1, w0 = 2 * ow - 1;
    for (int cl = tid >> 6; cl < nc; cl += THREADS / TW) {
      const __nv_bfloat16* p = y + ((size_t)b * C + c0 + cl) * H * W;
      float m = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        const int hh = h0 + dr;
        if (hh < 0 || hh >= H) continue;
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int ww = w0 + dc;
          if (ww >= 0 && ww < W)
            m = fmaxf(m, __bfloat162float(p[(size_t)hh * W + ww]));
        }
      }
      m = fminf(fmaxf(m, -lim), lim);
      tile[ol * ROW + cl] = requant(m, s, r);
    }
  }
  __syncthreads();

  // 64 columns x 4 vectors of 16 channels: one 16-byte store a thread
  const int col = tid >> 2, v = tid & 3, owc = ow0 + col;
  if (owc < Wo && v * 16 < nc) {
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(tile + col * ROW + v * 16);
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * Ho + oh) * Wo + owc) * C + c0 + v * 16) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

}  // namespace

// y (B, C, H, W) bf16, channels-last (nhwc = 1) or NCHW -> out (B, Ho, Wo,
// C) int8 codes at scale s.
extern "C" int insarseg_stem_pool_i8(const void* y, void* out, int B, int C,
                                     int H, int W, int nhwc, float s,
                                     void* stream) {
  if (C % 16 || B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  if (nhwc) {
    const long long nvec = (long long)B * Ho * Wo * (C / 8);
    stem_pool_nhwc_i8_kernel<<<(unsigned)((nvec + THREADS - 1) / THREADS),
                               THREADS, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<int8_t*>(out), C, H,
        W, Ho, Wo, nvec, s);
    return (int)cudaGetLastError();
  }
  const int cgroups = (C + TC - 1) / TC;
  if (Ho > 65535 || (long long)B * cgroups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Wo + TW - 1) / TW), (unsigned)Ho,
                  (unsigned)(B * cgroups));
  stem_pool_i8_kernel<<<grid, THREADS, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<int8_t*>(out), C, H,
      W, Ho, Wo, cgroups, s);
  return (int)cudaGetLastError();
}
