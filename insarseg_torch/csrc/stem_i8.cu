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
// NCHW input (the main path): a block takes 64 channels of one image, 4
// output rows and 128 output columns (256 input columns). Phase 1: warp w
// takes channels w, w + 8, ...; for each, lane l reads input columns
// 8 l .. 8 l + 7 of each of the 9 input rows the 4 output rows need as one
// 16-byte vector (a warp reads 512 contiguous bytes of a row; all 9 loads
// are in flight at once), gets column 8 l - 1 from lane l - 1 with a
// shuffle (lane 0 reads it, or -inf at the image's edge), takes the
// horizontal max of its 4 output columns in each row and the vertical max
// of 3 rows in registers: each input row is read once, and the one row two
// blocks share (1 in 9) is read again while the other block holds it in
// L2. W not a multiple of 8 (rows not 16-byte aligned) takes 9 scalar
// loads a row instead, the same arithmetic. The codes go to a shared tile
// [row][column][channel] (columns in lane-major order and rows of 68
// bytes: a warp's byte stores land in 32 banks). Phase 2: the tile leaves
// as 16-byte NHWC vectors, 64 contiguous channels of a pixel.
//
// Layouts: y (B, C, H, W) bf16, NCHW or channels-last, 16-byte aligned;
// out (B, Ho, Wo, C) int8 with Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
// C % 16 == 0; out 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant_i8.cuh"

namespace {

// NCHW kernel: output columns, output rows and channels a block; a
// staged column of channels, bytes
constexpr int THREADS = 256, TW = 128, R = 4, TC = 64, ROW = TC + 4;

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

// NCHW y: block (column span, output row band, image x channel group)
template <bool VEC>
__global__ void __launch_bounds__(THREADS) stem_pool_i8_kernel(
    const __nv_bfloat16* __restrict__ y, int8_t* __restrict__ out, int C,
    int H, int W, int Ho, int Wo, int cgroups, float s) {
  __shared__ __align__(16) int8_t tile[R * TW * ROW];
  constexpr int NR = 2 * R + 1;  // input rows of R output rows
  const float NEG = __uint_as_float(0xff800000u);  // -inf, the padding
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ow0 = blockIdx.x * TW, oh0 = blockIdx.y * R;
  const int b = blockIdx.z / cgroups, c0 = (blockIdx.z % cgroups) * TC;
  const int nc = min(TC, C - c0);
  const float r = __frcp_rn(s);
  const float lim = __fmul_rn(127.0f, s);
  const int x0 = 2 * ow0 + lane * 8;  // the lane's first input column

  for (int cl = warp; cl < nc; cl += THREADS / 32) {  // warp-uniform
    const __nv_bfloat16* p = y + ((size_t)b * C + c0 + cl) * H * W;
    // hm[k][i]: the max of input row 2 oh0 - 1 + k over the window of
    // the lane's output column i, columns x0 + 2i - 1 .. x0 + 2i + 1
    float hm[NR][4];
    if (VEC) {
      uint4 u[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int ih = 2 * oh0 - 1 + k;
        u[k] = (ih >= 0 && ih < H && x0 < W)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         p + (size_t)ih * W + x0))
                   : make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u,
                                0xff80ff80u);  // bf16 -inf
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int ih = 2 * oh0 - 1 + k;
        float v[9];  // columns x0 - 1 .. x0 + 7
        v[0] = bf_hi(__shfl_up_sync(0xffffffffu, u[k].w, 1));
        if (lane == 0)
          v[0] = (x0 > 0 && ih >= 0 && ih < H)
                     ? __bfloat162float(p[(size_t)ih * W + x0 - 1])
                     : NEG;
        const uint32_t w4[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[1 + 2 * q] = bf_lo(w4[q]);
          v[2 + 2 * q] = bf_hi(w4[q]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hm[k][i] = fmaxf(fmaxf(v[2 * i], v[2 * i + 1]), v[2 * i + 2]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int ih = 2 * oh0 - 1 + k;
        float v[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int x = x0 - 1 + j;
          v[j] = (ih >= 0 && ih < H && x >= 0 && x < W)
                     ? __bfloat162float(p[(size_t)ih * W + x])
                     : NEG;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hm[k][i] = fmaxf(fmaxf(v[2 * i], v[2 * i + 1]), v[2 * i + 2]);
      }
    }
    // output row q takes input rows 2q .. 2q + 2 of the band
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float m = fmaxf(fmaxf(hm[2 * q][i], hm[2 * q + 1][i]),
                        hm[2 * q + 2][i]);
        m = fminf(fmaxf(m, -lim), lim);
        tile[(q * TW + i * 32 + lane) * ROW + cl] = requant(m, s, r);
      }
  }
  __syncthreads();

  // R rows x TW columns x 4 vectors of 16 channels, 16 bytes a store; the
  // tile holds output column 4 l + i at column i * 32 + l
#pragma unroll
  for (int it = 0; it < R * TW * (TC / 16) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int vq = idx & 3, rc = idx >> 2;
    const int q = rc / TW, ol = rc % TW;
    const int oh = oh0 + q, ow = ow0 + ol;
    if (oh < Ho && ow < Wo && vq * 16 < nc) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          tile + (q * TW + (ol & 3) * 32 + (ol >> 2)) * ROW + vq * 16);
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * Ho + oh) * Wo + ow) * C + c0 + vq * 16) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
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
  if ((Ho + R - 1) / R > 65535 || (long long)B * cgroups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Wo + TW - 1) / TW), (unsigned)((Ho + R - 1) / R),
                  (unsigned)(B * cgroups));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  int8_t* o = static_cast<int8_t*>(out);
  if (W % 8 == 0)  // rows 16-byte aligned
    stem_pool_i8_kernel<true><<<grid, THREADS, 0, st>>>(yb, o, C, H, W, Ho,
                                                        Wo, cgroups, s);
  else
    stem_pool_i8_kernel<false><<<grid, THREADS, 0, st>>>(yb, o, C, H, W, Ho,
                                                         Wo, cgroups, s);
  return (int)cudaGetLastError();
}
