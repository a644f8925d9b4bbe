// K3 maxpool2x2_i8: 2x2 / stride-2 max-pool on NHWC int8 codes, and K3s
// maxpool_exit_s2d_i8: the same window on H-s2d codes, leaving the s2d
// layout.
//
// K3 replaces insarseg/models/unet_int8.py::_maxpool_i8 (a reduce_window
// max with init -128 on the codes; max commutes with the positive scale).
// K3s replaces insarseg/models/unet_s2d.py::_maxpool_exit_s2d as
// unet_int8.py:335 calls it on the level-1 codes: (B, R, W, 2C) s8 ->
// (B, R, W/2, C) s8, out[b,r,j,c] = max over e, a in {0,1} of
// x[b, r, 2j+e, a*C + c] (row parity a lives in the channels). The four
// inputs of one output vector are the contiguous 4C bytes of pixels 2j and
// 2j+1, so the kernel is K3 with other offsets.
//
// Bound on an H100 SXM: pure bandwidth, one read of the input and one
// write of the quarter-size output over 3.35 TB/s. Design: one thread per
// 16-byte output vector (16 channels of one output pixel) does four
// 16-byte loads, one per window pixel, and a per-byte signed max with
// __vmaxs4; neighbouring threads touch neighbouring addresses. Fusing it
// into K1's epilogue is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int vmax(int a, int b) {
  return (int)__vmaxs4((unsigned)a, (unsigned)b);
}

__global__ void __launch_bounds__(THREADS) maxpool2x2_i8_kernel(
    const int8_t* __restrict__ x, int8_t* __restrict__ out, int H, int W,
    int C, int Ho, int Wo, long long nvec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const int nv = C / 16;
  const int cv = (int)(i % nv);
  long long pix = i / nv;
  const int ox = (int)(pix % Wo);
  pix /= Wo;
  const int oy = (int)(pix % Ho);
  const long long b = pix / Ho;
  const size_t row = (size_t)W * C;
  const int8_t* p = x + ((b * H + 2 * oy) * (size_t)W + 2 * ox) * C + cv * 16;
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 bq = *reinterpret_cast<const int4*>(p + C);
  const int4 c = *reinterpret_cast<const int4*>(p + row);
  const int4 d = *reinterpret_cast<const int4*>(p + row + C);
  int4 r;
  r.x = vmax(vmax(a.x, bq.x), vmax(c.x, d.x));
  r.y = vmax(vmax(a.y, bq.y), vmax(c.y, d.y));
  r.z = vmax(vmax(a.z, bq.z), vmax(c.z, d.z));
  r.w = vmax(vmax(a.w, bq.w), vmax(c.w, d.w));
  *reinterpret_cast<int4*>(out + i * 16) = r;
}

__global__ void __launch_bounds__(THREADS) maxpool_exit_s2d_i8_kernel(
    const int8_t* __restrict__ x, int8_t* __restrict__ out, int W, int C,
    int Wo, long long nvec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const int nv = C / 16;
  const int cv = (int)(i % nv);
  const long long pix = i / nv;  // (b * R + r) * Wo + j
  const int j = (int)(pix % Wo);
  const long long row = pix / Wo;  // b * R + r
  const int8_t* p = x + (row * W + 2 * j) * (2 * (size_t)C) + cv * 16;
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 bq = *reinterpret_cast<const int4*>(p + C);
  const int4 c = *reinterpret_cast<const int4*>(p + 2 * C);
  const int4 d = *reinterpret_cast<const int4*>(p + 3 * C);
  int4 r;
  r.x = vmax(vmax(a.x, bq.x), vmax(c.x, d.x));
  r.y = vmax(vmax(a.y, bq.y), vmax(c.y, d.y));
  r.z = vmax(vmax(a.z, bq.z), vmax(c.z, d.z));
  r.w = vmax(vmax(a.w, bq.w), vmax(c.w, d.w));
  *reinterpret_cast<int4*>(out + i * 16) = r;
}

}  // namespace

extern "C" int insarseg_maxpool2x2_i8(const void* x, void* out, int B, int H,
                                      int W, int C, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const long long nvec = (long long)B * Ho * Wo * (C / 16);
  const unsigned blocks = (unsigned)((nvec + THREADS - 1) / THREADS);
  maxpool2x2_i8_kernel<<<blocks, THREADS, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), H, W, C, Ho,
      Wo, nvec);
  return (int)cudaGetLastError();
}

// x (B, R, W, 2C) int8 with C % 16 == 0 -> out (B, R, W/2, C) int8.
extern "C" int insarseg_maxpool_exit_s2d_i8(const void* x, void* out, int B,
                                           int R, int W, int C,
                                           void* stream) {
  const int Wo = W / 2;
  const long long nvec = (long long)B * R * Wo * (C / 16);
  const unsigned blocks = (unsigned)((nvec + THREADS - 1) / THREADS);
  maxpool_exit_s2d_i8_kernel<<<blocks, THREADS, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), W, C, Wo,
      nvec);
  return (int)cudaGetLastError();
}
