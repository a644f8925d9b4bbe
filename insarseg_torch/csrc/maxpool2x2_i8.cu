// K3 maxpool2x2_i8: 2x2 / stride-2 max-pool on NHWC int8 codes.
//
// Replaces insarseg/models/unet_int8.py::_maxpool_i8 (a reduce_window max
// with init -128 on the codes; max commutes with the positive scale).
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
