// K1 int8_conv3x3_epilogue: int8 x int8 -> int32 3x3 same-pad convolution
// on NHWC codes with the dequant / affine / ReLU / requant epilogue fused.
//
// Replaces insarseg/models/unet_int8.py::_conv_i8 (_conv_acc + _epilogue),
// which XLA:TPU compiled into one convolution fusion writing s8 codes.
//
// Bound on an H100 SXM: the 18 convolutions of one U-Net-CA forward do
// 367 G integer operations and move 263 MB of int8 activations per 512^2
// tile: ~186 us at the 1,979 TOP/s dense int8 tensor-core rate against
// ~78 us of traffic at 3.35 TB/s, so the function is compute-bound. This
// first kernel does not reach the tensor cores: it accumulates with
// __dp4a on the CUDA cores (4 int8 products per instruction), which puts
// its ceiling far below the tensor-core bound. Its design keeps the
// operands on chip instead:
//   - a block owns a 16x16 output-pixel tile x 64 output channels; each of
//     its 256 threads owns one pixel and keeps 64 int32 sums in registers;
//   - the input channels are walked in chunks of 32: the (16+2)^2 halo
//     patch and the 64 x 3x3 x 32 weight slice are staged in shared memory
//     (halo pixels padded to 48 bytes so the 16-byte reads of 8 adjacent
//     threads hit distinct banks; the weight reads are warp broadcasts);
//   - the epilogue runs on the registers and writes each pixel's 64 output
//     channels with 16-byte stores: __fmul_rn then __fadd_rn (two
//     roundings, as the eager plain version), ReLU, then either
//     __float2int_rn(__fdiv_rn(y, s)) clamped to +-127 -> int8, or
//     __float2bfloat16_rn(y) -> bf16.
// wgmma / mma.sync, TMA staging and fusing the 2x2 max-pool (K3) into this
// epilogue are later work.
//
// Layouts: x (B, H, W, Cin) int8 with Cin % 4 == 0 (the wrapper pads
// Cin = 1 with zero codes, which is exact); w (Cout, 3, 3, Cin) int8;
// mult, off (Cout) f32; out (B, H, W, Cout) int8 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int HALO = TILE + 2;
constexpr int CO_TILE = 64;
constexpr int CI_CHUNK = 32;     // input-channel bytes staged per step
constexpr int CI_WORDS = CI_CHUNK / 4;
constexpr int PIX_STRIDE = 48;   // shared-memory bytes per halo pixel
constexpr int THREADS = TILE * TILE;

__device__ __forceinline__ float affine_relu(int acc, float m, float o) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), o), 0.0f);
}

__device__ __forceinline__ int requant(float y, float s) {
  int q = __float2int_rn(__fdiv_rn(y, s));
  return max(-127, min(127, q));
}

template <bool BF16_OUT>
__global__ void __launch_bounds__(THREADS) conv3x3_i8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ off,
    void* __restrict__ out, int H, int W, int Cin, int Cout, float out_s,
    int tiles_w) {
  __shared__ __align__(16) int8_t xs[HALO * HALO * PIX_STRIDE];
  __shared__ __align__(16) int8_t ws[CO_TILE * 9 * CI_CHUNK];

  const int tid = threadIdx.x;
  const int ty = tid / TILE, tx = tid % TILE;
  const int oy0 = (blockIdx.x / tiles_w) * TILE;
  const int ox0 = (blockIdx.x % tiles_w) * TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int8_t* xb = x + (size_t)b * H * W * Cin;

  int acc[CO_TILE];
#pragma unroll
  for (int i = 0; i < CO_TILE; ++i) acc[i] = 0;

  for (int c0 = 0; c0 < Cin; c0 += CI_CHUNK) {
    const int cw = min(CI_CHUNK, Cin - c0);  // valid bytes, multiple of 4
    for (int i = tid; i < HALO * HALO * CI_WORDS; i += THREADS) {
      const int p = i / CI_WORDS, wd = i % CI_WORDS;
      const int iy = oy0 + p / HALO - 1, ix = ox0 + p % HALO - 1;
      int v = 0;
      if (wd * 4 < cw && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const int*>(
            xb + ((size_t)iy * W + ix) * Cin + c0 + wd * 4);
      *reinterpret_cast<int*>(xs + p * PIX_STRIDE + wd * 4) = v;
    }
    for (int i = tid; i < CO_TILE * 9 * CI_WORDS; i += THREADS) {
      const int r = i / CI_WORDS, wd = i % CI_WORDS;  // r = co * 9 + tap
      const int co = co0 + r / 9, tap = r % 9;
      int v = 0;
      if (wd * 4 < cw && co < Cout)
        v = *reinterpret_cast<const int*>(
            w + ((size_t)co * 9 + tap) * Cin + c0 + wd * 4);
      *reinterpret_cast<int*>(ws + r * CI_CHUNK + wd * 4) = v;
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int8_t* xp =
          xs + ((ty + tap / 3) * HALO + tx + tap % 3) * PIX_STRIDE;
#pragma unroll
      for (int g = 0; g < CI_CHUNK / 16; ++g) {
        const int4 xv = *reinterpret_cast<const int4*>(xp + g * 16);
#pragma unroll
        for (int co = 0; co < CO_TILE; ++co) {
          const int4 wv = *reinterpret_cast<const int4*>(
              ws + (co * 9 + tap) * CI_CHUNK + g * 16);
          int a = acc[co];
          a = __dp4a(xv.x, wv.x, a);
          a = __dp4a(xv.y, wv.y, a);
          a = __dp4a(xv.z, wv.z, a);
          a = __dp4a(xv.w, wv.w, a);
          acc[co] = a;
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= H || ox >= W) return;
  const size_t obase = (((size_t)b * H + oy) * W + ox) * Cout + co0;
  const bool full = co0 + CO_TILE <= Cout && Cout % 16 == 0;

  if (BF16_OUT) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) + obase;
    if (full) {
#pragma unroll
      for (int v = 0; v < CO_TILE / 8; ++v) {
        __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = v * 8 + k;
          pack[k] = __float2bfloat16_rn(
              affine_relu(acc[co], mult[co0 + co], off[co0 + co]));
        }
        *reinterpret_cast<uint4*>(o + v * 8) =
            *reinterpret_cast<const uint4*>(pack);
      }
    } else {
#pragma unroll
      for (int co = 0; co < CO_TILE; ++co)
        if (co0 + co < Cout)
          o[co] = __float2bfloat16_rn(
              affine_relu(acc[co], mult[co0 + co], off[co0 + co]));
    }
  } else {
    int8_t* o = reinterpret_cast<int8_t*>(out) + obase;
    if (full) {
#pragma unroll
      for (int v = 0; v < CO_TILE / 16; ++v) {
        __align__(16) int8_t pack[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int co = v * 16 + k;
          pack[k] = (int8_t)requant(
              affine_relu(acc[co], mult[co0 + co], off[co0 + co]), out_s);
        }
        *reinterpret_cast<int4*>(o + v * 16) =
            *reinterpret_cast<const int4*>(pack);
      }
    } else {
#pragma unroll
      for (int co = 0; co < CO_TILE; ++co)
        if (co0 + co < Cout)
          o[co] = (int8_t)requant(
              affine_relu(acc[co], mult[co0 + co], off[co0 + co]), out_s);
    }
  }
}

}  // namespace

extern "C" int insarseg_conv3x3_i8(const void* x, const void* w,
                                   const void* mult, const void* off,
                                   void* out, int B, int H, int W, int Cin,
                                   int Cout, float out_s, int bf16_out,
                                   void* stream) {
  const int tiles_h = (H + TILE - 1) / TILE, tiles_w = (W + TILE - 1) / TILE;
  const dim3 grid(tiles_h * tiles_w, (Cout + CO_TILE - 1) / CO_TILE, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* m = static_cast<const float*>(mult);
  const float* o = static_cast<const float*>(off);
  if (bf16_out)
    conv3x3_i8_kernel<true><<<grid, THREADS, 0, s>>>(
        xi, wi, m, o, out, H, W, Cin, Cout, out_s, tiles_w);
  else
    conv3x3_i8_kernel<false><<<grid, THREADS, 0, s>>>(
        xi, wi, m, o, out, H, W, Cin, Cout, out_s, tiles_w);
  return (int)cudaGetLastError();
}

extern "C" const char* insarseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
