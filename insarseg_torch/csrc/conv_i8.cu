// K5a int8_conv_epilogue: int8 x int8 -> int32 k x k convolution (k = 1 or
// 3) with stride, dilation and symmetric zero padding d*(k-1)/2 on NHWC
// codes, with a generalized fused epilogue:
//   y = acc * mult[c] + off[c]            (__fmul_rn, then __fadd_rn)
//   y = y + idn                           (optional residual; idn is either
//                                          int8 codes * in_s (__fmul_rn) or
//                                          an f32 tensor; __fadd_rn)
//   y = max(y, 0)                         (optional ReLU)
//   exit: int8 clip(rint(y / out_s), +-127) (a true __fdiv_rn, then
//         __float2int_rn), or f32 y, or bf16 __float2bfloat16_rn(y).
// The roundings are those of the JAX graph, in its order.
//
// Replaces insarseg/models/resnet_int8.py::_conv_i8 and the residual add of
// _block_i8 (resnet_int8.py:270), which XLA:TPU compiled into one
// convolution fusion per conv: every backbone, ASPP and head conv of the
// DeepLabV3 / FCN int8 engines.
//
// Bound on an H100 SXM at its 700 W power limit: operations,
// 2*B*Ho*Wo*Cin*Cout*k^2 at the 1,979 TOP/s dense int8 tensor-core rate
// (one FCN-CA forward at 512^2, batch 8, is about 2.2 T int-ops: ~1.1 ms),
// against bytes (input, weights, output and identity once) at 3.35 TB/s. |acc| <= 9 * 2048 * 127^2 ~ 3.0e8 fits
// int32. This first kernel does not reach the tensor cores: it accumulates
// with __dp4a on the CUDA cores, as K1 (int8_conv3x3.cu) does, which puts
// its ceiling far below that bound. Design:
//   - a block owns a 16x16 output-pixel tile x 64 output channels; each of
//     its 256 threads owns one output pixel and keeps 64 int32 sums in
//     registers;
//   - the input channels are walked in chunks of 32 bytes, and within a
//     chunk the k*k taps one by one: for each tap the 16x16 input pixels
//     it reads (stride and dilation applied, zero outside the image) and
//     the 64 x 32 weight slice are staged in shared memory. Staging per tap
//     instead of a halo patch keeps shared memory at 14 KB for any
//     dilation (a halo at dilation 36 would need 88^2 pixels); a pixel is
//     staged up to k*k times, from L2;
//   - pixels sit 48 bytes apart in shared memory, so the 16-byte reads of
//     8 adjacent threads hit distinct banks; weight reads are broadcasts;
//   - the epilogue runs on the registers; the identity is read with 16-byte
//     loads and the outputs are written with 16-byte stores.
// mma.sync / wgmma and TMA staging are later work.
//
// Layouts: x (B, H, W, Cin) int8 with Cin % 4 == 0 (the wrapper pads with
// zero codes, which is exact); w (Cout, k, k, Cin) int8; mult, off (Cout)
// f32; idn (B, Ho, Wo, Cout) int8 or f32; out (B, Ho, Wo, Cout) int8, f32
// or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int CO_TILE = 64;
constexpr int CI_CHUNK = 32;    // input-channel bytes staged per step
constexpr int CI_WORDS = CI_CHUNK / 4;
constexpr int PIX_STRIDE = 48;  // shared-memory bytes per staged pixel
constexpr int THREADS = TILE * TILE;

enum { IDN_NONE = 0, IDN_S8 = 1, IDN_F32 = 2 };
enum { EXIT_S8 = 0, EXIT_F32 = 1, EXIT_BF16 = 2 };

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* mult;
  const float* off;
  const void* idn;
  void* out;
  int H, W, Cin, Ho, Wo, Cout, K, stride, dil, pad, relu, tiles_w;
  float in_s, out_s;
};

template <int IDN>
__device__ __forceinline__ float epilogue(const Args& a, int acc, int c,
                                          size_t o) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a.mult[c]), a.off[c]);
  if (IDN == IDN_S8)
    y = __fadd_rn(y, __fmul_rn((float)static_cast<const int8_t*>(a.idn)[o],
                               a.in_s));
  if (IDN == IDN_F32) y = __fadd_rn(y, static_cast<const float*>(a.idn)[o]);
  return a.relu ? fmaxf(y, 0.0f) : y;
}

__device__ __forceinline__ int8_t requant(float y, float s) {
  const int q = __float2int_rn(__fdiv_rn(y, s));
  return (int8_t)max(-127, min(127, q));
}

template <int IDN, int EXIT>
__device__ __forceinline__ void store_one(const Args& a, int acc, int c,
                                          size_t o) {
  const float y = epilogue<IDN>(a, acc, c, o);
  if (EXIT == EXIT_S8) static_cast<int8_t*>(a.out)[o] = requant(y, a.out_s);
  if (EXIT == EXIT_F32) static_cast<float*>(a.out)[o] = y;
  if (EXIT == EXIT_BF16)
    static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
}

template <int IDN, int EXIT>
__global__ void __launch_bounds__(THREADS) conv_i8_kernel(const Args a) {
  __shared__ __align__(16) int8_t xs[THREADS * PIX_STRIDE];
  __shared__ __align__(16) int8_t ws[CO_TILE * CI_CHUNK];

  const int tid = threadIdx.x;
  const int oy0 = (blockIdx.x / a.tiles_w) * TILE;
  const int ox0 = (blockIdx.x % a.tiles_w) * TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int KK = a.K * a.K;
  const int8_t* xb = a.x + (size_t)b * a.H * a.W * a.Cin;

  int acc[CO_TILE];
#pragma unroll
  for (int i = 0; i < CO_TILE; ++i) acc[i] = 0;

  for (int c0 = 0; c0 < a.Cin; c0 += CI_CHUNK) {
    const int cw = min(CI_CHUNK, a.Cin - c0);  // valid bytes, multiple of 4
    for (int tap = 0; tap < KK; ++tap) {
      const int dy = (tap / a.K) * a.dil - a.pad;
      const int dx = (tap % a.K) * a.dil - a.pad;
      for (int i = tid; i < THREADS * CI_WORDS; i += THREADS) {
        const int p = i / CI_WORDS, wd = i % CI_WORDS;
        const int oy = oy0 + p / TILE, ox = ox0 + p % TILE;
        const int iy = oy * a.stride + dy, ix = ox * a.stride + dx;
        int v = 0;
        if (wd * 4 < cw && oy < a.Ho && ox < a.Wo && iy >= 0 && iy < a.H &&
            ix >= 0 && ix < a.W)
          v = *reinterpret_cast<const int*>(
              xb + ((size_t)iy * a.W + ix) * a.Cin + c0 + wd * 4);
        *reinterpret_cast<int*>(xs + p * PIX_STRIDE + wd * 4) = v;
      }
      for (int i = tid; i < CO_TILE * CI_WORDS; i += THREADS) {
        const int co = i / CI_WORDS, wd = i % CI_WORDS;
        int v = 0;
        if (wd * 4 < cw && co0 + co < a.Cout)
          v = *reinterpret_cast<const int*>(
              a.w + ((size_t)(co0 + co) * KK + tap) * a.Cin + c0 + wd * 4);
        *reinterpret_cast<int*>(ws + co * CI_CHUNK + wd * 4) = v;
      }
      __syncthreads();

      const int8_t* xp = xs + tid * PIX_STRIDE;
#pragma unroll
      for (int g = 0; g < CI_CHUNK / 16; ++g) {
        const int4 xv = *reinterpret_cast<const int4*>(xp + g * 16);
#pragma unroll
        for (int co = 0; co < CO_TILE; ++co) {
          const int4 wv =
              *reinterpret_cast<const int4*>(ws + co * CI_CHUNK + g * 16);
          int s = acc[co];
          s = __dp4a(xv.x, wv.x, s);
          s = __dp4a(xv.y, wv.y, s);
          s = __dp4a(xv.z, wv.z, s);
          s = __dp4a(xv.w, wv.w, s);
          acc[co] = s;
        }
      }
      __syncthreads();
    }
  }

  const int oy = oy0 + tid / TILE, ox = ox0 + tid % TILE;
  if (oy >= a.Ho || ox >= a.Wo) return;
  const size_t obase = (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout + co0;
  const bool full = co0 + CO_TILE <= a.Cout && a.Cout % 16 == 0;
  if (!full) {
#pragma unroll
    for (int co = 0; co < CO_TILE; ++co)
      if (co0 + co < a.Cout) store_one<IDN, EXIT>(a, acc[co], co0 + co,
                                                  obase + co);
    return;
  }
  // 16 channels per step: one 16-byte identity load (int8) or four (f32),
  // and one 16-byte store (int8), two (bf16) or four (f32)
#pragma unroll
  for (int v = 0; v < CO_TILE / 16; ++v) {
    float idn[16];
    if (IDN == IDN_S8) {
      __align__(16) int8_t q[16];
      *reinterpret_cast<int4*>(q) = *reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(a.idn) + obase + v * 16);
#pragma unroll
      for (int k = 0; k < 16; ++k) idn[k] = __fmul_rn((float)q[k], a.in_s);
    }
    if (IDN == IDN_F32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 f = reinterpret_cast<const float4*>(
            static_cast<const float*>(a.idn) + obase + v * 16)[k];
        idn[4 * k] = f.x;
        idn[4 * k + 1] = f.y;
        idn[4 * k + 2] = f.z;
        idn[4 * k + 3] = f.w;
      }
    }
    float y[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = co0 + v * 16 + k;
      y[k] = __fadd_rn(__fmul_rn(__int2float_rn(acc[v * 16 + k]), a.mult[c]),
                       a.off[c]);
      if (IDN != IDN_NONE) y[k] = __fadd_rn(y[k], idn[k]);
      if (a.relu) y[k] = fmaxf(y[k], 0.0f);
    }
    const size_t o = obase + v * 16;
    if (EXIT == EXIT_S8) {
      __align__(16) int8_t pack[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) pack[k] = requant(y[k], a.out_s);
      *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) + o) =
          *reinterpret_cast<const int4*>(pack);
    }
    if (EXIT == EXIT_F32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.out) + o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = make_float4(y[4 * k], y[4 * k + 1], y[4 * k + 2],
                             y[4 * k + 3]);
    }
    if (EXIT == EXIT_BF16) {
      __align__(16) __nv_bfloat16 pack[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) pack[k] = __float2bfloat16_rn(y[k]);
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(a.out) + o);
      dst[0] = reinterpret_cast<const uint4*>(pack)[0];
      dst[1] = reinterpret_cast<const uint4*>(pack)[1];
    }
  }
}

template <int IDN>
void launch_exit(int exit_kind, dim3 grid, cudaStream_t s, const Args& a) {
  if (exit_kind == EXIT_S8)
    conv_i8_kernel<IDN, EXIT_S8><<<grid, THREADS, 0, s>>>(a);
  else if (exit_kind == EXIT_F32)
    conv_i8_kernel<IDN, EXIT_F32><<<grid, THREADS, 0, s>>>(a);
  else
    conv_i8_kernel<IDN, EXIT_BF16><<<grid, THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" int insarseg_conv_i8(const void* x, const void* w,
                                const void* mult, const void* off,
                                const void* idn, void* out, int B, int H,
                                int W, int Cin, int Ho, int Wo, int Cout,
                                int K, int stride, int dilation, int relu,
                                int idn_kind, float in_s, float out_s,
                                int exit_kind, void* stream) {
  if ((K != 1 && K != 3) || idn_kind < 0 || idn_kind > 2 || exit_kind < 0 ||
      exit_kind > 2 || Cin % 4)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.mult = static_cast<const float*>(mult);
  a.off = static_cast<const float*>(off);
  a.idn = idn;
  a.out = out;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Ho = Ho;
  a.Wo = Wo;
  a.Cout = Cout;
  a.K = K;
  a.stride = stride;
  a.dil = dilation;
  a.pad = dilation * (K - 1) / 2;
  a.relu = relu;
  a.in_s = in_s;
  a.out_s = out_s;
  const int tiles_h = (Ho + TILE - 1) / TILE;
  a.tiles_w = (Wo + TILE - 1) / TILE;
  const dim3 grid(tiles_h * a.tiles_w, (Cout + CO_TILE - 1) / CO_TILE, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (idn_kind == IDN_NONE)
    launch_exit<IDN_NONE>(exit_kind, grid, s, a);
  else if (idn_kind == IDN_S8)
    launch_exit<IDN_S8>(exit_kind, grid, s, a);
  else
    launch_exit<IDN_F32>(exit_kind, grid, s, a);
  return (int)cudaGetLastError();
}
