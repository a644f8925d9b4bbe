// K6 up_concat_i8: one decoder level of the int8 U-Net, from the bf16
// decoder tensor to the int8 concat buffer, in one launch:
//   z[p, c]   = bf16( sum_k y[pix, k] * w[k, t * Cout + c] )   (f32 sum)
//   z[p, c]   = bf16( z + bias[c] )                            (a bf16 add)
//   out[p, :] = [ skip[p, 0:Cs], clip(rint(z[p, :] / cat_s), +-127) ]
// where input pixel pix = (b, i, j) and tap t give output pixel
// p = (b, RT * i + a, 2 j + e), t = a * 2 + e: the transposed conv k2 s2
// (RT = 2, four taps) or the H-s2d up4, a W-only transposed conv (RT = 1,
// two taps, out[.., 2j+e] = y[.., j] @ k[0, 1-e]). Each output pixel gets
// one tap, so the transposed conv is a per-pixel GEMM with M = pixels,
// N = taps * Cout, K = Cin.
//
// Replaces insarseg/models/unet_int8.py::unet_int8_apply lines 345-350
// (up1-3: _conv_transpose_k2s2, _requant, jnp.concatenate) and 355-358
// (up4, and in the H-s2d layout insarseg/models/unet_s2d.py::_up4_s2d):
// XLA:TPU fusions for which stock PyTorch has no CUDA op. In PyTorch they
// were eight passes: two layout copies, the cuDNN bf16 ConvT, the bf16
// bias add, an f32 cast, the division / round / clamp, the int8 cast and
// the concat copy.
//
// Exactness. The weights and the bias are bf16 (the JAX graph's
// .astype(x.dtype)), so every product y * w is exact in f32 and
// __fmaf_rn(y, w, acc) = RN(acc + y * w): the chain in ascending k is the
// plain version's acc = acc + y[:, k] * w[k] in f32, bit for bit. The sum
// starts at +0 and stays off -0, so the zeros that pad K, M and N to the
// tiles change no sum. Then the JAX roundings in order: bf16, the bias
// added as a bf16 add does (f32 add, bf16 round), the quotient
// RN(z / cat_s) by requant_i8.cuh's div_rn, round half to even, clamp.
// z is first clamped to [-lim, lim], lim = RN(127 * cat_s): a z outside
// gives the code +-127 either way, and the quotient stays finite.
// Tensor cores sum in an order no plain version repeats; this kernel
// keeps to CUDA cores. Built without --use_fast_math (denormals kept).
//
// Bound on an H100 SXM (700 W): per U-Net-CA int8 forward at 512^2 b8 the
// four levels do 4 x 34.4 = 137 GFLOP (M N K: 8192 x 2048 x 1024, 32768 x
// 1024 x 512, 131072 x 512 x 256, 524288 x 256 x 128) and move about 1.0
// GB (y once, the skip once, the concat buffer once): 0.30 ms by bytes,
// 0.14 ms by operations at the 989 TFLOP/s bf16 tensor-core rate. The f32
// FMA pipe (67 TFLOP/s) that exactness asks for needs 2.1 ms at best: the
// kernel is bound by its f32 FMAs. Design, a register-tiled SGEMM:
//   - a block takes 128 pixels x 128 columns, 256 threads of 8 x 8
//     accumulators (two 4 x 4 quadrants 64 apart, so the inner loop's
//     shared loads are float4 and conflict-free): 64 FMAs per 4 loads;
//   - k-tiles of 16: the 128 x 16 bf16 slice of y (two 16-byte loads a
//     row) and the 16 x 128 slice of w, widened to f32 on the way into
//     shared memory (y transposed), double-buffered, the next tile's
//     global loads in flight during the current tile's FMAs;
//   - the epilogue stores four codes a word at the concat's channel Cs + c,
//     and all blocks copy the skip's Cs channels of every output pixel
//     with 16-byte vectors, grid-stride: no torch.cat runs.
// Blocks walk N fastest, so the blocks of one pixel slab share y in L2.
//
// Layouts: y (M = B*H*W, K) bf16 NHWC; w (K, N) bf16, column t * Cout + c;
// bias (Cout) bf16 or null; skip (B, Ho, Wo, Cs) int8; out (B, Ho, Wo,
// Cs + Cout) int8, Ho = RT*H, Wo = 2W. K % 8 == 0, Cout % 16 == 0,
// Cs % 16 == 0, every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant_i8.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;

// the two bf16 halves of a word (element 0 in the low half) as floats
__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int RT>
__global__ void __launch_bounds__(THREADS, 2) up_concat_i8_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, const int8_t* __restrict__ skip,
    int8_t* __restrict__ out, int M, int K, int N, int Cout, int W, int Cs,
    float s, long long skip_vecs) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // loaders: y rows (a warp takes 32 rows of one 8-wide k half), w rows
  // (16 threads a k row, 8 columns each)
  const int a_row = tid & (BM - 1), a_k = (tid >> 7) * 8;
  const int b_k = tid >> 4, b_n = (tid & 15) * 8;
  const bool a_ok = m0 + a_row < M, b_ok = n0 + b_n < N;
  const __nv_bfloat16* a_src = y + (size_t)(a_ok ? m0 + a_row : 0) * K + a_k;
  const __nv_bfloat16* b_src = w + (size_t)b_k * N + (b_ok ? n0 + b_n : 0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra, rb;
  auto load = [&](int k0) {
    ra = (a_ok && k0 + a_k < K)
             ? __ldg(reinterpret_cast<const uint4*>(a_src + k0))
             : zero;
    rb = (b_ok && k0 + b_k < K)
             ? __ldg(reinterpret_cast<const uint4*>(b_src + (size_t)k0 * N))
             : zero;
  };
  auto store = [&](int buf) {
    const uint32_t av[4] = {ra.x, ra.y, ra.z, ra.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[buf][a_k + 2 * j][a_row] = bf_lo(av[j]);
      As[buf][a_k + 2 * j + 1][a_row] = bf_hi(av[j]);
    }
    float4* d = reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]);
    d[0] = make_float4(bf_lo(rb.x), bf_hi(rb.x), bf_lo(rb.y), bf_hi(rb.y));
    d[1] = make_float4(bf_lo(rb.z), bf_hi(rb.z), bf_lo(rb.w), bf_hi(rb.w));
  };

  // thread tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bf16, + bias (bf16 add), requant, four codes a word at the
  // concat's channel Cs + c of output pixel p
  const float r = __frcp_rn(s);
  const float lim = __fmul_rn(127.0f, s);
  const int Wo = 2 * W, Ctot = Cs + Cout;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int n = n0 + g * 64 + tx * 4;
    if (n >= N) continue;
    const int t = n / Cout, c = n - t * Cout;
    const int a = RT == 2 ? (t >> 1) : 0, e = t & 1;
    float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (bias != nullptr) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(bias + c));
      bv[0] = bf_lo(u.x);
      bv[1] = bf_hi(u.x);
      bv[2] = bf_lo(u.y);
      bv[3] = bf_hi(u.y);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m >= M) continue;
      const int row = m / W, j = m - row * W;  // row = b * H + i_in
      const long long p = ((long long)RT * row + a) * Wo + 2 * j + e;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float z = bf16_rn(acc[i][g * 4 + q]);
        if (bias != nullptr) z = bf16_rn(__fadd_rn(z, bv[q]));
        z = fminf(fmaxf(z, -lim), lim);
        word |= (uint32_t)(uint8_t)requant(z, s, r) << (8 * q);
      }
      *reinterpret_cast<uint32_t*>(out + p * Ctot + Cs + c) = word;
    }
  }

  // the skip's channels [0, Cs) of every output pixel, grid-stride
  if (Cs > 0) {
    const int cpv = Cs / 16, ctv = Ctot / 16;
    const long long stride = (long long)gridDim.x * gridDim.y * THREADS;
    for (long long v = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                           THREADS + tid;
         v < skip_vecs; v += stride) {
      const long long px = v / cpv;
      reinterpret_cast<uint4*>(out)[px * ctv + (v - px * cpv)] =
          __ldg(reinterpret_cast<const uint4*>(skip) + v);
    }
  }
}

}  // namespace

// y (M, K) bf16 with M = B*H*W pixels of width W; w (K, N) bf16 with
// N = 2 * rt * Cout; bias (Cout) bf16 or null; skip (M * 2 * rt, Cs) int8;
// out (M * 2 * rt, Cs + Cout) int8. rt = 2: ConvT k2 s2; rt = 1: the H-s2d
// up4.
extern "C" int insarseg_up_concat_i8(const void* y, const void* w,
                                     const void* bias, const void* skip,
                                     void* out, int M, int K, int N, int Cout,
                                     int W, int Cs, int rt, float cat_s,
                                     void* stream) {
  if ((rt != 1 && rt != 2) || K % 8 || Cout % 16 || Cs % 16 || W <= 0 ||
      M % W || N != 2 * rt * Cout || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  const long long skip_vecs = (long long)M * 2 * rt * (Cs / 16);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
  const int8_t* sk = static_cast<const int8_t*>(skip);
  int8_t* o = static_cast<int8_t*>(out);
  if (rt == 2)
    up_concat_i8_kernel<2><<<grid, THREADS, 0, st>>>(
        yb, wb, bb, sk, o, M, K, N, Cout, W, Cs, cat_s, skip_vecs);
  else
    up_concat_i8_kernel<1><<<grid, THREADS, 0, st>>>(
        yb, wb, bb, sk, o, M, K, N, Cout, W, Cs, cat_s, skip_vecs);
  return (int)cudaGetLastError();
}
