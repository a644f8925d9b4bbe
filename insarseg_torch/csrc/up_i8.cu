// K6 up_concat_i8: one decoder level of the int8 U-Net, from the bf16
// decoder tensor to the int8 concat buffer, in one launch:
//   z[p, c]   = bf16( sum_k y[pix, k] * w[t * Cout + c, k] )   (f32 sum)
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
// Arithmetic. The sum runs on the tensor cores (wgmma bf16 x bf16 -> f32),
// in their order: the f32 z may differ from the plain version's ascending-k
// f32 sum (kernels/up_i8.py::up_bf16_plain) by a few f32 ulps, and where
// that crosses a bf16 rounding boundary, or then a half-integer of
// z / cat_s, a code differs by one. So the kernel is held to the plain
// version by a counted bar on its codes (every code within 1, a stated
// share differing; kernels/up_i8.py::assert_up_codes_close), not bit for
// bit. The JAX reference sums this ConvT on the TPU's MXU in an order of
// its own, so no order of sums is the reference's. After the sum, the JAX
// roundings in order, as the plain version: bf16, the bias added as a bf16
// add does (f32 add, bf16 round), z clamped to [-lim, lim], lim =
// RN(127 * cat_s) (a z outside gives +-127 either way, and the quotient
// stays finite), the quotient RN(z / cat_s) by requant_i8.cuh's div_rn,
// round half to even, clamp. Built without --use_fast_math.
//
// Bound on an H100 SXM (700 W): per U-Net-CA int8 forward at 512^2 b8 the
// four levels do 4 x 34.4 = 137 GFLOP (M N K: 8192 x 2048 x 1024, 32768 x
// 1024 x 512, 131072 x 512 x 256, 524288 x 256 x 128) and move about 1.06
// GB (y, w and the skip read once, the concat buffer written once):
// 0.14 ms by operations at the 989 TFLOP/s bf16 tensor-core rate, 0.32 ms
// by bytes at 3.35 TB/s. Only up1 is bound by operations; up3 and the
// H-s2d up4 (K 256 and 128) are streams, bound by bytes, where the
// epilogue's per-code arithmetic (about a dozen instructions a code, 134 M
// codes at up4) is the other cost to hide. Design:
//   - a 128 x 128 tile of (pixels, columns) takes two warpgroups, each
//     wgmma m64n128k16 (bf16, f32 sums in registers) on its 64 rows; both
//     operands are K-major as they stand: y's NHWC rows, and the packed
//     weight (N, K) (kernels/up_i8.py::pack_up_weight);
//   - K advances 32 values (one 64-byte row, two k16 steps) a stage
//     through a 5-stage cp.async ring in dynamic shared memory, 3 stages
//     in flight, src-size 0 filling zeros for rows past M, columns past N
//     and K past Cin; the tiles use the 64-byte swizzle of gmma_sm90.cuh,
//     shared with K1 / K5a;
//   - one tile a block, two blocks an SM (98 KB of shared memory, at
//     most 128 registers a thread), so one block's loads run while the
//     other's epilogue does (a persistent tile loop whose ring ran across
//     tiles timed the same over a U-Net-CA forward in tools/up_ab.py:
//     8% faster at the H-s2d up4, 9-12% slower at up1 / up2);
//   - the epilogue rounds the f32 fragments two columns at a time (one
//     bf16x2 conversion; the requant's round half to even by adding
//     1.5 * 2^23, no float-to-int conversion) and stages the codes in a
//     tile of their own (rows padded to 144 bytes: the fragment stores are
//     free of bank conflicts), then every 16 columns of a row leave as one
//     16-byte store at the concat's channel Cs + c of its output pixel.
//     Columns map to (tap, channel) per 16-column piece, so a tile may
//     span taps (Cout 64: U-Net-SA's standard up4); where Cout >= 128 a
//     tile lies in one tap and a row leaves as one 128-byte segment;
//   - each tile also copies its slice of the skip's Cs channels of every
//     output pixel (16-byte vectors, a contiguous slice of the skip), the
//     loads in flight while the codes are made: no torch.cat runs.
// Tiles are numbered N fastest, so the blocks at work at one time share
// their pixel slabs in L2.
//
// Layouts: y (M = B*H*W, K) bf16 NHWC; w (N, K) bf16, row t * Cout + c;
// bias (Cout) bf16 or null; skip (B, Ho, Wo, Cs) int8; out (B, Ho, Wo,
// Cs + Cout) int8, Ho = RT*H, Wo = 2W. K % 8 == 0, Cout % 16 == 0,
// Cs % 16 == 0, every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmma_sm90.cuh"
#include "requant_i8.cuh"

namespace {

using namespace gmma;

constexpr int BM = 128;       // pixels a tile
constexpr int BN = 128;       // columns a tile
constexpr int BK = 32;        // K values a stage: one 64-byte row of bf16
constexpr int STAGES = 5;     // cp.async ring depth
constexpr int PREFETCH = STAGES - 2;  // stages copied ahead of the MMA
constexpr int THREADS = 256;  // two warpgroups
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;  // 16 KB
constexpr int RING = STAGES * STAGE_BYTES;          // 80 KB
constexpr int CROW = BN + 16;  // a staged row of codes, bytes
constexpr int SMEM = RING + BM * CROW;  // 98 KB: two blocks an SM
constexpr int SKIP_UNROLL = 4; // skip vectors a thread has in flight
static_assert(BK * 2 == ROW_BYTES, "a stage is one 64-byte tile row");

struct Up {
  const __nv_bfloat16* y;
  const __nv_bfloat16* w;
  const __nv_bfloat16* bias;
  const int8_t* skip;
  int8_t* out;
  int M, K, N, Cout, W, Cs;
  int n_tiles, tiles, KT;
  float s;
  long long skip_vecs, skip_chunk;
};

// the two bf16 halves of a word (element 0 in the low half) as floats
__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// D (64 x 128, f32) += A (64 x 16, bf16, K-major smem) * B (128 x 16,
// bf16, K-major smem) for one warpgroup
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// the concat's vector of skip vector i: pixel i / cpv, piece i % cpv
// (a 32-bit division where the indices fit, the common case)
__device__ __forceinline__ long long skip_dst(long long i, int cpv, int ctv,
                                              bool narrow) {
  const long long px =
      narrow ? (long long)((unsigned)i / (unsigned)cpv) : i / cpv;
  return px * ctv + (i - px * cpv);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q = RN(z / s) (div_rn) of a z clamped to +-lim, clipped to +-127 and
// rounded half to even by adding 1.5 * 2^23, whose ulp is 1 (exact for
// |q| < 2^22): the low byte of the sum's bits is the int8 code. Clipping
// before rounding gives the codes of clip(rint(q), +-127), and the add
// costs less than a float-to-int conversion.
__device__ __forceinline__ uint32_t code_bits(float z, float s, float r,
                                              float lim) {
  z = fminf(fmaxf(z, -lim), lim);
  const float q = fminf(fmaxf(div_rn(z, s, r), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// The codes of two f32 sums of adjacent columns, in the low 16 bits:
// bf16 (both in one conversion), + bias (a bf16 add: f32 add, bf16
// round), requant.
__device__ __forceinline__ uint32_t code_pair(float a0, float a1,
                                              bool has_bias, float b0,
                                              float b1, float s, float r,
                                              float lim) {
  uint32_t u = bf16x2_bits(a0, a1);
  if (has_bias)
    u = bf16x2_bits(__fadd_rn(bf_lo(u), b0), __fadd_rn(bf_hi(u), b1));
  return __byte_perm(code_bits(bf_lo(u), s, r, lim),
                     code_bits(bf_hi(u), s, r, lim), 0x0040);
}

// One tile a block (tiles numbered N fastest, so the blocks at work at one
// time share their pixel slabs in L2); two blocks an SM overlap one's
// epilogue with the other's loads.
template <int RT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) up_concat_i8_kernel(
    const Up a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t smem_u32 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint8_t* codes = smem + RING;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63
  const int tile = blockIdx.x;
  const int m0 = (tile / a.n_tiles) * BM, n0 = (tile % a.n_tiles) * BN;

  // Thread t copies the 16-byte piece t % 4 of each 64-byte row, for rows
  // t / 4 and t / 4 + 64 of A and of B.
  const int ch = tid & 3, row0 = tid >> 2;
  const __nv_bfloat16* a_ptr[2];
  const __nv_bfloat16* b_ptr[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + row0 + 64 * j, n = n0 + row0 + 64 * j;
    a_ok[j] = m < a.M;
    b_ok[j] = n < a.N;
    a_ptr[j] = a.y + (size_t)(a_ok[j] ? m : 0) * a.K + ch * 8;
    b_ptr[j] = a.w + (size_t)(b_ok[j] ? n : 0) * a.K + ch * 8;
  }
  // stage kt (past the last, nothing) into ring slot kt % STAGES, and one
  // commit group
  auto load = [&](int kt) {
    if (kt < a.KT) {
      const uint32_t sa = smem_u32 + (kt % STAGES) * STAGE_BYTES;
      const uint32_t sb = sa + BM * ROW_BYTES;
      const int k = kt * BK;
      const bool kok = k + ch * 8 < a.K;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool va = kok && a_ok[j], vb = kok && b_ok[j];
        cp_async16(sa + swz(row0 + 64 * j, ch),
                   va ? (const void*)(a_ptr[j] + k) : (const void*)a.y,
                   va ? 16 : 0, false);
        cp_async16(sb + swz(row0 + 64 * j, ch),
                   vb ? (const void*)(b_ptr[j] + k) : (const void*)a.w,
                   vb ? 16 : 0, false);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < PREFETCH; ++i) load(i);

  const float s = a.s, r = __frcp_rn(s), lim = __fmul_rn(127.0f, s);
  const int Ctot = a.Cs + a.Cout, Wo = 2 * a.W;
  const int g = lane >> 2, t4 = lane & 3;
  const int rr = wg * 64 + (warp & 3) * 16 + g;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

#pragma unroll 1
  for (int kt = 0; kt < a.KT; ++kt) {
    cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();  // this thread's copies -> the wgmma's proxy
    __syncthreads();      // stage landed; MMA two stages back is done
    const uint32_t sa = smem_u32 + (kt % STAGES) * STAGE_BYTES;
    const uint32_t sb = sa + BM * ROW_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_bf16(acc, gmma_desc(sa + wg * 64 * ROW_BYTES + kk * 32),
                 gmma_desc(sb + kk * 32));
    wgmma_commit();
    load(kt + PREFETCH);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();

  // this tile's slice of the skip copy: vectors [tile * chunk, + chunk)
  // of the skip's channels [0, Cs), to channel 0 of their pixels; the
  // loads are in flight while the codes are made
  const long long v0 = (long long)tile * a.skip_chunk;
  const long long v1 = min(v0 + a.skip_chunk, a.skip_vecs);
  const int cpv = a.Cs / 16, ctv = Ctot / 16;
  const bool narrow = a.skip_vecs < (1LL << 31);
  const uint4* src = reinterpret_cast<const uint4*>(a.skip);
  uint4* dst = reinterpret_cast<uint4*>(a.out);
  uint4 sk[SKIP_UNROLL];
#pragma unroll
  for (int u = 0; u < SKIP_UNROLL; ++u) {
    const long long i = v0 + tid + u * THREADS;
    if (i < v1) sk[u] = __ldg(src + i);
  }

  // fragments -> codes: d[4j + {0,1}] is row rr, columns 8j + 2 t4 +
  // {0,1}; d[4j + {2,3}] row rr + 8. Both columns lie in one tap, whose
  // channel c follows from the tile's first one without a division.
  const int c_first = n0 % a.Cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    const bool hb = a.bias != nullptr && n0 + col < a.N;
    float b0 = 0.0f, b1 = 0.0f;
    if (hb) {
      int c = c_first + col;
      while (c >= a.Cout) c -= a.Cout;
      const uint32_t u =
          __ldg(reinterpret_cast<const uint32_t*>(a.bias + c));
      b0 = bf_lo(u);
      b1 = bf_hi(u);
    }
    *reinterpret_cast<uint16_t*>(codes + rr * CROW + col) =
        (uint16_t)code_pair(acc[4 * j], acc[4 * j + 1], hb, b0, b1, s, r,
                            lim);
    *reinterpret_cast<uint16_t*>(codes + (rr + 8) * CROW + col) =
        (uint16_t)code_pair(acc[4 * j + 2], acc[4 * j + 3], hb, b0, b1, s,
                            r, lim);
  }
#pragma unroll
  for (int u = 0; u < SKIP_UNROLL; ++u) {
    const long long i = v0 + tid + u * THREADS;
    if (i < v1) dst[skip_dst(i, cpv, ctv, narrow)] = sk[u];
  }
  // a chunk longer than SKIP_UNROLL vectors a thread copies the rest here
#pragma unroll 1
  for (long long i = v0 + tid + SKIP_UNROLL * THREADS; i < v1;
       i += THREADS)
    dst[skip_dst(i, cpv, ctv, narrow)] = __ldg(src + i);
  __syncthreads();

  // 16 columns of a row -> one 16-byte store at channel Cs + c of the
  // row's output pixel for their tap (Cout % 16 == 0: one tap). Thread
  // t takes column piece t % 8 of rows t / 8 + 32 i: one tap for all
  // four, and one division for the first row's pixel.
  {
    const int q = tid & 7, row0s = tid >> 3;
    const int n = n0 + q * 16;
    const int t = n / a.Cout, c = n - t * a.Cout;
    const int ta = RT == 2 ? (t >> 1) : 0, e = t & 1;
    const int m = m0 + row0s;
    int pr = m / a.W, pj = m - pr * a.W;  // pr = b * H + i_in
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      if (i > 0) {
        pj += 32;
        while (pj >= a.W) {
          pj -= a.W;
          ++pr;
        }
      }
      if (n < a.N && m + 32 * i < a.M) {
        const long long p = ((long long)RT * pr + ta) * Wo + 2 * pj + e;
        *reinterpret_cast<uint4*>(a.out + p * Ctot + a.Cs + c) =
            *reinterpret_cast<const uint4*>(codes +
                                            (row0s + 32 * i) * CROW +
                                            q * 16);
      }
    }
  }
}

template <int RT>
cudaError_t launch_rt(const Up& a, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      up_concat_i8_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return e;
  up_concat_i8_kernel<RT><<<a.tiles, THREADS, SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y (M, K) bf16 with M = B*H*W pixels of width W; w (N, K) bf16 with
// N = 2 * rt * Cout; bias (Cout) bf16 or null; skip (M * 2 * rt, Cs) int8;
// out (M * 2 * rt, Cs + Cout) int8. rt = 2: ConvT k2 s2; rt = 1: the H-s2d
// up4.
extern "C" int insarseg_up_concat_i8(const void* y, const void* w,
                                     const void* bias, const void* skip,
                                     void* out, int M, int K, int N, int Cout,
                                     int W, int Cs, int rt, float cat_s,
                                     void* stream) {
  if ((rt != 1 && rt != 2) || K <= 0 || K % 8 || Cout <= 0 || Cout % 16 ||
      Cs < 0 || Cs % 16 || W <= 0 || M < 0 || M % W ||
      N != 2 * rt * Cout || (long long)M * 2 * rt >= (1LL << 31) ||
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Up a;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.skip = static_cast<const int8_t*>(skip);
  a.out = static_cast<int8_t*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.Cout = Cout;
  a.W = W;
  a.Cs = Cs;
  a.s = cat_s;
  a.n_tiles = (N + BN - 1) / BN;
  a.tiles = ((M + BM - 1) / BM) * a.n_tiles;
  a.KT = (K + BK - 1) / BK;
  a.skip_vecs = (long long)M * 2 * rt * (Cs / 16);
  // a tile's share of the skip copy, whole warps' worth of vectors
  a.skip_chunk = (a.skip_vecs + a.tiles - 1) / a.tiles;
  a.skip_chunk = (a.skip_chunk + 31) / 32 * 32;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(rt == 2 ? launch_rt<2>(a, st) : launch_rt<1>(a, st));
}
