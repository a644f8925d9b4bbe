// K8a bn_stats, K8b bn_apply_relu, K9a bn_relu_grad_stats and K9b
// bn_relu_grad_apply: the DoubleConv train epilogue, forward and backward.
//
// Replaces the XLA:TPU fusions of one Conv2d(stop_bias_grad=train) ->
// BatchNorm2d(train) -> relu of the JAX package's train step: the conv's
// bias add (insarseg/ops/layers.py:121-127, fused into the conv), the
// BatchNorm moments (one reduce fusion) and apply (one loop fusion with the
// relu; insarseg/ops/layers.py:224-246, insarseg/ops/blocks.py:127-134),
// and their autodiff. With cdt the compute dtype (bf16 or f32) and every
// per-channel quantity in f32:
//   t    = cdt(y + cdt(bias))                          y: the conv, no bias
//   K8a  stats = [sum t, sum t^2 (C each), n] in f64   read y once
//        (the caller may all-reduce stats over the ranks here)
//   mean = f32(sum t * (1/n)), var = max(f32(sum t^2 * (1/n)) - mean^2, 0)
//   rstd = rsqrt(var + eps), a = rstd * gamma
//   K8b  out = relu(cdt((t - mean) * a + beta)); running statistics
//        <- (1 - m) r + m (mean, var * n / max(n - 1, 1))
//                                                      read y, write out
//   g    = dout where the pre-ReLU cdt value > 0, else 0 (the mask of
//          JAX's relu on the bf16 value); xhat = (t - mean) * rstd
//   K9a  gstats = [sum g, sum g * xhat] in f64 (dbeta, dgamma)
//                                                      read y and dout
//        (the caller may all-reduce gstats over the ranks here)
//   K9b  dt = cdt(a * ((g - f32(sum g / n)) - xhat * f32(sum g xhat / n)))
//        (each "/ n" a product with 1/n, rounded in f64)
//                                                      read y, dout; write dt
// The bias gets no gradient (stop_gradient). Each product and sum of the
// element formulas is one rounding (__fmul_rn / __fadd_rn / __fsub_rn, no
// contraction into an FMA), in the order of the plain versions
// (kernels/bn_act.py). The sums are taken in f64 (each term, a product of
// two floats, is exact there) and the per-channel means rounded to f32
// once: the order of a sum, a kernel's or its plain version's, one card's
// or a mesh's (whose ranks add their buffers), then leaves the f32 means
// equal but where a sum lies within ~1e-16 of an f32 rounding boundary.
// That is the JAX moment rule with sums more exact than an f32 reduce.
//
// Bound on an H100 SXM: pure bandwidth, a few operations an element. The
// 18 BatchNorms of a U-Net-CA (base 64) train step at 512^2 b8 hold
// 1.0234e9 elements; in bf16 at 3.35 TB/s that is ~0.61 ms for K8a (one
// read), 1.22 ms for K8b and K9a, 1.83 ms for K9b: ~4.9 ms a step.
//
// Design (a simple memory-bound pass, two layouts, fixed order):
//   - Layouts: NCHW (cuDNN's f32 output) and channels-last (NHWC memory),
//     read where they lie. NCHW: a block owns one channel (grid.y) and a
//     strided share (grid.x = S slices) of its work items, an item being
//     up to THREADS * V * 4 consecutive elements of one (n, c) plane; the
//     per-channel terms are block-uniform registers. NHWC: a thread owns V
//     consecutive channels of a row (threads a row = C / V, up to THREADS;
//     more channels make channel groups on grid.y), a block a contiguous
//     range of rows (grid.x = S slices).
//   - Loads and stores are 16 bytes (V = 8 bf16 or 4 f32) where the plane
//     (NCHW) or the row (NHWC) is a whole number of vectors and the
//     pointers are 16-byte aligned, else one element (ragged H*W, C = 1,
//     the 1x1 map).
//   - Sums in two stages and no atomics: each block reduces its share in a
//     fixed order (registers, a warp's xor tree, then the warps or rows in
//     order through shared memory) into a workspace of per-slice partial
//     sums; a second launch sums the S partials of each channel in a fixed
//     order (8 strided runs over the slices, then the 8 runs in order).
//     The plan (S, V) follows the shape alone (kernels/bn_act.py::plan),
//     so the same tensor gives the same sums bit for bit, as remat's
//     recompute and cudnn.deterministic runs need.
//   - n is made on the host from the shape and written into stats[2C] by
//     the second launch (f64, exact), so an all-reduce of the buffer sums
//     the counts with the moments. No launch synchronises. The f64 adds
//     (2-3 an element, at the card's f64 rate) stay under the memory time.
//   - K8b's slice 0 of each channel updates its running statistics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEM_VECS = 4;  // vectors a thread loads in one NCHW item

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute dtype T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// V elements of T from p (16-byte aligned when V > 1)
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f<T>(p[0]);
  } else {
    static_assert(sizeof(T) * V == 16, "one 16-byte vector");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f<T>(e[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The pointers and numbers every kernel of the site reads.
struct Site {
  const void* y;          // the conv output without its bias (cdt)
  const void* dy;         // the gradient of the ReLU's output (cdt)
  const float* bias;      // the conv bias (C), f32
  const double* stats;    // [sum t, sum t^2, n] (2C + 1)
  const double* gstats;   // [sum g, sum g * xhat] (2C)
  const float* gamma;     // (C)
  const float* beta;      // (C)
  void* out;              // K8b's output or K9b's gradient (cdt)
  float* rm;              // running mean (C), K8b only
  float* rv;              // running variance (C), K8b only
  double* ws;             // the partial sums (S, 2C)
  double* sums;           // the result of a reduction (2C, +1 with n)
  long long N, HW;        // batch, pixels a plane
  int C, S;               // channels, slices
  float eps, keep, mom;   // eps, 1 - momentum, momentum
};

// The per-channel terms of channel c.
struct Chan {
  float bias;  // the conv bias rounded to cdt
  float mean, rstd, a, beta, mg, mgt;
};

// 1 / n, correctly rounded in f64 (one division a thread: the means are
// sums times it, f64 divisions a channel cost a short block a tenth of
// its time)
__device__ __forceinline__ double inv_count(const Site& s) {
  return s.stats != nullptr ? __drcp_rn(s.stats[2 * s.C]) : 0.0;
}

// the mean of channel c and its biased variance max(E[t^2] - mean^2, 0)
__device__ __forceinline__ float mean_of(const Site& s, int c, double rn) {
  return __double2float_rn(__dmul_rn(s.stats[c], rn));
}

__device__ __forceinline__ float var_of(const Site& s, int c, float mean,
                                        double rn) {
  const float e2 = __double2float_rn(__dmul_rn(s.stats[s.C + c], rn));
  return fmaxf(__fsub_rn(e2, __fmul_rn(mean, mean)), 0.0f);
}

template <typename T>
__device__ __forceinline__ Chan chan_of(const Site& s, int c, double rn) {
  Chan h;
  h.bias = round_to<T>(s.bias[c]);
  h.mean = h.rstd = h.a = h.beta = h.mg = h.mgt = 0.0f;
  if (s.stats != nullptr) {
    h.mean = mean_of(s, c, rn);
    h.rstd = rsqrtf(__fadd_rn(var_of(s, c, h.mean, rn), s.eps));
    h.a = __fmul_rn(h.rstd, s.gamma[c]);
    h.beta = s.beta[c];
    if (s.gstats != nullptr) {
      h.mg = __double2float_rn(__dmul_rn(s.gstats[c], rn));
      h.mgt = __double2float_rn(__dmul_rn(s.gstats[s.C + c], rn));
    }
  }
  return h;
}

// t and the pre-ReLU value of one element
template <typename T>
__device__ __forceinline__ float t_of(float y, const Chan& h) {
  return round_to<T>(__fadd_rn(y, h.bias));
}

template <typename T>
__device__ __forceinline__ float pre_of(float d, const Chan& h) {
  return round_to<T>(__fadd_rn(__fmul_rn(d, h.a), h.beta));
}

// K8a: (t, t^2)
template <typename T>
struct StatsOp {
  static constexpr bool kDy = false;
  __device__ static __forceinline__ void pair(float y, float, const Chan& h,
                                              double& u, double& w) {
    const double t = t_of<T>(y, h);
    u = t;
    w = __dmul_rn(t, t);
  }
};

// K9a: (g, g * xhat)
template <typename T>
struct GradStatsOp {
  static constexpr bool kDy = true;
  __device__ static __forceinline__ void pair(float y, float dy,
                                              const Chan& h, double& u,
                                              double& w) {
    const float d = __fsub_rn(t_of<T>(y, h), h.mean);
    const double g = pre_of<T>(d, h) > 0.0f ? dy : 0.0f;
    u = g;
    w = __dmul_rn(g, (double)__fmul_rn(d, h.rstd));
  }
};

// K8b: relu(cdt((t - mean) * a + beta))
template <typename T>
struct ApplyOp {
  static constexpr bool kDy = false;
  __device__ static __forceinline__ float out(float y, float,
                                              const Chan& h) {
    const float p = pre_of<T>(__fsub_rn(t_of<T>(y, h), h.mean), h);
    return p > 0.0f ? p : 0.0f;
  }
};

// K9b: a * ((g - mean g) - xhat * mean(g xhat)), rounded to cdt by the store
template <typename T>
struct GradApplyOp {
  static constexpr bool kDy = true;
  __device__ static __forceinline__ float out(float y, float dy,
                                              const Chan& h) {
    const float d = __fsub_rn(t_of<T>(y, h), h.mean);
    const float g = pre_of<T>(d, h) > 0.0f ? dy : 0.0f;
    const float xh = __fmul_rn(d, h.rstd);
    return __fmul_rn(h.a, __fsub_rn(__fsub_rn(g, h.mg), __fmul_rn(xh, h.mgt)));
  }
};

// K8b's running-statistics update of channel c (one thread a channel)
__device__ __forceinline__ void update_running(const Site& s, int c) {
  const double n = s.stats[2 * s.C], rn = __drcp_rn(n);
  const float mean = mean_of(s, c, rn);
  const float var = var_of(s, c, mean, rn);
  const float unbias = __double2float_rn(__ddiv_rn(n, fmax(n - 1.0, 1.0)));
  s.rm[c] = __fadd_rn(__fmul_rn(s.keep, s.rm[c]), __fmul_rn(s.mom, mean));
  s.rv[c] = __fadd_rn(__fmul_rn(s.keep, s.rv[c]),
                      __fmul_rn(s.mom, __fmul_rn(var, unbias)));
}

// thread 0 gets the block's totals of u and w, summed in a fixed order
__device__ __forceinline__ void block_sum2(double& u, double& w) {
  __shared__ double su[WARPS], sw[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, o);
    w += __shfl_xor_sync(0xffffffffu, w, o);
  }
  if (threadIdx.x % 32 == 0) {
    su[threadIdx.x / 32] = u;
    sw[threadIdx.x / 32] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    u = su[0];
    w = sw[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) {
      u += su[k];
      w += sw[k];
    }
  }
}

// ---------------------------------------------------------------------------
// NCHW: block (slice, channel)
// ---------------------------------------------------------------------------

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) reduce_nchw(Site s) {
  const int c = blockIdx.y;
  const Chan h = chan_of<T>(s, c, inv_count(s));
  constexpr long long CH = (long long)THREADS * V * ITEM_VECS;
  const long long per_plane = (s.HW + CH - 1) / CH;
  const long long items = s.N * per_plane;
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  double u = 0.0, w = 0.0;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const long long n = i / per_plane;
    const long long p0 = (i - n * per_plane) * CH;
    const long long base = (n * s.C + c) * s.HW;
    const long long end = min(s.HW, p0 + CH);
    for (long long p = p0 + (long long)threadIdx.x * V; p < end;
         p += (long long)THREADS * V) {
      float yv[V], dv[V] = {};
      load<T, V>(y + base + p, yv);
      if constexpr (Op::kDy) load<T, V>(dy + base + p, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        double a, b;
        Op::pair(yv[k], dv[k], h, a, b);
        u = __dadd_rn(u, a);
        w = __dadd_rn(w, b);
      }
    }
  }
  block_sum2(u, w);
  if (threadIdx.x == 0) {
    double* ws = s.ws + (long long)blockIdx.x * 2 * s.C;
    ws[c] = u;
    ws[s.C + c] = w;
  }
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) apply_nchw(Site s) {
  const int c = blockIdx.y;
  const Chan h = chan_of<T>(s, c, inv_count(s));
  if (s.rm != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    update_running(s, c);
  constexpr long long CH = (long long)THREADS * V * ITEM_VECS;
  const long long per_plane = (s.HW + CH - 1) / CH;
  const long long items = s.N * per_plane;
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  T* out = static_cast<T*>(s.out);
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const long long n = i / per_plane;
    const long long p0 = (i - n * per_plane) * CH;
    const long long base = (n * s.C + c) * s.HW;
    const long long end = min(s.HW, p0 + CH);
    for (long long p = p0 + (long long)threadIdx.x * V; p < end;
         p += (long long)THREADS * V) {
      float yv[V], dv[V] = {}, ov[V];
      load<T, V>(y + base + p, yv);
      if constexpr (Op::kDy) load<T, V>(dy + base + p, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) ov[k] = Op::out(yv[k], dv[k], h);
      store<T, V>(out + base + p, ov);
    }
  }
}

// ---------------------------------------------------------------------------
// NHWC (channels-last): block (slice of rows, channel group)
// ---------------------------------------------------------------------------

// threads a row and rows a pass for C channels, V a thread
__device__ __forceinline__ void nhwc_shape(int C, int V, int& tr, int& r) {
  const int cv = C / V;
  tr = cv < THREADS ? cv : THREADS;
  r = THREADS / tr;
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) reduce_nhwc(Site s) {
  __shared__ double su[THREADS * V], sw[THREADS * V];
  int tr, R;
  nhwc_shape(s.C, V, tr, R);
  const int lane = threadIdx.x % tr, r0 = threadIdx.x / tr;
  const int cv = blockIdx.y * tr + lane;  // this thread's channel vector
  const bool active = r0 < R && cv * V < s.C;
  const long long rows = s.N * s.HW;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long rbeg = (long long)blockIdx.x * per;
  const long long rend = min(rows, rbeg + per);
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  double u[V] = {}, w[V] = {};
  if (active) {
    Chan h[V];
    const double rn = inv_count(s);
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = chan_of<T>(s, cv * V + k, rn);
    for (long long r = rbeg + r0; r < rend; r += R) {
      const long long e = r * s.C + (long long)cv * V;
      float yv[V], dv[V] = {};
      load<T, V>(y + e, yv);
      if constexpr (Op::kDy) load<T, V>(dy + e, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        double a, b;
        Op::pair(yv[k], dv[k], h[k], a, b);
        u[k] = __dadd_rn(u[k], a);
        w[k] = __dadd_rn(w[k], b);
      }
    }
    const int j = r0 * tr * V + lane * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      su[j + k] = u[k];
      sw[j + k] = w[k];
    }
  }
  __syncthreads();
  // the R rows of the block's channels, summed in row order
  for (int j = threadIdx.x; j < tr * V; j += THREADS) {
    const int c = blockIdx.y * tr * V + j;
    if (c >= s.C) continue;
    double a = 0.0, b = 0.0;
    for (int r = 0; r < R; ++r) {
      a = __dadd_rn(a, su[r * tr * V + j]);
      b = __dadd_rn(b, sw[r * tr * V + j]);
    }
    double* ws = s.ws + (long long)blockIdx.x * 2 * s.C;
    ws[c] = a;
    ws[s.C + c] = b;
  }
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) apply_nhwc(Site s) {
  int tr, R;
  nhwc_shape(s.C, V, tr, R);
  const int lane = threadIdx.x % tr, r0 = threadIdx.x / tr;
  const int cv = blockIdx.y * tr + lane;
  if (r0 >= R || cv * V >= s.C) return;
  Chan h[V];
  const double rn = inv_count(s);
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = chan_of<T>(s, cv * V + k, rn);
  if (s.rm != nullptr && blockIdx.x == 0 && r0 == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) update_running(s, cv * V + k);
  }
  const long long rows = s.N * s.HW;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long rbeg = (long long)blockIdx.x * per;
  const long long rend = min(rows, rbeg + per);
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  T* out = static_cast<T*>(s.out);
  for (long long r = rbeg + r0; r < rend; r += R) {
    const long long e = r * s.C + (long long)cv * V;
    float yv[V], dv[V] = {}, ov[V];
    load<T, V>(y + e, yv);
    if constexpr (Op::kDy) load<T, V>(dy + e, dv);
#pragma unroll
    for (int k = 0; k < V; ++k) ov[k] = Op::out(yv[k], dv[k], h[k]);
    store<T, V>(out + e, ov);
  }
}

// the second stage: the S partial sums of each of the 2C sums, in a fixed
// order: a block takes 32 of the 2C sums, its 8 warps the slices k = g,
// g + 8, ... in order (lane j one sum, neighbouring lanes on neighbouring
// addresses), then warp 0 adds the 8 warps' totals in order
constexpr int FINISH_LANES = 32;
constexpr int FINISH_GROUPS = THREADS / FINISH_LANES;

__global__ void __launch_bounds__(THREADS) finish_sums(Site s, int with_n) {
  __shared__ double part[FINISH_GROUPS][FINISH_LANES];
  const int lane = threadIdx.x % FINISH_LANES;
  const int g = threadIdx.x / FINISH_LANES;
  const int j = blockIdx.x * FINISH_LANES + lane;
  double a = 0.0;
  if (j < 2 * s.C)
    for (int k = g; k < s.S; k += FINISH_GROUPS)
      a = __dadd_rn(a, s.ws[(long long)k * 2 * s.C + j]);
  part[g][lane] = a;
  __syncthreads();
  if (g == 0 && j < 2 * s.C) {
    double t = part[0][lane];
#pragma unroll
    for (int k = 1; k < FINISH_GROUPS; ++k) t = __dadd_rn(t, part[k][lane]);
    s.sums[j] = t;
  }
  if (with_n && blockIdx.x == 0 && threadIdx.x == 0)
    s.sums[2 * s.C] = (double)(s.N * s.HW);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int VEC_BYTES = 16;

template <typename T, int V>
dim3 grid_of(const Site& s, int layout) {
  if (layout == 0) return dim3((unsigned)s.S, (unsigned)s.C);
  const int cv = s.C / V;
  return dim3((unsigned)s.S, (unsigned)((cv + THREADS - 1) / THREADS));
}

template <typename T, int V, template <typename> class Op>
cudaError_t reduce_as(const Site& s, int layout, int with_n,
                      cudaStream_t st) {
  const dim3 g = grid_of<T, V>(s, layout);
  if (layout == 0)
    reduce_nchw<T, V, Op<T>><<<g, THREADS, 0, st>>>(s);
  else
    reduce_nhwc<T, V, Op<T>><<<g, THREADS, 0, st>>>(s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_sums<<<(2 * s.C + FINISH_LANES - 1) / FINISH_LANES, THREADS, 0,
                st>>>(s, with_n);
  return cudaGetLastError();
}

template <typename T, int V, template <typename> class Op>
cudaError_t apply_as(const Site& s, int layout, cudaStream_t st) {
  const dim3 g = grid_of<T, V>(s, layout);
  if (layout == 0)
    apply_nchw<T, V, Op<T>><<<g, THREADS, 0, st>>>(s);
  else
    apply_nhwc<T, V, Op<T>><<<g, THREADS, 0, st>>>(s);
  return cudaGetLastError();
}

template <template <typename> class Op>
cudaError_t reduce_site(const Site& s, int bf16, int layout, int vec,
                        int with_n, cudaStream_t st) {
  if (bf16)
    return vec ? reduce_as<__nv_bfloat16, VEC_BYTES / 2, Op>(s, layout,
                                                             with_n, st)
               : reduce_as<__nv_bfloat16, 1, Op>(s, layout, with_n, st);
  return vec ? reduce_as<float, VEC_BYTES / 4, Op>(s, layout, with_n, st)
             : reduce_as<float, 1, Op>(s, layout, with_n, st);
}

template <template <typename> class Op>
cudaError_t apply_site(const Site& s, int bf16, int layout, int vec,
                       cudaStream_t st) {
  if (bf16)
    return vec ? apply_as<__nv_bfloat16, VEC_BYTES / 2, Op>(s, layout, st)
               : apply_as<__nv_bfloat16, 1, Op>(s, layout, st);
  return vec ? apply_as<float, VEC_BYTES / 4, Op>(s, layout, st)
             : apply_as<float, 1, Op>(s, layout, st);
}

Site site_of(long long N, long long HW, int C, int S, float eps) {
  Site s = {};
  s.N = N;
  s.HW = HW;
  s.C = C;
  s.S = S;
  s.eps = eps;
  return s;
}

bool bad_shape(long long N, long long HW, int C, int S) {
  return N < 0 || HW < 0 || C < 1 || C > 65535 || S < 1;
}

}  // namespace

// Every entry point: y (and dy) (N, C, H, W) f32 or bf16 (bf16 != 0),
// NCHW (layout 0) or channels-last (layout 1) memory, HW = H * W; vec != 0
// takes 16-byte vectors (the wrapper checks the sizes and alignment); S the
// slices of the plan; ws an f64 workspace of S * 2C; the sums f64; the
// per-channel parameters and statistics f32.

// K8a: stats (2C + 1) = [sum t, sum t^2, n]
extern "C" int insarseg_bn_stats(const void* y, const void* bias, void* ws,
                                 void* stats, long long N, long long HW,
                                 int C, int S, int bf16, int layout, int vec,
                                 void* stream) {
  if (bad_shape(N, HW, C, S)) return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, 0.0f);
  s.y = y;
  s.bias = static_cast<const float*>(bias);
  s.ws = static_cast<double*>(ws);
  s.sums = static_cast<double*>(stats);
  return (int)reduce_site<StatsOp>(s, bf16, layout, vec, 1,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// K8b: out = relu(cdt((t - mean) * a + beta)); rm, rv updated in place
extern "C" int insarseg_bn_apply_relu(const void* y, const void* bias,
                                      const void* stats, const void* gamma,
                                      const void* beta, void* rm, void* rv,
                                      void* out, long long N, long long HW,
                                      int C, int S, float eps, float keep,
                                      float mom, int bf16, int layout,
                                      int vec, void* stream) {
  if (bad_shape(N, HW, C, S)) return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  s.y = y;
  s.bias = static_cast<const float*>(bias);
  s.stats = static_cast<const double*>(stats);
  s.gamma = static_cast<const float*>(gamma);
  s.beta = static_cast<const float*>(beta);
  s.rm = static_cast<float*>(rm);
  s.rv = static_cast<float*>(rv);
  s.out = out;
  s.keep = keep;
  s.mom = mom;
  return (int)apply_site<ApplyOp>(s, bf16, layout, vec,
                                  reinterpret_cast<cudaStream_t>(stream));
}

// K9a: gstats (2C) = [sum g, sum g * xhat]
extern "C" int insarseg_bn_relu_grad_stats(
    const void* dy, const void* y, const void* bias, const void* stats,
    const void* gamma, const void* beta, void* ws, void* gstats,
    long long N, long long HW, int C, int S, float eps, int bf16, int layout,
    int vec, void* stream) {
  if (bad_shape(N, HW, C, S)) return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  s.y = y;
  s.dy = dy;
  s.bias = static_cast<const float*>(bias);
  s.stats = static_cast<const double*>(stats);
  s.gamma = static_cast<const float*>(gamma);
  s.beta = static_cast<const float*>(beta);
  s.ws = static_cast<double*>(ws);
  s.sums = static_cast<double*>(gstats);
  return (int)reduce_site<GradStatsOp>(s, bf16, layout, vec, 0,
                                       reinterpret_cast<cudaStream_t>(stream));
}

// K9b: dt = cdt(a * ((g - sum g / n) - xhat * (sum g xhat / n)))
extern "C" int insarseg_bn_relu_grad_apply(
    const void* dy, const void* y, const void* bias, const void* stats,
    const void* gstats, const void* gamma, const void* beta, void* dt,
    long long N, long long HW, int C, int S, float eps, int bf16, int layout,
    int vec, void* stream) {
  if (bad_shape(N, HW, C, S)) return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  s.y = y;
  s.dy = dy;
  s.bias = static_cast<const float*>(bias);
  s.stats = static_cast<const double*>(stats);
  s.gstats = static_cast<const double*>(gstats);
  s.gamma = static_cast<const float*>(gamma);
  s.beta = static_cast<const float*>(beta);
  s.out = dt;
  return (int)apply_site<GradApplyOp>(s, bf16, layout, vec,
                                      reinterpret_cast<cudaStream_t>(stream));
}
