// K8a bn_stats, K8b bn_apply_relu, K9a bn_relu_grad_stats and K9b
// bn_relu_grad_apply: the train-mode BatchNorm epilogue, forward and
// backward, in three modes.
//
// Replaces the XLA:TPU fusions of one conv -> BatchNorm2d(train) -> its
// activation in the JAX package's train step: the conv's bias add
// (insarseg/ops/layers.py:121-127, fused into the conv; the ResNet
// families' convs have none), the BatchNorm moments (one reduce fusion) and
// apply (one loop fusion with what follows it; insarseg/ops/layers.py:
// 224-246), and their autodiff. The modes are what follows the BatchNorm:
//   relu      relu(BN)                 DoubleConv (insarseg/ops/blocks.py:
//             127-134); a ResNet's stem, bn1 and bn2 (insarseg/models/
//             resnet.py:72-84, :122-123); every head BN (deeplab.py:57-79,
//             :110-112; fcn.py:41-43; pspnet.py:47-49, :75-77)
//   none      BN                       downsample_bn; bn3 before an SE
//             block (resnet.py:88-98)
//   residual  relu(cdt(BN + r))        bn3, the residual add and its relu
//             (resnet.py:99), r the identity in the compute dtype
// With cdt the compute dtype (bf16, f32 or f64) and acc = promote(cdt, f32)
// for every per-channel quantity:
//   t    = cdt(y + cdt(bias))          y: the conv, no bias (t = y without)
//   K8a  stats = [sum t, sum t^2 (C each), n] in f64   read y once
//        (the caller may all-reduce stats over the ranks here)
//   mean = acc(sum t * (1/n)), var = max(acc(sum t^2 * (1/n)) - mean^2, 0)
//   rstd = rsqrt(var + eps), a = rstd * gamma, p = cdt((t - mean) * a + beta)
//   K8b  out = relu(p) | p | relu(cdt(p + r)); running statistics
//        <- (1 - m) rs + m (mean, var * k / max(k - 1, 1)), k = n / D (D the
//        copies of each row a replicated map's sums hold, else 1)
//                                               read y (and r), write out
//   g    = dout where the mode's ReLU passes, else 0: relu, p > 0 (the
//          mask of JAX's relu on the cdt value); none, everywhere;
//          residual, out > 0 (out the saved output: its sum > 0 exactly
//          there); xhat = (t - mean) * rstd
//   K9a  gstats = [sum g, sum g * xhat] in f64 (dbeta, dgamma)
//                                               read y, dout (and out)
//        (the caller may all-reduce gstats over the ranks here)
//   K9b  dt = cdt(a * ((g - acc(sum g / n)) - xhat * acc(sum g xhat / n)))
//        (each "/ n" a product with 1/n, rounded in f64); residual: also
//        dr = g, the identity's gradient   read y, dout (and out); write dt
//                                               (and dr)
// The bias gets no gradient (stop_gradient). Each product and sum of the
// element formulas is one rounding (__fmul_rn / __fadd_rn / __fsub_rn and
// their f64 forms, no contraction into an FMA), in the order of the plain
// versions (kernels/bn_act.py). The sums are taken in f64: with f32 or
// bf16 terms each term, a product of two floats, is exact there, and the
// per-channel means are rounded to f32 once: the order of a sum, a
// kernel's or its plain version's, one card's or a mesh's (whose ranks add
// their buffers), then leaves the f32 means equal but where a sum lies
// within ~1e-16 of an f32 rounding boundary. That is the JAX moment rule
// with sums more exact than an f32 reduce. In f64 (the yardstick steps)
// the terms round and the orders differ in the last bits.
//
// Bound on an H100 SXM: pure bandwidth, a few operations an element. The
// 18 BatchNorms of a U-Net-CA (base 64) train step at 512^2 b8 hold
// 1.0234e9 elements; in bf16 at 3.35 TB/s that is ~0.61 ms for K8a (one
// read), 1.22 ms for K8b and K9a, 1.83 ms for K9b: ~4.9 ms a step. The
// residual mode reads one operand more in K8b, K9a and K9b and writes dr.
//
// Design (memory-bound passes, two layouts, fixed order):
//   - Layouts: NCHW (cuDNN's f32 output) and channels-last (NHWC memory),
//     read where they lie. NCHW: a block owns one channel (grid.y) and a
//     share (grid.x = S slices) of its work items, an item being up to
//     THREADS * V * U consecutive elements of one (n, c) plane; the
//     per-channel terms are block-uniform registers. NHWC: a thread owns V
//     consecutive channels of a row, a block a group of channels (grid.y)
//     and a contiguous range of rows (grid.x = S slices).
//   - K8b and K9b load and store 16 bytes (V = 8 bf16, 4 f32 or 2 f64)
//     where the plane (NCHW) or the row (NHWC) is a whole number of
//     vectors and the pointers are 16-byte aligned, else one element
//     (ragged H*W, C = 1, the 1x1 map); a block's threads span up to
//     THREADS channel vectors.
//   - K8a and K9a (the reductions) are bound by the bytes a card keeps in
//     flight and, in bf16, by conversions (f32 -> bf16 roundings and
//     f32 -> f64, beside 2 f64 adds and a product an element). A thread
//     takes V = 4 channels (8 bytes of bf16, 16 of f32; f64 one element)
//     and issues U loads an operand a trip (RED_BYTES: U = 4 in bf16, 2 in
//     f32; U = 4 for one element, V = 1) before its first add;
//     channels-last, the loads of the next trip go out before the adds of
//     this one, and the first trip's before the per-channel terms are
//     made. A channels-last block spans GROUP_LANES channel vectors (64
//     channels), so the terms stay a few registers a thread (4 blocks an
//     SM for K8a, 2 for K9a) and a group's partial sums stay short; the
//     bf16 forms round two elements an instruction.
//   - Modes are template arguments: the relu instantiations are the
//     DoubleConv's kernels as they were, and only residual ones carry the
//     third operand's loads and registers.
//   - Sums in one launch, in a fixed order: each block reduces its slice
//     in a fixed order (registers, then a warp's xor tree and the warps in
//     order, or the rows of the block in order, through shared memory)
//     into a per-slice partial in a workspace; the last block of each run
//     of TREE slices of a group (found by a counter, __threadfence then
//     atomicAdd, which orders nothing of the sums) adds the run's partials
//     in a fixed order, and the last run of the group adds the runs' sums
//     in order. The counters reset themselves for the next launch. The
//     plan (S, the slice's length) follows the shape alone
//     (kernels/bn_act.py::reduce_plan), so the same tensor gives the same
//     sums bit for bit, as remat's recompute and cudnn.deterministic runs
//     need.
//   - n is made from the shape and written into stats[2C] by the last
//     block (f64, exact), so an all-reduce of the buffer sums the counts
//     with the moments. No launch synchronises.
//   - K8b's slice 0 of each channel updates its running statistics.

#include "train_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEM_VECS = 4;    // vectors a thread loads in one K8b / K9b item
constexpr int RED_V = 4;        // channels (NHWC) or elements (NCHW) a load
constexpr int GROUP_LANES = 16; // channel vectors of a channels-last group
constexpr int TREE = 32;        // partial sums a first-stage combine adds
constexpr int RED_BYTES = 32;   // bytes of loads an operand a thread's trip

// what follows the BatchNorm (kernels/bn_act.py::MODES)
constexpr int RELU = 0, NONE = 1, RESIDUAL = 2;

// loads an operand a thread issues before its first add: RED_BYTES of
// vectors, or 4 single elements
template <typename T, int V>
__host__ __device__ constexpr int unroll() {
  return V == 1 ? 4 : RED_BYTES / (V * (int)sizeof(T));
}

__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) { return rsqrt(v); }
__device__ __forceinline__ float max0(float v) { return fmaxf(v, 0.0f); }
__device__ __forceinline__ double max0(double v) { return fmax(v, 0.0); }

// an f64 value rounded to A
template <typename A>
__device__ __forceinline__ A narrow(double v);
template <>
__device__ __forceinline__ float narrow<float>(double v) {
  return __double2float_rn(v);
}
template <>
__device__ __forceinline__ double narrow<double>(double v) {
  return v;
}

// the bits of V elements of T, loaded as one word
template <int B>
struct RawOf;
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};
template <typename T, int V>
using Raw = typename RawOf<(int)sizeof(T) * V>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> raw_load(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r,
                                       Acc<T> (&v)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_a<T>(e[k]);
}

// The pointers and numbers every kernel of the site reads. The per-channel
// vectors are of the acc type (f32, or f64 for f64 input).
struct Site {
  const void* y;          // the conv output without its bias (cdt)
  const void* dy;         // the gradient of the site's output (cdt)
  const void* x3;         // residual: r (K8b) or the saved out (K9a, K9b)
  const void* bias;       // the conv bias (C), or null: none
  const double* stats;    // [sum t, sum t^2, n] (2C + 1)
  const double* gstats;   // [sum g, sum g * xhat] (2C)
  const void* gamma;      // (C)
  const void* beta;       // (C)
  void* out;              // K8b's output or K9b's gradient dt (cdt)
  void* out2;             // residual: K9b's dr (cdt)
  void* rm;               // running mean (C), K8b only
  void* rv;               // running variance (C), K8b only
  double* ws;             // the reductions' partial sums ((S + Q), 2C)
  unsigned* counters;     // the reductions' counters (G (Q + 1))
  double* sums;           // the result of a reduction (2C, +1 with n)
  long long N, HW;        // batch, pixels a plane
  long long per;          // rows (NHWC) or items (NCHW) a reduction's slice
  int C, S;               // channels, slices
  int with_n;             // a reduction writes n at sums[2C]
  double eps, keep, mom;  // eps, 1 - momentum, momentum
  double rows_div;        // the copies of each row the sums hold (K8b)
};

// The per-channel terms of channel c.
template <typename A>
struct Chan {
  A bias;  // the conv bias rounded to cdt
  A mean, rstd, a, beta, mg, mgt;
};

// 1 / n, correctly rounded in f64 (one division a thread: the means are
// sums times it, f64 divisions a channel cost a short block a tenth of
// its time)
__device__ __forceinline__ double inv_count(const Site& s) {
  return s.stats != nullptr ? __drcp_rn(s.stats[2 * s.C]) : 0.0;
}

// the mean of channel c and its biased variance max(E[t^2] - mean^2, 0)
template <typename A>
__device__ __forceinline__ A mean_of(const Site& s, int c, double rn) {
  return narrow<A>(__dmul_rn(s.stats[c], rn));
}

template <typename A>
__device__ __forceinline__ A var_of(const Site& s, int c, A mean, double rn) {
  const A e2 = narrow<A>(__dmul_rn(s.stats[s.C + c], rn));
  return max0(sub_rn(e2, mul_rn(mean, mean)));
}

template <typename T>
__device__ __forceinline__ Chan<Acc<T>> chan_of(const Site& s, int c,
                                                double rn) {
  using A = Acc<T>;
  Chan<A> h;
  const A* bias = static_cast<const A*>(s.bias);
  h.bias = bias != nullptr ? round_to<T>(bias[c]) : A(0);
  h.mean = h.rstd = h.a = h.beta = h.mg = h.mgt = A(0);
  if (s.stats != nullptr) {
    h.mean = mean_of<A>(s, c, rn);
    h.rstd = rsqrt_of(add_rn(var_of<A>(s, c, h.mean, rn), (A)s.eps));
    h.a = mul_rn(h.rstd, static_cast<const A*>(s.gamma)[c]);
    h.beta = static_cast<const A*>(s.beta)[c];
    if (s.gstats != nullptr) {
      h.mg = narrow<A>(__dmul_rn(s.gstats[c], rn));
      h.mgt = narrow<A>(__dmul_rn(s.gstats[s.C + c], rn));
    }
  }
  return h;
}

// t and the BatchNorm's output p of one element
template <typename T>
__device__ __forceinline__ Acc<T> t_of(Acc<T> y, const Chan<Acc<T>>& h) {
  return round_to<T>(add_rn(y, h.bias));
}

template <typename T>
__device__ __forceinline__ Acc<T> pre_of(Acc<T> d, const Chan<Acc<T>>& h) {
  return round_to<T>(add_rn(mul_rn(d, h.a), h.beta));
}

// the gradient through mode M's ReLU: p the BatchNorm's output (relu), o
// the saved output (residual)
template <int M, typename A>
__device__ __forceinline__ A masked(A dy, A p, A o) {
  if constexpr (M == RELU) return p > A(0) ? dy : A(0);
  if constexpr (M == RESIDUAL) return o > A(0) ? dy : A(0);
  return dy;
}

// The bf16 forms of K8a / K9a take two elements at a time (a 32-bit word
// of two bf16, the first in the low half): one F2FP rounds both to bf16,
// half the roundings of one element at a time (5-8% of these kernels'
// time on an H100, PERF.md, PR 14), the same bits.

// the two floats of a word of two bf16
__device__ __forceinline__ float lo_f(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// a and b rounded to bf16 (one instruction), as a word of two bf16
__device__ __forceinline__ unsigned round2(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&r);
}

// K8a: (t, t^2)
template <typename T, int M>
struct StatsOp {
  using A = Acc<T>;
  static constexpr bool kDy = false, kX3 = false;
  __device__ static __forceinline__ void pair(A y, A, A, const Chan<A>& h,
                                              double& u, double& w) {
    const double t = t_of<T>(y, h);
    u = t;
    w = __dmul_rn(t, t);
  }
  // two bf16 elements (words y and, unused, dy and x3)
  __device__ static __forceinline__ void pair2(unsigned y, unsigned,
                                               unsigned, const Chan<A>& h0,
                                               const Chan<A>& h1,
                                               double (&u)[2],
                                               double (&w)[2]) {
    const unsigned t = round2(__fadd_rn(lo_f(y), h0.bias),
                              __fadd_rn(hi_f(y), h1.bias));
    u[0] = lo_f(t);
    u[1] = hi_f(t);
    w[0] = __dmul_rn(u[0], u[0]);
    w[1] = __dmul_rn(u[1], u[1]);
  }
};

// K9a: (g, g * xhat)
template <typename T, int M>
struct GradStatsOp {
  using A = Acc<T>;
  static constexpr bool kDy = true, kX3 = M == RESIDUAL;
  __device__ static __forceinline__ void pair(A y, A dy, A o,
                                              const Chan<A>& h, double& u,
                                              double& w) {
    const A d = sub_rn(t_of<T>(y, h), h.mean);
    A p = A(0);
    if constexpr (M == RELU) p = pre_of<T>(d, h);
    const double g = masked<M>(dy, p, o);
    u = g;
    w = __dmul_rn(g, (double)mul_rn(d, h.rstd));
  }
  __device__ static __forceinline__ void pair2(unsigned y, unsigned dy,
                                               unsigned o,
                                               const Chan<A>& h0,
                                               const Chan<A>& h1,
                                               double (&u)[2],
                                               double (&w)[2]) {
    const unsigned t = round2(__fadd_rn(lo_f(y), h0.bias),
                              __fadd_rn(hi_f(y), h1.bias));
    const float d0 = __fsub_rn(lo_f(t), h0.mean);
    const float d1 = __fsub_rn(hi_f(t), h1.mean);
    unsigned pre = 0u;
    if constexpr (M == RELU)
      pre = round2(__fadd_rn(__fmul_rn(d0, h0.a), h0.beta),
                   __fadd_rn(__fmul_rn(d1, h1.a), h1.beta));
    u[0] = masked<M>(lo_f(dy), lo_f(pre), lo_f(o));
    u[1] = masked<M>(hi_f(dy), hi_f(pre), hi_f(o));
    w[0] = __dmul_rn(u[0], (double)__fmul_rn(d0, h0.rstd));
    w[1] = __dmul_rn(u[1], (double)__fmul_rn(d1, h1.rstd));
  }
};

// the (u, w) terms of V elements of one load (and dy's and x3's), channel
// k's terms in h[k]: two at a time in bf16, else one at a time
template <typename T, int V, class Op>
__device__ __forceinline__ void terms(const Raw<T, V>& ry,
                                      const Raw<T, V>& rd,
                                      const Raw<T, V>& ro,
                                      const Chan<Acc<T>>* h, double (&u)[V],
                                      double (&w)[V]) {
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
    const unsigned* y2 = reinterpret_cast<const unsigned*>(&ry);
    const unsigned* d2 = reinterpret_cast<const unsigned*>(&rd);
    const unsigned* o2 = reinterpret_cast<const unsigned*>(&ro);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      double a[2], b[2];
      Op::pair2(y2[k], Op::kDy ? d2[k] : 0u, Op::kX3 ? o2[k] : 0u, h[2 * k],
                h[2 * k + 1], a, b);
      u[2 * k] = a[0];
      u[2 * k + 1] = a[1];
      w[2 * k] = b[0];
      w[2 * k + 1] = b[1];
    }
  } else {
    Acc<T> yv[V], dv[V] = {}, ov[V] = {};
    unpack<T, V>(ry, yv);
    if constexpr (Op::kDy) unpack<T, V>(rd, dv);
    if constexpr (Op::kX3) unpack<T, V>(ro, ov);
#pragma unroll
    for (int k = 0; k < V; ++k)
      Op::pair(yv[k], dv[k], ov[k], h[k], u[k], w[k]);
  }
}

// K8b: p, relu(p) or relu(cdt(p + r))
template <typename T, int M>
struct ApplyOp {
  using A = Acc<T>;
  static constexpr bool kDy = false, kX3 = M == RESIDUAL, kOut2 = false;
  __device__ static __forceinline__ A out(A y, A, A r, const Chan<A>& h,
                                          A&) {
    const A p = pre_of<T>(sub_rn(t_of<T>(y, h), h.mean), h);
    if constexpr (M == NONE) return p;
    A v = p;
    if constexpr (M == RESIDUAL) v = round_to<T>(add_rn(p, r));
    return v > A(0) ? v : A(0);
  }
};

// K9b: a * ((g - mean g) - xhat * mean(g xhat)), rounded to cdt by the
// store; residual: g too (dr)
template <typename T, int M>
struct GradApplyOp {
  using A = Acc<T>;
  static constexpr bool kDy = true, kX3 = M == RESIDUAL,
                        kOut2 = M == RESIDUAL;
  __device__ static __forceinline__ A out(A y, A dy, A o, const Chan<A>& h,
                                          A& g) {
    const A d = sub_rn(t_of<T>(y, h), h.mean);
    A p = A(0);
    if constexpr (M == RELU) p = pre_of<T>(d, h);
    g = masked<M>(dy, p, o);
    const A xh = mul_rn(d, h.rstd);
    return mul_rn(h.a, sub_rn(sub_rn(g, h.mg), mul_rn(xh, h.mgt)));
  }
};

// K8b's running-statistics update of channel c (one thread a channel)
template <typename A>
__device__ __forceinline__ void update_running(const Site& s, int c) {
  const double n = s.stats[2 * s.C], rn = __drcp_rn(n);
  const double rows = __ddiv_rn(n, s.rows_div);
  const A mean = mean_of<A>(s, c, rn);
  const A var = var_of<A>(s, c, mean, rn);
  const A unbias = narrow<A>(__ddiv_rn(rows, fmax(rows - 1.0, 1.0)));
  const A keep = (A)s.keep, mom = (A)s.mom;
  A* rm = static_cast<A*>(s.rm);
  A* rv = static_cast<A*>(s.rv);
  rm[c] = add_rn(mul_rn(keep, rm[c]), mul_rn(mom, mean));
  rv[c] = add_rn(mul_rn(keep, rv[c]), mul_rn(mom, mul_rn(var, unbias)));
}

// ---------------------------------------------------------------------------
// the reductions' combine: the last blocks add the partials in a fixed order
// ---------------------------------------------------------------------------

// dst[col] for the 2 * width columns of channels [c0, c0 + width) of a
// [2C] row (the sums of u, then of w): the sum over the rows p < n of src
// (each 2C doubles) in a fixed order: lane l of L = THREADS / (2 width)
// adds the rows l, l + L, ... in order, then the L lanes are added in
// order. The rows were written by other blocks: read past L1.
__device__ __forceinline__ void combine(const Site& s, const double* src,
                                        int n, int c0, int width,
                                        double* dst) {
  __shared__ double part[THREADS];
  const int m = 2 * width;
  const int L = THREADS / m;
  const int j = threadIdx.x % m, l = threadIdx.x / m;
  const int col = j < width ? c0 + j : s.C + c0 + (j - width);
  double a = 0.0;
  if (l < L)
    for (int p = l; p < n; p += L)
      a = __dadd_rn(a, __ldcg(src + (long long)p * 2 * s.C + col));
  part[threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.x < m) {
    double t = part[j];
    const int lanes = min(L, n);
    for (int k = 1; k < lanes; ++k) t = __dadd_rn(t, part[k * m + j]);
    dst[col] = t;
  }
}

// A block has written its slice's partial (row blockIdx.x of s.ws, the
// columns of its group blockIdx.y: channels [c0, c0 + width)). The last
// block of its run of TREE slices adds the run's partials (into stage row
// q of s.ws, or into s.sums when one run holds every slice); the last run
// of the group adds the runs' sums in order into s.sums. Which block is
// last changes nothing in the sums. Each counter goes back to 0.
__device__ __forceinline__ void finish(const Site& s, int c0, int width) {
  const int Q = (s.S + TREE - 1) / TREE;
  const int q = blockIdx.x / TREE;
  const int runs = min(TREE, s.S - q * TREE);
  unsigned* first = s.counters + (long long)blockIdx.y * Q + q;
  unsigned* second = s.counters + (long long)gridDim.y * Q + blockIdx.y;
  double* stage = s.ws + (long long)s.S * 2 * s.C;
  if (!arrive_last(first, (unsigned)runs)) return;
  combine(s, s.ws + (long long)q * TREE * 2 * s.C, runs, c0, width,
          Q == 1 ? s.sums : stage + (long long)q * 2 * s.C);
  if (Q > 1) {
    if (threadIdx.x == 0) *first = 0;
    if (!arrive_last(second, (unsigned)Q)) return;
    combine(s, stage, Q, c0, width, s.sums);
  }
  if (threadIdx.x == 0) {
    if (Q > 1)
      *second = 0;
    else
      *first = 0;
    if (s.with_n && blockIdx.y == 0) s.sums[2 * s.C] = (double)(s.N * s.HW);
  }
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

// K8a / K9a: slice blockIdx.x holds the items [x per, (x + 1) per) of the
// channel's N * ceil(HW / ITEM) items; a thread loads U vectors of an item
// at once
template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) reduce_nchw(Site s) {
  constexpr int U = unroll<T, V>();
  constexpr long long ITEM = (long long)THREADS * V * U;
  const int c = blockIdx.y;
  Chan<Acc<T>> hv[V];  // the channel's terms, once an element of a load
  hv[0] = chan_of<T>(s, c, inv_count(s));
#pragma unroll
  for (int e = 1; e < V; ++e) hv[e] = hv[0];
  const long long per_plane = (s.HW + ITEM - 1) / ITEM;
  const long long items = s.N * per_plane;
  const long long i0 = (long long)blockIdx.x * s.per;
  const long long i1 = min(items, i0 + s.per);
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  const T* x3 = static_cast<const T*>(s.x3);
  double u = 0.0, w = 0.0;
  for (long long i = i0; i < i1; ++i) {
    const long long n = i / per_plane;
    const long long p0 =
        (i - n * per_plane) * ITEM + (long long)threadIdx.x * V;
    const long long base = (n * s.C + c) * s.HW;
    Raw<T, V> ry[U], rd[U], ro[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long p = p0 + (long long)k * THREADS * V;
      const bool ok = p < s.HW;
      ry[k] = ok ? raw_load<T, V>(y + base + p) : Raw<T, V>{};
      if constexpr (Op::kDy)
        rd[k] = ok ? raw_load<T, V>(dy + base + p) : Raw<T, V>{};
      if constexpr (Op::kX3)
        ro[k] = ok ? raw_load<T, V>(x3 + base + p) : Raw<T, V>{};
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (p0 + (long long)k * THREADS * V >= s.HW) continue;
      double a[V], b[V];
      terms<T, V, Op>(ry[k], rd[k], ro[k], hv, a, b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        u = __dadd_rn(u, a[e]);
        w = __dadd_rn(w, b[e]);
      }
    }
  }
  block_sum2(u, w);
  if (threadIdx.x == 0) {
    double* ws = s.ws + (long long)blockIdx.x * 2 * s.C;
    ws[c] = u;
    ws[s.C + c] = w;
  }
  finish(s, c, 1);
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) apply_nchw(Site s) {
  using A = Acc<T>;
  const int c = blockIdx.y;
  const Chan<A> h = chan_of<T>(s, c, inv_count(s));
  if (s.rm != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    update_running<A>(s, c);
  constexpr long long CH = (long long)THREADS * V * ITEM_VECS;
  const long long per_plane = (s.HW + CH - 1) / CH;
  const long long items = s.N * per_plane;
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  const T* x3 = static_cast<const T*>(s.x3);
  T* out = static_cast<T*>(s.out);
  T* out2 = static_cast<T*>(s.out2);
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const long long n = i / per_plane;
    const long long p0 = (i - n * per_plane) * CH;
    const long long base = (n * s.C + c) * s.HW;
    const long long end = min(s.HW, p0 + CH);
    for (long long p = p0 + (long long)threadIdx.x * V; p < end;
         p += (long long)THREADS * V) {
      A yv[V], dv[V] = {}, xv[V] = {}, ov[V], gv[V];
      load<T, V>(y + base + p, yv);
      if constexpr (Op::kDy) load<T, V>(dy + base + p, dv);
      if constexpr (Op::kX3) load<T, V>(x3 + base + p, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) ov[k] = Op::out(yv[k], dv[k], xv[k], h, gv[k]);
      store<T, V>(out + base + p, ov);
      if constexpr (Op::kOut2) store<T, V>(out2 + base + p, gv);
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

// a reduction's channels-last group: threads a row (up to GROUP_LANES
// channel vectors of V channels) and rows a pass
__device__ __forceinline__ void group_shape(int C, int V, int& tr, int& r) {
  const int cv = C / V;
  tr = cv < GROUP_LANES ? cv : GROUP_LANES;
  r = THREADS / tr;
}

// K8a / K9a: slice blockIdx.x holds the rows [x per, (x + 1) per), group
// blockIdx.y the channels [y tr V, (y + 1) tr V); a thread loads V channels
// of U rows at once (rows R apart), holds its V channels' terms in
// registers and their sums in f64
template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) reduce_nhwc(Site s) {
  constexpr int U = unroll<T, V>();
  __shared__ double su[THREADS * V], sw[THREADS * V];
  int tr, R;
  group_shape(s.C, V, tr, R);
  const int lane = threadIdx.x % tr, r0 = threadIdx.x / tr;
  const int c0 = blockIdx.y * tr * V;  // the group's first channel
  const int width = min(tr * V, s.C - c0);
  const int cv = blockIdx.y * tr + lane;  // this thread's channel vector
  const bool active = r0 < R && cv * V < s.C;
  const long long rows = s.N * s.HW;
  const long long rbeg = (long long)blockIdx.x * s.per;
  const long long rend = min(rows, rbeg + s.per);
  double u[V] = {}, w[V] = {};
  if (active) {
    const T* y = static_cast<const T*>(s.y) + (long long)cv * V;
    const T* dy = static_cast<const T*>(s.dy) + (long long)cv * V;
    const T* x3 = static_cast<const T*>(s.x3) + (long long)cv * V;
    const long long step = (long long)R * U;
    // the loads of trip r (rows r, r + R, ...; past rend none)
    auto fetch = [&](long long r, Raw<T, V>(&a)[U], Raw<T, V>(&b)[U],
                     Raw<T, V>(&o)[U]) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const long long e = (r + (long long)k * R) * s.C;
        const bool ok = r + (long long)k * R < rend;
        a[k] = ok ? raw_load<T, V>(y + e) : Raw<T, V>{};
        if constexpr (Op::kDy)
          b[k] = ok ? raw_load<T, V>(dy + e) : Raw<T, V>{};
        if constexpr (Op::kX3)
          o[k] = ok ? raw_load<T, V>(x3 + e) : Raw<T, V>{};
      }
    };
    Raw<T, V> ry[U], rd[U], ro[U];
    fetch(rbeg + r0, ry, rd, ro);  // in flight while the terms are made
    Chan<Acc<T>> h[V];
    const double rn = inv_count(s);
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = chan_of<T>(s, cv * V + k, rn);
    for (long long r = rbeg + r0; r < rend; r += step) {
      Raw<T, V> ny[U], nd[U], no[U];
      fetch(r + step, ny, nd, no);  // the next trip's loads, before these adds
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (r + (long long)k * R >= rend) continue;
        double a[V], b[V];
        terms<T, V, Op>(ry[k], rd[k], ro[k], h, a, b);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          u[j] = __dadd_rn(u[j], a[j]);
          w[j] = __dadd_rn(w[j], b[j]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        ry[k] = ny[k];
        if constexpr (Op::kDy) rd[k] = nd[k];
        if constexpr (Op::kX3) ro[k] = no[k];
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
  // the R rows of the group's channels, summed in row order: the partial
  for (int j = threadIdx.x; j < width; j += THREADS) {
    double a = 0.0, b = 0.0;
    for (int r = 0; r < R; ++r) {
      a = __dadd_rn(a, su[r * tr * V + j]);
      b = __dadd_rn(b, sw[r * tr * V + j]);
    }
    double* ws = s.ws + (long long)blockIdx.x * 2 * s.C;
    ws[c0 + j] = a;
    ws[s.C + c0 + j] = b;
  }
  finish(s, c0, width);
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(THREADS) apply_nhwc(Site s) {
  using A = Acc<T>;
  int tr, R;
  nhwc_shape(s.C, V, tr, R);
  const int lane = threadIdx.x % tr, r0 = threadIdx.x / tr;
  const int cv = blockIdx.y * tr + lane;
  if (r0 >= R || cv * V >= s.C) return;
  Chan<A> h[V];
  const double rn = inv_count(s);
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = chan_of<T>(s, cv * V + k, rn);
  if (s.rm != nullptr && blockIdx.x == 0 && r0 == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) update_running<A>(s, cv * V + k);
  }
  const long long rows = s.N * s.HW;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long rbeg = (long long)blockIdx.x * per;
  const long long rend = min(rows, rbeg + per);
  const T* y = static_cast<const T*>(s.y);
  const T* dy = static_cast<const T*>(s.dy);
  const T* x3 = static_cast<const T*>(s.x3);
  T* out = static_cast<T*>(s.out);
  T* out2 = static_cast<T*>(s.out2);
  for (long long r = rbeg + r0; r < rend; r += R) {
    const long long e = r * s.C + (long long)cv * V;
    A yv[V], dv[V] = {}, xv[V] = {}, ov[V], gv[V];
    load<T, V>(y + e, yv);
    if constexpr (Op::kDy) load<T, V>(dy + e, dv);
    if constexpr (Op::kX3) load<T, V>(x3 + e, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) ov[k] = Op::out(yv[k], dv[k], xv[k], h[k], gv[k]);
    store<T, V>(out + e, ov);
    if constexpr (Op::kOut2) store<T, V>(out2 + e, gv);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int VEC_BYTES = 16;

// the kernels this file has launched in the process (host side; read by
// insarseg_bn_kernel_launches)
int launched = 0;

// K8b / K9b: up to THREADS channel vectors a block
template <typename T, int V>
dim3 apply_grid(const Site& s, int layout) {
  if (layout == 0) return dim3((unsigned)s.S, (unsigned)s.C);
  const int cv = s.C / V;
  return dim3((unsigned)s.S, (unsigned)((cv + THREADS - 1) / THREADS));
}

// K8a / K9a: channels (NCHW) or GROUP_LANES channel vectors (NHWC) a block
template <typename T, int V>
unsigned reduce_groups(const Site& s, int layout) {
  if (layout == 0) return (unsigned)s.C;
  const int cv = s.C / V;
  const int tr = cv < GROUP_LANES ? cv : GROUP_LANES;
  return (unsigned)((cv + tr - 1) / tr);
}

template <typename T, int V, class Op>
cudaError_t reduce_as(const Site& s, int layout, int groups,
                      cudaStream_t st) {
  const dim3 g((unsigned)s.S, reduce_groups<T, V>(s, layout));
  if ((int)g.y != groups) return cudaErrorInvalidValue;
  if (layout == 0)
    reduce_nchw<T, V, Op><<<g, THREADS, 0, st>>>(s);
  else
    reduce_nhwc<T, V, Op><<<g, THREADS, 0, st>>>(s);
  ++launched;
  return cudaGetLastError();
}

template <typename T, int V, class Op>
cudaError_t apply_as(const Site& s, int layout, cudaStream_t st) {
  const dim3 g = apply_grid<T, V>(s, layout);
  if (layout == 0)
    apply_nchw<T, V, Op><<<g, THREADS, 0, st>>>(s);
  else
    apply_nhwc<T, V, Op><<<g, THREADS, 0, st>>>(s);
  ++launched;
  return cudaGetLastError();
}

// the reductions in f64 take one element a load
template <template <typename, int> class Op, int M>
cudaError_t reduce_typed(const Site& s, int dtype, int layout, int vec,
                         int groups, cudaStream_t st) {
  switch (dtype) {
    case BF16:
      return vec ? reduce_as<bf, RED_V, Op<bf, M>>(s, layout, groups, st)
                 : reduce_as<bf, 1, Op<bf, M>>(s, layout, groups, st);
    case F32:
      return vec ? reduce_as<float, RED_V, Op<float, M>>(s, layout, groups,
                                                         st)
                 : reduce_as<float, 1, Op<float, M>>(s, layout, groups, st);
    case F64:
      return vec ? cudaErrorInvalidValue
                 : reduce_as<double, 1, Op<double, M>>(s, layout, groups, st);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int> class Op, int M>
cudaError_t apply_typed(const Site& s, int dtype, int layout, int vec,
                        cudaStream_t st) {
  switch (dtype) {
    case BF16:
      return vec ? apply_as<bf, VEC_BYTES / 2, Op<bf, M>>(s, layout, st)
                 : apply_as<bf, 1, Op<bf, M>>(s, layout, st);
    case F32:
      return vec ? apply_as<float, VEC_BYTES / 4, Op<float, M>>(s, layout, st)
                 : apply_as<float, 1, Op<float, M>>(s, layout, st);
    case F64:
      return vec ? apply_as<double, VEC_BYTES / 8, Op<double, M>>(s, layout,
                                                                  st)
                 : apply_as<double, 1, Op<double, M>>(s, layout, st);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int> class Op>
cudaError_t reduce_site(const Site& s, int dtype, int layout, int vec,
                        int groups, int mode, cudaStream_t st) {
  switch (mode) {
    case RELU: return reduce_typed<Op, RELU>(s, dtype, layout, vec, groups, st);
    case NONE: return reduce_typed<Op, NONE>(s, dtype, layout, vec, groups, st);
    case RESIDUAL:
      return reduce_typed<Op, RESIDUAL>(s, dtype, layout, vec, groups, st);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int> class Op>
cudaError_t apply_site(const Site& s, int dtype, int layout, int vec,
                       int mode, cudaStream_t st) {
  switch (mode) {
    case RELU: return apply_typed<Op, RELU>(s, dtype, layout, vec, st);
    case NONE: return apply_typed<Op, NONE>(s, dtype, layout, vec, st);
    case RESIDUAL: return apply_typed<Op, RESIDUAL>(s, dtype, layout, vec, st);
  }
  return cudaErrorInvalidValue;
}

Site site_of(long long N, long long HW, int C, int S, double eps) {
  Site s = {};
  s.N = N;
  s.HW = HW;
  s.C = C;
  s.S = S;
  s.eps = eps;
  s.rows_div = 1.0;
  return s;
}

bool bad_shape(long long N, long long HW, int C, int S) {
  return N < 0 || HW < 0 || C < 1 || C > 65535 || S < 1;
}

// a residual site needs its third operand (and K9b its dr)
bool bad_mode(int mode, const void* x3) {
  return mode < RELU || mode > RESIDUAL || ((mode == RESIDUAL) != (x3 != nullptr));
}

// a reduction's partition and scratch: S slices of per rows or items;
// ws ((S + ceil(S / TREE)) 2C doubles) and counters ((ceil(S / TREE) + 1)
// groups, zero) from the wrapper's cached workspace
void plan_of(Site& s, long long per, void* ws, void* counters) {
  s.per = per;
  s.ws = static_cast<double*>(ws);
  s.counters = static_cast<unsigned*>(counters);
}

}  // namespace

// Every entry point: y (and dy, and the residual operand) (N, C, H, W) of
// dtype 0 f32, 1 bf16 or 2 f64, NCHW (layout 0) or channels-last (layout
// 1) memory, HW = H * W; vec != 0 takes vectors (the wrapper checks the
// sizes and alignment: 16 bytes for K8b / K9b, RED_V elements for K8a /
// K9a, none in f64); S the slices of the plan; the sums f64; the
// per-channel parameters and statistics f32 (f64 for f64 y); bias null for
// none; mode 0 relu, 1 none, 2 residual. K8a / K9a also take per (rows or
// items a slice), groups (grid.y, checked against the kernel's own) and the
// workspace.

// K8a: stats (2C + 1) = [sum t, sum t^2, n]
extern "C" int insarseg_bn_stats(const void* y, const void* bias, void* ws,
                                 void* counters, void* stats, long long N,
                                 long long HW, int C, int S, long long per,
                                 int groups, int dtype, int layout, int vec,
                                 void* stream) {
  if (bad_shape(N, HW, C, S) || per < 1) return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, 0.0);
  plan_of(s, per, ws, counters);
  s.y = y;
  s.bias = bias;
  s.sums = static_cast<double*>(stats);
  s.with_n = 1;
  // the moments do not depend on the mode
  return (int)reduce_typed<StatsOp, RELU>(
      s, dtype, layout, vec, groups, reinterpret_cast<cudaStream_t>(stream));
}

// K8b: out = relu(p), p or relu(cdt(p + r)); rm, rv updated in place, the
// unbiased factor from the count over rows_div
extern "C" int insarseg_bn_apply_relu(const void* y, const void* bias,
                                      const void* stats, const void* gamma,
                                      const void* beta, void* rm, void* rv,
                                      const void* r, void* out, long long N,
                                      long long HW, int C, int S, double eps,
                                      double keep, double mom,
                                      double rows_div, int dtype, int layout,
                                      int vec, int mode, void* stream) {
  if (bad_shape(N, HW, C, S) || bad_mode(mode, r) || !(rows_div >= 1.0))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  s.y = y;
  s.x3 = r;
  s.bias = bias;
  s.stats = static_cast<const double*>(stats);
  s.gamma = gamma;
  s.beta = beta;
  s.rm = rm;
  s.rv = rv;
  s.out = out;
  s.keep = keep;
  s.mom = mom;
  s.rows_div = rows_div;
  return (int)apply_site<ApplyOp>(s, dtype, layout, vec, mode,
                                  reinterpret_cast<cudaStream_t>(stream));
}

// K9a: gstats (2C) = [sum g, sum g * xhat]; o the saved output (residual)
extern "C" int insarseg_bn_relu_grad_stats(
    const void* dy, const void* y, const void* o, const void* bias,
    const void* stats, const void* gamma, const void* beta, void* ws,
    void* counters, void* gstats, long long N, long long HW, int C, int S,
    long long per, int groups, double eps, int dtype, int layout, int vec,
    int mode, void* stream) {
  if (bad_shape(N, HW, C, S) || per < 1 || bad_mode(mode, o))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  plan_of(s, per, ws, counters);
  s.y = y;
  s.dy = dy;
  s.x3 = o;
  s.bias = bias;
  s.stats = static_cast<const double*>(stats);
  s.gamma = gamma;
  s.beta = beta;
  s.sums = static_cast<double*>(gstats);
  return (int)reduce_site<GradStatsOp>(s, dtype, layout, vec, groups, mode,
                                       reinterpret_cast<cudaStream_t>(stream));
}

// K9b: dt = cdt(a * ((g - sum g / n) - xhat * (sum g xhat / n))); residual:
// dr = g, o the saved output
extern "C" int insarseg_bn_relu_grad_apply(
    const void* dy, const void* y, const void* o, const void* bias,
    const void* stats, const void* gstats, const void* gamma,
    const void* beta, void* dt, void* dr, long long N, long long HW, int C,
    int S, double eps, int dtype, int layout, int vec, int mode,
    void* stream) {
  if (bad_shape(N, HW, C, S) || bad_mode(mode, o) ||
      ((mode == RESIDUAL) != (dr != nullptr)))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(N, HW, C, S, eps);
  s.y = y;
  s.dy = dy;
  s.x3 = o;
  s.bias = bias;
  s.stats = static_cast<const double*>(stats);
  s.gstats = static_cast<const double*>(gstats);
  s.gamma = gamma;
  s.beta = beta;
  s.out = dt;
  s.out2 = dr;
  return (int)apply_site<GradApplyOp>(s, dtype, layout, vec, mode,
                                      reinterpret_cast<cudaStream_t>(stream));
}

namespace {

template <typename F>
cudaError_t info_of(F* f, int bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, THREADS, 0);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  out[4] = THREADS;
  out[5] = bytes;
  return cudaSuccess;
}

// the bytes a thread has in flight: U loads of V elements an operand
template <typename T, int V, class Op>
cudaError_t reduce_info(int layout, int* out) {
  constexpr int b = (int)sizeof(T) * V * unroll<T, V>() *
                    (1 + (int)Op::kDy + (int)Op::kX3);
  return layout ? info_of(reduce_nhwc<T, V, Op>, b, out)
                : info_of(reduce_nchw<T, V, Op>, b, out);
}

// one load of V elements an operand
template <typename T, int V, class Op>
cudaError_t apply_info(int layout, int* out) {
  constexpr int b = (int)sizeof(T) * V * (1 + (int)Op::kDy + (int)Op::kX3);
  return layout ? info_of(apply_nhwc<T, V, Op>, b, out)
                : info_of(apply_nchw<T, V, Op>, b, out);
}

}  // namespace

// The kernels the entry points above have launched in this process, into
// *count.
extern "C" int insarseg_bn_kernel_launches(int* count) {
  *count = launched;
  return 0;
}

// The resources of kernel k into out[0..5]: its registers a thread,
// local-memory (spill) bytes a thread, static shared bytes a block,
// resident blocks an SM at THREADS threads, THREADS, and the bytes of
// device memory a thread has in flight in one trip of its loop. k = 0-7
// the reductions K8a / K9a (relu) in bf16 channels-last, f32 NCHW, bf16
// NCHW and f32 channels-last (vectors); 8-11 the applies K8b / K9b (relu)
// in bf16 channels-last and f32 NCHW (16-byte vectors); 12-14 the
// residual K9a, K8b and K9b in bf16 channels-last; 15-16 K9a and K9b in
// f64 NCHW (relu).
extern "C" int insarseg_bn_kernel_info(int k, int* out) {
  constexpr int bv = VEC_BYTES / 2, fv = VEC_BYTES / 4;
  switch (k) {
    case 0: return (int)reduce_info<bf, RED_V, StatsOp<bf, RELU>>(1, out);
    case 1: return (int)reduce_info<bf, RED_V, GradStatsOp<bf, RELU>>(1, out);
    case 2: return (int)reduce_info<float, RED_V, StatsOp<float, RELU>>(0, out);
    case 3:
      return (int)reduce_info<float, RED_V, GradStatsOp<float, RELU>>(0, out);
    case 4: return (int)reduce_info<bf, RED_V, StatsOp<bf, RELU>>(0, out);
    case 5: return (int)reduce_info<bf, RED_V, GradStatsOp<bf, RELU>>(0, out);
    case 6: return (int)reduce_info<float, RED_V, StatsOp<float, RELU>>(1, out);
    case 7:
      return (int)reduce_info<float, RED_V, GradStatsOp<float, RELU>>(1, out);
    case 8: return (int)apply_info<bf, bv, ApplyOp<bf, RELU>>(1, out);
    case 9: return (int)apply_info<bf, bv, GradApplyOp<bf, RELU>>(1, out);
    case 10: return (int)apply_info<float, fv, ApplyOp<float, RELU>>(0, out);
    case 11:
      return (int)apply_info<float, fv, GradApplyOp<float, RELU>>(0, out);
    case 12:
      return (int)reduce_info<bf, RED_V, GradStatsOp<bf, RESIDUAL>>(1, out);
    case 13: return (int)apply_info<bf, bv, ApplyOp<bf, RESIDUAL>>(1, out);
    case 14: return (int)apply_info<bf, bv, GradApplyOp<bf, RESIDUAL>>(1, out);
    case 15:
      return (int)reduce_info<double, 1, GradStatsOp<double, RELU>>(0, out);
    case 16:
      return (int)apply_info<double, VEC_BYTES / 8, GradApplyOp<double, RELU>>(
          0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
