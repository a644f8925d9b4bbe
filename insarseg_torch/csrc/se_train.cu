// K10a se_squeeze, K10b se_excite, K11a se_grad_stats and K11b
// se_grad_apply: the squeeze-excite tail in train mode, forward and
// backward, in three modes.
//
// Replaces the XLA:TPU fusions of the SE tail of the JAX package's train
// step: the squeeze (jnp.mean over H and W, one reduce fusion;
// insarseg/ops/layers.py:339-341), the rescale by the gate and what follows
// it (one loop fusion), and their autodiff. The modes are what follows the
// rescale, and what the squeeze takes besides the mean:
//   scale     out = cdt(x * gate)        SELayer, the DoubleConv's SE tail
//             (insarseg/ops/blocks.py:46-64, :135-136)
//   residual  out = relu(cdt(cdt(x * gate) + idn))   SEBlock after bn3, the
//             residual add and its relu (insarseg/models/resnet.py:87-99;
//             insarseg/ops/blocks.py:67-86), idn the block's identity
//   cbam      out = cdt(x * gate), the gate from the mean and the max over
//             H and W through one shared MLP: CBAM's channel attention,
//             DeepLabV3-CA's (insarseg/ops/blocks.py:89-111,
//             insarseg/models/deeplab.py:114); K10a also takes the max and
//             its ties, K11b adds the max's cotangent split over them (JAX's
//             reduce-max VJP); K10b and K11a run the scale code
// With cdt the compute dtype (bf16, f32 or f64) and acc = promote(cdt, f32):
//   K10a  sums[b, c] = sum over H, W of x, in f64              read x once
//         cbam: also mx[b, c] = the max over H, W (cdt) and count[b, c] =
//         the positions equal to it (int32)
//         (the caller may sum the buffer over the slabs of a spatial mesh,
//         then makes mean = cdt(acc(sums / (H W))) and gate = sigmoid(fc2(
//         relu(fc1(mean)))) in torch ops on (B, C) vectors; cbam: gate =
//         sigmoid(cdt(mlp(mean) + mlp(mx))), mlp = fc2(relu(fc1(.))))
//   K10b  out = cdt(x * gate[b, c]), or relu(cdt(that + idn))
//                                                 read x (and idn), write out
//   g     = dout; residual: dout where out > 0 (out the saved output: the
//           sum is > 0 exactly there), else 0
//   K11a  gsum[b, c] = sum over H, W of cdt(g * x), in f64 (the gate's
//         cotangent, the JAX VJP's bf16 product summed)
//                                                 read dout, x (and out)
//         (the caller runs the MLP's VJP in torch ops, makes dtot =
//         acc(dmean) / (H W) and may sum it over the slabs)
//   K11b  dx = cdt(cdt(g * gate) + cdt(dtot)) (the JAX VJP's add_any of
//         the rescale's and the mean's cotangents, each rounded to cdt);
//         residual: also didn = g, the identity's gradient; cbam: dx =
//         cdt(cdt(cdt(g * gate) + tie) + cdt(dtot)), tie = cdt(dmax /
//         cdt(count)) where x == mx, else 0 (the jaxpr's order: the
//         rescale's and the max's cotangents added, then the mean's; JAX's
//         reduce-max VJP counts the ties in cdt)
//                   read dout (and out, or x); write dx (and didn)
// Each product and sum of the element formulas is one rounding (__fmul_rn
// / __fadd_rn and their f64 forms, no contraction into an FMA), in the
// order of the plain versions (kernels/se_train.py). The sums are taken in
// f64: a bf16 or f32 term is exact there, so the order of a sum, a
// kernel's or its plain version's, one card's or a mesh's (whose slabs add
// their buffers), moves a sum by at most ~1e-16 of its magnitude. In f64
// (the yardstick steps) the terms round and the orders differ in the last
// bits.
//
// Bound on an H100 SXM: pure bandwidth, a few operations an element. Per
// site K10a reads x, K10b reads x (and idn) and writes out, K11a reads
// dout and x (and out), K11b reads dout (and out, or x) and writes dx
// (and didn): 7 passes in the scale mode, 11 in the residual mode, 8 in
// the cbam mode.
//
// Design (memory-bound passes, two layouts, fixed order):
//   - Layouts: NCHW (a (b, c) plane is H W consecutive elements) and
//     channels-last (image b is H W rows of C channels), read where they
//     lie. Loads and stores are 16 bytes (V = 8 bf16, 4 f32 or 2 f64)
//     where a plane (NCHW) or a row (channels-last) is a whole number of
//     vectors and every pointer is 16-byte aligned, else one element.
//   - Reductions (K10a, K11a). A thread keeps LOADS vectors an operand in
//     flight before its adds (K10a, one operand, 2 LOADS). NCHW: block
//     (plane, slice) sums a range of one plane, one f64 sum a thread.
//     Channels-last: block (image, channel group, slice); a thread owns V
//     channels of a row, a block LANES channel vectors and THREADS / LANES
//     rows a pass over a range of the image's rows, V f64 sums a thread.
//     A block's partial is summed in a fixed
//     order (a warp's xor tree and the warps in order, or the rows in
//     order through shared memory); with more than one slice the partials
//     go to a workspace and the last block of a plane or group (a counter:
//     __threadfence, then atomicAdd, which orders nothing of the sums) adds
//     them in slice order and resets its counter. The cbam mode's max and
//     count ride beside each sum: a partial (max, count) merges with
//     another as (the larger max, the counts of those equal to it summed),
//     exact in any order; the workspace holds a slice's max and count (as
//     f64, exact) after the S partial sums. The plan (the slices and
//     their length) follows the shape alone (kernels/se_train.py::
//     reduce_plan), so one tensor gives the same sums bit for bit at every
//     call, as remat's recompute needs. No launch synchronises.
//   - Elementwise passes (K10b, K11b): block (plane, chunk) with the
//     plane's gate (and dtot) a block-uniform register (NCHW), or block
//     (image, channel group, chunk of rows) with a thread's V gates in
//     registers (channels-last).
//   - Modes are template arguments: only the residual instantiations carry
//     the third operand's loads and the second output's stores.
//   - A slab of no row (a spatial mesh's empty slab, H W = 0): one launch
//     each, zero sums (cbam: max -inf, count 0), nothing written.
//   - The kernels' names (se_reduce_* <..., GRAD>, se_apply_* <..., GRAD>)
//     tell K10a / K11a and K10b / K11b apart in a profiler's trace.

#include "train_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;   // vectors an operand a reduction's thread loads
                           // before adding (K11a; K10a, one operand, twice)
constexpr int LANES = 32;  // channel vectors of a channels-last reduction block

// what follows the rescale (kernels/se_train.py::MODES)
constexpr int SCALE = 0, RESIDUAL = 1, CBAM = 2;

// The pointers and numbers of one site.
struct Site {
  const void* x;       // bn3's or the DoubleConv's output (cdt)
  const void* dy;      // the gradient of the site's output (cdt)
  const void* x3;      // residual: idn (K10b) or the saved out (K11a,
                       // K11b); cbam: x (K11b)
  const void* gate;    // (B, C) cdt
  const void* dtot;    // (B, C) acc: dmean / (H W), summed over the slabs
  void* mx;            // cbam: the max (B, C) cdt, K10a's output, K11b's
  int* count;          // cbam: the positions equal to it (B, C), likewise
  const void* dmax;    // cbam: the max's cotangent (B, C) cdt (K11b)
  void* out;           // K10b's output or K11b's dx (cdt)
  void* out2;          // residual: K11b's didn (cdt)
  double* sums;        // a reduction's result (B, C)
  double* ws;          // its partial sums (S, B, C) when S > 1
  unsigned* counters;  // its counters, one a plane or group, zero
  long long B, HW;     // images, pixels a plane
  long long per;       // elements (NCHW) or rows (channels-last) a block
  int C;               // channels
  int K;               // blocks a plane (NCHW) or an (image, group)
};

// the g of the backward: dout, masked in the residual mode by the saved
// output's sign
template <int M, typename A>
__device__ __forceinline__ A masked(A dy, A o) {
  if constexpr (M == RESIDUAL) return o > A(0) ? dy : A(0);
  return dy;
}

// loads an operand a reduction's thread issues before its adds: K10a reads
// one operand, K11a two or three
template <bool GRAD>
__host__ __device__ constexpr int loads() {
  return GRAD ? LOADS : 2 * LOADS;
}

// a reduction's term: x (K10a) or cdt(g * x) (K11a), in f64
template <typename T, int M, bool GRAD>
__device__ __forceinline__ double term(Acc<T> x, Acc<T> dy, Acc<T> o) {
  if constexpr (GRAD) return round_to<T>(mul_rn(masked<M>(dy, o), x));
  return x;
}

template <typename A>
__device__ __forceinline__ A neg_inf() {
  return (A)__longlong_as_double(0xfff0000000000000ULL);
}

// (m, n) merged with (m2, n2): the larger max, and the counts of the
// positions equal to it (exact and commutative: any order gives the same
// pair; (-inf, 0) is its identity)
template <typename A>
__device__ __forceinline__ void merge(A& m, int& n, A m2, int n2) {
  if (m2 > m) {
    m = m2;
    n = n2;
  } else if (m2 == m) {
    n += n2;
  }
}

// thread 0 gets the block's (max, count) merged over its threads
template <typename A>
__device__ __forceinline__ void block_max(A& m, int& n) {
  __shared__ A pm[WARPS];
  __shared__ int pn[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const A m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const int n2 = __shfl_xor_sync(0xffffffffu, n, o);
    merge(m, n, m2, n2);
  }
  if (threadIdx.x % 32 == 0) {
    pm[threadIdx.x / 32] = m;
    pn[threadIdx.x / 32] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < WARPS; ++k) merge(m, n, pm[k], pn[k]);
  }
}

// thread 0 gets the block's total of u, summed in a fixed order
__device__ __forceinline__ double block_sum(double u) {
  __shared__ double part[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = u;
  __syncthreads();
  if (threadIdx.x == 0) {
    u = part[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) u += part[k];
  }
  return u;
}

// ---------------------------------------------------------------------------
// NCHW
// ---------------------------------------------------------------------------

// K10a / K11a: block (plane blockIdx.x, slice blockIdx.y) sums the elements
// [y per, (y + 1) per) of the plane
template <typename T, int V, int M, bool GRAD>
__global__ void __launch_bounds__(THREADS) se_reduce_nchw(Site s) {
  using A = Acc<T>;
  const long long p = blockIdx.x;
  const long long beg = (long long)blockIdx.y * s.per;
  const long long end = min(s.HW, beg + s.per);
  const long long base = p * s.HW;
  const T* x = static_cast<const T*>(s.x) + base;
  const T* dy = static_cast<const T*>(s.dy) + base;
  const T* x3 = static_cast<const T*>(s.x3) + base;
  constexpr long long STEP = (long long)THREADS * V;
  constexpr int L = loads<GRAD>();
  double u = 0.0;
  A mv = neg_inf<A>();  // cbam: the max and its count
  int mn = 0;
  for (long long i0 = beg + (long long)threadIdx.x * V; i0 < end;
       i0 += STEP * L) {
    A xv[L][V] = {}, dv[L][V] = {}, ov[L][V] = {};
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const long long i = i0 + k * STEP;
      if (i < end) {
        load<T, V>(x + i, xv[k]);
        if constexpr (GRAD) load<T, V>(dy + i, dv[k]);
        if constexpr (GRAD && M == RESIDUAL) load<T, V>(x3 + i, ov[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < L; ++k) {
      if (i0 + k * STEP >= end) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        u = __dadd_rn(u, term<T, M, GRAD>(xv[k][e], dv[k][e], ov[k][e]));
        if constexpr (M == CBAM) merge(mv, mn, xv[k][e], 1);
      }
    }
  }
  u = block_sum(u);
  if constexpr (M == CBAM) block_max(mv, mn);
  if (gridDim.y == 1) {
    if (threadIdx.x == 0) {
      s.sums[p] = u;
      if constexpr (M == CBAM) {
        static_cast<T*>(s.mx)[p] = from_a<T>(mv);
        s.count[p] = mn;
      }
    }
    return;
  }
  // the partials: the S sums, then (cbam) the S maxes and the S counts
  const long long P = gridDim.x, SP = (long long)gridDim.y * P;
  if (threadIdx.x == 0) {
    s.ws[(long long)blockIdx.y * P + p] = u;
    if constexpr (M == CBAM) {
      s.ws[SP + (long long)blockIdx.y * P + p] = (double)mv;
      s.ws[2 * SP + (long long)blockIdx.y * P + p] = (double)mn;
    }
  }
  if (!arrive_last(s.counters + p, gridDim.y)) return;
  if (threadIdx.x == 0) {
    double t = 0.0;
    A m = neg_inf<A>();
    int n = 0;
    for (unsigned j = 0; j < gridDim.y; ++j) {
      t = __dadd_rn(t, __ldcg(s.ws + (long long)j * P + p));
      if constexpr (M == CBAM)
        merge(m, n, (A)__ldcg(s.ws + SP + (long long)j * P + p),
              (int)__ldcg(s.ws + 2 * SP + (long long)j * P + p));
    }
    s.sums[p] = t;
    if constexpr (M == CBAM) {
      static_cast<T*>(s.mx)[p] = from_a<T>(m);
      s.count[p] = n;
    }
    s.counters[p] = 0;
  }
}

// K10b / K11b: block x = plane * K + chunk over the elements [chunk per,
// (chunk + 1) per) of the plane
template <typename T, int V, int M, bool GRAD>
__global__ void __launch_bounds__(THREADS) se_apply_nchw(Site s) {
  using A = Acc<T>;
  const long long p = blockIdx.x / (unsigned)s.K;
  const long long beg = (long long)(blockIdx.x % (unsigned)s.K) * s.per;
  const long long end = min(s.HW, beg + s.per);
  const long long base = p * s.HW;
  const A gate = to_a<T>(static_cast<const T*>(s.gate)[p]);
  A dt = A(0);
  if constexpr (GRAD) dt = round_to<T>(static_cast<const A*>(s.dtot)[p]);
  // cbam: the max and the tie's share of its cotangent
  A mxv = A(0), tie = A(0);
  if constexpr (M == CBAM) {
    mxv = to_a<T>(static_cast<const T*>(s.mx)[p]);
    tie = round_to<T>(div_rn(to_a<T>(static_cast<const T*>(s.dmax)[p]),
                             round_to<T>((A)s.count[p])));
  }
  const T* in = static_cast<const T*>(GRAD ? s.dy : s.x) + base;
  const T* x3 = static_cast<const T*>(s.x3) + base;
  T* out = static_cast<T*>(s.out) + base;
  T* out2 = static_cast<T*>(s.out2) + base;
#pragma unroll 4
  for (long long i = beg + (long long)threadIdx.x * V; i < end;
       i += (long long)THREADS * V) {
    A v[V], o[V] = {}, g[V];
    load<T, V>(in + i, v);
    if constexpr (M != SCALE) load<T, V>(x3 + i, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (GRAD) {
        g[e] = masked<M>(v[e], o[e]);
        A r = round_to<T>(mul_rn(g[e], gate));
        if constexpr (M == CBAM)
          r = round_to<T>(add_rn(r, o[e] == mxv ? tie : A(0)));
        v[e] = round_to<T>(add_rn(r, dt));
      } else {
        v[e] = round_to<T>(mul_rn(v[e], gate));
        if constexpr (M == RESIDUAL) {
          const A r = round_to<T>(add_rn(v[e], o[e]));
          v[e] = r > A(0) ? r : A(0);
        }
      }
    }
    store<T, V>(out + i, v);
    if constexpr (GRAD && M == RESIDUAL) store<T, V>(out2 + i, g);
  }
}

// ---------------------------------------------------------------------------
// channels-last
// ---------------------------------------------------------------------------

// K10a / K11a: block (image b, channel group, slice blockIdx.y): blockIdx.x
// = b * groups + group; a thread sums V channels of the rows r0, r0 + R,
// ... of the slice's rows [y per, (y + 1) per)
template <typename T, int V, int M, bool GRAD>
__global__ void __launch_bounds__(THREADS) se_reduce_nhwc(Site s) {
  using A = Acc<T>;
  __shared__ double part[THREADS * V];
  // cbam: each thread's maxes and counts
  __shared__ A pmax[M == CBAM ? THREADS * V : 1];
  __shared__ int pcnt[M == CBAM ? THREADS * V : 1];
  const int cvs = s.C / V;  // channel vectors a row
  const int lanes = cvs < LANES ? cvs : LANES;
  const int R = THREADS / lanes;
  const int groups = (cvs + lanes - 1) / lanes;
  const long long b = blockIdx.x / groups;
  const int grp = blockIdx.x % groups;
  const int lane = threadIdx.x % lanes, r0 = threadIdx.x / lanes;
  const int cv = grp * lanes + lane;
  const long long beg = (long long)blockIdx.y * s.per;
  const long long end = min(s.HW, beg + s.per);
  if (r0 < R && cv < cvs) {
    const long long base = b * s.HW * s.C + (long long)cv * V;
    const T* x = static_cast<const T*>(s.x) + base;
    const T* dy = static_cast<const T*>(s.dy) + base;
    const T* x3 = static_cast<const T*>(s.x3) + base;
    constexpr int L = loads<GRAD>();
    double u[V] = {};
    A mv[V];
    int mn[V] = {};
#pragma unroll
    for (int e = 0; e < V; ++e) mv[e] = neg_inf<A>();
    for (long long r = beg + r0; r < end; r += (long long)R * L) {
      A xv[L][V] = {}, dv[L][V] = {}, ov[L][V] = {};
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const long long row = r + (long long)k * R;
        if (row < end) {
          load<T, V>(x + row * s.C, xv[k]);
          if constexpr (GRAD) load<T, V>(dy + row * s.C, dv[k]);
          if constexpr (GRAD && M == RESIDUAL)
            load<T, V>(x3 + row * s.C, ov[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (r + (long long)k * R >= end) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          u[e] = __dadd_rn(u[e],
                           term<T, M, GRAD>(xv[k][e], dv[k][e], ov[k][e]));
          if constexpr (M == CBAM) merge(mv[e], mn[e], xv[k][e], 1);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part[(r0 * lanes + lane) * V + e] = u[e];
      if constexpr (M == CBAM) {
        pmax[(r0 * lanes + lane) * V + e] = mv[e];
        pcnt[(r0 * lanes + lane) * V + e] = mn[e];
      }
    }
  }
  __syncthreads();
  // the group's channels, each summed over the R row lanes in order; the
  // partials: the S sums, then (cbam) the S maxes and the S counts
  const int c0 = grp * lanes * V;
  const int width = min(lanes * V, s.C - c0);
  const long long bc = s.B * s.C, sbc = (long long)gridDim.y * bc;
  const bool one = gridDim.y == 1;
  for (int j = threadIdx.x; j < width; j += THREADS) {
    const long long at = b * s.C + c0 + j;
    double t = 0.0;
    for (int r = 0; r < R; ++r) t = __dadd_rn(t, part[r * lanes * V + j]);
    if (one) s.sums[at] = t;
    else s.ws[blockIdx.y * bc + at] = t;
    if constexpr (M == CBAM) {
      A m = neg_inf<A>();
      int n = 0;
      for (int r = 0; r < R; ++r)
        merge(m, n, pmax[r * lanes * V + j], pcnt[r * lanes * V + j]);
      if (one) {
        static_cast<T*>(s.mx)[at] = from_a<T>(m);
        s.count[at] = n;
      } else {
        s.ws[sbc + blockIdx.y * bc + at] = (double)m;
        s.ws[2 * sbc + blockIdx.y * bc + at] = (double)n;
      }
    }
  }
  if (one || !arrive_last(s.counters + blockIdx.x, gridDim.y)) return;
  for (int j = threadIdx.x; j < width; j += THREADS) {
    const long long at = b * s.C + c0 + j;
    double t = 0.0;
    A m = neg_inf<A>();
    int n = 0;
    for (unsigned k = 0; k < gridDim.y; ++k) {
      t = __dadd_rn(t, __ldcg(s.ws + k * bc + at));
      if constexpr (M == CBAM)
        merge(m, n, (A)__ldcg(s.ws + sbc + k * bc + at),
              (int)__ldcg(s.ws + 2 * sbc + k * bc + at));
    }
    s.sums[at] = t;
    if constexpr (M == CBAM) {
      static_cast<T*>(s.mx)[at] = from_a<T>(m);
      s.count[at] = n;
    }
  }
  if (threadIdx.x == 0) s.counters[blockIdx.x] = 0;
}

// K10b / K11b: block x = (b * groups + group) * K + chunk; a thread owns V
// channels (up to THREADS channel vectors a block) of the rows r0, r0 + R,
// ... of the chunk's rows [chunk per, (chunk + 1) per)
template <typename T, int V, int M, bool GRAD>
__global__ void __launch_bounds__(THREADS) se_apply_nhwc(Site s) {
  using A = Acc<T>;
  const int cvs = s.C / V;
  const int lanes = cvs < THREADS ? cvs : THREADS;
  const int R = THREADS / lanes;
  const int groups = (cvs + lanes - 1) / lanes;
  const unsigned bg = blockIdx.x / (unsigned)s.K;
  const long long b = bg / groups;
  const int grp = bg % groups;
  const int lane = threadIdx.x % lanes, r0 = threadIdx.x / lanes;
  const int cv = grp * lanes + lane;
  if (r0 >= R || cv >= cvs) return;
  const long long beg = (long long)(blockIdx.x % (unsigned)s.K) * s.per;
  const long long end = min(s.HW, beg + s.per);
  const long long ch = b * s.C + (long long)cv * V;  // the gate's index
  A gate[V], dt[V], mxv[V], tie[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    gate[e] = to_a<T>(static_cast<const T*>(s.gate)[ch + e]);
    dt[e] = mxv[e] = tie[e] = A(0);
    if constexpr (GRAD) dt[e] = round_to<T>(static_cast<const A*>(s.dtot)[ch + e]);
    if constexpr (M == CBAM) {
      mxv[e] = to_a<T>(static_cast<const T*>(s.mx)[ch + e]);
      tie[e] = round_to<T>(
          div_rn(to_a<T>(static_cast<const T*>(s.dmax)[ch + e]),
                 round_to<T>((A)s.count[ch + e])));
    }
  }
  const long long base = b * s.HW * s.C + (long long)cv * V;
  const T* in = static_cast<const T*>(GRAD ? s.dy : s.x) + base;
  const T* x3 = static_cast<const T*>(s.x3) + base;
  T* out = static_cast<T*>(s.out) + base;
  T* out2 = static_cast<T*>(s.out2) + base;
#pragma unroll 4
  for (long long r = beg + r0; r < end; r += R) {
    const long long e0 = r * s.C;
    A v[V], o[V] = {}, g[V];
    load<T, V>(in + e0, v);
    if constexpr (M != SCALE) load<T, V>(x3 + e0, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (GRAD) {
        g[e] = masked<M>(v[e], o[e]);
        A q = round_to<T>(mul_rn(g[e], gate[e]));
        if constexpr (M == CBAM)
          q = round_to<T>(add_rn(q, o[e] == mxv[e] ? tie[e] : A(0)));
        v[e] = round_to<T>(add_rn(q, dt[e]));
      } else {
        v[e] = round_to<T>(mul_rn(v[e], gate[e]));
        if constexpr (M == RESIDUAL) {
          const A q = round_to<T>(add_rn(v[e], o[e]));
          v[e] = q > A(0) ? q : A(0);
        }
      }
    }
    store<T, V>(out + e0, v);
    if constexpr (GRAD && M == RESIDUAL) store<T, V>(out2 + e0, g);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// groups of channel vectors a block: a reduction's LANES, an apply's
// THREADS
int groups_of(const Site& s, int V, int width) {
  const int cvs = s.C / V;
  const int lanes = cvs < width ? cvs : width;
  return (cvs + lanes - 1) / lanes;
}

template <typename T, int V, int M, bool GRAD>
cudaError_t reduce_as(const Site& s, int layout, int S, cudaStream_t st) {
  const long long x = layout == 0 ? s.B * s.C : s.B * groups_of(s, V, LANES);
  if (x > 0x7fffffffLL || S > 65535) return cudaErrorInvalidValue;
  const dim3 g((unsigned)x, (unsigned)S);
  if (layout == 0)
    se_reduce_nchw<T, V, M, GRAD><<<g, THREADS, 0, st>>>(s);
  else
    se_reduce_nhwc<T, V, M, GRAD><<<g, THREADS, 0, st>>>(s);
  return cudaGetLastError();
}

template <typename T, int V, int M, bool GRAD>
cudaError_t apply_as(const Site& s, int layout, cudaStream_t st) {
  const long long x =
      (layout == 0 ? s.B * s.C : s.B * groups_of(s, V, THREADS)) * s.K;
  if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (layout == 0)
    se_apply_nchw<T, V, M, GRAD><<<(unsigned)x, THREADS, 0, st>>>(s);
  else
    se_apply_nhwc<T, V, M, GRAD><<<(unsigned)x, THREADS, 0, st>>>(s);
  return cudaGetLastError();
}

template <int M, bool GRAD>
cudaError_t reduce_typed(const Site& s, int dtype, int layout, int vec,
                         int S, cudaStream_t st) {
  switch (dtype) {
    case BF16:
      return vec ? reduce_as<bf, 8, M, GRAD>(s, layout, S, st)
                 : reduce_as<bf, 1, M, GRAD>(s, layout, S, st);
    case F32:
      return vec ? reduce_as<float, 4, M, GRAD>(s, layout, S, st)
                 : reduce_as<float, 1, M, GRAD>(s, layout, S, st);
    case F64:
      return vec ? reduce_as<double, 2, M, GRAD>(s, layout, S, st)
                 : reduce_as<double, 1, M, GRAD>(s, layout, S, st);
  }
  return cudaErrorInvalidValue;
}

template <int M, bool GRAD>
cudaError_t apply_typed(const Site& s, int dtype, int layout, int vec,
                        cudaStream_t st) {
  switch (dtype) {
    case BF16:
      return vec ? apply_as<bf, 8, M, GRAD>(s, layout, st)
                 : apply_as<bf, 1, M, GRAD>(s, layout, st);
    case F32:
      return vec ? apply_as<float, 4, M, GRAD>(s, layout, st)
                 : apply_as<float, 1, M, GRAD>(s, layout, st);
    case F64:
      return vec ? apply_as<double, 2, M, GRAD>(s, layout, st)
                 : apply_as<double, 1, M, GRAD>(s, layout, st);
  }
  return cudaErrorInvalidValue;
}

Site site_of(long long B, long long HW, int C, long long per) {
  Site s = {};
  s.B = B;
  s.HW = HW;
  s.C = C;
  s.per = per;
  s.K = 1;
  return s;
}

bool bad(long long B, long long HW, int C, long long per, int layout,
         int mode) {
  return B < 1 || HW < 0 || C < 1 || per < 1 || layout < 0 || layout > 1 ||
         mode < SCALE || mode > CBAM;
}

// an image-sized operand p given exactly in the modes that read it, `in`
// (an empty slab's tensors have no storage: any pointer then)
bool bad_operand(bool in, const void* p, long long HW) {
  return HW > 0 && (in != (p != nullptr));
}

// a (B, C) vector of the cbam mode given exactly in that mode
bool bad_vector(int mode, const void* p) {
  return (mode == CBAM) != (p != nullptr);
}

cudaStream_t as_stream(void* stream) {
  return reinterpret_cast<cudaStream_t>(stream);
}

}  // namespace

// Every entry point: x (and dout, idn, the saved out) (B, C, H, W) of
// dtype 0 f32, 1 bf16 or 2 f64 in NCHW (layout 0) or channels-last (layout
// 1) memory, HW = H * W; vec != 0 takes 16-byte vectors (the wrapper checks
// the sizes and the alignment); mode 0 scale, 1 residual, 2 cbam; per and
// S (the reductions' slices) or K (the applies' blocks a plane or group)
// from the wrapper's plan; the sums (B, C) f64, the gate, the max and its
// cotangent (B, C) cdt, the count (B, C) int32, dtot (B, C) acc; ws ((S,
// B, C) f64 when S > 1, (3 S, B, C) in the cbam mode) and counters (zero,
// one a plane or group) from the wrapper's cached workspace.

// K10a: sums[b, c] = sum over H, W of x; cbam: also its max mx[b, c] and
// the positions equal to it, count[b, c]
extern "C" int insarseg_se_squeeze(const void* x, void* ws, void* counters,
                                   void* sums, void* mx, void* count,
                                   long long B, long long HW, int C, int S,
                                   long long per, int dtype, int layout,
                                   int vec, int mode, void* stream) {
  if (bad(B, HW, C, per, layout, mode) || S < 1 || bad_vector(mode, mx) ||
      bad_vector(mode, count))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, per);
  s.x = x;
  s.ws = static_cast<double*>(ws);
  s.counters = static_cast<unsigned*>(counters);
  s.sums = static_cast<double*>(sums);
  s.mx = mx;
  s.count = static_cast<int*>(count);
  const cudaStream_t st = as_stream(stream);
  return mode == CBAM
             ? (int)reduce_typed<CBAM, false>(s, dtype, layout, vec, S, st)
             : (int)reduce_typed<SCALE, false>(s, dtype, layout, vec, S, st);
}

// K10b: out = cdt(x * gate), residual: relu(cdt(that + idn)) (cbam: the
// scale code)
extern "C" int insarseg_se_excite(const void* x, const void* gate,
                                  const void* idn, void* out, long long B,
                                  long long HW, int C, int K, long long per,
                                  int dtype, int layout, int vec, int mode,
                                  void* stream) {
  if (bad(B, HW, C, per, layout, mode) || K < 1 ||
      bad_operand(mode == RESIDUAL, idn, HW))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, per);
  s.x = x;
  s.x3 = idn;
  s.gate = gate;
  s.out = out;
  s.K = K;
  const cudaStream_t st = as_stream(stream);
  return mode == RESIDUAL
             ? (int)apply_typed<RESIDUAL, false>(s, dtype, layout, vec, st)
             : (int)apply_typed<SCALE, false>(s, dtype, layout, vec, st);
}

// K11a: gsum[b, c] = sum over H, W of cdt(g * x); o the saved output
// (residual; cbam: the scale code)
extern "C" int insarseg_se_grad_stats(const void* dy, const void* x,
                                      const void* o, void* ws,
                                      void* counters, void* gsum,
                                      long long B, long long HW, int C,
                                      int S, long long per, int dtype,
                                      int layout, int vec, int mode,
                                      void* stream) {
  if (bad(B, HW, C, per, layout, mode) || S < 1 ||
      bad_operand(mode == RESIDUAL, o, HW))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, per);
  s.x = x;
  s.dy = dy;
  s.x3 = o;
  s.ws = static_cast<double*>(ws);
  s.counters = static_cast<unsigned*>(counters);
  s.sums = static_cast<double*>(gsum);
  const cudaStream_t st = as_stream(stream);
  return mode == RESIDUAL
             ? (int)reduce_typed<RESIDUAL, true>(s, dtype, layout, vec, S, st)
             : (int)reduce_typed<SCALE, true>(s, dtype, layout, vec, S, st);
}

// K11b: dx = cdt(cdt(g * gate) + cdt(dtot)); residual: didn = g, o the
// saved output; cbam: the max's term added before dtot's, o the site's x,
// mx and count K10a's, dmax the max's cotangent
extern "C" int insarseg_se_grad_apply(const void* dy, const void* o,
                                      const void* gate, const void* dtot,
                                      const void* mx, const void* count,
                                      const void* dmax, void* dx, void* didn,
                                      long long B, long long HW, int C,
                                      int K, long long per, int dtype,
                                      int layout, int vec, int mode,
                                      void* stream) {
  if (bad(B, HW, C, per, layout, mode) || K < 1 ||
      bad_operand(mode != SCALE, o, HW) ||
      bad_operand(mode == RESIDUAL, didn, HW) || bad_vector(mode, mx) ||
      bad_vector(mode, count) || bad_vector(mode, dmax))
    return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, per);
  s.dy = dy;
  s.x3 = o;
  s.gate = gate;
  s.dtot = dtot;
  s.mx = const_cast<void*>(mx);
  s.count = static_cast<int*>(const_cast<void*>(count));
  s.dmax = dmax;
  s.out = dx;
  s.out2 = didn;
  s.K = K;
  const cudaStream_t st = as_stream(stream);
  switch (mode) {
    case RESIDUAL:
      return (int)apply_typed<RESIDUAL, true>(s, dtype, layout, vec, st);
    case CBAM:
      return (int)apply_typed<CBAM, true>(s, dtype, layout, vec, st);
  }
  return (int)apply_typed<SCALE, true>(s, dtype, layout, vec, st);
}
