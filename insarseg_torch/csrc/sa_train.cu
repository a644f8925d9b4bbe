// K12a sa_pool, K12b sa_apply, K13a sa_grad_stats and K13b sa_grad_apply:
// the spatial-attention gate in train mode, forward and backward.
//
// Replaces the XLA:TPU fusions around the gate of the JAX package's train
// step: the channel mean and max (jnp.mean / jnp.max over C, one reduce
// fusion; insarseg/ops/blocks.py:152-154, :173-175), the per-pixel rescale
// by the gate (one loop fusion; :156, :184), and their autodiff. The
// middle between them (SpatialAttentionDC's DoubleConv(2 -> 1), whose
// BatchNorms run on K8a-K9b; SpatialAttentionConv's 7x7 or 3x3 conv) and
// the sigmoid stay the caller's. With cdt the compute dtype (bf16, f32 or
// f64) and acc = promote(cdt, f32), for each pixel (b, h, w):
//   K12a  m[b, 0] = cdt(acc(sum over C of x / C)), the sum in f64,
//         m[b, 1] = max over C of x, count = the channels equal to it
//                                      read x; write m (B, 2, H, W), count
//   K12b  out = cdt(x * gate[b, h, w])            read x; write out
//   K13a  gsum = sum over C of cdt(dout * x), in f64: the gate's cotangent
//                                                  read dout, x
//   K13b  dx = cdt(cdt(cdt(dout * gate) + cdt(dmax * hit)) + dmean), with
//         dmean = cdt(acc(dm[b, 0]) / C), dmax = cdt(acc(dm[b, 1]) /
//         acc(cdt(count))), hit = 1 where x equals the max, else 0: the
//         JAX VJP's three cotangents of x (the rescale's, the max's with
//         its ties split equally, the mean's) added in its order
//                                      read dout, x; write dx
// dm (B, 2, H, W) is the middle's input cotangent. Each product, quotient
// and sum of the element formulas is one rounding (__fmul_rn, __fdiv_rn,
// __fadd_rn and their f64 forms, no contraction into an FMA), in the order
// of the plain versions (kernels/sa_train.py). The sums are taken in f64:
// a bf16 or f32 term is exact there, so a kernel's order and its plain
// version's agree to ~1e-16 of the sum. The max and its count are exact.
//
// Bound on an H100 SXM: pure bandwidth. Per site K12a reads x once, K12b
// reads x and writes out, K13a reads dout and x, K13b reads dout and x and
// writes dx: 8 passes over (B, C, H, W); the per-pixel maps are 1/C of it.
//
// Design (each block owns whole pixels: no second pass, no atomics, a
// fixed order taken from the shape):
//   - NCHW: a thread owns V adjacent pixels (one 16-byte vector: 8 bf16, 4
//     f32 or 2 f64; one pixel where H W is not a whole number of vectors
//     or a pointer is not aligned) and walks a slice of the channels, S
//     slices a pixel group (the plan: enough threads to keep the card's
//     memory busy when the map is small and C large). A block holds 256 /
//     S pixel groups x S slices; the reductions add the slices' partials
//     in slice order through shared memory.
//   - channels-last: L lanes (a power of two up to a warp, each with UNROLL
//     channel vectors or more where C allows) own a pixel and walk its
//     channel vectors lane, lane + L, ...; the reductions finish with an
//     xor shuffle tree over the L lanes, a fixed order.
//   - Each thread keeps UNROLL vectors an operand in flight before it uses
//     them. The applies (K12b, K13b) read the per-pixel values once a
//     thread and walk the channels the same way.
//   - Tensors with no pixel (a spatial mesh's slab of 0 rows) launch
//     nothing: the wrapper returns their empty results.
//   - The kernels' names (sa_reduce_* <..., GRAD>, sa_apply_* <..., GRAD>)
//     tell K12a / K13a and K12b / K13b apart in a profiler's trace.

#include "train_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // vectors an operand a thread loads before use

// The pointers and numbers of one site.
struct Site {
  const void* x;    // the gated map (cdt)
  const void* dy;   // the gradient of the site's output (cdt)
  const void* gate; // (B, H W) cdt
  const void* m;    // K13b: K12a's (B, 2, H W) cdt, the max in plane 1
  const void* dm;   // K13b: (B, 2, H W) cdt, the middle's input cotangent
  const int* cnt;   // K13b: (B, H W) the max's ties
  void* out;        // K12b's output, K13b's dx (cdt); K12a's m
  int* cnt_out;     // K12a's count (B, H W)
  double* sums;     // K13a's (B, H W) f64
  long long B, HW;  // images, pixels an image
  int C;            // channels
  int S;            // NCHW: channel slices a pixel group; NHWC: lanes a pixel
};

// a pixel's running reduction: the f64 sum of its terms and (K12a) the
// max and the number of channels equal to it
template <typename A>
struct Red {
  double s;
  A mx;
  int n;
};

template <typename A>
__device__ __forceinline__ Red<A> red_init() {
  return {0.0, A(__int_as_float(int(0xff800000u))), 0};  // -inf
}

// K12a's term x, or K13a's cdt(dout * x)
template <typename T, bool GRAD>
__device__ __forceinline__ void add_term(Red<Acc<T>>& r, Acc<T> x,
                                         Acc<T> dy) {
  if constexpr (GRAD) {
    r.s = __dadd_rn(r.s, round_to<T>(mul_rn(x, dy)));
  } else {
    r.s = __dadd_rn(r.s, x);
    if (x > r.mx) {
      r.mx = x;
      r.n = 1;
    } else if (x == r.mx) {
      ++r.n;
    }
  }
}

// a then b: the sums in that order; the max and its ties exact
template <typename A, bool GRAD>
__device__ __forceinline__ Red<A> merge(const Red<A>& a, const Red<A>& b) {
  Red<A> r;
  r.s = __dadd_rn(a.s, b.s);
  if constexpr (!GRAD) {
    r.mx = a.mx > b.mx ? a.mx : b.mx;
    r.n = (a.mx == r.mx ? a.n : 0) + (b.mx == r.mx ? b.n : 0);
  }
  return r;
}

// pixel p (of image b) of a reduction: K12a's m and count, or K13a's sum
template <typename T, bool GRAD>
__device__ __forceinline__ void put(const Site& s, long long b, long long p,
                                    const Red<Acc<T>>& r) {
  using A = Acc<T>;
  if constexpr (GRAD) {
    s.sums[b * s.HW + p] = r.s;
  } else {
    T* m = static_cast<T*>(s.out) + 2 * b * s.HW + p;
    m[0] = from_a<T>(A(__ddiv_rn(r.s, double(s.C))));
    m[s.HW] = from_a<T>(r.mx);
    s.cnt_out[b * s.HW + p] = r.n;
  }
}

// the per-pixel values of an apply: the gate and (K13b) the max, the
// max's and the mean's cotangent terms
template <typename T, bool GRAD>
struct Pixel {
  Acc<T> gate, mx, dmax, dmean;
};

template <typename T, bool GRAD>
__device__ __forceinline__ Pixel<T, GRAD> pixel(const Site& s, long long b,
                                                long long p) {
  using A = Acc<T>;
  Pixel<T, GRAD> v;
  v.gate = to_a<T>(static_cast<const T*>(s.gate)[b * s.HW + p]);
  if constexpr (GRAD) {
    const long long k = 2 * b * s.HW + p;
    const T* m = static_cast<const T*>(s.m);
    const T* dm = static_cast<const T*>(s.dm);
    v.mx = to_a<T>(m[k + s.HW]);
    v.dmean = round_to<T>(div_rn(to_a<T>(dm[k]), A(s.C)));
    v.dmax = round_to<T>(div_rn(to_a<T>(dm[k + s.HW]),
                                round_to<T>(A(s.cnt[b * s.HW + p]))));
  }
  return v;
}

// K12b's output element, or K13b's dx element (x the gated map's)
template <typename T, bool GRAD>
__device__ __forceinline__ Acc<T> applied(const Pixel<T, GRAD>& v,
                                          Acc<T> in, Acc<T> x) {
  using A = Acc<T>;
  if constexpr (GRAD) {
    const A hit = x == v.mx ? A(1) : A(0);
    const A t = round_to<T>(add_rn(round_to<T>(mul_rn(in, v.gate)),
                                   round_to<T>(mul_rn(v.dmax, hit))));
    return round_to<T>(add_rn(t, v.dmean));
  } else {
    return round_to<T>(mul_rn(in, v.gate));
  }
}

// ---------------------------------------------------------------------------
// NCHW: thread (pixel group gi, slice sl) of a block of G = THREADS / S
// groups; group q = blockIdx.x * G + gi holds the V pixels [p0, p0 + V) of
// image b, the slice the channels [c0, c1)
// ---------------------------------------------------------------------------

struct Nchw {
  int G, gi, sl, c0, c1;
  long long groups, q, b, p0;
  bool live;
};

template <int V>
__device__ __forceinline__ Nchw nchw(const Site& s) {
  Nchw t;
  t.G = THREADS / s.S;
  t.gi = threadIdx.x % t.G;
  t.sl = threadIdx.x / t.G;
  t.groups = s.HW / V;
  t.q = (long long)blockIdx.x * t.G + t.gi;
  t.live = t.q < s.B * t.groups;
  t.b = t.q / t.groups;
  t.p0 = (t.q % t.groups) * V;
  const int cs = (s.C + s.S - 1) / s.S;
  t.c0 = min(s.C, t.sl * cs);
  t.c1 = min(s.C, t.c0 + cs);
  return t;
}

// K12a / K13a
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(THREADS) sa_reduce_nchw(Site s) {
  using A = Acc<T>;
  __shared__ double ps[THREADS * V];
  __shared__ A pm[GRAD ? 1 : THREADS * V];
  __shared__ int pn[GRAD ? 1 : THREADS * V];
  const Nchw t = nchw<V>(s);
  Red<A> r[V];
#pragma unroll
  for (int e = 0; e < V; ++e) r[e] = red_init<A>();
  if (t.live) {
    const long long off = t.b * s.C * s.HW + t.p0;
    const T* x = static_cast<const T*>(s.x) + off;
    const T* dy = static_cast<const T*>(s.dy) + off;
    for (int c = t.c0; c < t.c1; c += UNROLL) {
      A xv[UNROLL][V] = {}, dv[UNROLL][V] = {};
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (c + k < t.c1) {
          load<T, V>(x + (long long)(c + k) * s.HW, xv[k]);
          if constexpr (GRAD) load<T, V>(dy + (long long)(c + k) * s.HW, dv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (c + k >= t.c1) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
          add_term<T, GRAD>(r[e], xv[k][e], dv[k][e]);
      }
    }
  }
  // part [slice][group * V + e] is thread (slice, group)'s pixel e
#pragma unroll
  for (int e = 0; e < V; ++e) {
    ps[threadIdx.x * V + e] = r[e].s;
    if constexpr (!GRAD) {
      pm[threadIdx.x * V + e] = r[e].mx;
      pn[threadIdx.x * V + e] = r[e].n;
    }
  }
  __syncthreads();
  const int width = t.G * V;
  for (int j = threadIdx.x; j < width; j += THREADS) {
    const long long q = (long long)blockIdx.x * t.G + j / V;
    if (q >= s.B * t.groups) continue;
    Red<A> tot = red_init<A>();
    for (int k = 0; k < s.S; ++k) {
      Red<A> part;
      part.s = ps[k * width + j];
      if constexpr (!GRAD) {
        part.mx = pm[k * width + j];
        part.n = pn[k * width + j];
      }
      tot = k ? merge<A, GRAD>(tot, part) : part;
    }
    put<T, GRAD>(s, q / t.groups, (q % t.groups) * V + j % V, tot);
  }
}

// K12b / K13b
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(THREADS) sa_apply_nchw(Site s) {
  using A = Acc<T>;
  const Nchw t = nchw<V>(s);
  if (!t.live) return;
  Pixel<T, GRAD> px[V];
#pragma unroll
  for (int e = 0; e < V; ++e) px[e] = pixel<T, GRAD>(s, t.b, t.p0 + e);
  const long long off = t.b * s.C * s.HW + t.p0;
  const T* in = static_cast<const T*>(GRAD ? s.dy : s.x) + off;
  const T* x = static_cast<const T*>(s.x) + off;
  T* out = static_cast<T*>(s.out) + off;
  for (int c = t.c0; c < t.c1; c += UNROLL) {
    A iv[UNROLL][V] = {}, xv[UNROLL][V] = {};
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (c + k < t.c1) {
        load<T, V>(in + (long long)(c + k) * s.HW, iv[k]);
        if constexpr (GRAD) load<T, V>(x + (long long)(c + k) * s.HW, xv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (c + k >= t.c1) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        iv[k][e] = applied<T, GRAD>(px[e], iv[k][e], xv[k][e]);
      store<T, V>(out + (long long)(c + k) * s.HW, iv[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// channels-last: lane (of L = S) of pixel q = blockIdx.x * (THREADS / L) +
// threadIdx.x / L, over the image rows of C channels, V to a vector
// ---------------------------------------------------------------------------

// K12a / K13a
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(THREADS) sa_reduce_nhwc(Site s) {
  using A = Acc<T>;
  const int L = s.S;
  const int lane = threadIdx.x % L;
  const long long q = (long long)blockIdx.x * (THREADS / L) + threadIdx.x / L;
  const bool live = q < s.B * s.HW;
  const int cvs = s.C / V;
  Red<A> r = red_init<A>();
  if (live) {
    const T* x = static_cast<const T*>(s.x) + q * s.C;
    const T* dy = static_cast<const T*>(s.dy) + q * s.C;
    for (int cv = lane; cv < cvs; cv += L * UNROLL) {
      A xv[UNROLL][V] = {}, dv[UNROLL][V] = {};
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int v = cv + k * L;
        if (v < cvs) {
          load<T, V>(x + (long long)v * V, xv[k]);
          if constexpr (GRAD) load<T, V>(dy + (long long)v * V, dv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (cv + k * L >= cvs) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
          add_term<T, GRAD>(r, xv[k][e], dv[k][e]);
      }
    }
  }
  // the L lanes of a pixel: an xor tree (every lane of the warp takes part)
  for (int o = L / 2; o > 0; o >>= 1) {
    Red<A> u;
    u.s = __shfl_xor_sync(0xffffffffu, r.s, o);
    if constexpr (!GRAD) {
      u.mx = __shfl_xor_sync(0xffffffffu, r.mx, o);
      u.n = __shfl_xor_sync(0xffffffffu, r.n, o);
    }
    r = (lane & o) ? merge<A, GRAD>(u, r) : merge<A, GRAD>(r, u);
  }
  if (live && lane == 0) put<T, GRAD>(s, q / s.HW, q % s.HW, r);
}

// K12b / K13b
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(THREADS) sa_apply_nhwc(Site s) {
  using A = Acc<T>;
  const int L = s.S;
  const int lane = threadIdx.x % L;
  const long long q = (long long)blockIdx.x * (THREADS / L) + threadIdx.x / L;
  if (q >= s.B * s.HW) return;
  const int cvs = s.C / V;
  const Pixel<T, GRAD> px = pixel<T, GRAD>(s, q / s.HW, q % s.HW);
  const T* in = static_cast<const T*>(GRAD ? s.dy : s.x) + q * s.C;
  const T* x = static_cast<const T*>(s.x) + q * s.C;
  T* out = static_cast<T*>(s.out) + q * s.C;
  for (int cv = lane; cv < cvs; cv += L * UNROLL) {
    A iv[UNROLL][V] = {}, xv[UNROLL][V] = {};
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int v = cv + k * L;
      if (v < cvs) {
        load<T, V>(in + (long long)v * V, iv[k]);
        if constexpr (GRAD) load<T, V>(x + (long long)v * V, xv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int v = cv + k * L;
      if (v >= cvs) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        iv[k][e] = applied<T, GRAD>(px, iv[k][e], xv[k][e]);
      store<T, V>(out + (long long)v * V, iv[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int V, bool REDUCE, bool GRAD>
cudaError_t launch_as(const Site& s, int layout, cudaStream_t st) {
  const long long units = layout == 0 ? s.B * (s.HW / V) : s.B * s.HW;
  const long long per = THREADS / s.S;  // pixel groups or pixels a block
  const long long blocks = (units + per - 1) / per;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned g = (unsigned)blocks;
  if (layout == 0) {
    if constexpr (REDUCE)
      sa_reduce_nchw<T, V, GRAD><<<g, THREADS, 0, st>>>(s);
    else
      sa_apply_nchw<T, V, GRAD><<<g, THREADS, 0, st>>>(s);
  } else {
    if constexpr (REDUCE)
      sa_reduce_nhwc<T, V, GRAD><<<g, THREADS, 0, st>>>(s);
    else
      sa_apply_nhwc<T, V, GRAD><<<g, THREADS, 0, st>>>(s);
  }
  return cudaGetLastError();
}

template <bool REDUCE, bool GRAD>
cudaError_t launch_typed(const Site& s, int dtype, int layout, int vec,
                         cudaStream_t st) {
  switch (dtype) {
    case BF16:
      return vec ? launch_as<bf, 8, REDUCE, GRAD>(s, layout, st)
                 : launch_as<bf, 1, REDUCE, GRAD>(s, layout, st);
    case F32:
      return vec ? launch_as<float, 4, REDUCE, GRAD>(s, layout, st)
                 : launch_as<float, 1, REDUCE, GRAD>(s, layout, st);
    case F64:
      return vec ? launch_as<double, 2, REDUCE, GRAD>(s, layout, st)
                 : launch_as<double, 1, REDUCE, GRAD>(s, layout, st);
  }
  return cudaErrorInvalidValue;
}

// the sizes, the plan and the vectors: a power-of-two S (NCHW slices up
// to 64, channels-last lanes up to a warp and no more than the channel
// vectors), and vectors only where a plane (NCHW) or a pixel's row
// (channels-last) is a whole number of them
bool bad(long long B, long long HW, int C, int S, int dtype, int layout,
         int vec) {
  if (B < 1 || HW < 1 || C < 1 || S < 1 || (S & (S - 1)) || layout < 0 ||
      layout > 1 || dtype < F32 || dtype > F64)
    return true;
  const int V = vec ? 16 / (dtype == BF16 ? 2 : dtype == F32 ? 4 : 8) : 1;
  if (layout == 0) return S > 64 || HW % V != 0;
  return S > 32 || C % V != 0 || S > C / V;
}

Site site_of(long long B, long long HW, int C, int S) {
  Site s = {};
  s.B = B;
  s.HW = HW;
  s.C = C;
  s.S = S;
  return s;
}

cudaStream_t as_stream(void* stream) {
  return reinterpret_cast<cudaStream_t>(stream);
}

}  // namespace

// Every entry point: x (and dout, K12b's out, K13b's dx) (B, C, H, W) of
// dtype 0 f32, 1 bf16 or 2 f64 in NCHW (layout 0) or channels-last (layout
// 1) memory, HW = H * W >= 1 (the wrapper launches nothing for an empty
// map); vec != 0 takes 16-byte vectors (the wrapper checks the sizes and
// the alignment); S the plan's slices (NCHW) or lanes (channels-last).
// The per-pixel maps are contiguous: m and dm (B, 2, H, W) cdt, the gate
// (B, H, W) cdt, count (B, H, W) int32, gsum (B, H, W) f64.

// K12a: m = [cdt(mean over C of x), max over C of x], count = its ties
extern "C" int insarseg_sa_pool(const void* x, void* m, void* count,
                                long long B, long long HW, int C, int S,
                                int dtype, int layout, int vec,
                                void* stream) {
  if (bad(B, HW, C, S, dtype, layout, vec)) return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, S);
  s.x = x;
  s.out = m;
  s.cnt_out = static_cast<int*>(count);
  return (int)launch_typed<true, false>(s, dtype, layout, vec,
                                        as_stream(stream));
}

// K12b: out = cdt(x * gate)
extern "C" int insarseg_sa_apply(const void* x, const void* gate, void* out,
                                 long long B, long long HW, int C, int S,
                                 int dtype, int layout, int vec,
                                 void* stream) {
  if (bad(B, HW, C, S, dtype, layout, vec)) return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, S);
  s.x = x;
  s.gate = gate;
  s.out = out;
  return (int)launch_typed<false, false>(s, dtype, layout, vec,
                                         as_stream(stream));
}

// K13a: gsum = sum over C of cdt(dout * x), in f64
extern "C" int insarseg_sa_grad_stats(const void* dy, const void* x,
                                      void* gsum, long long B, long long HW,
                                      int C, int S, int dtype, int layout,
                                      int vec, void* stream) {
  if (bad(B, HW, C, S, dtype, layout, vec)) return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, S);
  s.x = x;
  s.dy = dy;
  s.sums = static_cast<double*>(gsum);
  return (int)launch_typed<true, true>(s, dtype, layout, vec,
                                       as_stream(stream));
}

// K13b: dx = cdt(cdt(cdt(dout * gate) + cdt(dmax * hit)) + dmean)
extern "C" int insarseg_sa_grad_apply(const void* dy, const void* x,
                                      const void* gate, const void* m,
                                      const void* count, const void* dm,
                                      void* dx, long long B, long long HW,
                                      int C, int S, int dtype, int layout,
                                      int vec, void* stream) {
  if (bad(B, HW, C, S, dtype, layout, vec)) return (int)cudaErrorInvalidValue;
  Site s = site_of(B, HW, C, S);
  s.x = x;
  s.dy = dy;
  s.gate = gate;
  s.m = m;
  s.cnt = static_cast<const int*>(count);
  s.dm = dm;
  s.out = dx;
  return (int)launch_typed<false, true>(s, dtype, layout, vec,
                                        as_stream(stream));
}
