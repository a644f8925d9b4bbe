// The pieces the train-mode kernels share: K8a-K9b (bn_act.cu),
// K10a-K11b (se_train.cu) and K12a-K13b (sa_train.cu). The codes of the
// compute dtype, its acc type
// (f32, f64 for f64 input), the arithmetic of one rounding an operation
// (no contraction into an FMA), the conversions between the two, 16-byte
// vector loads and stores, and the counter that finds the last block of a
// two-stage reduction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the compute dtype (kernels/_lib.py::DTYPES)
constexpr int F32 = 0, BF16 = 1, F64 = 2;

using bf = __nv_bfloat16;

// the per-channel and element arithmetic's type: f32, f64 for f64 input
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};
template <typename T>
using Acc = typename AccOf<T>::type;

// one rounding each, in A
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T>
__device__ __forceinline__ Acc<T> to_a(T v) {
  return v;
}
template <>
__device__ __forceinline__ float to_a<bf>(bf v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_a(Acc<T> v) {
  return v;
}
template <>
__device__ __forceinline__ bf from_a<bf>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute dtype T, in A
template <typename T>
__device__ __forceinline__ Acc<T> round_to(Acc<T> v) {
  return to_a<T>(from_a<T>(v));
}

// V elements of T from p (16-byte aligned when V > 1)
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p,
                                     Acc<T> (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_a<T>(p[0]);
  } else {
    static_assert(sizeof(T) * V == 16, "one 16-byte vector");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_a<T>(e[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p,
                                      const Acc<T> (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_a<T>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_a<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Whether this block is the last of the `total` blocks that count on
// `counter` (each has written its partials before the call: the fence
// makes them visible before the count, and atomicAdd orders nothing of
// the sums). Every thread of the block calls it and gets the same answer;
// the last block resets the counter when it is done with it.
__device__ __forceinline__ bool arrive_last(unsigned* counter,
                                            unsigned total) {
  __shared__ unsigned ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != total - 1) return false;
  __threadfence();
  return true;
}
