// The pieces of a Hopper (sm_90a) tensor-core mainloop that K1 / K5a
// (igemm_i8.cuh, int8 wgmma) and K6 (up_i8.cu, bf16 wgmma) share: the
// cp.async ring's copies and the shared-memory tile layout the wgmma
// descriptors name.
//
// Tiles are K-major with 64-byte rows (64 int8 or 32 bf16 values of K) in
// the 64-byte swizzle: the four 16-byte chunks of row r are XORed by
// (r / 2) % 4, so 8-row groups lie 512 bytes apart. One 64-byte chunk is
// one wgmma k32 step in int8 and two k16 steps in bf16; each step's
// descriptor starts 32 bytes further along the row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage (static): every object that includes this compiles its
// own copy. No anonymous namespace here: nvcc's generated launch stubs
// cannot name a kernel in a file's anonymous namespace when a second one
// is in scope through a using-directive.
namespace gmma {

static constexpr int ROW_BYTES = 64;  // a tile row: one K chunk

// byte offset of 16-byte chunk ch (0..3) of row r in a 64-byte-row tile
static __device__ __forceinline__ int swz(int r, int ch) {
  return r * ROW_BYTES + ((ch ^ ((r >> 1) & 3)) << 4);
}

// 16 bytes global -> shared; src_size 0 fills zeros (and reads nothing)
static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src,
                                                  int src_size, bool l1) {
  if (l1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_size)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_size)
                 : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma descriptor of a K-major tile of 64-byte rows in the 64-byte
// swizzle (the layout swz() writes): 8-row groups 512 bytes apart.
static __device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace gmma
