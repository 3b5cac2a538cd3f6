// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes). Each library exports `error_string` so the Python wrapper
// can name a non-zero cudaError_t it gets back from a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// max(a, b) that propagates NaN, as jnp.max and torch.amax do (PTX
// max.NaN, sm_80 and later): fmaxf returns the other operand of a NaN, so a
// running max taken with it hides a NaN input. On non-NaN operands the two
// are the same instruction and give the same bits.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmax_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16-byte row pieces (the key split's rows, K3's rows).
// elements of KV in one 16-byte load
template <typename KV>
struct Vec {
  static constexpr int n = 16 / sizeof(KV);
};

// up to 16 bytes of a row from p: `n_valid` elements (<= 0: none, zeros);
// the aligned form needs a 16-byte aligned p and n_valid <= 0 or >= a vector
template <typename KV, bool kAligned>
__device__ __forceinline__ uint4 load_raw(const KV* p, int n_valid) {
  if (n_valid <= 0) return make_uint4(0, 0, 0, 0);
  if (kAligned) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
  if constexpr (sizeof(KV) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n_valid) w[e] = __ldg(reinterpret_cast<const unsigned int*>(p) + e);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_valid)
        w[e / 2] |= static_cast<uint32_t>(__ldg(
                        reinterpret_cast<const unsigned short*>(p) + e))
                    << (16 * (e % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a piece's elements as f32: 4 f32, or 8 bf16 (bf16 -> f32 is exact)
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> f32, exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared-memory addresses and mbarriers (the TMA and bulk-copy pipelines).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
