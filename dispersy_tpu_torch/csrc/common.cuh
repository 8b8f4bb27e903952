// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel source is compiled on its own by nvcc into a shared
// library with a plain C interface (kernels/__init__.py loads it with
// ctypes).  Each C entry point launches on the stream it is handed and
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// that was refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// `LAUNCH(k, grid, block, smem, stream)(args...)` instead of the
// triple-chevron form keeps the sources parseable by a host compiler for
// a syntax check; it expands to the usual launch.
#ifndef LAUNCH
#define LAUNCH(k, g, b, s, st) k<<<(g), (b), (s), (st)>>>
#endif

#define DK_EXPORT extern "C" __attribute__((visibility("default")))

namespace dk {

constexpr uint32_t EMPTY_U32 = 0xFFFFFFFFu;
constexpr uint32_t FULL_MASK = 0xFFFFFFFFu;

// murmur3 32-bit finalizer and the seeded hash of ops/hashing.py.
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t hash_u32(uint32_t x,
                                                      uint32_t seed) {
  return fmix32(x ^ fmix32(seed));
}

constexpr uint32_t BLOOM_SEED_1 = 0x8F1BBCDCu;
constexpr uint32_t BLOOM_SEED_2 = 0xCA62C1D6u;
constexpr uint32_t BLOOM_SALT_SEED = 0x6ED9EBA1u;

inline unsigned blocks_for(long long n, int per_block) {
  long long b = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

}  // namespace dk

DK_EXPORT const char* dk_error_string(long long err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
