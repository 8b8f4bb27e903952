// K2: Bloom build and query over packed uint32 bitsets, one source with two
// entry points.
//
// Replaces dispersy_tpu/ops/bloom.py:196 `bloom_build` and :277
// `bloom_query` (with their gather twins `probe_bits` :91,
// `bloom_build_from` :118 and `bloom_query_from` :174), whose TPU form is
// a compare-and-reduce over the word axis, one pass per hash function.
//
// Bound on the H100: bytes.  The build reads the item hashes and the mask
// and writes W words per row; the query reads W words per row and the
// item hashes and writes one bool per item.  The k double-hash probes are
// a few integer operations per item each.
//
// Design.  The item hash, the per-filter salt and the double-hashing pair
// (h1, h2 | 1) are derived in registers with the same murmur3 mixing as
// ops/hashing.py, so the [N, M, k] probe tensor never exists.  The build
// gives each row one warp and a W-word bitset in shared memory: lanes
// walk the row's items and atomicOr their k probe bits, then the warp
// writes the W words.  The query gives each item one thread, which reads
// the k probed words of its row (a row-strided view is accepted, so the
// engine's [N, R, W] request inbox is queried in place per slot).
#include "common.cuh"

namespace {

constexpr int BUILD_WARPS = 4;
constexpr int MAX_WORDS = 256;

__device__ __forceinline__ void probe_pair(uint32_t item, uint32_t salt_mix,
                                           uint32_t* h1, uint32_t* h2) {
  const uint32_t x = item ^ salt_mix;
  *h1 = dk::hash_u32(x, dk::BLOOM_SEED_1);
  *h2 = dk::hash_u32(x, dk::BLOOM_SEED_2) | 1u;
}

// salt == nullptr is the unsalted filter (not the same as salt 0).
__device__ __forceinline__ uint32_t salt_mix_of(const uint32_t* salt) {
  return salt ? dk::hash_u32(*salt, dk::BLOOM_SALT_SEED) : 0u;
}

__global__ void dk_build_kernel(const uint32_t* hashes, const bool* mask,
                                long long n, int m, int n_bits, int k,
                                const uint32_t* salt, uint32_t* words) {
  __shared__ uint32_t bits[BUILD_WARPS][MAX_WORDS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)BUILD_WARPS + w;
  if (row >= n) return;  // warp-uniform; only warp-level sync below
  const int nw = n_bits >> 5;
  const uint32_t mix = salt_mix_of(salt);
  for (int t = lane; t < nw; t += 32) bits[w][t] = 0u;
  __syncwarp();
  for (int i = lane; i < m; i += 32) {
    const long long at = row * m + i;
    if (!mask[at]) continue;
    uint32_t h1, h2;
    probe_pair(hashes[at], mix, &h1, &h2);
    for (int j = 0; j < k; ++j) {
      const uint32_t b = (h1 + static_cast<uint32_t>(j) * h2) %
                         static_cast<uint32_t>(n_bits);
      atomicOr(&bits[w][b >> 5], 1u << (b & 31u));
    }
  }
  __syncwarp();
  for (int t = lane; t < nw; t += 32) words[row * nw + t] = bits[w][t];
}

__global__ void dk_query_kernel(const uint32_t* words, long long row_stride,
                                const uint32_t* hashes, long long n, int m,
                                int n_bits, int k, const uint32_t* salt,
                                bool* out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n * m) return;
  const uint32_t* wr = words + (i / m) * row_stride;
  uint32_t h1, h2;
  probe_pair(hashes[i], salt_mix_of(salt), &h1, &h2);
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = (h1 + static_cast<uint32_t>(j) * h2) %
                       static_cast<uint32_t>(n_bits);
    ok = ok && ((wr[b >> 5] >> (b & 31u)) & 1u);
  }
  out[i] = ok;
}

}  // namespace

DK_EXPORT int dk_bloom_build(const uint32_t* hashes, const bool* mask,
                             long long n, long long m, long long n_bits,
                             long long k, const uint32_t* salt,
                             uint32_t* words, cudaStream_t stream) {
  if (n_bits <= 0 || n_bits % 32 || n_bits / 32 > MAX_WORDS)
    return cudaErrorInvalidValue;
  LAUNCH(dk_build_kernel, dk::blocks_for(n, BUILD_WARPS), BUILD_WARPS * 32, 0,
         stream)(hashes, mask, n, static_cast<int>(m),
                 static_cast<int>(n_bits), static_cast<int>(k), salt, words);
  return static_cast<int>(cudaGetLastError());
}

DK_EXPORT int dk_bloom_query(const uint32_t* words, long long row_stride,
                             const uint32_t* hashes, long long n, long long m,
                             long long n_bits, long long k,
                             const uint32_t* salt, bool* out,
                             cudaStream_t stream) {
  if (n_bits <= 0 || n_bits % 32) return cudaErrorInvalidValue;
  const int tpb = 256;
  LAUNCH(dk_query_kernel, dk::blocks_for(n * m, tpb), tpb, 0, stream)(
      words, row_stride, hashes, n, static_cast<int>(m),
      static_cast<int>(n_bits), static_cast<int>(k), salt, out);
  return static_cast<int>(cudaGetLastError());
}
