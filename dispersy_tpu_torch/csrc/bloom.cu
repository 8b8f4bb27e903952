// K2 and K6: Bloom build, query and digest update over packed uint32
// bitsets, one source with three entry points.
//
// Replaces dispersy_tpu/ops/bloom.py:196 `bloom_build` and :277
// `bloom_query` (with their gather twins `probe_bits` :91,
// `bloom_build_from` :118 and `bloom_query_from` :174), whose TPU form is
// a compare-and-reduce over the word axis, one pass per hash function,
// and :234 `digest_update` (`digest | bloom_build_from(probes, mask)`, the
// byte-diet store's incremental claim digest).
//
// Bound on the H100: bytes.  The build reads the item hashes and the mask
// and writes W words per row; the digest update reads W words more per
// row; the query reads W words per row and the item hashes and writes one
// bool per item.  The k double-hash probes are a few integer operations
// per item each.
//
// Design.  The item hash, the filter's salt and the double-hashing pair
// (h1, h2 | 1) are derived in registers with the same murmur3 mixing as
// ops/hashing.py, so the [N, M, k] probe tensor never exists.  The salt
// is a pointer and a row stride: stride 0 is one salt for every filter,
// stride 1 one salt per row (the staggered store's per-peer epochs); a
// null pointer is the unsalted filter.  The build and the digest update
// give each row one warp and a W-word bitset in shared memory (zeroed, or
// loaded from the row's digest): lanes walk the row's items and atomicOr
// their k probe bits, then the warp writes the W words.  The query gives
// each item one thread, which reads the k probed words of its row (a
// row-strided view is accepted, so the engine's [N, R, W] request inbox
// and a cohort's block of the digest are queried in place).
#include "common.cuh"

namespace {

constexpr int BUILD_WARPS = 4;
constexpr int MAX_WORDS = 256;

struct Salt {
  const uint32_t* ptr;  // nullptr: unsalted (not the same as salt 0)
  long long stride;     // 0: one salt for all rows; 1: one per row
};

__device__ __forceinline__ void probe_pair(uint32_t item, uint32_t salt_mix,
                                           uint32_t* h1, uint32_t* h2) {
  const uint32_t x = item ^ salt_mix;
  *h1 = dk::hash_u32(x, dk::BLOOM_SEED_1);
  *h2 = dk::hash_u32(x, dk::BLOOM_SEED_2) | 1u;
}

__device__ __forceinline__ uint32_t salt_mix_of(Salt s, long long row) {
  return s.ptr ? dk::hash_u32(s.ptr[row * s.stride], dk::BLOOM_SALT_SEED)
               : 0u;
}

// One warp per row: the bitset starts from `base` (the digest) or zero.
__device__ __forceinline__ void build_row(const uint32_t* base,
                                          const uint32_t* hashes,
                                          const bool* mask, long long n,
                                          int m, int n_bits, int k, Salt salt,
                                          uint32_t* words) {
  __shared__ uint32_t bits[BUILD_WARPS][MAX_WORDS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)BUILD_WARPS + w;
  if (row >= n) return;  // warp-uniform; only warp-level sync below
  const int nw = n_bits >> 5;
  const uint32_t mix = salt_mix_of(salt, row);
  for (int t = lane; t < nw; t += 32)
    bits[w][t] = base ? base[row * nw + t] : 0u;
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

__global__ void dk_build_kernel(const uint32_t* hashes, const bool* mask,
                                long long n, int m, int n_bits, int k,
                                Salt salt, uint32_t* words) {
  build_row(nullptr, hashes, mask, n, m, n_bits, k, salt, words);
}

__global__ void dk_digest_update_kernel(const uint32_t* digest,
                                        const uint32_t* hashes,
                                        const bool* mask, long long n, int m,
                                        int n_bits, int k, Salt salt,
                                        uint32_t* words) {
  build_row(digest, hashes, mask, n, m, n_bits, k, salt, words);
}

__global__ void dk_query_kernel(const uint32_t* words, long long row_stride,
                                const uint32_t* hashes, long long n, int m,
                                int n_bits, int k, Salt salt, bool* out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n * m) return;
  const long long row = i / m;
  const uint32_t* wr = words + row * row_stride;
  uint32_t h1, h2;
  probe_pair(hashes[i], salt_mix_of(salt, row), &h1, &h2);
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = (h1 + static_cast<uint32_t>(j) * h2) %
                       static_cast<uint32_t>(n_bits);
    ok = ok && ((wr[b >> 5] >> (b & 31u)) & 1u);
  }
  out[i] = ok;
}

bool bad_bits(long long n_bits) {
  return n_bits <= 0 || n_bits % 32 || n_bits / 32 > MAX_WORDS;
}

}  // namespace

DK_EXPORT int dk_bloom_build(const uint32_t* hashes, const bool* mask,
                             long long n, long long m, long long n_bits,
                             long long k, const uint32_t* salt,
                             long long salt_stride, uint32_t* words,
                             cudaStream_t stream) {
  if (bad_bits(n_bits)) return cudaErrorInvalidValue;
  LAUNCH(dk_build_kernel, dk::blocks_for(n, BUILD_WARPS), BUILD_WARPS * 32, 0,
         stream)(hashes, mask, n, static_cast<int>(m),
                 static_cast<int>(n_bits), static_cast<int>(k),
                 Salt{salt, salt_stride}, words);
  return static_cast<int>(cudaGetLastError());
}

DK_EXPORT int dk_digest_update(const uint32_t* digest,
                               const uint32_t* hashes, const bool* mask,
                               long long n, long long m, long long n_bits,
                               long long k, const uint32_t* salt,
                               long long salt_stride, uint32_t* words,
                               cudaStream_t stream) {
  if (bad_bits(n_bits)) return cudaErrorInvalidValue;
  LAUNCH(dk_digest_update_kernel, dk::blocks_for(n, BUILD_WARPS),
         BUILD_WARPS * 32, 0, stream)(
      digest, hashes, mask, n, static_cast<int>(m), static_cast<int>(n_bits),
      static_cast<int>(k), Salt{salt, salt_stride}, words);
  return static_cast<int>(cudaGetLastError());
}

DK_EXPORT int dk_bloom_query(const uint32_t* words, long long row_stride,
                             const uint32_t* hashes, long long n, long long m,
                             long long n_bits, long long k,
                             const uint32_t* salt, long long salt_stride,
                             bool* out, cudaStream_t stream) {
  if (n_bits <= 0 || n_bits % 32) return cudaErrorInvalidValue;
  const int tpb = 256;
  LAUNCH(dk_query_kernel, dk::blocks_for(n * m, tpb), tpb, 0, stream)(
      words, row_stride, hashes, n, static_cast<int>(m),
      static_cast<int>(n_bits), static_cast<int>(k), Salt{salt, salt_stride},
      out);
  return static_cast<int>(cudaGetLastError());
}
