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
// Bound on the H100: the table's bound is by bytes (the build reads the
// item hashes and the mask and writes W words per row; the digest update
// reads W words more per row; the query reads W words per row and the
// item hashes and writes one bool per item), but the work is integer
// hashing: two murmur3 finalizers and k probes an item, each probe a
// remainder and a bit test.  The design keeps that to a few instructions
// a probe.
//
// Design.  A group of G lanes per row (G by M: each lane takes about
// CHUNK vectors of 4 items), R rows a block; the row comes from the block
// and the lane, with no 64-bit division.
//  - The salt is a pointer and a row stride: stride 0 is one salt for
//    every filter, stride 1 one salt per row (the staggered store's
//    per-peer epochs); a null pointer is the unsalted filter.  Each lane
//    mixes its row's salt once into the two seeds, so an item's pair is
//    h1 = fmix32(item ^ c1), h2 = fmix32(item ^ c2) | 1 -- the same
//    murmur3 mixing as ops/hashing.py, as h(item ^ mix(salt), seed).
//  - Probe j is (h1 + j * h2) mod 2^32, advanced by += h2, then mod
//    n_bits by a multiply-high reciprocal that the host computes
//    (kernels.bloom_reciprocal; exact for every u32 numerator).  As
//    n_bits is a multiple of 32, the bit in the word is the numerator's
//    low 5 bits.
//  - The query stages its R rows' W words in shared memory once (the
//    rows may be strided: the request inbox's [N, R, W] slots and a
//    cohort's block of the digest are queried in place), with the
//    lane's first hashes already in flight; an item's k probes are all
//    issued, with no early exit.
//  - The build ORs each masked item's probe bits into the rows' bitsets
//    in shared memory (zeroed, or the digest's words), then writes them
//    out; the block's rows are contiguous, so both copies are flat.
//  - Items, mask bytes and answers move as vectors of 4 when M is a
//    multiple of 4 and the pointers are aligned.
#include "common.cuh"

namespace {

constexpr int MAX_WORDS = 256;     // kernels.BLOOM_MAX_WORDS
constexpr int TPB = 256;           // threads a block at most
constexpr int SMEM_WORDS = 12288;  // staged words a block (48 KB)
constexpr int CHUNK = 3;           // vectors a lane has in flight
constexpr int K_FIXED = 7;         // the hash count the configs derive

struct Salt {
  const uint32_t* ptr;  // nullptr: unsalted (not the same as salt 0)
  long long stride;     // 0: one salt for all rows; 1: one per row
};

// x mod d for every u32 x, from the host's (magic, shift): Granlund and
// Montgomery's round-up reciprocal with its 33-bit correction.
struct Recip {
  uint32_t d, magic;
  int shift;
};

__device__ __forceinline__ uint32_t mod_of(uint32_t x, Recip rc) {
  const uint32_t t = __umulhi(x, rc.magic);
  return x - ((t + ((x - t) >> 1)) >> rc.shift) * rc.d;
}

// The row's two seeds with its salt folded in.
struct Seeds {
  uint32_t c1, c2;
};

__device__ __forceinline__ Seeds seeds_of(Salt s, long long row) {
  const uint32_t mix =
      s.ptr ? dk::hash_u32(s.ptr[row * s.stride], dk::BLOOM_SALT_SEED) : 0u;
  return {mix ^ dk::fmix32(dk::BLOOM_SEED_1),
          mix ^ dk::fmix32(dk::BLOOM_SEED_2)};
}

// Items and mask bytes, 4 or 1 at a time.
template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using H = uint4;
  using M = uint32_t;
  __device__ static uint32_t item(const uint4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<1> {
  using H = uint32_t;
  using M = uint8_t;
  __device__ static uint32_t item(uint32_t v, int) { return v; }
};

// Is every one of an item's k probe bits set in the row's words `wr`?
// (K: the hash count at compile time, 0 for the runtime k.)
template <int K>
__device__ __forceinline__ uint32_t query_item(uint32_t item, Seeds sd,
                                               Recip rc, const uint32_t* wr,
                                               int k) {
  uint32_t x = dk::fmix32(item ^ sd.c1);
  const uint32_t h2 = dk::fmix32(item ^ sd.c2) | 1u;
  uint32_t all = 1u;
  if (K) {
#pragma unroll
    for (int j = 0; j < K; ++j, x += h2)
      all &= wr[mod_of(x, rc) >> 5] >> (x & 31u);
  } else {
#pragma unroll 4
    for (int j = 0; j < k; ++j, x += h2)
      all &= wr[mod_of(x, rc) >> 5] >> (x & 31u);
  }
  return all & 1u;
}

// OR an item's k probe bits into the row's words `wr`.
template <int K>
__device__ __forceinline__ void build_item(uint32_t item, Seeds sd, Recip rc,
                                           uint32_t* wr, int k) {
  uint32_t x = dk::fmix32(item ^ sd.c1);
  const uint32_t h2 = dk::fmix32(item ^ sd.c2) | 1u;
  if (K) {
#pragma unroll
    for (int j = 0; j < K; ++j, x += h2)
      atomicOr(&wr[mod_of(x, rc) >> 5], 1u << (x & 31u));
  } else {
    for (int j = 0; j < k; ++j, x += h2)
      atomicOr(&wr[mod_of(x, rc) >> 5], 1u << (x & 31u));
  }
}

// Copy the block's rows of a row-strided [n, nw] filter into shared
// memory, rows packed: a warp takes 32 / nw rows a step when they fit.
__device__ __forceinline__ void stage_rows(uint32_t* rw, const uint32_t* words,
                                           long long stride, long long row0,
                                           int rows_here, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (nw <= 32) {
    const int per = 32 / nw, sub = lane / nw, c = lane - sub * nw;
    if (sub >= per) return;
#pragma unroll 4
    for (int r = warp * per + sub; r < rows_here; r += warps * per)
      rw[r * nw + c] = words[(row0 + r) * stride + c];
  } else {
    for (int r = warp; r < rows_here; r += warps)
      for (int c = lane; c < nw; c += 32)
        rw[r * nw + c] = words[(row0 + r) * stride + c];
  }
}

template <int K, int VEC>
__global__ void __launch_bounds__(TPB)
    dk_query_kernel(const uint32_t* __restrict__ words, long long row_stride,
                    const uint32_t* __restrict__ hashes, long long n, int m,
                    int nw, int lg, int rows, Salt salt, Recip rc, int k,
                    bool* __restrict__ out) {
  using V = Vec<VEC>;
  extern __shared__ uint32_t rw[];
  const int g = 1 << lg, gl = threadIdx.x & (g - 1), r = threadIdx.x >> lg;
  const long long row0 = blockIdx.x * (long long)rows, row = row0 + r;
  const bool active = row < n;
  const int nv = m / VEC;
  const auto* hv = reinterpret_cast<const typename V::H*>(hashes) +
                   (active ? row : 0) * nv;
  typename V::H h[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c)
    if (active && gl + c * g < nv) h[c] = hv[gl + c * g];
  const long long left = n - row0;
  stage_rows(rw, words, row_stride, row0,
             static_cast<int>(left < rows ? left : rows), nw);
  __syncthreads();
  if (!active) return;
  const Seeds sd = seeds_of(salt, row);
  const uint32_t* wr = rw + r * nw;
  auto* ov = reinterpret_cast<typename V::M*>(out) + row * nv;
  for (int v0 = gl; v0 < nv; v0 += CHUNK * g) {
    if (v0 != gl) {
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        if (v0 + c * g < nv) h[c] = hv[v0 + c * g];
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (v0 + c * g >= nv) break;
      typename V::M ok = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ok |= static_cast<typename V::M>(
            query_item<K>(V::item(h[c], e), sd, rc, wr, k) << (8 * e));
      ov[v0 + c * g] = ok;
    }
  }
}

// The build and the digest update: the bitsets start from `base` (the
// digest, [n, nw] contiguous) or zero.
template <int K, int VEC>
__global__ void __launch_bounds__(TPB)
    dk_build_kernel(const uint32_t* __restrict__ base,
                    const uint32_t* __restrict__ hashes,
                    const bool* __restrict__ mask, long long n, int m, int nw,
                    int lg, int rows, Salt salt, Recip rc, int k,
                    uint32_t* __restrict__ words) {
  using V = Vec<VEC>;
  extern __shared__ uint32_t bits[];
  const int g = 1 << lg, gl = threadIdx.x & (g - 1), r = threadIdx.x >> lg;
  const long long row0 = blockIdx.x * (long long)rows, row = row0 + r;
  const bool active = row < n;
  const int nv = m / VEC;
  const auto* hv = reinterpret_cast<const typename V::H*>(hashes) +
                   (active ? row : 0) * nv;
  const auto* mv = reinterpret_cast<const typename V::M*>(mask) +
                   (active ? row : 0) * nv;
  typename V::H h[CHUNK];
  typename V::M f[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    f[c] = 0;
    if (active && gl + c * g < nv) {
      f[c] = mv[gl + c * g];
      h[c] = hv[gl + c * g];
    }
  }
  const long long left = n - row0;
  const int total = static_cast<int>(left < rows ? left : rows) * nw;
  const long long at = row0 * nw;
  for (int t = threadIdx.x; t < total; t += blockDim.x)
    bits[t] = base ? base[at + t] : 0u;
  __syncthreads();
  if (active) {
    const Seeds sd = seeds_of(salt, row);
    uint32_t* wr = bits + r * nw;
    for (int v0 = gl; v0 < nv; v0 += CHUNK * g) {
      if (v0 != gl) {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          f[c] = 0;
          if (v0 + c * g < nv) {
            f[c] = mv[v0 + c * g];
            h[c] = hv[v0 + c * g];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if ((f[c] >> (8 * e)) & 1u)
            build_item<K>(V::item(h[c], e), sd, rc, wr, k);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < total; t += blockDim.x) words[at + t] = bits[t];
}

// The launch shape: G = 2^lg lanes a row so that a lane takes about CHUNK
// vectors, rows a block so that the block has at most TPB threads, a
// whole number of warps and at most SMEM_WORDS staged words.
struct Plan {
  int vec, lg, rows;
  unsigned blocks;
  size_t smem;
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Plan plan_of(long long n, int m, int nw, bool vec4) {
  Plan p;
  p.vec = vec4 ? 4 : 1;
  const int nv = m / p.vec;
  p.lg = 0;
  while (p.lg < 5 && (CHUNK << p.lg) < nv) ++p.lg;
  const int g = 1 << p.lg, whole = 32 / g;
  p.rows = TPB / g;
  const int cap = SMEM_WORDS / nw / whole * whole;
  if (cap < p.rows) p.rows = cap;
  p.blocks = dk::blocks_for(n, p.rows);
  p.smem = static_cast<size_t>(p.rows) * nw * sizeof(uint32_t);
  return p;
}

bool bad_shape(long long n, long long m, long long n_bits, long long k) {
  return n < 0 || m < 0 || m > (1 << 30) || n_bits < 32 || n_bits % 32 ||
         n_bits / 32 > MAX_WORDS || k < 0 || k > (1 << 30);
}

template <int K>
int launch_build(const uint32_t* base, const uint32_t* hashes,
                 const bool* mask, long long n, int m, int nw, Salt salt,
                 Recip rc, int k, uint32_t* words, cudaStream_t stream) {
  const bool vec4 = m % 4 == 0 && aligned(hashes, 16) && aligned(mask, 4);
  const Plan p = plan_of(n, m, nw, vec4);
  const auto kernel =
      vec4 ? dk_build_kernel<K, 4> : dk_build_kernel<K, 1>;
  LAUNCH(kernel, p.blocks, p.rows << p.lg, p.smem, stream)(
      base, hashes, mask, n, m, nw, p.lg, p.rows, salt, rc, k, words);
  return static_cast<int>(cudaGetLastError());
}

int build(const uint32_t* base, const uint32_t* hashes, const bool* mask,
          long long n, long long m, long long n_bits, long long k,
          const uint32_t* salt, long long salt_stride, long long magic,
          long long shift, uint32_t* words, cudaStream_t stream) {
  if (bad_shape(n, m, n_bits, k)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Recip rc{static_cast<uint32_t>(n_bits), static_cast<uint32_t>(magic),
                 static_cast<int>(shift)};
  const Salt s{salt, salt_stride};
  const int mi = static_cast<int>(m), nw = static_cast<int>(n_bits / 32);
  const int ki = static_cast<int>(k);
  return ki == K_FIXED ? launch_build<K_FIXED>(base, hashes, mask, n, mi, nw,
                                               s, rc, ki, words, stream)
                       : launch_build<0>(base, hashes, mask, n, mi, nw, s, rc,
                                         ki, words, stream);
}

template <int K>
int launch_query(const uint32_t* words, long long row_stride,
                 const uint32_t* hashes, long long n, int m, int nw,
                 Salt salt, Recip rc, int k, bool* out, cudaStream_t stream) {
  const bool vec4 = m % 4 == 0 && aligned(hashes, 16) && aligned(out, 4);
  const Plan p = plan_of(n, m, nw, vec4);
  const auto kernel =
      vec4 ? dk_query_kernel<K, 4> : dk_query_kernel<K, 1>;
  LAUNCH(kernel, p.blocks, p.rows << p.lg, p.smem, stream)(
      words, row_stride, hashes, n, m, nw, p.lg, p.rows, salt, rc, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (magic, shift): kernels.bloom_reciprocal(n_bits).
DK_EXPORT int dk_bloom_build(const uint32_t* hashes, const bool* mask,
                             long long n, long long m, long long n_bits,
                             long long k, const uint32_t* salt,
                             long long salt_stride, long long magic,
                             long long shift, uint32_t* words,
                             cudaStream_t stream) {
  return build(nullptr, hashes, mask, n, m, n_bits, k, salt, salt_stride,
               magic, shift, words, stream);
}

DK_EXPORT int dk_digest_update(const uint32_t* digest,
                               const uint32_t* hashes, const bool* mask,
                               long long n, long long m, long long n_bits,
                               long long k, const uint32_t* salt,
                               long long salt_stride, long long magic,
                               long long shift, uint32_t* words,
                               cudaStream_t stream) {
  return build(digest, hashes, mask, n, m, n_bits, k, salt, salt_stride,
               magic, shift, words, stream);
}

DK_EXPORT int dk_bloom_query(const uint32_t* words, long long row_stride,
                             const uint32_t* hashes, long long n, long long m,
                             long long n_bits, long long k,
                             const uint32_t* salt, long long salt_stride,
                             long long magic, long long shift, bool* out,
                             cudaStream_t stream) {
  if (bad_shape(n, m, n_bits, k)) return cudaErrorInvalidValue;
  if (n == 0 || m == 0) return cudaSuccess;
  const Recip rc{static_cast<uint32_t>(n_bits), static_cast<uint32_t>(magic),
                 static_cast<int>(shift)};
  const Salt s{salt, salt_stride};
  const int mi = static_cast<int>(m), nw = static_cast<int>(n_bits / 32);
  const int ki = static_cast<int>(k);
  return ki == K_FIXED
             ? launch_query<K_FIXED>(words, row_stride, hashes, n, mi, nw, s,
                                     rc, ki, out, stream)
             : launch_query<0>(words, row_stride, hashes, n, mi, nw, s, rc,
                               ki, out, stream);
}
