// K9: store_match -- the Timeline's store replays: for each of a row's Q
// queries, a reduce over the row's W entries that a selecting column
// picks and whose keys match the query.
//
// Replaces dispersy_tpu/ops/intake.py:182 `flip_best_batch` (and :163
// `flip_best`, its store-side view), :217 `undo_marked`, :293
// `stored_meta_of` and :244 `undo_hits_store` -- on the TPU a broadcast
// compare-reduce over [N, Q, W].  Modes (a template parameter):
//   FLIP         entries flagged (the flip mask); payload == q_meta and
//                gt <= q_gt (unsigned); the max of gt * 2 | (aux & 1)
//                (u32, wrapping), else 0;
//   UNDO_MARKED  entries whose meta is dispersy-undo-own / -other;
//                payload == member and aux == gt; any;
//   META_OF      entries whose meta is a user meta (< 32); member and gt
//                equal; the min meta, else 0xFFFF;
//   UNDO_HITS    the transposed view: the entries are the batch's
//                accepted undos (valid), the queries the store rows;
//                (member, gt) equal; any.
// Every compare is on u32 in C++'s unsigned order, which is the JAX
// package's.
//
// Bound on the H100: bytes -- the selecting column in full, the key and
// value columns at the slots it selects only, the queries, the output.
//
// Design.  A group of G lanes per row (G = 4, 8 or 16 by Q: 8, 4 or 2
// rows a warp, so one load instruction serves several rows).  A row
// costs two round trips to memory: its queries (QR a lane) and its
// selecting column (4 consecutive slots a lane, 4 such steps in flight)
// are loaded at once; each lane counts its selected slots, a scan over
// the group's lanes gives each its place, and the selected slots'
// indices go to a list in shared memory; then only the listed slots' key
// and value columns are loaded.  Each lane loops over the list with
// broadcast reads and compares every entry with its QR queries.  The
// lists of a block's rows are interleaved slot by slot, so the groups of
// a warp read different banks.  The selecting column is rarely true in
// the flip and undo modes, so most rows read and compare little.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_W = 256;  // kernels.MATCH_MAX_WIDTH
constexpr int UN = 4;       // steps of the selecting column in flight
constexpr int FLIP = 0, UNDO_MARKED = 1, META_OF = 2, UNDO_HITS = 3;
constexpr uint32_t META_UNDO_OWN = 0xF2, META_UNDO_OTHER = 0xF3;
constexpr uint32_t META_NOT_FOUND = 0xFFFF;

template <int MODE>
__device__ __forceinline__ bool selects(uint8_t f) {
  if (MODE == UNDO_MARKED) return f == META_UNDO_OWN || f == META_UNDO_OTHER;
  if (MODE == META_OF) return f < 32;
  return f != 0;
}

// The block's shared memory: four arrays -- the list's slot index, keys
// k1, k2 and value (aux for FLIP, the meta for META_OF) -- of W slots,
// each slot holding the R rows' entries side by side.
template <int MODE, int G, int QR>
__global__ void __launch_bounds__(WARPS * 32)
    dk_match_kernel(const uint8_t* flag, const uint32_t* w1,
                    const uint32_t* w2, const uint32_t* wv, const void* q1,
                    bool q1_u8, const uint32_t* q2, void* out, long long n,
                    int w, int q) {
  constexpr int R = WARPS * 32 / G;  // rows a block
  extern __shared__ __align__(16) uint32_t list[];
  const int gl = threadIdx.x % G;
  const int group = threadIdx.x / G;  // in the block
  const long long row = blockIdx.x * (long long)R + group;
  const bool active = row < n;
  uint32_t* li = list + group;
  uint32_t* l1 = li + w * R;
  uint32_t* l2 = l1 + w * R;
  uint32_t* lv = l2 + w * R;
  const uint8_t* frow = flag + row * w;
  const uint32_t* q2row = q2 + row * q;
  auto query1 = [&](int k) -> uint32_t {
    return q1_u8 ? static_cast<const uint8_t*>(q1)[row * q + k]
                 : static_cast<const uint32_t*>(q1)[row * q + k];
  };

  uint32_t qa[QR], qb[QR];
#pragma unroll
  for (int u = 0; u < QR; ++u) {
    const int k = gl + u * G;
    qa[u] = qb[u] = 0;
    if (active && k < q) {
      qa[u] = query1(k);
      qb[u] = q2row[k];
    }
  }
  int cnt = 0;  // uniform within the group
  for (int base = 0; base < w; base += UN * 4 * G) {  // warp-uniform
    uint8_t f[UN][4];
#pragma unroll
    for (int u = 0; u < UN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = base + (u * G + gl) * 4 + e;
        f[u][e] = active && j < w ? frow[j] : 0;
      }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      if (base + u * G * 4 >= w) break;  // warp-uniform
      unsigned sel = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = base + (u * G + gl) * 4 + e;
        sel |= unsigned{active && j < w && selects<MODE>(f[u][e])} << e;
      }
      const int c = __popc(sel);
      int incl = c;  // inclusive scan over the group's lanes
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int v = __shfl_up_sync(dk::FULL_MASK, incl, d, G);
        if (gl >= d) incl += v;
      }
      int at = cnt + incl - c;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((sel >> e) & 1u) {
          li[at * R] = base + (u * G + gl) * 4 + e;
          if (MODE == META_OF) lv[at * R] = f[u][e];
          ++at;
        }
      cnt += __shfl_sync(dk::FULL_MASK, incl, G - 1, G);
    }
  }
  __syncwarp();
  // With at most G queries (one a lane), the second key and the value
  // are read only for entries whose first key some query of the row
  // names: the others can match nothing.
  constexpr bool FILTER = QR == 1;
  uint32_t names[FILTER ? G : 1];
#pragma unroll
  for (int u = 0; u < (FILTER ? G : 1); ++u)
    names[u] = __shfl_sync(dk::FULL_MASK, qa[0], u, G);
#pragma unroll 4
  for (int t = gl; t < cnt; t += G) {
    const long long from = row * w + li[t * R];
    const uint32_t a = w1[from];
    bool named = !FILTER;
#pragma unroll
    for (int u = 0; u < (FILTER ? G : 0); ++u) named |= u < q && a == names[u];
    l1[t * R] = a;
    if (named) {
      l2[t * R] = w2[from];
      if (MODE == FLIP) lv[t * R] = wv[from];
    }
  }
  __syncwarp();
  if (!active) return;
  for (int k0 = 0; k0 < q; k0 += QR * G) {
    if (k0) {
#pragma unroll
      for (int u = 0; u < QR; ++u) {
        const int k = k0 + gl + u * G;
        if (k < q) {
          qa[u] = query1(k);
          qb[u] = q2row[k];
        }
      }
    }
    uint32_t acc[QR];
#pragma unroll
    for (int u = 0; u < QR; ++u)
      acc[u] = MODE == META_OF ? META_NOT_FOUND : 0u;
    for (int s = 0; s < cnt; ++s) {
      const uint32_t a = l1[s * R], g = l2[s * R];
      const uint32_t v = MODE == FLIP || MODE == META_OF ? lv[s * R] : 0u;
#pragma unroll
      for (int u = 0; u < QR; ++u) {
        if (MODE == FLIP) {
          const uint32_t key = (g << 1) | (v & 1u);
          if (a == qa[u] && g <= qb[u] && key > acc[u]) acc[u] = key;
        } else if (MODE == META_OF) {
          if (a == qa[u] && g == qb[u] && v < acc[u]) acc[u] = v;
        } else {
          acc[u] |= a == qa[u] && g == qb[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int k = k0 + gl + u * G;
      if (k >= q) continue;
      if (MODE == FLIP || MODE == META_OF)
        static_cast<uint32_t*>(out)[row * q + k] = acc[u];
      else
        static_cast<uint8_t*>(out)[row * q + k] = static_cast<uint8_t>(acc[u]);
    }
  }
}

template <int MODE, int G, int QR>
int launch(const uint8_t* flag, const uint32_t* w1, const uint32_t* w2,
           const uint32_t* wv, const void* q1, bool q1_u8,
           const uint32_t* q2, void* out, long long n, int w, int q,
           cudaStream_t stream) {
  constexpr int rows = WARPS * 32 / G;
  const auto kernel = dk_match_kernel<MODE, G, QR>;
  const size_t smem = static_cast<size_t>(rows) * 4 * w * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  LAUNCH(kernel, dk::blocks_for(n, rows), WARPS * 32, smem, stream)(
      flag, w1, w2, wv, q1, q1_u8, q2, out, n, w, q);
  return static_cast<int>(cudaGetLastError());
}

// G and QR by the query count: a group's lanes hold G * QR queries (more
// are taken QR * G at a time).
template <int MODE>
int launch_mode(const uint8_t* flag, const uint32_t* w1, const uint32_t* w2,
                const uint32_t* wv, const void* q1, bool q1_u8,
                const uint32_t* q2, void* out, long long n, int w, int q,
                cudaStream_t stream) {
  if (q <= 4)
    return launch<MODE, 4, 1>(flag, w1, w2, wv, q1, q1_u8, q2, out, n, w, q,
                              stream);
  if (q <= 24)
    return launch<MODE, 8, 3>(flag, w1, w2, wv, q1, q1_u8, q2, out, n, w, q,
                              stream);
  return launch<MODE, 16, 3>(flag, w1, w2, wv, q1, q1_u8, q2, out, n, w, q,
                             stream);
}

}  // namespace

// mode: FLIP 0, UNDO_MARKED 1, META_OF 2, UNDO_HITS 3.  flag: u8 [n, w]
// (a bool mask's bytes, or the meta column); w1, w2, wv: u32 [n, w] (wv
// read by FLIP only); q1: u32 [n, q], or u8 when q1_u8 (a meta column);
// q2: u32 [n, q]; out: u32 [n, q] for FLIP and META_OF, bool [n, q]
// otherwise.
DK_EXPORT int dk_store_match(long long mode, const uint8_t* flag,
                             const uint32_t* w1, const uint32_t* w2,
                             const uint32_t* wv, const void* q1,
                             long long q1_u8, const uint32_t* q2, void* out,
                             long long n, long long w, long long q,
                             cudaStream_t stream) {
  if (n < 0 || w < 1 || q < 1 || w > MAX_W || q > (1 << 30))
    return cudaErrorInvalidValue;
  const int wi = static_cast<int>(w), qi = static_cast<int>(q);
  const bool u8 = q1_u8 != 0;
  switch (mode) {
    case FLIP:
      return launch_mode<FLIP>(flag, w1, w2, wv, q1, u8, q2, out, n, wi, qi,
                               stream);
    case UNDO_MARKED:
      return launch_mode<UNDO_MARKED>(flag, w1, w2, wv, q1, u8, q2, out, n,
                                      wi, qi, stream);
    case META_OF:
      return launch_mode<META_OF>(flag, w1, w2, wv, q1, u8, q2, out, n, wi,
                                  qi, stream);
    case UNDO_HITS:
      return launch_mode<UNDO_HITS>(flag, w1, w2, wv, q1, u8, q2, out, n, wi,
                                    qi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
