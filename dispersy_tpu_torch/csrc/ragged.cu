// K12: deliver_ragged -- the shard-local exchange of a delivery whose
// peer axis is split into S shards, with capped send buckets, on one card.
//
// Replaces dispersy_tpu/ops/inbox.py:217 `deliver_ragged`.  Its TPU form
// views the (padded) edge list as [S, El] rows, sorts each row by
// (destination, class, local position), ranks each entry within its
// (row, destination shard) bucket, keeps the first B = min(budget, El)
// (B = El when budget is 0: nothing sheds) and sheds the rest at the
// sender, packs the kept entries into [S, S, B] buckets, transposes them
// source <-> destination shard (the all-to-all), merges each destination
// shard's arrivals by (destination, class, global position) and lands
// them shard-locally into the [N, Q] inboxes with per-peer drop counts,
// then carries the receipts back through the reverse transpose.
//
// Bound on the H100: bytes.  The function reads dst, valid and the class
// (6 B an edge), the payload row of each delivered edge, and writes the
// inboxes, their valid mask, the drop counts, the receipts and the shed
// stream; the bucket ranks are counts, not arithmetic.
//
// Design.  On one card the transpose is index arithmetic: a kept entry of
// row r at local position l has global position r * El + l, which is its
// edge index, so the destination merge by (destination, class, global
// position) is K1's stable radix sort by destination with (class, edge
// index) inside a group, run in place on the kept edges, and its landing
// (deliver.cuh).  What K12 adds is the bucket cap.  An entry's rank in
// its bucket (r, h) is a count in (destination, class, position) order,
// so the kept set of a bucket is every entry below its B-th (0-based)
// entry.  That boundary entry is found by narrowing one key field at a
// time, all counts, and no stage walks a bucket or a row in one block:
//   1. hist    -- one pass over the edges: per (row, destination) counts
//                 ([S, N]) and per (bucket, chunk of DCH destinations)
//                 sums, warp-aggregated atomics (a hot destination's
//                 edges in a warp add once);
//   2. dest    -- a block per bucket scans its chunk sums, then the one
//                 chunk where B falls: the destination d* whose group
//                 crosses B and the number m1 of its entries still kept
//                 (none: the bucket keeps all);
//   3. class   -- one pass: the 256-bin class histogram of each crossing
//                 group (r, d*); the last block to finish takes the class
//                 c* where m1 falls and the rank m2 of the boundary entry
//                 among the group's class-c* edges, a warp a bucket
//                 (skipped without classes: c* = 0, m2 = m1);
//   4. count   -- one pass: per (bucket, row chunk of ECH edges) the
//                 number of (d*, c*) edges;
//   5. resolve -- a block per crossing bucket scans those counts, then the
//                 one chunk where m2 falls, in edge order: the boundary
//                 edge l*;
//   6. keep    -- one pass: each deliverable edge is kept when (d, c, i)
//                 sorts below its bucket's (d*, c*, l*), shed otherwise.
// The passes take row chunks of ECH edges (a block each, so the row is
// the block's, without a division), read valid first and the destination
// and class only of an edge that needs them, and leave a row with no
// crossing bucket at once.  Why passes and not walks: a block that walks
// a bucket's destinations, or its row in edge order up to the boundary,
// does sequential work that only S^2 SMs share, and the call lasts as
// long as the longest walk; a pass spreads every edge over the grid, and
// the per-bucket scans read one count a chunk and then one chunk.  The
// crossing group's size never matters: a group of one edge and a flood
// target's tens of thousands cost the same passes.  Step 7 is K1's
// sort and landing on the kept edges, with receipts when asked.  The
// exact exchange (budget 0, or a budget of at least El) runs step 7
// alone, its shed stream cleared by the core's histogram pass.
#include "deliver.cuh"

namespace {

using dk::block_incl_scan;
using dk::warp_incl_scan;

constexpr int N_CLS = 256;
constexpr int ET = 256;           // threads of an edge pass
constexpr int EPT = 8;            // edges a thread of an edge pass
constexpr int ECH = ET * EPT;     // edges of a row chunk
constexpr int SB = 1024;          // threads of a per-bucket block
constexpr int DCH = SB;           // destinations of a hist chunk
constexpr int RPT = ECH / SB;     // edges a resolve thread
static_assert(ECH % SB == 0, "a resolve block covers a row chunk");
// bound[BF * bucket + field]
constexpr int BF = 8, B_D = 0, B_M1 = 1, B_C = 2, B_M2 = 3, B_L = 4;

__device__ __forceinline__ int cls_of(const uint8_t* cls, long long i) {
  return cls ? cls[i] : 0;
}

// A block's row chunk: edges [lo, hi) of row r, chunk c of its nch.
struct Span {
  long long lo, hi;
  int r, c;
};

__device__ __forceinline__ Span span_of(long long e, long long el,
                                        int nch) {
  Span sp;
  sp.r = static_cast<int>(blockIdx.x) / nch;
  sp.c = static_cast<int>(blockIdx.x) - sp.r * nch;
  const long long row_end = sp.r * el + el < e ? sp.r * el + el : e;
  sp.lo = sp.r * el + static_cast<long long>(sp.c) * ECH;
  sp.hi = sp.lo + ECH < row_end ? sp.lo + ECH : row_end;
  return sp;
}

__device__ __forceinline__ long long edge_at(const Span& sp, int u) {
  return sp.lo + u * ET + threadIdx.x;
}

// The destinations of the thread's EPT edges of the span, -1 where the
// edge is not deliverable (past the span, invalid, or outside [0, n));
// valid is read first, dst only where it is set.
__device__ __forceinline__ void load_dests(const int32_t* dst,
                                           const bool* valid, const Span& sp,
                                           int n, int (&d)[EPT]) {
  bool v[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const long long i = edge_at(sp, u);
    v[u] = i < sp.hi && valid[i];
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int x = v[u] ? dst[edge_at(sp, u)] : -1;
    d[u] = x >= 0 && x < n ? x : -1;
  }
}

// Adds one to *at for each lane of the warp whose `pred` holds, one
// atomic for each distinct address.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(int32_t* at, bool pred) {
  const unsigned act = __ballot_sync(dk::FULL_MASK, pred);
  if (!pred) return;
  const unsigned peers =
      __match_any_sync(act, reinterpret_cast<unsigned long long>(at));
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
    atomicAdd(at, __popc(peers));
}

// Whether a bucket of row r crosses its budget (block-uniform).
__device__ __forceinline__ bool row_crosses(const int32_t* bound, int r,
                                            int s) {
  bool any = false;
  for (int h = threadIdx.x; h < s; h += blockDim.x)
    any |= bound[BF * (r * s + h) + B_D] >= 0;
  return __syncthreads_or(any);
}

// 1. Per (row, destination) counts and per (bucket, chunk) sums.
__global__ void __launch_bounds__(ET)
    rg_hist_kernel(const int32_t* dst, const bool* valid, long long e,
                   long long el, int n, int nl, int s, int nch, int cpb,
                   int32_t* hist, int32_t* hcs) {
  const Span sp = span_of(e, el, nch);
  int d[EPT];
  load_dests(dst, valid, sp, n, d);
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const bool ok = d[u] >= 0;
    const int h = ok ? d[u] / nl : 0;
    const int j = ok ? d[u] - h * nl : 0;
    warp_add(hist + static_cast<long long>(sp.r) * n + (ok ? d[u] : 0), ok);
    warp_add(hcs + static_cast<long long>(sp.r * s + h) * cpb + j / DCH, ok);
  }
}

// 2. A block per bucket: the chunk where the budget falls, then the
// destination d* in it and m1 (without classes also c* = 0, m2 = m1).
__global__ void __launch_bounds__(SB)
    rg_dest_kernel(const int32_t* hist, const int32_t* hcs, int n, int nl,
                   int s, int cpb, int b, bool has_cls, int32_t* bound) {
  __shared__ int found_k, found_b;
  const int bucket = blockIdx.x, r = bucket / s, h = bucket % s;
  int32_t* bd = bound + BF * bucket;
  if (threadIdx.x == 0) found_k = -1;
  __syncthreads();
  const int32_t* cs = hcs + static_cast<long long>(bucket) * cpb;
  int carry = 0;
  for (int base = 0; base < cpb; base += SB) {
    const int j = base + threadIdx.x;
    const int v = j < cpb ? cs[j] : 0;
    int total;
    const int excl = carry + block_incl_scan(v, &total) - v;
    if (v > 0 && excl <= b && excl + v > b) {  // exactly one thread
      found_k = j;
      found_b = b - excl;
    }
    carry += total;
    __syncthreads();
    if (found_k >= 0) break;  // block-uniform
  }
  if (found_k < 0) {  // block-uniform: the bucket keeps everything
    if (threadIdx.x == 0) bd[B_D] = -1;
    return;
  }
  const int d0 = h * nl + found_k * DCH;
  const int width = nl - found_k * DCH < DCH ? nl - found_k * DCH : DCH;
  const int v = static_cast<int>(threadIdx.x) < width
                    ? hist[static_cast<long long>(r) * n + d0 + threadIdx.x]
                    : 0;
  int total;
  const int excl = block_incl_scan(v, &total) - v;
  const int bb = found_b;
  if (v > 0 && excl <= bb && excl + v > bb) {  // exactly one thread
    bd[B_D] = d0 + threadIdx.x;
    bd[B_M1] = bb - excl;
    if (!has_cls) {
      bd[B_C] = 0;
      bd[B_M2] = bb - excl;
    }
  }
}

// 3. The class histogram of each crossing group; the last block takes c*
// and m2 of every crossing bucket, a warp a bucket.
__global__ void __launch_bounds__(ET)
    rg_class_kernel(const int32_t* dst, const bool* valid,
                    const uint8_t* cls, long long e, long long el, int n,
                    int nl, int s, int nch, int32_t* bound, int32_t* chist,
                    unsigned* ticket) {
  __shared__ bool last;
  const Span sp = span_of(e, el, nch);
  if (row_crosses(bound, sp.r, s)) {
    int d[EPT];
    load_dests(dst, valid, sp, n, d);
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int bucket = sp.r * s + (d[u] >= 0 ? d[u] / nl : 0);
      const bool hit = d[u] >= 0 && bound[BF * bucket + B_D] == d[u];
      warp_add(chist + bucket * N_CLS + (hit ? cls[edge_at(sp, u)] : 0),
               hit);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int PER_LANE = N_CLS / 32;
  const int lane = threadIdx.x & 31;
  for (int bucket = threadIdx.x >> 5; bucket < s * s; bucket += ET / 32) {
    int32_t* bd = bound + BF * bucket;
    if (bd[B_D] < 0) continue;  // warp-uniform
    const int m1 = bd[B_M1];
    int v[PER_LANE], sum = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      v[k] = __ldcg(chist + bucket * N_CLS + lane * PER_LANE + k);
      sum += v[k];
    }
    const int incl = warp_incl_scan(sum);
    int cum = incl - sum;
    if (cum <= m1 && m1 < incl) {  // exactly one lane
      for (int k = 0; k < PER_LANE; ++k) {
        if (cum + v[k] > m1) {
          bd[B_C] = lane * PER_LANE + k;
          bd[B_M2] = m1 - cum;
          break;
        }
        cum += v[k];
      }
    }
  }
}

// 4. Per (bucket, row chunk) the number of (d*, c*) edges.
__global__ void __launch_bounds__(ET)
    rg_count_kernel(const int32_t* dst, const bool* valid,
                    const uint8_t* cls, long long e, long long el, int n,
                    int nl, int s, int nch, const int32_t* bound,
                    int32_t* ccnt) {
  const Span sp = span_of(e, el, nch);
  if (!row_crosses(bound, sp.r, s)) return;  // block-uniform
  int d[EPT];
  load_dests(dst, valid, sp, n, d);
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int bucket = sp.r * s + (d[u] >= 0 ? d[u] / nl : 0);
    const int32_t* bd = bound + BF * bucket;
    const bool hit = d[u] >= 0 && bd[B_D] == d[u] &&
                     cls_of(cls, edge_at(sp, u)) == bd[B_C];
    warp_add(ccnt + static_cast<long long>(bucket) * nch + sp.c, hit);
  }
}

// 5. A block per crossing bucket: the chunk where m2 falls, then the
// m2-th (d*, c*) edge in it, in edge order: l*.
__global__ void __launch_bounds__(SB)
    rg_resolve_kernel(const int32_t* dst, const bool* valid,
                      const uint8_t* cls, long long e, long long el, int s,
                      int nch, const int32_t* ccnt, int32_t* bound) {
  __shared__ int found_k, found_m;
  const int bucket = blockIdx.x, r = bucket / s;
  int32_t* bd = bound + BF * bucket;
  const int d_star = bd[B_D];
  if (d_star < 0) return;  // block-uniform
  const int c_star = bd[B_C], m2 = bd[B_M2];
  if (threadIdx.x == 0) found_k = -1;
  __syncthreads();
  const int32_t* cc = ccnt + static_cast<long long>(bucket) * nch;
  int carry = 0;
  for (int base = 0; base < nch; base += SB) {
    const int j = base + threadIdx.x;
    const int v = j < nch ? cc[j] : 0;
    int total;
    const int excl = carry + block_incl_scan(v, &total) - v;
    if (v > 0 && excl <= m2 && excl + v > m2) {  // exactly one thread
      found_k = j;
      found_m = m2 - excl;
    }
    carry += total;
    __syncthreads();
    if (found_k >= 0) break;  // block-uniform
  }
  if (found_k < 0) return;  // block-uniform; not reached on exact counts
  const long long row_end = r * el + el < e ? r * el + el : e;
  const long long lo = r * el + static_cast<long long>(found_k) * ECH +
                       static_cast<long long>(threadIdx.x) * RPT;
  bool hit[RPT];
  int f = 0;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const long long i = lo + u;
    hit[u] = i < row_end && valid[i] && dst[i] == d_star &&
             cls_of(cls, i) == c_star;
    f += hit[u];
  }
  int total;
  int at = block_incl_scan(f, &total) - f;
  if (at <= found_m && found_m < at + f) {  // exactly one thread
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      if (hit[u] && at++ == found_m) bd[B_L] = static_cast<int>(lo + u);
    }
  }
}

// 6. Keep or shed each deliverable edge; keep and shed written for all.
__global__ void __launch_bounds__(ET)
    rg_keep_kernel(const int32_t* dst, const bool* valid, const uint8_t* cls,
                   long long e, long long el, int n, int nl, int s, int nch,
                   const int32_t* bound, bool* keep, bool* shed) {
  const Span sp = span_of(e, el, nch);
  int d[EPT];
  load_dests(dst, valid, sp, n, d);
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const long long i = edge_at(sp, u);
    if (i >= sp.hi) break;
    bool kept = false;
    if (d[u] >= 0) {
      const int32_t* bd = bound + BF * (sp.r * s + d[u] / nl);
      const int d_star = bd[B_D];
      kept = d_star < 0 || d[u] < d_star;
      if (d[u] == d_star) {
        const int c = cls_of(cls, i), c_star = bd[B_C];
        kept = c < c_star || (c == c_star && i < bd[B_L]);
      }
    }
    keep[i] = kept;
    shed[i] = d[u] >= 0 && !kept;
  }
}

// The geometry of a capped call: row chunks a row, hist chunks a bucket.
struct Geo {
  long long el;
  int nl, nch, cpb;
};

inline Geo geo_of(long long e, long long n, long long s) {
  Geo g;
  g.el = (e + s - 1) / s;
  g.nl = static_cast<int>(n / s);
  g.nch = static_cast<int>((g.el + ECH - 1) / ECH);
  g.nch = g.nch < 1 ? 1 : g.nch;
  g.cpb = (g.nl + DCH - 1) / DCH;
  return g;
}

}  // namespace

// The capped stages' scratch, all zeroed by one memset: int32[s * n]
// (hist) | [s * s * cpb] (hist chunk sums) | [s * s * 256] (class
// histograms) | [s * s * nch] (row-chunk counts) | [BF * s * s]
// (bounds) | the ticket.  It overlays the core's scratch (deliver.cuh):
// the stages are done with it before the core's first launch on the
// stream, which clears the core's part anew.
inline size_t ragged_own_bytes(long long e, long long n, long long s) {
  const Geo g = geo_of(e, n, s);
  return dk::round_up((s * n + s * s * (g.cpb + N_CLS + g.nch + BF) + 1) *
                      sizeof(int32_t));
}

// Whether the budget binds anywhere it could: 0 < budget < El.
inline bool capped(long long e, long long s, long long budget) {
  return e > 0 && budget > 0 && budget < (e + s - 1) / s;
}

DK_EXPORT long long dk_deliver_ragged_scratch(long long e, long long n,
                                              long long s, long long budget,
                                              long long has_cls,
                                              long long k,
                                              const long long* nbytes) {
  const size_t core = dk::scratch_bytes(e, n, has_cls != 0, k, nbytes);
  if (!capped(e, s, budget)) return static_cast<long long>(core);
  const size_t own = ragged_own_bytes(e, n, s);
  return static_cast<long long>(own > core ? own : core);
}

// keep: bool[e].
DK_EXPORT int dk_deliver_ragged(
    const int32_t* dst, const bool* valid, const uint8_t* cls, long long e,
    long long n, long long q, long long s, long long budget,
    long long receipts, long long k, void* const* src_cols,
    void* const* dst_cols, const long long* nbytes, bool* inbox_valid,
    int32_t* n_dropped, int32_t* edge_slot, bool* shed, bool* keep,
    void* scratch, long long scratch_size, cudaStream_t stream) {
  if (s < 2 || n % s != 0 || budget < 0 || e < 0 || e >= dk::MAX_EDGES)
    return cudaErrorInvalidValue;
  const Geo g = geo_of(e, n, s);
  int32_t* hist = static_cast<int32_t*>(scratch);
  int32_t* hcs = hist + s * n;
  int32_t* chist = hcs + s * s * g.cpb;
  int32_t* ccnt = chist + s * s * N_CLS;
  int32_t* bound = ccnt + s * s * g.nch;
  unsigned* ticket = reinterpret_cast<unsigned*>(bound + BF * s * s);
  const bool* lands = valid;
  bool* clear = shed;
  if (capped(e, s, budget)) {
    const size_t own = ragged_own_bytes(e, n, s);
    if (static_cast<size_t>(scratch_size) < own)
      return cudaErrorInvalidValue;
    const int ni = static_cast<int>(n), si = static_cast<int>(s);
    const unsigned edges = static_cast<unsigned>(s * g.nch);
    const unsigned buckets = static_cast<unsigned>(s * s);
    cudaMemsetAsync(scratch, 0, own, stream);
    LAUNCH(rg_hist_kernel, edges, ET, 0, stream)(
        dst, valid, e, g.el, ni, g.nl, si, g.nch, g.cpb, hist, hcs);
    LAUNCH(rg_dest_kernel, buckets, SB, 0, stream)(
        hist, hcs, ni, g.nl, si, g.cpb, static_cast<int>(budget),
        cls != nullptr, bound);
    if (cls)
      LAUNCH(rg_class_kernel, edges, ET, 0, stream)(
          dst, valid, cls, e, g.el, ni, g.nl, si, g.nch, bound, chist,
          ticket);
    LAUNCH(rg_count_kernel, edges, ET, 0, stream)(
        dst, valid, cls, e, g.el, ni, g.nl, si, g.nch, bound, ccnt);
    LAUNCH(rg_resolve_kernel, buckets, SB, 0, stream)(
        dst, valid, cls, e, g.el, si, g.nch, ccnt, bound);
    LAUNCH(rg_keep_kernel, edges, ET, 0, stream)(
        dst, valid, cls, e, g.el, ni, g.nl, si, g.nch, bound, keep, shed);
    lands = keep;
    clear = nullptr;
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return dk::deliver_launch(dst, lands, cls, e, n, q, k, src_cols, dst_cols,
                            nbytes, static_cast<int>(receipts), inbox_valid,
                            n_dropped, edge_slot, clear, scratch,
                            scratch_size, stream);
}
