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
// position) is K1's counting sort by destination with (class, edge
// index) inside a group, run in place on the kept edges (deliver.cuh).
// What K12 adds is the bucket cap.  An entry's rank in its bucket
// (r, h) is a count in (destination, class, position) order, so the
// kept set of a bucket is every entry below its B-th (0-based) entry.
// That boundary entry is found by narrowing one key field at a time,
// all counts:
//   1. hist   -- per (row, destination) counts, [S, N] atomics;
//   2. dest   -- one block per bucket scans its destinations' counts;
//                a bucket of at most B entries keeps all, otherwise the
//                destination d* whose group crosses B and the number m1
//                of its entries still kept;
//   3. class  -- a 256-bin class histogram of each crossing group;
//   4. edge   -- one block per crossing bucket takes the class c* where
//                m1 falls and the m2-th edge of (d*, c*) in its row, by a
//                block scan over the row in edge order: l*;
//   5. keep   -- each deliverable edge is kept when (d, c, i) sorts
//                below its bucket's (d*, c*, l*), shed otherwise.
// Step 6 is K1's landing on the kept edges, with receipts when asked.
#include "deliver.cuh"

namespace {

using dk::block_incl_scan;
using dk::deliverable;

constexpr int RG_BLOCK = 1024;
constexpr int N_CLS = 256;

__device__ __forceinline__ int cls_of(const uint8_t* cls, long long i) {
  return cls ? cls[i] : 0;
}

__global__ void rg_hist_kernel(const int32_t* dst, const bool* valid,
                               long long e, long long el, int n,
                               int32_t* hist) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= e) return;
  int d;
  if (deliverable(dst, valid, i, n, &d))
    atomicAdd(&hist[(i / el) * n + d], 1);
}

// bound[4 * bucket]: d* (-1: the bucket keeps everything), m1, c*, l*.
__global__ void rg_dest_kernel(const int32_t* hist, int n, int nl, int s,
                               int b, int32_t* bound) {
  __shared__ int found_d, found_m;
  const int bucket = blockIdx.x, r = bucket / s, h = bucket % s;
  const int32_t* seg = hist + (long long)r * n + (long long)h * nl;
  if (threadIdx.x == 0) found_d = -1;
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < nl; base += RG_BLOCK) {
    const int j = base + threadIdx.x;
    const int v = j < nl ? seg[j] : 0;
    int total;
    const int incl = block_incl_scan(v, &total);
    const int excl = carry + incl - v;
    if (v > 0 && excl <= b && excl + v > b) {  // exactly one thread
      found_d = h * nl + j;
      found_m = b - excl;
    }
    carry += total;
    __syncthreads();
    if (found_d >= 0) break;  // block-uniform
  }
  if (threadIdx.x == 0) {
    bound[4 * bucket] = found_d;
    bound[4 * bucket + 1] = found_d >= 0 ? found_m : 0;
  }
}

__global__ void rg_class_kernel(const int32_t* dst, const bool* valid,
                                const uint8_t* cls, long long e, long long el,
                                int n, int nl, int s, const int32_t* bound,
                                int32_t* chist) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= e) return;
  int d;
  if (!deliverable(dst, valid, i, n, &d)) return;
  const int bucket = static_cast<int>(i / el) * s + d / nl;
  if (bound[4 * bucket] == d)
    atomicAdd(&chist[bucket * N_CLS + cls_of(cls, i)], 1);
}

__global__ void rg_edge_kernel(const int32_t* dst, const bool* valid,
                               const uint8_t* cls, long long e, long long el,
                               int n, int s, const int32_t* chist,
                               int32_t* bound) {
  __shared__ int c_star, m2, l_star;
  const int bucket = blockIdx.x;
  const int d_star = bound[4 * bucket];
  if (d_star < 0) return;  // block-uniform
  if (threadIdx.x == 0) {
    const int m1 = bound[4 * bucket + 1];
    int cum = 0, c = 0;
    for (; c < N_CLS; ++c) {
      const int hc = chist[bucket * N_CLS + c];
      if (cum + hc > m1) break;
      cum += hc;
    }
    c_star = c;
    m2 = m1 - cum;
    l_star = -1;
  }
  __syncthreads();
  const long long r = bucket / s;
  const long long lo = r * el, hi = lo + el < e ? lo + el : e;
  int carry = 0;
  for (long long base = lo; base < hi; base += RG_BLOCK) {
    const long long i = base + threadIdx.x;
    int d = -1;
    const bool f = i < hi && deliverable(dst, valid, i, n, &d) &&
                   d == d_star && cls_of(cls, i) == c_star;
    int total;
    const int incl = block_incl_scan(f ? 1 : 0, &total);
    if (f && carry + incl - 1 == m2) l_star = static_cast<int>(i);
    carry += total;
    __syncthreads();
    if (l_star >= 0) break;  // block-uniform
  }
  if (threadIdx.x == 0) {
    bound[4 * bucket + 2] = c_star;
    bound[4 * bucket + 3] = l_star;
  }
}

__global__ void rg_keep_kernel(const int32_t* dst, const bool* valid,
                               const uint8_t* cls, long long e, long long el,
                               int n, int nl, int s, const int32_t* bound,
                               bool* keep, bool* shed) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= e) return;
  int d;
  bool kept = false, lost = false;
  if (deliverable(dst, valid, i, n, &d)) {
    const int* bd = bound + 4 * (static_cast<int>(i / el) * s + d / nl);
    const int c = cls_of(cls, i);
    kept = bd[0] < 0 || d < bd[0] ||
           (d == bd[0] && (c < bd[2] || (c == bd[2] && i < bd[3])));
    lost = !kept;
  }
  keep[i] = kept;
  shed[i] = lost;
}

}  // namespace

// scratch: int32[4 * n + 1 + ceil(n / 1024) + e] (K1's) followed by
// int32[s * n + 4 * s * s + 256 * s * s] (hist | bound | chist);
// keep: bool[e].
DK_EXPORT int dk_deliver_ragged(
    const int32_t* dst, const bool* valid, const uint8_t* cls, long long e,
    long long n, long long q, long long s, long long budget,
    long long receipts, long long k, void* const* src_cols,
    void* const* dst_cols, const long long* nbytes, bool* inbox_valid,
    int32_t* n_dropped, int32_t* edge_slot, bool* shed, bool* keep,
    int32_t* scratch, cudaStream_t stream) {
  if (s < 2 || n % s != 0 || budget < 0) return cudaErrorInvalidValue;
  const long long el = (e + s - 1) / s;
  const long long b = budget > 0 && budget < el ? budget : el;
  const long long nb = dk::blocks_for(n, dk::SCAN_BLOCK);
  int32_t* hist = scratch + 4 * n + 1 + nb + e;
  int32_t* bound = hist + s * n;
  int32_t* chist = bound + 4 * s * s;
  const bool* lands = valid;
  if (b < el && e > 0) {
    const int tpb = 256, ni = static_cast<int>(n);
    const int nl = static_cast<int>(n / s), si = static_cast<int>(s);
    cudaMemsetAsync(hist, 0, (s * n + 4 * s * s + N_CLS * s * s) *
                                 sizeof(int32_t), stream);
    LAUNCH(rg_hist_kernel, dk::blocks_for(e, tpb), tpb, 0, stream)(
        dst, valid, e, el, ni, hist);
    LAUNCH(rg_dest_kernel, si * si, RG_BLOCK, 0, stream)(
        hist, ni, nl, si, static_cast<int>(b), bound);
    LAUNCH(rg_class_kernel, dk::blocks_for(e, tpb), tpb, 0, stream)(
        dst, valid, cls, e, el, ni, nl, si, bound, chist);
    LAUNCH(rg_edge_kernel, si * si, RG_BLOCK, 0, stream)(
        dst, valid, cls, e, el, ni, si, chist, bound);
    LAUNCH(rg_keep_kernel, dk::blocks_for(e, tpb), tpb, 0, stream)(
        dst, valid, cls, e, el, ni, nl, si, bound, keep, shed);
    lands = keep;
  } else if (e > 0) {
    cudaMemsetAsync(shed, 0, e, stream);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return dk::deliver_launch(dst, lands, cls, e, n, q, k, src_cols, dst_cols,
                            nbytes, static_cast<int>(receipts), inbox_valid,
                            n_dropped, edge_slot, scratch, stream);
}
