// K1: deliver -- an edge list of logical packets into bounded per-peer
// inboxes, as a stable counting sort by destination.
//
// Replaces dispersy_tpu/ops/inbox.py:79 `deliver`, whose TPU form sorts a
// packed (destination << pos_bits | position) key with an unstable
// lax.sort, ranks each destination group with a cummax scan and scatters
// every payload column straight from edge order.
//
// Bound on the H100: bytes.  The function reads dst and valid (5 B per
// edge), the payload row of each delivered edge, and writes the [N, Q]
// inboxes, their valid mask, the per-peer drop counts and the per-edge
// receipt; there is no arithmetic to speak of.
//
// Design.  The sort is a counting sort written out by hand:
//   1. count   -- one atomicAdd per deliverable edge into count[dst];
//                 every receipt starts at -1;
//   2. scan    -- an exclusive scan of the counts into group starts
//                 (block scan + scan of block sums + add);
//   3. place   -- each deliverable edge takes a position in its group
//                 with an atomicAdd (the order inside a group is not yet
//                 edge order);
//   4. order   -- groups of at most 32 edges: one warp ranks its group's
//                 edge indices with shuffles; larger groups (hot peers,
//                 the trackers) are listed and handed to
//   5. select  -- one block per listed group selects the Q smallest edge
//                 indices with a bitonic sort in shared memory, a chunk
//                 of the group at a time.
// Steps 4 and 5 write the delivered rows, the valid mask and the receipts
// for the first Q positions of each group and the drop counts for every
// peer.  Edge order inside a destination is therefore exactly JAX's.
#include <climits>

#include "common.cuh"

namespace {

constexpr int MAX_COLS = 8;
constexpr int SCAN_BLOCK = 1024;
constexpr int SEL = 4096;          // selection buffer of a large group
constexpr int SEL_HALF = SEL / 2;  // the largest inbox a large group fills

struct Cols {
  const uint8_t* src[MAX_COLS];
  uint8_t* dst[MAX_COLS];
  long long nbytes[MAX_COLS];  // bytes of one row of each column
  int k;
};

__device__ __forceinline__ void copy_row(const Cols& c, long long src_row,
                                         long long dst_row) {
  for (int j = 0; j < c.k; ++j) {
    const long long nb = c.nbytes[j];
    const uint8_t* s = c.src[j] + src_row * nb;
    uint8_t* d = c.dst[j] + dst_row * nb;
    if ((nb & 3) == 0) {
      for (long long b = 0; b < nb; b += 4)
        *reinterpret_cast<uint32_t*>(d + b) =
            *reinterpret_cast<const uint32_t*>(s + b);
    } else if ((nb & 1) == 0) {  // u16 columns
      for (long long b = 0; b < nb; b += 2)
        *reinterpret_cast<uint16_t*>(d + b) =
            *reinterpret_cast<const uint16_t*>(s + b);
    } else {
      for (long long b = 0; b < nb; ++b) d[b] = s[b];
    }
  }
}

__device__ __forceinline__ bool deliverable(const int32_t* dst,
                                            const bool* valid, long long i,
                                            int n, int* d) {
  *d = dst[i];
  return valid[i] && *d >= 0 && *d < n;
}

__global__ void dk_count_kernel(const int32_t* dst, const bool* valid,
                                long long e, int n, int32_t* count,
                                int32_t* edge_slot) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= e) return;
  edge_slot[i] = -1;
  int d;
  if (deliverable(dst, valid, i, n, &d)) atomicAdd(&count[d], 1);
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(dk::FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Inclusive scan over the block (blockDim.x a multiple of 32, <= 1024);
// `total` receives the block's sum on every thread.
__device__ int block_incl_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_incl_scan(v);
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    s = warp_incl_scan(s);
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_sums[w - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();
  return v;
}

__global__ void dk_scan_blocks_kernel(const int32_t* count, int n,
                                      int32_t* start, int32_t* sums) {
  const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const int v = i < n ? count[i] : 0;
  int total;
  const int incl = block_incl_scan(v, &total);
  if (i < n) start[i] = incl - v;
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void dk_scan_sums_kernel(int32_t* sums, int nb) {
  int carry = 0;
  for (int base = 0; base < nb; base += SCAN_BLOCK) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? sums[i] : 0;
    int total;
    const int incl = block_incl_scan(v, &total);
    if (i < nb) sums[i] = carry + incl - v;
    carry += total;
  }
}

__global__ void dk_scan_add_kernel(int32_t* start, int n, const int32_t* sums) {
  const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  if (i < n) start[i] += sums[blockIdx.x];
}

__global__ void dk_place_kernel(const int32_t* dst, const bool* valid,
                                long long e, int n, const int32_t* start,
                                int32_t* fill, int32_t* sorted) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= e) return;
  int d;
  if (deliverable(dst, valid, i, n, &d))
    sorted[start[d] + atomicAdd(&fill[d], 1)] = static_cast<int32_t>(i);
}

__device__ __forceinline__ void land(const Cols& cols, int q, int d,
                                     int slot, int edge, bool* inbox_valid,
                                     int32_t* edge_slot) {
  const long long row = (long long)d * q + slot;
  edge_slot[edge] = slot;
  inbox_valid[row] = true;
  copy_row(cols, edge, row);
}

// One warp per destination.  Groups of up to 32 edges are ranked here;
// larger ones are listed for dk_select_kernel.
__global__ void dk_small_groups_kernel(const int32_t* count,
                                       const int32_t* start,
                                       const int32_t* sorted, int n, int q,
                                       Cols cols, bool* inbox_valid,
                                       int32_t* n_dropped, int32_t* edge_slot,
                                       int32_t* large_list, int32_t* large_n) {
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // warp-uniform
  const int d = static_cast<int>(warp);
  const int g = count[d];
  if (lane == 0) n_dropped[d] = g > q ? g - q : 0;
  if (g == 0) return;
  if (g > 32) {
    if (lane == 0) large_list[atomicAdd(large_n, 1)] = d;
    return;
  }
  const int v = lane < g ? sorted[start[d] + lane] : INT_MAX;
  int rank = 0;
  for (int j = 0; j < g; ++j) rank += __shfl_sync(dk::FULL_MASK, v, j) < v;
  if (lane < g && rank < q) land(cols, q, d, rank, v, inbox_valid, edge_slot);
}

// Ascending bitonic sort of SEL ints in shared memory by the whole block.
__device__ void bitonic_sort(int* a) {
  for (int k = 2; k <= SEL; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < SEL; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int x = a[i], y = a[ixj];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Persistent blocks over the listed large groups: keep the SEL_HALF
// smallest edge indices seen so far in buf[0, SEL_HALF), stream the rest
// of the group through buf[SEL_HALF, SEL) and re-sort.
__global__ void dk_select_kernel(const int32_t* count, const int32_t* start,
                                 const int32_t* sorted, int q, Cols cols,
                                 bool* inbox_valid, int32_t* edge_slot,
                                 const int32_t* large_list,
                                 const int32_t* large_n) {
  __shared__ int buf[SEL];
  const int nl = *large_n;
  for (int li = blockIdx.x; li < nl; li += gridDim.x) {
    const int d = large_list[li];
    const int g = count[d];
    const int32_t* grp = sorted + start[d];
    for (int t = threadIdx.x; t < SEL; t += blockDim.x)
      buf[t] = t < g ? grp[t] : INT_MAX;
    __syncthreads();
    bitonic_sort(buf);
    for (int base = SEL; base < g; base += SEL_HALF) {
      for (int t = threadIdx.x; t < SEL_HALF; t += blockDim.x)
        buf[SEL_HALF + t] = base + t < g ? grp[base + t] : INT_MAX;
      __syncthreads();
      bitonic_sort(buf);
    }
    const int keep = g < q ? g : q;
    for (int t = threadIdx.x; t < keep; t += blockDim.x)
      land(cols, q, d, t, buf[t], inbox_valid, edge_slot);
    __syncthreads();
  }
}

}  // namespace

// scratch: int32[4 * n + 1 + ceil(n / 1024) + e], laid out as
// count[n] | fill[n] | large_n[1] | start[n] | large_list[n] | sums | sorted[e]
DK_EXPORT int dk_deliver(const int32_t* dst, const bool* valid, long long e,
                         long long n, long long q, long long k,
                         void* const* src_cols, void* const* dst_cols,
                         const long long* nbytes, bool* inbox_valid,
                         int32_t* n_dropped, int32_t* edge_slot,
                         int32_t* scratch, cudaStream_t stream) {
  if (k < 0 || k > MAX_COLS || q < 1 || q > SEL_HALF) return cudaErrorInvalidValue;
  Cols cols;
  cols.k = static_cast<int>(k);
  for (int j = 0; j < MAX_COLS; ++j) {
    cols.src[j] = j < k ? static_cast<const uint8_t*>(src_cols[j]) : nullptr;
    cols.dst[j] = j < k ? static_cast<uint8_t*>(dst_cols[j]) : nullptr;
    cols.nbytes[j] = j < k ? nbytes[j] : 0;
  }
  const int ni = static_cast<int>(n), qi = static_cast<int>(q);
  const int nb = static_cast<int>(dk::blocks_for(n, SCAN_BLOCK));
  int32_t* count = scratch;
  int32_t* fill = count + n;
  int32_t* large_n = fill + n;
  int32_t* start = large_n + 1;
  int32_t* large_list = start + n;
  int32_t* sums = large_list + n;
  int32_t* sorted = sums + nb;

  cudaMemsetAsync(count, 0, (2 * n + 1) * sizeof(int32_t), stream);
  for (int j = 0; j < k; ++j)
    cudaMemsetAsync(cols.dst[j], 0, n * q * nbytes[j], stream);
  cudaMemsetAsync(inbox_valid, 0, n * q, stream);

  const int tpb = 256;
  LAUNCH(dk_count_kernel, dk::blocks_for(e, tpb), tpb, 0, stream)(
      dst, valid, e, ni, count, edge_slot);
  LAUNCH(dk_scan_blocks_kernel, nb, SCAN_BLOCK, 0, stream)(count, ni, start,
                                                           sums);
  LAUNCH(dk_scan_sums_kernel, 1, SCAN_BLOCK, 0, stream)(sums, nb);
  LAUNCH(dk_scan_add_kernel, nb, SCAN_BLOCK, 0, stream)(start, ni, sums);
  LAUNCH(dk_place_kernel, dk::blocks_for(e, tpb), tpb, 0, stream)(
      dst, valid, e, ni, start, fill, sorted);
  LAUNCH(dk_small_groups_kernel, dk::blocks_for(n * 32, tpb), tpb, 0, stream)(
      count, start, sorted, ni, qi, cols, inbox_valid, n_dropped, edge_slot,
      large_list, large_n);
  LAUNCH(dk_select_kernel, 264, 1024, 0, stream)(count, start, sorted, qi, cols,
                                                 inbox_valid, edge_slot,
                                                 large_list, large_n);
  return static_cast<int>(cudaGetLastError());
}
