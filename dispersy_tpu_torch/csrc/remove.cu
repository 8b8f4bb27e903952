// K10: store_remove -- delete the masked records of each peer's [M] store
// ring; survivors keep their order and compact left, the empty record
// fills the tail, and each row counts what it deleted.
//
// Replaces dispersy_tpu/ops/store.py:577 `store_remove`, the retro-reject
// half of the Timeline's re-walk: keep = valid & ~kill, rank = cumsum -
// 1, and the six-column rank compaction of `rank_compact_many` (:140),
// whose TPU form is one flat scatter per column with u8 column pairs
// folded into u16 scatters.
//
// Bound on the H100: bytes.  The function reads the gt column and the
// kill mask in full and the other five columns of the survivors, and
// writes the six [N, M] columns and one count per row.
//
// Design: K4's gather form (csrc/compact.cu), its slot map computed in
// the kernel.  A block takes `rows` consecutive rows (about 4096 slots):
//   1. it reads their gt and kill as one flat run each -- 16-byte gt and
//      4-byte kill vectors when M % 4 == 0 and both are aligned -- and
//      keeps each slot's state (kept, removed) in shared memory, with
//      every inverse-slot entry set to -1 (the fill);
//   2. a warp per row turns the states into ranks with one ballot per 32
//      slots and writes each survivor's index to inv[row][rank], and the
//      row's removed count;
//   3. the gather stage of csrc/compact.cuh, shared with K4: every output
//      element once, in order, each column loaded at its survivor with
//      every load of a step in flight before its stores, or the empty
//      record's fill.
// Why the block and not a warp a row: a row walked in 32-slot steps is a
// chain of dependent round trips (gt and kill, a ballot, the survivors'
// loads, their stores); here every load of a stage goes out before its
// first use, and the ranks are shared-memory work between two stages.
// The aux column is u32 or u16, by the element size the wrapper passes:
// the column mixes (4, 0, 2) and (3, 1, 2) are K4's template parameters.
#include "compact.cuh"

namespace {

using dk::CCols;
constexpr int THREADS = dk::CMP_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = dk::CMP_MAX_INV;  // a block's slots (inv, state)
constexpr int IN_PER_BLOCK = 4096;          // slots a block aims for
constexpr int UN = 4;                       // vectors a thread in flight
constexpr uint8_t KEPT = 1, REMOVED = 2;

__device__ __forceinline__ uint8_t state_of(uint32_t gt, bool kill) {
  return gt == dk::EMPTY_U32 ? 0 : kill ? REMOVED : KEPT;
}

template <bool VEC, int N4, int N2, int N1>
__global__ void __launch_bounds__(THREADS, 4)
    dk_remove_kernel(const uint32_t* gt, const bool* kill, long long n,
                     int m, int rows, CCols c, int32_t* n_removed) {
  __shared__ int16_t inv[MAX_SLOTS];
  __shared__ uint8_t state[MAX_SLOTS];
  const long long row0 = blockIdx.x * static_cast<long long>(rows);
  const int nr = static_cast<int>(min(static_cast<long long>(rows),
                                      n - row0));
  const int n_in = nr * m;

  // 1. Each slot's state from the flat runs of gt and kill.
  const uint32_t* g = gt + row0 * m;
  const bool* k = kill + row0 * m;
  if (VEC) {  // m % 4 == 0: a vector's four slots lie in one row
    const int n4 = n_in / 4;
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const uint32_t* k4 = reinterpret_cast<const uint32_t*>(k);
    for (int base = 0; base < n4; base += UN * THREADS) {
      uint4 gv[UN];
      uint32_t kv[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f4 = base + u * THREADS + threadIdx.x;
        if (f4 < n4) {
          gv[u] = __ldg(g4 + f4);
          kv[u] = __ldg(k4 + f4);
        }
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f4 = base + u * THREADS + threadIdx.x;
        if (f4 >= n4) break;
        const int f = 4 * f4;
        state[f] = state_of(gv[u].x, kv[u] & 0xFFu);
        state[f + 1] = state_of(gv[u].y, (kv[u] >> 8) & 0xFFu);
        state[f + 2] = state_of(gv[u].z, (kv[u] >> 16) & 0xFFu);
        state[f + 3] = state_of(gv[u].w, kv[u] >> 24);
        inv[f] = inv[f + 1] = inv[f + 2] = inv[f + 3] = -1;
      }
    }
  } else {
    for (int base = 0; base < n_in; base += UN * THREADS) {
      uint32_t gv[UN];
      bool kv[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f = base + u * THREADS + threadIdx.x;
        if (f < n_in) {
          gv[u] = __ldg(g + f);
          kv[u] = k[f];
        }
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f = base + u * THREADS + threadIdx.x;
        if (f >= n_in) break;
        state[f] = state_of(gv[u], kv[u]);
        inv[f] = -1;
      }
    }
  }
  __syncthreads();

  // 2. A warp per row: each survivor's rank by ballot, its index into
  // inv at the rank; the row's removed count.
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int r = threadIdx.x >> 5; r < nr; r += WARPS) {
    const uint8_t* sr = state + r * m;
    int16_t* iv = inv + r * m;
    int kept = 0, removed = 0;
    for (int base = 0; base < m; base += 32) {
      const int i = base + lane;
      const uint8_t s = i < m ? sr[i] : 0;
      const unsigned keep = __ballot_sync(dk::FULL_MASK, s == KEPT);
      removed += __popc(__ballot_sync(dk::FULL_MASK, s == REMOVED));
      if (s == KEPT)
        iv[kept + __popc(keep & below)] = static_cast<int16_t>(i);
      kept += __popc(keep);
    }
    if (lane == 0) n_removed[row0 + r] = removed;
  }
  __syncthreads();

  // 3. Every output element once: the survivor or the empty record.
  dk::gather_rows<N4, N2, N1>(inv, row0, nr, m, m, c);
}

template <int N4, int N2, int N1>
int launch(const uint32_t* gt, const bool* kill, long long n, int m,
           int rows, const CCols& c, int32_t* n_removed,
           cudaStream_t stream) {
  const bool vec = m % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(gt) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(kill) & 3) == 0;
  const auto kernel = vec ? dk_remove_kernel<true, N4, N2, N1>
                          : dk_remove_kernel<false, N4, N2, N1>;
  LAUNCH(kernel, dk::blocks_for(n, rows), THREADS, 0, stream)(
      gt, kill, n, m, rows, c, n_removed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aux_size: bytes of one aux element (4, or 2 under aux_bits=16).  The
// output columns are fresh tensors (never the input's).  M is at most
// kernels.COMPACT_MAX_WIDTH (a block's inverse slot map).
DK_EXPORT int dk_store_remove(
    const uint32_t* s_gt, const uint32_t* s_member, const uint8_t* s_meta,
    const uint32_t* s_payload, const void* s_aux, const uint8_t* s_flags,
    const bool* kill, long long n, long long m, long long aux_size,
    uint32_t* o_gt, uint32_t* o_member, uint8_t* o_meta, uint32_t* o_payload,
    void* o_aux, uint8_t* o_flags, int32_t* n_removed, cudaStream_t stream) {
  if (m < 1 || m > MAX_SLOTS || n < 0 || (aux_size != 2 && aux_size != 4))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  // The six columns grouped by element size; the empty record's fills.
  CCols c{};
  dk::add_col(&c, 4, s_gt, o_gt, dk::EMPTY_U32);
  dk::add_col(&c, 4, s_member, o_member, dk::EMPTY_U32);
  dk::add_col(&c, 4, s_payload, o_payload, dk::EMPTY_U32);
  dk::add_col(&c, aux_size, s_aux, o_aux, 0u);
  dk::add_col(&c, 1, s_meta, o_meta, 0xFFu);
  dk::add_col(&c, 1, s_flags, o_flags, 0u);
  // Rows a block: about IN_PER_BLOCK slots, within MAX_SLOTS.
  long long rows = IN_PER_BLOCK / m;
  rows = rows < 1 ? 1 : rows;
  rows = rows < MAX_SLOTS / m ? rows : MAX_SLOTS / m;
  const int mi = static_cast<int>(m), ri = static_cast<int>(rows);
  if (aux_size == 4)
    return launch<4, 0, 2>(s_gt, kill, n, mi, ri, c, n_removed, stream);
  return launch<3, 1, 2>(s_gt, kill, n, mi, ri, c, n_removed, stream);
}
