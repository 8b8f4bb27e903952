// K3: store_insert -- merge a masked [B] record batch into each peer's
// [M] store ring, kill UNIQUE(member, global_time) duplicates, keep the M
// records that sort first and count what was inserted, dropped and
// evicted.  The compaction that follows the merge is fused in.
//
// Replaces dispersy_tpu/ops/store.py:265 `store_insert`: its merge form
// (`_merge_ordered` :425, picked on the TPU above M + B = 128) and its
// sort form (`_sort_ordered` :385), followed by the rank compaction of
// `rank_compact_many` (:140).  LastSync `history` is not taken: the
// wrapper raises for it.  The aux column is u32, or u16 under the
// byte-diet store's aux_bits=16 (store, batch and output alike).
//
// Bound on the H100: bytes.  The function reads six [N, M] columns (18 B
// per slot, 16 B with a u16 aux), six [N, B] columns and the mask, and
// writes six [N, M] columns and three counts per row.
//
// Design.  One warp per peer row.  The row's (gt, member) keys, masked
// batch entries replaced by EMPTY, go to shared memory; each lane ranks
// its entries by counting the keys that sort before them on
// (gt, member, position in ring ++ batch) -- the JAX sort form's key, so
// no precondition on the ring's order is needed and ties resolve exactly
// as there: the ring's record first, then batch order.  The warp then
// walks the sorted order 32 entries at a time: a dup flag against the
// predecessor, a ballot and popcount for the compaction rank, and a
// direct copy of the surviving record's six columns from its source row
// into output slot `rank`.  Slots past the survivors are filled with the
// empty record.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int WMAX = 256;  // M + B

struct Cols6 {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const void* aux;  // u32, or u16 when aux2
  const uint8_t* flags;
};

struct Out6 {
  uint32_t* gt;
  uint32_t* member;
  uint8_t* meta;
  uint32_t* payload;
  void* aux;
  uint8_t* flags;
};

__device__ __forceinline__ void put(const Out6& o, long long at,
                                    const Cols6& c, long long from,
                                    bool aux2) {
  o.gt[at] = c.gt[from];
  o.member[at] = c.member[from];
  o.meta[at] = c.meta[from];
  o.payload[at] = c.payload[from];
  if (aux2)
    static_cast<uint16_t*>(o.aux)[at] =
        static_cast<const uint16_t*>(c.aux)[from];
  else
    static_cast<uint32_t*>(o.aux)[at] =
        static_cast<const uint32_t*>(c.aux)[from];
  o.flags[at] = c.flags[from];
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(dk::FULL_MASK, v, o);
  return v;
}

__global__ void dk_insert_kernel(Cols6 s, Cols6 bt, const bool* mask,
                                 long long n, int m, int b, bool aux2,
                                 Out6 o, int32_t* n_inserted,
                                 int32_t* n_dropped,
                                 int32_t* n_evicted) {
  __shared__ uint32_t kg[WARPS][WMAX];
  __shared__ uint32_t km[WARPS][WMAX];
  __shared__ int perm[WARPS][WMAX];  // sorted position -> concat index
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)WARPS + w;
  if (row >= n) return;  // warp-uniform; only warp-level sync below
  const int width = m + b;

  int before = 0, new_valid = 0;
  for (int i = lane; i < width; i += 32) {
    uint32_t g, mb;
    if (i < m) {
      g = s.gt[row * m + i];
      mb = s.member[row * m + i];
      before += g != dk::EMPTY_U32;
    } else {
      const long long j = row * b + (i - m);
      const bool ok = mask[j];
      g = ok ? bt.gt[j] : dk::EMPTY_U32;
      mb = ok ? bt.member[j] : dk::EMPTY_U32;
      new_valid += g != dk::EMPTY_U32;
    }
    kg[w][i] = g;
    km[w][i] = mb;
  }
  __syncwarp();
  for (int i = lane; i < width; i += 32) {
    const uint32_t g = kg[w][i], mb = km[w][i];
    int r = 0;
    for (int j = 0; j < width; ++j) {
      const uint32_t gj = kg[w][j], mj = km[w][j];
      r += (gj < g) || (gj == g && (mj < mb || (mj == mb && j < i)));
    }
    perm[w][r] = i;
  }
  __syncwarp();

  int kept = 0;  // warp-uniform running survivor count
  int ins = 0, old_kept = 0;
  for (int base = 0; base < width; base += 32) {
    const int p = base + lane;
    bool keep = false;
    int i = 0;
    if (p < width) {
      i = perm[w][p];
      const uint32_t g = kg[w][i];
      bool dup = false;
      if (p > 0) {
        const int ip = perm[w][p - 1];
        dup = g == kg[w][ip] && km[w][i] == km[w][ip] && g != dk::EMPTY_U32;
      }
      keep = g != dk::EMPTY_U32 && !dup;
    }
    const unsigned bal = __ballot_sync(dk::FULL_MASK, keep);
    const int r = kept + __popc(bal & ((1u << lane) - 1u));
    if (keep && r < m) {
      if (i < m) {
        put(o, row * m + r, s, row * m + i, aux2);
        ++old_kept;
      } else {
        put(o, row * m + r, bt, row * b + (i - m), aux2);
        ++ins;
      }
    }
    kept += __popc(bal);
  }
  const int filled = kept < m ? kept : m;
  for (int t = filled + lane; t < m; t += 32) {
    const long long at = row * m + t;
    o.gt[at] = dk::EMPTY_U32;
    o.member[at] = dk::EMPTY_U32;
    o.meta[at] = 0xFF;
    o.payload[at] = dk::EMPTY_U32;
    if (aux2)
      static_cast<uint16_t*>(o.aux)[at] = 0u;
    else
      static_cast<uint32_t*>(o.aux)[at] = 0u;
    o.flags[at] = 0;
  }
  before = warp_sum(before);
  new_valid = warp_sum(new_valid);
  ins = warp_sum(ins);
  old_kept = warp_sum(old_kept);
  if (lane == 0) {
    n_inserted[row] = ins;
    n_dropped[row] = new_valid - ins;
    n_evicted[row] = before - old_kept;
  }
}

}  // namespace

// aux_size: bytes of one aux element (4, or 2 under aux_bits=16).
DK_EXPORT int dk_store_insert(
    const uint32_t* s_gt, const uint32_t* s_member, const uint8_t* s_meta,
    const uint32_t* s_payload, const void* s_aux, const uint8_t* s_flags,
    const uint32_t* b_gt, const uint32_t* b_member, const uint8_t* b_meta,
    const uint32_t* b_payload, const void* b_aux, const uint8_t* b_flags,
    const bool* mask, long long n, long long m, long long b,
    long long aux_size, uint32_t* o_gt, uint32_t* o_member, uint8_t* o_meta,
    uint32_t* o_payload, void* o_aux, uint8_t* o_flags, int32_t* counts,
    cudaStream_t stream) {
  if (m < 1 || b < 0 || m + b > WMAX) return cudaErrorInvalidValue;
  if (aux_size != 2 && aux_size != 4) return cudaErrorInvalidValue;
  const Cols6 s{s_gt, s_member, s_meta, s_payload, s_aux, s_flags};
  const Cols6 bt{b_gt, b_member, b_meta, b_payload, b_aux, b_flags};
  const Out6 o{o_gt, o_member, o_meta, o_payload, o_aux, o_flags};
  LAUNCH(dk_insert_kernel, dk::blocks_for(n, WARPS), WARPS * 32, 0, stream)(
      s, bt, mask, n, static_cast<int>(m), static_cast<int>(b), aux_size == 2,
      o, counts, counts + n, counts + 2 * n);
  return static_cast<int>(cudaGetLastError());
}
