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
// Design.  One warp per row, as K7: the row is walked 32 slots at a
// time; a ballot over keep and a popcount of the lower lanes plus the
// running survivor count give each survivor its output slot, where its
// six columns are copied.  The lanes then write the empty record into
// the slots past the survivors.  The aux column is u32 or u16, by the
// element size the wrapper passes (as K4 and K7 take it).
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

struct RCols {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const void* aux;
  const uint8_t* flags;
};

struct ROut {
  uint32_t* gt;
  uint32_t* member;
  uint8_t* meta;
  uint32_t* payload;
  void* aux;
  uint8_t* flags;
};

__global__ void dk_remove_kernel(RCols c, const bool* kill, long long n,
                                 int m, bool aux2, ROut o,
                                 int32_t* n_removed) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // warp-uniform
  const long long base_at = row * m;
  int kept = 0, removed = 0;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    bool keep = false;
    if (i < m) {
      const bool valid = c.gt[base_at + i] != dk::EMPTY_U32;
      const bool k = kill[base_at + i];
      keep = valid && !k;
      removed += valid && k;
    }
    const unsigned bal = __ballot_sync(dk::FULL_MASK, keep);
    const int r = kept + __popc(bal & ((1u << lane) - 1u));
    kept += __popc(bal);
    if (keep) {
      const long long at = base_at + r, from = base_at + i;
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
  }
  for (int t = kept + lane; t < m; t += 32) {
    const long long at = base_at + t;
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
  for (int d = 16; d > 0; d >>= 1)
    removed += __shfl_xor_sync(dk::FULL_MASK, removed, d);
  if (lane == 0) n_removed[row] = removed;
}

}  // namespace

// aux_size: bytes of one aux element (4, or 2 under aux_bits=16).  The
// output columns are fresh tensors (never the input's).
DK_EXPORT int dk_store_remove(
    const uint32_t* s_gt, const uint32_t* s_member, const uint8_t* s_meta,
    const uint32_t* s_payload, const void* s_aux, const uint8_t* s_flags,
    const bool* kill, long long n, long long m, long long aux_size,
    uint32_t* o_gt, uint32_t* o_member, uint8_t* o_meta, uint32_t* o_payload,
    void* o_aux, uint8_t* o_flags, int32_t* n_removed, cudaStream_t stream) {
  if (m < 1 || (aux_size != 2 && aux_size != 4)) return cudaErrorInvalidValue;
  const RCols c{s_gt, s_member, s_meta, s_payload, s_aux, s_flags};
  const ROut o{o_gt, o_member, o_meta, o_payload, o_aux, o_flags};
  LAUNCH(dk_remove_kernel, dk::blocks_for(n, WARPS), WARPS * 32, 0, stream)(
      c, kill, n, static_cast<int>(m), aux_size == 2, o, n_removed);
  return static_cast<int>(cudaGetLastError());
}
