// K7: store_stage -- append each peer's masked record batch to its staging
// buffer, in batch order, after the row's valid prefix; arrivals that
// find no free slot are dropped and counted.
//
// Replaces dispersy_tpu/ops/store.py:510 `store_stage`, the byte-diet
// store's every-round landing (a flat one-component scatter with
// mode="drop" on the TPU): rank = cumsum(mask) - 1, slot = count_valid +
// rank, landed = mask & slot < S.  The batch's aux column is narrowed to
// the staging width (u32 -> u16 under aux_bits=16) on the way in.
//
// Bound on the H100: bytes.  The function reads the staging gt column and
// the mask in full, the [N, S] staging row it copies and the batch
// columns of the arrivals that land, and writes the [N, S] staging
// columns, the landed mask and one count per row.
//
// Design.  One warp per row, S <= 32.  A ballot over gt != EMPTY counts
// the row's live entries; the lanes copy the staging row to the output;
// then the batch is walked 32 entries at a time: a ballot over the mask
// and a popcount of the lower lanes give each arrival its rank, and an
// arrival whose slot cnt + rank is below S is written there.  The
// __syncwarp between the copy and the appends orders the two writes of a
// slot.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MAX_S = 32;

struct SCols {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const void* aux;  // u32 or u16, by its aux size
  const uint8_t* flags;
};

struct SOut {
  uint32_t* gt;
  uint32_t* member;
  uint8_t* meta;
  uint32_t* payload;
  void* aux;
  uint8_t* flags;
};

__device__ __forceinline__ uint32_t load_aux(const void* p, int size,
                                             long long at) {
  return size == 2 ? static_cast<const uint16_t*>(p)[at]
                   : static_cast<const uint32_t*>(p)[at];
}

__device__ __forceinline__ void store_aux(void* p, int size, long long at,
                                          uint32_t v) {
  if (size == 2)
    static_cast<uint16_t*>(p)[at] = static_cast<uint16_t>(v);
  else
    static_cast<uint32_t*>(p)[at] = v;
}

__device__ __forceinline__ void put(const SOut& o, int o_aux, long long at,
                                    const SCols& c, int c_aux,
                                    long long from) {
  o.gt[at] = c.gt[from];
  o.member[at] = c.member[from];
  o.meta[at] = c.meta[from];
  o.payload[at] = c.payload[from];
  store_aux(o.aux, o_aux, at, load_aux(c.aux, c_aux, from));
  o.flags[at] = c.flags[from];
}

__global__ void dk_stage_kernel(SCols st, SCols bt, const bool* mask,
                                long long n, int s, int b, int st_aux,
                                int bt_aux, SOut o, bool* landed,
                                int32_t* n_dropped) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // warp-uniform
  const long long srow = row * s;
  const bool live = lane < s && st.gt[srow + lane] != dk::EMPTY_U32;
  const int cnt = __popc(__ballot_sync(dk::FULL_MASK, live));
  if (lane < s) put(o, st_aux, srow + lane, st, st_aux, srow + lane);
  __syncwarp();
  int taken = 0, dropped = 0;
  for (int base = 0; base < b; base += 32) {
    const int i = base + lane;
    const long long at = row * b + i;
    const bool mk = i < b && mask[at];
    const unsigned bal = __ballot_sync(dk::FULL_MASK, mk);
    const int slot = cnt + taken + __popc(bal & ((1u << lane) - 1u));
    const bool land = mk && slot < s;
    if (i < b) landed[at] = land;
    if (land) put(o, st_aux, srow + slot, bt, bt_aux, at);
    dropped += mk && !land;
    taken += __popc(bal);
  }
  for (int d = 16; d > 0; d >>= 1)
    dropped += __shfl_xor_sync(dk::FULL_MASK, dropped, d);
  if (lane == 0) n_dropped[row] = dropped;
}

}  // namespace

// st_aux / bt_aux: bytes of one aux element of the staging and of the
// batch (4, or 2 under aux_bits=16); the output takes the staging's.
DK_EXPORT int dk_store_stage(
    const uint32_t* s_gt, const uint32_t* s_member, const uint8_t* s_meta,
    const uint32_t* s_payload, const void* s_aux, const uint8_t* s_flags,
    const uint32_t* b_gt, const uint32_t* b_member, const uint8_t* b_meta,
    const uint32_t* b_payload, const void* b_aux, const uint8_t* b_flags,
    const bool* mask, long long n, long long s, long long b,
    long long st_aux, long long bt_aux, uint32_t* o_gt, uint32_t* o_member,
    uint8_t* o_meta, uint32_t* o_payload, void* o_aux, uint8_t* o_flags,
    bool* landed, int32_t* n_dropped, cudaStream_t stream) {
  if (s < 1 || s > MAX_S || b < 0) return cudaErrorInvalidValue;
  if ((st_aux != 2 && st_aux != 4) || (bt_aux != 2 && bt_aux != 4))
    return cudaErrorInvalidValue;
  const SCols st{s_gt, s_member, s_meta, s_payload, s_aux, s_flags};
  const SCols bt{b_gt, b_member, b_meta, b_payload, b_aux, b_flags};
  const SOut o{o_gt, o_member, o_meta, o_payload, o_aux, o_flags};
  LAUNCH(dk_stage_kernel, dk::blocks_for(n, WARPS), WARPS * 32, 0, stream)(
      st, bt, mask, n, static_cast<int>(s), static_cast<int>(b),
      static_cast<int>(st_aux), static_cast<int>(bt_aux), o, landed,
      n_dropped);
  return static_cast<int>(cudaGetLastError());
}
