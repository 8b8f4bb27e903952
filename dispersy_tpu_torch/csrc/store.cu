// K3: store_insert -- merge a masked [B] record batch into each peer's
// [M] store ring, kill UNIQUE(member, global_time) duplicates, keep the M
// records that sort first and count what was inserted, dropped and
// evicted.  The compaction that follows the merge is fused in.
//
// Replaces dispersy_tpu/ops/store.py:265 `store_insert`: its merge form
// (`_merge_ordered` :425, picked on the TPU above M + B = 128) and its
// sort form (`_sort_ordered` :385), followed by LastSync `history`
// (:328-345: after the dup kill, evict every record with at least k newer
// live records in its (member, meta) group) and the rank compaction of
// `rank_compact_many` (:140).  The aux column is u32, or u16 under the
// byte-diet store's aux_bits=16 (store, batch and output alike).
//
// Bound on the H100: bytes.  The function reads six [N, M] columns (18 B
// per slot, 16 B with a u16 aux), six [N, B] columns and the mask, and
// writes six [N, M] columns and three counts per row.
//
// Design.  One warp per peer row.  Every load of the row -- the six
// columns of ring and batch and the mask, all W = M + B entries -- is
// issued at once into registers (the width's 32-entry chunks are a
// template parameter), so a row costs one round trip to memory; the
// records then go to shared memory sized by the call's width, each with
// its order key (gt << 32 | member; masked batch entries and records
// with gt EMPTY read as the largest key).  The order is the JAX sort
// form's, (gt, member, position in ring ++ batch): the ring's record
// first on a tie, then batch order.  Every record with gt EMPTY sorts
// after every live one and is never kept, so only the order of the live
// records matters.
//
// * A ballot over the ring's adjacent pairs tests the round invariant
//   (`_merge_ordered`'s precondition): live records sorted by
//   (gt, member), EMPTY only as a suffix.  Rows that hold it (every row
//   the engine makes) take the merge path: each batch entry's rank in
//   the batch (a count over the batch) plus a binary search for the
//   number of ring keys <= its key gives its position; the ring fills
//   the free positions in order (a ballot over a shared bitmask).
//   O(B^2 / 32 + B log M + W / 32) a lane instead of O(W^2 / 32).
// * Rows that break it rank each entry by counting the keys that sort
//   before it: O(W^2) compares, the same function on any input.
//
// The warp then walks the sorted order 32 entries at a time: a dup flag
// against the predecessor (a shuffle), a ballot and popcount for the
// compaction rank, and a copy of the surviving record from shared memory
// into output slot `rank`.  Slots past the survivors get the empty
// record.  With a history (per-meta k, at most MAX_META metas, passed by
// value in the kernel's arguments) a first walk puts the live records
// whose meta keeps k > 0 on a short list, in sorted order, by ballot;
// each counts the later list entries of its (member, meta) -- after the
// dup kill later means a higher gt -- and dies at k; a second walk
// compacts.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int WMAX = 256;     // M + B (sorted positions fit a byte)
constexpr int MAX_META = 24;  // config.MAX_USER_META
constexpr uint64_t EMPTY_KEY = ~0ull;

struct Cols6 {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const void* aux;  // u32, or u16 when aux2
  const uint8_t* flags;
};

struct History {  // LastSync keep-last-k per user meta (0: keep all)
  int32_t k[MAX_META];
};

struct Out6 {
  uint32_t* gt;
  uint32_t* member;
  uint8_t* meta;
  uint32_t* payload;
  void* aux;
  uint8_t* flags;
};

// One warp's shared memory for a row of width W: the u64 order keys, the
// u32 payload, aux and candidate-list member, six u8 arrays (meta, flags,
// the sorted permutation, the live marks, the list's meta and sorted
// position), then the merge path's 8-word taken-position bitmask.
__host__ __device__ inline int taken_at(int w) {
  return ((26 * w + 3) / 4) * 4;
}

__host__ __device__ inline int warp_smem(int w) {
  return ((taken_at(w) + 32 + 15) / 16) * 16;
}

template <int NC>  // chunks of 32 entries: ceil(W / 32)
__global__ void __launch_bounds__(WARPS * 32)
    dk_insert_kernel(Cols6 s, Cols6 bt, const bool* mask, long long n,
                     int m, int b, bool aux2, History hist, int n_hist,
                     Out6 o, int32_t* n_inserted, int32_t* n_dropped,
                     int32_t* n_evicted) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)WARPS + w;
  if (row >= n) return;  // warp-uniform; only warp-level sync below
  const int width = m + b;
  uint8_t* base = smem + w * warp_smem(width);
  uint64_t* kk = reinterpret_cast<uint64_t*>(base);
  uint32_t* kp = reinterpret_cast<uint32_t*>(kk + width);
  uint32_t* ka = kp + width;
  uint32_t* cm = ka + width;  // candidate list: member
  uint8_t* kt = reinterpret_cast<uint8_t*>(cm + width);
  uint8_t* kf = kt + width;
  uint8_t* perm = kf + width;  // sorted position -> concat index
  uint8_t* lv = perm + width;  // live, by sorted position
  uint8_t* ct = lv + width;    // candidate list: meta
  uint8_t* cp = ct + width;    // candidate list: sorted position
  uint32_t* taken = reinterpret_cast<uint32_t*>(base + taken_at(width));
  const unsigned lt = (1u << lane) - 1u;

  uint32_t g[NC], mb[NC], pay[NC], ax[NC];
  uint8_t mt[NC], fl[NC];
  bool ok[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = c * 32 + lane;
    const bool ring = i < m;
    const long long at = ring ? row * m + i : row * b + (i - m);
    g[c] = mb[c] = pay[c] = dk::EMPTY_U32;
    ax[c] = 0;
    mt[c] = 0xFF;
    fl[c] = 0;
    ok[c] = false;
    if (i < width) {
      const Cols6& src = ring ? s : bt;
      g[c] = src.gt[at];
      mb[c] = src.member[at];
      mt[c] = src.meta[at];
      pay[c] = src.payload[at];
      ax[c] = aux2 ? static_cast<const uint16_t*>(src.aux)[at]
                   : static_cast<const uint32_t*>(src.aux)[at];
      fl[c] = src.flags[at];
      ok[c] = ring || mask[at];
    }
  }
  int before = 0, new_valid = 0;  // warp-uniform
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = c * 32 + lane;
    const bool live = ok[c] && g[c] != dk::EMPTY_U32;
    before += __popc(__ballot_sync(dk::FULL_MASK, live && i < m));
    new_valid += __popc(__ballot_sync(dk::FULL_MASK, live && i >= m));
    if (i < width) {
      kk[i] = live ? (uint64_t{g[c]} << 32) | mb[c] : EMPTY_KEY;
      kt[i] = ok[c] ? mt[c] : 0xFF;
      kp[i] = pay[c];
      ka[i] = ax[c];
      kf[i] = fl[c];
    }
  }
  if (lane < 8) taken[lane] = 0u;
  __syncwarp();

  // The ring invariant: keys non-decreasing, so live records sorted with
  // EMPTY (the largest key) only as a suffix.
  bool ordered = true;
  for (int i = lane; i + 1 < m; i += 32) ordered &= kk[i] <= kk[i + 1];
  if (__all_sync(dk::FULL_MASK, ordered)) {
    for (int j = lane; j < b; j += 32) {
      const uint64_t k = kk[m + j];
      int r = 0;
      for (int q = 0; q < b; ++q) {
        const uint64_t kq = kk[m + q];
        r += kq < k || (kq == k && q < j);
      }
      int lo = m;  // ring keys <= this key: the ring wins ties
      if (k != EMPTY_KEY) {
        lo = 0;
        int hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (k < kk[mid])
            hi = mid;
          else
            lo = mid + 1;
        }
      }
      const int p = r + lo;
      perm[p] = static_cast<uint8_t>(m + j);
      atomicOr(&taken[p >> 5], 1u << (p & 31));
    }
    __syncwarp();
    int next = 0;  // the ring's next index, warp-uniform
    for (int c = 0; c * 32 < width; ++c) {
      const int p = c * 32 + lane;
      unsigned free_ = ~taken[c];
      if (width - c * 32 < 32) free_ &= (1u << (width - c * 32)) - 1u;
      if ((free_ >> lane) & 1u)
        perm[p] = static_cast<uint8_t>(next + __popc(free_ & lt));
      next += __popc(free_);
    }
  } else {
    for (int i = lane; i < width; i += 32) {
      const uint64_t k = kk[i];
      int r = 0;
      for (int j = 0; j < width; ++j) {
        const uint64_t kj = kk[j];
        r += kj < k || (kj == k && j < i);
      }
      perm[r] = static_cast<uint8_t>(i);
    }
  }
  __syncwarp();

  // Walk the sorted order: live = not EMPTY and not a dup of its
  // predecessor (carried across chunks from lane 31).
  uint64_t carry = EMPTY_KEY;
  const bool hist_on = n_hist > 0;
  int n_cand = 0;
  for (int c = 0; c * 32 < width; ++c) {
    const int p = c * 32 + lane;
    uint64_t k = EMPTY_KEY;
    int t = 0xFF;
    if (p < width) {
      const int i = perm[p];
      k = kk[i];
      t = kt[i];
    }
    uint64_t pk = __shfl_up_sync(dk::FULL_MASK, k, 1);
    if (lane == 0) pk = carry;
    carry = __shfl_sync(dk::FULL_MASK, k, 31);
    const bool live = k != EMPTY_KEY && !(p > 0 && k == pk);
    if (hist_on) {
      const bool cand = live && t < n_hist && hist.k[t] > 0;
      const unsigned bal = __ballot_sync(dk::FULL_MASK, cand);
      if (cand) {
        const int at = n_cand + __popc(bal & lt);
        cm[at] = static_cast<uint32_t>(k);
        ct[at] = static_cast<uint8_t>(t);
        cp[at] = static_cast<uint8_t>(p);
      }
      n_cand += __popc(bal);
    }
    if (p < width) lv[p] = live;
  }
  __syncwarp();
  if (hist_on) {
    for (int a = lane; a < n_cand; a += 32) {
      const uint32_t member = cm[a];
      const uint8_t t = ct[a];
      const int k = hist.k[t];
      int newer = 0;
      for (int q = a + 1; q < n_cand && newer < k; ++q)
        newer += cm[q] == member && ct[q] == t;
      if (newer >= k) lv[cp[a]] = 0;
    }
    __syncwarp();
  }

  int kept = 0, ins = 0, old_kept = 0;  // warp-uniform
  for (int c = 0; c * 32 < width; ++c) {
    const int p = c * 32 + lane;
    const bool keep = p < width && lv[p];
    const unsigned bal = __ballot_sync(dk::FULL_MASK, keep);
    const int r = kept + __popc(bal & lt);
    const int i = keep ? perm[p] : 0;
    const bool put = keep && r < m;
    if (put) {
      const long long at = row * m + r;
      const uint64_t k = kk[i];
      o.gt[at] = static_cast<uint32_t>(k >> 32);
      o.member[at] = static_cast<uint32_t>(k);
      o.meta[at] = kt[i];
      o.payload[at] = kp[i];
      if (aux2)
        static_cast<uint16_t*>(o.aux)[at] = static_cast<uint16_t>(ka[i]);
      else
        static_cast<uint32_t*>(o.aux)[at] = ka[i];
      o.flags[at] = kf[i];
    }
    ins += __popc(__ballot_sync(dk::FULL_MASK, put && i >= m));
    old_kept += __popc(__ballot_sync(dk::FULL_MASK, put && i < m));
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
  if (lane == 0) {
    n_inserted[row] = ins;
    n_dropped[row] = new_valid - ins;
    n_evicted[row] = before - old_kept;
  }
}

template <int NC>
void launch(const Cols6& s, const Cols6& bt, const bool* mask, long long n,
            int m, int b, bool aux2, const History& h, int n_hist,
            const Out6& o, int32_t* counts, cudaStream_t stream) {
  const auto kernel = dk_insert_kernel<NC>;
  LAUNCH(kernel, dk::blocks_for(n, WARPS), WARPS * 32,
         WARPS * warp_smem(m + b), stream)(s, bt, mask, n, m, b, aux2, h,
                                           n_hist, o, counts, counts + n,
                                           counts + 2 * n);
}

}  // namespace

// aux_size: bytes of one aux element (4, or 2 under aux_bits=16).  hist:
// a host array of the n_hist per-meta keep-last-k values (n_hist 0: no
// LastSync meta), copied into the kernel's arguments.
DK_EXPORT int dk_store_insert(
    const uint32_t* s_gt, const uint32_t* s_member, const uint8_t* s_meta,
    const uint32_t* s_payload, const void* s_aux, const uint8_t* s_flags,
    const uint32_t* b_gt, const uint32_t* b_member, const uint8_t* b_meta,
    const uint32_t* b_payload, const void* b_aux, const uint8_t* b_flags,
    const bool* mask, long long n, long long m, long long b,
    long long aux_size, const int32_t* hist, long long n_hist,
    uint32_t* o_gt, uint32_t* o_member, uint8_t* o_meta,
    uint32_t* o_payload, void* o_aux, uint8_t* o_flags, int32_t* counts,
    cudaStream_t stream) {
  if (m < 1 || b < 0 || m + b > WMAX) return cudaErrorInvalidValue;
  if (aux_size != 2 && aux_size != 4) return cudaErrorInvalidValue;
  if (n_hist < 0 || n_hist > MAX_META) return cudaErrorInvalidValue;
  History h{};
  for (int i = 0; i < n_hist; ++i) h.k[i] = hist[i];
  const Cols6 s{s_gt, s_member, s_meta, s_payload, s_aux, s_flags};
  const Cols6 bt{b_gt, b_member, b_meta, b_payload, b_aux, b_flags};
  const Out6 o{o_gt, o_member, o_meta, o_payload, o_aux, o_flags};
  const int mi = static_cast<int>(m), bi = static_cast<int>(b);
  const int hi = static_cast<int>(n_hist);
  const bool a2 = aux_size == 2;
  switch ((mi + bi + 31) / 32) {
    case 1: launch<1>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 2: launch<2>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 3: launch<3>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 4: launch<4>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 5: launch<5>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 6: launch<6>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    case 7: launch<7>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
      break;
    default: launch<8>(s, bt, mask, n, mi, bi, a2, h, hi, o, counts, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
