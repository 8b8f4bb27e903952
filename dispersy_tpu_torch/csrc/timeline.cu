// K8: timeline_check -- the Timeline's permission test over each peer's
// bounded [A] grant table, for [N, Q] queries: `check` (does a member
// hold one permission for a meta at a global time?) and `check_grant`
// (may a member issue a grant or revoke covering a permission mask?).
//
// Replaces dispersy_tpu/ops/timeline.py:100 `check` and :133
// `check_grant`, whose TPU form (picked through ops/intake._auto_impl,
// timeline.py:166) is a broadcast compare over [N, Q, A] per meta and a
// max / any reduction over A; the chunked form computes the same
// function one query column at a time.
//
// Bound on the H100: bytes.  The function reads the table's four [N, A]
// columns (member, mask, gt, rev: 13 B a slot), the [N, Q] queries (and
// a founder column), and writes one bool per query; the A compares per
// query are a few integer operations.
//
// Design.  One thread per (row, query) pair, 256 to a block.  A block's
// pairs cover a contiguous range of rows, whose tables it loads into
// shared memory once; each thread then walks its row's A slots.  The
// verdict is latest-wins: among the matching slots the highest gt
// (<= the query's) decides, and a revoke slot beats a grant slot at that
// gt; no matching slot means not held.  `check` tests the single bit
// sh = min(4 * meta + perm, 31) with meta < MAX_TIMELINE_META (so the
// 0xFFFF not-found sentinel and the control metas match nothing) and
// ORs in the founder; `check_grant` needs the authority bit
// 4 * k + perm for every meta k whose nibble of the query mask is
// non-empty, and an empty mask proves nothing.  Every compare is
// unsigned u32, as in the JAX package.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_A = 32;
constexpr int MAX_TIMELINE_META = 8;

struct Table {
  const uint32_t* member;
  const uint32_t* mask;
  const uint32_t* gt;
  const bool* rev;
};

// The latest-wins verdict over the row's slots whose `bit` is set.
__device__ __forceinline__ bool verdict(const uint32_t* tm,
                                        const uint32_t* tk,
                                        const uint32_t* tg, const bool* tr,
                                        int a, uint32_t member, uint32_t gt,
                                        int bit, bool bit_ok) {
  bool any = false, grant_at = false, rev_at = false;
  uint32_t best = 0;
  for (int s = 0; s < a; ++s) {
    const bool match = bit_ok && tm[s] == member && tm[s] != dk::EMPTY_U32 &&
                       ((tk[s] >> bit) & 1u) && tg[s] <= gt;
    if (!match) continue;
    if (!any || tg[s] > best) {
      best = tg[s];
      grant_at = rev_at = false;
    }
    any = true;
    if (tg[s] == best) {
      if (tr[s])
        rev_at = true;
      else
        grant_at = true;
    }
  }
  return any && grant_at && !rev_at;
}

// mode 0: check (q_key = meta, of q_key_size bytes); mode 1: check_grant
// (q_key = mask, u32).
__global__ void dk_timeline_kernel(Table t, const uint32_t* q_member,
                                   const void* q_key, int q_key_size,
                                   const uint32_t* q_gt, long long n, int q,
                                   int a, int mode, int perm, int n_meta,
                                   const uint32_t* founder,
                                   long long founder_stride,
                                   uint32_t founder_val, bool* out) {
  extern __shared__ uint8_t smem[];
  const long long first = blockIdx.x * (long long)THREADS;
  const long long total = n * q;
  const long long row0 = first / q;
  long long last = first + THREADS - 1;
  if (last >= total) last = total - 1;
  const int rows = static_cast<int>(last / q - row0 + 1);
  uint32_t* s_member = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_mask = s_member + rows * a;
  uint32_t* s_gt = s_mask + rows * a;
  bool* s_rev = reinterpret_cast<bool*>(s_gt + rows * a);
  for (int i = threadIdx.x; i < rows * a; i += THREADS) {
    const long long at = row0 * a + i;
    s_member[i] = t.member[at];
    s_mask[i] = t.mask[at];
    s_gt[i] = t.gt[at];
    s_rev[i] = t.rev[at];
  }
  __syncthreads();
  const long long p = first + threadIdx.x;
  if (p >= total) return;
  const long long row = p / q;
  const int lr = static_cast<int>(row - row0);
  const uint32_t* tm = s_member + lr * a;
  const uint32_t* tk = s_mask + lr * a;
  const uint32_t* tg = s_gt + lr * a;
  const bool* tr = s_rev + lr * a;
  const uint32_t member = q_member[p], gt = q_gt[p];
  bool ok;
  if (mode == 0) {
    const uint32_t meta = q_key_size == 1
                              ? static_cast<const uint8_t*>(q_key)[p]
                              : static_cast<const uint32_t*>(q_key)[p];
    const bool in_range = meta < MAX_TIMELINE_META;
    // 4 * meta + perm in u32, clamped to 31 (only read when in range).
    uint32_t sh = 4u * meta + static_cast<uint32_t>(perm);
    if (sh > 31u) sh = 31u;
    ok = verdict(tm, tk, tg, tr, a, member, gt, static_cast<int>(sh),
                 in_range);
    const uint32_t f =
        founder ? founder[row * founder_stride] : founder_val;
    ok = ok || member == f;
  } else {
    const uint32_t mask = static_cast<const uint32_t*>(q_key)[p];
    ok = mask != 0u;
    const int metas = n_meta < MAX_TIMELINE_META ? n_meta : MAX_TIMELINE_META;
    for (int k = 0; k < metas && ok; ++k) {
      if (((mask >> (4 * k)) & 0xFu) == 0u) continue;
      ok = verdict(tm, tk, tg, tr, a, member, gt, 4 * k + perm, true);
    }
  }
  out[p] = ok;
}

}  // namespace

// q_key: the meta (check, 1 or 4 bytes) or the mask (check_grant, 4).
// founder: a u32 column read at row * founder_stride, or null for
// founder_val.
DK_EXPORT int dk_timeline_check(
    const uint32_t* t_member, const uint32_t* t_mask, const uint32_t* t_gt,
    const bool* t_rev, const uint32_t* q_member, const void* q_key,
    long long q_key_size, const uint32_t* q_gt, long long n, long long q,
    long long a, long long mode, long long perm, long long n_meta,
    const uint32_t* founder, long long founder_stride, long long founder_val,
    bool* out, cudaStream_t stream) {
  if (a < 1 || a > MAX_A || q < 1 || n < 1 || (mode != 0 && mode != 1) ||
      perm < 0 || perm > 3 || (q_key_size != 1 && q_key_size != 4) ||
      (mode == 1 && q_key_size != 4))
    return cudaErrorInvalidValue;
  // At most THREADS rows per block (q >= 1), four table columns each.
  const size_t smem = static_cast<size_t>(THREADS + 1) * a * 13;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dk_timeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Table t{t_member, t_mask, t_gt, t_rev};
  LAUNCH(dk_timeline_kernel, dk::blocks_for(n * q, THREADS), THREADS, smem,
         stream)(t, q_member, q_key, static_cast<int>(q_key_size), q_gt, n,
                 static_cast<int>(q), static_cast<int>(a),
                 static_cast<int>(mode), static_cast<int>(perm),
                 static_cast<int>(n_meta), founder, founder_stride,
                 static_cast<uint32_t>(founder_val), out);
  return static_cast<int>(cudaGetLastError());
}
