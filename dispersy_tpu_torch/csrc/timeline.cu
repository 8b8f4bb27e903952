// K8: timeline_check -- the Timeline's permission test over each peer's
// bounded [A] grant table, for [N, Q] queries: `check` (does a member
// hold a permission for a meta at a global time?), for up to three
// (meta, perm) pairs of one query in one walk, and `check_grant` (may a
// member issue a grant or revoke covering a permission mask?), with one
// perm for every query or REVOKE / AUTHORIZE by a per-query flag.
//
// Replaces dispersy_tpu/ops/timeline.py:100 `check` and :133
// `check_grant`, whose TPU form (picked through ops/intake._auto_impl,
// timeline.py:166) is a broadcast compare over [N, Q, A] per meta and a
// max / any reduction over A; the chunked form computes the same
// function one query column at a time.
//
// Bound on the H100: bytes.  The function reads the table's four [N, A]
// columns (member, mask, gt, rev: 13 B a slot), the [N, Q] queries (and
// a founder column), and writes one bool per query and pair; the A
// compares per query are a few integer operations.
//
// Design.  A group of G lanes per row (G the power of two >= Q / 6, at
// most 32; 32 / G rows a warp), each lane taking every G-th query of its
// row -- six at Q = 24 and 48, so no lane idles and a lane's table serves
// six queries.  Each lane issues the loads of its six queries and reads
// its row's table straight into
// registers -- at A = 8 with 16-byte vector loads, every lane of the
// group on the same addresses -- in one wave: no shared memory, no
// barrier, no lane talks to another.  The verdict is latest-wins: among
// the matching slots the highest gt (<= the query's) decides, and a
// revoke slot beats a grant slot at that gt; no matching slot means not
// held.  That is one
// maximum of the slot key 1 + (gt << 1 | rev): the permission is held
// iff some slot matches and the maximum key is a grant's (a revoke's key
// is one above a grant's at the same gt).  At A = 8 each lane keeps the
// 32-bit keys of its row's slots beside their members and masks; when
// every gt of the row is below 0x7FFFFFFF, gt <= the query's is key <=
// 2 * gt + 2 (every key, for a query's gt of 0x7FFFFFFF or more) and the
// walk is three compares, a select and a maximum a slot and pair.  Rows
// whose own gts reach 2^31, and other widths, take 64-bit keys from
// device memory.  A query of the EMPTY member -- a free store slot or
// batch entry -- takes no walk: it matches only free slots, which hold
// nothing.  `check` tests the single bit min(4 *
// meta + perm, 31) of a meta < MAX_TIMELINE_META (so the 0xFFFF
// not-found sentinel and the control metas match nothing) and ORs in
// the founder; `check_grant` keeps one maximum per meta in the same walk
// and needs the authority bit 4 * k + perm for every meta k whose nibble
// of the query mask is non-empty; an empty mask proves nothing.  The
// pair count of `check` and the meta count of `check_grant` are template
// parameters: no issue slot goes to a pair or a meta the call lacks.
// Every compare is unsigned u32, as in the JAX package.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_A = 32;
constexpr int MAX_PAIRS = 3;
constexpr int QL = 6;  // queries a lane holds at once
constexpr int MIN_BLOCKS = 3;  // blocks a multiprocessor (80 registers)
constexpr int MAX_TIMELINE_META = 8;
constexpr int PERM_AUTHORIZE = 1;  // config.PERM_AUTHORIZE
constexpr int PERM_REVOKE = 2;     // config.PERM_REVOKE

struct Table {
  const uint32_t* member;
  const uint32_t* mask;
  const uint32_t* gt;
  const bool* rev;
};

struct Queries {
  const uint32_t* member;
  const uint32_t* gt;
  // check (pairs 1-3): one key column (u8 or u32 metas) and perm per
  // pair, one out column each; check_grant (pairs 0): key[0] the u32
  // masks, perm[0] the perm of every query, or with `is_rev` REVOKE
  // where set and AUTHORIZE elsewhere.
  const void* key[MAX_PAIRS];
  int key_size[MAX_PAIRS];
  int perm[MAX_PAIRS];
  int pairs;
  int n_meta;
  const bool* is_rev;
  const uint32_t* founder;  // a column read at row * founder_stride
  long long founder_stride;
  uint32_t founder_val;     // when `founder` is null
  bool* out[MAX_PAIRS];
};

// A slot's latest-wins key, 1 + (gt << 1 | rev): never 0 (no slot
// matched), and a revoke's key one above a grant's at the same gt.
template <typename K>
__device__ __forceinline__ K slot_key(uint32_t sg, uint32_t sr) {
  return K(1) + ((K(sg) << 1) | K(sr));
}

template <typename K>
__device__ __forceinline__ bool held(K best) {
  return best != 0 && !((best - 1) & 1);
}

// A row of A = 8 slots in registers (16-byte loads; the host checks the
// alignment): member, mask and the 32-bit slot key, valid (`fits`) when
// every gt is below 0x7FFFFFFF.  Then gt <= the query's iff key <= 2 *
// gt + 2, so the gt column is not kept.
struct Row8 {
  uint32_t m[8], k[8], kk[8];
  bool fits = false;
  __device__ __forceinline__ Row8() {}
  __device__ __forceinline__ Row8(const Table& t, long long row) {
    const uint4* pm = reinterpret_cast<const uint4*>(t.member + row * 8);
    const uint4* pk = reinterpret_cast<const uint4*>(t.mask + row * 8);
    const uint4* pg = reinterpret_cast<const uint4*>(t.gt + row * 8);
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(t.rev + row * 8));
    uint32_t top = 0;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 a = __ldg(pm + v), b = __ldg(pk + v), c = __ldg(pg + v);
      const uint32_t g[4] = {c.x, c.y, c.z, c.w};
      m[4 * v] = a.x, m[4 * v + 1] = a.y, m[4 * v + 2] = a.z,
      m[4 * v + 3] = a.w;
      k[4 * v] = b.x, k[4 * v + 1] = b.y, k[4 * v + 2] = b.z,
      k[4 * v + 3] = b.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t rv = ((v ? r.y : r.x) >> (8 * i)) & 0xFFu;
        kk[4 * v + i] = slot_key<uint32_t>(g[i], rv != 0);
        top = top > g[i] ? top : g[i];
      }
    }
    fits = top < 0x7FFFFFFFu;
  }
};

__device__ __forceinline__ uint32_t load_key(const void* p, int size,
                                             long long at) {
  return size == 1 ? static_cast<const uint8_t*>(p)[at]
                   : static_cast<const uint32_t*>(p)[at];
}

// best[i]: the maximum key of the slots that match the query's (member,
// gt) and carry a bit of qbit[i]; ok[i] whether it is a grant's.  From
// the registers of a Row8 whose keys fit: a slot's gt is <= the query's
// iff its key is <= 2 * gt + 2, and every slot's is when the query's gt
// is 0x7FFFFFFF or more (2 * gt + 2 would not fit in 32 bits).
template <int NB>
__device__ __forceinline__ void walk32(const Row8& t, uint32_t qm,
                                       uint32_t qg, const uint32_t* qbit,
                                       bool* ok) {
  const uint32_t lim = qg < 0x7FFFFFFFu ? 2u * qg + 2u : 0xFFFFFFFFu;
  uint32_t best[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) best[i] = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t cand = t.kk[s] <= lim && t.m[s] == qm ? t.kk[s] : 0u;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t c = (t.k[s] & qbit[i]) ? cand : 0u;
      best[i] = best[i] > c ? best[i] : c;
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) ok[i] = held(best[i]);
}

// The same from device memory, any A, with 64-bit keys.
template <int NB>
__device__ __forceinline__ void walk64(const Table& t, long long row, int a,
                                       uint32_t qm, uint32_t qg,
                                       const uint32_t* qbit, bool* ok) {
  uint64_t best[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) best[i] = 0;
  const long long at = row * a;
  for (int s = 0; s < a; ++s) {
    const uint32_t sm = __ldg(t.member + at + s), sg = __ldg(t.gt + at + s);
    if (sm != qm || sg > qg) continue;
    const uint32_t sk = __ldg(t.mask + at + s);
    const uint64_t ks = slot_key<uint64_t>(
        sg, __ldg(reinterpret_cast<const uint8_t*>(t.rev) + at + s) != 0);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (sk & qbit[i]) best[i] = best[i] > ks ? best[i] : ks;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) ok[i] = held(best[i]);
}

// check (P pairs, NM = 0) or check_grant (P = 0, NM metas), the table in
// registers (KA = 8) or read from device memory (KA = 0).  A lane holds
// QL queries at once: all their loads go out with the table's.
template <int KA, int P, int NM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dk_timeline_kernel(Table t, Queries qs, long long n, int q, int a,
                       int lg) {
  constexpr int NB = P ? P : (NM ? NM : 1);
  constexpr int PK = P ? P : 1;
  const int lane = threadIdx.x & 31;
  const long long row =
      ((blockIdx.x * (long long)THREADS + threadIdx.x) >> 5 << (5 - lg)) +
      (lane >> lg);
  const int qi = lane & ((1 << lg) - 1);
  if (row >= n || qi >= q) return;
  uint32_t founder = qs.founder_val;
  if (P && qs.founder) founder = qs.founder[row * qs.founder_stride];
  for (int q0 = qi; q0 < q; q0 += QL << lg) {
    uint32_t qm[QL], qg[QL], key[QL][PK];
    bool rv[QL];
#pragma unroll
    for (int j = 0; j < QL; ++j) {
      const int qq = q0 + (j << lg);
      const long long p = row * q + (qq < q ? qq : q0);
      qm[j] = qs.member[p], qg[j] = qs.gt[p];
#pragma unroll
      for (int i = 0; i < PK; ++i)
        key[j][i] = load_key(qs.key[i], qs.key_size[i], p);
      rv[j] = !P && qs.is_rev && qs.is_rev[p];
    }
    const Row8 tab = KA ? Row8(t, row) : Row8();
#pragma unroll
    for (int j = 0; j < QL; ++j) {
      const int qq = q0 + (j << lg);
      if (qq >= q) break;
      const long long p = row * q + qq;
      // The bit each pair or meta needs: check, bit min(4 * meta + perm,
      // 31) of a meta in the nibble range (else none); check_grant, bit
      // 4k + perm of meta k.
      uint32_t qbit[NB];
      if (P) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const uint32_t s =
              4u * key[j][i] + static_cast<uint32_t>(qs.perm[i]);
          qbit[i] = key[j][i] < MAX_TIMELINE_META ? 1u << (s > 31u ? 31u : s)
                                                  : 0u;
        }
      } else {
        const int perm = !qs.is_rev ? qs.perm[0]
                         : rv[j]    ? PERM_REVOKE
                                    : PERM_AUTHORIZE;
#pragma unroll
        for (int k = 0; k < NB; ++k) qbit[k] = NM ? 1u << (4 * k + perm) : 0u;
      }
      // A matching slot is live: its member equals the query's, so a
      // query member of EMPTY_U32 matches only free slots, and nothing.
      bool ok[NB] = {};
      if (qm[j] == dk::EMPTY_U32) {
      } else if (KA && tab.fits) {
        walk32<NB>(tab, qm[j], qg[j], qbit, ok);
      } else {
        walk64<NB>(t, row, a, qm[j], qg[j], qbit, ok);
      }
      if (P) {
#pragma unroll
        for (int i = 0; i < P; ++i) qs.out[i][p] = ok[i] || qm[j] == founder;
      } else {
        const uint32_t mask = key[j][0];
        bool all = mask != 0u;
#pragma unroll
        for (int k = 0; k < NM; ++k)
          if ((mask >> (4 * k)) & 0xFu) all = all && ok[k];
        qs.out[0][p] = all;
      }
    }
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

using Kernel = void (*)(Table, Queries, long long, int, int, int);

// Pairs 1-3 for any check_many call (the engine's intake makes three,
// its other checks one); metas 0-8 for any n_meta.
template <int KA>
Kernel pick(int pairs, int n_meta) {
  switch (pairs) {
    case 1: return dk_timeline_kernel<KA, 1, 0>;
    case 2: return dk_timeline_kernel<KA, 2, 0>;
    case 3: return dk_timeline_kernel<KA, 3, 0>;
  }
  switch (n_meta) {
    case 1: return dk_timeline_kernel<KA, 0, 1>;
    case 2: return dk_timeline_kernel<KA, 0, 2>;
    case 3: return dk_timeline_kernel<KA, 0, 3>;
    case 4: return dk_timeline_kernel<KA, 0, 4>;
    case 5: return dk_timeline_kernel<KA, 0, 5>;
    case 6: return dk_timeline_kernel<KA, 0, 6>;
    case 7: return dk_timeline_kernel<KA, 0, 7>;
    case 8: return dk_timeline_kernel<KA, 0, 8>;
  }
  return dk_timeline_kernel<KA, 0, 0>;
}

// pairs 1-3: check; pairs 0: check_grant over qs.n_meta metas.  G, the
// lanes a row, is the power of two >= Q / QL (at most 32): at Q = 24 and
// 48 every lane takes six queries.
int launch(const Table& t, const Queries& qs, long long n, long long q,
           long long a, cudaStream_t stream) {
  int lg = 0;
  while (lg < 5 && QL * (1ll << lg) < q) ++lg;
  const long long rows_per_block = (THREADS / 32) << (5 - lg);
  const unsigned blocks = dk::blocks_for(n, static_cast<int>(rows_per_block));
  const bool vec = a == 8 && aligned(t.member, 16) && aligned(t.mask, 16) &&
                   aligned(t.gt, 16) && aligned(t.rev, 8);
  const Kernel k = vec ? pick<8>(qs.pairs, qs.n_meta)
                       : pick<0>(qs.pairs, qs.n_meta);
  LAUNCH(k, blocks, THREADS, 0, stream)(t, qs, n, static_cast<int>(q),
                                        static_cast<int>(a), lg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// check over `pairs` (meta, perm) pairs of one (member, gt) query: keys,
// key_sizes (1 or 4 bytes), perms and outs are host arrays of `pairs`
// entries.  founder: a u32 column read at row * founder_stride, or null
// for founder_val.
DK_EXPORT int dk_timeline_check(
    const uint32_t* t_member, const uint32_t* t_mask, const uint32_t* t_gt,
    const bool* t_rev, const uint32_t* q_member, const uint32_t* q_gt,
    long long n, long long q, long long a, long long pairs,
    const void* const* keys, const long long* key_sizes,
    const long long* perms, const uint32_t* founder,
    long long founder_stride, long long founder_val, bool* const* outs,
    cudaStream_t stream) {
  if (a < 1 || a > MAX_A || q < 1 || n < 1 || pairs < 1 ||
      pairs > MAX_PAIRS)
    return cudaErrorInvalidValue;
  Queries qs{};
  qs.member = q_member, qs.gt = q_gt, qs.pairs = static_cast<int>(pairs);
  for (int i = 0; i < pairs; ++i) {
    if ((key_sizes[i] != 1 && key_sizes[i] != 4) || perms[i] < 0 ||
        perms[i] > 3)
      return cudaErrorInvalidValue;
    qs.key[i] = keys[i], qs.key_size[i] = static_cast<int>(key_sizes[i]);
    qs.perm[i] = static_cast<int>(perms[i]), qs.out[i] = outs[i];
  }
  qs.founder = founder, qs.founder_stride = founder_stride;
  qs.founder_val = static_cast<uint32_t>(founder_val);
  return launch(Table{t_member, t_mask, t_gt, t_rev}, qs, n, q, a, stream);
}

// check_grant: `perm` for every query, or with is_rev (bool [N, Q], may
// be null) REVOKE where it is set and AUTHORIZE elsewhere.
DK_EXPORT int dk_timeline_check_grant(
    const uint32_t* t_member, const uint32_t* t_mask, const uint32_t* t_gt,
    const bool* t_rev, const uint32_t* q_member, const uint32_t* q_mask,
    const uint32_t* q_gt, long long n, long long q, long long a,
    long long n_meta, long long perm, const bool* is_rev, bool* out,
    cudaStream_t stream) {
  if (a < 1 || a > MAX_A || q < 1 || n < 1 || perm < 0 || perm > 3)
    return cudaErrorInvalidValue;
  Queries qs{};
  qs.member = q_member, qs.gt = q_gt, qs.pairs = 0;
  qs.key[0] = q_mask, qs.key_size[0] = 4;
  qs.perm[0] = static_cast<int>(perm);
  qs.n_meta = static_cast<int>(n_meta < 0 ? 0
                               : n_meta > MAX_TIMELINE_META ? MAX_TIMELINE_META
                                                            : n_meta);
  qs.is_rev = is_rev, qs.out[0] = out;
  return launch(Table{t_member, t_mask, t_gt, t_rev}, qs, n, q, a, stream);
}
