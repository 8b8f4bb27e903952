// K5: the intake checks -- for each of a row's B batch entries (member,
// gt, ok): in_store, is (member, gt) one of the row's M store slots, and
// dup_earlier, does an earlier entry of the batch with ok set carry the
// same (member, gt).
//
// Replaces dispersy_tpu/ops/intake.py:80 `in_store` and :137
// `dup_earlier`, whose TPU form is a broadcast compare-reduce over
// [N, B, M] and [N, B, B].  Without a store (`sg` null) the kernel
// computes dup_earlier alone and reads no ring: the byte-diet round's
// freshness test is a digest query (K2), not a ring compare.
//
// Bound on the H100: bytes.  The function reads the two [N, M] store
// key columns and the three [N, B] batch columns, and writes two bool
// [N, B] answers.
//
// Design.  A group of G lanes per row (G = 4, 8, 16 or 32 by B), one
// batch entry a lane, B > 32 in chunks of 32.  A group issues the loads
// of all its rows -- 4 rows without a ring, 1 with one -- before it uses
// any: its lanes' first-chunk entries, and the block's rings as one flat
// run of 16-byte vector loads (when aligned) into shared memory as
// 64-bit keys gt << 32 | member.
//   * in_store: a ballot over adjacent pairs tests whether the row's raw
//     keys are non-decreasing over all M slots.  EMPTY slots carry
//     gt = member = 0xFFFFFFFF and sort last, so every ring that holds
//     K3's round invariant (live records sorted by (gt, member), EMPTY a
//     suffix; csrc/store.cu) holds this.  Such rows answer each entry by
//     a binary search (ceil(log2 M) shared reads); rows that break it
//     compare every slot, the same function on any input (an EMPTY entry
//     against EMPTY slots is a hit either way: raw keys are compared).
//   * dup_earlier: __match_any_sync on a 32-bit hash of the key gives
//     the lanes of the warp whose key hashes alike; ANDed with the ballot
//     of `ok`, the group's lanes and the lanes below this one, it lists
//     the candidates, and a shuffle of each candidate's key, lowest
//     first, confirms one (a hash collision costs one more round).  An
//     entry of a later chunk also compares the earlier chunks' entries
//     (broadcast loads).  On this card a match on the 64-bit key costs
//     about twice a 32-bit one, and a shuffle loop over the earlier
//     lanes more than either (PERF.md).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_M = 256;         // kernels.INTAKE_MAX_WIDTH
constexpr int SMEM_KEYS = 6144;    // keys a block at most (48 KB)
constexpr int RPG = 4;             // rows a group without a ring
constexpr int UN = 2;              // vector loads a thread in flight

__device__ __forceinline__ uint64_t key_of(uint32_t gt, uint32_t member) {
  return (static_cast<uint64_t>(gt) << 32) | member;
}

// A lane's batch entry in a chunk (zeros past the row's B or the last
// row).
struct Entry {
  uint32_t mem, gt;
  bool ok, in;
};

// The 32-bit hash the dedup matches on (profiling.intake_arrays builds
// colliding keys from it): equal keys hash alike, and a collision of two
// keys costs one more confirming shuffle.
constexpr uint32_t HASH_GT = 0x9E3779B1u, HASH_MEMBER = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t hash_of(const Entry& e) {
  return e.gt * HASH_GT ^ e.mem * HASH_MEMBER;
}

__device__ __forceinline__ Entry load_entry(const uint32_t* qm,
                                            const uint32_t* qg,
                                            const uint8_t* ok, bool active,
                                            long long qb, int k, int b) {
  Entry e{0u, 0u, false, active && k < b};
  if (e.in) {
    e.mem = __ldg(qm + qb + k);
    e.gt = __ldg(qg + qb + k);
    e.ok = __ldg(ok + qb + k) != 0;
  }
  return e;
}

// Rows a group: RPG without a ring; one with a ring (the ring's keys and
// the search's registers cost more blocks a multiprocessor than more
// rows in flight gain).
template <bool STORE>
__host__ __device__ constexpr int rows_a_group() {
  return STORE ? 1 : RPG;
}

// RG rows a group: row i of group g is the block's row i * groups + g.
// `vec`: the rings' rows are 16-byte aligned (M % 4 == 0 and aligned
// bases).
template <bool STORE, int G>
__global__ void __launch_bounds__(THREADS)
    dk_intake_kernel(const uint32_t* sg, const uint32_t* sm,
                     const uint32_t* qm, const uint32_t* qg,
                     const uint8_t* ok, uint8_t* ins, uint8_t* dup,
                     long long n, int m, int b, bool vec) {
  constexpr int RG = rows_a_group<STORE>();
  extern __shared__ __align__(16) uint64_t keys[];  // [rows][m]
  const int lane = threadIdx.x & 31;
  const int gl = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const int rows = groups * RG;
  const unsigned gmask =
      (G == 32 ? dk::FULL_MASK : (1u << G) - 1u) << (lane - gl);
  const unsigned below = (1u << lane) - 1u;
  const long long row0 = blockIdx.x * static_cast<long long>(rows);
  const int nr = static_cast<int>(min(static_cast<long long>(rows),
                                      n - row0));

  Entry first[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int r = i * groups + group;
    first[i] = load_entry(qm, qg, ok, r < nr, (row0 + r) * b, gl, b);
  }

  if (STORE) {
    // The block's rings, one flat run of nr * m keys.
    const int n_in = nr * m;
    const uint32_t* g0 = sg + row0 * m;
    const uint32_t* m0 = sm + row0 * m;
    if (vec) {
      const uint4* g4 = reinterpret_cast<const uint4*>(g0);
      const uint4* m4 = reinterpret_cast<const uint4*>(m0);
      const int n4 = n_in / 4;
      for (int base = 0; base < n4; base += UN * blockDim.x) {
        uint4 a[UN], c[UN];
#pragma unroll
        for (int u = 0; u < UN; ++u) {
          const int f4 = base + u * blockDim.x + threadIdx.x;
          if (f4 < n4) {
            a[u] = __ldg(g4 + f4);
            c[u] = __ldg(m4 + f4);
          }
        }
#pragma unroll
        for (int u = 0; u < UN; ++u) {
          const int f4 = base + u * blockDim.x + threadIdx.x;
          if (f4 >= n4) break;
          ulonglong2* kp = reinterpret_cast<ulonglong2*>(keys + 4 * f4);
          kp[0] = make_ulonglong2(key_of(a[u].x, c[u].x),
                                  key_of(a[u].y, c[u].y));
          kp[1] = make_ulonglong2(key_of(a[u].z, c[u].z),
                                  key_of(a[u].w, c[u].w));
        }
      }
    } else {
      for (int f = threadIdx.x; f < n_in; f += blockDim.x)
        keys[f] = key_of(__ldg(g0 + f), __ldg(m0 + f));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int r = i * groups + group;
    const bool active = r < nr;
    const long long qb = (row0 + r) * b;
    const uint64_t* rk = keys + r * m;
    bool sorted = true;
    if (STORE) {
      bool bad = false;
      if (active)
        for (int t = gl; t + 1 < m; t += G) bad |= rk[t] > rk[t + 1];
      sorted = (__ballot_sync(dk::FULL_MASK, bad) & gmask) == 0;
    }
    Entry e = first[i];
    for (int k0 = 0; k0 < b; k0 += G) {  // warp-uniform
      if (k0) e = load_entry(qm, qg, ok, active, qb, k0 + gl, b);
      // The earlier ok lanes of the chunk whose key hashes alike, then
      // each candidate confirmed or struck by its key, lowest first.
      const unsigned oks = __ballot_sync(dk::FULL_MASK, e.ok);
      unsigned left = __match_any_sync(dk::FULL_MASK, hash_of(e)) & oks &
                      gmask & below;
      left = e.in ? left : 0u;
      bool d = false;
      while (__any_sync(dk::FULL_MASK, left != 0)) {
        const int c = left ? __ffs(left) - 1 : lane;
        const uint32_t m2 = __shfl_sync(dk::FULL_MASK, e.mem, c);
        const uint32_t g2 = __shfl_sync(dk::FULL_MASK, e.gt, c);
        if (left && m2 == e.mem && g2 == e.gt) {
          d = true;
          left = 0;
        }
        left &= left - 1;
      }
      if (!e.in) continue;
      for (int j = 0; j < k0 && !d; ++j)  // the earlier chunks
        d = __ldg(ok + qb + j) != 0 && __ldg(qg + qb + j) == e.gt &&
            __ldg(qm + qb + j) == e.mem;
      dup[qb + k0 + gl] = d;
      if (!STORE) continue;
      const uint64_t q = key_of(e.gt, e.mem);
      bool hit = false;
      if (sorted) {  // lower bound of q in the row's keys
        int lo = 0, len = m;
        while (len > 0) {
          const int half = len >> 1;
          if (rk[lo + half] < q) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        hit = lo < m && rk[lo] == q;
      } else {
        for (int t = 0; t < m; ++t) hit |= rk[t] == q;
      }
      ins[qb + k0 + gl] = hit;
    }
  }
}

template <bool STORE, int G>
int launch(const uint32_t* sg, const uint32_t* sm, const uint32_t* qm,
           const uint32_t* qg, const uint8_t* ok, uint8_t* ins,
           uint8_t* dup, long long n, int m, int b, cudaStream_t stream) {
  // Fewer groups, whole warps, while the block's keys pass SMEM_KEYS.
  constexpr int RG = rows_a_group<STORE>();
  int groups = THREADS / G;
  if (STORE && groups * RG * m > SMEM_KEYS) {
    groups = SMEM_KEYS / (RG * m);
    groups -= groups % (32 / G);
  }
  const int rows = groups * RG;
  const bool vec =
      STORE && m % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(sg) | reinterpret_cast<uintptr_t>(sm)) &
       15) == 0;
  const size_t smem = STORE ? sizeof(uint64_t) * rows * m : 0;
  const auto kernel = dk_intake_kernel<STORE, G>;
  LAUNCH(kernel, dk::blocks_for(n, rows), groups * G, smem, stream)(
      sg, sm, qm, qg, ok, ins, dup, n, m, b, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool STORE>
int launch_b(const uint32_t* sg, const uint32_t* sm, const uint32_t* qm,
             const uint32_t* qg, const uint8_t* ok, uint8_t* ins,
             uint8_t* dup, long long n, int m, int b, cudaStream_t stream) {
  if (b <= 4)
    return launch<STORE, 4>(sg, sm, qm, qg, ok, ins, dup, n, m, b, stream);
  if (b <= 8)
    return launch<STORE, 8>(sg, sm, qm, qg, ok, ins, dup, n, m, b, stream);
  if (b <= 16)
    return launch<STORE, 16>(sg, sm, qm, qg, ok, ins, dup, n, m, b, stream);
  return launch<STORE, 32>(sg, sm, qm, qg, ok, ins, dup, n, m, b, stream);
}

}  // namespace

// sg, sm: the store's gt and member [n, m] (u32), or both null for
// dup_earlier alone (m ignored, ins unwritten); qm, qg, ok: the batch's
// member, gt (u32) and ok (bool) [n, b]; ins, dup: bool [n, b].
DK_EXPORT int dk_intake(const uint32_t* sg, const uint32_t* sm,
                        const uint32_t* qm, const uint32_t* qg,
                        const uint8_t* ok, uint8_t* ins, uint8_t* dup,
                        long long n, long long m, long long b,
                        cudaStream_t stream) {
  const bool store = sg != nullptr;
  if (n < 0 || b < 1 || b > (1 << 30) || (store != (sm != nullptr)) ||
      (store && (m < 1 || m > MAX_M)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int mi = static_cast<int>(m), bi = static_cast<int>(b);
  return store ? launch_b<true>(sg, sm, qm, qg, ok, ins, dup, n, mi, bi,
                                stream)
               : launch_b<false>(sg, sm, qm, qg, ok, ins, dup, n, 0, bi,
                                 stream);
}
