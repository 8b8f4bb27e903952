// K11: store_probe -- the hardened community's three store probes: for
// each of a row's B batch entries, a reduce over the row's M store slots.
//
// Replaces dispersy_tpu/ops/intake.py:104 `conflict`, :269
// `identity_stored` and :325 `seq_stored_max` -- on the TPU a broadcast
// compare-reduce over [N, B, M].  Modes (a template parameter):
//   CONFLICT  any live slot (gt != EMPTY) with the entry's (member, gt)
//             whose (meta, payload, aux) differs from the entry's;
//   IDENTITY  any slot whose meta is dispersy-identity (0xF6) with the
//             entry's member (no gt test, as in the JAX package);
//   SEQ_MAX   the max aux, in C++'s unsigned order, over the live slots
//             of the entry's (member, meta); 0 when none.
//
// Bound on the H100: bytes -- the selecting columns in full ((member, gt)
// for CONFLICT, the meta for IDENTITY, (member, meta) for SEQ_MAX), the
// other columns only at the slots that some entry of the row matches (for
// IDENTITY the member at the identity slots), every query column, the
// output.
//
// Design: K9's (csrc/match.cu).  A group of G lanes per row (G = 4, 8 or
// 16 by B), the row's queries in registers (QR a lane).  A row costs two
// round trips to memory: the queries and the selecting columns are loaded
// at once (UN slots a lane in flight), and a ballot per step lists the
// selected slots in shared memory (CONFLICT: the live slots with their
// (member, gt); IDENTITY: the identity slots; SEQ_MAX: every slot with its
// (member, meta)).  CONFLICT and SEQ_MAX then compare every listed key
// with the lane's queries and mark the entries some query names -- rare
// in CONFLICT (a stored copy of an arriving record), a member's records
// of one meta in SEQ_MAX -- and a second ballot compacts the marked
// entries while the other columns are loaded at those slots only
// (CONFLICT: meta, payload, aux; SEQ_MAX: gt, aux; IDENTITY: the member
// at every listed slot).  Each lane then reduces its queries over the
// short list with broadcast reads.  A row's arrays are interleaved with
// the other rows' of the block slot by slot, so the groups of a warp read
// different banks.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_W = 256;  // kernels.PROBE_MAX_WIDTH
constexpr int UN = 8;       // slots a lane loads in flight
constexpr int CONFLICT = 0, IDENTITY = 1, SEQ_MAX = 2;
constexpr uint32_t META_IDENTITY = 0xF6;

// One side's columns; a mode's unread columns may be null.
struct Cols {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const uint32_t* aux;
};

// The u32 arrays a row keeps in shared memory, each of W entries: the
// list (slot, key 1, key 2) and the compacted entries (list entry with
// the meta above bit 16, value 1, value 2); IDENTITY needs the slot and
// the member only.
template <int MODE>
constexpr int n_arrays() {
  return MODE == IDENTITY ? 2 : 6;
}

template <int MODE, int G, int QR>
__global__ void __launch_bounds__(WARPS * 32)
    dk_probe_kernel(Cols s, Cols q, void* out, long long n, int w, int nq) {
  constexpr int R = WARPS * 32 / G;  // rows a block
  constexpr unsigned GBITS = G == 32 ? dk::FULL_MASK : (1u << G) - 1u;
  extern __shared__ __align__(16) uint32_t sh[];
  const int lane = threadIdx.x & 31;
  const int gl = threadIdx.x % G;
  const int group = threadIdx.x / G;  // in the block
  const long long row = blockIdx.x * (long long)R + group;
  const bool active = row < n;
  const int gshift = lane - gl;  // the group's first lane in its warp
  const unsigned gmask = GBITS << gshift;
  const unsigned below = (1u << gl) - 1u;
  uint32_t* li = sh + group;  // entry t of an array at [t * R]
  uint32_t* k1 = li + w * R;
  uint32_t* k2 = k1 + w * R;
  uint32_t* ct = k2 + w * R;
  uint32_t* v1 = ct + w * R;
  uint32_t* v2 = v1 + w * R;
  const long long sb = row * w, qb = row * nq;

  // The lane's queries k0 + gl + u * G; past the last, copies of the
  // last (a copy changes no mark, and its answer is not written).
  uint32_t qm[QR], qg[QR], qt[QR], qp[QR], qa[QR];
  auto load_queries = [&](int k0) {
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const long long at = qb + min(k0 + gl + u * G, nq - 1);
      qm[u] = qg[u] = qt[u] = qp[u] = qa[u] = 0;
      if (!active) continue;
      qm[u] = q.member[at];
      if (MODE == CONFLICT) {
        qg[u] = q.gt[at];
        qp[u] = q.payload[at];
        qa[u] = q.aux[at];
      }
      if (MODE != IDENTITY) qt[u] = q.meta[at];
    }
  };
  load_queries(0);

  // The list: every selecting load of a step in flight before its ballot.
  int cnt = 0;  // uniform within the group
  for (int base = 0; base < w; base += UN * G) {  // warp-uniform
    uint32_t a[UN], b[UN];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int j = base + u * G + gl;
      const bool in = active && j < w;
      a[u] = b[u] = 0;
      if (!in) continue;
      if (MODE == IDENTITY) {
        a[u] = s.meta[sb + j];
      } else {
        a[u] = s.member[sb + j];
        b[u] = MODE == CONFLICT ? s.gt[sb + j] : s.meta[sb + j];
      }
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      if (base + u * G >= w) break;  // warp-uniform
      const int j = base + u * G + gl;
      bool sel = active && j < w;
      if (MODE == IDENTITY) sel = sel && a[u] == META_IDENTITY;
      if (MODE == CONFLICT) sel = sel && b[u] != dk::EMPTY_U32;
      const unsigned bal = (__ballot_sync(dk::FULL_MASK, sel) >> gshift) &
                           GBITS;
      if (sel) {
        const int at = cnt + __popc(bal & below);
        li[at * R] = j;
        if (MODE != IDENTITY) {
          k1[at * R] = a[u];
          k2[at * R] = b[u];
          ct[at * R] = 0;  // the mark
        }
      }
      cnt += __popc(bal);
    }
  }
  __syncwarp();

  int cnt2 = cnt;  // the compacted entries
  if (MODE == IDENTITY) {
    // The member at every identity slot.
    for (int base = 0; base < cnt; base += UN * G) {  // group-uniform
      uint32_t x[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int t = base + u * G + gl;
        if (t < cnt) x[u] = s.member[sb + li[t * R]];
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int t = base + u * G + gl;
        if (t < cnt) k1[t * R] = x[u];
      }
    }
  } else {
    // Mark the listed entries whose keys some query of the row names.
    for (int k0 = 0; k0 < nq; k0 += QR * G) {
      if (k0) load_queries(k0);
      for (int t = 0; t < cnt; ++t) {
        const uint32_t a = k1[t * R], b = k2[t * R];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < QR; ++u)
          hit |= a == qm[u] && b == (MODE == CONFLICT ? qg[u] : qt[u]);
        if (hit) ct[t * R] = 1;
      }
    }
    __syncwarp();
    // Compact the marked entries, loading their other columns: every
    // load of a step in flight, and every mark of the step read before
    // the compacted entries (at or before their own) overwrite it.
    cnt2 = 0;
    for (int base = 0; base < cnt; base += UN * G) {  // group-uniform
      bool mk[UN];
      uint32_t x0[UN], x1[UN], x2[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int t = base + u * G + gl;
        mk[u] = t < cnt && ct[t * R] != 0;
        x0[u] = x1[u] = x2[u] = 0;
        if (!mk[u]) continue;
        const long long from = sb + li[t * R];
        if (MODE == CONFLICT) {
          x0[u] = s.meta[from];
          x1[u] = s.payload[from];
        } else {
          x1[u] = s.gt[from];
        }
        x2[u] = s.aux[from];
      }
      __syncwarp(gmask);
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        if (base + u * G >= cnt) break;  // group-uniform
        const int t = base + u * G + gl;
        const unsigned bal = __ballot_sync(gmask, mk[u]) >> gshift;
        if (mk[u]) {
          const int at = cnt2 + __popc(bal & below);
          ct[at * R] = static_cast<uint32_t>(t) | (x0[u] << 16);
          v1[at * R] = x1[u];
          v2[at * R] = x2[u];
        }
        cnt2 += __popc(bal);
      }
    }
  }
  __syncwarp(gmask);
  if (!active) return;

  // Each lane's queries against the short list, QR * G at a time.
  for (int k0 = 0; k0 < nq; k0 += QR * G) {
    if (MODE == IDENTITY ? k0 != 0 : (k0 != 0 || nq > QR * G))
      load_queries(k0);
    uint32_t acc[QR];
#pragma unroll
    for (int u = 0; u < QR; ++u) acc[u] = 0;
    for (int c = 0; c < cnt2; ++c) {
      if (MODE == IDENTITY) {
        const uint32_t a = k1[c * R];
#pragma unroll
        for (int u = 0; u < QR; ++u) acc[u] |= a == qm[u];
        continue;
      }
      const uint32_t e = ct[c * R];
      const uint32_t t = e & 0xFFFFu;
      const uint32_t a = k1[t * R], b = k2[t * R];
      const uint32_t y = v1[c * R], z = v2[c * R];
#pragma unroll
      for (int u = 0; u < QR; ++u) {
        if (MODE == CONFLICT) {
          acc[u] |= a == qm[u] && b == qg[u] &&
                    ((e >> 16) != qt[u] || y != qp[u] || z != qa[u]);
        } else if (a == qm[u] && b == qt[u] && y != dk::EMPTY_U32 &&
                   z > acc[u]) {
          acc[u] = z;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int k = k0 + gl + u * G;
      if (k >= nq) continue;
      if (MODE == SEQ_MAX)
        static_cast<uint32_t*>(out)[qb + k] = acc[u];
      else
        static_cast<uint8_t*>(out)[qb + k] = static_cast<uint8_t>(acc[u]);
    }
  }
}

template <int MODE, int G, int QR>
int launch(Cols s, Cols q, void* out, long long n, int w, int nq,
           cudaStream_t stream) {
  constexpr int rows = WARPS * 32 / G;
  const auto kernel = dk_probe_kernel<MODE, G, QR>;
  const size_t smem = static_cast<size_t>(rows) * n_arrays<MODE>() * w *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  LAUNCH(kernel, dk::blocks_for(n, rows), WARPS * 32, smem, stream)(
      s, q, out, n, w, nq);
  return static_cast<int>(cudaGetLastError());
}

// G and QR by the query count, as in K9: a group's lanes hold G * QR
// queries (more are taken G * QR at a time).
template <int MODE>
int launch_mode(Cols s, Cols q, void* out, long long n, int w, int nq,
                cudaStream_t stream) {
  if (nq <= 4) return launch<MODE, 4, 1>(s, q, out, n, w, nq, stream);
  if (nq <= 24) return launch<MODE, 8, 3>(s, q, out, n, w, nq, stream);
  return launch<MODE, 16, 3>(s, q, out, n, w, nq, stream);
}

}  // namespace

// mode: CONFLICT 0, IDENTITY 1, SEQ_MAX 2.  s_*: the store's columns
// [n, w] (u32; the meta u8), q_*: the batch's [n, nq]; a mode's unread
// columns may be null.  out: bool [n, nq], or u32 [n, nq] for SEQ_MAX.
DK_EXPORT int dk_store_probe(long long mode, const uint32_t* s_gt,
                             const uint32_t* s_member, const uint8_t* s_meta,
                             const uint32_t* s_payload,
                             const uint32_t* s_aux, const uint32_t* q_gt,
                             const uint32_t* q_member, const uint8_t* q_meta,
                             const uint32_t* q_payload,
                             const uint32_t* q_aux, void* out, long long n,
                             long long w, long long nq, cudaStream_t stream) {
  if (n < 0 || w < 1 || nq < 1 || w > MAX_W || nq > (1 << 30))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Cols s{s_gt, s_member, s_meta, s_payload, s_aux};
  const Cols q{q_gt, q_member, q_meta, q_payload, q_aux};
  const int wi = static_cast<int>(w), qi = static_cast<int>(nq);
  switch (mode) {
    case CONFLICT:
      return launch_mode<CONFLICT>(s, q, out, n, wi, qi, stream);
    case IDENTITY:
      return launch_mode<IDENTITY>(s, q, out, n, wi, qi, stream);
    case SEQ_MAX:
      return launch_mode<SEQ_MAX>(s, q, out, n, wi, qi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
