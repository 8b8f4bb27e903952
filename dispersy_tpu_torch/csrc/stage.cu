// K7: store_stage -- append each peer's masked record batch to its staging
// buffer, in batch order, after the row's valid entries; arrivals that
// find no free slot are dropped and counted.
//
// Replaces dispersy_tpu/ops/store.py:510 `store_stage`, the byte-diet
// store's every-round landing (a flat one-component scatter with
// mode="drop" on the TPU): cnt = the row's valid entries, rank =
// cumsum(mask) - 1, slot = cnt + rank, landed = mask & slot < S.  The
// batch's aux column is narrowed (or widened) to the staging width on the
// way in.  cnt counts valid slots and is not a prefix length: on a row
// with holes among its valid entries an arrival overwrites whatever slot
// cnt + rank holds, as the scatter does.
//
// Bound on the H100: bytes.  The function reads the staging row and the
// mask in full and the batch columns of the arrivals that land, and
// writes the [N, S] staging columns, the landed mask and one count per
// row.
//
// Design.  A group of G lanes per row (G the power of two >= S, widened
// so that the batch takes at most MAXC chunks of G entries; 32 / G rows
// a warp); lane t owns output slot t and batch entries c * G + t.  The
// first wave of loads is every load that does not depend on the mask --
// the lane's staging slot, six columns -- together with the mask's first
// MAXC chunks.  Ballots then give the row's valid count and each entry's
// arrival rank; slot t takes its staging value when t < cnt or t >= cnt
// + landed, else the arrival of rank t - cnt, whose batch index the lane
// finds in the chunk ballots.  The second wave loads only those
// arrivals, and every output slot is written once, by its lane.  The aux
// widths of staging and batch (u16 or u32) are template parameters.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_S = 32;
constexpr int MAXC = 4;  // mask chunks loaded in the first wave

template <typename A>
struct Cols {
  const uint32_t* gt;
  const uint32_t* member;
  const uint8_t* meta;
  const uint32_t* payload;
  const A* aux;
  const uint8_t* flags;
};

template <typename A>
struct Out {
  uint32_t* gt;
  uint32_t* member;
  uint8_t* meta;
  uint32_t* payload;
  A* aux;
  uint8_t* flags;
};

struct Rec {
  uint32_t gt, member, payload, aux;
  uint8_t meta, flags;
};

template <typename A>
__device__ __forceinline__ Rec load(const Cols<A>& c, long long at) {
  return Rec{c.gt[at], c.member[at], c.payload[at],
             static_cast<uint32_t>(c.aux[at]), c.meta[at], c.flags[at]};
}

// The position of the set bit of rank r (0-based) of v; r < popc(v).
__device__ __forceinline__ int nth_bit(uint32_t v, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const uint32_t lo = v & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (r >= c) {
      r -= c, v >>= w, pos += w;
    } else {
      v = lo;
    }
  }
  return pos;
}

template <typename SA, typename BA>
__global__ void __launch_bounds__(THREADS)
    dk_stage_kernel(Cols<SA> st, Cols<BA> bt, const bool* mask, long long n,
                    int s, int b, int lg, Out<SA> o, bool* landed,
                    int32_t* n_dropped) {
  const int g_size = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int l = lane & (g_size - 1);
  const int g_base = lane & ~(g_size - 1);
  const long long row =
      ((blockIdx.x * (long long)THREADS + threadIdx.x) >> 5 << (5 - lg)) +
      (lane >> lg);
  // Every lane of the warp reaches every ballot; rows past n are off.
  const bool on = row < n;
  const bool own = on && l < s;
  const long long sat = row * s + l, bat = row * b;
  // Wave 1: the mask's first chunks and the lane's staging slot.
  bool mk[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int e = c * g_size + l;
    mk[c] = on && e < b && mask[bat + e];
  }
  Rec v{dk::EMPTY_U32, 0, 0, 0, 0, 0};
  if (own) v = load(st, sat);
  const uint32_t group = __ballot_sync(dk::FULL_MASK, own && v.gt !=
                                                          dk::EMPTY_U32);
  const int cnt = __popc(g_size == 32 ? group : (group >> g_base) &
                                                    ((1u << g_size) - 1u));
  const int free_slots = s - cnt;
  const int r = l - cnt;  // the arrival rank slot l takes, if it lands
  int before = 0;         // masked entries in the chunks before
  int from = -1;          // batch index of slot l's arrival
  const int chunks = (b + g_size - 1) >> lg;
  auto chunk = [&](int c, bool m) {
    uint32_t bits = __ballot_sync(dk::FULL_MASK, m);
    if (g_size < 32) bits = (bits >> g_base) & ((1u << g_size) - 1u);
    const int e = c * g_size + l;
    if (on && e < b)
      landed[bat + e] = m && before + __popc(bits & ((1u << l) - 1u)) <
                                 free_slots;
    const int pc = __popc(bits);
    if (r >= before && r < before + pc)
      from = c * g_size + nth_bit(bits, r - before);
    before += pc;
  };
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < chunks) chunk(c, mk[c]);
  for (int c = MAXC; c < chunks; ++c) {
    const int e = c * g_size + l;
    chunk(c, on && e < b && mask[bat + e]);
  }
  // Wave 2: only the arrivals that land; each slot written once.
  if (own) {
    if (from >= 0) v = load(bt, bat + from);
    o.gt[sat] = v.gt;
    o.member[sat] = v.member;
    o.meta[sat] = v.meta;
    o.payload[sat] = v.payload;
    o.aux[sat] = static_cast<SA>(v.aux);
    o.flags[sat] = v.flags;
  }
  if (on && l == 0)
    n_dropped[row] = before - (before < free_slots ? before : free_slots);
}

template <typename SA, typename BA>
int launch(const void* const* s_cols, const void* const* b_cols,
           const bool* mask, long long n, long long s, long long b,
           void* const* o_cols, bool* landed, int32_t* n_dropped,
           cudaStream_t stream) {
  const Cols<SA> st{static_cast<const uint32_t*>(s_cols[0]),
                    static_cast<const uint32_t*>(s_cols[1]),
                    static_cast<const uint8_t*>(s_cols[2]),
                    static_cast<const uint32_t*>(s_cols[3]),
                    static_cast<const SA*>(s_cols[4]),
                    static_cast<const uint8_t*>(s_cols[5])};
  const Cols<BA> bt{static_cast<const uint32_t*>(b_cols[0]),
                    static_cast<const uint32_t*>(b_cols[1]),
                    static_cast<const uint8_t*>(b_cols[2]),
                    static_cast<const uint32_t*>(b_cols[3]),
                    static_cast<const BA*>(b_cols[4]),
                    static_cast<const uint8_t*>(b_cols[5])};
  const Out<SA> o{static_cast<uint32_t*>(o_cols[0]),
                  static_cast<uint32_t*>(o_cols[1]),
                  static_cast<uint8_t*>(o_cols[2]),
                  static_cast<uint32_t*>(o_cols[3]),
                  static_cast<SA*>(o_cols[4]),
                  static_cast<uint8_t*>(o_cols[5])};
  // G: the power of two >= S, and >= B / MAXC while below 32.
  int lg = 0;
  while (lg < 5 && ((1ll << lg) < s || (MAXC << lg) < b)) ++lg;
  const int rows_per_block = (THREADS / 32) << (5 - lg);
  const auto k = dk_stage_kernel<SA, BA>;
  LAUNCH(k, dk::blocks_for(n, rows_per_block), THREADS, 0, stream)(
      st, bt, mask, n, static_cast<int>(s), static_cast<int>(b), lg, o,
      landed, n_dropped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_cols, b_cols, o_cols: host arrays of the six column pointers (gt,
// member, meta, payload, aux, flags) of the staging, the batch and the
// output; st_aux / bt_aux: bytes of one aux element of the staging and
// of the batch (4, or 2 under aux_bits=16); the output takes the
// staging's.
DK_EXPORT int dk_store_stage(const void* const* s_cols,
                             const void* const* b_cols, const bool* mask,
                             long long n, long long s, long long b,
                             long long st_aux, long long bt_aux,
                             void* const* o_cols, bool* landed,
                             int32_t* n_dropped, cudaStream_t stream) {
  if (s < 1 || s > MAX_S || b < 0 || n < 0) return cudaErrorInvalidValue;
  if (st_aux == 2 && bt_aux == 2)
    return launch<uint16_t, uint16_t>(s_cols, b_cols, mask, n, s, b, o_cols,
                                      landed, n_dropped, stream);
  if (st_aux == 2 && bt_aux == 4)
    return launch<uint16_t, uint32_t>(s_cols, b_cols, mask, n, s, b, o_cols,
                                      landed, n_dropped, stream);
  if (st_aux == 4 && bt_aux == 2)
    return launch<uint32_t, uint16_t>(s_cols, b_cols, mask, n, s, b, o_cols,
                                      landed, n_dropped, stream);
  if (st_aux == 4 && bt_aux == 4)
    return launch<uint32_t, uint32_t>(s_cols, b_cols, mask, n, s, b, o_cols,
                                      landed, n_dropped, stream);
  return cudaErrorInvalidValue;
}
