// The delivery core, shared by csrc/deliver.cu (K1) and csrc/ragged.cu
// (K12, whose landing is K1's on the edges that cross): a stable LSD
// radix sort of the deliverable edges by destination, then a landing
// that writes every inbox row and every receipt once.
//
// It replaces a counting sort (an atomicAdd per edge into its
// destination's count, a three-kernel scan, an unstable atomicAdd
// placement, a warp per destination re-ranking its group by shuffles and
// a block-wide bitonic selection for groups above 32 edges), which cost
// two passes of global atomics, an N-warp stage whatever the edge count,
// a zeroing memset per output column and 9 + k launches a call.
//
// Bound on the H100: bytes.  The function reads dst and valid (5 B an
// edge, 6 B with a class), the payload row of each landed edge, and
// writes the [N, Q] inboxes, their valid mask, the drop counts and the
// receipts.  What costs more than those bytes is where they go: a landed
// row is read from a random edge and a receipt written to one, each a
// 32-byte sector for a few bytes.  The design reads and writes in order
// wherever it can:
//   - the narrow columns (rows of 1, 2 or 4 bytes) are packed side by
//     side into one row per edge in the pass over the edges, so a landed
//     row costs one random sector, not one per column;
//   - the receipts are not scattered from the inboxes: each sort pass
//     also writes, in its input order, where each key went, and the
//     receipt of edge e is read back in edge order through those
//     positions (e -> pass 0 -> pass 1 ...), each step a gather along
//     the pass's digit runs, which the L2 serves;
//   - the sort moves 8-byte (destination, edge) pairs, in tile order.
//
// With P passes (a first pass over the 8-bit class when there is one,
// then one per digit of at most RADIX_BITS bits of the destination, least
// significant first):
//   1. hist  -- one pass over the edges in edge order: each deliverable
//               edge (valid, 0 <= dst < n) adds one to its digit's bin of
//               every pass (shared memory, then global once per block)
//               and writes its packed row;
//   2. pass  -- P onesweep passes (the decoupled look-back of Merrill and
//               Garland's single-pass scan, as in Adinets and Merrill's
//               Onesweep): each block takes the next tile of TILE keys in
//               order, ranks their digits stably in shared memory (one
//               ballot per digit bit in each warp, then a scan over the
//               warps), publishes its digit counts, looks back over the
//               earlier tiles' counts, WINDOW tiles a step, for its global
//               offsets and writes the tile out digit-sorted through
//               shared memory (and, for the receipts, each key's new
//               position at its old one).  Pass 0 reads the edge list
//               itself and drops the edges that are not deliverable.
//               Each pass is stable, so the order inside a destination is
//               edge order, or (class, edge) order: no ranking stage and
//               no hot-peer path (a tracker's 10k-edge group is one long
//               run);
//   3. runs  -- one thread per sorted position writes where each
//               destination's run starts and ends;
//   4. land  -- blocks over the [N, Q] rows: a row's edge is its run's
//               slot-th key (none past the run); the valid mask, the drop
//               count at slot 0, the packed row unpacked into its columns
//               and the other columns gathered, zeros where no edge
//               landed; and blocks over the edges, each writing its
//               receipt (its sorted position less its run's start, if
//               below Q; else -1) in edge order.
// One memset (run bounds, bins, look-back words) and 4 + P kernels a
// call, whatever the number of columns.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace dk {
namespace {  // each source that includes this header keeps its own copy

constexpr int MAX_COLS = 8;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;  // bins of a destination digit
constexpr int CLS_BITS = 8;
constexpr int MAX_PASSES = 5;   // the class and ceil(31 / 8) dst digits
constexpr int THREADS = 256;    // a pass block: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int IPT = 16;         // keys a thread ranks
constexpr int TILE = THREADS * IPT;
constexpr int DPT = RADIX / THREADS;  // digits a thread looks back for
constexpr int WINDOW = 8;       // earlier tiles read a look-back step
constexpr int HIST_THREADS = 256;
constexpr int HIST_EPT = 2;     // edges a hist thread holds
constexpr int EPT = 4;          // edges a receipt thread holds
constexpr int LAND_THREADS = 256;
constexpr int ROWS_PT = 4;      // rows a landing thread holds
constexpr int LAND_ROWS = LAND_THREADS * ROWS_PT;
constexpr int GROUP = 4;        // loads in flight a thread in copy_rows
constexpr uint32_t FLAG_AGG = 1u << 30;  // the tile's own count
constexpr uint32_t FLAG_INC = 2u << 30;  // the count up to the tile
constexpr uint32_t COUNT = FLAG_AGG - 1;
constexpr long long MAX_EDGES = 1ll << 30;  // counts fit COUNT

struct Cols {
  const uint8_t* src[MAX_COLS];
  uint8_t* dst[MAX_COLS];
  long long nbytes[MAX_COLS];  // bytes of one row of each column
  int width[MAX_COLS];         // bytes of one copy: 16, 8, 4, 2 or 1
  unsigned packed;             // bit j: column j rides the packed row
  int k;
};

// The narrow columns packed side by side, column c of the pack in word c
// of a packed row (zero-extended); at least two, or none.
struct Pack {
  const uint8_t* src[MAX_COLS];
  uint8_t* dst[MAX_COLS];
  int nb[MAX_COLS];  // 1, 2 or 4
  int k;
  int stride;        // bytes of a packed row: 8, 16 or 32
};

// The columns that ride the packed row: rows of 1, 2 or 4 bytes whose
// tensors are aligned to it (the ones a caller allocates are).  Returns
// the packed row's bytes (0: no packing).
inline int make_pack(long long k, const long long* nbytes,
                     void* const* src, void* const* dst, Pack* p,
                     unsigned* packed) {
  *p = Pack{};
  *packed = 0;
  for (int j = 0; j < k; ++j) {
    const long long nb = nbytes[j];
    if (nb != 1 && nb != 2 && nb != 4) continue;
    if (src && (reinterpret_cast<unsigned long long>(src[j]) % nb ||
                reinterpret_cast<unsigned long long>(dst[j]) % nb))
      continue;
    if (src) {
      p->src[p->k] = static_cast<const uint8_t*>(src[j]);
      p->dst[p->k] = static_cast<uint8_t*>(dst[j]);
    }
    p->nb[p->k++] = static_cast<int>(nb);
    *packed |= 1u << j;
  }
  if (p->k < 2) {  // a lone column is gathered as fast
    *p = Pack{};
    *packed = 0;
    return 0;
  }
  p->stride = p->k <= 2 ? 8 : p->k <= 4 ? 16 : 32;
  return p->stride;
}

// The digits of the sort: pass p sorts by bits [shift, shift + bits) of
// the destination, or pass 0 by the class.
struct Plan {
  int passes;
  int cls;
  int shift[MAX_PASSES];
  int bits[MAX_PASSES];
  long long tiles;  // tiles of TILE keys over E, each pass's grid
};

inline Plan make_plan(long long e, long long n, bool cls) {
  Plan p{};
  int b = 1;
  while ((1ll << b) < n) ++b;  // destination bits
  const int nd = (b + RADIX_BITS - 1) / RADIX_BITS;
  const int w = (b + nd - 1) / nd;
  p.cls = cls ? 1 : 0;
  if (cls) {
    p.bits[0] = CLS_BITS;
    p.passes = 1;
  }
  for (int i = 0; i < nd; ++i, ++p.passes) {
    p.shift[p.passes] = i * w;
    p.bits[p.passes] = b - i * w < w ? b - i * w : w;
  }
  p.tiles = e > 0 ? (e + TILE - 1) / TILE : 1;
  return p;
}

// Where each pass sent each key, by its index in the pass's input.
struct Moves {
  uint32_t* to[MAX_PASSES];
};

// The scratch of a call, carved from one buffer: the zeroed part first
// (run bounds, bins, the per-pass tile counters and the total, the
// look-back words), then two ping-pong buffers of (destination, edge)
// pairs, the moves of each pass and the packed rows.
struct Scratch {
  int2* bounds;          // [n] run start, run end (0, 0: no edge)
  uint32_t* hist;        // [MAX_PASSES][RADIX]
  uint32_t* counters;    // [MAX_PASSES] tiles taken, [MAX_PASSES] total
  uint32_t* state[MAX_PASSES];  // [tiles][1 << bits] look-back words
  unsigned long long* pairs[2];
  Moves moves;           // [passes][e]
  uint8_t* packed;       // [e][stride] the packed rows, by edge
  size_t zeroed;         // bytes of the zeroed part
};

inline size_t round_up(size_t x) { return (x + 255) & ~size_t(255); }

// Lays out the scratch from `base` (null: only sizes it) for packed rows
// of `stride` bytes; returns its bytes.
inline size_t carve(const Plan& p, int stride, long long e, long long n,
                    void* base, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* at = base ? static_cast<uint8_t*>(base) + off : nullptr;
    off += round_up(bytes);
    return at;
  };
  s->bounds = static_cast<int2*>(take(n * sizeof(int2)));
  s->hist = static_cast<uint32_t*>(take(MAX_PASSES * RADIX * 4));
  s->counters = static_cast<uint32_t*>(take(2 * MAX_PASSES * 4));
  for (int i = 0; i < MAX_PASSES; ++i)
    s->state[i] = static_cast<uint32_t*>(
        take(i < p.passes ? (p.tiles << p.bits[i]) * 4 : 0));
  s->zeroed = off;
  const size_t keys = e > 0 ? e : 1;
  for (auto& buf : s->pairs)
    buf = static_cast<unsigned long long*>(take(keys * 8));
  for (int i = 0; i < MAX_PASSES; ++i)
    s->moves.to[i] =
        static_cast<uint32_t*>(take(i < p.passes ? keys * 4 : 0));
  s->packed = static_cast<uint8_t*>(take(e * stride));
  return off;
}

// The scratch of a call (the packing at its widest: as if every tensor
// were aligned).
inline size_t scratch_bytes(long long e, long long n, bool cls, long long k,
                            const long long* nbytes) {
  Pack pack;
  unsigned packed;
  const int stride = make_pack(k, nbytes, nullptr, nullptr, &pack, &packed);
  Scratch s;
  return carve(make_plan(e, n, cls), stride, e, n, nullptr, &s);
}

__device__ __forceinline__ bool deliverable(const int32_t* dst,
                                            const bool* valid, long long i,
                                            int n, int* d) {
  *d = dst[i];
  return valid[i] && *d >= 0 && *d < n;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Inclusive scan over the block (blockDim.x a multiple of 32, <= 1024);
// `total` receives the block's sum on every thread.
__device__ int block_incl_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_incl_scan(v);
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    s = warp_incl_scan(s);
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_sums[w - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();
  return v;
}

// Exclusive scan of r <= RADIX counts by a block of THREADS threads,
// each over DPT consecutive digits; returns the sum.
__device__ int scan_digits(const uint32_t* in, int* out, int r) {
  const int d0 = threadIdx.x * DPT;
  int v[DPT], s = 0;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    v[k] = d0 + k < r ? static_cast<int>(in[d0 + k]) : 0;
    s += v[k];
  }
  int total;
  int run = block_incl_scan(s, &total) - s;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    if (d0 + k < r) out[d0 + k] = run;
    run += v[k];
  }
  return total;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// An nb-byte field (nb = 1, 2 or 4) of row `i`, zero-extended.
__device__ __forceinline__ uint32_t load_field(const uint8_t* col, int nb,
                                               long long i) {
  return nb == 4   ? __ldg(reinterpret_cast<const uint32_t*>(col) + i)
         : nb == 2 ? __ldg(reinterpret_cast<const uint16_t*>(col) + i)
                   : __ldg(col + i);
}

__device__ __forceinline__ void store_field(uint8_t* col, int nb,
                                            long long i, uint32_t v) {
  if (nb == 4)
    reinterpret_cast<uint32_t*>(col)[i] = v;
  else if (nb == 2)
    reinterpret_cast<uint16_t*>(col)[i] = static_cast<uint16_t>(v);
  else
    col[i] = static_cast<uint8_t>(v);
}

// The hist pass: HIST_EPT edges a thread a step, a warp's edges
// consecutive; the loop is warp-uniform, for the warp-wide stores of the
// packed rows.
__global__ void __launch_bounds__(HIST_THREADS, 4)
    dk_hist_kernel(const int32_t* dst, const bool* valid, const uint8_t* cls,
                   long long e, int n, Plan plan, Pack pack, uint8_t* packed,
                   uint32_t* hist, uint32_t* total, bool* clear) {
  __shared__ uint32_t h[MAX_PASSES * RADIX];
  __shared__ __align__(16) uint8_t stage[HIST_THREADS * 32];
  __shared__ uint32_t kept;
  for (int i = threadIdx.x; i < MAX_PASSES * RADIX; i += blockDim.x) h[i] = 0;
  if (threadIdx.x == 0) kept = 0;
  __syncthreads();
  uint32_t mine = 0;
  const int lane = threadIdx.x & 31;
  const long long span = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long wb = blockIdx.x * (long long)blockDim.x + threadIdx.x - lane;
       wb < e; wb += HIST_EPT * span) {
    int d[HIST_EPT], c0[HIST_EPT];
    bool ok[HIST_EPT];
#pragma unroll
    for (int t = 0; t < HIST_EPT; ++t) {
      const long long i = wb + t * span + lane;
      ok[t] = i < e && deliverable(dst, valid, i, n, &d[t]);
      c0[t] = i < e && plan.cls ? cls[i] : 0;
      if (i < e && clear) clear[i] = false;
    }
    if (pack.k) {  // block-uniform
      // The deliverable edges' column loads of the step in flight at
      // once; a 32-byte row goes out through shared memory, so that
      // consecutive lanes store consecutive 16-byte chunks.
      uint32_t w[HIST_EPT][MAX_COLS];
#pragma unroll
      for (int t = 0; t < HIST_EPT; ++t) {
        const long long i = wb + t * span + lane;
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c)
          w[t][c] = ok[t] && c < pack.k ? load_field(pack.src[c], pack.nb[c],
                                                     i)
                                        : 0;
      }
#pragma unroll
      for (int t = 0; t < HIST_EPT; ++t) {
        const long long i = wb + t * span + lane;
        uint8_t* row = packed + i * pack.stride;
        if (pack.stride == 8) {
          if (ok[t])
            *reinterpret_cast<uint2*>(row) = make_uint2(w[t][0], w[t][1]);
        } else if (pack.stride == 16) {
          if (ok[t])
            *reinterpret_cast<uint4*>(row) =
                make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
        } else {
          uint4* own = reinterpret_cast<uint4*>(stage) + 2 * threadIdx.x;
          own[0] = make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
          own[1] = make_uint4(w[t][4], w[t][5], w[t][6], w[t][7]);
          __syncwarp();
          const unsigned keep = __ballot_sync(FULL_MASK, ok[t]);
          const uint4* rows = own - 2 * lane;
          uint4* out = reinterpret_cast<uint4*>(row - lane * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (keep >> (h * 16 + lane / 2) & 1)
              out[h * 32 + lane] = rows[h * 32 + lane];
          __syncwarp();
        }
      }
    }
#pragma unroll
    for (int t = 0; t < HIST_EPT; ++t) {
      if (!ok[t]) continue;
      ++mine;
#pragma unroll
      for (int p = 0; p < MAX_PASSES; ++p) {
        if (p >= plan.passes) continue;
        const int dg = plan.cls && p == 0 ? c0[t]
                                          : (d[t] >> plan.shift[p]) &
                                                ((1 << plan.bits[p]) - 1);
        atomicAdd(&h[p * RADIX + dg], 1u);
      }
    }
  }
  if (mine) atomicAdd(&kept, mine);
  __syncthreads();
  for (int i = threadIdx.x; i < plan.passes * RADIX; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[i], h[i]);
  if (threadIdx.x == 0 && kept) atomicAdd(total, kept);
}

// Shared memory of a pass block.
struct PassSmem {
  unsigned long long pairs[TILE];  // the tile, digit-sorted
  uint16_t digit[TILE];
  alignas(16) uint16_t warp_count[WARPS][RADIX];  // then warp offsets
  int base[RADIX];     // digit's first position in the pass's output
  int local[RADIX];    // digit's first position in the tile
  uint32_t count[RADIX];  // digit's keys in the tile
  long long tile;
};

// One onesweep pass.  `first`: read the edge list (and drop what is not
// deliverable), else the pairs `in`; `cls_digit`: the digit is the
// class.  `hist` is this pass's bins, `state` its look-back words,
// `taken` its tile counter, `total` the deliverable edges; `moved`
// (null: not kept) receives each key's output position at its input
// index.
__global__ void __launch_bounds__(THREADS, 3)
    dk_pass_kernel(int first, int cls_digit, int shift, int bits,
                   const int32_t* dst, const bool* valid, const uint8_t* cls,
                   long long e, int n, const unsigned long long* in,
                   unsigned long long* out, uint32_t* moved,
                   const uint32_t* hist, const uint32_t* total,
                   uint32_t* taken, uint32_t* state) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);
  const int r = 1 << bits;
  const uint32_t mask = r - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = first ? e : static_cast<long long>(*total);
  if (threadIdx.x == 0) sm.tile = atomicAdd(taken, 1u);
  for (int i = threadIdx.x; i < WARPS * RADIX / 8; i += THREADS)
    reinterpret_cast<uint4*>(&sm.warp_count[0][0])[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long tile = sm.tile;
  const long long tbase = tile * TILE;
  if (tbase >= m) return;  // block-uniform: no later tile has keys
  const long long mine = tbase + warp * (32 * IPT) + lane;

  // Load the tile: key j of a thread is key warp * 32 * IPT + j * 32 +
  // lane of the tile, so (warp, j, lane) is key order.
  unsigned long long key[IPT];
  uint32_t dr[IPT];  // the digit, then digit << 16 | place; ~0: no key
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const long long i = mine + j * 32;
    dr[j] = ~0u;
    key[j] = 0;
    if (i < m) {
      if (first) {
        int d;
        if (deliverable(dst, valid, i, n, &d)) {
          key[j] = static_cast<unsigned long long>(d) << 32 |
                   static_cast<uint32_t>(i);
          dr[j] = cls_digit ? cls[i] : (d >> shift) & mask;
        }
      } else {
        key[j] = in[i];
        dr[j] = (static_cast<uint32_t>(key[j] >> 32) >> shift) & mask;
      }
    }
  }
  scan_digits(hist, sm.base, r);

  // Rank: each key's count of equal digits before it in its warp.  The
  // lanes holding the same digit are found with one ballot per digit bit.
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const bool has = dr[j] != ~0u;
    unsigned peers = __ballot_sync(FULL_MASK, has);
    for (int b = 0; b < bits; ++b) {
      const bool bit = (dr[j] >> b) & 1;
      const unsigned set = __ballot_sync(FULL_MASK, bit);
      peers &= bit ? set : ~set;
    }
    uint32_t pre = 0;
    if (has) pre = sm.warp_count[warp][dr[j]];
    __syncwarp();
    if (has && lane == __ffs(peers) - 1)
      sm.warp_count[warp][dr[j]] =
          static_cast<uint16_t>(pre + __popc(peers));
    __syncwarp();
    if (has) dr[j] = dr[j] << 16 | (pre + __popc(peers & lower));
  }
  __syncthreads();

  // Per digit: the warps' offsets, the tile's count, published at once
  // (the first tile's count is already its inclusive prefix).
  for (int dg = threadIdx.x; dg < r; dg += THREADS) {
    uint32_t s = 0;
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t c = sm.warp_count[w][dg];
      sm.warp_count[w][dg] = static_cast<uint16_t>(s);
      s += c;
    }
    sm.count[dg] = s;
    store_volatile(&state[tile * r + dg], (tile ? FLAG_AGG : FLAG_INC) | s);
  }
  __syncthreads();
  const int nt = scan_digits(sm.count, sm.local, r);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (dr[j] == ~0u) continue;
    const int dg = dr[j] >> 16;
    const int at = sm.local[dg] + sm.warp_count[warp][dg] + (dr[j] & 0xFFFF);
    sm.pairs[at] = key[j];
    sm.digit[at] = static_cast<uint16_t>(dg);
    dr[j] = static_cast<uint32_t>(dg) << 16 | at;
  }

  // Look back over the earlier tiles, each thread for its digits at once
  // and WINDOW tiles a step, taking their counts from the nearest until
  // one holds an inclusive count (and stopping at one not yet
  // published); then publish this tile's inclusive count and keep the
  // digit's output offset (base + earlier tiles - its start in the tile).
  uint32_t before[DPT];
  long long at[DPT];
  bool done[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    before[k] = 0;
    at[k] = tile - 1;
    done[k] = tile == 0 || threadIdx.x + k * THREADS >= r;
  }
  for (bool busy = true; busy;) {
    uint32_t v[DPT][WINDOW];  // every load of the step in flight at once
#pragma unroll
    for (int k = 0; k < DPT; ++k)
#pragma unroll
      for (int w = 0; w < WINDOW; ++w)
        v[k][w] = !done[k] && at[k] - w >= 0
                      ? load_volatile(&state[(at[k] - w) * r + threadIdx.x +
                                             k * THREADS])
                      : FLAG_INC;
    busy = false;
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      if (done[k]) continue;
#pragma unroll
      for (int w = 0; w < WINDOW; ++w) {
        if (!(v[k][w] & (FLAG_AGG | FLAG_INC))) break;  // not published
        before[k] += v[k][w] & COUNT;
        --at[k];
        if (v[k][w] & FLAG_INC) {
          done[k] = true;
          break;
        }
      }
      busy |= !done[k];
    }
  }
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int dg = threadIdx.x + k * THREADS;
    if (dg >= r) continue;
    if (tile) store_volatile(&state[tile * r + dg],
                             FLAG_INC | (before[k] + sm.count[dg]));
    sm.base[dg] += static_cast<int>(before[k]) - sm.local[dg];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt; i += THREADS)
    out[sm.base[sm.digit[i]] + i] = sm.pairs[i];
  if (!moved) return;
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    if (dr[j] != ~0u)
      moved[mine + j * 32] = sm.base[dr[j] >> 16] + (dr[j] & 0xFFFF);
}

__device__ __forceinline__ int dest_of(unsigned long long pair) {
  return static_cast<int>(pair >> 32);
}

__global__ void dk_runs_kernel(const unsigned long long* sorted,
                               const uint32_t* total, int2* bounds) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long m = *total;
  if (i >= m) return;
  const int d = dest_of(sorted[i]);
  if (i == 0 || dest_of(sorted[i - 1]) != d)
    bounds[d].x = static_cast<int>(i);
  if (i == m - 1 || dest_of(sorted[i + 1]) != d)
    bounds[d].y = static_cast<int>(i + 1);
}

// `rows` rows of `nb` bytes in T-sized words, GROUP loads in flight a
// thread: row r of `to` (rows `nb` bytes apart) from row `row_of(r)` of
// `from`, zeros where that is negative.
template <typename T, typename RowOf>
__device__ __forceinline__ void copy_rows_t(uint8_t* to, const uint8_t* from,
                                            long long nb, int rows,
                                            RowOf row_of) {
  const int per_row = static_cast<int>(nb / sizeof(T));
  const int words = rows * per_row;
  const T* s = reinterpret_cast<const T*>(from);
  T* d = reinterpret_cast<T*>(to);
  for (int u0 = threadIdx.x; u0 < words; u0 += GROUP * blockDim.x) {
    T v[GROUP];
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      const int u = u0 + t * static_cast<int>(blockDim.x);
      const int r = per_row == 1 ? u : u / per_row;
      const long long src = u < words ? row_of(r) : -1;
      v[t] = src >= 0 ? s[src * per_row + (u - r * per_row)] : T{};
    }
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      const int u = u0 + t * static_cast<int>(blockDim.x);
      if (u < words) d[u] = v[t];
    }
  }
}

template <typename RowOf>
__device__ __forceinline__ void copy_rows(int width, uint8_t* to,
                                          const uint8_t* from, long long nb,
                                          int rows, RowOf row_of) {
  switch (width) {
    case 16: copy_rows_t<uint4>(to, from, nb, rows, row_of); break;
    case 8: copy_rows_t<uint2>(to, from, nb, rows, row_of); break;
    case 4: copy_rows_t<uint32_t>(to, from, nb, rows, row_of); break;
    case 2: copy_rows_t<uint16_t>(to, from, nb, rows, row_of); break;
    default: copy_rows_t<uint8_t>(to, from, nb, rows, row_of);
  }
}

// The landing: blocks [0, land_blocks) over the [N, Q] rows, ROWS_PT
// rows a thread; the blocks after them over the edges, EPT a thread,
// writing the receipts (all -1 without `receipts`).
__global__ void __launch_bounds__(LAND_THREADS)
    dk_land_kernel(const unsigned long long* sorted, const int2* bounds,
                   long long rows, int q, Cols cols, Pack pack,
                   const uint8_t* packed, bool* inbox_valid,
                   int32_t* n_dropped, long long land_blocks,
                   const int32_t* dst, const bool* valid, long long e, int n,
                   int passes, Moves moves, int receipts,
                   int32_t* edge_slot) {
  if (blockIdx.x >= land_blocks) {
    const long long base =
        (blockIdx.x - land_blocks) * static_cast<long long>(LAND_THREADS) *
            EPT + threadIdx.x;
    int d[EPT];
    long long p[EPT];
#pragma unroll
    for (int t = 0; t < EPT; ++t) {
      const long long i = base + t * LAND_THREADS;
      p[t] = i < e && receipts && deliverable(dst, valid, i, n, &d[t]) ? i
                                                                        : -1;
    }
#pragma unroll
    for (int s = 0; s < MAX_PASSES; ++s) {
      if (s >= passes) continue;
#pragma unroll
      for (int t = 0; t < EPT; ++t)
        if (p[t] >= 0) p[t] = moves.to[s][p[t]];
    }
#pragma unroll
    for (int t = 0; t < EPT; ++t) {
      const long long i = base + t * LAND_THREADS;
      if (i >= e) continue;
      int slot = -1;
      if (p[t] >= 0) {
        slot = static_cast<int>(p[t] - bounds[d[t]].x);
        if (slot >= q) slot = -1;
      }
      edge_slot[i] = slot;
    }
    return;
  }

  __shared__ int edge[LAND_ROWS];
  const long long row0 = blockIdx.x * static_cast<long long>(LAND_ROWS);
  const int nr = rows - row0 < LAND_ROWS ? static_cast<int>(rows - row0)
                                         : LAND_ROWS;
  int d[ROWS_PT], slot[ROWS_PT], ed[ROWS_PT];
  int2 b[ROWS_PT];
#pragma unroll
  for (int t = 0; t < ROWS_PT; ++t) {
    const int r = threadIdx.x + t * LAND_THREADS;
    if (r >= nr) continue;
    d[t] = static_cast<int>((row0 + r) / q);
    slot[t] = static_cast<int>(row0 + r - static_cast<long long>(d[t]) * q);
    b[t] = bounds[d[t]];
  }
#pragma unroll
  for (int t = 0; t < ROWS_PT; ++t) {
    const int r = threadIdx.x + t * LAND_THREADS;
    ed[t] = -1;
    if (r >= nr) continue;
    const int g = b[t].y - b[t].x;
    if (slot[t] < g)
      ed[t] = static_cast<int>(sorted[b[t].x + slot[t]] & 0xFFFFFFFFu);
    edge[r] = ed[t];
    inbox_valid[row0 + r] = ed[t] >= 0;
    if (slot[t] == 0) n_dropped[d[t]] = g > q ? g - q : 0;
  }
  if (pack.k) {  // block-uniform: each row's packed row, unpacked
    uint32_t w[ROWS_PT][MAX_COLS];
#pragma unroll
    for (int t = 0; t < ROWS_PT; ++t) {
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (ed[t] >= 0) {
        const uint8_t* row = packed + static_cast<long long>(ed[t]) *
                                          pack.stride;
        if (pack.stride == 8) {
          const uint2 a = *reinterpret_cast<const uint2*>(row);
          lo = make_uint4(a.x, a.y, 0, 0);
        } else {
          lo = *reinterpret_cast<const uint4*>(row);
          if (pack.stride == 32)
            hi = *reinterpret_cast<const uint4*>(row + 16);
        }
      }
      w[t][0] = lo.x, w[t][1] = lo.y, w[t][2] = lo.z, w[t][3] = lo.w;
      w[t][4] = hi.x, w[t][5] = hi.y, w[t][6] = hi.z, w[t][7] = hi.w;
    }
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      if (c >= pack.k) continue;
#pragma unroll
      for (int t = 0; t < ROWS_PT; ++t) {
        const int r = threadIdx.x + t * LAND_THREADS;
        if (r < nr) store_field(pack.dst[c], pack.nb[c], row0 + r, w[t][c]);
      }
    }
  }
  if (cols.packed == (1u << cols.k) - 1) return;  // block-uniform
  __syncthreads();
  auto edge_of = [&](int r) -> long long { return edge[r]; };
#pragma unroll
  for (int j = 0; j < MAX_COLS; ++j) {
    if (j >= cols.k || cols.packed >> j & 1) continue;
    const long long nb = cols.nbytes[j];
    copy_rows(cols.width[j], cols.dst[j] + row0 * nb, cols.src[j], nb, nr,
              edge_of);
  }
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that divides a row and both
// columns' addresses.
inline int copy_width(long long nb, const void* a, const void* b) {
  const unsigned long long pa = reinterpret_cast<unsigned long long>(a);
  const unsigned long long pb = reinterpret_cast<unsigned long long>(b);
  int w = 16;
  while (w > 1 && (nb % w || pa % w || pb % w)) w >>= 1;
  return w;
}

// The whole delivery of `e` edges into [n, q] inboxes on `stream`.
// `scratch` holds scratch_bytes(e, n, cls != null, k, nbytes) bytes;
// `clear`, when given, is a bool[e] written false on the way.
inline int deliver_launch(const int32_t* dst, const bool* valid,
                          const uint8_t* cls, long long e, long long n,
                          long long q, long long k, void* const* src_cols,
                          void* const* dst_cols, const long long* nbytes,
                          int receipts, bool* inbox_valid, int32_t* n_dropped,
                          int32_t* edge_slot, bool* clear, void* scratch,
                          long long scratch_size, cudaStream_t stream) {
  if (k < 0 || k > MAX_COLS || q < 1 || n < 1 || e < 0 || e >= MAX_EDGES)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(e, n, cls != nullptr);
  Cols cols{};
  Pack pack;
  const int stride =
      make_pack(k, nbytes, src_cols, dst_cols, &pack, &cols.packed);
  Scratch s;
  if (carve(plan, stride, e, n, scratch, &s) >
      static_cast<size_t>(scratch_size))
    return cudaErrorInvalidValue;
  cols.k = static_cast<int>(k);
  for (int j = 0; j < k; ++j) {
    cols.src[j] = static_cast<const uint8_t*>(src_cols[j]);
    cols.dst[j] = static_cast<uint8_t*>(dst_cols[j]);
    cols.nbytes[j] = nbytes[j];
    cols.width[j] = copy_width(nbytes[j], src_cols[j], dst_cols[j]);
  }
  const int ni = static_cast<int>(n);
  uint32_t* total = s.counters + MAX_PASSES;

  cudaMemsetAsync(scratch, 0, s.zeroed, stream);
  int sms = 132, dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned steps = blocks_for(e, HIST_THREADS * HIST_EPT);
  const unsigned hist_grid = steps < 8u * sms ? steps : 8u * sms;
  LAUNCH(dk_hist_kernel, hist_grid, HIST_THREADS, 0, stream)(
      dst, valid, cls, e, ni, plan, pack, s.packed, s.hist, total, clear);
  cudaFuncSetAttribute(dk_pass_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(sizeof(PassSmem)));
  for (int p = 0; p < plan.passes; ++p) {
    LAUNCH(dk_pass_kernel, static_cast<unsigned>(plan.tiles), THREADS,
           sizeof(PassSmem), stream)(
        p == 0, plan.cls && p == 0, plan.shift[p], plan.bits[p], dst, valid,
        cls, e, ni, p ? s.pairs[(p - 1) & 1] : nullptr, s.pairs[p & 1],
        receipts ? s.moves.to[p] : nullptr, s.hist + p * RADIX, total,
        s.counters + p, s.state[p]);
  }
  const unsigned long long* sorted = s.pairs[(plan.passes - 1) & 1];
  LAUNCH(dk_runs_kernel, blocks_for(e, 256), 256, 0, stream)(sorted, total,
                                                            s.bounds);
  const unsigned land = blocks_for(n * q, LAND_ROWS);
  const unsigned edges = e > 0 ? blocks_for(e, LAND_THREADS * EPT) : 0;
  LAUNCH(dk_land_kernel, land + edges, LAND_THREADS, 0, stream)(
      sorted, s.bounds, n * q, static_cast<int>(q), cols, pack, s.packed,
      inbox_valid, n_dropped, land, dst, valid, e, ni, plan.passes, s.moves,
      receipts, edge_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dk
