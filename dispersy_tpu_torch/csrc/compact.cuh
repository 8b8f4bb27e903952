// The gather stage shared by K4 (csrc/compact.cu) and K10
// (csrc/remove.cu): with a block's inverse slot map in shared memory --
// inv[row][t], the input entry that lands in output slot t of the row, or
// -1 for the fill -- every output element (row, t) is written once, in
// order (consecutive threads on consecutive outputs), each column's value
// loaded at that entry (only landing entries are read) or its fill.
//
// The columns are grouped by element size on the host (4, 2, then 1
// byte; bool is 1), so every load and store has a compile-time width, and
// the call sites' patterns of column counts -- (4, 0, 2), (3, 1, 2),
// (4, 0, 1), (3, 1, 1) -- are template parameters: a thread issues every
// column's loads at UNO = 4 output elements before it stores any (any
// other mix reads its counts at run time, one element at a time).
#pragma once

#include "common.cuh"

namespace dk {
namespace {  // each source that includes this header keeps its own copy

constexpr int CMP_MAX_COLS = 8;     // kernels.MAX_COLS
constexpr int CMP_THREADS = 256;
constexpr int CMP_MAX_INV = 8192;   // inv entries a block (int16: 16 KB)
constexpr int CMP_MAX_W = 32767;    // an entry index fits inv's int16

// The columns of one element size; fill bits in the low bytes.
struct Group {
  const void* src[CMP_MAX_COLS];
  void* dst[CMP_MAX_COLS];
  uint32_t fill[CMP_MAX_COLS];
  int n;
};

struct CCols {
  Group g[3];  // 4-, 2- and 1-byte columns
};

// Adds a column of `size` bytes (4, 2 or 1) to its group.
inline void add_col(CCols* c, long long size, const void* src, void* dst,
                    uint32_t fill) {
  Group& g = c->g[size == 4 ? 0 : size == 2 ? 1 : 2];
  g.src[g.n] = src;
  g.dst[g.n] = dst;
  g.fill[g.n] = fill;
  ++g.n;
}

// A group's C columns (C = CMP_MAX_COLS and `g.n` at run time when RT)
// at UNO output elements: entry index i (or -1: the fill), from its
// offset.
template <typename T, int C, bool RT, int UNO>
__device__ __forceinline__ void load_group(const Group& g,
                                           const int (&i)[UNO],
                                           const long long (&from)[UNO],
                                           T (&v)[C ? C : 1][UNO]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (RT && j >= g.n) break;
#pragma unroll
    for (int u = 0; u < UNO; ++u)
      v[j][u] = i[u] >= 0
                    ? __ldg(static_cast<const T*>(g.src[j]) + from[u])
                    : static_cast<T>(g.fill[j]);
  }
}

template <typename T, int C, bool RT, int UNO>
__device__ __forceinline__ void store_group(const Group& g, int base,
                                            int n_out, long long out0,
                                            const T (&v)[C ? C : 1][UNO]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (RT && j >= g.n) break;
#pragma unroll
    for (int u = 0; u < UNO; ++u) {
      const int o = base + u * CMP_THREADS + threadIdx.x;
      if (o < n_out) static_cast<T*>(g.dst[j])[out0 + o] = v[j][u];
    }
  }
}

// Every output element of the block's `nr` rows from row `row0` once:
// rows of `w` input entries, `width` output slots; inv in shared memory.
// N4, N2, N1: the columns of each size, compile-time for the patterns
// the call sites use; -1: any mix, the counts read at run time.
template <int N4, int N2, int N1>
__device__ __forceinline__ void gather_rows(const int16_t* inv,
                                            long long row0, int nr, int w,
                                            int width, const CCols& c) {
  constexpr bool RT = N4 < 0;
  constexpr int UNO = RT ? 1 : 4;
  constexpr int C4 = RT ? CMP_MAX_COLS : N4;
  constexpr int C2 = RT ? CMP_MAX_COLS : N2;
  constexpr int C1 = RT ? CMP_MAX_COLS : N1;
  const int n_out = nr * width;
  const long long out0 = row0 * width;
  for (int base = 0; base < n_out; base += UNO * CMP_THREADS) {
    int i[UNO];
    long long from[UNO];
#pragma unroll
    for (int u = 0; u < UNO; ++u) {
      const int o = base + u * CMP_THREADS + threadIdx.x;
      i[u] = o < n_out ? inv[o] : -1;
      from[u] = (row0 + o / width) * w + i[u];
    }
    uint32_t v4[C4 ? C4 : 1][UNO];
    uint16_t v2[C2 ? C2 : 1][UNO];
    uint8_t v1[C1 ? C1 : 1][UNO];
    load_group<uint32_t, C4, RT, UNO>(c.g[0], i, from, v4);
    load_group<uint16_t, C2, RT, UNO>(c.g[1], i, from, v2);
    load_group<uint8_t, C1, RT, UNO>(c.g[2], i, from, v1);
    store_group<uint32_t, C4, RT, UNO>(c.g[0], base, n_out, out0, v4);
    store_group<uint16_t, C2, RT, UNO>(c.g[1], base, n_out, out0, v2);
    store_group<uint8_t, C1, RT, UNO>(c.g[2], base, n_out, out0, v1);
  }
}

}  // namespace
}  // namespace dk
