// K4: rank_compact_many -- move several same-shaped [N, W] columns to
// their slot in fill-initialised [N, width] rows, sharing one slot map;
// entries whose slot is not in [0, width) are dropped (the spill slot).
//
// Replaces dispersy_tpu/ops/store.py:140 `rank_compact_many` (and :102
// `rank_compact`), whose TPU form runs one flat scatter per column with
// adjacent uint8 column pairs folded into one uint16 scatter.
//
// Bound on the H100: bytes.  The function reads the slot map once, each
// column at the entries whose slot is below the width, and writes each
// [N, width] output once.
//
// Design: the gather form of the JAX package's CPU path
// (store.py:180-186).  A block takes `rows` consecutive rows.  It reads
// their slot maps as one flat run (16-byte vector loads when the map's
// rows are 16-byte aligned) and inverts them in shared memory: an entry
// with 0 <= slot < width writes its index to inv[row][slot], which starts
// at -1 (slots below the width are unique per row by the function's
// contract).  The block's threads then take the output elements (row, t)
// in order -- consecutive threads write consecutive outputs, several rows
// a warp at small widths -- read inv, load every column at that index
// (only kept entries are read), and write the value or the fill once.
// The columns are grouped by element size on the host (4, 2, then 1
// byte; bool is 1), so every load and store has a compile-time width,
// and the call sites' patterns of column counts -- (4, 0, 2), (3, 1, 2),
// (4, 0, 1), (3, 1, 1) -- are template parameters: a thread issues every
// column's loads at UNO = 4 output elements before it stores any (any
// other mix reads its counts at run time, one element at a time).
#include "common.cuh"

namespace {

constexpr int MAX_COLS = 8;       // kernels.MAX_COLS
constexpr int THREADS = 256;
constexpr int MAX_INV = 8192;     // inv entries a block (int16: 16 KB)
constexpr int IN_PER_BLOCK = 4096;  // slot entries a block aims for
constexpr int MAX_W = 32767;      // an entry index fits inv's int16
constexpr int UN = 4;             // loads a thread keeps in flight

// The columns of one element size; fill bits in the low bytes.
struct Group {
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  uint32_t fill[MAX_COLS];
  int n;
};

struct CCols {
  Group g[3];  // 4-, 2- and 1-byte columns
};

// A group's C columns (C = MAX_COLS and `g.n` at run time when RT) at
// UNO output elements: entry index i (or -1: the fill), from its offset.
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
      const int o = base + u * THREADS + threadIdx.x;
      if (o < n_out) static_cast<T*>(g.dst[j])[out0 + o] = v[j][u];
    }
  }
}

// N4, N2, N1: the columns of each size, compile-time for the patterns
// the call sites use (UNO outputs a thread in flight); -1: any mix, the
// counts read at run time, one output at a time.
template <bool VEC, int N4, int N2, int N1>
__global__ void __launch_bounds__(THREADS, 4)
    dk_compact_kernel(const int32_t* slot, long long n, int w, int width,
                      int rows, CCols c) {
  constexpr bool RT = N4 < 0;
  constexpr int UNO = RT ? 1 : 4;
  constexpr int C4 = RT ? MAX_COLS : N4;
  constexpr int C2 = RT ? MAX_COLS : N2;
  constexpr int C1 = RT ? MAX_COLS : N1;
  __shared__ int16_t inv[MAX_INV];
  const long long row0 = blockIdx.x * static_cast<long long>(rows);
  const int nr = static_cast<int>(min(static_cast<long long>(rows),
                                      n - row0));
  const int n_out = nr * width;
  for (int o = threadIdx.x; o < n_out; o += THREADS) inv[o] = -1;
  __syncthreads();

  // Invert the slot maps: the block's nr * w entries are one flat run.
  const int32_t* sl = slot + row0 * w;
  const unsigned uw = static_cast<unsigned>(width);
  if (VEC) {  // w % 4 == 0: a vector's four entries lie in one row
    const int n4 = nr * w / 4;
    const int4* sl4 = reinterpret_cast<const int4*>(sl);
    for (int base = 0; base < n4; base += UN * THREADS) {
      int4 v[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f4 = base + u * THREADS + threadIdx.x;
        if (f4 < n4) v[u] = __ldg(sl4 + f4);
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f = 4 * (base + u * THREADS + threadIdx.x);
        if (f >= 4 * n4) break;
        const int r = f / w;
        const int i = f - r * w;
        int16_t* iv = inv + r * width;
        if (static_cast<unsigned>(v[u].x) < uw) iv[v[u].x] = i;
        if (static_cast<unsigned>(v[u].y) < uw) iv[v[u].y] = i + 1;
        if (static_cast<unsigned>(v[u].z) < uw) iv[v[u].z] = i + 2;
        if (static_cast<unsigned>(v[u].w) < uw) iv[v[u].w] = i + 3;
      }
    }
  } else {
    const int n_in = nr * w;
    for (int base = 0; base < n_in; base += UN * THREADS) {
      int v[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f = base + u * THREADS + threadIdx.x;
        if (f < n_in) v[u] = __ldg(sl + f);
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int f = base + u * THREADS + threadIdx.x;
        if (f >= n_in) break;
        const int r = f / w;
        if (static_cast<unsigned>(v[u]) < uw)
          inv[r * width + v[u]] = static_cast<int16_t>(f - r * w);
      }
    }
  }
  __syncthreads();

  // Every output element once: gather the kept entry or write the fill;
  // every load of a step in flight before its stores.
  const long long out0 = row0 * width;
  for (int base = 0; base < n_out; base += UNO * THREADS) {
    int i[UNO];
    long long from[UNO];
#pragma unroll
    for (int u = 0; u < UNO; ++u) {
      const int o = base + u * THREADS + threadIdx.x;
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

template <int N4, int N2, int N1>
int launch(const int32_t* slot, long long n, int w, int width, int rows,
           const CCols& c, cudaStream_t stream) {
  const bool vec =
      w % 4 == 0 && (reinterpret_cast<uintptr_t>(slot) & 15) == 0;
  const auto kernel = vec ? dk_compact_kernel<true, N4, N2, N1>
                          : dk_compact_kernel<false, N4, N2, N1>;
  LAUNCH(kernel, dk::blocks_for(n, rows), THREADS, 0, stream)(
      slot, n, w, width, rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DK_EXPORT int dk_rank_compact(const int32_t* slot, long long n, long long w,
                              long long width, long long k,
                              void* const* src, void* const* dst,
                              const long long* size,
                              const long long* fill, cudaStream_t stream) {
  if (k < 1 || k > MAX_COLS || width < 1 || width > MAX_INV || w < 1 ||
      w > MAX_W || n < 0)
    return cudaErrorInvalidValue;
  for (int j = 0; j < k; ++j)
    if (size[j] != 1 && size[j] != 2 && size[j] != 4)
      return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  // The columns grouped by element size, 4 then 2 then 1 byte.
  CCols c{};
  for (int j = 0; j < k; ++j) {
    Group& g = c.g[size[j] == 4 ? 0 : size[j] == 2 ? 1 : 2];
    g.src[g.n] = src[j];
    g.dst[g.n] = dst[j];
    g.fill[g.n] = static_cast<uint32_t>(fill[j]);
    ++g.n;
  }
  // Rows a block: about IN_PER_BLOCK slot entries, inv within MAX_INV.
  long long rows = IN_PER_BLOCK / w;
  rows = rows < 1 ? 1 : rows;
  rows = rows < MAX_INV / width ? rows : MAX_INV / width;
  const int wi = static_cast<int>(w), wd = static_cast<int>(width);
  const int ri = static_cast<int>(rows);
  // The call sites' patterns: the outbox and the recovery pass (u32 or
  // u16 aux, two byte columns), the forward buffer and the timeline's
  // auth table (one byte column).
  const int n4 = c.g[0].n, n2 = c.g[1].n, n1 = c.g[2].n;
  if (n4 == 4 && n2 == 0 && n1 == 2)
    return launch<4, 0, 2>(slot, n, wi, wd, ri, c, stream);
  if (n4 == 3 && n2 == 1 && n1 == 2)
    return launch<3, 1, 2>(slot, n, wi, wd, ri, c, stream);
  if (n4 == 4 && n2 == 0 && n1 == 1)
    return launch<4, 0, 1>(slot, n, wi, wd, ri, c, stream);
  if (n4 == 3 && n2 == 1 && n1 == 1)
    return launch<3, 1, 1>(slot, n, wi, wd, ri, c, stream);
  return launch<-1, -1, -1>(slot, n, wi, wd, ri, c, stream);
}
