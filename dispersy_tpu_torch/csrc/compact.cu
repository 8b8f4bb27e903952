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
// (only kept entries are read), and write the value or the fill once:
// the gather stage of csrc/compact.cuh, which K10 (csrc/remove.cu)
// shares.
#include "compact.cuh"

namespace {

using dk::CCols;
constexpr int MAX_COLS = dk::CMP_MAX_COLS;  // kernels.MAX_COLS
constexpr int THREADS = dk::CMP_THREADS;
constexpr int MAX_INV = dk::CMP_MAX_INV;
constexpr int IN_PER_BLOCK = 4096;  // slot entries a block aims for
constexpr int MAX_W = dk::CMP_MAX_W;
constexpr int UN = 4;             // loads a thread keeps in flight

// N4, N2, N1: the columns of each size, compile-time for the patterns
// the call sites use (UNO outputs a thread in flight); -1: any mix, the
// counts read at run time, one output at a time.
template <bool VEC, int N4, int N2, int N1>
__global__ void __launch_bounds__(THREADS, 4)
    dk_compact_kernel(const int32_t* slot, long long n, int w, int width,
                      int rows, CCols c) {
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

  // Every output element once: the kept entry or the fill.
  dk::gather_rows<N4, N2, N1>(inv, row0, nr, w, width, c);
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
  for (int j = 0; j < k; ++j)
    dk::add_col(&c, size[j], src[j], dst[j], static_cast<uint32_t>(fill[j]));
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
