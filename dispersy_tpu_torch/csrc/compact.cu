// K4: rank_compact_many -- scatter several same-shaped [N, W] columns to
// their slot in fill-initialised [N, width] rows, sharing one slot map;
// entries whose slot is not in [0, width) are dropped (the spill slot).
//
// Replaces dispersy_tpu/ops/store.py:140 `rank_compact_many` (and :102
// `rank_compact`), whose TPU form runs one flat scatter per column with
// adjacent uint8 column pairs folded into one uint16 scatter.
//
// Bound on the H100: bytes.  The function reads the slot map and each
// column once and writes each [N, width] output once.
//
// Design.  One warp per row.  The lanes first write the fill value into
// every output slot of the row, synchronise the warp, then walk the
// row's W entries and copy each live entry of every column to its slot.
// Columns of mixed element sizes (u32, u16, u8, bool) ride one launch:
// the kernel copies by element size, so one pass over the slot map serves
// all of them.
#include "common.cuh"

namespace {

constexpr int MAX_COLS = 8;
constexpr int WARPS = 8;

struct CCols {
  const uint8_t* src[MAX_COLS];
  uint8_t* dst[MAX_COLS];
  int size[MAX_COLS];       // element bytes: 1 (u8, bool), 2 (u16), 4 (u32)
  uint32_t fill[MAX_COLS];  // fill bits, low `size` bytes used
  int k;
};

__device__ __forceinline__ void store_elem(uint8_t* base, int size,
                                           long long at, uint32_t v) {
  if (size == 4)
    reinterpret_cast<uint32_t*>(base)[at] = v;
  else if (size == 2)
    reinterpret_cast<uint16_t*>(base)[at] = static_cast<uint16_t>(v);
  else
    base[at] = static_cast<uint8_t>(v);
}

__device__ __forceinline__ uint32_t load_elem(const uint8_t* base, int size,
                                              long long at) {
  if (size == 4) return reinterpret_cast<const uint32_t*>(base)[at];
  if (size == 2) return reinterpret_cast<const uint16_t*>(base)[at];
  return base[at];
}

__global__ void dk_compact_kernel(const int32_t* slot, long long n, int w,
                                  int width, CCols c) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // warp-uniform
  for (int t = lane; t < width; t += 32)
    for (int j = 0; j < c.k; ++j)
      store_elem(c.dst[j], c.size[j], row * width + t, c.fill[j]);
  __syncwarp();
  for (int i = lane; i < w; i += 32) {
    const int s = slot[row * w + i];
    if (s < 0 || s >= width) continue;
    for (int j = 0; j < c.k; ++j)
      store_elem(c.dst[j], c.size[j], row * width + s,
                 load_elem(c.src[j], c.size[j], row * w + i));
  }
}

}  // namespace

DK_EXPORT int dk_rank_compact(const int32_t* slot, long long n, long long w,
                              long long width, long long k,
                              void* const* src, void* const* dst,
                              const long long* size,
                              const long long* fill, cudaStream_t stream) {
  if (k < 1 || k > MAX_COLS || width < 1) return cudaErrorInvalidValue;
  for (int j = 0; j < k; ++j)
    if (size[j] != 1 && size[j] != 2 && size[j] != 4)
      return cudaErrorInvalidValue;
  CCols c;
  c.k = static_cast<int>(k);
  for (int j = 0; j < MAX_COLS; ++j) {
    c.src[j] = j < k ? static_cast<const uint8_t*>(src[j]) : nullptr;
    c.dst[j] = j < k ? static_cast<uint8_t*>(dst[j]) : nullptr;
    c.size[j] = j < k ? static_cast<int>(size[j]) : 0;
    c.fill[j] = j < k ? static_cast<uint32_t>(fill[j]) : 0u;
  }
  LAUNCH(dk_compact_kernel, dk::blocks_for(n, WARPS), WARPS * 32, 0, stream)(
      slot, n, static_cast<int>(w), static_cast<int>(width), c);
  return static_cast<int>(cudaGetLastError());
}
