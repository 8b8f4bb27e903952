// K1: deliver -- an edge list of logical packets into bounded per-peer
// inboxes, as a stable radix sort by destination.
//
// Replaces dispersy_tpu/ops/inbox.py:79 `deliver`, whose TPU form sorts a
// packed (destination << pos_bits | position) key -- with the overload
// plane's admission class, (destination, class, position) -- with an
// unstable lax.sort, ranks each destination group with a cummax scan and
// scatters every payload column straight from edge order.
//
// Bound on the H100: bytes.  The function reads dst and valid (5 B per
// edge; 6 B with a class), the payload row of each delivered edge, and
// writes the [N, Q] inboxes, their valid mask, the per-peer drop counts
// and the per-edge receipt; there is no arithmetic to speak of.
//
// Design: the core of csrc/deliver.cuh -- a histogram pass, one onesweep
// radix pass per destination digit (three at 1M peers), the run bounds and
// a landing that writes every inbox row once.  With a class, a first
// pass sorts by it, so that the stable destination passes leave (class,
// edge) order inside a destination: lower classes take the inbox slots
// first and overflow sheds the highest classes, as the TPU form's packed
// key orders them.
#include "deliver.cuh"

DK_EXPORT long long dk_deliver_scratch(long long e, long long n,
                                       long long has_cls, long long k,
                                       const long long* nbytes) {
  return static_cast<long long>(
      dk::scratch_bytes(e, n, has_cls != 0, k, nbytes));
}

DK_EXPORT int dk_deliver(const int32_t* dst, const bool* valid,
                         const uint8_t* cls, long long e, long long n,
                         long long q, long long k, void* const* src_cols,
                         void* const* dst_cols, const long long* nbytes,
                         bool* inbox_valid, int32_t* n_dropped,
                         int32_t* edge_slot, void* scratch,
                         long long scratch_size, cudaStream_t stream) {
  return dk::deliver_launch(dst, valid, cls, e, n, q, k, src_cols, dst_cols,
                            nbytes, 1, inbox_valid, n_dropped, edge_slot,
                            nullptr, scratch, scratch_size, stream);
}
