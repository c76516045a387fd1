// ring_poll: per-slot status of a device mailbox ring.
//
// Replaces the TPU kernel src/repro/kernels/ring_poll.py::ring_poll
// (_poll_kernel), which ran one grid step per slot and found the trailer
// with a masked sum over the whole slot.
//
// Bound on this card: neither bytes nor operations.  A sweep reads five
// header words and one trailer word per slot (24 B), so the 512 slots of
// the singleton lane move 12 KiB — a few nanoseconds at 3.35 TB/s.  The
// launch itself (a few microseconds) is the cost.  The design therefore
// does the least work per launch: one thread per slot, the five header
// words read directly, the one trailer word gathered at min(5 + fw, W - 1)
// instead of scanning the slot, and no shared memory or synchronisation.
//
// The lanes no longer launch this kernel: their sweep polls each slot
// inside the one launch that also executes, masks and clears it
// (ifunc_vm.cu, ring_sweep_*_kernel), with the same per-slot logic from
// mailbox_poll.cuh.  It stays as ring_poll(), the reference's API.
//
// Slot layout and statuses: mailbox_poll.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "mailbox_poll.cuh"

namespace {

__global__ void ring_poll_kernel(const uint32_t* __restrict__ slots,
                                 int64_t n_slots, int64_t slot_words,
                                 int32_t* __restrict__ status) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  status[i] = mailbox::frame_status(slots + i * slot_words, slot_words);
}

}  // namespace

extern "C" int ring_poll_launch(const void* slots, int64_t n_slots,
                                int64_t slot_words, void* status,
                                void* stream) {
  if (n_slots <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n_slots + threads - 1) / threads);
  ring_poll_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(slots), n_slots, slot_words,
      static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
