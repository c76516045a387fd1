// agg_poll: container and per-sub-record status of an aggregate mailbox ring.
//
// Replaces the TPU kernel src/repro/kernels/agg_poll.py::agg_ring_poll
// (_agg_poll_kernel), which ran one grid step per slot over the slot's
// header block, the trailer word and the bound hash in scalar memory.
//
// Bound on this card: neither bytes nor operations.  A slot reads its
// 5 + 2K header words and one trailer word and writes 1 + K statuses, so
// the 32 slots of the aggregate lane at K = 64 move about 25 KB, a few
// nanoseconds at 3.35 TB/s.  The launch is the cost.  The design keeps
// the work per launch small and reads the mailbox in place: one block per
// slot, given the header table's and the trailer column's base pointers
// with their row strides (they are strided views of the [slots, W]
// mailbox, so nothing is copied to poll); every thread derives the
// container status from the five header words and the tail word, thread 0
// writes it, and the threads stride over the K descriptors.
//
// The lanes no longer launch this kernel: their sweep polls each container
// and sub-record inside the one launch that also executes, masks and
// clears it (ifunc_vm.cu, agg_sweep_*_kernel), with the same logic from
// mailbox_poll.cuh.  It stays as agg_ring_poll(), the reference's API.
//
// Layout and statuses: mailbox_poll.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "mailbox_poll.cuh"

namespace {

__global__ void agg_poll_kernel(const uint32_t* __restrict__ hdr,
                                int64_t hdr_stride,
                                const uint32_t* __restrict__ trailers,
                                int64_t trailer_stride, int64_t k,
                                uint32_t bound, int32_t* __restrict__ status,
                                int32_t* __restrict__ sub) {
  const int64_t slot = blockIdx.x;
  const uint32_t* h = hdr + slot * hdr_stride;
  const int32_t st =
      mailbox::container_status(h, trailers[slot * trailer_stride], k);
  if (threadIdx.x == 0) status[slot] = st;
  int32_t* out = sub + slot * k;
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x)
    out[i] = mailbox::sub_status(st, h[1], i, h[mailbox::kHdrWords + 2 * i],
                                 h[mailbox::kHdrWords + 2 * i + 1], bound);
}

}  // namespace

extern "C" int agg_poll_launch(const void* hdr, int64_t hdr_stride,
                               const void* trailers, int64_t trailer_stride,
                               int64_t n_slots, int64_t k, uint32_t bound,
                               void* status, void* sub, void* stream) {
  if (n_slots <= 0) return 0;
  if (n_slots > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  agg_poll_kernel<<<static_cast<unsigned>(n_slots), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hdr), hdr_stride,
      static_cast<const uint32_t*>(trailers), trailer_stride, k, bound,
      static_cast<int32_t*>(status), static_cast<int32_t*>(sub));
  return static_cast<int>(cudaGetLastError());
}
