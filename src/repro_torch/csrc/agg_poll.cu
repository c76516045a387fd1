// agg_poll: container and per-sub-record status of an aggregate mailbox ring.
//
// Replaces the TPU kernel src/repro/kernels/agg_poll.py::agg_ring_poll
// (_agg_poll_kernel), which ran one grid step per slot over the slot's
// header block, the trailer word and the bound hash in scalar memory.
//
// Bound on this card: neither bytes nor operations.  A slot reads its
// 5 + 2K header words and one trailer word and writes 1 + K statuses, so
// the 32 slots of the main path at K = 64 move about 25 KB, a few
// nanoseconds at 3.35 TB/s.  The launch is the cost.  The design keeps
// the work per launch small and reads the mailbox in place: one block per
// slot, given the header table's and the trailer column's base pointers
// with their row strides (they are strided views of the [slots, W]
// mailbox, so nothing is copied to poll); every thread derives the
// container status from the five header words and the tail word, thread 0
// writes it, and the threads stride over the K descriptors.
//
// Layout (uint32 words, kept as int32 by PyTorch and compared here as
// unsigned bit patterns):
//   w0 magic 0x1F5C0DE6 | w1 n_subs | w2 code_kind | w3 reserved |
//   w4 hdr_check = magic ^ n_subs ^ kind ^ reserved |
//   w5 + 2i name_hash_i | w6 + 2i sub_check_i = name_hash_i ^ 0x5A17A9E5 |
//   ... bodies ... | w[W - 1] trailer 0xD0E1F2A3
// Container: 0 EMPTY (magic 0), 1 READY, 2 INFLIGHT (header good, trailer
// absent), 3 BAD (magic, check word, or n_subs > K compared unsigned, so
// n_subs = 0xFFFFFFFF is out of bounds).
// Sub i: 0 EMPTY unless the container is READY and i < n_subs; then
// 1 READY (check good, hash == bound or bound == 0), 4 NACK (check good,
// another hash), 3 BAD (check word wrong).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kAggMagic = 0x1F5C0DE6u;
constexpr uint32_t kSubSalt = 0x5A17A9E5u;
constexpr uint32_t kTrailer = 0xD0E1F2A3u;
constexpr int64_t kHdrWords = 5;
constexpr int32_t kEmpty = 0, kReady = 1, kInflight = 2, kBad = 3;
constexpr int32_t kSubEmpty = 0, kSubReady = 1, kSubBad = 3, kSubNack = 4;

__global__ void agg_poll_kernel(const uint32_t* __restrict__ hdr,
                                int64_t hdr_stride,
                                const uint32_t* __restrict__ trailers,
                                int64_t trailer_stride, int64_t k,
                                uint32_t bound, int32_t* __restrict__ status,
                                int32_t* __restrict__ sub) {
  const int64_t slot = blockIdx.x;
  const uint32_t* h = hdr + slot * hdr_stride;
  const uint32_t magic = h[0], n_subs = h[1], kind = h[2], rsvd = h[3],
                 chk = h[4];
  int32_t st;
  if (magic == 0u) {
    st = kEmpty;
  } else if (!(magic == kAggMagic && chk == (magic ^ n_subs ^ kind ^ rsvd) &&
               static_cast<uint64_t>(n_subs) <= static_cast<uint64_t>(k))) {
    st = kBad;
  } else {
    st = trailers[slot * trailer_stride] == kTrailer ? kReady : kInflight;
  }
  if (threadIdx.x == 0) status[slot] = st;
  int32_t* out = sub + slot * k;
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    int32_t s = kSubEmpty;
    if (st == kReady && i < static_cast<int64_t>(n_subs)) {
      const uint32_t hash = h[kHdrWords + 2 * i];
      const uint32_t check = h[kHdrWords + 2 * i + 1];
      if (check != (hash ^ kSubSalt)) {
        s = kSubBad;
      } else {
        s = (bound == 0u || hash == bound) ? kSubReady : kSubNack;
      }
    }
    out[i] = s;
  }
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
