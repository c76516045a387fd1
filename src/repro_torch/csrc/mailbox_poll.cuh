// mailbox_poll: the per-slot status logic of a device mailbox ring, shared
// by the standalone poll kernels (ring_poll.cu, agg_poll.cu) and the fused
// sweeps (ifunc_vm.cu, ring_sweep_* and agg_sweep_*), so that all of them
// read a slot the same way.
//
// Words are uint32 on the wire and int32 in PyTorch; everything here
// compares them as unsigned bit patterns.
//
// Singleton slot (kernels/ring_poll.py):
//   w0 magic 0x1F5C0DE5 | w1 frame_words | w2 code_kind | w3 name_hash |
//   w4 hdr_check = magic ^ fw ^ kind ^ name_hash | body | w[5+fw] trailer
// Status: EMPTY (magic 0, whatever follows), READY, INFLIGHT (header good,
// trailer absent), BAD (magic, check word, or fw > W - 6, compared
// unsigned so fw = 0xFFFFFFF0 is out of bounds).  The trailer is the one
// word at min(5 + fw, W - 1).
//
// Aggregate slot (kernels/agg_poll.py):
//   w0 magic 0x1F5C0DE6 | w1 n_subs | w2 code_kind | w3 reserved |
//   w4 hdr_check = magic ^ n_subs ^ kind ^ reserved |
//   w5 + 2i name_hash_i | w6 + 2i sub_check_i = name_hash_i ^ 0x5A17A9E5 |
//   ... bodies ... | w[W - 1] trailer 0xD0E1F2A3
// Container: as the singleton, with n_subs > K out of bounds and the
// trailer at the fixed tail.  Sub i: EMPTY unless the container is READY
// and i < n_subs; then READY (check good, hash == bound or bound == 0),
// NACK (check good, another hash), BAD (check word wrong).

#pragma once

#include <cstdint>

namespace mailbox {

constexpr uint32_t kMagic = 0x1F5C0DE5u;
constexpr uint32_t kAggMagic = 0x1F5C0DE6u;
constexpr uint32_t kSubSalt = 0x5A17A9E5u;
constexpr uint32_t kTrailer = 0xD0E1F2A3u;
constexpr int64_t kHdrWords = 5;
constexpr int32_t kEmpty = 0, kReady = 1, kInflight = 2, kBad = 3;
constexpr int32_t kSubEmpty = 0, kSubReady = 1, kSubBad = 3, kSubNack = 4;

// Where a singleton slot's trailer word is looked for.
__device__ __forceinline__ int64_t trailer_index(uint32_t fw,
                                                 int64_t slot_words) {
  const int64_t idx = kHdrWords + static_cast<int64_t>(fw);
  return idx > slot_words - 1 ? slot_words - 1 : idx;
}

// The status of the singleton slot at s (slot_words words); reads words
// 0-4 and, when the header is good, the trailer word.
__device__ __forceinline__ int32_t frame_status(const uint32_t* s,
                                                int64_t slot_words) {
  const uint32_t magic = s[0], fw = s[1], kind = s[2], nh = s[3], chk = s[4];
  if (magic == 0u) return kEmpty;
  const bool hdr_ok = magic == kMagic && chk == (magic ^ fw ^ kind ^ nh);
  const bool bounds_ok = static_cast<uint64_t>(fw) <=
                         static_cast<uint64_t>(slot_words - kHdrWords - 1);
  if (!(hdr_ok && bounds_ok)) return kBad;
  return s[trailer_index(fw, slot_words)] == kTrailer ? kReady : kInflight;
}

// The container status of the aggregate slot whose header words 0-4 are
// at h and whose tail word is trailer, for K = k descriptor pairs.
__device__ __forceinline__ int32_t container_status(const uint32_t* h,
                                                    uint32_t trailer,
                                                    int64_t k) {
  const uint32_t magic = h[0], n_subs = h[1], kind = h[2], rsvd = h[3],
                 chk = h[4];
  if (magic == 0u) return kEmpty;
  if (!(magic == kAggMagic && chk == (magic ^ n_subs ^ kind ^ rsvd) &&
        static_cast<uint64_t>(n_subs) <= static_cast<uint64_t>(k)))
    return kBad;
  return trailer == kTrailer ? kReady : kInflight;
}

// The status of sub-record i of a container in state container with
// n_subs occupied subs, from its descriptor pair (hash, check) and the
// mailbox-bound program hash (0 = any hash).
__device__ __forceinline__ int32_t sub_status(int32_t container,
                                              uint32_t n_subs, int64_t i,
                                              uint32_t hash, uint32_t check,
                                              uint32_t bound) {
  if (container != kReady || i >= static_cast<int64_t>(n_subs))
    return kSubEmpty;
  if (check != (hash ^ kSubSalt)) return kSubBad;
  return (bound == 0u || hash == bound) ? kSubReady : kSubNack;
}

}  // namespace mailbox
