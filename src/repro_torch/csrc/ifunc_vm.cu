// ifunc_vm: the μVM interpreter, the device-tier ifunc executor.
//
// Replaces the TPU kernel src/repro/kernels/ifunc_vm.py::ifunc_vm
// (_vm_call / _vm_kernel): one grid step per 128x128 f32 payload tile runs
// the whole μVM program (20 opcodes over 8 tile registers) with the
// register file in VMEM and `matmul` on the MXU.
//
// Bound on this card: operations, for programs with a matmul.  A 128^3
// product is 4.2 MFLOP per tile against 128 KiB of payload in and out, 32
// FLOP per byte, above the FP32 (non-tensor-core) ridge of about 20 FLOP/B
// on an H100 SXM.  The μVM has no lower-precision mode, and TF32 tensor
// cores would miss the reference's 2e-5 tolerance, so the product runs as
// FP32 FMAs.  Programs without a matmul are bound by bytes.
//
// The register file of the reference (8 x 64 KiB a tile) does not fit in
// the 227 KB of shared memory a block may use.  So the kernel does not run
// the program as written but a plan of it, made once per program on the
// host (kernels/ifunc_vm.py, vm_plan):
// * registers are renamed onto as few physical tiles as the program's
//   live values need (a dead result takes none; an operand that dies at an
//   instruction leaves its tile to that instruction's result);
// * a value loaded by loadp or loade is never copied: every read of it is
//   served in place from the payload or from the shard's external table
//   (which all the shard's tiles share, so it stays in L2);
// * only registers read before any write are zeroed;
// * only the last store is kept, and a program that never stores writes
//   zeros.
// Operands are locations: 0..7 a physical tile, 8 the payload tile, 16 + j
// external j (clamped to the table as loade clamps it).
//
// Two variants of one interpreter, chosen from the plan:
// * ifunc_vm_smem_kernel: plans of at most three tiles keep them in shared
//   memory (3 x 64 KiB plus the product's staging, 208 KiB).  uvm_affine
//   needs one: its matmul reads the payload and W in place, and relu and
//   store work on the one tile, so a tile costs one read of its payload
//   and one write of its output in device memory;
// * ifunc_vm_global_kernel: larger plans keep their tiles in a global
//   scratch [n_tiles, n_phys, T, T] the wrapper allocates, zeroing only
//   what the plan marks.
// One block of 256 threads per payload tile, one launch for every tile of
// every shard.  Elementwise ops stride over the 16,384 elements with the
// same thread for the same element in every op, so they need no barrier
// between them; the product is fenced by barriers on both sides.
//
// The product: k-chunks of 16 of A (transposed, rows padded to keep
// 16-byte alignment) and B are staged in shared memory, the next chunk
// fetched into registers while the current one is computed; each thread
// keeps an 8 x 8 block of the result (rows 4ty.., 64 + 4ty.., columns
// 4tx.., 64 + 4tx..) in registers and reads its operands as float4s, FP32
// FMAs in ascending k.  The result is written only after the last read of
// A and B, so dst == a or dst == b is safe.
//
// Payload layout: tile t is tile t % tiles_per_slot of slot
// t / tiles_per_slot, which starts body_off words into a slot of
// slot_stride words.  A contiguous payload is one tile a slot at stride
// T*T; the mailbox sweeps pass the mailbox itself, whose bodies start at
// word 5 (or 5 + 2K) and are read with 4-byte loads where they lie.  Tile t
// reads the external table of shard t / tiles_per_shard.
//
// The mailbox sweeps (ring_sweep_*_kernel, agg_sweep_*_kernel) are the
// same two variants behind a gate (SweepGate below): one launch a sweep
// polls each tile's slot with the logic of mailbox_poll.cuh, runs the
// plan on READY bodies, writes +0.0 over every other output tile and
// clears consumed slots in place.  They replace, on the lanes, the
// standalone ring_poll / agg_ring_poll launch, this kernel's launch and
// PyTorch's mask and clear passes over the whole output and mailbox: a
// poll moves a few bytes a slot and cost a launch of its own, and the two
// whole-ring passes were half a sweep.
//
// Semantics (the reference oracle, src/repro/kernels/ref.py): halt is a
// no-op, not a stop; gelu is the tanh approximation; loade reads
// ext[min(a, n_ext - 1)]; store copies va to the output and leaves the
// registers alone (the last store wins); rsqrt is rsqrt(|x| + 1e-12);
// max and relu propagate NaN as numpy's maximum does; registers read
// before any write read as zeros.

#include <cstdint>
#include <cuda_runtime.h>

#include "mailbox_poll.cuh"

namespace {

constexpr int T = 128;
constexpr int TT = T * T;
constexpr int kThreads = 256;
constexpr int KC = 16;                       // k-chunk of the product
constexpr int LDA = T + 4;                   // A's staged rows, padded
constexpr int kStage = KC * LDA + KC * T;    // staging floats
constexpr int kSmemTiles = 3;                // tiles the smem variant holds
constexpr int PAYLOAD = 8, EXT0 = 16;        // operand locations

enum Op : int32_t {
  HALT = 0, LOADP = 1, LOADE = 2, STORE = 3, ADD = 4, SUB = 5, MUL = 6,
  FMA = 7, RELU = 8, GELU = 9, EXP = 10, SCALE = 11, MATMUL = 12, MAX = 13,
  COPY = 14, ZERO = 15, TANH = 16, RSQRT = 17, ADDI = 18, MULI = 19,
};

__device__ __forceinline__ float nan_max(float x, float y) {
  return (x != x || y != y) ? x + y : fmaxf(x, y);  // NaN in, NaN out
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

struct Tile {
  float* tiles;           // the plan's physical tiles (shared or global)
  const float* pt;        // this tile's payload
  const float* et;        // its shard's external table
  int n_ext;

  __device__ __forceinline__ const float* at(int loc) const {
    if (loc < PAYLOAD) return tiles + loc * TT;
    if (loc == PAYLOAD) return pt;
    return et + static_cast<int64_t>(min(loc - EXT0, n_ext - 1)) * TT;
  }
};

// D = A @ B for 128x128 tiles anywhere in memory; D may alias A or B.
__device__ __forceinline__ void tile_matmul(const float* A, const float* B,
                                            float* D, float* stage) {
  float* As = stage;                         // [KC][LDA]: A's chunk, k-major
  float* Bs = stage + KC * LDA;               // [KC][T]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  constexpr int PER = KC * T / kThreads;     // staged elements a thread
  float pa[PER], pb[PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + kThreads * i;
      pa[i] = A[(e / KC) * T + k0 + e % KC];   // row e / KC, k e % KC
      pb[i] = B[(k0 + e / T) * T + e % T];     // k e / T, column e % T
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  __syncthreads();                           // A and B are written
  fetch(0);
  for (int k0 = 0; k0 < T; k0 += KC) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + kThreads * i;
      As[(e % KC) * LDA + e / KC] = pa[i];
      Bs[e] = pb[i];
    }
    __syncthreads();
    if (k0 + KC < T) fetch(k0 + KC);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDA + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * LDA + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * T + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * T + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();   // the chunk is read; past the last, every read of A, B
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 4 * ty : 60 + 4 * ty) + i;
    *reinterpret_cast<float4*>(D + r * T + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(D + r * T + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();                           // D is whole for every thread
}

#define EW(expr)                                               \
  for (int e = threadIdx.x; e < TT; e += kThreads) { expr; }  \
  break

// The plan's instructions over one payload tile.  code is [5, n_instr]:
// opcode, dst (a tile), a, b, c (locations; c is fma's addend).
__device__ __forceinline__ void run(const int32_t* __restrict__ code,
                                    const float* __restrict__ imm,
                                    int n_instr, unsigned zero_mask,
                                    const Tile& v, float* __restrict__ o,
                                    float* stage) {
  for (int p = 0; p < 8; ++p)
    if (zero_mask >> p & 1u)
      for (int e = threadIdx.x; e < TT; e += kThreads) v.tiles[p * TT + e] = 0.f;
  bool stored = false;
  for (int pc = 0; pc < n_instr; ++pc) {
    const int op = code[pc];
    float* vd = v.tiles + code[n_instr + pc] * TT;
    const float* va = v.at(code[2 * n_instr + pc]);
    const float* vb = v.at(code[3 * n_instr + pc]);
    const float* vc = v.at(code[4 * n_instr + pc]);
    const float im = imm[pc];
    switch (op) {
      case STORE: stored = true; EW(o[e] = va[e]);
      case ADD: EW(vd[e] = va[e] + vb[e]);
      case SUB: EW(vd[e] = va[e] - vb[e]);
      case MUL: EW(vd[e] = va[e] * vb[e]);
      case FMA: EW(vd[e] = vc[e] + va[e] * vb[e]);
      case RELU: EW(vd[e] = nan_max(va[e], 0.0f));
      case GELU: EW(vd[e] = gelu_tanh(va[e]));
      case EXP: EW(vd[e] = expf(va[e]));
      case SCALE:
      case MULI: EW(vd[e] = va[e] * im);
      case MATMUL: tile_matmul(va, vb, vd, stage); break;
      case MAX: EW(vd[e] = nan_max(va[e], vb[e]));
      case COPY: EW(vd[e] = va[e]);
      case ZERO: EW(vd[e] = 0.0f);
      case TANH: EW(vd[e] = tanhf(va[e]));
      case RSQRT: EW(vd[e] = rsqrtf(fabsf(va[e]) + 1e-12f));
      case ADDI: EW(vd[e] = va[e] + im);
      default: break;  // the plan serves loads in place and drops halts
    }
  }
  if (!stored) {
    for (int e = threadIdx.x; e < TT; e += kThreads) o[e] = 0.0f;
  }
}

__device__ __forceinline__ Tile tile_of(float* tiles, const float* payload,
                                        int64_t slot_stride, int64_t body_off,
                                        int64_t tiles_per_slot,
                                        const float* ext, int n_ext,
                                        int64_t tiles_per_shard) {
  const int64_t t = blockIdx.x;
  return Tile{tiles,
              payload + (t / tiles_per_slot) * slot_stride + body_off +
                  (t % tiles_per_slot) * TT,
              ext + (t / tiles_per_shard) * static_cast<int64_t>(n_ext) * TT,
              n_ext};
}

// The gate policy of a launch: what a block does around the interpreter.
// NoGate runs every tile (ifunc_vm).  A sweep's gate polls the tile's
// slot first, runs the plan only on a READY slot (sub-record) and writes
// +0.0 over the output tile otherwise, then clears a READY or BAD slot in
// place.  Every thread of a block derives the same status from the same
// words, so the branch is uniform and run()'s barriers stay legal.
struct NoGate {
  __device__ __forceinline__ bool open() { return true; }
  __device__ __forceinline__ void close() {}
};

// A mailbox sweep (kAgg: aggregate containers of agg_k sub-records, each
// tiles_per_slot / agg_k tiles; else singleton frames).  One block per
// tile; tile t is tile t % tiles_per_slot of slot t / tiles_per_slot.
//
// The clear, for READY and BAD slots: each block zeroes its own body tile
// after its last read of it, except the word the poll reads as the
// trailer (a short frame's trailer may lie inside a body tile that another
// block polls).  The slot's last block to finish, found by an atomicAdd
// on the slot's counter after a __threadfence, zeroes every word outside
// the body tiles and that trailer word, then resets the counter: by then
// every block of the slot has read its header, descriptors and trailer.
// INFLIGHT and EMPTY slots are not written.
template <bool kAgg>
struct SweepGate {
  uint32_t* slots;          // the mailbox [n_slots, slot_words], in place
  int64_t slot_words, body_off, tiles_per_slot, agg_k;
  uint32_t bound;           // aggregate: the bound program hash (0: any)
  int32_t* status;          // [n_slots]
  int32_t* sub;             // aggregate: [n_slots, agg_k]
  int32_t* counters;        // [n_slots], zero between sweeps
  // set by open()
  int64_t slot, j, keep;    // keep: the trailer word the last block clears
  int32_t st;

  __device__ __forceinline__ uint32_t* base() const {
    return slots + slot * slot_words;
  }

  __device__ __forceinline__ bool open() {
    const int64_t t = blockIdx.x;
    slot = t / tiles_per_slot;
    j = t % tiles_per_slot;
    const uint32_t* s = base();
    if (!kAgg) {
      st = mailbox::frame_status(s, slot_words);
      keep = mailbox::trailer_index(s[1], slot_words);
      if (j == 0 && threadIdx.x == 0) status[slot] = st;
      return st == mailbox::kReady;
    }
    const int64_t per_sub = tiles_per_slot / agg_k, i = j / per_sub;
    keep = slot_words - 1;
    st = mailbox::container_status(s, s[keep], agg_k);
    const int32_t ss = mailbox::sub_status(
        st, s[1], i, s[mailbox::kHdrWords + 2 * i],
        s[mailbox::kHdrWords + 2 * i + 1], bound);
    if (threadIdx.x == 0) {
      if (j == 0) status[slot] = st;
      if (j % per_sub == 0) sub[slot * agg_k + i] = ss;
    }
    return ss == mailbox::kSubReady;
  }

  __device__ __forceinline__ void close() {
    if (st != mailbox::kReady && st != mailbox::kBad) return;
    uint32_t* s = base();
    const int64_t lo = body_off + j * TT;
    __syncthreads();                 // every read of the body tile is done
    for (int e = threadIdx.x; e < TT; e += kThreads)
      if (lo + e != keep) s[lo + e] = 0u;
    __threadfence();
    __syncthreads();
    const bool last = __syncthreads_or(
        threadIdx.x == 0 &&
        atomicAdd(counters + slot, 1) == static_cast<int>(tiles_per_slot) - 1);
    if (!last) return;
    __threadfence();                 // the other blocks' reads came first
    for (int64_t w = threadIdx.x; w < body_off; w += kThreads) s[w] = 0u;
    for (int64_t w = body_off + tiles_per_slot * TT + threadIdx.x;
         w < slot_words; w += kThreads)
      s[w] = 0u;
    if (threadIdx.x == 0) {
      s[keep] = 0u;
      counters[slot] = 0;
    }
  }
};

__device__ __forceinline__ void zero_tile(float* o) {
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int e = threadIdx.x; e < TT / 4; e += kThreads)
    o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One block: the gate, then the plan over its tile or a +0.0 tile.
template <class Gate>
__device__ __forceinline__ void gated(Gate& g, const int32_t* code,
                                      const float* imm, int n_instr,
                                      unsigned zero_mask, const Tile& v,
                                      float* out, float* stage) {
  float* o = out + int64_t{blockIdx.x} * TT;
  if (g.open())
    run(code, imm, n_instr, zero_mask, v, o, stage);
  else
    zero_tile(o);
  g.close();
}

template <class Gate>
__device__ __forceinline__ void smem_body(
    Gate& g, const int32_t* code, const float* imm, int n_instr,
    unsigned zero_mask, const float* payload, int64_t slot_stride,
    int64_t body_off, int64_t tiles_per_slot, const float* ext, int n_ext,
    int64_t tiles_per_shard, float* out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const Tile v = tile_of(stage + kStage, payload, slot_stride, body_off,
                         tiles_per_slot, ext, n_ext, tiles_per_shard);
  gated(g, code, imm, n_instr, zero_mask, v, out, stage);
}

template <class Gate>
__device__ __forceinline__ void global_body(
    Gate& g, const int32_t* code, const float* imm, int n_instr,
    unsigned zero_mask, const float* payload, int64_t slot_stride,
    int64_t body_off, int64_t tiles_per_slot, const float* ext, int n_ext,
    int64_t tiles_per_shard, float* scratch, int n_phys, float* out) {
  __shared__ __align__(16) float stage[kStage];
  const Tile v = tile_of(scratch + int64_t{blockIdx.x} * n_phys * TT,
                         payload, slot_stride, body_off, tiles_per_slot, ext,
                         n_ext, tiles_per_shard);
  gated(g, code, imm, n_instr, zero_mask, v, out, stage);
}

__global__ void __launch_bounds__(kThreads, 2)
ifunc_vm_smem_kernel(const int32_t* __restrict__ code,
                     const float* __restrict__ imm, int n_instr,
                     unsigned zero_mask, const float* __restrict__ payload,
                     int64_t slot_stride, int64_t body_off,
                     int64_t tiles_per_slot, const float* __restrict__ ext,
                     int n_ext, int64_t tiles_per_shard,
                     float* __restrict__ out) {
  NoGate g;
  smem_body(g, code, imm, n_instr, zero_mask, payload, slot_stride, body_off,
            tiles_per_slot, ext, n_ext, tiles_per_shard, out);
}

__global__ void __launch_bounds__(kThreads, 2)
ifunc_vm_global_kernel(const int32_t* __restrict__ code,
                       const float* __restrict__ imm, int n_instr,
                       unsigned zero_mask, const float* __restrict__ payload,
                       int64_t slot_stride, int64_t body_off,
                       int64_t tiles_per_slot, const float* __restrict__ ext,
                       int n_ext, int64_t tiles_per_shard, float* scratch,
                       int n_phys, float* __restrict__ out) {
  NoGate g;
  global_body(g, code, imm, n_instr, zero_mask, payload, slot_stride,
              body_off, tiles_per_slot, ext, n_ext, tiles_per_shard, scratch,
              n_phys, out);
}

// The sweeps: the mailbox is read and cleared through one pointer, so it
// is not __restrict__.
#define SWEEP_KERNELS(NAME, AGG)                                              \
  __global__ void __launch_bounds__(kThreads, 2) NAME##_smem_kernel(         \
      const int32_t* __restrict__ code, const float* __restrict__ imm,       \
      int n_instr, unsigned zero_mask, SweepGate<AGG> g,                     \
      const float* __restrict__ ext, int n_ext, int64_t tiles_per_shard,     \
      float* __restrict__ out) {                                             \
    smem_body(g, code, imm, n_instr, zero_mask,                              \
              reinterpret_cast<const float*>(g.slots), g.slot_words,         \
              g.body_off, g.tiles_per_slot, ext, n_ext, tiles_per_shard,     \
              out);                                                          \
  }                                                                          \
  __global__ void __launch_bounds__(kThreads, 2) NAME##_global_kernel(       \
      const int32_t* __restrict__ code, const float* __restrict__ imm,       \
      int n_instr, unsigned zero_mask, SweepGate<AGG> g,                     \
      const float* __restrict__ ext, int n_ext, int64_t tiles_per_shard,     \
      float* scratch, int n_phys, float* __restrict__ out) {                 \
    global_body(g, code, imm, n_instr, zero_mask,                            \
                reinterpret_cast<const float*>(g.slots), g.slot_words,       \
                g.body_off, g.tiles_per_slot, ext, n_ext, tiles_per_shard,   \
                scratch, n_phys, out);                                       \
  }

SWEEP_KERNELS(ring_sweep, false)
SWEEP_KERNELS(agg_sweep, true)
#undef SWEEP_KERNELS

}  // namespace

// in_smem: the plan's n_phys tiles in shared memory (n_phys <= 3), else in
// scratch [n_tiles, n_phys, T, T].  Returns a cudaError_t.
extern "C" int ifunc_vm_launch(const void* code, const void* imm, int n_instr,
                               int n_phys, unsigned zero_mask, int in_smem,
                               const void* payload, int64_t n_tiles,
                               int64_t slot_stride, int64_t body_off,
                               int64_t tiles_per_slot, const void* ext,
                               int n_ext, int64_t tiles_per_shard,
                               void* scratch, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_tiles > 0x7FFFFFFF || n_phys < 0 || n_phys > 8 || n_ext < 1 ||
      tiles_per_slot < 1 || tiles_per_shard < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto c = static_cast<const int32_t*>(code);
  const auto i = static_cast<const float*>(imm);
  const auto p = static_cast<const float*>(payload);
  const auto e = static_cast<const float*>(ext);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (in_smem) {
    if (n_phys > kSmemTiles) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        ifunc_vm_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kStage + kSmemTiles * TT) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = (kStage + n_phys * TT) * sizeof(float);
    ifunc_vm_smem_kernel<<<grid, kThreads, smem, st>>>(
        c, i, n_instr, zero_mask, p, slot_stride, body_off, tiles_per_slot, e,
        n_ext, tiles_per_shard, static_cast<float*>(out));
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ifunc_vm_global_kernel<<<grid, kThreads, 0, st>>>(
        c, i, n_instr, zero_mask, p, slot_stride, body_off, tiles_per_slot, e,
        n_ext, tiles_per_shard, static_cast<float*>(scratch), n_phys,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch a mailbox sweep: poll, execute or mask, and clear in place.
// slots is the mailbox [n_slots, slot_words]; each slot holds
// tiles_per_slot body tiles from word body_off on.  agg_k = 0: singleton
// frames; else containers of agg_k sub-records of tiles_per_slot / agg_k
// tiles each, against the bound hash (sub is then [n_slots, agg_k]).
// counters [n_slots] must be zero and are zero again after the launch.
// Returns a cudaError_t.
extern "C" int ifunc_vm_sweep_launch(
    const void* code, const void* imm, int n_instr, int n_phys,
    unsigned zero_mask, int in_smem, void* slots, int64_t n_slots,
    int64_t slot_words, int64_t body_off, int64_t tiles_per_slot,
    int64_t agg_k, uint32_t bound, const void* ext, int n_ext,
    int64_t tiles_per_shard, void* scratch, void* status, void* sub,
    void* counters, void* out, void* stream) {
  if (n_slots <= 0) return 0;
  const int64_t hdr = mailbox::kHdrWords + 2 * agg_k;
  if (tiles_per_slot < 1 || tiles_per_slot > 0x7FFFFFFF ||
      n_slots > 0x7FFFFFFF / tiles_per_slot || n_phys < 0 || n_phys > 8 ||
      n_ext < 1 || tiles_per_shard < 1 || agg_k < 0 ||
      (agg_k > 0 && (tiles_per_slot % agg_k || sub == nullptr)) ||
      body_off < hdr || body_off + tiles_per_slot * TT > slot_words ||
      counters == nullptr || (!in_smem && scratch == nullptr) ||
      (in_smem && n_phys > kSmemTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto c = static_cast<const int32_t*>(code);
  const auto i = static_cast<const float*>(imm);
  const auto e = static_cast<const float*>(ext);
  const auto o = static_cast<float*>(out);
  const auto sc = static_cast<float*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_slots * tiles_per_slot);
  const size_t smem = (kStage + n_phys * TT) * sizeof(float);
  const int smem_max = static_cast<int>((kStage + kSmemTiles * TT) * sizeof(float));
  auto go = [&](auto gate, auto smem_kernel, auto global_kernel) -> int {
    if (in_smem) {
      cudaError_t err = cudaFuncSetAttribute(
          smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_kernel<<<grid, kThreads, smem, st>>>(c, i, n_instr, zero_mask, gate,
                                                e, n_ext, tiles_per_shard, o);
    } else {
      global_kernel<<<grid, kThreads, 0, st>>>(c, i, n_instr, zero_mask, gate,
                                               e, n_ext, tiles_per_shard, sc,
                                               n_phys, o);
    }
    return static_cast<int>(cudaGetLastError());
  };
  const auto s = static_cast<uint32_t*>(slots);
  const auto stt = static_cast<int32_t*>(status);
  const auto sb = static_cast<int32_t*>(sub);
  const auto cnt = static_cast<int32_t*>(counters);
  if (agg_k > 0) {
    SweepGate<true> g{s, slot_words, body_off, tiles_per_slot, agg_k, bound,
                      stt, sb, cnt, 0, 0, 0, 0};
    return go(g, agg_sweep_smem_kernel, agg_sweep_global_kernel);
  }
  SweepGate<false> g{s, slot_words, body_off, tiles_per_slot, 1, 0u,
                     stt, sb, cnt, 0, 0, 0, 0};
  return go(g, ring_sweep_smem_kernel, ring_sweep_global_kernel);
}
