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
// Design, kept simple in this first version:
// * One thread block (256 threads) per payload tile, one launch for every
//   tile of every shard.  Tile t reads the external table (the device GOT)
//   of shard t / tiles_per_shard.
// * The register file (8 x 64 KiB per tile) does not fit in the 227 KB of
//   shared memory a block may use, so it lives in a global scratch
//   [n_tiles, 8, 128, 128] the wrapper allocates; the block zeroes its
//   slice first, as _vm_kernel zeroes its VMEM scratch.  The output tile is
//   zero-filled too: a program that never stores yields zeros, as the
//   reference oracle does.
// * The block walks the instruction stream.  Elementwise ops stride over
//   the 16,384 elements (coalesced); a barrier follows every instruction,
//   since the next one may be a matmul that reads every element.
// * matmul is written out here: k-chunks of 32 of A and B staged in shared
//   memory (A padded against bank conflicts), an 8x8 accumulator block per
//   thread in registers, FP32 FMAs in ascending k.  The result is written
//   only after the last chunk's barrier, so dst == a or dst == b is safe.
//
// Known costs, left to the next version: the register file at 1,024 tiles
// (512 MiB) does not stay in the 50 MB L2; the FP32 product uses no tensor
// core and no double buffering; and the caller copies the mailbox bodies
// (which start at word 5, so they are not 16-byte aligned) into a
// contiguous payload before the launch.
//
// Semantics (the reference oracle, src/repro/kernels/ref.py): halt is a
// no-op, not a stop; gelu is the tanh approximation; loade reads
// ext[min(a, n_ext - 1)]; store copies va to the output and leaves the
// registers alone (the last store wins); rsqrt is rsqrt(|x| + 1e-12);
// max and relu propagate NaN as numpy's maximum does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 128;
constexpr int TT = T * T;
constexpr int R = 8;
constexpr int kThreads = 256;
constexpr int KC = 32;  // k-chunk of the matmul

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

// D = A @ B for 128x128 tiles; A or B may alias D.
__device__ __forceinline__ void tile_matmul(const float* A, const float* B, float* D,
                            float (*As)[KC + 1], float (*Bs)[T]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < T; k0 += KC) {
    for (int e = tid; e < T * KC; e += kThreads) {
      const int r = e / KC, c = e % KC;
      As[r][c] = A[r * T + k0 + c];
      const int kr = e / T, kc = e % T;
      Bs[kr][kc] = B[(k0 + kr) * T + kc];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every read of A and B is done past this point
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) D[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}

#define EW(expr)                                               \
  for (int e = threadIdx.x; e < TT; e += kThreads) { expr; }  \
  break

__global__ void __launch_bounds__(kThreads)
ifunc_vm_kernel(const int32_t* __restrict__ code,  // [4, P]: op, dst, a, b
                const float* __restrict__ imm,     // [P]
                int n_instr,
                const float* __restrict__ payload,  // [n_tiles, T, T]
                const float* __restrict__ ext,      // [n_shards, n_ext, T, T]
                int n_ext, int64_t tiles_per_shard,
                float* regs,                        // [n_tiles, R, T, T]
                float* __restrict__ out) {          // [n_tiles, T, T]
  __shared__ float As[T][KC + 1];
  __shared__ float Bs[KC][T];
  const int64_t t = blockIdx.x;
  float* rf = regs + t * R * TT;
  float* o = out + t * TT;
  const float* pt = payload + t * TT;
  const float* et = ext + (t / tiles_per_shard) * static_cast<int64_t>(n_ext) * TT;
  for (int e = threadIdx.x; e < R * TT; e += kThreads) rf[e] = 0.0f;
  for (int e = threadIdx.x; e < TT; e += kThreads) o[e] = 0.0f;
  __syncthreads();
  for (int pc = 0; pc < n_instr; ++pc) {
    const int op = code[pc];
    const int d = code[n_instr + pc];
    const int a = code[2 * n_instr + pc];
    const int b = code[3 * n_instr + pc];
    const float im = imm[pc];
    float* vd = rf + d * TT;
    const float* va = rf + a * TT;
    const float* vb = rf + b * TT;
    switch (op) {
      case LOADP: EW(vd[e] = pt[e]);
      case LOADE: {
        const float* ev = et + static_cast<int64_t>(min(a, n_ext - 1)) * TT;
        EW(vd[e] = ev[e]);
      }
      case STORE: EW(o[e] = va[e]);
      case ADD: EW(vd[e] = va[e] + vb[e]);
      case SUB: EW(vd[e] = va[e] - vb[e]);
      case MUL: EW(vd[e] = va[e] * vb[e]);
      case FMA: EW(vd[e] = vd[e] + va[e] * vb[e]);
      case RELU: EW(vd[e] = nan_max(va[e], 0.0f));
      case GELU: EW(vd[e] = gelu_tanh(va[e]));
      case EXP: EW(vd[e] = expf(va[e]));
      case SCALE:
      case MULI: EW(vd[e] = va[e] * im);
      case MATMUL: tile_matmul(va, vb, vd, As, Bs); break;
      case MAX: EW(vd[e] = nan_max(va[e], vb[e]));
      case COPY: EW(vd[e] = va[e]);
      case ZERO: EW(vd[e] = 0.0f);
      case TANH: EW(vd[e] = tanhf(va[e]));
      case RSQRT: EW(vd[e] = rsqrtf(fabsf(va[e]) + 1e-12f));
      case ADDI: EW(vd[e] = va[e] + im);
      default: break;  // HALT: a no-op
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ifunc_vm_launch(const void* code, const void* imm, int n_instr,
                               const void* payload, int64_t n_tiles,
                               const void* ext, int n_ext,
                               int64_t tiles_per_shard, void* regs, void* out,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  ifunc_vm_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(code), static_cast<const float*>(imm),
      n_instr, static_cast<const float*>(payload),
      static_cast<const float*>(ext), n_ext, tiles_per_shard,
      static_cast<float*>(regs), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
