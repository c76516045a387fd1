// flash_attn_bwd: causal flash attention, backward.  Two kernels, one for
// each pallas_call of the reference's backward:
//
//   flash_bwd_dq_*        replaces src/repro/kernels/flash_attn.py::_flash_bwd
//                         (_bwd_dq_kernel): dQ, k blocks innermost;
//   flash_bwd_dkv_*       replaces the same function's second call
//                         (_bwd_dkv_kernel): dK and dV, q blocks innermost.
//
// The reference's grids ran the innermost block axis in order on one core
// and carried dQ (or dK, dV) in VMEM scratch from one grid step to the
// next.  Here blocks run in parallel, so each block owns one tile of
// outputs and a loop over the other axis takes the place of the
// sequential grid axis.  The split into two kernels is kept because it
// lets every output element be written by exactly one block: no atomics,
// and the sums are taken in the same order on every run, so two launches
// on the same inputs give the same bits.
//
// Both recompute the probabilities from the forward's row log-sum-exp:
//   s = scale * q k^T,  p = exp(s - lse) where i >= j (and i - j < window),
//   dp = dO v^T,        ds = p * (dp - delta) * scale,  delta = rowsum(dO*O)
//   dQ = ds k,          dK = ds^T q,                    dV = p^T dO.
// delta comes from the wrapper (the reference too computes it outside any
// kernel).
//
// Bound on this card: operations.  At 15 heads x 4,096 positions x
// head_dim 64 (bf16, causal, the lower triangle only) dQ needs three
// products, 4.8e10 FLOP, and dK/dV four, 6.4e10: 0.049 and 0.065 ms at the
// tensor cores' 989 TFLOP/s, against 40 and 48 MB of traffic (each operand
// read once, each output written once: 0.012 and 0.014 ms at 3.35 TB/s).
//
// In bf16 both kernels are built on wgmma, the only way to the tensor
// cores, from the pieces in hopper.cuh: two warpgroups a block, operand
// tiles in the 128-byte swizzled layout that wgmma reads, filled by
// cp.async, and the tiles that stream through a ring of two stages loaded
// while the previous one is computed.  Probabilities are taken with ex2 in
// base 2 (scale log2 e folded into one multiply), and the mask by position
// is applied only to tiles that cross the diagonal, the window or S.
//
// dQ (flash_bwd_dq_wgmma_kernel): one block per (bh, tile of 128
// queries), each warpgroup owning 64 query rows; the last query tiles,
// which see the most keys, come first.  Q and dO stay in shared memory,
// each thread holds its two rows' LSE and delta, and K and V tiles of 64
// keys stream through the ring.  Per key tile and warpgroup, three
// products:
//   S  = Q K^T             wgmma SS, both K-major;
//   dP = dO V^T            wgmma SS, both K-major, in the same batch;
//   P  = exp2(S scale log2 e - lse log2 e), masked, in registers;
//   dS = P (dP - delta) scale, in registers;
//   dQ += dS K             dS as bf16 register A, K MN-major.
//
// dK/dV (flash_bwd_dkv_wgmma_kernel): the same with the roles of queries
// and keys swapped: one block per (bh, tile of 128 keys), the first keys,
// which the most query rows see, first.  K and V stay in shared memory;
// Q, dO, LSE and delta tiles of BQ queries (64 at head_dim 64, 32 at 128,
// so that the four accumulators fit the registers without spilling)
// stream through the ring.  Per query tile and warpgroup, four products:
//   S^T  = K Q^T            wgmma SS, both K-major;
//   dP^T = V dO^T           wgmma SS, both K-major, in the same batch;
//   P^T  = exp2(S^T scale log2 e - lse log2 e), masked, in registers;
//   dV  += P^T dO           P^T as bf16 register A, dO MN-major;
//   dS^T = P^T (dP^T - delta) scale, in registers;
//   dK  += dS^T Q           dS^T as bf16 register A, Q MN-major.
// The MN-major B operands (K, dO, Q read down their rows) go through the
// descriptor's transpose bit, which wgmma offers for 16-bit types only.
// dQ, dK and dV stay in f32 registers to the end and are written in bf16.
//
// In f32 both compute in FP32 FMAs on the CUDA cores (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel): 256 threads per block, tiles of 64 rows held in
// shared memory as f32 with rows padded by one word (column reads hit
// distinct banks).  Thread (r, c) = (tid / 16, tid % 16) computes rows
// 4r..4r+3 and columns c + 16j of each 64 x 64 product tile, and columns
// c + 16d of its output rows, which it keeps in registers until the end.
// wgmma's f32 route is TF32 (a 10-bit mantissa), which would break the f32
// path's agreement with the plain version, so f32 keeps this design.
//
// In all, tiles wholly above the diagonal or wholly outside the window are
// never visited; within a visited tile the mask is by position, so any
// S >= 1 works (the ragged last tile reads zeros and writes nothing past
// S), and a masked entry contributes exactly 0.
//
// Inputs q, k, v, dO [BH, S, hd] contiguous, f32 or bf16, all one type;
// lse and delta [BH, S] f32.  Outputs dQ, dK, dV [BH, S, hd] in the
// input type.  hd is 64 or 128; the bf16 kernels are templates on hd
// (see flash_attn.cu for what 96 and 256 need).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kB = 64, kThreads = 256;   // tile rows; threads a block

// rows row0 .. row0+63 of a [S, HD] f32 matrix into dst[64][HD + 1],
// zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t row0, int64_t S, int tid) {
  constexpr int LD = HD + 1;
  for (int e = tid; e < kB * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    const int64_t row = row0 + i;
    dst[i * LD + d] = row < S ? src[row * HD + d] : 0.f;
  }
}

// x = A1 B1^T and y = A2 B2^T on this thread's 4 x 4 entries, where every
// operand is a [64][HD + 1] tile: rows 4r + ii of A, rows c + 16 jj of B
template <int HD>
__device__ __forceinline__ void two_products(
    const float* A1, const float* B1, const float* A2, const float* B2,
    int r, int c, float (&x)[4][4], float (&y)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) x[ii][jj] = y[ii][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      a1[ii] = A1[(4 * r + ii) * LD + d];
      a2[ii] = A2[(4 * r + ii) * LD + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      b1[jj] = B1[(c + 16 * jj) * LD + d];
      b2[jj] = B2[(c + 16 * jj) * LD + d];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        x[ii][jj] = fmaf(a1[ii], b1[jj], x[ii][jj]);
        y[ii][jj] = fmaf(a2[ii], b2[jj], y[ii][jj]);
      }
  }
}

__device__ __forceinline__ bool allowed(int64_t qi, int64_t kj, int64_t S,
                                        int64_t window) {
  return qi < S && kj <= qi && (window == 0 || qi - kj < window);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (HD + 1) + kB * (kB + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kB * (HD + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// One block per (tile of 64 query rows, bh); the heaviest tiles (the last
// rows, which see the most keys) are handed out first.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int64_t S, float scale, int64_t window) {
  constexpr int LD = HD + 1, LP = kB + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                // [kB][LD]
  float* dOs = Qs + kB * LD;       // [kB][LD]
  float* Ks = dOs + kB * LD;       // [kB][LD]
  float* Vs = Ks + kB * LD;        // [kB][LD]
  float* dSs = Vs + kB * LD;       // [kB][LP]

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int64_t n_tiles = (S + kB - 1) / kB;
  const int64_t q0 = (n_tiles - 1 - blockIdx.x) * kB;
  const int64_t bh = blockIdx.y;
  const int64_t base = bh * S * HD;

  load_tile<HD>(Qs, q + base, q0, S, tid);
  load_tile<HD>(dOs, dout + base, q0, S, tid);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t qi = q0 + 4 * r + ii;
    lse_r[ii] = qi < S ? lse[bh * S + qi] : 0.f;
    delta_r[ii] = qi < S ? delta[bh * S + qi] : 0.f;
  }
  float acc[4][ND];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[ii][dd] = 0.f;

  const int64_t q_last = (q0 + kB - 1 < S - 1) ? q0 + kB - 1 : S - 1;
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kB;
  const int64_t kt_end = q_last / kB;

  for (int64_t kt = kt_begin; kt <= kt_end; ++kt) {
    const int64_t k0 = kt * kB;
    __syncthreads();               // the last tile's reads are done
    load_tile<HD>(Ks, k + base, k0, S, tid);
    load_tile<HD>(Vs, v + base, k0, S, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<HD>(Qs, Ks, dOs, Vs, r, c, s, dp);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int64_t qi = q0 + 4 * r + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t kj = k0 + c + 16 * jj;
        const float p = allowed(qi, kj, S, window)
                            ? expf(s[ii][jj] * scale - lse_r[ii]) : 0.f;
        dSs[(4 * r + ii) * LP + c + 16 * jj] =
            p * (dp[ii][jj] - delta_r[ii]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float ds[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) ds[ii] = dSs[(4 * r + ii) * LP + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float kv = Ks[j * LD + c + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[ii][dd] = fmaf(ds[ii], kv, acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t qi = q0 + 4 * r + ii;
    if (qi >= S) continue;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
      dq[base + qi * HD + c + 16 * dd] = acc[ii][dd];
  }
}

// One block per (tile of 64 keys, bh); the first keys, which the most
// query rows see, come first.  Rows of this block's product tiles are
// keys, columns queries.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int64_t S, float scale,
                         int64_t window) {
  constexpr int LD = HD + 1, LP = kB + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                // [kB][LD]
  float* Vs = Ks + kB * LD;        // [kB][LD]
  float* Qs = Vs + kB * LD;        // [kB][LD]
  float* dOs = Qs + kB * LD;       // [kB][LD]
  float* Ps = dOs + kB * LD;       // [kB keys][LP queries]
  float* dSs = Ps + kB * LP;       // [kB keys][LP queries]
  float* lse_s = dSs + kB * LP;    // [kB]
  float* delta_s = lse_s + kB;     // [kB]

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kB;
  const int64_t bh = blockIdx.y;
  const int64_t base = bh * S * HD;

  load_tile<HD>(Ks, k + base, k0, S, tid);
  load_tile<HD>(Vs, v + base, k0, S, tid);
  float acc_k[4][ND], acc_v[4][ND];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc_k[ii][dd] = acc_v[ii][dd] = 0.f;

  const int64_t k_last = (k0 + kB - 1 < S - 1) ? k0 + kB - 1 : S - 1;
  int64_t q_end = S - 1;
  if (window > 0 && k_last + window - 1 < q_end) q_end = k_last + window - 1;
  const int64_t qt_begin = k0 / kB, qt_end = q_end / kB;

  for (int64_t qt = qt_begin; qt <= qt_end; ++qt) {
    const int64_t q0 = qt * kB;
    __syncthreads();               // the last tile's reads are done
    load_tile<HD>(Qs, q + base, q0, S, tid);
    load_tile<HD>(dOs, dout + base, q0, S, tid);
    for (int e = tid; e < kB; e += kThreads) {
      const int64_t qi = q0 + e;
      lse_s[e] = qi < S ? lse[bh * S + qi] : 0.f;
      delta_s[e] = qi < S ? delta[bh * S + qi] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];       // [key 4r + ii][query c + 16 jj]
    two_products<HD>(Ks, Qs, Vs, dOs, r, c, s, dp);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int64_t kj = k0 + 4 * r + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ql = c + 16 * jj;
        const float p = allowed(q0 + ql, kj, S, window)
                            ? expf(s[ii][jj] * scale - lse_s[ql]) : 0.f;
        Ps[(4 * r + ii) * LP + ql] = p;
        dSs[(4 * r + ii) * LP + ql] = p * (dp[ii][jj] - delta_s[ql]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float pv[4], ds[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        pv[ii] = Ps[(4 * r + ii) * LP + j];
        ds[ii] = dSs[(4 * r + ii) * LP + j];
      }
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float dov = dOs[j * LD + c + 16 * dd];
        const float qv = Qs[j * LD + c + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          acc_v[ii][dd] = fmaf(pv[ii], dov, acc_v[ii][dd]);
          acc_k[ii][dd] = fmaf(ds[ii], qv, acc_k[ii][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t kj = k0 + 4 * r + ii;
    if (kj >= S) continue;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      dk[base + kj * HD + c + 16 * dd] = acc_k[ii][dd];
      dv[base + kj * HD + c + 16 * dd] = acc_v[ii][dd];
    }
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int64_t BH,
              int64_t S, float scale, int64_t window, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kB - 1) / kB),
                  static_cast<unsigned>(BH));
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), S, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int64_t BH, int64_t S, float scale, int64_t window,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kB - 1) / kB),
                  static_cast<unsigned>(BH));
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ dK/dV bf16: wgmma

using bf16 = __nv_bfloat16;

template <int HD>
struct Dkv {
  static constexpr int BK = 128;             // keys a block
  static constexpr int BQ = HD == 64 ? 64 : 32;   // queries a tile
  static constexpr int THREADS = 256;        // two warpgroups
  static constexpr int KV_BYTES = BK * HD * 2;    // K or V
  static constexpr int T_BYTES = BQ * HD * 2;     // Q or dO, one stage
  // Q, dO, then LSE and delta in 1 KiB, so that every stage is aligned
  static constexpr int STAGE = 2 * T_BYTES + 1024;
  static_assert(2 * BQ * 4 <= 1024, "LSE and delta fit their KiB");
  // K, V, then the ring's two stages; 1 KiB to align the base
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 2 * STAGE;
};

// Q, dO, LSE and delta of queries q0 .. q0 + BQ - 1 into one stage of the
// ring; rows past S read as zeros
template <int HD>
__device__ __forceinline__ void load_q_stage(
    uint32_t st, const bf16* q, const bf16* dout, const float* lse,
    const float* delta, int q0, int S, int tid) {
  using C = Dkv<HD>;
  using namespace hopper;
  hopper::load_tile<C::BQ, HD, C::THREADS>(st, q, q0, S, tid);
  hopper::load_tile<C::BQ, HD, C::THREADS>(st + C::T_BYTES, dout, q0, S, tid);
  if (tid < 2 * C::BQ) {
    const int i = tid % C::BQ, qi = q0 + i;
    const float* src = tid < C::BQ ? lse : delta;
    cp_async4(st + 2 * C::T_BYTES + (tid / C::BQ) * C::BQ * 4 + i * 4,
              src + (qi < S ? qi : 0), qi < S);
  }
}

template <int HD>
__global__ void __launch_bounds__(Dkv<HD>::THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int S, float scale, int window) {
  using C = Dkv<HD>;
  using namespace hopper;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::THREADS;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Vs = Ks + C::KV_BYTES;
  const uint32_t Q0 = Vs + C::KV_BYTES;      // stage s at Q0 + s * STAGE
  const uint8_t* ring = smem_raw + (Q0 - smem_u32(smem_raw));  // Q0, generic

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t bh = blockIdx.x;
  const int64_t base = bh * S * HD;
  const int k0 = static_cast<int>(blockIdx.y) * BK;
  const int k_last = min(k0 + BK - 1, S - 1);
  const int q_end = (window > 0 && k_last + window - 1 < S - 1)
                        ? k_last + window - 1 : S - 1;
  const int qt_begin = k0 / BQ, qt_end = q_end / BQ;

  hopper::load_tile<BK, HD, NT>(Ks, k + base, k0, S, tid);
  hopper::load_tile<BK, HD, NT>(Vs, v + base, k0, S, tid);
  load_q_stage<HD>(Q0, q + base, dout + base, lse + bh * S, delta + bh * S,
                   qt_begin * BQ, S, tid);
  cp_async_commit();

  const int wk0 = k0 + 64 * wg;              // this warpgroup's first key
  const int key = wk0 + 16 * warp + lane / 4;   // keys key and key + 8
  const int col = 2 * (lane % 4);            // queries 8j + col, + 1
  const float scale_log2 = scale * kLog2e;
  float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int qt = qt_begin; qt <= qt_end; ++qt) {
    const int stage = (qt - qt_begin) & 1;
    const uint32_t Qs = Q0 + stage * C::STAGE, dOs = Qs + C::T_BYTES;
    if (qt < qt_end) {                       // the next tile, other stage
      load_q_stage<HD>(Q0 + (stage ^ 1) * C::STAGE, q + base, dout + base,
                       lse + bh * S, delta + bh * S, (qt + 1) * BQ, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                         // this tile is in for all

    const int q0 = qt * BQ;
    // does the tile hold a query that sees a key of this warpgroup?
    if (wk0 < S && q0 + BQ - 1 >= wk0 &&
        (window == 0 || q0 - (wk0 + 63) < window)) {
      const float* lse_s = reinterpret_cast<const float*>(
          ring + stage * C::STAGE + 2 * C::T_BYTES);
      const float* delta_s = lse_s + BQ;
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // S^T = K Q^T
        const uint32_t panel = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BQ, 0>(
            st, desc_sw128(Ks + panel * BK * 128 + wg * 64 * 128 + off, 16,
                           1024),
            desc_sw128(Qs + panel * BQ * 128 + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // dP^T = V dO^T
        const uint32_t panel = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BQ, 0>(
            dpt, desc_sw128(Vs + panel * BK * 128 + wg * 64 * 128 + off, 16,
                            1024),
            desc_sw128(dOs + panel * BQ * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // every (key, query) of the tile allowed for this warpgroup?
      const bool whole = q0 >= wk0 + 63 && q0 + BQ <= S &&
                         (window == 0 || q0 + BQ - 1 - wk0 < window);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int kj = key + ((i & 2) ? 8 : 0);
        const int ql = 8 * (i / 4) + col + (i & 1);
        const int qi = q0 + ql;
        float p = ex2(st[i] * scale_log2 - lse_s[ql] * kLog2e);
        if (!whole && !(qi < S && kj <= qi && (window == 0 || qi - kj < window)))
          p = 0.f;                           // contributes exactly 0
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_s[ql]) * scale;
      }
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];   // bf16 register A
      acc_to_a<BQ>(st, pa);
      acc_to_a<BQ>(dpt, dsa);
      fence_regs(pa);
      fence_regs(dsa);
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)     // dV += P^T dO, dO MN-major
        wgmma_rs<HD, 1>(acc_dv, pa[kk],
                        desc_sw128(dOs + kk * 16 * 128, BQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)     // dK += dS^T Q, Q MN-major
        wgmma_rs<HD, 1>(acc_dk, dsa[kk],
                        desc_sw128(Qs + kk * 16 * 128, BQ * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    __syncthreads();                         // the stage is free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = key + 8 * h;
    if (kj >= S) continue;
    const int64_t at = base + static_cast<int64_t>(kj) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j + col) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * h],
                                acc_dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j + col) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * h],
                                acc_dv[4 * j + 2 * h + 1]);
    }
  }
}

template <int HD>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int64_t BH, int64_t S, float scale,
                    int64_t window, cudaStream_t stream) {
  using C = Dkv<HD>;
  const int64_t n_kt = (S + C::BK - 1) / C::BK;
  if (n_kt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // grid.x over heads, so that the heaviest key tiles of every head
  // (grid.y = 0: the first keys) are dispatched first
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_kt));
  flash_bwd_dkv_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<int>(S),
      scale, static_cast<int>(window >= S ? 0 : window));  // >= S: no mask
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- dQ bf16: wgmma

template <int HD>
struct Dq {
  static constexpr int BQ = 128;             // queries a block
  static constexpr int BK = 64;              // keys a tile
  static constexpr int THREADS = 256;        // two warpgroups
  static constexpr int Q_BYTES = BQ * HD * 2;     // Q or dO
  static constexpr int KV_BYTES = BK * HD * 2;    // K or V, one stage
  static constexpr int STAGE = 2 * KV_BYTES;
  // Q, dO, then the ring's two stages; 1 KiB to align the base
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * STAGE;
};

// K and V of keys k0 .. k0 + BK - 1 into one stage of the ring; rows past
// S read as zeros
template <int HD>
__device__ __forceinline__ void load_kv_stage(uint32_t st, const bf16* k,
                                              const bf16* v, int k0, int S,
                                              int tid) {
  using C = Dq<HD>;
  hopper::load_tile<C::BK, HD, C::THREADS>(st, k, k0, S, tid);
  hopper::load_tile<C::BK, HD, C::THREADS>(st + C::KV_BYTES, v, k0, S, tid);
}

template <int HD>
__global__ void __launch_bounds__(Dq<HD>::THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int S, float scale,
                              int window) {
  using C = Dq<HD>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::THREADS;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dOs = Qs + C::Q_BYTES;
  const uint32_t K0 = dOs + C::Q_BYTES;      // stage s at K0 + s * STAGE

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t bh = blockIdx.x;
  const int64_t base = bh * S * HD;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int kt_begin =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int kt_end = q_last / BK;

  hopper::load_tile<BQ, HD, NT>(Qs, q + base, q0, S, tid);
  hopper::load_tile<BQ, HD, NT>(dOs, dout + base, q0, S, tid);
  load_kv_stage<HD>(K0, k + base, v + base, kt_begin * BK, S, tid);
  cp_async_commit();

  const int wq0 = q0 + 64 * wg;              // this warpgroup's first query
  const int row = wq0 + 16 * warp + lane / 4;   // queries row and row + 8
  const int col = 2 * (lane % 4);            // keys 8j + col, + 1
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];                     // this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row + 8 * h;
    lse2[h] = qi < S ? lse[bh * S + qi] * kLog2e : 0.f;
    dlt[h] = qi < S ? delta[bh * S + qi] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    const uint32_t Ks = K0 + stage * C::STAGE, Vs = Ks + C::KV_BYTES;
    if (kt < kt_end) {                       // the next tile, other stage
      load_kv_stage<HD>(K0 + (stage ^ 1) * C::STAGE, k + base, v + base,
                        (kt + 1) * BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                         // this tile is in for all

    const int k0 = kt * BK;
    // does the tile hold a key that a query of this warpgroup sees?
    if (wq0 < S && k0 <= wq0 + 63 &&
        (window == 0 || wq0 - (k0 + BK - 1) < window)) {
      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // S = Q K^T
        const uint32_t panel = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK, 0>(
            s, desc_sw128(Qs + panel * BQ * 128 + wg * 64 * 128 + off, 16,
                          1024),
            desc_sw128(Ks + panel * BK * 128 + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // dP = dO V^T
        const uint32_t panel = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK, 0>(
            dp, desc_sw128(dOs + panel * BQ * 128 + wg * 64 * 128 + off, 16,
                           1024),
            desc_sw128(Vs + panel * BK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // every (query, key) of the tile allowed for this warpgroup?
      const bool whole = k0 + BK - 1 <= wq0 && wq0 + 63 < S &&
                         (window == 0 || wq0 + 63 - k0 < window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i & 2) ? 1 : 0;
        const int qi = row + 8 * h;
        const int kj = k0 + 8 * (i / 4) + col + (i & 1);
        float p = ex2(s[i] * scale_log2 - lse2[h]);
        if (!whole && !(qi < S && kj <= qi && (window == 0 || qi - kj < window)))
          p = 0.f;                           // contributes exactly 0
        dp[i] = p * (dp[i] - dlt[h]) * scale;   // dS
      }
      uint32_t dsa[BK / 16][4];              // dS as bf16 register A
      acc_to_a<BK>(dp, dsa);
      fence_regs(dsa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)     // dQ += dS K, K MN-major
        wgmma_rs<HD, 1>(acc, dsa[kk],
                        desc_sw128(Ks + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();                         // the stage is free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row + 8 * h;
    if (qi >= S) continue;
    const int64_t at = base + static_cast<int64_t>(qi) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int HD>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int64_t BH, int64_t S, float scale,
                   int64_t window, cudaStream_t stream) {
  using C = Dq<HD>;
  const int64_t n_qt = (S + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // grid.x over heads, so that the heaviest query tiles of every head
  // (grid.y = 0: the last queries) are dispatched first
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_qt));
  flash_bwd_dq_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<int>(S), scale,
      static_cast<int>(window >= S ? 0 : window));  // >= S: no mask
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int64_t BH, int64_t S,
                                   int64_t hd, float scale, int64_t window,
                                   int is_bf16, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (BH > 65535 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (S > (int64_t{1} << 30)) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 64)
      return launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                                window, st);
    if (hd == 128)
      return launch_dq_bf16<128>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                                 window, st);
  } else {
    if (hd == 64)
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                           window, st);
    if (hd == 128)
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                            window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int64_t BH, int64_t S,
                                    int64_t hd, float scale, int64_t window,
                                    int is_bf16, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (BH > 65535 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (S > (int64_t{1} << 30)) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 64)
      return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                 scale, window, st);
    if (hd == 128)
      return launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                  scale, window, st);
  } else {
    if (hd == 64)
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                            scale, window, st);
    if (hd == 128)
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                             scale, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
