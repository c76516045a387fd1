// flash_attn_bwd: causal flash attention, backward.  Two kernels, one for
// each pallas_call of the reference's backward:
//
//   flash_bwd_dq_kernel  replaces src/repro/kernels/flash_attn.py::_flash_bwd
//                        (_bwd_dq_kernel): dQ, k blocks innermost;
//   flash_bwd_dkv_kernel replaces the same function's second call
//                        (_bwd_dkv_kernel): dK and dV, q blocks innermost.
//
// The reference's grids ran the innermost block axis in order on one core
// and carried dQ (or dK, dV) in VMEM scratch from one grid step to the
// next.  Here blocks run in parallel, so each block owns one tile of
// outputs and a loop over the other axis takes the place of the
// sequential grid axis.  The split into two kernels is kept because it
// lets every output element be written by exactly one block: no atomics,
// and the sums are taken in the same order on every run.
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
// This first version computes in FP32 FMAs on the CUDA cores, as the
// forward kernel does, so it cannot come near that bound; wgmma on bf16
// tiles is the next step.  What the design keeps is the point of flash
// attention: no [S, S] matrix ever leaves the chip.
//
// Design, shared by both: 256 threads per block, tiles of 64 rows held in
// shared memory as f32 with rows padded by one word (column reads hit
// distinct banks).  Thread (r, c) = (tid / 16, tid % 16) computes rows
// 4r..4r+3 and columns c + 16j of each 64 x 64 product tile, and columns
// c + 16d of its output rows, which it keeps in registers until the end.
// Tiles wholly above the diagonal or wholly outside the window are never
// visited; within a visited tile the mask is by position, so any S >= 1
// works (the ragged last tile reads zeros and writes nothing past S).
//
// Inputs q, k, v, dO [BH, S, hd] contiguous, f32 or bf16, all one type;
// lse and delta [BH, S] f32.  Outputs dQ, dK, dV [BH, S, hd] in the
// input type.  hd is 64 or 128.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64, kThreads = 256;   // tile rows; threads a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// rows row0 .. row0+63 of a [S, HD] matrix into dst[64][HD + 1] as f32,
// zeros past S
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t S, int tid) {
  constexpr int LD = HD + 1;
  for (int e = tid; e < kB * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    const int64_t row = row0 + i;
    dst[i * LD + d] = row < S ? to_f32(src[row * HD + d]) : 0.f;
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
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

  load_tile<T, HD>(Qs, q + base, q0, S, tid);
  load_tile<T, HD>(dOs, dout + base, q0, S, tid);
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
    load_tile<T, HD>(Ks, k + base, k0, S, tid);
    load_tile<T, HD>(Vs, v + base, k0, S, tid);
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
      dq[base + qi * HD + c + 16 * dd] = from_f32<T>(acc[ii][dd]);
  }
}

// One block per (tile of 64 keys, bh); the first keys, which the most
// query rows see, come first.  Rows of this block's product tiles are
// keys, columns queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int64_t S, float scale,
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

  load_tile<T, HD>(Ks, k + base, k0, S, tid);
  load_tile<T, HD>(Vs, v + base, k0, S, tid);
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
    load_tile<T, HD>(Qs, q + base, q0, S, tid);
    load_tile<T, HD>(dOs, dout + base, q0, S, tid);
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
      dk[base + kj * HD + c + 16 * dd] = from_f32<T>(acc_k[ii][dd]);
      dv[base + kj * HD + c + 16 * dd] = from_f32<T>(acc_v[ii][dd]);
    }
  }
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int64_t BH,
              int64_t S, float scale, int64_t window, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kB - 1) / kB),
                  static_cast<unsigned>(BH));
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int64_t BH, int64_t S, float scale, int64_t window,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kB - 1) / kB),
                  static_cast<unsigned>(BH));
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, scale, window);
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
    if (hd == 64)
      return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, BH,
                                          S, scale, window, st);
    if (hd == 128)
      return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, BH,
                                           S, scale, window, st);
  } else {
    if (hd == 64)
      return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                                  window, st);
    if (hd == 128)
      return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, BH, S,
                                   scale, window, st);
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
    if (hd == 64)
      return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                           BH, S, scale, window, st);
    if (hd == 128)
      return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                            BH, S, scale, window, st);
  } else {
    if (hd == 64)
      return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                   scale, window, st);
    if (hd == 128)
      return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                    scale, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
