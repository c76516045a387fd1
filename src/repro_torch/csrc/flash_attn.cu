// flash_attn: causal flash attention, forward (O and the row log-sum-exp).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::_flash_fwd
// (_fwd_kernel), whose grid (BH, q blocks, k blocks) ran the k-block axis
// in order on one core and carried the online-softmax state (m, l, acc)
// in VMEM scratch from one grid step to the next.
//
// Bound on this card: operations.  At the model's largest shape (15 heads
// x 4,096 positions x head_dim 64, bf16) a call needs 3.2e10 FLOP and
// moves 31.5 MB (q, k, v read once, O written once): 0.033 ms at the
// tensor cores' 989 TFLOP/s against 0.0094 ms at 3.35 TB/s.  This first
// version computes in FP32 FMAs on the CUDA cores (67 TFLOP/s at most),
// so it cannot come near that bound; wgmma on bf16 tiles is the next
// step.  What the design does keep is the point of flash attention: the
// [S, S] score matrix never leaves the chip.
//
// Design: one block of 256 threads per (bh, tile of 64 query rows).  A
// loop over tiles of 64 keys takes the place of the sequential grid axis.
// Q, K and V tiles are held in shared memory as f32 (rows padded by one
// word, so column reads hit distinct banks); the 64 x 64 score tile and
// its probabilities too.  Thread (r, c) owns rows 4r..4r+3 and, of the
// score tile, columns c + 16j; of the output, columns c + 16d.  A row's
// max and sum are reduced over its 16 threads, which share a half-warp,
// by shuffles.  m, l and the output accumulator stay in registers.
// Tiles wholly above the diagonal or wholly outside the window are never
// visited (the reference visits them and corrects them away; outputs
// agree).  A masked score contributes exactly 0 and leaves the row max
// alone, so a row whose entries in a tile are all masked keeps l = 0
// there instead of the reference's transient exp(NEG - NEG) = 1, which a
// later tile rescales by exp(NEG - m) = 0: O and LSE agree.
//
// Inputs q, k, v [BH, S, hd] contiguous, f32 or bf16; O [BH, S, hd] in the
// same type; LSE [BH, S] f32.  hd is 64 or 128; any S >= 1.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr float kNeg = -1e30f;

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int64_t S, float scale,
                     int64_t window) {
  constexpr int LD = HD + 1;       // padded row of Q and K
  constexpr int LP = kBK + 1;      // padded row of the probability tile
  constexpr int ND = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;       // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][HD]
  float* Ps = Vs + kBK * HD;       // [kBQ][LP]

  const int tid = threadIdx.x;
  const int r = tid >> 4;          // rows 4r .. 4r+3
  const int c = tid & 15;          // column lane
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * HD;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    const int64_t qi = q0 + i;
    Qs[i * LD + d] = qi < S ? to_f32(q[base + qi * HD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNeg;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[ii][dd] = 0.f;
  }

  const int64_t q_last = (q0 + kBQ - 1 < S - 1) ? q0 + kBQ - 1 : S - 1;
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;
  const int64_t kt_end = q_last / kBK;

  for (int64_t kt = kt_begin; kt <= kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();               // the last tile's reads are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int64_t kj = k0 + j;
      const bool in = kj < S;
      Ks[j * LD + d] = in ? to_f32(k[base + kj * HD + d]) : 0.f;
      Vs[j * HD + d] = in ? to_f32(v[base + kj * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = Qs[(4 * r + ii) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(c + 16 * jj) * LD + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int64_t qi = q0 + 4 * r + ii;
      bool ok[4];
      float mt = kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t kj = k0 + c + 16 * jj;
        ok[jj] = kj < S && kj <= qi && (window == 0 || qi - kj < window);
        s[ii][jj] *= scale;
        if (ok[jj]) mt = fmaxf(mt, s[ii][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[ii], mt);
      const float corr = expf(m[ii] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[ii][jj] - m_new) : 0.f;
        Ps[(4 * r + ii) * LP + c + 16 * jj] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[ii] = l[ii] * corr + ps;
      m[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[ii][dd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = Ps[(4 * r + ii) * LP + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float vv = Vs[j * HD + c + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          acc[ii][dd] = fmaf(pv[ii], vv, acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t qi = q0 + 4 * r + ii;
    if (qi >= S) continue;
    const float lc = fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
      o[base + qi * HD + c + 16 * dd] = from_f32<T>(acc[ii][dd] / lc);
    if (c == 0) lse[static_cast<int64_t>(blockIdx.y) * S + qi] = m[ii] + logf(lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int64_t BH, int64_t S, float scale, int64_t window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int64_t BH, int64_t S,
                                int64_t hd, float scale, int64_t window,
                                int is_bf16, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, S, scale, window, st);
    if (hd == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, S, scale, window, st);
  } else {
    if (hd == 64) return launch<float, 64>(q, k, v, o, lse, BH, S, scale, window, st);
    if (hd == 128) return launch<float, 128>(q, k, v, o, lse, BH, S, scale, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
