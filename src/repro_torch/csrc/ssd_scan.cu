// ssd_scan: the chunked Mamba-2 SSD forward, carrying an [hd, ds] f32
// state from chunk to chunk.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), whose grid (BH, chunks) ran the chunk axis in order and
// kept the state in VMEM scratch.  Per chunk, with cum = cumsum(la) and
// L[i][j] = exp(cum_i - cum_j) for j <= i, else 0:
//   y     = ((C B^T) o L) x + exp(cum) o (C state^T)
//   state = state * exp(cum_last) + (exp(cum_last - cum) o x)^T B
// Every y row reads the state as it was before the chunk's update.
//
// Bound on this card: at the model's largest shape (48 heads x 16 chunks
// of 256, hd 64, ds 128, all f32) a call reads x, la, B and C once and
// writes y once: 302 MB, 0.090 ms at 3.35 TB/s; its products need about
// 1.6e10 FLOP in f32 (the lower triangle of C B^T and of the score-x
// product, and the two state products), 0.24 ms at the 67 TFLOP/s of
// FP32 outside the tensor cores — so the operations bound it.  This
// first version reaches neither: it runs one block per (batch, head) row,
// 48 blocks on 132 SMs at batch 1, in FP32 FMAs.  Of the bytes, 201 MB
// are B and C broadcast to every head by the caller (the model's B and C
// are shared by all heads); reading them once per batch row is the first
// target of the kernel's next version.
//
// Design: one block of 256 threads per bh row, looping over its chunks in
// order, the state in shared memory.  A chunk's [Q, Q] decay-and-score
// matrix does not fit beside the state at Q = 256 (256 KiB), nor do its B
// and C (128 KiB each), so the block streams tiles of 32 query rows (C)
// and, for each, the tiles of 32 key rows (B, x) at or below the
// diagonal; cum is computed once per chunk.  The state update follows a
// barrier every y tile has passed, and streams the key tiles once more.
// Any Q >= 1 is taken; hd <= 64 and ds <= 128.
//
// Inputs x [BH, nc, Q, hd], la [BH, nc, Q], B, C [BH, nc, Q, ds], all f32
// contiguous; output y [BH, nc, Q, hd] f32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kTQ = 32, kTK = 32;
constexpr int kMaxHD = 64, kMaxDS = 128;
constexpr int kLS = kMaxDS + 1;   // padded row of the state, B and C tiles
constexpr int kLX = kMaxHD + 1;   // padded row of the x tile
constexpr int kLP = kTK + 1;      // padded row of the score tile
constexpr size_t kFixedSmem =
    sizeof(float) * (kMaxHD * kLS + kTQ * kLS + kTK * kLS + kTK * kLX + kTQ * kLP);

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ la,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ y, int64_t nc, int Q, int hd, int ds) {
  extern __shared__ float smem[];
  float* St = smem;                // [kMaxHD][kLS]  state[p][n]
  float* Cs = St + kMaxHD * kLS;   // [kTQ][kLS]
  float* Bs = Cs + kTQ * kLS;      // [kTK][kLS]
  float* Xs = Bs + kTK * kLS;      // [kTK][kLX]
  float* Ss = Xs + kTK * kLX;      // [kTQ][kLP]
  float* cum = Ss + kTQ * kLP;     // [Q]

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  for (int e = tid; e < kMaxHD * kLS; e += kThreads) St[e] = 0.f;

  // y / score mapping: row i = tid / 8; columns tid % 8 + 8 k
  const int yi = tid >> 3, yc = tid & 7;
  // state mapping: p = tid / 4; n = tid % 4 + 4 k
  const int sp = tid >> 2, sc = tid & 3;

  for (int64_t ch = 0; ch < nc; ++ch) {
    const int64_t row0 = (bh * nc + ch) * Q;      // first row of the chunk
    const float* xc = x + row0 * hd;
    const float* bc = Bm + row0 * ds;
    const float* cc = Cm + row0 * ds;
    float* yc_out = y + row0 * hd;

    __syncthreads();               // the last chunk's reads of cum are done
    for (int e = tid; e < Q; e += kThreads) cum[e] = la[row0 + e];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int e = 0; e < Q; ++e) {
        run += cum[e];
        cum[e] = run;
      }
    }
    __syncthreads();

    // ---- y, tile by tile of query rows, against the state before update
    for (int i0 = 0; i0 < Q; i0 += kTQ) {
      __syncthreads();             // Cs, Bs, Xs, Ss free
      for (int e = tid; e < kTQ * ds; e += kThreads) {
        const int i = e / ds, n = e % ds;
        Cs[i * kLS + n] = i0 + i < Q ? cc[(int64_t)(i0 + i) * ds + n] : 0.f;
      }
      __syncthreads();

      const int ig = i0 + yi;
      float acc[kMaxHD / 8];
      // inter-chunk: exp(cum_i) * sum_n C[i][n] state[p][n]
#pragma unroll
      for (int k = 0; k < kMaxHD / 8; ++k) {
        const int p = yc + 8 * k;
        float a = 0.f;
        if (p < hd)
          for (int n = 0; n < ds; ++n)
            a = fmaf(Cs[yi * kLS + n], St[p * kLS + n], a);
        acc[k] = a;
      }
      const float ei = ig < Q ? expf(cum[ig]) : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxHD / 8; ++k) acc[k] *= ei;

      // intra-chunk: key tiles at or below the diagonal
      const int i_last = (i0 + kTQ < Q ? i0 + kTQ : Q) - 1;
      for (int j0 = 0; j0 <= i_last; j0 += kTK) {
        __syncthreads();           // Bs, Xs, Ss free
        for (int e = tid; e < kTK * ds; e += kThreads) {
          const int j = e / ds, n = e % ds;
          Bs[j * kLS + n] = j0 + j < Q ? bc[(int64_t)(j0 + j) * ds + n] : 0.f;
        }
        for (int e = tid; e < kTK * hd; e += kThreads) {
          const int j = e / hd, p = e % hd;
          Xs[j * kLX + p] = j0 + j < Q ? xc[(int64_t)(j0 + j) * hd + p] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTK / 8; ++k) {
          const int j = yc + 8 * k, jg = j0 + j;
          float s = 0.f;
          for (int n = 0; n < ds; ++n)
            s = fmaf(Cs[yi * kLS + n], Bs[j * kLS + n], s);
          const bool lower = ig < Q && jg < Q && jg <= ig;
          Ss[yi * kLP + j] = lower ? s * expf(cum[ig] - cum[jg]) : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < kTK; ++j) {
          const float sv = Ss[yi * kLP + j];
#pragma unroll
          for (int k = 0; k < kMaxHD / 8; ++k)
            acc[k] = fmaf(sv, Xs[j * kLX + yc + 8 * k], acc[k]);
        }
      }
      if (ig < Q) {
#pragma unroll
        for (int k = 0; k < kMaxHD / 8; ++k) {
          const int p = yc + 8 * k;
          if (p < hd) yc_out[(int64_t)ig * hd + p] = acc[k];
        }
      }
    }

    // ---- state update, after every y tile has read the old state
    const float last = cum[Q - 1];
    float up[kMaxDS / 4];
#pragma unroll
    for (int k = 0; k < kMaxDS / 4; ++k) up[k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kTK) {
      __syncthreads();             // Bs, Xs free; every y tile done
      for (int e = tid; e < kTK * ds; e += kThreads) {
        const int j = e / ds, n = e % ds;
        Bs[j * kLS + n] = j0 + j < Q ? bc[(int64_t)(j0 + j) * ds + n] : 0.f;
      }
      for (int e = tid; e < kTK * hd; e += kThreads) {
        const int j = e / hd, p = e % hd;
        const int jg = j0 + j;
        Xs[j * kLX + p] =
            jg < Q ? expf(last - cum[jg]) * xc[(int64_t)jg * hd + p] : 0.f;
      }
      __syncthreads();
      if (sp < hd) {
        for (int j = 0; j < kTK; ++j) {
          const float xv = Xs[j * kLX + sp];
#pragma unroll
          for (int k = 0; k < kMaxDS / 4; ++k)
            up[k] = fmaf(xv, Bs[j * kLS + sc + 4 * k], up[k]);
        }
      }
    }
    const float decay = expf(last);
    if (sp < hd) {
#pragma unroll
      for (int k = 0; k < kMaxDS / 4; ++k) {
        const int n = sc + 4 * k;
        if (n < ds) St[sp * kLS + n] = St[sp * kLS + n] * decay + up[k];
      }
    }
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* la, const void* Bm,
                               const void* Cm, void* y, int64_t BH, int64_t nc,
                               int64_t Q, int64_t hd, int64_t ds,
                               void* stream) {
  if (BH <= 0 || nc <= 0 || Q <= 0) return 0;
  if (hd <= 0 || hd > kMaxHD || ds <= 0 || ds > kMaxDS || BH > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kFixedSmem + sizeof(float) * static_cast<size_t>(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<static_cast<unsigned>(BH), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(la),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), nc, static_cast<int>(Q), static_cast<int>(hd),
      static_cast<int>(ds));
  return static_cast<int>(cudaGetLastError());
}
