// ssd_scan: the chunked Mamba-2 SSD forward, every chunk of every row in
// parallel, the [hd, ds] state recurrence in a pass of its own.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), whose grid (BH, chunks) ran the chunk axis in order and
// kept the state in VMEM scratch.  Per chunk, with cum = cumsum(la) and
// L[i][j] = exp(cum_i - cum_j) for j <= i, else 0:
//   y     = ((C B^T) o L) x + exp(cum) o (C h_prev^T)
//   h_new = h_prev * exp(cum_last) + (exp(cum_last - cum) o x)^T B
// Only h_prev depends on earlier chunks; everything else is the chunk's
// own.  B and C belong to a group of heads (Mamba-2's n_groups): row bh
// reads group bh / (BH / G), so C B^T is computed once per group.
//
// Four launches on the caller's stream:
// 1. ssd_chunk_state_kernel, a block of 256 per (bh, chunk), two an SM:
//    cum by warp scans (written out for the others), then the chunk's own
//    state S_c = (exp(cum_last - cum) o x)^T B, stored [ds][hd], k-chunks
//    of 16 keys staged while the last is multiplied, 8 x 4 outputs a
//    thread;
// 2. ssd_state_pass_kernel, per (bh, 1,024 state elements): chunks in
//    order, h_prev[c] = h and h = h * exp(cum_last[c]) + S_c, in place
//    over the states buffer (4 elements a thread, no products);
// 3. ssd_bmm_kernel, a block of 128 per (group, chunk, 64 x 64 tile of the
//    lower triangle): C B^T into an f32 scratch [G, nc, Q, Q];
// 4. ssd_chunk_scan_kernel, a block of 128 per (bh, chunk, 64 query rows):
//    y = exp(cum) o (C h_prev^T) + ((C B^T) o L) x over the key chunks at
//    or below the diagonal, exp(cum_i - cum_j) once per score as the
//    score is staged, 4 x 8 outputs a thread; a warp skips the key chunks
//    that lie wholly above its rows.
// Every product is FP32 FMAs on the CUDA cores, register-tiled: operands
// staged in shared memory (k-major, padded rows), read as float4s, the
// next k-chunk fetched into registers while this one is multiplied.  The
// reference's tolerance (3e-4) rules out single-pass TF32.  Each output
// has one writer and a fixed order of sums, so a run repeats bit for bit,
// and G = 1 gives what G = BH gives on the broadcast inputs.
//
// Bound on this card (NVIDIA H100 SXM, 700 W: 67 TFLOP/s FP32 outside the
// tensor cores, 3.35 TB/s): at the Mamba-2 780M prefill of 4,096 tokens
// (48 heads x 16 chunks of 256, hd 64, ds 128, G = 1) the products need
// 9.81e9 FLOP (C B^T once per group, the score-x product's lower
// triangle, the two state products) -> 0.146 ms; x, la, B, C and y are
// 106 MB -> 0.032 ms, so the operations bound it.  With B and C per row
// (G = 48) C B^T alone is 6.47e9 FLOP and the bound 0.241 ms.  On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 11) the four
// kernels take 0.38 ms at G = 1 (26 TFLOP/s, 0.39 of the bound; the
// chunk scan 0.25 ms of it in phase 13's traced prefill) and 0.67 ms at
// G = 48, where one block per row walking its chunks in order took
// 7.87 ms in the same run.
//
// Any Q >= 1 up to 16,384 (ragged tiles masked), hd <= 64, ds <= 128.
// Inputs x [BH, nc, Q, hd], la [BH, nc, Q], B, C [G, nc, Q, ds], all f32
// contiguous; output y [BH, nc, Q, hd] f32; scratch the wrapper allocates:
// cum [BH, nc, Q], states [BH, nc, ds, hd], cb [G, nc, Q, Q].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHD = 64, kMaxDS = 128, kMaxQ = 16384;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------- 1. chunk state
constexpr int kStThreads = 256, kStKC = 16;
constexpr int kStXPer = kStKC * kMaxHD / kStThreads;   // staged x a thread
constexpr int kStBPer = kStKC * kMaxDS / kStThreads;   // staged B a thread
constexpr int kStWarps = kStThreads / 32;
constexpr size_t kStFixedSmem =
    sizeof(float) * (kStKC * kMaxHD + kStKC * kMaxDS + kStWarps);

// Inclusive cumsum of la[0 .. Q) into cum (shared), by all kStThreads
// threads: a warp scan of each 256-element round, the warps' totals
// scanned by warp 0, a carry across rounds.  Ends in a barrier.
__device__ __forceinline__ void block_cumsum(const float* __restrict__ la,
                                             float* cum, float* wsum, int Q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kStThreads) {
    const int i = base + tid;
    float v = i < Q ? la[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kStWarps ? wsum[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < kStWarps; o <<= 1) {
        const float t = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += t;
      }
      if (lane < kStWarps) wsum[lane] = w;
    }
    __syncthreads();
    if (i < Q) cum[i] = v + carry + (warp ? wsum[warp - 1] : 0.f);
    carry += wsum[kStWarps - 1];
    __syncthreads();               // wsum is free for the next round
  }
}

__global__ void __launch_bounds__(kStThreads, 2)
    ssd_chunk_state_kernel(const float* __restrict__ x,
                           const float* __restrict__ la,
                           const float* __restrict__ Bm,
                           float* __restrict__ cum_out,
                           float* __restrict__ states, int64_t nc,
                           int64_t rows_per_group, int Q, int hd, int ds) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);   // [kStKC][kMaxHD] w o x
  float* Bs = Xs + kStKC * kMaxHD;               // [kStKC][kMaxDS]
  float* wsum = Bs + kStKC * kMaxDS;             // [kStWarps]
  float* w = wsum + kStWarps;                    // [Q]: cum, then the tail

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;                // bh * nc + c
  const int64_t grow = (row / nc / rows_per_group) * nc + row % nc;
  const float* xc = x + row * Q * hd;
  const float* bc = Bm + grow * Q * ds;

  block_cumsum(la + row * Q, w, wsum, Q);
  const float last = w[Q - 1];
  __syncthreads();                 // every thread has read last
  for (int j = tid; j < Q; j += kStThreads) {
    const float cj = w[j];
    cum_out[row * Q + j] = cj;
    w[j] = expf(last - cj);
  }
  __syncthreads();

  // outputs S^T[n][p]: n in {4a .. 4a+3, 64+4a ..}, p in 4b .. 4b+3
  const int a = tid >> 4, b = tid & 15;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float px[kStXPer], pb[kStBPer];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int r = 0; r < kStXPer; ++r) {
      const int e = tid + kStThreads * r;
      const int j = j0 + e / kMaxHD, p = e % kMaxHD;
      px[r] = j < Q && p < hd ? xc[j * hd + p] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kStBPer; ++r) {
      const int e = tid + kStThreads * r;
      const int j = j0 + e / kMaxDS, n = e % kMaxDS;
      pb[r] = j < Q && n < ds ? bc[j * ds + n] : 0.f;
    }
  };
  fetch(0);
  for (int j0 = 0; j0 < Q; j0 += kStKC) {
#pragma unroll
    for (int r = 0; r < kStXPer; ++r) {
      const int e = tid + kStThreads * r;
      const int j = j0 + e / kMaxHD;
      Xs[e] = j < Q ? px[r] * w[j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kStBPer; ++r) Bs[tid + kStThreads * r] = pb[r];
    __syncthreads();
    if (j0 + kStKC < Q) fetch(j0 + kStKC);
#pragma unroll 8
    for (int k = 0; k < kStKC; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kMaxDS + 4 * a);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * kMaxDS + 64 + 4 * a);
      const float4 xv = *reinterpret_cast<const float4*>(Xs + k * kMaxHD + 4 * b);
      const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bn[i], xp[j], acc[i][j]);
    }
    __syncthreads();               // Xs, Bs are read
  }
  float* st = states + row * ds * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = (i < 4 ? 4 * a : 60 + 4 * a) + i;
    if (n >= ds || 4 * b >= hd) continue;
    if (hd % 4 == 0) {
      *reinterpret_cast<float4*>(st + n * hd + 4 * b) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * b + j < hd) st[n * hd + 4 * b + j] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------- 2. state pass
constexpr int kPassThreads = 256, kPassPer = 4;
constexpr int kPassSpan = kPassThreads * kPassPer;   // elements a block

__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(float* __restrict__ states,
                          const float* __restrict__ cum, int64_t nc, int Q,
                          int E) {
  const int64_t bh = blockIdx.x;
  const int e0 = blockIdx.y * kPassSpan + threadIdx.x;
  float* st = states + bh * nc * E;
  const float* last = cum + bh * nc * Q + (Q - 1);   // chunk c at c * Q
  float h[kPassPer], s[kPassPer];
#pragma unroll
  for (int r = 0; r < kPassPer; ++r) {
    const int e = e0 + kPassThreads * r;
    h[r] = 0.f;
    s[r] = e < E ? st[e] : 0.f;
  }
  float d = expf(last[0]);
  for (int64_t c = 0; c < nc; ++c) {
    float sn[kPassPer], dn = 0.f;
    const bool more = c + 1 < nc;
#pragma unroll
    for (int r = 0; r < kPassPer; ++r) {
      const int e = e0 + kPassThreads * r;
      sn[r] = more && e < E ? st[(c + 1) * E + e] : 0.f;
    }
    if (more) dn = last[(c + 1) * Q];
#pragma unroll
    for (int r = 0; r < kPassPer; ++r) {
      const int e = e0 + kPassThreads * r;
      if (e < E) st[c * E + e] = h[r];           // the state before chunk c
      h[r] = h[r] * d + s[r];
      s[r] = sn[r];
    }
    d = expf(dn);
  }
}

// ------------------------------------- shared by the two tiled products
// A 64 x 64 output tile over 128 threads, each rows 4ty .. 4ty + 3 by
// columns 4tx + j and 32 + 4tx + j; k-chunks of kKC staged in shared
// memory.
constexpr int kTile = 64, kTThreads = 128, kKC = 16, kLD = kTile + 4;
constexpr int kTPer = kKC * kTile / kTThreads;       // staged values a thread
constexpr int kARows = kTThreads / kKC;              // A rows staged a pass
constexpr int kBRows = kTThreads / kTile;            // B rows staged a pass

// acc[i][j] += sum_k As[k][4ty + i] * Bs[k][4tx + j (+ 28 for j >= 4)]
__device__ __forceinline__ void tile_fma(float (&acc)[4][8], const float* As,
                                         const float* Bs, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kKC; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(As + k * kLD + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLD + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * kLD + 32 + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// Rows r0 + 4ty + i, columns c0 + 4tx + j (+ 28 for j >= 4) of acc into
// out[rows][ld], inside n_rows x n_cols.
__device__ __forceinline__ void tile_store(const float (&acc)[4][8],
                                           float* out, int64_t ld, int r0,
                                           int c0, int n_rows, int n_cols,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 32 * h + 4 * tx;
      float* o = out + r * ld + col;
      if (ld % 4 == 0 && col + 3 < n_cols) {
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n_cols) o[j] = acc[i][4 * h + j];
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// ------------------------------------------------------------- 3. C B^T
__global__ void __launch_bounds__(kTThreads)
    ssd_bmm_kernel(const float* __restrict__ Cm, const float* __restrict__ Bm,
                   float* __restrict__ cb, int Q, int ds) {
  __shared__ __align__(16) float Cs[kKC * kLD];   // [n][i]
  __shared__ __align__(16) float Bs[kKC * kLD];   // [n][j]
  const int64_t gc = blockIdx.x;                  // g * nc + c
  const int t = blockIdx.y;                       // lower-triangle tile
  int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int i0 = ti * kTile, j0 = (t - ti * (ti + 1) / 2) * kTile;
  const float* cc = Cm + gc * Q * ds;
  const float* bc = Bm + gc * Q * ds;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int k = tid % kKC, r0 = tid / kKC;        // staged (r0 + kARows r, k)
  float pc[kTPer], pb[kTPer];
  auto fetch = [&](int n0) {
    const bool kin = n0 + k < ds;
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      const int i = i0 + r0 + kARows * r, j = j0 + r0 + kARows * r;
      pc[r] = kin && i < Q ? cc[i * ds + n0 + k] : 0.f;
      pb[r] = kin && j < Q ? bc[j * ds + n0 + k] : 0.f;
    }
  };
  float acc[4][8];
  zero(acc);
  fetch(0);
  for (int n0 = 0; n0 < ds; n0 += kKC) {
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      Cs[k * kLD + r0 + kARows * r] = pc[r];
      Bs[k * kLD + r0 + kARows * r] = pb[r];
    }
    __syncthreads();
    if (n0 + kKC < ds) fetch(n0 + kKC);
    tile_fma(acc, Cs, Bs, ty, tx);
    __syncthreads();
  }
  tile_store(acc, cb + gc * Q * Q, Q, i0, j0, Q, Q, ty, tx);
}

// ---------------------------------------------------------- 4. chunk scan
__global__ void __launch_bounds__(kTThreads)
    ssd_chunk_scan_kernel(const float* __restrict__ x,
                          const float* __restrict__ Cm,
                          const float* __restrict__ cum,
                          const float* __restrict__ states,
                          const float* __restrict__ cb, float* __restrict__ y,
                          int64_t nc, int64_t rows_per_group, int Q, int hd,
                          int ds) {
  __shared__ __align__(16) float As[kKC * kLD];   // [k][i]: C^T, scores^T
  __shared__ __align__(16) float Bs[kKC * kLD];   // [k][p]: h_prev^T, x
  __shared__ float cq[kTile];                     // cum of the query rows
  const int64_t row = blockIdx.x;                 // bh * nc + c
  const int64_t gc = (row / nc / rows_per_group) * nc + row % nc;
  const int i0 = blockIdx.y * kTile;
  const float* cc = Cm + gc * Q * ds;
  const float* cbc = cb + gc * Q * Q;
  const float* cumc = cum + row * Q;
  const float* st = states + row * ds * hd;
  const float* xc = x + row * Q * hd;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  if (tid < kTile) cq[tid] = i0 + tid < Q ? cumc[i0 + tid] : 0.f;
  const int k = tid % kKC, r0 = tid / kKC;        // A at (r0 + kARows r, k)
  const int p = tid % kTile, q0 = tid / kTile;    // B at (q0 + kBRows r, p)
  float pa[kTPer], pv[kTPer];
  float acc[4][8];
  zero(acc);

  // inter-chunk: acc = C h_prev^T over k-chunks of ds
  auto fetch_c = [&](int n0) {
    const bool kin = n0 + k < ds;
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      const int i = i0 + r0 + kARows * r, n = n0 + q0 + kBRows * r;
      pa[r] = kin && i < Q ? cc[i * ds + n0 + k] : 0.f;
      pv[r] = n < ds && p < hd ? st[n * hd + p] : 0.f;
    }
  };
  fetch_c(0);
  for (int n0 = 0; n0 < ds; n0 += kKC) {
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      As[k * kLD + r0 + kARows * r] = pa[r];
      Bs[(q0 + kBRows * r) * kLD + p] = pv[r];
    }
    __syncthreads();
    if (n0 + kKC < ds) fetch_c(n0 + kKC);
    tile_fma(acc, As, Bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = expf(cq[4 * ty + i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= e;
  }

  // intra-chunk: acc += (C B^T o L) x over the key chunks up to the
  // tile's last row; each score is scaled by exp(cum_i - cum_j) once, as
  // it is staged, and is 0 above the diagonal and past Q
  const int j_end = min(i0 + kTile, Q);
  // a warp whose rows all lie above a key chunk has only zero scores in it
  const int warp_last = i0 + 4 * ((tid | 31) >> 3) + 3;
  float cj = 0.f;
  auto fetch_s = [&](int j0) {
    const int j = j0 + k;
    cj = j < Q ? cumc[j] : 0.f;
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      const int i = i0 + r0 + kARows * r, jx = j0 + q0 + kBRows * r;
      pa[r] = j <= i && i < Q ? cbc[i * Q + j] : 0.f;
      pv[r] = jx < Q && p < hd ? xc[jx * hd + p] : 0.f;
    }
  };
  fetch_s(0);
  for (int j0 = 0; j0 < j_end; j0 += kKC) {
#pragma unroll
    for (int r = 0; r < kTPer; ++r) {
      const int il = r0 + kARows * r, i = i0 + il;
      As[k * kLD + il] =
          j0 + k <= i && i < Q ? pa[r] * expf(cq[il] - cj) : 0.f;
      Bs[(q0 + kBRows * r) * kLD + p] = pv[r];
    }
    __syncthreads();
    if (j0 + kKC < j_end) fetch_s(j0 + kKC);
    if (j0 <= warp_last) tile_fma(acc, As, Bs, ty, tx);
    __syncthreads();
  }
  tile_store(acc, y + row * Q * hd, hd, i0, 0, Q, hd, ty, tx);
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* la, const void* Bm,
                               const void* Cm, void* y, void* cum,
                               void* states, void* cb, int64_t BH, int64_t G,
                               int64_t nc, int64_t Q, int64_t hd, int64_t ds,
                               void* stream) {
  if (BH <= 0 || nc <= 0 || Q <= 0) return 0;
  if (hd <= 0 || hd > kMaxHD || ds <= 0 || ds > kMaxDS || Q > kMaxQ ||
      G <= 0 || BH % G != 0 || BH * nc > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* laf = static_cast<const float*>(la);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  auto* cumf = static_cast<float*>(cum);
  auto* stf = static_cast<float*>(states);
  auto* cbf = static_cast<float*>(cb);
  const int64_t rpg = BH / G;
  const int q = static_cast<int>(Q), h = static_cast<int>(hd),
            d = static_cast<int>(ds);

  const size_t smem = kStFixedSmem + sizeof(float) * static_cast<size_t>(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<<<static_cast<unsigned>(BH * nc), kStThreads, smem,
                           s>>>(xf, laf, bf, cumf, stf, nc, rpg, q, h, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int E = h * d;
  ssd_state_pass_kernel<<<dim3(static_cast<unsigned>(BH),
                               (E + kPassSpan - 1) / kPassSpan),
                          kPassThreads, 0, s>>>(stf, cumf, nc, q, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int tiles = (q + kTile - 1) / kTile;
  ssd_bmm_kernel<<<dim3(static_cast<unsigned>(G * nc),
                        tiles * (tiles + 1) / 2),
                   kTThreads, 0, s>>>(cf, bf, cbf, q, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_chunk_scan_kernel<<<dim3(static_cast<unsigned>(BH * nc), tiles),
                          kTThreads, 0, s>>>(xf, cf, cumf, stf, cbf,
                                             static_cast<float*>(y), nc, rpg,
                                             q, h, d);
  return static_cast<int>(cudaGetLastError());
}
