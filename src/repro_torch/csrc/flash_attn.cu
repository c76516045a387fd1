// flash_attn: causal flash attention, forward (O and the row log-sum-exp).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::_flash_fwd
// (_fwd_kernel), whose grid (BH, q blocks, k blocks) ran the k-block axis
// in order on one core and carried the online-softmax state (m, l, acc)
// in VMEM scratch from one grid step to the next.  Here a loop over key
// tiles inside a block takes the place of that axis, with m, l and the
// output accumulator in registers; the [S, S] score matrix never leaves
// the chip.
//
// Bound on this card: operations.  At the model's largest shape (15 heads
// x 4,096 positions x head_dim 64, bf16, causal) a call needs 3.2e10 FLOP
// and moves 31.7 MB (q, k, v read once, O and LSE written once): 0.033 ms
// at the tensor cores' 989 TFLOP/s against 0.0095 ms at 3.35 TB/s.  Only
// the tensor cores can approach it, so the bf16 path is built on wgmma:
//
// bf16 (flash_fwd_wgmma_kernel): one block of two warpgroups per (bh, tile
// of 128 query rows), each warpgroup owning 64 rows; the heaviest tiles
// (the last rows, which see the most keys) are handed out first.  Q stays
// in shared memory; K and V tiles of 64 keys stream through a ring of two
// stages filled by cp.async while the previous tile is computed, in the
// 128-byte swizzled layout that wgmma reads (hopper.cuh).  Per tile and
// warpgroup: S = Q K^T by wgmma m64n64k16 with both operands in shared
// memory; the online softmax on the f32 accumulator in registers (scores
// prescaled by scale * log2 e, exp2, row max and sum across the four
// threads of a row by shuffles); P rounded to bf16 in registers and fed as
// the register A operand of O += P V (m64n{64,128}k16, V MN-major through
// the descriptor's transpose bit).  O is written in bf16, LSE = m + log l
// in f32.  Key tiles that hold no key a warpgroup's rows may see (above
// the diagonal, outside the window) are skipped by it, and never loaded
// when no row of the block sees them.
//
// f32 (flash_fwd_kernel): FP32 FMAs on the CUDA cores, one block of 256
// threads per (tile of 64 query rows, bh), q, k, v tiles in shared memory
// as f32.  wgmma's f32 route is TF32 (a 10-bit mantissa), which would
// break the f32 path's 1e-4 agreement with the plain version, so f32 keeps
// this design.
//
// In both, a masked score contributes exactly 0 and leaves the row max
// alone, so a row whose entries in a tile are all masked keeps l = 0 there
// instead of the reference's transient exp(NEG - NEG) = 1, which a later
// tile rescales by exp(NEG - m) = 0: O and LSE agree.  Masking is by
// position inside the visited tiles, so any S >= 1 works (a ragged last
// tile reads zeros and writes nothing past S).
//
// Inputs q, k, v [BH, S, hd] contiguous, f32 or bf16; O [BH, S, hd] in the
// same type; LSE [BH, S] f32.  hd is 64, 96, 128 or 256; both kernels are
// templates on it.  In the bf16 one, head_dim 256 runs O += P V as one
// m64n256k16 a k-step: O alone is then 128 f32 registers a thread, so a
// block of two warpgroups runs one to an SM with up to 255 registers each
// (phase 1 of chip_smoke.py fails a build that spills).  Head_dim 96 holds
// Q, K and V as two column panels, the second half used: S = Q K^T reads
// only its 6 k-steps, and O += P V runs n128 over V's last panel, whose
// columns 96-127 are zeroed once in both stages (cp.async never writes
// them), so the accumulator's last 32 columns stay 0 and are never
// stored.  Register- and shared-memory-wise 96 is 128.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ------------------------------------------------------------ f32: FMAs

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
    Qs[i * LD + d] = qi < S ? q[base + qi * HD + d] : 0.f;
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
      Ks[j * LD + d] = in ? k[base + kj * HD + d] : 0.f;
      Vs[j * HD + d] = in ? v[base + kj * HD + d] : 0.f;
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
      o[base + qi * HD + c + 16 * dd] = acc[ii][dd] / lc;
    if (c == 0) lse[static_cast<int64_t>(blockIdx.y) * S + qi] = m[ii] + logf(lc);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int64_t BH, int64_t S, int64_t hd, float scale,
               int64_t window, cudaStream_t stream) {
  auto kernel = hd == 64    ? flash_fwd_kernel<64>
                : hd == 96  ? flash_fwd_kernel<96>
                : hd == 128 ? flash_fwd_kernel<128>
                            : flash_fwd_kernel<256>;
  const size_t smem = hd == 64    ? smem_bytes<64>()
                      : hd == 96  ? smem_bytes<96>()
                      : hd == 128 ? smem_bytes<128>()
                                  : smem_bytes<256>();   // 213,760 B
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- bf16: wgmma

using bf16 = __nv_bfloat16;

template <int HD>
struct Fwd {
  static constexpr int HDP = (HD + 63) / 64 * 64;   // whole column panels
  static constexpr int BQ = 128;             // query rows a block
  static constexpr int BK = 64;              // keys a tile
  static constexpr int THREADS = 256;        // two warpgroups
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;  // K or V, one stage
  // the ring's two stages of K and V after Q; 1 KiB to align the base
  // (head_dim 256: 1 + 64 + 128 KiB)
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * 2 * KV_BYTES;
  // two blocks an SM where the registers allow
  static constexpr int MIN_BLOCKS = HD == 64 ? 2 : 1;
};

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::THREADS, Fwd<HD>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, float scale_log2,
                           int window) {
  using C = Fwd<HD>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t KV0 = Qs + C::Q_BYTES;      // stage s: K, then V

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S * HD;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int kt_begin = (window > 0 && q0 - window + 1 > 0)
                           ? (q0 - window + 1) / BK : 0;
  const int kt_end = q_last / BK;

  // V's padded columns (B of O += P V), both stages
  zero_pad<HD, C::HDP, BK, NT>(KV0 + C::KV_BYTES, tid);
  zero_pad<HD, C::HDP, BK, NT>(KV0 + 2 * C::KV_BYTES + C::KV_BYTES, tid);
  load_tile<BQ, HD, NT>(Qs, q + base, q0, S, tid);
  load_tile<BK, HD, NT>(KV0, k + base, kt_begin * BK, S, tid);
  load_tile<BK, HD, NT>(KV0 + C::KV_BYTES, v + base, kt_begin * BK, S, tid);
  cp_async_commit();

  const int wq0 = q0 + 64 * wg;              // this warpgroup's first row
  const int row = wq0 + 16 * warp + lane / 4;   // rows row and row + 8
  const int col = 2 * (lane % 4);            // columns 8j + col, + 1
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[C::HDP / 2];
#pragma unroll
  for (int i = 0; i < C::HDP / 2; ++i) acc[i] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const uint32_t Ks = KV0 + ((kt - kt_begin) & 1) * 2 * C::KV_BYTES;
    const uint32_t Vs = Ks + C::KV_BYTES;
    if (kt < kt_end) {                       // the next tile, other stage
      const uint32_t nK = KV0 + ((kt + 1 - kt_begin) & 1) * 2 * C::KV_BYTES;
      load_tile<BK, HD, NT>(nK, k + base, (kt + 1) * BK, S, tid);
      load_tile<BK, HD, NT>(nK + C::KV_BYTES, v + base, (kt + 1) * BK, S,
                            tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                         // this tile is in for all

    const int k0 = kt * BK;
    // does the tile hold a key that a row of this warpgroup may see?
    if (wq0 < S && k0 <= wq0 + 63 &&
        (window == 0 || wq0 - (k0 + BK - 1) < window)) {
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // S = Q K^T, both K-major
        const uint32_t panel = (kk / 4), off = (kk % 4) * 32;
        wgmma_ss<BK, 0>(
            s, desc_sw128(Qs + panel * BQ * 128 + wg * 64 * 128 + off, 16,
                          1024),
            desc_sw128(Ks + panel * BK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // every entry of the tile allowed for every row of the warpgroup?
      const bool whole = k0 + BK - 1 <= wq0 && k0 + BK <= S &&
                         (window == 0 || wq0 + 63 - k0 < window);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = row + ((i & 2) ? 8 : 0);
        const int kj = k0 + 8 * (i / 4) + col + (i & 1);
        float x = s[i] * scale_log2;
        if (!whole && !(kj <= r && kj < S && (window == 0 || r - kj < window)))
          x = -INFINITY;                     // contributes exactly 0
        s[i] = x;
        mt[(i & 2) >> 1] = fmaxf(mt[(i & 2) >> 1], x);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h]);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i & 2) >> 1;
        s[i] = ex2(s[i] - m[h]);
        ps[h] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l[h] = l[h] * corr[h] + ps[h];
      }
#pragma unroll
      for (int i = 0; i < C::HDP / 2; ++i) acc[i] *= corr[(i & 2) >> 1];

      uint32_t pa[BK / 16][4];               // P in bf16, register A
      acc_to_a<BK>(s, pa);
      fence_regs(pa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)     // O += P V, V MN-major
        wgmma_rs<C::HDP, 1>(acc, pa[kk],
                        desc_sw128(Vs + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();                         // the stage is free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    const float lc = fmaxf(l[h], 1e-30f), inv = 1.f / lc;
    bf16* orow = o + base + static_cast<int64_t>(r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      __nv_bfloat162 pr = __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                                acc[4 * j + 2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) = pr;
    }
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(blockIdx.x) * S + r] =
          m[h] * 0.6931471805599453f + logf(lc);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int64_t BH, int64_t S, float scale, int64_t window,
                cudaStream_t stream) {
  using C = Fwd<HD>;
  const int64_t n_qt = (S + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // grid.x over heads, so that the heaviest query tiles of every head
  // (grid.y = 0: the last rows) are dispatched first
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_qt));
  flash_fwd_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<int>(S),
      scale * 1.4426950408889634f,
      static_cast<int>(window >= S ? 0 : window));   // >= S masks nothing
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int64_t BH, int64_t S,
                                int64_t hd, float scale, int64_t window,
                                int is_bf16, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (BH > 65535 || S > (int64_t{1} << 30) || window < 0 ||
      (hd != 64 && hd != 96 && hd != 128 && hd != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_f32(q, k, v, o, lse, BH, S, hd, scale, window, st);
  switch (hd) {
    case 64:
      return launch_bf16<64>(q, k, v, o, lse, BH, S, scale, window, st);
    case 96:
      return launch_bf16<96>(q, k, v, o, lse, BH, S, scale, window, st);
    case 128:
      return launch_bf16<128>(q, k, v, o, lse, BH, S, scale, window, st);
    default:
      return launch_bf16<256>(q, k, v, o, lse, BH, S, scale, window, st);
  }
}
