// Flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward kernels (K2: dK and dV, K3: dQ) over (BH, S, D) tensors.
//
// Replaces the TPU kernels of mxnet_tpu/ops/attention.py:
//   K1  `_fa_fwd_kernel`       (reached through `_fa_forward_pallas`)
//   K2  `_fa_bwd_dkdv_kernel`  (reached through `_fa_backward_pallas`)
//   K3  `_fa_bwd_dq_kernel`    (reached through `_fa_backward_pallas`)
//
// What they compute (the reference's numerics, not its blocking):
//   K1  s = (q·kᵀ)·scale, accumulated in f32 from the input type; masked
//       keys (kpos >= seq_k, and kpos > qpos when causal, top-left
//       aligned) take -1e30; an online softmax keeps f32 m / l / acc; p
//       is rounded to v's type before p·v; O = acc / l (l == 0 -> 1) in
//       q's type and LSE = m + log l in f32.
//   K2  P = exp(s - lse) (0 where masked), dV = Pᵀ·dO, dP = dO·Vᵀ,
//       dS = P∘(dP - delta)·scale, dK = dSᵀ·Q.
//   K3  the same P and dS, dQ = dS·K.
//   dP, dS and the dK / dV / dQ products are formed in f32, as the
//   reference does (`.astype(jnp.float32)` on every operand), and
//   delta = rowsum(dO∘O) comes in from the caller.
//
// What bounds them on an H100: operations.  At the training shape (BH 64,
// S 2048, D 64, causal) one (S x S x D) product is F = 17.2 GFLOP; the
// operands are O(S·D) bytes per head, re-read from L2 by every tile.
// In bf16 every product runs on the tensor cores, counted in bf16
// passes: K1 2F, K2 8F (s 1, dP 1, dV 3, dK 3), K3 5F (s 1, dP 1, dQ 3),
// all far above the card's bytes-to-flops balance point.
//
// Why three passes.  In bf16, s = q·kᵀ and dP = dO·Vᵀ multiply bf16
// values, whose products are exact in f32: one bf16 mma with f32
// accumulation forms the reference's products.  dV, dK and dQ multiply
// an f32 operand (P or dS) by a bf16 one.  Any f32 x is exactly
// hi + mid + lo with hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid) (24 significant bits; each rounding to nearest leaves a remainder
// of at most 8 bits plus its sign), so three bf16 passes accumulated in
// f32 form the reference's f32 products.  Two passes keep 16 bits and
// one 8, which is what a bf16 backward that rounds P and dS does: not
// the reference's numerics.  f32 inputs are not bf16-exact, so f32 runs
// every product on the FMA units.
//
// Design (simple kernels that are right; TMA, wgmma and warp
// specialisation are later work):
//   * bf16: warp-level mma.sync.m16n8k16 (bf16 operands, f32
//     accumulators), one warp per 16 rows of the block's own tile, which
//     keeps those rows' A fragments and its f32 accumulators in
//     registers.  Tiles sit in shared-memory rows padded by 16 bytes,
//     which keeps fragment reads free of bank conflicts; a row-major
//     tile on the k side of a product is read through ldmatrix.trans.
//     - K1: Q fragments; s = Q·Kᵀ, an online softmax, and the score
//       accumulators re-packed in place as the A operand of P·V (p
//       rounded to bf16 there, summed into l in f32).
//     - K2: one block per (bh, k tile); K and V fragments (from shared
//       memory at D 128, where registers would spill).  16 queries at a
//       time: sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in one pass each, Pᵀ and dSᵀ in
//       f32 in the accumulators, re-packed as A fragments split into
//       hi / mid / lo, then dV += Pᵀ·dO and dK += dSᵀ·Q in three passes.
//     - K3: one block per (bh, q tile); Q and dO fragments.  16 keys at
//       a time: s = Q·Kᵀ and dP = dO·Vᵀ in one pass, P and dS in f32,
//       dQ += dS·K in three passes.
//     - K2 and K3 double-buffer the streamed tiles (Q, dO, lse and delta
//       in K2; K and V in K3) with cp.async 16-byte copies: the next
//       tile is in flight while the current one's products run.
//   * f32: the FMA units.  256 threads as a 16 x 16 grid, each computing
//     a (TILE/16) x (TILE/16) sub-tile of the score tile (rows ty + 16i,
//     columns tx + 16j) from shared memory and owning the same rows of
//     the output tile (columns tx + 16c); a row's reductions run over
//     the 16 lanes of a half-warp with shuffles.  Tiles are staged as
//     f32 with rows padded to D + 1 floats, so neither the broadcast row
//     reads nor the strided column reads conflict on a bank.
//   * The TPU carried acc / m / l (or the dK, dV, dQ sums) in scratch
//     across its sequential innermost grid axis.  Blocks on a GPU run in
//     no order, so each block owns one output tile and loops inside
//     itself: K1 and K3 one block per (bh, q tile) over the k tiles up to
//     the diagonal when causal (the longest rows launched first), K2 one
//     block per (bh, k tile) over the q tiles from the diagonal down.
//     The split into K2 and K3 keeps the backward free of atomics and
//     deterministic.
//   * Square TILE x TILE tiles (TILE 32 or 64).  Ragged edges are masked
//     here, not padded by the caller: rows past seq_q / seq_k load as
//     zeros, their scores are masked and their outputs are not stored.
//     The bf16 backward applies the causal mask on the diagonal tile
//     and the bounds on the last tile only.
//   * -1e30, not -inf, seeds m, as in the reference: exp(-inf - -inf) is
//     NaN.
//   * Head dims 64 and 128 are instantiated; anything else is refused.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

// TILE rows of a (rows_total, D) f32 matrix from row0 into shared memory
// with row stride D + 1; rows past rows_total read as zeros.
template <int TILE, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows_total) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < rows_total ? src[(size_t)g * D + c] : 0.f;
  }
}

template <int TILE>
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int rows_total) {
  for (int i = threadIdx.x; i < TILE; i += kThreads)
    dst[i] = row0 + i < rows_total ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared-memory footprint (bytes) of each f32 kernel.
template <int TILE, int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TILE * (D + 1) + TILE * (TILE + 16));
}
template <int TILE, int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * (TILE + 16) + 2 * TILE);
}
template <int TILE, int D> constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * TILE * (D + 1) + 2 * TILE * (TILE + 16) + 2 * TILE);
}

// ---------------------------------------------------------- K1, f32 ----
template <int TILE, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int seq_q, int seq_k, int causal,
              float scale) {
  constexpr int LD = D + 1, PLD = TILE + 16, R = TILE / 16, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;

  const int nq = (seq_q + TILE - 1) / TILE;
  const int q0 = (nq - 1 - (int)blockIdx.x) * TILE;   // longest rows first
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;

  load_tile<TILE, D>(Qs, q + qoff, q0, seq_q);
  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // causal: k tiles wholly above the tile's last row contribute nothing
  const int k_end = causal ? min(seq_k, q0 + TILE) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();               // the last tile's Ks / Vs / Ps are read
    load_tile<TILE, D>(Ks, k + koff, k0, seq_k);
    load_tile<TILE, D>(Vs, v + koff, k0, seq_k);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[R], b[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) b[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < seq_k && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float p[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = Ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= seq_q) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + qoff + (size_t)qpos * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / li;
    if (tx == 0) lse[(size_t)bh * seq_q + qpos] = m[i] + logf(li);
  }
}

// ----------------------------------------------------------- K3, f32 ----
template <int TILE, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int seq_q, int seq_k, int causal, float scale) {
  constexpr int LD = D + 1, PLD = TILE + 16, R = TILE / 16, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* dSs = Vs + TILE * LD;
  float* lse_s = dSs + TILE * PLD;
  float* delta_s = lse_s + TILE;

  const int nq = (seq_q + TILE - 1) / TILE;
  const int q0 = (nq - 1 - (int)blockIdx.x) * TILE;   // longest rows first
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;

  load_tile<TILE, D>(Qs, q + qoff, q0, seq_q);
  load_tile<TILE, D>(dOs, dout + qoff, q0, seq_q);
  load_vec<TILE>(lse_s, lse + (size_t)bh * seq_q, q0, seq_q);
  load_vec<TILE>(delta_s, delta + (size_t)bh * seq_q, q0, seq_q);
  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(seq_k, q0 + TILE) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile<TILE, D>(Ks, k + koff, k0, seq_k);
    load_tile<TILE, D>(Vs, v + koff, k0, seq_k);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], b[R], ga[R], gb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        ga[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        b[j] = Ks[(tx + 16 * j) * LD + d];
        gb[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], gb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < seq_q && kpos < seq_k &&
                        (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * PLD + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float a[R], b[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = dSs[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) b[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= seq_q) continue;
    float* row = dq + qoff + (size_t)qpos * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// ----------------------------------------------------------- K2, f32 ----
// Scores are formed transposed (rows = keys, columns = queries) so that a
// thread's score rows are the dK / dV rows it owns.
template <int TILE, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int seq_q, int seq_k, int causal,
                   float scale) {
  constexpr int LD = D + 1, PLD = TILE + 16, R = TILE / 16, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Pt = dOs + TILE * LD;
  float* dSt = Pt + TILE * PLD;
  float* lse_s = dSt + TILE * PLD;
  float* delta_s = lse_s + TILE;

  const int k0 = blockIdx.x * TILE;     // low k tiles see the most queries
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;

  load_tile<TILE, D>(Ks, k + koff, k0, seq_k);
  load_tile<TILE, D>(Vs, v + koff, k0, seq_k);
  float gk[R][DC], gv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;

  // causal: q tiles wholly above this k tile's first key see none of it
  for (int q0 = causal ? k0 : 0; q0 < seq_q; q0 += TILE) {
    __syncthreads();
    load_tile<TILE, D>(Qs, q + qoff, q0, seq_q);
    load_tile<TILE, D>(dOs, dout + qoff, q0, seq_q);
    load_vec<TILE>(lse_s, lse + (size_t)bh * seq_q, q0, seq_q);
    load_vec<TILE>(delta_s, delta + (size_t)bh * seq_q, q0, seq_q);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], b[R], ga[R], gb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Ks[(ty + 16 * i) * LD + d];
        ga[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        b[j] = Qs[(tx + 16 * j) * LD + d];
        gb[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], gb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const bool ok = qpos < seq_q && kpos < seq_k &&
                        (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        Pt[r * PLD + c] = p;
        dSt[r * PLD + c] = p * (dp[i][j] - delta_s[c]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      float p[R], ds[R], go[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = Pt[(ty + 16 * i) * PLD + qq];
        ds[i] = dSt[(ty + 16 * i) * PLD + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        go[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[i][c] = fmaf(p[i], go[c], gv[i][c]);
          gk[i][c] = fmaf(ds[i], qv[c], gk[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= seq_k) continue;
    float* krow = dk + koff + (size_t)kpos * D;
    float* vrow = dv + koff + (size_t)kpos * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = gk[i][c];
      vrow[tx + 16 * c] = gv[i][c];
    }
  }
}

// ------------------------------------------------------- K1, bf16 ----
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 b16 matrices, transposed: lanes 0-7 give the row addresses of
// the first, lanes 8-15 of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A registers
// hold rows g / g + 8 at columns 2t, 2t + 1 (+ 8 for registers 2, 3); B
// registers rows 2t, 2t + 1 (+ 8) of column g; C holds rows g / g + 8 at
// columns 2t, 2t + 1.
template <int TILE, int D>
__global__ void __launch_bounds__(TILE * 2)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int seq_q, int seq_k, int causal, float scale) {
  constexpr int KLD = D + 8;                   // padded smem rows (bf16)
  constexpr int NT = TILE / 8, DT = D / 8, KS = D / 16, PS = TILE / 16;
  constexpr int THREADS = TILE * 2, CH = D / 8;  // CH 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 Ks[TILE * KLD];
  __shared__ __align__(16) __nv_bfloat16 Vs[TILE * KLD];

  const int nq = (seq_q + TILE - 1) / TILE;
  const int q0 = (nq - 1 - (int)blockIdx.x) * TILE;   // longest rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + qoff);
  const uint4* k16 = reinterpret_cast<const uint4*>(k + koff);
  const uint4* v16 = reinterpret_cast<const uint4*>(v + koff);

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int col = ks * 16 + (r >> 1) * 8 + 2 * t;
      qa[ks][r] = row < seq_q ? q32[((size_t)row * D + col) / 2] : 0u;
    }
  float o[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const int k_end = causal ? min(seq_k, q0 + TILE) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();               // the last tile's Ks / Vs are read
#pragma unroll
    for (int j = 0; j < TILE * CH / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < seq_k;
      const size_t at = (size_t)(k0 + r) * CH + c;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(&Ks[r * KLD + c * 8]) = ok ? k16[at] : z;
      *reinterpret_cast<uint4*>(&Vs[r * KLD + c * 8]) = ok ? v16[at] : z;
    }
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * KLD + ks * 16 + 2 * t];
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {          // rows g (h = 0) and g + 8
      const int qpos = rows[h];
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = kpos < seq_k && (!causal || qpos >= kpos);
          s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
          mt = fmaxf(mt, s[nt][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[h], mt);
      const float corr = expf(m[h] - mn);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - mn);
          ps += s[nt][e];
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[h] = l[h] * corr + ps;
      m[h] = mn;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= corr;
        o[dt][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < PS; ++j) {         // keys 16j .. 16j + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          &Vs[(j * 16 + (lane & 15)) * KLD + dt * 8]);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = rows[h];
    if (qpos >= seq_q) continue;
    const float li = l[h] == 0.f ? 1.f : l[h];
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + qoff +
                                                 (size_t)qpos * D);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      orow[(dt * 8 + 2 * t) / 2] =
          pack_bf16(o[dt][2 * h] / li, o[dt][2 * h + 1] / li);
    if (t == 0) lse[(size_t)bh * seq_q + qpos] = m[h] + logf(li);
  }
}

// ------------------------------------------------- K2 / K3, bf16 ----
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices: lanes 8i .. 8i + 7 give the row addresses of the
// i-th, and register i receives it (row g, columns 2t, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// The same, each matrix transposed (rows 2t, 2t + 1 of column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// Asynchronous global -> shared copies of 16 (cp.async.cg) or 4 bytes;
// zeros land in shared memory when !ok (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group (the newest) is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values (columns 2t, 2t + 1 of an A fragment register) as three
// bf16 pairs with x == hi + mid + lo exactly (see the head comment).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;        // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// c += (hi + mid + lo)·b, the small terms first.
__device__ __forceinline__ void mma_bf16x3(float* c, const uint32_t* hi,
                                           const uint32_t* mid,
                                           const uint32_t* lo, uint32_t b0,
                                           uint32_t b1) {
  mma_bf16(c, lo, b0, b1);
  mma_bf16(c, mid, b0, b1);
  mma_bf16(c, hi, b0, b1);
}

// ROWS rows of a (rows_total, D) bf16 matrix from row0 into shared-memory
// rows of D + 8 elements, in 16-byte cp.async copies by THREADS threads;
// rows past rows_total land as zeros.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void copy_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int rows_total) {
  constexpr int CH = D / 8, LD = D + 8;
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < rows_total;
    cp_async16(&dst[r * LD + c * 8],
               src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

// The A fragment (16 rows from row0, k columns col0 .. col0 + 15) of a
// row-major tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile,
                                       int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, &tile[(row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8]);
}

// B fragments of two k steps (registers 0, 1: k columns col0 .. col0 + 15;
// 2, 3: the next 16) for the 8 n rows from row0 of a row-major (n, k)
// tile: Q for sᵀ = K·Qᵀ, K for s = Q·Kᵀ.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* tile,
                                          int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, &tile[(row0 + (lane & 7)) * LD + col0 + (lane >> 3) * 8]);
}

// B fragments of two n tiles (registers 0, 1: n columns col0 .. col0 + 7;
// 2, 3: the next 8) for the 16 k rows from row0 of a row-major (k, n)
// tile: dO and Q for dV and dK, K for dQ.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* tile,
                                          int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(
      b, &tile[(row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8]);
}

template <int TILE, int D> constexpr size_t dkdv_mma_smem() {
  return sizeof(bf16) * 6 * TILE * (D + 8) + sizeof(float) * 4 * TILE;
}
template <int TILE, int D> constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * 6 * TILE * (D + 8);
}

// K2 in bf16.  Warp w owns keys k0 + 16w .. + 15 (A rows g, g + 8 of its
// fragments) and their dK / dV rows in f32 accumulators.
template <int TILE, int D>
__global__ void __launch_bounds__(TILE * 2)
fa_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int seq_q, int seq_k,
                       int causal, float scale) {
  constexpr int LD = D + 8, THREADS = TILE * 2;
  constexpr int KS = D / 16, DT = D / 8, QC = TILE / 16;
  constexpr bool KV_REGS = D <= 64;   // at D 128 they come from smem
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Vs = Ks + TILE * LD;
  bf16* Qs = Vs + TILE * LD;                    // two stages each
  bf16* dOs = Qs + 2 * TILE * LD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE * LD);
  float* Ds = Ls + 2 * TILE;

  const int k0 = blockIdx.x * TILE;     // low k tiles see the most queries
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = warp * 16;                     // the warp's rows in Ks
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;
  const float* lse_bh = lse + (size_t)bh * seq_q;
  const float* delta_bh = delta + (size_t)bh * seq_q;

  auto fetch = [&](int q0, int stage) {         // one q tile, one group
    copy_tile_async<TILE, D, THREADS>(Qs + stage * TILE * LD, q + qoff, q0,
                                      seq_q);
    copy_tile_async<TILE, D, THREADS>(dOs + stage * TILE * LD, dout + qoff,
                                      q0, seq_q);
    const int i = threadIdx.x % TILE;     // lse by the first TILE threads,
    const bool ok = q0 + i < seq_q;       // delta by the others
    const bool first = threadIdx.x < TILE;
    cp_async4((first ? Ls : Ds) + stage * TILE + i,
              (first ? lse_bh : delta_bh) + (ok ? q0 + i : 0), ok);
    cp_async_commit();
  };

  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[dt][e] = gv[dt][e] = 0.f;
  uint32_t ka[KV_REGS ? KS : 1][4], va[KV_REGS ? KS : 1][4];

  // causal: q tiles wholly above this k tile's first key see none of it
  const int q_begin = causal ? k0 : 0;
  if (q_begin < seq_q) {                // K and V ride in the first group
    copy_tile_async<TILE, D, THREADS>(Ks, k + koff, k0, seq_k);
    copy_tile_async<TILE, D, THREADS>(Vs, v + koff, k0, seq_k);
    fetch(q_begin, 0);
  }
  int stage = 0;
  for (int q0 = q_begin; q0 < seq_q; q0 += TILE, stage ^= 1) {
    if (q0 + TILE < seq_q) fetch(q0 + TILE, stage ^ 1);
    else cp_async_commit();                     // an empty group
    cp_async_wait_all_but_newest();
    __syncthreads();
    if constexpr (KV_REGS) {
      if (q0 == q_begin) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          load_a<LD>(ka[ks], Ks, kw, ks * 16);
          load_a<LD>(va[ks], Vs, kw, ks * 16);
        }
      }
    }
    const bf16* Qt = Qs + stage * TILE * LD;
    const bf16* dOt = dOs + stage * TILE * LD;
    const float* Lt = Ls + stage * TILE;
    const float* Dt = Ds + stage * TILE;
    const bool masked = (causal && q0 == k0) || q0 + TILE > seq_q ||
                        k0 + TILE > seq_k;
#pragma unroll 1          // unrolled, ptxas spills at D 128
    for (int c = 0; c < QC; ++c) {             // queries c*16 .. c*16 + 15
      float st[2][4], dpt[2][4];                // sᵀ, dPᵀ: keys x queries
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        uint32_t kf[2][4], vf[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if constexpr (KV_REGS) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              kf[u][r] = ka[ks + u][r];
              vf[u][r] = va[ks + u][r];
            }
          } else {
            load_a<LD>(kf[u], Ks, kw, (ks + u) * 16);
            load_a<LD>(vf[u], Vs, kw, (ks + u) * 16);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bq[4], bo[4];
          load_b_nk<LD>(bq, Qt, c * 16 + nt * 8, ks * 16);
          load_b_nk<LD>(bo, dOt, c * 16 + nt * 8, ks * 16);
          mma_bf16(st[nt], kf[0], bq[0], bq[1]);
          mma_bf16(st[nt], kf[1], bq[2], bq[3]);
          mma_bf16(dpt[nt], vf[0], bo[0], bo[1]);
          mma_bf16(dpt[nt], vf[1], bo[2], bo[3]);
        }
      }
      // Pᵀ and dSᵀ in f32, re-packed in place as A fragments (rows: keys
      // g, g + 8; k: queries 2t, 2t + 1 of register h + 2nt), split in 3
      uint32_t ph[4], pm[4], pl[4], sh[4], sm[4], sl[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kpos = k0 + kw + g + 8 * h;
          float p2[2], ds2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = c * 16 + nt * 8 + 2 * t + e;
            const int qpos = q0 + qi;
            const bool ok = !masked || (qpos < seq_q && kpos < seq_k &&
                                        (!causal || qpos >= kpos));
            const float p =
                ok ? expf(__fmul_rn(st[nt][2 * h + e], scale) - Lt[qi]) : 0.f;
            p2[e] = p;
            ds2[e] = p * (dpt[nt][2 * h + e] - Dt[qi]) * scale;
          }
          const int r = h + 2 * nt;
          split3(p2[0], p2[1], ph[r], pm[r], pl[r]);
          split3(ds2[0], ds2[1], sh[r], sm[r], sl[r]);
        }
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bo[4], bq[4];
        load_b_kn<LD>(bo, dOt, c * 16, dt * 8);
        load_b_kn<LD>(bq, Qt, c * 16, dt * 8);
        mma_bf16x3(gv[dt], ph, pm, pl, bo[0], bo[1]);
        mma_bf16x3(gv[dt + 1], ph, pm, pl, bo[2], bo[3]);
        mma_bf16x3(gk[dt], sh, sm, sl, bq[0], bq[1]);
        mma_bf16x3(gk[dt + 1], sh, sm, sl, bq[2], bq[3]);
      }
    }
    __syncthreads();               // this stage is read before it refills
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + kw + g + 8 * h;
    if (kpos >= seq_k) continue;
    uint32_t* krow =
        reinterpret_cast<uint32_t*>(dk + koff + (size_t)kpos * D);
    uint32_t* vrow =
        reinterpret_cast<uint32_t*>(dv + koff + (size_t)kpos * D);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      krow[(dt * 8 + 2 * t) / 2] =
          pack_bf16(gk[dt][2 * h], gk[dt][2 * h + 1]);
      vrow[(dt * 8 + 2 * t) / 2] =
          pack_bf16(gv[dt][2 * h], gv[dt][2 * h + 1]);
    }
  }
}

// K3 in bf16.  Warp w owns queries q0 + 16w .. + 15, their Q and dO
// fragments, lse and delta, and their dQ rows in f32 accumulators.
template <int TILE, int D>
__global__ void __launch_bounds__(TILE * 2)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int seq_q, int seq_k, int causal, float scale) {
  constexpr int LD = D + 8, THREADS = TILE * 2;
  constexpr int KS = D / 16, DT = D / 8, KC = TILE / 16;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;                   // two stages each
  bf16* Vs = Ks + 2 * TILE * LD;

  const int nq = (seq_q + TILE - 1) / TILE;
  const int q0 = (nq - 1 - (int)blockIdx.x) * TILE;   // longest rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;

  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < seq_q;
    lr[h] = ok ? lse[(size_t)bh * seq_q + rows[h]] : 0.f;
    dr[h] = ok ? delta[(size_t)bh * seq_q + rows[h]] : 0.f;
  }

  auto fetch = [&](int k0, int stage) {         // one k tile, one group
    copy_tile_async<TILE, D, THREADS>(Ks + stage * TILE * LD, k + koff, k0,
                                      seq_k);
    copy_tile_async<TILE, D, THREADS>(Vs + stage * TILE * LD, v + koff, k0,
                                      seq_k);
    cp_async_commit();
  };

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  uint32_t qa[KS][4], oa[KS][4];

  // causal: k tiles wholly right of the tile's last row contribute nothing
  const int k_end = causal ? min(seq_k, q0 + TILE) : seq_k;
  copy_tile_async<TILE, D, THREADS>(Qs, q + qoff, q0, seq_q);
  copy_tile_async<TILE, D, THREADS>(dOs, dout + qoff, q0, seq_q);
  fetch(0, 0);                          // Q and dO ride in the first group
  int stage = 0;
  for (int k0 = 0; k0 < k_end; k0 += TILE, stage ^= 1) {
    if (k0 + TILE < k_end) fetch(k0 + TILE, stage ^ 1);
    else cp_async_commit();                     // an empty group
    cp_async_wait_all_but_newest();
    __syncthreads();
    if (k0 == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a<LD>(qa[ks], Qs, warp * 16, ks * 16);
        load_a<LD>(oa[ks], dOs, warp * 16, ks * 16);
      }
    }
    const bf16* Kt = Ks + stage * TILE * LD;
    const bf16* Vt = Vs + stage * TILE * LD;
    const bool masked = (causal && k0 == q0) || k0 + TILE > seq_k ||
                        q0 + TILE > seq_q;
#pragma unroll 1          // unrolled, ptxas spills at D 128
    for (int j = 0; j < KC; ++j) {             // keys j*16 .. j*16 + 15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bk[4], bv[4];
          load_b_nk<LD>(bk, Kt, j * 16 + nt * 8, ks * 16);
          load_b_nk<LD>(bv, Vt, j * 16 + nt * 8, ks * 16);
          mma_bf16(s[nt], qa[ks], bk[0], bk[1]);
          mma_bf16(s[nt], qa[ks + 1], bk[2], bk[3]);
          mma_bf16(dp[nt], oa[ks], bv[0], bv[1]);
          mma_bf16(dp[nt], oa[ks + 1], bv[2], bv[3]);
        }
      // dS in f32, re-packed in place as an A fragment (rows: queries g,
      // g + 8; k: keys 2t, 2t + 1 of register h + 2nt), split in three
      uint32_t sh[4], sm[4], sl[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + j * 16 + nt * 8 + 2 * t + e;
            const bool ok = !masked || (rows[h] < seq_q && kpos < seq_k &&
                                        (!causal || rows[h] >= kpos));
            const float p =
                ok ? expf(__fmul_rn(s[nt][2 * h + e], scale) - lr[h]) : 0.f;
            ds2[e] = p * (dp[nt][2 * h + e] - dr[h]) * scale;
          }
          const int r = h + 2 * nt;
          split3(ds2[0], ds2[1], sh[r], sm[r], sl[r]);
        }
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bk[4];
        load_b_kn<LD>(bk, Kt, j * 16, dt * 8);
        mma_bf16x3(acc[dt], sh, sm, sl, bk[0], bk[1]);
        mma_bf16x3(acc[dt + 1], sh, sm, sl, bk[2], bk[3]);
      }
    }
    __syncthreads();               // this stage is read before it refills
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= seq_q) continue;
    uint32_t* row =
        reinterpret_cast<uint32_t*>(dq + qoff + (size_t)rows[h] * D);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      row[(dt * 8 + 2 * t) / 2] =
          pack_bf16(acc[dt][2 * h], acc[dt][2 * h + 1]);
  }
}

// ------------------------------------------------------------ launch ----
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  int bh, seq_q, seq_k, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int TILE, int D, typename T>
cudaError_t launch_fwd(const Args& a) {
  const dim3 grid((a.seq_q + TILE - 1) / TILE, a.bh);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    fa_fwd_mma_kernel<TILE, D><<<grid, TILE * 2, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse_out), a.seq_q, a.seq_k, a.causal,
        a.scale);
  } else {
    constexpr size_t smem = fwd_smem<TILE, D>();
    auto kernel = fa_fwd_kernel<TILE, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse_out), a.seq_q, a.seq_k, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

// The bf16 backward runs on the tensor cores, the f32 one on the FMA units.
template <int TILE, int D, typename T>
cudaError_t launch_dq(const Args& a) {
  const dim3 grid((a.seq_q + TILE - 1) / TILE, a.bh);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = dq_mma_smem<TILE, D>();
    auto kernel = fa_bwd_dq_mma_kernel<TILE, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TILE * 2, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dq), a.seq_q, a.seq_k, a.causal, a.scale);
  } else {
    constexpr size_t smem = dq_smem<TILE, D>();
    auto kernel = fa_bwd_dq_kernel<TILE, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dq), a.seq_q, a.seq_k, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int TILE, int D, typename T>
cudaError_t launch_dkdv(const Args& a) {
  const dim3 grid((a.seq_k + TILE - 1) / TILE, a.bh);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = dkdv_mma_smem<TILE, D>();
    auto kernel = fa_bwd_dkdv_mma_kernel<TILE, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TILE * 2, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq_q, a.seq_k,
        a.causal, a.scale);
  } else {
    constexpr size_t smem = dkdv_smem<TILE, D>();
    auto kernel = fa_bwd_dkdv_kernel<TILE, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq_q, a.seq_k,
        a.causal, a.scale);
  }
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

template <int TILE, int D, typename T>
cudaError_t launch(int which, const Args& a) {
  switch (which) {
    case kFwd: return launch_fwd<TILE, D, T>(a);
    case kDkdv: return launch_dkdv<TILE, D, T>(a);
    case kDq: return launch_dq<TILE, D, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int which, int tile, int head_dim, const Args& a) {
  if (tile == 64 && head_dim == 64) return launch<64, 64, T>(which, a);
  if (tile == 64 && head_dim == 128) return launch<64, 128, T>(which, a);
  if (tile == 32 && head_dim == 64) return launch<32, 64, T>(which, a);
  if (tile == 32 && head_dim == 128) return launch<32, 128, T>(which, a);
  return cudaErrorInvalidValue;
}

int run(int which, int is_bf16, int tile, int head_dim, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(which, tile, head_dim, a)
              : dispatch<float>(which, tile, head_dim, a);
  return (int)err;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a tile / head dim not compiled here.  All
// tensors are contiguous (BH, S, D) (or (BH, S) for lse / delta); q, k, v,
// dout and the outputs share one type (f32, or bf16 when is_bf16).

int mx_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int is_bf16, int bh, int seq_q, int seq_k,
                 int head_dim, int causal, float scale, int tile,
                 void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
  a.bh = bh; a.seq_q = seq_q; a.seq_k = seq_k; a.causal = causal;
  a.scale = scale; a.stream = static_cast<cudaStream_t>(stream);
  return run(kFwd, is_bf16, tile, head_dim, a);
}

int mx_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int is_bf16, int bh, int seq_q,
                      int seq_k, int head_dim, int causal, float scale,
                      int tile, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.bh = bh; a.seq_q = seq_q; a.seq_k = seq_k; a.causal = causal;
  a.scale = scale; a.stream = static_cast<cudaStream_t>(stream);
  return run(kDkdv, is_bf16, tile, head_dim, a);
}

int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int is_bf16, int bh, int seq_q, int seq_k,
                    int head_dim, int causal, float scale, int tile,
                    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq;
  a.bh = bh; a.seq_q = seq_q; a.seq_k = seq_k; a.causal = causal;
  a.scale = scale; a.stream = static_cast<cudaStream_t>(stream);
  return run(kDq, is_bf16, tile, head_dim, a);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
