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
// all far above the card's bytes-to-flops balance point.  K1 has a
// second ceiling at D 64: one exponential a score, 134.3 M of them at
// the training shape, at 16 a clock an SM (the MUFU units) need ~0.032
// ms, as long as its 2F on the tensor cores (~0.035 ms).  Neither is
// reached unless the softmax of one tile runs while the tensor cores
// work on another.
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
// every product on the FMA units.  K1's p·v takes p rounded to bf16, as
// the reference does, so one pass forms it.
//
// Design:
//   * bf16 K1: wgmma, TMA and warp specialisation (sm_90a only).
//     - A persistent grid, one block an SM, walks the (bh, 128-row q
//       tile) items, the longest rows first, in a snake over the blocks.
//       A block is a producer warpgroup, which hands its registers to
//       the consumers (setmaxnreg 24 / 240), and two consumer warpgroups
//       of 64 query rows.
//     - One producer thread issues TMA loads: Q once an item (as soon as
//       the consumers' last S = Q·Kᵀ of the item before is done), K and V
//       through a ring of 128-key stages (3 at D 64, 2 at D 128), each
//       with a full and an empty mbarrier, in 128-byte swizzle.  The
//       tensor maps are 3-D (D, S, BH), so rows past seq_q / seq_k load
//       as zeros, never as the next head's rows; they are encoded per
//       call in mx_flash_fwd (cuTensorMapEncodeTiled, reached through
//       the runtime) and passed as __grid_constant__ parameters.
//     - S = Q·Kᵀ: wgmma m64n128k16, both operands K-major in shared
//       memory.  O += P·V: wgmma m64n64k16 a 64-column panel of D, A = p
//       from registers (the f32 accumulator re-packed in place as bf16
//       fragments), B = V read transposed from its key-major tile.
//     - Overlap inside each consumer: tile j's S is issued with tile
//       j-1's P·V behind it, so the softmax of tile j (FMNMX, one FFMA
//       and one ex2 a score) runs while P·V is on the tensor cores, and
//       the two consumers' softmaxes fill each other's waits.  (Ping-pong
//       on named barriers, which makes the consumers take turns, was
//       tried and was not faster on top of this overlap.)
//     - The softmax runs on the raw scores x: since scale > 0, max(x·
//       scale) = max(x)·scale exactly, so m is kept unscaled and p =
//       2^(x·c - m·c), c = scale·log2 e (one FFMA and ex2.approx); a
//       row's max reduces over the four lanes that hold it, its sum is
//       kept a lane and reduced once at the end.  The causal mask runs
//       only on tiles that cross a consumer's diagonal, the bounds mask
//       only on the ragged last tile; a fully masked row is impossible
//       (key 0 is always visible).
//     - Epilogue: O = acc · (1 / l) in bf16 through a swizzled staging
//       buffer and a TMA store (which drops rows past seq_q), LSE =
//       m·scale + log l in f32 for rows < seq_q.
//     - Left for later: an atomic work queue (the snake leaves ~3% of
//       imbalance), 192-row items at D 64 (three consumers spill at 160
//       registers), clusters with K / V multicast.
//   * bf16 K2 / K3: warp-level mma.sync.m16n8k16 (bf16 operands, f32
//     accumulators), one warp per 16 rows of the block's own tile, which
//     keeps those rows' A fragments and its f32 accumulators in
//     registers.  Tiles sit in shared-memory rows padded by 16 bytes,
//     which keeps fragment reads free of bank conflicts; a row-major
//     tile on the k side of a product is read through ldmatrix.trans.
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
//     no order, so each output tile is owned by one block that loops
//     inside itself: K1 and K3 over the k tiles up to the diagonal when
//     causal (the longest rows first), K2 one block per (bh, k tile) over
//     the q tiles from the diagonal down.  The split into K2 and K3
//     keeps the backward free of atomics and deterministic.
//   * K2, K3 and the f32 K1 take square TILE x TILE tiles (TILE 32 or
//     64); the bf16 K1 has its own (128 rows, 128 keys).  Ragged edges
//     are masked here, not padded by the caller: rows past seq_q / seq_k
//     load as zeros, their scores are masked and their outputs are not
//     stored.  The bf16 kernels apply the causal mask on the diagonal
//     tiles and the bounds on the last tile only.
//   * -1e30, not -inf, seeds m, as in the reference: exp(-inf - -inf) is
//     NaN.
//   * Head dims 64 and 128 are instantiated; anything else is refused.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <initializer_list>
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

// -------------------------------------- mma.sync helpers (K2 / K3) ----
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A registers
// hold rows g / g + 8 at columns 2t, 2t + 1 (+ 8 for registers 2, 3); B
// registers rows 2t, 2t + 1 (+ 8) of column g; C holds rows g / g + 8 at
// columns 2t, 2t + 1.

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

// ------------------------------------------- K1, bf16: wgmma + TMA ----
// A persistent block an SM: two consumer warpgroups (64 query rows each,
// 128 a work item) and one producer warpgroup.  Shared memory, 1024-byte
// aligned for the 128-byte swizzle: Q, then the O staging (each per
// consumer, per 64-column panel: 64 rows x 128 bytes), then STAGES
// stages of K and of V (per panel: 128 keys x 128 bytes), then the
// mbarriers.
namespace k1 {

constexpr int kKeys = 128;            // keys per stage
constexpr int kPanelQ = 64 * 128;     // bytes: 64 rows x 64 bf16
constexpr int kPanelKV = kKeys * 128; // bytes: 128 keys x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Layout {
  static constexpr int NC = 2;                     // consumer warpgroups
  static constexpr int ROWS = 64 * NC;             // query rows an item
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PREGS = 24, CREGS = 240;    // 24 + 2 x 240 = 3 x 168
  static constexpr int P = D / 64;                 // 64-column panels
  static constexpr int STAGES = D == 64 ? 3 : 2;   // fits 227 KB at D 128
  static constexpr int Q_BYTES = NC * P * kPanelQ; // and the O staging
  static constexpr int KV_BYTES = P * kPanelKV;    // one stage of K or V
  static constexpr int Q_OFF = 0;
  static constexpr int O_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BARS = 2 + 4 * STAGES;  // Q full / free, K/V full, empty
  static constexpr size_t SMEM = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrives on ``bar`` where ``pred`` holds: a predicated instruction, not
// a branch, so no divergent path sits between a wgmma and its wait.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((uint32_t)pred) : "memory");
}

// Waits for the phase of ``parity`` to complete.  (No timeout: a trap on
// this path makes ptxas drop setmaxnreg and spill the consumers.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// A box of the 3-D (D, S, BH) tensor map at {col, row, bh} into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(bh)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int row,
                                          int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col),
         "r"(row), "r"(bh)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO); ``lbo`` (bytes) is the distance
// between 64-element panels of an MN-major operand (unused when K-major).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving uses of an accumulator across a wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// d(64 x 128) (+)= A(64 x 16) · B(128 x 16)ᵀ, A and B K-major in shared
// memory (128-byte swizzle); d is zeroed first unless ``accumulate``.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64) += A(64 x 16, bf16 pairs in registers) · B(16 x 64), B
// MN-major in shared memory (128-byte swizzle, read transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online softmax of one (64 x kKeys) score tile held as a wgmma
// accumulator: thread (warp w, lane) holds rows r0 = 16w + lane / 4 and
// r0 + 8 (h = 0, 1) at columns 8j + 2(lane % 4) + e, in s[4j + 2h + e].
// It runs on the raw scores x = q·k: since scale > 0, the row max of
// x·scale is (max x)·scale exactly, so m is kept unscaled (masked keys:
// -1e30) and p = exp(x·scale - m·scale) = 2^(x·c - m·c), c = scale·log2 e,
// is one FFMA and one ex2.  m is reduced over the four lanes of a row;
// p is left in s; corr = 2^(m_old·c - m·c); l keeps this thread's share
// of the row sum (summed over the four lanes at the end: l only ever
// scales by corr, which the lanes share).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, int c2,
                                             int seq_k, int causal, float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row0 + 8 * h;
    float mt = m[h];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (MASK) {
          const int kpos = k0 + 8 * j + c2 + e;
          if (kpos >= seq_k || (causal && kpos > qpos)) x = kNegInf;
        }
        mt = fmaxf(mt, x);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mc = mt * c;
    corr[h] = ex2(fmaf(m[h], c, -mc));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = ex2(fmaf(x, c, -mc));
        sum += x;
      }
    l[h] = l[h] * corr[h] + sum;
    m[h] = mt;
  }
}

// Tile j of a consumer whose rows start at qw: the causal mask only on
// tiles that cross its diagonal, the bounds mask only on the ragged last
// tile.
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        int j, int qw, int row0, int c2,
                                        int seq_k, int causal, float c) {
  if ((j + 1) * kKeys > seq_k || (causal && (j + 1) * kKeys - 1 > qw))
    softmax_tile<true>(s, m, l, corr, j * kKeys, row0, c2, seq_k, causal, c);
  else
    softmax_tile<false>(s, m, l, corr, j * kKeys, row0, c2, seq_k, causal,
                        c);
}

// p (f32, in the accumulator layout) as bf16 A fragments of P·V, in
// place: keys 16t .. 16t + 15 are accumulator columns 8(2t) and 8(2t+1).
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int t = 0; t < kKeys / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
}

template <int P>
__device__ __forceinline__ void rescale(float (&o)[P][32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i >> 1) & 1];
}

// S = Q·Kᵀ for one consumer: D / 16 wgmma k-steps over Q's and K's
// panels, both K-major; a k-step advances the start address by 32 bytes
// inside the swizzled 128-byte rows.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_smem,
                                        uint32_t k_smem) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    wgmma_ss_n128(s, desc_sw128(q_smem + (ks / 4) * kPanelQ + off, 16),
                  desc_sw128(k_smem + (ks / 4) * kPanelKV + off, 16),
                  ks > 0);
  }
}

// O += P·V: A = p from registers, B = V read transposed (key-major in
// shared memory); one wgmma a 64-column panel of D and 16 keys.
template <int P>
__device__ __forceinline__ void issue_pv(float (&o)[P][32],
                                         const uint32_t (&pa)[kKeys / 16][4],
                                         uint32_t v_smem) {
#pragma unroll
  for (int t = 0; t < kKeys / 16; ++t)
#pragma unroll
    for (int p = 0; p < P; ++p)
      wgmma_rs_n64(o[p], pa[t],
                   desc_sw128(v_smem + p * kPanelKV + t * 16 * 128,
                              kPanelKV));
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, int bh_count, int seq_q,
                    int seq_k, int causal, float scale) {
  using L = Layout<D>;
  constexpr int P = L::P, STAGES = L::STAGES, NC = L::NC, ROWS = L::ROWS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::BAR_OFF;      // Q loaded
  const uint32_t bar_q_free = bar_q + 8;         // consumers done with Q
  auto full_k = [&](int s) { return bar_q + 8 * (2 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (2 + STAGES + s); };
  auto empty_k = [&](int s) { return bar_q + 8 * (2 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar_q + 8 * (2 + 3 * STAGES + s); };

  // Persistent: one block an SM walks the (q tile, head) items, longest
  // rows first, item i = the (nq - 1 - i / BH)-th q tile of head i % BH.
  // Round r gives block b item rG + b, or rG + G - 1 - b on odd rounds
  // (a snake: with the longest first, the blocks' sums stay within a few
  // percent); once past the end, every later round is too.
  const int nq = (seq_q + ROWS - 1) / ROWS;
  const int n_items = nq * bh_count;
  auto item_at = [&](int r) {
    return r * (int)gridDim.x +
           (r & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  auto tiles_of = [&](int q0) {
    const int k_end = causal ? min(seq_k, q0 + ROWS) : seq_k;
    return (k_end + kKeys - 1) / kKeys;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_free, NC * 4);               // one arrive per warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), NC * 4);
      mbar_init(empty_v(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread keeps the TMA loads in flight; the next
    // item's Q is loaded as soon as the consumers' last S = Q·Kᵀ of the
    // current one is done, and K / V run on through one ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(L::PREGS));
    if (threadIdx.x == NC * 128) {
      int t = 0;                                 // tiles through the ring
      for (int it = 0; item_at(it) < n_items; ++it) {
        const int item = item_at(it);
        const int q0 = (nq - 1 - item / bh_count) * ROWS;
        const int bh = item % bh_count;
        if (it > 0) mbar_wait(bar_q_free, (it - 1) & 1);
        mbar_expect_tx(bar_q, L::Q_BYTES);
        for (int w = 0; w < NC; ++w)
          for (int p = 0; p < P; ++p)
            tma_load(base + L::Q_OFF + (w * P + p) * kPanelQ, &tm_q, bar_q,
                     64 * p, q0 + 64 * w, bh);
        const int n_tiles = tiles_of(q0);
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          const uint32_t phase = (t / STAGES) & 1;
          const uint32_t ks = base + L::K_OFF + s * L::KV_BYTES;
          const uint32_t vs = base + L::V_OFF + s * L::KV_BYTES;
          if (t >= STAGES) mbar_wait(empty_k(s), phase ^ 1);
          mbar_expect_tx(full_k(s), L::KV_BYTES);
          for (int p = 0; p < P; ++p)
            tma_load(ks + p * kPanelKV, &tm_k, full_k(s), 64 * p,
                     j * kKeys, bh);
          if (t >= STAGES) mbar_wait(empty_v(s), phase ^ 1);
          mbar_expect_tx(full_v(s), L::KV_BYTES);
          for (int p = 0; p < P; ++p)
            tma_load(vs + p * kPanelKV, &tm_v, full_v(s), 64 * p,
                     j * kKeys, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::CREGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const uint32_t q_smem = base + L::Q_OFF + wg * P * kPanelQ;
    const uint32_t o_smem = base + L::O_OFF + wg * P * kPanelQ;
    const float c = scale * kLog2e;
    auto k_smem = [&](int t) {
      return base + L::K_OFF + (t % STAGES) * L::KV_BYTES;
    };
    auto v_smem = [&](int t) {
      return base + L::V_OFF + (t % STAGES) * L::KV_BYTES;
    };
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };
    int t = 0;                                   // tiles through the ring
    for (int it = 0; item_at(it) < n_items; ++it) {
      const int item = item_at(it);
      const int q0 = (nq - 1 - item / bh_count) * ROWS;
      const int bh = item % bh_count;
      const int qw = q0 + 64 * wg;                   // this consumer's rows
      const int row0 = qw + 16 * warp + lane / 4;    // and row0 + 8
      const int n_tiles = tiles_of(q0);
      float o[P][32], s[64], m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f}, corr[2];
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = 0.f;

      mbar_wait(bar_q, it & 1);
      mbar_wait(full_k(t % STAGES), (t / STAGES) & 1);
      wgmma_fence();
      issue_s<D>(s, q_smem, k_smem(t));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(t % STAGES));
      if (n_tiles == 1) release(bar_q_free);
      softmax(s, m, l, corr, 0, qw, row0, c2, seq_k, causal, c);
      pack_p(s, pa);
      // Inside a consumer, tile j's S = Q·Kᵀ is issued with tile j-1's
      // P·V behind it: the softmax of tile j runs while P·V of tile j-1
      // is on the tensor cores.
      for (int j = 1; j < n_tiles; ++j) {
        const int tj = t + j;
        mbar_wait(full_k(tj % STAGES), (tj / STAGES) & 1);
        mbar_wait(full_v((tj - 1) % STAGES), ((tj - 1) / STAGES) & 1);
        rescale(o, corr);                   // to tile j-1's running max
        wgmma_fence();
        issue_s<D>(s, q_smem, k_smem(tj));
        wgmma_commit();
        issue_pv(o, pa, v_smem(tj - 1));
        wgmma_commit();
        wgmma_wait<1>();                    // S of tile j is in
        fence_regs(s);
        release(empty_k(tj % STAGES));
        if (j == n_tiles - 1) release(bar_q_free);
        softmax(s, m, l, corr, j, qw, row0, c2, seq_k, causal, c);
        wgmma_wait<0>();                    // P·V of tile j-1 is in
#pragma unroll
        for (int p = 0; p < P; ++p) fence_regs(o[p]);
        release(empty_v((tj - 1) % STAGES));
        pack_p(s, pa);
      }
      const int tl = t + n_tiles - 1;
      mbar_wait(full_v(tl % STAGES), (tl / STAGES) & 1);
      rescale(o, corr);
      wgmma_fence();
      issue_pv(o, pa, v_smem(tl));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) fence_regs(o[p]);
      release(empty_v(tl % STAGES));
      t += n_tiles;

      // ---- epilogue: O = acc / l in bf16 through this consumer's O
      // panels (swizzled as the tensor map expects; the last item's store
      // must have read them) and a TMA store, which drops rows past
      // seq_q; LSE = m·scale + log l in f32 for rows < seq_q ----
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        if (l[h] == 0.f) l[h] = 1.f;
        inv[h] = 1.f / l[h];
      }
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + lane / 4 + 8 * h;  // row in the panel
            const uint32_t at = o_smem + p * kPanelQ + r * 128 +
                                ((j ^ (r & 7)) << 4) + c2 * 2;
            const uint32_t v = pack_bf16(o[p][4 * j + 2 * h] * inv[h],
                                         o[p][4 * j + 2 * h + 1] * inv[h]);
            asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(at), "r"(v)
                         : "memory");
          }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg);
      if (tid == 0 && qw < seq_q) {
        for (int p = 0; p < P; ++p)
          tma_store(&tm_o, o_smem + p * kPanelQ, 64 * p, qw, bh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < seq_q)
            lse[(size_t)bh * seq_q + row0 + 8 * h] =
                __fmul_rn(m[h], scale) + logf(l[h]);
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library links no more than the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (BH, S, D) bf16 as a 3-D map (D, S, BH): boxes of 64 columns x ``rows``
// rows of one head; rows past S read as zeros (and are not written), never
// as the next head's.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int bh,
            int seq, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace k1

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

// The bf16 K1 has its own tiling (128 query rows, 128 keys a stage), so
// ``tile`` does not reach it; its tensor maps are encoded here, per call.
template <int D>
cudaError_t launch_fwd_wgmma(const Args& a) {
  for (const void* ptr : {a.q, a.k, a.v, static_cast<const void*>(a.out)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return cudaErrorMisalignedAddress;
  const k1::EncodeTiled fn = k1::encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!k1::encode(fn, &tq, a.q, a.bh, a.seq_q, D, 64) ||
      !k1::encode(fn, &tk, a.k, a.bh, a.seq_k, D, k1::kKeys) ||
      !k1::encode(fn, &tv, a.v, a.bh, a.seq_k, D, k1::kKeys) ||
      !k1::encode(fn, &to, a.out, a.bh, a.seq_q, D, 64))
    return cudaErrorInvalidValue;
  constexpr size_t smem = k1::Layout<D>::SMEM;
  auto kernel = k1::fa_fwd_wgmma_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  using L = k1::Layout<D>;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int items = (a.seq_q + L::ROWS - 1) / L::ROWS * a.bh;
  kernel<<<items < sms ? items : sms, L::THREADS, smem, a.stream>>>(
      tq, tk, tv, to, static_cast<float*>(a.lse_out), a.bh, a.seq_q,
      a.seq_k, a.causal, a.scale);
  return cudaGetLastError();
}

template <int TILE, int D, typename T>
cudaError_t launch_fwd(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_fwd_wgmma<D>(a);
  } else {
    const dim3 grid((a.seq_q + TILE - 1) / TILE, a.bh);
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
