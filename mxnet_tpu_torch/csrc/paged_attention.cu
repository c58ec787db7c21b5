// Paged decode attention for Hopper (sm_90a): one query token per slot
// attends over its KV history, which lives in fixed-size pages of a
// shared pool reached through the slot's page table.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py `_pa_kernel`
// (reached through `_paged_attention_pallas`).
//
// What bounds it on an H100: bytes.  Each live key costs 2*D*4 bytes of
// K and V (fp32 pool) against 4*D flops, far below the card's ~20
// flops/byte fp32 balance point, so the only aim is to stream the live
// pages at memory rate and touch nothing else.
//
// Design (simple first; a split-K pass over long contexts is later work):
//   * one block per (head, slot); NW warps; the block loads its own page
//     table row into shared memory (no scalar prefetch on a GPU);
//   * the TPU kernel carried acc/m/l across its sequential (page, block_k)
//     grid axes; here that carry is a loop inside the block.  Keys are
//     dealt to the warps round-robin, KPW keys per warp per step and U
//     steps per iteration, so each thread has U*2 K and U*2 V 16-byte
//     loads in flight before it computes;
//   * a key's dot product is split over D/8 lanes (8 floats each,
//     two float4 loads) and reduced with warp shuffles; each warp keeps
//     an online softmax with f32 m / l / acc;
//   * the loop stops at the slot's length: keys and pages past it are
//     never read (table entries past a slot's pages are 0, a valid page
//     id, and must not be read as context);
//   * warps merge (m, l, acc) through shared memory at the end;
//   * -1e30, not -inf, seeds m: exp(-inf - -inf) is NaN, and the
//     l == 0 -> 1 guard is what makes a length-0 slot exact zeros.
// q may be fp32 or bf16 (the engine's pool is fp32); the output has q's
// type.  Pools must be contiguous (num_pages, page_size, H, D); the
// wrapper passes the pointer of the layer's view, offset included.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kVec = 8;      // floats per lane per key row
constexpr int kUnroll = 4;   // key steps in flight per iteration

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void load8(const float* p, float* r) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

template <int D, int NW, typename QT>
__global__ void __launch_bounds__(NW * kWarp)
paged_attention_kernel(const QT* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       QT* __restrict__ out,
                       int heads, int page_size, int pages_per_slot,
                       float sm_scale) {
  constexpr int LPK = D / kVec;          // lanes per key
  constexpr int KPW = kWarp / LPK;       // keys per warp per step
  constexpr int STEP = NW * KPW;         // keys per block per step
  __shared__ float s_acc[NW][D];
  __shared__ float s_m[NW];
  __shared__ float s_l[NW];
  extern __shared__ int s_table[];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / LPK;              // which key of the warp's step
  const int j = lane % LPK;              // which 8-float chunk of D

  int length = lengths[s];
  const int cap = pages_per_slot * page_size;
  length = length < 0 ? 0 : (length > cap ? cap : length);
  const int n_pages = (length + page_size - 1) / page_size;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x)
    s_table[i] = tables[(size_t)s * pages_per_slot + i];
  __syncthreads();

  float qv[kVec];
  const QT* qrow = q + ((size_t)s * heads + h) * D + j * kVec;
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] = to_f32(qrow[i]) * sm_scale;

  const size_t row_stride = (size_t)heads * D;   // one key of a page
  const size_t head_off = (size_t)h * D + j * kVec;
  float m = kNegInf, l = 0.f, acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  for (int base = warp * KPW; base < length; base += STEP * kUnroll) {
    float kr[kUnroll][kVec], vr[kUnroll][kVec];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * STEP + g;
      valid[u] = t < length;
      if (valid[u]) {
        const size_t row =
            (size_t)s_table[t / page_size] * page_size + t % page_size;
        load8(k_pool + row * row_stride + head_off, kr[u]);
        load8(v_pool + row * row_stride + head_off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float sc[kUnroll];
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[i], kr[u][i], dot);
#pragma unroll
      for (int off = LPK / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[u] = valid[u] ? dot : kNegInf;
      tile_max = fmaxf(tile_max, sc[u]);
    }
#pragma unroll
    for (int off = LPK; off < kWarp; off *= 2)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = valid[u] ? expf(sc[u] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vr[u][i], acc[i]);
    }
    // psum is replicated over a key's LPK lanes: sum one per key group
#pragma unroll
    for (int off = LPK; off < kWarp; off *= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
  }

  // fold the warp's key groups (same chunk j, different g) together
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int off = LPK; off < kWarp; off *= 2)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) s_acc[warp][j * kVec + i] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(s_m[w] - mx);
      lsum += c * s_l[w];
      o += c * s_acc[w][d];
    }
    if (lsum == 0.f) lsum = 1.f;
    from_f32(o / lsum, out + ((size_t)s * heads + h) * D + d);
  }
}

template <int D, int NW, typename QT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out,
                   int slots, int heads, int page_size, int pages_per_slot,
                   float sm_scale, cudaStream_t stream) {
  const dim3 grid(heads, slots);
  const size_t smem = (size_t)pages_per_slot * sizeof(int);
  paged_attention_kernel<D, NW, QT><<<grid, NW * kWarp, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), heads,
      page_size, pages_per_slot, sm_scale);
  return cudaGetLastError();
}

template <int D, typename QT>
cudaError_t dispatch_warps(int warps, const void* q, const void* k,
                           const void* v, const void* t, const void* len,
                           void* o, int slots, int heads, int ps, int pps,
                           float scale, cudaStream_t st) {
  switch (warps) {
    case 4: return launch<D, 4, QT>(q, k, v, t, len, o, slots, heads, ps,
                                    pps, scale, st);
    case 8: return launch<D, 8, QT>(q, k, v, t, len, o, slots, heads, ps,
                                    pps, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_dim(int head_dim, int warps, const void* q,
                         const void* k, const void* v, const void* t,
                         const void* len, void* o, int slots, int heads,
                         int ps, int pps, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 64: return dispatch_warps<64, QT>(warps, q, k, v, t, len, o, slots,
                                           heads, ps, pps, scale, st);
    case 128: return dispatch_warps<128, QT>(warps, q, k, v, t, len, o,
                                             slots, heads, ps, pps, scale,
                                             st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim / warp count not compiled here.
int mx_paged_attention(const void* q, int q_is_bf16, const void* k_pool,
                       const void* v_pool, const void* tables,
                       const void* lengths, void* out, int slots, int heads,
                       int head_dim, int page_size, int pages_per_slot,
                       float sm_scale, int warps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return dispatch_dim<__nv_bfloat16>(head_dim, warps, q, k_pool, v_pool,
                                       tables, lengths, out, slots, heads,
                                       page_size, pages_per_slot, sm_scale,
                                       st);
  return dispatch_dim<float>(head_dim, warps, q, k_pool, v_pool, tables,
                             lengths, out, slots, heads, page_size,
                             pages_per_slot, sm_scale, st);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
