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
// Design (flash-decoding: each slot's keys split across the SMs):
//   * a block per (head, slot, partition): a partition is PART keys, a
//     multiple of the page size, so it starts on a page boundary.  One
//     block per (head, slot) left the kernel as long as the longest slot
//     (~1000 keys) while the short slots' blocks sat idle, on 64 of the
//     card's 132 SMs; split, the live keys spread over every SM.
//   * the grid comes from pages_per_slot, never from the lengths (they
//     live on the device and are not read back): a block whose
//     partition starts at or past its slot's length exits at once;
//   * the block loads its partition's page-table entries into shared
//     memory (no scalar prefetch on a GPU).  The TPU kernel carried
//     acc/m/l across its sequential (page, block_k) grid axes; here that
//     carry is a loop inside the block.  Keys are dealt to the warps
//     round-robin, KPW keys per warp per step and U steps per iteration,
//     so each thread has U*2 K and U*2 V 16-byte loads in flight before
//     it computes;
//   * a key's dot product is split over D/8 lanes (8 floats each, two
//     float4 loads) and reduced with warp shuffles; each warp keeps an
//     online softmax with f32 m / l / acc, and the warps merge (m, l,
//     acc) through shared memory at the end;
//   * a slot that fits in one partition writes its output directly.
//     Otherwise each block writes its partial (acc[D], m, l) to a scratch
//     buffer, fences, and counts itself on the (head, slot)'s counter;
//     the block that counts last merges the partials in partition order
//     (the same sums in the same order on every run: bitwise-repeatable)
//     and sets the counter back to 0 for the next launch.  One launch,
//     no second pass; the wrapper zeroes the counters once, when it makes
//     the scratch buffer;
//   * the loop stops at the slot's length: keys and pages past it are
//     never read (table entries past a slot's pages are 0, a valid page
//     id, and must not be read as context);
//   * -1e30, not -inf, seeds m: exp(-inf - -inf) is NaN, and the
//     l == 0 -> 1 guard is what makes a length-0 slot exact zeros.
// q may be fp32 or bf16 (the engine's pool is fp32); the output has q's
// type.  Pools must be contiguous (num_pages, page_size, H, D); the
// wrapper passes the pointer of the layer's view, offset included.  Two
// launches that share a scratch buffer must run in stream order.
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
                       QT* __restrict__ out, float* __restrict__ partials,
                       int* __restrict__ counters,
                       int heads, int page_size, int pages_per_slot,
                       int part_keys, float sm_scale) {
  constexpr int LPK = D / kVec;          // lanes per key
  constexpr int KPW = kWarp / LPK;       // keys per warp per step
  constexpr int STEP = NW * KPW;         // keys per block per step
  __shared__ float s_acc[NW][D];
  __shared__ float s_m[NW];
  __shared__ float s_l[NW];
  __shared__ int s_last;
  extern __shared__ int s_table[];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int part = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / LPK;              // which key of the warp's step
  const int j = lane % LPK;              // which 8-float chunk of D

  // the slot's length, the partition's table entries and q are read
  // together: one memory latency before the keys, not three (entries past
  // the length are valid page ids, read but never used)
  const int k_begin = part * part_keys;
  const int page0 = k_begin / page_size;
  const int n_pages = min(part_keys / page_size, pages_per_slot - page0);
  int length = lengths[s];
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x)
    s_table[i] = tables[(size_t)s * pages_per_slot + page0 + i];
  float qv[kVec];
  const QT* qrow = q + ((size_t)s * heads + h) * D + j * kVec;
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] = to_f32(qrow[i]) * sm_scale;
  const int cap = pages_per_slot * page_size;
  length = length < 0 ? 0 : (length > cap ? cap : length);
  const int n_live = length > part_keys ? (length + part_keys - 1) / part_keys
                                        : 1;
  if (part >= n_live) return;            // (uniform: before any barrier)
  const int k_end = min(length, k_begin + part_keys);
  __syncthreads();

  const size_t row_stride = (size_t)heads * D;   // one key of a page
  const size_t head_off = (size_t)h * D + j * kVec;
  float m = kNegInf, l = 0.f, acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  for (int base = k_begin + warp * KPW; base < k_end;
       base += STEP * kUnroll) {
    float kr[kUnroll][kVec], vr[kUnroll][kVec];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * STEP + g;
      valid[u] = t < k_end;
      if (valid[u]) {
        const size_t row =
            (size_t)s_table[t / page_size - page0] * page_size +
            t % page_size;
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

  // the block's (m, l, acc[d]) over its warps
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w]);
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) lsum += expf(s_m[w] - mx) * s_l[w];
  QT* orow = out + ((size_t)s * heads + h) * D;
  if (n_live == 1) {                     // the whole slot: write it out
    const float li = lsum == 0.f ? 1.f : lsum;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) o += expf(s_m[w] - mx) * s_acc[w][d];
      from_f32(o / li, orow + d);
    }
    return;
  }
  const int n_parts = gridDim.z;
  float* mine = partials +
                (((size_t)s * heads + h) * n_parts + part) * (D + 2);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) o += expf(s_m[w] - mx) * s_acc[w][d];
    mine[d] = o;
  }
  if (threadIdx.x == 0) {
    mine[D] = mx;
    mine[D + 1] = lsum;
  }
  __threadfence();                       // partials visible before counting
  __syncthreads();
  int* counter = counters + (size_t)s * heads + h;
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of (head, slot): merge the partials in partition order
  const float* all = partials + ((size_t)s * heads + h) * n_parts * (D + 2);
  float big = kNegInf;
  for (int p = 0; p < n_live; ++p)
    big = fmaxf(big, __ldcg(all + (size_t)p * (D + 2) + D));
  float lt = 0.f;
  for (int p = 0; p < n_live; ++p) {
    const float* pp = all + (size_t)p * (D + 2);
    lt += expf(__ldcg(pp + D) - big) * __ldcg(pp + D + 1);
  }
  const float li = lt == 0.f ? 1.f : lt;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int p = 0; p < n_live; ++p) {
      const float* pp = all + (size_t)p * (D + 2);
      o += expf(__ldcg(pp + D) - big) * __ldcg(pp + d);
    }
    from_f32(o / li, orow + d);
  }
  if (threadIdx.x == 0) *counter = 0;    // ready for the next launch
}

struct Call {
  const void *q, *k, *v, *tables, *lengths;
  void *out, *partials, *counters;
  int slots, heads, page_size, pages_per_slot, part_keys;
  float scale;
  cudaStream_t stream;
};

template <int D, int NW, typename QT>
cudaError_t launch(const Call& c) {
  const int n_parts =
      (c.pages_per_slot * c.page_size + c.part_keys - 1) / c.part_keys;
  const dim3 grid(c.heads, c.slots, n_parts);
  const size_t smem = (size_t)(c.part_keys / c.page_size) * sizeof(int);
  paged_attention_kernel<D, NW, QT><<<grid, NW * kWarp, smem, c.stream>>>(
      static_cast<const QT*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const int*>(c.tables),
      static_cast<const int*>(c.lengths), static_cast<QT*>(c.out),
      static_cast<float*>(c.partials), static_cast<int*>(c.counters),
      c.heads, c.page_size, c.pages_per_slot, c.part_keys, c.scale);
  return cudaGetLastError();
}

template <int D, typename QT>
cudaError_t dispatch_warps(int warps, const Call& c) {
  switch (warps) {
    case 4: return launch<D, 4, QT>(c);
    case 8: return launch<D, 8, QT>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_dim(int head_dim, int warps, const Call& c) {
  switch (head_dim) {
    case 64: return dispatch_warps<64, QT>(warps, c);
    case 128: return dispatch_warps<128, QT>(warps, c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim / warp count not compiled here or
// a partition that is not a positive multiple of the page size.
// ``partials`` holds slots * heads * ceil(pages_per_slot * page_size /
// part_keys) * (head_dim + 2) floats; ``counters`` slots * heads ints,
// zero before the first launch (each launch leaves them zero).
int mx_paged_attention(const void* q, int q_is_bf16, const void* k_pool,
                       const void* v_pool, const void* tables,
                       const void* lengths, void* out, void* partials,
                       void* counters, int slots, int heads, int head_dim,
                       int page_size, int pages_per_slot, int part_keys,
                       float sm_scale, int warps, void* stream) {
  if (page_size <= 0 || part_keys <= 0 || part_keys % page_size)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k_pool, v_pool, tables, lengths, out, partials, counters,
               slots, heads, page_size, pages_per_slot, part_keys,
               sm_scale, static_cast<cudaStream_t>(stream)};
  if (q_is_bf16) return dispatch_dim<__nv_bfloat16>(head_dim, warps, c);
  return dispatch_dim<float>(head_dim, warps, c);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
