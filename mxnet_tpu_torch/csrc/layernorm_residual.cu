// Fused LayerNorm(x + residual) over the last axis for Hopper (sm_90a):
// out = (y - mean(y)) * rsqrt(var(y) + eps) * gamma + beta, y = x + r,
// with the statistics in f32 and the output in x's type.
//
// Replaces the TPU kernel mxnet_tpu/ops/layernorm_residual.py `_lnr_kernel`
// (reached through `_lnr_pallas`).
//
// What bounds it on an H100: bytes.  Per element it reads x and r and
// writes out (3 x 2 bytes in bf16) against about ten flops, far below the
// card's balance point, so the aim is to move each byte once at memory
// rate: the residual sum never goes back to memory, and the row is read
// once.
//
// Design (simple first):
//   * F <= 1024: one warp per row, the row held in registers.  A lane
//     owns chunks of 8 consecutive elements (chunk c = lane + 32 k), so
//     one warp instruction reads 32 x 16 contiguous bytes of a bf16 row
//     (two float4 loads a chunk in f32).  CPL = chunks per lane (1, 2, 4
//     for F up to 256, 512, 1024) is a template parameter, so the row
//     lives in CPL * 8 registers.  Vector loads need F % 8 == 0 and
//     16-byte aligned pointers; otherwise every element is loaded alone
//     and checked against F (the scalar tail).
//   * The mean is a warp-shuffle sum; the variance is then the mean of
//     squared deviations taken from the registers -- two passes over the
//     registers and one over memory, with the numerics of the reference
//     (_lnr_reference), not E[y^2] - mean^2.
//   * Several rows (warps) per block is the tunable config (2..16); the
//     rows of the last block past the end are masked (their warps
//     return), where the TPU version padded the rows with jnp.pad.
//   * F > 1024: one block of 256 threads per row, looping over the row
//     three times (sum, squared deviations, output); the re-reads of a row
//     come from L1/L2.
//   * x and r may each be f32, bf16 or f16 (the reference casts each to
//     f32 on its own); gamma and beta arrive as f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 8;           // elements of a lane's chunk
constexpr int kMaxWarpF = kWarp * kChunk * 4;
constexpr int kRowThreads = 256;    // block-per-row path

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// 8 consecutive elements at a 16-byte aligned p, as f32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 16-bit types travel as their bits (unsigned short) through one 16-byte
// load or store.
__device__ __forceinline__ float bits_to_f32(unsigned short u,
                                             const __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ float bits_to_f32(unsigned short u,
                                             const __half*) {
  return __half2float(__ushort_as_half(u));
}
__device__ __forceinline__ unsigned short f32_to_bits(float v,
                                                      const __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ unsigned short f32_to_bits(float v,
                                                      const __half*) {
  return __half_as_ushort(__float2half(v));
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  union { uint4 raw; unsigned short h[kChunk]; } u;
  u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int i = 0; i < kChunk; ++i) v[i] = bits_to_f32(u.h[i], p);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  union { uint4 raw; unsigned short h[kChunk]; } u;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) u.h[i] = f32_to_bits(v[i], p);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

// The first n (may be <= 0) of 8 elements at p, zeros after them.
template <typename T>
__device__ __forceinline__ void load8_tail(const T* p, int n, float* v) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store8_tail(T* p, int n, const float* v) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (i < n) p[i] = from_f32<T>(v[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename XT, typename RT, int CPL, bool VEC>
__global__ void __launch_bounds__(16 * kWarp)
lnr_warp_rows(const XT* __restrict__ x, const RT* __restrict__ r,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, XT* __restrict__ out,
              int rows, int f, float eps) {
  const int row = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the last block's rows past the end
  const size_t base = static_cast<size_t>(row) * f;
  const XT* xr = x + base;
  const RT* rr = r + base;
  float v[CPL][kChunk];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (c * kWarp + lane) * kChunk;
    float a[kChunk], b[kChunk];
    if constexpr (VEC) {
      if (col < f) {
        load8(xr + col, a);
        load8(rr + col, b);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) a[i] = b[i] = 0.f;
      }
    } else {
      load8_tail(xr + col, f - col, a);
      load8_tail(rr + col, f - col, b);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[c][i] = a[i] + b[i];
      sum += v[c][i];
    }
  }
  const float mean = warp_sum(sum) / f;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (c * kWarp + lane) * kChunk;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float d = v[c][i] - mean;
      if (col + i < f) sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / f + eps);
  XT* orow = out + base;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (c * kWarp + lane) * kChunk;
    if (col >= f) continue;
    float g[kChunk], bt[kChunk], o[kChunk];
    if constexpr (VEC) {
      load8(gamma + col, g);
      load8(beta + col, bt);
    } else {
      load8_tail(gamma + col, f - col, g);
      load8_tail(beta + col, f - col, bt);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      o[i] = (v[c][i] - mean) * rstd * g[i] + bt[i];
    if constexpr (VEC) {
      store8(orow + col, o);
    } else {
      store8_tail(orow + col, f - col, o);
    }
  }
}

// Sum over the block; sh holds kWarp + 1 floats.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with sh
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / kWarp) ? sh[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) sh[kWarp] = v;
  }
  __syncthreads();
  return sh[kWarp];
}

template <typename XT, typename RT>
__global__ void __launch_bounds__(kRowThreads)
lnr_block_row(const XT* __restrict__ x, const RT* __restrict__ r,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, XT* __restrict__ out, int f,
              float eps) {
  __shared__ float sh[kWarp + 1];
  const size_t base = static_cast<size_t>(blockIdx.x) * f;
  const XT* xr = x + base;
  const RT* rr = r + base;
  float s = 0.f;
  for (int i = threadIdx.x; i < f; i += blockDim.x)
    s += to_f32(xr[i]) + to_f32(rr[i]);
  const float mean = block_sum(s, sh) / f;
  float q = 0.f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const float d = to_f32(xr[i]) + to_f32(rr[i]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, sh) / f + eps);
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const float y = to_f32(xr[i]) + to_f32(rr[i]);
    out[base + i] = from_f32<XT>((y - mean) * rstd * gamma[i] + beta[i]);
  }
}

template <typename XT, typename RT, int CPL>
cudaError_t launch_warp(bool vec, int rows, int rows_per_block,
                        const XT* x, const RT* r, const float* g,
                        const float* b, XT* o, int f, float eps,
                        cudaStream_t st) {
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  const dim3 block(rows_per_block * kWarp);
  if (vec)
    lnr_warp_rows<XT, RT, CPL, true><<<grid, block, 0, st>>>(
        x, r, g, b, o, rows, f, eps);
  else
    lnr_warp_rows<XT, RT, CPL, false><<<grid, block, 0, st>>>(
        x, r, g, b, o, rows, f, eps);
  return cudaGetLastError();
}

template <typename XT, typename RT>
cudaError_t launch_typed(const void* xv, const void* rv, const float* g,
                         const float* b, void* ov, int rows, int f,
                         float eps, int rows_per_block, cudaStream_t st) {
  const XT* x = static_cast<const XT*>(xv);
  const RT* r = static_cast<const RT*>(rv);
  XT* o = static_cast<XT*>(ov);
  if (f > kMaxWarpF) {
    lnr_block_row<XT, RT><<<rows, kRowThreads, 0, st>>>(x, r, g, b, o, f,
                                                       eps);
    return cudaGetLastError();
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xv) |
                         reinterpret_cast<uintptr_t>(rv) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(ov);
  const bool vec = f % kChunk == 0 && addr % 16 == 0;
  if (f <= kWarp * kChunk)
    return launch_warp<XT, RT, 1>(vec, rows, rows_per_block, x, r, g, b, o,
                                  f, eps, st);
  if (f <= 2 * kWarp * kChunk)
    return launch_warp<XT, RT, 2>(vec, rows, rows_per_block, x, r, g, b, o,
                                  f, eps, st);
  return launch_warp<XT, RT, 4>(vec, rows, rows_per_block, x, r, g, b, o, f,
                                eps, st);
}

template <typename XT>
cudaError_t dispatch_r(int r_dtype, const void* x, const void* r,
                       const float* g, const float* b, void* o, int rows,
                       int f, float eps, int rpb, cudaStream_t st) {
  switch (r_dtype) {
    case 0: return launch_typed<XT, float>(x, r, g, b, o, rows, f, eps, rpb,
                                           st);
    case 1: return launch_typed<XT, __nv_bfloat16>(x, r, g, b, o, rows, f,
                                                   eps, rpb, st);
    case 2: return launch_typed<XT, __half>(x, r, g, b, o, rows, f, eps,
                                            rpb, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 float16; out has x's type.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an argument the kernels do not take.
int mx_layer_norm_residual(const void* x, int x_dtype, const void* r,
                           int r_dtype, const void* gamma, const void* beta,
                           void* out, int rows, int f, float eps,
                           int rows_per_block, void* stream) {
  if (rows <= 0 || f <= 0 || rows_per_block < 1 || rows_per_block > 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  switch (x_dtype) {
    case 0: return dispatch_r<float>(r_dtype, x, r, g, b, out, rows, f, eps,
                                     rows_per_block, st);
    case 1: return dispatch_r<__nv_bfloat16>(r_dtype, x, r, g, b, out, rows,
                                             f, eps, rows_per_block, st);
    case 2: return dispatch_r<__half>(r_dtype, x, r, g, b, out, rows, f, eps,
                                      rows_per_block, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
