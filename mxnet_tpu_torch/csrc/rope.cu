// Rotary position embedding (RoPE, NeoX half split) for Hopper (sm_90a):
// for each head vector x (D values) at integer position p, the pairs
// (x[i], x[i + D/2]) rotate by the angle p * base^(-2i/D):
//
//     out[i]       = x[i] * cos - x[i + D/2] * sin
//     out[i + D/2] = x[i + D/2] * cos + x[i] * sin
//
// Replaces the TPU kernel mxnet_tpu/ops/rope.py:63 `_rope_kernel`
// (called through `_rope_pallas`, :92).  It computes what the plain
// version `rope_reference` (mxnet_tpu_torch/ops/rope.py) computes; it is
// not a copy of the Pallas body, whose row blocks and lane-broadcast
// positions were tiling for the TPU.
//
// What bounds it on an H100: bytes, and at the decode shapes the launch
// itself.  Each element is read once and written once (a q or k of 8
// slots x 8 heads x 64 is 16 KB each way in fp32) against a few flops
// and one sincos per pair, so the kernel body takes well under a
// microsecond and what a caller waits on is the launch.  The design
// therefore keeps the host side to one C call with no allocation and no
// synchronisation, and lets one launch rotate both q and k.
//
// Design:
//   * one entry, mx_rope, rotates one or two tensors (x0 -> out0 and
//     optionally x1 -> out1) of one shape (R, H, D), contiguous, sharing
//     one positions vector (R,) of int32 or int64; blockIdx.y selects the
//     tensor;
//   * each block first computes the D/2 inverse frequencies
//     expf(k * neg_log_base_half) into shared memory, once;
//   * each thread takes P consecutive pairs of one head vector.  Where
//     D/2 is a multiple of P and every pointer is aligned to P elements,
//     it reads P values from each half as one vector (16 bytes for P = 4
//     in fp32 or P = 8 in bf16 / fp16) and writes them the same way; else
//     the kernel's scalar variant walks the same P pairs one element at
//     a time (pairs may then straddle two head vectors);
//   * the decode shape (R 8, H 8, D 64: 2048 pairs a tensor) is one small
//     wave of 8 blocks of 128 threads for q and k together.
//
// Numerics (the plain version's rounding, step by step):
//   * the inverse frequency is expf of one rounded f32 product, the angle
//     one rounded f32 product (float)pos * inv; (float) of an int64
//     rounds to nearest, as torch's .float() does;
//   * expf and sincosf are the accurate library functions (no fast-math
//     forms: positions run to 4095, where __sinf / __cosf lose every
//     digit);
//   * x1*cos - x2*sin and x2*cos + x1*sin round each product and then the
//     sum (__fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting
//     them into FMAs), as the plain version's separate torch ops do;
//   * bf16 / fp16 are loaded to f32 and stored with round-to-nearest
//     (__float2bfloat16_rn / __float2half_rn), as .to(dtype) does.
// So on the card the kernel gives the plain version's bits wherever
// sincosf agrees with torch's separate sinf / cosf.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// P values of one half of a head vector, moved as one aligned access.
template <typename T, int P>
struct alignas(sizeof(T) * P) Pack {
  T v[P];
};

struct RopeArgs {
  const void* x[2];
  void* out[2];
  const void* positions;
  long long n_pairs;      // R * H * half, per tensor
  int heads;
  int half;
  float neg_log_base_half;
};

// Rotate one pair in f32 with the plain version's roundings.
__device__ __forceinline__ void rotate(float x1, float x2, float ang,
                                       float* o1, float* o2) {
  float s, c;
  sincosf(ang, &s, &c);
  *o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  *o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

template <typename T, typename PosT, int P, bool VEC>
__global__ void rope_kernel(RopeArgs a) {
  extern __shared__ float inv_freq[];
  const int half = a.half;
  for (int k = threadIdx.x; k < half; k += blockDim.x)
    inv_freq[k] =
        expf(__fmul_rn(static_cast<float>(k), a.neg_log_base_half));
  __syncthreads();

  // a select, not an index: a parameter array indexed at run time would
  // be copied to local memory
  const T* __restrict__ x =
      static_cast<const T*>(blockIdx.y ? a.x[1] : a.x[0]);
  T* __restrict__ out = static_cast<T*>(blockIdx.y ? a.out[1] : a.out[0]);
  const PosT* __restrict__ pos = static_cast<const PosT*>(a.positions);
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * P;
  if (j0 >= a.n_pairs) return;

  if constexpr (VEC) {
    // half % P == 0: the P pairs lie in one head vector
    const long long vec = j0 / half;
    const int k0 = static_cast<int>(j0 - vec * half);
    const float p = static_cast<float>(__ldg(pos + vec / a.heads));
    const long long base = vec * 2 * half + k0;
    const Pack<T, P> lo = *reinterpret_cast<const Pack<T, P>*>(x + base);
    const Pack<T, P> hi =
        *reinterpret_cast<const Pack<T, P>*>(x + base + half);
    Pack<T, P> olo, ohi;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float o1, o2;
      rotate(to_f32(lo.v[i]), to_f32(hi.v[i]),
             __fmul_rn(p, inv_freq[k0 + i]), &o1, &o2);
      olo.v[i] = from_f32<T>(o1);
      ohi.v[i] = from_f32<T>(o2);
    }
    *reinterpret_cast<Pack<T, P>*>(out + base) = olo;
    *reinterpret_cast<Pack<T, P>*>(out + base + half) = ohi;
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const long long j = j0 + i;
      if (j >= a.n_pairs) break;
      const long long vec = j / half;
      const int k = static_cast<int>(j - vec * half);
      const float p = static_cast<float>(__ldg(pos + vec / a.heads));
      const long long e = vec * 2 * half + k;
      float o1, o2;
      rotate(to_f32(x[e]), to_f32(x[e + half]),
             __fmul_rn(p, inv_freq[k]), &o1, &o2);
      out[e] = from_f32<T>(o1);
      out[e + half] = from_f32<T>(o2);
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename PosT, int P>
cudaError_t launch_p(const RopeArgs& a, int n_tensors, int threads,
                     cudaStream_t stream) {
  const size_t vec_bytes = sizeof(T) * P;
  bool vec = a.half % P == 0;
  for (int t = 0; t < n_tensors; ++t)
    vec = vec && aligned(a.x[t], vec_bytes) && aligned(a.out[t], vec_bytes);
  const long long work = (a.n_pairs + P - 1) / P;
  const dim3 grid(static_cast<unsigned>((work + threads - 1) / threads),
                  n_tensors);
  const size_t smem = sizeof(float) * a.half;
  if (vec)
    rope_kernel<T, PosT, P, true><<<grid, threads, smem, stream>>>(a);
  else
    rope_kernel<T, PosT, P, false><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename PosT>
cudaError_t launch_t(const RopeArgs& a, int n_tensors, int pairs,
                     int threads, cudaStream_t stream) {
  switch (pairs) {
    case 2: return launch_p<T, PosT, 2>(a, n_tensors, threads, stream);
    case 4: return launch_p<T, PosT, 4>(a, n_tensors, threads, stream);
    case 8: return launch_p<T, PosT, 8>(a, n_tensors, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pos(const RopeArgs& a, int pos_is_int64, int n_tensors,
                       int pairs, int threads, cudaStream_t stream) {
  return pos_is_int64
      ? launch_t<T, long long>(a, n_tensors, pairs, threads, stream)
      : launch_t<T, int>(a, n_tensors, pairs, threads, stream);
}

}  // namespace

extern "C" {

// Rotates x0 into out0 and, when n_tensors is 2, x1 into out1: each a
// contiguous (rows, heads, head_dim) array of one dtype (0 float32,
// 1 bfloat16, 2 float16) with an even head_dim; positions a contiguous
// (rows,) array of int32 (pos_is_int64 0) or int64 (1).  pairs (2, 4 or
// 8) is the pairs a thread takes, threads (a multiple of 32, at most
// 1024) the threads a block.  Launches on ``stream``, allocates nothing
// and never synchronises.  Returns cudaGetLastError() after the launch
// (0 = launched; nothing is launched for rows * heads == 0), or
// cudaErrorInvalidValue for an argument the kernel does not take.
int mx_rope(const void* x0, void* out0, const void* x1, void* out1,
            int n_tensors, int dtype, const void* positions,
            int pos_is_int64, long long rows, int heads, int head_dim,
            float neg_log_base_half, int pairs, int threads, void* stream) {
  if (n_tensors < 1 || n_tensors > 2 || rows < 0 || heads < 0 ||
      head_dim <= 0 || head_dim % 2 || threads < 32 || threads > 1024 ||
      threads % 32 || (pairs != 2 && pairs != 4 && pairs != 8))
    return cudaErrorInvalidValue;
  RopeArgs a;
  a.x[0] = x0;
  a.out[0] = out0;
  a.x[1] = n_tensors == 2 ? x1 : x0;
  a.out[1] = n_tensors == 2 ? out1 : out0;
  a.positions = positions;
  a.half = head_dim / 2;
  a.heads = heads;
  a.n_pairs = rows * heads * static_cast<long long>(a.half);
  a.neg_log_base_half = neg_log_base_half;
  if (a.n_pairs == 0) return cudaSuccess;
  if ((a.n_pairs + pairs - 1) / pairs / threads >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_pos<float>(a, pos_is_int64, n_tensors, pairs, threads, s);
    case 1:
      return launch_pos<__nv_bfloat16>(a, pos_is_int64, n_tensors, pairs,
                                       threads, s);
    case 2:
      return launch_pos<__half>(a, pos_is_int64, n_tensors, pairs, threads,
                                s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
