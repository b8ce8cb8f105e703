// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// over the last dim, statistics in f32, y cast once to x's dtype.
//
// Replaces the Pallas TPU kernel `rmsnorm` (`_rmsnorm_kernel`) in
// src/repro/kernels/rmsnorm.py.  x is (R, D) with rows `x_rs` elements
// apart and its last dim contiguous (bf16 or f32); w is (D,) f32; y is
// (R, D) contiguous in x's dtype.
//
// Bound: bytes.  Each element is read once and written once with a handful
// of flops, so at zamba2's and granite's widths the kernel can at best move
// 2 * R * D * sizeof(x) bytes at the card's memory rate (0.080 ms at
// (16384, 4096) bf16).  The TPU kernel takes 256-row blocks with the whole
// feature dim in VMEM and pads the row count up to the block; here one CTA
// owns one row, so any row count works with no padding.  Its threads read
// the row in 16-byte vectors (8 bf16 or 4 f32; a scalar loop when D or the
// alignment does not allow it), sum the squares with warp shuffles and one
// pass through shared memory, and then read the row again (from L1: at most
// 28 KB) to scale and write it.  A row of D <= 7168 needs at most 4 vectors
// per thread at 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// VEC consecutive elements of x as f32, from one 16-byte load
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) store(&e[i], in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// sum over the block, returned to every thread
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[MAX_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) s += part[i];
  return s;
}

// VECTOR: x rows, y rows and w are 16-byte aligned and D % VEC == 0
template <typename T, bool VECTOR>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w,
                               T* __restrict__ y, int D, int64_t x_rs,
                               float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + (int64_t)blockIdx.x * x_rs;
  T* yr = y + (int64_t)blockIdx.x * D;
  float ss = 0.f;
  if (VECTOR) {
    for (int v = threadIdx.x; v < D / VEC; v += blockDim.x) {
      float e[VEC];
      load_vec<T, VEC>(xr + v * VEC, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(e[i], e[i], ss);
    }
  } else {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float e = to_f32(xr[d]);
      ss = fmaf(e, e, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / (float)D + eps);
  if (VECTOR) {
    for (int v = threadIdx.x; v < D / VEC; v += blockDim.x) {
      float e[VEC];
      load_vec<T, VEC>(xr + v * VEC, e);
      const float4* w4 = reinterpret_cast<const float4*>(w + v * VEC);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const float4 t = w4[j];
        e[4 * j + 0] = e[4 * j + 0] * r * (1.f + t.x);
        e[4 * j + 1] = e[4 * j + 1] * r * (1.f + t.y);
        e[4 * j + 2] = e[4 * j + 2] * r * (1.f + t.z);
        e[4 * j + 3] = e[4 * j + 3] * r * (1.f + t.w);
      }
      store_vec<T, VEC>(yr + v * VEC, e);
    }
  } else {
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      store(&yr[d], to_f32(xr[d]) * r * (1.f + w[d]));
  }
}

template <typename T>
int launch(const void* x, const float* w, void* y, int R, int D,
           int64_t x_rs, float eps, int vector, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int units = vector ? D / VEC : D;
  int threads = ((units + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vector)
    rmsnorm_kernel<T, true><<<R, threads, 0, stream>>>(xp, w, yp, D, x_rs, eps);
  else
    rmsnorm_kernel<T, false><<<R, threads, 0, stream>>>(xp, w, yp, D, x_rs, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x rows are x_rs elements apart; y is
// contiguous.  vector != 0 only when x, x_rs, y and w allow 16-byte loads
// (the wrapper decides).  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              int dtype, int R, int D, int64_t x_rs,
                              float eps, int vector, void* stream) {
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* wp = static_cast<const float*>(w);
  if (dtype == 0) return launch<float>(x, wp, y, R, D, x_rs, eps, vector, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wp, y, R, D, x_rs, eps, vector, st);
  return (int)cudaErrorInvalidValue;
}
