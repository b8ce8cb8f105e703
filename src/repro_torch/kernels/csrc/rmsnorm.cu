// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// over the last dim, statistics in f32, y cast once to x's dtype.
//
// Replaces the Pallas TPU kernel `rmsnorm` (`_rmsnorm_kernel`) in
// src/repro/kernels/rmsnorm.py:23.  x is (R, D) with rows `x_rs` elements
// apart and its last dim contiguous (bf16 or f32); w is (D,) f32; y is
// (R, D) contiguous in x's dtype.
//
// Bound: bytes.  Each element is read once and written once with a handful
// of flops, so the kernel can at best move 2 * R * D * sizeof(x) bytes at
// the card's memory rate (0.080 ms at (16384, 4096) bf16).  The TPU kernel
// takes 256-row blocks with the whole feature dim in VMEM and pads the row
// count up to the block.  Here:
//
// * One HBM pass from registers.  A CTA is the warp group of one row, and
//   the grid is one CTA a row, so any row count works with no padding.
//   Each thread holds 2 of the row's 16-byte vectors (8 bf16 or 4 f32; 4
//   above 8192 bf16 or 4096 f32) in registers across the reduction: each
//   element is read once, with streaming loads, and written once.
// * Cheap reductions.  Warp shuffles, then (for more than one warp) one
//   barrier among the row's warps.
// * Many rows or few.  With many rows (more CTAs than fit the card at
//   once: prefill), w is read through L1 after the reduction: the CTAs of
//   an SM share w's 8-28 KB there, and a thread holds no w registers while
//   its loads are in flight, so more CTAs fit an SM.  With few rows
//   (decode: 32-128), w is loaded beside the row, so that its latency
//   overlaps the row's.
// * A y larger than L2 is stored evict-first (`st.global.cs`): it cannot
//   stay there anyway, and the pass then moves its bytes as fast as
//   cudaMemcpy does.  A smaller y is stored plainly, for the next kernel
//   to find in L2.
// * No persistent CTAs.  A persistent grid (CTAs an SM x SMs walking rows a
//   grid apart, w in registers once a CTA, the next row's loads issued
//   before the current row is reduced, from registers or by a TMA ring)
//   streamed worse on the H100 at every width; chip_probes/rmsnorm_designs.cu
//   keeps both such designs, and chip_probes/rmsnorm_probe.py times them
//   beside this one.
//
// Routes, decided here from the pointers, strides and D: `vector` when x,
// its row stride, y and w allow 16-byte loads, D is a multiple of the
// vector and the row fits 512 threads' registers (D <= 16384 bf16, 8192
// f32); `loop` otherwise (odd D, a misaligned view, wider rows): a CTA a
// row in a strided loop, the row read twice, the second time from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int MAX_THREADS = 512;  // up to 128 registers a thread
constexpr int LOOP_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One unit of a row: 16 bytes (vector route) or one element.
template <typename T, bool VEC>
struct Unit {
  using type = uint4;
  static constexpr int E = 16 / sizeof(T);
};
template <typename T>
struct Unit<T, false> {
  using type = T;
  static constexpr int E = 1;
};

template <typename T, typename U, int E>
__device__ __forceinline__ void unpack(const U& u, float (&f)[E]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = to_f32(e[i]);
}

template <typename T, typename U, int E>
__device__ __forceinline__ U pack(const float (&f)[E]) {
  U u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < E; ++i) store(&e[i], f[i]);
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the CTA (the row's warps), returned to every thread; once a CTA
__device__ __forceinline__ float row_sum(float v, float (&part)[32]) {
  v = warp_sum(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1) return v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += part[i];
  return s;
}

// (1 + w) for vector u: E consecutive f32 in 16-byte loads
template <int E>
__device__ __forceinline__ void load_w1(const float* w, int u,
                                        float (&out)[E]) {
  const float4* w4 = reinterpret_cast<const float4*>(w) + (int64_t)u * (E / 4);
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    const float4 t = __ldg(w4 + k);
    out[4 * k + 0] = 1.f + t.x;
    out[4 * k + 1] = 1.f + t.y;
    out[4 * k + 2] = 1.f + t.z;
    out[4 * k + 3] = 1.f + t.w;
  }
}

// The vector route: one CTA a row, a grid of R CTAs.  UPT: 16-byte vectors
// a thread holds; MANY: the grid outgrows the card at once, so (1 + w) is
// read through L1 after the reduction, else loaded beside the row; STREAM:
// y outgrows L2, so it is stored evict-first.
template <typename T, int UPT, bool MANY, bool STREAM>
__global__ void __launch_bounds__(MAX_THREADS)
    row_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int D, int64_t x_rs, float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float part[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nu = D / E;  // vectors a row
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (int64_t)blockIdx.x * x_rs);
  uint4* yr = reinterpret_cast<uint4*>(y + (int64_t)blockIdx.x * D);
  uint4 v[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = tid + i * nt;
    if (u < nu) v[i] = __ldcs(xr + u);  // read once: evicted first
  }
  float w1[MANY ? 1 : UPT][E];
  if constexpr (!MANY) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * nt;
      if (u < nu) load_w1<E>(w, u, w1[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (tid + i * nt < nu) {
      float f[E];
      unpack<T, uint4, E>(v[i], f);
#pragma unroll
      for (int j = 0; j < E; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  const float rs = rsqrtf(row_sum(ss, part) / (float)D + eps);
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = tid + i * nt;
    if (u < nu) {
      float f[E], wv[E];
      unpack<T, uint4, E>(v[i], f);
      if constexpr (MANY) {
        load_w1<E>(w, u, wv);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) wv[j] = w1[i][j];
      }
#pragma unroll
      for (int j = 0; j < E; ++j) f[j] = f[j] * rs * wv[j];
      if constexpr (STREAM)
        __stcs(yr + u, pack<T, uint4, E>(f));
      else
        yr[u] = pack<T, uint4, E>(f);
    }
  }
}

// The loop route: one CTA a row, the row read twice (the second time from
// L1), w read a row; 16-byte units where aligned (rows too wide for the
// vector route), else one element a unit.
template <typename T, bool VEC>
__global__ void __launch_bounds__(LOOP_THREADS)
    loop_kernel(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, int D, int64_t x_rs, float eps) {
  using U = typename Unit<T, VEC>::type;
  constexpr int E = Unit<T, VEC>::E;
  __shared__ float part[32];
  const int nu = D / E;
  const U* xr = reinterpret_cast<const U*>(x + (int64_t)blockIdx.x * x_rs);
  U* yr = reinterpret_cast<U*>(y + (int64_t)blockIdx.x * D);
  float ss = 0.f;
  for (int u = threadIdx.x; u < nu; u += blockDim.x) {
    float f[E];
    unpack<T, U, E>(xr[u], f);
#pragma unroll
    for (int j = 0; j < E; ++j) ss = fmaf(f[j], f[j], ss);
  }
  const float r = rsqrtf(row_sum(ss, part) / (float)D + eps);
  for (int u = threadIdx.x; u < nu; u += blockDim.x) {
    float f[E];
    unpack<T, U, E>(xr[u], f);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = f[j] * r * (1.f + w[(int64_t)u * E + j]);
    yr[u] = pack<T, U, E>(f);
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const float*, T*, int, int64_t, float);

// What a call launches, decided from the pointers, strides and shapes.
struct Plan {
  int vector;   // 16-byte units, else one element a unit
  int loop;     // loop_kernel, else row_kernel
  int threads;  // a CTA: the row's warps
  int upt;      // vectors a thread holds (row_kernel)
  int grid;     // one CTA a row
  int ctas_per_sm;
  int many;     // the grid outgrows the card at once (row_kernel's MANY)
  int stream;   // y outgrows L2 (row_kernel's STREAM)
};

template <typename T>
KernelFn<T> kernel_of(const Plan& p) {
  if (p.loop) return p.vector ? loop_kernel<T, true> : loop_kernel<T, false>;
  if (p.stream)
    return p.upt == 2 ? row_kernel<T, 2, true, true>
                      : row_kernel<T, 4, true, true>;
  if (p.many)
    return p.upt == 2 ? row_kernel<T, 2, true, false>
                      : row_kernel<T, 4, true, false>;
  return p.upt == 2 ? row_kernel<T, 2, false, false>
                    : row_kernel<T, 4, false, false>;
}

// the card's SMs and L2 bytes and a kernel's CTAs an SM, asked once per
// (device, kernel, threads), in a table a mutex guards
struct Occupancy {
  int dev;
  const void* fn;
  int threads, sms, l2, ctas;
};
std::mutex occ_mutex;
Occupancy occ_table[64];
int occ_n = 0;

int occupancy(const void* fn, int threads, int* sms, int* l2, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(occ_mutex);
  for (int i = 0; i < occ_n; ++i) {
    const Occupancy& o = occ_table[i];
    if (o.dev == dev && o.fn == fn && o.threads == threads) {
      *sms = o.sms;
      *l2 = o.l2;
      *ctas = o.ctas;
      return 0;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (*ctas < 1) return (int)cudaErrorInvalidConfiguration;
  if (occ_n < 64)
    occ_table[occ_n++] = Occupancy{dev, fn, threads, *sms, *l2, *ctas};
  return 0;
}

template <typename T>
int make_plan(const void* x, const void* w, const void* y, int R, int D,
              int64_t x_rs, Plan* p) {
  constexpr int VEC = 16 / sizeof(T);
  *p = Plan{};
  p->vector = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
              (uintptr_t)w % 16 == 0 && (R == 1 || x_rs % VEC == 0) &&
              D % VEC == 0;
  p->grid = R;
  // the fewest vectors a thread that MAX_THREADS hold
  const int64_t nu = D / VEC;
  for (int upt = 2; upt <= 4 && p->vector && !p->upt; upt *= 2)
    if ((nu + 32 * upt - 1) / (32 * upt) * 32 <= MAX_THREADS) p->upt = upt;
  if (!p->upt) {
    p->loop = 1;
    p->threads = LOOP_THREADS;
    return 0;
  }
  p->threads = (int)((nu + 32 * p->upt - 1) / (32 * p->upt) * 32);
  // few rows while the grid fits the card at once
  int sms = 0, l2 = 0;
  int err = occupancy((const void*)kernel_of<T>(*p), p->threads, &sms, &l2,
                      &p->ctas_per_sm);
  if (err || (int64_t)R <= (int64_t)sms * p->ctas_per_sm) return err;
  p->many = 1;
  p->stream = (int64_t)R * D * (int64_t)sizeof(T) > l2;
  return occupancy((const void*)kernel_of<T>(*p), p->threads, &sms, &l2,
                   &p->ctas_per_sm);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int R, int D, int64_t x_rs,
           float eps, cudaStream_t stream) {
  Plan p;
  const int err = make_plan<T>(x, w, y, R, D, x_rs, &p);
  if (err) return err;
  const KernelFn<T> kernel = kernel_of<T>(p);
  kernel<<<p.grid, p.threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), D, x_rs, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x rows are x_rs elements apart; y is
// contiguous; w is (D,) f32.  The route and the grid are decided here.
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              int dtype, int R, int D, int64_t x_rs,
                              float eps, void* stream) {
  if (R <= 0 || D <= 0) return R == 0 ? 0 : (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, y, R, D, x_rs, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, R, D, x_rs, eps, st);
  return (int)cudaErrorInvalidValue;
}

// What rmsnorm_launch would launch for these arguments, into out[11]:
// vector, loop, threads, vectors a thread, grid, CTAs an SM, registers a
// thread, local memory a thread (spills), the vector width in elements,
// row_kernel's MANY and STREAM.  Returns a CUDA error code.
extern "C" int rmsnorm_plan(const void* x, const void* w, const void* y,
                            int dtype, int R, int D, int64_t x_rs, int* out) {
  if ((dtype != 0 && dtype != 1) || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaFuncAttributes at;
  int err;
  if (dtype == 0) {
    err = make_plan<float>(x, w, y, R, D, x_rs, &p);
    if (!err) err = (int)cudaFuncGetAttributes(&at, kernel_of<float>(p));
  } else {
    err = make_plan<__nv_bfloat16>(x, w, y, R, D, x_rs, &p);
    if (!err)
      err = (int)cudaFuncGetAttributes(&at, kernel_of<__nv_bfloat16>(p));
  }
  if (err) return err;
  const int vals[11] = {p.vector, p.loop, p.threads, p.upt, p.grid,
                        p.ctas_per_sm, at.numRegs, (int)at.localSizeBytes,
                        dtype == 0 ? 4 : 8, p.many, p.stream};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}
