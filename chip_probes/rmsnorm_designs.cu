// The RMSNorm kernel's persistent designs, for timing beside the launch's
// (chip_probes/rmsnorm_probe.py); nothing of the port launches them.
//
// Design 0 is src/repro_torch/kernels/csrc/rmsnorm.cu, included whole:
// one CTA a row.  Designs 1 and 2 walk rows with a persistent grid (CTAs an
// SM x SMs, rows a grid apart), each thread holding its slice of (1 + w) in
// registers once and its 4 vectors of a row:
//   1: a register double buffer, the next row's loads issued before the
//      current row is reduced (two buffers that swap roles, unrolled, since
//      a copy between them would wait on the loads); where the registers
//      hold under 32 KB of rows ahead an SM (7168 wide: 2 CTAs), thread 0
//      also has the row after next fetched into L2;
//   2: each row by a 1-D TMA bulk copy (`cp.async.bulk`, an mbarrier a
//      slot) into a two-slot ring in shared memory.
// Vector route only (16-byte aligned rows, D a multiple of the vector, two
// rows in 48 KB of shared memory for design 2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC -o librmsnorm_designs.so chip_probes/rmsnorm_designs.cu

#include "../src/repro_torch/kernels/csrc/rmsnorm.cu"

namespace {

constexpr int PERSIST_UNITS = 4;

// sum over the CTA (the row's warps), returned to every thread; `part`
// alternates between two halves by row parity, so one barrier a row
// suffices: a warp can write the next row's half only after every warp
// has passed this row's barrier, and reads this row's half before it
__device__ __forceinline__ float row_sum2(float v, float (&part)[2][32],
                                          int parity, bool always_sync) {
  v = warp_sum(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1 && !always_sync) return v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[parity][warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += part[parity][i];
  return s;
}


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    // a wait of 2^35 cycles (about 20 s) is a fault, not a wait: trap, so
    // the launch fails instead of hanging the card
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// one row of `bytes` bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// have `bytes` bytes from `src` fetched into L2 (16-byte aligned, a
// multiple of 16)
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   (uint64_t)src),
               "r"(bytes)
               : "memory");
}


// Designs 1 and 2: persistent CTAs, (1 + w) in registers once a CTA.  UPT:
// vectors a thread holds; TMA: design 2 (rows through a shared-memory
// ring), else design 1 (register double buffer).
template <typename T, int UPT, bool TMA>
__global__ void __launch_bounds__(MAX_THREADS)
    rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, int R, int D, int64_t x_rs, float eps,
                int prefetch) {
  using U = uint4;
  constexpr int E = 16 / sizeof(T);
  __shared__ float part[2][32];
  __shared__ __align__(8) uint64_t bar[2];
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nu = D / E;  // units a row
  const U* xu = reinterpret_cast<const U*>(x);
  U* yu = reinterpret_cast<U*>(y);
  const int64_t xs = x_rs / E;  // row stride in units

  // (1 + w) for this thread's units, once
  float w1[UPT][E];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = tid + i * nt;
    if (u < nu) load_w1<E>(w, u, w1[i]);
  }

  // this thread's units of row r into buf
  auto load = [&](U(&buf)[UPT], int r) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * nt;
      if (u < nu) buf[i] = __ldcs(xu + r * xs + u);
    }
  };
  // reduce row r (in buf), scale it and store it; where asked, first have
  // the row after next (whose loads are not yet issued) fetched into L2,
  // so that more bytes are in flight than the registers hold
  auto process = [&](const U(&buf)[UPT], int r, int parity) {
    if (prefetch && tid == 0 && r + 2 * gridDim.x < R)
      prefetch_l2(x + (r + 2 * gridDim.x) * x_rs, (uint32_t)D * sizeof(T));
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (tid + i * nt < nu) {
        float f[E];
        unpack<T, U, E>(buf[i], f);
#pragma unroll
        for (int j = 0; j < E; ++j) ss = fmaf(f[j], f[j], ss);
      }
    }
    const float rs = rsqrtf(row_sum2(ss, part, parity, TMA) / (float)D + eps);
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * nt;
      if (u < nu) {
        float f[E];
        unpack<T, U, E>(buf[i], f);
#pragma unroll
        for (int j = 0; j < E; ++j) f[j] = f[j] * rs * w1[i][j];
        yu[(int64_t)r * nu + u] = pack<T, U, E>(f);
      }
    }
  };

  int row = blockIdx.x;
  if constexpr (!TMA) {
    // two buffers that swap roles every row, with no copy between them
    // (a copy would wait for the loads in flight): the next row's loads
    // are issued before the current row is reduced
    U a[UPT], b[UPT];
    load(a, row);
    for (;;) {
      int next = row + gridDim.x;
      if (next < R) load(b, next);
      process(a, row, 0);
      if (next >= R) break;
      row = next;
      next = row + gridDim.x;
      if (next < R) load(a, next);
      process(b, row, 1);
      if (next >= R) break;
      row = next;
    }
  } else {
    const uint32_t bytes = (uint32_t)D * sizeof(T);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&bar[0])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&bar[1])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      bulk_row(ring, x + row * x_rs, bytes, &bar[0]);
    }
    __syncthreads();
    for (int it = 0;; ++it) {
      const int next = row + gridDim.x;
      const int slot = it & 1;
      // the other slot was read last row, before that row's barrier
      if (tid == 0 && next < R)
        bulk_row(ring + (slot ^ 1) * bytes, x + next * x_rs, bytes,
                 &bar[slot ^ 1]);
      mbar_wait(&bar[slot], (it >> 1) & 1);
      const U* s = reinterpret_cast<const U*>(ring + slot * bytes);
      U buf[UPT];
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int u = tid + i * nt;
        if (u < nu) buf[i] = s[u];
      }
      process(buf, row, slot);
      if (next >= R) break;
      row = next;
    }
  }
}


template <typename T, bool TMA>
int persistent(const void* x, const void* w, void* y, int R, int D,
               int64_t x_rs, float eps, cudaStream_t stream, int* out) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t nu = D / VEC;
  const int threads = (int)((nu + 32 * PERSIST_UNITS - 1) /
                            (32 * PERSIST_UNITS) * 32);
  const int smem = TMA ? 2 * D * (int)sizeof(T) : 0;
  if ((uintptr_t)x % 16 || (uintptr_t)y % 16 || (uintptr_t)w % 16 ||
      (R > 1 && x_rs % VEC) || D % VEC || threads > MAX_THREADS ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const auto kernel = rows_kernel<T, PERSIST_UNITS, TMA>;
  int dev = 0, sms = 0, ctas = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(R < (int64_t)sms * ctas ? R : (int64_t)sms * ctas);
  const int prefetch = !TMA && (int64_t)ctas * D * sizeof(T) < 32 * 1024;
  cudaFuncAttributes at;
  cudaFuncGetAttributes(&at, kernel);
  const int vals[7] = {threads, grid, ctas, prefetch, smem, at.numRegs,
                       (int)at.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), R, D, x_rs, eps, prefetch);
  return (int)cudaGetLastError();
}

}  // namespace

// Design 1 (tma 0) or 2 (tma 1) on the same arguments as rmsnorm_launch;
// out[7]: threads, grid, CTAs an SM, the L2 prefetch, dynamic shared
// memory, registers a thread, local memory a thread.
extern "C" int rmsnorm_persistent_launch(const void* x, const void* w,
                                         void* y, int dtype, int R, int D,
                                         int64_t x_rs, float eps, int tma,
                                         void* stream, int* out) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return tma ? persistent<float, true>(x, w, y, R, D, x_rs, eps, st, out)
               : persistent<float, false>(x, w, y, R, D, x_rs, eps, st, out);
  if (dtype == 1)
    return tma ? persistent<__nv_bfloat16, true>(x, w, y, R, D, x_rs, eps, st,
                                                 out)
               : persistent<__nv_bfloat16, false>(x, w, y, R, D, x_rs, eps,
                                                  st, out);
  return (int)cudaErrorInvalidValue;
}
