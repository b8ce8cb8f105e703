// SSD inter-chunk state scan for Hopper (sm_90a): the sequential part of the
// chunked Mamba2 scan and the output it feeds.
//
// Replaces the Pallas TPU kernel `ssd_state_scan` (`_ssd_scan_kernel`) in
// src/repro/kernels/ssm_scan.py.  For each batch b and SSM head h, with the
// running state s (hd x N, f32) starting at zero, for chunks c = 0 .. nc-1:
//
//   y[b, c, i, h, :] = (C[b, c, i, :] @ s^T) * exp(cum[b, c, i, h])   (i < Q)
//   s = s * exp(totals[b, c, h]) + states[b, c, h]
//
// and final[b, h] = s after the last chunk.  states (B, nc, nh, hd, N),
// totals (B, nc, nh), C (B, nc, Q, N) (one group, shared by the heads) and
// cum (B, nc, Q, nh) are f32 with their own strides; y (B, nc, Q, nh, hd)
// and final (B, nh, hd, N) are f32 and contiguous: the JAX layouts, read
// and written in place.
//
// Bound: operations.  Per chunk and head the work is a (Q x N) @ (N x hd)
// product, 2 * Q * N * hd flops against the 4 * Q * hd bytes of its output:
// 32 flops a byte at N = 64, above the card's f32 ridge point (67 TFLOP/s
// over 3.35 TB/s, 20 flops a byte).  At zamba2's prefill (B 4, nc 16,
// nh 112, hd = N = 64, Q 256) that is 15.2 GFLOP, 0.227 ms at the f32 FMA
// peak, against 0.606 GB of bytes (almost all of it y), 0.181 ms.  This
// design runs the products on the tensor cores as 3xTF32 (45.7 GFLOP of
// TF32 products, 0.092 ms at the 495 TFLOP/s dense TF32 peak) and writes
// and reads the state before each chunk once more (2 x 0.117 GB), so its
// own floor is its bytes, 0.841 GB, 0.251 ms.
//
// The TPU kernel walks the chunks as a sequential grid dimension with the
// state in VMEM scratch, after transposing states, cum and y into per-head
// layouts.  Here two kernels split the work so that nothing serial sits
// between the loads and the products:
// * `scan_kernel` runs the recurrence, one CTA a (batch, head), and writes
//   the state before each chunk into `prefix` (B, nc, nh, 64, 64) and the
//   state after the last into `final`: memory-bound, each thread its
//   float4s of the block, the next chunk's states loaded while this one's
//   are added.
// * `y_kernel` computes y on a persistent grid of one CTA an SM, each CTA
//   an equal share of the (batch, chunk, 256 rows, head) items, heads
//   fastest.  A CTA holds its rows of C split into TF32 hi/lo operand tiles
//   (128-byte swizzled) for all the heads it walks, so C is read about
//   once a CTA instead of once a head, and each state block once instead
//   of once a 64-row tile; per head it splits the state (prefetched into
//   registers during the previous head) into one of two buffers, and each
//   of its two warpgroups computes two 64 x 64 tiles of y on `wgmma`.
//   Each product is hi.hi + hi.lo + lo.hi (3xTF32; lo = TF32(x - hi), both
//   rounded to nearest: the dropped lo.lo term and lo's rounding leave
//   about 2^-22 of each product, against 2^-11 for one TF32 product).  The
//   tensor cores truncate the sums they accumulate, which over a long sum
//   adds up past the 1e-5 tolerance, so each k-step's hi.hi is summed from
//   zero and added in f32 (round to nearest), and the two small terms
//   (2^-11 of it) share one accumulator, added last.
// hd and N are at most 64; Q and nc are any size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 64;        // state tile: hd and N padded to this
constexpr int RG = 256;       // rows of C a CTA of `y_kernel` holds
constexpr int T_WG = 2;       // `y_kernel`: two warpgroups
constexpr int T_THREADS = 128 * T_WG;
constexpr int SCAN_THREADS = 256;
constexpr int KSTEPS = TS / 8;
// `y_kernel`'s shared memory, from a 1024-byte aligned base: 64 x 64 TF32
// operand tiles, each two 128-byte swizzled slabs of 32 columns, a hi tile
// followed by its lo tile: C's four 64-row tiles, then two buffers of the
// state's
constexpr int TILE = TS * TS * 4;  // 16 KB
constexpr int C_T = 0, S_T = (RG / 64) * 2 * TILE;
constexpr int SMEM_BYTES = S_T + 2 * 2 * TILE + 1024;

struct Args {
  const float* states;
  const float* totals;
  const float* C;
  const float* cum;
  float* y;
  float* final_state;
  float* prefix;  // (B, nc, nh, 64, 64): the state before each chunk
  int B, nc, nh, hd, N, Q;
  int c_vec, s_vec;  // C / states rows read as 16-byte vectors
  int64_t s_sb, s_sc, s_sh, s_sd, s_sn;
  int64_t t_sb, t_sc, t_sh;
  int64_t c_sb, c_sc, c_si, c_sn;
  int64_t u_sb, u_sc, u_si, u_sh;
};

// four consecutive columns n .. n + 3 of a row of an f32 matrix with column
// stride `sn`, zero past `N` (and all zero unless `ok`)
__device__ __forceinline__ float4 load4(const float* row, int n, int N,
                                        int64_t sn, bool vec, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + n));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = n + e < N ? __ldg(row + (n + e) * sn) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The recurrence: one CTA a (batch, head), each thread 16 elements of the
// (hd x N) state as four float4s (element e4 = tid + 256 j: row e4 / 16,
// columns 4 (e4 % 16) ..).  Writes the state before each chunk into
// `prefix` (zero-padded to 64 x 64) and the state after the last into
// `final_state`; the next chunk's states are loaded while this one's are
// added.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(const Args a) {
  const int b = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const float* sb = a.states + b * a.s_sb + h * a.s_sh;
  float4 s[4], cur[4];
  auto load = [&](int c, float4 (&v)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e4 = threadIdx.x + SCAN_THREADS * j;
      const int d = e4 >> 4, n = (e4 & 15) * 4;
      v[j] = load4(sb + c * a.s_sc + d * a.s_sd, n, a.N, a.s_sn, a.s_vec,
                   d < a.hd && n < a.N);
    }
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.nc > 0) load(0, cur);
  for (int c = 0; c < a.nc; ++c) {
    float4* pre = reinterpret_cast<float4*>(
        a.prefix + (((int64_t)b * a.nc + c) * a.nh + h) * TS * TS);
#pragma unroll
    for (int j = 0; j < 4; ++j) pre[threadIdx.x + SCAN_THREADS * j] = s[j];
    float4 nxt[4];
    if (c + 1 < a.nc) load(c + 1, nxt);
    const float decay = expf(a.totals[b * a.t_sb + c * a.t_sc + h * a.t_sh]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j].x = fmaf(s[j].x, decay, cur[j].x);
      s[j].y = fmaf(s[j].y, decay, cur[j].y);
      s[j].z = fmaf(s[j].z, decay, cur[j].z);
      s[j].w = fmaf(s[j].w, decay, cur[j].w);
      if (c + 1 < a.nc) cur[j] = nxt[j];
    }
  }
  float* fin = a.final_state + ((int64_t)b * a.nh + h) * a.hd * a.N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e4 = threadIdx.x + SCAN_THREADS * j;
    const int d = e4 >> 4, n = (e4 & 15) * 4;
    const float v[4] = {s[j].x, s[j].y, s[j].z, s[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d < a.hd && n + e < a.N) fin[d * a.N + n + e] = v[e];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// x rounded to TF32 (nearest, ties away from zero)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// byte offset of element (r, k) of a swizzled 64 x 64 operand tile: slab
// k / 32, row r of 128 bytes, its 16-byte chunk (k % 32) / 4 XOR r % 8
__device__ __forceinline__ uint32_t sw(int r, int k) {
  return (k >> 5) * 8192 + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) +
         (k & 3) * 4;
}

// four consecutive columns k .. k + 3 of row r, split into TF32 hi and lo
// parts, into the operand tiles at `hi` and `hi + TILE`
__device__ __forceinline__ void put4(unsigned char* sm, int hi, int r, int k,
                                     float4 x) {
  const float4 h4 = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
  const float4 l4 = make_float4(tf32(x.x - h4.x), tf32(x.y - h4.y),
                                tf32(x.z - h4.z), tf32(x.w - h4.w));
  const uint32_t off = sw(r, k);
  *reinterpret_cast<float4*>(sm + hi + off) = h4;
  *reinterpret_cast<float4*>(sm + hi + TILE + off) = l4;
}

// descriptor of k-step kk of a swizzled operand tile at `tile`: slab kk / 4,
// 32 bytes a k-step within it; 8 rows of 128 bytes between core matrices
// (1024), layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t tile, int kk) {
  const uint32_t addr = tile + (kk >> 2) * 8192 + (kk & 3) * 32;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) = [D +] A (64 x 8, smem) . B (8 x 64, smem); TF32, both
// operands K-major
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// y, on a persistent grid: an item is (batch, chunk, group of RG = 256
// rows, head), heads fastest; CTA k takes items [k * n / ctas, (k + 1) * n /
// ctas).  A CTA holds its (batch, chunk, rows)'s C split into TF32 hi/lo
// operand tiles, loaded once for all the heads it walks; for each head it
// splits the state before the chunk (from `prefix`, read once, prefetched
// into registers during the previous head) into one of two buffers, and
// each of its two warpgroups computes y for two 64-row tiles as 3xTF32 on
// `wgmma`, the two tiles' products interleaved: the small terms lo.hi and
// hi.lo on one accumulator a tile; hi.hi a k-step at a time from zero (the
// tensor cores truncate their sums), summed in f32 (round to nearest), and
// the small terms added last.
__global__ void __launch_bounds__(T_THREADS) y_kernel(const Args a) {
  extern __shared__ unsigned char sm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      ((uintptr_t)sm_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int n_rg = (a.Q + RG - 1) / RG;
  const int64_t n_items = (int64_t)a.B * a.nc * n_rg * a.nh;
  const int64_t first = blockIdx.x * n_items / gridDim.x;
  const int64_t last = (blockIdx.x + 1) * n_items / gridDim.x;

  // the state before chunk c of head h for item `it`: element e4 = tid +
  // 256 j, row e4 / 16, columns 4 (e4 % 16) ..
  float4 pf[TS * TS / 4 / T_THREADS];
  auto fetch = [&](int64_t it) {
    const int64_t bch = it / a.nh;  // (batch, chunk, row group) index
    const int h = (int)(it % a.nh);
    const int64_t bc = bch / n_rg;  // batch * nc + chunk
    const float4* pre = reinterpret_cast<const float4*>(
        a.prefix + (bc * a.nh + h) * TS * TS);
#pragma unroll
    for (int j = 0; j < TS * TS / 4 / T_THREADS; ++j)
      pf[j] = __ldg(pre + tid + T_THREADS * j);
  };
  if (first < last) fetch(first);
  int buf = 0;
  for (int64_t it = first; it < last; ++it) {
    const int64_t bch = it / a.nh;
    const int h = (int)(it % a.nh);
    const int rg = (int)(bch % n_rg);
    const int c = (int)(bch / n_rg % a.nc);
    const int b = (int)(bch / ((int64_t)n_rg * a.nc));
    const int r0 = rg * RG, rows = min(RG, a.Q - r0);
    if (it == first || h == 0) {
      // a new (batch, chunk, rows): C's 256 rows into the operand tiles
      // (rows past Q and columns past N zero), once all warps are done
      // with the previous ones
      __syncthreads();
      const float* Cc = a.C + b * a.c_sb + c * a.c_sc + (int64_t)r0 * a.c_si;
#pragma unroll 4
      for (int j = 0; j < RG * TS / 4 / T_THREADS; ++j) {
        const int e4 = tid + T_THREADS * j, r = e4 >> 4, k = (e4 & 15) * 4;
        put4(sm, C_T + (r >> 6) * 2 * TILE, r & 63, k,
             load4(Cc + r * a.c_si, k, a.N, a.c_sn, a.c_vec,
                   r < rows && k < a.N));
      }
    }
    const int s_hi = S_T + buf * 2 * TILE;
#pragma unroll
    for (int j = 0; j < TS * TS / 4 / T_THREADS; ++j) {
      const int e4 = tid + T_THREADS * j;
      put4(sm, s_hi, e4 >> 4, (e4 & 15) * 4, pf[j]);
    }
    if (it + 1 < last) fetch(it + 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int64_t y_si = (int64_t)a.nh * a.hd;
    float* yc = a.y + (((int64_t)b * a.nc + c) * a.Q + r0) * y_si +
                (int64_t)h * a.hd;
    const float* uc = a.cum + b * a.u_sb + c * a.u_sc + h * a.u_sh;
    const bool pairs = (a.hd & 1) == 0;
    // this warpgroup's two 64-row tiles, their products interleaved: the
    // small terms on each tile's accumulator `sm0`/`sm1`; hi.hi a k-step at a
    // time from zero (`t0`/`t1`), added to the f32 sums `y0`/`y1`
    const int m0 = wg * 2;
    float ec[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (m0 + m) * 64 + 16 * warp + g + 8 * r;
        ec[m][r] = i < rows ? __ldg(uc + (r0 + i) * a.u_si) : 0.f;
      }
    const uint32_t sh = base + s_hi;
    const uint32_t ch[2] = {base + C_T + m0 * 2 * TILE,
                            base + C_T + (m0 + 1) * 2 * TILE};
    float sm0[32], sm1[32], t0[32], t1[32], y0[32], y1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y0[i] = y1[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wgmma(sm0, desc(ch[0] + TILE, kk), desc(sh, kk), kk > 0);
      wgmma(sm0, desc(ch[0], kk), desc(sh + TILE, kk), 1);
      wgmma(sm1, desc(ch[1] + TILE, kk), desc(sh, kk), kk > 0);
      wgmma(sm1, desc(ch[1], kk), desc(sh + TILE, kk), 1);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wgmma(t0, desc(ch[0], kk), desc(sh, kk), 0);
      wgmma(t1, desc(ch[1], kk), desc(sh, kk), 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(t0);
      fence_regs(t1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        y0[i] += t0[i];
        y1[i] += t1[i];
      }
      wg_fence();
    }
    fence_regs(sm0);
    fence_regs(sm1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      y0[i] += sm0[i];
      y1[i] += sm1[i];
    }
    // y: warp w of the warpgroup has rows 16 w + g (+8) of each tile,
    // columns 8 n + 2 tig (+1)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float(&v)[32] = m ? y1 : y0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (m0 + m) * 64 + 16 * warp + g + 8 * r;
        if (i >= rows) continue;
        const float e = expf(ec[m][r]);
#pragma unroll
        for (int n = 0; n < TS / 8; ++n) {
          const int d = 8 * n + 2 * tig;
          float* dst = yc + i * y_si + d;
          const float v0 = v[4 * n + 2 * r] * e, v1 = v[4 * n + 2 * r + 1] * e;
          if (pairs && d + 1 < a.hd) {
            __stcs(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
          } else {
            if (d < a.hd) __stcs(dst, v0);
            if (d + 1 < a.hd) __stcs(dst + 1, v1);
          }
        }
      }
    }
    buf ^= 1;
  }
}

int launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t prepared = cudaFuncSetAttribute(
      y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (prepared != cudaSuccess) return (int)prepared;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int64_t scans = (int64_t)a.B * a.nh;
  const int64_t items =
      scans * a.nc * ((a.Q + RG - 1) / RG);  // (batch, chunk, rows, head)
  if (scans >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)scans, SCAN_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || items == 0) return (int)err;
  const int ctas = (int)(items < sms ? items : sms);  // one CTA an SM
  y_kernel<<<ctas, T_THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// All strides in elements.  hd and N at most 64; prefix is scratch of
// (B, nc, nh, 64, 64) f32.  Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int ssd_state_scan_launch(
    const void* states, const void* totals, const void* C, const void* cum,
    void* y, void* final_state, void* prefix, int B, int nc, int nh, int hd,
    int N, int Q, int64_t s_sb, int64_t s_sc, int64_t s_sh, int64_t s_sd,
    int64_t s_sn, int64_t t_sb, int64_t t_sc, int64_t t_sh, int64_t c_sb,
    int64_t c_sc, int64_t c_si, int64_t c_sn, int64_t u_sb, int64_t u_sc,
    int64_t u_si, int64_t u_sh, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (hd > TS || N > TS || hd < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int c_vec = c_sn == 1 && N % 4 == 0 && c_si % 4 == 0 &&
                    c_sc % 4 == 0 && c_sb % 4 == 0 && aligned16(C);
  const int s_vec = s_sn == 1 && N % 4 == 0 && s_sd % 4 == 0 &&
                    s_sh % 4 == 0 && s_sc % 4 == 0 && s_sb % 4 == 0 &&
                    aligned16(states);
  Args a{(const float*)states, (const float*)totals, (const float*)C,
         (const float*)cum,    (float*)y,            (float*)final_state,
         (float*)prefix,       B,    nc,   nh,   hd,   N,    Q,
         c_vec, s_vec, s_sb, s_sc, s_sh, s_sd, s_sn, t_sb, t_sc, t_sh,
         c_sb,  c_sc,  c_si, c_sn, u_sb, u_sc, u_si, u_sh};
  return launch(a, (cudaStream_t)stream);
}

// out[5]: registers a thread, CTAs an SM (occupancy API), dynamic shared
// memory, threads, local memory a thread (spills) of `y_kernel`, the
// kernel that does the products
extern "C" int ssd_state_scan_info(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, y_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, y_kernel,
                                                      T_THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = ctas;
  out[2] = SMEM_BYTES;
  out[3] = T_THREADS;
  out[4] = (int)at.localSizeBytes;
  return 0;
}
