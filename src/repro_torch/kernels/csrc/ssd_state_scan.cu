// SSD inter-chunk state scan for Hopper (sm_90a): the sequential part of the
// chunked Mamba2 scan, fused with the output it feeds.
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
// Bound: bytes.  Per chunk and head the work is a (Q x N) @ (N x hd)
// product, 2 * Q * N * hd flops against the 4 * Q * hd bytes of its output:
// 32 flops a byte at N = 64, below the f32 ridge point of the card (67
// TFLOP/s over 3.35 TB/s, 20 flops a byte) once the states and C are
// counted too, so the least time is the bytes: at zamba2's prefill
// (B 4, nc 16, nh 112, hd = N = 64, Q 256) about 0.61 GB, 0.18 ms, almost
// all of it y.  The TPU kernel walks the chunks as a sequential grid
// dimension with the state in VMEM scratch, after transposing states, cum
// and y into per-head layouts.  Here one CTA of 256 threads owns one
// (batch, head) and loops over the chunks itself, the state resident in
// shared memory (64 x 68 f32, zero-padded to 64 x 64 for smaller hd or N).
// Per chunk it stages C in 64-row tiles; each thread computes a 4 x 4
// micro-tile of y (rows ty + 16a, columns tx + 16b), so a warp stores two
// 64-byte row segments at a time; then every thread updates its share of
// the state with the chunk's own (hd x N) block, read as contiguous rows.
// hd and N are at most 64; Q and nc are any size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 64;        // state tile: hd and N padded to this
constexpr int LD = TS + 4;    // row stride of the shared tiles (floats)
constexpr int THREADS = 256;

struct Args {
  const float* states;
  const float* totals;
  const float* C;
  const float* cum;
  float* y;
  float* final_state;
  int B, nc, nh, hd, N, Q;
  int64_t s_sb, s_sc, s_sh, s_sd, s_sn;
  int64_t t_sb, t_sc, t_sh;
  int64_t c_sb, c_sc, c_si, c_sn;
  int64_t u_sb, u_sc, u_si, u_sh;
};

__global__ void __launch_bounds__(THREADS) ssd_state_scan_kernel(const Args a) {
  __shared__ __align__(16) float S[TS * LD];   // state: row d, column n
  __shared__ __align__(16) float Cs[TS * LD];  // C tile: row i, column n
  __shared__ float ecum[TS];                   // exp(cum) of the tile's rows

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int NP = (a.N + 3) & ~3;  // contraction length, zero-padded

  for (int e = tid; e < TS * LD; e += THREADS) {
    S[e] = 0.f;
    Cs[e] = 0.f;
  }
  __syncthreads();

  for (int c = 0; c < a.nc; ++c) {
    const float* Cc = a.C + b * a.c_sb + c * a.c_sc;
    const float* uc = a.cum + b * a.u_sb + c * a.u_sc + h * a.u_sh;
    float* yc = a.y + (((int64_t)b * a.nc + c) * a.Q * a.nh + h) * a.hd;
    const int64_t y_si = (int64_t)a.nh * a.hd;  // y's row stride
    for (int i0 = 0; i0 < a.Q; i0 += TS) {
      const int rows = min(TS, a.Q - i0);
      for (int e = tid; e < TS * a.N; e += THREADS) {
        const int r = e / a.N, n = e % a.N;
        Cs[r * LD + n] = r < rows ? Cc[(int64_t)(i0 + r) * a.c_si + n * a.c_sn]
                                  : 0.f;
      }
      if (tid < TS) ecum[tid] = tid < rows ? expf(uc[(int64_t)(i0 + tid) * a.u_si])
                                           : 0.f;
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < NP; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LD + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = *reinterpret_cast<const float4*>(&S[(tx + 16 * j) * LD + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv[i].x, sv[j].x, acc[i][j]);
            acc[i][j] = fmaf(cv[i].y, sv[j].y, acc[i][j]);
            acc[i][j] = fmaf(cv[i].z, sv[j].z, acc[i][j]);
            acc[i][j] = fmaf(cv[i].w, sv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const float ec = ecum[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx + 16 * j;
          if (d < a.hd) yc[(int64_t)(i0 + r) * y_si + d] = acc[i][j] * ec;
        }
      }
      __syncthreads();  // Cs, ecum and S are read; the next tile or the
                        // state update may overwrite them
    }
    const float decay = expf(a.totals[b * a.t_sb + c * a.t_sc + h * a.t_sh]);
    const float* sc = a.states + b * a.s_sb + c * a.s_sc + h * a.s_sh;
    for (int e = tid; e < a.hd * a.N; e += THREADS) {
      const int d = e / a.N, n = e % a.N;
      S[d * LD + n] = S[d * LD + n] * decay + sc[d * a.s_sd + n * a.s_sn];
    }
    __syncthreads();
  }
  float* fin = a.final_state + ((int64_t)b * a.nh + h) * a.hd * a.N;
  for (int e = tid; e < a.hd * a.N; e += THREADS)
    fin[e] = S[(e / a.N) * LD + e % a.N];
}

}  // namespace

// All strides in elements.  hd and N at most 64.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_state_scan_launch(
    const void* states, const void* totals, const void* C, const void* cum,
    void* y, void* final_state, int B, int nc, int nh, int hd, int N, int Q,
    int64_t s_sb, int64_t s_sc, int64_t s_sh, int64_t s_sd, int64_t s_sn,
    int64_t t_sb, int64_t t_sc, int64_t t_sh, int64_t c_sb, int64_t c_sc,
    int64_t c_si, int64_t c_sn, int64_t u_sb, int64_t u_sc, int64_t u_si,
    int64_t u_sh, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (hd > TS || N > TS || hd < 1 || N < 1) return (int)cudaErrorInvalidValue;
  Args a{(const float*)states, (const float*)totals, (const float*)C,
         (const float*)cum,    (float*)y,            (float*)final_state,
         B,    nc,   nh,   hd,   N,    Q,    s_sb, s_sc, s_sh, s_sd, s_sn,
         t_sb, t_sc, t_sh, c_sb, c_sc, c_si, c_sn, u_sb, u_sc, u_si, u_sh};
  ssd_state_scan_kernel<<<B * nh, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
