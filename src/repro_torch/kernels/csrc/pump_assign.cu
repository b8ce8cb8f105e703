// Pump window assignment of the StreamSim wave program, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pump_assign_pallas` in
// src/repro/core/jax_device_loop.py.  For each member m and lane l:
//
//   out[m, l] = max(t_ready[m, l], ring[gid[m], idx_on[m] % P, l])
//                                      if idx_on[m] >= P and valid[m]
//   out[m, l] = max(t_ready[m, l], 0)  otherwise
//
// `ring` is the per-consumer (delivery pump) or per-producer (reply pump)
// prefetch/ack ring, (R, P, L) float64; t_ready and out are (Np, L) float64;
// gid and idx_on are (Np,) int64; valid is (Np,) bool, one byte each.
//
// Bound: memory and launch latency.  The work is one gather and one max per
// element, with no reduction and no reuse: at Np = 8192 and L = 3 it moves
// about 0.7 MB, about 0.2 us at 3.35 TB/s, well under the few microseconds
// of one launch.  The TPU kernel was a single block walking the members in a
// serial loop because the whole ring fit in VMEM; the members are
// independent, so here every (m, l) element is its own thread, on the flat
// index m * L + l, which keeps the loads of t_ready and the stores of out
// coalesced.  A thread reads the ring only when its gate applies.  The
// result is exact: a gather and a max, no rounding.  idx_on is never
// negative, so C's % agrees with the Python/NumPy modulo of the reference.
// Hiding the launch (fusing with the gathers around it, or capturing the
// step loop in a CUDA graph) is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pump_assign_kernel(const double* __restrict__ ring,
                                   const double* __restrict__ t_ready,
                                   const int64_t* __restrict__ gid,
                                   const int64_t* __restrict__ idx_on,
                                   const uint8_t* __restrict__ valid,
                                   double* __restrict__ out,
                                   int64_t n, int64_t lanes, int64_t P) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int64_t m = e / lanes;
  int64_t l = e - m * lanes;
  double t = t_ready[e];
  double g = 0.0;
  int64_t i = idx_on[m];
  if (valid[m] && i >= P) {
    g = ring[(gid[m] * P + i % P) * lanes + l];
  }
  // NumPy's maximum: NaN if either side is NaN
  out[e] = (t >= g || t != t) ? t : g;
}

extern "C" int pump_assign_launch(const void* ring, const void* t_ready,
                                  const void* gid, const void* idx_on,
                                  const void* valid, void* out,
                                  int64_t n_members, int64_t lanes, int64_t P,
                                  void* stream) {
  int64_t n = n_members * lanes;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  pump_assign_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const double*)ring, (const double*)t_ready, (const int64_t*)gid,
      (const int64_t*)idx_on, (const uint8_t*)valid, (double*)out, n, lanes,
      P);
  return (int)cudaGetLastError();
}
