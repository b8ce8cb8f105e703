// Flash decode for Hopper (sm_90a): one query token per request against a
// KV cache, grouped-query, with an optional sliding window and logit
// softcap; keys past each request's position are never read.
//
// Replaces the Pallas TPU kernel `flash_decode` (`_decode_kernel`) in
// src/repro/kernels/decode_attention.py.  q is (B, H, hd), the caches are
// (B, T, KV, hd) with their own strides (the head dim contiguous), pos is
// (B,) int32; query head h reads KV head h / (H / KV).  For each (b, h):
//
//   s_t = softcap(q . k_t * scale)     for lo <= t <= min(pos[b], T - 1),
//                                      lo = max(0, pos[b] - window + 1) if window
//   out = sum_t exp(s_t - m) v_t / max(sum_t exp(s_t - m), 1e-30)
//
// with (m, l, acc) in f32 and the output written in q's dtype.  Keys outside
// [lo, pos] are masked in the reference (-1e30 after the softcap) and skipped
// here, which gives the same sums whenever one key is visible (always, for
// 0 <= pos); with none visible (pos < 0) the output is 0, as the TPU
// kernel's.
//
// Bound: bytes.  Each cached key and value is read once and used for 2 * G
// multiply-adds each way (G = H / KV query heads per KV head, 1 to 4 here),
// far below the card's ridge point, so the least time is the cache read at
// the memory rate (0.32 ms for granite's 128 x 2048 tokens, 1.07 GB).  The
// TPU kernel walks the KV blocks of one (batch, KV head) as a sequential
// grid dimension and copies the whole cache into (B*KV, T, hd) first.  Here
// the cache is read in place, and the keys of one (batch, KV head) are cut
// into n_split ranges so that a single long request still spreads over all
// SMs: the grid is (B * KV * n_gb, n_split), n_gb blocks of GB query heads
// of the group, n_split chosen by the wrapper from B * KV and the SM count.
// A CTA of 4 warps loads its GB query heads once (pre-scaled f32).  In each
// warp, groups of GL lanes each own one key at a time, a lane holding one
// 16-byte vector of the key's row (8 bf16 or 4 f32; two for hd 256 in f32),
// so every key row is read as whole 32-byte sectors; each group keeps U keys
// of K and V in flight before it uses them.  A group reduces its dot
// products with shuffles and runs the online-softmax update once per U keys.
// The groups, then the warps (through shared memory), merge their
// (m, l, acc) by log-sum-exp.  With one split the CTA writes the output;
// otherwise it writes (acc, m, l) for its range, and a second small kernel
// merges the splits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;  // keys per lane group in flight
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;      // (B, H, hd) contiguous, q's dtype
  float* part;  // (n_split, B, H, hd + 2) f32 when n_split > 1: acc, m, l
  int B, T, H, KV, G, n_gb, n_split, chunk;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  float scale, cap;
  int window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// element i of a 16-byte vector of T, as f32
template <typename T>
__device__ __forceinline__ float to_f32_at(const uint4& raw, int i) {
  return to_f32(reinterpret_cast<const T*>(&raw)[i]);
}

__host__ __device__ constexpr int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int NV = HD / VEC;               // vectors per key row
  constexpr int GL = NV >= 32 ? 32 : pow2ceil(NV);  // lanes per key
  constexpr int VPL = (NV + GL - 1) / GL;    // vectors per lane
  constexpr int KPW = 32 / GL;               // keys per warp at a time
  constexpr int E = VPL * VEC;               // row elements per lane
  static_assert(HD % VEC == 0, "head dim must be whole 16-byte vectors");
  __shared__ float red_acc[WARPS][GB][HD];
  __shared__ float red_m[WARPS][GB], red_l[WARPS][GB];

  const int bkg = blockIdx.x;
  const int split = blockIdx.y;
  const int gblk = bkg % a.n_gb;
  const int kvh = (bkg / a.n_gb) % a.KV;
  const int b = bkg / (a.n_gb * a.KV);
  const int g0 = gblk * GB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / GL, li = lane % GL;

  const int p = a.pos[b];
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int hi = min(a.T, p + 1);
  const int ts = max(lo, split * a.chunk);
  const int te = min(hi, split * a.chunk + a.chunk);

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  float qr[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int h = kvh * a.G + g0 + g;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int slot = j * GL + li;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][j * VEC + e] =
            (g0 + g < a.G && slot < NV)
                ? to_f32(qb[h * a.q_sh + slot * VEC + e]) * a.scale
                : 0.f;
    }
  }
  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  constexpr int STEP = WARPS * KPW * U;
  for (int t0 = ts; t0 < te; t0 += STEP) {
    uint4 kr[U][VPL], vr[U][VPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + (warp * U + u) * KPW + gi;
      ok[u] = t < te;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int slot = j * GL + li;
        if (ok[u] && slot < NV) {
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(
              kb + (int64_t)t * a.k_st + slot * VEC));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(
              vb + (int64_t)t * a.v_st + slot * VEC));
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qr[g][j * VEC + e], to_f32_at<T>(kr[u][j], e), dot);
#pragma unroll
        for (int off = GL / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (a.cap > 0.f) dot = a.cap * tanhf(dot / a.cap);
        s[u][g] = dot;
      }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float pu = expf(s[u][g] - mx);
        l[g] += pu;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][j * VEC + e] =
                fmaf(pu, to_f32_at<T>(vr[u][j], e), acc[g][j * VEC + e]);
      }
      m[g] = mx;
    }
  }

  // merge the lane groups of the warp (lanes li, li + GL, ... hold the same
  // row elements), then the warps through shared memory
#pragma unroll
  for (int off = GL; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mm), cb = expf(mo - mm);
      l[g] = l[g] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mm;
    }
  if (gi == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int slot = j * GL + li;
        if (slot < NV)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red_acc[warp][g][slot * VEC + e] = acc[g][j * VEC + e];
      }
      if (li == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * HD; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    if (g0 + g >= a.G) break;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, red_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(red_m[w][g] - mm);
      lt += red_l[w][g] * c;
      at += red_acc[w][g][d] * c;
    }
    const int h = kvh * a.G + g0 + g;
    const int64_t bh = (int64_t)b * a.H + h;
    if (a.n_split == 1) {
      store(static_cast<T*>(a.o) + bh * HD + d, at / fmaxf(lt, 1e-30f));
    } else {
      float* pp = a.part + ((int64_t)split * a.B * a.H + bh) * (HD + 2);
      pp[d] = at;
      if (d == 0) {
        pp[HD] = mm;
        pp[HD + 1] = lt;
      }
    }
  }
}

// merges the n_split partial results of one (b, h) by log-sum-exp
template <typename T, int HD>
__global__ void combine_kernel(const Args a) {
  const int64_t bh = blockIdx.x;
  const int64_t stride = (int64_t)a.B * a.H * (HD + 2);
  const float* p0 = a.part + bh * (HD + 2);
  float mm = NEG;
  for (int s = 0; s < a.n_split; ++s) mm = fmaxf(mm, p0[s * stride + HD]);
  float lt = 0.f;
  for (int s = 0; s < a.n_split; ++s)
    lt += p0[s * stride + HD + 1] * expf(p0[s * stride + HD] - mm);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float at = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      at += p0[s * stride + d] * expf(p0[s * stride + HD] - mm);
    store(static_cast<T*>(a.o) + bh * HD + d, at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int HD, int GB>
int launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.B * a.KV * a.n_gb, a.n_split);
  flash_decode_kernel<T, HD, GB><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  combine_kernel<T, HD><<<a.B * a.H, HD < 128 ? HD : 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_gb(const Args& a, int gb, cudaStream_t stream) {
  switch (gb) {
    case 1: return launch<T, HD, 1>(a, stream);
    case 2: return launch<T, HD, 2>(a, stream);
    case 4: return launch<T, HD, 4>(a, stream);
    case 8: return launch<T, HD, 8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(const Args& a, int hd, int gb, cudaStream_t stream) {
  switch (hd) {
    case 64: return dispatch_gb<T, 64>(a, gb, stream);
    case 112: return dispatch_gb<T, 112>(a, gb, stream);
    case 128: return dispatch_gb<T, 128>(a, gb, stream);
    case 256: return dispatch_gb<T, 256>(a, gb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; the head dim of
// q and the caches is contiguous, every cache stride a whole number of
// 16-byte vectors and the caches 16-byte aligned.  gb query heads per CTA
// (1, 2, 4 or 8), n_gb = ceil(G / gb); n_split ranges of `chunk` keys; part
// is scratch of (n_split, B, H, hd + 2) f32 when n_split > 1.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part, int dtype, int B, int T, int H, int KV, int hd, int gb,
    int n_split, int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, float cap, int window, void* stream) {
  if (B == 0) return 0;
  const int G = H / KV;
  Args a{q,    k,    v,    (const int*)pos, out, (float*)part, B, T, H, KV,
         G,    (G + gb - 1) / gb, n_split, chunk, q_sb, q_sh, k_sb, k_st,
         k_sh, v_sb, v_st, v_sh, scale, cap, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(a, hd, gb, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, hd, gb, st);
  return (int)cudaErrorInvalidValue;
}
