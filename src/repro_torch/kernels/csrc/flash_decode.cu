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
// [lo, pos] are masked in the reference (-1e30 after the softcap) and never
// read here, which gives the same sums whenever one key is visible (always,
// for 0 <= pos); with none visible (pos < 0) the output is 0, as the TPU
// kernel's.
//
// Bound: bytes.  Each cached key and value is read once and used for 2 * G
// multiply-adds each way (G = H / KV query heads per KV head, 1 to 4 here),
// far below the card's ridge point, so the least time is the cache read at
// the memory rate (0.32 ms for granite's 128 x 2048 tokens, 1.07 GB; 0.56
// ms for zamba2's 32 x 4096, 1.88 GB).  The TPU kernel walks the KV blocks
// of one (batch, KV head) as a sequential grid dimension and copies the
// whole cache into (B*KV, T, hd) first.  Here the cache is read in place.
//
// Work and grid.  A unit is one (request, KV head, block of query heads);
// its keys are cut into groups of KG = 16.  Where one head's bf16 row is not
// a whole number of the memory's 64-byte granules (hd 112: 224 bytes, so
// neighbouring heads' rows share a granule) a unit holds two adjacent KV
// heads and takes them in turns, group by group, so that the shared
// granule is read by two warps at the same time and fetched once (the
// wrapper's `kv_heads_per_unit`).  The grid is persistent: `ctas`
// CTAs (the wrapper takes the SMs times the CTAs an SM that the occupancy
// API reports for this instance, so the grid is exactly one full wave) each
// take an equal share of the flattened (unit, group) sequence, so no last
// wave is ragged.  A CTA's share crosses unit boundaries: each stretch of
// it inside one unit is a segment.  A segment that is a whole unit writes
// the output; otherwise it writes (acc, m, l) into slot (cta + unit) of
// `part` and `combine_kernel` merges the slots of each split unit by
// log-sum-exp.
//
// Two kernels do the arithmetic.
// * `tc::decode_tc_kernel` (bf16 at hd 64, 112 and 128, every serving
//   shape): four warps, each with its own three-stage ring of 16-key K and V
//   groups in shared memory, filled by `cp.async` (16 bytes a lane, keys
//   outside [lo, pos] zero-filled and never read), so the next two groups
//   are in flight while one is used; the warps of a CTA take the groups of
//   its share in turn and never wait for each other inside a segment.  A
//   warp computes all of a unit's query heads (up to 16, the rows of the
//   product) from one staged group on the tensor cores, with no per-key
//   shuffle tree: Q.K^T is `mma.sync` m16n8k16 (bf16 in, f32 out; exact in
//   its inputs) with K read by `ldmatrix`, then the scale, softcap, masks
//   and online softmax in f32 on the accumulator fragments, then P.V as
//   P_hi.V + P_lo.V (P split into two bf16 halves, so P keeps f32's
//   precision to 2^-17) with V read by `ldmatrix.trans`.  At the end of a
//   segment the warps merge their (m, l, acc) through shared memory.
// * `flash_decode_kernel` (f32, and bf16 at hd 256): CUDA-core FMA, groups
//   of lanes owning keys, U keys in flight per group, shuffle trees, as
//   before, walking its share of the same persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int KG = 16;  // keys of one group: the grid's unit of work

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;      // (B, H, hd) contiguous, q's dtype
  float* part;  // (ctas + units - 1, kvu * gu, hd + 2) f32 when a unit is cut
  int B, T, H, KV, G;
  int gu;       // query heads of a unit's KV head
  int kvu;      // KV heads of a unit (1, or 2 read in turns)
  int n_gb;     // units per (request, KV head): ceil(G / gu)
  int ng;       // key groups per unit: kvu * ceil(T / KG)
  int ctas;     // CTAs of the persistent grid
  int64_t units;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  float scale, cap;
  int window;
};

// The share of CTA c: groups [first(c), first(c + 1)) of the flattened
// (unit, group) sequence of W = units * ng groups.
__host__ __device__ __forceinline__ int64_t share_first(int64_t c, int64_t W,
                                                        int64_t ctas) {
  return c * W / ctas;
}

// the CTA whose share holds group x (the largest c with first(c) <= x)
__host__ __device__ __forceinline__ int64_t cta_of(int64_t x, int64_t W,
                                                   int64_t ctas) {
  return ((x + 1) * ctas - 1) / W;
}

// A unit: (request b, first KV head, first query head of its block) and
// the keys the request sees, [lo, hi).  Its groups take its kvu KV heads in
// turns: group y is key group y / kvu of KV head kvh + y % kvu.
struct Unit {
  int b, kvh, g0, lo, hi;
};

__device__ __forceinline__ Unit unit_of(const Args& a, int64_t u) {
  Unit r;
  const int kv_units = a.KV / a.kvu;
  r.g0 = (int)(u % a.n_gb) * a.gu;
  r.kvh = (int)((u / a.n_gb) % kv_units) * a.kvu;
  r.b = (int)(u / ((int64_t)a.n_gb * kv_units));
  const int p = a.pos[r.b];
  r.lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  r.hi = min(a.T, p + 1);
  return r;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Writes one merged element of row r of KV head kvh + sub of the unit: the
// output when the segment is its whole unit, else the segment's partial in
// slot (cta + unit).
template <typename T, int HD>
__device__ __forceinline__ void emit(const Args& a, const Unit& un,
                                     int64_t slot, bool whole, int sub, int r,
                                     int d, float acc, float m, float l) {
  const int64_t bh =
      (int64_t)un.b * a.H + (un.kvh + sub) * a.G + un.g0 + r;
  if (whole) {
    store(static_cast<T*>(a.o) + bh * HD + d, acc / fmaxf(l, 1e-30f));
  } else {
    float* pp = a.part + ((slot * a.kvu + sub) * a.gu + r) * (HD + 2);
    pp[d] = acc;
    if (d == 0) {
      pp[HD] = m;
      pp[HD + 1] = l;
    }
  }
}

// ---------------------------------------------------------------- FMA kernel

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;  // keys per lane group in flight

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

// CUDA-core kernel: a CTA of 4 warps walks the segments of its share.  It
// loads a unit's GB query heads once (pre-scaled f32).  In each warp,
// groups of GL lanes each own one key at a time, a lane holding one 16-byte
// vector of the key's row (8 bf16 or 4 f32; two for hd 256 in f32), so
// every key row is read as whole 32-byte sectors; each group keeps U keys
// of K and V in flight before it uses them, reduces its dot products with
// shuffles and runs the online-softmax update once per U keys.  The groups,
// then the warps (through shared memory), merge their (m, l, acc).
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / GL, li = lane % GL;
  const int64_t W = a.units * a.ng;
  const int64_t ge = share_first(blockIdx.x + 1, W, a.ctas);
  for (int64_t sa = share_first(blockIdx.x, W, a.ctas); sa < ge;) {
    const int64_t u = sa / a.ng;
    const int64_t sb = min(ge, (u + 1) * a.ng);
    const bool whole = sa == u * a.ng && sb == (u + 1) * a.ng;
    const Unit un = unit_of(a, u);
    const int ts = max(un.lo, (int)(sa - u * a.ng) * KG);
    const int te = min(un.hi, (int)(sb - u * a.ng) * KG);

    const T* qb = static_cast<const T*>(a.q) + un.b * a.q_sb;
    float qr[GB][E];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const int h = un.kvh * a.G + un.g0 + g;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int slot = j * GL + li;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[g][j * VEC + e] =
              (un.g0 + g < a.G && slot < NV)
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

    const T* kb = static_cast<const T*>(a.k) + un.b * a.k_sb + un.kvh * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + un.b * a.v_sb + un.kvh * a.v_sh;
    constexpr int STEP = WARPS * KPW * U;
    for (int t0 = ts; t0 < te; t0 += STEP) {
      uint4 kr[U][VPL], vr[U][VPL];
      bool ok[U];
#pragma unroll
      for (int u4 = 0; u4 < U; ++u4) {
        const int t = t0 + (warp * U + u4) * KPW + gi;
        ok[u4] = t < te;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int slot = j * GL + li;
          if (ok[u4] && slot < NV) {
            kr[u4][j] = __ldg(reinterpret_cast<const uint4*>(
                kb + (int64_t)t * a.k_st + slot * VEC));
            vr[u4][j] = __ldg(reinterpret_cast<const uint4*>(
                vb + (int64_t)t * a.v_st + slot * VEC));
          } else {
            kr[u4][j] = make_uint4(0u, 0u, 0u, 0u);
            vr[u4][j] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      float s[U][GB];
#pragma unroll
      for (int u4 = 0; u4 < U; ++u4)
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VPL; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot = fmaf(qr[g][j * VEC + e], to_f32_at<T>(kr[u4][j], e), dot);
#pragma unroll
          for (int off = GL / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (a.cap > 0.f) dot = a.cap * tanhf(dot / a.cap);
          s[u4][g] = dot;
        }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u4 = 0; u4 < U; ++u4)
          if (ok[u4]) mx = fmaxf(mx, s[u4][g]);
        const float corr = expf(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u4 = 0; u4 < U; ++u4) {
          if (!ok[u4]) continue;
          const float pu = expf(s[u4][g] - mx);
          l[g] += pu;
#pragma unroll
          for (int j = 0; j < VPL; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[g][j * VEC + e] =
                  fmaf(pu, to_f32_at<T>(vr[u4][j], e), acc[g][j * VEC + e]);
        }
        m[g] = mx;
      }
    }

    // merge the lane groups of the warp (lanes li, li + GL, ... hold the
    // same row elements), then the warps through shared memory
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
      if (un.g0 + g >= a.G) break;
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
      emit<T, HD>(a, un, blockIdx.x + u, whole, 0, g, d, at, mm, lt);
    }
    __syncthreads();  // red_* are reused by the next segment
    sa = sb;
  }
}

// ------------------------------------------------------- tensor-core kernel

namespace tc {

constexpr int STAGES = 3;  // ring slots a warp owns: two groups in flight

template <int HD>
struct Layout {
  static constexpr int ROW = HD + 8;        // bf16; 16-byte pad: no conflicts
  static constexpr int TILE = KG * ROW;     // one group of K or of V
  static constexpr int RING = STAGES * 2 * TILE;  // a warp's ring, bf16
  static constexpr int CPR = HD / 8;        // 16-byte chunks a row
  // bytes: the four rings, then the warps' (acc, m, l) of gu rows
  static constexpr int ring_bytes = WARPS * RING * 2;
  static constexpr int smem_bytes(int gu) {
    return ring_bytes + WARPS * gu * (HD + 2) * 4;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) unless `valid`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b, m16n8k16, bf16 in, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 of a row of q, packed (lower column in the low half); 0 for a
// padding row
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, int d,
                                           bool ok) {
  if (!ok) return 0u;
  __nv_bfloat162 v;
  v.x = row[d];
  v.y = row[d + 1];
  return pack(v);
}

// P split into bf16 halves: hi = bf16(p), lo = bf16(p - hi), two columns
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) decode_tc_kernel(const Args a) {
  using L = Layout<HD>;
  constexpr int NT = HD / 8;  // n-tiles of the output, 8 columns each
  static_assert(HD % 16 == 0, "head dim must be whole k-steps of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::ring_bytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* mine = ring + warp * L::RING;
  const uint32_t mine_u32 = smem_u32(mine);

  const int64_t W = a.units * a.ng;
  const int64_t gs = share_first(blockIdx.x, W, a.ctas);
  const int64_t ge = share_first(blockIdx.x + 1, W, a.ctas);
  // the KV head of the unit this warp takes: its groups are gs + warp +
  // 4 j, and ng and 4 are multiples of kvu
  const int sub = (int)((gs + warp) % a.kvu);
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(a.v);

  // group j of this warp is group gs + warp + WARPS * j of the sequence;
  // stage it in ring slot j % STAGES (an empty commit when there is none or
  // none of its keys is visible, so the count of committed groups stays j)
  auto issue = [&](int j) {
    const int64_t x = gs + warp + (int64_t)WARPS * j;
    if (x < ge) {
      const int64_t u = x / a.ng;
      const int key0 = (int)(x - u * a.ng) / a.kvu * KG;
      const Unit un = unit_of(a, u);
      if (key0 < un.hi && key0 + KG > un.lo) {
        const int kvh = un.kvh + sub;
        const __nv_bfloat16* kb = kc + un.b * a.k_sb + kvh * a.k_sh;
        const __nv_bfloat16* vb = vc + un.b * a.v_sb + kvh * a.v_sh;
        const uint32_t dk = mine_u32 + (j % STAGES) * 2 * L::TILE * 2;
        const uint32_t dv = dk + L::TILE * 2;
#pragma unroll
        for (int i = lane; i < KG * L::CPR; i += 32) {
          const int row = i / L::CPR, col = (i % L::CPR) * 8;
          const int t = key0 + row;
          const bool ok = t >= un.lo && t < un.hi;
          const uint32_t off = (row * L::ROW + col) * 2;
          cp_async16(dk + off, ok ? kb + (int64_t)t * a.k_st + col : kb, ok);
          cp_async16(dv + off, ok ? vb + (int64_t)t * a.v_st + col : vb, ok);
        }
      }
    }
    cp_commit();
  };

  // the warp's ldmatrix row addresses within a group (bytes): K for
  // Q.K^T (matrix l/8: keys (l/16)*8 + l%8, columns + ((l/8)%2)*8) and V
  // for P.V (keys ((l/8)%2)*8 + l%8, columns + (l/16)*8)
  const uint32_t k_lane =
      (((lane >> 4) * 8 + (lane & 7)) * L::ROW + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_lane =
      ((((lane >> 3) & 1) * 8 + (lane & 7)) * L::ROW + (lane >> 4) * 8) * 2;

  int j = 0;  // the warp's next group to use
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int64_t sa = gs; sa < ge;) {
    const int64_t u = sa / a.ng;
    const int64_t sb = min(ge, (u + 1) * a.ng);
    const bool whole = sa == u * a.ng && sb == (u + 1) * a.ng;
    const Unit un = unit_of(a, u);
    const int rows = min(a.gu, a.G - un.g0);  // real rows of the product

    // Q as A fragments, one per k-step: rows g and g + 8, columns 2 tig
    // (+1) and 2 tig + 8 (+9); padding rows are 0
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + un.b * a.q_sb;
    const __nv_bfloat16* q0 =
        qb + ((un.kvh + sub) * a.G + un.g0 + g) * a.q_sh;
    const __nv_bfloat16* q8 = q0 + 8 * a.q_sh;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int d = kk * 16 + 2 * tig;
      qa[kk][0] = q_pair(q0, d, g < rows);
      qa[kk][1] = q_pair(q8, d, g + 8 < rows);
      qa[kk][2] = q_pair(q0, d + 8, g < rows);
      qa[kk][3] = q_pair(q8, d + 8, g + 8 < rows);
    }
    // per row (g, g + 8): running max, this lane's part of the sum, and
    // the output fragments (c0, c1 row g; c2, c3 row g + 8)
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int64_t x = gs + warp + (int64_t)WARPS * j; x < sb;
         ++j, x += WARPS) {
      issue(j + STAGES - 1);
      cp_wait<STAGES - 1>();
      __syncwarp();
      const int key0 = (int)(x - u * a.ng) / a.kvu * KG;
      if (key0 < un.hi && key0 + KG > un.lo) {
        const uint32_t kbase = mine_u32 + (j % STAGES) * 2 * L::TILE * 2;
        const uint32_t vbase = kbase + L::TILE * 2;
        // S = Q.K^T: two n-tiles of 8 keys
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t b[4];
          ldsm_x4(kbase + k_lane + kk * 32, b);
          mma(s[0], qa[kk], b[0], b[1]);
          mma(s[1], qa[kk], b[2], b[3]);
        }
        // scale, softcap, masks, online softmax in f32; element e of tile t
        // is row g + 8 (e / 2), key key0 + 8 t + 2 tig + e % 2
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = s[t][e] * a.scale;
            if (a.cap > 0.f) v = a.cap * tanhf(v / a.cap);
            const int key = key0 + 8 * t + 2 * tig + (e & 1);
            v = (key >= un.lo && key < un.hi) ? v : NEG;
            s[t][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = expf(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= corr[r];
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t][e] = expf(s[t][e] - mx[e >> 1]);
            l[e >> 1] += s[t][e];
          }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
        // P as A fragments (rows g, g + 8; keys 2 tig (+1), 8 + 2 tig (+1))
        uint32_t ph[4], pl[4];
        split_p(s[0][0], s[0][1], ph[0], pl[0]);
        split_p(s[0][2], s[0][3], ph[1], pl[1]);
        split_p(s[1][0], s[1][1], ph[2], pl[2]);
        split_p(s[1][2], s[1][3], ph[3], pl[3]);
        // O += P_hi.V + P_lo.V, two n-tiles of 8 columns a load
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_t(vbase + v_lane + dn * 32, b);
          mma(acc[2 * dn], ph, b[0], b[1]);
          mma(acc[2 * dn], pl, b[0], b[1]);
          mma(acc[2 * dn + 1], ph, b[2], b[3]);
          mma(acc[2 * dn + 1], pl, b[2], b[3]);
        }
      }
      __syncwarp();  // the slot is read before a later issue refills it
    }

    // the segment's end: each warp's (m, l, acc) of its real rows to
    // shared memory, then every thread merges columns across the warps
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float* wr = red + warp * a.gu * (HD + 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= rows) continue;
      float* dst = wr + row * (HD + 2);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8 + 2 * tig) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (tig == 0) {
        dst[HD] = m[r];
        dst[HD + 1] = l[r];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < a.kvu * rows * HD; idx += THREADS) {
      const int rr = idx / HD, d = idx % HD;
      const int sb2 = rr / rows, r = rr % rows;  // KV head of the unit, row
      float mm = NEG;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if ((gs + w) % a.kvu == sb2)
          mm = fmaxf(mm, red[(w * a.gu + r) * (HD + 2) + HD]);
      float lt = 0.f, at = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((gs + w) % a.kvu != sb2) continue;
        const float* src = red + (w * a.gu + r) * (HD + 2);
        const float c = expf(src[HD] - mm);
        lt += src[HD + 1] * c;
        at += src[d] * c;
      }
      emit<__nv_bfloat16, HD>(a, un, blockIdx.x + u, whole, sb2, r, d, at,
                              mm, lt);
    }
    __syncthreads();  // the merge area is reused by the next segment
    sa = sb;
  }
  cp_wait<0>();  // no copy outlives the CTA
}

}  // namespace tc

// merges the partials of each unit that more than one CTA's share cut, by
// log-sum-exp; one CTA a unit (a whole unit returns at once)
template <typename T, int HD>
__global__ void combine_kernel(const Args a) {
  const int64_t u = blockIdx.x;
  const int64_t W = a.units * a.ng;
  const int64_t c0 = cta_of(u * a.ng, W, a.ctas);
  const int64_t c1 = cta_of((u + 1) * a.ng - 1, W, a.ctas);
  if (c0 == c1) return;
  const Unit un = unit_of(a, u);
  const int rows = min(a.gu, a.G - un.g0);
  for (int idx = threadIdx.x; idx < a.kvu * rows * HD; idx += blockDim.x) {
    const int rr = idx / HD, d = idx % HD;
    const int sub = rr / rows, r = rr % rows;
    const int64_t row = sub * a.gu + r;  // of a slot's kvu * gu rows
    const int64_t stride = (int64_t)a.kvu * a.gu * (HD + 2);
    const float* p0 = a.part + (u * a.kvu * a.gu + row) * (HD + 2);
    float mm = NEG;
    for (int64_t c = c0; c <= c1; ++c)
      mm = fmaxf(mm, p0[c * stride + HD]);
    float lt = 0.f, at = 0.f;
    for (int64_t c = c0; c <= c1; ++c) {
      const float* pp = p0 + c * stride;
      const float w = expf(pp[HD] - mm);
      lt += pp[HD + 1] * w;
      at += pp[d] * w;
    }
    emit<T, HD>(a, un, 0, true, sub, r, d, at, mm, lt);
  }
}

// what one kernel instance gets: registers a thread, CTAs an SM (occupancy
// API), dynamic shared memory, threads, local memory a thread (spills)
template <typename Kernel>
int info(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = ctas;
  out[2] = smem;
  out[3] = THREADS;
  out[4] = (int)at.localSizeBytes;
  return 0;
}

// the tensor-core instance's shared-memory attributes, set once: room for
// the largest block of query heads, and the whole carveout for shared memory
template <int HD>
cudaError_t tc_prepare() {
  static cudaError_t done = [] {
    cudaError_t err = cudaFuncSetAttribute(
        tc::decode_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::Layout<HD>::smem_bytes(16));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(tc::decode_tc_kernel<HD>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return done;
}

template <typename T, int HD, int GB>
int launch_fma(const Args& a, bool combine, cudaStream_t stream) {
  flash_decode_kernel<T, HD, GB><<<a.ctas, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !combine) return (int)err;
  combine_kernel<T, HD><<<(unsigned)a.units, 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a, bool combine, cudaStream_t stream) {
  cudaError_t err = tc_prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  tc::decode_tc_kernel<HD>
      <<<a.ctas, THREADS, tc::Layout<HD>::smem_bytes(a.gu), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !combine) return (int)err;
  combine_kernel<__nv_bfloat16, HD><<<(unsigned)a.units, 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_gb(const Args& a, bool combine, cudaStream_t stream) {
  switch (a.gu) {
    case 1: return launch_fma<T, HD, 1>(a, combine, stream);
    case 2: return launch_fma<T, HD, 2>(a, combine, stream);
    case 4: return launch_fma<T, HD, 4>(a, combine, stream);
    case 8: return launch_fma<T, HD, 8>(a, combine, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_fma(const Args& a, int hd, bool combine, cudaStream_t stream) {
  switch (hd) {
    case 64: return dispatch_gb<T, 64>(a, combine, stream);
    case 112: return dispatch_gb<T, 112>(a, combine, stream);
    case 128: return dispatch_gb<T, 128>(a, combine, stream);
    case 256: return dispatch_gb<T, 256>(a, combine, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
int fma_info(int gb, int* out) {
  switch (gb) {
    case 1: return info(flash_decode_kernel<T, HD, 1>, 0, out);
    case 2: return info(flash_decode_kernel<T, HD, 2>, 0, out);
    case 4: return info(flash_decode_kernel<T, HD, 4>, 0, out);
    case 8: return info(flash_decode_kernel<T, HD, 8>, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HD>
int tc_info(int gu, int* out) {
  if (gu < 1 || gu > 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = tc_prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  return info(tc::decode_tc_kernel<HD>, tc::Layout<HD>::smem_bytes(gu), out);
}

}  // namespace

// route: 1 = the tensor-core kernel (bf16, hd 64/112/128, gb 1..16), 0 =
// the FMA kernel (gb 1, 2, 4 or 8).  dtype: 0 = float32, 1 = bfloat16.
// Strides in elements; the head dim of q and the caches is contiguous,
// every cache stride a whole number of 16-byte vectors and the caches
// 16-byte aligned.  gb query heads a unit, n_gb = ceil(G / gb) units a
// (request, KV head); `ctas` CTAs share the units' ceil(T / 16) key groups
// each; `combine` when a share boundary cuts a unit, and then part is
// scratch of (ctas + units - 1, gb, hd + 2) f32.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part, int route, int dtype, int B, int T, int H, int KV, int hd,
    int gb, int kvu, int ctas, int combine, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, float cap, int window, void* stream) {
  if (B == 0) return 0;
  const int G = H / KV;
  const int n_gb = (G + gb - 1) / gb;
  if (kvu < 1 || KV % kvu || (kvu > 1 && route != 1))
    return (int)cudaErrorInvalidValue;
  const int ng = (T + KG - 1) / KG * kvu;
  Args a{q,    k,    v,     (const int*)pos, out, (float*)part, B, T, H, KV,
         G,    gb,   kvu,   n_gb, ng,  ctas, (int64_t)B * (KV / kvu) * n_gb,
         q_sb, q_sh, k_sb,  k_st, k_sh, v_sb, v_st, v_sh, scale, cap, window};
  if (ctas < 1 || (int64_t)ctas > a.units * ng)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1 || gb > 16) return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 64: return launch_tc<64>(a, combine, st);
      case 112: return launch_tc<112>(a, combine, st);
      case 128: return launch_tc<128>(a, combine, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) return dispatch_fma<float>(a, hd, combine, st);
  if (dtype == 1) return dispatch_fma<__nv_bfloat16>(a, hd, combine, st);
  return (int)cudaErrorInvalidValue;
}

// out[5]: registers a thread, CTAs an SM, dynamic shared memory, threads,
// local memory a thread of the instance a launch with these arguments runs
extern "C" int flash_decode_info(int route, int dtype, int hd, int gb,
                                 int* out) {
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 64: return tc_info<64>(gb, out);
      case 112: return tc_info<112>(gb, out);
      case 128: return tc_info<128>(gb, out);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype * 1000 + hd) {
    case 64: return fma_info<float, 64>(gb, out);
    case 112: return fma_info<float, 112>(gb, out);
    case 128: return fma_info<float, 128>(gb, out);
    case 256: return fma_info<float, 256>(gb, out);
    case 1064: return fma_info<__nv_bfloat16, 64>(gb, out);
    case 1112: return fma_info<__nv_bfloat16, 112>(gb, out);
    case 1128: return fma_info<__nv_bfloat16, 128>(gb, out);
    case 1256: return fma_info<__nv_bfloat16, 256>(gb, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
