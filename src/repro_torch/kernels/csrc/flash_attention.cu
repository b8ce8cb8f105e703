// Flash-attention forward for Hopper (sm_90a): grouped-query attention
// with causal and sliding-window masks from explicit positions and an
// optional logit softcap.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (`_flash_kernel`) in
// src/repro/kernels/flash_attention.py.  q is (B, S, H, hd), k and v are
// (B, T, KV, hd), each with its own strides (the head dim contiguous); query
// head h reads KV head h / (H / KV).  For each query row i:
//
//   s_j = softcap(q_i . k_j * scale)            (cap * tanh(s / cap) if cap > 0)
//   s_j = -1e30 where masked                    (causal: q_pos[i] < k_pos[j];
//                                                window: q_pos[i] - k_pos[j] >= window)
//   out_i = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// computed as an online softmax over KV tiles, with m, l and the output
// accumulator in f32 and the output written in q's dtype (bf16 or f32).
//
// Design.  The TPU kernel walks the KV axis as a sequential grid dimension
// and keeps (m, l, acc) in VMEM scratch across grid steps.  Here one CTA of
// 256 threads owns a 64-row query tile of one (batch, head) and loops over
// 64-row KV tiles itself.  Per tile: K is staged in shared memory as f32, the
// 64x64 score tile S = Q K^T goes to shared memory (each thread a 4x4
// register micro-tile), each warp runs the online-softmax update on 8 rows
// (m and l live in the warp's registers, replicated across its lanes) while
// V is staged into the buffer K used, and each thread accumulates a 4-row by
// hd/16-column slice of the output in registers.  Q is loaded once per CTA,
// pre-scaled (q.astype(f32) * scale, as the reference).  A KV tile whose
// first position lies after the query tile's last (causal) or whose last
// position lies at or before the query tile's first minus the window is
// skipped, as in the reference; positions are taken to be increasing, as
// there.  Query tiles run latest first so the longest causal rows start
// early.  Rows and columns past S and T are zero-filled and excluded from
// the softmax (p = 0), so no length needs to be a multiple of the tile.
//
// Masked scores are -1e30, never -inf: a row that is fully masked in the
// first tile it sees takes p = exp(0) = 1 there, and the first tile with a
// visible key wipes that out through corr = exp(-1e30 - m) = 0.  With -inf
// that update would be exp(-inf + inf) = NaN.
//
// Bound.  At granite-8b's prefill shape the work is 4*B*H*hd*(visible
// pairs) operations against a few hundred MB of q, k, v and out: far above
// the card's ridge point, so bound by operations.  This kernel is plain f32
// FMA on the CUDA cores (about 67 TFLOP/s peak on the H100), not the tensor
// cores (989 TFLOP/s bf16); mma/wgmma tiles, TMA loads and a pipelined KV
// ring are left to later work.
//
// Shared memory: Q (64 x (HDP+4)) + K/V (64 x (HDP+4)) + S/P (64 x 68) f32,
// 85.5 KB at hd = 128 and 148 KB at hd = 256, above the 48 KB static limit,
// so it is dynamic and the launcher raises the kernel's limit first.  The +4
// padding keeps the 16-byte row loads of K free of bank conflicts.  HDP is
// hd rounded up to a multiple of 64, the width of the P.V column split: a
// head dim of 112 (zamba2) is staged in tiles 128 wide whose last 16
// columns are zero, and only its 112 columns are stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BQ / WARPS;  // softmax rows per warp
constexpr int LDP = BK + 4;      // row stride of the score tile (floats)
constexpr float NEG = -1e30f;
static_assert(BQ == BK, "load_tile stages BQ = BK rows");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* o;
  int B, S, T, H, KV;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale, cap;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the head dim padded to the P.V column split
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 63) / 64 * 64;
}

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int LD = padded<HD>() + 4;
  return sizeof(float) * (size_t)(BQ * LD + BK * LD + BQ * LDP + BQ + BQ) +
         sizeof(int) * (size_t)(BQ + BK);
}

// rows x HD tile of a (.., rows, .., HD) tensor into shared memory as f32,
// rows past `n` zero-filled; consecutive threads take consecutive elements
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int n,
                                          float mul) {
  constexpr int LD = padded<HD>() + 4;
  for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] = r < n ? to_f32(src[(int64_t)r * row_stride + d]) * mul
                            : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const Args a) {
  constexpr int HDP = padded<HD>();
  constexpr int LD = HDP + 4;
  constexpr int NC = HDP / 64;  // float4 column groups a thread owns in P.V
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;
  float* corr_s = Ps + BQ * LDP;
  float* l_s = corr_s + BQ;
  int* qp_s = reinterpret_cast<int*>(l_s + BQ);
  int* kp_s = qp_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;  // 16 x 16 micro-tile grid
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BQ;
  const int nrows = min(BQ, a.S - q0);

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                (int64_t)q0 * a.q_ss;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh +
          (int64_t)q0 * a.o_ss;

  // the padding columns of the K/V tile stay zero (tiles write d < HD)
  if constexpr (HDP > HD)
    for (int e = threadIdx.x; e < BK * (HDP - HD); e += THREADS)
      KVs[(e / (HDP - HD)) * LD + HD + e % (HDP - HD)] = 0.f;
  load_tile<T, HD>(Qs, qg, a.q_ss, nrows, a.scale);
  if (tid < BQ) qp_s[tid] = tid < nrows ? a.qpos[q0 + tid] : 0;
  const int q_first = a.qpos[q0], q_last = a.qpos[q0 + nrows - 1];

  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_r[r] = NEG;
    l_r[r] = 0.f;
  }
  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  const int nk = (a.T + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const int ncols = min(BK, a.T - k0);
    // tile-level visibility, the same for every thread of the CTA
    bool visible = true;
    if (a.causal) visible = visible && a.kpos[k0] <= q_last;
    if (a.window > 0)
      visible = visible && a.kpos[k0 + ncols - 1] > q_first - a.window;
    if (!visible) continue;

    __syncthreads();  // the previous tile's P.V is done with KVs and Ps
    load_tile<T, HD>(KVs, kg + (int64_t)k0 * a.k_st, a.k_st, ncols, 1.f);
    if (tid < BK) kp_s[tid] = tid < ncols ? a.kpos[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T: rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // online softmax: warp `warp` owns rows warp*RPW .. +RPW, a lane owns
    // columns lane and lane + 32
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const int qp = qp_s[row];
      float sv[2];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        float x = Ps[row * LDP + j];
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        bool ok = true;
        if (a.causal) ok = ok && qp >= kp_s[j];
        if (a.window > 0) ok = ok && qp - kp_s[j] < a.window;
        sv[c] = ok ? x : NEG;
        if (j < ncols) mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const float p = j < ncols ? expf(sv[c] - m_new) : 0.f;
        Ps[row * LDP + j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * corr + psum;
      m_r[r] = m_new;
      if (lane == 0) corr_s[row] = corr;
    }
    // every thread finished reading K at the barrier before the softmax
    load_tile<T, HD>(KVs, vg + (int64_t)k0 * a.v_st, a.v_st, ncols, 1.f);
    __syncthreads();

    // O = O * corr + P V: rows ty + 16i, columns 64n + 4tx .. +3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = corr_s[ty + 16 * i];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= c;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + j]);
        pv[i][0] = t.x;
        pv[i][1] = t.y;
        pv[i][2] = t.z;
        pv[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(j + jj) * LD + 64 * n + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][n][0] = fmaf(pv[i][jj], vv.x, acc[i][n][0]);
            acc[i][n][1] = fmaf(pv[i][jj], vv.y, acc[i][n][1]);
            acc[i][n][2] = fmaf(pv[i][jj], vv.z, acc[i][n][2]);
            acc[i][n][3] = fmaf(pv[i][jj], vv.w, acc[i][n][3]);
          }
        }
    }
  }

  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RPW; ++r) l_s[warp * RPW + r] = l_r[r];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= nrows) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (64 * n + 4 * tx + e < HD)
          store(&og[(int64_t)row * a.o_ss + 64 * n + 4 * tx + e],
                acc[i][n][e] / l);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(a, stream);
    case 112: return launch<T, 112>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// of q, k, v and out is contiguous.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, int dtype, int B, int S, int T, int H,
    int KV, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, float cap,
    int causal, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  Args a{q,    k,    v,    (const int*)q_pos, (const int*)k_pos, out,  B,
         S,    T,    H,    KV,   q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
         v_sb, v_st, v_sh, o_sb, o_ss, o_sh, scale, cap, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(a, hd, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, hd, st);
  return (int)cudaErrorInvalidValue;
}
