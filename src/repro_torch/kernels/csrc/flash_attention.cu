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
// computed as an online softmax over KV tiles, with the scores, m, l and the
// output accumulator in f32 and the output written in q's dtype.  As in the
// TPU kernel, a KV tile whose first position lies after the query tile's
// last (causal) or whose last position lies at or before the query tile's
// first minus the window is skipped; positions are taken to be increasing.
// Query tiles run latest first, so the longest causal rows start early.
// Rows and columns past S and T are never stored and never enter the
// softmax, so no length needs to be a multiple of a tile.
//
// Masked scores are -1e30, never -inf: a row that is fully masked in the
// first tile it sees takes p = exp(0) = 1 there, and the first tile with a
// visible key wipes that out through corr = exp(-1e30 - m) = 0.  With -inf
// that update would be exp(-inf + inf) = NaN.
//
// Two kernels, the route chosen by the wrapper before any launch:
//
// * `tc::flash_tc_kernel`, bf16 at hd 64, 112 and 128 with TMA-aligned
//   operands: both products on the tensor cores (`wgmma`, f32 accumulation).
//   A CTA holds 128 query rows of one (batch, head) and runs 288 threads:
//   two consumer warpgroups of 64 rows each and one producer warp.  The
//   producer's lane 0 loads the CTA's Q tile once and then every visible
//   64-key K and V tile into a ring of STAGES slots in shared memory by TMA
//   (4-D tensor maps over the strided q, k, v: the inputs are read in place,
//   rows past S or T arrive as zeros), each slot guarded by a `full` and an
//   `empty` mbarrier, so the next tiles load while the current one is
//   multiplied.  A consumer warpgroup computes S = Q K^T with Q and K as
//   they are in bf16 (their products are exact; the scale is applied to the
//   f32 accumulator, which equals the reference's (q * scale) . k within f32
//   rounding), keeps S and P in registers, runs the softcap, the position
//   masks and the online softmax in f32, and feeds P to the P.V `wgmma` as
//   its register operand.  P is split into two bf16 halves,
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both are multiplied by
//   the same V tile into one f32 accumulator: P keeps about 2^-17 of
//   relative precision, where bf16 alone (2^-9) would miss the f32
//   reference by far more than the output's own rounding.  l sums the f32
//   P.  Two overlaps keep the tensor cores fed: a warpgroup issues a tile's
//   Q.K^T together with the previous tile's P.V, and the two warpgroups
//   take turns (two named barriers), so one's softmax runs while the
//   other's products do.  hd 112 runs the hd-128 kernel: TMA fills the
//   last 16 columns with zeros and only 112 columns are stored.  Shared
//   memory: Q (128 x 128) and STAGES = 4 x (K and V, 64 x 128) in bf16, in
//   128-byte swizzled 64-column slabs, 161 KB.  Registers: at 288 threads
//   the compiler caps a thread at 168 (the S, P and O tiles take 128 of
//   them), so Q stays in shared memory and KV tiles are 64 keys; one CTA
//   an SM.
// * `flash_fwd_kernel`, f32 at any hd and bf16 at hd 256 (and bf16 whose
//   pointers or strides TMA cannot take): plain f32 FMA on the CUDA cores.
//   One CTA of 256 threads owns a 64-row query tile and loops over 64-row
//   KV tiles; K and V are staged in shared memory as f32, the 64x64 score
//   tile goes through shared memory, each warp runs the online softmax on
//   8 rows, each thread accumulates a 4-row by hd/16-column slice.  Q is
//   pre-scaled (q.astype(f32) * scale, as the reference).  Shared memory is
//   85.5 KB at hd = 128 and 148 KB at hd = 256 (dynamic); HDP, hd rounded up
//   to 64, stages hd 112 as 128 columns.
//
// Bound.  At granite-8b's prefill shape the function is 4*B*H*hd*(visible
// pairs) operations against a few hundred MB of q, k, v and out: far above
// the card's ridge point, so bound by operations, 0.556 ms at the H100's
// 989 TFLOP/s in bf16.  The tensor-core kernel does 6*B*H*hd*pairs (P.V
// twice), so its own floor is 1.5x that, 0.83 ms; the FMA kernel's is the
// function's operations at the 67 TFLOP/s of the CUDA cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

namespace tc {

constexpr int WG_ROWS = 64;                  // query rows a consumer warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups a CTA
constexpr int BQ = WG_ROWS * CONSUMERS;      // query rows a CTA
constexpr int BK = 64;                       // keys a KV tile
constexpr int STAGES = 4;                    // K/V ring slots
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int THREADS = 32 * (PRODUCER_WARP + 1);
constexpr int SLAB = 64;                     // columns of one swizzled slab
constexpr int ROW_BYTES = SLAB * 2;          // 128 bytes: the swizzle span
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const int* qpos;
  const int* kpos;
  __nv_bfloat16* o;
  int S, T, H, KV, hd;
  int64_t o_sb, o_ss, o_sh;
  float scale, cap;
  int causal, window;
};

// shared memory of a kernel staging HDP (64 or 128) columns of the head dim
template <int HDP>
constexpr size_t smem_bytes() {
  // + 1024 to align the tiles to the 1024-byte swizzle pattern, + barriers
  return (size_t)(BQ + 2 * STAGES * BK) * HDP * 2 + 1024 +
         8 * (1 + 2 * STAGES);
}

// 2^x and 1/x on the special-function unit, with no branch (a branch the
// compiler cannot prove uniform, while a wgmma is in flight, makes it
// serialize every wgmma of the kernel)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// tanh(y) = 1 - 2 / (e^2y + 1): exact at both ends (e^2y overflows to inf
// or flushes to 0), within a few f32 ulps of 1 in between
__device__ __forceinline__ float tanh_nb(float y) {
  return 1.f - 2.f * rcp(ex2(2.f * LOG2E * y) + 1.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// the arrivals and copies below are predicated inside the instruction, not
// branched around: a branch that the compiler cannot prove uniform, while
// a wgmma is in flight, makes it serialize every wgmma of the kernel
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes,
                                               bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int phase) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(phase)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `phase` has completed.  A wait of more
// than 2^35 cycles (about 20 s) is a fault of the pipeline, not a wait: it
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, phase)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, phase))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one TMA box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completion counted in bytes on `bar`; issued where `pred`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"((int)pred)
      : "memory");
}

// shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// N-major: imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// N-major: imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x N) += P (registers) V (smem, N-major)
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// named barriers of the two consumer warpgroups' turns at the tensor cores
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}

// every key of a tile lies at or before the rows' last position (causal)
// and after their first minus the window
__device__ __forceinline__ bool tile_visible(const Args& a, int k0, int qf,
                                             int ql) {
  const int kl = min(k0 + BK, a.T) - 1;
  bool vis = true;
  if (a.causal) vis = vis && a.kpos[k0] <= ql;
  if (a.window > 0) vis = vis && a.kpos[kl] > qf - a.window;
  return vis;
}

// HDP: the head dim as staged, 64 or 128 columns (hd 112 runs the 128
// kernel: TMA fills its last 16 columns with zeros, a.hd bounds the store)
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int NSLAB = HDP / SLAB;
  constexpr int Q_BYTES = BQ * HDP * 2;
  constexpr int KV_BYTES = BK * HDP * 2;  // one K or V tile
  constexpr int QK_STEPS = HDP / 16;
  constexpr int NS = BK / 8;     // n8 blocks of the score tile
  constexpr int NO = HDP / 8;    // n8 blocks of the output tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + Q_BYTES;
  uint8_t* Vs = Ks + STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // warp and warpgroup through a shuffle, so the compiler sees them (and
  // every branch on them) as uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int wg = warp >> 2;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BQ;
  const int nrows = min(BQ, a.S - q0);
  const int q_first = a.qpos[q0], q_last = a.qpos[q0 + nrows - 1];
  const int nk = (a.T + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {  // one thread loads
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES, true);
      for (int c = 0; c < NSLAB; ++c)
        tma_load(Qs + c * BQ * ROW_BYTES, &tq, q_full, c * SLAB, q0, h, b,
                 true);
      int it = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (!tile_visible(a, kt * BK, q_first, q_last)) continue;
        const int s = it % STAGES;
        // the slot's previous round released (passes at once in round 0)
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES, true);
        for (int c = 0; c < NSLAB; ++c) {
          tma_load(Ks + s * KV_BYTES + c * BK * ROW_BYTES, &tk, &full[s],
                   c * SLAB, kt * BK, kvh, b, true);
          tma_load(Vs + s * KV_BYTES + c * BK * ROW_BYTES, &tv, &full[s],
                   c * SLAB, kt * BK, kvh, b, true);
        }
        ++it;
      }
    }
    return;
  }

  // consumer warpgroup `wg`: rows q0 + 64 wg .. + 63.  A thread holds rows
  // r0 and r0 + 8 of them, columns 8 j + c2 and + 1 of every n8 block j
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const int w0 = q0 + wg * WG_ROWS;
  const int wrows = min(WG_ROWS, a.S - w0);
  const bool active = wrows > 0;
  const int wq_first = active ? a.qpos[w0] : 0;
  const int wq_last = active ? a.qpos[w0 + wrows - 1] : 0;
  const int qp0 = a.qpos[min(w0 + r0, a.S - 1)];
  const int qp1 = a.qpos[min(w0 + r0 + 8, a.S - 1)];
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_base = smem_u32(Qs) + wg * WG_ROWS * ROW_BYTES;
  int n_vis = 0;  // the CTA's visible KV tiles
  for (int kt = 0; kt < nk; ++kt)
    n_vis += tile_visible(a, kt * BK, q_first, q_last);

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share
  // the previous visible tile: its P, its slot, and the rescale of O that
  // goes with it.  Its P.V is issued together with the next tile's Q.K^T.
  uint32_t phi[NS * 2], plo[NS * 2];
  float corr0 = 1.f, corr1 = 1.f;
  int s_prev = 0;
  bool has_prev = false;

  // Between a wgmma's issue and its wait no branch may depend on data (the
  // compiler would then serialize every wgmma): each step below issues,
  // passes the turn, waits and runs the softmax without one, and the
  // choices (pending P.V or not, masks or not) are made before it starts.

  // O = O * corr before the previous tile's P.V is added (with no wgmma in
  // flight: the compiler would otherwise wait for every one first)
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) o[i] *= (i & 2) ? corr1 : corr0;
    fence_regs(o);
  };
  // O += P_hi V + P_lo V for the previous tile, committed
  auto issue_pv = [&]() {
    const uint32_t v_base = smem_u32(Vs + s_prev * KV_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // V is N-major (the head dim contiguous): its 64-column slabs
      // BK * 128 bytes apart, 8-key groups 1024 apart
      const uint64_t dv = desc(v_base + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
                               1024);
      const uint32_t ah[4] = {phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                              phi[4 * kk + 3]};
      const uint32_t al[4] = {plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                              plo[4 * kk + 3]};
      wgmma_pv<HDP>(o, ah, dv);
      wgmma_pv<HDP>(o, al, dv);
    }
    wg_commit();
  };
  // once that P.V has completed: its slot is free
  auto release_prev = [&]() {
    fence_regs(o);
    __syncwarp();
    mbar_arrive(&empty[s_prev], lane == 0);
    has_prev = false;
  };
  // one visible tile in slot s: S = Q K^T, the previous tile's P.V beside
  // it when PENDING, then the softmax (with the position masks when MASK)
  // and this tile's P, split into bf16 halves
  auto step = [&](int s, int k0, auto pending, auto mask) {
    constexpr bool PENDING = decltype(pending)::value;
    constexpr bool MASK = decltype(mask)::value;
    turn_wait(1 + wg);
    if constexpr (PENDING) rescale_o();
    float sc[NS * 4];  // the first k-step overwrites it (scale-d = 0)
    const uint32_t k_base = smem_u32(Ks + s * KV_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk)
      wgmma_ss_n64(sc,
                   desc(q_base + (kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32, 16,
                        1024),
                   desc(k_base + (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32, 16,
                        1024),
                   kk > 0);
    wg_commit();
    if constexpr (PENDING) issue_pv();
    turn_pass(2 - wg);
    wg_wait<PENDING ? 1 : 0>();
    fence_regs(sc);

    // scores in log2 units, masks as selects, online softmax
    const int ncols = min(BK, a.T - k0);
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        x = a.cap > 0.f ? a.cap * tanh_nb(x * a.scale / a.cap) * LOG2E
                        : x * sl2;
        if constexpr (MASK) {
          const int col = 8 * j + c2 + (e & 1);
          const int kp = a.kpos[min(k0 + col, a.T - 1)];
          const int qp = (e & 2) ? qp1 : qp0;
          const bool ok = (!a.causal || qp >= kp) &&
                          (a.window <= 0 || qp - kp < a.window);
          // past T: out of the softmax (p = 0); masked: -1e30
          x = col < ncols ? (ok ? x : NEG) : -INFINITY;
        }
        sc[4 * j + e] = x;
        if (e & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) {
      sc[i] = ex2(sc[i] - ((i & 2) ? mn1 : mn0));
      if (i & 2)
        ps1 += sc[i];
      else
        ps0 += sc[i];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    if constexpr (PENDING) {
      wg_wait<0>();
      release_prev();
    }
    // P in f32, split into two bf16 halves packed as the A operand of the
    // next P.V: elements 2i and 2i + 1 (row r0 + 8 where i is odd)
#pragma unroll
    for (int i = 0; i < NS * 2; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(sc[2 * i] - hf.x, sc[2 * i + 1] - hf.y);
      phi[i] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[i] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    corr0 = c0;
    corr1 = c1;
    s_prev = s;
    has_prev = true;
  };

  // The two warpgroups take turns at the tensor cores: each issues its
  // products for a tile in its turn, then passes the turn and runs its
  // softmax while the other's products run.  Warpgroup 0 goes first; every
  // tile of the CTA is a turn of both, and warpgroup 0 takes the last pass
  // after its loop, so the arrivals pair up.
  mbar_wait(q_full, 0);
  if (wg == 1 && n_vis > 0) turn_pass(1);
  int kt = 0;
  for (int it = 0; it < n_vis; ++it, ++kt) {
    while (!tile_visible(a, kt * BK, q_first, q_last)) ++kt;
    const int k0 = kt * BK;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (!(active && tile_visible(a, k0, wq_first, wq_last))) {
      // nothing for these rows: finish the previous tile, free this slot
      turn_wait(1 + wg);
      if (has_prev) {
        rescale_o();
        issue_pv();
        turn_pass(2 - wg);
        wg_wait<0>();
        release_prev();
      } else {
        turn_pass(2 - wg);
      }
      __syncwarp();
      mbar_arrive(&empty[s], lane == 0);
      continue;
    }
    const int ncols = min(BK, a.T - k0);
    bool need_mask = ncols < BK;
    if (a.causal) need_mask |= a.kpos[k0 + ncols - 1] > wq_first;
    if (a.window > 0) need_mask |= wq_last - a.kpos[k0] >= a.window;
    using T_ = std::true_type;
    using F_ = std::false_type;
    if (has_prev) {
      if (need_mask)
        step(s, k0, T_{}, T_{});
      else
        step(s, k0, T_{}, F_{});
    } else {
      if (need_mask)
        step(s, k0, F_{}, T_{});
      else
        step(s, k0, F_{}, F_{});
    }
  }
  if (wg == 0 && n_vis > 0) turn_wait(1);
  if (has_prev) {
    rescale_o();
    issue_pv();
    wg_wait<0>();
    release_prev();
  }

  if (!active) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = a.o + b * a.o_sb + h * a.o_sh + (int64_t)w0 * a.o_ss;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = 8 * j + c2;
    if (col >= a.hd) continue;
    if (r0 < wrows)
      *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)r0 * a.o_ss + col) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < wrows)
      *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)(r0 + 8) * a.o_ss +
                                         col) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// error codes of the tensor-map setup, apart from cudaError_t's
constexpr int ERR_NO_ENCODER = 9999;
constexpr int ERR_ENCODE = 10000;  // + the CUresult

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map (head dim, rows, heads, batch) over a strided bf16 tensor, in
// boxes of 64 columns x `box_rows` rows, 128-byte swizzled; what lies past
// a dimension's end arrives as zeros
int make_map(CUtensorMap* map, const void* base, int hd, int rows, int heads,
             int batch, int64_t s_row, int64_t s_head, int64_t s_batch,
             int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SLAB, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int HDP>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  flash_tc_kernel<HDP><<<grid, THREADS, smem, stream>>>(q, k, v, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

// registers a thread, CTAs an SM (occupancy API), dynamic shared memory,
// threads, local memory a thread (spills) of one kernel instance
template <typename Kernel>
int kernel_info(Kernel kernel, size_t smem, int threads, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = ctas;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = (int)at.localSizeBytes;
  return 0;
}

template <typename T, int HD>
int fma_info(int* out) {
  return kernel_info(flash_fwd_kernel<T, HD>, smem_bytes<HD>(), THREADS, out);
}

template <int HDP>
int tc_info(int* out) {
  return kernel_info(tc::flash_tc_kernel<HDP>, tc::smem_bytes<HDP>(),
                     tc::THREADS, out);
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

// The tensor-core route: bf16 q, k, v and out, hd 64, 112 or 128, every
// pointer 16-byte aligned and every stride (elements) a multiple of 8, as
// TMA needs; the wrapper routes nothing else here.  Same arguments as
// flash_attention_launch (dtype must be 1).  Returns cudaGetLastError()
// after the launch, or a tensor-map setup error (ERR_NO_ENCODER,
// ERR_ENCODE + CUresult); 0 on success.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, int dtype, int B, int S, int T, int H,
    int KV, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, float cap,
    int causal, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = tc::make_map(&tq, q, hd, S, H, B, q_ss, q_sh, q_sb, tc::BQ);
  if (err == 0) err = tc::make_map(&tk, k, hd, T, KV, B, k_st, k_sh, k_sb, tc::BK);
  if (err == 0) err = tc::make_map(&tv, v, hd, T, KV, B, v_st, v_sh, v_sb, tc::BK);
  if (err != 0) return err;
  const tc::Args a{(const int*)q_pos, (const int*)k_pos,
                   (__nv_bfloat16*)out, S, T, H, KV, hd, o_sb, o_ss, o_sh,
                   scale, cap, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return tc::launch<64>(tq, tk, tv, a, B, st);
    case 112:
    case 128: return tc::launch<128>(tq, tk, tv, a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the compiler and the occupancy API report for one kernel instance:
// route 0 is the FMA kernel (dtype 0 = float32, 1 = bfloat16), route 1 the
// tensor-core kernel.  out[5]: registers a thread, CTAs an SM, dynamic
// shared memory (bytes), threads a CTA, local memory a thread (bytes).
extern "C" int flash_attention_info(int route, int dtype, int hd, int* out) {
  if (route == 1) {
    switch (hd) {
      case 64: return tc_info<64>(out);
      case 112:
      case 128: return tc_info<128>(out);
    }
  } else if (dtype == 0 || dtype == 1) {
    switch (hd * 2 + dtype) {
      case 128: return fma_info<float, 64>(out);
      case 224: return fma_info<float, 112>(out);
      case 256: return fma_info<float, 128>(out);
      case 512: return fma_info<float, 256>(out);
      case 129: return fma_info<__nv_bfloat16, 64>(out);
      case 225: return fma_info<__nv_bfloat16, 112>(out);
      case 257: return fma_info<__nv_bfloat16, 128>(out);
      case 513: return fma_info<__nv_bfloat16, 256>(out);
    }
  }
  return (int)cudaErrorInvalidValue;
}
