// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate:
// kernels B2a (dK, dV) and B2b (dQ).
//
// Replaces: unitex_tpu/ops/attention.py:_flash_bwd_dkv_kernel (B2a) and
// _flash_bwd_dq_kernel (B2b), both launched by _flash_backward_pallas
// behind the custom VJP _flash_core.  Given the forward's q, k, v, its
// row logsumexp lse, the output gradient dO and Drow = rowsum(dO ∘ O)
// (computed outside, as in JAX), each recomputes P = exp(Q Kᵀ·s − lse)
// tile by tile and never writes the S×S matrices:
//   B2a: dV = Σ_q Pᵀ dO;  dS = P ∘ (dO Vᵀ − Drow);  dK = Σ_q dSᵀ Q · s
//   B2b: dQ = Σ_k dS K · s
//
// Bound: compute.  B2a does four S×S×D products (Q Kᵀ, dO Vᵀ, Pᵀ dO,
// dSᵀ Q): 8·B·H·S²·D FLOPs; B2b three (Q Kᵀ, dO Vᵀ, dS K): 6·B·H·S²·D.  At
// 989 TFLOP/s (bf16 dense, H100 SXM) that is 4.07 ms and 3.05 ms at
// S = 12800, against ~0.4 GB of q/k/v/dO/dq/dk/dv traffic (0.12 ms at
// 3.35 TB/s).  So the design keeps the tensor cores fed and the
// recomputed P, dP and dS in registers:
//   * the TPU's sequential grid axis becomes a loop inside the block.  B2a:
//     one block per (batch·head, 128-key tile), 8 warps of 16 key rows,
//     looping over 64-query tiles; B2b: one block per (batch·head,
//     128-query tile), 8 warps of 16 query rows, looping over 64-key
//     tiles.  Each block owns its outputs, so there are no atomics and
//     the gradients are the same from run to run (FlashAttention-2's
//     atomic dQ is not used);
//   * B2a computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with the keys as the mma rows,
//     so Pᵀ and dSᵀ come out of the accumulators already in the layout of
//     the A operand of Pᵀ·dO and dSᵀ·Q (as P feeds P·V in B1); B2b keeps
//     the queries as rows and feeds dS to dS·K the same way;
//   * every product is mma.sync m16n8k16 bf16 -> f32; P and dS are rounded
//     to bf16 before their products, as the JAX kernels do; the dK/dV or
//     dQ accumulators stay in f32 registers and are written once in bf16;
//   * the streamed tiles (Q/dO/lse/Drow in B2a, K/V in B2b) are
//     double-buffered with cp.async; the block's own tiles stay in shared
//     memory; 16-byte chunks are XOR-swizzled (common.cuh);
//   * any S: rows past S are zero-filled by cp.async (lse and Drow too).
//     A query row past S then has Q = dO = Drow = 0, so its P·dO, dS and
//     dS·Q terms are 0 in B2a; key rows past S only reach their own dK/dV
//     rows, whose stores are guarded.  B2b masks P of keys past S to 0
//     before it forms dS.
// Wgmma, TMA and warp specialisation are not used yet.
//
// Layout: q/k/v/dO/dq/dk/dv are [B, S, H, D] read through their strides
// (the innermost D stride must be 1); lse and Drow are [B·H, S] f32.
// D = 128 only.

#include <math.h>

#include "common.cuh"

namespace {

using namespace fa;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kOwn = kWarps * 16;  // rows a block owns: 16 per warp
constexpr int kStream = 64;        // rows of a streamed tile
constexpr int kOwnBytes = kOwn * kRowBytes;
constexpr int kStreamBytes = kStream * kRowBytes;
// B2a: K, V (owned) + 2x(Q, dO) tiles + 2x(lse, Drow) rows
constexpr int kDkvSmem = 2 * kOwnBytes + 4 * kStreamBytes + 4 * kStream * 4;
// B2b: Q, dO (owned) + 2x(K, V) tiles
constexpr int kDqSmem = 2 * kOwnBytes + 4 * kStreamBytes;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ const __nv_bfloat16* head(const void* p,
                                                     Strides st, int b,
                                                     int h) {
  return static_cast<const __nv_bfloat16*>(p) + b * st.b + h * st.h;
}

__device__ __forceinline__ void zero(float (&acc)[kD / 8][4]) {
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// acc[16 x kStream] = rows(a_tile, row0) · rows(b_tile)ᵀ over D.
__device__ __forceinline__ void qk_product(float (&acc)[kStream / 8][4],
                                           uint32_t a_tile, int row0,
                                           uint32_t b_tile, int lane) {
#pragma unroll
  for (int i = 0; i < kStream / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm_rows(a_tile, row0, kk, lane, a);
#pragma unroll
    for (int np = 0; np < kStream / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_cols(b_tile, np * 16, kk, lane, b0, b1, b2, b3);
      mma_bf16(acc[2 * np], a, b0, b1);
      mma_bf16(acc[2 * np + 1], a, b2, b3);
    }
  }
}

// out[16 x kD] += p[16 x kStream] (bf16) · tile[kStream x kD].
__device__ __forceinline__ void pv_product(float (&out)[kD / 8][4],
                                           const float (&p)[kStream / 8][4],
                                           uint32_t tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(p[2 * kk], p[2 * kk + 1], a);
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm_kd(tile, kk * 16, dp, lane, b0, b1, b2, b3);
      mma_bf16(out[2 * dp], a, b0, b1);
      mma_bf16(out[2 * dp + 1], a, b2, b3);
    }
  }
}

// Store 16 rows (row0 + g, row0 + g + 8) of an f32 accumulator as bf16,
// times `scale`, guarding rows at or past S.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride, int row0,
                                           int S, const float (&acc)[kD / 8][4],
                                           float scale, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* p = base + row * row_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p + dt * 8) = __floats2bfloat162_rn(
          acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
    }
  }
}

// B2a: one block per (128-key tile, batch·head); loops over query tiles.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ drow,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int H,
                         Strides qst, Strides kst, Strides vst, Strides gst,
                         Strides dkst, Strides dvst, float scale,
                         float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const __nv_bfloat16* qp = head(q, qst, b, h);
  const __nv_bfloat16* gp = head(dout, gst, b, h);
  const float* lse_p = lse + static_cast<long long>(bh) * S;
  const float* dr_p = drow + static_cast<long long>(bh) * S;

  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kOwnBytes;
  const uint32_t sQ = sV + kOwnBytes;         // buffers 0/1 at sQ + i * kStreamBytes
  const uint32_t sG = sQ + 2 * kStreamBytes;  // dO buffers 0/1
  const uint32_t sRow = sG + 2 * kStreamBytes;  // [2][lse | Drow][kStream] f32
  const float* rowf = reinterpret_cast<const float*>(smem + 2 * kOwnBytes +
                                                      4 * kStreamBytes);

  // Query tile i (and its lse / Drow) into buffer `buf`.
  auto load_q = [&](int i, int buf) {
    const int m0 = i * kStream;
    load_tile<kStream, kThreads>(sQ + buf * kStreamBytes, qp, qst.s, m0, S, tid);
    load_tile<kStream, kThreads>(sG + buf * kStreamBytes, gp, gst.s, m0, S, tid);
    if (tid < 2 * kStream) {
      const int r = tid % kStream;
      const bool ok = m0 + r < S;
      const float* src = (tid < kStream ? lse_p : dr_p) + (ok ? m0 + r : 0);
      cp_async4(sRow + (buf * 2 * kStream + tid) * 4, src, ok);
    }
  };

  load_tile<kOwn, kThreads>(sK, head(k, kst, b, h), kst.s, n0, S, tid);
  load_tile<kOwn, kThreads>(sV, head(v, vst, b, h), vst.s, n0, S, tid);
  load_q(0, 0);
  cp_async_commit();

  float dk_acc[kD / 8][4];
  float dv_acc[kD / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int row0 = warp * 16;  // this warp's keys in the tile

  const int n_tiles = (S + kStream - 1) / kStream;
  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_tiles) load_q(i + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t cQ = sQ + cur * kStreamBytes;
    const uint32_t cG = sG + cur * kStreamBytes;
    const float* cL = rowf + cur * 2 * kStream;
    const float* cDr = cL + kStream;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x 64 queries per warp.
    float st[kStream / 8][4];
    float dpt[kStream / 8][4];
    qk_product(st, sK, row0, cQ, lane);
    qk_product(dpt, sV, row0, cG, lane);

    // Pᵀ = exp(Sᵀ·s − lse[q]); dSᵀ = Pᵀ ∘ (dPᵀ − Drow[q]).  Element e of
    // n-tile nt is query nt * 8 + 2t + (e & 1).
#pragma unroll
    for (int nt = 0; nt < kStream / 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(cL + nt * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(cDr + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        const float d = (e & 1) ? d2.y : d2.x;
        const float p = exp2f(st[nt][e] * scale_log2 - l * kLog2e);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - d);
      }
    }

    pv_product(dv_acc, st, cG, lane);   // dV += Pᵀ dO
    pv_product(dk_acc, dpt, cQ, lane);  // dK += dSᵀ Q
    // Every warp is done with buffer `cur` before iteration i + 1 refills it.
    __syncthreads();
  }

  store_rows(dk + b * dkst.b + h * dkst.h, dkst.s, n0 + row0, S, dk_acc,
             scale, g, t);
  store_rows(dv + b * dvst.b + h * dvst.h, dvst.s, n0 + row0, S, dv_acc, 1.f,
             g, t);
}

// B2b: one block per (128-query tile, batch·head); loops over key tiles.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ drow,
                        __nv_bfloat16* __restrict__ dq, int S, int H,
                        Strides qst, Strides kst, Strides vst, Strides gst,
                        Strides dqst, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const __nv_bfloat16* kp = head(k, kst, b, h);
  const __nv_bfloat16* vp = head(v, vst, b, h);

  const uint32_t sQ = smem_u32(smem);
  const uint32_t sG = sQ + kOwnBytes;
  const uint32_t sK = sG + kOwnBytes;         // buffers 0/1 at sK + i * kStreamBytes
  const uint32_t sV = sK + 2 * kStreamBytes;  // V buffers 0/1

  load_tile<kOwn, kThreads>(sQ, head(q, qst, b, h), qst.s, m0, S, tid);
  load_tile<kOwn, kThreads>(sG, head(dout, gst, b, h), gst.s, m0, S, tid);
  load_tile<kStream, kThreads>(sK, kp, kst.s, 0, S, tid);
  load_tile<kStream, kThreads>(sV, vp, vst.s, 0, S, tid);
  cp_async_commit();

  // lse (scaled into the exp2 domain) and Drow of this thread's two rows.
  const int row0 = warp * 16;
  float lrow[2], drw[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + row0 + g + 8 * half;
    const long long idx = static_cast<long long>(bh) * S + row;
    lrow[half] = row < S ? lse[idx] * kLog2e : 0.f;
    drw[half] = row < S ? drow[idx] : 0.f;
  }

  float dq_acc[kD / 8][4];
  zero(dq_acc);

  const int n_tiles = (S + kStream - 1) / kStream;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      const int nxt = (cur ^ 1) * kStreamBytes;
      load_tile<kStream, kThreads>(sK + nxt, kp, kst.s, (j + 1) * kStream, S, tid);
      load_tile<kStream, kThreads>(sV + nxt, vp, vst.s, (j + 1) * kStream, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t cK = sK + cur * kStreamBytes;
    const uint32_t cV = sV + cur * kStreamBytes;

    // S = Q Kᵀ and dP = dO Vᵀ: 16 queries x 64 keys per warp.
    float s[kStream / 8][4];
    float dp[kStream / 8][4];
    qk_product(s, sQ, row0, cK, lane);
    qk_product(dp, sG, row0, cV, lane);

    // P = exp(S·s − lse) (0 for keys past S); dS = P ∘ (dP − Drow).
    const int key0 = j * kStream;
    const bool tail = key0 + kStream > S;
#pragma unroll
    for (int nt = 0; nt < kStream / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float p = exp2f(s[nt][e] * scale_log2 - lrow[half]);
        if (tail && key0 + nt * 8 + 2 * t + (e & 1) >= S) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - drw[half]);
      }
    }

    pv_product(dq_acc, dp, cK, lane);  // dQ += dS K
    // Every warp is done with buffer `cur` before iteration j + 1 refills it.
    __syncthreads();
  }

  store_rows(dq + b * dqst.b + h * dqst.h, dqst.s, m0 + row0, S, dq_acc,
             scale, g, t);
}

bool bad_args(int B, int S, int H, int D) {
  return D != kD || B <= 0 || S <= 0 || H <= 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Strides are in elements, three
// (batch, sequence, head) per [B, S, H, D] tensor; the innermost D stride
// of every tensor must be 1.  Each returns cudaGetLastError() after its
// launch (0 on success).
extern "C" int flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* drow, void* dk, void* dv, int B, int S,
    int H, int D, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    long long gb, long long gs, long long gh, long long dkb, long long dks,
    long long dkh, long long dvb, long long dvs, long long dvh, float scale,
    void* stream) {
  if (bad_args(B, S, H, D)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, drow,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H,
      Strides{qb, qs, qh}, Strides{kb, ks, kh}, Strides{vb, vs, vh},
      Strides{gb, gs, gh}, Strides{dkb, dks, dkh}, Strides{dvb, dvs, dvh},
      scale, scale * kLog2e);
  return cudaGetLastError();
}

extern "C" int flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* drow, void* dq, int B, int S, int H, int D,
    long long qb, long long qs, long long qh, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, long long gb,
    long long gs, long long gh, long long dqb, long long dqs, long long dqh,
    float scale, void* stream) {
  if (bad_args(B, S, H, D)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, drow,
      static_cast<__nv_bfloat16*>(dq), S, H, Strides{qb, qs, qh},
      Strides{kb, ks, kh}, Strides{vb, vs, vh}, Strides{gb, gs, gh},
      Strides{dqb, dqs, dqh}, scale, scale * kLog2e);
  return cudaGetLastError();
}
