// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: unitex_tpu/ops/attention.py:_flash_kernel (launched by
// _flash_forward) — non-causal softmax(Q K^T / sqrt(D)) V over the MMDiT
// joint sequence, with an online softmax, plus the per-row logsumexp.
//
// Bound: compute.  4·B·H·S²·D FLOPs on the tensor cores (989 TFLOP/s bf16
// dense on an H100 SXM) against 4·B·S·H·D·2 bytes of q/k/v/out traffic:
// at S = 13824, D = 128 that is ~6900 FLOP per byte, far right of the
// ~295 FLOP/byte ridge.  So the design keeps the tensor cores fed and
// never writes the S×S logits:
//   * one block per (batch·head, 128-row query tile), 8 warps, each warp
//     owning 16 query rows; the key axis is a loop inside the block (the
//     TPU's sequential grid axis);
//   * Q is staged once through shared memory into registers (ldmatrix);
//     K/V tiles of 64 keys are double-buffered in shared memory with
//     cp.async so the next tile's copy overlaps this tile's products;
//     16-byte chunks are XOR-swizzled by row so ldmatrix is conflict-free;
//   * Q·Kᵀ and P·V run as mma.sync m16n8k16 bf16 -> f32; P stays in
//     registers (the S accumulator fragments are re-packed as the A
//     operand of P·V), so the logits never touch shared or device memory;
//   * the online-softmax max and (per-thread partial) sum live in f32
//     registers, in the exp2 domain; the partial sums are reduced across
//     the quad only once, at the end;
//   * any S: keys past S are zero-filled by cp.async and masked to -inf,
//     query rows past S are computed and not stored.
// Wgmma, TMA and warp specialisation are not used yet.
//
// Layout: q/k/v/out are [B, S, H, D] read through their strides (the
// innermost D stride must be 1); lse is [B·H, S] f32.  D = 128 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBlockM = 128;
constexpr int kBlockN = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunksPerRow = kD * 2 / 16;  // 16-byte chunks in one row
constexpr int kRowBytes = kD * 2;
constexpr int kQBytes = kBlockM * kRowBytes;
constexpr int kKVBytes = kBlockN * kRowBytes;
constexpr int kSmemBytes = kQBytes + 4 * kKVBytes;  // Q + 2x(K, V)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][kD] tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a · b for one m16n8k16 bf16 tile with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of one head into a swizzled smem tile;
// rows at or past S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int S, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunksPerRow / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunksPerRow;
    const int c = idx % kChunksPerRow;
    const int s = row0 + r;
    const bool ok = s < S;
    const __nv_bfloat16* p = src + (ok ? s : 0) * row_stride + c * 8;
    cp_async16(dst + swz(r, c), p, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int H, long long qb, long long qs, long long qh,
                     long long kb, long long ks, long long kh, long long vb,
                     long long vs, long long vh, long long ob, long long os,
                     long long oh, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // thread within the quad
  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const __nv_bfloat16* qp = q + b * qb + h * qh;
  const __nv_bfloat16* kp = k + b * kb + h * kh;
  const __nv_bfloat16* vp = v + b * vb + h * vh;

  const uint32_t sQ = smem_u32(smem);
  // K buffers 0/1 then V buffers 0/1; buffer i of K at sK + i * kKVBytes.
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + 2 * kKVBytes;

  load_tile<kBlockM>(sQ, qp, qs, m0, S, tid);
  cp_async_commit();
  load_tile<kBlockN>(sK, kp, ks, 0, S, tid);
  load_tile<kBlockN>(sV, vp, vs, 0, S, tid);
  cp_async_commit();

  // Q fragments of this warp's 16 rows: 8 k-steps of 16 along D.
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kD / 16][4];
  {
    const int row = warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      ldsm_x4(sQ + swz(row, kk * 2 + (lane >> 4)), qf[kk][0], qf[kk][1],
              qf[kk][2], qf[kk][3]);
    }
  }

  float oacc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  }
  float mrow[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
  float lrow[2] = {0.f, 0.f};              // per-thread partial row sums

  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t cur = (j & 1) * kKVBytes;
    const uint32_t nxt = kKVBytes - cur;
    if (j + 1 < n_tiles) {
      load_tile<kBlockN>(sK + nxt, kp, ks, (j + 1) * kBlockN, S, tid);
      load_tile<kBlockN>(sV + nxt, vp, vs, (j + 1) * kBlockN, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q Kᵀ for 16 rows x 64 keys (8 n-tiles of 8 keys).
    float sacc[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
      sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + ((lane >> 4) << 3) + (lane & 7);
        ldsm_x4(sK + cur + swz(key, kk * 2 + ((lane >> 3) & 1)), b0, b1, b2,
                b3);
        mma_bf16(sacc[2 * np], qf[kk], b0, b1);
        mma_bf16(sacc[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // Scale into the exp2 domain and mask keys past S.
    const int key0 = j * kBlockN;
    const bool tail = key0 + kBlockN > S;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[nt][e] * scale_log2;
        if (tail && key0 + nt * 8 + 2 * t + (e & 1) >= S) x = -INFINITY;
        sacc[nt][e] = x;
      }
    }

    // Online softmax for rows g (half 0) and g + 8 (half 1).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = mrow[half];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * half], sacc[nt][2 * half + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(mrow[half] - mx);
      mrow[half] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const float p0 = exp2f(sacc[nt][2 * half] - mx);
        const float p1 = exp2f(sacc[nt][2 * half + 1] - mx);
        sacc[nt][2 * half] = p0;
        sacc[nt][2 * half + 1] = p1;
        sum += p0 + p1;
      }
      lrow[half] = lrow[half] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        oacc[dt][2 * half] *= alpha;
        oacc[dt][2 * half + 1] *= alpha;
      }
    }

    // O += P V: P from the S fragments (bf16), V via transposed ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
      };
      const int key = kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(sV + cur + swz(key, dp * 2 + (lane >> 4)), b0, b1, b2, b3);
        mma_bf16(oacc[2 * dp], a, b0, b1);
        mma_bf16(oacc[2 * dp + 1], a, b2, b3);
      }
    }
    // Every warp is done with buffer `cur` before iteration j + 1 refills it.
    __syncthreads();
  }

  // Normalise, store O in bf16 and the natural-log lse in f32.
  const float kLn2 = 0.69314718055994531f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = lrow[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + warp * 16 + g + 8 * half;
    if (row < S) {
      const float inv = 1.f / l;
      __nv_bfloat16* orow = o + b * ob + row * os + h * oh + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(oacc[dt][2 * half] * inv,
                                  oacc[dt][2 * half + 1] * inv);
      }
      if (t == 0) lse[static_cast<long long>(bh) * S + row] =
          (mrow[half] + log2f(l)) * kLn2;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements; the
// innermost D stride of every tensor must be 1.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int H,
                                   int D, long long qb, long long qs,
                                   long long qh, long long kb, long long ks,
                                   long long kh, long long vb, long long vs,
                                   long long vh, long long ob, long long os,
                                   long long oh, float scale, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  // Per device, cheap: set on every call rather than cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, S, H, qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, scale_log2);
  return cudaGetLastError();
}
