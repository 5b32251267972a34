// Flash-attention forward with an int8 Q·Kᵀ for Hopper (sm_90a): int8 q/k
// with f32 per-row scales, bf16 v, f32 softmax and P·V accumulation.
//
// Replaces: unitex_tpu/ops/attention.py:_flash_kernel_qk8 (launched by
// _flash_forward_qk8) — the serving-mode variant of _flash_kernel whose
// logits are float(int32(qq · kqᵀ)) · (sq · scale) · sk, with q and k
// quantized per row outside the kernel (quant_rows in ops/attention.py).
// Forward only: no lse is written.
//
// Bound: compute.  2·B·H·S²·D int8 operations for Q·Kᵀ (1,979 TOP/s dense
// on an H100 SXM) plus 2·B·H·S²·D bf16 FLOPs for P·V (989 TFLOP/s), against
// about 4·B·S·H·D bytes of q/k/v/out traffic; at S = 13824 that is 1.78 ms
// of tensor-core time.  The B·H·S² exponentials are a second bound on the
// SFU (about 1.1 ms there).  The design is B1's (flash_attn_fwd.cu) with
// the first product on the int8 tensor-core path:
//   * one block per (batch·head, 128-row query tile), 8 warps of 16 query
//     rows; the key axis is a loop inside the block;
//   * int8 Q staged once through shared memory into registers; int8 K
//     (64 keys), bf16 V and the 64 key scales double-buffered with
//     cp.async; int8 rows are 128 bytes, so their 8 16-byte chunks are
//     XOR-swizzled by row (c ^ (r & 7)) for conflict-free ldmatrix;
//   * Q·Kᵀ on mma.sync m16n8k32 s8·s8 -> s32 (four k-steps over D = 128):
//     an int8 16x32 A tile and 32x8 B tile have the byte layout of a bf16
//     16x16 / 16x8 tile, so the same ldmatrix patterns load them;
//   * the int32 logits become f32 in registers, scaled by the query row's
//     (sq · scale · log2 e) and the key's sk, then run B1's online softmax
//     in the exp2 domain and P·V on mma.sync m16n8k16 bf16 -> f32, with P
//     re-packed from registers;
//   * any S: keys past S are zero-filled and masked to -inf, query rows
//     past S are computed and not stored.
// Wgmma, TMA and warp specialisation are not used yet.
//
// Layout: qq/kq int8 and v/out bf16 are [B, S, H, D] read through their
// strides (innermost D stride 1, rows 16-byte aligned); sq/sk are f32
// [B, S, H] read through their strides.  D = 128 only.

#include <math.h>

#include "common.cuh"

namespace {

using namespace fa;

constexpr int kBlockM = 128;
constexpr int kBlockN = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBytes8 = kD;               // one int8 row of D values
constexpr int kChunks8 = kRowBytes8 / 16;    // its 16-byte chunks
constexpr int kQBytes = kBlockM * kRowBytes8;
constexpr int kKBytes = kBlockN * kRowBytes8;
constexpr int kVBytes = kBlockN * kRowBytes;
constexpr int kSkBytes = kBlockN * 4;
// Q + 2 x (K, V, key scales)
constexpr int kSmemBytes = kQBytes + 2 * (kKBytes + kVBytes + kSkBytes);

// Byte offset of 16-byte chunk c of row r in a swizzled int8 [rows][kD] tile.
__device__ __forceinline__ uint32_t swz8(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes8 + ((c ^ (r & 7)) << 4));
}

// Copy int8 rows [row0, row0 + ROWS) of one head into a swizzled tile;
// rows at or past S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile_i8(uint32_t dst, const int8_t* src,
                                             long long row_stride, int row0,
                                             int S, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunks8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks8;
    const int c = idx % kChunks8;
    const int s = row0 + r;
    const bool ok = s < S;
    const int8_t* p = src + (ok ? s : 0) * row_stride + c * 16;
    cp_async16(dst + swz8(r, c), p, ok);
  }
}

// The kBlockN key scales from key0 on; keys at or past S read as 0.
__device__ __forceinline__ void load_scales(uint32_t dst, const float* src,
                                            long long stride, int key0, int S,
                                            int tid) {
  if (tid < kBlockN) {
    const int s = key0 + tid;
    const bool ok = s < S;
    cp_async4(dst + tid * 4, src + (ok ? s : 0) * stride, ok);
  }
}

// d += a · b for one m16n8k32 int8 tile with int32 accumulation.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_qk8_kernel(const int8_t* __restrict__ qq,
                     const int8_t* __restrict__ kq,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ sq,
                     const float* __restrict__ sk,
                     __nv_bfloat16* __restrict__ o, int S, int H,
                     long long qb, long long qs, long long qh, long long kb,
                     long long ks, long long kh, long long vb, long long vs,
                     long long vh, long long ob, long long os, long long oh,
                     long long sqb, long long sqs, long long sqh,
                     long long skb, long long sks, long long skh,
                     float scale_log2) {
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

  const int8_t* qp = qq + b * qb + h * qh;
  const int8_t* kp = kq + b * kb + h * kh;
  const __nv_bfloat16* vp = v + b * vb + h * vh;
  const float* skp = sk + b * skb + h * skh;

  const uint32_t sQ = smem_u32(smem);
  // buffer i of K at sK + i * kKBytes, of V at sV + i * kVBytes, of the
  // key scales at sS + i * kSkBytes
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + 2 * kKBytes;
  const uint32_t sS = sV + 2 * kVBytes;
  const float* sS_ptr = reinterpret_cast<const float*>(
      smem + kQBytes + 2 * kKBytes + 2 * kVBytes);

  load_tile_i8<kBlockM>(sQ, qp, qs, m0, S, tid);
  cp_async_commit();
  load_tile_i8<kBlockN>(sK, kp, ks, 0, S, tid);
  load_tile<kBlockN, kThreads>(sV, vp, vs, 0, S, tid);
  load_scales(sS, skp, sks, 0, S, tid);
  cp_async_commit();

  // This thread's two query rows: (sq · scale · log2 e) of each.
  float rowf[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + g + 8 * half;
    rowf[half] = row < S ? sq[b * sqb + row * sqs + h * sqh] * scale_log2
                         : 0.f;
  }

  // Q fragments of this warp's 16 rows: 4 k-steps of 32 along D.
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kD / 32][4];
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk) {
    ldsm_x4(sQ + swz8(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)),
            qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
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
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int key1 = (j + 1) * kBlockN;
      load_tile_i8<kBlockN>(sK + (buf ^ 1) * kKBytes, kp, ks, key1, S, tid);
      load_tile<kBlockN, kThreads>(sV + (buf ^ 1) * kVBytes, vp, vs, key1, S,
                                   tid);
      load_scales(sS + (buf ^ 1) * kSkBytes, skp, sks, key1, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // int32 S = Qq Kqᵀ for 16 rows x 64 keys (8 n-tiles of 8 keys).
    int iacc[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
      iacc[i][0] = iacc[i][1] = iacc[i][2] = iacc[i][3] = 0;
    }
    const uint32_t kt = sK + buf * kKBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        const int row = np * 16 + ((lane >> 4) << 3) + (lane & 7);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kt + swz8(row, kk * 2 + ((lane >> 3) & 1)), b0, b1, b2, b3);
        mma_s8(iacc[2 * np], qf[kk], b0, b1);
        mma_s8(iacc[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // Dequantize into the exp2 domain and mask keys past S.
    const float* skt = sS_ptr + buf * kBlockN;
    const int key0 = j * kBlockN;
    const bool tail = key0 + kBlockN > S;
    float sacc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float2 skv =
          *reinterpret_cast<const float2*>(skt + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = static_cast<float>(iacc[nt][e]) * rowf[e >> 1] *
                  ((e & 1) ? skv.y : skv.x);
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
    const uint32_t vt = sV + buf * kVBytes;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(sacc[2 * kk], sacc[2 * kk + 1], a);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_kd(vt, kk * 16, dp, lane, b0, b1, b2, b3);
        mma_bf16(oacc[2 * dp], a, b0, b1);
        mma_bf16(oacc[2 * dp + 1], a, b2, b3);
      }
    }
    // Every warp is done with buffer `buf` before iteration j + 1 refills it.
    __syncthreads();
  }

  // Normalise and store O in bf16.
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
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements; the
// innermost D stride of qq/kq/v/o must be 1.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_attn_qk8_fwd(
    const void* qq, const void* kq, const void* v, const float* sq,
    const float* sk, void* o, int B, int S, int H, int D, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, float scale, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_qk8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_qk8_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qq), static_cast<const int8_t*>(kq),
      static_cast<const __nv_bfloat16*>(v), sq, sk,
      static_cast<__nv_bfloat16*>(o), S, H, qb, qs, qh, kb, ks, kh, vb, vs,
      vh, ob, os, oh, sqb, sqs, sqh, skb, sks, skh, scale * kLog2e);
  return cudaGetLastError();
}
