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
// SFU (about 1.1 ms there), and with the int8 product at twice the bf16
// rate the per-logit work beside the products (conversion, scales, max,
// exp2, sum, P packing) weighs more than in B1.  So the design is B1's
// (flash_attn_fwd.cu, on hopper.cuh), which runs one warpgroup's softmax
// under the other's products, with the first product on the int8 path and
// as few instructions per logit as the function allows:
//   * one block per (batch·head, 128-query tile) and three warpgroups: a
//     producer (one thread issues TMA copies, one warp copies the key
//     scales; its registers given to the others by setmaxnreg) and two
//     consumers of 64 query rows each;
//   * TMA loads the int8 Q tile once and streams int8 K (16 KB) and bf16 V
//     (32 KB) tiles of 128 keys through a ring of kStages stages, 128-byte
//     swizzled, K and V each guarded by a full and an empty mbarrier; an
//     int8 row of D = 128 is 128 bytes, so a Q or K tile is one swizzled
//     box;
//   * S = Q·Kᵀ is wgmma m64n128k32 s8·s8 -> s32 with both operands K-major
//     in shared memory (the only layout 8-bit wgmma takes, and the one q
//     and k rows already have): four k-steps of 32 bytes along one row;
//   * the s32 logits become f32 in registers (I2FP, exact: |Σ| ≤ 127²·128
//     < 2^24) times the key's sk.  The key scales are f32 [B, S, H] with
//     stride H along S, which no TMA box can read (its inner extent must
//     be 16 bytes), so a producer warp copies the stage's 128 of them with
//     plain loads under the K full barrier (0 past S); each consumer warp
//     releases the K stage once it has read them.  The query row's
//     sq · scale · log2 e goes into the tile's max and the exp2's
//     multiply-add rather than into a multiply per logit;
//   * O += P·V with P in registers: each consumer rounds P to bf16 pairs,
//     which in the accumulator layout of S are already the register
//     operand of wgmma m64n128k16, and V is read MN-major from shared
//     memory.  Each issues S_j beside P_{j-1}·V_{j-1} and runs the softmax
//     of S_j while the second product does, and two named barriers pass
//     the turn to issue products from one consumer to the other;
//   * the consumers wait on the ring by spinning without a trap
//     (hop::mbar_wait_spin; a trap there held the consumers of
//     flash_attn_bwd.cu to the launch's 168 registers).  The producer
//     thread waits, with a trap, until both consumers arrive on a `done`
//     barrier at their end, so a fault in the bookkeeping fails the
//     launch instead of holding the card;
//   * any S: TMA reads rows past S as zeros, keys past S are masked to
//     -inf before the max (in the last tile only), query rows past S are
//     computed and not stored.
// Each choice against its alternative on an H100:
// unitex_torch/scripts/probe_flash_qk8.py, PERF.md §6.
//
// Layout: qq/kq int8 and v/out bf16 are [B, S, H, D] read through their
// strides (D contiguous, rows 16-byte aligned, as TMA requires); sq/sk are
// f32 [B, S, H] read through their strides.  D = 128 only.

#include <float.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hop;
using fa::kD;
using fa::kLog2e;

constexpr int kBlockM = 128;  // queries per block: two warpgroups of 64
constexpr int kBlockN = 128;  // keys per stage
constexpr int kThreads = 3 * 128;
constexpr uint32_t kQBytes = kBlockM * kD;      // int8 Q tile, one box
constexpr uint32_t kKBytes = kBlockN * kD;      // int8 K tile, one box
constexpr uint32_t kVBytes = kBlockN * kD * 2;  // bf16 V tile
constexpr uint32_t kVBox = kVBytes / 2;         // its [128][64] half
constexpr uint32_t kSkBytes = kBlockN * 4;      // a stage's key scales

constexpr int kStages = 3;  // K/V ring depth
// Q, the K and V rings, the key scales, the barriers, and slack to align
// the base to 1024
constexpr uint32_t kSmemBytes = kQBytes + kStages * (kKBytes + kVBytes) +
                                kStages * kSkBytes + 8 * (2 + 4 * kStages) +
                                1024;

// The mbarriers, 8 bytes each from `base`: Q's, then per stage K full
// (TMA bytes and the 32 arrivals of the scale-copying warp), V full,
// K empty (one arrival per consumer warp) and V empty (one per consumer
// warpgroup), then the consumers' done.
struct Bars {
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t kfull(int s) const { return base + 8u * (1 + s); }
  __device__ uint32_t vfull(int s) const {
    return base + 8u * (1 + kStages + s);
  }
  __device__ uint32_t kempty(int s) const {
    return base + 8u * (1 + 2 * kStages + s);
  }
  __device__ uint32_t vempty(int s) const {
    return base + 8u * (1 + 3 * kStages + s);
  }
  __device__ uint32_t done() const { return base + 8u * (1 + 4 * kStages); }
};

// S (64 x 128, s32) = Q rows of this warpgroup · K tileᵀ, from their
// descriptors: 4 k-steps of 32 bytes (2 descriptor units) along the one
// 128-byte row of each.
__device__ __forceinline__ void issue_qk(int (&s)[64], uint64_t dq,
                                         uint64_t dk) {
  wgmma_m64n128k32_s8_zero(s, dq, dk);
#pragma unroll
  for (int kk = 1; kk < kD / 32; ++kk) {
    wgmma_m64n128k32_s8(s, dq + 2 * kk, dk + 2 * kk);
  }
}

// O (64 x 128) += P (registers, bf16 pairs) · V tile (descriptor dv), 8
// k-steps of 16 keys (16 rows of 128 bytes, 128 descriptor units).
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&p)[32],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_m64n128_rs<1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                        p[4 * kk + 3], dv + 128 * kk);
  }
}

// y = the s32 logits (rows 16·warp + g and + 8, keys 8·nt + 2t and + 1 of
// the tile) in f32, exactly (|Σ| ≤ 127²·128 < 2^24), times the key's sk
// from the stage's copy in shared memory: the logit in the exp2 domain is
// rowf · y, with the row factor rowf = sq · scale · log2 e applied by
// softmax_tile.  kMask: the tile may reach past S, whose keys get the y
// that makes rowf · y = -inf (only the last tile does, so the others skip
// the test).
template <bool kMask>
__device__ __forceinline__ void dequant(const int (&acc)[64], float (&s)[64],
                                        const float (&rowf)[2],
                                        const float* sk_tile, int key0, int S,
                                        int t) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 skv =
        *reinterpret_cast<const float2*>(sk_tile + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * nt + e] =
          static_cast<float>(acc[4 * nt + e]) * ((e & 1) ? skv.y : skv.x);
    }
  }
  if (kMask && key0 + kBlockN > S) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (key0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) {
        s[i] = rowf[(i >> 1) & 1] > 0.f ? -INFINITY : INFINITY;
      }
    }
  }
}

// Online softmax of one tile in the exp2 domain, the logits rowf · y (y in
// s): updates the running max m and per-thread partial sum l of rows g and
// g + 8, leaves P in s and the factor for the old O in alpha.  The row
// factor goes into the tile's max and the exp2's multiply-add instead of
// a multiply of its own per logit; the largest rowf · y is rowf times the
// largest y where rowf > 0 and the smallest where rowf < 0 (rowf is never
// 0: see the consumers' rowf).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const float (&rowf)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float a = rowf[half];
    float ext = -INFINITY;
    if (a > 0.f) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        ext = fmaxf(ext, fmaxf(s[4 * nt + 2 * half], s[4 * nt + 2 * half + 1]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        ext = fmaxf(ext,
                    fmaxf(-s[4 * nt + 2 * half], -s[4 * nt + 2 * half + 1]));
      }
      ext = -ext;
    }
    float mx = a * ext;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key below S, so the new max is finite
    const float m_new = fmaxf(m[half], mx);
    alpha[half] = ex2(m[half] - m_new);
    m[half] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int i = 4 * nt + 2 * half;
      s[i] = ex2(fmaf(s[i], a, -m_new));
      s[i + 1] = ex2(fmaf(s[i + 1], a, -m_new));
      sum += s[i] + s[i + 1];
    }
    l[half] = l[half] * alpha[half] + sum;
  }
}

// P (f32 in the S accumulators) rounded to bf16 pairs: the a operand of
// P·V (see wgmma_m64n128_rs).
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_qk8_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ sq,
                     const float* __restrict__ sk,
                     __nv_bfloat16* __restrict__ o, int S, int H,
                     long long ob, long long os, long long oh, long long sqb,
                     long long sqs, long long sqh, long long skb,
                     long long sks, long long skh, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKBytes;
  const uint32_t sSk = sV + kStages * kVBytes;  // [stage][128 key scales]
  float* sk_f = reinterpret_cast<float*>(smem_raw + (sSk - raw));
  const Bars bar{sSk + kStages * kSkBytes};
  const int tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so that the compiler sees each
  // role's branch taken by whole warps (setmaxnreg needs that)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_init(bar.q(), 1);
    mbar_init(bar.done(), 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.kfull(s), 1 + 32);  // the TMA thread and the scale warp
      mbar_init(bar.vfull(s), 1);
      mbar_init(bar.kempty(s), 8);  // one arrival per consumer warp
      mbar_init(bar.vempty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 keeps the ring full, warp 1 the scales ----
    reg_dealloc<24>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(bar.q(), kQBytes);
      tma_load_4d(sQ, &tq, bar.q(), 0, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        const int key0 = j * kBlockN;
        mbar_wait(bar.kempty(s), free_parity);
        mbar_expect_tx(bar.kfull(s), kKBytes);
        tma_load_4d(sK + s * kKBytes, &tk, bar.kfull(s), 0, h, key0, b);
        mbar_wait(bar.vempty(s), free_parity);
        mbar_expect_tx(bar.vfull(s), kVBytes);
        tma_load_4d(sV + s * kVBytes, &tv, bar.vfull(s), 0, h, key0, b);
        tma_load_4d(sV + s * kVBytes + kVBox, &tv, bar.vfull(s), 64, h, key0,
                    b);
      }
      // the consumers spin without a trap (see mbar_wait_spin): a fault
      // that hangs them traps here instead
      mbar_wait(bar.done(), 0);
    } else if (warp == 1) {
      // the stage's 128 key scales, 0 past S: plain loads, stores to
      // shared memory, then a release arrival
      const float* sk_h = sk + b * skb + h * skh;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(bar.kempty(s), ((j / kStages) & 1) ^ 1);
        float* slot = sk_f + s * kBlockN;
#pragma unroll
        for (int r = lane; r < kBlockN; r += 32) {
          const int key = j * kBlockN + r;
          slot[r] = key < S ? sk_h[key * sks] : 0.f;
        }
        mbar_arrive(bar.kfull(s));
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int ltid = tid % 128;
    const int warp = ltid / 32;
    const int lane = ltid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // descriptors of this warpgroup's 64 Q rows (128 bytes a row) and of
    // the first K and V stages
    const uint64_t dq = desc_sw128(sQ + c * 64 * 128, 16, 1024);
    const uint64_t dk = desc_sw128(sK, 16, 1024);
    const uint64_t dv = desc_sw128(sV, kVBox, 1024);

    // sq · scale · log2 e of this thread's two query rows, kept off 0 so
    // that a masked key's rowf · y is -inf and not NaN: a row whose factor
    // is 0 gets a uniform softmax either way (rows past S take 1)
    float rowf[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + c * 64 + warp * 16 + g + 8 * half;
      const float f =
          row < S ? sq[b * sqb + row * sqs + h * sqh] * scale_log2 : 1.f;
      rowf[half] = copysignf(fmaxf(fabsf(f), FLT_MIN), f);
    }

    float oacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
    int iacc[64];
    float sacc[64];
    uint32_t pacc[32];  // P of the previous tile, the a operand of P·V
    float m[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
    float l[2] = {0.f, 0.f};              // per-thread partial row sums
    float alpha[2];

    // Named barrier 1 + c is this warpgroup's turn to issue its products;
    // warpgroup 0 starts, and each hands over once it has issued, so that
    // one's softmax runs under the other's products.  Tile 0 is peeled:
    // every later turn issues S_j = Q·K_jᵀ beside P_{j-1}·V_{j-1}, and the
    // softmax of S_j runs while the second product does.  Each warp
    // releases the K stage once S_j is done and it has read the stage's
    // key scales; P_j goes into pacc once P_{j-1}·V_{j-1} is done.
    mbar_wait_spin(bar.q(), 0);
    if (c == 0) bar_arrive(1, 256);
    mbar_wait_spin(bar.kfull(0), 0);
    bar_sync(1 + c, 256);
    wgmma_fence();
    issue_qk(iacc, dq, dk);
    wgmma_commit();
    if (!(c == 1 && n_tiles == 1)) bar_arrive(2 - c, 256);
    wgmma_wait<0>();
    fence_regs(iacc);
    dequant<true>(iacc, sacc, rowf, sk_f, 0, S, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.kempty(0));
    softmax_tile(sacc, m, l, alpha, rowf);
    pack_p(sacc, pacc);

    // one turn for tile j; the last tile may reach past S
    auto turn = [&](int j, auto last) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int sp = (j - 1) % kStages;  // tile j - 1
      const uint32_t parity_p = ((j - 1) / kStages) & 1;
      mbar_wait_spin(bar.kfull(s), parity);
      mbar_wait_spin(bar.vfull(sp), parity_p);
      bar_sync(1 + c, 256);
      wgmma_fence();
      issue_qk(iacc, dq, dk + s * (kKBytes >> 4));
      wgmma_commit();
      issue_pv(oacc, pacc, dv + sp * (kVBytes >> 4));
      wgmma_commit();
      // the other warpgroup takes no turn after its last tile
      if (!(c == 1 && j == n_tiles - 1)) bar_arrive(2 - c, 256);
      wgmma_wait<1>();  // S_j is done; P_{j-1}·V_{j-1} may still run
      fence_regs(iacc);
      dequant<decltype(last)::value>(iacc, sacc, rowf, sk_f + s * kBlockN,
                                     j * kBlockN, S, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.kempty(s));
      softmax_tile(sacc, m, l, alpha, rowf);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pacc);
      if (ltid == 0) mbar_arrive(bar.vempty(sp));
      rescale(oacc, alpha);
      pack_p(sacc, pacc);
    };
    for (int j = 1; j < n_tiles - 1; ++j) turn(j, std::false_type());
    if (n_tiles > 1) turn(n_tiles - 1, std::true_type());

    const int s = (n_tiles - 1) % kStages;
    mbar_wait_spin(bar.vfull(s), ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv(oacc, pacc, dv + s * (kVBytes >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (ltid == 0) mbar_arrive(bar.done());

    // Normalise and store O in bf16.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = l[half];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = m0 + c * 64 + warp * 16 + g + 8 * half;
      if (row < S) {
        const float inv = 1.f / sum;
        __nv_bfloat16* orow = o + b * ob + row * os + h * oh + 2 * t;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(oacc[4 * dt + 2 * half] * inv,
                                    oacc[4 * dt + 2 * half + 1] * inv);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements; the
// innermost D stride of qq/kq/v/o must be 1 and the other strides of qq,
// kq and v multiples of 16 bytes (for TMA).  Returns cudaGetLastError()
// after the launch (0 on success), or hop::kMapError + the driver's
// CUresult if a tensor map could not be encoded.
extern "C" int flash_attn_qk8_fwd(
    const void* qq, const void* kq, const void* v, const float* sq,
    const float* sk, void* o, int B, int S, int H, int D, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, float scale, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int rc = make_map_bshd_i8(&tq, qq, B, S, H, qb, qs, qh, kBlockM);
  if (rc == 0) rc = make_map_bshd_i8(&tk, kq, B, S, H, kb, ks, kh, kBlockN);
  if (rc == 0) rc = make_map_bshd(&tv, v, B, S, H, vb, vs, vh, kBlockN);
  if (rc != 0) return rc;
  // Per device, cheap: set on every call rather than cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_qk8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_qk8_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, sq, sk, static_cast<__nv_bfloat16*>(o), S, H, ob, os, oh,
      sqb, sqs, sqh, skb, sks, skh, scale * kLog2e);
  return cudaGetLastError();
}
