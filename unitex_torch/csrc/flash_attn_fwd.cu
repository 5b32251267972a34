// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: unitex_tpu/ops/attention.py:_flash_kernel (launched by
// _flash_forward) — non-causal softmax(Q K^T / sqrt(D)) V over the MMDiT
// joint sequence, with an online softmax, plus the per-row logsumexp.
//
// Bound: compute.  4·B·H·S²·D FLOPs on the tensor cores (989 TFLOP/s bf16
// dense on an H100 SXM) against 4·B·S·H·D·2 bytes of q/k/v/out traffic: at
// S = 13824, D = 128 that is ~6900 FLOP per byte, far right of the ~295
// FLOP/byte ridge.  Second to the products comes the exponential: S² exp2
// on the SFUs (16 a clock per SM) take about half the tensor-core time.  So
// the design keeps the tensor cores fed from shared memory and runs one
// warpgroup's softmax under the other's products:
//   * one block per (batch·head, 128-query tile) and three warpgroups: a
//     producer (one thread issues TMA copies, its registers given to the
//     others by setmaxnreg) and two consumers of 64 query rows each;
//   * TMA loads Q once and K and V tiles of 128 keys into a ring of
//     kStages stages, 128-byte swizzled, each guarded by a full and an
//     empty mbarrier (K and V apart, so a K stage refills as soon as its
//     S product is done); the key axis (the TPU's sequential grid axis) is
//     the loop over the ring;
//   * S = Q·Kᵀ and O += P·V are wgmma m64n128k16 with both operands in
//     shared memory (read once per 64-row warpgroup, not once per 16-row
//     warp as with mma.sync): each consumer writes its P, rounded to bf16,
//     into a 16 KB tile of its own, K-major, and V is read MN-major;
//   * each consumer issues S_j = Q·K_jᵀ beside P_{j-1}·V_{j-1} and runs the
//     softmax of S_j while the second product does; P goes through shared
//     memory because S, O and a register P live at once were more than
//     ptxas would keep in registers (it serialized the products and
//     spilled P, PERF.md);
//   * two named barriers pass the turn to issue products from one consumer
//     to the other, so one's softmax also runs under the other's products;
//   * any S: TMA reads rows past S as zeros, keys past S are masked to
//     -inf before the max, query rows past S are computed and not stored.
//
// Head width: one kernel template, instantiated for D = 128 (FLUX) and
// D = 64 (the SD3 transformer of TSD-SR), as the Pallas kernel is generic
// in D.  At D = 64 a K or V row is exactly one 128-byte swizzle row, so a
// 128-key tile is one 16 KB TMA box (D = 128 needs two); Q·Kᵀ runs four
// k16 steps instead of eight; P·V is a wgmma m64n64k16, so the O
// accumulator is 32 registers a thread instead of 64; and, with the tile
// half as large, the ring is three stages deep instead of two.  At SD3's
// S = 1178 the products per key tile halve while the exp work stays the
// same, so the SFUs bound it about as much as the tensor cores do.
//
// Layout: q/k/v/out are [B, S, H, D] read through their strides (D
// contiguous, rows 16-byte aligned, as TMA requires); lse is [B·H, S] f32
// in natural log.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hop;
using fa::kLog2e;

constexpr int kBlockM = 128;  // queries per block: two warpgroups of 64
constexpr int kBlockN = 128;  // keys per stage
constexpr int kThreads = 3 * 128;
constexpr uint32_t kBoxBytes = 128 * 64 * 2;  // one [128][64] box

// The sizes that follow from the head width D (128 or 64).
template <int D>
struct Shape {
  static constexpr int kBoxes = D / 64;                   // boxes a tile
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // 128 rows
  static constexpr int kStages = D == 64 ? 3 : 2;         // K/V ring depth
  static constexpr int kAcc = D / 2;  // O accumulators a thread
};

// P of one consumer: [64 rows][128 keys] bf16 as two 128-byte-swizzled
// [64][64] boxes, the K-major A operand of P·V
constexpr uint32_t kPBytes = 64 * 128 * 2;
// Q, the K and V rings, both consumers' P, the barriers, and slack to
// align the base to 1024
template <int D>
constexpr uint32_t smem_bytes() {
  return Shape<D>::kTileBytes * (1 + 2 * Shape<D>::kStages) + 2 * kPBytes +
         8 * (1 + 4 * Shape<D>::kStages) + 1024;
}

// The mbarriers, 8 bytes each from `base`: Q's, then per stage K full, V
// full, K empty and V empty.
template <int kStages>
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
};

// S (64 x 128) = Q rows of this warpgroup · K tileᵀ, D/16 k-steps of 16.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
  wgmma_m64n128_ss_zero(s, desc_sw128(q_rows, 16, 1024),
                        desc_sw128(k_tile, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_m64n128_ss(s, desc_sw128(q_rows + off, 16, 1024),
                     desc_sw128(k_tile + off, 16, 1024));
  }
}

// O (64 x D) += P (shared memory) · V tile, 8 k-steps of 16 keys: V is
// MN-major, the leading offset steps between its 64-column boxes (one at
// D = 64, where it is unused).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t p_tile,
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t da =
        desc_sw128(p_tile + (kk / 4) * (kPBytes / 2) + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(v_tile + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128_ss<1>(o, da, db);
    } else {
      wgmma_m64n64_ss<1>(o, da, db);
    }
  }
}

// P (f32 in the S accumulators: rows 16·warp + g and + 8, keys 8·nt + 2t
// and + 1) to bf16 in this warpgroup's P tile, 128-byte swizzled as TMA
// would write it; the 8 rows of a store land in 8 different bank groups.
__device__ __forceinline__ void store_p(const float (&s)[64], uint32_t p_tile,
                                        int warp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      const uint32_t a = p_tile + (nt / 8) * (kPBytes / 2) + r * 128 +
                         (((nt % 8) ^ (r & 7)) << 4) + 4 * t;
      const uint32_t v =
          pack_bf16(s[4 * nt + 2 * half], s[4 * nt + 2 * half + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
    }
  }
}

// Online softmax of one S tile of 128 keys in the exp2 domain: masks keys
// past S, updates the running max m and per-thread partial sum l of rows g
// and g + 8, leaves P in s and the factor for the old O in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int key0, int S,
                                             int t) {
  if (key0 + kBlockN > S) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (key0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * half], s[4 * nt + 2 * half + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key below S, so the new max is finite
    const float m_new = fmaxf(m[half], mx * scale_log2);
    alpha[half] = ex2(m[half] - m_new);
    m[half] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int i = 4 * nt + 2 * half;
      s[i] = ex2(fmaf(s[i], scale_log2, -m_new));
      s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, -m_new));
      sum += s[i] + s[i + 1];
    }
    l[half] = l[half] * alpha[half] + sum;
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int H, long long ob, long long os, long long oh,
                     float scale_log2) {
  constexpr uint32_t kTileBytes = Shape<D>::kTileBytes;
  constexpr int kStages = Shape<D>::kStages;
  constexpr int kBoxes = Shape<D>::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTileBytes;
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t sP = sV + kStages * kTileBytes;
  const Bars<kStages> bar{sP + 2 * kPBytes};
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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.kfull(s), 1);
      mbar_init(bar.vfull(s), 1);
      mbar_init(bar.kempty(s), 2);  // one arrival per consumer warpgroup
      mbar_init(bar.vempty(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(bar.q(), kTileBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(sQ + x * kBoxBytes, &tq, bar.q(), 64 * x, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        const int key0 = j * kBlockN;
        mbar_wait(bar.kempty(s), free_parity);
        mbar_expect_tx(bar.kfull(s), kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(sK + s * kTileBytes + x * kBoxBytes, &tk, bar.kfull(s),
                      64 * x, h, key0, b);
        }
        mbar_wait(bar.vempty(s), free_parity);
        mbar_expect_tx(bar.vfull(s), kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(sV + s * kTileBytes + x * kBoxBytes, &tv, bar.vfull(s),
                      64 * x, h, key0, b);
        }
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
    const uint32_t q_rows = sQ + c * 64 * 128;  // 128 bytes a row in a box
    const uint32_t p_tile = sP + c * kPBytes;

    float oacc[Shape<D>::kAcc];
#pragma unroll
    for (int i = 0; i < Shape<D>::kAcc; ++i) oacc[i] = 0.f;
    float sacc[64];
    float m[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
    float l[2] = {0.f, 0.f};              // per-thread partial row sums
    float alpha[2];

    // Named barrier 1 + c is this warpgroup's turn to issue its products;
    // warpgroup 0 starts, and each hands over once it has issued, so that
    // one's softmax runs under the other's products.  Barrier 3 + c joins
    // this warpgroup's P stores before P·V reads them.  Tile 0 is peeled:
    // every later turn issues S_j = Q·K_jᵀ beside P_{j-1}·V_{j-1}, and the
    // softmax of S_j runs while the second product does.
    mbar_wait(bar.q(), 0);
    if (c == 0) bar_arrive(1, 256);
    mbar_wait(bar.kfull(0), 0);
    bar_sync(1 + c, 256);
    wgmma_fence();
    issue_qk<D>(sacc, q_rows, sK);
    wgmma_commit();
    if (!(c == 1 && n_tiles == 1)) bar_arrive(2 - c, 256);
    wgmma_wait<0>();
    fence_regs(sacc);
    if (ltid == 0) mbar_arrive(bar.kempty(0));
    softmax_tile(sacc, m, l, alpha, scale_log2, 0, S, t);
    store_p(sacc, p_tile, warp, g, t);
    fence_proxy_async();
    bar_sync(3 + c, 128);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int sp = (j - 1) % kStages;  // tile j - 1
      const uint32_t parity_p = ((j - 1) / kStages) & 1;
      mbar_wait(bar.kfull(s), parity);
      mbar_wait(bar.vfull(sp), parity_p);
      bar_sync(1 + c, 256);
      wgmma_fence();
      issue_qk<D>(sacc, q_rows, sK + s * kTileBytes);
      wgmma_commit();
      issue_pv<D>(oacc, p_tile, sV + sp * kTileBytes);
      wgmma_commit();
      // the other warpgroup takes no turn after its last tile
      if (!(c == 1 && j == n_tiles - 1)) bar_arrive(2 - c, 256);
      wgmma_wait<1>();  // S_j is done; P_{j-1}·V_{j-1} may still run
      fence_regs(sacc);
      if (ltid == 0) mbar_arrive(bar.kempty(s));
      softmax_tile(sacc, m, l, alpha, scale_log2, j * kBlockN, S, t);
      wgmma_wait<0>();
      fence_regs(oacc);
      if (ltid == 0) mbar_arrive(bar.vempty(sp));
      rescale(oacc, alpha);
      store_p(sacc, p_tile, warp, g, t);
      fence_proxy_async();
      bar_sync(3 + c, 128);
    }
    const int s = (n_tiles - 1) % kStages;
    mbar_wait(bar.vfull(s), ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<D>(oacc, p_tile, sV + s * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);

    // Normalise, store O in bf16 and the natural-log lse in f32.
    const float kLn2 = 0.69314718055994531f;
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
        for (int dt = 0; dt < D / 8; ++dt) {
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(oacc[4 * dt + 2 * half] * inv,
                                    oacc[4 * dt + 2 * half + 1] * inv);
        }
        if (t == 0) {
          lse[static_cast<long long>(bh) * S + row] =
              (m[half] + log2f(sum)) * kLn2;
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, long long qb, long long qs, long long qh,
           long long kb, long long ks, long long kh, long long vb,
           long long vs, long long vh, long long ob, long long os,
           long long oh, float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_map_bshd(&tq, q, B, S, H, qb, qs, qh, kBlockM, D);
  if (rc == 0) rc = make_map_bshd(&tk, k, B, S, H, kb, ks, kh, kBlockN, D);
  if (rc == 0) rc = make_map_bshd(&tv, v, B, S, H, vb, vs, vh, kBlockN, D);
  if (rc != 0) return rc;
  // Per device, cheap: set on every call rather than cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(),
                        static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H, ob, os, oh,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  D is 128 or 64.  Strides are in
// elements; the innermost D stride of every tensor must be 1 and the others
// multiples of 8 (16 bytes, for TMA).  Returns cudaGetLastError() after the
// launch (0 on success), or hop::kMapError + the driver's CUresult if a
// tensor map could not be encoded.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int H,
                                   int D, long long qb, long long qs,
                                   long long qh, long long kb, long long ks,
                                   long long kh, long long vb, long long vs,
                                   long long vh, long long ob, long long os,
                                   long long oh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 128) {
    return launch<128>(q, k, v, o, lse, B, S, H, qb, qs, qh, kb, ks, kh, vb,
                       vs, vh, ob, os, oh, scale, stream);
  }
  if (D == 64) {
    return launch<64>(q, k, v, o, lse, B, S, H, qb, qs, qh, kb, ks, kh, vb,
                      vs, vh, ob, os, oh, scale, stream);
  }
  return cudaErrorInvalidValue;
}
