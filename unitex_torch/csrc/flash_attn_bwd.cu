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
// 3.35 TB/s).  So both kernels take B1's shape (flash_attn_fwd.cu, on
// hopper.cuh) and keep the tensor cores fed from shared memory:
//   * one block per (batch·head, 128 owned rows) with three warpgroups: a
//     producer (TMA copies by one thread, its registers given to the
//     others by setmaxnreg) and two consumers of 64 owned rows each.  The
//     TPU's sequential grid axis is the loop over a ring of streamed
//     tiles.  Each block owns its outputs, so there are no atomics and the
//     gradients are the same bit for bit from run to run;
//   * B2b owns 128 queries: TMA loads Q and dO once and streams K and V in
//     128-key tiles through a two-stage ring (K and V with full and empty
//     mbarriers of their own).  Per tile a consumer computes S = Q·Kᵀ and
//     dP = dO·Vᵀ (wgmma m64n128k16, K-major operands), P = exp2(S·s·log2 e
//     − lse·log2 e) with keys past S set to 0, dS = P ∘ (dP − Drow) rounded
//     to bf16 into a 16 KB tile of its own (K-major, as B1 stores P), and
//     dQ += dS·K with K read MN-major;
//   * B2a owns 128 keys: TMA loads K and V once and streams Q and dO in
//     64-query tiles through a three-stage ring; a producer warp copies
//     the tile's lse (times log2 e) and Drow into the stage beside them.
//     With the keys as the 64 rows of a warpgroup, Sᵀ = K·Qᵀ and dPᵀ =
//     V·dOᵀ are wgmma m64n64k16; Pᵀ and dSᵀ are rounded to bf16 into two
//     8 KB tiles of the consumer's own, and dV += Pᵀ·dO and dK += dSᵀ·Q are
//     m64n128k16 over a 64-row MN-major tile (8 KB between its two
//     64-column boxes).  dK, dV, Sᵀ and dPᵀ take 192 accumulator registers
//     of the 240 that setmaxnreg gives; 128-query tiles would need 256;
//   * a turn issues the previous tile's gradient product first and this
//     tile's two score products after it, so the streamed tile that the
//     gradient product read is released one turn before the ring needs it
//     again; two named barriers pass the turn from one consumer to the
//     other, so one's exp2 and dS arithmetic runs under the other's
//     products;
//   * the consumers wait on the ring by spinning without a trap
//     (hop::mbar_wait_spin): with a trap in their loop ptxas kept them to
//     the launch's 168 registers instead of setmaxnreg's 240 and spilled.
//     The producer thread waits, with a trap, until both consumers arrive
//     on a `done` barrier at their end, so a fault in the bookkeeping
//     still fails the launch instead of holding the card;
//   * any S: TMA reads rows past S as zeros and the producer gives them
//     lse = Drow = 0, so a query row past S has Q = dO = 0, P = 1 and
//     dS = 0 and adds nothing to dK and dV; B2b sets P of keys past S to
//     0; rows past S are computed and not stored.
//
// Head width: both kernels are templates on D, instantiated for D = 128
// (FLUX) and D = 64 (the SD3 transformer of the TSD-SR trainer), as the
// Pallas kernels are generic in D.  At D = 64 a row of q/k/v/dO is one
// 128-byte swizzle row, so every tile is a single TMA box (D = 128 needs
// two, kBox bytes apart); the products that contract over D (S, dP, Sᵀ,
// dPᵀ) take four k16 steps instead of eight; the products whose N is D
// (dQ += dS·K, dK += dSᵀ·Q, dV += Pᵀ·dO) are wgmma m64n64k16 into 32
// accumulator registers a thread instead of 64.  The rings keep their
// depth; tuning at D = 64 (deeper rings, 128-query B2a tiles, which the
// halved accumulators would allow) is left for later.
//
// Layout: q/k/v/dO/dq/dk/dv are [B, S, H, D] read through their strides
// (D contiguous, rows 16-byte aligned, as TMA requires); lse (natural
// log) and Drow are [B·H, S] f32.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hop;
using fa::kLog2e;

constexpr int kThreads = 3 * 128;
constexpr int kOwn = 128;                         // rows a block owns
constexpr uint32_t kOwnBox = kOwn * 128;          // a [128][64] box, 16 KB
constexpr int kStream = 64;                       // B2a's streamed queries
constexpr uint32_t kStreamBox = kStream * 128;    // a [64][64] box, 8 KB

// The sizes that follow from the head width D (128 or 64).
template <int D>
struct Shape {
  static constexpr int kBoxes = D / 64;  // 64-column boxes a tile
  static constexpr uint32_t kOwnBytes = kBoxes * kOwnBox;
  static constexpr uint32_t kStreamBytes = kBoxes * kStreamBox;
  static constexpr int kAcc = D / 2;  // dQ / dK / dV accumulators a thread
};

// B2b: Q, dO, the K and V rings, both consumers' dS ([64][128] bf16 as two
// [64][64] boxes), the barriers, and slack to align the base to 1024.
constexpr int kDqStages = 2;
constexpr uint32_t kDsBytes = 64 * 128 * 2;
template <int D>
constexpr uint32_t dq_smem() {
  return Shape<D>::kOwnBytes * (2 + 2 * kDqStages) + 2 * kDsBytes +
         8 * (2 + 4 * kDqStages) + 1024;
}

// B2a: K, V, the Q and dO rings of 64-query tiles, both consumers' Pᵀ and
// dSᵀ ([64 keys][64 queries] bf16, one box each), each stage's lse and
// Drow, the barriers, and the alignment slack.
constexpr int kDkvStages = 3;
constexpr uint32_t kTBytes = 64 * 64 * 2;
constexpr uint32_t kRowsBytes = 2 * kStream * 4;  // lse | Drow of a stage
template <int D>
constexpr uint32_t dkv_smem() {
  return 2 * Shape<D>::kOwnBytes + 2 * kDkvStages * Shape<D>::kStreamBytes +
         4 * kTBytes + kDkvStages * kRowsBytes + 8 * (2 + 2 * kDkvStages) +
         1024;
}

// d (64 x D) += a·b with b MN-major (kTransB = 1): the product whose N is
// the head width, m64n128k16 at D = 128 and m64n64k16 at D = 64.
template <int D>
__device__ __forceinline__ void wgmma_nd(float (&d)[D / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (D == 128) {
    wgmma_m64n128_ss<1>(d, da, db);
  } else {
    wgmma_m64n64_ss<1>(d, da, db);
  }
}

// x, which the compiler must take as a new value here: an address or
// descriptor derived from an opaque base is computed where it is used
// instead of being hoisted out of the loop into a register of its own.
// With 192 accumulator registers live, B2b ran 1–2 % faster on an H100
// with its descriptors and dS store addresses built so, in every paired
// run (unitex_torch/scripts/probe_flash_bwd.py, variant hoisted_bases;
// PERF.md).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// A descriptor whose start address is moved by `bytes` (no carry leaves
// the 14-bit address field: shared memory ends below 256 KB).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The f32 accumulator of a 64 x N product (rows 16·warp + g and + 8,
// columns 8·nt + 2t and + 1) to bf16 in a tile of [64][64] boxes, 128-byte
// swizzled as TMA would write it; the 8 rows of a store land in 8
// different bank groups.  Row r has r & 7 == g and its 16-byte chunk nt
// sits at chunk nt ^ g, bits 4-6 of the address, which are 0 in the
// 1024-aligned tile plus r·128 + 4t: so each store is one XOR away from a
// per-row base.
template <int N>
__device__ __forceinline__ void store_tile(const float (&x)[N / 2],
                                           uint32_t tile, int warp, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t row =
        opaque(tile + (warp * 16 + g + 8 * half) * 128 + (g << 4) + 4 * t);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const uint32_t a = (row ^ ((nt % 8) << 4)) + (nt / 8) * (64 * 128);
      const uint32_t v =
          pack_bf16(x[4 * nt + 2 * half], x[4 * nt + 2 * half + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
    }
  }
}

// Store 64 rows of an f32 [64][D] accumulator as bf16, times `scale`,
// guarding rows at or past S; row0 is this warpgroup's first row.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride, int row0,
                                           int S, const float (&acc)[D / 2],
                                           float scale, int warp, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + g + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* p = base + row * row_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p + dt * 8) = __floats2bfloat162_rn(
          acc[4 * dt + 2 * half] * scale, acc[4 * dt + 2 * half + 1] * scale);
    }
  }
}

// ---- B2b ----------------------------------------------------------------

// x (64 x 128) = rows (64 of a 128-row tile) · tileᵀ (128 rows), D/16
// k-steps of 16 over D, both K-major: S = Q·Kᵀ and dP = dO·Vᵀ.
template <int D>
__device__ __forceinline__ void issue_scores(float (&x)[64], uint32_t rows,
                                             uint32_t tile) {
  const uint64_t da = opaque(desc_sw128(rows, 16, 1024));
  const uint64_t db = opaque(desc_sw128(tile, 16, 1024));
  wgmma_m64n128_ss_zero(x, da, db);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kOwnBox + (kk % 4) * 32;
    wgmma_m64n128_ss(x, desc_add(da, off), desc_add(db, off));
  }
}

// dQ (64 x D) += dS (shared memory, K-major) · K tile (MN-major; the
// leading offset steps between its 64-column boxes, unused at D = 64), 8
// k-steps of 16 keys.
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2], uint32_t ds_tile,
                                         uint32_t k_tile) {
  const uint64_t da = opaque(desc_sw128(ds_tile, 16, 1024));
  const uint64_t db = opaque(desc_sw128(k_tile, kOwnBox, 1024));
#pragma unroll
  for (int kk = 0; kk < kOwn / 16; ++kk) {
    const uint32_t off = (kk / 4) * (kDsBytes / 2) + (kk % 4) * 32;
    wgmma_nd<D>(dq, desc_add(da, off), desc_add(db, kk * 16 * 128));
  }
}

// The mbarriers of B2b, 8 bytes each from `base`: Q and dO's, per stage K
// full, V full, K empty and V empty, then the consumers' done.
struct DqBars {
  uint32_t base;
  __device__ uint32_t own() const { return base; }
  __device__ uint32_t done() const { return base + 8u * (1 + 4 * kDqStages); }
  __device__ uint32_t kfull(int s) const { return base + 8u * (1 + s); }
  __device__ uint32_t vfull(int s) const {
    return base + 8u * (1 + kDqStages + s);
  }
  __device__ uint32_t kempty(int s) const {
    return base + 8u * (1 + 2 * kDqStages + s);
  }
  __device__ uint32_t vempty(int s) const {
    return base + 8u * (1 + 3 * kDqStages + s);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse,
                        const float* __restrict__ drow,
                        __nv_bfloat16* __restrict__ dq, int S, int H,
                        long long ob, long long os, long long oh, float scale,
                        float scale_log2) {
  constexpr uint32_t kOwnBytes = Shape<D>::kOwnBytes;
  constexpr int kBoxes = Shape<D>::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + kOwnBytes;
  const uint32_t sK = sG + kOwnBytes;
  const uint32_t sV = sK + kDqStages * kOwnBytes;
  const uint32_t sDs = sV + kDqStages * kOwnBytes;
  const DqBars bar{sDs + 2 * kDsBytes};
  const int tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so that the compiler sees each
  // role's branch taken by whole warps (setmaxnreg needs that)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_tiles = (S + kOwn - 1) / kOwn;

  if (tid == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tg);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_init(bar.own(), 1);
    mbar_init(bar.done(), 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_expect_tx(bar.own(), 2 * kOwnBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(sQ + x * kOwnBox, &tq, bar.own(), 64 * x, h, m0, b);
        tma_load_4d(sG + x * kOwnBox, &tg, bar.own(), 64 * x, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kDqStages;
        const uint32_t free_parity = ((j / kDqStages) & 1) ^ 1;
        const int key0 = j * kOwn;
        // V is released a turn before K (K also feeds dS·K), so it goes
        // first and never waits behind K's slot
        mbar_wait(bar.vempty(s), free_parity);
        mbar_expect_tx(bar.vfull(s), kOwnBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(sV + s * kOwnBytes + x * kOwnBox, &tv, bar.vfull(s),
                      64 * x, h, key0, b);
        }
        mbar_wait(bar.kempty(s), free_parity);
        mbar_expect_tx(bar.kfull(s), kOwnBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(sK + s * kOwnBytes + x * kOwnBox, &tk, bar.kfull(s),
                      64 * x, h, key0, b);
        }
      }
      // the consumers spin without a trap (see mbar_wait_spin): a fault
      // in their bookkeeping traps here
      mbar_wait(bar.done(), 0);
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
    const uint32_t g_rows = sG + c * 64 * 128;
    const uint32_t ds_tile = sDs + c * kDsBytes;

    // lse (in the exp2 domain) and Drow of this thread's two rows; rows
    // past S take 0 (their Q and dO are zeros, so dS is 0 there)
    float lrow[2], drw[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + c * 64 + warp * 16 + g + 8 * half;
      const long long idx = static_cast<long long>(bh) * S + row;
      lrow[half] = row < S ? lse[idx] * kLog2e : 0.f;
      drw[half] = row < S ? drow[idx] : 0.f;
    }

    float dqacc[Shape<D>::kAcc];
#pragma unroll
    for (int i = 0; i < Shape<D>::kAcc; ++i) dqacc[i] = 0.f;
    float sacc[64];
    float dpacc[64];

    // Named barrier 1 + c is this warpgroup's turn to issue its products;
    // warpgroup 0 starts, and each hands over once it has issued.  Barrier
    // 3 + c joins this warpgroup's dS stores before dS·K reads them.  Turn
    // j issues dQ += dS_{j-1}·K_{j-1} first, then S_j and dP_j, so K_{j-1}
    // is released as soon as its product is done.
    mbar_wait_spin(bar.own(), 0);
    if (c == 0) bar_arrive(1, 256);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kDqStages;
      const uint32_t parity = (j / kDqStages) & 1;
      const int sp = (j + kDqStages - 1) % kDqStages;  // tile j - 1
      mbar_wait_spin(bar.kfull(s), parity);
      mbar_wait_spin(bar.vfull(s), parity);
      bar_sync(1 + c, 256);
      wgmma_fence();
      if (j > 0) issue_dq<D>(dqacc, ds_tile, sK + sp * kOwnBytes);
      wgmma_commit();
      issue_scores<D>(sacc, q_rows, sK + s * kOwnBytes);
      issue_scores<D>(dpacc, g_rows, sV + s * kOwnBytes);
      wgmma_commit();
      // the other warpgroup takes no turn after its last tile
      if (!(c == 1 && j == n_tiles - 1)) bar_arrive(2 - c, 256);
      wgmma_wait<1>();  // dS_{j-1}·K_{j-1} is done
      fence_regs(dqacc);
      if (j > 0 && ltid == 0) mbar_arrive(bar.kempty(sp));
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      if (ltid == 0) mbar_arrive(bar.vempty(s));

      // P = exp2(S·s·log2 e − lse·log2 e), 0 for keys past S; dS = P ∘
      // (dP − Drow), left in dpacc.  Element i is row g + 8·((i >> 1) & 1)
      // and key 8·(i / 4) + 2t + (i & 1) of the tile.
      const int key0 = j * kOwn;
      const bool tail = key0 + kOwn > S;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int half = (i >> 1) & 1;
        float p = ex2(fmaf(sacc[i], scale_log2, -lrow[half]));
        if (tail && key0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) p = 0.f;
        dpacc[i] = p * (dpacc[i] - drw[half]);
      }
      store_tile<128>(dpacc, ds_tile, warp, g, t);
      fence_proxy_async();
      bar_sync(3 + c, 128);
    }
    wgmma_fence();
    issue_dq<D>(dqacc, ds_tile,
                sK + ((n_tiles - 1) % kDqStages) * kOwnBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    if (ltid == 0) mbar_arrive(bar.done());
    store_rows<D>(dq + b * ob + h * oh, os, m0 + c * 64, S, dqacc, scale,
                  warp, g, t);
  }
}

// ---- B2a ----------------------------------------------------------------

// x (64 x 64) = rows (64 of a 128-row tile) · tileᵀ (64 rows), D/16
// k-steps of 16 over D, both K-major: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ.
template <int D>
__device__ __forceinline__ void issue_scores_t(float (&x)[32], uint32_t rows,
                                               uint32_t tile) {
  const uint64_t da = opaque(desc_sw128(rows, 16, 1024));
  const uint64_t db = opaque(desc_sw128(tile, 16, 1024));
  wgmma_m64n64_ss_zero(x, da, db);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_m64n64_ss(x, desc_add(da, (kk / 4) * kOwnBox + col),
                    desc_add(db, (kk / 4) * kStreamBox + col));
  }
}

// acc (64 x D) += t_tile ([64 keys][64 queries], K-major) · a 64-row
// streamed tile (MN-major; at D = 128 its two 64-column boxes 8 KB apart),
// 4 k-steps of 16 queries: dV += Pᵀ·dO and dK += dSᵀ·Q.
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2],
                                           uint32_t t_tile, uint32_t tile) {
  const uint64_t da = opaque(desc_sw128(t_tile, 16, 1024));
  const uint64_t db = opaque(desc_sw128(tile, kStreamBox, 1024));
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    wgmma_nd<D>(acc, desc_add(da, kk * 32), desc_add(db, kk * 16 * 128));
  }
}

// The mbarriers of B2a, 8 bytes each from `base`: K and V's, per stage
// full (TMA bytes and the 32 arrivals of the row-copying warp) and empty,
// then the consumers' done.
struct DkvBars {
  uint32_t base;
  __device__ uint32_t own() const { return base; }
  __device__ uint32_t done() const { return base + 8u * (1 + 2 * kDkvStages); }
  __device__ uint32_t full(int s) const { return base + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return base + 8u * (1 + kDkvStages + s);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ lse,
                         const float* __restrict__ drow,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int H,
                         long long dkb, long long dks, long long dkh,
                         long long dvb, long long dvs, long long dvh,
                         float scale, float scale_log2) {
  constexpr uint32_t kOwnBytes = Shape<D>::kOwnBytes;
  constexpr uint32_t kStreamBytes = Shape<D>::kStreamBytes;
  constexpr int kBoxes = Shape<D>::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + kOwnBytes;
  const uint32_t sQ = sV + kOwnBytes;  // stage s at + s·kStreamBytes
  const uint32_t sG = sQ + kDkvStages * kStreamBytes;   // dO, likewise
  const uint32_t sT = sG + kDkvStages * kStreamBytes;   // Pᵀ, Pᵀ, dSᵀ, dSᵀ
  const uint32_t sRows = sT + 4 * kTBytes;              // [stage][lse | Drow]
  float* rows_f = reinterpret_cast<float*>(smem_raw + (sRows - raw));
  const DkvBars bar{sRows + kDkvStages * kRowsBytes};
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_tiles = (S + kStream - 1) / kStream;

  if (tid == 0) {
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tq);
    tma_prefetch(&tg);
    mbar_init(bar.own(), 1);
    mbar_init(bar.done(), 2);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(bar.full(s), 1 + 32);  // the TMA thread and the row warp
      mbar_init(bar.empty(s), 2);      // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA copies, warp 1 the rows ----
    reg_dealloc<24>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(bar.own(), 2 * kOwnBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(sK + x * kOwnBox, &tk, bar.own(), 64 * x, h, n0, b);
        tma_load_4d(sV + x * kOwnBox, &tv, bar.own(), 64 * x, h, n0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDkvStages;
        const int m0 = i * kStream;
        mbar_wait(bar.empty(s), ((i / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), 2 * kStreamBytes);
        const uint32_t q_st = sQ + s * kStreamBytes;
        const uint32_t g_st = sG + s * kStreamBytes;
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(q_st + x * kStreamBox, &tq, bar.full(s), 64 * x, h, m0,
                      b);
          tma_load_4d(g_st + x * kStreamBox, &tg, bar.full(s), 64 * x, h, m0,
                      b);
        }
      }
      mbar_wait(bar.done(), 0);  // as in B2b
    } else if (warp == 1) {
      // lse (times log2 e) and Drow of the stage's 64 queries, 0 past S:
      // plain loads, stores to shared memory, then a release arrival
      const float* lse_h = lse + static_cast<long long>(bh) * S;
      const float* drow_h = drow + static_cast<long long>(bh) * S;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDkvStages;
        mbar_wait(bar.empty(s), ((i / kDkvStages) & 1) ^ 1);
        float* slot = rows_f + s * 2 * kStream;
#pragma unroll
        for (int r = lane; r < kStream; r += 32) {
          const int m = i * kStream + r;
          slot[r] = m < S ? lse_h[m] * kLog2e : 0.f;
          slot[kStream + r] = m < S ? drow_h[m] : 0.f;
        }
        mbar_arrive(bar.full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int ltid = tid % 128;
    const int warp = ltid / 32;
    const int lane = ltid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t k_rows = sK + c * 64 * 128;  // 128 bytes a row in a box
    const uint32_t v_rows = sV + c * 64 * 128;
    const uint32_t pt_tile = sT + c * kTBytes;
    const uint32_t dst_tile = sT + (2 + c) * kTBytes;

    float dkacc[Shape<D>::kAcc], dvacc[Shape<D>::kAcc];
#pragma unroll
    for (int i = 0; i < Shape<D>::kAcc; ++i) dkacc[i] = dvacc[i] = 0.f;
    float st[32];
    float dpt[32];

    // Turns as in B2b: turn i issues dV += Pᵀ_{i-1}·dO_{i-1} and dK +=
    // dSᵀ_{i-1}·Q_{i-1} first, then Sᵀ_i and dPᵀ_i, and releases stage
    // i - 1 once the first two are done.
    mbar_wait_spin(bar.own(), 0);
    if (c == 0) bar_arrive(1, 256);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kDkvStages;
      const uint32_t parity = (i / kDkvStages) & 1;
      const int sp = (i + kDkvStages - 1) % kDkvStages;  // tile i - 1
      mbar_wait_spin(bar.full(s), parity);
      bar_sync(1 + c, 256);
      wgmma_fence();
      if (i > 0) {
        issue_grad<D>(dvacc, pt_tile, sG + sp * kStreamBytes);
        issue_grad<D>(dkacc, dst_tile, sQ + sp * kStreamBytes);
      }
      wgmma_commit();
      issue_scores_t<D>(st, k_rows, sQ + s * kStreamBytes);
      issue_scores_t<D>(dpt, v_rows, sG + s * kStreamBytes);
      wgmma_commit();
      if (!(c == 1 && i == n_tiles - 1)) bar_arrive(2 - c, 256);
      wgmma_wait<1>();  // the products of tile i - 1 are done
      fence_regs(dkacc);
      fence_regs(dvacc);
      if (i > 0 && ltid == 0) mbar_arrive(bar.empty(sp));
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // Pᵀ = exp2(Sᵀ·s·log2 e − lse[q]·log2 e); dSᵀ = Pᵀ ∘ (dPᵀ − Drow[q]).
      // Element 4·nt + e is key g + 8·(e >> 1) and query 8·nt + 2t +
      // (e & 1) of the tile.
      const float* lrow = rows_f + s * 2 * kStream;
      const float* drw = lrow + kStream;
#pragma unroll
      for (int nt = 0; nt < kStream / 8; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + nt * 8 + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(drw + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i4 = 4 * nt + e;
          const float p = ex2(fmaf(st[i4], scale_log2, (e & 1) ? -l2.y : -l2.x));
          st[i4] = p;
          dpt[i4] = p * (dpt[i4] - ((e & 1) ? d2.y : d2.x));
        }
      }
      store_tile<64>(st, pt_tile, warp, g, t);
      store_tile<64>(dpt, dst_tile, warp, g, t);
      fence_proxy_async();
      bar_sync(3 + c, 128);
    }
    const int s = (n_tiles - 1) % kDkvStages;
    wgmma_fence();
    issue_grad<D>(dvacc, pt_tile, sG + s * kStreamBytes);
    issue_grad<D>(dkacc, dst_tile, sQ + s * kStreamBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dkacc);
    fence_regs(dvacc);
    if (ltid == 0) mbar_arrive(bar.done());
    store_rows<D>(dk + b * dkb + h * dkh, dks, n0 + c * 64, S, dkacc, scale,
                  warp, g, t);
    store_rows<D>(dv + b * dvb + h * dvh, dvs, n0 + c * 64, S, dvacc, 1.f,
                  warp, g, t);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* drow, void* dk, void* dv, int B,
               int S, int H, long long qb, long long qs, long long qh,
               long long kb, long long ks, long long kh, long long vb,
               long long vs, long long vh, long long gb, long long gs,
               long long gh, long long dkb, long long dks, long long dkh,
               long long dvb, long long dvs, long long dvh, float scale,
               void* stream) {
  CUtensorMap tk, tv, tq, tg;
  int rc = make_map_bshd(&tk, k, B, S, H, kb, ks, kh, kOwn, D);
  if (rc == 0) rc = make_map_bshd(&tv, v, B, S, H, vb, vs, vh, kOwn, D);
  if (rc == 0) rc = make_map_bshd(&tq, q, B, S, H, qb, qs, qh, kStream, D);
  if (rc == 0) rc = make_map_bshd(&tg, dout, B, S, H, gb, gs, gh, kStream, D);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(),
                            static_cast<cudaStream_t>(stream)>>>(
      tk, tv, tq, tg, lse, drow, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, dkb, dks, dkh, dvb, dvs, dvh,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* drow, void* dq, int B, int S,
              int H, long long qb, long long qs, long long qh, long long kb,
              long long ks, long long kh, long long vb, long long vs,
              long long vh, long long gb, long long gs, long long gh,
              long long dqb, long long dqs, long long dqh, float scale,
              void* stream) {
  CUtensorMap tq, tg, tk, tv;
  int rc = make_map_bshd(&tq, q, B, S, H, qb, qs, qh, kOwn, D);
  if (rc == 0) rc = make_map_bshd(&tg, dout, B, S, H, gb, gs, gh, kOwn, D);
  if (rc == 0) rc = make_map_bshd(&tk, k, B, S, H, kb, ks, kh, kOwn, D);
  if (rc == 0) rc = make_map_bshd(&tv, v, B, S, H, vb, vs, vh, kOwn, D);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(),
                           static_cast<cudaStream_t>(stream)>>>(
      tq, tg, tk, tv, lse, drow, static_cast<__nv_bfloat16*>(dq), S, H, dqb,
      dqs, dqh, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  D is 128 or 64; any other D
// returns cudaErrorInvalidValue.  Strides are in elements, three
// (batch, sequence, head) per [B, S, H, D] tensor; the innermost D stride
// of every tensor must be 1 and the others multiples of 8 (16 bytes, for
// TMA).  Each returns cudaGetLastError() after its launch (0 on success),
// or hop::kMapError + the driver's CUresult if a tensor map could not be
// encoded.
extern "C" int flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* drow, void* dk, void* dv, int B, int S,
    int H, int D, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    long long gb, long long gs, long long gh, long long dkb, long long dks,
    long long dkh, long long dvb, long long dvs, long long dvh, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 128) {
    return launch_dkv<128>(q, k, v, dout, lse, drow, dk, dv, B, S, H, qb, qs,
                           qh, kb, ks, kh, vb, vs, vh, gb, gs, gh, dkb, dks,
                           dkh, dvb, dvs, dvh, scale, stream);
  }
  if (D == 64) {
    return launch_dkv<64>(q, k, v, dout, lse, drow, dk, dv, B, S, H, qb, qs,
                          qh, kb, ks, kh, vb, vs, vh, gb, gs, gh, dkb, dks,
                          dkh, dvb, dvs, dvh, scale, stream);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* drow, void* dq, int B, int S, int H, int D,
    long long qb, long long qs, long long qh, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, long long gb,
    long long gs, long long gh, long long dqb, long long dqs, long long dqh,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 128) {
    return launch_dq<128>(q, k, v, dout, lse, drow, dq, B, S, H, qb, qs, qh,
                          kb, ks, kh, vb, vs, vh, gb, gs, gh, dqb, dqs, dqh,
                          scale, stream);
  }
  if (D == 64) {
    return launch_dq<64>(q, k, v, dout, lse, drow, dq, B, S, H, qb, qs, qh,
                         kb, ks, kh, vb, vs, vh, gb, gs, gh, dqb, dqs, dqh,
                         scale, stream);
  }
  return cudaErrorInvalidValue;
}
