// Building blocks of the mma.sync flash-attention kernel B3
// (flash_attn_qk8.cu; sm_90a, f32 accumulate): cp.async copies into
// XOR-swizzled shared-memory tiles, ldmatrix fragment loads and the
// m16n8k16 tensor-core product.  hopper.cuh reuses its constants, the
// shared-memory address and the bf16 packing.
//
// A tile is [rows][kD] bf16, one 256-byte row per sequence position; its
// 16-byte chunks are XOR-swizzled by row so that the 8 row addresses of
// one ldmatrix fall in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int kD = 128;
constexpr int kChunksPerRow = kD * 2 / 16;  // 16-byte chunks in one row
constexpr int kRowBytes = kD * 2;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;  // 0 source bytes: the 4 bytes are zeroed
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// Copy rows [row0, row0 + ROWS) of one head into a swizzled smem tile with
// THREADS threads; rows at or past S are zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int S, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunksPerRow / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / kChunksPerRow;
    const int c = idx % kChunksPerRow;
    const int s = row0 + r;
    const bool ok = s < S;
    const __nv_bfloat16* p = src + (ok ? s : 0) * row_stride + c * 8;
    cp_async16(dst + swz(r, c), p, ok);
  }
}

// B fragments of two 8-wide D tiles (dp * 16 ..) for a product over the
// tile's rows (k-step of 16 rows starting at k0): the tile is the second
// operand as it is stored, [k][kD].
__device__ __forceinline__ void ldsm_kd(uint32_t tile, int k0, int dp,
                                        int lane, uint32_t& b0, uint32_t& b1,
                                        uint32_t& b2, uint32_t& b3) {
  const int row = k0 + (((lane >> 3) & 1) << 3) + (lane & 7);
  ldsm_x4_t(tile + swz(row, dp * 2 + (lane >> 4)), b0, b1, b2, b3);
}

// A fragment for k-step kk of a product over an accumulator's columns:
// the m16n8 accumulators 2kk and 2kk+1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&lo)[4],
                                         const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace fa
