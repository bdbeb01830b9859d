// Device helpers of the one mma.sync kernel left, the ring's int8 step
// (ring_attention.cu): tile sizes, bf16 packing, the mma.sync.m16n8k16
// bf16 -> fp32 and m16n8k32 s8 -> s32 products and the int8 tile loads.
// The Hopper tile (attend_sm90.cuh) takes the constants and pack_bf16 from
// here.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t):
//   A (16x16, row): a0 (row g, k 2t..2t+1), a1 (row g+8, same k),
//                   a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
//   B (16x8, col):  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C (16x8):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// The C layout of two neighbouring 8-column tiles equals the A layout of one
// 16-deep step, so a score tile is re-packed to bf16 in registers and used
// as the A operand of the next product without touching shared memory.
//
// The int8 score product is mma.sync.m16n8k32 s8 x s8 -> s32 (exact):
//   A (16x32, row): a0 (row g, k 4t..4t+3), a1 (row g+8, same k),
//                   a2 (row g, k 4t+16..), a3 (row g+8, k 4t+16..);
//   B (32x8, col):  b0 (k 4t..4t+3, col g), b1 (k 4t+16.., col g);
//   C (16x8, s32):  as above.
// int8 tiles sit in shared memory row-major with kPadS8 bytes of padding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;   // query rows per tile: 4 warps x 16
constexpr int kBlockK = 64;   // keys per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 padding per shared row
constexpr int kPadS8 = 16;    // int8 padding per shared row
constexpr float kNegInf = -1e30f;  // finite "minus infinity", as on the TPU
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClampLog2 = 80.0f * kLog2e;  // the bounded clamp, in log2 units

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col), int8 inputs, exact s32 accumulator
__device__ __forceinline__ void mma16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 rows [row0, row0 + 64) of a (rows, D) strided matrix into a
// row-major shared tile with D + kPadS8 columns; rows at or past n_valid
// become zeros
template <int D>
__device__ __forceinline__ void load_rows_s8(int8_t* dst, const int8_t* src,
                                             long long row_stride, int row0,
                                             int n_valid) {
  constexpr int kVecs = D / 16;
  for (int i = threadIdx.x; i < kBlockK * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPadS8) + c) = val;
  }
}

// the int8 A fragments of this warp's 16 rows, D / 32 steps deep
template <int D>
__device__ __forceinline__ void load_a_fragments_s8(uint32_t (&f)[D / 32][4],
                                                    const int8_t* tile, int r0,
                                                    int t) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int8_t* lo = tile + r0 * (D + kPadS8) + kk * 32 + t * 4;
    const int8_t* hi = lo + 8 * (D + kPadS8);
    f[kk][0] = ld32(lo);
    f[kk][1] = ld32(hi);
    f[kk][2] = ld32(lo + 16);
    f[kk][3] = ld32(hi + 16);
  }
}

// s (16 x 64) = float(A (16 x D, int8 fragments) * tile^T), tile a row-major
// shared (64, D + kPadS8) int8 tile: the exact integer scores, as floats
// (|s| <= 127^2 D < 2^24)
template <int D>
__device__ __forceinline__ void mma_rows_by_tile_s8(float (&s)[kBlockK / 8][4],
                                                    const uint32_t (&a)[D / 32][4],
                                                    const int8_t* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
    int si[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* r = tile + (j * 8 + g) * (D + kPadS8) + kk * 32 + t * 4;
      mma16832_s8(si, a[kk], ld32(r), ld32(r + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = static_cast<float>(si[e]);
  }
}

// acc (16 x D) += bf16(s) (16 x 64) * tile, tile stored transposed in
// shared memory as (D, 64 + kPad)
template <int D>
__device__ __forceinline__ void mma_scores_by_tile(float (&acc)[D / 8][4],
                                                   const float (&s)[kBlockK / 8][4],
                                                   const __nv_bfloat16* tile_t,
                                                   int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
    };
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* r = tile_t + (n * 8 + g) * (kBlockK + kPad) + kk * 16 + t * 2;
      mma16816(acc[n], a, ld32(r), ld32(r + 8));
    }
  }
}

// store this warp's 16 x D accumulator, times `mul`, as bf16 rows of a
// (rows, D) strided matrix; rows at or past n_rows are skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[D / 8][4], float mul_lo,
                                           float mul_hi, int row_lo, int n_rows, int t) {
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row_lo < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (long long)row_lo * row_stride + c) =
          pack_bf16(acc[n][0] * mul_lo, acc[n][1] * mul_lo);
    if (row_hi < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (long long)row_hi * row_stride + c) =
          pack_bf16(acc[n][2] * mul_hi, acc[n][3] * mul_hi);
  }
}

}  // namespace flash
