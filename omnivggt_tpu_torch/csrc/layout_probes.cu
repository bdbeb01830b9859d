// Ten layout probes for Hopper (sm_90a): each is one data-movement or
// matrix-product primitive that the 3x3 convolution kernel (conv3x3.cu)
// relies on, on a small (rows, columns, 64) bf16 tile that goes through
// shared memory. Plain C interface, loaded with ctypes from
// omnivggt_tpu_torch/tools/probe_layouts.py, which holds each probe against
// the torch expression of the same function.
//
// Replaces the ten tiny TPU kernels of tools/probe_mosaic_layouts.py (_run).
// There the question was whether Mosaic lowers a reshape, a shifted slice,
// a roll or a strided slice at all. On Hopper every one of them is address
// arithmetic, so the question is whether the result is right and whether
// the vector loads stay legal: the tile's shared rows are padded by 4 bf16
// (8 bytes), as a bank-conflict pad would, so a slice shifted by one column
// starts on an 8-byte and not a 16-byte boundary, and load8() must pick the
// widest load the address allows (a misaligned 16-byte load faults).
//
// Bound by launch latency: each probe moves about 55 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;        // channels
constexpr int kRow = kC + 4;  // shared row length of the movement probes
constexpr int kRowM = kC + 8; // shared row length of the matmul probes
constexpr int kThreads = 128;

struct __align__(16) Vec8 {
  __nv_bfloat16 v[8];
};

// eight bf16 from shared memory by the widest load the address allows
__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* p) {
  Vec8 out;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(out.v) = *reinterpret_cast<const uint4*>(p);
  } else if ((a & 7) == 0) {
    reinterpret_cast<uint2*>(out.v)[0] = reinterpret_cast<const uint2*>(p)[0];
    reinterpret_cast<uint2*>(out.v)[1] = reinterpret_cast<const uint2*>(p)[1];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<uint32_t*>(out.v)[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
  return out;
}

// stage a contiguous (rows, cols, 64) tile into shared rows of `row` bf16
__device__ __forceinline__ void stage(__nv_bfloat16* tile, const __nv_bfloat16* x,
                                      int n_pix, int row) {
  for (int i = threadIdx.x; i < n_pix * (kC / 8); i += kThreads) {
    const int pix = i / (kC / 8), c = (i % (kC / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(x + pix * kC + c);
    __nv_bfloat16* dst = tile + pix * row + c;
    // the padded row is 8-byte aligned only
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(val.x, val.y);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(val.z, val.w);
  }
}

// The movement probes. x: (R, W2, 64); out: (A, B, CO) with CO 64 or 128.
// Each output vector of 8 channels comes from pixel (r1, w1) of x, plus
// pixel (r2, w2) when `add`.
__global__ void __launch_bounds__(kThreads) probe_move(int probe, const __nv_bfloat16* x,
                                                       __nv_bfloat16* out, int R, int W2,
                                                       int A, int B, int CO) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  stage(tile, x, R * W2, kRow);
  __syncthreads();
  const int vecs = CO / 8;
  for (int i = threadIdx.x; i < A * B * vecs; i += kThreads) {
    const int a = i / (B * vecs), b = (i / vecs) % B, c = (i % vecs) * 8;
    const int half = c / kC, cc = c % kC;  // which 64-channel half of a concat
    int r1 = a, w1 = b, r2 = 0, w2 = 0;
    bool add = false;
    switch (probe) {
      case 0:  // major split (R, W2, C) -> (R/2, 2, W2, C), the two halves added
        r1 = 2 * a; r2 = 2 * a + 1; w2 = b; add = true; break;
      case 1:  // major merge, 16-aligned columns: (R, W2, C) -> (R * W2, C)
      case 2:  // the same with an unaligned column count
        r1 = a / W2; w1 = a % W2; break;
      case 3:  // channel concat of two slices shifted along the major (row) axis
        r1 = 2 * a + 2 * half; break;
      case 4:  // channel concat of two slices shifted by one column
        w1 = b + half; break;
      case 5:  // roll by one along the column axis
        w1 = (b + W2 - 1) % W2; break;
      case 6:  // strided major slice x[0::2]
        r1 = 2 * a; break;
      case 7:  // strided column slice x[:, 0::2]
        w1 = 2 * b; break;
      case 8:  // channel concat of column-interleaved slices
        w1 = 2 * b + half; break;
    }
    Vec8 v = load8(tile + (r1 * W2 + w1) * kRow + cc);
    if (add) {
      const Vec8 u = load8(tile + (r2 * W2 + w2) * kRow + cc);
#pragma unroll
      for (int j = 0; j < 8; ++j) v.v[j] = __hadd(v.v[j], u.v[j]);
    }
    *reinterpret_cast<uint4*>(out + ((long long)(a * B + b)) * CO + c) =
        *reinterpret_cast<const uint4*>(v.v);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The matmul probes: out (M, 128) = A (M, 64) @ w (64, 128) in bf16 with
// fp32 accumulation, where row m of A is pixel (m / (W2 - off), off + m %
// (W2 - off)) of x (R, W2, 64): with off = 1 the left operand starts one
// column into every row of the tile.
__global__ void __launch_bounds__(kThreads) probe_matmul(const __nv_bfloat16* x,
                                                         const __nv_bfloat16* w,
                                                         __nv_bfloat16* out, int R, int W2,
                                                         int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [R * W2][kRowM]
  __nv_bfloat16* wt = tile + R * W2 * kRowM;                     // [128][kRowM]: w^T
  stage(tile, x, R * W2, kRowM);
  for (int i = threadIdx.x; i < kC * 128; i += kThreads) {
    const int k = i / 128, n = i % 128;
    wt[n * kRowM + k] = w[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wide = W2 - off, M = R * wide;
  for (int mb = warp; mb * 16 < M; mb += kThreads / 32) {
    const int m_lo = mb * 16 + g, m_hi = m_lo + 8;
    // rows past M read row 0 and are not stored
    const int p_lo = m_lo < M ? (m_lo / wide) * W2 + off + m_lo % wide : 0;
    const int p_hi = m_hi < M ? (m_hi / wide) * W2 + off + m_hi % wide : 0;
    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const __nv_bfloat16* lo = tile + p_lo * kRowM + kk * 16 + t * 2;
      const __nv_bfloat16* hi = tile + p_hi * kRowM + kk * 16 + t * 2;
      const uint32_t a0 = ld32(lo), a1 = ld32(hi), a2 = ld32(lo + 8), a3 = ld32(hi + 8);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const __nv_bfloat16* r = wt + (n * 8 + g) * kRowM + kk * 16 + t * 2;
        const uint32_t b0 = ld32(r), b1 = ld32(r + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = n * 8 + t * 2;
      if (m_lo < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m_lo * 128 + col) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      if (m_hi < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m_hi * 128 + col) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }
}

}  // namespace

// probe 0..8: a movement probe (see probe_move) from x (R, W2, 64) to out
// (A, B, CO); probe 9: the matmul probe with left-operand offset `off` and
// the (64, 128) matrix w. Returns the cudaError_t of the launch.
extern "C" int omnivggt_layout_probe(int probe, const void* x, const void* w, void* out,
                                     int R, int W2, int A, int B, int CO, int off,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (probe >= 0 && probe <= 8) {
    const int bytes = R * W2 * kRow * (int)sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(probe_move, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_move<<<1, kThreads, bytes, s>>>(probe, xb, ob, R, W2, A, B, CO);
  } else if (probe == 9) {
    const int bytes = (R * W2 + 128) * kRowM * (int)sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(probe_matmul, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_matmul<<<1, kThreads, bytes, s>>>(xb, static_cast<const __nv_bfloat16*>(w), ob, R, W2,
                                            off);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
