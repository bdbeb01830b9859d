// Layout probes for Hopper (sm_90a): each is one data-movement or
// matrix-product primitive that the 3x3 convolution kernel (conv3x3.cu)
// relies on, on a small (rows, columns, 64) bf16 tile. Plain C interface,
// loaded with ctypes from omnivggt_tpu_torch/tools/probe_layouts.py, which
// holds each probe against the torch expression of the same function.
//
// Replaces the ten tiny TPU kernels of tools/probe_mosaic_layouts.py (_run).
// There the question was whether Mosaic lowers a reshape, a shifted slice,
// a roll or a strided slice at all. Here every probe runs on the
// primitives the convolution uses, so the question is whether they address
// the tile right:
//   - the tile enters shared memory as one TMA box of a 4-D map over the
//     contiguous (rows, cols, 64) tensor, channels innermost, 128-byte
//     swizzle: pixel p is the 128-byte row p of the box, its 16-byte chunk
//     c stored at chunk c ^ (p % 8) (sm90.cuh);
//   - the movement probes read the tile back through those swizzled
//     addresses, 16 bytes at a time;
//   - the matmul probes run wgmma m64n128k16 SS on descriptors: A is 64
//     consecutive pixel rows of the tile, B the (128, 64) K-major w^T
//     staged by TMA the same way. The column-offset probe starts the A
//     descriptor `off` pixels (off * 128 bytes) into each image row, as the
//     convolution shifts its dx taps, so the start is not on the swizzle's
//     1024-byte repeat; `base_offset` chooses whether the descriptor's
//     matrix base-offset field stays 0 or carries (start >> 7) & 7.
//
// Bound by launch latency: each probe moves about 55 KB. The function's
// shared-memory attribute is set once per process; the wrapper encodes
// each tensor map once per tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int kC = 64;            // channels: one 128-byte row a pixel
constexpr int kMaxPixels = 512;   // tile rows * cols
constexpr int kSlack = 64;        // pixel rows past the tile an A block may read
constexpr int kThreads = 256;     // two warpgroups
constexpr int kTileBytes = (kMaxPixels + kSlack) * 128;
constexpr int kWBytes = 128 * 128;  // w^T: 128 rows of 64 bf16
constexpr int kSmem = 1024 + kTileBytes + kWBytes + 16;

struct ProbeParams {
  CUtensorMap x_map;  // (64, cols, rows, 1), box = the whole tile
  CUtensorMap w_map;  // (64, 1, 128, 1): the (128, 64) w^T, K-major
  __nv_bfloat16* out;
  int probe, R, W2, A, B, CO, off, base_offset;
};

__global__ void __launch_bounds__(kThreads) layout_probe(const __grid_constant__ ProbeParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tile = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* wt = tile + kTileBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(wt + kWBytes);
  const bool matmul = p.probe == 9;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t x_bytes = p.R * p.W2 * 128;
    sm90::mbar_arrive_expect_tx(bar, x_bytes + (matmul ? kWBytes : 0));
    sm90::tma_load_4d(tile, &p.x_map, bar, 0, 0, 0, 0);
    if (matmul) sm90::tma_load_4d(wt, &p.w_map, bar, 0, 0, 0, 0);
  }
  sm90::mbar_wait(bar, 0);

  if (!matmul) {
    // out (A, B, CO) with CO 64 or 128: each 8-channel vector comes from
    // pixel (r1, w1) of x, plus pixel (r2, w2) when `add`
    const int vecs = p.CO / 8;
    for (int i = threadIdx.x; i < p.A * p.B * vecs; i += kThreads) {
      const int a = i / (p.B * vecs), b = (i / vecs) % p.B, c = (i % vecs) * 8;
      const int half = c / kC, cc = c % kC;  // which 64-channel half of a concat
      int r1 = a, w1 = b, r2 = 0, w2 = 0;
      bool add = false;
      switch (p.probe) {
        case 0:  // major split (R, W2, C) -> (R/2, 2, W2, C), the two halves added
          r1 = 2 * a; r2 = 2 * a + 1; w2 = b; add = true; break;
        case 1:  // major merge, 16-aligned columns: (R, W2, C) -> (R * W2, C)
        case 2:  // the same with an unaligned column count
          r1 = a / p.W2; w1 = a % p.W2; break;
        case 3:  // channel concat of two slices shifted along the major (row) axis
          r1 = 2 * a + 2 * half; break;
        case 4:  // channel concat of two slices shifted by one column
          w1 = b + half; break;
        case 5:  // roll by one along the column axis
          w1 = (b + p.W2 - 1) % p.W2; break;
        case 6:  // strided major slice x[0::2]
          r1 = 2 * a; break;
        case 7:  // strided column slice x[:, 0::2]
          w1 = 2 * b; break;
        case 8:  // channel concat of column-interleaved slices
          w1 = 2 * b + half; break;
      }
      const uint32_t o1 = (r1 * p.W2 + w1) * 128 + cc * 2;
      uint4 v = *reinterpret_cast<const uint4*>(tile + sm90::swizzled<128>(o1));
      if (add) {
        const uint32_t o2 = (r2 * p.W2 + w2) * 128 + cc * 2;
        const uint4 u = *reinterpret_cast<const uint4*>(tile + sm90::swizzled<128>(o2));
        __nv_bfloat162* vv = reinterpret_cast<__nv_bfloat162*>(&v);
        const __nv_bfloat162* uu = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = __hadd2(vv[j], uu[j]);
      }
      *reinterpret_cast<uint4*>(p.out + (static_cast<long long>(a) * p.B + b) * p.CO + c) = v;
    }
    return;
  }

  // out (M, 128) = A (M, 64) @ w (64, 128), M = R (W2 - off): row m of A is
  // pixel (m / (W2 - off), off + m % (W2 - off)). Each image row is cut
  // into blocks of up to 64 output rows; a block's A operand is the 64
  // pixel rows from its first, and rows past the block are not stored.
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  const int wide = p.W2 - p.off, per_row = (wide + 63) / 64;
  for (int j = wg; j < p.R * per_row; j += kThreads / 128) {
    const int r = j / per_row, mb = j % per_row;
    const int first = r * p.W2 + p.off + 64 * mb;  // pixel row of the tile
    const int valid = min(64, wide - 64 * mb);
    float acc[64];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const uint8_t* a_start = tile + first * 128 + kk * 32;
      uint64_t a = sm90::desc_sw<128>(a_start, 16, 1024);
      if (p.base_offset) a = sm90::with_base_offset(a, sm90::smem_u32(a_start) >> 7);
      sm90::wgmma_ss_m64n128k16(acc, a, sm90::desc_sw<128>(wt + kk * 32, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    const long long m0 = static_cast<long long>(r) * wide + 64 * mb;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = 16 * warp + g + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * q;
      if (row < valid)
        *reinterpret_cast<__nv_bfloat162*>(p.out + (m0 + row) * 128 + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

cudaError_t set_attributes() {
  return cudaFuncSetAttribute(layout_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
}

}  // namespace

// Encodes the TMA map of a contiguous (rows, cols, 64) bf16 tile into
// map_out (128 bytes): one box of the whole tile, 128-byte swizzle.
// Returns 1 on success, 0 where the driver refuses it or the tile is over
// kMaxPixels.
extern "C" int omnivggt_probe_encode(const void* base, int rows, int cols, void* map_out) {
  if (rows < 1 || cols < 1 || rows > 256 || cols > 256 || rows * cols > kMaxPixels) return 0;
  CUtensorMap map;
  const long long dims[4] = {kC, cols, rows, 1};
  const long long strides[3] = {kC * 2, static_cast<long long>(cols) * kC * 2,
                                static_cast<long long>(rows) * cols * kC * 2};
  const int box[4] = {kC, cols, rows, 1};
  if (!sm90::encode_tiled_4d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))
    return 0;
  memcpy(map_out, &map, sizeof(map));
  return 1;
}

// probe 0..8: a movement probe from the tile x (R, W2, 64) to out
// (A, B, CO); probe 9: the matmul probe with left-operand offset `off`
// and base_offset 0 or 1, w_map the map of the contiguous (128, 64) w^T
// encoded as a (128, 1, 64) tile. Maps are 128-byte host buffers from
// omnivggt_probe_encode. Returns the cudaError_t of the launch.
extern "C" int omnivggt_layout_probe(int probe, const void* x_map, const void* w_map, void* out,
                                     int R, int W2, int A, int B, int CO, int off,
                                     int base_offset, void* stream) {
  static const cudaError_t attr = set_attributes();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (probe < 0 || probe > 9 || R * W2 > kMaxPixels || (probe == 9 && w_map == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ProbeParams p;
  memcpy(&p.x_map, x_map, sizeof(CUtensorMap));
  if (probe == 9) memcpy(&p.w_map, w_map, sizeof(CUtensorMap));
  p.out = static_cast<__nv_bfloat16*>(out);
  p.probe = probe; p.R = R; p.W2 = W2; p.A = A; p.B = B; p.CO = CO; p.off = off;
  p.base_offset = base_offset;
  layout_probe<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
