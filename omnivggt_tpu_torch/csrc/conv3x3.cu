// 3x3 stride-1 pad-1 convolution + bias + optional ReLU for Hopper (sm_90a),
// cout <= 64, fp32 accumulation, output in the input's type. Plain C
// interface, loaded with ctypes from omnivggt_tpu_torch/ops/kernels/conv3x3.py.
//
// Replaces the TPU kernel _conv_kernel of omnivggt_tpu/ops/pallas/conv3x3.py
// (reached through conv3x3_folded): on the flagship the DPT heads'
// output_conv2[0], 128 -> 32 channels at 518 x 518, 8 frames a chunk.
// The TPU kernel folds output columns into the 128 lanes, expands the x taps
// outside the kernel and pads to Mosaic's layout rules; none of that is
// carried over. Here the convolution is an implicit GEMM over a
// channels_last input: M = output pixels, N = cout, K = 9 taps x cin.
//
// What bounds it on this card: 2 * 9 * cin * cout operations per output
// pixel against (cin + cout) elements of traffic. At 128 -> 32 that is 461
// FLOP per byte in bf16, so the bf16 form is bound by bytes: the 549.5 MB
// input read once and the 137.4 MB output written once at (8, 32, 518, 518),
// 0.205 ms at 3.35 TB/s. In fp32 the products run on the fp32 units (no
// TF32), so the fp32 form is bound by operations at 67 TFLOP/s (2.36 ms).
//
// The design:
//   - x arrives channels_last, every stride but the channels' a multiple of
//     16 bytes (the wrapper copies a tensor that is not so once, counted);
//     a 4-D TMA map over (C, W, H, B) stages boxes of one channel slice
//     (64 bf16 channels under the 128-byte swizzle, 16 fp32 channels under
//     the 64-byte one) of 66 columns starting at x0 - 1. TMA fills coordinates
//     outside the tensor with zeros below 0 as past the extent, so the
//     boxes carry the pad-1 halo and no thread writes one (chip_smoke.py's
//     border cases and the planted halo fault hold this on the card);
//     channels past cin read as zeros too;
//   - a unit of work is 64 output columns x `rows` output rows of one
//     image; a persistent grid (one block an SM) walks the units, and
//     producer threads keep TMA loads in flight through rings of stages
//     (full and empty mbarriers) across unit boundaries;
//   - bf16: the weights stay resident in shared memory for the block's
//     life (73.7 KB at 128 -> 32), for each dx and slice one K-major tile
//     of the three tap rows' weights stacked along N (3 N rows, N = cout
//     rounded up to 16, 32 or 64), written once by every thread from the
//     wrapper's packed copy. Two consumer warpgroups each walk their own
//     units of 16 rows, fed by their own producer warp and ring: a stage
//     is one input image row (66 pixels, every slice), which meets tap row
//     dy in output row j - dy, so one wgmma m64n(3N)k16 SS per slice, dx
//     and 16-channel step multiplies the row by all three tap rows at once
//     (24 products a row at 128 -> 32) and the accumulator's three column
//     blocks gather output rows j, j - 1, j - 2; after each input row the
//     oldest is stored and the blocks shift by one row. The dx taps are A
//     descriptors one 128-byte pixel row apart, off the swizzle's
//     1024-byte repeat, which the layout probes (csrc/layout_probes.cu)
//     show the descriptor reads right with its base-offset field left at
//     0. Each input row is loaded once per unit (18 rows for 16);
//   - fp32: fp32 wgmma does not exist and TF32 is not this kernel, so 256
//     consumer threads run exact FFMA. 147 KB of fp32 weights at 128 -> 32
//     leave no room to keep them, so a stage is one 16-channel slice of a
//     unit: its box of rows + 2 rows (rows 8, 4 at N = 64; 64 bytes a
//     pixel under the 64-byte swizzle) by TMA and the slice's 9 x 16 x N
//     weights by one bulk copy, three or four stages deep. A thread owns 8
//     pixels (8 apart, so a warp's float4 loads through the swizzle do not
//     conflict) x 8 output channels (4 at N = 16) and reads the weights as
//     warp-uniform float4 broadcasts;
//   - the epilogue adds the bias, applies the ReLU, rounds to x's type and
//     stores by the output's strides (pairs or float4 where the output is
//     channels_last), so channels_last and NCHW outputs are written
//     directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int kTileW = 64;            // output columns a unit: wgmma's M
constexpr int kBoxW = kTileW + 2;     // staged columns, with the halo
constexpr int kRowBytes = kBoxW * 128;  // one staged image row of one slice
constexpr int kSliceBytes = 9216;     // kRowBytes rounded up to the 1024-byte repeat
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block can have
constexpr int kMaxStages = 4;
constexpr int kUnitRowsB = 16;        // bf16: output rows a unit
constexpr int kThreadsB = 128 * 2 + 64;  // two consumer warpgroups, two producer warps
constexpr int kThreadsF = 128 * 2 + 32;  // two consumer warpgroups, one producer warp

// What one launch needs; conv_launch_shape in conv3x3.py works out the same.
struct Geometry {
  int threads;
  int n;             // cout rounded up to 16, 32 or 64
  int slice;         // channels a slice: bf16 64 (128 bytes a pixel), fp32 16 (64)
  int slices;
  int rows;          // output rows a unit
  int stage_bytes;   // bf16: one image row of every slice; fp32: one box and its weights
  int stages;        // bf16: a ring each consumer warpgroup; fp32: one ring
  int weight_bytes;  // bf16: the resident weight tiles; fp32: one slice's, in its stage
  int smem;          // dynamic shared memory; 0 where two stages do not fit
};

Geometry geometry(bool bf16, int cin, int cout) {
  Geometry g{};
  g.n = cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
  g.slice = bf16 ? 64 : 16;
  g.slices = (cin + g.slice - 1) / g.slice;
  int rings;
  if (bf16) {
    g.threads = kThreadsB;
    g.rows = kUnitRowsB;
    g.stage_bytes = g.slices * kSliceBytes;
    g.weight_bytes = 9 * g.slices * g.n * 128;
    rings = 2;
  } else {
    // a 16-channel slice: 64 bytes a pixel; a stage holds its box and its
    // weights (9 x 16 x N fp32)
    g.threads = kThreadsF;
    g.rows = g.n == 64 ? 4 : 8;
    g.weight_bytes = 9 * 16 * g.n * 4;
    g.stage_bytes = ((g.rows + 2) * kBoxW * 64 + 1023) / 1024 * 1024 + g.weight_bytes;
    rings = 1;
  }
  const int room = kSmemLimit - 1024 - 16 * 2 * kMaxStages - (bf16 ? g.weight_bytes : 0);
  g.stages = room > 0 ? room / (rings * g.stage_bytes) : 0;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = g.stages >= 2
               ? 1024 + (bf16 ? g.weight_bytes : 0) + rings * g.stages * (g.stage_bytes + 16)
               : 0;
  return g;
}

struct ConvParams {
  CUtensorMap x_map;  // (C, W, H, B); box bf16 (64, 66, 1, 1), fp32 (16, 66, rows + 2, 1)
  const void* w;      // bf16: (3 dx, 3 dy, n, slices * 64); fp32: (slices, 3 dy, 3 dx, 16, n)
  const float* bias;  // (n) fp32, zero past cout
  void* out;
  long long o_sb, o_sc, o_sh, o_sw;  // element strides of out (B, C, H, W)
  int cout, H, W, rows, tiles_x, tiles_y, units;
  int slices, stages, stage_bytes, weight_bytes;
  int relu;
  int vector_store;      // out channels_last with aligned strides: pairs / float4
  int drop_halo_column;  // test hook: the left halo column read as zeros
};

struct Unit {
  int b, y0, x0;  // image, first output row, first output column
};

__device__ __forceinline__ Unit unit_of(const ConvParams& p, int u) {
  Unit t;
  t.x0 = (u % p.tiles_x) * kTileW;
  const int rest = u / p.tiles_x;
  t.b = rest / p.tiles_y;
  t.y0 = (rest % p.tiles_y) * p.rows;
  return t;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The fault hook: column 0 of `rows` staged rows (the left halo) to zeros,
// by the 128 threads of one consumer warpgroup before they read the stage;
// kPixel bytes a pixel (and swizzle), rows 66 pixels apart in each of
// `slices` tiles kSliceBytes apart
template <int kPixel>
__device__ __forceinline__ void drop_left_halo(uint8_t* stage, int rows, int slices, int tid,
                                               int wg) {
  constexpr int kChunks = kPixel / 16;
  for (int i = tid; i < slices * rows * kChunks; i += 128) {
    const int c = i % kChunks, r = (i / kChunks) % rows, s = i / (kChunks * rows);
    *reinterpret_cast<uint4*>(stage + s * kSliceBytes +
                              sm90::swizzled<kPixel>(r * kBoxW * kPixel + c * 16)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  sm90::fence_proxy_async_shared();
  sm90::bar_sync<128>(1 + wg);
}

// --------------------------------------------------------------------------
// bf16: wgmma on staged image rows, weights resident
// --------------------------------------------------------------------------

// The producer thread of consumer warpgroup wg: for each of its units, the
// unit's rows + 2 input rows (y0 - 1 .. y0 + rows), every slice of a row in
// one stage of its ring, once the warpgroup has released the stage.
__device__ __forceinline__ void produce_rows(const ConvParams& p, int wg, uint8_t* ring,
                                             uint64_t* full, uint64_t* empty) {
  sm90::prefetch_tensor_map(&p.x_map);
  int it = 0;
  for (int u = 2 * blockIdx.x + wg; u < p.units; u += 2 * gridDim.x) {
    const Unit t = unit_of(p, u);
    for (int j = 0; j < p.rows + 2; ++j, ++it) {
      const int st = it % p.stages;
      sm90::mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&full[st], p.slices * kRowBytes);
      for (int s = 0; s < p.slices; ++s)
        sm90::tma_load_4d(ring + st * p.stage_bytes + s * kSliceBytes, &p.x_map, &full[st], s * 64,
                          t.x0 - 1, t.y0 - 1 + j, t.b);
    }
  }
}

// acc (m64n(3N)) += a * b: the three tap rows' weights stacked along N
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&acc)[3 * N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 16) {
    sm90::wgmma_ss_m64n48k16(acc, a, b, 1);
  } else if constexpr (N == 32) {
    sm90::wgmma_ss_m64n96k16(acc, a, b, 1);
  } else {
    sm90::wgmma_ss_m64n192k16(acc, a, b, 1);
  }
}

// bias, ReLU, bf16, stored by the output's strides: output row y of the
// unit from the m64nN accumulator d (d[i]: pixel 16 warp + g + 8 ((i / 2)
// % 2), output channel 8 (i / 4) + 2 q + i % 2)
template <int N>
__device__ __forceinline__ void store_row(const ConvParams& p, const Unit& t, int y,
                                          const float* d, int tid) {
  if (y >= p.H) return;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + t.b * p.o_sb + y * p.o_sh;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int x = t.x0 + 16 * warp + g + 8 * ((i / 2) % 2);
    const int co = 8 * (i / 4) + 2 * q;
    if (x >= p.W || co >= p.cout) continue;
    float v0 = d[i] + p.bias[co], v1 = d[i + 1] + p.bias[co + 1];
    if (p.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    __nv_bfloat16* o = out + x * p.o_sw + co * p.o_sc;
    if (p.vector_store && co + 1 < p.cout) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16(v0);
      if (co + 1 < p.cout) o[p.o_sc] = __float2bfloat16(v1);
    }
  }
}

// One staged input row j of the unit (image row y0 - 1 + j) through the
// products: it meets the weights of tap row dy in output row j - dy, so one
// wgmma per slice, dx and 16-channel step multiplies it by the three tap
// rows' weights stacked along N (a 3N-row tile), and the accumulator's
// column blocks 0, 1, 2 gather output rows j, j - 1 and j - 2. After it
// output row j - 2 (block 2) is complete and stored, and the blocks shift
// by one row: 1 to 2, 0 to 1, 0 zeroed, so every product writes the same
// registers. Rows outside the unit pass through blocks that are never
// stored.
template <int N>
__device__ __forceinline__ void row_step(const ConvParams& p, const Unit& t, int j, int& it,
                                         uint8_t* ring, uint64_t* full, uint64_t* empty,
                                         const uint8_t* wts, float (&acc)[3 * N / 2], int tid,
                                         int wg) {
  const int st = it % p.stages;
  sm90::mbar_wait(&full[st], (it / p.stages) & 1);
  uint8_t* stage = ring + st * p.stage_bytes;
  if (p.drop_halo_column) drop_left_halo<128>(stage, 1, p.slices, tid, wg);
  sm90::wgmma_fence();
#pragma unroll 1
  for (int s = 0; s < p.slices; ++s) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint8_t* a = stage + s * kSliceBytes + dx * 128;
      const uint8_t* b = wts + (dx * p.slices + s) * 3 * N * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rows<N>(acc, sm90::desc_sw<128>(a + kk * 32, 16, 1024),
                      sm90::desc_sw<128>(b + kk * 32, 16, 1024));
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::mbar_arrive(&empty[st]);
  ++it;
  if (j >= 2 && j - 2 < p.rows) store_row<N>(p, t, t.y0 + j - 2, acc + N, tid);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[N + i] = acc[N / 2 + i];
    acc[N / 2 + i] = acc[i];
    acc[i] = 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreadsB, 1)
    conv3x3_bf16_tma(const __grid_constant__ ConvParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // [dx][slice]: a 3N x 128-byte K-major tile, rows dy * N + co, swizzled
  uint8_t* wts = smem;
  uint8_t* rings = smem + p.weight_bytes;  // [warpgroup][stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + 2 * p.stages * p.stage_bytes);
  uint64_t* empty = full + 2 * p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * p.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  // the weights, once: 16-byte chunks of the packed (3 dx, 3 dy, N, slices * 64)
  const uint4* wsrc = static_cast<const uint4*>(p.w);
  for (int i = threadIdx.x; i < 9 * N * p.slices * 8; i += kThreadsB) {
    const int c = i % 8, s = (i / 8) % p.slices, row = (i / (8 * p.slices)) % (3 * N);
    const int dx = i / (8 * p.slices * 3 * N);
    *reinterpret_cast<uint4*>(wts + (dx * p.slices + s) * 3 * N * 128 +
                              sm90::swizzled<128>(row * 128 + c * 16)) = wsrc[i];
  }
  sm90::fence_proxy_async_shared();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  uint8_t* ring = rings + (wg & 1) * p.stages * p.stage_bytes;
  if (wg == 2) {  // the producer warps: warp 8 feeds warpgroup 0, warp 9 warpgroup 1
    const int pw = (threadIdx.x - 256) / 32;
    if (threadIdx.x % 32 == 0)
      produce_rows(p, pw, rings + pw * p.stages * p.stage_bytes, full + pw * p.stages,
                   empty + pw * p.stages);
    return;
  }

  const int tid = threadIdx.x % 128;
  float acc[3 * N / 2];
#pragma unroll
  for (int i = 0; i < 3 * N / 2; ++i) acc[i] = 0.f;
  uint64_t* my_full = full + wg * p.stages;
  uint64_t* my_empty = empty + wg * p.stages;
  int it = 0;
  for (int u = 2 * blockIdx.x + wg; u < p.units; u += 2 * gridDim.x) {
    const Unit t = unit_of(p, u);
    for (int j = 0; j < p.rows + 2; ++j)
      row_step<N>(p, t, j, it, ring, my_full, my_empty, wts, acc, tid, wg);
  }
}

// --------------------------------------------------------------------------
// fp32: exact fused multiply-adds on staged boxes
// --------------------------------------------------------------------------

// The producer thread: for every unit of this block and every 16-channel
// slice, one box of rows + 2 rows and the slice's weights (one bulk copy of
// the packed (9, 16, N)) into the next stage once the consumers have
// released it.
__device__ __forceinline__ void produce_boxes(const ConvParams& p, uint8_t* stages,
                                              uint64_t* full, uint64_t* empty) {
  sm90::prefetch_tensor_map(&p.x_map);
  const int box_bytes = (p.rows + 2) * kBoxW * 64;
  const int w_offset = p.stage_bytes - p.weight_bytes;
  const uint8_t* w = static_cast<const uint8_t*>(p.w);
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_of(p, u);
    for (int s = 0; s < p.slices; ++s, ++it) {
      const int st = it % p.stages;
      uint8_t* stage = stages + st * p.stage_bytes;
      sm90::mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&full[st], box_bytes + p.weight_bytes);
      sm90::tma_load_4d(stage, &p.x_map, &full[st], s * 16, t.x0 - 1, t.y0 - 1, t.b);
      sm90::bulk_load(stage + w_offset, w + s * p.weight_bytes, p.weight_bytes, &full[st]);
    }
  }
}

// kCo output channels a thread (8, 4 at N = 16), kRows output rows a unit
// (8, 4 at N = 64): 256 consumer threads = N / kCo channel groups x kRows
// rows x 8 pixel groups; group pg holds pixels pg, pg + 8, .., pg + 56, so
// a warp's float4 loads of one pixel column land on 8 distinct chunks of
// the swizzle and do not conflict
template <int N>
__global__ void __launch_bounds__(kThreadsF, 1)
    conv3x3_fp32_tma(const __grid_constant__ ConvParams p) {
  constexpr int kCo = N == 16 ? 4 : 8;
  constexpr int kRows = N == 64 ? 4 : 8;
  static_assert(8 * kRows * (N / kCo) == 256, "one output tile a consumer thread");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) produce_boxes(p, stages, full, empty);
    return;
  }

  // a warp shares its channel group, so its weight loads are uniform
  const int tid = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int co0 = (threadIdx.x / (8 * kRows)) * kCo;
  const int row = (threadIdx.x % (8 * kRows)) / 8, pg = threadIdx.x % 8;
  const int w_offset = p.stage_bytes - p.weight_bytes;
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_of(p, u);
    float acc[8][kCo];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < kCo; ++c) acc[j][c] = 0.f;

    for (int s = 0; s < p.slices; ++s, ++it) {
      const int st = it % p.stages;
      sm90::mbar_wait(&full[st], (it / p.stages) & 1);
      uint8_t* box = stages + st * p.stage_bytes;
      const float* ws = reinterpret_cast<const float*>(box + w_offset) + co0;
      if (p.drop_halo_column) drop_left_halo<64>(box, kRows + 2, 1, tid, wg);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint32_t base = ((row + dy) * kBoxW + pg + dx) * 64;
#pragma unroll 1
        for (int c = 0; c < 4; ++c) {  // 4-channel chunks of the slice
          float4 xv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xv[j] = *reinterpret_cast<const float4*>(
                box + sm90::swizzled<64>(base + j * 8 * 64 + c * 16));
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            // weights of (tap, channel): kCo output channels, the same for
            // the whole warp (a broadcast)
            const float4* wr = reinterpret_cast<const float4*>(ws + (tap * 16 + c * 4 + ci) * N);
#pragma unroll
            for (int c4 = 0; c4 < kCo / 4; ++c4) {
              const float4 wv = wr[c4];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float xs = ci == 0 ? xv[j].x : ci == 1 ? xv[j].y : ci == 2 ? xv[j].z : xv[j].w;
                acc[j][c4 * 4 + 0] = fmaf(xs, wv.x, acc[j][c4 * 4 + 0]);
                acc[j][c4 * 4 + 1] = fmaf(xs, wv.y, acc[j][c4 * 4 + 1]);
                acc[j][c4 * 4 + 2] = fmaf(xs, wv.z, acc[j][c4 * 4 + 2]);
                acc[j][c4 * 4 + 3] = fmaf(xs, wv.w, acc[j][c4 * 4 + 3]);
              }
            }
          }
        }
      }
      sm90::mbar_arrive(&empty[st]);
    }

    const int y = t.y0 + row;
    if (y >= p.H) continue;
    float* out = static_cast<float*>(p.out) + t.b * p.o_sb + y * p.o_sh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = t.x0 + pg + 8 * j;
      if (x >= p.W) continue;
#pragma unroll
      for (int c4 = 0; c4 < kCo / 4; ++c4) {
        const int co = co0 + c4 * 4;
        if (co >= p.cout) continue;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = acc[j][c4 * 4 + k] + p.bias[co + k];
          if (p.relu) v[k] = fmaxf(v[k], 0.f);
        }
        float* o = out + x * p.o_sw + co * p.o_sc;
        if (p.vector_store && co + 3 < p.cout) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (co + k < p.cout) o[k * p.o_sc] = v[k];
        }
      }
    }
  }
}

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n > 0 ? n : 1;
  }();
  return count;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const cudaError_t& attr, int threads, int grid,
                   const ConvParams& p, int smem, cudaStream_t stream) {
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the shared-memory attribute is set once per kernel and process
template <int N>
cudaError_t launch_bf16(const ConvParams& p, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bf16_tma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  const int pairs = (p.units + 1) / 2;  // a unit each consumer warpgroup
  return launch(conv3x3_bf16_tma<N>, attr, kThreadsB, pairs < sm_count() ? pairs : sm_count(),
                p, smem, stream);
}

template <int N>
cudaError_t launch_fp32(const ConvParams& p, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_fp32_tma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return launch(conv3x3_fp32_tma<N>, attr, kThreadsF,
                p.units < sm_count() ? p.units : sm_count(), p, smem, stream);
}

}  // namespace

// (threads a block, dynamic shared-memory bytes, output rows a unit,
// stages) of the launch for x's type (is_bf16), cin and cout, into out[4];
// shared memory 0 where the kernel cannot hold the weights and two stages.
extern "C" void omnivggt_conv3x3_launch_shape(int is_bf16, int cin, int cout, int* out) {
  const Geometry g = geometry(is_bf16 != 0, cin, cout);
  out[0] = g.threads;
  out[1] = g.smem;
  out[2] = g.rows;
  out[3] = g.stages;
}

// is_bf16: 1 for bf16 x and out, 0 for fp32. x: (B, cin, H, W) by element
// strides x_strides (batch, channel, row, column) with the channel stride
// 1, the others multiples of 16 bytes and x 16-byte aligned. w: the
// wrapper's packed weights (see ConvParams), bias: (n) fp32. out: (B,
// cout, H, W) by o_strides. drop_halo_column: 0 on every real call (a test
// hook that plants a fault). Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int omnivggt_conv3x3(int is_bf16, const void* x, const long long* x_strides,
                                const void* w, const void* bias, void* out,
                                const long long* o_strides, int B, int cin, int cout, int H,
                                int W, int relu, int drop_halo_column, void* stream) {
  const bool bf16 = is_bf16 != 0;
  const Geometry g = geometry(bf16, cin, cout);
  if (cout < 1 || cout > 64 || g.smem == 0 || x_strides[1] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = bf16 ? 2 : 4;
  ConvParams p;
  const long long dims[4] = {cin, W, H, B};
  const long long strides[3] = {x_strides[3] * es, x_strides[2] * es, x_strides[0] * es};
  const int box[4] = {g.slice, kBoxW, bf16 ? 1 : g.rows + 2, 1};
  if (!sm90::encode_tiled_4d(&p.x_map,
                             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             x, dims, strides, box,
                             bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.o_sb = o_strides[0]; p.o_sc = o_strides[1]; p.o_sh = o_strides[2]; p.o_sw = o_strides[3];
  p.cout = cout; p.H = H; p.W = W; p.rows = g.rows;
  p.tiles_x = (W + kTileW - 1) / kTileW;
  p.tiles_y = (H + g.rows - 1) / g.rows;
  const long long units = static_cast<long long>(p.tiles_x) * p.tiles_y * B;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  p.slices = g.slices; p.stages = g.stages; p.stage_bytes = g.stage_bytes;
  p.weight_bytes = g.weight_bytes;
  p.relu = relu;
  const int lanes = bf16 ? 2 : 4;  // channels a vector store
  const uintptr_t align = static_cast<uintptr_t>(lanes * es);
  p.vector_store = o_strides[1] == 1 && o_strides[0] % lanes == 0 && o_strides[2] % lanes == 0 &&
                   o_strides[3] % lanes == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  p.drop_halo_column = drop_halo_column;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = g.n == 16   ? launch_bf16<16>(p, g.smem, s)
          : g.n == 32 ? launch_bf16<32>(p, g.smem, s)
                      : launch_bf16<64>(p, g.smem, s);
  } else {
    err = g.n == 16   ? launch_fp32<16>(p, g.smem, s)
          : g.n == 32 ? launch_fp32<32>(p, g.smem, s)
                      : launch_fp32<64>(p, g.smem, s);
  }
  return static_cast<int>(err);
}
