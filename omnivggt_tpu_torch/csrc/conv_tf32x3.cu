// fp32 stride-1 convolution (3x3 pad 1, or 1x1) + bias + optional ReLU for
// Hopper (sm_90a), on the tensor cores at fp32 accuracy: three TF32
// products a multiply (3xTF32). Plain C interface, loaded with ctypes from
// omnivggt_tpu_torch/ops/kernels/conv_tf32x3.py.
//
// Replaces no TPU kernel: the JAX package leaves the DPT heads' fp32
// convolutions to XLA. It takes them from cuDNN's fp32 FFMA convolutions on
// the inference path (models/dpt_head.py): per head and chunk of frames the
// 4 projections, the 4 layerN_rn, the 14 residual-unit convolutions, the 4
// fusion out_convs, output_conv1 and output_conv2[0].
//
// What bounds it on this card: 2 * taps * cin * cout operations a pixel,
// at the heads' widths far above the bytes (256 -> 256 3x3: 1,152
// operations a byte). fp32 FFMA peaks at 67 TFLOP/s; TF32 wgmma at 495, and
// three of them a multiply at 165 TFLOP/s of fp32-accurate work, so that is
// the bound this kernel is held to.
//
// Precision (3xTF32, CUTLASS's "fast accurate" fp32 product): each operand
// is split into a high and a low TF32 part and the product taken as
// hi*hi + hi*lo + lo*hi (lo*lo, ~2^-21 of it, is left out):
//   - weights: split once per call by `split_weights` below into
//     hi = rna(w) and lo = rna(w - hi), both exact TF32 values (|w - hi -
//     lo| <= 2^-22 |w|, unbiased);
//   - activations: the staged fp32 tile is read into registers; hi = the
//     value with its low 13 bits cleared (what the tensor core would read
//     of it), lo = rna(x - hi) (|x - hi - lo| <= 2^-21 |x|, and lo's sign
//     is the value's, so the rounding of lo, not the truncation, sets the
//     error);
//   - accumulation: the tensor core adds into its accumulator with a
//     rounding biased toward zero, so an accumulator carried over the whole
//     K loop drifts: 16 to 45 times cuDNN fp32's median relative error on
//     this card, growing with the 8-deep steps it carries (PERF.md). So
//     each stage (32 channels of one tap: 12 products) accumulates into a
//     fresh accumulator, and that is added to an fp32 sum in registers by
//     round-to-nearest additions (the split of Ootomo and Yokota, 2022, at
//     the granularity of a stage): 0.3 to 1.4 times cuDNN's. Two stages a
//     block already read 2.4 times at 256 -> 256 1x1.
// One-pass TF32 (hi*hi alone) keeps 11 bits of each operand: ~10^3 times
// the error; the card tests hold the kernel to the repo's fp32 convolution
// tolerance and to twice cuDNN fp32's median relative error, which that
// and a dropped correction product fail (PERF.md gives the readings).
//
// The design (implicit GEMM: M = output pixels of every image, N = cout, K
// = taps x cin in 32-channel slices):
//   - x channels-last, every stride but the channels' a multiple of 16
//     bytes (the wrapper copies one that is not, counted); a 4-D im2col TMA
//     map over (C, W, H, B) brings, for one tap (dy, dx) and one slice, the
//     128 output pixels p0 .. p0 + 127 of a tile as 128 rows of 32 channels
//     (128 bytes, 128-byte swizzle), each read at (x - pad + dx, y - pad +
//     dy): the map's bounding box walks rows and images in order and reads
//     the pad halo as zeros, so a tile is any 128 consecutive pixels and
//     nothing is wasted at a row's end;
//   - the weights, split and packed (2, cout, taps, cin rounded up to 32),
//     come by a tiled TMA map as two K-major N x 32 tiles (hi, lo) a stage;
//     within a slice the K order is permuted so that a thread's A values of
//     the four 8-deep steps are one float4 (see consume below);
//   - a block: 128 x N tiles (N = 128, or cout rounded up to 16, 32 or 64
//     when narrower), two consumer warpgroups of 64 rows and one producer
//     warpgroup, one thread of which issues the loads into a ring of stages
//     (full and empty mbarriers); a persistent grid (one block an SM) walks
//     the tiles, N tiles of one M tile next to each other;
//   - a consumer warpgroup per stage: for each of the four 8-deep steps
//     three wgmma m64nNk8 tf32 with A from registers (hi*Bhi, hi*Blo,
//     lo*Bhi) into the stage's accumulator; while they run, the next
//     stage's fragments are fetched into a second set of registers (4 float4
//     loads a thread: rows g and g + 8 of its warp, two 4-channel groups;
//     hi and lo formed in registers); then the accumulator is added to the
//     fp32 sum. Both sets are fenced so that ptxas adds no fence of its own
//     between the products (each would drain the tensor pipe);
//   - the epilogue adds the bias, applies the ReLU and stores by the
//     output's strides (pairs where the output is channels-last).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;           // output pixels a tile: two consumer warpgroups of 64
constexpr int kABytes = kBM * 128;  // one slice of a tile's pixels: 32 fp32 channels a row
constexpr int kThreads = 384;       // two consumer warpgroups, one producer warpgroup
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have
constexpr int kMaxStages = 8;

// Test hooks that plant faults (the card tests' and chip_smoke.py's). A
// form of the kernel carries one as a template argument; the forms every
// real call runs are FAULT = kSound and compile none of them in.
enum Fault {
  kSound = 0,
  kLoDropped = 2,    // the activations' low parts dropped (the lo*hi product)
  kHaloColumn = 3,   // the left halo column of 64-column strips read as zeros
  kBiasDropped = 4,  // the bias left out
  kReluDropped = 5,  // the ReLU left out
};

// What one launch needs; launch_shape in conv_tf32x3.py works out the same.
struct Geometry {
  int n;            // the N tile: 128, or cout rounded up to 16, 32 or 64
  int b_bytes;      // one K-major N x 32 weight tile
  int stage_bytes;  // the A tile and the hi and lo weight tiles
  int stages;
  int smem;
};

Geometry geometry(int cout) {
  Geometry g;
  g.n = 16;
  while (g.n < cout && g.n < 128) g.n *= 2;
  g.b_bytes = g.n * 128;
  g.stage_bytes = kABytes + 2 * g.b_bytes;
  g.stages = (kSmemLimit - 1024 - 16 * kMaxStages) / g.stage_bytes;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = 1024 + g.stages * (g.stage_bytes + 16);
  return g;
}

struct Params {
  CUtensorMap x_map;  // im2col over (C, W, H, B): 128 pixels x 32 channels a load
  CUtensorMap w_map;  // tiled over (K, cout, 2, 1): (32, N, 1, 1) boxes
  const float* bias;  // (cout) or null
  float* out;
  long long o_sb, o_sc, o_sh, o_sw;  // element strides of out (B, C, H, W)
  long long pixels;                  // B * H * W
  int H, W, cout, kw, pad, taps, slices;
  int n_tiles, tiles, stages, stage_bytes, b_bytes;
  int relu;
  int vector_store;  // out channels-last with even strides: float2 pairs
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The producer thread: for each tile of this block, each tap and each
// slice, the tile's 128 pixels at that tap (im2col) and the slice's hi and
// lo weight tiles into the next stage, once both consumer warpgroups have
// released it.
__device__ __forceinline__ void produce(const Params& p, int n_tile, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  sm90::prefetch_tensor_map(&p.x_map);
  sm90::prefetch_tensor_map(&p.w_map);
  const long long hw = static_cast<long long>(p.H) * p.W;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long p0 = static_cast<long long>(t / p.n_tiles) * kBM;
    const int n0 = (t % p.n_tiles) * n_tile;
    const int b = static_cast<int>(p0 / hw);
    const int rem = static_cast<int>(p0 - b * hw);
    const int y = rem / p.W, x = rem % p.W;
    for (int tap = 0; tap < p.taps; ++tap) {
      const uint16_t dy = static_cast<uint16_t>(tap / p.kw), dx = static_cast<uint16_t>(tap % p.kw);
      for (int s = 0; s < p.slices; ++s, ++it) {
        const int st = it % p.stages;
        uint8_t* stage = smem + st * p.stage_bytes;
        sm90::mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kABytes + 2 * p.b_bytes);
        sm90::tma_load_im2col_4d(stage, &p.x_map, &full[st], s * 32, x - p.pad, y - p.pad, b, dx,
                                 dy);
        const int k = (tap * p.slices + s) * 32;
        sm90::tma_load_4d(stage + kABytes, &p.w_map, &full[st], k, n0, 0, 0);
        sm90::tma_load_4d(stage + kABytes + p.b_bytes, &p.w_map, &full[st], k, n0, 1, 0);
      }
    }
  }
}

// acc (m64nN) += a * b, or = a * b when accumulate is 0
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  if constexpr (N == 16) {
    sm90::wgmma_rs_m64n16k8_tf32(acc, a, b, accumulate);
  } else if constexpr (N == 32) {
    sm90::wgmma_rs_m64n32k8_tf32(acc, a, b, accumulate);
  } else if constexpr (N == 64) {
    sm90::wgmma_rs_m64n64k8_tf32(acc, a, b, accumulate);
  } else {
    sm90::wgmma_rs_m64n128k8_tf32(acc, a, b, accumulate);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// A thread's A fragments of one stage, for the four 8-deep steps: the
// activations' high and low TF32 parts
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};

// What a consumer thread needs of its place
struct Lane {
  int r0, g, q;  // rows r0 and r0 + 8 of the tile; g = r0 % 8, q = lane % 4
  int col[2];    // the output columns of the two rows (kHaloColumn's only)
};

// Waits for stage `it`'s tiles and reads this thread's A values into
// registers: thread (warp w, g, q) holds rows r0 = 64 wg + 16 w + g and
// r0 + 8; its A values of step kk are, for fragment column q + 4 h (h = 0,
// 1), channel 8 q + 4 h + kk of the slice (the packed weights put the same
// channel at K position 8 kk + q + 4 h), so each (row, h) is one float4 of
// the staged row; hi = the value with its low 13 bits cleared, lo =
// rna(value - hi). ks: the stage's place in the tile's K loop.
template <int FAULT>
__device__ __forceinline__ void fetch(const Params& p, const Lane& l, uint8_t* smem,
                                      uint64_t* full, int it, int ks, Frags& f) {
  const int st = it % p.stages;
  sm90::mbar_wait(&full[st], (it / p.stages) & 1);
  const uint8_t* a_tile = smem + st * p.stage_bytes;
  // v[2 h + i]: row r0 + 8 i, channels 8 q + 4 h .. + 3 (128-byte swizzle:
  // 16-byte chunk 2 q + h of row r stored at chunk (2 q + h) ^ (r % 8))
  float4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int h = j / 2, r = l.r0 + 8 * (j % 2);
    v[j] = *reinterpret_cast<const float4*>(a_tile + r * 128 + (((2 * l.q + h) ^ l.g) << 4));
  }
  if constexpr (FAULT == kHaloColumn) {
    if (p.kw == 3 && (ks / p.slices) % 3 == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l.col[j % 2] % 64 == 0 && l.col[j % 2] > 0) v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // fragment register j: a[0] (r0, q), a[1] (r0 + 8, q), a[2] (r0, q + 4), a[3] (r0 + 8, q + 4)
      const float xv = lane_of(v[j], kk);
      f.hi[kk][j] = __float_as_uint(xv) & 0xffffe000u;
      f.lo[kk][j] = FAULT == kLoDropped
                        ? 0u
                        : sm90::to_tf32_rna(xv - __uint_as_float(f.hi[kk][j]));
    }
    // the fragments complete before the products' fence, so the compiler
    // adds no fence of its own between the products
    sm90::fence_regs(f.hi[kk]);
    sm90::fence_regs(f.lo[kk]);
  }
}

// Stage `it` (fragments f, fetched) through the products, three a step
// (hi*Bhi, hi*Blo, lo*Bhi) into a fresh accumulator; while they run, the
// next stage's fragments are fetched into `next` (when there is one); then
// the stage is released and the accumulator added to the fp32 sum.
template <int N, int FAULT>
__device__ __forceinline__ void multiply(const Params& p, const Lane& l, uint8_t* smem,
                                         uint64_t* full, uint64_t* empty, int it, int ks,
                                         int k_steps, Frags& f, Frags& next,
                                         float (&acc)[N / 2], float (&sum)[N / 2]) {
  const int st = it % p.stages;
  const uint8_t* b_hi = smem + st * p.stage_bytes + kABytes;
  const uint8_t* b_lo = b_hi + p.b_bytes;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d_hi = sm90::desc_sw<128>(b_hi + kk * 32, 16, 1024);
    const uint64_t d_lo = sm90::desc_sw<128>(b_lo + kk * 32, 16, 1024);
    wgmma_tf32<N>(acc, f.hi[kk], d_hi, kk > 0);
    wgmma_tf32<N>(acc, f.hi[kk], d_lo, 1);
    wgmma_tf32<N>(acc, f.lo[kk], d_hi, 1);
  }
  sm90::wgmma_commit();
  if (ks + 1 < k_steps) fetch<FAULT>(p, l, smem, full, it + 1, ks + 1, next);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // the products read f until here: keep its registers from other values
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::fence_regs(f.hi[kk]);
    sm90::fence_regs(f.lo[kk]);
  }
  sm90::mbar_arrive(&empty[st]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = ks == 0 ? acc[i] : sum[i] + acc[i];
}

// Consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile, the K loop
// two stages a turn so the fragments alternate between two sets of
// registers (one in the products, one being fetched).
template <int N, int FAULT>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int wg) {
  const int tid = threadIdx.x % 128;
  Lane l;
  l.g = (tid % 32) / 4;
  l.q = tid % 4;
  l.r0 = 64 * wg + 16 * (tid / 32) + l.g;
  const long long hw = static_cast<long long>(p.H) * p.W;
  const int k_steps = p.taps * p.slices;
  float acc[N / 2], sum[N / 2];
  Frags f0, f1;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long p0 = static_cast<long long>(t / p.n_tiles) * kBM;
    const int n0 = (t % p.n_tiles) * N;
    const int r0 = l.r0, q = l.q;
    if constexpr (FAULT == kHaloColumn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) l.col[h] = static_cast<int>((p0 + r0 + 8 * h) % hw % p.W);
    }
    fetch<FAULT>(p, l, smem, full, it, 0, f0);
    for (int ks = 0; ks < k_steps; ks += 2) {
      multiply<N, FAULT>(p, l, smem, full, empty, it, ks, k_steps, f0, f1, acc, sum);
      ++it;
      if (ks + 1 < k_steps) {
        multiply<N, FAULT>(p, l, smem, full, empty, it, ks + 1, k_steps, f1, f0, acc, sum);
        ++it;
      }
    }

    // epilogue: d[i] holds row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q + i % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long pix = p0 + r0 + 8 * h;
      if (pix >= p.pixels) continue;
      const long long b = pix / hw, rem = pix - b * hw;
      float* o = p.out + b * p.o_sb + (rem / p.W) * p.o_sh + (rem % p.W) * p.o_sw;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int co = n0 + 8 * j + 2 * q;
        if (co >= p.cout) continue;
        float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
        if (p.bias != nullptr && FAULT != kBiasDropped) {
          v0 += p.bias[co];
          if (co + 1 < p.cout) v1 += p.bias[co + 1];
        }
        if (p.relu && FAULT != kReluDropped) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (p.vector_store && co + 1 < p.cout) {
          *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
        } else {
          o[co * p.o_sc] = v0;
          if (co + 1 < p.cout) o[(co + 1) * p.o_sc] = v1;
        }
      }
    }
  }
}

template <int N, int FAULT>
__global__ void __launch_bounds__(kThreads, 1) conv_tf32x3(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) produce(p, N, smem, full, empty);
    return;
  }
  sm90::setmaxnreg_inc<232>();
  consume<N, FAULT>(p, smem, full, empty, wg);
}

// The weights split and packed for the kernel: w (cout, cin, taps)
// contiguous (an nn.Conv2d weight) into out (2, cout, taps, cin32): [0] =
// rna(w), [1] = rna(w - [0]), zero past cin, each 32-channel slice in the
// kernel's K order (K position 8 kk + j of a slice holds channel 8 (j % 4)
// + 4 (j / 4) + kk).
__global__ void split_weights(const float* w, float* out, int cout, int cin, int taps,
                              int cin32) {
  const long long n = static_cast<long long>(cout) * taps * cin32;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int pos = static_cast<int>(i % cin32);
    const long long rest = i / cin32;
    const int tap = static_cast<int>(rest % taps), co = static_cast<int>(rest / taps);
    const int j = pos % 32, kk = j / 8, jj = j % 8;
    const int c = pos - j + 8 * (jj % 4) + 4 * (jj / 4) + kk;
    const float v = c < cin ? w[(static_cast<long long>(co) * cin + c) * taps + tap] : 0.f;
    const float hi = __uint_as_float(sm90::to_tf32_rna(v));
    out[i] = hi;
    out[n + i] = __uint_as_float(sm90::to_tf32_rna(v - hi));
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

// the shared-memory attribute is set once per kernel and process
template <int N, int FAULT>
cudaError_t launch(const Params& p, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_tf32x3<N, FAULT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  conv_tf32x3<N, FAULT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// a form with a planted fault, at the N tiles the checks use (32 and 128)
template <int N>
cudaError_t launch_faulted(const Params& p, int fault, int smem, cudaStream_t stream) {
  switch (fault) {
    case kLoDropped: return launch<N, kLoDropped>(p, smem, stream);
    case kHaloColumn: return launch<N, kHaloColumn>(p, smem, stream);
    case kBiasDropped: return launch<N, kBiasDropped>(p, smem, stream);
    case kReluDropped: return launch<N, kReluDropped>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (threads a block, dynamic shared-memory bytes, N tile, stages) of the
// launch for cout, into out[4].
extern "C" void omnivggt_conv_tf32x3_launch_shape(int cout, int* out) {
  const Geometry g = geometry(cout);
  out[0] = kThreads;
  out[1] = g.smem;
  out[2] = g.n;
  out[3] = g.stages;
}

// w: (cout, cin, k, k) fp32 contiguous; out: (2, cout, k * k, cin rounded
// up to 32) fp32. Returns the cudaError_t of the launch.
extern "C" int omnivggt_conv_tf32x3_split(const float* w, float* out, int cout, int cin, int taps,
                                          void* stream) {
  const int cin32 = (cin + 31) / 32 * 32;
  const long long n = static_cast<long long>(cout) * taps * cin32;
  const long long blocks = (n + 255) / 256;
  split_weights<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(w, out, cout, cin, taps, cin32);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, cin, H, W) fp32 by element strides x_strides (batch, channel, row,
// column), the channel stride 1, the others multiples of 4 and x 16-byte
// aligned. w_split: omnivggt_conv_tf32x3_split's output for this weight.
// bias: (cout) fp32 or null. out: (B, cout, H, W) fp32 by o_strides. k: 3
// (pad 1) or 1 (pad 0). fault: 0 on every real call; test hooks that plant
// faults, launched only where the N tile is 32 or 128: 1 one-pass TF32
// (hi*hi alone: the activations' low parts dropped here, the weights' by
// the caller, who passes them as zeros), 2 the lo*hi product left out (the
// activations' low parts dropped), 3 the left halo column of 64-column
// strips read as zeros, 4 the bias left out, 5 the ReLU left out. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int omnivggt_conv_tf32x3(const float* x, const long long* x_strides, const float* w_split,
                                    const float* bias, float* out, const long long* o_strides,
                                    int B, int cin, int cout, int H, int W, int k, int relu,
                                    int fault, void* stream) {
  if ((k != 1 && k != 3) || cout < 1 || cin < 1 || x_strides[1] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(cout);
  const int pad = k / 2, cin32 = (cin + 31) / 32 * 32;
  Params p;
  const long long x_dims[4] = {cin, W, H, B};
  const long long x_strides_b[3] = {x_strides[3] * 4, x_strides[2] * 4, x_strides[0] * 4};
  if (!sm90::encode_im2col_4d(&p.x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, x_dims, x_strides_b,
                              -pad, pad - (k - 1), 32, kBM, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long kdim = static_cast<long long>(k) * k * cin32;
  const long long w_dims[4] = {kdim, cout, 2, 1};
  const long long w_strides[3] = {kdim * 4, kdim * cout * 4, kdim * cout * 8};
  const int w_box[4] = {32, g.n, 1, 1};
  if (!sm90::encode_tiled_4d(&p.w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w_split, w_dims, w_strides,
                             w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.bias = bias;
  p.out = out;
  p.o_sb = o_strides[0]; p.o_sc = o_strides[1]; p.o_sh = o_strides[2]; p.o_sw = o_strides[3];
  p.pixels = static_cast<long long>(B) * H * W;
  p.H = H; p.W = W; p.cout = cout; p.kw = k; p.pad = pad; p.taps = k * k; p.slices = cin32 / 32;
  p.n_tiles = (cout + g.n - 1) / g.n;
  const long long tiles = (p.pixels + kBM - 1) / kBM * p.n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.stages = g.stages; p.stage_bytes = g.stage_bytes; p.b_bytes = g.b_bytes;
  p.relu = relu;
  p.vector_store = o_strides[1] == 1 && o_strides[0] % 2 == 0 && o_strides[2] % 2 == 0 &&
                   o_strides[3] % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fault != kSound) {
    const int form = fault == 1 ? kLoDropped : fault;
    const cudaError_t err = g.n == 32    ? launch_faulted<32>(p, form, g.smem, s)
                            : g.n == 128 ? launch_faulted<128>(p, form, g.smem, s)
                                         : cudaErrorInvalidValue;
    return static_cast<int>(err);
  }
  const cudaError_t err = g.n == 16   ? launch<16, kSound>(p, g.smem, s)
                          : g.n == 32 ? launch<32, kSound>(p, g.smem, s)
                          : g.n == 64 ? launch<64, kSound>(p, g.smem, s)
                                      : launch<128, kSound>(p, g.smem, s);
  return static_cast<int>(err);
}
