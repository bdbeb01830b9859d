// 3x3 stride-1 pad-1 convolution + bias + optional ReLU for Hopper (sm_90a),
// cout <= 64, fp32 accumulation, output in the input's type. Plain C
// interface, loaded with ctypes from omnivggt_tpu_torch/ops/kernels/conv3x3.py.
//
// Replaces the TPU kernel _conv_kernel of omnivggt_tpu/ops/pallas/conv3x3.py
// (reached through conv3x3_folded): on the flagship the DPT heads'
// output_conv2.conv1, 128 -> 32 channels at 518 x 518, 8 frames a chunk.
// The TPU kernel folds output columns into the 128 lanes, expands the x taps
// outside the kernel and pads to Mosaic's layout rules; none of that is
// carried over. Here the convolution is an implicit GEMM: a block owns a
// tile of output pixels, stages the input tile with its one-pixel halo in
// both directions in shared memory, one slice of input channels at a time,
// and accumulates the nine taps in registers.
//
// What bounds it on this card: 2 * 9 * cin * cout operations per output
// pixel against (cin + cout) elements of traffic. At 128 -> 32 that is
// 461 FLOP per byte in bf16 (tensor cores: bound by the 549 MB input and
// 69 MB output) and 230 in fp32, where the products run on the fp32 units
// (no TF32), so the fp32 form is bound by operations at the fp32 rate.
//
// What the design does about it (simple first):
//   - x and out are addressed by (batch, channel, row, column) strides, so
//     the heads' own NCHW tensors and channels_last views are both read in
//     place; no relayout pass exists outside the kernel;
//   - bf16: 4 warps own a 16 x 16 pixel tile; a row of 16 pixels is the M
//     side of mma.sync.m16n8k16, 16 input channels the K side, 8 output
//     channels the N side; the tile sits in shared memory pixel-major with
//     channels innermost (padded by 8), so a tap is an address offset and
//     every fragment load is one conflict-free 32-bit load;
//   - fp32: a thread owns 4 neighbouring pixels x 16 output channels
//     (64 accumulators) and reads each input value once per tap row and
//     each weight as part of a broadcast 128-bit load: 192 fused
//     multiply-adds per 18 shared loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ConvParams {
  const void* x;
  const void* w;      // (cout, cin, 3, 3) contiguous, in x's type
  const float* bias;  // (cout) fp32
  void* out;
  int B, cin, cout, H, W;
  long long x_sb, x_sc, x_sh, x_sw;  // element strides
  long long o_sb, o_sc, o_sh, o_sw;
  int relu;
  int drop_halo_column;  // test hook: leave the left halo column at zero
};

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

constexpr int kTile = 16;            // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;     // staged tile with its halo
constexpr int kSliceB = 32;          // input channels per slice
constexpr int kRowB = kSliceB + 8;   // shared row length (bf16), padded
constexpr int kThreadsB = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NB: output channels / 8, rounded up
template <int NB>
__global__ void __launch_bounds__(kThreadsB) conv3x3_bf16(ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kHalo*kHalo][kRowB]
  __nv_bfloat16* ws = xs + kHalo * kHalo * kRowB;              // [9][NB*8][kRowB]
  constexpr int CO = NB * 8;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x) + n * p.x_sb;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const bool channels_last = p.x_sc == 1;

  float acc[4][NB][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      acc[m][nb][0] = acc[m][nb][1] = acc[m][nb][2] = acc[m][nb][3] = 0.f;

  for (int c0 = 0; c0 < p.cin; c0 += kSliceB) {
    // input tile with halo; the thread index runs along the axis that is
    // contiguous in device memory
    for (int i = threadIdx.x; i < kHalo * kHalo * kSliceB; i += kThreadsB) {
      int ci, pix;
      if (channels_last) {
        ci = i % kSliceB;
        pix = i / kSliceB;
      } else {
        const int ch = i / (kHalo * kHalo), rem = i % (kHalo * kHalo);
        // col fastest, then row, then channel
        ci = ch;
        pix = rem;
      }
      const int row = pix / kHalo, col = pix % kHalo;
      const int gy = y0 - 1 + row, gx = x0 - 1 + col, gc = c0 + ci;
      __nv_bfloat16 val = zero;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && gc < p.cin &&
          !(p.drop_halo_column && col == 0))
        val = x[gc * p.x_sc + gy * p.x_sh + gx * p.x_sw];
      xs[pix * kRowB + ci] = val;
    }
    // weights of this slice: ws[tap][co][ci]
    for (int i = threadIdx.x; i < 9 * CO * kSliceB; i += kThreadsB) {
      const int ci = i % kSliceB, co = (i / kSliceB) % CO, tap = i / (kSliceB * CO);
      const int gc = c0 + ci;
      __nv_bfloat16 val = zero;
      if (co < p.cout && gc < p.cin) val = w[((long long)co * p.cin + gc) * 9 + tap];
      ws[(tap * CO + co) * kRowB + ci] = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kSliceB / 16; ++kk) {
        uint32_t bf[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const __nv_bfloat16* r = ws + (tap * CO + nb * 8 + g) * kRowB + kk * 16 + t * 2;
          bf[nb][0] = ld32(r);
          bf[nb][1] = ld32(r + 8);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int rr = warp * 4 + m;
          const __nv_bfloat16* lo =
              xs + ((rr + dy) * kHalo + g + dx) * kRowB + kk * 16 + t * 2;
          const __nv_bfloat16* hi = lo + 8 * kRowB;
          const uint32_t a[4] = {ld32(lo), ld32(hi), ld32(lo + 8), ld32(hi + 8)};
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma16816(acc[m][nb], a, bf[nb][0], bf[nb][1]);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + n * p.o_sb;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int gy = y0 + warp * 4 + m;
    if (gy >= p.H) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gx = x0 + g + 8 * (e >> 1);
        const int co = nb * 8 + t * 2 + (e & 1);
        if (gx < p.W && co < p.cout) {
          float v = acc[m][nb][e] + p.bias[co];
          if (p.relu) v = fmaxf(v, 0.f);
          out[co * p.o_sc + gy * p.o_sh + gx * p.o_sw] = __float2bfloat16(v);
        }
      }
    }
  }
}

// --------------------------------------------------------------------------
// fp32: full-precision fused multiply-adds
// --------------------------------------------------------------------------

constexpr int kRowsF = 8, kColsF = 32;  // output tile
constexpr int kSliceF = 8;              // input channels per slice
constexpr int kXW = 40;                 // staged row length: 34 columns, padded
constexpr int kQuads = kRowsF * kColsF / 4;  // 64 pixel quads per tile

// CG: output channels / 16, rounded up; the block has 64 * CG threads
template <int CG>
__global__ void __launch_bounds__(kQuads * CG) conv3x3_fp32(ConvParams p) {
  constexpr int CO = CG * 16;
  __shared__ __align__(16) float xs[kSliceF][kRowsF + 2][kXW];
  __shared__ __align__(16) float ws[kSliceF][9][CO];

  const int cg = threadIdx.x / kQuads, quad = threadIdx.x % kQuads;
  const int r = quad / (kColsF / 4), cq = quad % (kColsF / 4);
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kRowsF, x0 = blockIdx.x * kColsF;
  const float* x = static_cast<const float*>(p.x) + n * p.x_sb;
  const float* w = static_cast<const float*>(p.w);
  const bool channels_last = p.x_sc == 1;
  constexpr int kStaged = (kRowsF + 2) * (kColsF + 2);

  float acc[4][16];
#pragma unroll
  for (int px = 0; px < 4; ++px)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[px][c] = 0.f;

  for (int c0 = 0; c0 < p.cin; c0 += kSliceF) {
    for (int i = threadIdx.x; i < kSliceF * kStaged; i += kQuads * CG) {
      int ci, pix;
      if (channels_last) {
        ci = i % kSliceF;
        pix = i / kSliceF;
      } else {
        ci = i / kStaged;
        pix = i % kStaged;
      }
      const int row = pix / (kColsF + 2), col = pix % (kColsF + 2);
      const int gy = y0 - 1 + row, gx = x0 - 1 + col, gc = c0 + ci;
      float val = 0.f;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && gc < p.cin &&
          !(p.drop_halo_column && col == 0))
        val = x[gc * p.x_sc + gy * p.x_sh + gx * p.x_sw];
      xs[ci][row][col] = val;
    }
    for (int i = threadIdx.x; i < kSliceF * 9 * CO; i += kQuads * CG) {
      const int co = i % CO, tap = (i / CO) % 9, ci = i / (CO * 9);
      const int gc = c0 + ci;
      float val = 0.f;
      if (co < p.cout && gc < p.cin) val = w[((long long)co * p.cin + gc) * 9 + tap];
      ws[ci][tap][co] = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kSliceF; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* xr = &xs[ci][r + dy][cq * 4];
        const float4 x4 = *reinterpret_cast<const float4*>(xr);
        const float xv[6] = {x4.x, x4.y, x4.z, x4.w, xr[4], xr[5]};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = &ws[ci][dy * 3 + dx][cg * 16];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wr + c4 * 4);
#pragma unroll
            for (int px = 0; px < 4; ++px) {
              acc[px][c4 * 4 + 0] = fmaf(xv[px + dx], w4.x, acc[px][c4 * 4 + 0]);
              acc[px][c4 * 4 + 1] = fmaf(xv[px + dx], w4.y, acc[px][c4 * 4 + 1]);
              acc[px][c4 * 4 + 2] = fmaf(xv[px + dx], w4.z, acc[px][c4 * 4 + 2]);
              acc[px][c4 * 4 + 3] = fmaf(xv[px + dx], w4.w, acc[px][c4 * 4 + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out) + n * p.o_sb;
  const int gy = y0 + r;
  if (gy >= p.H) return;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int co = cg * 16 + c;
    if (co >= p.cout) continue;
    const float b = p.bias[co];
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      const int gx = x0 + cq * 4 + px;
      if (gx < p.W) {
        float v = acc[px][c] + b;
        if (p.relu) v = fmaxf(v, 0.f);
        out[co * p.o_sc + gy * p.o_sh + gx * p.o_sw] = v;
      }
    }
  }
}

template <int NB>
cudaError_t launch_bf16(const ConvParams& p, cudaStream_t stream) {
  const int bytes = (kHalo * kHalo + 9 * NB * 8) * kRowB * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, p.B);
  conv3x3_bf16<NB><<<grid, kThreadsB, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int CG>
cudaError_t launch_fp32(const ConvParams& p, cudaStream_t stream) {
  const dim3 grid((p.W + kColsF - 1) / kColsF, (p.H + kRowsF - 1) / kRowsF, p.B);
  conv3x3_fp32<CG><<<grid, kQuads * CG, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bf16 x, w and out, 0 for fp32. strides: 8 element strides,
// (batch, channel, row, column) of x then of out. drop_halo_column: 0 on
// every real call (a test hook that plants a fault). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int omnivggt_conv3x3(int is_bf16, const void* x, const void* w,
                                const void* bias, void* out, int B, int cin,
                                int cout, int H, int W, const long long* strides,
                                int relu, int drop_halo_column, void* stream) {
  ConvParams p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.out = out;
  p.B = B; p.cin = cin; p.cout = cout; p.H = H; p.W = W;
  p.x_sb = strides[0]; p.x_sc = strides[1]; p.x_sh = strides[2]; p.x_sw = strides[3];
  p.o_sb = strides[4]; p.o_sc = strides[5]; p.o_sh = strides[6]; p.o_sw = strides[7];
  p.relu = relu;
  p.drop_halo_column = drop_halo_column;
  if (cout < 1 || cout > 64 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (cout <= 8) err = launch_bf16<1>(p, s);
    else if (cout <= 16) err = launch_bf16<2>(p, s);
    else if (cout <= 32) err = launch_bf16<4>(p, s);
    else err = launch_bf16<8>(p, s);
  } else {
    if (cout <= 16) err = launch_fp32<1>(p, s);
    else if (cout <= 32) err = launch_fp32<2>(p, s);
    else if (cout <= 48) err = launch_fp32<3>(p, s);
    else err = launch_fp32<4>(p, s);
  }
  return static_cast<int>(err);
}
