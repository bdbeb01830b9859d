// Non-causal flash-attention backward for Hopper (sm_90a): two kernels,
// bf16 in, fp32 accumulation, bf16 out. Plain C interface, loaded with
// ctypes from omnivggt_tpu_torch/ops/kernels/flash_attention.py.
//
// Replaces the two backward TPU kernels of
// omnivggt_tpu/ops/pallas/flash_attention.py (reached through
// _flash_backward from every custom_vjp wrapper, head-major and packed):
//   - _flash_bwd_dq_kernel (TPU kernel 3): dq = scale * sum_k ds k, and
//     delta = rowsum(dO * O) once per query row;
//   - _flash_bwd_dkv_kernel (TPU kernel 4): dv = sum_q p^T dO,
//     dk = scale * sum_q ds^T q;
// with p = exp(s - lse) rebuilt from the forward's saved row LSE (s clamped
// at 80 in bounded mode, the clamp passing gradients straight through, as
// _bwd_recompute does) and ds = p * (dO v^T - delta). Keys at or past
// min(Nk, kv_valid) get p = 0, which zeroes their dq contribution and their
// own dk/dv rows.
//
// What bounds it on this card: per (query, key) pair the dq kernel runs
// three matrix products (S = Q K^T, dP = dO V^T, dQ += dS K) and the dk/dv
// kernel four (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q), 2 D
// FLOPs each, against q, k, v, o, dO read and dq, dk, dv written about
// once: thousands of FLOPs a byte at the training shapes, so both kernels
// are bound by the tensor cores (0.19 + 0.25 ms of bf16 products at
// (1, 5496, 16, 64) against 0.02 ms of bytes), with one exponential per
// score and kernel on the special-function units beside them. Two kernels
// run 7 products where a dq summed by atomics runs 5: the price of a
// deterministic sum.
//
// What the design does about it: the forward's Hopper tile
// (attend_sm90.cuh; primitives in sm90.cuh):
//   - 384 threads a block: two consumer warpgroups of 64 rows (wgmma's M)
//     and a producer warpgroup, of which one thread issues every TMA load
//     into a ring of shared-memory stages guarded by full and empty
//     mbarriers (setmaxnreg: 24 registers for the producer, 240 for the
//     consumers), so the next tiles are in flight while the tensor cores
//     work on this one;
//   - dq kernel (flash_bwd_dq): a block owns 128 query rows of one (batch,
//     head). Q and dO are loaded once and 128-key K and V tiles stream
//     through attend::produce's stage ring (3 stages at D = 64, 2 at
//     D = 128). Per tile: S and dP by wgmma SS (both operands K-major along
//     D), p from the saved LSE with the scale folded into the exponent's
//     argument while dP is still in the tensor cores, ds in registers,
//     packed in place to bf16 as the A fragment of dQ += dS K by wgmma RS,
//     K read through the descriptor's transpose bit. delta is formed in the
//     prologue from plain loads of O and dO (a quad of threads a row pair)
//     and written for the dk/dv kernel, so O is read once;
//   - dk/dv kernel (flash_bwd_dkv): a block owns 128 keys. K and V are
//     loaded once, and 128-query (D = 64) or 64-query (D = 128, which keeps
//     the four accumulators at 192 registers a thread) tiles of Q and dO
//     stream through a 3-stage ring with those rows' lse and delta, each a
//     1-D TMA box over the flat (B, H, N) buffer (its row stride of 4 N
//     bytes is not a multiple of 16, so no 2-D map is legal; a 1-D box has
//     to start on a 16-byte boundary, or the load faults, so it starts up
//     to 3 values before the tile's first row). Per tile: S^T
//     and dP^T by SS, p^T and ds^T in registers with lse and delta read
//     from the stage by the accumulator's column, then dV += P^T dO and
//     dK += dS^T Q by RS, dO and Q through the transpose bit. A block wholly
//     past the valid keys writes zeros and loads nothing;
//   - neither kernel writes P or dS to shared memory or keeps a transposed
//     copy of an operand; p and ds are rounded to bf16 only as the A
//     operand, as the TPU kernels round them; every sum is taken in one
//     block in a fixed order (no atomics), so the output is deterministic;
//   - TMA's zero fill stands in for rows past N or Nk; a tile that crosses
//     n_eff (keys) or N (query rows, dk/dv) sets p = 0 there by a select,
//     so a score of a zero-filled key, or an lse read past the head's row,
//     never reaches a sum;
//   - q, k, v, dO are read through (B, N, H, D) strides (v in place from the
//     fused qkv tensor), and dq, dk, dv are written the same way in bf16.

#include "attend_sm90.cuh"

namespace {

using attend::kBwdDq;
using attend::kConsumers;
using attend::kRows;
using flash::kClampLog2;
using flash::kLog2e;
using flash::pack_bf16;
constexpr int kThreads = attend::kThreads;

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;  // 4-D (D, H, N, B) maps, see sm90.cuh
  CUtensorMap lse_map, delta_map;           // dk/dv: 1-D maps over the flat (B, H, N) rows
  const __nv_bfloat16* o;                   // dq: O and dO rows, read by threads for delta
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, N) natural-log row LSE of the forward
  float* delta;      // dq: (B, H, N) rowsum(dO * O), written for the dk/dv kernel
  __nv_bfloat16* out;   // dq, or dk
  __nv_bfloat16* out2;  // dv
  // element strides (batch, token, head); the last axis is contiguous
  long long o_sb, o_sn, o_sh;
  long long do_sb, do_sn, do_sh;
  long long out_sb, out_sn, out_sh;
  long long out2_sb, out2_sn, out2_sh;
  int B, H, N, Nk;
  int kv_static;
  const int* kv_dynamic;
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 * log2(e)
};

__device__ __forceinline__ int valid_keys(const BwdParams& p) {
  const int n = p.kv_dynamic ? min(p.Nk, *p.kv_dynamic) : p.kv_static;
  return max(n, 0);
}

// p = exp(min?(s * scale) - lse) from a raw score, lse2 in log2 units
template <bool kBounded>
__device__ __forceinline__ float prob(float s, float scale_log2, float lse2) {
  return sm90::exp2_ftz(kBounded ? fminf(s * scale_log2, kClampLog2) - lse2
                                 : fmaf(s, scale_log2, -lse2));
}

// sum of the products of 8 bf16 pairs, in order
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float sum) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(x[j]), w = __bfloat1622float2(y[j]);
    sum = fmaf(u.x, w.x, sum);
    sum = fmaf(u.y, w.y, sum);
  }
  return sum;
}

// d (m64nN) = a * b^T, or plus d when accumulate != 0 (SS, bf16)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 128) {
    sm90::wgmma_ss_m64n128k16(d, a, b, accumulate);
  } else {
    sm90::wgmma_ss_m64n64k16(d, a, b, accumulate);
  }
}

// d (m64nD) += a * b (RS, b through the transpose bit)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    sm90::wgmma_rs_m64n64k16(d, a, b);
  } else {
    sm90::wgmma_rs_m64n128k16(d, a, b);
  }
}

// d (64 x N) = A B^T over D: A the 64 rows from a_row of a tile of kARows
// rows, B a tile of N rows, both bf16 in TMA's 128-byte swizzle (D / 64
// boxes of 64 columns), K-major along D (wgmma SS)
template <int D, int kARows, int N>
__device__ __forceinline__ void rows_by_rows(float (&d)[N / 2], const uint8_t* a, int a_row,
                                             const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 32;
    wgmma_ss<N>(d, sm90::desc_sw<128>(a + (kk / 4) * kARows * 128 + a_row * 128 + col, 16, 1024),
                sm90::desc_sw<128>(b + (kk / 4) * N * 128 + col, 16, 1024), kk > 0);
  }
}

// d (64 x D) += A B: A (64 x kK) as bf16 fragments in registers, B a tile of
// kK rows x D columns read through the transpose bit (wgmma RS)
template <int D, int kK>
__device__ __forceinline__ void frags_by_rows(float (&d)[D / 2], const uint32_t (&a)[kK / 16][4],
                                              const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
    wgmma_rs<D>(d, a[kk], sm90::desc_sw<128>(b + kk * 16 * 128, kK * 128, 1024));
}

// an m64nN accumulator packed to bf16: column groups 2k and 2k + 1 are the
// A operand of the k-th 16-deep step
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
  }
}

// ---- dq ---------------------------------------------------------------------

// Consumer warpgroup wg, thread tq of its quad: key tile `it` into dQ (acc)
// for the thread's two rows (lse2 in log2 units, delta); kMask: the tile
// crosses n_eff.
template <int D, bool kBounded, bool kMask>
__device__ __forceinline__ void dq_tile(const attend::Tiles& t, int wg, int tq, int it, int n_eff,
                                        float scale_log2, const float (&lse2)[2],
                                        const float (&delta)[2], float (&acc)[D / 2]) {
  using L = attend::Smem<D, kBwdDq>;
  constexpr int kS = L::kStages;
  const int s = it % kS;
  const uint32_t parity = (it / kS) & 1;
  const uint8_t* kt = t.ks + s * L::kKTile;
  const uint8_t* vt = t.vs + s * L::kVTile;

  float sc[64], dp[64];
  sm90::mbar_wait(&t.k_full[s], parity);
  sm90::wgmma_fence();
  rows_by_rows<D, kRows, kRows>(sc, t.qs, wg * 64, kt);  // S = Q K^T
  sm90::wgmma_commit();
  sm90::mbar_wait(&t.v_full[s], parity);
  rows_by_rows<D, kRows, kRows>(dp, t.dos, wg * 64, vt);  // dP = dO V^T
  sm90::wgmma_commit();

  sm90::wgmma_wait<1>();  // S is in; dP may still be in flight
  sm90::fence_regs(sc);
  const int k0 = it * kRows;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float pe = prob<kBounded>(sc[i], scale_log2, lse2[(i >> 1) & 1]);
    sc[i] = kMask && k0 + (i / 4) * 8 + tq * 2 + (i & 1) >= n_eff ? 0.f : pe;
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 64; ++i) dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]);  // ds
  uint32_t da[8][4];
  pack_frags<kRows>(da, dp);

  sm90::wgmma_fence();
  frags_by_rows<D, kRows>(acc, da, kt);  // dQ += dS K
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::mbar_arrive(&t.empty[s]);
}

// counterpart of _flash_bwd_dq_kernel: grid (query tiles of 128, B*H)
template <int D, bool kBounded>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(const __grid_constant__ BwdParams p) {
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kRows;
  const attend::Tiles t = attend::carve_tiles<D, kBwdDq>();
  // producer and consumers read the same count, so they agree on the tiles
  const int n_eff = valid_keys(p);
  const int n_tiles = (n_eff + kRows - 1) / kRows;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kConsumers)
      attend::produce<D, kBwdDq>(t, &p.q_map, h, q0, b, &p.k_map, h, b, &p.v_map, h, b, n_tiles,
                                 &p.do_map);
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) >> 2;  // accumulator row group
  const int tq = tid & 3;         // thread in group
  const int row_lo = q0 + wg * 64 + (tid / 32) * 16 + g;  // rows row_lo, row_lo + 8
  const long long row_base = (long long)bh * p.N;

  // delta and lse of the thread's two rows: each thread of the quad sums
  // D / 4 columns of dO * O (16-byte loads), then the quad adds
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    float sum = 0.f;
    if (row < p.N) {
      const uint4* orow =
          reinterpret_cast<const uint4*>(p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn) +
          tq * (D / 32);
      const uint4* drow =
          reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + h * p.do_sh + row * p.do_sn) +
          tq * (D / 32);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) sum = dot8(orow[j], drow[j], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
    lse2[r] = row < p.N ? p.lse[row_base + row] * kLog2e : 0.f;
    if (tq == 0 && row < p.N) p.delta[row_base + row] = sum;
  }

  float acc[D / 2];  // dQ: m64nD accumulator
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(t.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if ((it + 1) * kRows > n_eff) {
      dq_tile<D, kBounded, true>(t, wg, tq, it, n_eff, p.scale_log2, lse2, delta, acc);
    } else {
      dq_tile<D, kBounded, false>(t, wg, tq, it, n_eff, p.scale_log2, lse2, delta, acc);
    }
  }
  const float mul[2] = {p.scale, p.scale};
  attend::store_rows<D>(p.out + b * p.out_sb + h * p.out_sh, p.out_sn, acc, mul, row_lo, p.N, tq);
}

// ---- dk/dv ------------------------------------------------------------------

// Bytes of the dk/dv block's shared memory: K and V (128 keys), then
// kStages stages of Q and of dO (kQRows rows), of lse and of delta (a box
// of kRowBox fp32: the stage's rows and the up to 3 before them, so that
// it starts on a 16-byte boundary), then the barriers. Every bf16 tile
// starts 1024-byte aligned, every row box 128-byte aligned.
template <int D>
struct DkvSmem {
  static constexpr int kQRows = D == 64 ? 128 : 64;  // query rows a stage
  static constexpr int kStages = 3;
  static constexpr int kKVTile = kRows * D * 2;
  static constexpr int kQTile = kQRows * D * 2;
  static constexpr int kRowBox = kQRows + 4;
  static constexpr int kRowBytes = (kRowBox * 4 + 127) / 128 * 128;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kLse = kDo + kStages * kQTile;
  static constexpr int kDelta = kLse + kStages * kRowBytes;
  static constexpr int kBars = kDelta + kStages * kRowBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

struct DkvTiles {
  uint8_t* ks;
  uint8_t* vs;
  uint8_t* qs;
  uint8_t* dos;
  float* lse;
  float* delta;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
};

template <int D>
__device__ __forceinline__ DkvTiles carve_dkv() {
  using L = DkvSmem<D>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  DkvTiles t;
  t.ks = smem;
  t.vs = smem + L::kV;
  t.qs = smem + L::kQ;
  t.dos = smem + L::kDo;
  t.lse = reinterpret_cast<float*>(smem + L::kLse);
  t.delta = reinterpret_cast<float*>(smem + L::kDelta);
  t.kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  t.full = t.kv_full + 1;
  t.empty = t.full + kS;
  if (threadIdx.x == 0) {
    sm90::mbar_init(t.kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&t.full[s], 1);
      sm90::mbar_init(&t.empty[s], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return t;
}

// The producer thread: K and V at keys k0 once, then query tiles it = 0 ..
// n_tiles - 1 (Q, dO from row it * kQRows; lse and delta from flat index
// row0 + it * kQRows - lead, row0 the head's first row and lead = row0 % 4)
// into stage it % kStages once the consumers have released it.
template <int D>
__device__ __forceinline__ void produce_dkv(const DkvTiles& t, const BwdParams& p, int b, int h,
                                            int k0, int n_tiles, int row0, int lead) {
  using L = DkvSmem<D>;
  constexpr int kS = L::kStages, kQ = L::kQRows;
  sm90::prefetch_tensor_map(&p.q_map);
  sm90::prefetch_tensor_map(&p.k_map);
  sm90::prefetch_tensor_map(&p.v_map);
  sm90::prefetch_tensor_map(&p.do_map);
  sm90::prefetch_tensor_map(&p.lse_map);
  sm90::prefetch_tensor_map(&p.delta_map);
  sm90::mbar_arrive_expect_tx(t.kv_full, 2 * L::kKVTile);
  attend::load_tile<D, false>(t.ks, &p.k_map, t.kv_full, h, k0, b);
  attend::load_tile<D, false>(t.vs, &p.v_map, t.kv_full, h, k0, b);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&t.empty[s], ((it / kS) & 1) ^ 1);
    uint64_t* bar = &t.full[s];
    sm90::mbar_arrive_expect_tx(bar, 2 * L::kQTile + 2 * L::kRowBox * 4);
    attend::load_tile<D, false, kQ>(t.qs + s * L::kQTile, &p.q_map, bar, h, it * kQ, b);
    attend::load_tile<D, false, kQ>(t.dos + s * L::kQTile, &p.do_map, bar, h, it * kQ, b);
    const int c0 = row0 + it * kQ - lead;  // a multiple of 4: a 16-byte boundary
    sm90::tma_load_1d(t.lse + s * L::kRowBytes / 4, &p.lse_map, bar, c0);
    sm90::tma_load_1d(t.delta + s * L::kRowBytes / 4, &p.delta_map, bar, c0);
  }
}

// Consumer warpgroup wg, thread tq of its quad: query tile `it` into dK and
// dV of the thread's two keys (key_ok: below n_eff); kMask: the tile
// crosses N or the block's keys cross n_eff. Column c of the accumulators
// is query row it * kQRows + c, whose lse and delta the stage holds at
// lead + c.
template <int D, bool kBounded, bool kMask>
__device__ __forceinline__ void dkv_tile(const DkvTiles& t, int wg, int tq, int it, int N,
                                         int lead, const bool (&key_ok)[2], float scale_log2,
                                         float (&dk)[D / 2], float (&dv)[D / 2]) {
  using L = DkvSmem<D>;
  constexpr int kS = L::kStages, kQ = L::kQRows;
  const int s = it % kS;
  const uint32_t parity = (it / kS) & 1;
  const uint8_t* qt = t.qs + s * L::kQTile;
  const uint8_t* dot = t.dos + s * L::kQTile;
  const float* lse = t.lse + s * L::kRowBytes / 4 + lead + 2 * tq;
  const float* dl = t.delta + s * L::kRowBytes / 4 + lead + 2 * tq;

  float st[kQ / 2], dpt[kQ / 2];
  sm90::mbar_wait(&t.full[s], parity);
  sm90::wgmma_fence();
  rows_by_rows<D, kRows, kQ>(st, t.ks, wg * 64, qt);  // S^T = K Q^T
  sm90::wgmma_commit();
  rows_by_rows<D, kRows, kQ>(dpt, t.vs, wg * 64, dot);  // dP^T = V dO^T
  sm90::wgmma_commit();

  sm90::wgmma_wait<1>();  // S^T is in; dP^T may still be in flight
  sm90::fence_regs(st);
  const int q0 = it * kQ;
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j) {
    const float l[2] = {lse[8 * j] * kLog2e, lse[8 * j + 1] * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float pe = prob<kBounded>(st[i], scale_log2, l[e & 1]);
      st[i] = kMask && !(key_ok[e >> 1] && q0 + 8 * j + 2 * tq + (e & 1) < N) ? 0.f : pe;
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dpt);
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j) {
    const float d[2] = {dl[8 * j], dl[8 * j + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dpt[i] = st[i] * (dpt[i] - d[e & 1]);  // ds^T
    }
  }
  uint32_t pa[kQ / 16][4], da[kQ / 16][4];
  pack_frags<kQ>(pa, st);
  pack_frags<kQ>(da, dpt);

  sm90::wgmma_fence();
  frags_by_rows<D, kQ>(dv, pa, dot);  // dV += P^T dO
  frags_by_rows<D, kQ>(dk, da, qt);   // dK += dS^T Q
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dv);
  sm90::fence_regs(dk);
  sm90::mbar_arrive(&t.empty[s]);
}

// counterpart of _flash_bwd_dkv_kernel: grid (key tiles of 128, B*H)
template <int D, bool kBounded>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv(const __grid_constant__ BwdParams p) {
  using L = DkvSmem<D>;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kRows;
  const int n_eff = valid_keys(p);
  __nv_bfloat16* dkb = p.out + b * p.out_sb + h * p.out_sh;
  __nv_bfloat16* dvb = p.out2 + b * p.out2_sb + h * p.out2_sh;

  if (k0 >= n_eff) {  // every key of the block is masked: dk = dv = 0
    for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
      const int key = k0 + i / (D / 8), c = (i % (D / 8)) * 8;
      if (key < p.Nk) {
        *reinterpret_cast<uint4*>(dkb + key * p.out_sn + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dvb + key * p.out2_sn + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const DkvTiles t = carve_dkv<D>();
  const int n_tiles = (p.N + L::kQRows - 1) / L::kQRows;
  const int row0 = bh * p.N;  // the head's first row in the flat lse and delta
  const int lead = row0 % 4;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kConsumers) produce_dkv<D>(t, p, b, h, k0, n_tiles, row0, lead);
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) >> 2;
  const int tq = tid & 3;
  const int key_lo = k0 + wg * 64 + (tid / 32) * 16 + g;  // keys key_lo, key_lo + 8
  const bool key_ok[2] = {key_lo < n_eff, key_lo + 8 < n_eff};
  const bool keys_cut = k0 + kRows > n_eff;

  float dk[D / 2], dv[D / 2];  // m64nD accumulators
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  sm90::mbar_wait(t.kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (keys_cut || (it + 1) * L::kQRows > p.N) {
      dkv_tile<D, kBounded, true>(t, wg, tq, it, p.N, lead, key_ok, p.scale_log2, dk, dv);
    } else {
      dkv_tile<D, kBounded, false>(t, wg, tq, it, p.N, lead, key_ok, p.scale_log2, dk, dv);
    }
  }
  const float mul_k[2] = {p.scale, p.scale}, mul_v[2] = {1.f, 1.f};
  attend::store_rows<D>(dkb, p.out_sn, dk, mul_k, key_lo, p.Nk, tq);
  attend::store_rows<D>(dvb, p.out2_sn, dv, mul_v, key_lo, p.Nk, tq);
}

// ---- launch -----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int tiles, const BwdParams& p, int bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, p.B * p.H), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int bounded, cudaStream_t s) {
  const int tiles = (p.N + kRows - 1) / kRows;
  const int bytes = attend::Smem<D, kBwdDq>::kAlloc;
  return bounded ? launch(flash_bwd_dq<D, true>, tiles, p, bytes, s)
                 : launch(flash_bwd_dq<D, false>, tiles, p, bytes, s);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int bounded, cudaStream_t s) {
  const int tiles = (p.Nk + kRows - 1) / kRows;
  const int bytes = DkvSmem<D>::kAlloc;
  return bounded ? launch(flash_bwd_dkv<D, true>, tiles, p, bytes, s)
                 : launch(flash_bwd_dkv<D, false>, tiles, p, bytes, s);
}

// The fields both kernels take; false where a tensor map is refused. q, k,
// v and dO are mapped with boxes of 128 rows (K and V) and q_rows rows (Q
// and dO).
bool make_params(BwdParams* p, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, void* delta, const long long* st, int D, int q_rows, int B,
                 int H, int N, int Nk, int kv_static, const void* kv_dynamic, float scale) {
  if (!(sm90::encode_bnhd_map(&p->q_map, q, B, N, H, D, st[0], st[1], st[2], q_rows) &&
        sm90::encode_bnhd_map(&p->k_map, k, B, Nk, H, D, st[3], st[4], st[5], kRows) &&
        sm90::encode_bnhd_map(&p->v_map, v, B, Nk, H, D, st[6], st[7], st[8], kRows) &&
        sm90::encode_bnhd_map(&p->do_map, dout, B, N, H, D, st[9], st[10], st[11], q_rows)))
    return false;
  p->dout = static_cast<const __nv_bfloat16*>(dout);
  p->do_sb = st[9]; p->do_sn = st[10]; p->do_sh = st[11];
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<float*>(delta);
  p->B = B; p->H = H; p->N = N; p->Nk = Nk;
  p->kv_static = kv_static;
  p->kv_dynamic = static_cast<const int*>(kv_dynamic);
  p->scale = scale;
  p->scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

// Threads a block of either kernel, and the dynamic shared memory in bytes
// of kernel 0 (dq) or 1 (dk/dv) at a head dim (64 or 128; 0 otherwise),
// for the build report.
extern "C" int omnivggt_flash_attention_bwd_threads() { return kThreads; }

extern "C" int omnivggt_flash_attention_bwd_smem_bytes(int kernel, int head_dim) {
  if (head_dim != 64 && head_dim != 128) return 0;
  if (kernel == 0)
    return head_dim == 64 ? attend::Smem<64, kBwdDq>::kAlloc : attend::Smem<128, kBwdDq>::kAlloc;
  if (kernel == 1) return head_dim == 64 ? DkvSmem<64>::kAlloc : DkvSmem<128>::kAlloc;
  return 0;
}

// strides: 18 element strides, (batch, token, head) for q, k, v, dO, o, dq;
// q, k, v, dO go to TMA (each stride a multiple of 16 bytes, the bases
// 16-byte aligned), o is read with 16-byte loads. Writes dq and delta
// (contiguous (B, H, N) fp32). Returns the cudaError_t of the launch.
extern "C" int omnivggt_flash_attention_bwd_dq(
    int bounded, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* delta, void* dq,
    const long long* strides, int B, int H, int N, int Nk, int kv_static,
    const void* kv_dynamic, float scale, void* stream) {
  const int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (head_dim != 64 && head_dim != 128) return kInvalid;
  BwdParams p = {};
  if (!make_params(&p, q, k, v, dout, lse, delta, strides, head_dim, kRows, B, H, N, Nk,
                   kv_static, kv_dynamic, scale))
    return kInvalid;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.o_sb = strides[12]; p.o_sn = strides[13]; p.o_sh = strides[14];
  p.out = static_cast<__nv_bfloat16*>(dq);
  p.out_sb = strides[15]; p.out_sn = strides[16]; p.out_sh = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim == 64 ? launch_dq<64>(p, bounded, s)
                                         : launch_dq<128>(p, bounded, s));
}

// strides: 18 element strides, (batch, token, head) for q, k, v, dO, dk, dv
// (q, k, v, dO to TMA, as above). Reads lse and delta (contiguous (B, H, N)
// fp32, 16-byte aligned; delta as the dq kernel wrote it) through 1-D maps.
// Returns the cudaError_t.
extern "C" int omnivggt_flash_attention_bwd_dkv(
    int bounded, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int N, int Nk, int kv_static,
    const void* kv_dynamic, float scale, void* stream) {
  const int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (head_dim != 64 && head_dim != 128) return kInvalid;
  const int q_rows = head_dim == 64 ? DkvSmem<64>::kQRows : DkvSmem<128>::kQRows;
  const long long rows = static_cast<long long>(B) * H * N;
  BwdParams p = {};
  if (!make_params(&p, q, k, v, dout, lse, const_cast<void*>(delta), strides, head_dim, q_rows,
                   B, H, N, Nk, kv_static, kv_dynamic, scale) ||
      !sm90::encode_flat_f32_map(&p.lse_map, lse, rows, q_rows + 4) ||
      !sm90::encode_flat_f32_map(&p.delta_map, delta, rows, q_rows + 4))
    return kInvalid;
  p.out = static_cast<__nv_bfloat16*>(dk);
  p.out_sb = strides[12]; p.out_sn = strides[13]; p.out_sh = strides[14];
  p.out2 = static_cast<__nv_bfloat16*>(dv);
  p.out2_sb = strides[15]; p.out2_sn = strides[16]; p.out2_sh = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim == 64 ? launch_dkv<64>(p, bounded, s)
                                         : launch_dkv<128>(p, bounded, s));
}
