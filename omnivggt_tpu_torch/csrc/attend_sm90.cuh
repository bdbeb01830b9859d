// The bf16 attention tile of the Hopper kernels, one copy for the two
// sources that run it: flash_attention.cu (tma_attend, under the head-major
// and the token-major grids) and ring_attention.cu (ring_attend, one ring
// step of a sequence sharded over ranks). Each block holds 128 query rows
// of one (batch, head): two consumer warpgroups of 64 rows (wgmma's M) and
// one producer warpgroup, of which one thread issues every TMA load.
//
// Here are the parts the two kernels share:
//   - the block's shared memory (Q, a ring of K and V stages, the full and
//     empty mbarriers) and the barriers' initialisation;
//   - the producer: Q once, then 128-key K and V tiles through the stage
//     ring (3 stages at D = 64, 2 at D = 128), each a 4-D TMA box of 64
//     columns x 1 head x 128 rows x 1 batch at coordinates the caller
//     names, so the same loop reads (B, N, H, D) inputs and a ring buffer
//     viewed as (4 B H, nl, 1, D); rows past a map's extent load as zeros;
//   - the consumer's step over one key tile: S = Q K^T by wgmma SS (both
//     operands in shared memory, 128-byte swizzle), keys at or past n_eff
//     scored -1e30, the softmax in registers with the scale folded into the
//     exponent's argument (one FFMA, then ex2.approx.ftz), the bounded
//     clamp exp(min(s, 80)) at a fixed max of 0 or an online running max,
//     P rounded to bf16 and packed in place as the A fragment, O += P V by
//     wgmma RS with V read through the descriptor's transpose bit;
//   - the quad reduction of the row sums and the bf16 store of o rows.
// What the callers keep: the grid, the coordinates, where the softmax
// state starts and ends (registers for a whole key axis; device memory
// between the ring's steps), the LSE. Layouts and primitives: sm90.cuh.

#pragma once

#include "flash_common.cuh"
#include "sm90.cuh"

namespace attend {

using flash::kClampLog2;
using flash::kNegInf;
using flash::pack_bf16;

constexpr int kRows = 128;       // query rows a block, keys a tile
constexpr int kConsumers = 2;    // consumer warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = kRows * 128;  // one 64-column box of 128 rows

template <int D>
struct Smem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTile = kRows * D * 2;  // bytes of a Q, K or V tile
  static constexpr int kK = kTile;             // Q at 0
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// The block's tiles and barriers in dynamic shared memory.
struct Tiles {
  uint8_t* qs;
  uint8_t* ks;
  uint8_t* vs;
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* empty;
};

// Carves the dynamic shared memory (1024-byte aligned for the swizzle) and
// initialises the barriers; every thread of the block calls it.
template <int D>
__device__ __forceinline__ Tiles carve_tiles() {
  using L = Smem<D>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Tiles t;
  t.qs = smem;
  t.ks = smem + L::kK;
  t.vs = smem + L::kV;
  t.q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  t.k_full = t.q_full + 1;
  t.v_full = t.k_full + kS;
  t.empty = t.v_full + kS;
  if (threadIdx.x == 0) {
    sm90::mbar_init(t.q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&t.k_full[s], 1);
      sm90::mbar_init(&t.v_full[s], 1);
      sm90::mbar_init(&t.empty[s], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return t;
}

// The producer thread: the Q tile at (qh, q_row, qb) of q_map once, then
// key tiles it = 0 .. n_tiles - 1, K at (kh, it * 128, kb) of k_map and V
// at (vh, it * 128, vb) of v_map, each into stage it % kStages once the
// consumers have released it.
template <int D>
__device__ __forceinline__ void produce(const Tiles& t, const CUtensorMap* q_map, int qh,
                                        int q_row, int qb, const CUtensorMap* k_map, int kh,
                                        int kb, const CUtensorMap* v_map, int vh, int vb,
                                        int n_tiles) {
  using L = Smem<D>;
  constexpr int kS = L::kStages;
  sm90::prefetch_tensor_map(q_map);
  sm90::prefetch_tensor_map(k_map);
  sm90::prefetch_tensor_map(v_map);
  sm90::mbar_arrive_expect_tx(t.q_full, L::kTile);
#pragma unroll
  for (int box = 0; box < D / 64; ++box)
    sm90::tma_load_4d(t.qs + box * kBoxBytes, q_map, t.q_full, box * 64, qh, q_row, qb);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&t.empty[s], ((it / kS) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&t.k_full[s], L::kTile);
#pragma unroll
    for (int box = 0; box < D / 64; ++box)
      sm90::tma_load_4d(t.ks + s * L::kTile + box * kBoxBytes, k_map, &t.k_full[s], box * 64,
                        kh, it * kRows, kb);
    sm90::mbar_arrive_expect_tx(&t.v_full[s], L::kTile);
#pragma unroll
    for (int box = 0; box < D / 64; ++box)
      sm90::tma_load_4d(t.vs + s * L::kTile + box * kBoxBytes, v_map, &t.v_full[s], box * 64,
                        vh, it * kRows, vb);
  }
}

// Consumer warpgroup wg, thread tq of its quad: key tile `it` (keys from
// it * 128) into the softmax state. acc is the m64nD accumulator of O,
// m_run the running max of the thread's two rows in log2 units, l_run the
// thread's share of their row sums. Keys at or past n_eff are masked (in
// the last tile only); the raw scores' scale into log2 units is folded
// into the exponent's argument. The caller has waited for Q.
template <int D, bool kBounded>
__device__ __forceinline__ void consume_tile(const Tiles& t, int wg, int tq, int it, int n_eff,
                                             float scale_log2, float (&acc)[D / 2],
                                             float (&m_run)[2], float (&l_run)[2]) {
  using L = Smem<D>;
  constexpr int kS = L::kStages;
  const int s = it % kS;
  const uint32_t parity = (it / kS) & 1;
  const uint8_t* kt = t.ks + s * L::kTile;
  const uint8_t* vt = t.vs + s * L::kTile;

  // S = Q K^T: 64 rows x 128 keys, D / 16 steps
  float sc[64];
  sm90::mbar_wait(&t.k_full[s], parity);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    sm90::wgmma_ss_m64n128k16(sc, sm90::desc_sw128(t.qs + off + wg * 64 * 128, 16, 1024),
                              sm90::desc_sw128(kt + off, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);

  // mask keys at or past n_eff in the last tile (raw scores)
  const int k0 = it * kRows;
  if (k0 + kRows > n_eff) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + (i / 4) * 8 + tq * 2 + (i & 1) >= n_eff) sc[i] = kNegInf;
    }
  }
  if (kBounded) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = sm90::exp2_ftz(fminf(sc[i] * scale_log2, kClampLog2));
      l_run[(i >> 1) & 1] += sc[i];
    }
  } else {
    // the row max of the raw scores, scaled after (the scale is > 0)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      corr[r] = sm90::exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = sm90::exp2_ftz(fmaf(sc[i], scale_log2, -m_run[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += sc[i];
    }
  }

  // P in bf16: column groups 2kk and 2kk + 1 are the A operand of step kk
  uint32_t pa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  }

  // O += P V: 128 keys in 8 steps; V read through the transpose bit
  sm90::mbar_wait(&t.v_full[s], parity);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = sm90::desc_sw128(vt + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (D == 64) {
      sm90::wgmma_rs_m64n64k16(acc, pa[kk], dv);
    } else {
      sm90::wgmma_rs_m64n128k16(acc, pa[kk], dv);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::mbar_arrive(&t.empty[s]);
}

// The row sums of the thread's two rows, summed over its quad (every
// thread of the quad then holds them).
__device__ __forceinline__ void quad_sum(float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
}

// o rows row_lo and row_lo + 8 (those below row_end) as bf16, acc times
// inv[r]; ob is the (batch, head)'s base, o_sn the row stride in elements.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, long long o_sn,
                                           const float (&acc)[D / 2], const float (&inv)[2],
                                           int row_lo, int row_end, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row < row_end) {
      __nv_bfloat16* orow = ob + (long long)row * o_sn;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

}  // namespace attend
