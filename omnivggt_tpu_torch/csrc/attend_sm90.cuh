// The attention tile of the Hopper kernels, one copy for the sources that
// run it: flash_attention.cu (tma_attend, under the head-major and the
// token-major grids, bf16 and int8 scores), ring_attention.cu (ring_attend,
// one ring step of a sequence sharded over ranks, bf16 or int8) and
// flash_attention_bwd.cu (the dq kernel: its shared memory and producer,
// with a dO tile loaded beside Q). Each
// block holds 128 query rows of one (batch, head): two consumer warpgroups
// of 64 rows (wgmma's M) and one producer warpgroup, of which one thread
// issues every TMA load.
//
// Here are the parts the kernels share:
//   - the block's shared memory (Q, for the dq kernel dO, a ring of K and
//     V stages, the full and empty mbarriers) and the barriers'
//     initialisation;
//   - the producer: Q (and dO) once, then 128-key K and V tiles through the
//     stage ring, each a 4-D TMA box (or two) of columns x 1 head x 128
//     rows x 1 batch at coordinates the caller names, so the same loop reads
//     (B, N, H, D) inputs and a ring buffer viewed as (4 B H, nl, 1, D);
//     rows past a map's extent load as zeros;
//   - the converters of the form whose V arrives as int8 (the int8 ring,
//     whose K/V shards rotate as int8): the producer warpgroup's other three
//     warps turn each int8 V tile, staged by TMA beside the K tile, into
//     the bf16 V stage in the layout TMA gives a bf16 tile, exactly and
//     without a conversion instruction, so the P V product below reads it
//     unchanged;
//   - the consumer's step over one key tile, in two forms that differ only
//     in the score product:
//       bf16: S = Q K^T by wgmma SS (both operands in shared memory,
//       128-byte swizzle), keys at or past n_eff scored -1e30;
//       int8: S = Q K^T by wgmma SS s8 -> s32 (int8 rows of D bytes under
//       a D-byte swizzle), exact; the accumulator starts at the float bits
//       of 1.5 * 2^23, so each s32 entry holds the bits of the float
//       1.5 * 2^23 + s and one FADD gives s exactly (|s| <= 127^2 D < 2^22),
//       without the conversion instruction, which issues at the rate of
//       the exponential; the last tile scales by the head's dequantising
//       scalar before it masks, so a scalar of 0 (all-zero q and k) leaves
//       the masked keys at -1e30;
//     then the softmax in registers with the scale folded into the
//     exponent's argument (one FFMA, then ex2.approx.ftz), the bounded
//     clamp exp(min(s, 80)) at a fixed max of 0 or an online running max,
//     P rounded to bf16 and packed in place as the A fragment, O += P V by
//     wgmma RS with V read through the descriptor's transpose bit;
//   - quantise_q: the int8 form whose q arrives as bf16 (the stream
//     kernel's) rounds each warpgroup's 64 rows to the int8 grid into a
//     tile that the score product reads;
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
constexpr int kBoxBytes = kRows * 128;  // one 64-column bf16 box of 128 rows

// how the scores are formed
constexpr int kScoresBf16 = 0;     // bf16 q and k
constexpr int kScoresInt8 = 1;     // int8 q and k, quantised by the caller
constexpr int kScoresInt8QIn = 2;  // int8 k from the caller, bf16 q quantised here
constexpr int kBwdDq = 3;          // the dq kernel: bf16 scores, a bf16 dO tile beside Q
constexpr int kScoresInt8V8 = 4;   // int8 q, k and v; V converted to bf16 here

// threads that convert int8 V tiles (kScoresInt8V8): the producer
// warpgroup's warps 1-3
constexpr int kConverters = 96;

// the int8 scores' accumulator start: the float bits of 1.5 * 2^23
constexpr uint32_t kScoreBias = 0x4B400000u;
constexpr float kScoreBiasF = 12582912.0f;

// Bytes of the block's shared memory: Q as loaded (int8 for kScoresInt8
// and kScoresInt8V8, else bf16), kScoresInt8QIn's int8 Q tile or kBwdDq's
// bf16 dO tile, kStages K stages (int8 for the int8 forms), kStages bf16 V
// stages, for kScoresInt8V8 kStages int8 V stages that TMA fills, then the
// barriers. Every tile starts 1024-byte aligned.
template <int D, int kForm = kScoresBf16>
struct Smem {
  static constexpr bool kV8 = kForm == kScoresInt8V8;
  static constexpr bool kS8 = kForm == kScoresInt8 || kForm == kScoresInt8QIn || kV8;
  static constexpr bool kQ8In = kForm == kScoresInt8 || kV8;  // Q arrives as int8
  static constexpr int kStages = kS8 ? (D == 64 ? 4 : 3) : (D == 64 ? 3 : 2);
  static constexpr int kQTile = kRows * D * (kQ8In ? 1 : 2);
  static constexpr int kKTile = kRows * D * (kS8 ? 1 : 2);
  static constexpr int kVTile = kRows * D * 2;
  static constexpr int kV8Tile = kV8 ? kRows * D : 0;
  static constexpr int kQ8 = kQTile;  // kScoresInt8QIn: the int8 Q the consumers write;
                                      // kBwdDq: dO
  static constexpr int kK = kQ8 + (kForm == kScoresInt8QIn ? kRows * D
                                   : kForm == kBwdDq       ? kQTile
                                                           : 0);
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kV8s = kV + kStages * kVTile;
  static constexpr int kBars = kV8s + kStages * kV8Tile;
  static constexpr int kBytes = kBars + (1 + (kV8 ? 4 : 3) * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kAlloc <= 232448, "more shared memory than a block of the H100 can have");
};

// The block's tiles and barriers in dynamic shared memory.
struct Tiles {
  uint8_t* qs;  // Q as loaded
  uint8_t* qa;  // Q as the score product reads it (int8 Q for the int8 forms)
  uint8_t* dos;  // kBwdDq: the dO tile
  uint8_t* ks;
  uint8_t* vs;
  uint8_t* v8s;  // kScoresInt8V8: the int8 V stages
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* empty;
  uint64_t* v8_full;  // kScoresInt8V8: an int8 V tile has landed
};

// Carves the dynamic shared memory (1024-byte aligned for the swizzle) and
// initialises the barriers; every thread of the block calls it.
template <int D, int kForm = kScoresBf16>
__device__ __forceinline__ Tiles carve_tiles() {
  using L = Smem<D, kForm>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Tiles t;
  t.qs = smem;
  t.qa = kForm == kScoresInt8QIn ? smem + L::kQ8 : smem;
  t.dos = smem + L::kQ8;
  t.ks = smem + L::kK;
  t.vs = smem + L::kV;
  t.v8s = smem + L::kV8s;
  t.q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  t.k_full = t.q_full + 1;
  t.v_full = t.k_full + kS;
  t.empty = t.v_full + kS;
  t.v8_full = t.empty + kS;
  if (threadIdx.x == 0) {
    sm90::mbar_init(t.q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&t.k_full[s], 1);
      // TMA's one arrival, or every converter's once it has written the stage
      sm90::mbar_init(&t.v_full[s], L::kV8 ? kConverters : 1);
      sm90::mbar_init(&t.empty[s], 128 * kConsumers);
      if (L::kV8) sm90::mbar_init(&t.v8_full[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return t;
}

// One kTileRows-row tile (128 unless named) of an operand at (h, row, b)
// of `map`: bf16 as D / 64 boxes of 64 columns, int8 as one box of D
// columns.
template <int D, bool kInt8, int kTileRows = kRows>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row, int b) {
  constexpr int kBoxes = kInt8 ? 1 : D / 64;
  constexpr int kCols = D / kBoxes;
#pragma unroll
  for (int box = 0; box < kBoxes; ++box)
    sm90::tma_load_4d(dst + box * kTileRows * kCols * (kInt8 ? 1 : 2), map, bar, box * kCols, h,
                      row, b);
}

// The producer thread: the Q tile at (qh, q_row, qb) of q_map once (for
// kBwdDq with the dO tile at the same place of do_map, on the same
// barrier), then key tiles it = 0 .. n_tiles - 1, K at (kh, it * 128, kb)
// of k_map and V at (vh, it * 128, vb) of v_map, each into stage
// it % kStages once the consumers have released it (kScoresInt8V8: V as
// int8 into the int8 V stage, for the converters).
template <int D, int kForm = kScoresBf16>
__device__ __forceinline__ void produce(const Tiles& t, const CUtensorMap* q_map, int qh,
                                        int q_row, int qb, const CUtensorMap* k_map, int kh,
                                        int kb, const CUtensorMap* v_map, int vh, int vb,
                                        int n_tiles, const CUtensorMap* do_map = nullptr) {
  using L = Smem<D, kForm>;
  constexpr int kS = L::kStages;
  sm90::prefetch_tensor_map(q_map);
  sm90::prefetch_tensor_map(k_map);
  sm90::prefetch_tensor_map(v_map);
  if constexpr (kForm == kBwdDq) {
    sm90::prefetch_tensor_map(do_map);
    sm90::mbar_arrive_expect_tx(t.q_full, 2 * L::kQTile);
    load_tile<D, false>(t.dos, do_map, t.q_full, qh, q_row, qb);
  } else {
    sm90::mbar_arrive_expect_tx(t.q_full, L::kQTile);
  }
  load_tile<D, L::kQ8In>(t.qs, q_map, t.q_full, qh, q_row, qb);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&t.empty[s], ((it / kS) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&t.k_full[s], L::kKTile);
    load_tile<D, L::kS8>(t.ks + s * L::kKTile, k_map, &t.k_full[s], kh, it * kRows, kb);
    if constexpr (L::kV8) {
      sm90::mbar_arrive_expect_tx(&t.v8_full[s], L::kV8Tile);
      load_tile<D, true>(t.v8s + s * L::kV8Tile, v_map, &t.v8_full[s], vh, it * kRows, vb);
    } else {
      sm90::mbar_arrive_expect_tx(&t.v_full[s], L::kVTile);
      load_tile<D, false>(t.vs + s * L::kVTile, v_map, &t.v_full[s], vh, it * kRows, vb);
    }
  }
}

// 4 int8 values (value j in byte j of w) -> 4 bf16 in two words (value 0 in
// the low half of the first), exactly and without a conversion
// instruction: byte j, biased by 128 (x ^ 0x80), becomes the low byte of
// the float 2^23 + x + 128 (one byte permute), one FADD takes off
// 2^23 + 128, and a float that holds an integer of magnitude <= 128 has its
// low 16 bits zero, so its high half, picked by a second permute, is its
// bf16.
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) -
                           8388736.0f);  // 2^23 + 128
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// kScoresInt8V8, converter c (0 .. kConverters - 1): key tiles
// it = 0 .. n_tiles - 1, the int8 V tile of stage it % kStages (D bytes a
// row under a D-byte swizzle, as TMA stores it) into the bf16 V stage as a
// bf16 TMA box would hold it (64-column boxes, 128-byte swizzle: the layout
// softmax_pv reads through the transpose bit), 16 columns at a time. The
// bf16 stage is free when the int8 tile has landed: the producer issued
// that load only after the consumers had released the stage (empty), and
// the wait below repeats that wait, which has completed, for the ordering.
// Each converter fences its writes for wgmma's proxy and arrives on
// v_full.
template <int D>
__device__ __forceinline__ void convert_v(const Tiles& t, int c, int n_tiles) {
  using L = Smem<D, kScoresInt8V8>;
  constexpr int kS = L::kStages;
  constexpr int kChunks = D / 16;  // 16-byte int8 chunks a row
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    const uint32_t parity = (it / kS) & 1;
    sm90::mbar_wait(&t.v8_full[s], parity);
    sm90::mbar_wait(&t.empty[s], parity ^ 1);
    const uint8_t* src = t.v8s + s * L::kV8Tile;
    uint8_t* dst = t.vs + s * L::kVTile;
#pragma unroll 2
    for (int i = c; i < kRows * kChunks; i += kConverters) {
      const int r = i / kChunks, ch = i % kChunks;
      const uint4 x = *reinterpret_cast<const uint4*>(src + sm90::swizzled<D>(r * D + ch * 16));
      const uint2 a = s8x4_to_bf16x4(x.x), b = s8x4_to_bf16x4(x.y);
      const uint2 e = s8x4_to_bf16x4(x.z), f = s8x4_to_bf16x4(x.w);
      // bf16 columns 16 ch .. 16 ch + 15: box ch / 4, bytes 32 (ch % 4) of row r
      uint8_t* box = dst + (ch / 4) * kBoxBytes;
      const uint32_t off = r * 128 + (ch % 4) * 32;
      *reinterpret_cast<uint4*>(box + sm90::swizzled<128>(off)) = make_uint4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<uint4*>(box + sm90::swizzled<128>(off + 16)) =
          make_uint4(e.x, e.y, f.x, f.y);
    }
    sm90::fence_proxy_async_shared();
    sm90::mbar_arrive(&t.v_full[s]);
  }
}

// kScoresInt8QIn, consumer warpgroup wg: its 64 rows of the bf16 Q tile
// (loaded, the caller has waited) to round(q * qinv), half to even,
// clipped to +-127 (rows the scale did not see may exceed it), into the
// int8 Q tile in the layout the score product reads. q8 (a test hook):
// null, or where row r of the tile goes (row stride q8_sn bytes, rows
// below n_rows). Ends with the warpgroup's writes visible to wgmma.
template <int D>
__device__ __forceinline__ void quantise_q(const Tiles& t, int wg, float qinv, int8_t* q8,
                                           long long q8_sn, int n_rows) {
  constexpr int kGroups = D / 4;  // 4-value groups a row
  const int tid = threadIdx.x % 128;
#pragma unroll 4
  for (int i = tid; i < 64 * kGroups; i += 128) {
    const int r = wg * 64 + i / kGroups, c = (i % kGroups) * 4;
    // 4 bf16 values, 8 bytes inside one 16-byte chunk of the swizzled row
    const uint2 x = *reinterpret_cast<const uint2*>(
        t.qs + (c / 64) * kBoxBytes + sm90::swizzled<128>(r * 128 + (c % 64) * 2));
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = j < 2 ? x.x : x.y;
      const float q = __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));  // exact
      int v8 = __float2int_rn(__fmul_rn(q, qinv));
      v8 = max(-127, min(127, v8));
      packed |= (static_cast<uint32_t>(v8) & 0xffu) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(t.qa + sm90::swizzled<D>(r * D + c)) = packed;
    if (q8 != nullptr && r < n_rows) *reinterpret_cast<uint32_t*>(q8 + r * q8_sn + c) = packed;
  }
  sm90::fence_proxy_async_shared();
  sm90::bar_sync<128>(1 + wg);
}

// The softmax of one tile's scores sc (keys past n_eff already at -1e30)
// into the state, in units that scale_log2 takes to log2 units, then
// O += P V from stage s; releases the stage. acc is the m64nD accumulator
// of O, m_run the running max of the thread's two rows in log2 units,
// l_run the thread's share of their row sums.
template <int D, bool kBounded, int kForm>
__device__ __forceinline__ void softmax_pv(const Tiles& t, int s, uint32_t parity,
                                           float (&sc)[64], float scale_log2,
                                           float (&acc)[D / 2], float (&m_run)[2],
                                           float (&l_run)[2]) {
  using L = Smem<D, kForm>;
  const uint8_t* vt = t.vs + s * L::kVTile;
  if (kBounded) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = sm90::exp2_ftz(fminf(sc[i] * scale_log2, kClampLog2));
      l_run[(i >> 1) & 1] += sc[i];
    }
  } else {
    // the row max of the raw scores, scaled after (the scale is >= 0)
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
    const uint64_t dv = sm90::desc_sw<128>(vt + kk * 16 * 128, kBoxBytes, 1024);
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

// Consumer warpgroup wg, thread tq of its quad, bf16 scores: key tile `it`
// (keys from it * 128) into the softmax state (see softmax_pv). Keys at or
// past n_eff are masked (in the last tile only); the raw scores' scale
// into log2 units is folded into the exponent's argument. The caller has
// waited for Q.
template <int D, bool kBounded>
__device__ __forceinline__ void consume_tile(const Tiles& t, int wg, int tq, int it, int n_eff,
                                             float scale_log2, float (&acc)[D / 2],
                                             float (&m_run)[2], float (&l_run)[2]) {
  using L = Smem<D>;
  constexpr int kS = L::kStages;
  const int s = it % kS;
  const uint32_t parity = (it / kS) & 1;
  const uint8_t* kt = t.ks + s * L::kKTile;

  // S = Q K^T: 64 rows x 128 keys, D / 16 steps
  float sc[64];
  sm90::mbar_wait(&t.k_full[s], parity);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    sm90::wgmma_ss_m64n128k16(sc, sm90::desc_sw<128>(t.qa + off + wg * 64 * 128, 16, 1024),
                              sm90::desc_sw<128>(kt + off, 16, 1024), kk > 0);
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
  softmax_pv<D, kBounded, kScoresBf16>(t, s, parity, sc, scale_log2, acc, m_run, l_run);
}

// The same step with int8 scores (kForm kScoresInt8, kScoresInt8QIn or
// kScoresInt8V8): scale_log2 is the head's dequantising scalar c times
// log2(e).
template <int D, bool kBounded, int kForm>
__device__ __forceinline__ void consume_tile_s8(const Tiles& t, int wg, int tq, int it,
                                                int n_eff, float scale_log2,
                                                float (&acc)[D / 2], float (&m_run)[2],
                                                float (&l_run)[2]) {
  static_assert(Smem<D, kForm>::kS8, "int8 forms only");
  using L = Smem<D, kForm>;
  constexpr int kS = L::kStages;
  const int s = it % kS;
  const uint32_t parity = (it / kS) & 1;
  const uint8_t* kt = t.ks + s * L::kKTile;

  // S = Q K^T: 64 rows x 128 keys, D / 32 steps of 32 bytes along the
  // D-byte rows; 8-row groups 8 D bytes apart
  uint32_t si[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) si[i] = kScoreBias;
  sm90::mbar_wait(&t.k_full[s], parity);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    sm90::wgmma_ss_m64n128k32_s8(si, sm90::desc_sw<D>(t.qa + wg * 64 * D + kk * 32, 16, 8 * D),
                                 sm90::desc_sw<D>(kt + kk * 32, 16, 8 * D));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(si);
  float sc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = __uint_as_float(si[i]) - kScoreBiasF;  // exact

  // the last tile: scaled, then keys at or past n_eff masked
  const int k0 = it * kRows;
  if (k0 + kRows > n_eff) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      sc[i] = k0 + (i / 4) * 8 + tq * 2 + (i & 1) >= n_eff ? kNegInf : sc[i] * scale_log2;
    scale_log2 = 1.f;
  }
  softmax_pv<D, kBounded, kForm>(t, s, parity, sc, scale_log2, acc, m_run, l_run);
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
