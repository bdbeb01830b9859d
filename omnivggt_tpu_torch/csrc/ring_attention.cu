// Fused ring flash attention for Hopper (sm_90a): the sequence is sharded
// over n ranks, every rank keeps its query shard and a two-slot K/V ring
// buffer, and the K/V shards rotate from each rank's buffer into its right
// neighbour's while the rank attends to the shard it holds. Plain C
// interface, loaded with ctypes from
// omnivggt_tpu_torch/ops/kernels/ring_attention.py.
//
// Replaces two TPU kernels of omnivggt_tpu/ops/pallas/ring_attention.py:
//   - _ring_kernel (ring buffer and the softmax state of one query chunk on
//     chip, one whole rotation per query chunk, via ring_flash_attention);
//   - _ring_hbm_kernel (ring buffer in device memory, K/V tiles streamed,
//     state for the whole shard, one rotation whatever the shard length,
//     ragged shards masked, via ring_flash_attention_hbm).
// Both run the same kernels here. What told them apart on the TPU is where
// the ring buffer and the (m, l, acc) state fit; on this card both live in
// device memory (the state is read at the start of a ring step and
// written at its end, fp32), so the difference that is left, the first
// kernel's query chunks with one ring pass each, is a row range
// [q0, q0 + q_rows) that the Python wrappers choose.
//
// One ring pass is n + 1 launches on one stream:
//   - ring_stage copies every rank's own K and V shard from the strided
//     (B, nl, H, D) input into slot 0 of its buffer, head-major
//     (2 slots, [k | v], B*H, nl, D);
//   - one step launch for each step s = 0 .. n-1, with the ranks as the
//     grid's z axis. Its first n_copy blocks of every (head, rank) are the
//     rotation: they copy slot s % 2 of rank r into slot (s + 1) % 2 of
//     rank (r + 1) % n with 16-byte vector loads and stores, and are
//     scheduled ahead of the compute blocks of the same (head, rank), so
//     the transfer rides under the step's products as the TPU's RDMA does.
//     The other blocks attend their query rows to slot s % 2 of their own
//     rank. Nobody reads slot (s + 1) % 2 during step s, and the launch
//     boundary is what the TPU kernel's send, receive and capacity
//     semaphores are: no block ever waits on another, so nothing can hang
//     (at the flagship a step is 4 ranks x 16 heads x 22 query tiles =
//     1,408 blocks, far more than can be resident at once). The last step
//     issues no copy.
// Every rank's q, o, state and buffer are reached through per-rank base
// pointers (and, for the bf16 forms, per-rank tensor maps encoded on the
// host at every call), so a buffer mapped from another card can stand in
// for a neighbour's slot without a change here.
//
// Two designs share this file.
//
// The bf16 forms (the main path: ring_flash_attention at the 224 px
// shards, ring_flash_attention_hbm at the flagship's) run ring_step_tma,
// whose compute blocks are the bf16 forward kernel's tile
// (attend_sm90.cuh, also run by flash_attention.cu):
//   - 128 query rows of one (rank, batch, head) a block, two consumer
//     warpgroups of 64 rows and a producer warpgroup whose one thread
//     issues every TMA load (setmaxnreg 24 / 240), 384 threads;
//   - Q by TMA once per block through the rank's map over its strided
//     shard ((B, nl, H, D): rows past nl read as zeros); 128-key K and V
//     tiles of the slot held at this step through the rank's map over its
//     buffer viewed as (4 B H, nl, 1, D), streamed through a 3-stage
//     (D = 64) / 2-stage (D = 128) ring; no thread stages or transposes a
//     tile;
//   - S = Q K^T by wgmma SS, the softmax in registers with the folded
//     exponent, P rounded to bf16 and packed in place as the A fragment,
//     O += P V by wgmma RS through the transpose bit;
//   - keys at or past nl (the tail of the last 128-key tile of a ragged
//     shard; at the flagship 2748 = 21 x 128 + 60) scored -1e30 in every
//     rotating shard; TMA's zero fill covers the rows themselves;
//   - the (m, l, acc) fp32 state in device memory between the steps: read
//     at the start of a step (except the first) and written at its end
//     (except the last). acc keeps the accumulator fragment's own register
//     order, so each thread moves its share as 16-byte vectors and a warp's
//     access is contiguous; l is summed over the quad before it is stored
//     and held by one thread of the quad after it is loaded; the last step
//     divides by l (guarded: a row whose every key was masked has l = 0)
//     and stores bf16 rows below the pass's end.
// The tensor maps travel in the kernel's parameters (2 x 16 maps of 128
// bytes, about 4.7 KB in all, inside the 32,764 bytes CUDA 12.1 allows).
//
// The int8 forms keep the first design, ring_tile: 4 warps of 16 query
// rows a block, mma.sync m16n8k32 s8 scores from int8 tiles staged by
// threads, the softmax and P @ V on mma.sync m16n8k16 with V converted
// from int8 to bf16 (exactly) as it is transposed into shared memory, the
// state as fp32 rows; the final multiplier folds in the head's v scale.
// They move onto wgmma with the int8 head-major form (s8 wgmma, m64nNk32).
//
// What bounds it on this card: as the bf16 forward, two matrix products
// per (query, key) tile, 4 N^2 D FLOPs per head over all ranks (0.50 ms of
// bf16 tensor work at the flagship's (1, 10992, 16, 64)); the ring adds
// bytes, not operations: the rotation ((n - 1) shards of K and V read and
// written, 270 MB at the flagship), the state (read and written between
// the steps, about 280 MB over 4 ranks) and the staging copy (~90 MB),
// about 0.19 ms at 3.35 TB/s, under the products. Bounded mode (fixed max
// 0, exp(min(s, 80))) makes p independent of the tiling, so the bf16
// bounded ring differs from the head-major kernel only by the order of its
// fp32 sums.

#include "attend_sm90.cuh"

namespace {

using namespace flash;

constexpr int kMaxRanks = 16;

// ---- the rotation and the staging copy, both designs --------------------

// slot `slot`, part kv (0 k, 1 v) of head bh in a rank's ring buffer
__device__ __forceinline__ char* slot_ptr(void* buffer, int slot, int kv, int bhn, int bh,
                                          long long head_bytes) {
  return static_cast<char*>(buffer) + (((long long)slot * 2 + kv) * bhn + bh) * head_bytes;
}

// the rotation: block `block` of n_copy copies its stripe of head bh's K
// and V, slot `cur` of rank r -> slot cur ^ 1 of its right neighbour, with
// every thread of the block and four 16-byte loads in flight a thread
__device__ __forceinline__ void rotate_stripe(void* const* slots, int r, int n_ranks, int cur,
                                              int bhn, int bh, long long head_bytes, int block,
                                              int n_copy) {
  const int right = (r + 1) % n_ranks;
  const long long vecs = head_bytes / 16;
  const long long stride = (long long)n_copy * blockDim.x;
  for (int kv = 0; kv < 2; ++kv) {
    const uint4* __restrict__ src =
        reinterpret_cast<const uint4*>(slot_ptr(slots[r], cur, kv, bhn, bh, head_bytes));
    uint4* __restrict__ dst =
        reinterpret_cast<uint4*>(slot_ptr(slots[right], cur ^ 1, kv, bhn, bh, head_bytes));
    for (long long i = (long long)block * blockDim.x + threadIdx.x; i < vecs; i += 4 * stride) {
      uint4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * stride < vecs) x[u] = src[i + u * stride];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * stride < vecs) dst[i + u * stride] = x[u];
    }
  }
}

struct RingParams {
  const void* q[kMaxRanks];     // rank's q shard, strided (B, nl, H, D): int8
  const void* k[kMaxRanks];     // rank's own k shard, same layout (staging only)
  const void* v[kMaxRanks];
  __nv_bfloat16* o[kMaxRanks];  // rank's output shard, strided (B, nl, H, D)
  void* slots[kMaxRanks];       // rank's ring buffer (2, 2, B*H, nl, D), k/v dtype
  float* acc[kMaxRanks];        // (B*H, q_rows, D) fp32 numerator
  float* ml[kMaxRanks];         // (2, B*H, q_rows) fp32: running max (log2 units), row sum
  const float* c[kMaxRanks];    // int8: (B*H, 2): q_s k_s D^-0.5, v_s
  long long q_sb, q_sn, q_sh;   // element strides, each of its own type
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int B, H, nl;        // nl: keys (and query rows) per rank
  int q0, q_rows;      // this pass attends query rows [q0, q0 + q_rows)
  int n_ranks, step;
  int n_copy;          // rotation blocks per (head, rank); 0: no rotation
};

// Every rank's own K and V shard -> slot 0 of its buffer, head-major: grid
// (64-row tiles, B*H, ranks). Counterpart of the TPU kernels' first copies
// (kv_buf[0] = k_ref, v_ref; cp_k, cp_v).
template <int D>
__global__ void __launch_bounds__(kThreads) ring_stage(const __grid_constant__ RingParams p,
                                                       int esize) {
  const int r = blockIdx.z, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row0 = blockIdx.x * kBlockK;
  const int vecs = D * esize / 16;  // 16-byte vectors per row
  const long long head_bytes = (long long)p.nl * D * esize;
  for (int kv = 0; kv < 2; ++kv) {
    const char* src = static_cast<const char*>(kv ? p.v[r] : p.k[r]);
    const long long sb = kv ? p.v_sb : p.k_sb, sn = kv ? p.v_sn : p.k_sn,
                    sh = kv ? p.v_sh : p.k_sh;
    src += (b * sb + h * sh) * esize;
    char* dst = slot_ptr(p.slots[r], 0, kv, p.B * p.H, bh, head_bytes);
    for (int i = threadIdx.x; i < kBlockK * vecs; i += kThreads) {
      const int row = row0 + i / vecs, c = (i % vecs) * 16;
      if (row < p.nl)
        *reinterpret_cast<uint4*>(dst + (long long)row * D * esize + c) =
            *reinterpret_cast<const uint4*>(src + (long long)row * sn * esize + c);
    }
  }
}

// ---- bf16: TMA + wgmma ------------------------------------------------------

struct RingTmaParams {
  CUtensorMap q_map[kMaxRanks];     // rank's q shard as (D, H, nl, B)
  CUtensorMap slot_map[kMaxRanks];  // rank's ring buffer as (D, 1, nl, 4 B H)
  __nv_bfloat16* o[kMaxRanks];      // rank's output shard, strided (B, nl, H, D)
  void* slots[kMaxRanks];           // rank's ring buffer (2, 2, B*H, nl, D)
  float* acc[kMaxRanks];            // (B*H, q_tiles, D / 8, 256, 4): fragment order
  float* ml[kMaxRanks];             // (2, B*H, q_tiles * 128): running max (log2), row sum
  long long o_sb, o_sn, o_sh;
  int B, H, nl;
  int q0, q_rows, q_tiles;  // this pass: rows [q0, q0 + q_rows), q_tiles 128-row tiles
  int n_ranks, step;
  int n_copy;         // rotation blocks per (head, rank); 0: no rotation
  int kv_tiles;       // key tiles a shard: ceil(nl / 128) (one fewer: a planted fault)
  int kv_head_shift;  // 0; a test hook that plants a fault (K and V of head (h + shift) % H)
  float scale_log2;   // D^-0.5 * log2(e)
};
static_assert(sizeof(RingTmaParams) <= 32764, "the kernel-parameter limit of CUDA 12.1");

// One compute block: query tile `tile` of the pass (128 rows from
// q0 + 128 tile) of head h of batch b of rank r, against the shard in
// slot step % 2, the state carried in and out through device memory.
template <int D, bool kBounded>
__device__ __forceinline__ void ring_attend(const RingTmaParams& p, int r, int b, int h,
                                            int tile) {
  const attend::Tiles t = attend::carve_tiles<D>();
  const int bhn = p.B * p.H, bh = b * p.H + h;
  const int row0 = p.q0 + tile * attend::kRows;

  const int wg = threadIdx.x / 128;
  if (wg == attend::kConsumers) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * attend::kConsumers) {
      const int cur = p.step & 1;
      const int kv_bh = b * p.H + (h + p.kv_head_shift) % p.H;
      attend::produce<D>(t, &p.q_map[r], h, row0, b, &p.slot_map[r], 0, (2 * cur) * bhn + kv_bh,
                         &p.slot_map[r], 0, (2 * cur + 1) * bhn + kv_bh, p.kv_tiles);
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) >> 2, tq = tid & 3;
  const int row_in = wg * 64 + (tid / 32) * 16 + g;  // rows row_in, row_in + 8 of the tile
  const bool first = p.step == 0, last = p.step == p.n_ranks - 1;

  // this thread's state: its accumulator fragment as D / 8 float4, and the
  // m and l of its two rows
  float4* a_state = reinterpret_cast<float4*>(p.acc[r]) +
                    ((long long)bh * p.q_tiles + tile) * (D / 8) * 256 + wg * 128 + tid;
  const long long srow = (long long)bh * p.q_tiles * attend::kRows + tile * attend::kRows + row_in;
  float* m_state = p.ml[r];
  float* l_state = p.ml[r] + (long long)bhn * p.q_tiles * attend::kRows;

  float acc[D / 2];
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  if (first) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float4 x = a_state[j * 256];
      acc[4 * j] = x.x;
      acc[4 * j + 1] = x.y;
      acc[4 * j + 2] = x.z;
      acc[4 * j + 3] = x.w;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!kBounded) m_run[rr] = m_state[srow + 8 * rr];
      if (tq == 0) l_run[rr] = l_state[srow + 8 * rr];  // the row sum, held by one thread of the quad
    }
  }

  sm90::mbar_wait(t.q_full, 0);
  for (int it = 0; it < p.kv_tiles; ++it)
    attend::consume_tile<D, kBounded>(t, wg, tq, it, p.nl, p.scale_log2, acc, m_run, l_run);
  attend::quad_sum(l_run);

  if (last) {
    const float inv[2] = {l_run[0] > 0.f ? 1.f / l_run[0] : 0.f,
                          l_run[1] > 0.f ? 1.f / l_run[1] : 0.f};
    attend::store_rows<D>(p.o[r] + b * p.o_sb + h * p.o_sh, p.o_sn, acc, inv, row0 + row_in,
                          p.q0 + p.q_rows, tq);
    return;
  }
  // rows past the pass's end keep a state nobody reads (the buffer has
  // q_tiles whole tiles)
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    a_state[j * 256] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  if (tq == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!kBounded) m_state[srow + 8 * rr] = m_run[rr];
      l_state[srow + 8 * rr] = l_run[rr];
    }
  }
}

// One ring step for every rank, bf16: grid (n_copy + q_tiles, B*H, ranks),
// 384 threads. Counterpart of one iteration of the step loop of
// _ring_kernel and of _ring_hbm_kernel.
template <int D, bool kBounded>
__global__ void __launch_bounds__(attend::kThreads, 1)
    ring_step_tma(const __grid_constant__ RingTmaParams p) {
  const int r = blockIdx.z, bh = blockIdx.y;
  if (static_cast<int>(blockIdx.x) < p.n_copy) {
    rotate_stripe(p.slots, r, p.n_ranks, p.step & 1, p.B * p.H, bh, (long long)p.nl * D * 2,
                  blockIdx.x, p.n_copy);
    return;
  }
  ring_attend<D, kBounded>(p, r, bh / p.H, bh % p.H, blockIdx.x - p.n_copy);
}

// ---- int8: mma.sync -----------------------------------------------------------

// int8 rows [row0, row0 + 64) of a (rows, D) matrix, converted to bf16 and
// stored transposed: dst[d][r], kBlockK + kPad columns; rows at or past
// n_valid become zeros
template <int D>
__device__ __forceinline__ void load_rows_transposed_s8(__nv_bfloat16* dst, const int8_t* src,
                                                        long long row_stride, int row0,
                                                        int n_valid) {
  constexpr int kVecs = D / 16;
  for (int i = threadIdx.x; i < kBlockK * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      dst[(c + j) * (kBlockK + kPad) + r] = __float2bfloat16(static_cast<float>(e[j]));
  }
}

// One compute block: 64 query rows of head h of batch b of rank r, starting
// at shard row row0, against the int8 shard in slot step % 2.
template <int D, bool kBounded>
__device__ __forceinline__ void ring_tile(const RingParams& p, int r, int b, int h, int row0) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 vt[D * (kBlockK + kPad)];
  int8_t* ks8 = reinterpret_cast<int8_t*>(ks);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int bh = b * p.H + h;
  const int q_end = p.q0 + p.q_rows;
  const bool first = p.step == 0, last = p.step == p.n_ranks - 1;

  uint32_t qf8[D / 32][4];
  const int8_t* qb = static_cast<const int8_t*>(p.q[r]) + b * p.q_sb + h * p.q_sh;
  load_rows_s8<D>(ks8, qb, p.q_sn, row0, q_end);
  __syncthreads();
  load_a_fragments_s8<D>(qf8, ks8, r0, t);
  __syncthreads();
  const float score_mul = p.c[r][bh * 2] * kLog2e;

  // the state of this thread's two rows (g and g + 8 of the warp's 16)
  float acc[D / 8][4];
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  long long srow[2];
  bool valid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + r0 + 8 * rr;
    valid[rr] = row < q_end;
    srow[rr] = (long long)bh * p.q_rows + (row - p.q0);
  }
  float* m_state = p.ml[r];
  float* l_state = p.ml[r] + (long long)p.B * p.H * p.q_rows;
  if (!first) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!valid[rr]) continue;
      if (!kBounded) m_run[rr] = m_state[srow[rr]];
      if (t == 0) l_run[rr] = l_state[srow[rr]];  // the row sum, held by one thread of the quad
      const float* a = p.acc[r] + srow[rr] * D + t * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(a + n * 8);
        acc[n][2 * rr] = x.x;
        acc[n][2 * rr + 1] = x.y;
      }
    }
  }

  const long long head_bytes = (long long)p.nl * D;
  const int8_t* k_slab = reinterpret_cast<const int8_t*>(
      slot_ptr(p.slots[r], p.step & 1, 0, p.B * p.H, bh, head_bytes));
  const int8_t* v_slab = reinterpret_cast<const int8_t*>(
      slot_ptr(p.slots[r], p.step & 1, 1, p.B * p.H, bh, head_bytes));
  const int n_eff = p.nl;

  for (int k0 = 0; k0 < n_eff; k0 += kBlockK) {
    load_rows_s8<D>(ks8, k_slab, D, k0, n_eff);
    load_rows_transposed_s8<D>(vt, v_slab, D, k0, n_eff);
    __syncthreads();

    float s[kBlockK / 8][4];
    mma_rows_by_tile_s8<D>(s, qf8, ks8, g, t);

    // log2 units; keys past the shard's end (a ragged shard's tail) masked
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        const float x = col < n_eff ? s[j][e] * score_mul : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }

    if (kBounded) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(fminf(s[j][e], kClampLog2));
          s[j][e] = pe;
          l_run[e >> 1] += pe;
        }
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float m_new = fmaxf(m_run[rr], mx[rr]);
        corr[rr] = exp2f(m_run[rr] - m_new);
        m_run[rr] = m_new;
        l_run[rr] *= corr[rr];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[j][e] - m_run[e >> 1]);
          s[j][e] = pe;
          l_run[e >> 1] += pe;
        }
      }
    }

    mma_scores_by_tile<D>(acc, s, vt, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
  }

  if (last) {
    // divide only now; the v scale folds into the same multiplier
    const float v_scale = p.c[r][bh * 2 + 1];
    float mul[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) mul[rr] = (l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f) * v_scale;
    store_rows<D>(p.o[r] + b * p.o_sb + h * p.o_sh, p.o_sn, acc, mul[0], mul[1], row0 + r0,
                  q_end, t);
    return;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!valid[rr]) continue;
    if (t == 0) {
      if (!kBounded) m_state[srow[rr]] = m_run[rr];
      l_state[srow[rr]] = l_run[rr];
    }
    float* a = p.acc[r] + srow[rr] * D + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(a + n * 8) = make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
  }
}

// One ring step for every rank, int8: grid (n_copy + 64-row query tiles,
// B*H, ranks), 128 threads.
template <int D, bool kBounded>
__global__ void __launch_bounds__(kThreads) ring_step(const __grid_constant__ RingParams p) {
  const int r = blockIdx.z, bh = blockIdx.y;
  if (static_cast<int>(blockIdx.x) < p.n_copy) {
    rotate_stripe(p.slots, r, p.n_ranks, p.step & 1, p.B * p.H, bh, (long long)p.nl * D,
                  blockIdx.x, p.n_copy);
    return;
  }
  const int tile = blockIdx.x - p.n_copy;
  ring_tile<D, kBounded>(p, r, bh / p.H, bh % p.H, p.q0 + tile * kBlockQ);
}

// rotation blocks per (head, rank): one per eight query tiles, so the copy
// takes a small share of the step's blocks and ends before they do
int copy_blocks(int q_tiles) { return q_tiles / 8 > 0 ? q_tiles / 8 : 1; }

template <int D, bool kBounded>
cudaError_t run_pass_int8(RingParams& p, int skip_rotation_at, cudaStream_t stream) {
  const int q_tiles = (p.q_rows + kBlockQ - 1) / kBlockQ;
  const int bh = p.B * p.H;
  ring_stage<D><<<dim3((p.nl + kBlockK - 1) / kBlockK, bh, p.n_ranks), kThreads, 0, stream>>>(
      p, 1);
  cudaError_t err = cudaGetLastError();
  for (int step = 0; step < p.n_ranks && err == cudaSuccess; ++step) {
    p.step = step;
    p.n_copy = (step + 1 < p.n_ranks && step != skip_rotation_at) ? copy_blocks(q_tiles) : 0;
    ring_step<D, kBounded><<<dim3(p.n_copy + q_tiles, bh, p.n_ranks), kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <int D, bool kBounded>
cudaError_t run_pass_tma(const RingParams& stage, RingTmaParams& p, int skip_rotation_at,
                         cudaStream_t stream) {
  const int bh = p.B * p.H;
  const int bytes = attend::Smem<D>::kAlloc;
  ring_stage<D><<<dim3((p.nl + kBlockK - 1) / kBlockK, bh, p.n_ranks), kThreads, 0, stream>>>(
      stage, 2);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_step_tma<D, kBounded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  for (int step = 0; step < p.n_ranks && err == cudaSuccess; ++step) {
    p.step = step;
    p.n_copy = (step + 1 < p.n_ranks && step != skip_rotation_at) ? copy_blocks(p.q_tiles) : 0;
    ring_step_tma<D, kBounded>
        <<<dim3(p.n_copy + p.q_tiles, bh, p.n_ranks), attend::kThreads, bytes, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// One ring pass over query rows [q0, q0 + q_rows) of every rank's shard:
// the staging launch, then n_ranks step launches, on `stream`.
// q, k, v, o, slots, acc, ml, c: arrays of n_ranks device pointers (c null
// unless int8). slots: (2, 2, B*H, nl, D) in the k/v dtype. acc, ml: the
// state, fp32, of (B*H, ceil(q_rows / 128) * 128, D) and
// (2, B*H, ceil(q_rows / 128) * 128) elements at least (their layout is
// the kernel's own). strides: 12 element strides, (batch, token, head) of
// q, k, v, o in turn, each counting elements of its own type; rows must
// start on 16-byte boundaries.
// skip_rotation_at: -1, or a step whose rotation is left out (a planted
// fault for the checks: the ranks then read a stale slot).
// kv_head_shift, drop_last_key_tile: 0 on every real call; test hooks of
// the bf16 forms that plant a fault (K and V read from head
// (h + shift) % H; the last key tile of every shard left out).
// Returns the cudaError_t of the first launch that failed (0 = launched).
extern "C" int omnivggt_ring_attention(
    int bounded, int head_dim, int int8, const void* const* q, const void* const* k,
    const void* const* v, void* const* o, void* const* slots, void* const* acc,
    void* const* ml, const void* const* c, const long long* strides, int B, int H, int nl,
    int q0, int q_rows, int n_ranks, int skip_rotation_at, float scale, void* stream,
    int kv_head_shift, int drop_last_key_tile) {
  if (n_ranks < 1 || n_ranks > kMaxRanks || nl < 1 || q_rows < 1 || q0 < 0 ||
      q0 + q_rows > nl || (int8 && c == nullptr) || B * H > 65535 ||
      (head_dim != 64 && head_dim != 128) ||
      (int8 && (kv_head_shift != 0 || drop_last_key_tile != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  RingParams p;
  for (int r = 0; r < n_ranks; ++r) {
    p.q[r] = q[r];
    p.k[r] = k[r];
    p.v[r] = v[r];
    p.o[r] = static_cast<__nv_bfloat16*>(o[r]);
    p.slots[r] = slots[r];
    p.acc[r] = static_cast<float*>(acc[r]);
    p.ml[r] = static_cast<float*>(ml[r]);
    p.c[r] = int8 ? static_cast<const float*>(c[r]) : nullptr;
  }
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.nl = nl; p.q0 = q0; p.q_rows = q_rows;
  p.n_ranks = n_ranks; p.step = 0; p.n_copy = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (int8) {
    cudaError_t err = cudaErrorInvalidValue;
    if (head_dim == 64)
      err = bounded ? run_pass_int8<64, true>(p, skip_rotation_at, s)
                    : run_pass_int8<64, false>(p, skip_rotation_at, s);
    else
      err = bounded ? run_pass_int8<128, true>(p, skip_rotation_at, s)
                    : run_pass_int8<128, false>(p, skip_rotation_at, s);
    return static_cast<int>(err);
  }

  // the bf16 forms: one q map and one buffer map per rank, encoded now
  RingTmaParams t;
  const long long row = head_dim;  // a buffer row: one key of one head
  for (int r = 0; r < n_ranks; ++r) {
    if (!sm90::encode_bnhd_map(&t.q_map[r], q[r], B, nl, H, head_dim, strides[0], strides[1],
                               strides[2], attend::kRows) ||
        !sm90::encode_bnhd_map(&t.slot_map[r], slots[r], 4 * B * H, nl, 1, head_dim,
                               (long long)nl * row, row, row, attend::kRows))
      return static_cast<int>(cudaErrorInvalidValue);
    t.o[r] = p.o[r];
    t.slots[r] = slots[r];
    t.acc[r] = p.acc[r];
    t.ml[r] = p.ml[r];
  }
  t.o_sb = p.o_sb; t.o_sn = p.o_sn; t.o_sh = p.o_sh;
  t.B = B; t.H = H; t.nl = nl;
  t.q0 = q0; t.q_rows = q_rows; t.q_tiles = (q_rows + attend::kRows - 1) / attend::kRows;
  t.n_ranks = n_ranks; t.step = 0; t.n_copy = 0;
  t.kv_tiles = (nl + attend::kRows - 1) / attend::kRows - (drop_last_key_tile ? 1 : 0);
  t.kv_head_shift = ((kv_head_shift % H) + H) % H;
  t.scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (head_dim == 64)
    err = bounded ? run_pass_tma<64, true>(p, t, skip_rotation_at, s)
                  : run_pass_tma<64, false>(p, t, skip_rotation_at, s);
  else
    err = bounded ? run_pass_tma<128, true>(p, t, skip_rotation_at, s)
                  : run_pass_tma<128, false>(p, t, skip_rotation_at, s);
  return static_cast<int>(err);
}
