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
// pointers and per-rank tensor maps encoded on the host at every call, so a
// buffer mapped from another process can stand in for a neighbour's slot
// without a change here. That is the process form (the seq axis over
// processes, one rank each, on one card or several): a launch covers only
// the ranks [rank0, rank0 + n_local) of this process (grid z), its pointer
// tables hold its own q, k, v, o, state and slots and, for the rotation,
// the right neighbour's slots mapped into this process through CUDA IPC
// (parallel/peer.py). omnivggt_ring_attention_step launches the staging
// copy or one step alone, so that the host puts the step boundary between
// launches: a stream sync and a barrier of the processes, the TPU kernel's
// ready_sem handshake done on the host. No block waits on another process
// inside a launch, so processes that time-slice one card cannot deadlock.
//
// Every step runs ring_step_tma, whose compute blocks are the forward
// kernel's tile (attend_sm90.cuh, also run by flash_attention.cu), in two
// forms: bf16 (the main path: ring_flash_attention at the 224 px shards,
// ring_flash_attention_hbm at the flagship's) and int8 (qk_int8: q, k and
// v on the int8 grids of quant_ring, the ring buffer int8, so the rotation
// moves half the bytes):
//   - 128 query rows of one (rank, batch, head) a block, two consumer
//     warpgroups of 64 rows and a producer warpgroup whose one thread
//     issues every TMA load, 384 threads (setmaxnreg 24 / 240; int8 40 /
//     232, for the converters below);
//   - Q by TMA once per block through the rank's map over its strided
//     shard ((B, nl, H, D): rows past nl read as zeros); 128-key K and V
//     tiles of the slot held at this step through the rank's map over its
//     buffer viewed as (4 B H, nl, 1, D), streamed through a ring of stages
//     (bf16: 3 at D = 64, 2 at D = 128; int8: 4 and 3);
//   - bf16: S = Q K^T by wgmma SS; int8: by wgmma SS s8 x s8 -> s32
//     (exact), times c0 = q_s k_s D^-0.5 of the rank and head;
//   - int8 V arrives by TMA as int8 (128 x D bytes a tile) into a stage of
//     its own; the producer warpgroup's three other warps convert it into
//     the bf16 V stage (exact, byte permutes and one FADD a value) and
//     release it to the consumers, so the rotated shards stay int8;
//   - the softmax in registers with the folded exponent, P rounded to bf16
//     and packed in place as the A fragment, O += P V by wgmma RS through
//     the transpose bit;
//   - keys at or past nl (the tail of the last 128-key tile of a ragged
//     shard; at the flagship 2748 = 21 x 128 + 60) scored -1e30 in every
//     rotating shard; TMA's zero fill covers the rows themselves;
//   - the (m, l, acc) fp32 state in device memory between the steps: read
//     at the start of a step (except the first) and written at its end
//     (except the last). acc keeps the accumulator fragment's own register
//     order, so each thread moves its share as 16-byte vectors and a warp's
//     access is contiguous; l is summed over the quad before it is stored
//     and held by one thread of the quad after it is loaded; the last step
//     multiplies by 1 / l (guarded: a row whose every key was masked has
//     l = 0), for int8 by v_s / l, and stores bf16 rows below the pass's
//     end.
// The tensor maps travel in the kernel's parameters (2 x 16 maps of 128
// bytes, about 4.9 KB in all, inside the 32,764 bytes CUDA 12.1 allows).
//
// What bounds it on this card: as the forward, two matrix products per
// (query, key) tile, 4 N^2 D operations per head over all ranks (0.50 ms of
// bf16 tensor work at the flagship's (1, 10992, 16, 64); 0.38 ms with the
// int8 score product at twice the rate); the ring adds bytes, not
// operations: the rotation ((n - 1) shards of K and V read and written,
// 270 MB at the flagship in bf16, 135 MB in int8), the state (read and
// written between the steps, about 280 MB over 4 ranks) and the staging
// copy, under the products. Bounded mode (fixed max 0, exp(min(s, 80)))
// makes p independent of the tiling, so the bf16 bounded ring differs from
// the head-major kernel only by the order of its fp32 sums.

#include <cstring>

#include "attend_sm90.cuh"

namespace {

using namespace flash;
using attend::kScoresBf16;
using attend::kScoresInt8V8;

constexpr int kMaxRanks = 16;
constexpr int kStageRows = 64;  // ring_stage: rows a block
constexpr int kStageThreads = 128;

// ---- the rotation and the staging copy ------------------------------------

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

struct StageParams {
  int rank0;                 // the first rank of this launch (grid z adds to it)
  const void* k[kMaxRanks];  // rank's own k shard, strided (B, nl, H, D)
  const void* v[kMaxRanks];
  void* slots[kMaxRanks];    // rank's ring buffer (2, 2, B*H, nl, D), k/v dtype
  long long k_sb, k_sn, k_sh;  // element strides
  long long v_sb, v_sn, v_sh;
  int B, H, nl;
};

// Every rank's own K and V shard -> slot 0 of its buffer, head-major: grid
// (64-row tiles, B*H, ranks). Counterpart of the TPU kernels' first copies
// (kv_buf[0] = k_ref, v_ref; cp_k, cp_v).
template <int D>
__global__ void __launch_bounds__(kStageThreads) ring_stage(const __grid_constant__ StageParams p,
                                                            int esize) {
  const int r = p.rank0 + blockIdx.z, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row0 = blockIdx.x * kStageRows;
  const int vecs = D * esize / 16;  // 16-byte vectors per row
  const long long head_bytes = (long long)p.nl * D * esize;
  for (int kv = 0; kv < 2; ++kv) {
    const char* src = static_cast<const char*>(kv ? p.v[r] : p.k[r]);
    const long long sb = kv ? p.v_sb : p.k_sb, sn = kv ? p.v_sn : p.k_sn,
                    sh = kv ? p.v_sh : p.k_sh;
    src += (b * sb + h * sh) * esize;
    char* dst = slot_ptr(p.slots[r], 0, kv, p.B * p.H, bh, head_bytes);
    for (int i = threadIdx.x; i < kStageRows * vecs; i += kStageThreads) {
      const int row = row0 + i / vecs, c = (i % vecs) * 16;
      if (row < p.nl)
        *reinterpret_cast<uint4*>(dst + (long long)row * D * esize + c) =
            *reinterpret_cast<const uint4*>(src + (long long)row * sn * esize + c);
    }
  }
}

// ---- one ring step: TMA + wgmma ---------------------------------------------

struct RingTmaParams {
  CUtensorMap q_map[kMaxRanks];     // rank's q shard as (D, H, nl, B)
  CUtensorMap slot_map[kMaxRanks];  // rank's ring buffer as (D, 1, nl, 4 B H)
  __nv_bfloat16* o[kMaxRanks];      // rank's output shard, strided (B, nl, H, D)
  void* slots[kMaxRanks];           // rank's ring buffer (2, 2, B*H, nl, D)
  float* acc[kMaxRanks];            // (B*H, q_tiles, D / 8, 256, 4): fragment order
  float* ml[kMaxRanks];             // (2, B*H, q_tiles * 128): running max (log2), row sum
  const float* c[kMaxRanks];        // int8: (B*H, 2): q_s k_s D^-0.5, v_s
  long long o_sb, o_sn, o_sh;
  int B, H, nl;
  int q0, q_rows, q_tiles;  // this pass: rows [q0, q0 + q_rows), q_tiles 128-row tiles
  int n_ranks, step;
  int rank0;          // the first rank of this launch (grid z adds to it)
  int n_copy;         // rotation blocks per (head, rank); 0: no rotation
  int kv_tiles;       // key tiles a shard: ceil(nl / 128) (one fewer: a planted fault)
  int kv_head_shift;  // 0; a test hook that plants a fault (K and V of head (h + shift) % H)
  float scale_log2;   // bf16: D^-0.5 * log2(e)
};
static_assert(sizeof(RingTmaParams) <= 32764, "the kernel-parameter limit of CUDA 12.1");

// One compute block: query tile `tile` of the pass (128 rows from
// q0 + 128 tile) of head h of batch b of rank r, against the shard in
// slot step % 2, the state carried in and out through device memory.
// kForm: kScoresBf16 or kScoresInt8V8.
template <int D, bool kBounded, int kForm>
__device__ __forceinline__ void ring_attend(const RingTmaParams& p, int r, int b, int h,
                                            int tile) {
  constexpr bool kInt8 = kForm == kScoresInt8V8;
  const attend::Tiles t = attend::carve_tiles<D, kForm>();
  const int bhn = p.B * p.H, bh = b * p.H + h;
  const int row0 = p.q0 + tile * attend::kRows;

  const int wg = threadIdx.x / 128;
  if (wg == attend::kConsumers) {
    // the producer thread; in the int8 form warps 1-3 convert V
    sm90::setmaxnreg_dec<kInt8 ? 40 : 24>();
    const int pt = threadIdx.x - 128 * attend::kConsumers;
    if (pt == 0) {
      const int cur = p.step & 1;
      const int kv_bh = b * p.H + (h + p.kv_head_shift) % p.H;
      attend::produce<D, kForm>(t, &p.q_map[r], h, row0, b, &p.slot_map[r], 0,
                                (2 * cur) * bhn + kv_bh, &p.slot_map[r], 0,
                                (2 * cur + 1) * bhn + kv_bh, p.kv_tiles);
    } else if constexpr (kInt8) {
      if (pt >= 32) attend::convert_v<D>(t, pt - 32, p.kv_tiles);
    }
    return;
  }
  sm90::setmaxnreg_inc<kInt8 ? 232 : 240>();
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
  if constexpr (kInt8) {
    const float c0_log2 = p.c[r][2 * bh] * kLog2e;  // the rank's dequantising scalar
    for (int it = 0; it < p.kv_tiles; ++it)
      attend::consume_tile_s8<D, kBounded, kForm>(t, wg, tq, it, p.nl, c0_log2, acc, m_run, l_run);
  } else {
    for (int it = 0; it < p.kv_tiles; ++it)
      attend::consume_tile<D, kBounded>(t, wg, tq, it, p.nl, p.scale_log2, acc, m_run, l_run);
  }
  attend::quad_sum(l_run);

  if (last) {
    float inv[2] = {l_run[0] > 0.f ? 1.f / l_run[0] : 0.f, l_run[1] > 0.f ? 1.f / l_run[1] : 0.f};
    if constexpr (kInt8) {
      const float v_s = p.c[r][2 * bh + 1];  // v's scale, folded into the same multiplier
      inv[0] *= v_s;
      inv[1] *= v_s;
    }
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

// One ring step for the ranks of this launch: grid (n_copy + q_tiles, B*H,
// n_local), 384 threads. Counterpart of one iteration of the step loop of _ring_kernel
// and of _ring_hbm_kernel.
template <int D, bool kBounded, int kForm>
__global__ void __launch_bounds__(attend::kThreads, 1)
    ring_step_tma(const __grid_constant__ RingTmaParams p) {
  const int r = p.rank0 + blockIdx.z, bh = blockIdx.y;
  if (static_cast<int>(blockIdx.x) < p.n_copy) {
    const int esize = kForm == kScoresInt8V8 ? 1 : 2;
    rotate_stripe(p.slots, r, p.n_ranks, p.step & 1, p.B * p.H, bh, (long long)p.nl * D * esize,
                  blockIdx.x, p.n_copy);
    return;
  }
  ring_attend<D, kBounded, kForm>(p, r, bh / p.H, bh % p.H, blockIdx.x - p.n_copy);
}

// rotation blocks per (head, rank): one per eight query tiles, so the copy
// takes a small share of the step's blocks and ends before they do
int copy_blocks(int q_tiles) { return q_tiles / 8 > 0 ? q_tiles / 8 : 1; }

// step -1: the staging copy; 0 .. n_ranks - 1: that step, over the ranks
// [rank0, rank0 + n_local)
template <int D, bool kBounded, int kForm>
cudaError_t launch(const StageParams& stage, RingTmaParams& p, int n_local, int step,
                   int skip_rotation_at, cudaStream_t stream) {
  const int bh = p.B * p.H;
  if (step < 0) {
    ring_stage<D><<<dim3((p.nl + kStageRows - 1) / kStageRows, bh, n_local), kStageThreads, 0,
                    stream>>>(stage, kForm == kScoresInt8V8 ? 1 : 2);
    return cudaGetLastError();
  }
  const int bytes = attend::Smem<D, kForm>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(ring_step_tma<D, kBounded, kForm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  p.step = step;
  p.n_copy = (step + 1 < p.n_ranks && step != skip_rotation_at) ? copy_blocks(p.q_tiles) : 0;
  ring_step_tma<D, kBounded, kForm>
      <<<dim3(p.n_copy + p.q_tiles, bh, n_local), attend::kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int kForm>
cudaError_t launch_form(int head_dim, int bounded, const StageParams& stage, RingTmaParams& p,
                        int n_local, int step, int skip_rotation_at, cudaStream_t stream) {
  if (head_dim == 64)
    return bounded ? launch<64, true, kForm>(stage, p, n_local, step, skip_rotation_at, stream)
                   : launch<64, false, kForm>(stage, p, n_local, step, skip_rotation_at, stream);
  return bounded ? launch<128, true, kForm>(stage, p, n_local, step, skip_rotation_at, stream)
                 : launch<128, false, kForm>(stage, p, n_local, step, skip_rotation_at, stream);
}

// The parameters of a pass over query rows [q0, q0 + q_rows) for the ranks
// [rank0, rank0 + n_local) (their maps encoded here); slots[r] of every
// other rank may be null, except the right neighbour's, which the
// rotation stores into. Returns cudaErrorInvalidValue on a bad argument.
cudaError_t prepare(StageParams& sp, RingTmaParams& t, int head_dim, int int8,
                    const void* const* q, const void* const* k, const void* const* v,
                    void* const* o, void* const* slots, void* const* acc, void* const* ml,
                    const void* const* c, const long long* strides, int B, int H, int nl, int q0,
                    int q_rows, int n_ranks, int rank0, int n_local, float scale,
                    int kv_head_shift, int drop_last_key_tile) {
  if (n_ranks < 1 || n_ranks > kMaxRanks || nl < 1 || q_rows < 1 || q0 < 0 ||
      q0 + q_rows > nl || (int8 && c == nullptr) || B * H > 65535 ||
      (head_dim != 64 && head_dim != 128) || rank0 < 0 || n_local < 1 ||
      rank0 + n_local > n_ranks)
    return cudaErrorInvalidValue;
  std::memset(&sp, 0, sizeof(sp));
  std::memset(&t, 0, sizeof(t));
  const long long row = head_dim;  // a buffer row: one key of one head
  for (int r = 0; r < n_ranks; ++r) {
    sp.slots[r] = slots[r];
    t.slots[r] = slots[r];
  }
  for (int r = rank0; r < rank0 + n_local; ++r) {
    if (slots[r] == nullptr || slots[(r + 1) % n_ranks] == nullptr) return cudaErrorInvalidValue;
    // the maps: int8 boxes of all D columns under a D-byte swizzle, or bf16
    // boxes of 64 columns under the 128-byte swizzle
    const bool maps =
        int8 ? sm90::encode_bnhd_map_s8(&t.q_map[r], q[r], B, nl, H, head_dim, strides[0],
                                        strides[1], strides[2], attend::kRows) &&
                   sm90::encode_bnhd_map_s8(&t.slot_map[r], slots[r], 4 * B * H, nl, 1,
                                            head_dim, (long long)nl * row, row, row,
                                            attend::kRows)
             : sm90::encode_bnhd_map(&t.q_map[r], q[r], B, nl, H, head_dim, strides[0],
                                     strides[1], strides[2], attend::kRows) &&
                   sm90::encode_bnhd_map(&t.slot_map[r], slots[r], 4 * B * H, nl, 1, head_dim,
                                         (long long)nl * row, row, row, attend::kRows);
    if (!maps) return cudaErrorInvalidValue;
    sp.k[r] = k[r];
    sp.v[r] = v[r];
    t.o[r] = static_cast<__nv_bfloat16*>(o[r]);
    t.acc[r] = static_cast<float*>(acc[r]);
    t.ml[r] = static_cast<float*>(ml[r]);
    t.c[r] = int8 ? static_cast<const float*>(c[r]) : nullptr;
  }
  sp.rank0 = rank0;
  sp.k_sb = strides[3]; sp.k_sn = strides[4]; sp.k_sh = strides[5];
  sp.v_sb = strides[6]; sp.v_sn = strides[7]; sp.v_sh = strides[8];
  sp.B = B; sp.H = H; sp.nl = nl;
  t.o_sb = strides[9]; t.o_sn = strides[10]; t.o_sh = strides[11];
  t.B = B; t.H = H; t.nl = nl;
  t.q0 = q0; t.q_rows = q_rows; t.q_tiles = (q_rows + attend::kRows - 1) / attend::kRows;
  t.n_ranks = n_ranks; t.rank0 = rank0; t.step = 0; t.n_copy = 0;
  t.kv_tiles = (nl + attend::kRows - 1) / attend::kRows - (drop_last_key_tile ? 1 : 0);
  t.kv_head_shift = ((kv_head_shift % H) + H) % H;
  t.scale_log2 = scale * kLog2e;
  return cudaSuccess;
}

cudaError_t launch_any(int int8, int head_dim, int bounded, const StageParams& sp,
                       RingTmaParams& t, int n_local, int step, int skip_rotation_at,
                       cudaStream_t s) {
  return int8 ? launch_form<kScoresInt8V8>(head_dim, bounded, sp, t, n_local, step,
                                           skip_rotation_at, s)
              : launch_form<kScoresBf16>(head_dim, bounded, sp, t, n_local, step,
                                         skip_rotation_at, s);
}

}  // namespace

// The step kernel's dynamic shared memory in bytes for a head dim (64 or
// 128; else 0) and a form (int8 0: bf16, 1: int8), and its threads a
// block, for the build report.
extern "C" int omnivggt_ring_attention_smem_bytes(int head_dim, int int8) {
  if (head_dim == 64)
    return int8 ? attend::Smem<64, kScoresInt8V8>::kAlloc : attend::Smem<64>::kAlloc;
  if (head_dim == 128)
    return int8 ? attend::Smem<128, kScoresInt8V8>::kAlloc : attend::Smem<128>::kAlloc;
  return 0;
}

extern "C" int omnivggt_ring_attention_threads() { return attend::kThreads; }

// One ring pass over query rows [q0, q0 + q_rows) of every rank's shard:
// the staging launch, then n_ranks step launches, on `stream`.
// q, k, v, o, slots, acc, ml, c: arrays of n_ranks device pointers (c null
// unless int8). int8: q, k, v int8 (the grids of quant_ring), c[r] the
// rank's (B*H, 2) fp32 table (q_s k_s D^-0.5, v_s); else bf16. slots: (2,
// 2, B*H, nl, D) in the k/v dtype. acc, ml: the state, fp32, of (B*H,
// ceil(q_rows / 128) * 128, D) and (2, B*H, ceil(q_rows / 128) * 128)
// elements at least (their layout is the kernel's own). strides: 12
// element strides, (batch, token, head) of q, k, v, o in turn, each
// counting elements of its own type; every base and stride a multiple of 16
// bytes (TMA, vector copies).
// skip_rotation_at: -1, or a step whose rotation is left out (a planted
// fault for the checks: the ranks then read a stale slot).
// kv_head_shift, drop_last_key_tile: 0 on every real call; test hooks
// that plant a fault (K and V read from head (h + shift) % H; the last key
// tile of every shard left out).
// Returns the cudaError_t of the first launch that failed (0 = launched).
extern "C" int omnivggt_ring_attention(
    int bounded, int head_dim, int int8, const void* const* q, const void* const* k,
    const void* const* v, void* const* o, void* const* slots, void* const* acc,
    void* const* ml, const void* const* c, const long long* strides, int B, int H, int nl,
    int q0, int q_rows, int n_ranks, int skip_rotation_at, float scale, void* stream,
    int kv_head_shift, int drop_last_key_tile) {
  StageParams sp;
  RingTmaParams t;
  cudaError_t err = prepare(sp, t, head_dim, int8, q, k, v, o, slots, acc, ml, c, strides, B, H,
                            nl, q0, q_rows, n_ranks, 0, n_ranks, scale, kv_head_shift,
                            drop_last_key_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int step = -1; step < n_ranks && err == cudaSuccess; ++step)
    err = launch_any(int8, head_dim, bounded, sp, t, n_ranks, step, skip_rotation_at, s);
  return static_cast<int>(err);
}

// The process form: one launch over this process's ranks [rank0, rank0 +
// n_local) of n_ranks, on `stream`: step -1 the staging copy into slot 0
// of their own buffers, else ring step `step` (the rotation of step s <
// n_ranks - 1 stores into slots[(r + 1) % n_ranks], the right neighbour's
// buffer mapped into this process). The arguments are
// omnivggt_ring_attention's, read only at this process's ranks (and the
// right neighbour's slot); the caller runs steps -1, 0, .., n_ranks - 1 in
// order, with every process of the ring past its previous launch before the
// next (a stream sync and a barrier between them).
extern "C" int omnivggt_ring_attention_step(
    int bounded, int head_dim, int int8, const void* const* q, const void* const* k,
    const void* const* v, void* const* o, void* const* slots, void* const* acc,
    void* const* ml, const void* const* c, const long long* strides, int B, int H, int nl,
    int q0, int q_rows, int n_ranks, int rank0, int n_local, int step, int skip_rotation_at,
    float scale, void* stream, int kv_head_shift, int drop_last_key_tile) {
  if (step < -1 || step >= n_ranks) return static_cast<int>(cudaErrorInvalidValue);
  StageParams sp;
  RingTmaParams t;
  cudaError_t err = prepare(sp, t, head_dim, int8, q, k, v, o, slots, acc, ml, c, strides, B, H,
                            nl, q0, q_rows, n_ranks, rank0, n_local, scale, kv_head_shift,
                            drop_last_key_tile);
  if (err == cudaSuccess)
    err = launch_any(int8, head_dim, bounded, sp, t, n_local, step, skip_rotation_at,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
