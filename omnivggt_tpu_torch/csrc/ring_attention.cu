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
// Both run one __global__ here, ring_step. What told them apart on the TPU
// is where the ring buffer and the (m, l, acc) state fit; on this card both
// live in device memory (the state is read at the start of a ring step and
// written at its end, fp32, per query row), so the difference that is left,
// the first kernel's query chunks with one ring pass each, is a row range
// [q0, q0 + q_rows) that the Python wrappers choose.
//
// One ring pass is n + 1 launches on one stream:
//   - ring_stage copies every rank's own K and V shard from the strided
//     (B, nl, H, D) input into slot 0 of its buffer, head-major
//     (2 slots, [k | v], B*H, nl, D);
//   - ring_step, once per step s = 0 .. n-1, with the ranks as the grid's z
//     axis. Its first n_copy blocks of every (head, rank) are the rotation:
//     they copy slot s % 2 of rank r into slot (s + 1) % 2 of rank
//     (r + 1) % n with 16-byte vector loads and stores, and are scheduled
//     ahead of the compute blocks of the same launch, so the transfer rides
//     under the step's products as the TPU's RDMA does. The other blocks
//     attend 64 query rows to slot s % 2 of their own rank. Nobody reads
//     slot (s + 1) % 2 during step s, and the launch boundary is what the
//     TPU kernel's send, receive and capacity semaphores are: no block ever
//     waits on another, so nothing can hang. The last step issues no copy.
// Every rank's q, o, state and buffer are reached through per-rank base
// pointers, so a buffer mapped from another card can stand in for a
// neighbour's slot without a change here.
//
// The tile itself is the forward kernel's (flash_attention.cu): 4 warps of
// 16 query rows, mma.sync m16n8k16 bf16 (or m16n8k32 s8 for int8 scores),
// scores and probabilities in registers, K row-major and V transposed in
// shared memory. What is new:
//   - the state outlives the pass over one shard: m and the quad-reduced l
//     per row, acc as fp32 rows; only the last step divides by l (guarded:
//     a row whose every key so far was masked has l = 0) and, for int8,
//     multiplies by the head's v scale;
//   - int8 V: the shard rotates as int8 (half the bytes) and is converted
//     to bf16 (exactly) as it is staged into shared memory;
//   - keys at or past nl (the tail of the last 64-key tile of a ragged
//     shard) are scored -1e30 in every rotating shard.
// Bounded mode (fixed max 0, exp(min(s, 80))) makes p independent of the
// tiling, so the bf16 bounded ring differs from the head-major kernel only
// by the order of its fp32 sums.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kMaxRanks = 16;

struct RingParams {
  const void* q[kMaxRanks];     // rank's q shard, strided (B, nl, H, D): bf16 or int8
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
  float scale_log2;    // D^-0.5 * log2(e)
};

template <int D>
__device__ __forceinline__ char* slot_ptr(const RingParams& p, int rank, int slot, int kv,
                                          int bh, int esize) {
  const long long slab = (long long)p.nl * D * esize;  // one head's K (or V) shard
  return static_cast<char*>(p.slots[rank]) +
         (((long long)slot * 2 + kv) * (p.B * p.H) + bh) * slab;
}

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

// the rotation: this block's stripe of head bh's K and V, slot `cur` of
// rank r -> slot `nxt` of its right neighbour
template <int D>
__device__ __forceinline__ void rotate_stripe(const RingParams& p, int r, int bh, int esize) {
  const int cur = p.step & 1, nxt = cur ^ 1;
  const int right = (r + 1) % p.n_ranks;
  const long long vecs = (long long)p.nl * D * esize / 16;
  for (int kv = 0; kv < 2; ++kv) {
    const uint4* src = reinterpret_cast<const uint4*>(slot_ptr<D>(p, r, cur, kv, bh, esize));
    uint4* dst = reinterpret_cast<uint4*>(slot_ptr<D>(p, right, nxt, kv, bh, esize));
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < vecs;
         i += (long long)p.n_copy * kThreads)
      dst[i] = src[i];
  }
}

// One compute block: 64 query rows of head h of batch b of rank r, starting
// at shard row row0, against the shard in slot step % 2.
template <int D, bool kBounded, bool kInt8>
__device__ __forceinline__ void ring_tile(const RingParams& p, int r, int b, int h, int row0) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 vt[D * (kBlockK + kPad)];
  int8_t* ks8 = reinterpret_cast<int8_t*>(ks);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int bh = b * p.H + h;
  const int q_end = p.q0 + p.q_rows;
  const int esize = kInt8 ? 1 : 2;
  const bool first = p.step == 0, last = p.step == p.n_ranks - 1;

  uint32_t qf[D / 16][4];
  uint32_t qf8[D / 32][4];
  if constexpr (kInt8) {
    const int8_t* qb = static_cast<const int8_t*>(p.q[r]) + b * p.q_sb + h * p.q_sh;
    load_rows_s8<D>(ks8, qb, p.q_sn, row0, q_end);
    __syncthreads();
    load_a_fragments_s8<D>(qf8, ks8, r0, t);
  } else {
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(p.q[r]) + b * p.q_sb + h * p.q_sh;
    load_rows<D>(ks, qb, p.q_sn, row0, q_end);
    __syncthreads();
    load_a_fragments<D>(qf, ks, r0, t);
  }
  __syncthreads();
  float score_mul = p.scale_log2;
  if constexpr (kInt8) score_mul = p.c[r][bh * 2] * kLog2e;

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

  const int cur = p.step & 1;
  const char* k_slab = slot_ptr<D>(p, r, cur, 0, bh, esize);
  const char* v_slab = slot_ptr<D>(p, r, cur, 1, bh, esize);
  const int n_eff = p.nl;

  for (int k0 = 0; k0 < n_eff; k0 += kBlockK) {
    if constexpr (kInt8) {
      load_rows_s8<D>(ks8, reinterpret_cast<const int8_t*>(k_slab), D, k0, n_eff);
      load_rows_transposed_s8<D>(vt, reinterpret_cast<const int8_t*>(v_slab), D, k0, n_eff);
    } else {
      load_rows<D>(ks, reinterpret_cast<const __nv_bfloat16*>(k_slab), D, k0, n_eff);
      load_rows_transposed<D>(vt, reinterpret_cast<const __nv_bfloat16*>(v_slab), D, k0, n_eff);
    }
    __syncthreads();

    float s[kBlockK / 8][4];
    if constexpr (kInt8) {
      mma_rows_by_tile_s8<D>(s, qf8, ks8, g, t);
    } else {
      mma_rows_by_tile<D>(s, qf, ks, g, t);
    }

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
    // divide only now; the int8 v scale folds into the same multiplier
    float mul[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) mul[rr] = l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f;
    if constexpr (kInt8) {
      const float v_scale = p.c[r][bh * 2 + 1];
      mul[0] *= v_scale;
      mul[1] *= v_scale;
    }
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

// One ring step for every rank: grid (n_copy + query tiles, B*H, ranks).
// Counterpart of one iteration of the step loop of _ring_kernel and of
// _ring_hbm_kernel.
template <int D, bool kBounded, bool kInt8>
__global__ void __launch_bounds__(kThreads) ring_step(const __grid_constant__ RingParams p) {
  const int r = blockIdx.z, bh = blockIdx.y;
  if (static_cast<int>(blockIdx.x) < p.n_copy) {
    rotate_stripe<D>(p, r, bh, kInt8 ? 1 : 2);
    return;
  }
  const int tile = blockIdx.x - p.n_copy;
  ring_tile<D, kBounded, kInt8>(p, r, bh / p.H, bh % p.H, p.q0 + tile * kBlockQ);
}

// Every rank's own K and V shard -> slot 0 of its buffer, head-major: grid
// (64-row tiles, B*H, ranks). Counterpart of the TPU kernels' first copies
// (kv_buf[0] = k_ref, v_ref; cp_k, cp_v).
template <int D>
__global__ void __launch_bounds__(kThreads) ring_stage(const __grid_constant__ RingParams p,
                                                       int esize) {
  const int r = blockIdx.z, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row0 = blockIdx.x * kBlockK;
  const int vecs = D * esize / 16;  // 16-byte vectors per row
  for (int kv = 0; kv < 2; ++kv) {
    const char* src = static_cast<const char*>(kv ? p.v[r] : p.k[r]);
    const long long sb = kv ? p.v_sb : p.k_sb, sn = kv ? p.v_sn : p.k_sn,
                    sh = kv ? p.v_sh : p.k_sh;
    src += (b * sb + h * sh) * esize;
    char* dst = slot_ptr<D>(p, r, 0, kv, bh, esize);
    for (int i = threadIdx.x; i < kBlockK * vecs; i += kThreads) {
      const int row = row0 + i / vecs, c = (i % vecs) * 16;
      if (row < p.nl)
        *reinterpret_cast<uint4*>(dst + (long long)row * D * esize + c) =
            *reinterpret_cast<const uint4*>(src + (long long)row * sn * esize + c);
    }
  }
}

template <int D, bool kBounded, bool kInt8>
cudaError_t run_pass(RingParams& p, int copy_blocks, int skip_rotation_at, cudaStream_t stream) {
  const int q_tiles = (p.q_rows + kBlockQ - 1) / kBlockQ;
  const int bh = p.B * p.H;
  ring_stage<D><<<dim3((p.nl + kBlockK - 1) / kBlockK, bh, p.n_ranks), kThreads, 0, stream>>>(
      p, kInt8 ? 1 : 2);
  cudaError_t err = cudaGetLastError();
  for (int step = 0; step < p.n_ranks && err == cudaSuccess; ++step) {
    p.step = step;
    p.n_copy = (step + 1 < p.n_ranks && step != skip_rotation_at) ? copy_blocks : 0;
    ring_step<D, kBounded, kInt8>
        <<<dim3(p.n_copy + q_tiles, bh, p.n_ranks), kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// One ring pass over query rows [q0, q0 + q_rows) of every rank's shard:
// the staging launch, then n_ranks step launches, on `stream`.
// q, k, v, o, slots, acc, ml, c: arrays of n_ranks device pointers (see
// RingParams; c null unless int8). strides: 12 element strides, (batch,
// token, head) of q, k, v, o in turn, each counting elements of its own
// type; rows must start on 16-byte boundaries.
// skip_rotation_at: -1, or a step whose rotation is left out (a planted
// fault for the checks: the ranks then read a stale slot).
// Returns the cudaError_t of the first launch that failed (0 = launched).
extern "C" int omnivggt_ring_attention(
    int bounded, int head_dim, int int8, const void* const* q, const void* const* k,
    const void* const* v, void* const* o, void* const* slots, void* const* acc,
    void* const* ml, const void* const* c, const long long* strides, int B, int H, int nl,
    int q0, int q_rows, int n_ranks, int skip_rotation_at, float scale, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxRanks || nl < 1 || q_rows < 1 || q0 < 0 ||
      q0 + q_rows > nl || (int8 && c == nullptr) || B * H > 65535)
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
  p.scale_log2 = scale * kLog2e;
  // rotation blocks per (head, rank): one per eight query tiles, so the
  // copy takes a small share of the step's blocks and ends before they do
  const int q_tiles = (q_rows + kBlockQ - 1) / kBlockQ;
  const int copy_blocks = q_tiles / 8 > 0 ? q_tiles / 8 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RING_CASE(DIM, BOUNDED, INT8)                                               \
  if (head_dim == DIM && (bounded != 0) == BOUNDED && (int8 != 0) == INT8)          \
    err = run_pass<DIM, BOUNDED, INT8>(p, copy_blocks, skip_rotation_at, s);
  RING_CASE(64, true, false)
  RING_CASE(64, false, false)
  RING_CASE(64, true, true)
  RING_CASE(64, false, true)
  RING_CASE(128, true, false)
  RING_CASE(128, false, false)
  RING_CASE(128, true, true)
  RING_CASE(128, false, true)
#undef RING_CASE
  return static_cast<int>(err);
}
