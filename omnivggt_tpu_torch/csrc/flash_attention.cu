// Non-causal flash-attention forward for Hopper (sm_90a), bf16 in, fp32
// accumulation, bf16 out. Plain C interface, loaded with ctypes from
// omnivggt_tpu_torch/ops/kernels/flash_attention.py.
//
// Replaces three TPU kernels of omnivggt_tpu/ops/pallas/flash_attention.py:
//   - _flash_kernel (head-major streaming softmax, via _flash_forward and
//     flash_attention): the global attention, (1, 10992, 16, 64) at S=8,
//     in its bf16 form and in its qk_int8 form (q and k quantised per head
//     outside, scores by an exact s8 x s8 -> s32 product times the per-head
//     scalar c = q_scale * k_scale * D^-0.5);
//   - _flash_packed_kernel (token-major, whole key axis per block, via
//     _flash_packed_forward and flash_attention_packed): frame attention
//     (8, 1374, 16, 64) and DINOv2 attention (8, 1376, 16, 64) with a
//     valid-key prefix of 1374;
//   - _flash_packed_stream_kernel (token-major, key axis streamed, bounded
//     softmax only, via flash_attention_packed_stream): the global attention
//     when the stream flag is on, in a bf16 form and an int8 form whose q
//     tile is quantised here, once per block, as round(q * qinv) with the
//     head's inverse scale, against a k quantised token-major outside.
// Two designs share this file.
//
// The bf16 forms (the main path: global attention under the head-major
// grid, frame and DINOv2 attention under the token-major grid, and the
// stream wrapper's bf16 form) run one kernel template built for Hopper,
// tma_attend():
//   - a block holds 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows (wgmma's M) and one producer warpgroup, of which
//     one thread issues every load; the producer drops to 24 registers with
//     setmaxnreg so the consumers can hold 240;
//   - TMA loads Q once per block and streams 128-key K and V tiles through a
//     ring of shared-memory stages (3 at D = 64, 2 at D = 128) guarded by
//     full and empty mbarriers, so the next tiles are in flight while the
//     tensor cores work on this one. The tensor maps are 4-D over the
//     (B, N, H, D) tensors as the wrappers pass them (dims D, H, N, B; box
//     64 columns x 1 head x 128 rows x 1), encoded on the host for every
//     call; TMA's zero fill stands in for rows past N or Nk;
//   - S = Q K^T is wgmma with both operands in shared memory (128-byte
//     swizzle, K-major), accumulated in fp32 registers (64 a thread);
//   - the softmax stays in registers: scores scaled into log2 units inside
//     the exponent's argument (one FFMA, then the bare ex2 instruction),
//     keys at or past min(Nk, kv_valid) set to -1e30 in the last tile only, the
//     bounded clamp exp(min(s, 80)) at a fixed max of 0 or an online running
//     max, P rounded to bf16 as the TPU kernel does, each row summed per
//     thread (2 rows x 32 columns of every 64 x 128 tile) and finished by one
//     quad shuffle;
//   - O += P V is wgmma with P from registers (the accumulator's column
//     pairs are the A fragment) and V from shared memory through the
//     descriptor's transpose bit: V is never transposed by threads;
//   - the epilogue divides by l (l > 0 guarded), stores bf16 rows below N
//     and, when training, the row LSE as before.
// The two grids differ only in the block order: head-major (query tiles,
// B*H) keeps one head's query tiles together; token-major (H, query tiles,
// B) keeps the heads of one query tile together. The tile (its shared
// memory, the producer's loop, the consumer's step over a key tile, the
// store of o) is attend_sm90.cuh's, which the ring kernel
// (ring_attention.cu) runs too; the primitives (mbarrier, TMA, wgmma,
// setmaxnreg, the tensor-map encoding) are in sm90.cuh.
//
// The int8 forms keep the first design, attend_tile(): 64 query rows and
// 4 warps a block, mma.sync.m16n8k32 s8 scores from int8 tiles staged by
// threads, then the softmax and P @ V with mma.sync.m16n8k16 and a V tile
// transposed in shared memory. The TPU stream kernel's head pairs,
// zero-padded q tiles and 128-lane extended V answer its lane tile and are
// not carried over: a block reads its head's 64 columns out of the
// token-major rows by stride.
//
// What bounds it on this card: two matrix products per (query, key) tile,
// 4 N Nk D FLOPs per head, against q, k, v read and o written once. At
// D = 64 and the flagship's lengths that is compute-bound (0.50 ms of bf16
// tensor work for the global attention against 0.09 ms of bytes), and with
// D = 64 the exponentials (one per score, on the special-function units)
// weigh as much as the products: both products and the softmax of a tile
// have to overlap with the loads of the next, which is what the producer
// warpgroup and the stage ring are for. Each consumer warpgroup runs its
// tiles in order (S, softmax, P V); the SM interleaves one warpgroup's
// softmax with the other's products by itself. Two schedules that order
// this by hand, one tile ahead within a warpgroup and a ping-pong of the
// two warpgroups on named barriers, measured slower on the H100 in the
// forms tried (PERF.md).
//
// The int8 forms in detail:
//   - the int8 forms stage int8 Q and K tiles (a quarter of the bytes of
//     the bf16 pair) and run mma.sync.m16n8k32 s8, whose s32 fragment has
//     the bf16 product's layout, so the softmax and P @ V below it are the
//     same code; the dequantising scalar is folded into the log2 scale;
//   - K is staged row-major and V transposed in shared memory, each row
//     padded by 8 bf16, so every fragment load is one conflict-free 32-bit
//     shared load; keys at or past min(Nk, kv_valid) load as zeros and
//     their scores are set to -1e30.

#include "attend_sm90.cuh"

namespace {

using namespace flash;

// how the scores are formed
constexpr int kScoresBf16 = 0;    // bf16 q and k
constexpr int kScoresInt8 = 1;    // int8 q and k, quantised by the caller
constexpr int kScoresInt8QIn = 2; // int8 k from the caller, bf16 q quantised here

// ---- bf16: TMA + wgmma ------------------------------------------------------

using attend::kConsumers;
using attend::kRows;
constexpr int kTmaThreads = attend::kThreads;

template <int D>
using TmaSmem = attend::Smem<D>;

struct TmaParams {
  CUtensorMap q_map, k_map, v_map;  // (D, H, N, B) maps, see sm90.cuh
  __nv_bfloat16* o;
  float* lse;  // optional (B, H, N) natural-log row LSE, for the backward
  long long o_sb, o_sn, o_sh;
  int B, H, N, Nk;
  int kv_static;          // valid keys when kv_dynamic is null (<= Nk)
  const int* kv_dynamic;  // optional device scalar: valid-key count
  float scale_log2;       // D^-0.5 * log2(e)
  int kv_head_shift;      // 0; a test hook that plants a fault (K and V
                          // read from head (h + shift) % H)
};

// One block: 128 query rows of head h of batch b, starting at row q0; the
// tile and its pipeline are attend_sm90.cuh's.
template <int D, bool kBounded>
__device__ __forceinline__ void tma_attend(const TmaParams& p, int b, int h, int q0) {
  const attend::Tiles t = attend::carve_tiles<D>();

  // producer and consumers read the same count, so they agree on the tiles
  int n_eff = p.kv_dynamic ? min(p.Nk, *p.kv_dynamic) : p.kv_static;
  n_eff = max(n_eff, 0);
  const int n_tiles = (n_eff + kRows - 1) / kRows;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kh = (h + p.kv_head_shift) % p.H;
      attend::produce<D>(t, &p.q_map, h, q0, b, &p.k_map, kh, b, &p.v_map, kh, b, n_tiles);
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) >> 2;  // accumulator row group
    const int tq = tid & 3;         // thread in group
    const int row_lo = q0 + wg * 64 + (tid / 32) * 16 + g;  // rows row_lo, row_lo + 8

    float acc[D / 2];  // O: m64nD accumulator
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // running max (log2 units)
    float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

    // One tile after the other: the two consumer warpgroups interleave on
    // the SM by themselves (one's softmax beside the other's products).
    sm90::mbar_wait(t.q_full, 0);
    for (int it = 0; it < n_tiles; ++it)
      attend::consume_tile<D, kBounded>(t, wg, tq, it, n_eff, p.scale_log2, acc, m_run, l_run);

    attend::quad_sum(l_run);
    const float inv[2] = {l_run[0] > 0.f ? 1.f / l_run[0] : 0.f,
                          l_run[1] > 0.f ? 1.f / l_run[1] : 0.f};

    if (p.lse != nullptr && tq == 0) {
      // lse = ln(sum_k exp(s_k)) = (m + log2 l) ln 2 in log2 units; bounded
      // mode's max is fixed at 0, so lse = ln l, the TPU kernel's contract.
      // A row with every key masked gets +1e30, so the backward's
      // p = exp(s - lse) is 0 there instead of NaN.
      float* lb = p.lse + ((long long)b * p.H + h) * p.N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < p.N) {
          const float lse2 = kBounded ? log2f(l_run[r]) : m_run[r] + log2f(l_run[r]);
          lb[row] = l_run[r] > 0.f ? lse2 * kLn2 : -kNegInf;
        }
      }
    }

    attend::store_rows<D>(p.o + b * p.o_sb + h * p.o_sh, p.o_sn, acc, inv, row_lo, p.N, tq);
  }
}

// counterpart of _flash_kernel (bf16): grid (query tiles, B*H)
template <int D, bool kBounded>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_head_major_tma(const __grid_constant__ TmaParams p) {
  const int bh = blockIdx.y;
  tma_attend<D, kBounded>(p, bh / p.H, bh % p.H, blockIdx.x * kRows);
}

// counterpart of _flash_packed_kernel and of _flash_packed_stream_kernel
// (bf16): grid (H, query tiles, B). The key loop streams 128-key tiles
// whatever the key length, so the TPU's two token-major kernels (whole key
// axis in one block up to 2048 keys; key axis streamed beyond) are one
// kernel here, and the Python wrappers keep their two contracts and launch
// counters.
template <int D, bool kBounded>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_token_major_tma(const __grid_constant__ TmaParams p) {
  tma_attend<D, kBounded>(p, blockIdx.z, blockIdx.x, blockIdx.y * kRows);
}

constexpr int kModeHeadMajor = 0, kModeTokenMajor = 1;

template <int D, bool kBounded>
cudaError_t launch_tma(const TmaParams& p, int mode, cudaStream_t stream) {
  const int bytes = TmaSmem<D>::kAlloc;
  const int q_tiles = (p.N + kRows - 1) / kRows;
  cudaError_t err;
  if (mode == kModeHeadMajor) {
    err = cudaFuncSetAttribute(flash_fwd_head_major_tma<D, kBounded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_head_major_tma<D, kBounded>
        <<<dim3(q_tiles, p.B * p.H), kTmaThreads, bytes, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_token_major_tma<D, kBounded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_token_major_tma<D, kBounded>
        <<<dim3(p.H, q_tiles, p.B), kTmaThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---- int8: mma.sync ---------------------------------------------------------

struct Params {
  const int8_t* q;  // int8 (kScoresInt8), or bf16 read as such (kScoresInt8QIn)
  const int8_t* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  // element strides of the batch, token and head axes; the last axis is
  // contiguous and every stride is a multiple of 8 (16-byte vectors)
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int B, H, N, Nk;
  int kv_static;          // valid keys when kv_dynamic is null (<= Nk)
  const int* kv_dynamic;  // optional device scalar: valid-key count
  const float* c;         // (B, H) q_scale * k_scale * D^-0.5
  const float* qinv;      // kScoresInt8QIn: (B, H) 1 / q_scale
  int8_t* q8_out;         // kScoresInt8QIn: optional contiguous (B, N, H, D)
                          // copy of the quantised q, for checking the grid
};

// One block: 64 query rows of head h of batch b, starting at row q0.
template <int D, bool kBounded, int kQ>
__device__ __forceinline__ void attend_tile(const Params& p, int b, int h, int q0) {
  static_assert(kQ == kScoresInt8 || kQ == kScoresInt8QIn, "int8 forms only");
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 vt[D * (kBlockK + kPad)];
  // the int8 tiles (64 x (D + kPadS8) bytes) fit in the bf16 K buffer
  int8_t* ks8 = reinterpret_cast<int8_t*>(ks);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = warp * 16 + g;

  int n_eff = p.kv_dynamic ? min(p.Nk, *p.kv_dynamic) : p.kv_static;
  n_eff = max(n_eff, 0);

  // q and k strides count elements of their own type
  const int8_t* k8b = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // Q tile -> shared -> A fragments in registers
  uint32_t qf8[D / 32][4];
  if constexpr (kQ == kScoresInt8) {
    load_rows_s8<D>(ks8, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.N);
    __syncthreads();
    load_a_fragments_s8<D>(qf8, ks8, r0, t);
  } else {
    // bf16 Q tile (borrowing the V buffer) -> round(q * qinv), clipped to
    // +-127 (rows the scale did not see may exceed it), half to even
    const __nv_bfloat16* qb =
        reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    load_rows<D>(vt, qb, p.q_sn, q0, p.N);
    __syncthreads();
    const float qinv = p.qinv[b * p.H + h];
    for (int i = threadIdx.x; i < kBlockQ * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
      const __nv_bfloat16* src = vt + r * (D + kPad) + c4;
      uint32_t packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v8 = __float2int_rn(__fmul_rn(__bfloat162float(src[j]), qinv));
        v8 = max(-127, min(127, v8));
        packed |= (static_cast<uint32_t>(v8) & 0xffu) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(ks8 + r * (D + kPadS8) + c4) = packed;
      if (p.q8_out != nullptr && q0 + r < p.N)
        *reinterpret_cast<uint32_t*>(
            p.q8_out + (((long long)b * p.N + q0 + r) * p.H + h) * D + c4) = packed;
    }
    __syncthreads();
    load_a_fragments_s8<D>(qf8, ks8, r0, t);
  }
  __syncthreads();
  // scores -> log2 units by the head's dequantising c
  const float score_mul = p.c[b * p.H + h] * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max (log2 units), rows g and g+8
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int k0 = 0; k0 < n_eff; k0 += kBlockK) {
    load_rows_s8<D>(ks8, k8b, p.k_sn, k0, n_eff);
    load_rows_transposed<D>(vt, vb, p.v_sn, k0, n_eff);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
    mma_rows_by_tile_s8<D>(s, qf8, ks8, g, t);
    // scale into log2 units and mask keys at or past n_eff
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
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= corr[r];
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

    // O += P V: the score fragments of key groups (2kk, 2kk+1) form the A
    // operand of the kk-th 16-key step
    mma_scores_by_tile<D>(acc, s, vt, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;

  store_rows<D>(p.o + b * p.o_sb + h * p.o_sh, p.o_sn, acc, inv0, inv1, q0 + r0, p.N, t);
}

// counterpart of _flash_kernel's qk_int8 form: grid (query tiles, B*H)
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_head_major(Params p) {
  const int bh = blockIdx.y;
  attend_tile<D, kBounded, kQ>(p, bh / p.H, bh % p.H, blockIdx.x * kBlockQ);
}

// counterpart of _flash_packed_stream_kernel's int8 form: grid (H, query
// tiles, B)
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_token_major(Params p) {
  attend_tile<D, kBounded, kQ>(p, blockIdx.z, blockIdx.x, blockIdx.y * kBlockQ);
}

template <int D, bool kBounded>
bool launch_int8(const Params& p, int mode, int qk, cudaStream_t stream) {
  const int q_tiles = (p.N + kBlockQ - 1) / kBlockQ;
  const dim3 token_major(p.H, q_tiles, p.B), head_major(q_tiles, p.B * p.H);
  if (mode == kModeHeadMajor && qk == kScoresInt8) {
    flash_fwd_head_major<D, kBounded, kScoresInt8><<<head_major, kThreads, 0, stream>>>(p);
  } else if (mode == kModeTokenMajor && kBounded && D == 64 && qk == kScoresInt8QIn) {
    flash_fwd_token_major<64, true, kScoresInt8QIn><<<token_major, kThreads, 0, stream>>>(p);
  } else {
    return false;
  }
  return true;
}

}  // namespace

// The bf16 kernel's dynamic shared memory in bytes for a head dim (64 or
// 128; 0 otherwise) and its threads a block, for the build report.
extern "C" int omnivggt_flash_attention_tma_smem_bytes(int head_dim) {
  return head_dim == 64 ? TmaSmem<64>::kAlloc : head_dim == 128 ? TmaSmem<128>::kAlloc : 0;
}

extern "C" int omnivggt_flash_attention_tma_threads() { return kTmaThreads; }

// mode: 0 head-major grid, 1 token-major grid (the packed and the stream
// wrappers).
// qk: 0 bf16 scores (TMA + wgmma); 1 int8 q and k (head-major only) with c;
// 2 int8 k and a bf16 q quantised in the kernel by qinv (token-major,
// bounded, head dim 64: the stream wrapper's int8 form) with c, q8_out
// optionally receiving the quantised q as contiguous (B, N, H, D) int8.
// strides: 12 element strides, (batch, token, head) for q, k, v, o in turn,
// q's and k's counting elements of their own type.
// lse: null, or a contiguous (B, H, N) fp32 output for the backward (bf16
// scores only).
// kv_head_shift: 0 on every real call (a test hook that plants a fault: the
// bf16 forms read K and V from head (h + shift) % H).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int omnivggt_flash_attention_fwd(
    int mode, int bounded, int head_dim, int qk, const void* q, const void* k,
    const void* v, void* o, void* lse, const void* c, const void* qinv,
    void* q8_out, const long long* strides, int B, int H, int N, int Nk,
    int kv_static, const void* kv_dynamic, float scale, void* stream,
    int kv_head_shift) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (qk == kScoresBf16) {
    TmaParams p;
    const bool maps =
        sm90::encode_bnhd_map(&p.q_map, q, B, N, H, head_dim, strides[0], strides[1],
                              strides[2], kRows) &&
        sm90::encode_bnhd_map(&p.k_map, k, B, Nk, H, head_dim, strides[3], strides[4],
                              strides[5], kRows) &&
        sm90::encode_bnhd_map(&p.v_map, v, B, Nk, H, head_dim, strides[6], strides[7],
                              strides[8], kRows);
    if (!maps || mode < kModeHeadMajor || mode > kModeTokenMajor)
      return static_cast<int>(cudaErrorInvalidValue);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
    p.B = B; p.H = H; p.N = N; p.Nk = Nk;
    p.kv_static = kv_static;
    p.kv_dynamic = static_cast<const int*>(kv_dynamic);
    p.scale_log2 = scale * kLog2e;
    p.kv_head_shift = ((kv_head_shift % H) + H) % H;
    cudaError_t err;
    if (head_dim == 64) {
      err = bounded ? launch_tma<64, true>(p, mode, s) : launch_tma<64, false>(p, mode, s);
    } else {
      err = bounded ? launch_tma<128, true>(p, mode, s) : launch_tma<128, false>(p, mode, s);
    }
    return static_cast<int>(err);
  }
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.N = N; p.Nk = Nk;
  p.kv_static = kv_static;
  p.kv_dynamic = static_cast<const int*>(kv_dynamic);
  p.c = static_cast<const float*>(c);
  p.qinv = static_cast<const float*>(qinv);
  p.q8_out = static_cast<int8_t*>(q8_out);
  if (p.c == nullptr || lse != nullptr || kv_head_shift != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (qk == kScoresInt8QIn && p.qinv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (head_dim == 64) {
    ok = bounded ? launch_int8<64, true>(p, mode, qk, s) : launch_int8<64, false>(p, mode, qk, s);
  } else {
    ok = bounded ? launch_int8<128, true>(p, mode, qk, s) : launch_int8<128, false>(p, mode, qk, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
