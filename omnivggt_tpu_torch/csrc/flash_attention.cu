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
// One kernel template built for Hopper, tma_attend(), runs every form:
//   - a block holds 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows (wgmma's M) and one producer warpgroup, of which
//     one thread issues every load; the producer drops to 24 registers with
//     setmaxnreg so the consumers can hold 240;
//   - TMA loads Q once per block and streams 128-key K and V tiles through a
//     ring of shared-memory stages (bf16: 3 at D = 64, 2 at D = 128; int8
//     scores: 4 and 3) guarded by full and empty mbarriers, so the next
//     tiles are in flight while the tensor cores work on this one. The
//     tensor maps are 4-D over the (B, N, H, D) tensors as the wrappers pass
//     them (dims D, H, N, B; box 64 bf16 columns, or all D int8 columns, x 1
//     head x 128 rows x 1), encoded on the host for every call; TMA's zero
//     fill stands in for rows past N or Nk;
//   - S = Q K^T is wgmma with both operands in shared memory (K-major),
//     accumulated in registers (64 a thread): bf16 under a 128-byte swizzle
//     into fp32; in the int8 forms s8 x s8 into s32 under a D-byte swizzle,
//     the exact integer scores taken to fp32 by one FADD (the accumulator
//     starts at the float bits of 1.5 * 2^23) and scaled by the head's
//     c = q_scale * k_scale * D^-0.5;
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
//   - the stream kernel's int8 form loads its q tile as bf16 and the
//     consumers quantise it once per block into an int8 tile in the layout
//     the score product reads (a proxy fence and a warpgroup barrier before
//     the first product); the TPU stream kernel's head pairs, zero-padded q
//     tiles and 128-lane extended V answer its lane tile and are not carried
//     over: a block reads its head's columns out of the token-major rows;
//   - the epilogue divides by l (l > 0 guarded), stores bf16 rows below N
//     and, when training (bf16 scores), the row LSE.
// The two grids differ only in the block order: head-major (query tiles,
// B*H) keeps one head's query tiles together; token-major (H, query tiles,
// B) keeps the heads of one query tile together. The tile (its shared
// memory, the producer's loop, the consumer's step over a key tile in its
// bf16 and its int8 form, the store of o) is attend_sm90.cuh's, which the
// ring kernel (ring_attention.cu) runs too; the primitives (mbarrier, TMA,
// wgmma, setmaxnreg, the tensor-map encoding) are in sm90.cuh.
//
// What bounds it on this card: two matrix products per (query, key) tile,
// 4 N Nk D operations per head, against q, k, v read and o written once. At
// D = 64 and the flagship's lengths that is compute-bound (0.50 ms of bf16
// tensor work for the global attention against 0.09 ms of bytes; 0.38 ms
// with int8 scores, whose product runs at twice the bf16 rate), and with
// D = 64 the exponentials (one per score, on the special-function units)
// weigh as much as the products: both products and the softmax of a tile
// have to overlap with the loads of the next, which is what the producer
// warpgroup and the stage ring are for. Each consumer warpgroup runs its
// tiles in order (S, softmax, P V); the SM interleaves one warpgroup's
// softmax with the other's products by itself. Two schedules that order
// this by hand, one tile ahead within a warpgroup and a ping-pong of the
// two warpgroups on named barriers, measured slower on the H100 in the
// forms tried (PERF.md).

#include "attend_sm90.cuh"

namespace {

using namespace flash;
using attend::kConsumers;
using attend::kRows;
using attend::kScoresBf16;
using attend::kScoresInt8;
using attend::kScoresInt8QIn;
constexpr int kTmaThreads = attend::kThreads;

struct TmaParams {
  CUtensorMap q_map, k_map, v_map;  // (D, H, N, B) maps, see sm90.cuh
  __nv_bfloat16* o;
  float* lse;  // optional (B, H, N) natural-log row LSE, for the backward
  long long o_sb, o_sn, o_sh;
  int B, H, N, Nk;
  int kv_static;          // valid keys when kv_dynamic is null (<= Nk)
  const int* kv_dynamic;  // optional device scalar: valid-key count
  float scale_log2;       // bf16 scores: D^-0.5 * log2(e)
  const float* c;         // int8 scores: (B, H) q_scale * k_scale * D^-0.5
  const float* qinv;      // kScoresInt8QIn: (B, H) 1 / q_scale
  int8_t* q8_out;         // kScoresInt8QIn: optional contiguous (B, N, H, D)
                          // copy of the quantised q, for checking the grid
  int kv_head_shift;      // 0; a test hook that plants a fault (K and V
                          // read from head (h + shift) % H)
};

// One block: 128 query rows of head h of batch b, starting at row q0; the
// tile and its pipeline are attend_sm90.cuh's.
template <int D, bool kBounded, int kQ>
__device__ __forceinline__ void tma_attend(const TmaParams& p, int b, int h, int q0) {
  const attend::Tiles t = attend::carve_tiles<D, kQ>();

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
      attend::produce<D, kQ>(t, &p.q_map, h, q0, b, &p.k_map, kh, b, &p.v_map, kh, b, n_tiles);
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
    if constexpr (kQ == kScoresBf16) {
      for (int it = 0; it < n_tiles; ++it)
        attend::consume_tile<D, kBounded>(t, wg, tq, it, n_eff, p.scale_log2, acc, m_run, l_run);
    } else {
      const int bh = b * p.H + h;
      if constexpr (kQ == kScoresInt8QIn) {
        int8_t* q8 = p.q8_out == nullptr
                         ? nullptr
                         : p.q8_out + (((long long)b * p.N + q0) * p.H + h) * D;
        attend::quantise_q<D>(t, wg, p.qinv[bh], q8, (long long)p.H * D, p.N - q0);
      }
      const float scale_log2 = p.c[bh] * kLog2e;  // the dequantising scalar, log2 units
      for (int it = 0; it < n_tiles; ++it)
        attend::consume_tile_s8<D, kBounded, kQ>(t, wg, tq, it, n_eff, scale_log2, acc, m_run,
                                                 l_run);
    }

    attend::quad_sum(l_run);
    const float inv[2] = {l_run[0] > 0.f ? 1.f / l_run[0] : 0.f,
                          l_run[1] > 0.f ? 1.f / l_run[1] : 0.f};

    if (kQ == kScoresBf16 && p.lse != nullptr && tq == 0) {
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

// counterpart of _flash_kernel (bf16 and qk_int8): grid (query tiles, B*H)
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_head_major_tma(const __grid_constant__ TmaParams p) {
  const int bh = blockIdx.y;
  tma_attend<D, kBounded, kQ>(p, bh / p.H, bh % p.H, blockIdx.x * kRows);
}

// counterpart of _flash_packed_kernel and of _flash_packed_stream_kernel
// (bf16, and int8 with q quantised here): grid (H, query tiles, B). The key
// loop streams 128-key tiles whatever the key length, so the TPU's two
// token-major kernels (whole key axis in one block up to 2048 keys; key
// axis streamed beyond) are one kernel here, and the Python wrappers keep
// their two contracts and launch counters.
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_token_major_tma(const __grid_constant__ TmaParams p) {
  tma_attend<D, kBounded, kQ>(p, blockIdx.z, blockIdx.x, blockIdx.y * kRows);
}

constexpr int kModeHeadMajor = 0, kModeTokenMajor = 1;

template <int D, bool kBounded, int kQ, int kMode>
cudaError_t launch_tma(const TmaParams& p, cudaStream_t stream) {
  const int bytes = attend::Smem<D, kQ>::kAlloc;
  const int q_tiles = (p.N + kRows - 1) / kRows;
  cudaError_t err;
  if constexpr (kMode == kModeHeadMajor) {
    err = cudaFuncSetAttribute(flash_fwd_head_major_tma<D, kBounded, kQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_head_major_tma<D, kBounded, kQ>
        <<<dim3(q_tiles, p.B * p.H), kTmaThreads, bytes, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_token_major_tma<D, kBounded, kQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_token_major_tma<D, kBounded, kQ>
        <<<dim3(p.H, q_tiles, p.B), kTmaThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D, bool kBounded>
cudaError_t launch_bf16(const TmaParams& p, int mode, cudaStream_t stream) {
  return mode == kModeHeadMajor
             ? launch_tma<D, kBounded, kScoresBf16, kModeHeadMajor>(p, stream)
             : launch_tma<D, kBounded, kScoresBf16, kModeTokenMajor>(p, stream);
}

}  // namespace

// The kernel's dynamic shared memory in bytes for a head dim (64 or 128)
// and a score form (qk as below; 0 where the pair has no kernel), and its
// threads a block, for the build report.
extern "C" int omnivggt_flash_attention_tma_smem_bytes(int head_dim, int qk) {
  if (qk == kScoresBf16)
    return head_dim == 64 ? attend::Smem<64>::kAlloc
                          : head_dim == 128 ? attend::Smem<128>::kAlloc : 0;
  if (qk == kScoresInt8)
    return head_dim == 64 ? attend::Smem<64, kScoresInt8>::kAlloc
                          : head_dim == 128 ? attend::Smem<128, kScoresInt8>::kAlloc : 0;
  if (qk == kScoresInt8QIn) return head_dim == 64 ? attend::Smem<64, kScoresInt8QIn>::kAlloc : 0;
  return 0;
}

extern "C" int omnivggt_flash_attention_tma_threads() { return kTmaThreads; }

// mode: 0 head-major grid, 1 token-major grid (the packed and the stream
// wrappers).
// qk: 0 bf16 scores; 1 int8 q and k (head-major only) with c; 2 int8 k and
// a bf16 q quantised in the kernel by qinv (token-major, bounded, head dim
// 64: the stream wrapper's int8 form) with c, q8_out optionally receiving
// the quantised q as contiguous (B, N, H, D) int8.
// strides: 12 element strides, (batch, token, head) for q, k, v, o in turn,
// q's and k's counting elements of their own type; each a multiple of 16
// bytes, the bases 16-byte aligned (TMA).
// lse: null, or a contiguous (B, H, N) fp32 output for the backward (bf16
// scores only).
// kv_head_shift: 0 on every real call (a test hook that plants a fault: K
// and V read from head (h + shift) % H).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int omnivggt_flash_attention_fwd(
    int mode, int bounded, int head_dim, int qk, const void* q, const void* k,
    const void* v, void* o, void* lse, const void* c, const void* qinv,
    void* q8_out, const long long* strides, int B, int H, int N, int Nk,
    int kv_static, const void* kv_dynamic, float scale, void* stream,
    int kv_head_shift) {
  const int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((head_dim != 64 && head_dim != 128) || mode < kModeHeadMajor || mode > kModeTokenMajor ||
      qk < kScoresBf16 || qk > kScoresInt8QIn)
    return kInvalid;
  if (qk != kScoresBf16 && (c == nullptr || lse != nullptr)) return kInvalid;
  if (qk == kScoresInt8 && mode != kModeHeadMajor) return kInvalid;
  if (qk == kScoresInt8QIn &&
      (qinv == nullptr || mode != kModeTokenMajor || !bounded || head_dim != 64))
    return kInvalid;
  TmaParams p;
  const bool maps =
      (qk == kScoresInt8 ? sm90::encode_bnhd_map_s8 : sm90::encode_bnhd_map)(
          &p.q_map, q, B, N, H, head_dim, strides[0], strides[1], strides[2], kRows) &&
      (qk == kScoresBf16 ? sm90::encode_bnhd_map : sm90::encode_bnhd_map_s8)(
          &p.k_map, k, B, Nk, H, head_dim, strides[3], strides[4], strides[5], kRows) &&
      sm90::encode_bnhd_map(&p.v_map, v, B, Nk, H, head_dim, strides[6], strides[7],
                            strides[8], kRows);
  if (!maps) return kInvalid;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.N = N; p.Nk = Nk;
  p.kv_static = kv_static;
  p.kv_dynamic = static_cast<const int*>(kv_dynamic);
  p.scale_log2 = scale * kLog2e;
  p.c = static_cast<const float*>(c);
  p.qinv = static_cast<const float*>(qinv);
  p.q8_out = static_cast<int8_t*>(q8_out);
  p.kv_head_shift = ((kv_head_shift % H) + H) % H;
  cudaError_t err;
  if (qk == kScoresBf16) {
    if (head_dim == 64) {
      err = bounded ? launch_bf16<64, true>(p, mode, s) : launch_bf16<64, false>(p, mode, s);
    } else {
      err = bounded ? launch_bf16<128, true>(p, mode, s) : launch_bf16<128, false>(p, mode, s);
    }
  } else if (qk == kScoresInt8) {
    if (head_dim == 64) {
      err = bounded ? launch_tma<64, true, kScoresInt8, kModeHeadMajor>(p, s)
                    : launch_tma<64, false, kScoresInt8, kModeHeadMajor>(p, s);
    } else {
      err = bounded ? launch_tma<128, true, kScoresInt8, kModeHeadMajor>(p, s)
                    : launch_tma<128, false, kScoresInt8, kModeHeadMajor>(p, s);
    }
  } else {
    err = launch_tma<64, true, kScoresInt8QIn, kModeTokenMajor>(p, s);
  }
  return static_cast<int>(err);
}
