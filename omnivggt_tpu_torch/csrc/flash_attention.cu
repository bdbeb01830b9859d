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
// All run one device function, attend_tile(), under two grids (head-major:
// query tiles of one head are neighbours; token-major: the heads of one
// query tile are neighbours) and three ways of forming the scores. The
// packed and the stream wrapper share the token-major kernel: its key loop
// has no length limit, so what tells them apart (the key-length contract,
// the bounded-only rule, the launch counter) lives in Python. The TPU stream kernel's head pairs, zero-padded q
// tiles and 128-lane extended V answer its lane tile and are not carried
// over: a block reads its head's 64 columns out of the token-major rows by
// stride.
//
// What bounds it on this card: two matrix products per (64-query, 64-key)
// tile, 2*64*64*D FLOPs each, against 64*D*2*2 bytes of K and V streamed
// from L2/HBM per tile. At D=64 that is ~64 FLOP/byte before L2 reuse, so
// the kernel is compute-bound on the tensor cores once K/V sit in L2 (they
// do: one head's K+V at N=10992 is 2.8 MB), and its rate is set by how
// fast mma.sync can be fed from shared memory and by the exp work of the
// softmax (64*64 exp per tile per block).
//
// What the design does about it (simple first; wgmma, TMA and warp
// specialisation are later work):
//   - 128 threads = 4 warps; each warp owns 16 query rows and keeps its Q
//     fragments, its 16x64 score tile and its 16xD output accumulator in
//     registers, so scores and probabilities never touch shared memory;
//   - mma.sync.m16n8k16 bf16->fp32 for both products; the fp32 score
//     fragment is re-packed to bf16 in registers as the A operand of P @ V
//     (the accumulator layout of m16n8 equals the A layout of m16n8k16),
//     rounding P to bf16 as the TPU kernel does;
//   - K is staged row-major and V transposed in shared memory, each row
//     padded by 8 bf16, so every fragment load is one conflict-free 32-bit
//     shared load;
//   - q/k/v/o are read and written through explicit (B, N, H, D) strides,
//     so neither the TPU's head-major relayout (to_bhnd) nor its token-major
//     packing exists here;
//   - keys at or past min(Nk, kv_valid) are loaded as zeros and their
//     scores set to -1e30; tiles past that bound are never visited;
//   - bounded mode (qk-normed inputs) uses a fixed max of 0 with the
//     exp(min(s, 80)) clamp; otherwise an online running max. The TPU's
//     ones-column row-sum fold is not carried over: each thread sums its
//     own probabilities and one quad shuffle finishes the row sum;
//   - the int8 forms stage int8 Q and K tiles (a quarter of the bytes of
//     the bf16 pair) and run mma.sync.m16n8k32 s8, whose s32 fragment has
//     the bf16 product's layout, so the softmax and P @ V below it are the
//     same code; the dequantising scalar is folded into the log2 scale;
//   - when training, the bf16 entry points also write the row log-sum-exp
//     (the TPU kernel's return_lse output) to a (B, H, N) fp32 tensor,
//     from the running max and row sum already in registers; the backward
//     kernels (flash_attention_bwd.cu) rebuild P from it.

#include "flash_common.cuh"

namespace {

using namespace flash;

// how the scores are formed
constexpr int kScoresBf16 = 0;    // bf16 q and k
constexpr int kScoresInt8 = 1;    // int8 q and k, quantised by the caller
constexpr int kScoresInt8QIn = 2; // int8 k from the caller, bf16 q quantised here

struct Params {
  const void* q;  // bf16, or int8 with kScoresInt8
  const void* k;  // bf16, or int8 with either int8 form
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // optional (B, H, N) natural-log row LSE, for the backward
  // element strides of the batch, token and head axes; the last axis is
  // contiguous and every stride is a multiple of 8 (16-byte vectors)
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int B, H, N, Nk;
  int kv_static;          // valid keys when kv_dynamic is null (<= Nk)
  const int* kv_dynamic;  // optional device scalar: valid-key count
  float scale_log2;       // D^-0.5 * log2(e)
  const float* c;         // int8 forms: (B, H) q_scale * k_scale * D^-0.5
  const float* qinv;      // kScoresInt8QIn: (B, H) 1 / q_scale
  int8_t* q8_out;         // kScoresInt8QIn: optional contiguous (B, N, H, D)
                          // copy of the quantised q, for checking the grid
};

// One block: 64 query rows of head h of batch b, starting at row q0.
template <int D, bool kBounded, int kQ>
__device__ __forceinline__ void attend_tile(const Params& p, int b, int h, int q0) {
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
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const int8_t* q8b = static_cast<const int8_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const int8_t* k8b = static_cast<const int8_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // Q tile -> shared (borrowing the K buffer) -> A fragments in registers
  uint32_t qf[D / 16][4];
  uint32_t qf8[D / 32][4];
  if constexpr (kQ == kScoresBf16) {
    load_rows<D>(ks, qb, p.q_sn, q0, p.N);
    __syncthreads();
    load_a_fragments<D>(qf, ks, r0, t);
  } else if constexpr (kQ == kScoresInt8) {
    load_rows_s8<D>(ks8, q8b, p.q_sn, q0, p.N);
    __syncthreads();
    load_a_fragments_s8<D>(qf8, ks8, r0, t);
  } else {
    // bf16 Q tile (borrowing the V buffer) -> round(q * qinv), clipped to
    // +-127 (rows the scale did not see may exceed it), half to even
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
  // scores -> log2 units: the softmax scale, or the head's dequantising c
  float score_mul = p.scale_log2;
  if constexpr (kQ != kScoresBf16) score_mul = p.c[b * p.H + h] * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max (log2 units), rows g and g+8
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int k0 = 0; k0 < n_eff; k0 += kBlockK) {
    if constexpr (kQ == kScoresBf16) {
      load_rows<D>(ks, kb, p.k_sn, k0, n_eff);
    } else {
      load_rows_s8<D>(ks8, k8b, p.k_sn, k0, n_eff);
    }
    load_rows_transposed<D>(vt, vb, p.v_sn, k0, n_eff);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
    if constexpr (kQ == kScoresBf16) {
      mma_rows_by_tile<D>(s, qf, ks, g, t);
    } else {
      mma_rows_by_tile_s8<D>(s, qf8, ks8, g, t);
    }

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

  if (p.lse != nullptr && t == 0) {
    // lse = ln(sum_k exp(s_k)) = (m + log2 l) ln 2 in log2 units; bounded
    // mode's max is fixed at 0, so lse = ln l, the TPU kernel's contract.
    // A row with every key masked gets +1e30, so the backward's
    // p = exp(s - lse) is 0 there instead of NaN.
    float* lb = p.lse + ((long long)b * p.H + h) * p.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row < p.N) {
        const float lse2 = kBounded ? log2f(l_run[r]) : m_run[r] + log2f(l_run[r]);
        lb[row] = l_run[r] > 0.f ? lse2 * kLn2 : -kNegInf;
      }
    }
  }

  store_rows<D>(p.o + b * p.o_sb + h * p.o_sh, p.o_sn, acc, inv0, inv1, q0 + r0, p.N, t);
}

// counterpart of _flash_kernel: grid (query tiles, B*H)
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_head_major(Params p) {
  const int bh = blockIdx.y;
  attend_tile<D, kBounded, kQ>(p, bh / p.H, bh % p.H, blockIdx.x * kBlockQ);
}

// counterpart of _flash_packed_kernel and of _flash_packed_stream_kernel:
// grid (H, query tiles, B). The key loop streams 64-key tiles whatever the
// key length, so the TPU's two token-major kernels (whole key axis in one
// block up to 2048 keys; key axis streamed beyond) are one kernel here, and
// the Python wrappers keep their two contracts and launch counters.
template <int D, bool kBounded, int kQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_token_major(Params p) {
  attend_tile<D, kBounded, kQ>(p, blockIdx.z, blockIdx.x, blockIdx.y * kBlockQ);
}

constexpr int kModeHeadMajor = 0, kModeTokenMajor = 1;

template <int D, bool kBounded>
bool launch(const Params& p, int mode, int qk, cudaStream_t stream) {
  const int q_tiles = (p.N + kBlockQ - 1) / kBlockQ;
  const dim3 token_major(p.H, q_tiles, p.B), head_major(q_tiles, p.B * p.H);
  if (mode == kModeHeadMajor && qk == kScoresBf16) {
    flash_fwd_head_major<D, kBounded, kScoresBf16><<<head_major, kThreads, 0, stream>>>(p);
  } else if (mode == kModeHeadMajor && qk == kScoresInt8) {
    flash_fwd_head_major<D, kBounded, kScoresInt8><<<head_major, kThreads, 0, stream>>>(p);
  } else if (mode == kModeTokenMajor && qk == kScoresBf16) {
    flash_fwd_token_major<D, kBounded, kScoresBf16><<<token_major, kThreads, 0, stream>>>(p);
  } else if (mode == kModeTokenMajor && kBounded && D == 64 && qk == kScoresInt8QIn) {
    flash_fwd_token_major<64, true, kScoresInt8QIn><<<token_major, kThreads, 0, stream>>>(p);
  } else {
    return false;
  }
  return true;
}

}  // namespace

// mode: 0 head-major grid, 1 token-major grid (the packed and the stream
// wrappers).
// qk: 0 bf16 scores; 1 int8 q and k (head-major only) with c; 2 int8 k and a
// bf16 q quantised in the kernel by qinv (token-major, bounded, head dim 64:
// the stream wrapper's int8 form) with c, q8_out
// optionally receiving the quantised q as contiguous (B, N, H, D) int8.
// strides: 12 element strides, (batch, token, head) for q, k, v, o in turn,
// q's and k's counting elements of their own type.
// lse: null, or a contiguous (B, H, N) fp32 output for the backward (bf16
// scores only).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int omnivggt_flash_attention_fwd(
    int mode, int bounded, int head_dim, int qk, const void* q, const void* k,
    const void* v, void* o, void* lse, const void* c, const void* qinv,
    void* q8_out, const long long* strides, int B, int H, int N, int Nk,
    int kv_static, const void* kv_dynamic, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.N = N; p.Nk = Nk;
  p.kv_static = kv_static;
  p.kv_dynamic = static_cast<const int*>(kv_dynamic);
  p.scale_log2 = scale * kLog2e;
  p.c = static_cast<const float*>(c);
  p.qinv = static_cast<const float*>(qinv);
  p.q8_out = static_cast<int8_t*>(q8_out);
  if (qk != kScoresBf16 && (p.c == nullptr || p.lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (qk == kScoresInt8QIn && p.qinv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (head_dim == 64) {
    ok = bounded ? launch<64, true>(p, mode, qk, s) : launch<64, false>(p, mode, qk, s);
  } else if (head_dim == 128) {
    ok = bounded ? launch<128, true>(p, mode, qk, s) : launch<128, false>(p, mode, qk, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
