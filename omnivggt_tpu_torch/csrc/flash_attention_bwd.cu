// Non-causal flash-attention backward for Hopper (sm_90a): two kernels,
// bf16 in, fp32 accumulation, bf16 out. Plain C interface, loaded with
// ctypes from omnivggt_tpu_torch/ops/kernels/flash_attention.py.
//
// Replaces the two backward TPU kernels of
// omnivggt_tpu/ops/pallas/flash_attention.py (reached through
// _flash_backward from every custom_vjp wrapper, head-major and packed):
//   - _flash_bwd_dq_kernel:  dq = scale * sum_k ds k;
//   - _flash_bwd_dkv_kernel: dv = sum_q p^T dO, dk = scale * sum_q ds^T q;
// with p = exp(s - lse) rebuilt from the forward's saved row LSE (s clamped
// at 80 in bounded mode, the clamp passing gradients straight through, as
// _bwd_recompute does), ds = p * (dO v^T - delta) and
// delta = rowsum(dO * O). Keys at or past min(Nk, kv_valid) get p = 0,
// which zeroes their dq contribution and their own dk/dv rows.
//
// What bounds it on this card: per (64-query, 64-key) tile the dq kernel
// runs three products (S = Q K^T, dP = dO V^T, dQ += dS K) and the dk/dv
// kernel four (S^T, dP^T, dV += P^T dO, dK += dS^T Q), 2*64*64*D FLOPs
// each, against 2-4 strided (64, D) bf16 tiles streamed per tile. At D=64
// that is ~64-96 FLOP/byte before L2 reuse, and one head's operands fit L2
// (Q, K, V, O, dO at N=5496 are 3.5 MB), so both kernels are bound by the
// tensor cores and by how fast mma.sync is fed from shared memory, plus
// one exp per score.
//
// What the design does about it (simple first; wgmma, TMA and warp
// specialisation are later work):
//   - the TPU grid's inner "arbitrary" axis becomes a loop inside the
//     block: dq blocks own (b*h, 64 queries) and loop over key tiles, dk/dv
//     blocks own (b*h, 64 keys) and loop over query tiles, so every sum is
//     kept in registers and no atomics are needed: the reduction order is
//     fixed and the result deterministic, as on the TPU;
//   - 128 threads = 4 warps of 16 rows; the scores, probabilities and ds
//     never leave registers: each fp32 score fragment is re-packed to bf16
//     as the A operand of the next product (rounding p and ds to bf16, as
//     the TPU kernels do);
//   - operands that appear as the B operand of a row-by-tile product are
//     staged row-major, those of a score-by-tile product transposed, each
//     row padded by 8 bf16 so that fragment loads are conflict-free;
//   - delta = rowsum(dO * O) is computed once per query row by the dq
//     kernel (it holds the dO tile already) and written to a (B, H, N)
//     fp32 buffer that the dk/dv kernel, launched next on the same stream,
//     reads: O is read once, not once per key tile;
//   - q/k/v/o/dO are read through (B, N, H, D) strides (v in place from the
//     fused qkv tensor); dq/dk/dv are written the same way, in bf16.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, N) natural-log row LSE of the forward
  float* delta;      // (B, H, N) rowsum(dO * O): dq kernel writes, dkv reads
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // element strides (batch, token, head); the last axis is contiguous
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
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

// p = exp(min?(s * scale) - lse) in log2 units, 0 where masked
template <bool kBounded>
__device__ __forceinline__ float prob(float s, float scale_log2, float lse2, bool valid) {
  float x = s * scale_log2;
  if (kBounded) x = fminf(x, kClampLog2);
  return valid ? exp2f(x - lse2) : 0.f;
}

template <int D>
constexpr int dq_smem_bytes() {
  // K row-major, K transposed, V row-major
  return 2 * (2 * kBlockK * (D + kPad) + D * (kBlockK + kPad));
}

template <int D>
constexpr int dkv_smem_bytes() {
  // Q and dO, each row-major and transposed, plus lse and delta rows
  return 2 * 2 * (kBlockQ * (D + kPad) + D * (kBlockQ + kPad)) + 2 * kBlockQ * 4;
}

// counterpart of _flash_bwd_dq_kernel: grid (query tiles, B*H)
template <int D, bool kBounded>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kt = ks + kBlockK * (D + kPad);
  __nv_bfloat16* vs = kt + D * (kBlockK + kPad);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int n_eff = valid_keys(p);

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long row_base = ((long long)b * p.H + h) * p.N;

  // Q and dO fragments into registers; O shares the transposed buffer's
  // space (64 x (D + kPad) fits in D x (64 + kPad)) for delta
  load_rows<D>(ks, qb, p.q_sn, q0, p.N);
  load_rows<D>(vs, dob, p.do_sn, q0, p.N);
  load_rows<D>(kt, ob, p.o_sn, q0, p.N);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_fragments<D>(qf, ks, r0, t);
  load_a_fragments<D>(dof, vs, r0, t);
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const __nv_bfloat16* dr = vs + (r0 + 8 * r) * (D + kPad);
    const __nv_bfloat16* orow = kt + (r0 + 8 * r) * (D + kPad);
    float sum = 0.f;
    for (int c = t * 2; c < D; c += 8) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dr + c));
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
      sum += a.x * o.x + a.y * o.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
    const int row = q0 + r0 + 8 * r;
    lse2[r] = row < p.N ? p.lse[row_base + row] * kLog2e : 0.f;
    if (t == 0 && row < p.N) p.delta[row_base + row] = sum;
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < n_eff; k0 += kBlockK) {
    load_rows<D>(ks, kb, p.k_sn, k0, n_eff);
    load_rows_transposed<D>(kt, kb, p.k_sn, k0, n_eff);
    load_rows<D>(vs, vb, p.v_sn, k0, n_eff);
    __syncthreads();

    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
    mma_rows_by_tile<D>(s, qf, ks, g, t);   // S = Q K^T
    mma_rows_by_tile<D>(dp, dof, vs, g, t); // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        const float pe = prob<kBounded>(s[j][e], p.scale_log2, lse2[e >> 1], col < n_eff);
        s[j][e] = pe * (dp[j][e] - delta[e >> 1]);  // ds
      }
    }
    mma_scores_by_tile<D>(acc, s, kt, g, t);  // dQ += dS K
    __syncthreads();
  }

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, p.scale, p.scale,
                q0 + r0, p.N, t);
}

// counterpart of _flash_bwd_dkv_kernel: grid (key tiles, B*H)
template <int D, bool kBounded>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qt = qs + kBlockQ * (D + kPad);
  __nv_bfloat16* dos = qt + D * (kBlockQ + kPad);
  __nv_bfloat16* dot = dos + kBlockQ * (D + kPad);
  float* lse_s = reinterpret_cast<float*>(dot + D * (kBlockQ + kPad));
  float* delta_s = lse_s + kBlockQ;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int n_eff = valid_keys(p);

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long row_base = ((long long)b * p.H + h) * p.N;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  if (k0 < n_eff) {  // a tile of masked keys keeps dk = dv = 0
    // K and V fragments (this warp's 16 keys) into registers
    load_rows<D>(qs, kb, p.k_sn, k0, n_eff);
    load_rows<D>(dos, vb, p.v_sn, k0, n_eff);
    __syncthreads();
    uint32_t kf[D / 16][4], vf[D / 16][4];
    load_a_fragments<D>(kf, qs, r0, t);
    load_a_fragments<D>(vf, dos, r0, t);
    __syncthreads();
    const bool key_ok[2] = {k0 + r0 < n_eff, k0 + r0 + 8 < n_eff};

    for (int q0 = 0; q0 < p.N; q0 += kBlockQ) {
      load_rows<D>(qs, qb, p.q_sn, q0, p.N);
      load_rows_transposed<D>(qt, qb, p.q_sn, q0, p.N);
      load_rows<D>(dos, dob, p.do_sn, q0, p.N);
      load_rows_transposed<D>(dot, dob, p.do_sn, q0, p.N);
      if (threadIdx.x < kBlockQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.N ? p.lse[row_base + row] * kLog2e : 0.f;
        delta_s[threadIdx.x] = row < p.N ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
      mma_rows_by_tile<D>(s, kf, qs, g, t);    // S^T = K Q^T
      mma_rows_by_tile<D>(dp, vf, dos, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + t * 2 + (e & 1);
          const float pe = prob<kBounded>(s[j][e], p.scale_log2, lse_s[c],
                                          key_ok[e >> 1] && q0 + c < p.N);
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - delta_s[c]);  // dS^T
        }
      }
      mma_scores_by_tile<D>(dv, s, dot, g, t);  // dV += P^T dO
      mma_scores_by_tile<D>(dk, dp, qt, g, t);  // dK += dS^T Q
      __syncthreads();
    }
  }

  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, p.scale, p.scale,
                k0 + r0, p.Nk, t);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, 1.f, 1.f, k0 + r0,
                p.Nk, t);
}

template <typename Kernel>
int launch(Kernel kernel, int tiles, const BwdParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, p.B * p.H), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const BwdParams& p, int bounded, cudaStream_t s) {
  const int tiles = (p.N + kBlockQ - 1) / kBlockQ;
  return bounded ? launch(flash_bwd_dq<D, true>, tiles, p, dq_smem_bytes<D>(), s)
                 : launch(flash_bwd_dq<D, false>, tiles, p, dq_smem_bytes<D>(), s);
}

template <int D>
int launch_dkv(const BwdParams& p, int bounded, cudaStream_t s) {
  const int tiles = (p.Nk + kBlockK - 1) / kBlockK;
  return bounded ? launch(flash_bwd_dkv<D, true>, tiles, p, dkv_smem_bytes<D>(), s)
                 : launch(flash_bwd_dkv<D, false>, tiles, p, dkv_smem_bytes<D>(), s);
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta,
                      const long long* st, int B, int H, int N, int Nk,
                      int kv_static, const void* kv_dynamic, float scale) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.q_sb = st[0]; p.q_sn = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sn = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sn = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_sn = st[10]; p.do_sh = st[11];
  p.B = B; p.H = H; p.N = N; p.Nk = Nk;
  p.kv_static = kv_static;
  p.kv_dynamic = static_cast<const int*>(kv_dynamic);
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// strides: 18 element strides, (batch, token, head) for q, k, v, dO, o, dq.
// Writes dq and delta (B, H, N) fp32. Returns the cudaError_t of the launch.
extern "C" int omnivggt_flash_attention_bwd_dq(
    int bounded, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* delta, void* dq,
    const long long* strides, int B, int H, int N, int Nk, int kv_static,
    const void* kv_dynamic, float scale, void* stream) {
  BwdParams p = make_params(q, k, v, o, dout, lse, delta, strides, B, H, N, Nk,
                            kv_static, kv_dynamic, scale);
  p.o_sb = strides[12]; p.o_sn = strides[13]; p.o_sh = strides[14];
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = strides[15]; p.dq_sn = strides[16]; p.dq_sh = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dq<64>(p, bounded, s);
  if (head_dim == 128) return launch_dq<128>(p, bounded, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 18 element strides, (batch, token, head) for q, k, v, dO, dk, dv.
// Reads delta as the dq kernel wrote it. Returns the cudaError_t.
extern "C" int omnivggt_flash_attention_bwd_dkv(
    int bounded, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int N, int Nk, int kv_static,
    const void* kv_dynamic, float scale, void* stream) {
  BwdParams p = make_params(q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
                            strides, B, H, N, Nk, kv_static, kv_dynamic, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dk_sb = strides[12]; p.dk_sn = strides[13]; p.dk_sh = strides[14];
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dv_sb = strides[15]; p.dv_sn = strides[16]; p.dv_sh = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dkv<64>(p, bounded, s);
  if (head_dim == 128) return launch_dkv<128>(p, bounded, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
