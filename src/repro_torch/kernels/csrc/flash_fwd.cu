// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention_fwd`) and
// computes what it computes: online-softmax attention with f32 running max,
// sum and accumulator; causal mask aligned top-left (k_pos <= q_pos, both
// counted from 0); sliding window k_pos > q_pos - window; a per-batch-row
// valid length kv_len (k_pos < kv_len); GQA by kv head = q head / group;
// scale 1/sqrt(D). Outputs O (B, S, Hq, D) in the input type and the f32
// row logsumexp (B*Hq, S).
//
// Design. One block per (b*Hq + h, tile of BQ query rows). A loop over K/V
// tiles of BK keys, staged in shared memory as f32, takes the place of the
// TPU's sequential kv grid axis. Each query row is owned by TPR consecutive
// lanes of one warp: lane l computes the scores of keys l, l+TPR, ... and the
// accumulator columns l, l+TPR, ...; row max and row sum are reduced with
// warp shuffles. Tiles that causal, window or kv_len mask wholly are never
// visited (the loop runs over [k_begin, k_end) only), and the ragged edges
// of S and T are masked in the kernel, so any S and T work. Masked keys get
// p = 0 explicitly; for every row with at least one valid key this equals
// the TPU kernel's -1e30 fill, whose wholly masked early tiles are cancelled
// later by alpha. A row with no valid key is outside the contract; it writes
// 0 and lse = -1e30, as the plain version does. kv_len < 1 traps.
//
// Bound on the card: prefill (S = T = 1024, D = 64) needs about as long for
// its bytes as for its operations, 4*S*T*D/2 per head under the causal mask
// (~0.01 ms each on an H100 SXM); decode (S = 1) is bound by the bytes of the
// valid K/V prefix. This first version uses f32 FMAs from
// shared memory (no tensor cores): it is right and simple; wgmma, TMA and
// split-KV decode are later work. Two tile shapes are compiled: BQ = 64
// rows x 4 lanes for prefill, BQ = 4 rows x 32 lanes for S <= 4 (decode), so
// that a decode block spends its threads on loading K/V, not on empty rows
// (4 rows x 16 lanes at D = 80, zamba2's shared attention block, so that the
// lanes of a row split its columns evenly). Head dims 32, 64, 80 and 128 are
// compiled; shared memory is 78.6 KB a block at D = 80 and 115.5 KB at 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;            // (B, S, Hq, D), contiguous
  float* lse;         // (B * Hq, S), contiguous
  const int* kv_len;  // (B,) or nullptr (= T)
  int B, S, T, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // strides in elements; the last dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
};

template <typename T, int D, int BQ, int TPR, int BK>
__global__ void __launch_bounds__(BQ * TPR) flash_fwd_kernel(const FlashParams p) {
  constexpr int NT = BQ * TPR;
  constexpr int KS = D + 1;     // padded row stride (floats): no bank conflicts
  constexpr int PS = BK + 1;
  constexpr int NS = BK / TPR;  // scores per lane
  constexpr int ND = D / TPR;   // accumulator columns per lane
  static_assert(32 % TPR == 0 && BK % TPR == 0 && D % TPR == 0, "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;             // BQ x KS
  float* ks = qs + BQ * KS;     // BK x KS
  float* vs = ks + BK * KS;     // BK x D
  float* ps = vs + BK * D;      // BQ x PS

  const int bh = blockIdx.x;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int l = tid % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < p.S;
  const int kv_len = p.kv_len ? min(p.kv_len[b], p.T) : p.T;
  // a device-resident kv_len is not read by the wrapper: check it here. A
  // trap fails the launch (the next CUDA call reports it); assert() instead
  // cost decode ~15 % on an H100 SXM, for its call frame.
  if (kv_len < 1) __trap();

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int qq = q0 + rr;
    qs[rr * KS + d] = qq < p.S ? to_f32(qg[qq * p.q_ss + d]) : 0.f;
  }

  // keys this tile of rows can see: [k_begin, k_end)
  const int q_hi = min(q0 + BQ, p.S) - 1;
  int k_end = kv_len;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m_i = kNegInf, l_i = 0.f;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int kk = i / D, d = i % D;
      const int t = k0 + kk;
      const bool ok = t < k_end;
      ks[kk * KS + d] = ok ? to_f32(kg[t * p.k_ss + d]) : 0.f;
      vs[kk * D + d] = ok ? to_f32(vg[t * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    if (row_ok) {
      for (int d = 0; d < D; ++d) {
        const float qv = qs[r * KS + d];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j] += qv * ks[(l + j * TPR) * KS + d];
      }
    }
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = k0 + l + j * TPR;
      const bool valid = t < k_end && (!p.causal || t <= qi) &&
                         (p.window <= 0 || t > qi - p.window);
      s[j] = valid ? s[j] * p.scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_i, m_tile);
    const float alpha = __expf(m_i - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float pj = s[j] == kNegInf ? 0.f : __expf(s[j] - m_new);
      ps[r * PS + l + j * TPR] = pj;
      lsum += pj;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    l_i = l_i * alpha + lsum;
    m_i = m_new;
    __syncwarp();  // the row's P is written by lanes of this warp only

    if (row_ok) {
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] *= alpha;
      const int n = min(BK, k_end - k0);
      for (int kk = 0; kk < n; ++kk) {
        const float pv = ps[r * PS + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] += pv * vs[kk * D + l + j * TPR];
      }
    }
  }

  if (row_ok) {
    const float denom = l_i == 0.f ? 1.f : l_i;
    T* og = static_cast<T*>(p.o) + ((static_cast<long long>(b) * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) og[l + j * TPR] = from_f32<T>(acc[j] / denom);
    if (l == 0) p.lse[static_cast<long long>(bh) * p.S + qi] = m_i + logf(denom);
  }
}

template <typename T, int D, int BQ, int TPR, int BK>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BQ, TPR, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.Hq, (p.S + BQ - 1) / BQ);
  flash_fwd_kernel<T, D, BQ, TPR, BK><<<grid, BQ * TPR, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_for_rows(const FlashParams& p, cudaStream_t stream) {
  // a decode row's lanes split its D columns evenly: 16 lanes for D = 80
  constexpr int kDecodeLanes = D % 32 == 0 ? 32 : 16;
  if (p.S <= 4) return launch<T, D, 4, kDecodeLanes, 64>(p, stream);
  return launch<T, D, 64, 4, 64>(p, stream);
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              const void* kv_len, int B, int S, int T_, int Hq, int Hkv, int D,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T_ <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  FlashParams p{q, k, v, o, static_cast<float*>(lse), static_cast<const int*>(kv_len),
                B, S, T_, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_for_rows<T, 32>(p, st);
    case 64: return launch_for_rows<T, 64>(p, st);
    case 80: return launch_for_rows<T, 80>(p, st);
    case 128: return launch_for_rows<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define FLASH_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *o, void *lse, const void *kv_len,    \
      int B, int S, int T, int Hq, int Hkv, int D, long long q_sb, long long q_ss,        \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,     \
      long long v_ss, long long v_sh, int causal, int window, float scale, void *stream
#define FLASH_CALL                                                                        \
  q, k, v, o, lse, kv_len, B, S, T, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, \
      v_ss, v_sh, causal, window, scale, stream

extern "C" int repro_flash_fwd_f32(FLASH_ARGS) { return flash_fwd<float>(FLASH_CALL); }
extern "C" int repro_flash_fwd_bf16(FLASH_ARGS) { return flash_fwd<__nv_bfloat16>(FLASH_CALL); }
