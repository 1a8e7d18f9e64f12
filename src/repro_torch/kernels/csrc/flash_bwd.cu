// Flash-attention backward for Hopper (sm_90a), f32 and bf16: two kernels.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of src/repro/kernels/flash_attention.py (wrapper
// `flash_attention_bwd`) and computes what they compute, flash-v2 style:
// p = exp(s * scale - lse) recomputed from the forward's f32 logsumexp under
// the forward's mask (causal top-left k_pos <= q_pos; window
// k_pos > q_pos - window; k_pos < T), dp = dO . V^T, ds = p * (dp - delta)
// with delta = rowsum(dO * O) given by the caller, and
//   dq = sum_k ds . K * scale        (flash_bwd_dq_kernel)
//   dk = sum_q ds^T . Q * scale, dv = sum_q p^T . dO   (flash_bwd_dkv_kernel)
// with dk/dv summed over the GQA group of q heads that share a kv head.
// f32 inside; dq in q's type, dk/dv in k's type. Inputs are contiguous
// (B, S, Hq, D) / (B, T, Hkv, D); lse and delta (B * Hq, S) f32.
//
// Design. The TPU kernels carry their accumulators across a sequential
// grid axis; here a loop inside the block takes its place, so nothing
// crosses blocks and no atomics are needed: the result does not depend on
// the order blocks run in.
//  * dq: one block per (b * Hq + h, tile of BQ query rows). Q, dO, lse and
//    delta of the tile are loaded once; the loop walks the K/V tiles the
//    rows can reach (wholly masked tiles are never visited, as `pl.when`
//    skips them on the TPU), recomputes s, p, dp, ds and accumulates dq in
//    registers; dq is written once.
//  * dk/dv: one block per (b * Hkv + hk, tile of BK keys). K and V of the
//    tile stay in shared memory; the loop walks the group's q heads times
//    the reachable q tiles (the TPU's third grid axis j = g * nq + iq), so
//    the GQA group is summed inside the block. Pairs that are wholly masked
//    add p = 0 and are skipped.
// Each row (a query row in dq, a key row in dk/dv) is owned by TPR lanes of
// one warp, as in flash_fwd.cu; the p / ds tile passes between the lanes of
// a warp through shared memory.
//
// Bound on the card: at the training path's shape (B = 4, S = T = 1024,
// 16 heads of 64, causal) dq needs 6 * D and dk/dv 8 * D operations per
// valid (q, k) pair, about as long as their bytes (~0.013 and ~0.017 ms on
// an H100 SXM). This first version uses f32 FMAs from shared memory (no
// tensor cores); wgmma, TMA and a fused single-pass backward are later
// work. Shared memory exceeds 48 KB (83 KB / 149 KB for dq, 100 KB /
// 166 KB for dk/dv at D = 64 / 128): each instantiation opts into dynamic
// shared memory once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct BwdParams {
  const void* q;       // (B, S, Hq, D)
  const void* k;       // (B, T, Hkv, D)
  const void* v;       // (B, T, Hkv, D)
  const void* dout;    // (B, S, Hq, D)
  const float* lse;    // (B * Hq, S)
  const float* delta;  // (B * Hq, S)
  void* dq;            // (B, S, Hq, D)
  void* dk;            // (B, T, Hkv, D)
  void* dv;            // (B, T, Hkv, D)
  int B, S, T, Hq, Hkv;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const BwdParams& p, int qi, int t) {
  return t < p.T && (!p.causal || t <= qi) && (p.window <= 0 || t > qi - p.window);
}

template <typename T, int D, int BQ, int TPR, int BK>
__global__ void __launch_bounds__(BQ * TPR) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int NT = BQ * TPR;
  constexpr int KS = D + 1;     // padded row stride (floats): no bank conflicts
  constexpr int PS = BK + 1;
  constexpr int NS = BK / TPR;  // keys per lane
  constexpr int ND = D / TPR;   // dq columns per lane
  static_assert(32 % TPR == 0 && BK % TPR == 0 && D % TPR == 0, "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;             // BQ x KS
  float* dos = qs + BQ * KS;    // BQ x KS
  float* ks = dos + BQ * KS;    // BK x KS
  float* vs = ks + BK * KS;     // BK x KS
  float* dss = vs + BK * KS;    // BQ x PS

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

  const long long q_row = static_cast<long long>(p.Hq) * D;   // stride of a position
  const long long k_row = static_cast<long long>(p.Hkv) * D;
  const long long q_off = static_cast<long long>(b) * p.S * q_row + h * D;
  const long long k_off = static_cast<long long>(b) * p.T * k_row + hk * D;
  const T* qg = static_cast<const T*>(p.q) + q_off;
  const T* dog = static_cast<const T*>(p.dout) + q_off;
  const T* kg = static_cast<const T*>(p.k) + k_off;
  const T* vg = static_cast<const T*>(p.v) + k_off;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int qq = q0 + rr;
    const bool ok = qq < p.S;
    qs[rr * KS + d] = ok ? to_f32(qg[qq * q_row + d]) : 0.f;
    dos[rr * KS + d] = ok ? to_f32(dog[qq * q_row + d]) : 0.f;
  }
  const long long stat = static_cast<long long>(bh) * p.S + qi;
  const float lse_r = row_ok ? p.lse[stat] : 0.f;
  const float delta_r = row_ok ? p.delta[stat] : 0.f;

  // keys this tile of rows can see: [k_begin, k_end)
  const int q_hi = min(q0 + BQ, p.S) - 1;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int kk = i / D, d = i % D;
      const int t = k0 + kk;
      const bool ok = t < k_end;
      ks[kk * KS + d] = ok ? to_f32(kg[t * k_row + d]) : 0.f;
      vs[kk * KS + d] = ok ? to_f32(vg[t * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    if (row_ok) {
      for (int d = 0; d < D; ++d) {
        const float qv = qs[r * KS + d];
        const float dov = dos[r * KS + d];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j] += qv * ks[(l + j * TPR) * KS + d];
          dp[j] += dov * vs[(l + j * TPR) * KS + d];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = k0 + l + j * TPR;
      const float pj = row_ok && visible(p, qi, t) ? __expf(s[j] * p.scale - lse_r) : 0.f;
      dss[r * PS + l + j * TPR] = pj * (dp[j] - delta_r);
    }
    __syncwarp();  // the row's ds is written by lanes of this warp only

    if (row_ok) {
      const int n = min(BK, k_end - k0);
      for (int kk = 0; kk < n; ++kk) {
        const float dsv = dss[r * PS + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] += dsv * ks[kk * KS + l + j * TPR];
      }
    }
  }

  if (row_ok) {
    T* dqg = static_cast<T*>(p.dq) + q_off + qi * q_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) dqg[l + j * TPR] = from_f32<T>(acc[j] * p.scale);
  }
}

template <typename T, int D, int BK, int TPR, int BQ>
__global__ void __launch_bounds__(BK * TPR) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int NT = BK * TPR;
  constexpr int KS = D + 1;
  constexpr int PS = BQ + 1;
  constexpr int NS = BQ / TPR;  // query rows per lane
  constexpr int ND = D / TPR;   // dk/dv columns per lane
  static_assert(32 % TPR == 0 && BQ % TPR == 0 && D % TPR == 0, "tile shape");

  extern __shared__ float smem[];
  float* ks = smem;             // BK x KS
  float* vs = ks + BK * KS;     // BK x KS
  float* qs = vs + BK * KS;     // BQ x KS
  float* dos = qs + BQ * KS;    // BQ x KS
  float* pss = dos + BQ * KS;   // BK x PS: p^T
  float* dss = pss + BK * PS;   // BK x PS: ds^T
  float* lses = dss + BK * PS;  // BQ
  float* dls = lses + BQ;       // BQ

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv;
  const int hk = bhk % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int l = tid % TPR;
  const int kj = k0 + r;
  const bool key_ok = kj < p.T;

  const long long q_row = static_cast<long long>(p.Hq) * D;
  const long long k_row = static_cast<long long>(p.Hkv) * D;
  const long long k_off = static_cast<long long>(b) * p.T * k_row + hk * D;
  const T* kg = static_cast<const T*>(p.k) + k_off;
  const T* vg = static_cast<const T*>(p.v) + k_off;

  for (int i = tid; i < BK * D; i += NT) {
    const int kk = i / D, d = i % D;
    const int t = k0 + kk;
    const bool ok = t < p.T;
    ks[kk * KS + d] = ok ? to_f32(kg[t * k_row + d]) : 0.f;
    vs[kk * KS + d] = ok ? to_f32(vg[t * k_row + d]) : 0.f;
  }

  // query rows that can see a key of this tile: [q_begin, q_end)
  const int k_hi = min(k0 + BK, p.T) - 1;
  int q_begin = p.causal ? k0 : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = p.window > 0 ? min(p.S, k_hi + p.window) : p.S;

  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * p.Hq + h;
    const long long q_off = static_cast<long long>(b) * p.S * q_row + h * D;
    const T* qg = static_cast<const T*>(p.q) + q_off;
    const T* dog = static_cast<const T*>(p.dout) + q_off;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's Q/dO/p/ds are no longer read
      for (int i = tid; i < BQ * D; i += NT) {
        const int rr = i / D, d = i % D;
        const int qq = q0 + rr;
        const bool ok = qq < q_end;
        qs[rr * KS + d] = ok ? to_f32(qg[qq * q_row + d]) : 0.f;
        dos[rr * KS + d] = ok ? to_f32(dog[qq * q_row + d]) : 0.f;
      }
      for (int i = tid; i < BQ; i += NT) {
        const int qq = q0 + i;
        const bool ok = qq < q_end;
        lses[i] = ok ? p.lse[bh * p.S + qq] : 0.f;
        dls[i] = ok ? p.delta[bh * p.S + qq] : 0.f;
      }
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
      if (key_ok) {
        for (int d = 0; d < D; ++d) {
          const float kv = ks[r * KS + d];
          const float vv = vs[r * KS + d];
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            s[j] += kv * qs[(l + j * TPR) * KS + d];
            dp[j] += vv * dos[(l + j * TPR) * KS + d];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = l + j * TPR;
        const int qq = q0 + c;
        const float pj = key_ok && qq < q_end && visible(p, qq, kj)
                             ? __expf(s[j] * p.scale - lses[c]) : 0.f;
        pss[r * PS + c] = pj;
        dss[r * PS + c] = pj * (dp[j] - dls[c]);
      }
      __syncwarp();  // the key row's p / ds are written by lanes of this warp only

      if (key_ok) {
        const int n = min(BQ, q_end - q0);
        for (int qq = 0; qq < n; ++qq) {
          const float pv = pss[r * PS + qq];
          const float dsv = dss[r * PS + qq];
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            dv_acc[j] += pv * dos[qq * KS + l + j * TPR];
            dk_acc[j] += dsv * qs[qq * KS + l + j * TPR];
          }
        }
      }
    }
  }

  if (key_ok) {
    T* dkg = static_cast<T*>(p.dk) + k_off + kj * k_row;
    T* dvg = static_cast<T*>(p.dv) + k_off + kj * k_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkg[l + j * TPR] = from_f32<T>(dk_acc[j] * p.scale);
      dvg[l + j * TPR] = from_f32<T>(dv_acc[j]);
    }
  }
}

constexpr int kRows = 64;  // BQ = BK
constexpr int kLanes = 4;  // lanes per row

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (4 * kRows * (D + 1) + kRows * (kRows + 1));
  auto kernel = flash_bwd_dq_kernel<T, D, kRows, kLanes, kRows>;
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.Hq, (p.S + kRows - 1) / kRows);
  kernel<<<grid, kRows * kLanes, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (4 * kRows * (D + 1) + 2 * kRows * (kRows + 1) + 2 * kRows);
  auto kernel = flash_bwd_dkv_kernel<T, D, kRows, kLanes, kRows>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.Hkv, (p.T + kRows - 1) / kRows);
  kernel<<<grid, kRows * kLanes, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool DQ>
int flash_bwd(const BwdParams& p, int D, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.T <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return DQ ? launch_dq<T, 32>(p, st) : launch_dkv<T, 32>(p, st);
    case 64: return DQ ? launch_dq<T, 64>(p, st) : launch_dkv<T, 64>(p, st);
    case 128: return DQ ? launch_dq<T, 128>(p, st) : launch_dkv<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,       \
      const void *delta
#define BWD_DIMS                                                                        \
  int B, int S, int T, int Hq, int Hkv, int D, int causal, int window, float scale,     \
      void *stream
#define BWD_PARAMS(dq, dk, dv)                                                          \
  BwdParams {                                                                           \
    q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),    \
        dq, dk, dv, B, S, T, Hq, Hkv, causal, window, scale                             \
  }

extern "C" int repro_flash_bwd_dq_f32(BWD_ARGS, void* dq, BWD_DIMS) {
  return flash_bwd<float, true>(BWD_PARAMS(dq, nullptr, nullptr), D, stream);
}
extern "C" int repro_flash_bwd_dq_bf16(BWD_ARGS, void* dq, BWD_DIMS) {
  return flash_bwd<__nv_bfloat16, true>(BWD_PARAMS(dq, nullptr, nullptr), D, stream);
}
extern "C" int repro_flash_bwd_dkv_f32(BWD_ARGS, void* dk, void* dv, BWD_DIMS) {
  return flash_bwd<float, false>(BWD_PARAMS(nullptr, dk, dv), D, stream);
}
extern "C" int repro_flash_bwd_dkv_bf16(BWD_ARGS, void* dk, void* dv, BWD_DIMS) {
  return flash_bwd<__nv_bfloat16, false>(BWD_PARAMS(nullptr, dk, dv), D, stream);
}
