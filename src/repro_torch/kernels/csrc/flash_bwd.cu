// Flash-attention backward for Hopper (sm_90a): dq and dk/dv, each in bf16
// on tensor cores and in f32 on FMAs.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of src/repro/kernels/flash_attention.py (wrapper
// `flash_attention_bwd`) and computes what they compute, flash-v2 style:
// p = exp(s * scale - lse) recomputed from the forward's f32 logsumexp under
// the forward's mask (causal top-left k_pos <= q_pos; window
// k_pos > q_pos - window; k_pos < T), dp = dO . V^T, ds = p * (dp - delta)
// with delta = rowsum(dO * O) given by the caller, and
//   dq = sum_k ds . K * scale                          (the dq kernels)
//   dk = sum_q ds^T . Q * scale, dv = sum_q p^T . dO   (the dk/dv kernels)
// with dk/dv summed over the GQA group of q heads that share a kv head.
// dq in q's type, dk/dv in k's type. Inputs are contiguous (B, S, Hq, D) /
// (B, T, Hkv, D); lse and delta (B * Hq, S) f32. D is one of 32, 64, 80,
// 96, 128, 256.
//
// The TPU kernels carry their accumulators across a sequential grid axis;
// here a loop inside the block takes its place, so nothing crosses blocks
// and no atomics are needed: the result does not depend on the order blocks
// run in. Tiles that the masks cover wholly are never visited (`pl.when`
// skips them on the TPU); the mask is applied only on tiles that the causal
// diagonal, the window edge or the end of S or T cuts.
//
// 1. bf16 (`flash_bwd_dq_tc_kernel`, `flash_bwd_dkv_tc_kernel`). Bound on an
//    H100 SXM by operations at the train shape (B = 4, S = T = 1024, 16
//    heads of 64, causal): 6*D (dq) and 8*D (dk/dv) per valid pair at 989
//    TFLOP/s, ~0.013 and ~0.017 ms; only tensor cores reach that. Both
//    kernels keep one tile resident, stream the other through a ring of TMA
//    loads (a producer warp, full/empty mbarriers, as the forward's
//    tc_prefill) and run every product as wgmma with f32 accumulators in
//    registers; the operand layouts are hopper.cuh's (128-byte swizzle at
//    D = 64, 128, 256; 8-column groups at D = 32, 80, 96). P and dS are
//    rounded to bf16 in registers to be the A operand of the second
//    products, as the forward rounds P for P·V.
//    * dq: one block per (b*Hq + h, tile of 64*WG query rows; WG = 2
//      consumer warpgroups, 1 at D = 256), longest causal tile first. Q,
//      dO and each row's lse and delta are loaded once; the ring streams
//      the reachable K/V tiles of 64 keys. Per tile and warpgroup:
//      S = Q·Kᵀ and dP = dO·Vᵀ (wgmma m64n64k16, both operands K-major from
//      shared memory), P and dS in the accumulators' registers, then
//      dq += dS·K with A = dS from registers and K read MN-major (the form
//      of P·V in the forward). dq is written once, times scale.
//    * dk/dv: one block per (b*Hkv + hk, tile of 64*WG keys; WG = 2 at
//      D <= 80, 1 above, by registers), with K and V resident. The ring
//      streams the (Q, dO) tiles of 64 rows of every q head of the GQA
//      group, each with its rows' lse and delta (written into the stage by
//      the producer warp), so the group is summed inside the block. Keys
//      are the M dimension: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ and dSᵀ stay in
//      registers as A, and dV += Pᵀ·dO, dK += dSᵀ·Q read dO and Q MN-major.
//      dK and dV take 2 x D/2 f32 registers a thread; at D = 256 that is
//      more than a thread has, so a block there writes 128 of the 256
//      columns (gridDim.z = 2) and the two blocks of a key tile each
//      recompute Sᵀ and dPᵀ.
//    Shared memory at D = 256: dq 192 KB (Q 32 + dO 32 + two 64 KB K/V
//    stages), dk/dv 193 KB (K 32 + V 32 + two 64 KB Q/dO stages).
// 2. f32 (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`): f32 FMAs from
//    shared memory. Each row (a query row in dq, a key row in dk/dv) is
//    owned by 4 lanes of one warp; the p / ds tile passes between the
//    lanes of a warp through shared memory. Tiles of 64 rows, 32 at
//    D = 256 (136 / 137 KB of shared memory there, where 64 would need
//    280 / 296 KB).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

// ===========================================================================
// 2. f32: FMAs from shared memory
// ===========================================================================
__device__ __forceinline__ bool visible(const BwdParams& p, int qi, int t) {
  return t < p.T && (!p.causal || t <= qi) && (p.window <= 0 || t > qi - p.window);
}

template <int D, int BQ, int TPR, int BK>
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
  const float* qg = static_cast<const float*>(p.q) + q_off;
  const float* dog = static_cast<const float*>(p.dout) + q_off;
  const float* kg = static_cast<const float*>(p.k) + k_off;
  const float* vg = static_cast<const float*>(p.v) + k_off;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int qq = q0 + rr;
    const bool ok = qq < p.S;
    qs[rr * KS + d] = ok ? qg[qq * q_row + d] : 0.f;
    dos[rr * KS + d] = ok ? dog[qq * q_row + d] : 0.f;
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
      ks[kk * KS + d] = ok ? kg[t * k_row + d] : 0.f;
      vs[kk * KS + d] = ok ? vg[t * k_row + d] : 0.f;
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
    float* dqg = static_cast<float*>(p.dq) + q_off + qi * q_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) dqg[l + j * TPR] = acc[j] * p.scale;
  }
}

template <int D, int BK, int TPR, int BQ>
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
  const float* kg = static_cast<const float*>(p.k) + k_off;
  const float* vg = static_cast<const float*>(p.v) + k_off;

  for (int i = tid; i < BK * D; i += NT) {
    const int kk = i / D, d = i % D;
    const int t = k0 + kk;
    const bool ok = t < p.T;
    ks[kk * KS + d] = ok ? kg[t * k_row + d] : 0.f;
    vs[kk * KS + d] = ok ? vg[t * k_row + d] : 0.f;
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
    const float* qg = static_cast<const float*>(p.q) + q_off;
    const float* dog = static_cast<const float*>(p.dout) + q_off;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's Q/dO/p/ds are no longer read
      for (int i = tid; i < BQ * D; i += NT) {
        const int rr = i / D, d = i % D;
        const int qq = q0 + rr;
        const bool ok = qq < q_end;
        qs[rr * KS + d] = ok ? qg[qq * q_row + d] : 0.f;
        dos[rr * KS + d] = ok ? dog[qq * q_row + d] : 0.f;
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
    float* dkg = static_cast<float*>(p.dk) + k_off + kj * k_row;
    float* dvg = static_cast<float*>(p.dv) + k_off + kj * k_row;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkg[l + j * TPR] = dk_acc[j] * p.scale;
      dvg[l + j * TPR] = dv_acc[j];
    }
  }
}

constexpr int kLanes = 4;  // lanes per row
// rows of a tile (BQ = BK): 32 at D = 256, where 64 would pass 227 KB
template <int D>
constexpr int fma_rows() { return D > 128 ? 32 : 64; }

template <int D>
cudaError_t launch_dq_fma(const BwdParams& p, cudaStream_t stream) {
  constexpr int R = fma_rows<D>();
  constexpr int smem = static_cast<int>(sizeof(float)) * (4 * R * (D + 1) + R * (R + 1));
  auto kernel = flash_bwd_dq_kernel<D, R, kLanes, R>;
  if (cudaError_t err = hopper::begin("flash_bwd_dq_kernel")) return err;
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t opted = hopper::opt_in(kernel, smem);
  const dim3 grid(p.B * p.Hq, (p.S + R - 1) / R);
  return hopper::launch("flash_bwd_dq_kernel", kernel, opted, grid, R * kLanes, smem, stream,
                        p);
}

template <int D>
cudaError_t launch_dkv_fma(const BwdParams& p, cudaStream_t stream) {
  constexpr int R = fma_rows<D>();
  constexpr int smem =
      static_cast<int>(sizeof(float)) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R);
  auto kernel = flash_bwd_dkv_kernel<D, R, kLanes, R>;
  if (cudaError_t err = hopper::begin("flash_bwd_dkv_kernel")) return err;
  static const cudaError_t opted = hopper::opt_in(kernel, smem);
  const dim3 grid(p.B * p.Hkv, (p.T + R - 1) / R);
  return hopper::launch("flash_bwd_dkv_kernel", kernel, opted, grid, R * kLanes, smem, stream,
                        p);
}

// ===========================================================================
// 1. bf16: TMA + wgmma
// ===========================================================================
namespace tc {

constexpr int BT = 64;   // rows of a streamed tile: K/V keys (dq), Q/dO rows (dk/dv)

struct Params {
  __nv_bfloat16* out0;   // dq, or dk
  __nv_bfloat16* out1;   // dv
  const float* lse;
  const float* delta;
  int S, T, Hq, Hkv, causal, window;
  float scale, scale_log2;   // 1/sqrt(D), and times log2(e)
  // which tensor-map dim (1..3) holds the sequence, the head and the batch
  int q_pos[3], k_pos[3], v_pos[3], do_pos[3];
};

template <int D>
struct DqCfg {
  static constexpr int kWG = D > 128 ? 1 : 2;   // consumer warpgroups: 64 query rows each
  static constexpr int BQ = 64 * kWG;
  static constexpr int kStages = D > 128 ? 2 : 3;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kQ = BQ * D;       // elements of Q, and of dO
  static constexpr int kTile = BT * D;    // elements of a K tile, and of a V tile
  // + 1 KB to align the operands to the swizzle pattern's 1024 bytes
  static constexpr int kBytes = 2 * (2 * kQ + 2 * kStages * kTile) + 8 * (2 * kStages + 1) +
                                (hopper::Tile<D>::kSwizzle ? 1024 : 0);
};

template <int D>
struct DkvCfg {
  // consumer warpgroups, 64 keys each: two cap a thread at 168 registers
  // (ptxas counts the 288 threads as three warpgroups), which spills at D = 96
  static constexpr int kWG = D > 80 ? 1 : 2;
  static constexpr int BK = 64 * kWG;
  static constexpr int DC = D > 128 ? 128 : D;  // dK/dV columns a block writes
  static constexpr int kStages = D > 128 ? 2 : 3;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kKV = BK * D;      // elements of K, and of V
  static constexpr int kTile = BT * D;    // elements of a Q tile, and of a dO tile
  static constexpr int kBytes = 2 * (2 * kKV + 2 * kStages * kTile) + 4 * 2 * kStages * BT +
                                8 * (2 * kStages + 1) + (hopper::Tile<D>::kSwizzle ? 1024 : 0);
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap, const Params p) {
  using namespace hopper;
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, kStages = C::kStages, W = Tile<D>::kBoxCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs =
      reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, Tile<D>::kSwizzle));
  __nv_bfloat16* dos = qs + C::kQ;
  __nv_bfloat16* ks = dos + C::kQ;
  __nv_bfloat16* vs = ks + kStages * C::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * C::kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal tiles first
  // the K/V tiles some row of this block can see
  const int q_hi = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? min(p.T, q_hi + 1) : p.T;
  const int t_begin = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BT;
  const int ntiles = max(0, (k_end + BT - 1) / BT - t_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kWG);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * C::kWG) {
    // ---- producer: one thread issues every TMA load ----
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * 2 * C::kQ);
#pragma unroll 1
      for (int c = 0; c < D / W; ++c) {
        load_box(qs + c * BQ * W, &qmap, qbar, p.q_pos, W * c, q0, h, b);
        load_box(dos + c * BQ * W, &domap, qbar, p.do_pos, W * c, q0, h, b);
      }
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * 2 * C::kTile);
        const int k0 = (t_begin + it) * BT;
        __nv_bfloat16* kt = ks + stage * C::kTile;
        __nv_bfloat16* vt = vs + stage * C::kTile;
#pragma unroll 1
        for (int c = 0; c < D / W; ++c) {
          load_box(kt + c * BT * W, &kmap, &full[stage], p.k_pos, W * c, k0, hk, b);
          load_box(vt + c * BT * W, &vmap, &full[stage], p.v_pos, W * c, k0, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63 ----
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  // the accumulator layout: this thread holds rows r0 and r0 + 8, columns
  // 8*j + 2*quad + {0, 1} (register 4*j + {0, 1} row r0, 4*j + {2, 3} r0 + 8)
  const int r0 = wg_row0 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const long long stat = static_cast<long long>(bh) * p.S;
  const float lse0 = r0 < p.S ? p.lse[stat + r0] * kLog2e : 0.f;
  const float lse1 = r1 < p.S ? p.lse[stat + r1] * kLog2e : 0.f;
  const float dl0 = r0 < p.S ? p.delta[stat + r0] : 0.f;
  const float dl1 = r1 < p.S ? p.delta[stat + r1] : 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // this warpgroup's 64 rows of Q and dO: 64 rows on in every region or group
  const __nv_bfloat16* q_wg = qs + wg * 64 * W;
  const __nv_bfloat16* do_wg = dos + wg * 64 * W;
  mbar_wait(qbar, 0);

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const __nv_bfloat16* kt = ks + stage * C::kTile;
    const __nv_bfloat16* vt = vs + stage * C::kTile;
    const int k0 = (t_begin + it) * BT;
    // a tile that no pair of this warpgroup can see adds nothing
    const bool dead = wg_row0 >= p.S || (p.causal && k0 > wg_row0 + 63) ||
                      (p.window > 0 && k0 + BT - 1 <= wg_row0 - p.window);
    if (!dead) {
      // S = Q·Kᵀ and dP = dO·Vᵀ (64 x 64 each)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(s, desc_k_major<D>(q_wg, BQ, kk), desc_k_major<D>(kt, BT, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dp, desc_k_major<D>(do_wg, BQ, kk), desc_k_major<D>(vt, BT, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S·scale·log2e − lse·log2e) under the mask (only on a tile
      // that crosses T, the diagonal or the window edge); dS = P∘(dP − Δ)
      const bool edge = k0 + BT > p.T || (p.causal && k0 + BT - 1 > wg_row0) ||
                        (p.window > 0 && k0 <= wg_row0 + 63 - p.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        float pv = exp2_approx(s[i] * p.scale_log2 - (hi ? lse1 : lse0));
        if (edge) {
          const int t = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int row = hi ? r1 : r0;
          const bool ok = t < p.T && (!p.causal || t <= row) &&
                          (p.window <= 0 || t > row - p.window);
          pv = ok ? pv : 0.f;
        }
        s[i] = pv * (dp[i] - (hi ? dl1 : dl0));
      }
      uint32_t da[4][4];
      to_a_frags(da, s);

      // dq += dS·K, K read MN-major: 16 keys a step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        wgmma_rs<D>(acc, da[kk], desc_mn_major<D>(kt, BT, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= p.S) continue;
    __nv_bfloat16* out =
        p.out0 + ((static_cast<long long>(b) * p.S + row) * p.Hq + h) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * p.scale, acc[4 * j + 2 * half + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap, const Params p) {
  using namespace hopper;
  using C = DkvCfg<D>;
  constexpr int BK = C::BK, DC = C::DC, kStages = C::kStages, W = Tile<D>::kBoxCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks =
      reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, Tile<D>::kSwizzle));
  __nv_bfloat16* vs = ks + C::kKV;
  __nv_bfloat16* qs = vs + C::kKV;
  __nv_bfloat16* dos = qs + kStages * C::kTile;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * C::kTile);   // log2 units
  float* dl_s = lse_s + kStages * BT;
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_s + kStages * BT);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv, group = p.Hq / p.Hkv;
  const int k0 = blockIdx.y * BK;   // the first key tiles have the most causal work
  const int c0 = blockIdx.z * DC;   // this block's dK/dV columns
  // the query tiles (of each q head of the group) that see a key of this block
  const int k_hi = min(k0 + BK, p.T) - 1;
  const int q_first = (p.causal ? k0 : 0) / BT;
  const int q_end = p.window > 0 ? min(p.S, k_hi + p.window) : p.S;
  const int nq = max(0, (q_end + BT - 1) / BT - q_first);
  const int ntiles = group * nq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA's bytes and the producer warp's lse/Δ writes
      mbar_init(&empty[s], 4 * C::kWG);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * C::kWG) {
    // ---- producer: lane 0 issues the TMA loads, the warp writes lse/Δ ----
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * 2 * C::kKV);
#pragma unroll 1
      for (int c = 0; c < D / W; ++c) {
        load_box(ks + c * BK * W, &kmap, kvbar, p.k_pos, W * c, k0, hk, b);
        load_box(vs + c * BK * W, &vmap, kvbar, p.v_pos, W * c, k0, hk, b);
      }
    }
#pragma unroll 1
    for (int it = 0; it < ntiles; ++it) {
      const int stage = it % kStages;
      mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
      const int h = hk * group + it / nq;
      const int q0 = (q_first + it % nq) * BT;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * 2 * C::kTile);
        __nv_bfloat16* qt = qs + stage * C::kTile;
        __nv_bfloat16* dot = dos + stage * C::kTile;
#pragma unroll 1
        for (int c = 0; c < D / W; ++c) {
          load_box(qt + c * BT * W, &qmap, &full[stage], p.q_pos, W * c, q0, h, b);
          load_box(dot + c * BT * W, &domap, &full[stage], p.do_pos, W * c, q0, h, b);
        }
      }
      // rows past S take 0: every pair with them is masked
      const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.S;
      for (int r = lane; r < BT; r += 32) {
        const int row = q0 + r;
        lse_s[stage * BT + r] = row < p.S ? p.lse[stat + row] * kLog2e : 0.f;
        dl_s[stage * BT + r] = row < p.S ? p.delta[stat + row] : 0.f;
      }
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64*wg .. + 63 ----
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int kw0 = k0 + wg * 64;
  // the accumulator layout (keys in rows, queries in columns): this thread
  // holds keys kr0 and kr0 + 8, columns 8*j + 2*quad + {0, 1}
  const int kr0 = kw0 + (warp % 4) * 16 + lane / 4, kr1 = kr0 + 8;
  float dk[DC / 2], dv[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
  const __nv_bfloat16* k_wg = ks + wg * 64 * W;
  const __nv_bfloat16* v_wg = vs + wg * 64 * W;
  mbar_wait(kvbar, 0);

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const __nv_bfloat16* qt = qs + stage * C::kTile;
    const __nv_bfloat16* dot = dos + stage * C::kTile;
    const float* lse_t = lse_s + stage * BT;
    const float* dl_t = dl_s + stage * BT;
    const int q0 = (q_first + it % nq) * BT;
    // a tile that no pair of this warpgroup can see adds nothing
    const bool dead = kw0 >= p.T || (p.causal && q0 + BT - 1 < kw0) ||
                      (p.window > 0 && kw0 + 63 <= q0 - p.window);
    if (!dead) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (64 keys x 64 queries each)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(s, desc_k_major<D>(k_wg, BK, kk), desc_k_major<D>(qt, BT, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dp, desc_k_major<D>(v_wg, BK, kk), desc_k_major<D>(dot, BT, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // Pᵀ and dSᵀ; lse and Δ by column (query) from the stage
      const bool edge = q0 + BT > p.S || kw0 + 64 > p.T || (p.causal && kw0 + 63 > q0) ||
                        (p.window > 0 && kw0 <= q0 + BT - 1 - p.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * quad + (i & 1);
        float pv = exp2_approx(s[i] * p.scale_log2 - lse_t[c]);
        if (edge) {
          const int qi = q0 + c, key = (i & 2) ? kr1 : kr0;
          const bool ok = qi < p.S && key < p.T && (!p.causal || key <= qi) &&
                          (p.window <= 0 || key > qi - p.window);
          pv = ok ? pv : 0.f;
        }
        s[i] = pv;
        dp[i] = pv * (dp[i] - dl_t[c]);
      }
      uint32_t pa[4][4], da[4][4];
      to_a_frags(pa, s);
      to_a_frags(da, dp);

      // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read MN-major from column c0
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        wgmma_rs<DC>(dv, pa[kk], desc_mn_major<D>(dot + c0 * BT, BT, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        wgmma_rs<DC>(dk, da[kk], desc_mn_major<D>(qt + c0 * BT, BT, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kr1 : kr0;
    if (key >= p.T) continue;
    const long long at = ((static_cast<long long>(b) * p.T + key) * p.Hkv + hk) * D + c0 + 2 * quad;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(p.out0 + at + 8 * j) = __floats2bfloat162_rn(
          dk[4 * j + 2 * half] * p.scale, dk[4 * j + 2 * half + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.out1 + at + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

// the four tensor maps of contiguous q, k, v, dO; q and dO in boxes of
// q_rows rows, k and v of k_rows
template <int D>
cudaError_t make_maps(const BwdParams& a, Params& p, CUtensorMap (&m)[4], int q_rows,
                      int k_rows) {
  constexpr int W = hopper::Tile<D>::kBoxCols;
  const long long qx[3] = {a.S, a.Hq, a.B}, kx[3] = {a.T, a.Hkv, a.B};
  const long long qst[3] = {1LL * a.Hq * D, D, 1LL * a.S * a.Hq * D};
  const long long kst[3] = {1LL * a.Hkv * D, D, 1LL * a.T * a.Hkv * D};
  cudaError_t err;
  if ((err = hopper::make_map(&m[0], "q", a.q, D, qx, qst, W, q_rows, p.q_pos)) ||
      (err = hopper::make_map(&m[1], "k", a.k, D, kx, kst, W, k_rows, p.k_pos)) ||
      (err = hopper::make_map(&m[2], "v", a.v, D, kx, kst, W, k_rows, p.v_pos)) ||
      (err = hopper::make_map(&m[3], "dO", a.dout, D, qx, qst, W, q_rows, p.do_pos)))
    return err;
  return cudaSuccess;
}

Params params(const BwdParams& a, void* out0, void* out1) {
  return Params{static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1),
                a.lse, a.delta, a.S, a.T, a.Hq, a.Hkv, a.causal, a.window,
                a.scale, a.scale * kLog2e, {}, {}, {}, {}};
}

template <int D>
cudaError_t launch_dq(const BwdParams& a, cudaStream_t stream) {
  using C = DqCfg<D>;
  Params p = params(a, a.dq, nullptr);
  CUtensorMap m[4];
  cudaError_t err;
  if ((err = hopper::begin("flash_bwd_dq_tc_kernel")) ||
      (err = make_maps<D>(a, p, m, C::BQ, BT)))
    return err;
  static const cudaError_t opted = hopper::opt_in(flash_bwd_dq_tc_kernel<D>, C::kBytes);
  const dim3 grid(a.B * a.Hq, (a.S + C::BQ - 1) / C::BQ);
  return hopper::launch("flash_bwd_dq_tc_kernel", flash_bwd_dq_tc_kernel<D>, opted, grid,
                        C::kThreads, C::kBytes, stream, m[0], m[1], m[2], m[3], p);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& a, cudaStream_t stream) {
  using C = DkvCfg<D>;
  Params p = params(a, a.dk, a.dv);
  CUtensorMap m[4];
  cudaError_t err;
  if ((err = hopper::begin("flash_bwd_dkv_tc_kernel")) ||
      (err = make_maps<D>(a, p, m, BT, C::BK)))
    return err;
  static const cudaError_t opted = hopper::opt_in(flash_bwd_dkv_tc_kernel<D>, C::kBytes);
  const dim3 grid(a.B * a.Hkv, (a.T + C::BK - 1) / C::BK, D / C::DC);
  return hopper::launch("flash_bwd_dkv_tc_kernel", flash_bwd_dkv_tc_kernel<D>, opted, grid,
                        C::kThreads, C::kBytes, stream, m[0], m[1], m[2], m[3], p);
}

}  // namespace tc

// the kernel of one (precision, output) pair at head dim D
template <bool TC, bool DQ, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t st) {
  if constexpr (TC) return DQ ? tc::launch_dq<D>(p, st) : tc::launch_dkv<D>(p, st);
  else return DQ ? launch_dq_fma<D>(p, st) : launch_dkv_fma<D>(p, st);
}

template <bool TC, bool DQ>
int flash_bwd(const BwdParams& p, int D, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.T <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<TC, DQ, 32>(p, st);
    case 64: return launch<TC, DQ, 64>(p, st);
    case 80: return launch<TC, DQ, 80>(p, st);
    case 96: return launch<TC, DQ, 96>(p, st);
    case 128: return launch<TC, DQ, 128>(p, st);
    case 256: return launch<TC, DQ, 256>(p, st);
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

// f32: the FMA kernels
extern "C" int repro_flash_bwd_dq_f32(BWD_ARGS, void* dq, BWD_DIMS) {
  return flash_bwd<false, true>(BWD_PARAMS(dq, nullptr, nullptr), D, stream);
}
extern "C" int repro_flash_bwd_dkv_f32(BWD_ARGS, void* dk, void* dv, BWD_DIMS) {
  return flash_bwd<false, false>(BWD_PARAMS(nullptr, dk, dv), D, stream);
}
// bf16: the tensor-core kernels. q, k, v, dO contiguous with 16-byte
// aligned base pointers (TMA); the wrapper checks.
extern "C" int repro_flash_bwd_dq_bf16(BWD_ARGS, void* dq, BWD_DIMS) {
  return flash_bwd<true, true>(BWD_PARAMS(dq, nullptr, nullptr), D, stream);
}
extern "C" int repro_flash_bwd_dkv_bf16(BWD_ARGS, void* dk, void* dv, BWD_DIMS) {
  return flash_bwd<true, false>(BWD_PARAMS(nullptr, dk, dv), D, stream);
}
