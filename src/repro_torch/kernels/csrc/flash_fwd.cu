// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention_fwd`) and
// computes what it computes: online-softmax attention with f32 running max,
// sum and accumulator; causal mask aligned top-left (k_pos <= q_pos, both
// counted from 0); sliding window k_pos > q_pos - window; a per-batch-row
// valid length kv_len (k_pos < kv_len); GQA by kv head = q head / group;
// scale 1/sqrt(D). Outputs O (B, S, Hq, D) in the input type and the f32
// row logsumexp (B*Hq, S). A row with no valid key is outside the contract;
// every variant writes 0 and lse = -1e30 there, as the plain version does.
// kv_len < 1 traps (the wrapper cannot read a device kv_len).
//
// Three kernels, chosen by the wrapper (kernels/flash_attention.py) by dtype
// and shape, never one in place of another that failed:
//
// 1. bf16 prefill (`flash_fwd_tc_kernel`, entry repro_flash_fwd_bf16).
//    Bound on an H100 SXM: at S = T = 1024 about as much by operations
//    (4*D per valid pair, 989 TFLOP/s) as by bytes; only tensor cores reach
//    that. One block per (b*Hq + h, 128-row Q tile), scheduled longest
//    causal tile first: two consumer warpgroups of 64 rows and one producer
//    warp (two blocks an SM at D <= 64, one above, by registers; at D = 256
//    a producer warpgroup that hands its registers to the consumers with
//    setmaxnreg, 240 a consumer thread). The
//    producer loads Q once and K/V tiles of 64 keys through TMA into a ring
//    of 3 stages with full/empty mbarriers; TMA zero-fills rows past S and
//    T. Each consumer warpgroup runs S = Q·Kᵀ as wgmma (m64n64k16, both
//    operands in shared memory, K-major), the online softmax in f32
//    registers in the accumulator's layout (exp2 of log2-scaled scores;
//    masks only on tiles that cross the causal diagonal, the window edge or
//    kv_len), rounds P to bf16 in registers and runs O += P·V as wgmma with
//    A = P from registers and B = V read MN-major from shared memory (the
//    transposed-B form). Tiles that the masks cover wholly are never
//    loaded. D = 64, 128 and 256 keep their tiles in the 128-byte swizzle
//    (TMA boxes of 64 columns); D = 32, 80 (zamba2) and 96 (phi-3-vision),
//    whose 64-, 160- and 192-byte rows the 128-byte swizzle span does not
//    fit, without swizzle, as 8-column groups of one 16-byte-wide TMA box
//    each (hopper.cuh). P·V is one m64nDk16 product at every D. At D = 256
//    (gemma3) the ring has two stages (Q 64 KB + 2 x 64 KB), and each
//    consumer thread holds 128 f32 of O besides S and P.
// 2. bf16 decode, S <= 4 and (Hq/Hkv)*S <= 32 (`flash_decode_kernel`, entry
//    repro_flash_decode_bf16). Bound by the bytes of the valid K/V prefix.
//    Split-KV: one block per (b*Hkv + kv head, chunk of keys, group of up to
//    8 of the kv head's g*S query rows), so each KV head is read once (at
//    GQA 8:1 and S = 1), not g times. Each of the block's 4 warps streams a
//    quarter of the chunk 32 keys a step with no block barrier, both
//    products on tensor cores (mma.sync m16n8k16, the rows in the top half
//    of the tile): K rows come straight from device memory as 16-byte
//    loads that are also the B fragments (D's columns permuted alike in Q
//    and K), V rows through a per-warp cp.async stage and ldmatrix.trans.
//    The warps' partials (unnormalised O, max m, sum l) combine in shared
//    memory into the block's, written to f32 scratch; the last block of a
//    (b, kv head) to finish, found by an atomic counter that it resets,
//    merges the chunks in the same launch. A chunk at or past kv_len
//    writes an empty partial (l = 0). The chunk (256 keys) and the number
//    of splits come from T alone, on the host. The V stage is dynamic
//    shared memory (66 KB at D = 256).
// 3. f32, any shape (`flash_fwd_kernel`, entry repro_flash_fwd_f32): f32
//    FMAs from shared memory. One block per (b*Hq + h, tile of BQ query
//    rows); each row owned by TPR lanes of one warp; BQ = 64 rows x 4 lanes,
//    or 4 rows x 32 lanes (16 at D = 80) for S <= 4 (209 KB of shared
//    memory at D = 256).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// ===========================================================================
// 3. f32: FMAs from shared memory
// ===========================================================================
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

template <int D, int BQ, int TPR, int BK>
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int qq = q0 + rr;
    qs[rr * KS + d] = qq < p.S ? qg[qq * p.q_ss + d] : 0.f;
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
      ks[kk * KS + d] = ok ? kg[t * p.k_ss + d] : 0.f;
      vs[kk * D + d] = ok ? vg[t * p.v_ss + d] : 0.f;
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
    float* og = static_cast<float*>(p.o) + ((static_cast<long long>(b) * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) og[l + j * TPR] = acc[j] / denom;
    if (l == 0) p.lse[static_cast<long long>(bh) * p.S + qi] = m_i + logf(denom);
  }
}

template <int D, int BQ, int TPR, int BK>
cudaError_t launch_fma(const FlashParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  if (cudaError_t err = hopper::begin("flash_fwd_kernel")) return err;
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t opted = hopper::opt_in(flash_fwd_kernel<D, BQ, TPR, BK>, smem);
  const dim3 grid(p.B * p.Hq, (p.S + BQ - 1) / BQ);
  return hopper::launch("flash_fwd_kernel", flash_fwd_kernel<D, BQ, TPR, BK>, opted, grid,
                        BQ * TPR, smem, stream, p);
}

template <int D>
cudaError_t launch_fma_for_rows(const FlashParams& p, cudaStream_t stream) {
  // a decode row's lanes split its D columns evenly: 16 lanes for D = 80
  constexpr int kDecodeLanes = D % 32 == 0 ? 32 : 16;
  if (p.S <= 4) return launch_fma<D, 4, kDecodeLanes, 64>(p, stream);
  return launch_fma<D, 64, 4, 64>(p, stream);
}

// ===========================================================================
// 1. bf16 prefill: TMA + wgmma, one producer warp, two consumer warpgroups
// ===========================================================================
namespace tc {

constexpr int BQ = 128;              // query rows a block: two warpgroups of 64
constexpr int BK = 64;               // keys a K/V tile
constexpr int kConsumerWarps = 8;

// Shared memory of one block: Q, then the K/V ring (hopper::Tile<D> gives
// the operand layout). Three stages of the ring; two at D = 256, where a
// 128-row Q tile (64 KB) and three 64-key stages (192 KB) would pass the
// 227 KB a block can have. At D = 256 a consumer thread also holds 128 f32
// of O besides S and P, more than the 168 registers ptxas gives each of
// 288 threads (it spilled): there the producer is a whole warpgroup that
// gives its registers back (setmaxnreg), 24 a thread, and the two consumer
// warpgroups take 240.
template <int D>
struct Smem {
  static constexpr bool kSwizzle = hopper::Tile<D>::kSwizzle;
  static constexpr int kBoxCols = hopper::Tile<D>::kBoxCols;
  static constexpr bool kRealloc = D > 128;
  static constexpr int kThreads = 32 * kConsumerWarps + (kRealloc ? 128 : 32);
  static constexpr int kStages = D > 128 ? 2 : 3;
  static constexpr int kQ = BQ * D;     // elements
  static constexpr int kTile = BK * D;
  // + 1 KB to align the operands to the swizzle pattern's 1024 bytes
  static constexpr int kBytes =
      2 * (kQ + 2 * kStages * kTile) + 8 * (2 * kStages + 1) + (kSwizzle ? 1024 : 0);
};

struct Params {
  __nv_bfloat16* o;   // (B, S, Hq, D), contiguous
  float* lse;         // (B * Hq, S)
  const int* kv_len;  // (B,) or nullptr (= T)
  int S, T, Hq, Hkv, causal, window;
  float scale_log2;   // 1/sqrt(D) * log2(e)
  // which tensor-map dim (1..3) holds the sequence, the head and the batch
  int q_pos[3], k_pos[3], v_pos[3];
};

template <int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, D <= 64 ? 2 : 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Params p) {
  using namespace hopper;
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, L::kSwizzle));
  __nv_bfloat16* ks = qs + L::kQ;
  constexpr int kStages = L::kStages;
  __nv_bfloat16* vs = ks + kStages * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * L::kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal tiles first
  const int kv_len = p.kv_len ? min(p.kv_len[b], p.T) : p.T;
  if (kv_len < 1) __trap();
  // the K/V tiles some row of this block can see
  const int q_hi = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? min(kv_len, q_hi + 1) : kv_len;
  const int t_begin = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BK;
  const int ntiles = max(0, (k_end + BK - 1) / BK - t_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (L::kRealloc) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * L::kQ);
      constexpr int W = L::kBoxCols;
#pragma unroll 1
      for (int c = 0; c < D / W; ++c)
        load_box(qs + c * BQ * W, &qmap, qbar, p.q_pos, W * c, q0, h, b);
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * 2 * L::kTile);
        const int k0 = (t_begin + it) * BK;
        __nv_bfloat16* kt = ks + stage * L::kTile;
        __nv_bfloat16* vt = vs + stage * L::kTile;
#pragma unroll 1
        for (int c = 0; c < D / W; ++c) {
          load_box(kt + c * BK * W, &kmap, &full[stage], p.k_pos, W * c, k0, hk, b);
          load_box(vt + c * BK * W, &vmap, &full[stage], p.v_pos, W * c, k0, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63 ----
  if constexpr (L::kRealloc) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  // the accumulator layout: this thread holds rows r0 and r0 + 8, columns
  // 8*j + 2*quad + {0, 1} (register 4*j + {0, 1} row r0, 4*j + {2, 3} r0 + 8)
  const int r0 = wg_row0 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // this warpgroup's 64 rows of Q: 64 rows on in every region or group
  const __nv_bfloat16* q_wg = qs + wg * 64 * L::kBoxCols;
  mbar_wait(qbar, 0);

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const __nv_bfloat16* kt = ks + stage * L::kTile;
    const __nv_bfloat16* vt = vs + stage * L::kTile;

    // S = Q·Kᵀ (64 x 64 per warpgroup)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(s, desc_k_major<D>(q_wg, BQ, kk), desc_k_major<D>(kt, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // masks (only on a tile that crosses kv_len, the diagonal or the window
    // edge), log2-scaled scores, online softmax
    const int k0 = (t_begin + it) * BK;
    const bool edge = k0 + BK > kv_len || (p.causal && k0 + BK - 1 > wg_row0) ||
                      (p.window > 0 && k0 <= wg_row0 + 63 - p.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * p.scale_log2;
      if (edge) {
        const int t = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        const bool ok = t < kv_len && (!p.causal || t <= row) &&
                        (p.window <= 0 || t > row - p.window);
        x = ok ? x : kNegInf;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = s[i];
      float pv = exp2_approx(x - ((i & 2) ? mn1 : mn0));
      if (edge && x == kNegInf) pv = 0.f;
      s[i] = pv;
      if (i & 2) ls1 += pv;
      else ls0 += pv;
    }
    l0 = l0 * a0 + ls0;   // this thread's share; the quad's sum at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

    // P in bf16 as the A operand
    uint32_t pa[BK / 16][4];
    to_a_frags(pa, s);

    // O += P·V, V MN-major: 16 keys a step
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mn_major<D>(vt, BK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    if (row >= p.S) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* og =
        p.o + ((static_cast<long long>(b) * p.S + row) * p.Hq + h) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    if (quad == 0)
      p.lse[static_cast<long long>(bh) * p.S + row] = l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
  }
}

template <int D>
cudaError_t launch(const FlashParams& a, cudaStream_t stream) {
  Params p{static_cast<__nv_bfloat16*>(a.o), a.lse, a.kv_len, a.S, a.T, a.Hq, a.Hkv,
           a.causal, a.window, a.scale * kLog2e, {}, {}, {}};
  CUtensorMap qm, km, vm;
  cudaError_t err;
  constexpr int W = Smem<D>::kBoxCols;
  using hopper::make_map;
  if ((err = hopper::begin("flash_fwd_tc_kernel")) ||
      (err = make_map(&qm, "q", a.q, D, {a.S, a.Hq, a.B}, {a.q_ss, a.q_sh, a.q_sb}, W, BQ,
                      p.q_pos)) ||
      (err = make_map(&km, "k", a.k, D, {a.T, a.Hkv, a.B}, {a.k_ss, a.k_sh, a.k_sb}, W, BK,
                      p.k_pos)) ||
      (err = make_map(&vm, "v", a.v, D, {a.T, a.Hkv, a.B}, {a.v_ss, a.v_sh, a.v_sb}, W, BK,
                      p.v_pos)))
    return err;
  static const cudaError_t opted = hopper::opt_in(flash_fwd_tc_kernel<D>, Smem<D>::kBytes);
  const dim3 grid(a.B * a.Hq, (a.S + BQ - 1) / BQ);
  return hopper::launch("flash_fwd_tc_kernel", flash_fwd_tc_kernel<D>, opted, grid,
                        Smem<D>::kThreads, Smem<D>::kBytes, stream, qm, km, vm, p);
}

}  // namespace tc

// ===========================================================================
// 2. bf16 decode: split-KV, one block per (b, kv head, chunk), merged in place
// ===========================================================================
namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int RMAX = 32;      // query rows of a kv head: g * S
constexpr int RB = 8;         // rows a block takes (a row group): an mma's top half
constexpr int kMergeSplits = 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;   // (B, S, Hq, D), contiguous
  float* lse;         // (B * Hq, S)
  const int* kv_len;  // (B,) or nullptr (= T)
  float* part;        // O (B*Hkv, splits, R, D), then m and l (B*Hkv, splits, R)
  int* counter;       // (B*Hkv,), zero between launches
  int S, T, Hq, Hkv, chunk, splits, causal, window;
  float scale_log2;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <int D>
struct Smem {
  static constexpr int VS = D + 8;   // V stage row (elements): ldmatrix without bank conflicts
  static constexpr int kStage = kWarps * 32 * VS * 2;          // bytes
  static constexpr int kCombine = kWarps * RB * D * 4;
  static constexpr int kMerge = 2 * kMergeSplits * (RMAX + 1) * 4;
  static constexpr int kBytes = kStage > kCombine ? (kStage > kMerge ? kStage : kMerge)
                                                  : (kCombine > kMerge ? kCombine : kMerge);
};

// One block per (b*Hkv + kv head, chunk of keys, group of up to 8 of the kv
// head's g*S query rows). Each warp streams a quarter of the chunk, 32 keys
// a step, with no block barrier, on tensor cores (mma.sync m16n8k16, the 8
// rows in the top half of the 16-row tile):
//  - S = Q·Kᵀ: the dot product does not depend on the order of the D
//    columns, so lane 4g + q takes columns 32m + 8q .. + 7 of both Q row g
//    and K row g of each 8-key n-tile as one 16-byte load, and those words
//    are its A and B fragments of k-steps 2m and 2m + 1. Q's fragments are
//    loaded once; K rows come straight from device memory.
//  - the online softmax of row g stays in the 4 lanes that hold it.
//  - O += P·V: P's fragments are the score accumulators, rounded to bf16;
//    V's 32 rows are staged in shared memory by cp.async and read with
//    ldmatrix.trans.
// The warps' partials combine in shared memory into the block's.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Params p) {
  using namespace hopper;
  constexpr int KB = D / 32;            // whole 32-column blocks of D
  constexpr bool kTail = D % 32 != 0;   // D = 80: a last block of 16 columns
  constexpr int NKS = D / 16;           // k-steps of S = Q·Kᵀ
  constexpr int NT = D / 8;             // n-tiles of O
  constexpr int VS = Smem<D>::VS;
  constexpr int EPT = (RMAX * D / 2 + kThreads - 1) / kThreads;   // merge: pairs a thread
  static_assert(D % 16 == 0, "head dim");
  extern __shared__ __align__(16) unsigned char buf[];   // Smem<D>::kBytes
  __shared__ float m_w[kWarps][RB], l_w[kWarps][RB];
  __shared__ float m_row[RMAX], l_row[RMAX];
  __shared__ int last;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int grp = p.Hq / p.Hkv, R = grp * p.S;
  const int r0 = blockIdx.z * RB, nr = min(RB, R - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int kv = p.kv_len ? min(p.kv_len[b], p.T) : p.T;
  if (kv < 1) __trap();
  const int k_hi = p.causal ? min(kv, p.S) : kv;
  const int c0 = split * p.chunk, c1 = min(c0 + p.chunk, k_hi);
  const int piece = p.chunk / kWarps;
  const int w0 = c0 + warp * piece, w1 = min(w0 + piece, c1);

  // row r0 + g: query head hk*grp + j at position s, r = j*S + s
  const bool row_ok = g < nr;
  const int sq = (r0 + g) % p.S;
  uint32_t qa[NKS][2];
  {
    const int r = row_ok ? r0 + g : 0;
    const __nv_bfloat16* qrow =
        p.q + b * p.q_sb + (r % p.S) * p.q_ss + (hk * grp + r / p.S) * p.q_sh;
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      const uint4 w = (row_ok && w0 < w1)
                          ? __ldg(reinterpret_cast<const uint4*>(qrow + 32 * m + 8 * q4))
                          : make_uint4(0, 0, 0, 0);
      qa[2 * m][0] = w.x;
      qa[2 * m][1] = w.y;
      qa[2 * m + 1][0] = w.z;
      qa[2 * m + 1][1] = w.w;
    }
    if constexpr (kTail) {
      const uint2 w = (row_ok && w0 < w1)
                          ? __ldg(reinterpret_cast<const uint2*>(qrow + 32 * KB + 4 * q4))
                          : make_uint2(0, 0);
      qa[NKS - 1][0] = w.x;
      qa[NKS - 1][1] = w.y;
    }
  }

  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16(*v_s)[VS] = reinterpret_cast<__nv_bfloat16(*)[VS]>(buf) + warp * 32;
  float o[NT][2];   // row g, columns 8n + 2*q4 + {0, 1}
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = 0.f;
  float m_r = kNegInf, l_r = 0.f;   // row g's running max and this lane's share of its sum

#pragma unroll 1
  for (int base = w0; base < w1; base += 32) {
    // V rows base .. base + 31 into this warp's stage (zeros past w1)
    for (int i = lane; i < 32 * (D / 8); i += 32) {
      const int key = i / (D / 8), c = 8 * (i % (D / 8)), t = base + key;
      const bool ok = t < w1;
      cp_async16(&v_s[key][c], vg + (ok ? t : 0) * p.v_ss + c, ok);
    }
    cp_async_commit();

    // S = Q·Kᵀ: n-tile i holds keys base + 8i .. + 7; this lane loads key
    // base + 8i + g (row 0 in place of a key past w1: its score is masked)
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = base + 8 * i + g;
      const __nv_bfloat16* krow = kg + (t < w1 ? t : 0) * p.k_ss;
      sc[i][0] = sc[i][1] = 0.f;
#pragma unroll
      for (int m = 0; m < KB; ++m) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(krow + 32 * m + 8 * q4));
        mma_16816_top(sc[i], qa[2 * m][0], qa[2 * m][1], w.x, w.y);
        mma_16816_top(sc[i], qa[2 * m + 1][0], qa[2 * m + 1][1], w.z, w.w);
      }
      if constexpr (kTail) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(krow + 32 * KB + 4 * q4));
        mma_16816_top(sc[i], qa[NKS - 1][0], qa[NKS - 1][1], w.x, w.y);
      }
    }

    // masks and the online softmax of row g: this lane holds keys
    // base + 8i + 2*q4 + e
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = base + 8 * i + 2 * q4 + e;
        const bool ok = row_ok && t < w1 && (!p.causal || t <= sq) &&
                        (p.window <= 0 || t > sq - p.window);
        const float x = ok ? sc[i][e] * p.scale_log2 : kNegInf;
        sc[i][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_r, mx);
    const float alpha = exp2_approx(m_r - mn);
    m_r = mn;
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sc[i][e];
        const float pv = x == kNegInf ? 0.f : exp2_approx(x - mn);
        sc[i][e] = pv;
        ls += pv;
      }
    l_r = l_r * alpha + ls;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    // P as A fragments: k-step j (keys 16j ..) is n-tiles 2j and 2j + 1
    uint32_t pa[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pa[j][0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[j][1] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
    }

    // O += P·V: V's fragments by ldmatrix.trans from the stage, 16 columns
    // (two n-tiles) at a time
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &v_s[16 * j + ((lane / 8) % 2) * 8 + lane % 8]
                                  [16 * dt + (lane / 16) * 8]);
        mma_16816_top(o[2 * dt], pa[j][0], pa[j][1], vb[0], vb[1]);
        mma_16816_top(o[2 * dt + 1], pa[j][0], pa[j][1], vb[2], vb[3]);
      }
    __syncwarp();   // the stage is read before the next step overwrites it
  }

  // the block's partial from its warps' (m, l, O); the stage's memory
  // takes the warps' O once every warp is done with it
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 1);
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 2);
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(buf);   // [kWarps][RB][D]
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<float2*>(&acc_s[(warp * RB + g) * D + 8 * n + 2 * q4]) =
        make_float2(o[n][0], o[n][1]);
  if (q4 == 0) {
    m_w[warp][g] = m_r;
    l_w[warp][g] = l_r;
  }
  __syncthreads();
  const long long nparts = static_cast<long long>(gridDim.x) * p.splits;
  const long long pidx = static_cast<long long>(bh) * p.splits + split;
  float* po = p.part;
  float* pm = p.part + nparts * R * D;
  float* pl = pm + nparts * R;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (l_w[w][r] > 0.f) M = fmaxf(M, m_w[w][r]);
    float ov = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (l_w[w][r] > 0.f) {
        const float e = exp2_approx(m_w[w][r] - M);
        ov += e * acc_s[(w * RB + r) * D + d];
        L += e * l_w[w][r];
      }
    }
    po[(pidx * R + r0 + r) * D + d] = ov;
    if (d == 0) {
      pm[pidx * R + r0 + r] = M;
      pl[pidx * R + r0 + r] = L;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(p.counter + bh, 1) == p.splits * static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of (b, kv head): merge the splits' partials of all R
  // rows. Every block wrote its rows (O = 0 where l = 0), so the loads need
  // no branch and go out together. Pass 1: each row's max M and sum L.
  float(*wts)[RMAX + 1] = reinterpret_cast<float(*)[RMAX + 1]>(buf);
  float(*lts)[RMAX + 1] = wts + kMergeSplits;
  const long long p0 = static_cast<long long>(bh) * p.splits;
  float M = kNegInf, Lsum = 0.f;   // row `tid`'s, for tid < R
  for (int s0 = 0; s0 < p.splits; s0 += kMergeSplits) {
    const int ns = min(kMergeSplits, p.splits - s0);
    for (int i = tid; i < R * ns; i += kThreads) {
      const int sj = i / R, r = i % R;
      const long long idx = (p0 + s0 + sj) * R + r;
      wts[sj][r] = __ldcg(pm + idx);
      lts[sj][r] = __ldcg(pl + idx);
    }
    __syncthreads();
    if (tid < R) {
      float Mg = M;
      for (int sj = 0; sj < ns; ++sj)
        if (lts[sj][tid] > 0.f) Mg = fmaxf(Mg, wts[sj][tid]);
      Lsum *= exp2_approx(M - Mg);
      for (int sj = 0; sj < ns; ++sj)
        if (lts[sj][tid] > 0.f) Lsum += lts[sj][tid] * exp2_approx(wts[sj][tid] - Mg);
      M = Mg;
    }
    __syncthreads();
  }
  if (tid < R) {
    m_row[tid] = M;
    l_row[tid] = Lsum;
  }
  __syncthreads();
  // pass 2: O = Σ_s O_s · exp2(m_s − M) / L
  float2 out[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) out[e] = make_float2(0.f, 0.f);
  for (int s0 = 0; s0 < p.splits; s0 += kMergeSplits) {
    const int ns = min(kMergeSplits, p.splits - s0);
    for (int i = tid; i < R * ns; i += kThreads) {   // weights of this group of splits
      const int sj = i / R, r = i % R;
      const long long idx = (p0 + s0 + sj) * R + r;
      const float ls = __ldcg(pl + idx);
      wts[sj][r] = (ls > 0.f && l_row[r] > 0.f)
                       ? exp2_approx(__ldcg(pm + idx) - m_row[r]) / l_row[r]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int pair = tid + e * kThreads;
      if (pair < R * (D / 2)) {
        const int r = pair / (D / 2), c = 2 * (pair % (D / 2));
        const float* src = po + (p0 + s0) * R * D + r * D + c;
#pragma unroll 8
        for (int sj = 0; sj < ns; ++sj) {
          const float w = wts[sj][r];
          const float2 x = __ldcg(reinterpret_cast<const float2*>(src + sj * R * D));
          out[e].x += w * x.x;
          out[e].y += w * x.y;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int pair = tid + e * kThreads;
    if (pair < R * (D / 2)) {
      const int r = pair / (D / 2), c = 2 * (pair % (D / 2)), j = r / p.S, s = r % p.S;
      *reinterpret_cast<__nv_bfloat162*>(
          p.o + ((static_cast<long long>(b) * p.S + s) * p.Hq + hk * grp + j) * D + c) =
          __floats2bfloat162_rn(out[e].x, out[e].y);
    }
  }
  if (tid < R) {
    const int j = tid / p.S, s = tid % p.S;
    const float L = l_row[tid];
    p.lse[(static_cast<long long>(b) * p.Hq + hk * grp + j) * p.S + s] =
        L > 0.f ? (m_row[tid] + log2f(L)) * kLn2 : kNegInf;
  }
  if (tid == 0) p.counter[bh] = 0;   // ready for the next launch
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if (cudaError_t err = hopper::begin("flash_decode_kernel")) return err;
  // dynamic shared memory: the V stage passes 48 KB at D = 256 (66 KB)
  static const cudaError_t opted = hopper::opt_in(flash_decode_kernel<D>, Smem<D>::kBytes);
  const int R = (p.Hq / p.Hkv) * p.S;
  const dim3 grid(B * p.Hkv, p.splits, (R + RB - 1) / RB);
  return hopper::launch("flash_decode_kernel", flash_decode_kernel<D>, opted, grid, kThreads,
                        Smem<D>::kBytes, stream, p);
}

}  // namespace dec

bool shapes_ok(int B, int S, int T, int Hq, int Hkv) {
  return B > 0 && S > 0 && T > 0 && Hkv > 0 && Hq % Hkv == 0;
}

}  // namespace

#define FLASH_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *o, void *lse, const void *kv_len,    \
      int B, int S, int T, int Hq, int Hkv, int D, long long q_sb, long long q_ss,        \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,     \
      long long v_ss, long long v_sh, int causal, int window, float scale, void *stream

// f32: the FMA kernel
extern "C" int repro_flash_fwd_f32(FLASH_ARGS) {
  if (!shapes_ok(B, S, T, Hq, Hkv)) return cudaErrorInvalidValue;
  const FlashParams p{q, k, v, o, static_cast<float*>(lse), static_cast<const int*>(kv_len),
                      B, S, T, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                      causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fma_for_rows<32>(p, st);
    case 64: return launch_fma_for_rows<64>(p, st);
    case 80: return launch_fma_for_rows<80>(p, st);
    case 96: return launch_fma_for_rows<96>(p, st);
    case 128: return launch_fma_for_rows<128>(p, st);
    case 256: return launch_fma_for_rows<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 prefill (any S): the tensor-core kernel. q, k, v: base pointers and
// strides of every dim of extent > 1 16-byte aligned (TMA); the wrapper
// checks.
extern "C" int repro_flash_fwd_bf16(FLASH_ARGS) {
  if (!shapes_ok(B, S, T, Hq, Hkv)) return cudaErrorInvalidValue;
  const FlashParams p{q, k, v, o, static_cast<float*>(lse), static_cast<const int*>(kv_len),
                      B, S, T, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                      causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return tc::launch<32>(p, st);
    case 64: return tc::launch<64>(p, st);
    case 80: return tc::launch<80>(p, st);
    case 96: return tc::launch<96>(p, st);
    case 128: return tc::launch<128>(p, st);
    case 256: return tc::launch<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 decode (S <= 4 rows, (Hq/Hkv)*S <= 32): the split-KV kernel. `part`
// holds B*Hkv*splits*R*(D + 2) floats (R = (Hq/Hkv)*S), `counter` B*Hkv
// zeroed ints; chunk is a multiple of 64 and chunk*splits >= T. k, v: as for
// the prefill (16-byte cp.async).
extern "C" int repro_flash_decode_bf16(FLASH_ARGS, void* part, void* counter, int chunk,
                                       int splits) {
  if (!shapes_ok(B, S, T, Hq, Hkv) || (Hq / Hkv) * S > dec::RMAX || chunk <= 0 ||
      chunk % (32 * dec::kWarps) != 0 || static_cast<long long>(chunk) * splits < T ||
      static_cast<long long>(chunk) * (splits - 1) >= T)
    return cudaErrorInvalidValue;
  const dec::Params p{static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v),
                      static_cast<__nv_bfloat16*>(o),
                      static_cast<float*>(lse),
                      static_cast<const int*>(kv_len),
                      static_cast<float*>(part),
                      static_cast<int*>(counter),
                      S, T, Hq, Hkv, chunk, splits, causal, window, scale * kLog2e,
                      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dec::launch<32>(p, B, st);
    case 64: return dec::launch<64>(p, B, st);
    case 80: return dec::launch<80>(p, B, st);
    case 96: return dec::launch<96>(p, B, st);
    case 128: return dec::launch<128>(p, B, st);
    case 256: return dec::launch<256>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
