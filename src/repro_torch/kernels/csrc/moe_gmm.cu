// Grouped expert GEMM (MoE FFN) for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of src/repro/kernels/moe_gmm.py
// (wrapper `moe_gmm_pallas`) and computes what it computes: for every expert
// e, out[e] = buf[e] @ w[e] with buf (E, C, D), w (E, D, F), out (E, C, F), all
// contiguous, an f32 accumulator and one cast to buf's type.
//
// The TPU grid carries its accumulator in VMEM across a sequential D axis.
// Here a block owns whole output tiles and loops over D itself; the f32
// accumulators stay in registers and there are no atomics. Four kernels,
// chosen by the wrapper (kernels/moe_gmm.py `_variant`) by dtype and shape,
// never one in place of another that failed:
//
// 1. bf16 prefill, C > 16, D and F multiples of 8, 16-byte-aligned bases
//    (`moe_gmm_tc_kernel`, entry repro_moe_gmm_bf16_tc). Bound on an H100
//    SXM by w's bytes: at qwen3-moe-30b-a3b's prefill step (E = 128,
//    C = 320, D/F = 2048/768) each call moves 634 MB (w 403 MB), 0.189 ms
//    at 3.35 TB/s, against 0.130 ms for its 128.8 GFLOP at 989 TFLOP/s;
//    only tensor cores reach either. A persistent grid of one block per SM
//    walks the (expert, F tile, C tile) output tiles of 128 x 256, the C
//    tile fastest, so that the C tiles of one (expert, F tile) run side by
//    side and w's tile comes from device memory once and from L2 for the
//    rest; the F tiles of one expert follow, so buf[e] is re-read from L2
//    too. A producer warpgroup (which hands its registers to the consumers
//    with setmaxnreg) has one thread issue TMA loads of 64-deep K steps
//    into a ring of 4 stages (buf 128 x 64, w 64 x 256: 48 KB a stage) with
//    full/empty mbarriers, running ahead into the next tile while the
//    consumers store this one. buf is the K-major A operand, one box of
//    64 columns (a 128-byte swizzled row) x 128 rows of a (D, C, E) map; w
//    the MN-major B operand, four boxes of 64 columns x 64 rows of a
//    (F, D, E) map, as V in flash's P·V. The maps keep E as a dim of its
//    own, so a box past C, D or F is zero-filled by TMA and never reads
//    the next expert. Two consumer warpgroups each own 64 rows of the
//    tile and run one wgmma m64n256k16 per 16 of depth, both operands from
//    shared memory, and free each stage as soon as its products are done
//    (the other warpgroup's products fill the wait), so that three stages'
//    loads are in flight; a warpgroup whose 64 rows are all at or past C
//    (C = 320's last tile) issues none. Each warpgroup writes its 64 x 256
//    outputs, half at a time, into 16 KB of shared memory in TMA's
//    swizzled layout and stores them with TMA, which drops rows >= C and
//    columns >= F and runs on while the next tile's products start. On an
//    H100 (PERF.md §6): storing from registers straight to device memory
//    cost ~5 us a tile (30 % at the down projection's 12 K steps); 4
//    stages freed at once beat 3 stages freed one step late by 6-15 %;
//    sharing w's tile across a cluster of the C tiles by TMA multicast
//    was slower than either.
// 2. bf16 decode, C <= 16 (`moe_gmm_bf16_kernel<16, 64, 64, 16, 16>`,
//    entry repro_moe_gmm_bf16_decode). Bound by w's bytes (~408 MB a call,
//    ~0.122 ms). One block per (expert, F tile of 64), one C tile of 16
//    rows, so every w element is read from device memory once; 4 warps on
//    nvcuda::wmma (mma.sync 16x16x16), 16-byte loads into registers one
//    step ahead.
// 3. bf16, C > 16 with D or F no multiple of 8 or a misaligned base
//    (`moe_gmm_bf16_kernel<64, 64, 32, 32, 32>`, entry repro_moe_gmm_bf16):
//    the first port's 64 x 64 wmma tile; ragged edges zero-filled on load
//    and masked on store, so any shape runs.
// 4. f32 (tests only; entry repro_moe_gmm_f32): one output per thread from
//    16 x 16 tiles by FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// 8 consecutive 16-bit values of row `row` from column `col` of a row-major
// (rows x ncols) array; zero past the row's end or for a row that is out.
__device__ __forceinline__ uint4 load8(const unsigned short* __restrict__ base, int row,
                                       bool row_ok, int col, int ncols, bool vec) {
  const long long off = static_cast<long long>(row) * ncols + col;
  if (row_ok && vec && col + 8 <= ncols) return *reinterpret_cast<const uint4*>(base + off);
  unsigned int h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = (row_ok && col + j < ncols) ? base[off + j] : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                    h[6] | (h[7] << 16));
}

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    moe_gmm_bf16_kernel(const unsigned short* __restrict__ buf,
                        const unsigned short* __restrict__ w, __nv_bfloat16* __restrict__ out,
                        int C, int D, int F, int vec_a, int vec_b) {
  static_assert((BM / WM) * (BN / WN) == kWarps, "one warp tile per warp");
  constexpr int FM = WM / 16, FN = WN / 16;
  // rows padded by 8 values (16 bytes): wmma wants a multiple of 8 and
  // 32-byte aligned fragment starts, which these strides keep
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int A_PER = BM * BK / 8 / kThreads, B_PER = BK * BN / 8 / kThreads;
  static_assert(A_PER * 8 * kThreads == BM * BK && B_PER * 8 * kThreads == BK * BN,
                "tiles split into 16-byte loads evenly");

  __shared__ __align__(128) unsigned short as[BM * LDA];
  __shared__ __align__(128) unsigned short bs[BK * LDB];
  __shared__ __align__(128) float cs[BM * LDC];

  const int e = blockIdx.z, c0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const unsigned short* a_e = buf + static_cast<long long>(e) * C * D;
  const unsigned short* b_e = w + static_cast<long long>(e) * D * F;
  const int warp = threadIdx.x / 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[A_PER], rb[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BK / 8), cc = idx % (BK / 8) * 8;
      ra[i] = load8(a_e, c0 + r, c0 + r < C, k0 + cc, D, vec_a);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BN / 8), cc = idx % (BN / 8) * 8;
      rb[i] = load8(b_e, k0 + r, k0 + r < D, n0 + cc, F, vec_b);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(as + idx / (BK / 8) * LDA + idx % (BK / 8) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(bs + idx / (BN / 8) * LDB + idx % (BN / 8) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + BK < D) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(as + (wm * WM + i * 16) * LDA + kk),
            LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(bs + kk * LDB + wn * WN + j * 16),
            LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* o_e = out + static_cast<long long>(e) * C * F;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    if (c0 + r < C && n0 + c < F)
      o_e[static_cast<long long>(c0 + r) * F + n0 + c] = __float2bfloat16(cs[r * LDC + c]);
  }
}

constexpr int kT = 16;

__global__ void __launch_bounds__(kT * kT)
    moe_gmm_f32_kernel(const float* __restrict__ buf, const float* __restrict__ w,
                       float* __restrict__ out, int C, int D, int F) {
  __shared__ float as[kT][kT + 1];
  __shared__ float bs[kT][kT + 1];
  const int e = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kT + ty, col = blockIdx.x * kT + tx;
  const float* a_e = buf + static_cast<long long>(e) * C * D;
  const float* b_e = w + static_cast<long long>(e) * D * F;
  float acc = 0.f;
  for (int k0 = 0; k0 < D; k0 += kT) {
    as[ty][tx] = (row < C && k0 + tx < D) ? a_e[static_cast<long long>(row) * D + k0 + tx] : 0.f;
    bs[ty][tx] = (k0 + ty < D && col < F) ? b_e[static_cast<long long>(k0 + ty) * F + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kT; ++k) acc = fmaf(as[ty][k], bs[k][tx], acc);
    __syncthreads();
  }
  if (row < C && col < F) out[(static_cast<long long>(e) * C + row) * F + col] = acc;
}

// ===========================================================================
// 1. bf16 prefill: TMA + wgmma, persistent, a producer warpgroup and two
//    consumer warpgroups
// ===========================================================================
namespace tc {

constexpr int BM = 128;              // C rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;              // F columns a tile: one m64n256k16 a warpgroup
constexpr int BK = 64;               // D a stage: one 128-byte swizzled buf row
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;   // + the producer warpgroup
constexpr int kA = BM * BK;          // elements of a stage's buf tile (16 KB)
constexpr int kB = BK * BN;          // of its w tile: BN / 64 regions of BK x 64 (32 KB)
constexpr int kOut = 64 * BN / 2;    // half a warpgroup's output tile (16 KB)
// + 1 KB to align the operands to the swizzle pattern's 1024 bytes
constexpr int kBytes =
    2 * (kStages * (kA + kB) + 2 * kOut) + 8 * 2 * kStages + 1024;

struct Params {
  int C, m_tiles, n_tiles, k_steps, tiles;
  // which tensor-map dim (1..3) holds the rows, the expert and the unit dim
  int a_pos[3], b_pos[3], o_pos[3];
};

// output tile t: C tile fastest, then F tile, then expert
struct TileIdx {
  int m0, n0, e;
  __device__ TileIdx(const Params& p, int t)
      : m0((t % p.m_tiles) * BM),
        n0((t / p.m_tiles) % p.n_tiles * BN),
        e(t / (p.m_tiles * p.n_tiles)) {}
};

__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_tc_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, const Params p) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = as + kStages * kA;
  __nv_bfloat16* os = bs + kStages * kB;   // the two warpgroups' output halves
  uint64_t* full = reinterpret_cast<uint64_t*>(os + 2 * kOut);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer: one thread issues every TMA load, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
#pragma unroll 1
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const TileIdx ti(p, t);
#pragma unroll 1
        for (int k = 0; k < p.k_steps; ++k, ++it) {
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * (kA + kB));
          load_box(as + stage * kA, &amap, &full[stage], p.a_pos, k * BK, ti.m0, ti.e, 0);
          __nv_bfloat16* bt = bs + stage * kB;
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            load_box(bt + c * BK * 64, &bmap, &full[stage], p.b_pos, ti.n0 + 64 * c, k * BK,
                     ti.e, 0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64*wg .. + 63 of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, quad = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;   // issues the warpgroup's stores
  __nv_bfloat16* ot = os + wg * kOut;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  float acc[BN / 2];
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileIdx ti(p, t);
    const int row0 = ti.m0 + wg * 64;
    const bool active = row0 < p.C;   // uniform over the warpgroup
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < p.k_steps; ++k, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      if (active) {
        // this warpgroup's 64 rows: 64 rows on in the buf tile's one region
        const __nv_bfloat16* at = as + stage * kA + wg * 64 * 64;
        const __nv_bfloat16* bt = bs + stage * kB;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_m64n256_tb(acc, desc_k_major<64>(at, BM, kk), desc_mn_major<BN>(bt, BK, kk));
        wgmma_commit();
        // done with the stage: free it at once, so that 3 stages' loads can
        // be in flight (the other warpgroup's products fill this wait)
        wgmma_wait<0>();
        fence_regs(acc);
      }
      release(stage);
    }
    if (!active) continue;

    // the accumulator layout: this thread holds rows r and r + 8 of the
    // warpgroup's 64 (r = 16 * (warp % 4) + lane / 4), columns 8*j + 2*quad
    // + {0, 1} (register 4*j + {0, 1} row r, 4*j + {2, 3} row r + 8). Each
    // half of the columns goes to this warpgroup's 16 KB of shared memory as
    // TMA's 128-byte swizzle lays out a box of 64 columns (16-byte chunk c
    // of row r at chunk c ^ (r % 8): no bank conflicts), then out by TMA
    // stores that run on while the next half, and the next tile's
    // products, start; rows past C and columns past F are not written.
    const int r = (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      if (leader) bulk_wait_read();   // the last stores have read ot
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half;
        unsigned char* orow = reinterpret_cast<unsigned char*>(ot) + rr * 128 + 4 * quad;
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj) {
          const int j = part * (BN / 16) + jj;
          *reinterpret_cast<uint32_t*>(orow + (jj / 8) * 64 * 128 +
                                       (((jj % 8) ^ (rr % 8)) * 16)) =
              pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
      fence_proxy_async_smem();
      named_barrier(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < BN / 128; ++c)
          store_box(&omap, ot + c * 64 * 64, p.o_pos, ti.n0 + BN / 2 * part + 64 * c, row0,
                    ti.e, 0);
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait();
}

int launch(const void* buf, const void* w, void* out, int E, int C, int D, int F,
           cudaStream_t stream) {
  const long long m = (C + BM - 1) / BM, n = (F + BN - 1) / BN;
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      reinterpret_cast<uintptr_t>(buf) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || E * m * n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Params p{C, static_cast<int>(m), static_cast<int>(n), (D + BK - 1) / BK,
           static_cast<int>(E * m * n), {}, {}, {}};
  CUtensorMap am, bm, om;
  cudaError_t err;
  const long long cd = static_cast<long long>(C) * D, df = static_cast<long long>(D) * F,
                  cf = static_cast<long long>(C) * F;
  // buf: (D, C, E) with D contiguous; w: (F, D, E) and out: (F, C, E) with
  // F contiguous
  if ((err = hopper::make_map(&am, buf, D, {C, E, 1}, {D, cd, cd * E}, 64, BM, p.a_pos)) ||
      (err = hopper::make_map(&bm, w, F, {D, E, 1}, {F, df, df * E}, 64, BK, p.b_pos)) ||
      (err = hopper::make_map(&om, out, F, {C, E, 1}, {F, cf, cf * E}, 64, 64, p.o_pos)))
    return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  // persistent: one block an SM (its shared memory allows no second)
  const int grid = p.tiles < sms ? p.tiles : sms;
  moe_gmm_tc_kernel<<<grid, kThreads, kBytes, stream>>>(am, bm, om, p);
  return cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int check_dims(int E, int C, int D, int F, int rows_per_block) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + rows_per_block - 1) / rows_per_block > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BM, int BN, int BK, int WM, int WN>
int launch_bf16(const void* buf, const void* w, void* out, int E, int C, int D, int F,
                cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  moe_gmm_bf16_kernel<BM, BN, BK, WM, WN><<<grid, kThreads, 0, stream>>>(
      static_cast<const unsigned short*>(buf), static_cast<const unsigned short*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F, int(D % 8 == 0 && aligned16(buf)),
      int(F % 8 == 0 && aligned16(w)));
  return cudaGetLastError();
}

}  // namespace

// the tile is the caller's choice (`_variant`): any C runs on either
extern "C" int repro_moe_gmm_bf16(const void* buf, const void* w, void* out, int E, int C,
                                  int D, int F, void* stream) {
  if (int err = check_dims(E, C, D, F, 64)) return err;
  return launch_bf16<64, 64, 32, 32, 32>(buf, w, out, E, C, D, F,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int repro_moe_gmm_bf16_decode(const void* buf, const void* w, void* out, int E,
                                         int C, int D, int F, void* stream) {
  if (int err = check_dims(E, C, D, F, 16)) return err;
  return launch_bf16<16, 64, 64, 16, 16>(buf, w, out, E, C, D, F,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int repro_moe_gmm_f32(const void* buf, const void* w, void* out, int E, int C,
                                 int D, int F, void* stream) {
  if (int err = check_dims(E, C, D, F, kT)) return err;
  const dim3 grid((F + kT - 1) / kT, (C + kT - 1) / kT, E);
  moe_gmm_f32_kernel<<<grid, dim3(kT, kT), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const float*>(w), static_cast<float*>(out),
      C, D, F);
  return cudaGetLastError();
}

extern "C" int repro_moe_gmm_bf16_tc(const void* buf, const void* w, void* out, int E, int C,
                                     int D, int F, void* stream) {
  return tc::launch(buf, w, out, E, C, D, F, static_cast<cudaStream_t>(stream));
}
