// Grouped expert GEMM (MoE FFN) for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of src/repro/kernels/moe_gmm.py
// (wrapper `moe_gmm_pallas`) and computes what it computes: for every expert
// e, out[e] = buf[e] @ w[e] with buf (E, C, D), w (E, D, F), out (E, C, F), all
// contiguous, an f32 accumulator and one cast to buf's type.
//
// The TPU grid carries its accumulator in VMEM across a sequential D axis.
// Here a block owns whole output tiles and loops over D itself; the f32
// accumulators stay in registers and there are no atomics, so a call is
// bit-identical to the next. Four kernels,
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
// 2. bf16 decode, C <= 16, D and F multiples of 8, 16-byte-aligned bases
//    (`moe_gmm_decode_kernel`, entry repro_moe_gmm_bf16_decode). A call
//    does at most 16 operations a byte of w, against the card's ridge of
//    ~295, so it is bound by reading w once: mixtral-8x22b's 1.61 GB, 0.481
//    ms at 3.35 TB/s; qwen3-moe-30b-a3b's 403 MB, 0.122 ms. Only the way w
//    streams sets the pace, so the kernel is a TMA ring, like (1.): one
//    producer thread issues, 128 D rows a stage, two boxes of 64 F columns
//    x 128 D rows of an (F, D, E) map (w's 32 KB, MN-major as in (1.), its
//    lines promoted to 256 bytes in L2) and two boxes of 64 D columns x 16
//    rows of a (D, C, E) map (buf, 4 KB: rows past C zero-filled, so C = 1
//    never reads the next expert's rows; under an L2 evict-last policy, as
//    buf is re-read once per F tile while w streams past) into a ring of 2
//    stages with full/empty mbarriers. Every expert's w is read, whatever
//    buf holds, as `_gmm_kernel` reads it: a zero row times a NaN of w
//    gives NaN here as there. The product swaps its operands, out^T = w^T .
//    buf^T, so the wide F dim is wgmma's M and the <= 16 tokens its N: per
//    stage, 8 x 2 wgmma m64n16k16, w the transposed (MN-major) A read as
//    stored, buf the K-major B, both from shared memory. wgmma rather than
//    mma.sync: it reads both operands from the TMA's swizzled tiles with no
//    ldmatrix and no register copy, and at N = 16 it pads C by at most 16x
//    (a 64-row A of tokens, padded the other way round, would be 64x at C =
//    1); compute stays far under a stage's load time either way. One
//    consumer warpgroup holds 16 f32 accumulators a thread, frees each
//    stage as soon as its products are done, and stores a tile's bf16
//    outputs straight from them (the output is <= 0.4 % of the bytes).
//    The grid: the E x ceil(F/128) tiles t = (expert t / n_tiles, F columns
//    (t % n_tiles)*128..), walked as t = b, b + G, ... by the fewest blocks
//    (at most one an SM) that give every block the same number of tiles:
//    128 blocks of 8, 3, 6 and 16 tiles at mixtral's gate/up and down and
//    qwen3-moe's gate/up and down on 132 SMs. Each tile's whole D is summed
//    in one block, in order, so a call is bit-identical to the next with no
//    atomics. The blocks that run together hold adjacent tiles and walk D
//    at the same pace, so the card reads whole rows of w at a time. Tried
//    on an H100 and slower at one decode shape or more: splitting D to even
//    the blocks' shares (stream-K over (tile, step) units, or 2 or 3 splits
//    a tile summed in a fixed order: split blocks read scattered rows, and
//    a split tile's partials cost a fence and a second pass); 64- and
//    256-column tiles; 64-, 192- and 256-deep stages; more bytes in flight
//    (more stages, or 2 and 3 blocks an SM); 128-byte promotion; an
//    evict-first policy on w (fast back to back, but 7 % slower after L2
//    was filled with dirty lines); grids that leave some blocks a tile more.
// 3. bf16 that fails the TMA rule: D or F no multiple of 8, or a base
//    not 16-byte aligned, at any C (`moe_gmm_bf16_kernel<64, 64, 32, 32,
//    32>`, entry repro_moe_gmm_bf16): the first port's 64 x 64 wmma tile;
//    ragged edges zero-filled on load and masked on store, so any shape
//    runs.
// 4. f32 (tests only; entry repro_moe_gmm_f32): one output per thread from
//    16 x 16 tiles by FMAs.
//
// The backward (entry repro_moe_gmm_bwd_*, `dw` = 0 for dX, 1 for dW). The
// TPU kernel has none (JAX differentiates the expert einsum with XLA). No
// operand is copied transposed. At qwen3-moe's train microbatch (E 128, C
// 320, D/F 2048/768) each product moves ~633 MB: 0.189 ms at 3.35 TB/s
// against 0.130 ms for its 128.8 GFLOP at 989 TFLOP/s, bound by bytes; at
// mixtral-8x22b's (E 8, C 1280, D/F 6144/16384) 2.085 ms of operations.
// bf16 under TMA's rule (D and F multiples of 8, 16-byte-aligned bases) takes
// 5. (dX) and 6. (dW), kernels/moe_gmm.py `_bwd_plan` picking dW's tile
// order; other bf16 the wmma tile (3.) on transposed layouts, f32 the FMA
// kernel (4.).
// 5. dX, dbuf[e] (C x D) = dy[e] (C x F) . w[e]^T (`moe_gmm_dx_kernel`):
//    computed transposed, dbuf^T = w . dy^T, so that one tile holds 320
//    tokens, all of an expert's at qwen3-moe (more tokens take several
//    tiles, which run side by side and read w's tile from L2; fewer are
//    zero-filled by TMA and dropped by the store), and 128 D rows. The
//    forward's layout (M = C) cut C = 320 into 128 + 128 + 64 rows, and
//    the 64-row tail loaded a full tile's w for half its products, so each
//    w tile was read three times from L2; here each is read once (w, 403
//    MB at qwen3-moe, streams from device memory once) and dy, 63 MB, is
//    re-read from L2 by the D tiles. w is the K-major A (one box of 64 F
//    columns x 128 D rows a stage), dy the K-major B (two boxes of 64 F
//    columns x 160 tokens); each warpgroup runs two wgmma m64n160k16 a
//    k-step, 3 stages of ring. The accumulator is out^T; stmatrix.trans
//    writes it into TMA's swizzled layout as rows of D, and a TMA store
//    puts 64 D columns x 160 tokens a warpgroup into (E, C, D), dropping
//    rows past C and columns past D. A tile's second part (its second
//    wgmma's 160 tokens) waits as bf16 pairs in 40 registers and goes out
//    under the next tile's first products; its first part goes out at
//    once, with the warpgroup's tensor pipe idle: holding it too would
//    take 40 more registers a thread than the consumers' 232 leave. So
//    half of dX's epilogue is overlapped.
// 6. dW, dw[e] (D x F) = buf[e]^T (D x C) . dy[e] (C x F), contracting over
//    the tokens C (`moe_gmm_dw_kernel`): the forward's persistent 128 x 256
//    tiles, buf^T an MN-major A (wgmma reads bf16 A transposed from shared
//    memory: two boxes of 64 D columns x 64 C rows) and dy an MN-major B
//    as w is in the forward; TMA zero-fills the contraction's tail past C.
//    At qwen3-moe dW contracts only 5 steps of 64 and writes a 403 MB
//    output, so the epilogue sets the pace: a tile's outputs wait as bf16
//    pairs in 64 registers and go out, 128 columns a step, during the next
//    tile's second and third k-steps, under its products. The tiles walk D
//    or F fastest (`_bwd_plan`): F where the blocks that run together then
//    write whole rows of dw (qwen3-moe's down), or where buf[e]^T outweighs
//    dy[e] and would not stay in L2 between F tiles (mixtral's down: 42 MB
//    an expert).
// Neither uses atomics: each output is summed in one block in a fixed
// order, so a call is bit-identical to the next. As at every launch here,
// a thread's first makes the device's context current before it makes
// tensor maps (hopper::begin): cuTensorMapEncodeTiled refuses every map,
// with CUDA_ERROR_INVALID_CONTEXT, on a thread that has none, which
// autograd's backward thread can be. Tried on an H100 and not kept (PERF.md §6):
// keeping one stage's products in flight (wgmma_wait<1>, each stage freed
// a step late), faster only for qwen3-moe's dX on the M = C layout, which
// the transposed kernel beat; splitting C = 320's 64-row tail tile by
// columns between the warpgroups, which left its loads as they were; an
// L2 evict-last policy on A and 256-byte L2 lines for B, no gain that held
// from one call to the next; storing a tile's outputs at once, or from the
// next tile's first or third step; dX past 320 tokens on 6.'s layout (M =
// C, 128 x 256 tiles), 1-3 % slower than 5. at mixtral's C = 1280.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// A (M x K) and B (K x N) of expert e as stored: A row-major (M, K), or
// (K, M) when kAT; B row-major (K, N), or (N, K) when kBT is false. Each
// tile goes to shared memory as stored (16-byte loads along the contiguous
// dim) and wmma reads a stored-transposed tile as col_major.
template <int BM, int BN, int BK, int WM, int WN, bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads)
    moe_gmm_bf16_kernel(const unsigned short* __restrict__ a,
                        const unsigned short* __restrict__ b, __nv_bfloat16* __restrict__ out,
                        int M, int K, int N, int vec_a, int vec_b) {
  static_assert((BM / WM) * (BN / WN) == kWarps, "one warp tile per warp");
  constexpr int FM = WM / 16, FN = WN / 16;
  // rows padded by 8 values (16 bytes): wmma wants a multiple of 8 and
  // 32-byte aligned fragment starts, which these strides keep
  constexpr int LDA = kAT ? BM + 8 : BK + 8, LDB = kBT ? BN + 8 : BK + 8, LDC = BN + 4;
  constexpr int A_ROWS = kAT ? BK : BM, A_COLS = kAT ? BM : BK;   // as stored
  constexpr int B_ROWS = kBT ? BK : BN, B_COLS = kBT ? BN : BK;
  constexpr int A_PER = BM * BK / 8 / kThreads, B_PER = BK * BN / 8 / kThreads;
  static_assert(A_PER * 8 * kThreads == BM * BK && B_PER * 8 * kThreads == BK * BN,
                "tiles split into 16-byte loads evenly");

  __shared__ __align__(128) unsigned short as[A_ROWS * LDA];
  __shared__ __align__(128) unsigned short bs[B_ROWS * LDB];
  __shared__ __align__(128) float cs[BM * LDC];

  const int e = blockIdx.z, c0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const unsigned short* a_e = a + static_cast<long long>(e) * M * K;
  const unsigned short* b_e = b + static_cast<long long>(e) * K * N;
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
      const int r = idx / (A_COLS / 8), cc = idx % (A_COLS / 8) * 8;
      ra[i] = kAT ? load8(a_e, k0 + r, k0 + r < K, c0 + cc, M, vec_a)
                  : load8(a_e, c0 + r, c0 + r < M, k0 + cc, K, vec_a);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (B_COLS / 8), cc = idx % (B_COLS / 8) * 8;
      rb[i] = kBT ? load8(b_e, k0 + r, k0 + r < K, n0 + cc, N, vec_b)
                  : load8(b_e, n0 + r, n0 + r < N, k0 + cc, K, vec_b);
    }
  };
  using LayA = typename std::conditional<kAT, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<kBT, wmma::row_major, wmma::col_major>::type;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(as + idx / (A_COLS / 8) * LDA + idx % (A_COLS / 8) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(bs + idx / (B_COLS / 8) * LDB + idx % (B_COLS / 8) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wm * WM + i * 16;
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(as + (kAT ? kk * LDA + m : m * LDA + kk)),
            LDA);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wn * WN + j * 16;
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(bs + (kBT ? kk * LDB + n : n * LDB + kk)),
            LDB);
      }
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
  __nv_bfloat16* o_e = out + static_cast<long long>(e) * M * N;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    if (c0 + r < M && n0 + c < N)
      o_e[static_cast<long long>(c0 + r) * N + n0 + c] = __float2bfloat16(cs[r * LDC + c]);
  }
}

constexpr int kT = 16;

// the layouts as in moe_gmm_bf16_kernel
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kT * kT)
    moe_gmm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ float as[kT][kT + 1];
  __shared__ float bs[kT][kT + 1];
  const int e = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kT + ty, col = blockIdx.x * kT + tx;
  const float* a_e = a + static_cast<long long>(e) * M * K;
  const float* b_e = b + static_cast<long long>(e) * K * N;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += kT) {
    const int ka = k0 + tx, kb = k0 + ty;
    as[ty][tx] = (row < M && ka < K)
                     ? a_e[kAT ? static_cast<long long>(ka) * M + row
                               : static_cast<long long>(row) * K + ka]
                     : 0.f;
    bs[ty][tx] = (kb < K && col < N)
                     ? b_e[kBT ? static_cast<long long>(kb) * N + col
                               : static_cast<long long>(col) * K + kb]
                     : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kT; ++k) acc = fmaf(as[ty][k], bs[k][tx], acc);
    __syncthreads();
  }
  if (row < M && col < N) out[(static_cast<long long>(e) * M + row) * N + col] = acc;
}

// ===========================================================================
// 1. bf16 prefill: TMA + wgmma, persistent, a producer warpgroup and two
//    consumer warpgroups
// ===========================================================================
namespace tc {

constexpr int BM = 128;              // M rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;              // N columns a tile: one m64n256k16 a warpgroup
constexpr int BK = 64;               // K a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;   // + the producer warpgroup
constexpr int kA = BM * BK;          // elements of a stage's A tile (16 KB)
constexpr int kB = BK * BN;          // of its B tile (32 KB)
constexpr int kOut = 64 * BN / 2;    // half a warpgroup's output tile (16 KB)
// + 1 KB to align the operands to the swizzle pattern's 1024 bytes
constexpr int kBytes =
    2 * (kStages * (kA + kB) + 2 * kOut) + 8 * 2 * kStages + 1024;

struct Params {
  int M, m_tiles, n_tiles, k_steps, tiles;
  // which tensor-map dim (1..3) holds the rows, the expert and the unit dim
  int a_pos[3], b_pos[3], o_pos[3];
};

// output tile t: M tile fastest, then N tile, then expert
struct TileIdx {
  int m0, n0, e;
  __device__ TileIdx(const Params& p, int t)
      : m0((t % p.m_tiles) * BM),
        n0((t / p.m_tiles) % p.n_tiles * BN),
        e(t / (p.m_tiles * p.n_tiles)) {}
};

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N): A = buf, B = w.
//  - A K-major: one box of 64 K columns (a 128-byte swizzled row) x 128 M
//    rows of a (K, M, E) map; warpgroup wg's rows start 64 rows in.
//  - B MN-major: four boxes of 64 N columns x 64 K rows of an (N, K, E)
//    map, as V in flash's P.V.
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
    const bool active = row0 < p.M;   // uniform over the warpgroup
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < p.k_steps; ++k, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      if (active) {
        // this warpgroup's 64 rows: 64 rows on in A's K-major tile
        const __nv_bfloat16* at = as + stage * kA + wg * 64 * 64;
        const __nv_bfloat16* bt = bs + stage * kB;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<256, 0, 1>(acc, desc_k_major<64>(at, BM, kk), desc_mn_major<BN>(bt, BK, kk), 1);
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
    // products, start; rows past M and columns past N are not written.
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

// buf (E, C, D), w (E, D, F), out (E, C, F), all contiguous: M = C, N =
// F, K = D. TMA reads rows at 16-byte strides from 16-byte-aligned bases:
// D and F multiples of 8.
int launch(const void* a, const void* b, void* out, int E, int M, int N, int K,
           cudaStream_t stream) {
  const long long m = (M + BM - 1) / BM, n = (N + BN - 1) / BN;
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || E * m * n > 0x7fffffffLL)
    return hopper::refuse("moe_gmm_tc_kernel: shape or alignment outside TMA's rule");
  Params p{M, static_cast<int>(m), static_cast<int>(n), (K + BK - 1) / BK,
           static_cast<int>(E * m * n), {}, {}, {}};
  CUtensorMap am, bm, om;
  cudaError_t err;
  const long long mk = static_cast<long long>(M) * K, kn = static_cast<long long>(K) * N,
                  mn = static_cast<long long>(M) * N;
  using hopper::make_map;
  int sms = 0;
  if ((err = hopper::begin("moe_gmm_tc_kernel")) ||
      (err = make_map(&am, "buf", a, K, {M, E, 1}, {K, mk, mk * E}, 64, BM, p.a_pos)) ||
      (err = make_map(&bm, "w", b, N, {K, E, 1}, {N, kn, kn * E}, 64, BK, p.b_pos)) ||
      (err = make_map(&om, "out", out, N, {M, E, 1}, {N, mn, mn * E}, 64, 64, p.o_pos)) ||
      (err = hopper::sm_count(&sms)))
    return err;
  static const cudaError_t opted = hopper::opt_in(moe_gmm_tc_kernel, kBytes);
  // persistent: one block an SM (its shared memory allows no second)
  const int grid = p.tiles < sms ? p.tiles : sms;
  return hopper::launch("moe_gmm_tc_kernel", moe_gmm_tc_kernel, opted, grid, kThreads, kBytes,
                        stream, am, bm, om, p);
}

}  // namespace tc

// ===========================================================================
// 6. the bf16 dW: TMA + wgmma, persistent, each tile's outputs stored under
//    the next tile's products
// ===========================================================================
namespace wgrad {

constexpr int BM = 128;              // M rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;              // N columns a tile: one m64n256k16 a warpgroup
constexpr int BK = 64;               // K a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;   // + the producer warpgroup
constexpr int kA = BM * BK;          // elements of a stage's A tile (16 KB)
constexpr int kB = BK * BN;          // of its B tile (32 KB)
constexpr int kPart = 64 * BN / 2;   // an output part: 64 rows x 128 columns (16 KB)
// the k-step of the next tile at which a tile's first part goes out (its
// second a step later): after that tile's first products and loads are
// under way (steps 0, 1 and 2 measured; 1 the fastest at qwen3-moe's dW)
constexpr int kStoreFrom = 1;
// + 1 KB to align the operands to the swizzle pattern's 1024 bytes
constexpr int kBytes = 2 * (kStages * (kA + kB) + 2 * kPart) + 8 * 2 * kStages + 1024;

struct Params {
  int m_tiles, n_tiles, k_steps, tiles, n_fast;
  // which tensor-map dim (1..3) holds the rows, the expert and the unit dim
  int a_pos[3], b_pos[3], o_pos[3];
};

// output tile t: M tile fastest, then N tile, then expert; with n_fast the
// N tile fastest
struct TileIdx {
  int m0, n0, e;
  __device__ TileIdx(const Params& p, int t)
      : m0((p.n_fast ? t / p.n_tiles % p.m_tiles : t % p.m_tiles) * BM),
        n0((p.n_fast ? t % p.n_tiles : t / p.m_tiles % p.n_tiles) * BN),
        e(t / (p.m_tiles * p.n_tiles)) {}
};

// dw[e] (M = D x N = F) = A[e] (M x K) . B[e] (K x N), K = C: A = buf^T,
// buf read as stored, MN-major (two boxes of 64 M columns x 64 K rows of
// an (M, K, E) map); B = dy, MN-major (four boxes of 64 N columns x 64 K
// rows of an (N, K, E) map, as w in the forward). Warpgroup wg owns rows
// m0 + 64 wg.. and runs one wgmma m64n256k16 a k-step.
__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_dw_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, const Params p) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = as + kStages * kA;
  __nv_bfloat16* os = bs + kStages * kB;   // the two warpgroups' output parts
  uint64_t* full = reinterpret_cast<uint64_t*>(os + 2 * kPart);
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
#pragma unroll
          for (int c = 0; c < BM / 64; ++c)
            load_box(as + stage * kA + c * BK * 64, &amap, &full[stage], p.a_pos, ti.m0 + 64 * c,
                     k * BK, ti.e, 0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            load_box(bs + stage * kB + c * BK * 64, &bmap, &full[stage], p.b_pos, ti.n0 + 64 * c,
                     k * BK, ti.e, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, quad = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;   // issues the warpgroup's stores
  const int r = (warp % 4) * 16 + lane / 4;     // this thread's rows r, r + 8 of 64
  __nv_bfloat16* ot = os + wg * kPart;
  // The accumulator: this thread holds rows r and r + 8 of the warpgroup's
  // 64, columns 8j + 2 quad + {0, 1} (registers 4j + {0, 1} row r, 4j + {2,
  // 3} row r + 8). A tile's outputs wait in `held` as bf16 pairs (held[2j +
  // h]: row r + 8h, columns 8j + 2 quad..) until the next tile's products
  // run, then go out in parts of 128 columns (part q: held[32q..32q + 31])
  // at row held_row, column held_col + 128 q of expert held_e.
  float acc[BN / 2];
  uint32_t held[BN / 4];
  int held_parts = 0, stored = 0, held_row = 0, held_col = 0, held_e = 0;
  // part q of `held` into this warpgroup's 16 KB of shared memory, laid out
  // as TMA's 128-byte swizzle lays out two boxes of 64 columns (16-byte
  // chunk c of row x at chunk c ^ (x % 8): no bank conflicts), then out by
  // TMA stores, which drop rows past M and columns past N and run on
  // while the products do
  auto store_part = [&](int q) {
    if (leader) bulk_wait_read();   // the last part's stores have read ot
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      if (qq != q) continue;        // registers by constant index only
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        unsigned char* orow = reinterpret_cast<unsigned char*>(ot) + rr * 128 + 4 * quad;
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
          *reinterpret_cast<uint32_t*>(orow + (jj / 8) * 64 * 128 +
                                       (((jj % 8) ^ (rr % 8)) * 16)) =
              held[2 * (qq * (BN / 16) + jj) + h];
      }
    }
    fence_proxy_async_smem();
    named_barrier(1 + wg, 128);
    if (leader) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        store_box(&omap, ot + c * 64 * 64, p.o_pos, held_col + 128 * q + 64 * c, held_row,
                  held_e, 0);
      bulk_commit();
    }
  };

  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileIdx ti(p, t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < p.k_steps; ++k, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      // this warpgroup's 64 rows: the second of A's boxes for wg 1. Rows
      // past M are zero-filled and their outputs dropped by the stores:
      // every warpgroup runs the same products, so that no branch divides
      // the wgmma pipeline (ptxas would serialize it)
      const __nv_bfloat16* at = as + stage * kA + wg * 64 * 64;
      const __nv_bfloat16* bt = bs + stage * kB;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN, 1, 1>(acc, desc_mn_major<64>(at, BK, kk), desc_mn_major<BN>(bt, BK, kk), 1);
      wgmma_commit();
      // the last tile's outputs, a part a step, under these products
      if (k >= kStoreFrom && stored < held_parts) store_part(stored++);
      // done with the stage: free it at once, so that 3 stages' loads can
      // be in flight (the other warpgroup's products fill the wait)
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    while (stored < held_parts) store_part(stored++);   // a tile of few K steps
    // this tile's outputs, held until the next tile's products run
    stored = 0;
    held_parts = 2;
    held_row = ti.m0 + wg * 64;
    held_col = ti.n0;
    held_e = ti.e;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        held[2 * j + h] = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  while (stored < held_parts) store_part(stored++);
  if (leader) bulk_wait();
}

// buf (E, C, D), dy (E, C, F), dw (E, D, F), all contiguous: M = D, N = F,
// K = C. TMA reads rows at 16-byte strides from 16-byte-aligned bases: D
// and F multiples of 8.
cudaError_t launch(const void* a, const void* b, void* out, int E, int M, int N, int K,
                   int n_fast, cudaStream_t stream) {
  const long long m = (M + BM - 1) / BM, n = (N + BN - 1) / BN;
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || N % 8 || M % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || E * m * n > 0x7fffffffLL)
    return hopper::refuse("moe_gmm_dw_kernel: shape or alignment outside TMA's rule");
  Params p{static_cast<int>(m), static_cast<int>(n), (K + BK - 1) / BK,
           static_cast<int>(E * m * n), n_fast, {}, {}, {}};
  CUtensorMap am, bm, om;
  cudaError_t err;
  const long long mk = static_cast<long long>(M) * K, kn = static_cast<long long>(K) * N,
                  mn = static_cast<long long>(M) * N;
  using hopper::make_map;
  int sms = 0;
  if ((err = hopper::begin("moe_gmm_dw_kernel")) ||
      (err = make_map(&am, "buf (E, C, D)", a, M, {K, E, 1}, {M, mk, mk * E}, 64, BK,
                      p.a_pos)) ||
      (err = make_map(&bm, "dy (E, C, F)", b, N, {K, E, 1}, {N, kn, kn * E}, 64, BK,
                      p.b_pos)) ||
      (err = make_map(&om, "dw (E, D, F)", out, N, {M, E, 1}, {N, mn, mn * E}, 64, 64,
                      p.o_pos)) ||
      (err = hopper::sm_count(&sms)))
    return err;
  static const cudaError_t opted = hopper::opt_in(moe_gmm_dw_kernel, kBytes);
  // persistent: one block an SM (its shared memory allows no second)
  const int grid = p.tiles < sms ? p.tiles : sms;
  return hopper::launch("moe_gmm_dw_kernel", moe_gmm_dw_kernel, opted, grid, kThreads, kBytes,
                        stream, am, bm, om, p);
}

}  // namespace wgrad

// ===========================================================================
// 5. the bf16 dX, transposed: dbuf[e]^T (D x C) = w[e] (D x F) . dy[e]^T,
//    so that a tile holds 320 tokens and w is read once
// ===========================================================================
namespace dxt {

constexpr int BM = 128;              // D rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;               // F a stage: one 128-byte swizzled row
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;   // + the producer warpgroup

// a tile: 320 tokens (C), as two wgmma of 160 columns a k-step
constexpr int kNC = 320;
constexpr int kSplit = 2;
constexpr int NI = kNC / kSplit;
constexpr int kA = BM * BK, kB = kNC * BK;   // elements of a stage's w and dy tiles
constexpr int kPart = 64 * NI;               // a warpgroup's output part
constexpr int kStageBytes = 2 * (kA + kB);
constexpr int kFree = 232448 - 2 * 2 * kPart - 1024 - 256;
constexpr int kStages = kFree / kStageBytes > 6 ? 6 : kFree / kStageBytes;
constexpr int kBytes = kStages * kStageBytes + 2 * 2 * kPart + 16 * kStages + 1024;
static_assert(kStages >= 2, "dX tile");

struct Params {
  int c_tiles, d_tiles, k_steps, tiles;
  int a_pos[3], b_pos[3], o_pos[3];
};

// tile t: C tile fastest (they share w's tile), then D tile, then expert.
// A = w, K-major: one box of 64 F columns x 128 D rows of an (F, D, E) map;
// B = dy, K-major (as K in flash's Q.K^T): two boxes of 64 F columns x
// NI C rows of an (F, C, E) map. The accumulator is out^T: this thread's D
// rows r, r + 8 of its warpgroup's 64, C columns 8j + 2 quad + {0, 1}; the
// epilogue writes it to out (C rows of D) by stmatrix.trans into TMA's
// swizzled layout, a box of 64 D columns x NI C rows a warpgroup and part.
__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_dx_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, const Params p) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = as + kStages * kA;
  __nv_bfloat16* os = bs + kStages * kB;   // the two warpgroups' output parts
  uint64_t* full = reinterpret_cast<uint64_t*>(os + 2 * kPart);
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
        const int c0 = t % p.c_tiles * kNC, d0 = t / p.c_tiles % p.d_tiles * BM,
                  e = t / (p.c_tiles * p.d_tiles);
#pragma unroll 1
        for (int k = 0; k < p.k_steps; ++k, ++it) {
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          load_box(as + stage * kA, &amap, &full[stage], p.a_pos, k * BK, d0, e, 0);
#pragma unroll
          for (int h = 0; h < kSplit; ++h)
            load_box(bs + stage * kB + h * NI * BK, &bmap, &full[stage], p.b_pos, k * BK,
                     c0 + h * NI, e, 0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns D rows d0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;   // issues the warpgroup's stores
  __nv_bfloat16* ot = os + wg * kPart;
  // stmatrix: this lane addresses row lane % 8 of matrix lane / 8, whose D
  // columns start at d_blk (of the warpgroup's 64) and whose C rows are
  // column group j + (lane / 8) / 2 of the accumulator
  const int d_blk = 16 * (warp % 4) + 8 * ((lane / 8) % 2), c_in = 8 * (lane / 16) + lane % 8;
  float acc[kSplit][NI / 2];
  // part h (C columns c0 + h NI..) of a tile from bf16 pairs v (v[2j + x]:
  // accumulator registers 4j + 2x, + 1) into this warpgroup's shared memory
  // by stmatrix.trans, in TMA's 128-byte swizzle (16-byte chunk x of C row
  // c at chunk x ^ (c % 8): no bank conflicts), then out by a TMA store
  // that drops rows past C and columns past D
  auto store = [&](const uint32_t (&v)[NI / 4], int h, int c0, int d0, int e) {
    if (leader) bulk_wait_read();   // the last part's store has read ot
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < NI / 8; j += 2) {
      const int c = 8 * j + c_in;   // this lane's destination row: a C of the part
      stmatrix_x4_trans(smem_u32(ot) + c * 128 + (((d_blk / 8) ^ (c % 8)) * 16), v[2 * j],
                        v[2 * j + 1], v[2 * j + 2], v[2 * j + 3]);
    }
    fence_proxy_async_smem();
    named_barrier(1 + wg, 128);
    if (leader) {
      store_box(&omap, ot, p.o_pos, d0 + 64 * wg, c0 + h * NI, e, 0);
      bulk_commit();
    }
  };
  auto pack = [&](uint32_t (&v)[NI / 4], const float (&a)[NI / 2]) {
#pragma unroll
    for (int i = 0; i < NI / 4; ++i) v[i] = pack_bf16(a[2 * i], a[2 * i + 1]);
  };
  // a tile's second part waits as bf16 pairs in `held` and goes out under
  // the next tile's first products; its first part goes out at once, with
  // this warpgroup's tensor pipe idle (holding it too would take another 40
  // registers a thread, past the 232 the consumers have)
  uint32_t held[NI / 4];
  bool pending = false;
  int pc0 = 0, pd0 = 0, pe = 0;
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int c0 = t % p.c_tiles * kNC, d0 = t / p.c_tiles % p.d_tiles * BM,
              e = t / (p.c_tiles * p.d_tiles);
#pragma unroll
    for (int h = 0; h < kSplit; ++h)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[h][i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < p.k_steps; ++k, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      const __nv_bfloat16* at = as + stage * kA + wg * 64 * 64;
      const __nv_bfloat16* bt = bs + stage * kB;
#pragma unroll
      for (int h = 0; h < kSplit; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < kSplit; ++h)
          wgmma_ss<NI, 0, 0>(acc[h], desc_k_major<64>(at, BM, kk),
                             desc_k_major<64>(bt + h * NI * BK, NI, kk), 1);
      wgmma_commit();
      if (pending) {   // the last tile's second part, under these products
        store(held, 1, pc0, pd0, pe);
        pending = false;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kSplit; ++h) fence_regs(acc[h]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);   // done with the stage: free it at once
    }
    uint32_t first[NI / 4];
    pack(first, acc[0]);
    store(first, 0, c0, d0, e);
    pack(held, acc[1]);
    pending = true;
    pc0 = c0;
    pd0 = d0;
    pe = e;
  }
  if (pending) store(held, 1, pc0, pd0, pe);
  if (leader) bulk_wait();
}

// dy (E, C, F), w (E, D, F), out (E, C, D), all contiguous, D and F
// multiples of 8, 16-byte-aligned bases
cudaError_t launch(const void* dy, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  const long long c_tiles = (C + kNC - 1) / kNC, d_tiles = (D + BM - 1) / BM;
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || E * c_tiles * d_tiles > 0x7fffffffLL)
    return hopper::refuse("moe_gmm_dx_kernel: shape or alignment outside TMA's rule");
  Params p{static_cast<int>(c_tiles), static_cast<int>(d_tiles), (F + BK - 1) / BK,
           static_cast<int>(E * c_tiles * d_tiles), {}, {}, {}};
  CUtensorMap am, bm, om;
  cudaError_t err;
  const long long df = static_cast<long long>(D) * F, cf = static_cast<long long>(C) * F,
                  cd = static_cast<long long>(C) * D;
  using hopper::make_map;
  int sms = 0;
  if ((err = hopper::begin("moe_gmm_dx_kernel")) ||
      (err = make_map(&am, "w (E, D, F)", w, F, {D, E, 1}, {F, df, df * E}, 64, BM, p.a_pos)) ||
      (err = make_map(&bm, "dy (E, C, F)", dy, F, {C, E, 1}, {F, cf, cf * E}, 64, NI,
                      p.b_pos)) ||
      (err = make_map(&om, "dbuf (E, C, D)", out, D, {C, E, 1}, {D, cd, cd * E}, 64, NI,
                      p.o_pos)) ||
      (err = hopper::sm_count(&sms)))
    return err;
  auto kernel = moe_gmm_dx_kernel;
  static const cudaError_t opted = hopper::opt_in(kernel, kBytes);
  // persistent: one block an SM (its shared memory allows no second)
  const int grid = p.tiles < sms ? p.tiles : sms;
  return hopper::launch("moe_gmm_dx_kernel", kernel, opted, grid, kThreads, kBytes, stream,
                        am, bm, om, p);
}

}  // namespace dxt

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ===========================================================================
// 2. bf16 decode: w through a TMA ring, out^T = w^T . buf^T on wgmma, one
//    block an SM walking whole tiles
// ===========================================================================
namespace dec {

constexpr int BN = 128;              // F columns a tile: two boxes of 64
constexpr int BK = 128;              // D rows a stage: two 128-byte swizzled rows of buf
constexpr int NR = 16;               // buf rows a stage, wgmma's N: C <= 16, zero past C
constexpr int kStages = 2;
constexpr int kConsumerWarps = 4;    // one warpgroup
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kW = BK * BN;          // elements of a stage's w tile (32 KB)
constexpr int kA = NR * BK;          // of its buf tile (4 KB)
// + 1 KB to align the tiles to the swizzle pattern's 1024 bytes
constexpr int kBytes = 2 * kStages * (kW + kA) + 8 * 2 * kStages + 1024;

struct Params {
  __nv_bfloat16* out;   // (E, C, F)
  int C, F, n_tiles, k_steps, tiles;   // F tiles an expert, D steps a tile, E*n_tiles
  int a_pos[3], w_pos[3];
};

// tile t is F columns (t % n_tiles)*BN.. of expert t / n_tiles
__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_decode_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap wmap, const Params p) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* as = ws + kStages * kW;
  uint64_t* full = reinterpret_cast<uint64_t*>(as + kStages * kA);
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

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every TMA load of the block's tiles ----
    if (lane == 0) {
      const uint64_t again = l2_evict_last();   // buf is read once per F tile
      int it = 0;
#pragma unroll 1
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int e = t / p.n_tiles, n0 = t % p.n_tiles * BN;
#pragma unroll 1
        for (int k = 0; k < p.k_steps; ++k, ++it) {
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * (kW + kA));
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            load_box(ws + stage * kW + c * BK * 64, &wmap, &full[stage], p.w_pos, n0 + 64 * c,
                     k * BK, e, 0);
#pragma unroll
          for (int c = 0; c < BK / 64; ++c)
            load_box(as + stage * kA + c * NR * 64, &amap, &full[stage], p.a_pos,
                     k * BK + 64 * c, 0, e, 0, again);
        }
      }
    }
    return;
  }

  // ---- consumers: box m's accumulator is the tile's F rows 64m..64m+63
  // (wgmma's M) x the 16 token columns (N). This thread holds F rows
  // 16*warp + lane/4 (+ 8) and tokens 8j + 2*(lane%4) + {0, 1}: register
  // 4j + {0, 1} the first row, 4j + {2, 3} the second ----
  float acc[BN / 64][8];
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
    for (int m = 0; m < BN / 64; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[m][i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < p.k_steps; ++k, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      const __nv_bfloat16* wt = ws + stage * kW;
      const __nv_bfloat16* at = as + stage * kA;
#pragma unroll
      for (int m = 0; m < BN / 64; ++m) fence_regs(acc[m]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_k_major<64>(at, NR, kk);
#pragma unroll
        for (int m = 0; m < BN / 64; ++m)
          wgmma_ss<16, 1, 0>(acc[m], desc_mn_major<64>(wt + m * BK * 64, BK, kk), db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < BN / 64; ++m) fence_regs(acc[m]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);   // done with the stage: free it at once
    }

    // out[e][c][f] for the tokens c < C and the columns f < F
    const int e = t / p.n_tiles, n0 = t % p.n_tiles * BN;
    __nv_bfloat16* o_e = p.out + static_cast<long long>(e) * p.C * p.F;
#pragma unroll
    for (int m = 0; m < BN / 64; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = n0 + 64 * m + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < NR / 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int c = 8 * j + 2 * (lane % 4) + x;
            if (c < p.C && f < p.F)
              o_e[static_cast<long long>(c) * p.F + f] = __float2bfloat16(acc[m][4 * j + 2 * h + x]);
          }
      }
  }
}

// buf (E, C, D), w (E, D, F), out (E, C, F), all contiguous; C <= NR, D and
// F multiples of 8, buf's and w's bases 16-byte aligned (TMA's rule); at
// most one block an SM, as few as give each the same number of tiles
int launch(const void* buf, const void* w, void* out, int E, int C, int D, int F,
           cudaStream_t stream) {
  const long long n_tiles = (F + BN - 1LL) / BN, tiles = E * n_tiles;
  if (E <= 0 || C <= 0 || C > NR || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      !aligned16(buf) || !aligned16(w) || tiles > 0x7fffffffLL)
    return hopper::refuse("moe_gmm_decode_kernel: shape or alignment outside TMA's rule");
  Params p{static_cast<__nv_bfloat16*>(out), C, F, static_cast<int>(n_tiles),
           (D + BK - 1) / BK, static_cast<int>(tiles), {}, {}};
  CUtensorMap am, wm;
  cudaError_t err;
  const long long cd = static_cast<long long>(C) * D, df = static_cast<long long>(D) * F;
  int sms = 0;
  if ((err = hopper::begin("moe_gmm_decode_kernel")) ||
      (err = hopper::make_map(&am, "buf", buf, D, {C, E, 1}, {D, cd, cd * E}, 64, NR,
                              p.a_pos)) ||
      (err = hopper::make_map(&wm, "w", w, F, {D, E, 1}, {F, df, df * E}, 64, BK, p.w_pos,
                              true)) ||
      (err = hopper::sm_count(&sms)))
    return err;
  static const cudaError_t opted = hopper::opt_in(moe_gmm_decode_kernel, kBytes);
  const long long rounds = (tiles + sms - 1) / sms;
  const int grid = static_cast<int>((tiles + rounds - 1) / rounds);
  return hopper::launch("moe_gmm_decode_kernel", moe_gmm_decode_kernel, opted, grid, kThreads,
                        kBytes, stream, am, wm, p);
}

}  // namespace dec

int check_dims(const char* kernel, int E, int M, int N, int K, int rows_per_block) {
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || E > 65535 ||
      (M + rows_per_block - 1) / rows_per_block > 65535) {
    hopper::note("%s: a dim is not positive or its grid exceeds 65535 blocks", kernel);
    return cudaErrorInvalidValue;
  }
  return hopper::begin(kernel);
}

// layouts as in moe_gmm_bf16_kernel: A (E, M, K), or (E, K, M) when kAT; B
// (E, K, N) when kBT, else (E, N, K)
template <int BM, int BN, int BK, int WM, int WN, bool kAT, bool kBT>
int launch_bf16(const void* a, const void* b, void* out, int E, int M, int N, int K,
                cudaStream_t stream) {
  if (int err = check_dims("moe_gmm_bf16_kernel", E, M, N, K, BM)) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  return hopper::launch(
      "moe_gmm_bf16_kernel", moe_gmm_bf16_kernel<BM, BN, BK, WM, WN, kAT, kBT>, cudaSuccess,
      grid, kThreads, 0, stream, static_cast<const unsigned short*>(a),
      static_cast<const unsigned short*>(b), static_cast<__nv_bfloat16*>(out), M, K, N,
      int((kAT ? M : K) % 8 == 0 && aligned16(a)), int((kBT ? N : K) % 8 == 0 && aligned16(b)));
}

template <bool kAT, bool kBT>
int launch_f32(const void* a, const void* b, void* out, int E, int M, int N, int K,
               cudaStream_t stream) {
  if (int err = check_dims("moe_gmm_f32_kernel", E, M, N, K, kT)) return err;
  const dim3 grid((N + kT - 1) / kT, (M + kT - 1) / kT, E);
  return hopper::launch("moe_gmm_f32_kernel", moe_gmm_f32_kernel<kAT, kBT>, cudaSuccess, grid,
                        dim3(kT, kT), 0, stream, static_cast<const float*>(a),
                        static_cast<const float*>(b), static_cast<float*>(out), M, K, N);
}

}  // namespace

// any shape, any C: the caller's choice where TMA's rule fails (`_variant`)
extern "C" int repro_moe_gmm_bf16(const void* buf, const void* w, void* out, int E, int C,
                                  int D, int F, void* stream) {
  return launch_bf16<64, 64, 32, 32, 32, false, true>(buf, w, out, E, C, F, D,
                                                      static_cast<cudaStream_t>(stream));
}

// C <= 16 under TMA's rule
extern "C" int repro_moe_gmm_bf16_decode(const void* buf, const void* w, void* out, int E,
                                         int C, int D, int F, void* stream) {
  return dec::launch(buf, w, out, E, C, D, F, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_moe_gmm_f32(const void* buf, const void* w, void* out, int E, int C,
                                 int D, int F, void* stream) {
  return launch_f32<false, true>(buf, w, out, E, C, F, D, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_moe_gmm_bf16_tc(const void* buf, const void* w, void* out, int E, int C,
                                     int D, int F, void* stream) {
  return tc::launch(buf, w, out, E, C, F, D, static_cast<cudaStream_t>(stream));
}

// the backward: dw = 0 computes dbuf (E, C, D) = dy . w^T from (x, y) =
// (dy, w) on the transposed kernel; dw = 1 computes dw (E, D, F) = buf^T .
// dy from (x, y) = (buf, dy), N tiles fastest with n_fast
// (kernels/moe_gmm.py `_bwd_plan` picks it)
extern "C" int repro_moe_gmm_bwd_bf16_tc(const void* x, const void* y, void* out, int E, int C,
                                         int D, int F, int dw, int n_fast, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dw ? wgrad::launch(x, y, out, E, D, F, C, n_fast, s)
            : dxt::launch(x, y, out, E, C, D, F, s);
}

extern "C" int repro_moe_gmm_bwd_bf16(const void* x, const void* y, void* out, int E, int C,
                                      int D, int F, int dw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dw ? launch_bf16<64, 64, 32, 32, 32, true, true>(x, y, out, E, D, F, C, s)
            : launch_bf16<64, 64, 32, 32, 32, false, false>(x, y, out, E, C, D, F, s);
}

extern "C" int repro_moe_gmm_bwd_f32(const void* x, const void* y, void* out, int E, int C,
                                     int D, int F, int dw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dw ? launch_f32<true, true>(x, y, out, E, D, F, C, s)
            : launch_f32<false, false>(x, y, out, E, C, D, F, s);
}
