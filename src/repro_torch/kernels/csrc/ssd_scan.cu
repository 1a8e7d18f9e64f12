// Mamba2 SSD chunked scan for Hopper (sm_90a): bf16 on tensor cores, f32 on FMAs.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (wrapper `ssd_scan_pallas`) and computes what it computes, plus the final
// state: for head h of batch row b, with group g = h / (H / G),
//   dA_s = dt_s * a_h,   cum_i = sum_{s <= i} dA_s over the chunk,
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra-chunk)
//        + exp(cum_i) C_i . h_in                                   (incoming state)
//   h   <- h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j,
// carried over the sequence; y (B, S, H, P) in the input type and the f32
// final state h_final (B, H, P, N). Inputs x (B, S, H, P), dt (B, S, H),
// B and C (B, S, G, N) may be strided views (the splits of the model's xBC)
// as long as their last dim is contiguous; a (H,) is contiguous. The SSD is
// exact under any chunking, so either kernel gives the TPU kernel's result
// up to rounding whatever the config's chunk.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at mamba2-370m's
// prefill (B 4, S 1024, H 32, P 64, N 128, bf16) the bytes (x, dt, B, C read
// once, y and h_final written once: 40 MB) take 12.0 us; the operations of
// the chunked form, C.B^T shared by the heads of a group, ~5.4 GFLOP, 5.5 us.
// So the job is bound by bytes, and what a kernel has to find is
// parallelism across the card and a load path near the memory's rate.
//
// Two kernels, chosen by the wrapper (kernels/ssd_scan.py `_variant`) by
// dtype, never one in place of another that failed:
//
// 1. bf16 (`ssd_scan_tc_kernel`, entry repro_ssd_scan_bf16): chunks in
//    parallel, the products on tensor cores. The TPU kernel walks the chunks
//    of one (batch, head) in order on one core; here the sequence is cut into
//    chunks of Q = 128 rows and one block takes one (chunk, batch, block of
//    `heads` heads of one group, 64- or 32-column tile of P): 1024 (b, h, c)
//    units at mamba2's prefill, 512 blocks of 2 heads (the f32 kernel below
//    has 128 there, each walking all of S). The wrapper picks `heads` (1..8, a
//    divisor of H/G) as the most that keep 3 blocks an SM: more heads share
//    C.B^T and overlap one head's x load with another's work, fewer blocks
//    leave SMs waiting on a block's loads.
//    Only the recurrence h_in[c+1] = h_in[c] exp(sum dA_c) + S_c runs in
//    chunk order, and it is passed block to block inside the launch: h_final
//    itself carries h (P x N f32 per (b, h): 4.2 MB at mamba2, L2-resident,
//    so chunk states are never written per chunk), and one flag per (b, h,
//    P tile) says which chunk's h_in it holds. A block takes an ordered
//    ticket (an atomic counter) and its unit from it, chunk-major, so the
//    block it waits on took an earlier ticket and is already running: no
//    wait is on a block that has not started. The last block to finish
//    resets the ticket, the last chunk's block its flag; so launches on one
//    stream share one zeroed buffer.
//    Per block: TMA loads C and B of the chunk (K-major tiles, the 128-byte
//    swizzle at N = 64, 128) once, and x of each head through two buffers
//    (the next head's load overlaps this one's work); TMA zero-fills rows
//    past S, whose dt the block loads as 0, so they neither decay nor feed
//    the state, and a TMA store drops their y. Two warpgroups of 64 rows:
//    - C.B^T once per block for all its heads (wgmma, both operands K-major
//      in shared memory; the upper warpgroup's strip is 64 x 128, the
//      lower's only its causal 64 x 64), kept in f32 registers;
//    - per head, first the chunk state S_c = (w o x)^T B with w_j =
//      exp(cum_last - cum_j) dt_j on mma.sync (x and B by ldmatrix.trans),
//      w o x split into bf16 hi + lo so that the carried state keeps f32
//      accuracy; meanwhile h_in's loads are in flight if the chunk before
//      has raised its flag already (else the block waits, then loads);
//    - h_out = h_in exp(cum_last) + S_c to h_final in f32, h_in in bf16 to
//      shared memory, the flag raised (chunk c + 1 goes on from here);
//    - y = exp(cum_i) C_i.h_in^T (wgmma), then M = (C.B^T) o exp(cum_i -
//      cum_j) dt_j for j <= i (exp only of arguments <= 0: never above the
//      diagonal), rounded to bf16 A fragments in registers, and y += M.x as
//      wgmma (A from registers, x read MN-major: flash attention's P.V);
//    - y in bf16 into x's spent buffer, one TMA store.
//    One CUDA kernel per call. 256 threads and one block an SM (up to 255
//    registers a thread, ~125 KB of shared memory at N = 128). What holds it
//    above its bound (PERF.md): the chunk state's mma.sync, the h pass-on's
//    round trips through L2, and each block's load latency, which one block
//    an SM does not hide.
// 2. f32 (`ssd_scan_kernel`, entry repro_ssd_scan_f32): the first port. One
//    block owns one (batch, head, tile of PT columns of P) and walks the
//    sequence itself in tiles of 64 rows, with its (N x PT) f32 slice of the
//    state in shared memory: the recurrence is independent per column of P,
//    so the P tiles need nothing from each other. Per tile: a warp scan
//    gives cum in f32; M = (C B^T) o exp(cum_i - cum_j) dt_j is formed only
//    for j <= i; then y = M x + exp(cum) C h_in, then the state update. All
//    four products run as f32 FMAs on 4 x 4 register tiles from shared
//    memory, operands laid out k-major so that each step is two 16-byte
//    loads. Rows past S load dt = 0 and x = B = C = 0: they neither decay
//    nor feed the state, and their y is not written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ===========================================================================
// 2. f32: FMAs from shared memory, one block per (batch, head, P tile)
// ===========================================================================
constexpr int kL = 64;          // rows per tile of the sequence
constexpr int kThreads = 256;
constexpr int kLS = kL + 4;     // row stride (floats) of the L-wide arrays

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// W consecutive floats of shared memory (16- or 8-byte aligned) into v
template <int W>
__device__ __forceinline__ void load_row(const float* src, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    static_assert(W == 2, "row width");
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x; v[1] = t.y;
  }
}

struct SsdParams {
  const void* x;
  const void* dt;
  const void* a;
  const void* b;
  const void* c;
  void* y;         // (B, S, H, P), contiguous
  float* h_final;  // (B, H, P, N), contiguous
  int B, S, H, P, G;
  long long x_sb, x_ss, x_sh;  // strides in elements; the last dim is contiguous
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

template <int N, int PT>
constexpr int smem_floats() {
  return 2 * N * kLS + kL * kLS + kL * (PT + 4) + N * (PT + 4) + 2 * kL + kL;
}

template <typename T, int N, int PT>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const SsdParams p) {
  constexpr int PS = PT + 4;    // row stride (floats) of x and of the state
  constexpr int CW = PT / 16;   // columns of P per thread in the y tile
  static_assert(N % 4 == 0 && PT % 32 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* bt = smem;             // N x kLS: bt[n][j] = B[j][n]
  float* ct = bt + N * kLS;     // N x kLS: ct[n][i] = C[i][n]
  float* mt = ct + N * kLS;     // kL x kLS: mt[j][i] = M[i][j]
  float* xs = mt + kL * kLS;    // kL x PS: xs[j][q] = x[j][p0 + q]
  float* hs = xs + kL * PS;     // N x PS: hs[n][q] = h[p0 + q][n]
  float* dts = hs + N * PS;     // kL: dt
  float* cum = dts + kL;        // kL: inclusive cumsum of dt * a in the tile
  float* wts = cum + kL;        // kL: exp(cum[last] - cum[j]) * dt[j]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.y * PT;
  const int tid = threadIdx.x;
  const float a = to_f32(static_cast<const T*>(p.a)[h]);
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* dtg = static_cast<const T*>(p.dt) + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb + g * p.c_sg;
  const long long y_ss = static_cast<long long>(p.H) * p.P;
  T* yg = static_cast<T*>(p.y) + (static_cast<long long>(b) * p.S * p.H + h) * p.P + p0;

  for (int i = tid; i < N * PS; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += kL) {
    __syncthreads();  // the previous tile's reads are done
    const int rows = min(kL, p.S - c0);
    if (tid < kL) dts[tid] = tid < rows ? to_f32(dtg[(c0 + tid) * p.dt_ss]) : 0.f;
    for (int i = tid; i < kL * PT; i += kThreads) {
      const int j = i / PT, q = i % PT;
      xs[j * PS + q] = j < rows ? to_f32(xg[(c0 + j) * p.x_ss + q]) : 0.f;
    }
    // neighbouring threads on neighbouring rows j: the transposed stores
    // into shared memory are free of bank conflicts
    for (int i = tid; i < kL * N; i += kThreads) {
      const int j = i % kL, n = i / kL;
      const bool ok = j < rows;
      bt[n * kLS + j] = ok ? to_f32(bg[(c0 + j) * p.b_ss + n]) : 0.f;
      ct[n * kLS + j] = ok ? to_f32(cg[(c0 + j) * p.c_ss + n]) : 0.f;
    }
    __syncthreads();

    if (tid < 32) {  // one warp: inclusive scan of dA over the 64 rows
      float v0 = dts[tid] * a, v1 = dts[tid + 32] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float total = __shfl_sync(0xffffffffu, v1, 31);
      cum[tid] = v0;
      cum[tid + 32] = v1;
      // cum falls along the tile (dA <= 0), so these exponents are <= 0
      wts[tid] = expf(total - v0) * dts[tid];
      wts[tid + 32] = expf(total - v1) * dts[tid + 32];
    }
    __syncthreads();

    // M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    for (int t = tid; t < (kL / 4) * (kL / 4); t += kThreads) {
      const int i0 = (t / (kL / 4)) * 4, j0 = (t % (kL / 4)) * 4;
      float acc[4][4] = {};
      if (j0 <= i0) {  // a tile wholly above the diagonal stays 0
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
          load_row<4>(ct + n * kLS + i0, cv);
          load_row<4>(bt + n * kLS + j0, bv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] += cv[r] * bv[s];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int i = i0 + r, j = j0 + s;
          mt[j * kLS + i] = j <= i ? acc[r][s] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // y = M x + exp(cum) (C h_in), written for the rows below S
    for (int t = tid; t < (kL / 4) * 16; t += kThreads) {
      const int i0 = (t / 16) * 4, q0 = (t % 16) * CW;
      float yi[4][CW] = {}, yo[4][CW] = {};
      for (int j = 0; j < i0 + 4; ++j) {  // M[i][j] = 0 for j > i
        float mv[4], xv[CW];
        load_row<4>(mt + j * kLS + i0, mv);
        load_row<CW>(xs + j * PS + q0, xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < CW; ++s) yi[r][s] += mv[r] * xv[s];
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[CW];
        load_row<4>(ct + n * kLS + i0, cv);
        load_row<CW>(hs + n * PS + q0, hv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < CW; ++s) yo[r][s] += cv[r] * hv[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i < rows) {
          const float e = expf(cum[i]);
          T* yr = yg + (c0 + i) * y_ss + q0;
#pragma unroll
          for (int s = 0; s < CW; ++s) yr[s] = from_f32<T>(yi[r][s] + e * yo[r][s]);
        }
      }
    }
    __syncthreads();  // the state is read above and updated below

    // h <- h exp(cum_last) + sum_j wts_j x_j (x) B_j
    const float decay = expf(cum[kL - 1]);
    for (int t = tid; t < (N / 4) * (PT / 4); t += kThreads) {
      const int n0 = (t / (PT / 4)) * 4, q0 = (t % (PT / 4)) * 4;
      float acc[4][4] = {};
      for (int j = 0; j < rows; ++j) {
        const float w = wts[j];
        float bv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = bt[(n0 + r) * kLS + j] * w;
        load_row<4>(xs + j * PS + q0, xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] += bv[r] * xv[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float& hv = hs[(n0 + r) * PS + q0 + s];
          hv = hv * decay + acc[r][s];
        }
    }
  }
  __syncthreads();

  float* hf = p.h_final + (static_cast<long long>(bh) * p.P + p0) * N;
  for (int i = tid; i < PT * N; i += kThreads) {
    const int q = i / N, n = i % N;
    hf[q * N + n] = hs[n * PS + q];
  }
}

template <typename T, int N, int PT>
cudaError_t launch(const SsdParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) * smem_floats<N, PT>();
  if (cudaError_t err = hopper::begin("ssd_scan_kernel")) return err;
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t opted = hopper::opt_in(ssd_scan_kernel<T, N, PT>, smem);
  const dim3 grid(p.B * p.H, p.P / PT);
  return hopper::launch("ssd_scan_kernel", ssd_scan_kernel<T, N, PT>, opted, grid, kThreads,
                        smem, stream, p);
}

template <typename T, int N>
cudaError_t launch_for_p(const SsdParams& p, cudaStream_t stream) {
  if (p.P % 64 == 0) return launch<T, N, 64>(p, stream);
  return launch<T, N, 32>(p, stream);
}

template <typename T>
int ssd_scan(const void* x, const void* dt, const void* a, const void* b, const void* c,
             void* y, void* h_final, int B, int S, int H, int P, int G, int N,
             long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
             long long dt_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,
             long long c_ss, long long c_sg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P % 32 != 0)
    return cudaErrorInvalidValue;
  const SsdParams p{x, dt, a, b, c, y, static_cast<float*>(h_final), B, S, H, P, G,
                    x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch_for_p<T, 16>(p, st);
    case 32: return launch_for_p<T, 32>(p, st);
    case 64: return launch_for_p<T, 64>(p, st);
    case 128: return launch_for_p<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// 1. bf16: chunks in parallel, TMA + wgmma / mma.sync, h passed block to block
// ===========================================================================
namespace tc {

constexpr int Q = 128;             // rows a chunk: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kMaxHeads = 8;       // heads a block takes: one warp scans each
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint64_t kWaitNs = 2000000000ull;   // 2 s: a launch takes well under 1 ms

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Shared memory of one block, in bf16 elements: C and B of the chunk (Q x N
// each), two x buffers (Q x PT), h_in (PT x N); every tile's bytes are a
// multiple of 1024, so each starts aligned to the 128-byte swizzle's atom.
// Then per head dt, cum (log2-scaled) and the state weights w (Q floats
// each), cum at the chunk's end, three mbarriers and the ticket.
template <int N, int PT>
struct Smem {
  static constexpr int kBC = Q * N;
  static constexpr int kX = Q * PT;
  static constexpr int kH = PT * N;
  static constexpr int kFloats = 3 * kMaxHeads * Q + kMaxHeads;
  static constexpr int kBytes = 1024 + 2 * (2 * kBC + 2 * kX + kH) + 4 * kFloats + 8 * 3 + 16;
};

struct Params {
  const __nv_bfloat16* dt;
  const __nv_bfloat16* a;
  __nv_bfloat16* y;    // (B, S, H, P), contiguous
  float* h_final;      // (B, H, P, N), contiguous; carries h from chunk to chunk
  int* sync;           // ticket, finished blocks, one flag per (b, h, P tile): 0 between launches
  int B, S, H, P, G, heads, nc, ptiles;
  long long dt_sb, dt_ss, dt_sh;
  // which tensor-map dim (1..3) holds the sequence, the head (group) and the batch
  int x_pos[3], b_pos[3], c_pos[3], y_pos[3];
};

// element offset of the 8 columns col..col+7 (col a multiple of 8) of row r
// in a tile of `rows` rows of D columns laid out as hopper::Tile<D> says
template <int D>
__device__ __forceinline__ int tile_off(int rows, int r, int col) {
  if constexpr (hopper::Tile<D>::kSwizzle)
    return (col / 64) * rows * 64 + r * 64 + ((((col % 64) / 8) ^ (r % 8)) * 8);
  else
    return (col / 8) * rows * 8 + r * 8;
}

// a bf16 pair times (w0, w1) in f32, as a bf16 pair hi and the pair lo of
// what hi misses: hi + lo holds the f32 product to ~2^-16
__device__ __forceinline__ void split_scaled(uint32_t v, float w0, float w1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float f0 = __low2float(x) * w0, f1 = __high2float(x) * w1;
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(f0 - __low2float(h), f1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int N, int PT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap ymap, const Params p) {
  using namespace hopper;
  using L = Smem<N, PT>;
  constexpr int WN = Tile<N>::kBoxCols, WP = Tile<PT>::kBoxCols;
  // the chunk state's mma.sync tiles: 16 rows of P (PB blocks) x 16 columns
  // of N (NBP pairs of 8-column tiles); warp w takes P block w % PB and the
  // column pairs w / PB, + NG, ...
  constexpr int PB = PT / 16, NG = 8 / PB, NBP = N / 16, NPW = (NBP + NG - 1) / NG;
  static_assert(N % 16 == 0 && N <= 128 && (PT == 32 || PT == 64), "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = cs + L::kBC;
  __nv_bfloat16* xs = bs + L::kBC;     // two buffers of L::kX
  __nv_bfloat16* hs = xs + 2 * L::kX;  // h_in in bf16, PT rows of N (K-major)
  float* dts = reinterpret_cast<float*>(hs + L::kH);
  float* cum = dts + kMaxHeads * Q;    // inclusive cumsum of dt * a * log2(e)
  float* wts = cum + kMaxHeads * Q;    // exp(cum_last - cum_j) * dt_j
  float* last = wts + kMaxHeads * Q;   // cum at the chunk's end
  uint64_t* bars = reinterpret_cast<uint64_t*>(last + kMaxHeads);   // B/C, x buffers 0 and 1
  int* ticket = reinterpret_cast<int*>(bars + 3);
  int* ready = ticket + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    *ticket = atomicAdd(p.sync, 1);
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // the unit of this ticket, chunk-major: every block of chunk c - 1 took
  // its ticket, and so runs or has finished, before any block of chunk c
  const int hblocks = p.H / p.heads, per_chunk = p.B * hblocks * p.ptiles;
  int t = *ticket;
  const int c = t / per_chunk;
  t %= per_chunk;
  const int pt = t % p.ptiles;
  t /= p.ptiles;
  const int h0 = (t % hblocks) * p.heads, b = t / hblocks;
  const int g = h0 / (p.H / p.G);
  const int row0 = c * Q, p0 = pt * PT;

  const CUtensorMap* xm = &xmap;
  auto load_x = [&](int k) {   // x of head h0 + k into buffer k % 2
    uint64_t* bar = &bars[1 + (k & 1)];
    __nv_bfloat16* dst = xs + (k & 1) * L::kX;
    mbar_arrive_expect_tx(bar, 2 * L::kX);
#pragma unroll 1
    for (int cb = 0; cb < PT / WP; ++cb)
      load_box(dst + cb * Q * WP, xm, bar, p.x_pos, p0 + WP * cb, row0, h0 + k, b);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * 2 * L::kBC);
#pragma unroll 1
    for (int cb = 0; cb < N / WN; ++cb) {
      load_box(cs + cb * Q * WN, &cmap, &bars[0], p.c_pos, WN * cb, row0, g, b);
      load_box(bs + cb * Q * WN, &bmap, &bars[0], p.b_pos, WN * cb, row0, g, b);
    }
    load_x(0);
    if (p.heads > 1) load_x(1);
  }
  // dt of the block's heads (neighbouring threads on neighbouring heads of
  // a row), 0 past S
  for (int i = tid; i < p.heads * Q; i += kThreads) {
    const int k = i % p.heads, j = i / p.heads, row = row0 + j;
    dts[k * Q + j] = row < p.S ? __bfloat162float(p.dt[b * p.dt_sb + row * p.dt_ss +
                                                       (h0 + k) * p.dt_sh])
                               : 0.f;
  }
  __syncthreads();
  if (warp < p.heads) {   // warp k: the scan of head k over the chunk, 4 rows a lane
    const int k = warp;
    const float a = __bfloat162float(p.a[h0 + k]) * kLog2e;
    float v[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      run += dts[k * Q + 4 * lane + e] * a;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float base = incl - run, total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k * Q + 4 * lane + e;
      cum[j] = base + v[e];
      // cum falls along the chunk (dA <= 0): the exponent is <= 0
      wts[j] = exp2_approx(fminf(total - cum[j], 0.f)) * dts[j];
    }
    if (lane == 0) last[k] = total;
  }
  __syncthreads();

  // ---- C.B^T for every head of the block; warpgroup wg owns rows 64 wg .. ----
  const int wg = warp / 4, quad = lane % 4;
  // the accumulator layout: this thread holds rows r0 and r0 + 8 (of the
  // chunk), columns 8*jj + 2*quad + {0, 1} (register 4*jj + {0, 1} row r0,
  // 4*jj + {2, 3} row r1)
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const __nv_bfloat16* c_wg = cs + wg * 64 * WN;
  float s[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) s[i] = 0.f;
  mbar_wait(&bars[0], 0);
  fence_regs(s);
  wgmma_fence();
  if (wg == 0) {   // its causal part: columns 0..63
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<64>(*reinterpret_cast<float(*)[32]>(s), desc_k_major<N>(c_wg, Q, kk),
                      desc_k_major<N>(bs, Q, kk), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<128>(s, desc_k_major<N>(c_wg, Q, kk), desc_k_major<N>(bs, Q, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  const int ksteps = (wg + 1) * (Q / 32);   // k-steps of M.x with a row at or past j
  const int gq = lane / 4, mi = lane / 8, rr = lane % 8;
  const int pb = warp % PB, ng = warp / PB;
  // this lane's ldmatrix rows in x (rows j, columns p of P block pb) and in
  // B (rows j, columns n of each column pair it takes); k-step kk is 16 rows
  // on, which keeps a row's place in the swizzle
  const int a_off = tile_off<PT>(Q, (mi >> 1) * 8 + rr, 16 * pb + (mi & 1) * 8);
  uint32_t b_addr[NPW];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
    b_addr[i] = smem_u32(bs + tile_off<N>(Q, (mi & 1) * 8 + rr, 16 * (ng + NG * i) + (mi >> 1) * 8));

#pragma unroll 1
  for (int k = 0; k < p.heads; ++k) {
    const int h = h0 + k, buf = k & 1;
    const float* cm = cum + k * Q;
    const float* dk = dts + k * Q;
    const float* wk = wts + k * Q;
    mbar_wait(&bars[1 + buf], (k >> 1) & 1);
    const __nv_bfloat16* xt = xs + buf * L::kX;

    // h_in[c], which the block of chunk c - 1 leaves in h_final: if its flag
    // is up already (the rule: that block started a wave earlier), its loads
    // go out now and land while the state product runs
    int* flag = p.sync + 2 + (static_cast<long long>(b) * p.H + h) * p.ptiles + pt;
    float* hf = p.h_final + ((static_cast<long long>(b) * p.H + h) * p.P + p0) * N;
    if (tid == 0) *ready = c == 0 || ld_acquire(flag) == c;
    __syncthreads();
    const bool early = *ready;
    float2 hin[NPW][2][2];
    auto load_h = [&]() {
#pragma unroll
      for (int i = 0; i < NPW; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pr = 16 * pb + gq + 8 * half, n = 16 * (ng + NG * i) + 8 * e + 2 * quad;
            hin[i][e][half] = (c > 0 && ng + NG * i < NBP)
                                  ? __ldcg(reinterpret_cast<const float2*>(hf + pr * N + n))
                                  : make_float2(0.f, 0.f);
          }
    };
    if (early) load_h();

    // the chunk state S_c = (w o x)^T B on mma.sync, w o x as bf16 hi + lo
    float st[NPW][2][4];
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[i][e][r] = 0.f;
    const uint32_t xa = smem_u32(xt + a_off);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      // A = (w o x)^T: rows p, reduction over j; x is [j][p], so transposed
      uint32_t ax[4], hi[4], lo[4];
      ldmatrix_x4_trans_at(ax, xa + kk * 16 * WP * 2);
      const float2 w01 = *reinterpret_cast<const float2*>(wk + 16 * kk + 2 * quad);
      const float2 w89 = *reinterpret_cast<const float2*>(wk + 16 * kk + 8 + 2 * quad);
      split_scaled(ax[0], w01.x, w01.y, hi[0], lo[0]);
      split_scaled(ax[1], w01.x, w01.y, hi[1], lo[1]);
      split_scaled(ax[2], w89.x, w89.y, hi[2], lo[2]);
      split_scaled(ax[3], w89.x, w89.y, hi[3], lo[3]);
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        if (ng + NG * i < NBP) {
          uint32_t bf[4];   // B fragments of columns 16 np .. + 7 and + 8 .. + 15
          ldmatrix_x4_trans_at(bf, b_addr[i] + kk * 16 * WN * 2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_16816(st[i][e], hi[0], hi[1], hi[2], hi[3], bf[2 * e], bf[2 * e + 1]);
            mma_16816(st[i][e], lo[0], lo[1], lo[2], lo[3], bf[2 * e], bf[2 * e + 1]);
          }
        }
      }
    }

    if (!early) {   // wait for the chunk before; if its flag never comes (a
                    // fault elsewhere), fail the launch after kWaitNs
      if (tid == 0) {
        const uint64_t t0 = globaltimer_ns();
        while (ld_acquire(flag) != c) {
          __nanosleep(20);
          if (globaltimer_ns() - t0 > kWaitNs) __trap();
        }
      }
      __syncthreads();
      load_h();
    }
    // h_out = h_in exp(cum_last) + S_c back into h_final in f32, h_in into
    // shared memory in bf16
    const float decay = exp2_approx(last[k]);
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int np = ng + NG * i;
      if (np < NBP) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pr = 16 * pb + gq + 8 * half, n = 16 * np + 8 * e + 2 * quad;
            const float2 v = hin[i][e][half];
            __stcg(reinterpret_cast<float2*>(hf + pr * N + n),
                   make_float2(v.x * decay + st[i][e][2 * half], v.y * decay + st[i][e][2 * half + 1]));
            *reinterpret_cast<__nv_bfloat162*>(hs + tile_off<N>(PT, pr, n & ~7) + (n & 7)) =
                __floats2bfloat162_rn(v.x, v.y);
          }
      }
    }
    fence_proxy_async_smem();   // h_in's shared-memory writes, for wgmma
    __syncthreads();
    // the barrier orders every thread's h_out before thread 0's release
    if (tid == 0) st_release(flag, c + 1 == p.nc ? 0 : c + 1);

    // y = exp(cum_i) C_i . h_in first (wgmma, both operands in shared
    // memory), the fragments of M computed meanwhile
    float y[PT / 2];
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) y[i] = 0.f;
    fence_regs(y);
    wgmma_fence();
    if (c > 0) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<PT>(y, desc_k_major<N>(c_wg, Q, kk), desc_k_major<N>(hs, PT, kk), kk > 0);
    }
    wgmma_commit();

    // M in bf16 as the A fragments of the k-steps: for k-step kk the
    // accumulator's registers 8kk .. 8kk + 7
    const float ci0 = cm[r0], ci1 = cm[r1];
    uint32_t ma[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk >= ksteps) continue;   // the lower warpgroup's columns past its rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kk + 8 * half + 2 * quad;
        const float cj0 = cm[j], cj1 = cm[j + 1], d0 = dk[j], d1 = dk[j + 1];
        const float* sv = s + 8 * kk + 4 * half;
        const float m0 = j <= r0 ? sv[0] * exp2_approx(fminf(ci0 - cj0, 0.f)) * d0 : 0.f;
        const float m1 = j + 1 <= r0 ? sv[1] * exp2_approx(fminf(ci0 - cj1, 0.f)) * d1 : 0.f;
        const float m2 = j <= r1 ? sv[2] * exp2_approx(fminf(ci1 - cj0, 0.f)) * d0 : 0.f;
        const float m3 = j + 1 <= r1 ? sv[3] * exp2_approx(fminf(ci1 - cj1, 0.f)) * d1 : 0.f;
        ma[kk][2 * half] = pack_bf16(m0, m1);
        ma[kk][2 * half + 1] = pack_bf16(m2, m3);
      }
    }
    wgmma_wait<0>();
    fence_regs(y);
    const float e0 = exp2_approx(ci0), e1 = exp2_approx(ci1);
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) y[i] *= (i & 2) ? e1 : e0;

    // then y += M.x, x read MN-major
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      if (kk < ksteps) wgmma_rs<PT>(y, ma[kk], desc_mn_major<PT>(xt, Q, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    // y, in bf16, into x's buffer (its products are done: a barrier first,
    // for the other warpgroup's), then one TMA store; rows past S are not
    // written
    __nv_bfloat16* ys = xs + buf * L::kX;
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
#pragma unroll
      for (int jj = 0; jj < PT / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(ys + tile_off<PT>(Q, r, 8 * jj) + 2 * quad) =
            __floats2bfloat162_rn(y[4 * jj + 2 * half], y[4 * jj + 2 * half + 1]);
    }
    fence_proxy_async_smem();
    __syncthreads();   // y staged; h_in is free again
    if (tid == 0) {
#pragma unroll 1
      for (int cb = 0; cb < PT / WP; ++cb)
        store_box(&ymap, ys + cb * Q * WP, p.y_pos, p0 + WP * cb, row0, h, b);
      bulk_commit();
      if (k + 2 < p.heads) {
        bulk_wait_read();   // the store has read the buffer the load refills
        load_x(k + 2);
      }
    }
  }
  if (tid == 0) bulk_wait();

  // the last block to finish makes the ticket ready for the next launch
  if (tid == 0 && atomicAdd(p.sync + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    p.sync[0] = 0;
    p.sync[1] = 0;
  }
}

struct Args {
  const void *x, *dt, *a, *b, *c;
  void *y, *h_final;
  int *sync;
  int B, S, H, P, G, heads;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

template <int N, int PT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  Params p{static_cast<const __nv_bfloat16*>(a.dt), static_cast<const __nv_bfloat16*>(a.a),
           static_cast<__nv_bfloat16*>(a.y), static_cast<float*>(a.h_final), a.sync,
           a.B, a.S, a.H, a.P, a.G, a.heads, (a.S + Q - 1) / Q, a.P / PT,
           a.dt_sb, a.dt_ss, a.dt_sh, {}, {}, {}, {}};
  CUtensorMap xm, bm, cm, ym;
  cudaError_t err;
  const long long y_ss = static_cast<long long>(a.H) * a.P;
  using hopper::make_map;
  using hopper::Tile;
  if ((err = hopper::begin("ssd_scan_tc_kernel")) ||
      (err = make_map(&xm, "x", a.x, a.P, {a.S, a.H, a.B}, {a.x_ss, a.x_sh, a.x_sb},
                      Tile<PT>::kBoxCols, Q, p.x_pos)) ||
      (err = make_map(&bm, "B", a.b, N, {a.S, a.G, a.B}, {a.b_ss, a.b_sg, a.b_sb},
                      Tile<N>::kBoxCols, Q, p.b_pos)) ||
      (err = make_map(&cm, "C", a.c, N, {a.S, a.G, a.B}, {a.c_ss, a.c_sg, a.c_sb},
                      Tile<N>::kBoxCols, Q, p.c_pos)) ||
      (err = make_map(&ym, "y", a.y, a.P, {a.S, a.H, a.B}, {y_ss, a.P, a.S * y_ss},
                      Tile<PT>::kBoxCols, Q, p.y_pos)))
    return err;
  constexpr int smem = Smem<N, PT>::kBytes;
  static const cudaError_t opted = hopper::opt_in(ssd_scan_tc_kernel<N, PT>, smem);
  const int grid = p.nc * a.B * (a.H / a.heads) * p.ptiles;
  return hopper::launch("ssd_scan_tc_kernel", ssd_scan_tc_kernel<N, PT>, opted, grid, kThreads,
                        smem, stream, xm, bm, cm, ym, p);
}

template <int N>
cudaError_t launch_for_p(const Args& a, cudaStream_t stream) {
  if (a.P % 64 == 0) return launch<N, 64>(a, stream);
  return launch<N, 32>(a, stream);
}

cudaError_t ssd_scan(const Args& a, int N, cudaStream_t stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.G <= 0 || a.H % a.G != 0 || a.P <= 0 ||
      a.P % 32 != 0 || a.heads < 1 || a.heads > kMaxHeads || (a.H / a.G) % a.heads != 0)
    return cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_for_p<16>(a, stream);
    case 32: return launch_for_p<32>(a, stream);
    case 64: return launch_for_p<64>(a, stream);
    case 128: return launch_for_p<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

#define SSD_ARGS                                                                           \
  const void *x, const void *dt, const void *a, const void *b, const void *c, void *y,     \
      void *h_final, int B, int S, int H, int P, int G, int N, long long x_sb,             \
      long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,   \
      long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,      \
      long long c_sg, void *stream

extern "C" int repro_ssd_scan_f32(SSD_ARGS) {
  return ssd_scan<float>(x, dt, a, b, c, y, h_final, B, S, H, P, G, N, x_sb, x_ss, x_sh,
                         dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, stream);
}
// bf16 also takes `sync` (2 + B*H*(P/PT) ints, PT = 64 if 64 divides P else
// 32; zero between launches, and left so by the kernel) and the heads a
// block takes (1..8, dividing H/G)
extern "C" int repro_ssd_scan_bf16(SSD_ARGS, void *sync, int heads) {
  const tc::Args args{x, dt, a, b, c, y, h_final, static_cast<int *>(sync), B, S, H, P, G,
                      heads, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb,
                      c_ss, c_sg};
  return tc::ssd_scan(args, N, static_cast<cudaStream_t>(stream));
}
