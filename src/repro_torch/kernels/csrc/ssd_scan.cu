// Mamba2 SSD chunked scan for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (wrapper `ssd_scan_pallas`) and computes what it computes, plus the final
// state: for head h of batch row b, with group g = h / (H / G),
//   dA_s = dt_s * a_h,   cum_i = sum_{s <= i} dA_s over the tile,
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra-tile)
//        + exp(cum_i) C_i . h_in                                   (incoming state)
//   h   <- h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j,
// carried over the sequence; y (B, S, H, P) in the input type and the f32
// final state h_final (B, H, P, N). Inputs x (B, S, H, P), dt (B, S, H),
// B and C (B, S, G, N) may be strided views (the splits of the model's xBC)
// as long as their last dim is contiguous; a (H,) is contiguous.
//
// Design. The TPU kernel's grid runs the chunks of one (batch, head) in
// order and keeps h in VMEM scratch. Here one block owns one (batch, head,
// tile of PT columns of P) and walks the sequence itself in tiles of 64 rows,
// with its (N x PT) f32 slice of the state in shared memory: the recurrence is
// independent per column of P, so the P tiles need nothing from each other.
// The SSD is exact under any chunking, so a 64-row tile gives the TPU
// kernel's result up to rounding whatever the config's chunk: it keeps the
// 64 x 64 decay matrix at 16 KB where the config's 256 x 256 would not fit a
// block's shared memory. Per tile: a warp scan gives cum in f32; the masked
// matrix M = (C B^T) o exp(cum_i - cum_j) dt_j is formed only for j <= i (exp
// is never taken above the diagonal, where its argument is positive and the
// TPU kernel's exp-then-mask can give inf * 0); then y = M x + exp(cum) C h_in,
// then the state update. All four products run as f32 FMAs on 4 x 4 register
// tiles from shared memory, operands laid out k-major so that each step is
// two 16-byte loads. Rows past S load dt = 0 and x = B = C = 0: they neither
// decay nor feed the state, and their y is not written, so any S is exact.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at mamba2-370m's
// prefill (B 4, S 1024, H 32, P 64, N 128, bf16) the bytes (x, dt, B, C read
// once, y and h_final written once: 40 MB) take 12.0 us and the operations of
// the chunked form at the config's chunk 256, counting only the causal half
// (j <= i) of its two chunk-square products, take 10.9 us. This first version
// uses f32 FMAs (no tensor cores) and one block per (batch, head, P tile),
// 128 blocks there for 132 SMs: it is right and simple; wgmma on the three
// matrix products and a split of the sequence across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;          // rows per tile of the sequence
constexpr int kThreads = 256;
constexpr int kLS = kL + 4;     // row stride (floats) of the L-wide arrays

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  // above 48 KB a block needs dynamic shared memory, opted into once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.H, p.P / PT);
  ssd_scan_kernel<T, N, PT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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

}  // namespace

#define SSD_ARGS                                                                           \
  const void *x, const void *dt, const void *a, const void *b, const void *c, void *y,     \
      void *h_final, int B, int S, int H, int P, int G, int N, long long x_sb,             \
      long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,   \
      long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,      \
      long long c_sg, void *stream
#define SSD_CALL                                                                           \
  x, dt, a, b, c, y, h_final, B, S, H, P, G, N, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,     \
      b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, stream

extern "C" int repro_ssd_scan_f32(SSD_ARGS) { return ssd_scan<float>(SSD_CALL); }
extern "C" int repro_ssd_scan_bf16(SSD_ARGS) { return ssd_scan<__nv_bfloat16>(SSD_CALL); }
