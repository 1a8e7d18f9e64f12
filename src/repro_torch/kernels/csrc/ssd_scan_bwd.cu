// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), f32 and bf16
// inputs, f32 arithmetic.
//
// The TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py) has no
// backward: JAX differentiates `ssd_chunked` with XLA. The port's forward
// runs on csrc/ssd_scan.cu, so its gradient is a kernel too. For head h of
// batch row b (group g = h / (H / G)) and a tile of L rows with
// cum_i = sum_{s <= i} dt_s a, the forward is
//   y_i   = sum_{j <= i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j + e^{cum_i} h_in C_i
//   h_out = e^{cum_Q} h_in + sum_j e^{cum_Q - cum_j} dt_j x_j B_j^T      (Q = the last row)
// and given dy and g = dL/dh_out (dh_final after the last tile) the tile's
// gradients are its transposes:
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j g B_j,   M_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j,
//                                                 w_j = e^{cum_Q - cum_j} dt_j
//   dC_i  = sum_{j <= i} W_ij B_j + e^{cum_i} h_in^T dy_i,   W_ij = (dy_i . x_j) e^{cum_i - cum_j} dt_j
//   dB_j  = sum_{i >= j} W_ij C_i + w_j g^T x_j
//   g    <- e^{cum_Q} g + sum_i e^{cum_i} dy_i C_i^T                    (for the tile before)
// and dcum_k, from T'_ij = (C_i . B_j) e^{cum_i - cum_j} (dy_i . x_j) (j <= i) and
// u_j = x_j^T g B_j:
//   dcum_k = sum_j T'_kj dt_j - dt_k sum_i T'_ik + e^{cum_k} C_k . (h_in^T dy_k) - w_k u_k
//            + [k = Q] (e^{cum_Q} <g, h_in> + sum_j w_j u_j)
//   ddt_k  = sum_i T'_ik + e^{cum_Q - cum_k} u_k + a ddA_k,   ddA_k = sum_{m >= k} dcum_m,
//   da     = sum_k dt_k ddA_k over every row.
// Every exponent is of an argument <= 0 (cum falls along a tile): no
// e^{-cum} is formed. kernels/ssd_scan.py `ssd_scan_bwd_plain` is the same
// arithmetic in PyTorch.
//
// One block per (batch, head, tile of PT columns of P), 256 threads, as the
// f32 forward kernel: every term above is independent per column p of x,
// dy and the states, except the contractions over p (dy_i . x_j, h_in^T dy,
// u, <g, h_in>), which enter dB, dC, ddt and da linearly. So each block
// writes its dx slice alone and adds its share of dB and dC (summed also
// over the H / G heads of a group), of ddt (over the P tiles) and of da
// (over B and S) into f32 buffers with atomics: those four sums are not
// deterministic in order (f32, relative ~1e-7 per add); dx is.
//   1. forward pass over the tiles, recomputing each tile's incoming state
//      h_in (PT x N f32, in registers) and storing it to `hbuf` (B, H, T, P,
//      N; T = ceil(S / L)): 67 MB at mamba2-370m's train microbatch (B 4,
//      S 1024, H 32, P 64, N 128), written and read by the same block. The
//      forward kernel keeps no per-chunk state, and h cannot be walked
//      backward from h_final (that would need e^{-cum}).
//   2. reverse pass over the tiles with g (PT x N f32) in shared memory: per
//      tile the L x L matrices C.B^T and dy.x^T, then dx, dC, dB, the new g
//      and the scalar chain dcum -> ddA (a serial suffix sum) -> ddt, da.
// All products are f32 FMAs on register tiles from shared memory: thread
// (ty, tx) of 16 x 16 owns rows ty + 16 r and columns tx + 16 s of each
// product, every array is stored once with an odd row stride, so that both
// orientations read without bank conflicts. ~218 KB of shared memory at
// N = 128, PT = 64: one block an SM.
//
// Bound on the card (H100 SXM): at mamba2-370m's train microbatch, bf16,
// the bytes (x, dt, B, C, dy read once, dx, ddt, da, dB, dC written once:
// 72 MB) take 0.021 ms at 3.35 TB/s, the operations of the chunked
// backward at Q = 128 (19.4 GFLOP) 0.020 ms at 989 TFLOP/s (chip_smoke.py
// reckons both). This first kernel runs on FMAs, not tensor cores, one
// block an SM walking its (b, h)'s sequence in order, and sits far above
// that bound: making it fast (chunks in parallel, wgmma, as the forward's
// `tc`) is later work; PERF.md keeps its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // rows per tile of the sequence
constexpr int kThreads = 256;   // 16 x 16: (ty, tx)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct BwdParams {
  const void* x;
  const void* dt;
  const void* a;
  const void* b;
  const void* c;
  const void* dy;
  const float* dh_final;   // (B, H, P, N) contiguous, or null: zero
  void* dx;                // (B, S, H, P) contiguous, x's type
  float* ddt;              // (B, S, H), zeroed
  float* da;               // (H,), zeroed
  float* db;               // (B, S, G, N), zeroed
  float* dc;               // (B, S, G, N), zeroed
  float* hbuf;             // (B, H, T, P, N) scratch
  int B, S, H, P, G;
  long long x_sb, x_ss, x_sh;  // strides in elements; the last dim is contiguous
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
};

// acc[r][s] += sum_k fa(ty + 16 r, k) * fb(k, tx + 16 s)
template <int RM, int RN, int K, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], FA fa, FB fb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = fa(ty + 16 * r, k);
#pragma unroll
    for (int s = 0; s < RN; ++s) bv[s] = fb(k, tx + 16 * s);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int s = 0; s < RN; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int s = 0; s < RN; ++s) acc[r][s] = 0.f;
}

// the sum over the 16 threads of one ty (one half of a warp)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N, int PT>
constexpr int smem_floats() {
  return 2 * kL * (PT + 1) + 2 * kL * (N + 1) + 2 * PT * (N + 1) + 3 * kL * (kL + 1) +
         9 * kL + 32;
}

template <typename T, int N, int PT>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_bwd_kernel(const BwdParams p) {
  constexpr int SL = kL + 1, SP = PT + 1, SN = N + 1;   // odd row strides
  constexpr int RL = kL / 16, RP = PT / 16, RN = N / 16;
  static_assert(N % 16 == 0 && PT % 16 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // L x SP: x[j][p]
  float* dys = xs + kL * SP;     // L x SP: dy[i][p]
  float* bs = dys + kL * SP;     // L x SN: B[j][n]
  float* cs = bs + kL * SN;      // L x SN: C[i][n]
  float* hs = cs + kL * SN;      // PT x SN: h_in[p][n]
  float* gs = hs + PT * SN;      // PT x SN: g[p][n]
  float* ms = gs + PT * SN;      // L x SL: M[i][j]
  float* ws = ms + kL * SL;      // L x SL: W[i][j]
  float* ts = ws + kL * SL;      // L x SL: T'[i][j]
  float* dts = ts + kL * SL;     // L: dt
  float* cum = dts + kL;         // L: inclusive cumsum of dt * a in the tile
  float* ecum = cum + kL;        // L: e^{cum}
  float* wq = ecum + kL;         // L: e^{cum_Q - cum}
  float* us = wq + kL;           // L: u
  float* crow = us + kL;         // L: e^{cum_i} C_i . (h_in^T dy_i)
  float* dcum = crow + kL;       // L
  float* ddir = dcum + kL;       // L: the direct part of ddt
  float* dda = ddir + kL;        // L: ddA
  float* red = dda + kL;         // 32: a block reduction's warp sums

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.y * PT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles = (p.S + kL - 1) / kL;
  const float a = to_f32(static_cast<const T*>(p.a)[h]);
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh + p0;
  const T* dtg = static_cast<const T*>(p.dt) + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb + g * p.c_sg;
  const long long gn = static_cast<long long>(p.G) * N;   // row stride of db, dc
  float* dbg = p.db + static_cast<long long>(b) * p.S * gn + g * N;
  float* dcg = p.dc + static_cast<long long>(b) * p.S * gn + g * N;
  T* dxg = static_cast<T*>(p.dx) + (static_cast<long long>(b) * p.S * p.H + h) * p.P + p0;
  const long long dx_ss = static_cast<long long>(p.H) * p.P;
  float* hb = p.hbuf + static_cast<long long>(bh) * tiles * p.P * N;

  // the tile's rows [c0, c0 + rows): dt (0 past S), its cumsum and exponentials
  auto load_dt_and_scan = [&](int c0, int rows) {
    if (tid < kL) dts[tid] = tid < rows ? to_f32(dtg[(c0 + tid) * p.dt_ss]) : 0.f;
    __syncthreads();
    if (tid < 32) {   // one warp: inclusive scan of dA over the 64 rows
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
      ecum[tid] = expf(v0);
      ecum[tid + 32] = expf(v1);
      wq[tid] = expf(total - v0);   // <= 1: cum falls along the tile
      wq[tid + 32] = expf(total - v1);
    }
  };
  // rows [c0, c0 + rows) of a (S, cols) slice with row stride `ss` into
  // dst (L x stride), zero past `rows`
  auto load_rows = [&](float* dst, int stride, const T* src, long long ss, int cols, int c0,
                       int rows) {
    for (int i = tid; i < kL * cols; i += kThreads) {
      const int j = i / cols, q = i % cols;
      dst[j * stride + q] = j < rows ? to_f32(src[(c0 + j) * ss + q]) : 0.f;
    }
  };

  // ---- 1. forward over the tiles: each tile's incoming state to hbuf ----
  {
    float hreg[RP][RN];
    zero(hreg);
    for (int t = 0; t < tiles; ++t) {
      const int c0 = t * kL, rows = min(kL, p.S - c0);
      __syncthreads();   // the previous tile's reads are done
      float* ht = hb + static_cast<long long>(t) * p.P * N;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int s = 0; s < RN; ++s) ht[(p0 + ty + 16 * r) * N + tx + 16 * s] = hreg[r][s];
      if (t == tiles - 1) break;
      load_rows(xs, SP, xg, p.x_ss, PT, c0, rows);
      load_rows(bs, SN, bg, p.b_ss, N, c0, rows);
      load_dt_and_scan(c0, rows);
      __syncthreads();
      for (int i = tid; i < kL * PT; i += kThreads) {   // x_j * w_j
        const int j = i / PT, q = i % PT;
        xs[j * SP + q] *= wq[j] * dts[j];
      }
      __syncthreads();
      float st[RP][RN];
      zero(st);
      mm<RP, RN, kL>(st, [&](int q, int j) { return xs[j * SP + q]; },
                     [&](int j, int n) { return bs[j * SN + n]; });
      const float decay = expf(cum[kL - 1]);
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int s = 0; s < RN; ++s) hreg[r][s] = hreg[r][s] * decay + st[r][s];
    }
  }

  // ---- 2. backward over the tiles, g carried in shared memory ----
  for (int i = tid; i < PT * N; i += kThreads) {
    const int q = i / N, n = i % N;
    gs[q * SN + n] =
        p.dh_final ? p.dh_final[(static_cast<long long>(bh) * p.P + p0 + q) * N + n] : 0.f;
  }
  float da_acc = 0.f;   // thread 0's share of da
  for (int t = tiles - 1; t >= 0; --t) {
    const int c0 = t * kL, rows = min(kL, p.S - c0);
    __syncthreads();   // the previous tile's reads are done
    load_rows(xs, SP, xg, p.x_ss, PT, c0, rows);
    load_rows(dys, SP, dyg, p.dy_ss, PT, c0, rows);
    load_rows(bs, SN, bg, p.b_ss, N, c0, rows);
    load_rows(cs, SN, cg, p.c_ss, N, c0, rows);
    const float* ht = hb + static_cast<long long>(t) * p.P * N;
    for (int i = tid; i < PT * N; i += kThreads) {
      const int q = i / N, n = i % N;
      hs[q * SN + n] = ht[(p0 + q) * N + n];
    }
    load_dt_and_scan(c0, rows);
    __syncthreads();

    // (i, j): C.B^T and dy.x^T, then M, W and T' below the diagonal
    {
      float cb[RL][RL], dx_[RL][RL];
      zero(cb);
      zero(dx_);
      mm<RL, RL, N>(cb, [&](int i, int n) { return cs[i * SN + n]; },
                    [&](int n, int j) { return bs[j * SN + n]; });
      mm<RL, RL, PT>(dx_, [&](int i, int q) { return dys[i * SP + q]; },
                     [&](int q, int j) { return xs[j * SP + q]; });
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int s = 0; s < RL; ++s) {
          const int i = ty + 16 * r, j = tx + 16 * s;
          const bool low = j <= i;
          const float l = low ? expf(cum[i] - cum[j]) : 0.f;
          ms[i * SL + j] = cb[r][s] * l * dts[j];
          ws[i * SL + j] = dx_[r][s] * l * dts[j];
          ts[i * SL + j] = cb[r][s] * l * dx_[r][s];
        }
    }
    __syncthreads();

    // (j, p): dx = M^T dy + w_j g B_j, and u_j = x_j . (g B_j)
    {
      float acc[RL][RP], bgv[RL][RP];
      zero(acc);
      zero(bgv);
      mm<RL, RP, kL>(acc, [&](int j, int i) { return ms[i * SL + j]; },
                     [&](int i, int q) { return dys[i * SP + q]; });
      mm<RL, RP, N>(bgv, [&](int j, int n) { return bs[j * SN + n]; },
                    [&](int n, int q) { return gs[q * SN + n]; });
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int j = ty + 16 * r;
        const float wj = wq[j] * dts[j];
        float u = 0.f;
#pragma unroll
        for (int s = 0; s < RP; ++s) {
          const int q = tx + 16 * s;
          u = fmaf(xs[j * SP + q], bgv[r][s], u);
          if (j < rows) dxg[(c0 + j) * dx_ss + q] = from_f32<T>(acc[r][s] + wj * bgv[r][s]);
        }
        u = row_sum16(u);
        if (tx == 0) us[j] = u;
      }
    }
    // (i, n): dC = W B + e^{cum_i} h_in^T dy_i, and its dcum term
    {
      float acc[RL][RN], dyh[RL][RN];
      zero(acc);
      zero(dyh);
      mm<RL, RN, kL>(acc, [&](int i, int j) { return ws[i * SL + j]; },
                     [&](int j, int n) { return bs[j * SN + n]; });
      mm<RL, RN, PT>(dyh, [&](int i, int q) { return dys[i * SP + q]; },
                     [&](int q, int n) { return hs[q * SN + n]; });
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int i = ty + 16 * r;
        float cr = 0.f;
#pragma unroll
        for (int s = 0; s < RN; ++s) {
          const int n = tx + 16 * s;
          const float off = ecum[i] * dyh[r][s];
          cr = fmaf(cs[i * SN + n], off, cr);
          if (i < rows) atomicAdd(dcg + (c0 + i) * gn + n, acc[r][s] + off);
        }
        cr = row_sum16(cr);
        if (tx == 0) crow[i] = cr;
      }
    }
    // (j, n): dB = W^T C + w_j g^T x_j
    {
      float acc[RL][RN], xg_[RL][RN];
      zero(acc);
      zero(xg_);
      mm<RL, RN, kL>(acc, [&](int j, int i) { return ws[i * SL + j]; },
                     [&](int i, int n) { return cs[i * SN + n]; });
      mm<RL, RN, PT>(xg_, [&](int j, int q) { return xs[j * SP + q]; },
                     [&](int q, int n) { return gs[q * SN + n]; });
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int j = ty + 16 * r;
        const float wj = wq[j] * dts[j];
        if (j < rows)
#pragma unroll
          for (int s = 0; s < RN; ++s)
            atomicAdd(dbg + (c0 + j) * gn + tx + 16 * s, acc[r][s] + wj * xg_[r][s]);
      }
    }
    __syncthreads();   // g is read above and replaced below

    // (p, n): <g, h_in>, then g <- e^{cum_Q} g + sum_i e^{cum_i} dy_i C_i^T
    {
      float acc[RP][RN];
      zero(acc);
      mm<RP, RN, kL>(acc, [&](int q, int i) { return dys[i * SP + q] * ecum[i]; },
                     [&](int i, int n) { return cs[i * SN + n]; });
      const float decay = expf(cum[kL - 1]);
      float gh = 0.f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int s = 0; s < RN; ++s) {
          float& gv = gs[(ty + 16 * r) * SN + tx + 16 * s];
          gh = fmaf(gv, hs[(ty + 16 * r) * SN + tx + 16 * s], gh);
          gv = gv * decay + acc[r][s];
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, off);
      if (tid % 32 == 0) red[tid / 32] = gh;
    }
    // the rows' and columns' sums of T'
    if (tid < kL) {
      const int k = tid;
      float row = 0.f, col = 0.f;
      for (int m = 0; m < kL; ++m) {
        row = fmaf(ts[k * SL + m], dts[m], row);
        col += ts[m * SL + k];
      }
      const float wk = wq[k] * dts[k];
      dcum[k] = row - dts[k] * col + crow[k] - wk * us[k];
      ddir[k] = col + wq[k] * us[k];
    }
    __syncthreads();
    if (tid == 0) {   // the tile's last row, then ddA by a serial suffix sum
      float gh = 0.f, wu = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) gh += red[w];
      for (int j = 0; j < kL; ++j) wu = fmaf(wq[j] * dts[j], us[j], wu);
      float run = expf(cum[kL - 1]) * gh + wu;
      for (int k = kL - 1; k >= 0; --k) {
        run += dcum[k];
        dda[k] = run;
        da_acc = fmaf(dts[k], run, da_acc);
      }
    }
    __syncthreads();
    if (tid < rows)
      atomicAdd(p.ddt + (static_cast<long long>(b) * p.S + c0 + tid) * p.H + h,
                ddir[tid] + a * dda[tid]);
  }
  if (tid == 0) atomicAdd(p.da + h, da_acc);
}

template <typename T, int N, int PT>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<N, PT>() * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_bwd_kernel<T, N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.H, p.P / PT);
  ssd_scan_bwd_kernel<T, N, PT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_for_p(const BwdParams& p, cudaStream_t stream) {
  return p.P % 64 == 0 ? launch<T, N, 64>(p, stream) : launch<T, N, 32>(p, stream);
}

template <typename T>
cudaError_t ssd_scan_bwd(const BwdParams& p, int N, cudaStream_t stream) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0 || p.G <= 0 || p.H % p.G != 0 || p.P % 32 != 0 ||
      static_cast<long long>(p.B) * p.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_for_p<T, 16>(p, stream);
    case 32: return launch_for_p<T, 32>(p, stream);
    case 64: return launch_for_p<T, 64>(p, stream);
    case 128: return launch_for_p<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define SSD_BWD_ARGS                                                                       \
  const void *x, const void *dt, const void *a, const void *b, const void *c,              \
      const void *dy, const void *dh_final, void *dx, void *ddt, void *da, void *db,       \
      void *dc, void *hbuf, int B, int S, int H, int P, int G, int N, long long x_sb,      \
      long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,   \
      long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,      \
      long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh, void *stream

#define SSD_BWD_PARAMS                                                                     \
  BwdParams {                                                                              \
    x, dt, a, b, c, dy, static_cast<const float *>(dh_final), dx,                          \
        static_cast<float *>(ddt), static_cast<float *>(da), static_cast<float *>(db),     \
        static_cast<float *>(dc), static_cast<float *>(hbuf), B, S, H, P, G, x_sb, x_ss,   \
        x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, dy_sb, dy_ss, dy_sh \
  }

// dh_final may be null (a zero gradient of the final state); ddt, da, db
// and dc must be zeroed f32 buffers; hbuf holds B*H*ceil(S/64)*P*N floats
extern "C" int repro_ssd_scan_bwd_f32(SSD_BWD_ARGS) {
  return ssd_scan_bwd<float>(SSD_BWD_PARAMS, N, static_cast<cudaStream_t>(stream));
}
extern "C" int repro_ssd_scan_bwd_bf16(SSD_BWD_ARGS) {
  return ssd_scan_bwd<__nv_bfloat16>(SSD_BWD_PARAMS, N, static_cast<cudaStream_t>(stream));
}
