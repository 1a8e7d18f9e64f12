// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a): bf16 on
// tensor cores (`tc`), f32 on FMAs (`fma`).
//
// The TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py) has no
// backward: JAX differentiates `ssd_chunked` with XLA. The port's forward
// runs on csrc/ssd_scan.cu, so its gradient is a kernel too. For head h of
// batch row b (group g = h / (H / G)) and a chunk of rows with
// cum_i = sum_{s <= i} dt_s a, the forward is
//   y_i   = sum_{j <= i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j + e^{cum_i} h_in C_i
//   h_out = e^{cum_Q} h_in + sum_j e^{cum_Q - cum_j} dt_j x_j B_j^T      (Q = the last row)
// and given dy and g = dL/dh_out (dh_final after the last chunk) the
// chunk's gradients are its transposes:
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j g B_j,   M_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j,
//                                                 w_j = e^{cum_Q - cum_j} dt_j
//   dC_i  = sum_{j <= i} W_ij B_j + e^{cum_i} h_in^T dy_i,   W_ij = (dy_i . x_j) e^{cum_i - cum_j} dt_j
//   dB_j  = sum_{i >= j} W_ij C_i + w_j g^T x_j
//   g    <- e^{cum_Q} g + sum_i e^{cum_i} dy_i C_i^T                    (for the chunk before)
// and dcum_k, from T'_ij = (C_i . B_j) e^{cum_i - cum_j} (dy_i . x_j) (j <= i) and
// u_j = x_j^T g B_j:
//   dcum_k = sum_j T'_kj dt_j - dt_k sum_i T'_ik + e^{cum_k} C_k . (h_in^T dy_k) - w_k u_k
//            + [k = Q] (e^{cum_Q} <g, h_in> + sum_j w_j u_j)
//   ddt_k  = sum_i T'_ik + e^{cum_Q - cum_k} u_k + a ddA_k,   ddA_k = sum_{m >= k} dcum_m,
//   da     = sum_k dt_k ddA_k over every row.
// Every exponent is of an argument <= 0 (cum falls along a chunk): no
// e^{-cum} is formed. kernels/ssd_scan.py `ssd_scan_bwd_plain` is the same
// arithmetic in PyTorch. Every term is independent per column p of x, dy
// and the states except the contractions over p (dy_i . x_j, h_in^T dy, u,
// <g, h_in>), which enter dB, dC, ddt and da linearly: a block that takes a
// tile of P's columns adds its share of those.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16; chip_smoke.py
// reckons both from the run's shapes): the bytes (x, dt, B, C, dy read
// once, dx, ddt, da, dB, dC written once) against the operations of the
// chunked backward at Q = 128. At mamba2-370m's train microbatch (B 4, S
// 1024, H 32, P 64, N 128) 72 MB, 0.021 ms, and 19.4 GFLOP, 0.020 ms; at
// zamba2-2.7b's (H 80, N 64) 0.051 ms of bytes. Either way a kernel has to
// run the chunks in parallel and its products on tensor cores.
//
// Two kernels, chosen by the wrapper (kernels/ssd_scan.py `_bwd_variant`)
// by dtype, never one in place of another that failed:
//
// 1. bf16 (`tc`, entry repro_ssd_scan_bwd_bf16): three launches.
//    a. `ssd_scan_bwd_tc_states_kernel`, one block per (chunk of Q = 128
//       rows, batch, head, 64- or 32-column tile of P), two an SM: the
//       chunk-local terms of the two recurrences, S_c = (w o x)^T B and
//       G_c = (e^{cum} o dy)^T C, on mma.sync from bf16 hi + lo splits of
//       w o x and e^{cum} o dy (the forward's state product), stored in
//       bf16 (B, H, nc, P, N): 16.8 MB each at mamba2.
//    b. `ssd_scan_bwd_tc_chain_kernel`: the only work in chunk order, per
//       (b, h) and 4 elements of (p, n) a thread: h_in[c + 1] = e^{cum_Q,c}
//       h_in[c] + S_c from 0 and g[c - 1] = e^{cum_Q,c} g[c] + G_c from
//       dh_final (or 0), carried in f32, each chunk's h_in and g stored in
//       bf16 (B, H, nc, P, N). No block waits on another, and no block
//       walks a sequence: the `fma` kernel's f32 `hbuf` (67 MB at mamba2),
//       written and read by one block, has no counterpart here.
//    c. `ssd_scan_bwd_tc_kernel`, one block per (chunk, batch, `heads` heads
//       of one group, P tile), the chunks in parallel: TMA loads C and B
//       once and per head x, dy, h_in and g (rows past S zero-filled; their
//       dt loads as 0, so they take no part). Two warpgroups of 64 rows.
//       Per head:
//       - by rows j, 64 columns i at a time: B.C^T and x.dy^T (wgmma),
//         then L_ji = e^{cum_i - cum_j} (i >= j) once for both and M' =
//         (C.B^T) o L, W = (x.dy^T) o L dt stored transposed (rows j) in
//         bf16 to shared memory, with what rounding took from W's diagonal
//         W_jj kept in f32; warpgroup 1 (j >= 64) forms only i >= 64;
//       - rows j: dB += W^T C, M'^T dy and B g^T (wgmma, M'^T and W^T as
//         K-major A), and the diagonal's residual r_j times C_j (dB) and B_j
//         (dC) in f32: where a row's dB or dC is that one term (the last
//         row of the sequence when g = 0, every row at S = 1) the heads'
//         W_jj can cancel, and bf16's rounding of each would be all of
//         what is left; then dx = dt o (M'^T dy) + w o (B g^T) staged in bf16
//         for one TMA store, and the sums Col_j = x_j . (M'^T dy)_j (the
//         column sums of T'), u_j = x_j . (B g^T)_j;
//       - x becomes dt o x in place (bf16); dB += (wq o (dt o x)) g (A from
//         registers); rows i: y = e^{cum} o (C h_in^T) + M' (dt o x) (M'
//         read transposed, an MN-major A), whose dy_i . y_i are the row sums
//         of T' dt and the incoming state's dcum term, and dC += (e^{cum} o
//         dy) h_in + W B (W read transposed);
//       - the scalar chain dcum -> ddA (a warp's suffix scan over the 128
//         rows) -> ddt by one atomic a row, da by one a head; dcum's
//         dt_j Col_j is taken from the same rounded dt o x as y's, since the
//         two cancel over the chunk.
//       dB and dC are summed over the block's heads in registers, then
//       staged in f32 and added by one bulk reduce (cp.reduce.async.bulk)
//       a row: H / heads adds a row of a group, not H.
//    256 threads and one block an SM (~221 KB of shared memory at N = 128).
//    What holds it above its bound (PERF.md): one block an SM with no
//    second buffer, so each head's loads wait at its start and each
//    product waits for the one before; the chunk states' kernel (a quarter
//    of the time) writes and the chains read the per-chunk states through
//    device memory.
// 2. f32 (`fma`, entry repro_ssd_scan_bwd_f32): the first port, kept for
//    f32 inputs. One block per (batch, head, tile of PT columns of P), 256
//    threads:
//   1. forward pass over the 64-row tiles, recomputing each tile's incoming
//      state h_in (PT x N f32, in registers) and storing it to `hbuf` (B, H,
//      T, P, N; T = ceil(S / 64)), written and read by the same block. The
//      forward kernel keeps no per-chunk state, and h cannot be walked
//      backward from h_final (that would need e^{-cum}).
//   2. reverse pass over the tiles with g (PT x N f32) in shared memory: per
//      tile the L x L matrices C.B^T and dy.x^T, then dx, dC, dB, the new g
//      and the scalar chain dcum -> ddA (a serial suffix sum) -> ddt, da.
//   All products are f32 FMAs on register tiles from shared memory: thread
//   (ty, tx) of 16 x 16 owns rows ty + 16 r and columns tx + 16 s of each
//   product, every array is stored once with an odd row stride, so that both
//   orientations read without bank conflicts. dB, dC, ddt and da are
//   summed with f32 atomics, in no fixed order; dx is written once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
  if (cudaError_t err = hopper::begin("ssd_scan_bwd_kernel")) return err;
  static const cudaError_t opted = hopper::opt_in(ssd_scan_bwd_kernel<T, N, PT>, bytes);
  const dim3 grid(p.B * p.H, p.P / PT);
  return hopper::launch("ssd_scan_bwd_kernel", ssd_scan_bwd_kernel<T, N, PT>, opted, grid,
                        kThreads, bytes, stream, p);
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


// ===========================================================================
// tc: bf16, chunks in parallel, the products on tensor cores
// ===========================================================================
namespace tc {

constexpr int Q = 128;             // rows a chunk: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kMaxHeads = 4;       // heads a block takes: one warp scans each
constexpr float kLog2e = 1.4426950408889634f;

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

constexpr uint64_t kWaitNs = 2000000000ull;   // 2 s: a launch takes well under 1 ms

// wait until the phase of parity `parity` of `bar` has completed; a load
// that never lands (a fault elsewhere) fails the launch after kWaitNs
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  uint64_t t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kWaitNs) __trap();
  }
}

// a bf16 pair times s, rounded to bf16
__device__ __forceinline__ uint32_t scaled(uint32_t v, float s) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return hopper::pack_bf16(__low2float(x) * s, __high2float(x) * s);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// the A fragments (rows r0, r1 of this warp's 16, k-steps over the PT
// columns) of a Q x PT tile, row r0's scaled by s0 and r1's by s1, in bf16:
// the lane's ldmatrix row is `row` (lanes 8m..8m+7: matrix m)
template <int PT>
__device__ __forceinline__ void row_frags(uint32_t (&af)[PT / 16][4], const __nv_bfloat16* tile,
                                          int row, int mi, float s0, float s1) {
#pragma unroll
  for (int kk = 0; kk < PT / 16; ++kk) {
    hopper::ldmatrix_x4_at(
        af[kk], hopper::smem_u32(tile + tile_off<PT>(Q, row, 16 * kk + (mi >> 1) * 8)));
    af[kk][0] = scaled(af[kk][0], s0);
    af[kk][1] = scaled(af[kk][1], s1);
    af[kk][2] = scaled(af[kk][2], s0);
    af[kk][3] = scaled(af[kk][3], s1);
  }
}

struct Params {
  const __nv_bfloat16* dt;
  const __nv_bfloat16* a;
  const float* dh_final;   // (B, H, P, N) contiguous, or null: zero
  float* ddt;              // (B, S, H), zeroed
  float* da;               // (H,), zeroed
  float* db;               // (B, S, G, N), zeroed
  float* dc;               // (B, S, G, N), zeroed
  __nv_bfloat16* st;       // (B, H, nc, P, N): the chunk states S_c
  __nv_bfloat16* gt;       // (B, H, nc, P, N): the chunk terms G_c
  float* last;             // (B, H, nc): log2(e) * cum at each chunk's end
  __nv_bfloat16* hb;       // (B, H, nc, P, N): h_in of each chunk
  __nv_bfloat16* gb;       // (B, H, nc, P, N): g, the gradient of its h_out
  int B, S, H, P, G, N, heads, nc, ptiles;
  long long dt_sb, dt_ss, dt_sh;
  // which tensor-map dim (1..3) holds the sequence, the head (group) and the batch
  int x_pos[3], dy_pos[3], b_pos[3], c_pos[3], dx_pos[3], s_pos[3];
};

// A block's unit: (chunk c, batch b, heads h0 .. h0 + heads - 1 of group g,
// P tile pt), neighbouring blocks on one (b, c) so that B and C stay in L2
struct Unit {
  int c, b, h0, g, pt;
  __device__ Unit(const Params& p) {
    int t = blockIdx.x;
    pt = t % p.ptiles;
    t /= p.ptiles;
    const int hblocks = p.H / p.heads;
    h0 = (t % hblocks) * p.heads;
    t /= hblocks;
    b = t % p.B;
    c = t / p.B;
    g = h0 / (p.H / p.G);
  }
};

// dt of the block's heads (0 past S), then warp k scans head k over the
// chunk (4 rows a lane): cum (log2-scaled), e^{cum} and e^{cum_last - cum},
// every exponent <= 0 (cum falls along the chunk)
__device__ __forceinline__ void scan_heads(const Params& p, const Unit& u, float* dts, float* cum,
                                           float* ecs, float* wqs, float* last) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < p.heads * Q; i += kThreads) {
    const int k = i % p.heads, j = i / p.heads, row = u.c * Q + j;
    dts[k * Q + j] = row < p.S ? __bfloat162float(p.dt[u.b * p.dt_sb + row * p.dt_ss +
                                                       (u.h0 + k) * p.dt_sh])
                               : 0.f;
  }
  __syncthreads();
  if (warp < p.heads) {
    const int k = warp;
    const float a = __bfloat162float(p.a[u.h0 + k]) * kLog2e;
    float v[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      run += dts[k * Q + 4 * lane + e] * a;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float base = incl - run, total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k * Q + 4 * lane + e;
      cum[j] = base + v[e];
      ecs[j] = hopper::exp2_approx(fminf(cum[j], 0.f));
      wqs[j] = hopper::exp2_approx(fminf(total - cum[j], 0.f));
    }
    if (lane == 0) last[k] = total;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. the chunk states: S_c = (w o x)^T B and G_c = (e^{cum} o dy)^T C
// ---------------------------------------------------------------------------
// One head a block (p.heads = 1), two blocks an SM. Shared memory: C and B
// (Q x N bf16), x and dy (Q x PT bf16), then dt, cum, e^{cum},
// e^{cum_last - cum} (Q floats each) and cum_last (2 floats, which keeps the
// mbarrier after it 8-byte aligned), one mbarrier.
template <int N, int PT>
struct StatesSmem {
  static constexpr int kBC = Q * N;
  static constexpr int kX = Q * PT;
  static constexpr int kBytes = 1024 + 2 * (2 * kBC + 2 * kX) + 4 * (4 * Q + 2) + 8 + 16;
};

template <int N, int PT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_bwd_tc_states_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const __grid_constant__ CUtensorMap dymap,
                                  const __grid_constant__ CUtensorMap bmap,
                                  const __grid_constant__ CUtensorMap cmap, const Params p) {
  using namespace hopper;
  using L = StatesSmem<N, PT>;
  constexpr int WN = Tile<N>::kBoxCols, WP = Tile<PT>::kBoxCols;
  // mma.sync tiles: 16 rows of P (PB blocks) x 16 columns of N (NBP pairs
  // of 8-column tiles); warp w takes P block w % PB and the column pairs
  // w / PB, + NG, ...
  constexpr int PB = PT / 16, NG = 8 / PB, NBP = N / 16, NPW = (NBP + NG - 1) / NG;
  static_assert(N % 16 == 0 && N <= 128 && (PT == 32 || PT == 64), "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = cs + L::kBC;
  __nv_bfloat16* xs = bs + L::kBC;
  __nv_bfloat16* dys = xs + L::kX;
  float* dts = reinterpret_cast<float*>(dys + L::kX);
  float* cum = dts + Q;
  float* ecs = cum + Q;
  float* wqs = ecs + Q;
  float* last = wqs + Q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(last + 2);   // 8-byte aligned

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Unit u(p);
  const int row0 = u.c * Q, p0 = u.pt * PT;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, 2 * (2 * L::kBC + 2 * L::kX));
#pragma unroll 1
    for (int cb = 0; cb < N / WN; ++cb) {
      load_box(cs + cb * Q * WN, &cmap, bar, p.c_pos, WN * cb, row0, u.g, u.b);
      load_box(bs + cb * Q * WN, &bmap, bar, p.b_pos, WN * cb, row0, u.g, u.b);
    }
#pragma unroll 1
    for (int cb = 0; cb < PT / WP; ++cb) {
      load_box(xs + cb * Q * WP, &xmap, bar, p.x_pos, p0 + WP * cb, row0, u.h0, u.b);
      load_box(dys + cb * Q * WP, &dymap, bar, p.dy_pos, p0 + WP * cb, row0, u.h0, u.b);
    }
  }
  scan_heads(p, u, dts, cum, ecs, wqs, last);
  mbar_wait_or_trap(bar, 0);

  const int quad = lane % 4, gq = lane / 4, mi = lane / 8, rr = lane % 8;
  const int pb = warp % PB, ng = warp / PB;
  // this lane's ldmatrix rows in x or dy (rows j, columns p of P block pb)
  // and in B or C (rows j, columns n of each column pair it takes); k-step
  // kk is 16 rows on, which keeps a row's place in the swizzle
  const int a_off = tile_off<PT>(Q, (mi >> 1) * 8 + rr, 16 * pb + (mi & 1) * 8);
  int b_off[NPW];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
    b_off[i] = tile_off<N>(Q, (mi & 1) * 8 + rr, 16 * (ng + NG * i) + (mi >> 1) * 8);

  // (w o x)^T B or (e^{cum} o dy)^T C, into out (B, H, nc, P, N) in bf16
  auto state = [&](const __nv_bfloat16* at, const float* wt, const __nv_bfloat16* bt,
                   __nv_bfloat16* out) {
    float acc[NPW][2][4];
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][e][r] = 0.f;
    const uint32_t xa = smem_u32(at + a_off);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t ax[4], hi[4], lo[4];
      ldmatrix_x4_trans_at(ax, xa + kk * 16 * WP * 2);
      const float2 w01 = *reinterpret_cast<const float2*>(wt + 16 * kk + 2 * quad);
      const float2 w89 = *reinterpret_cast<const float2*>(wt + 16 * kk + 8 + 2 * quad);
      split_scaled(ax[0], w01.x, w01.y, hi[0], lo[0]);
      split_scaled(ax[1], w01.x, w01.y, hi[1], lo[1]);
      split_scaled(ax[2], w89.x, w89.y, hi[2], lo[2]);
      split_scaled(ax[3], w89.x, w89.y, hi[3], lo[3]);
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        if (ng + NG * i < NBP) {
          uint32_t bf[4];
          ldmatrix_x4_trans_at(bf, smem_u32(bt + b_off[i]) + kk * 16 * WN * 2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_16816(acc[i][e], hi[0], hi[1], hi[2], hi[3], bf[2 * e], bf[2 * e + 1]);
            mma_16816(acc[i][e], lo[0], lo[1], lo[2], lo[3], bf[2 * e], bf[2 * e + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int np = ng + NG * i;
      if (np < NBP) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pr = 16 * pb + gq + 8 * half, n = 16 * np + 8 * e + 2 * quad;
            *reinterpret_cast<uint32_t*>(out + pr * N + n) =
                pack_bf16(acc[i][e][2 * half], acc[i][e][2 * half + 1]);
          }
      }
    }
  };

  const long long bhc = (static_cast<long long>(u.b) * p.H + u.h0) * p.nc + u.c;
  // w = e^{cum_last - cum} dt into dt's place (dt is not read again)
  if (tid < Q) dts[tid] *= wqs[tid];
  __syncthreads();
  state(xs, dts, bs, p.st + (bhc * p.P + p0) * N);
  state(dys, ecs, cs, p.gt + (bhc * p.P + p0) * N);
  if (tid == 0 && u.pt == 0) p.last[bhc] = last[0];
}

// ---------------------------------------------------------------------------
// 2. the two recurrences over the chunks, elementwise in (p, n):
//    h_in[0] = 0, h_in[c + 1] = e^{cum_last,c} h_in[c] + S_c;
//    g[nc - 1] = dh_final, g[c - 1] = e^{cum_last,c} g[c] + G_c;
//    carried in f32, stored in bf16 for the main kernel's products
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_tc_chain_kernel(const Params p) {
  const long long pn = static_cast<long long>(p.P) * p.N;
  const long long v = (static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x) * 4;
  if (v >= pn) return;
  const long long bh = blockIdx.x;
  const long long base = bh * p.nc * pn + v;
  const float* lastp = p.last + bh * p.nc;
  auto store = [&](__nv_bfloat16* dst, const float4& f) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(hopper::pack_bf16(f.x, f.y), hopper::pack_bf16(f.z, f.w));
  };
  auto load = [&](const __nv_bfloat16* src) {   // read once: streaming
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(src));
    const float2 lo = unpack(v.x), hi = unpack(v.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  };
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < p.nc; ++c) {
    const long long at = base + c * pn;
    store(p.hb + at, h);
    const float d = hopper::exp2_approx(fminf(lastp[c], 0.f));
    const float4 s = load(p.st + at);
    h = make_float4(fmaf(h.x, d, s.x), fmaf(h.y, d, s.y), fmaf(h.z, d, s.z), fmaf(h.w, d, s.w));
  }
  float4 g = p.dh_final ? *reinterpret_cast<const float4*>(p.dh_final + bh * pn + v)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long at = base + c * pn;
    store(p.gb + at, g);
    const float d = hopper::exp2_approx(fminf(lastp[c], 0.f));
    const float4 s = load(p.gt + at);
    g = make_float4(fmaf(g.x, d, s.x), fmaf(g.y, d, s.y), fmaf(g.z, d, s.z), fmaf(g.w, d, s.w));
  }
}

// ---------------------------------------------------------------------------
// 3. the gradients of each chunk, given its h_in and g
// ---------------------------------------------------------------------------
// Shared memory in bf16 elements: C and B (Q x N), W^T and M'^T (Q x Q,
// rows j, Tile<Q>), x, dy and the staged dx (Q x PT), h_in and g (PT x N);
// every TMA or wgmma tile's bytes are a multiple of 1024, so each starts
// aligned to the 128-byte swizzle's atom. Then per head dt, cum, e^{cum},
// e^{cum_last - cum} (Q floats each) and cum_last; two sets (one per parity
// of the head) of the scalar chain's inputs: dy.y, Col, dt Col, u (Q floats
// each) and <g, h_in>; the diagonal's residual W_jj - bf16(W_jj) (Q floats);
// five mbarriers. At the end C, B (2 Q N bf16) stage dB and
// W^T, M'^T (2 Q Q bf16, at least Q N floats) stage dC in f32.
template <int N, int PT>
struct MainSmem {
  static constexpr int kBC = Q * N;
  static constexpr int kQQ = Q * Q;
  static constexpr int kX = Q * PT;
  static constexpr int kH = PT * N;
  static constexpr int kSums = 4 * Q + 8;
  static constexpr int kFloats = 4 * kMaxHeads * Q + kMaxHeads + 2 * kSums + Q;
  static constexpr int kBytes =
      1024 + 2 * (2 * kBC + 2 * kQQ + 3 * kX + 2 * kH) + 4 * kFloats + 8 * 5 + 16;
  static_assert(2 * kQQ >= 2 * kBC, "W^T and M'^T stage dC");
};

template <int N, int PT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_bwd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap dymap,
                           const __grid_constant__ CUtensorMap bmap,
                           const __grid_constant__ CUtensorMap cmap,
                           const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const __grid_constant__ CUtensorMap dxmap, const Params p) {
  using namespace hopper;
  using L = MainSmem<N, PT>;
  constexpr int WN = Tile<N>::kBoxCols, WP = Tile<PT>::kBoxCols;
  static_assert(N % 16 == 0 && N <= 128 && (PT == 32 || PT == 64), "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(aligned_smem(smem_raw, true));
  __nv_bfloat16* bs = cs + L::kBC;
  __nv_bfloat16* wt = bs + L::kBC;           // W^T: rows j, columns i (Tile<Q>)
  __nv_bfloat16* mt = wt + L::kQQ;           // M'^T: rows j, columns i
  __nv_bfloat16* xs = mt + L::kQQ;
  __nv_bfloat16* dys = xs + L::kX;
  __nv_bfloat16* dxs = dys + L::kX;
  __nv_bfloat16* hs = dxs + L::kX;           // h_in: rows p, columns n (Tile<N>)
  __nv_bfloat16* gs = hs + L::kH;            // g: rows p, columns n
  float* dts = reinterpret_cast<float*>(gs + L::kH);
  float* cum = dts + kMaxHeads * Q;
  float* ecs = cum + kMaxHeads * Q;
  float* wqs = ecs + kMaxHeads * Q;
  float* last = wqs + kMaxHeads * Q;
  float* sums = last + kMaxHeads;            // two sets of L::kSums
  float* wres = sums + 2 * L::kSums;         // W_jj - bf16(W_jj) of the head
  uint64_t* bars = reinterpret_cast<uint64_t*>(wres + Q);   // B/C, x, dy, h, g

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Unit u(p);
  const int row0 = u.c * Q, p0 = u.pt * PT;
  auto load_rows = [&](int k, const CUtensorMap* map, const int (&pos)[3], __nv_bfloat16* dst,
                       uint64_t* bar) {   // x or dy of head h0 + k
    mbar_arrive_expect_tx(bar, 2 * L::kX);
#pragma unroll 1
    for (int cb = 0; cb < PT / WP; ++cb)
      load_box(dst + cb * Q * WP, map, bar, pos, p0 + WP * cb, row0, u.h0 + k, u.b);
  };
  // h_in or g of (b, h, c), P rows p0.. of the (B H, nc, P, N) scratch
  auto load_state = [&](int k, const CUtensorMap* map, __nv_bfloat16* dst, uint64_t* bar) {
    mbar_arrive_expect_tx(bar, 2 * L::kH);
#pragma unroll 1
    for (int cb = 0; cb < N / WN; ++cb)
      load_box(dst + cb * PT * WN, map, bar, p.s_pos, WN * cb, p0, u.c, u.b * p.H + u.h0 + k);
  };
  auto load_head = [&](int k) {
    load_rows(k, &xmap, p.x_pos, xs, &bars[1]);
    load_rows(k, &dymap, p.dy_pos, dys, &bars[2]);
    load_state(k, &hmap, hs, &bars[3]);
    load_state(k, &gmap, gs, &bars[4]);
  };
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bars[0], 2 * 2 * L::kBC);
#pragma unroll 1
    for (int cb = 0; cb < N / WN; ++cb) {
      load_box(cs + cb * Q * WN, &cmap, &bars[0], p.c_pos, WN * cb, row0, u.g, u.b);
      load_box(bs + cb * Q * WN, &bmap, &bars[0], p.b_pos, WN * cb, row0, u.g, u.b);
    }
    load_head(0);
  }
  for (int i = tid; i < 2 * L::kSums; i += kThreads) sums[i] = 0.f;
  scan_heads(p, u, dts, cum, ecs, wqs, last);

  // Two warpgroups of 64 rows. The (j, i) matrices C.B^T and x.dy^T are
  // formed by rows j (the input's time) in registers, M' = (C.B^T) o L and
  // W = (x.dy^T) o L dt from them stored to shared memory in bf16, which
  // every product then reads: as a K-major A by rows j (dx, dB) or
  // transposed, an MN-major A by rows i (dC, y). The accumulator layout:
  // this thread holds rows r0 and r0 + 8 (of the chunk), columns 8*jj +
  // 2*quad + {0, 1} (register 4*jj + {0, 1} row r0, 4*jj + {2, 3} row r1).
  // M' and W vanish for i < j, so warpgroup 0 (j < 64) forms every i and
  // warpgroup 1 (j >= 64) only i >= 64; a product by rows j reduces over
  // i from the warpgroup's first row (8 k-steps, or 4), one by rows i over
  // j <= i (4, or 8).
  const int wg = warp / 4, quad = lane % 4, mi = lane / 8;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const int ibase = wg * 64;                 // the strip's first column i
  const int kofs = wg ? 4 : 0;               // its first k-step over i
  const int jsteps = wg ? 8 : 4;             // k-steps over j <= i of rows i
  const __nv_bfloat16* b_wg = bs + wg * 64 * WN;   // this warpgroup's 64 rows of B
  const __nv_bfloat16* c_wg = cs + wg * 64 * WN;   // ... and of C
  const __nv_bfloat16* mt_j = mt + wg * 64 * 64;   // its rows j of M'^T (K-major A)
  const __nv_bfloat16* wt_j = wt + wg * 64 * 64;
  const __nv_bfloat16* mt_i = mt + wg * Q * 64;    // its columns i (MN-major A)
  const __nv_bfloat16* wt_i = wt + wg * Q * 64;
  // this lane's ldmatrix row in an x or dy tile (A fragments of rows r0, r1)
  const int lm_row = wg * 64 + (warp % 4) * 16 + (mi & 1) * 8 + lane % 8;

  // M'^T = (B.C^T) o L and W^T = (x.dy^T) o L dt by rows j, 64 columns i
  // (from i0) at a time, in bf16 into their Tile<Q>s (rows j, columns i):
  // both products on wgmma, then L_ji = e^{cum_i - cum_j} (i >= j, else 0)
  // once for both; the lane that forms W_jj keeps its rounding residual in
  // wres[j]
  auto store_strips = [&](int i0, const float* cm, const float* dk) {
    float sb[32], sx[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sb[i] = sx[i] = 0.f;
    fence_regs(sb);
    fence_regs(sx);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<64>(sb, desc_k_major<N>(b_wg, Q, kk), desc_k_major<N>(cs + i0 * WN, Q, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < PT / 16; ++kk)
      wgmma_ss<64>(sx, desc_k_major<PT>(xs + wg * 64 * WP, Q, kk),
                   desc_k_major<PT>(dys + i0 * WP, Q, kk), kk > 0);
    wgmma_commit();
    const float cj0 = cm[r0], cj1 = cm[r1], dj0 = dk[r0], dj1 = dk[r1];
    wgmma_wait<0>();
    fence_regs(sb);
    fence_regs(sx);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = i0 + 8 * jj, i = col + 2 * quad;
      const float2 ci = *reinterpret_cast<const float2*>(cm + i);
      const float l00 = i >= r0 ? exp2_approx(fminf(ci.x - cj0, 0.f)) : 0.f;
      const float l01 = i + 1 >= r0 ? exp2_approx(fminf(ci.y - cj0, 0.f)) : 0.f;
      const float l10 = i >= r1 ? exp2_approx(fminf(ci.x - cj1, 0.f)) : 0.f;
      const float l11 = i + 1 >= r1 ? exp2_approx(fminf(ci.y - cj1, 0.f)) : 0.f;
      const int o0 = tile_off<Q>(Q, r0, col) + 2 * quad, o1 = tile_off<Q>(Q, r1, col) + 2 * quad;
      *reinterpret_cast<uint32_t*>(mt + o0) = pack_bf16(sb[4 * jj] * l00, sb[4 * jj + 1] * l01);
      *reinterpret_cast<uint32_t*>(mt + o1) =
          pack_bf16(sb[4 * jj + 2] * l10, sb[4 * jj + 3] * l11);
      const float w00 = sx[4 * jj] * l00 * dj0, w01 = sx[4 * jj + 1] * l01 * dj0;
      const float w10 = sx[4 * jj + 2] * l10 * dj1, w11 = sx[4 * jj + 3] * l11 * dj1;
      const uint32_t h0 = pack_bf16(w00, w01), h1 = pack_bf16(w10, w11);
      *reinterpret_cast<uint32_t*>(wt + o0) = h0;
      *reinterpret_cast<uint32_t*>(wt + o1) = h1;
      if (i == r0 || i + 1 == r0) {
        const float2 r = unpack(h0);
        wres[r0] = i == r0 ? w00 - r.x : w01 - r.y;
      }
      if (i == r1 || i + 1 == r1) {
        const float2 r = unpack(h1);
        wres[r1] = i == r1 ? w10 - r.x : w11 - r.y;
      }
    }
  };
  // per row (r0, r1) of an accumulator of PT columns: sum_p t_p acc_p with
  // t a Q x PT tile (x or dy) read at the accumulator's places; with
  // `scale`, t_p of row r0 (r1) times s0 (s1), rounded to bf16
  auto row_dots = [&](const float (&acc)[PT / 2], const __nv_bfloat16* t, float& v0,
                      float& v1, bool scale = false, float s0 = 1.f, float s1 = 1.f) {
    v0 = v1 = 0.f;
#pragma unroll
    for (int jp = 0; jp < PT / 8; ++jp) {
      uint32_t p0 = *reinterpret_cast<const uint32_t*>(t + tile_off<PT>(Q, r0, 8 * jp) + 2 * quad);
      uint32_t p1 = *reinterpret_cast<const uint32_t*>(t + tile_off<PT>(Q, r1, 8 * jp) + 2 * quad);
      if (scale) {
        p0 = scaled(p0, s0);
        p1 = scaled(p1, s1);
      }
      const float2 t0 = unpack(p0), t1 = unpack(p1);
      v0 = fmaf(t0.x, acc[4 * jp], fmaf(t0.y, acc[4 * jp + 1], v0));
      v1 = fmaf(t1.x, acc[4 * jp + 2], fmaf(t1.y, acc[4 * jp + 3], v1));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, off);
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    }
  };

  float db[N / 2], dc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) db[i] = dc[i] = 0.f;
  mbar_wait_or_trap(&bars[0], 0);

#pragma unroll 1
  for (int k = 0; k < p.heads; ++k) {
    const int h = u.h0 + k, ph = k & 1;
    const float* cm = cum + k * Q;
    const float* dk = dts + k * Q;
    const float* ek = ecs + k * Q;
    const float* wk = wqs + k * Q;
    float* yv = sums + ph * L::kSums;        // dy_i . y_i (y the forward's output)
    float* colv = yv + Q;                    // x_j . (M'^T dy)_j = sum_i T'_ij
    float* dcolv = colv + Q;                 // (dt_j x_j) . (M'^T dy)_j = dt_j Col_j
    float* uv = dcolv + Q;                   // u_j = x_j . (B_j g^T)
    float* ghd = uv + Q;                     // <g, h_in>
    mbar_wait_or_trap(&bars[1], ph);
    mbar_wait_or_trap(&bars[2], ph);
    mbar_wait_or_trap(&bars[3], ph);
    mbar_wait_or_trap(&bars[4], ph);

    // <g, h_in> over this P tile (the layouts of the two tiles agree)
    {
      const uint32_t* h32 = reinterpret_cast<const uint32_t*>(hs);
      const uint32_t* g32 = reinterpret_cast<const uint32_t*>(gs);
      float v = 0.f;
      for (int i = tid; i < L::kH / 2; i += kThreads) {
        const float2 hv = unpack(h32[i]), gv = unpack(g32[i]);
        v = fmaf(hv.x, gv.x, fmaf(hv.y, gv.y, v));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) atomicAdd(ghd, v);
    }
    // M'^T = (B.C^T) o L and W^T = (x.dy^T) o L dt, by rows j, to shared
    // memory (the previous head's products are done with both: the barrier
    // that ended it)
#pragma unroll 1
    for (int i0 = ibase; i0 < Q; i0 += 64) store_strips(i0, cm, dk);
    if (tid == 0) bulk_wait_read();   // the previous head's dx store has read dxs
    fence_proxy_async_smem();         // M'^T and W^T, for wgmma
    __syncthreads();

    const float dt0 = dk[r0], dt1 = dk[r1];
    const float wq0 = wk[r0], wq1 = wk[r1];
    // rows j: dB += W^T C; dx = dt o (M'^T dy) + w o (B g^T) with w = wq dt,
    // on the way Col = x.(M'^T dy) (the column sums of T') and u = x.(B g^T)
    {
      float md[PT / 2], bg[PT / 2];
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) md[i] = bg[i] = 0.f;
      fence_regs(db);
      fence_regs(md);
      fence_regs(bg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk)
        if (kk >= kofs) {
          wgmma_ss<N, 0, 1>(db, desc_k_major<Q>(wt_j, Q, kk), desc_mn_major<N>(cs, Q, kk), 1);
          wgmma_ss<PT, 0, 1>(md, desc_k_major<Q>(mt_j, Q, kk), desc_mn_major<PT>(dys, Q, kk),
                               1);
        }
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<PT, 0, 0>(bg, desc_k_major<N>(b_wg, Q, kk), desc_k_major<N>(gs, PT, kk),
                             kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(db);
      fence_regs(md);
      fence_regs(bg);
      // the diagonal's residual: dB_j += r_j C_j, dC_j += r_j B_j
      {
        const float rs0 = wres[r0], rs1 = wres[r1];
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int o0 = tile_off<N>(Q, r0, 8 * jj) + 2 * quad;
          const int o1 = tile_off<N>(Q, r1, 8 * jj) + 2 * quad;
          const float2 c0v = unpack(*reinterpret_cast<const uint32_t*>(cs + o0));
          const float2 c1v = unpack(*reinterpret_cast<const uint32_t*>(cs + o1));
          const float2 b0v = unpack(*reinterpret_cast<const uint32_t*>(bs + o0));
          const float2 b1v = unpack(*reinterpret_cast<const uint32_t*>(bs + o1));
          db[4 * jj] = fmaf(rs0, c0v.x, db[4 * jj]);
          db[4 * jj + 1] = fmaf(rs0, c0v.y, db[4 * jj + 1]);
          db[4 * jj + 2] = fmaf(rs1, c1v.x, db[4 * jj + 2]);
          db[4 * jj + 3] = fmaf(rs1, c1v.y, db[4 * jj + 3]);
          dc[4 * jj] = fmaf(rs0, b0v.x, dc[4 * jj]);
          dc[4 * jj + 1] = fmaf(rs0, b0v.y, dc[4 * jj + 1]);
          dc[4 * jj + 2] = fmaf(rs1, b1v.x, dc[4 * jj + 2]);
          dc[4 * jj + 3] = fmaf(rs1, b1v.y, dc[4 * jj + 3]);
        }
      }
      float v0, v1, c0, c1, u0, u1;
      row_dots(md, xs, v0, v1);
      // dt_j Col_j for dcum from the rounded dt o x that y takes below: the
      // two cancel over the chunk, and do so only with one rounding
      row_dots(md, xs, c0, c1, true, dt0, dt1);
      row_dots(bg, xs, u0, u1);
      if (quad == 0) {
        colv[r0] = v0;
        colv[r1] = v1;
        dcolv[r0] = c0;
        dcolv[r1] = c1;
        uv[r0] = u0;
        uv[r1] = u1;
      }
      // dx in bf16 into its staging tile
#pragma unroll
      for (int jp = 0; jp < PT / 8; ++jp)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float d = half ? dt1 : dt0, w = d * (half ? wq1 : wq0);
          const int e = 4 * jp + 2 * half;
          *reinterpret_cast<uint32_t*>(dxs + tile_off<PT>(Q, half ? r1 : r0, 8 * jp) +
                                       2 * quad) =
              pack_bf16(fmaf(w, bg[e], d * md[e]), fmaf(w, bg[e + 1], d * md[e + 1]));
        }
    }
    fence_proxy_async_smem();   // dx staged, for the TMA store
    __syncthreads();            // ... and x is read as it came
    if (tid == 0) {
#pragma unroll 1
      for (int cb = 0; cb < PT / WP; ++cb)
        store_box(&dxmap, dxs + cb * Q * WP, p.dx_pos, p0 + WP * cb, row0, h, u.b);
      bulk_commit();
    }
    // x becomes dt o x (rounded to bf16), the input the products below take
    for (int i = tid; i < L::kX / 2; i += kThreads) {
      uint32_t* v = reinterpret_cast<uint32_t*>(xs) + i;
      *v = scaled(*v, dk[(2 * i / WP) % Q]);
    }
    fence_proxy_async_smem();
    __syncthreads();

    // dB += (w o x) g = (wq o (dt o x)) g; rows i: y = e^{cum} o (C h_in^T)
    // + M' (dt o x) (the forward's output) for dy.y; dC += (e^{cum} o dy)
    // h_in + W B
    {
      const float e0 = ek[r0], e1 = ek[r1];
      float y[PT / 2];
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) y[i] = 0.f;
      uint32_t ax[PT / 16][4], ay[PT / 16][4];
      row_frags<PT>(ax, xs, lm_row, mi, wq0, wq1);
      row_frags<PT>(ay, dys, lm_row, mi, e0, e1);
      fence_regs(y);
      fence_regs(db);
      fence_regs(dc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<PT, 0, 0>(y, desc_k_major<N>(c_wg, Q, kk), desc_k_major<N>(hs, PT, kk),
                             kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        wgmma_rs<N>(db, ax[kk], desc_mn_major<N>(gs, PT, kk), 1);
        wgmma_rs<N>(dc, ay[kk], desc_mn_major<N>(hs, PT, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk)
        if (kk < jsteps)
          wgmma_ss<N, 1, 1>(dc, desc_mn_major<64>(wt_i, Q, kk), desc_mn_major<N>(bs, Q, kk),
                              1);
      wgmma_commit();
      wgmma_wait<1>();   // y's first product
      fence_regs(y);
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) y[i] *= (i & 2) ? e1 : e0;
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk)
        if (kk < jsteps)
          wgmma_ss<PT, 1, 1>(y, desc_mn_major<64>(mt_i, Q, kk),
                               desc_mn_major<PT>(xs, Q, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(db);
      fence_regs(dc);
      float v0, v1;
      row_dots(y, dys, v0, v1);
      if (quad == 0) {
        yv[r0] = v0;
        yv[r1] = v1;
      }
    }
    __syncthreads();   // every tile of this head is read: the next head's may load
    if (tid == 0 && k + 1 < p.heads) load_head(k + 1);

    // the chunk's scalar chain for head k (warp 4, 4 rows a lane):
    // dcum_j = dy_j.y_j - dt_j Col_j - w_j u_j (+ e^{cum_last} <g, h_in> +
    // sum w u at the last row), ddA its suffix sum; ddt = Col + wq u + a
    // ddA; da = sum dt ddA
    if (warp == 4) {
      const float a = __bfloat162float(p.a[h]);
      float dcum[4], wu = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float w = wk[j] * dk[j];
        dcum[e] = yv[j] - dcolv[j] - w * uv[j];
        wu = fmaf(w, uv[j], wu);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wu += __shfl_xor_sync(0xffffffffu, wu, off);
      if (lane == 31) dcum[3] += exp2_approx(fminf(last[k], 0.f)) * *ghd + wu;
      // suffix sums: within the lane, then over the lanes above
      float run = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        run += dcum[e];
        dcum[e] = run;
      }
      float above = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, above, off);
        if (lane + off < 32) above += t;
      }
      above -= run;   // the sum over the lanes above this one
      float dav = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e, row = row0 + j;
        const float dda = dcum[e] + above;
        dav = fmaf(dk[j], dda, dav);
        if (row < p.S)
          atomicAdd(p.ddt + (static_cast<long long>(u.b) * p.S + row) * p.H + h,
                    colv[j] + wk[j] * uv[j] + a * dda);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dav += __shfl_xor_sync(0xffffffffu, dav, off);
      __syncwarp();
      if (lane == 0) {
        atomicAdd(p.da + h, dav);
        *ghd = 0.f;
      }
    }
  }

  // ---- dB (rows j) and dC (rows i), summed over the block's heads: staged
  // in f32, then one bulk add a row into device memory ----
  __syncthreads();   // every product is done with shared memory
  float* sb = reinterpret_cast<float*>(cs);   // Q x N
  float* sc = reinterpret_cast<float*>(wt);   // Q x N
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0, n = 8 * jj + 2 * quad;
      *reinterpret_cast<float2*>(sb + r * N + n) =
          make_float2(db[4 * jj + 2 * half], db[4 * jj + 2 * half + 1]);
      *reinterpret_cast<float2*>(sc + r * N + n) =
          make_float2(dc[4 * jj + 2 * half], dc[4 * jj + 2 * half + 1]);
    }
  fence_proxy_async_smem();
  __syncthreads();
  if (tid < Q && row0 + tid < p.S) {
    const long long at = ((static_cast<long long>(u.b) * p.S + row0 + tid) * p.G + u.g) * N;
    bulk_reduce_add_f32(p.db + at, sb + tid * N, N * 4);
    bulk_reduce_add_f32(p.dc + at, sc + tid * N, N * 4);
    bulk_commit();
  }
  // the adds (and thread 0's dx stores) have read shared memory; they
  // complete before the launch does
  bulk_wait_read();
}

struct Args {
  const void *x, *dt, *a, *b, *c, *dy, *dh_final;
  void *dx, *ddt, *da, *db, *dc, *st, *gt, *last, *hb, *gb;
  int B, S, H, P, G, heads;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
      dy_sb, dy_ss, dy_sh;
};

template <int N, int PT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using hopper::make_map;
  using hopper::Tile;
  const int nc = (a.S + Q - 1) / Q;
  Params p{static_cast<const __nv_bfloat16*>(a.dt), static_cast<const __nv_bfloat16*>(a.a),
           static_cast<const float*>(a.dh_final), static_cast<float*>(a.ddt),
           static_cast<float*>(a.da), static_cast<float*>(a.db), static_cast<float*>(a.dc),
           static_cast<__nv_bfloat16*>(a.st), static_cast<__nv_bfloat16*>(a.gt),
           static_cast<float*>(a.last),
           static_cast<__nv_bfloat16*>(a.hb), static_cast<__nv_bfloat16*>(a.gb),
           a.B, a.S, a.H, a.P, a.G, N, a.heads, nc, a.P / PT,
           a.dt_sb, a.dt_ss, a.dt_sh, {}, {}, {}, {}, {}, {}};
  CUtensorMap xm, dym, bm, cm, hm, gm, dxm;
  const long long dx_ss = static_cast<long long>(a.H) * a.P;
  const long long pn = static_cast<long long>(a.P) * N;
  int unused[3];
  cudaError_t err;
  if ((err = hopper::begin("ssd_scan_bwd_tc")) ||
      (err = make_map(&xm, "x", a.x, a.P, {a.S, a.H, a.B}, {a.x_ss, a.x_sh, a.x_sb},
                      Tile<PT>::kBoxCols, Q, p.x_pos)) ||
      (err = make_map(&dym, "dy", a.dy, a.P, {a.S, a.H, a.B}, {a.dy_ss, a.dy_sh, a.dy_sb},
                      Tile<PT>::kBoxCols, Q, p.dy_pos)) ||
      (err = make_map(&bm, "B", a.b, N, {a.S, a.G, a.B}, {a.b_ss, a.b_sg, a.b_sb},
                      Tile<N>::kBoxCols, Q, p.b_pos)) ||
      (err = make_map(&cm, "C", a.c, N, {a.S, a.G, a.B}, {a.c_ss, a.c_sg, a.c_sb},
                      Tile<N>::kBoxCols, Q, p.c_pos)) ||
      (err = make_map(&dxm, "dx", a.dx, a.P, {a.S, a.H, a.B}, {dx_ss, a.P, a.S * dx_ss},
                      Tile<PT>::kBoxCols, Q, p.dx_pos)) ||
      (err = make_map(&hm, "h_in", a.hb, N, {a.P, nc, static_cast<long long>(a.B) * a.H},
                      {N, pn, nc * pn}, Tile<N>::kBoxCols, PT, p.s_pos)) ||
      (err = make_map(&gm, "g", a.gb, N, {a.P, nc, static_cast<long long>(a.B) * a.H},
                      {N, pn, nc * pn}, Tile<N>::kBoxCols, PT, unused)))
    return err;
  // the chunk states take one head a block (two blocks an SM, each loads B
  // and C from L2 again); the main kernel `heads`
  Params ps = p;
  ps.heads = 1;
  constexpr int s_smem = StatesSmem<N, PT>::kBytes, m_smem = MainSmem<N, PT>::kBytes;
  static const cudaError_t opted1 = hopper::opt_in(ssd_scan_bwd_tc_states_kernel<N, PT>, s_smem);
  static const cudaError_t opted2 = hopper::opt_in(ssd_scan_bwd_tc_kernel<N, PT>, m_smem);
  if ((err = hopper::launch("ssd_scan_bwd_tc_states_kernel", ssd_scan_bwd_tc_states_kernel<N, PT>,
                            opted1, nc * a.B * a.H * p.ptiles, kThreads, s_smem, stream, xm, dym,
                            bm, cm, ps)))
    return err;
  const dim3 chain_grid(a.B * a.H, static_cast<unsigned>((pn / 4 + kThreads - 1) / kThreads));
  if ((err = hopper::launch("ssd_scan_bwd_tc_chain_kernel", ssd_scan_bwd_tc_chain_kernel,
                            cudaSuccess, chain_grid, kThreads, 0, stream, p)))
    return err;
  const int grid = nc * a.B * (a.H / a.heads) * p.ptiles;
  return hopper::launch("ssd_scan_bwd_tc_kernel", ssd_scan_bwd_tc_kernel<N, PT>, opted2, grid,
                        kThreads, m_smem, stream, xm, dym, bm, cm, hm, gm, dxm, p);
}

template <int N>
cudaError_t launch_for_p(const Args& a, cudaStream_t stream) {
  if (a.P % 64 == 0) return launch<N, 64>(a, stream);
  return launch<N, 32>(a, stream);
}

cudaError_t ssd_scan_bwd(const Args& a, int N, cudaStream_t stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.G <= 0 || a.H % a.G != 0 || a.P <= 0 ||
      a.P % 32 != 0 || a.heads < 1 || a.heads > kMaxHeads || (a.H / a.G) % a.heads != 0 ||
      static_cast<long long>(a.B) * a.H > 0x7fffffffLL)
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

#define SSD_BWD_ARGS                                                                       \
  const void *x, const void *dt, const void *a, const void *b, const void *c,              \
      const void *dy, const void *dh_final, void *dx, void *ddt, void *da, void *db,       \
      void *dc, void *hbuf, int B, int S, int H, int P, int G, int N, long long x_sb,      \
      long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,   \
      long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,      \
      long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh, void *stream

// dh_final may be null (a zero gradient of the final state); ddt, da, db
// and dc must be zeroed f32 buffers; hbuf holds B*H*ceil(S/64)*P*N floats
extern "C" int repro_ssd_scan_bwd_f32(SSD_BWD_ARGS) {
  return ssd_scan_bwd<float>(
      BwdParams{x, dt, a, b, c, dy, static_cast<const float *>(dh_final), dx,
                static_cast<float *>(ddt), static_cast<float *>(da), static_cast<float *>(db),
                static_cast<float *>(dc), static_cast<float *>(hbuf), B, S, H, P, G, x_sb,
                x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, dy_sb,
                dy_ss, dy_sh},
      N, static_cast<cudaStream_t>(stream));
}

// bf16: x, b, c, dy and dx 16-byte aligned (bases and strides, for TMA);
// dh_final may be null; ddt, da, db, dc zeroed f32 buffers; st, gt, hb and
// gb B*H*nc*P*N bf16 and last B*H*nc floats of scratch (nc = ceil(S / 128));
// heads 1..4, dividing H/G
extern "C" int repro_ssd_scan_bwd_bf16(const void *x, const void *dt, const void *a,
                                       const void *b, const void *c, const void *dy,
                                       const void *dh_final, void *dx, void *ddt, void *da,
                                       void *db, void *dc, void *st, void *gt, void *last,
                                       void *hb, void *gb, int B, int S, int H, int P, int G,
                                       int N, long long x_sb, long long x_ss, long long x_sh,
                                       long long dt_sb, long long dt_ss, long long dt_sh,
                                       long long b_sb, long long b_ss, long long b_sg,
                                       long long c_sb, long long c_ss, long long c_sg,
                                       long long dy_sb, long long dy_ss, long long dy_sh,
                                       void *stream, int heads) {
  const tc::Args args{x,     dt,    a,     b,     c,     dy,    dh_final, dx,    ddt,
                      da,    db,    dc,    st,    gt,    last,  hb,       gb,    B,
                      S,     H,     P,     G,     heads, x_sb,  x_ss,     x_sh,  dt_sb,
                      dt_ss, dt_sh, b_sb,  b_ss,  b_sg,  c_sb,  c_ss,     c_sg,  dy_sb,
                      dy_ss, dy_sh};
  return tc::ssd_scan_bwd(args, N, static_cast<cudaStream_t>(stream));
}
