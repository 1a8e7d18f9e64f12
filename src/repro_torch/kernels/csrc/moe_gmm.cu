// Grouped expert GEMM (MoE FFN) for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of src/repro/kernels/moe_gmm.py
// (wrapper `moe_gmm_pallas`) and computes what it computes: for every expert
// e, out[e] = buf[e] @ w[e] with buf (E, C, D), w (E, D, F), out (E, C, F), all
// contiguous, an f32 accumulator and one cast to buf's type.
//
// Design. The TPU grid carries its accumulator in VMEM across a sequential D
// axis. Here one block owns one (expert, C tile, F tile) output tile and
// loops over D itself, staging a buf tile and a w tile through shared memory
// per step; the f32 accumulators stay in registers and there are no atomics.
// Ragged C, D and F edges are zero-filled on load and masked on store, so any
// shape runs (the TPU wrapper halves its blocks until they divide instead).
//  - bf16 (the serving path): tensor cores through nvcuda::wmma (mma.sync,
//    16x16x16, f32 accumulate), 4 warps. Tiles are loaded 16 bytes a thread
//    (neighbouring threads on neighbouring addresses along D for buf, along F
//    for w) into registers one step ahead, so the next tile's loads are in
//    flight while the tensor cores work on this one. Two tile shapes:
//      C <= 16 (decode): 16 x 64 outputs, 64 deep; each warp one 16 x 16 tile.
//        With one C tile, every w element is read from device memory once.
//      C > 16 (prefill):  64 x 64 outputs, 32 deep; each warp 32 x 32.
//  - f32 (tests only): one output per thread from 16 x 16 tiles by FMAs.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): decode is bound
// by w's bytes. At qwen3-moe's shapes (E = 128, D = 2048, F = 768) each call
// moves ~408 MB, ~0.122 ms; the 16-row tile keeps the block's threads on
// loading w, not on rows that are zero. A prefill step (C = 320) needs about
// as long for its 128.8 GFLOP as for its 633 MB; this first version's
// mma.sync tiles do not reach that (wgmma, TMA and a persistent schedule are
// later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

extern "C" int repro_moe_gmm_bf16(const void* buf, const void* w, void* out, int E, int C,
                                  int D, int F, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 16) {
    if (int err = check_dims(E, C, D, F, 16)) return err;
    return launch_bf16<16, 64, 64, 16, 16>(buf, w, out, E, C, D, F, s);
  }
  if (int err = check_dims(E, C, D, F, 64)) return err;
  return launch_bf16<64, 64, 32, 32, 32>(buf, w, out, E, C, D, F, s);
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
