// Fused RMSNorm for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm.py (wrapper `rmsnorm_pallas`) and computes what
// it computes: per row, the f32 mean of squares, rsqrt(ms + eps), times the
// scale in f32, one cast to the input type.
//
// Bound on the card: bytes, each element read once and written once,
// 2 * rows * d * sizeof(T) over 3.35 TB/s (4096 rows of d = 1024 in bf16:
// 16.8 MB, 5.0 us). The design keeps enough 16-byte loads in flight to
// reach that and touches each byte once:
//  - rows_kernel (d up to 2048 vectors of 16 bytes: bf16 d <= 16384, f32
//    d <= 8192; every config): WPR warps a row (1 up to 256 vectors, 2, 4
//    or 8 above), VPT 16-byte vectors a thread held in registers from the
//    load to the write, so the row is read from device memory once. A
//    block of 256 threads takes 8 / WPR rows (one row a block where the
//    rows are too few to fill the card; fewer rows than SMs, a decode
//    round, take 8 warps a row). The scale is loaded into shared memory
//    once per block by all its threads, with the loads of x in flight,
//    and published by the one block barrier (which also sums a
//    row's warps when WPR > 1). Rows reduce by warp shuffles. A d that is
//    no multiple of 16 bytes, or a misaligned base, takes element loads
//    and stores with the same layout (the scalar tail).
//  - wide_kernel (wider rows): one block per row, strided element loads,
//    the row read twice (the second read mostly from L1/L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpt = 8;

// the element type's storage: bf16 as its 16-bit pattern
template <typename T> struct Elem;
template <> struct Elem<float> {
  using S = float;
  static constexpr int N = 4;   // elements in 16 bytes
  static __device__ __forceinline__ float f32(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  using S = unsigned short;
  static constexpr int N = 8;
  static __device__ __forceinline__ float f32(unsigned short x) {
    return __uint_as_float(uint32_t(x) << 16);
  }
  static __device__ __forceinline__ unsigned short from(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  }
};

// 16 bytes of a row: N elements
template <typename T>
union Vec {
  uint4 u;
  typename Elem<T>::S e[Elem<T>::N];
};

// vector i (elements N*i .. N*i + N - 1) of a row of d; zero past d
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const typename Elem<T>::S* __restrict__ row, int i,
                                           int d, bool vec) {
  constexpr int N = Elem<T>::N;
  Vec<T> v;
  if (vec) {
    v.u = *reinterpret_cast<const uint4*>(row + N * i);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v.e[j] = N * i + j < d ? row[N * i + j] : 0;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store_vec(typename Elem<T>::S* __restrict__ row, int i, int d,
                                          bool vec, const Vec<T>& v) {
  constexpr int N = Elem<T>::N;
  if (vec) {
    *reinterpret_cast<uint4*>(row + N * i) = v.u;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (N * i + j < d) row[N * i + j] = v.e[j];
  }
}

// `vec`: d is a multiple of N and x, scale, out are 16-byte aligned
template <typename T, int WPR, int VPT>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows_kernel(const typename Elem<T>::S* __restrict__ x,
                        const typename Elem<T>::S* __restrict__ scale,
                        typename Elem<T>::S* __restrict__ out, long long rows, int d, float eps,
                        int vec) {
  using E = Elem<T>;
  constexpr int TPR = 32 * WPR;               // threads a row
  __shared__ uint4 scale_s[VPT * TPR];
  __shared__ float partial[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rpb = blockDim.x / TPR;          // rows a block
  const int t = (warp % WPR) * 32 + lane;    // thread in the row
  const long long row = static_cast<long long>(blockIdx.x) * rpb + warp / WPR;
  const bool row_ok = row < rows;
  const int nvec = (d + Elem<T>::N - 1) / Elem<T>::N;
  const typename E::S* xr = x + row * d;

  Vec<T> v[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * TPR;
    if (row_ok && i < nvec) v[j] = load_vec<T>(xr, i, d, vec);
    else v[j].u = make_uint4(0, 0, 0, 0);
  }
  // the block stages the scale, VPT / rows-a-block vectors a thread
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) scale_s[i] = load_vec<T>(scale, i, d, vec).u;
  }

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int k = 0; k < Elem<T>::N; ++k) {
      const float f = E::f32(v[j].e[k]);
      ss += f * f;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (WPR > 1) {
    if (lane == 0) partial[warp] = ss;
  }
  __syncthreads();   // the scale and the warps' partial sums are in
  if constexpr (WPR > 1) {
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) ss += partial[warp / WPR * WPR + w];
  }
  if (!row_ok) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  typename E::S* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * TPR;
    if (i >= nvec) break;
    Vec<T> s, o;
    s.u = scale_s[i];
#pragma unroll
    for (int k = 0; k < Elem<T>::N; ++k)
      o.e[k] = E::from(E::f32(v[j].e[k]) * inv * E::f32(s.e[k]));
    store_vec<T>(orow, i, d, vec, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_wide_kernel(const typename Elem<T>::S* __restrict__ x,
                        const typename Elem<T>::S* __restrict__ scale,
                        typename Elem<T>::S* __restrict__ out, int d, float eps) {
  using E = Elem<T>;
  __shared__ float warp_sums[kWarps];
  const long long row = blockIdx.x;
  const typename E::S* xr = x + row * d;
  typename E::S* orow = out + row * d;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = E::f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) ss += warp_sums[w];
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = E::from(E::f32(xr[i]) * inv * E::f32(scale[i]));
}

template <typename T, int WPR, int VPT>
int launch_rows(const void* x, const void* scale, void* out, long long rows, int d, float eps,
                int sms, cudaStream_t stream) {
  using S = typename Elem<T>::S;
  // 8 / WPR rows a block, unless that leaves SMs idle: then one row a block
  const long long full = kWarps / WPR;
  const long long rpb = (rows + full - 1) / full >= sms ? full : 1;
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = d % Elem<T>::N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return hopper::launch("rmsnorm_rows_kernel", rmsnorm_rows_kernel<T, WPR, VPT>, cudaSuccess,
                        static_cast<unsigned>(blocks), static_cast<unsigned>(rpb * 32 * WPR), 0,
                        stream, static_cast<const S*>(x), static_cast<const S*>(scale),
                        static_cast<S*>(out), rows, d, eps, int(vec));
}

template <typename T>
int rmsnorm(const void* x, const void* scale, void* out, long long rows, int d, float eps,
            void* stream) {
  using S = typename Elem<T>::S;
  if (rows <= 0 || d <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  if (cudaError_t err = hopper::begin("rmsnorm")) return err;
  if (cudaError_t err = hopper::sm_count(&sms)) return err;
  const long long nvec = (d + Elem<T>::N - 1) / Elem<T>::N;
  if (rows < sms && nvec > 32 && nvec <= 2048) {
    // fewer rows than SMs (decode): 8 warps a row, so that each thread
    // waits on as few loads as it can
    if (nvec <= 256) return launch_rows<T, 8, 1>(x, scale, out, rows, d, eps, sms, s);
    if (nvec <= 512) return launch_rows<T, 8, 2>(x, scale, out, rows, d, eps, sms, s);
    if (nvec <= 1024) return launch_rows<T, 8, 4>(x, scale, out, rows, d, eps, sms, s);
    return launch_rows<T, 8, kMaxVpt>(x, scale, out, rows, d, eps, sms, s);
  }
  if (nvec <= 32) return launch_rows<T, 1, 1>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 64) return launch_rows<T, 1, 2>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 128) return launch_rows<T, 1, 4>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 256) return launch_rows<T, 1, kMaxVpt>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 512) return launch_rows<T, 2, kMaxVpt>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 1024) return launch_rows<T, 4, kMaxVpt>(x, scale, out, rows, d, eps, sms, s);
  if (nvec <= 2048) return launch_rows<T, 8, kMaxVpt>(x, scale, out, rows, d, eps, sms, s);
  return hopper::launch("rmsnorm_wide_kernel", rmsnorm_wide_kernel<T>, cudaSuccess,
                        static_cast<unsigned>(rows), kThreads, 0, s, static_cast<const S*>(x),
                        static_cast<const S*>(scale), static_cast<S*>(out), d, eps);
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const void* x, const void* scale, void* out, long long rows,
                                 int d, float eps, void* stream) {
  return rmsnorm<float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* scale, void* out, long long rows,
                                  int d, float eps, void* stream) {
  return rmsnorm<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}
