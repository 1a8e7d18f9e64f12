// Fused RMSNorm for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm.py (wrapper `rmsnorm_pallas`) and computes what
// it computes: per row, the f32 mean of squares, rsqrt(ms + eps), times the
// scale in f32, one cast to the input type.
//
// Design. One block of 256 threads per row: each thread sums the squares of
// a strided slice in f32, warp shuffles and one shared-memory hop give the
// row sum, then each thread writes its slice. The row is read twice (the
// second read mostly hits L1/L2) and written once.
//
// Bound on the card: bytes. 2 * rows * d * sizeof(T) over 3.35 TB/s; at the
// serving path's shapes (rows = 8 or 4096, d = 1024, bf16) the launch costs
// more than the bytes, so this first version does not vectorise its loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                   int d, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) warp_sums[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T>
int rmsnorm(const void* x, const void* scale, void* out, long long rows, int d, float eps,
            void* stream) {
  if (rows <= 0 || d <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
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
