// Error names for the ctypes wrappers: the kernels' C entry points return a
// cudaError_t as an int, and the Python side turns it into a message here.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
