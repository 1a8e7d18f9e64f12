// Error names and notes for the ctypes wrappers: the kernels' C entry
// points return a cudaError_t as an int, and the Python side turns it into a
// message here, with the note the entry point left on this thread (which
// check, tensor map or launch failed, and why: hopper.cuh's `note`).
#include <cuda_runtime.h>
#include <string.h>

#include "hopper.cuh"

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// this thread's note, cleared: read once per error
extern "C" const char* repro_last_error_note() {
  static thread_local char out[640];
  strncpy(out, hopper::error_note(), sizeof(out) - 1);
  out[sizeof(out) - 1] = 0;
  hopper::error_note()[0] = 0;
  return out;
}
