// Error reporting for the C entry points of the kernel library: each
// entry point returns the cudaError_t of its launch, and the Python side
// (r3det_tpu_torch/_ext.py) turns a nonzero code into an exception with
// this message.
#include <cuda_runtime.h>

extern "C" const char* r3det_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
