// The CUDA runtime's text for an error code, for the Python wrappers' messages.
#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
