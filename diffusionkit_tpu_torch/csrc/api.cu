// Library-wide C entry points of the kernel library.

#include <cuda_runtime.h>

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
