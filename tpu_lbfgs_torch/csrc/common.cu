// Plain C entry points shared by the kernels' Python wrappers.
#include "reduce.cuh"

extern "C" int tl_max_blocks(void) { return tl::kMaxBlocks; }

extern "C" const char* tl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
