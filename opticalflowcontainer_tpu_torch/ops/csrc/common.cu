// Helpers shared by the kernels' Python wrappers: CUDA error text and the
// card's shared-memory limit for one block (opt-in, above the 48 KB default).
#include <cuda_runtime.h>

extern "C" const char* ofc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory one block may use on `device`, in bytes, or
// -1 when the attribute cannot be read.
extern "C" int ofc_max_dynamic_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}
