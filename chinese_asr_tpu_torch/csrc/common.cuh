// Shared definitions of the port's CUDA kernels (built by
// ops/cuda/build.py into one shared library with a plain C interface).
//
// Every exported entry point launches on the caller's stream (PyTorch's
// current stream, passed as an opaque pointer), allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after the
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define ASR_API extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than the default 48 KB of dynamic shared memory
// (Hopper allows up to 227 KB per block).  Returns 0 or a cudaError_t.
template <typename Kernel>
static inline int asr_allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
