// Error reporting for the Python wrappers: turns the cudaError_t an entry
// point returned into CUDA's own message.
#include "common.cuh"

ASR_API const char* asr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
