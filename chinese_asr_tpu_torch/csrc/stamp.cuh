// Phase stamps of the BiLSTM cluster kernels, for their measurement build
// only: chinese_asr_tpu_torch/tools/lstm_stamp.py compiles lstm.cu and
// lstm_bwd.cu with -DASR_STAMP into a library of its own.  The product
// build (ops/cuda/build.py) never defines ASR_STAMP, and there every macro
// below is empty.
//
// One thread (thread 0 of block (0, 0): cluster 0, rank 0, the forward
// direction) sums the clock64 cycles between consecutive stamps by phase
// in shared memory; at the kernel's end it writes the sums, its total
// cycles and its %globaltimer nanoseconds into a device array that the
// library's asr_stamp_read_* entry copies out.  A stamp costs that thread
// a clock read and a shared-memory add.
#pragma once

#define ASR_STAMP_N 24     // phases 0..21, then total cycles, total ns

#ifdef ASR_STAMP
__device__ __forceinline__ unsigned long long asr_globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

#define STAMP_BEGIN                                                        \
    __shared__ unsigned long long stamp_acc_[ASR_STAMP_N];                 \
    const bool stamp_on_ = blockIdx.x == 0 && blockIdx.y == 0              \
                           && threadIdx.x == 0;                            \
    unsigned long long stamp_last_ = clock64();                            \
    const unsigned long long stamp_c0_ = stamp_last_;                      \
    const unsigned long long stamp_g0_ = asr_globaltimer();                \
    if (stamp_on_)                                                         \
        for (int i_ = 0; i_ < ASR_STAMP_N; ++i_) stamp_acc_[i_] = 0ull

#define STAMP(k)                                                           \
    do {                                                                   \
        if (stamp_on_) {                                                   \
            const unsigned long long n_ = clock64();                       \
            stamp_acc_[k] += n_ - stamp_last_;                             \
            stamp_last_ = n_;                                              \
        }                                                                  \
    } while (0)

#define STAMP_END(arr)                                                     \
    do {                                                                   \
        if (stamp_on_) {                                                   \
            for (int i_ = 0; i_ < ASR_STAMP_N - 2; ++i_)                   \
                (arr)[i_] = stamp_acc_[i_];                                \
            (arr)[ASR_STAMP_N - 2] = clock64() - stamp_c0_;                \
            (arr)[ASR_STAMP_N - 1] = asr_globaltimer() - stamp_g0_;        \
        }                                                                  \
    } while (0)

// The device array of one source's kernels, the C entry that reads it,
// and the one that sets the bf16 kernels' CTAs a cluster for the next
// launches (8 or 4; 0: the plan's rule, tc.cuh `bf16_ctas`).
#define STAMP_EXPORT(arr, reader, setter)                                  \
    __device__ unsigned long long arr[ASR_STAMP_N];                        \
    static int stamp_ctas_ = 0;                                            \
    ASR_API int reader(unsigned long long* out) {                          \
        return (int)cudaMemcpyFromSymbol(out, arr, sizeof(arr));           \
    }                                                                      \
    ASR_API void setter(int ctas) { stamp_ctas_ = ctas; }
#define STAMP_CTAS(c) (stamp_ctas_ ? stamp_ctas_ : (c))
#else
#define STAMP_BEGIN
#define STAMP(k) do {} while (0)
#define STAMP_END(arr) do {} while (0)
#define STAMP_EXPORT(arr, reader, setter)
#define STAMP_CTAS(c) (c)
#endif
