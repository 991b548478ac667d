// K1: fused log-mel front end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/logmel.py
// (`_kernel`, launched by `pallas_log_mel`): pre-emphasized wav
// [B, N] f32 -> [B, T, n_mels] f32 log-mel, never materializing the
// [T, win] frame matrix or the [T, bins] spectrum in device memory.
// Frame t covers samples [t*hop + offset, t*hop + offset + win) (the
// 400-tap window centred in the 512-point frame, offset 56); samples past
// the end of the row read as zero.
//
// What bounds it on the H100: arithmetic.  The windowed DFT is
// 2 * 2 * win * bins flops per frame (~411 kflop at 400 x 257) against
// ~0.6 KB of new samples per frame, far above the card's ~20 f32 flops
// per byte of memory bandwidth; with f32 math outside the tensor cores
// the floor is flops / 67 TFLOP/s.
//
// Design: one block per (utterance, tile of TF frames).  The tile's
// samples ((TF-1)*hop + win floats) are staged once in shared memory.
// One thread per DFT bin accumulates re/im for all TF frames in
// registers, reading the window-folded cos/sin tables (win x bins f32,
// ~0.8 MB together) straight from global memory, where they stay in the
// 50 MB L2 -- each table element loaded is reused for TF frames.  The
// power spectrum goes to shared memory, then the threads split the
// TF x n_mels mel products (bins-long dot products against the
// filterbank), apply the float32-eps floor of `mel == 0` and the log.
// The frame mask is applied by the wrapper after the kernel, as in the
// JAX wrapper.  The TPU kernel's 384-lane bin padding is not copied.
//
// Later, faster designs: TF32/bf16x3 tensor-core products (wgmma) for
// the DFT, TMA staging of the sample tile.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int TF = 16;  // frames per block

__global__ void logmel_kernel(const float* __restrict__ wav,
                              const float* __restrict__ cosm,
                              const float* __restrict__ sinm,
                              const float* __restrict__ fb,
                              float* __restrict__ out,
                              int N, int T, int win, int hop, int offset,
                              int nbins, int nmels, float eps) {
    extern __shared__ float smem[];
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TF;
    const int nf = min(TF, T - t0);
    const int span = (TF - 1) * hop + win;
    float* xs = smem;            // [span] samples of this tile
    float* pw = smem + span;     // [TF][nbins] power spectrum

    const float* row = wav + (size_t)b * N;
    const long long base = (long long)t0 * hop + offset;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const long long n = base + i;
        xs[i] = (n < N) ? row[n] : 0.f;
    }
    __syncthreads();

    for (int k = threadIdx.x; k < nbins; k += blockDim.x) {
        float re[TF], im[TF];
#pragma unroll
        for (int f = 0; f < TF; ++f) {
            re[f] = 0.f;
            im[f] = 0.f;
        }
        for (int n = 0; n < win; ++n) {
            const float c = __ldg(cosm + (size_t)n * nbins + k);
            const float s = __ldg(sinm + (size_t)n * nbins + k);
#pragma unroll
            for (int f = 0; f < TF; ++f) {
                const float x = xs[f * hop + n];
                re[f] = fmaf(x, c, re[f]);
                im[f] = fmaf(x, s, im[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < TF; ++f)
            pw[f * nbins + k] = re[f] * re[f] + im[f] * im[f];
    }
    __syncthreads();

    for (int o = threadIdx.x; o < nf * nmels; o += blockDim.x) {
        const int f = o / nmels;
        const int m = o - f * nmels;
        const float* p = pw + f * nbins;
        float acc = 0.f;
        for (int k = 0; k < nbins; ++k)
            acc = fmaf(p[k], __ldg(fb + (size_t)k * nmels + m), acc);
        acc = (acc == 0.f) ? eps : acc;
        out[((size_t)b * T + t0 + f) * nmels + m] = logf(acc);
    }
}

}  // namespace

// wav [B, N] (pre-emphasized), cosm/sinm [win, nbins], fb [nbins, nmels]
// -> out [B, T, nmels].  All float32, contiguous, on the current device.
ASR_API int asr_logmel(const float* wav, const float* cosm, const float* sinm,
                       const float* fb, float* out, int B, int N, int T,
                       int win, int hop, int offset, int nbins, int nmels,
                       float eps, void* stream) {
    if (B <= 0 || T <= 0) return 0;
    const size_t smem =
        ((size_t)(TF - 1) * hop + win + (size_t)TF * nbins) * sizeof(float);
    const int rc = asr_allow_smem(logmel_kernel, smem);
    if (rc) return rc;
    const int threads = min(1024, (nbins + 31) / 32 * 32);
    const dim3 grid((T + TF - 1) / TF, B);
    logmel_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        wav, cosm, sinm, fb, out, N, T, win, hop, offset, nbins, nmels, eps);
    return (int)cudaGetLastError();
}
