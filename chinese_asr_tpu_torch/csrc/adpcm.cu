// K5: decode of the 4-bit block-adaptive ADPCM wire for Hopper (sm_90a).
//
// The JAX package decodes this wire with a lax.scan of 256 steps over all
// blocks (chinese_asr_tpu/audio/features.py:500, `adpcm_decode_flat`); it
// has no Pallas kernel.  As eager torch ops the scan would be some 256 x 12
// launches a batch, so the port decodes in one launch.
//
// Wire (uint8, nb blocks of K = 256 samples): bytes [0, nb) the initial
// predictor's low byte, [nb, 2nb) its high byte, [2nb, 3nb) the initial
// step index, then the codes as a [K/2, nb] byte matrix: byte j of block b
// sits at 3nb + j*nb + b, its low nibble code 2j, its high nibble code
// 2j+1.  Each code is a sign bit and a 3-bit magnitude; the step is
// integer-only, (8 + (idx & 7)) << (idx >> 3), so the decode is bit-exact
// with the encoder's state machine and with the JAX scan.
//
// What bounds it on the H100: per block 131 bytes read and 1 KiB written,
// 3.35 TB/s of HBM -> ~0.34 ns a block; but each block is 256 dependent
// integer steps (~10 instructions each), so a block takes a few
// microseconds of one thread.  With one thread per block, a batch of B=32
// 9-10 s wavs (~19,000 blocks) fills the card; B=1 (~600 blocks) is
// bound by the 256-step latency of one thread.
//
// Design: one thread per block, one warp per CTA.  Code bytes are read
// 16 at a time ahead of use; adjacent lanes read adjacent bytes (one
// 32-byte line per warp and byte).  The output b*256 + t is strided by
// 1 KiB across lanes, so each chunk of 32 samples is staged in shared
// memory as a [32 blocks][32 samples] tile and written out row by row:
// every store instruction of the warp writes 128 contiguous bytes.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int K = 256;          // samples per block (features.ADPCM_K)
constexpr int IDX_MAX = 95;
constexpr int CH = 32;          // samples per staged chunk

__global__ void __launch_bounds__(32)
adpcm_decode_kernel(const uint8_t* __restrict__ buf, float* __restrict__ out,
                    int nb) {
    __shared__ float tile[32][CH + 1];   // +1: conflict-free column writes
    const int lane = threadIdx.x;
    const int base = blockIdx.x * 32;
    const int b = base + lane;
    const bool live = b < nb;
    int pred = 0, idx = 0;
    if (live) {
        pred = (int)buf[b] | ((int)buf[nb + b] << 8);
        pred -= (pred >> 15) << 16;      // sign-extend int16
        idx = buf[2 * nb + b];
    }
    const uint8_t* codes = buf + 3 * (size_t)nb + b;
    for (int t0 = 0; t0 < K; t0 += CH) {
        uint8_t by[CH / 2];
#pragma unroll
        for (int j = 0; j < CH / 2; ++j)
            by[j] = live ? codes[(size_t)(t0 / 2 + j) * nb] : 0;
#pragma unroll
        for (int t = 0; t < CH; ++t) {
            const int code = (t & 1) ? by[t >> 1] >> 4 : by[t >> 1] & 15;
            const int step = (8 + (idx & 7)) << (idx >> 3);
            const int mag = code & 7;
            const int dq = ((2 * mag + 1) * step) >> 3;
            pred += (code >> 3) ? -dq : dq;
            pred = min(max(pred, -32768), 32767);
            idx = min(max(idx + (mag < 4 ? -1 : 2 * (mag - 3)), 0), IDX_MAX);
            tile[lane][t] = (float)pred * (1.f / 32768.f);
        }
        __syncwarp();
        // row r of the tile is block base + r's samples t0 .. t0 + CH
        for (int r = 0; r < 32 && base + r < nb; ++r)
            out[(size_t)(base + r) * K + t0 + lane] = tile[r][lane];
        __syncwarp();
    }
}

}  // namespace

// buf uint8 [nb * (3 + K/2)] -> out float32 [nb * K].  Returns 0 or a
// cudaError_t.
ASR_API int asr_adpcm_decode(const uint8_t* buf, float* out, int nb,
                             void* stream) {
    if (nb <= 0) return 0;
    adpcm_decode_kernel<<<(nb + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        buf, out, nb);
    return (int)cudaGetLastError();
}
