// K7: y = x @ w + b in float32, f32-accurate, on Hopper's tensor cores
// (sm_90a), as 3xTF32 products.
//
//   x [M, K] (rows at a stride of lda floats), w [K, N], b [N] or none
//   -> y [M, N] row-major, float32 throughout.
//
// K7 replaces no TPU kernel: the JAX package leaves its dense products to
// XLA.  The port's Conformer encoder (models/conformer.py) runs ~29 TFLOP
// of them a call, in float32 with TF32 off, and cuBLAS computes those on
// the CUDA cores (SIMT sgemm), at under a third of what the tensor cores
// give at the same accuracy.
//
// Arithmetic: each operand is split into a TF32 hi word and a TF32 lo
// word, both rounded with cvt.rna (hi = rna(v), lo = rna(v - hi)), and
// lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w) is summed, the two small terms
// first at each k8 step (the lo*lo term is dropped).  The products of
// TF32 values are exact in float32; the tensor cores' additions are not:
// they truncate, and summed over K = 9728 on the tensor cores alone the
// result sat ~70x farther from the float64 product than cuBLAS's float32
// one.  So the tensor cores sum one stage (32 k) at a time from zero, and
// each stage's partial sum is added to a float32 accumulator in
// registers, rounded to nearest: the result then sits as close to the
// float64 product as cuBLAS's float32 one, or closer.  This is K1's and
// K2's product (tc.cuh), on wgmma instead of mma.sync.
//
// What bounds it on the H100: the tensor cores.  Three TF32 passes at
// 495 TFLOP/s give 165 TFLOP/s of f32-accurate work; at the Conformer's
// shapes (K 512-9728, N 512-2048, M ~40,000) a product does 60-300
// operations a byte.
//
// Design:
//   * w is split once, outside the kernel, into hi and lo copies laid out
//     K-major, [N, K] each (ops/cuda/gemm.py caches them a weight and
//     version): a TF32 wgmma reads B only K-major from shared memory.
//   * A persistent kernel, one block an SM, walks 128 x 128 output tiles
//     (N fastest, so that the blocks in flight share their rows of x in
//     L2).  Warpgroup 2 is the producer: one thread keeps TMA loads of x's
//     128 x 32 tile and the two 128 x 32 tiles of w's hi and lo copies in
//     flight on a ring of STAGES mbarrier stages (48 KB a stage), 128-byte
//     swizzled; rows past M, columns past N and k past K come in as
//     zeros.
//   * The producer warpgroup gives up registers (setmaxnreg 40) and the
//     consumers take them (232): without, the consumers spill at the
//     384-thread block's 168 a thread and run ~14 % slower.
//   * Warpgroups 0 and 1 are the consumers, 64 rows of the tile each.  At
//     each stage a thread reads its A fragments (4 values a k8 step) from
//     shared memory, splits them in registers, and issues, for each of the
//     four k8 steps, wgmma.m64n128k8 with (A lo, B hi), (A hi, B lo), (A
//     hi, B hi): A from registers, B by descriptor, into the stage's
//     partial sum.  It waits for its group, each warp releases the stage
//     to the producer, and the partial sum goes into the float32
//     accumulator.  The two consumers' groups interleave on the tensor
//     cores.
//   * Epilogue: the bias (copied into shared memory by cp.async at the
//     tile's start) is added in float32 and rows past M and columns past
//     N are masked at the store, while the producer already loads the
//     next tile's stages.
// Inside the decode's CUDA graph: launched on the caller's stream, no
// allocation and no host synchronisation; the TMA descriptors are built
// on the host at each launch and passed by value (__grid_constant__), so
// a captured launch keeps its own.
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                 // tile rows (two warpgroups of 64)
constexpr int BN = 128;                 // tile columns
constexpr int BK = 32;                  // k a stage: 128 bytes of float32
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;            // warpgroups that run the wgmma
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int TILE_A = BM * BK * 4;     // 16 KB
constexpr int TILE_B = BN * BK * 4;     // 16 KB, each of hi and lo
constexpr int STAGE_BYTES = TILE_A + 2 * TILE_B;
// the tiles (1024-byte aligned for the 128-byte swizzle), the full and
// empty mbarriers, each consumer's slice of the bias; 1024 bytes of slack
// to align the start
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8
                     + CONSUMERS * BN * 4 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_whi,
                   const __grid_constant__ CUtensorMap map_wlo,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int M, int N, int K) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
    const uint32_t base = smem_u32(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    float* bias_slices = reinterpret_cast<float*>(empty + STAGES);
    // stage s: x's tile at s * TILE_A, then w hi's and w lo's
    auto tile_x = [&](int s) { return base + s * TILE_A; };
    auto tile_whi = [&](int s) { return base + STAGES * TILE_A + s * TILE_B; };
    auto tile_wlo = [&](int s) {
        return base + STAGES * (TILE_A + TILE_B) + s * TILE_B;
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init_count(&full[s], 1);
            mbar_init_count(&empty[s], CONSUMERS * 4);   // a warp each
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int tiles_n = (N + BN - 1) / BN;
    const int tiles = ((M + BM - 1) / BM) * tiles_n;
    const int ksteps = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;

    if (wg == CONSUMERS) {
        // ---- producer: one thread keeps the ring full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x % 128 == 0) {
            int s = 0;
            uint32_t phase = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
                for (int kb = 0; kb < ksteps; ++kb) {
                    mbar_wait(&empty[s], phase ^ 1);
                    mbar_expect(&full[s], STAGE_BYTES);
                    tma_load(tile_x(s), &map_x, &full[s], kb * BK, m0);
                    tma_load(tile_whi(s), &map_whi, &full[s], kb * BK, n0);
                    tma_load(tile_wlo(s), &map_wlo, &full[s], kb * BK, n0);
                    if (++s == STAGES) { s = 0; phase ^= 1; }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t4 = lane & 3;
        // this thread's A rows within the tile: r and r + 8 (r % 8 == g)
        const int r = wg * 64 + warp * 16 + g;
        float* sb = bias_slices + wg * BN;
        float acc[64], part[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) part[i] = 0.f;
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
            // the tile's bias slice into shared memory, asynchronously
            // (zeros past N or without a bias): read at the epilogue
            const int bcol = n0 + tid;
            cp_async<4>(sb + tid, bias != nullptr && bcol < N ? bias + bcol
                                                               : y,
                        bias != nullptr && bcol < N);
            cp_async_commit();
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
            for (int kb = 0; kb < ksteps; ++kb) {
                mbar_wait(&full[s], phase);
                const float* xa = reinterpret_cast<const float*>(
                    smem + s * TILE_A);
                // A fragments of the 4 k8 steps: a0 (r, c), a1 (r + 8, c),
                // a2 (r, c + 4), a3 (r + 8, c + 4) with c = 8 ks + t4; the
                // 16-byte unit u of row r sits at u ^ (r % 8)
                uint32_t ahi[4][4], alo[4][4];
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int row = r + (j & 1) * 8;
                        const int unit = (2 * ks + (j >> 1)) ^ g;
                        const float v = xa[row * BK + unit * 4 + t4];
                        const float hi = tf32_rna(v);
                        ahi[ks][j] = __float_as_uint(hi);
                        alo[ks][j] = __float_as_uint(tf32_rna(v - hi));
                    }
                }
                const uint64_t dhi = sw128_desc(tile_whi(s));
                const uint64_t dlo = sw128_desc(tile_wlo(s));
                // the stage's 32-term partial sum on the tensor cores, from
                // zero, then added to acc in float32 (rounded to nearest):
                // the tensor cores' own additions truncate, so they never
                // hold more than a stage's terms
                fence_acc(part);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
                    wgmma_tf32(part, alo[ks], dhi + 2 * ks, ks > 0);
                    wgmma_tf32(part, ahi[ks], dlo + 2 * ks, 1);
                    wgmma_tf32(part, ahi[ks], dhi + 2 * ks, 1);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_acc(part);
                if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
                for (int i = 0; i < 64; ++i) acc[i] += part[i];
                if (++s == STAGES) { s = 0; phase ^= 1; }
            }
            // epilogue: acc[4 i + h] is row r (+ 8 for h >= 2), column
            // 8 i + 2 t4 (+ 1 for odd h) of this warpgroup's 64 x 128
            // (the bias from its slice: read from global memory here, its
            // loads were hoisted into the main loop, which then ran ~20 %
            // slower)
            const bool even = (N & 1) == 0;
            cp_async_wait_all();
            consumer_sync(wg);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int col = n0 + 8 * i + 2 * t4;
                const float2 bb = *reinterpret_cast<const float2*>(
                    sb + 8 * i + 2 * t4);
                const float b0 = bb.x, b1 = bb.y;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = m0 + r + 8 * h;
                    if (row >= M) continue;
                    float* dst = y + (size_t)row * N + col;
                    const float v0 = acc[4 * i + 2 * h] + b0;
                    const float v1 = acc[4 * i + 2 * h + 1] + b1;
                    if (even && col + 1 < N) {
                        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                    } else {
                        if (col < N) dst[0] = v0;
                        if (col + 1 < N) dst[1] = v1;
                    }
                }
            }
            consumer_sync(wg);      // the slice read before the next copy
        }
    }
}

}  // namespace

// y [M, N] = x [M, K] (row stride lda) @ w + b, with w given as its TF32
// hi and lo words, each [N, K] contiguous; bias may be null.  x, w_hi and
// w_lo 16-byte aligned, lda and K multiples of 4 (TMA's strides).
ASR_API int asr_gemm_tf32x3(const float* x, int lda, const float* w_hi,
                            const float* w_lo, const float* bias, float* y,
                            int M, int N, int K, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return 0;
    CUtensorMap mx, mhi, mlo;
    int rc = make_map(&mx, x, M, K, lda, BM);
    if (!rc) rc = make_map(&mhi, w_hi, N, K, K, BN);
    if (!rc) rc = make_map(&mlo, w_lo, N, K, K, BN);
    if (rc) return rc;
    int sms = 0;
    rc = sm_count(&sms);
    if (rc) return rc;
    rc = asr_allow_smem(tf32x3_gemm_kernel, SMEM);
    if (rc) return rc;
    const long tiles = (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    const int grid = (int)(tiles < sms ? tiles : sms);
    tf32x3_gemm_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        mx, mhi, mlo, bias, y, M, N, K);
    return (int)cudaGetLastError();
}
