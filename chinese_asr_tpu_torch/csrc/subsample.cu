// K8: the Conformer's and the E-Branchformer's convolutional subsampling
// (ESPnet's Conv2dSubsampling) without its linear map, in float32,
// f32-accurate, on Hopper's tensor cores (sm_90a):
//
//   h1 = relu(conv1(x) + b1)   1 -> C channels, 3x3, stride 2, valid
//   y  = relu(conv2(h1) + b2)  C -> C channels, 3x3, stride 2, valid
//
//   x [B, T, F] (log-mels, padding zeroed), w1 [3, 3, 1, C], b1 [C],
//   w2 [3, 3, C, C] (kt, kf, in, out), b2 [C]
//   -> y [B, T2, C * F2], feature c * F2 + f2 (channel-major, the layout
//   the subsampling's linear map reads), T2 = ((T - 1) / 2 - 1) / 2 and
//   F2 = ((F - 1) / 2 - 1) / 2.
//
// K8 replaces no TPU kernel: the JAX package leaves both convolutions to
// XLA (lax.conv).  On the card cuDNN ran them in float32 with TF32 off
// on the CUDA cores (an implicit GEMM at ~39 TFLOP/s); the second holds
// nearly all of the work (2 * 9 C^2 operations an output position:
// ~12 TFLOP a call of the offline cells), and its 1 -> C intermediate
// ([B, C, T1, F1], ~22 GB a call) went through device memory.
//
// Arithmetic: conv2 as an implicit GEMM, y[m, n] = sum_k A[m, k] W[k, n]
// with m = (b, t2, f2) the output position, n the output channel and k =
// (kt, kf, c) in w2's own order, so that w2 is already the K-major [9 C,
// C] matrix; A[m, (kt, kf, c)] = h1[b, 2 t2 + kt, 2 f2 + kf, c].  K7's
// 3xTF32 product (gemm.cu): A and W split into TF32 hi and lo words with
// cvt.rna, lo(A) hi(W) + hi(A) lo(W) + hi(A) hi(W) summed on the tensor
// cores one 32-k stage at a time from zero, and the stages added in
// float32 (the tensor cores' own additions truncate).
//
// What bounds it on the H100: the tensor cores, 165 TFLOP/s of
// f32-accurate work at three TF32 passes (~75 ms a call of the offline
// cells); its bytes are x read once and y written once.
//
// Design (K7's, with A made in registers):
//   * A persistent kernel, one block an SM, walks 128 x 128 output tiles,
//     N fastest.  The producer warpgroup's one thread keeps TMA loads of
//     the two 128 x 32 tiles of w2's hi and lo copies (K-major, [C, 9 C]
//     each: ops/cuda/gemm.py's cached split of the weight) in flight on a
//     ring of STAGES mbarrier stages (32 KB a stage), 128-byte swizzled.
//   * A never touches device memory.  Each consumer thread computes its
//     own A fragments (2 rows x 8 channels a stage) from x: a value is
//     b1 plus 9 taps of w1 by fma, its ReLU, then the hi / lo split.  The
//     7 x 7 input patch of each of a warpgroup's 64 rows is copied into
//     shared memory at the tile's start; w1 and b1 sit in shared memory
//     for the kernel's life, laid out so that a thread reads its 8
//     channels' 10 values (9 taps and the bias) as float4s without bank
//     conflicts.  The k loop runs tap by tap, C / 32 stages of 32
//     channels each, so that a thread holds its two rows' 3 x 3 window
//     of the tap in registers.  That is 144 fma a thread a stage against
//     12 wgmma of m64n128k8, run while the other consumer's products hold
//     the tensor cores.  ptxas holds the kernel to 168 registers a
//     thread (384 threads a block), which a consumer's 64 accumulators,
//     64 partial sums and 32 A words nearly fill: the next stage's fmas
//     run under this stage's products, or the two consumers taking turns
//     on the tensor cores by named barriers, spilled or ran slower on
//     the card.
//   * Warpgroups 0 and 1 are the consumers, 64 rows of the tile each:
//     wgmma.m64n128k8 with (A lo, B hi), (A hi, B lo), (A hi, B hi) at
//     each of a stage's four k8 steps into the stage's partial sum, which
//     is then added to the float32 accumulator.  setmaxnreg 40 / 232 as
//     in K7.
//   * Epilogue: b2 (copied into shared memory by cp.async at the tile's
//     start) added in float32, the ReLU, and each value stored at its
//     place in [B, T2, C * F2]: a warp's store writes four runs of 8
//     neighbouring positions (f2 is fastest in both the tile's rows and
//     the output), rows past M and channels past C masked.
// Inside the decode's CUDA graph: launched on the caller's stream, no
// allocation and no host synchronisation; the TMA descriptors are built
// on the host at each launch and passed by value (__grid_constant__).
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                 // tile rows (two warpgroups of 64)
constexpr int BN = 128;                 // tile columns (output channels)
constexpr int BK = 32;                  // k a stage: 32 channels of a tap
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;            // warpgroups that run the wgmma
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int TILE_B = BN * BK * 4;     // 16 KB, each of hi and lo
constexpr int STAGE_BYTES = 2 * TILE_B;
constexpr int PATCH = 49;               // a row's 7 x 7 input patch
// w1 and b1 in shared memory: for each 32-channel block and lane t4 of a
// quad, the 10 values (9 taps, then the bias) of its 8 channels c = 32 cb
// + 4 p + t4, p = 0..7; 80 floats padded to 84, so that the four t4 of a
// quad read distinct banks
constexpr int WQUAD = 84;
constexpr int MAX_C = 1024;

// the dynamic shared memory a launch at C channels takes: the ring
// (1024-byte aligned for the 128-byte swizzle), the full and empty
// mbarriers, each consumer's slice of b2, w1 and b1, each consumer's
// patches; 1024 bytes of slack to align the start
inline int smem_bytes(int C) {
    return 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8
           + 4 * (CONSUMERS * BN + (C / 32) * 4 * WQUAD
                  + CONSUMERS * 64 * PATCH);
}

__global__ void __launch_bounds__(THREADS, 1)
subsample_tf32x3_kernel(const __grid_constant__ CUtensorMap map_whi,
                        const __grid_constant__ CUtensorMap map_wlo,
                        const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2, float* __restrict__ y,
                        int T, int Fq, int T2, int F2, int C, int M) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
    const uint32_t base = smem_u32(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    float* bias_slices = reinterpret_cast<float*>(empty + STAGES);
    float* wq = bias_slices + CONSUMERS * BN;
    float* patches = wq + (C / 32) * 4 * WQUAD;
    auto tile_whi = [&](int s) { return base + s * STAGE_BYTES; };
    auto tile_wlo = [&](int s) { return base + s * STAGE_BYTES + TILE_B; };

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init_count(&full[s], 1);
            mbar_init_count(&empty[s], CONSUMERS * 4);   // a warp each
        }
        mbar_init_fence();
    }
    // w1 and b1 into their quad layout, by every thread
    for (int i = threadIdx.x; i < (C / 32) * 4 * 80; i += THREADS) {
        const int p = i % 8, j = (i / 8) % 10, quad = i / 80;
        const int c = (quad / 4) * 32 + 4 * p + quad % 4;
        wq[quad * WQUAD + j * 8 + p] = j < 9 ? w1[j * C + c] : b1[c];
    }
    __syncthreads();

    const int N = C, K = 9 * C, cblocks = C / 32;
    const int tiles_n = (N + BN - 1) / BN;
    const int tiles = ((M + BM - 1) / BM) * tiles_n;
    const int ksteps = K / BK;
    const int wg = threadIdx.x / 128;

    if (wg == CONSUMERS) {
        // ---- producer: one thread keeps the ring of w2's tiles full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x % 128 == 0) {
            int s = 0;
            uint32_t phase = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int n0 = (t % tiles_n) * BN;
                for (int kb = 0; kb < ksteps; ++kb) {
                    mbar_wait(&empty[s], phase ^ 1);
                    mbar_expect(&full[s], STAGE_BYTES);
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
        float* wp = patches + wg * 64 * PATCH;
        const float* p0 = wp + (warp * 16 + g) * PATCH;
        const int cf = C * F2;
        float acc[64], part[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) part[i] = 0.f;
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
            // the tile's b2 slice into shared memory, asynchronously
            // (zeros past N): read at the epilogue
            const int bcol = n0 + tid;
            cp_async<4>(sb + tid, bcol < N ? b2 + bcol : b2, bcol < N);
            cp_async_commit();
            // the 7 x 7 input patch of each of this warpgroup's 64 rows:
            // row m = (b, t2, f2) reads x[b, 4 t2 .. 4 t2 + 6, 4 f2 ..
            // 4 f2 + 6] (zeros past M)
            for (int i = tid; i < 64 * PATCH; i += 128) {
                const int rl = i / PATCH, e = i - rl * PATCH;
                const int m = m0 + wg * 64 + rl;
                float xv = 0.f;
                if (m < M) {
                    const int q = m / F2, f2 = m - q * F2;
                    const int b = q / T2, t2 = q - b * T2;
                    xv = __ldg(x + ((size_t)b * T + 4 * t2 + e / 7) * Fq
                               + 4 * f2 + e % 7);
                }
                wp[i] = xv;
            }
            consumer_sync(wg);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
            for (int tap = 0; tap < 9; ++tap) {
                // the 3 x 3 window of x under tap (kt, kf) of rows r and r +
                // 8, held in registers over the tap's C / 32 stages
                const int kt = tap / 3, kf = tap - kt * 3;
                const float* pa = p0 + 14 * kt + 2 * kf;
                float xr[2][9];
#pragma unroll
                for (int j = 0; j < 9; ++j) {
                    const int off = (j / 3) * 7 + j % 3;
                    xr[0][j] = pa[off];
                    xr[1][j] = pa[8 * PATCH + off];
                }
                for (int cb = 0; cb < cblocks; ++cb) {
                    // stage (tap, cb): conv1 at rows r, r + 8 and channels
                    // 32 cb + 4 p + t4, b1 plus 9 taps by fma; channel p = 2
                    // ks + half (column 8 ks + 4 half + t4 of the stage) is
                    // A fragment j = h + 2 half of k8 step ks
                    const float* wc = wq + (cb * 4 + t4) * WQUAD;
                    float v[2][8];
                    {
                        const float4 lo4 = *reinterpret_cast<const float4*>(wc + 72);
                        const float4 hi4 = *reinterpret_cast<const float4*>(wc + 76);
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            v[h][0] = lo4.x; v[h][1] = lo4.y; v[h][2] = lo4.z;
                            v[h][3] = lo4.w; v[h][4] = hi4.x; v[h][5] = hi4.y;
                            v[h][6] = hi4.z; v[h][7] = hi4.w;
                        }
                    }
#pragma unroll
                    for (int j = 0; j < 9; ++j) {
                        const float4 wl = *reinterpret_cast<const float4*>(wc + 8 * j);
                        const float4 wh =
                            *reinterpret_cast<const float4*>(wc + 8 * j + 4);
                        const float w[8] = {wl.x, wl.y, wl.z, wl.w,
                                            wh.x, wh.y, wh.z, wh.w};
#pragma unroll
                        for (int p = 0; p < 8; ++p) {
                            v[0][p] = fmaf(xr[0][j], w[p], v[0][p]);
                            v[1][p] = fmaf(xr[1][j], w[p], v[1][p]);
                        }
                    }
                    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
                    for (int p = 0; p < 8; ++p) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float a = fmaxf(v[h][p], 0.f);
                            const float hi = tf32_rna(a);
                            ahi[p >> 1][h + 2 * (p & 1)] = __float_as_uint(hi);
                            alo[p >> 1][h + 2 * (p & 1)] =
                                __float_as_uint(tf32_rna(a - hi));
                        }
                    }
                    mbar_wait(&full[s], phase);
                    const uint64_t dhi = sw128_desc(tile_whi(s));
                    const uint64_t dlo = sw128_desc(tile_wlo(s));
                    // the stage's 32-term partial sum on the tensor cores,
                    // from zero, then added to acc in float32 (K7's order)
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
            }
            // epilogue: acc[4 i + h] is row r (+ 8 for h >= 2), column
            // 8 i + 2 t4 (+ 1 for odd h) of this warpgroup's 64 x 128;
            // row m = q F2 + f2 (q = b T2 + t2) and channel n go to
            // y[q, n F2 + f2]
            cp_async_wait_all();
            consumer_sync(wg);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + r + 8 * h;
                if (m >= M) continue;
                const int q = m / F2;
                float* dst = y + (size_t)q * cf + (m - q * F2);
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const int col = n0 + 8 * i + 2 * t4;
                    const float2 bb = *reinterpret_cast<const float2*>(
                        sb + 8 * i + 2 * t4);
                    if (col < N)
                        dst[(size_t)col * F2] =
                            fmaxf(acc[4 * i + 2 * h] + bb.x, 0.f);
                    if (col + 1 < N)
                        dst[(size_t)(col + 1) * F2] =
                            fmaxf(acc[4 * i + 2 * h + 1] + bb.y, 0.f);
                }
            }
            // the b2 slice and the patches read before the next tile's
            // copies
            consumer_sync(wg);
        }

    }
}

}  // namespace

// y [B, T2, C * F2] = relu(conv2(relu(conv1(x) + b1)) + b2), flattened
// channel-major, with w2 given as its TF32 hi and lo words, each [C, 9 C]
// contiguous (K-major, k = (kt, kf, c_in)).  x [B, T, F], w1 [3, 3, 1, C]
// and b1, b2 [C] contiguous; w_hi and w_lo 16-byte aligned; C a multiple
// of 32 up to 1024; T2 and F2 at least 1.
ASR_API int asr_subsample_tf32x3(const float* x, const float* w1,
                                 const float* b1, const float* w_hi,
                                 const float* w_lo, const float* b2, float* y,
                                 int B, int T, int Fq, int C, void* stream) {
    const int T2 = ((T - 1) / 2 - 1) / 2, F2 = ((Fq - 1) / 2 - 1) / 2;
    if (C <= 0 || C % 32 || C > MAX_C || T < 7 || Fq < 7)
        return (int)cudaErrorInvalidValue;
    const long M = (long)B * T2 * F2;
    if (M <= 0) return 0;
    if (M > (1L << 30)) return (int)cudaErrorInvalidValue;
    CUtensorMap mhi, mlo;
    int rc = make_map(&mhi, w_hi, C, 9 * C, 9 * C, BN);
    if (!rc) rc = make_map(&mlo, w_lo, C, 9 * C, 9 * C, BN);
    if (rc) return rc;
    int sms = 0;
    rc = sm_count(&sms);
    if (rc) return rc;
    const int smem = smem_bytes(C);
    rc = asr_allow_smem(subsample_tf32x3_kernel, smem);
    if (rc) return rc;
    const long tiles = ((M + BM - 1) / BM) * ((C + BN - 1) / BN);
    const int grid = (int)(tiles < sms ? tiles : sms);
    subsample_tf32x3_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        mhi, mlo, x, w1, b1, b2, y, T, Fq, T2, F2, C, (int)M);
    return (int)cudaGetLastError();
}
