// K1: fused log-mel front end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/logmel.py:107
// (`pallas_log_mel`, body `_kernel` :70): pre-emphasized wav [B, N] f32 ->
// [B, T, n_mels] f32 log-mel, never materializing the [T, win] frame matrix
// or the [T, bins] spectrum in device memory.  Frame t covers samples
// [t*hop + offset, t*hop + offset + win) (the 400-tap window centred in the
// 512-point frame, offset 56); samples past the end of the row read as zero.
//
// What bounds it on the H100: the windowed DFT.  Done as a product it is
// 2 * win * 2 * bins flops per frame (~411 kflop at 400 x 257), ~24x what a
// real 512-point FFT needs; the function's own bound is the FFT's
// operations at the f32 rate.  The first version ran the product on the
// CUDA cores (one thread per bin, the cos/sin tables read from L2 element
// by element: load-bound at 24 % of the f32 rate).  This one runs it on
// the tensor cores, where three TF32 products per k-step, issued as
// `mma.sync`, and the table's stream from L2 set the pace.
//
// Design: the DFT as a tensor-core product with f32 accuracy (3xTF32).
// * Tiles of TF = 64 frames of one utterance.  A persistent grid (one
//   block per SM, 16 warps: two halves of the frames x 8 groups of bins)
//   walks over the tiles; the next tile's samples arrive by cp.async while
//   this one's DFT runs.  Each sample is then split into a TF32 hi word and
//   the exact rest (float2) in shared memory, with 4 pad entries after
//   every `hop` samples so that the A-fragment loads of 8 frames (stride
//   hop = 160) hit distinct banks.
// * Frames [TF, win] x table [win, 2 bins'] with the cos and sin columns of a
//   bin interleaved (2b, 2b+1).  A is never built: frame f's tap n is the
//   staged sample f*hop + n, loaded straight into `mma.m16n8k8` A fragments
//   (the rest truncated to TF32 as it is loaded).  B is the window-folded
//   table, split into hi/lo once on the host and laid out in fragment order
//   (one float4 per lane per k-step and n-tile: b0 hi, b1 hi, b0 lo, b1 lo),
//   read from L2 one k-step ahead.  hi*hi goes to one set of f32
//   accumulators, lo*hi + hi*lo to another, term by term over the warp's 8
//   tiles.
// * An m16n8 accumulator gives each thread two adjacent columns, i.e. re and
//   im of one bin: the power is formed in registers and written to shared
//   memory.
// * Of the lowest NX = 4 bins and the last (Nyquist) bin, those that a mel
//   filter uses are dot products on the CUDA cores instead, from the raw
//   samples before the DFT starts (the last warps; the others split the
//   samples meanwhile): f32 FMAs in tap order and re*re + im*im, the plain
//   version's arithmetic.  Pre-emphasis leaves almost no energy at the
//   lowest bins (31 Hz is 27 dB down), so their sums cancel deeply: any
//   other order of rounding moves their log by up to ~2e-3 against the
//   plain version (its own error against f64 is 1.8e-3 there), and the
//   first mel filter (bin 1 alone at the flagship config) passes it on.
// * The mel stage reads each filter's nonzero bin range (computed on the
//   host from the filterbank) from the shared power, lanes over frames so
//   that a warp runs one filter; it floors `mel == 0` to eps, takes the log
//   and the tile's rows leave in one coalesced run.
// The frame mask is applied by the wrapper after the kernel, as in the JAX
// wrapper.
//
// Left for later: `wgmma` (the TF32 rate `mma.sync` does not reach) with
// the table tiles brought by TMA, multicast over a cluster of frame
// tiles, and a warp-specialised producer; or a shared-memory FFT, the
// smaller algorithm.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int TF = 64;              // frames per block
constexpr int MW = 2;               // m16 tiles per warp (half the frames)
constexpr int WARPS = 16;           // 2 frame halves x 8 bin groups
constexpr int THREADS = 32 * WARPS;
constexpr int NPG = 4;              // n-tiles per warp pass
constexpr int SK = 4;               // pad float2 entries per hop of samples
constexpr int PF = 1;               // k-steps of B prefetched in registers
constexpr int NX = 4;               // lowest bins done in f32 on the CUDA cores

__device__ __forceinline__ float tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

// d += a * b on the tensor cores, TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
          "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
          "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// The A fragments of one k-step for the warp's MW m-tiles (frames r, r+8
// of each, taps n0 and n0 + 4; seg0 = n0 / hop), then advance the taps by
// 8 (hop >= 8, so by one segment at most).
__device__ __forceinline__ void load_a(float2 (&x)[MW][4],
                                       const float2* __restrict__ xw, int rs,
                                       int hop, int& n0, int& seg0) {
    const int bnd = (seg0 + 1) * hop;
    const int q0 = n0 + seg0 * SK;
    const int q1 = q0 + 4 + (n0 + 4 >= bnd ? SK : 0);
#pragma unroll
    for (int m = 0; m < MW; ++m) {
        const float2* r = xw + m * 16 * rs;
        x[m][0] = r[q0];
        x[m][1] = r[8 * rs + q0];
        x[m][2] = r[q1];
        x[m][3] = r[8 * rs + q1];
#pragma unroll
        for (int e = 0; e < 4; ++e)       // the exact lo, truncated to TF32
            x[m][e].y = __uint_as_float(__float_as_uint(x[m][e].y)
                                        & 0xffffe000u);
    }
    n0 += 8;
    if (n0 >= bnd) ++seg0;
}

// One k-step: accs += lo*hi + hi*lo, acc += hi*hi, term by term, so that
// consecutive mma instructions use different accumulators.  The small
// terms have their own accumulators: summed into the large ones they would
// lose their low bits to the tensor cores' alignment of the addends.
__device__ __forceinline__ void mma3(float (&acc)[MW][NPG][4],
                                     float (&accs)[MW][NPG][4],
                                     const float2 (&x)[MW][4],
                                     const float4 (&w)[NPG]) {
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int j = 0; j < NPG; ++j)
            mma_tf32(accs[m][j], x[m][0].y, x[m][1].y, x[m][2].y, x[m][3].y,
                     w[j].x, w[j].y);
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int j = 0; j < NPG; ++j)
            mma_tf32(accs[m][j], x[m][0].x, x[m][1].x, x[m][2].x, x[m][3].x,
                     w[j].z, w[j].w);
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int j = 0; j < NPG; ++j)
            mma_tf32(acc[m][j], x[m][0].x, x[m][1].x, x[m][2].x, x[m][3].x,
                     w[j].x, w[j].y);
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool pred) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 ::"r"(d), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

// Persistent: block j takes tiles j, j + gridDim.x, ... (tile = utterance
// b, frames [t0, t0 + TF)); the next tile's samples arrive by cp.async
// while this one's DFT runs.
__global__ void __launch_bounds__(THREADS, 1)
logmel_tc_kernel(const float* __restrict__ wav,
                 const float4* __restrict__ bfrag,
                 const float* __restrict__ cosm,
                 const float* __restrict__ sinm,
                 const float* __restrict__ mel_w,
                 const int* __restrict__ mel_idx,
                 const int* __restrict__ exbins,
                 float* __restrict__ out,
                 int B, int N, int T, int win, int hop, int offset, int ksteps,
                 int ngroups, int nbins, int nmels, int nmw, int nex,
                 float eps, int span, int xs_len, int raw_len, int ps) {
    extern __shared__ float2 smem2[];
    float2* xs = smem2;                                      // [xs_len]
    float* ob = reinterpret_cast<float*>(smem2);             // [TF][nmels+1]
    float* raw = reinterpret_cast<float*>(smem2 + xs_len);   // [raw_len]
    float* pw = raw + raw_len;                               // [TF][ps]
    float2* ex = reinterpret_cast<float2*>(pw + TF * ps);   // [win][NX+1]
    int* midx = reinterpret_cast<int*>(ex + win * (NX + 1)); // [3][nmels]
    float* mw = reinterpret_cast<float*>(midx + 3 * nmels);  // [nmw]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int rs = hop + SK;                  // row stride of a frame
    const int ntf = (T + TF - 1) / TF;        // frame tiles per utterance
    const int ntile = B * ntf;

    // this tile's samples [t0*hop + offset, + span) into raw (zeros past
    // N), one pad word after every hop samples: frame f's tap n sits at
    // f*(hop+1) + n + n/hop, so 32 frames' taps n hit 32 banks
    auto fetch = [&](int tile) {
        const int b = tile / ntf;
        const long long base = (long long)(tile - b * ntf) * TF * hop + offset;
        const float* row = wav + (size_t)b * N;
        for (int i = tid, q = tid / hop, r = tid % hop; i < span;
             i += THREADS) {
            const long long n = base + i;
            cp_async4(raw + i + q, n < N ? row + n : row, n < N);
            q += THREADS / hop;                 // q = i / hop, r = i % hop
            r += THREADS % hop;
            if (r >= hop) {
                r -= hop;
                ++q;
            }
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    };
    if (blockIdx.x < ntile) fetch(blockIdx.x);
    for (int i = tid; i < 3 * nmels; i += THREADS) midx[i] = mel_idx[i];
    for (int i = tid; i < nmw; i += THREADS) mw[i] = mel_w[i];
    // (cos, sin) of the bins the CUDA cores take
    for (int i = tid; i < win * nex; i += THREADS) {
        const int n = i / nex;
        const size_t o = (size_t)n * nbins + exbins[i - n * nex];
        ex[i] = make_float2(cosm[o], sinm[o]);
    }
    const int ext = TF * nex;                 // threads of that f32 pass

    for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
        const int b = tile / ntf;
        const int t0 = (tile - b * ntf) * TF;
        const int nf = min(TF, T - t0);
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
        if (tid >= THREADS - ext) {
            // ---- the lowest bins and the last one (those the filterbank
            //      uses) on the CUDA cores: f32 FMAs in tap order from the
            //      samples, and the power as re*re + im*im (no FMA): the
            //      plain version's arithmetic.  A thread takes one (frame,
            //      bin); a warp, 32 frames.  The last warps take it ----
            const int xt = tid - (THREADS - ext);
            const int f = xt % TF, e = xt / TF;
            const float* xr = raw + f * (hop + 1);
            const float2* w = ex + e;
            float re = 0.f, im = 0.f;
            for (int seg = 0; seg * hop < win; ++seg) {
                const int n1 = min(win, (seg + 1) * hop);
#pragma unroll 4
                for (int n = seg * hop; n < n1; ++n) {
                    const float x = xr[n + seg];
                    const float2 c = w[n * nex];
                    re = fmaf(x, c.x, re);
                    im = fmaf(x, c.y, im);
                }
            }
            pw[f * ps + exbins[e]] =
                __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        } else {
            // ---- split the samples into a TF32 hi and the exact rest (hi +
            //      lo is the sample); padded rows ----
            const int i0 = tid, di = THREADS - ext;
            for (int i = i0, q = i0 / hop, r = i0 % hop; i < span; i += di) {
                const float x = raw[i + q];
                const float hi = tf32_rna(x);
                xs[i + q * SK] = make_float2(hi, x - hi);
                q += di / hop;                  // q = i / hop, r = i % hop
                r += di % hop;
                if (r >= hop) {
                    r -= hop;
                    ++q;
                }
            }
        }
        __syncthreads();
        if (tile + gridDim.x < ntile) fetch(tile + gridDim.x);

        // ---- DFT of bins 0 .. nbins-2 on the tensor cores ----
        const int ntiles = ngroups * NPG;
        const int mh = warp & 1;                  // frame half of this warp
        for (int grp = warp >> 1; grp < ngroups; grp += WARPS / 2) {
            float acc[MW][NPG][4], accs[MW][NPG][4];
#pragma unroll
            for (int m = 0; m < MW; ++m)
#pragma unroll
                for (int j = 0; j < NPG; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[m][j][e] = accs[m][j][e] = 0.f;

            const float4* bp = bfrag + (size_t)grp * NPG * 32 + lane;
            const int bstep = ntiles * 32;
            float4 bq[PF][NPG];
#pragma unroll
            for (int q = 0; q < PF; ++q)
#pragma unroll
                for (int j = 0; j < NPG; ++j)
                    bq[q][j] = __ldg(bp + q * bstep + j * 32);
            // taps n0 = 8s + tig and n0 + 4 (segment = tap / hop)
            int n0 = tig, seg0 = 0;
            const float2* xw = xs + ((mh * MW) * 16 + g) * rs;
            for (int s = 0; s < ksteps; s += PF) {
#pragma unroll
                for (int q = 0; q < PF; ++q) {
                    float2 x[MW][4];
                    load_a(x, xw, rs, hop, n0, seg0);
                    mma3(acc, accs, x, bq[q]);
                    // refill this slot with k-step s + q + PF (the table is
                    // padded with zero k-steps past the end)
#pragma unroll
                    for (int j = 0; j < NPG; ++j)
                        bq[q][j] = __ldg(bp + (s + q + PF) * bstep
                                         + j * 32);
                }
            }
            // re, im of bin (nt*4 + tig) sit in acc[.][.][0,1] (row g) and
            // acc[.][.][2,3] (row g + 8), plus the small terms in accs
#pragma unroll
            for (int j = 0; j < NPG; ++j) {
                const int bin = (grp * NPG + j) * 4 + tig;
                if (bin >= NX && bin < nbins - 1) {
#pragma unroll
                    for (int m = 0; m < MW; ++m) {
                        float a[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            a[e] = acc[m][j][e] + accs[m][j][e];
                        const int fr = (mh * MW + m) * 16 + g;
                        pw[fr * ps + bin] = a[0] * a[0] + a[1] * a[1];
                        pw[(fr + 8) * ps + bin] = a[2] * a[2] + a[3] * a[3];
                    }
                }
            }
        }
        __syncthreads();

        // ---- mel over each filter's nonzero bins, eps floor, log ----
        // lanes take frames, so a warp runs one filter (one bin count) and
        // reads its weights by broadcast; rows go to ob (stride nmels + 1)
        {
            const int f = tid % TF;
            for (int m = tid / TF; m < nmels; m += THREADS / TF) {
                const int lo = midx[m], cnt = midx[nmels + m];
                const float* p = pw + f * ps + lo;
                const float* w = mw + midx[2 * nmels + m];
                float acc = 0.f;
                for (int k = 0; k < cnt; ++k) acc = fmaf(p[k], w[k], acc);
                acc = (acc == 0.f) ? eps : acc;
                ob[f * (nmels + 1) + m] = logf(acc);
            }
        }
        __syncthreads();
        // the tile's rows are one contiguous run of the output
        float* dst = out + ((size_t)b * T + t0) * nmels;
        for (int o = tid, f = tid / nmels, m = tid % nmels; o < nf * nmels;
             o += THREADS) {
            dst[o] = ob[f * (nmels + 1) + m];
            f += THREADS / nmels;
            m += THREADS % nmels;
            if (m >= nmels) {
                m -= nmels;
                ++f;
            }
        }
    }
}

}  // namespace

// wav [B, N] (pre-emphasized); bfrag: the split DFT table in fragment order
// [ksteps + 1][ngroups * 4][32] float4; cosm/sinm [win, nbins]; mel_w [nmw]
// packed filter weights, mel_idx [3][nmels] (first bin, bin count, offset
// into mel_w); exbins [nex]: the bins below NX and the last bin that the
// filters use, done in f32 on the CUDA cores -> out [B, T, nmels].  All
// contiguous, on the current device.
ASR_API int asr_logmel(const float* wav, const void* bfrag, const float* cosm,
                       const float* sinm, const float* mel_w,
                       const int* mel_idx, const int* exbins, float* out,
                       int B, int N, int T, int win, int hop, int offset,
                       int ksteps, int ngroups, int nbins, int nmels, int nmw,
                       int nex, float eps, void* stream) {
    if (B <= 0 || T <= 0) return 0;
    if (hop < 8 || ksteps % PF || ksteps * 8 < win || nbins <= NX ||
        nex < 0 || nex > NX + 1 ||
        (nbins - 1) > ngroups * NPG * 4)
        return (int)cudaErrorInvalidValue;
    const int span = (TF - 1) * hop + ksteps * 8;
    const int xs_len = (span + (span / hop + 1) * SK + 1) & ~1;
    const int raw_len = span + span / hop + 1;
    if ((size_t)xs_len * 2 < (size_t)TF * (nmels + 1))
        return (int)cudaErrorInvalidValue;   // ob aliases xs
    int ps = (nbins + 31) / 32 * 32 + 1;      // power row stride: 1 mod 32
    const size_t smem = (size_t)xs_len * sizeof(float2)
                        + ((size_t)raw_len + TF * ps + 2 * win * (NX + 1)
                           + 3 * nmels + nmw) * sizeof(float);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    int rc = asr_allow_smem(logmel_tc_kernel, smem);
    if (rc) return rc;
    int dev = 0, sms = 0;
    rc = (int)cudaGetDevice(&dev);
    if (rc) return rc;
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
    const int ntile = B * ((T + TF - 1) / TF);
    logmel_tc_kernel<<<min(ntile, sms), THREADS, smem, (cudaStream_t)stream>>>(
        wav, (const float4*)bfrag, cosm, sinm, mel_w, mel_idx, exbins, out, B,
        N, T, win, hop, offset, ksteps, ngroups, nbins, nmels, nmw, nex, eps,
        span, xs_len, raw_len, ps);
    return (int)cudaGetLastError();
}
