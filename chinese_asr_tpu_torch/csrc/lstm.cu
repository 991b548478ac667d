// K2: bidirectional LSTM time loop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/lstm.py
// (`_kernel`, launched by `bidir_lstm_time_loop`): both directions'
// T-step recurrence of one encoder layer,
//   gates = xg_t + h @ W_hh  (i, f, g, o order)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c');  y = h' m
//   h <- y + (1 - m) h;  c <- m c' + (1 - m) c   (mask freezes the carry)
// The input projections xg = x @ W_ih + b are precomputed outside (one
// large matmul per direction), the backward direction already flipped in
// time, so its outputs come back in that flipped order.
//
// What bounds it on the H100: the recurrence is serial in T, and every
// step needs all of W_hh (H x 4H f32: 1 MiB per direction at H=256).
// That is far over the 227 KB of shared memory a block can hold, so the
// TPU design (weights resident in VMEM) does not carry over to one block.
// Counted against the card, the layer is bound by its 2 * 2 * T * B * H *
// 4H flops at the f32 rate; in practice each step is bound by where W_hh
// is read from and by one synchronisation per step.
//
// Two kernels, one contract:
//
// * `bilstm_cluster_kernel` (H a multiple of 64 whose weight slices fit
//   shared memory; the flagship H=256): a thread-block cluster of 8 CTAs
//   shares one direction and one tile of 16 batch rows.  CTA r owns hidden
//   units [r*H/8, (r+1)*H/8): it keeps their 4 gate columns of W_hh
//   (H x 4H/8 f32 = 128 KB at H=256) in shared memory for the whole T loop,
//   so W_hh is read from device memory once per launch instead of once per
//   step.  Each step a CTA computes its units' gates for the 16 rows,
//   updates c (registers) and h, and writes its slice of the new h into
//   every CTA of the cluster through distributed shared memory; one
//   cluster barrier per step publishes it (h is double-buffered, so one
//   barrier suffices).  Thread (unit u, row group) accumulates the 4
//   gates of u for 4 rows: per k one float4 of W and one float4 of h feed
//   16 FMAs, and a warp's loads are one shared-memory wavefront each.
// * `bilstm_kernel` (any other H <= 1024): the simple persistent kernel,
//   grid = (batch tiles of 8 rows) x (2 directions); each block owns its
//   rows' h (shared memory) and c (registers) for the whole loop and
//   re-reads W_hh from L2 every step.  Its step time is the latency of
//   those L2 reads with few warps per SM.
//
// No block ever waits on a block outside its cluster.
//
// Where the cluster kernel's step time goes at H=256 (about 10 us): each
// warp's float4 shared-memory loads take 4 wavefronts, so the four row
// groups re-read the 128 KB weight slice 4 times per step (about 8k
// wavefront cycles per SM against 4k FMA cycles per SM sub-partition),
// plus the transcendentals and the cluster barrier.  The card also holds
// only 15 such clusters at once, so B=128 (16 clusters) runs in two waves.
// Later, faster designs: split k across the warps (each thread then keeps
// all 16 rows of one unit, 4x fewer loads per FMA) with a shared-memory
// reduction of the partial gates; tensor-core products (3xTF32 to keep
// f32 accuracy); smaller shared-memory slices so two CTAs share an SM.
#include "common.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid(float x) {
    return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// cluster kernel
// ---------------------------------------------------------------------------
constexpr int CL = 8;           // CTAs per cluster (portable maximum)
constexpr int CBT = 16;         // batch rows per cluster
constexpr int RG = 4;           // rows per thread: one float4 of h
constexpr int NRG = CBT / RG;   // row groups per CTA
constexpr int UW = 32 / NRG;    // hidden units per warp

// One cluster barrier split in two halves: arrive publishes this thread's
// prior writes (the distributed-shared-memory stores of h) to the cluster,
// wait makes every other thread's visible here.
__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

size_t cluster_smem(int H) {
    // W slice [H][H/CL] float4 + h [2][H][NRG] float4
    return ((size_t)H * (H / CL) + (size_t)2 * H * NRG) * sizeof(float4);
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(256)
bilstm_cluster_kernel(const float* __restrict__ xg_f,
                      const float* __restrict__ xg_b,
                      const float* __restrict__ m_f,
                      const float* __restrict__ m_b,
                      const float* __restrict__ w_hh,
                      float* __restrict__ ys_f,
                      float* __restrict__ ys_b,
                      float* __restrict__ hT,
                      float* __restrict__ cT,
                      int T, int B, int H) {
    extern __shared__ float4 smem4[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int HU = H / CL;                      // units of this CTA
    const int H4 = 4 * H;
    const int dir = blockIdx.y;
    const int b0 = (blockIdx.x / CL) * CBT;
    const int lane = threadIdx.x & 31;
    const int u = (threadIdx.x >> 5) * UW + lane % UW;
    const int rg = lane / UW;
    const int ug = rank * HU + u;               // global hidden unit
    const float* xg = dir ? xg_b : xg_f;
    const float* mk = dir ? m_b : m_f;
    float* ys = dir ? ys_b : ys_f;
    const float* W = w_hh + (size_t)dir * H * H4;

    float4* ws = smem4;                         // [H][HU]: (i,f,g,o) at k
    float4* hs = smem4 + (size_t)H * HU;        // [2][H][NRG]: 4 rows of h_k
    float* wsf = reinterpret_cast<float*>(ws);
    for (int i = threadIdx.x; i < H * 4 * HU; i += blockDim.x) {
        const int k = i / (4 * HU);
        const int r = i - k * 4 * HU;
        const int g = r / HU;
        const int uu = r - g * HU;
        wsf[((size_t)k * HU + uu) * 4 + g] =
            W[(size_t)k * H4 + g * H + rank * HU + uu];
    }
    for (int i = threadIdx.x; i < 2 * H * NRG; i += blockDim.x)
        hs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // every CTA's buffers are zero (and its W slice staged) before any
    // CTA of the cluster writes into them
    cluster.sync();

    int row[RG];
    bool valid[RG];
    float h[RG], c[RG], nx[RG][4], nm[RG];
#pragma unroll
    for (int j = 0; j < RG; ++j) {
        row[j] = b0 + rg * RG + j;
        valid[j] = row[j] < B;
        h[j] = 0.f;
        c[j] = 0.f;
        nm[j] = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) nx[j][g] = 0.f;
        if (valid[j] && T > 0) {
            const float* x = xg + (size_t)row[j] * H4 + ug;
#pragma unroll
            for (int g = 0; g < 4; ++g) nx[j][g] = x[g * H];
            nm[j] = mk[row[j]];
        }
    }

    int cur = 0;
    for (int t = 0; t < T; ++t) {
        float acc[RG][4], m[RG], y[RG];
#pragma unroll
        for (int j = 0; j < RG; ++j) {
            m[j] = nm[j];
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[j][g] = nx[j][g];
        }
        if (t + 1 < T) {                        // prefetch the next step
#pragma unroll
            for (int j = 0; j < RG; ++j) {
                if (valid[j]) {
                    const float* x =
                        xg + ((size_t)(t + 1) * B + row[j]) * H4 + ug;
#pragma unroll
                    for (int g = 0; g < 4; ++g) nx[j][g] = x[g * H];
                    nm[j] = mk[(size_t)(t + 1) * B + row[j]];
                }
            }
        }
        const float4* hc = hs + (size_t)cur * H * NRG;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
            const float4 w = ws[(size_t)k * HU + u];
            const float4 hv = hc[k * NRG + rg];
            const float hr[RG] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int j = 0; j < RG; ++j) {
                acc[j][0] = fmaf(hr[j], w.x, acc[j][0]);
                acc[j][1] = fmaf(hr[j], w.y, acc[j][1]);
                acc[j][2] = fmaf(hr[j], w.z, acc[j][2]);
                acc[j][3] = fmaf(hr[j], w.w, acc[j][3]);
            }
        }
#pragma unroll
        for (int j = 0; j < RG; ++j) {
            const float ig = sigmoid(acc[j][0]);
            const float fg = sigmoid(acc[j][1]);
            const float gg = tanhf(acc[j][2]);
            const float og = sigmoid(acc[j][3]);
            const float c2 = fg * c[j] + ig * gg;
            const float h2 = og * tanhf(c2);
            y[j] = h2 * m[j];
            h[j] = y[j] + (1.f - m[j]) * h[j];
            c[j] = m[j] * c2 + (1.f - m[j]) * c[j];
        }
        // publish this CTA's slice of the new h to the whole cluster, then
        // store y while the barrier completes: a global store issued just
        // before the release would have to drain before it
        const float4 hn = make_float4(h[0], h[1], h[2], h[3]);
        float4* dst = hs + (size_t)(cur ^ 1) * H * NRG + ug * NRG + rg;
#pragma unroll
        for (int q = 0; q < CL; ++q) *cluster.map_shared_rank(dst, q) = hn;
        cluster_arrive_release();
#pragma unroll
        for (int j = 0; j < RG; ++j)
            if (valid[j]) ys[((size_t)t * B + row[j]) * H + ug] = y[j];
        cluster_wait_acquire();
        cur ^= 1;
    }

#pragma unroll
    for (int j = 0; j < RG; ++j) {
        if (valid[j]) {
            const size_t o = ((size_t)dir * B + row[j]) * H + ug;
            hT[o] = h[j];
            cT[o] = c[j];
        }
    }
}

bool cluster_fits(int H) {
    return H % (CL * UW) == 0 && cluster_smem(H) <= 232448;
}

// ---------------------------------------------------------------------------
// simple per-block kernel
// ---------------------------------------------------------------------------
constexpr int BT = 8;  // batch rows per block

__global__ void bilstm_kernel(const float* __restrict__ xg_f,
                              const float* __restrict__ xg_b,
                              const float* __restrict__ m_f,
                              const float* __restrict__ m_b,
                              const float* __restrict__ w_hh,
                              float* __restrict__ ys_f,
                              float* __restrict__ ys_b,
                              float* __restrict__ hT,
                              float* __restrict__ cT,
                              int T, int B, int H) {
    extern __shared__ float hs[];  // [2][BT][H]
    const int dir = blockIdx.y;
    const int b0 = blockIdx.x * BT;
    const int nb = min(BT, B - b0);
    const int j = threadIdx.x;
    const bool active = j < H;
    const int H4 = 4 * H;
    const float* xg = dir ? xg_b : xg_f;
    const float* mk = dir ? m_b : m_f;
    float* ys = dir ? ys_b : ys_f;
    const float* W = w_hh + (size_t)dir * H * H4;

    for (int i = threadIdx.x; i < 2 * BT * H; i += blockDim.x) hs[i] = 0.f;

    float h[BT], c[BT], nx[BT][4], nm[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) {
        h[b] = 0.f;
        c[b] = 0.f;
        nm[b] = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) nx[b][g] = 0.f;
    }
    // prefetch step 0
    if (active && T > 0) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
            if (b < nb) {
                const float* x = xg + ((size_t)b0 + b) * H4 + j;
#pragma unroll
                for (int g = 0; g < 4; ++g) nx[b][g] = x[g * H];
                nm[b] = mk[b0 + b];
            }
        }
    }
    __syncthreads();

    int cur = 0;
    for (int t = 0; t < T; ++t) {
        const float* hcur = hs + cur * BT * H;
        float* hnext = hs + (cur ^ 1) * BT * H;
        float acc[BT][4], m[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
            m[b] = nm[b];
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[b][g] = nx[b][g];
        }
        if (active) {
            if (t + 1 < T) {
#pragma unroll
                for (int b = 0; b < BT; ++b) {
                    if (b < nb) {
                        const float* x =
                            xg + ((size_t)(t + 1) * B + b0 + b) * H4 + j;
#pragma unroll
                        for (int g = 0; g < 4; ++g) nx[b][g] = x[g * H];
                        nm[b] = mk[(size_t)(t + 1) * B + b0 + b];
                    }
                }
            }
            const float* wj = W + j;
#pragma unroll 4
            for (int kk = 0; kk < H; ++kk) {
                const float* wr = wj + (size_t)kk * H4;
                const float w0 = __ldg(wr);
                const float w1 = __ldg(wr + H);
                const float w2 = __ldg(wr + 2 * H);
                const float w3 = __ldg(wr + 3 * H);
#pragma unroll
                for (int b = 0; b < BT; ++b) {
                    const float hv = hcur[b * H + kk];
                    acc[b][0] = fmaf(hv, w0, acc[b][0]);
                    acc[b][1] = fmaf(hv, w1, acc[b][1]);
                    acc[b][2] = fmaf(hv, w2, acc[b][2]);
                    acc[b][3] = fmaf(hv, w3, acc[b][3]);
                }
            }
#pragma unroll
            for (int b = 0; b < BT; ++b) {
                if (b < nb) {
                    const float ig = sigmoid(acc[b][0]);
                    const float fg = sigmoid(acc[b][1]);
                    const float gg = tanhf(acc[b][2]);
                    const float og = sigmoid(acc[b][3]);
                    const float c2 = fg * c[b] + ig * gg;
                    const float h2 = og * tanhf(c2);
                    const float y = h2 * m[b];
                    h[b] = y + (1.f - m[b]) * h[b];
                    c[b] = m[b] * c2 + (1.f - m[b]) * c[b];
                    ys[((size_t)t * B + b0 + b) * H + j] = y;
                    hnext[b * H + j] = h[b];
                }
            }
        }
        __syncthreads();
        cur ^= 1;
    }

    if (active) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
            if (b < nb) {
                const size_t o = ((size_t)dir * B + b0 + b) * H + j;
                hT[o] = h[b];
                cT[o] = c[b];
            }
        }
    }
}

}  // namespace

// xg_f, xg_b [T, B, 4H]; m_f, m_b [T, B]; w_hh [2, H, 4H] ->
// ys_f, ys_b [T, B, H]; hT, cT [2, B, H].  All float32 and contiguous.
// H alone picks the kernel: the cluster kernel where it fits, else the
// simple one.
ASR_API int asr_bilstm(const float* xg_f, const float* xg_b, const float* m_f,
                       const float* m_b, const float* w_hh, float* ys_f,
                       float* ys_b, float* hT, float* cT, int T, int B, int H,
                       void* stream) {
    if (B <= 0 || H <= 0) return 0;
    if (H > 1024) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (cluster_fits(H)) {
        const size_t smem = cluster_smem(H);
        const int rc = asr_allow_smem(bilstm_cluster_kernel, smem);
        if (rc) return rc;
        const dim3 grid((B + CBT - 1) / CBT * CL, 2);
        bilstm_cluster_kernel<<<grid, H / CL * NRG, smem, s>>>(
            xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, hT, cT, T, B, H);
        return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)2 * BT * H * sizeof(float);
    const int rc = asr_allow_smem(bilstm_kernel, smem);
    if (rc) return rc;
    const int threads = (H + 31) / 32 * 32;
    const dim3 grid((B + BT - 1) / BT, 2);
    bilstm_kernel<<<grid, threads, smem, s>>>(
        xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, hT, cT, T, B, H);
    return (int)cudaGetLastError();
}
