// K2-bwd: the backward of K2, the bidirectional LSTM time loop, for Hopper
// (sm_90a).
//
// JAX trains through its Pallas loop (chinese_asr_tpu/ops/pallas/lstm.py:142)
// with a custom_vjp whose backward takes the VJP of the same recurrence as a
// lax.scan (chinese_asr_tpu/ops/rnn.py:295-297, `_bidir_core_bwd` of
// `_bidir_core_scan`); this kernel is that VJP's serial part.  Per direction
// (the backward one arrives time-flipped, as K2 took it), with K2's step
//   a = xg_t + h @ W_hh;  i, f, o = sig(a_i, a_f, a_o), g = tanh(a_g)
//   c2 = f c + i g;  y = o tanh(c2) m;  h <- y + (1-m) h;  c <- m c2 + (1-m) c
// and the cotangents gy_t of ys and ghT, gcT of the final state:
//
// 1. forward in time: h_{t-1} is rebuilt from ys and the masks (not from a
//    second run of the recurrence: h_t = y_t + (1-m_t) h_{t-1}, so the masks
//    need not be prefix masks), the gates are recomputed from it and c is
//    rolled forward.  h_{t-1} and c_{t-1} go to scratch (hs, cs), the
//    activated gates into dxg, which the second pass overwrites in place;
// 2. backward in time from dh = ghT, dc = gcT:
//      dy = gy_t + dh;  dh2 = dy m;  dc2 = m dc + dh2 o (1 - tanh(c2)^2)
//      dxg_t = (dc2 g i(1-i), dc2 c_{t-1} f(1-f), dc2 i (1-g^2),
//               dh2 tanh(c2) o(1-o))
//      dc <- (1-m) dc + dc2 f;  dh <- (1-m) dh + dxg_t @ W_hh^T
//    (a masked step passes dh and dc through unchanged).
// dW_hh = sum_t h_{t-1}^T dxg_t is not serial: the wrapper forms it as one
// batched product of hs and dxg (ops/cuda/lstm.py), as the scan's VJP does.
//
// What bounds it: like K2, the recurrence is serial in T and each step needs
// all of W_hh.  Counted against the card, the work is three products of
// 2 * 4H * H flops per valid (row, step) (the gate recompute, dh's product
// and dW's), 0.38 ms at the f32 rate at [332, 32, 256] with 75 % of the
// steps valid; in practice each step of this simple kernel is bound by
// issuing its FMAs and shared-memory loads on the few SMs its batch tiles
// occupy, and by W_hh's re-read from L2 (1 MiB per direction at H=256).
//
// Design: K2's simple persistent kernel (csrc/lstm.cu `bilstm_kernel`), one
// for every H <= 1024: grid = (batch tiles of R rows) x (2 directions), KS
// threads a hidden unit j (KS = 4 up to H=256, 2 up to 512, 1 above, so
// that a block has at most 1024 threads; R = min(KS, 2)).  Thread (q, j)
// sums every KS-th k of the step's products for all R rows, the KS partial
// sums meet in shared memory, and thread (q, j) finishes row q < R: its h,
// c (pass 1) and dh, dc (pass 2) stay in its registers.  The shared row
// tile carries h_{t-1} (pass 1) or dxg_t (pass 2, read as float4) to every
// thread; pass 1 reads W_hh a column j of each gate, pass 2 its transpose
// [4H, H] (passed by the wrapper) a column j, so both reads are coalesced.
// Plain f32 FMAs; two block barriers a step.  No block waits on another.
// Splitting k over KS threads puts 32 warps on an SM at H=256, which hides
// the L2 latency of W_hh's reads that 8 warps (one thread a j) could not;
// 2 rows a block, not 1 or 4, balance the FMAs each SM issues a step
// against the SMs the grid fills (PERF.md, Findings).  Left for later: the
// cluster / tensor-core design of K2's `bilstm_tc_kernel` (W_hh resident
// in registers across a cluster).
#include "common.cuh"

#include <math.h>

namespace {

__device__ __forceinline__ float sigm(float x) {
    return 1.f / (1.f + expf(-x));
}

// A block holds R batch rows and KS >= R threads a hidden unit j: thread
// (q, j) sums every KS-th k of the step's products for all R rows, and
// finishes row q < R (its h, c in pass 1 and dh, dc in pass 2 stay in its
// registers).
template <int KS, int R>
__global__ void __launch_bounds__(1024)
bilstm_bwd_kernel(const float* __restrict__ xg_f,
                  const float* __restrict__ xg_b,
                  const float* __restrict__ m_f,
                  const float* __restrict__ m_b,
                  const float* __restrict__ w_hh,
                  const float* __restrict__ w_t,
                  const float* __restrict__ ys_f,
                  const float* __restrict__ ys_b,
                  const float* __restrict__ gy_f,
                  const float* __restrict__ gy_b,
                  const float* __restrict__ ghT,
                  const float* __restrict__ gcT,
                  float* __restrict__ dxg,
                  float* __restrict__ hs,
                  float* __restrict__ cs,
                  int T, int B, int H) {
    // tile: h_{t-1} rows [R][H] (pass 1) or dxg_t rows [R][4H] (pass 2);
    // part: the KS partial sums, [KS][R][4][H] (pass 1) or [KS][R][H]
    extern __shared__ float4 smem4[];
    float* tile = reinterpret_cast<float*>(smem4);
    float* part = tile + R * 4 * H;
    const int Hp = (H + 31) / 32 * 32;
    const int q = threadIdx.x / Hp;
    const int j = threadIdx.x % Hp;
    const bool active = j < H;
    const int dir = blockIdx.y;
    const int b0 = blockIdx.x * R;
    const int nb = min(R, B - b0);
    const bool mine = active && q < nb;      // this thread's row is real
    const int H4 = 4 * H;
    const float* xg = dir ? xg_b : xg_f;
    const float* mk = dir ? m_b : m_f;
    const float* ys = dir ? ys_b : ys_f;
    const float* gy = dir ? gy_b : gy_f;
    const float* W = w_hh + (size_t)dir * H * H4;
    const float* WT = w_t + (size_t)dir * H4 * H;
    float* dx = dxg + (size_t)dir * T * B * H4;
    float* hq = hs + (size_t)dir * T * B * H;
    float* cq = cs + (size_t)dir * T * B * H;

    // ---- pass 1: forward in time ---------------------------------------
    float h = 0.f, c = 0.f;
    for (int t = 0; t < T; ++t) {
        const size_t row = (size_t)t * B + b0 + q;
        if (active) {
            if (mine) {
                hq[row * H + j] = h;
                cq[row * H + j] = c;
            }
            if (q < R) tile[q * H + j] = h;
        }
        __syncthreads();
        if (active) {
            float acc[R][4];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                const float* x = xg + ((size_t)t * B + b0 + b) * H4 + j;
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    acc[b][g] = (q == 0 && b < nb) ? x[g * H] : 0.f;
            }
            const float* wj = W + j;
#pragma unroll 2
            for (int k = q; k < H; k += KS) {
                const float* wr = wj + (size_t)k * H4;
                const float w0 = __ldg(wr);
                const float w1 = __ldg(wr + H);
                const float w2 = __ldg(wr + 2 * H);
                const float w3 = __ldg(wr + 3 * H);
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    const float hv = tile[b * H + k];
                    acc[b][0] = fmaf(hv, w0, acc[b][0]);
                    acc[b][1] = fmaf(hv, w1, acc[b][1]);
                    acc[b][2] = fmaf(hv, w2, acc[b][2]);
                    acc[b][3] = fmaf(hv, w3, acc[b][3]);
                }
            }
#pragma unroll
            for (int b = 0; b < R; ++b)
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    part[((q * R + b) * 4 + g) * H + j] = acc[b][g];
        }
        __syncthreads();
        if (mine) {
            float a[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                a[g] = part[(q * 4 + g) * H + j];
#pragma unroll
                for (int p = 1; p < KS; ++p)
                    a[g] += part[((p * R + q) * 4 + g) * H + j];
            }
            const float ig = sigm(a[0]);
            const float fg = sigm(a[1]);
            const float gg = tanhf(a[2]);
            const float og = sigm(a[3]);
            const float m = mk[row];
            c = m * (fg * c + ig * gg) + (1.f - m) * c;
            h = ys[row * H + j] + (1.f - m) * h;
            float* d = dx + row * H4 + j;
            d[0] = ig;
            d[H] = fg;
            d[2 * H] = gg;
            d[3 * H] = og;
        }
    }

    // ---- pass 2: backward in time --------------------------------------
    float dh = 0.f, dc = 0.f;
    if (mine) {
        const size_t o = ((size_t)dir * B + b0 + q) * H + j;
        dh = ghT[o];
        dc = gcT[o];
    }
    const float4* tile4 = smem4;
    for (int t = T - 1; t >= 0; --t) {
        if (active) {
            float da[4] = {0.f, 0.f, 0.f, 0.f};
            if (mine) {
                const size_t row = (size_t)t * B + b0 + q;
                const float m = mk[row];
                const float cp = cq[row * H + j];
                float* d = dx + row * H4 + j;
                const float ig = d[0], fg = d[H], gg = d[2 * H],
                            og = d[3 * H];
                const float tc = tanhf(fg * cp + ig * gg);
                const float dh2 = (gy[row * H + j] + dh) * m;
                const float dc2 = m * dc + dh2 * og * (1.f - tc * tc);
                da[0] = dc2 * gg * ig * (1.f - ig);
                da[1] = dc2 * cp * fg * (1.f - fg);
                da[2] = dc2 * ig * (1.f - gg * gg);
                da[3] = dh2 * tc * og * (1.f - og);
#pragma unroll
                for (int g = 0; g < 4; ++g) d[g * H] = da[g];
                dc = (1.f - m) * dc + dc2 * fg;
                dh = (1.f - m) * dh;
            }
            if (q < R) {
#pragma unroll
                for (int g = 0; g < 4; ++g) tile[q * H4 + g * H + j] = da[g];
            }
        }
        __syncthreads();
        if (active) {
            // this thread's share of dxg_t @ W_hh^T: every KS-th group of
            // four k (4H is a multiple of 4, so the tile reads as float4)
            float p[R];
#pragma unroll
            for (int b = 0; b < R; ++b) p[b] = 0.f;
            const float* wj = WT + j;
#pragma unroll 1
            for (int k4 = q; k4 < H; k4 += KS) {
                const float* wr = wj + (size_t)(4 * k4) * H;
                const float w0 = __ldg(wr);
                const float w1 = __ldg(wr + H);
                const float w2 = __ldg(wr + 2 * H);
                const float w3 = __ldg(wr + 3 * H);
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    const float4 s = tile4[b * H + k4];
                    float v = fmaf(s.x, w0, p[b]);
                    v = fmaf(s.y, w1, v);
                    v = fmaf(s.z, w2, v);
                    p[b] = fmaf(s.w, w3, v);
                }
            }
#pragma unroll
            for (int b = 0; b < R; ++b) part[(q * R + b) * H + j] = p[b];
        }
        __syncthreads();
        if (mine) {
            float s = part[q * H + j];
#pragma unroll
            for (int p = 1; p < KS; ++p) s += part[(p * R + q) * H + j];
            dh += s;
        }
    }
}

template <int KS, int R>
int bwd_launch(const float* const* in, float* dxg, float* hs, float* cs,
               int T, int B, int H, cudaStream_t s) {
    const size_t smem = (size_t)(R * 4 * H + KS * R * 4 * H) * sizeof(float);
    const int rc = asr_allow_smem(bilstm_bwd_kernel<KS, R>, smem);
    if (rc) return rc;
    const int threads = KS * ((H + 31) / 32 * 32);
    const dim3 grid((B + R - 1) / R, 2);
    bilstm_bwd_kernel<KS, R><<<grid, threads, smem, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], dxg, hs, cs, T, B, H);
    return (int)cudaGetLastError();
}

}  // namespace

// xg_f, xg_b [T, B, 4H]; m_f, m_b [T, B]; w_hh [2, H, 4H] and its transpose
// w_t [2, 4H, H]; ys_f, ys_b and their cotangents gy_f, gy_b [T, B, H];
// the final state's cotangents ghT, gcT [2, B, H] ->
// dxg [2, T, B, 4H] (the gate cotangents, = d xg), hs [2, T, B, H] (the
// carried h_{t-1} of each step, for dW_hh), cs [2, T, B, H] (scratch).  All
// float32 and contiguous; any H <= 1024.  Returns 0 or a cudaError_t.
ASR_API int asr_bilstm_bwd(const float* xg_f, const float* xg_b,
                           const float* m_f, const float* m_b,
                           const float* w_hh, const float* w_t,
                           const float* ys_f, const float* ys_b,
                           const float* gy_f, const float* gy_b,
                           const float* ghT, const float* gcT, float* dxg,
                           float* hs, float* cs, int T, int B, int H,
                           void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (H > 1024) return (int)cudaErrorInvalidValue;
    const float* in[12] = {xg_f, xg_b, m_f, m_b, w_hh, w_t,
                           ys_f, ys_b, gy_f, gy_b, ghT, gcT};
    const cudaStream_t s = (cudaStream_t)stream;
    const int Hp = (H + 31) / 32 * 32;
    // KS threads a hidden unit, as many as 1024 threads a block allow (up
    // to 4), and R = min(KS, 2) rows a block
    if (Hp <= 256) return bwd_launch<4, 2>(in, dxg, hs, cs, T, B, H, s);
    if (Hp <= 512) return bwd_launch<2, 2>(in, dxg, hs, cs, T, B, H, s);
    return bwd_launch<1, 1>(in, dxg, hs, cs, T, B, H, s);
}
