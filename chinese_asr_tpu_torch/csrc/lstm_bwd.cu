// K2-bwd: the backward of K2, the bidirectional LSTM time loop, for Hopper
// (sm_90a).
//
// JAX trains through its Pallas loop (chinese_asr_tpu/ops/pallas/lstm.py:142)
// with a custom_vjp whose backward takes the VJP of the same recurrence as a
// lax.scan (chinese_asr_tpu/ops/rnn.py:297, `_bidir_core_bwd` of
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
// steps valid; in practice each step is bound by the latency of one
// product on the few SMs a row tile uses and by one synchronisation.
//
// Two kernels, one contract; H alone picks, as in K2:
//
// * `bilstm_bwd_tc_kernel` (H in {64, 128, 192, 256}; the flagship 256):
//   K2's cluster / tensor-core plan.  One cluster of 8 CTAs (256 threads)
//   per direction and tile of 16 or 32 batch rows (B alone picks, by K2's
//   rule, tc.cuh `tc_mtiles`); CTA r owns hidden units [r*H/8, (r+1)*H/8)
//   and their 4 gate columns.  Its W_hh slice (128 KB at H=256) stays in
//   registers as the B fragments of `mma.m16n8k8` (128 a thread), the
//   products are 3xTF32 (f32 accuracy), as in K2 (the f32 instance; the
//   bf16 one is below).
//   - Pass 1 needs no exchange: the rebuilt h does not depend on an earlier
//     product, so every CTA rebuilds the whole h_{t-1} of its rows in
//     shared memory (A-fragment order) from ys and the masks, prefetched a
//     step ahead with cp.async with xg_t, and multiplies it by its slice
//     (K2's product, warps = 2 k-halves x 4 column quarters).  Two block
//     barriers a step; no CTA waits on another.
//   - Pass 2, the serial part: the cell threads keep dh and dc of their
//     units in registers and form the CTA's [R, 4H/8] slice of dxg_t (pass
//     1's scratch of the step prefetched a step ahead).  dxg_t @ W_hh^T is
//     a reduce-scatter: warp w multiplies the slice by the [4H/8, H/8]
//     block of W_hh^T that feeds CTA w's units (the W registers reloaded at
//     the pass boundary) and stores its partial dh into CTA w's shared
//     memory; one cluster barrier a step, then the owner adds the 8
//     partials.  The bytes exchanged are K2's, and the product needs no
//     remote data, so nothing waits between the cell update and the
//     product but a block barrier.  The next step's prefetch goes between
//     the barrier's arrive and wait.  The other exchange, an all-gather of
//     dxg_t into every CTA (4x the bytes, the product behind the cluster
//     barrier, each CTA multiplying the whole dxg_t by the W_hh^T slice of
//     its own units), was built at H=256 and 16 rows and timed against
//     this one on an H100 80GB HBM3 at 700 W: 4.66 ms at [332, 32, 256]
//     against the reduce-scatter's 2.99 (PERF.md), its 64 remote 4-byte
//     stores a thread a step costing more than the bytes alone suggest.
//     It was then deleted.
//   Each thread of the cell role owns the same (row, unit) elements in both
//   passes, so pass 2 reads back only what it wrote in pass 1.
// * `bilstm_bwd_kernel` (any other H <= 1024; the golden model's 16): the
//   simple persistent kernel, grid = (batch tiles of R rows) x (2
//   directions), KS threads a hidden unit j (KS = 4 up to H=256, 2 up to
//   512, 1 above, so that a block has at most 1024 threads; R = min(KS,
//   2)).  Thread (q, j) sums every KS-th k of the step's products for all R
//   rows, the KS partial sums meet in shared memory, and thread (q, j)
//   finishes row q < R.  Pass 1 reads W_hh a column j of each gate, pass 2
//   its transpose [4H, H] (passed by the wrapper) a column j, both
//   coalesced, from L2 every step; plain f32 FMAs, two block barriers a
//   step.
//
// What bounds the cluster kernel: each step of either pass is one chain of
// 3xTF32 `mma.sync` (three a k8 step and tile; 192 a warp at H=256 and 16
// rows) behind the cell's exact expf / tanhf and a barrier, on the 8 SMs
// of a tile: 4.5 us a step at [332, 32, 256] (3.02 ms, 12 % of the bound,
// on the same H100), 8.8 us at 32 rows a cluster.  Left for later: `wgmma`
// for the products, a pipelined exchange (bulk copies completing on an
// mbarrier in place of the cluster barrier), and 16-CTA clusters so that
// one tile spreads over twice the SMs.
//
// The f32 tensor-core kernel below is float only (its template parameter
// E is float).
//
// K2-bwd-bf16 (bf16 training; JAX's bf16 backward is the VJP of its bf16
// scan, chinese_asr_tpu/ops/rnn.py:297 of :248, every op rounded to bf16).
// xg, the masks, W_hh, ys, the cotangents, dxg and the scratch hs and cs
// are bf16; the products are bf16 x bf16 with f32 accumulation
// (`mma.m16n8k16`); each step's arithmetic is f32; and the rounding points
// are
//   pass 1: c rounded at the end of each step, where K2-bf16 rounds it
//     (the rolled-forward c is the forward's, or an ulp from it where sums
//     run in another order); the activated gates rounded as they are kept
//     in dxg's buffer (JAX keeps them in bf16 too); h, rebuilt from ys and
//     0/1 masks, is exact;
//   pass 2: dxg_t rounded as it is stored, that rounded value the A
//     operand of dxg_t @ W_hh^T; the dh and dc carries rounded at the end
//     of each step (JAX's carry type).
// At H in {64, 128, 192, 256} pass 1 leaves the serial loop, since nothing
// in it but c's roll is serial: (a) `bilstm_bf16_rebuild_kernel` rebuilds
// hs; (b) the wrapper forms pre = hs @ W_hh for all T as one f32-result
// cuBLAS bmm (ops/cuda/lstm.py), as JAX leaves that product to XLA;
// (c) `bilstm_bf16_activate_kernel` activates the gates and rolls c.
// Pass 2 is `bilstm_bf16_bwd2_kernel` on K2-bf16's cluster plan.  The
// bytes of the f32 pre-activations (written by (b), read by (c): 2 x 87
// MB at [332, 32, 256]) are what a GEMM with (c)'s activation in its
// epilogue would save; c's roll needs the f32 activations of every step
// in order, so such an epilogue would still hand them to a serial pass.
// Other H run the simple kernel's bf16 instance.  dW_hh = hs^T dxg is
// accumulated in f32 and rounded once (the wrapper's product), where
// JAX's reverse scan carries it as a bf16 running sum over the T steps:
// at [332, 32, 256] the port's dW_hh is 4.2e-3 of its magnitude from a
// float64 VJP of the same bf16 inputs, JAX's 5.0e-2
// (tests/torch_port_bf16_gap.py).  Bound at [332, 32, 256] with 75 % of
// the steps valid: the bf16 bytes, 0.033 ms; the three products at the
// dense bf16 rate, 0.025 ms.
#include "common.cuh"
#include "stamp.cuh"
#include "tc.cuh"

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// phase sums of the measurement build (stamp.cuh; empty in the product)
STAMP_EXPORT(asr_stamp_bwd, asr_stamp_read_bwd, asr_stamp_ctas_bwd)

namespace {

// Two units' values: one float2 (f32) or one word of two bf16 (bf16, the
// first unit in the low half; st2 rounds to nearest).
__device__ __forceinline__ float2 unpack2(float2 v) { return v; }

__device__ __forceinline__ float2 unpack2(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ---------------------------------------------------------------------------
// tensor-core cluster kernel (CL, TC_THREADS and the helpers: tc.cuh)
// ---------------------------------------------------------------------------
constexpr int KG = 2;              // pass 1's warps: 2 k-halves x 4 column
constexpr int NG = 4;              // quarters (K2's product)

// The shapes of one instantiation: operand type E, hidden size H (a
// multiple of 64, at most 256) and MT m16 tiles of batch rows per cluster.
template <typename E, int H, int MT>
struct BwdShape {
    static constexpr int KSTEP = Elt<E>::KSTEP;  // k depth of one mma
    static constexpr int UC = H / CL;       // hidden units of one CTA
    static constexpr int COLS = 4 * UC;     // its gate columns (q*UC + u)
    static constexpr int R = 16 * MT;       // batch rows of one cluster
    // pass 1, K2's product h[R, H] @ W_hh[:, cols]: warps KG x NG
    static constexpr int KS = H / KSTEP;    // mma k-steps over h
    static constexpr int KPW = KS / KG;     // k-steps of one warp
    static constexpr int NPW = COLS / 8 / NG;   // n8 tiles of one warp
    static constexpr int PS = COLS + 8;     // partial-sum row stride
    // pass 2, dxg[R, cols] @ W_hh[units of CTA w, cols]^T on warp w
    static constexpr int KS2 = COLS / KSTEP;    // mma k-steps over the cols
    static constexpr int NTU = UC / 8;      // n8 tiles of one CTA's units
    // the cell role: slot (m, j, lane) of pass 2's accumulator fragments
    // holds rows g, g+8 of m-tile m by units 8j + 2c, 8j + 2c + 1; a
    // thread takes one row of a slot (PP = 2) or both (PP = 4)
    static constexpr int NSLOT = MT * NTU * 32;
    static constexpr int PP = 2 * NSLOT <= TC_THREADS ? 2 : 4;
    static constexpr int RP = PP / 2;       // rows of one cell thread
    static constexpr int NLT = NSLOT * 4 / PP;  // threads of the cell role
    static constexpr int HB = R * H;        // elements of one h buffer
    // ys tile row stride in elements (16-byte rows, no bank conflicts in
    // the rebuild)
    static constexpr int YS = H + 4;
    using P = float2;                       // a unit pair
    // shared memory, byte offsets.  Pass 1: h [2][HB] (A-fragment order),
    // part [KG][R][PS], ys [2][R][YS], masks [2][R], gates [2][RP*4][NLT]
    // (P).  Pass 2, over the same bytes: recv [2][CL][NSLOT] (float4
    // partials), the CTA's dxg slice [R][COLS] (A-fragment order),
    // prefetch [RP*6][NLT] (P), masks [RP][NLT].
    static constexpr size_t O_PART = (size_t)2 * HB * sizeof(E);
    static constexpr size_t O_YS = O_PART + (size_t)KG * R * PS * 4;
    static constexpr size_t O_MK = O_YS + (size_t)2 * R * YS * sizeof(E);
    static constexpr size_t O_XG = O_MK + (size_t)2 * R * 4;
    static constexpr size_t P1 = O_XG + (size_t)2 * RP * 4 * NLT * sizeof(P);
    static constexpr size_t O_AT = (size_t)2 * CL * NSLOT * 16;
    static constexpr size_t O_PF = O_AT + (size_t)R * COLS * sizeof(E);
    static constexpr size_t O_PM = O_PF + (size_t)RP * 6 * NLT * sizeof(P);
    static constexpr size_t P2 = O_PM + (size_t)RP * NLT * 4;
    static constexpr size_t SMEM = P1 > P2 ? P1 : P2;
    static_assert(H % 64 == 0 && KS % KG == 0 && NPW >= 1
                  && KPW == KS2 && NPW == NTU && NLT <= TC_THREADS
                  && O_XG % 16 == 0 && O_PF % 16 == 0 && SMEM <= 232448
                  && !Elt<E>::BF16, "shape");
};

// Index of element (row r, column k) of an [R, KSTEP*ks] operand kept in
// A-fragment order, so that a warp's A operand of one (m-tile, k-step) is
// one conflict-free 16-byte load a lane.  f32 (m16n8k8 tf32): for m-tile
// m, k8-step s and lane l = 4g + c the float4 (r g, k 8s+c), (g+8, 8s+c),
// (g, 8s+c+4), (g+8, 8s+c+4).  bf16 (m16n8k16, pass 2's dxg slice): for
// k16-step s the eight (g, 16s+2c), (g, 16s+2c+1), (g+8, 16s+2c),
// (g+8, 16s+2c+1), then the same at columns 16s+2c+8 and +9; units 2c and
// 2c+1 of a row are one word.
template <typename E, int KSTEPS>
__device__ __forceinline__ int afrag(int r, int k) {
    if constexpr (Elt<E>::BF16)
        return (((r >> 4) * KSTEPS + (k >> 4)) * 32 + (r & 7) * 4
                + ((k & 7) >> 1)) * 8
               + ((k >> 3) & 1) * 4 + ((r >> 3) & 1) * 2 + (k & 1);
    else
        return ((((r >> 4) * KSTEPS + (k >> 3)) * 32 + (r & 7) * 4 + (k & 3))
                * 4) + ((r >> 3) & 1) + 2 * ((k >> 2) & 1);
}

// the rebuild of two bf16 units: y + k h, rounded (exact for 0/1 masks)
__device__ __forceinline__ uint32_t rebuild2(uint32_t y, uint32_t h,
                                             float k) {
    const float2 a = unpack2(y), b = unpack2(h);
    return pack_bf16(a.x + k * b.x, a.y + k * b.y);
}

template <typename E, int H, int MT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(TC_THREADS, 1)
bilstm_bwd_tc_kernel(const E* __restrict__ xg_f,
                     const E* __restrict__ xg_b,
                     const E* __restrict__ m_f,
                     const E* __restrict__ m_b,
                     const E* __restrict__ w_hh,
                     const E* __restrict__ ys_f,
                     const E* __restrict__ ys_b,
                     const E* __restrict__ gy_f,
                     const E* __restrict__ gy_b,
                     const E* __restrict__ ghT,
                     const E* __restrict__ gcT,
                     E* __restrict__ dxg,
                     E* __restrict__ hs,
                     E* __restrict__ cs,
                     int T, int B) {
    using S = BwdShape<E, H, MT>;
    using X = Elt<E>;
    using P = typename S::P;
    constexpr int H4 = 4 * H;
    constexpr int R = S::R, UC = S::UC, NLT = S::NLT, RP = S::RP;
    STAMP_BEGIN;
    extern __shared__ float4 smem4[];
    char* smc = reinterpret_cast<char*>(smem4);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int dir = blockIdx.y;
    const int b0 = (blockIdx.x / CL) * R;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const E* xg = dir ? xg_b : xg_f;
    const E* mk = dir ? m_b : m_f;
    const E* ys = dir ? ys_b : ys_f;
    const E* gy = dir ? gy_b : gy_f;
    const E* W = w_hh + (size_t)dir * H * H4;
    E* dx = dxg + (size_t)dir * T * B * H4;
    E* hq = hs + (size_t)dir * T * B * H;
    E* cq = cs + (size_t)dir * T * B * H;

    // the cell role: rows rrow(rp) (cluster-relative), units u0, u0 + 1 of
    // this CTA (U0 = its global unit), in both passes, so that pass 2
    // reads back only what this thread wrote in pass 1
    const bool nl = tid < NLT;
    const int slot = tid % S::NSLOT;
    const int hrow = S::PP == 2 ? tid / S::NSLOT : 0;   // the row half
    const int cm = slot / (S::NTU * 32);
    const int u0 = ((slot >> 5) % S::NTU) * 8 + 2 * tig;
    const int U0 = rank * UC + u0;
    auto rrow = [&](int rp) { return cm * 16 + g + 8 * (hrow + rp); };
    bool valid[RP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) valid[rp] = nl && b0 + rrow(rp) < B;

    // ---- pass 1: forward in time --------------------------------------
    // Every CTA rebuilds the whole h_{t-1} of its rows from ys and the
    // masks, multiplies it by its W_hh slice (K2's product), activates its
    // units' gates and rolls their c forward; no CTA waits on another.
    E* hbuf = reinterpret_cast<E*>(smc);                      // [2][HB]
    float* part = reinterpret_cast<float*>(smc + S::O_PART);  // [KG][R][PS]
    E* ysb = reinterpret_cast<E*>(smc + S::O_YS);             // [2][R][YS]
    float* mkb = reinterpret_cast<float*>(smc + S::O_MK);     // [2][R]
    P* xgb = reinterpret_cast<P*>(smc + S::O_XG);     // [2][RP*4][NLT]

    // This warp's B fragments of the W_hh slice, in registers for the whole
    // pass (split into TF32 hi/lo at each use); pass 2 reloads them.
    typename X::W wr[S::KPW][S::NPW][2];
    {
        const int kg = warp / NG, ng = warp % NG;
#pragma unroll
        for (int ks = 0; ks < S::KPW; ++ks) {
#pragma unroll
            for (int j = 0; j < S::NPW; ++j) {
                const int col = (ng * S::NPW + j) * 8 + g;
                const int c0 = (col / UC) * H + rank * UC + col % UC;
                const int k = (kg * S::KPW + ks) * 8 + tig;
                const E* w = W + (size_t)k * H4 + c0;
                wr[ks][j][0] = w[0];
                wr[ks][j][1] = w[(size_t)4 * H4];
            }
        }
    }
    {                                                          // h_{-1}
        uint32_t* hw = reinterpret_cast<uint32_t*>(hbuf);
        constexpr int NW = (int)(S::HB * sizeof(E) / 4);
        for (int i = tid; i < NW; i += TC_THREADS) hw[i] = 0u;
    }

    // step t's ys rows and masks (the rebuild's) and this thread's gates,
    // into buffer b; rows past B read as zeros
    auto fetch1 = [&](int t, int b) {
        constexpr int CE = 16 / (int)sizeof(E);    // elements of 16 bytes
        constexpr int C16 = H / CE;
        for (int i = tid; i < R * C16; i += TC_THREADS) {
            const int r = i / C16, k = (i % C16) * CE;
            const bool v = b0 + r < B;
            cp_async<16>(ysb + (b * R + r) * S::YS + k,
                         v ? ys + ((size_t)t * B + b0 + r) * H + k : ys, v);
        }
        if (tid < R) {
            const bool v = b0 + tid < B;
            cp_async<4>(mkb + b * R + tid,
                        v ? mk + (size_t)t * B + b0 + tid : mk, v);
        }
        if (nl) {
#pragma unroll
            for (int rp = 0; rp < RP; ++rp) {
                const E* x = xg + ((size_t)t * B + b0 + rrow(rp)) * H4 + U0;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    cp_async<(int)sizeof(P)>(
                        xgb + (b * RP * 4 + rp * 4 + q) * NLT + tid,
                        valid[rp] ? x + q * H : xg, valid[rp]);
            }
        }
        cp_async_commit();
    };

    float c[S::PP];
#pragma unroll
    for (int p = 0; p < S::PP; ++p) c[p] = 0.f;
    fetch1(0, 0);
    cp_async_wait_all();
    __syncthreads();
    STAMP(9);                                        // prologue
    for (int t = 0; t < T; ++t) {
        const int cur = t & 1;
        if (t + 1 < T) fetch1(t + 1, cur ^ 1);
        const E* hc = hbuf + cur * S::HB;
        // ---- gates' h_{t-1} @ W_hh part on the tensor cores (K2's) ----
        {
            const int kg = warp / NG, ng = warp % NG;
            float acc[MT][S::NPW][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int j = 0; j < S::NPW; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < S::KPW; ++ks) {
                const int s = kg * S::KPW + ks;
                // 3xTF32: f32 accuracy from three TF32 products
                float4 ahi[MT], alo[MT];
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    split_rna(*reinterpret_cast<const float4*>(
                                  hc + ((m * S::KS + s) * 32 + lane) * 4),
                              ahi[m], alo[m]);
                float bh[S::NPW][2], bl[S::NPW][2];
#pragma unroll
                for (int j = 0; j < S::NPW; ++j) {
                    split_tf32(wr[ks][j][0], bh[j][0], bl[j][0]);
                    split_tf32(wr[ks][j][1], bh[j][1], bl[j][1]);
                }
#pragma unroll
                for (int j = 0; j < S::NPW; ++j)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
                        mma_tf32(acc[m][j], alo[m], bh[j][0], bh[j][1]);
#pragma unroll
                for (int j = 0; j < S::NPW; ++j)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
                        mma_tf32(acc[m][j], ahi[m], bl[j][0], bl[j][1]);
#pragma unroll
                for (int j = 0; j < S::NPW; ++j)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
                        mma_tf32(acc[m][j], ahi[m], bh[j][0], bh[j][1]);
            }
            STAMP(0);                                // pass 1: products
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int j = 0; j < S::NPW; ++j) {
                    const int col = (ng * S::NPW + j) * 8 + 2 * tig;
                    float* p0 = part + (kg * R + m * 16 + g) * S::PS + col;
                    *reinterpret_cast<float2*>(p0) =
                        make_float2(acc[m][j][0], acc[m][j][1]);
                    *reinterpret_cast<float2*>(p0 + 8 * S::PS) =
                        make_float2(acc[m][j][2], acc[m][j][3]);
                }
            }
        }
        __syncthreads();
        STAMP(1);                            // pass 1: partials, barrier

        // ---- the cell: activated gates, h_{t-1}, c_{t-1} to scratch ----
        if (nl) {
#pragma unroll
            for (int rp = 0; rp < RP; ++rp) {
                const int r = rrow(rp);
                float a[4][2];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 x = unpack2(
                        xgb[(cur * RP * 4 + rp * 4 + q) * NLT + tid]);
                    const int o = r * S::PS + q * UC + u0;
                    const float2 p0 = *reinterpret_cast<const float2*>(
                        part + o);
                    const float2 p1 = *reinterpret_cast<const float2*>(
                        part + R * S::PS + o);
                    a[q][0] = x.x + (p0.x + p1.x);
                    a[q][1] = x.y + (p0.y + p1.y);
                }
                const float m = mkb[cur * R + r];
                float cp[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int p = 2 * rp + e;
                    a[0][e] = sigmoid(a[0][e]);
                    a[1][e] = sigmoid(a[1][e]);
                    a[2][e] = tanhf(a[2][e]);
                    a[3][e] = sigmoid(a[3][e]);
                    cp[e] = c[p];
                    c[p] = X::rnd(m * (a[1][e] * c[p] + a[0][e] * a[2][e])
                                  + (1.f - m) * c[p]);
                }
                if (valid[rp]) {
                    const size_t row = (size_t)t * B + b0 + r;
                    E* d = dx + row * H4 + U0;
                    // the activated gates, for pass 2
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        st2(d + q * H, a[q][0], a[q][1]);
                    st2(hq + row * H + U0, hc[afrag<E, S::KS>(r, U0)],
                        hc[afrag<E, S::KS>(r, U0 + 1)]);
                    st2(cq + row * H + U0, cp[0], cp[1]);
                }
            }
        }
        STAMP(2);                            // pass 1: cell, scratch stores
        // ---- the rebuild: h_t = y_t + (1 - m_t) h_{t-1}, all units ----
        if (t + 1 < T) {
            const E* yb = ysb + cur * R * S::YS;
            const float* mb = mkb + cur * R;
            const float4* hp4 = reinterpret_cast<const float4*>(hc);
            float4* hn4 =
                reinterpret_cast<float4*>(hbuf + (cur ^ 1) * S::HB);
            for (int i = tid; i < S::HB / 4; i += TC_THREADS) {
                const int r = (i / (S::KS * 32)) * 16 + ((i & 31) >> 2);
                const int k = ((i >> 5) % S::KS) * 8 + (i & 3);
                const float k0 = 1.f - mb[r], k1 = 1.f - mb[r + 8];
                const float4 h = hp4[i];
                hn4[i] = make_float4(yb[r * S::YS + k] + k0 * h.x,
                                     yb[(r + 8) * S::YS + k] + k1 * h.y,
                                     yb[r * S::YS + k + 4] + k0 * h.z,
                                     yb[(r + 8) * S::YS + k + 4]
                                         + k1 * h.w);
            }
        }
        STAMP(3);                                    // pass 1: rebuild
        cp_async_wait_all();
        __syncthreads();
        STAMP(4);                    // pass 1: next step's fetch, barrier
    }

    // ---- pass 2: backward in time -------------------------------------
    // Each step a CTA forms its units' slice of dxg_t from dh, dc (in the
    // cell threads' registers), gy_t and pass 1's scratch; then warp w
    // multiplies the slice by W_hh[units of CTA w, this CTA's columns]^T
    // and stores the partial dh into CTA w's shared memory (reduce-scatter:
    // K2's bytes, and no wait before the product); one cluster barrier a
    // step, and the owner sums the 8 partials.
    float4* recv = smem4;
    E* atile = reinterpret_cast<E*>(smc + S::O_AT);
    P* pf = reinterpret_cast<P*>(smc + S::O_PF);
    float* pm = reinterpret_cast<float*>(smc + S::O_PM);

    // B fragments of W_hh[units of CTA `warp`, this CTA's columns]^T: its
    // element (k, n) is W_hh[n][column k of this CTA]
#pragma unroll
    for (int s = 0; s < S::KS2; ++s) {
#pragma unroll
        for (int j = 0; j < S::NTU; ++j) {
            const E* wn = W + (size_t)(warp * UC + j * 8 + g) * H4;
            auto wt = [&](int k) { return wn[(k / UC) * H + rank * UC
                                             + k % UC]; };
            wr[s][j][0] = wt(8 * s + tig);
            wr[s][j][1] = wt(8 * s + tig + 4);
        }
    }
    // step t's activated gates, c_{t-1}, gy_t and mask of this thread's
    // elements (what it wrote in pass 1), zeros past B
    auto fetch2 = [&](int t) {
#pragma unroll
        for (int rp = 0; rp < RP; ++rp) {
            const size_t row = (size_t)t * B + b0 + rrow(rp);
            const bool v = valid[rp];
            constexpr int NB = (int)sizeof(P);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                cp_async<NB>(pf + (rp * 6 + q) * NLT + tid,
                             v ? dx + row * H4 + q * H + U0 : dx, v);
            cp_async<NB>(pf + (rp * 6 + 4) * NLT + tid,
                         v ? cq + row * H + U0 : cq, v);
            cp_async<NB>(pf + (rp * 6 + 5) * NLT + tid,
                         v ? gy + row * H + U0 : gy, v);
            cp_async<4>(pm + rp * NLT + tid, v ? mk + row : mk, v);
        }
        cp_async_commit();
    };
    float dh[S::PP], dc[S::PP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const size_t o = ((size_t)dir * B + b0 + rrow(rp)) * H + U0 + e;
            dh[2 * rp + e] = valid[rp] ? X::ld(ghT + o) : 0.f;
            dc[2 * rp + e] = valid[rp] ? X::ld(gcT + o) : 0.f;
        }
    }
    // every CTA is done with pass 1's buffers before any writes into them
    cluster.sync();
    if (nl) fetch2(T - 1);
    STAMP(10);                                       // between the passes

    for (int t = T - 1; t >= 0; --t) {
        if (t < T - 1) {
            // the partial sums of dxg_{t+1} @ W_hh^T for this CTA's units
            cluster_wait_acquire();
            if (nl) {
                const float4* in = recv + slot + ((t + 1) & 1) * CL * S::NSLOT;
                float sum[S::PP];
#pragma unroll
                for (int p = 0; p < S::PP; ++p) sum[p] = 0.f;
#pragma unroll
                for (int src = 0; src < CL; ++src) {
                    // rows g (.x, .y) and g+8 (.z, .w) of the slot
                    const float4 v = in[src * S::NSLOT];
                    if constexpr (S::PP == 4) {
                        sum[0] += v.x;
                        sum[1] += v.y;
                        sum[S::PP - 2] += v.z;
                        sum[S::PP - 1] += v.w;
                    } else {
                        sum[0] += hrow ? v.z : v.x;
                        sum[1] += hrow ? v.w : v.y;
                    }
                }
                // bf16 rounds the dh carry at the end of each step
#pragma unroll
                for (int p = 0; p < S::PP; ++p) dh[p] = X::rnd(dh[p] + sum[p]);
            }
            STAMP(5);                        // pass 2: cluster barrier, sum
        }
        // ---- the cell: dxg_t of this thread's elements ----
        if (nl) {
            cp_async_wait_all();
            STAMP(11);                       // pass 2: the operands' arrival
#pragma unroll
            for (int rp = 0; rp < RP; ++rp) {
                const int r = rrow(rp);
                float2 a[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    a[q] = unpack2(pf[(rp * 6 + q) * NLT + tid]);
                const float2 cp2 = unpack2(pf[(rp * 6 + 4) * NLT + tid]);
                const float2 gy2 = unpack2(pf[(rp * 6 + 5) * NLT + tid]);
                const float m = pm[rp * NLT + tid];
                float da[4][2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int p = 2 * rp + e;
                    const float ig = e ? a[0].y : a[0].x;
                    const float fg = e ? a[1].y : a[1].x;
                    const float gg = e ? a[2].y : a[2].x;
                    const float og = e ? a[3].y : a[3].x;
                    const float cp = e ? cp2.y : cp2.x;
                    const float tc = tanhf(fg * cp + ig * gg);
                    const float dh2 = ((e ? gy2.y : gy2.x) + dh[p]) * m;
                    const float dc2 = m * dc[p] + dh2 * og * (1.f - tc * tc);
                    da[0][e] = X::rnd(dc2 * gg * ig * (1.f - ig));
                    da[1][e] = X::rnd(dc2 * cp * fg * (1.f - fg));
                    da[2][e] = X::rnd(dc2 * ig * (1.f - gg * gg));
                    da[3][e] = X::rnd(dh2 * tc * og * (1.f - og));
                    dc[p] = X::rnd((1.f - m) * dc[p] + dc2 * fg);
                    dh[p] = (1.f - m) * dh[p];
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int k = q * UC + u0;
                    atile[afrag<E, S::KS2>(r, k)] = da[q][0];
                    atile[afrag<E, S::KS2>(r, k + 1)] = da[q][1];
                }
                if (valid[rp]) {
                    E* d = dx + ((size_t)t * B + b0 + r) * H4 + U0;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        st2(d + q * H, da[q][0], da[q][1]);
                }
            }
        }
        STAMP(6);                                    // pass 2: cell
        if (t == 0) break;            // h_{-1} = 0 is no input: no dh_{-1}
        __syncthreads();
        STAMP(7);                                    // pass 2: barrier

        // ---- dxg_t slice @ W_hh[units of CTA warp, cols]^T ----
        float acc[MT][S::NTU][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll
        for (int s = 0; s < S::KS2; ++s) {
            float4 ahi[MT], alo[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m)
                split_rna(*reinterpret_cast<const float4*>(
                              atile + ((m * S::KS2 + s) * 32 + lane) * 4),
                          ahi[m], alo[m]);
            float bh[S::NTU][2], bl[S::NTU][2];
#pragma unroll
            for (int j = 0; j < S::NTU; ++j) {
                split_tf32(wr[s][j][0], bh[j][0], bl[j][0]);
                split_tf32(wr[s][j][1], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    mma_tf32(acc[m][j], alo[m], bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    mma_tf32(acc[m][j], ahi[m], bl[j][0], bl[j][1]);
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    mma_tf32(acc[m][j], ahi[m], bh[j][0], bh[j][1]);
        }
        STAMP(8);                                    // pass 2: product
        // the partial of CTA `warp`'s units into its slot for this CTA
        float4* out = recv + ((t & 1) * CL + rank) * S::NSLOT + lane;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
                *cluster.map_shared_rank(out + (m * S::NTU + j) * 32, warp) =
                    make_float4(acc[m][j][0], acc[m][j][1], acc[m][j][2],
                                acc[m][j][3]);
        STAMP(12);                                   // pass 2: remote stores
        cluster_arrive_release();
        // while the barrier completes: fetch step t-1's operands
        if (nl) fetch2(t - 1);
        STAMP(13);                           // pass 2: arrive, next fetch
    }
    STAMP(14);                                       // epilogue
    STAMP_END(asr_stamp_bwd);
}

// The operands of one call of either kernel.
template <typename E>
struct BwdArgs {
    const E* in[12];    // xg_f, xg_b, m_f, m_b, w_hh, w_t, ys_f, ys_b,
                        // gy_f, gy_b, ghT, gcT
    E *dxg, *hs, *cs;
    int T, B;
};

template <typename E, int H, int MT>
int bwd_tc_launch(const BwdArgs<E>& a, cudaStream_t s, int* plan) {
    using S = BwdShape<E, H, MT>;
    const int rc = asr_allow_smem(bilstm_bwd_tc_kernel<E, H, MT>, S::SMEM);
    if (rc) return rc;
    const dim3 grid((a.B + S::R - 1) / S::R * CL, 2);
    if (plan) {                 // rows per cluster, clusters, max resident
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(TC_THREADS);
        cfg.dynamicSmemBytes = S::SMEM;
        int n = 0;
        const cudaError_t e = cudaOccupancyMaxActiveClusters(
            &n, (const void*)bilstm_bwd_tc_kernel<E, H, MT>, &cfg);
        if (e != cudaSuccess) return (int)e;
        plan[0] = S::R;
        plan[1] = (int)(grid.x / CL * grid.y);
        plan[2] = n;
        plan[3] = CL;
        return 0;
    }
    const E* const* in = a.in;
    bilstm_bwd_tc_kernel<E, H, MT><<<grid, TC_THREADS, S::SMEM, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[6], in[7], in[8], in[9],
        in[10], in[11], a.dxg, a.hs, a.cs, a.T, a.B);
    return (int)cudaGetLastError();
}

template <typename E, int H>
int bwd_tc_dispatch_mt(const BwdArgs<E>& a, cudaStream_t s, int* plan) {
    if (tc_mtiles(a.B) == 1) return bwd_tc_launch<E, H, 1>(a, s, plan);
    return bwd_tc_launch<E, H, 2>(a, s, plan);
}

template <typename E>
int bwd_tc_dispatch(int H, const BwdArgs<E>& a, cudaStream_t s, int* plan) {
    switch (H) {
    case 64:
        return bwd_tc_dispatch_mt<E, 64>(a, s, plan);
    case 128:
        return bwd_tc_dispatch_mt<E, 128>(a, s, plan);
    case 192:
        return bwd_tc_dispatch_mt<E, 192>(a, s, plan);
    default:
        return bwd_tc_dispatch_mt<E, 256>(a, s, plan);
    }
}

// ---------------------------------------------------------------------------
// K2-bwd-bf16: pass 1 as three stages, pass 2 on the bf16 cluster plan
// ---------------------------------------------------------------------------
// The stage kernels' block: one (direction, row) and AU unit pairs, one
// thread a pair and step of a chunk of AS steps.  A chunk's loads (and,
// in stage (c), its activations) run at once; then one thread a pair
// walks the chunk's serial part, h's or c's carry, from shared memory.
constexpr int AS = 8;       // steps of a chunk
constexpr int AU = 32;      // unit pairs of a block

// Stage (a): hs[d, t] = h_{t-1} of direction d, rebuilt from ys and the
// masks (h_t = y_t + (1 - m_t) h_{t-1}, rounded to bf16: exact for 0/1
// masks, and the masks need not be prefix masks).
__global__ void __launch_bounds__(AS * AU)
bilstm_bf16_rebuild_kernel(const bf16* __restrict__ ys_f,
                           const bf16* __restrict__ ys_b,
                           const bf16* __restrict__ m_f,
                           const bf16* __restrict__ m_b,
                           bf16* __restrict__ hs, int T, int B, int H) {
    __shared__ uint32_t yc[AS][AU];
    __shared__ float msk[AS];
    const int groups = H / 2 / AU;
    const int kp = threadIdx.x % AU, s = threadIdx.x / AU;
    const int grp = blockIdx.x % groups;
    const int b = blockIdx.x / groups % B, dir = blockIdx.x / groups / B;
    const int k = (grp * AU + kp) * 2;
    const bf16* ys = (dir ? ys_b : ys_f) + (size_t)b * H + k;
    const bf16* mk = (dir ? m_b : m_f) + b;
    uint32_t* hq = reinterpret_cast<uint32_t*>(
        hs + ((size_t)dir * T * B + b) * H + k);
    const size_t step = (size_t)B * H / 2;           // words a step
    uint32_t h = 0u;                                 // (s == 0) h of the pair
    for (int t0 = 0; t0 < T; t0 += AS) {
        const int t = t0 + s;
        if (t < T) {
            yc[s][kp] = __ldg(reinterpret_cast<const unsigned int*>(
                ys + (size_t)t * B * H));
            if (kp == 0) msk[s] = __bfloat162float(mk[(size_t)t * B]);
        }
        __syncthreads();
        if (s == 0) {
            for (int j = 0; j < AS && t0 + j < T; ++j) {
                hq[(size_t)(t0 + j) * step] = h;
                h = rebuild2(yc[j][kp], h, 1.f - msk[j]);
            }
        }
        __syncthreads();
    }
}

// Stage (c), after (b) pre = hs @ W_hh (the wrapper's f32 batched
// product): the gates xg_t + pre_t activated (exact expf / tanhf), stored
// rounded to bf16 in dxg's buffer for pass 2, and c rolled forward under
// the mask with the f32 activations, rounded at the end of each step,
// c_{t-1} into cs.  Both stages are bound by their bytes: (a) reads ys
// and writes hs, (c) reads xg and the f32 pre-activations and writes the
// gates and cs (2 x 87 MB of pre at [332, 32, 256]).
__global__ void __launch_bounds__(AS * AU)
bilstm_bf16_activate_kernel(const bf16* __restrict__ xg_f,
                            const bf16* __restrict__ xg_b,
                            const bf16* __restrict__ m_f,
                            const bf16* __restrict__ m_b,
                            const float* __restrict__ pre,
                            bf16* __restrict__ dxg, bf16* __restrict__ cs,
                            int T, int B, int H) {
    using X = Elt<bf16>;
    __shared__ float2 gi[AS][AU], gf[AS][AU], gg[AS][AU];
    __shared__ float msk[AS];
    const int H4 = 4 * H, groups = H / 2 / AU;
    const int kp = threadIdx.x % AU, s = threadIdx.x / AU;
    const int grp = blockIdx.x % groups;
    const int b = blockIdx.x / groups % B, dir = blockIdx.x / groups / B;
    const int k = (grp * AU + kp) * 2;
    const size_t row0 = (size_t)dir * T * B + b;     // row of step 0
    const bf16* xg = (dir ? xg_b : xg_f) + (size_t)b * H4 + k;
    const bf16* mk = (dir ? m_b : m_f) + b;
    const float* pr = pre + row0 * H4 + k;
    bf16* dx = dxg + row0 * H4 + k;
    bf16* cq = cs + row0 * H + k;
    float c0 = 0.f, c1 = 0.f;                        // (s == 0) c of the pair
    for (int t0 = 0; t0 < T; t0 += AS) {
        const int t = t0 + s;
        if (t < T) {
            const size_t o = (size_t)t * B * H4;
            float a[4][2];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float2 xv = unpack2(__ldg(
                    reinterpret_cast<const unsigned int*>(xg + o + q * H)));
                const float2 pv = __ldg(
                    reinterpret_cast<const float2*>(pr + o + q * H));
                a[q][0] = xv.x + pv.x;
                a[q][1] = xv.y + pv.y;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                a[0][e] = sigmoid(a[0][e]);
                a[1][e] = sigmoid(a[1][e]);
                a[2][e] = tanhf(a[2][e]);
                a[3][e] = sigmoid(a[3][e]);
            }
            // the activated gates, rounded to bf16 for pass 2
#pragma unroll
            for (int q = 0; q < 4; ++q)
                st2(dx + o + q * H, a[q][0], a[q][1]);
            gi[s][kp] = make_float2(a[0][0], a[0][1]);
            gf[s][kp] = make_float2(a[1][0], a[1][1]);
            gg[s][kp] = make_float2(a[2][0], a[2][1]);
            if (kp == 0) msk[s] = __bfloat162float(mk[(size_t)t * B]);
        }
        __syncthreads();
        if (s == 0) {
            // c rolled forward where K2-bf16 rounds it
            for (int j = 0; j < AS && t0 + j < T; ++j) {
                st2(cq + (size_t)(t0 + j) * B * H, c0, c1);
                const float mm = msk[j];
                const float2 i2 = gi[j][kp], f2 = gf[j][kp], g2 = gg[j][kp];
                c0 = X::rnd(mm * (f2.x * c0 + i2.x * g2.x) + (1.f - mm) * c0);
                c1 = X::rnd(mm * (f2.y * c1 + i2.y * g2.y) + (1.f - mm) * c1);
            }
        }
        __syncthreads();
    }
}

// Pass 2, backward in time (the f32 kernel's pass 2 in bf16, on K2-bf16's
// plan): CLB CTAs (tc.cuh `bf16_ctas`) share one direction and 16 rows;
// each step a CTA forms its units' slice of dxg_t from dh, dc (in the cell
// threads' registers), gy_t and stage (c)'s scratch; warps w = WPD d ..
// WPD d + WPD - 1 multiply it by W_hh[units of CTA d, this CTA's
// columns]^T (NTW n-tiles each) and send the partial dh to CTA d with
// st.async, signalling d's mbarrier of the step's receive buffer
// (reduce-scatter); a CTA waits for its own barrier and sums the CLB
// partials.  The dxg slice is double-buffered by the step's parity, so
// that a CTA may begin a step's cell while a warp of it still multiplies
// the last one.  Timed against this design on an H100 80GB HBM3 at 700 W
// (tools/lstm_stamp.py, PERF.md) and then deleted: plain remote stores
// and one cluster barrier a step (the f32 kernel's exchange), K2-bwd-bf16
// 1.015 ms at [332, 32, 256] and 1.757 ms at B=128 against this one's
// 0.905 and 1.660 ms in the same call; a step's operands fetched in
// 16-byte chunks spread over all threads behind one more block barrier,
// with two accumulators a tile, pass 2 0.710 ms at B=32 against this
// one's 0.638 (another call).
template <int H, int CLB>
struct Bwd2Shape {
    static constexpr int UC = H / CLB;      // hidden units of one CTA
    static constexpr int COLS = 4 * UC;     // its gate columns (q*UC + u)
    static constexpr int R = 16;            // batch rows of one cluster
    static constexpr int KS2 = COLS / 16;   // k16 steps over the columns
    static constexpr int NTU = UC / 8;      // n8 tiles of one CTA's units
    // 256 threads a CTA, or 512 where a CTA of 4 has the n-tiles for them
    // (H = 128, 256), so that a thread's cell and n-tiles stay those of 8
    static constexpr int THREADS = CLB == 4 && NTU % 4 == 0 ? 512 : 256;
    static constexpr int WPD = THREADS / 32 / CLB;  // warps a destination
    static constexpr int NTW = NTU / WPD;   // n-tiles of one warp
    // the cell role: slot (j, lane) of the partials holds rows g, g+8 by
    // units 8j + 2c, 8j + 2c + 1; a thread takes one row of a slot (PP = 2)
    // or both (PP = 4)
    static constexpr int NSLOT = NTU * 32;
    static constexpr int PP = 2 * NSLOT <= THREADS ? 2 : 4;
    static constexpr int RP = PP / 2;       // rows of one cell thread
    static constexpr int NLT = NSLOT * 4 / PP;  // threads of the cell role
    // shared memory, bytes: recv [2][CLB][NSLOT] float4 partials, the dxg
    // slice [2][R][COLS] (A-fragment order), prefetch [RP*6][NLT] words,
    // the two receive buffers' mbarriers
    static constexpr size_t O_AT = (size_t)2 * CLB * NSLOT * 16;
    static constexpr size_t AT = (size_t)R * COLS;     // elements a slice
    static constexpr size_t O_PF = O_AT + 2 * AT * 2;
    static constexpr size_t O_BAR = O_PF + (size_t)RP * 6 * NLT * 4;
    static constexpr size_t SMEM = O_BAR + 16;
    static_assert(H % 64 == 0 && NTU % WPD == 0 && NTW >= 1
                  && NLT <= THREADS && O_PF % 16 == 0 && O_BAR % 8 == 0,
                  "shape");
};

template <int H, int CLB>
__global__ void __launch_bounds__(Bwd2Shape<H, CLB>::THREADS, 1)
bilstm_bf16_bwd2_kernel(const bf16* __restrict__ m_f,
                        const bf16* __restrict__ m_b,
                        const bf16* __restrict__ w_hh,
                        const bf16* __restrict__ gy_f,
                        const bf16* __restrict__ gy_b,
                        const bf16* __restrict__ ghT,
                        const bf16* __restrict__ gcT,
                        bf16* __restrict__ dxg,
                        const bf16* __restrict__ cs,
                        int T, int B) {
    using S = Bwd2Shape<H, CLB>;
    using X = Elt<bf16>;
    constexpr int H4 = 4 * H;
    constexpr int R = S::R, UC = S::UC, NLT = S::NLT, RP = S::RP;
    constexpr int NSLOT = S::NSLOT;
    STAMP_BEGIN;
    extern __shared__ float4 smem4[];
    char* smc = reinterpret_cast<char*>(smem4);
    float4* recv = smem4;                            // [2][CLB][NSLOT]
    bf16* atile = reinterpret_cast<bf16*>(smc + S::O_AT);     // [2][AT]
    uint32_t* pf = reinterpret_cast<uint32_t*>(smc + S::O_PF);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smc + S::O_BAR);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int dir = blockIdx.y;
    const int b0 = (blockIdx.x / CLB) * R;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const bf16* mk = dir ? m_b : m_f;
    const bf16* gy = dir ? gy_b : gy_f;
    const bf16* W = w_hh + (size_t)dir * H * H4;
    bf16* dx = dxg + (size_t)dir * T * B * H4;
    const bf16* cq = cs + (size_t)dir * T * B * H;

    // the cell role: rows rrow(rp) (cluster-relative), units u0, u0 + 1 of
    // this CTA (U0 = its global unit)
    const bool nl = tid < NLT;
    const int slot = tid % NSLOT;
    const int hrow = S::PP == 2 ? tid / NSLOT : 0;   // the row half
    const int u0 = (slot >> 5) * 8 + 2 * tig;
    const int U0 = rank * UC + u0;
    auto rrow = [&](int rp) { return g + 8 * (hrow + rp); };
    bool valid[RP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) valid[rp] = nl && b0 + rrow(rp) < B;

    // B fragments of W_hh[units of CTA dd, this CTA's columns]^T, n-tiles
    // j0 .. j0 + NTW - 1 of CTA dd's: element (k, n) is W_hh[n][column k]
    const int dd = warp / S::WPD, j0 = (warp % S::WPD) * S::NTW;
    uint32_t wr[S::KS2][S::NTW][2];
#pragma unroll
    for (int s = 0; s < S::KS2; ++s) {
#pragma unroll
        for (int j = 0; j < S::NTW; ++j) {
            const bf16* wn = W + (size_t)(dd * UC + (j0 + j) * 8 + g) * H4;
            auto wt = [&](int k) { return wn[(k / UC) * H + rank * UC
                                             + k % UC]; };
            const int k = 16 * s + 2 * tig;
            wr[s][j][0] = pack_bf16(wt(k), wt(k + 1));
            wr[s][j][1] = pack_bf16(wt(k + 8), wt(k + 9));
        }
    }
    // step t's activated gates, c_{t-1}, gy_t (one word of two units each)
    // and mask of this thread's elements, zeros past B
    float mreg[RP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) mreg[rp] = 0.f;
    auto fetch2 = [&](int t) {
#pragma unroll
        for (int rp = 0; rp < RP; ++rp) {
            const size_t row = (size_t)t * B + b0 + rrow(rp);
            const bool v = valid[rp];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                cp_async<4>(pf + (rp * 6 + q) * NLT + tid,
                            v ? dx + row * H4 + q * H + U0 : dx, v);
            cp_async<4>(pf + (rp * 6 + 4) * NLT + tid,
                        v ? cq + row * H + U0 : cq, v);
            cp_async<4>(pf + (rp * 6 + 5) * NLT + tid,
                        v ? gy + row * H + U0 : gy, v);
            mreg[rp] = v ? X::ld(mk + row) : 0.f;
        }
        cp_async_commit();
    };
    float dh[S::PP], dc[S::PP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const size_t o = ((size_t)dir * B + b0 + rrow(rp)) * H + U0 + e;
            dh[2 * rp + e] = valid[rp] ? X::ld(ghT + o) : 0.f;
            dc[2 * rp + e] = valid[rp] ? X::ld(gcT + o) : 0.f;
        }
    }
    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        mbar_init_fence();
    }
    // every CTA's barriers are ready before any CTA sends
    cluster.sync();
    if (nl) fetch2(T - 1);
    STAMP(10);                                       // prologue
    uint32_t phase = 0u;          // each receive buffer's phase bit

    for (int t = T - 1; t >= 0; --t) {
        // the partials of step t arrive in buffer t & 1
        if (tid == 0 && t > 0)
            mbar_expect(&bar[t & 1], (uint32_t)(CLB * NSLOT * 16));
        if (t < T - 1) {
            // the partial sums of dxg_{t+1} @ W_hh^T for this CTA's units
            const int rb = (t + 1) & 1;
            mbar_wait(&bar[rb], (phase >> rb) & 1u);
            phase ^= 1u << rb;
            if (nl) {
                const float4* in = recv + slot + rb * CLB * NSLOT;
                float sum[S::PP];
#pragma unroll
                for (int p = 0; p < S::PP; ++p) sum[p] = 0.f;
#pragma unroll
                for (int src = 0; src < CLB; ++src) {
                    // rows g (.x, .y) and g+8 (.z, .w) of the slot
                    const float4 v = in[src * NSLOT];
                    if constexpr (S::PP == 4) {
                        sum[0] += v.x;
                        sum[1] += v.y;
                        sum[2] += v.z;
                        sum[3] += v.w;
                    } else {
                        sum[0] += hrow ? v.z : v.x;
                        sum[1] += hrow ? v.w : v.y;
                    }
                }
                // the dh carry rounded at the end of each step
#pragma unroll
                for (int p = 0; p < S::PP; ++p) dh[p] = X::rnd(dh[p] + sum[p]);
            }
            STAMP(5);                        // pass 2: the wait, the sum
        }
        // ---- the cell: dxg_t of this thread's elements ----
        bf16* at = atile + (t & 1) * S::AT;
        if (nl) {
            cp_async_wait_all();
            STAMP(11);                       // pass 2: the operands' arrival
#pragma unroll
            for (int rp = 0; rp < RP; ++rp) {
                const int r = rrow(rp);
                float2 a[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    a[q] = unpack2(pf[(rp * 6 + q) * NLT + tid]);
                const float2 cp2 = unpack2(pf[(rp * 6 + 4) * NLT + tid]);
                const float2 gy2 = unpack2(pf[(rp * 6 + 5) * NLT + tid]);
                const float m = mreg[rp];
                float da[4][2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int p = 2 * rp + e;
                    const float ig = e ? a[0].y : a[0].x;
                    const float fg = e ? a[1].y : a[1].x;
                    const float gg = e ? a[2].y : a[2].x;
                    const float og = e ? a[3].y : a[3].x;
                    const float cp = e ? cp2.y : cp2.x;
                    const float tc = tanhf(fg * cp + ig * gg);
                    const float dh2 = ((e ? gy2.y : gy2.x) + dh[p]) * m;
                    const float dc2 = m * dc[p] + dh2 * og * (1.f - tc * tc);
                    // dxg_t rounded as it is stored, then the product's
                    // operand
                    da[0][e] = X::rnd(dc2 * gg * ig * (1.f - ig));
                    da[1][e] = X::rnd(dc2 * cp * fg * (1.f - fg));
                    da[2][e] = X::rnd(dc2 * ig * (1.f - gg * gg));
                    da[3][e] = X::rnd(dh2 * tc * og * (1.f - og));
                    dc[p] = X::rnd((1.f - m) * dc[p] + dc2 * fg);
                    dh[p] = (1.f - m) * dh[p];
                }
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    st2(at + afrag<bf16, S::KS2>(r, q * UC + u0), da[q][0],
                        da[q][1]);
                if (valid[rp]) {
                    bf16* d = dx + ((size_t)t * B + b0 + r) * H4 + U0;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        st2(d + q * H, da[q][0], da[q][1]);
                }
            }
        }
        STAMP(6);                                    // pass 2: cell
        if (t == 0) break;            // h_{-1} = 0 is no input: no dh_{-1}
        __syncthreads();
        STAMP(7);                                    // pass 2: barrier

        // ---- dxg_t slice @ W_hh[units of CTA dd, cols]^T ----
        float acc[S::NTW][4];
#pragma unroll
        for (int j = 0; j < S::NTW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int s = 0; s < S::KS2; ++s) {
            const uint4 a = *reinterpret_cast<const uint4*>(
                at + (s * 32 + lane) * 8);
#pragma unroll
            for (int j = 0; j < S::NTW; ++j)
                mma_bf16(acc[j], a, wr[s][j][0], wr[s][j][1]);
        }
        STAMP(8);                                    // pass 2: product
        // the partial of CTA dd's units into its slot for this CTA
        float4* out = recv + ((t & 1) * CLB + rank) * NSLOT + lane;
        const uint32_t ba = smem_u32(&bar[t & 1]);
#pragma unroll
        for (int j = 0; j < S::NTW; ++j) {
            const float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2],
                                         acc[j][3]);
            st_async(cluster_u32(smem_u32(out + (j0 + j) * 32), dd), v,
                     cluster_u32(ba, dd));
        }
        STAMP(12);                                   // pass 2: the sends
        // while the partials travel: fetch step t-1's operands
        if (nl) fetch2(t - 1);
        STAMP(13);                           // pass 2: the next fetch
    }
    // no CTA leaves while a store of the cluster may still be in flight
    cluster.sync();
    STAMP(14);                                       // epilogue
    STAMP_END(asr_stamp_bwd);
}

template <int H, int CLB>
int bwd2_launch(const BwdArgs<bf16>& a, cudaStream_t s, int* plan) {
    using S = Bwd2Shape<H, CLB>;
    const dim3 grid((a.B + S::R - 1) / S::R * CLB, 2);
    const bf16* const* in = a.in;
    return launch_clusters(bilstm_bf16_bwd2_kernel<H, CLB>, CLB, S::R,
                           S::THREADS, grid, S::SMEM, s, plan, in[2], in[3],
                           in[4], in[8], in[9], in[10], in[11], a.dxg,
                           (const bf16*)a.cs, a.T, a.B);
}

template <int H>
int bwd2_dispatch_cl(const BwdArgs<bf16>& a, cudaStream_t s, int* plan) {
    if (STAMP_CTAS(bf16_ctas(a.B)) == 8) return bwd2_launch<H, 8>(a, s, plan);
    return bwd2_launch<H, 4>(a, s, plan);
}

int bwd2_dispatch(int H, const BwdArgs<bf16>& a, cudaStream_t s, int* plan) {
    switch (H) {
    case 64:
        return bwd2_dispatch_cl<64>(a, s, plan);
    case 128:
        return bwd2_dispatch_cl<128>(a, s, plan);
    case 192:
        return bwd2_dispatch_cl<192>(a, s, plan);
    default:
        return bwd2_dispatch_cl<256>(a, s, plan);
    }
}

// ---------------------------------------------------------------------------
// simple per-block kernel
// ---------------------------------------------------------------------------
// A block holds R batch rows and KS >= R threads a hidden unit j: thread
// (q, j) sums every KS-th k of the step's products for all R rows, and
// finishes row q < R (its h, c in pass 1 and dh, dc in pass 2 stay in its
// registers).  Shared memory and sums are f32; a bf16 instance rounds
// where the cluster kernel does.
template <typename E, int KS, int R>
__global__ void __launch_bounds__(1024)
bilstm_bwd_kernel(const E* __restrict__ xg_f,
                  const E* __restrict__ xg_b,
                  const E* __restrict__ m_f,
                  const E* __restrict__ m_b,
                  const E* __restrict__ w_hh,
                  const E* __restrict__ w_t,
                  const E* __restrict__ ys_f,
                  const E* __restrict__ ys_b,
                  const E* __restrict__ gy_f,
                  const E* __restrict__ gy_b,
                  const E* __restrict__ ghT,
                  const E* __restrict__ gcT,
                  E* __restrict__ dxg,
                  E* __restrict__ hs,
                  E* __restrict__ cs,
                  int T, int B, int H) {
    using X = Elt<E>;
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
    const E* xg = dir ? xg_b : xg_f;
    const E* mk = dir ? m_b : m_f;
    const E* ys = dir ? ys_b : ys_f;
    const E* gy = dir ? gy_b : gy_f;
    const E* W = w_hh + (size_t)dir * H * H4;
    const E* WT = w_t + (size_t)dir * H4 * H;
    E* dx = dxg + (size_t)dir * T * B * H4;
    E* hq = hs + (size_t)dir * T * B * H;
    E* cq = cs + (size_t)dir * T * B * H;

    // ---- pass 1: forward in time ---------------------------------------
    float h = 0.f, c = 0.f;
    for (int t = 0; t < T; ++t) {
        const size_t row = (size_t)t * B + b0 + q;
        if (active) {
            if (mine) {
                X::st(hq + row * H + j, h);
                X::st(cq + row * H + j, c);
            }
            if (q < R) tile[q * H + j] = h;
        }
        __syncthreads();
        if (active) {
            float acc[R][4];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                const E* x = xg + ((size_t)t * B + b0 + b) * H4 + j;
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    acc[b][g] = (q == 0 && b < nb) ? X::ld(x + g * H) : 0.f;
            }
            const E* wj = W + j;
#pragma unroll 2
            for (int k = q; k < H; k += KS) {
                const E* wr = wj + (size_t)k * H4;
                const float w0 = X::ldg(wr);
                const float w1 = X::ldg(wr + H);
                const float w2 = X::ldg(wr + 2 * H);
                const float w3 = X::ldg(wr + 3 * H);
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
            const float ig = sigmoid(a[0]);
            const float fg = sigmoid(a[1]);
            const float gg = tanhf(a[2]);
            const float og = sigmoid(a[3]);
            const float m = X::ld(mk + row);
            c = X::rnd(m * (fg * c + ig * gg) + (1.f - m) * c);
            h = X::rnd(X::ld(ys + row * H + j) + (1.f - m) * h);
            E* d = dx + row * H4 + j;
            X::st(d, ig);
            X::st(d + H, fg);
            X::st(d + 2 * H, gg);
            X::st(d + 3 * H, og);
        }
    }

    // ---- pass 2: backward in time --------------------------------------
    float dh = 0.f, dc = 0.f;
    if (mine) {
        const size_t o = ((size_t)dir * B + b0 + q) * H + j;
        dh = X::ld(ghT + o);
        dc = X::ld(gcT + o);
    }
    const float4* tile4 = smem4;
    for (int t = T - 1; t >= 0; --t) {
        if (active) {
            float da[4] = {0.f, 0.f, 0.f, 0.f};
            if (mine) {
                const size_t row = (size_t)t * B + b0 + q;
                const float m = X::ld(mk + row);
                const float cp = X::ld(cq + row * H + j);
                E* d = dx + row * H4 + j;
                const float ig = X::ld(d), fg = X::ld(d + H),
                            gg = X::ld(d + 2 * H), og = X::ld(d + 3 * H);
                const float tc = tanhf(fg * cp + ig * gg);
                const float dh2 = (X::ld(gy + row * H + j) + dh) * m;
                const float dc2 = m * dc + dh2 * og * (1.f - tc * tc);
                da[0] = X::rnd(dc2 * gg * ig * (1.f - ig));
                da[1] = X::rnd(dc2 * cp * fg * (1.f - fg));
                da[2] = X::rnd(dc2 * ig * (1.f - gg * gg));
                da[3] = X::rnd(dh2 * tc * og * (1.f - og));
#pragma unroll
                for (int g = 0; g < 4; ++g) X::st(d + g * H, da[g]);
                dc = X::rnd((1.f - m) * dc + dc2 * fg);
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
            const E* wj = WT + j;
#pragma unroll 1
            for (int k4 = q; k4 < H; k4 += KS) {
                const E* wr = wj + (size_t)(4 * k4) * H;
                const float w0 = X::ldg(wr);
                const float w1 = X::ldg(wr + H);
                const float w2 = X::ldg(wr + 2 * H);
                const float w3 = X::ldg(wr + 3 * H);
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
            dh = X::rnd(dh + s);
        }
    }
}

template <typename E, int KS, int R>
int bwd_launch(const BwdArgs<E>& a, int H, cudaStream_t s) {
    const size_t smem = (size_t)(R * 4 * H + KS * R * 4 * H) * sizeof(float);
    const int rc = asr_allow_smem(bilstm_bwd_kernel<E, KS, R>, smem);
    if (rc) return rc;
    const int threads = KS * ((H + 31) / 32 * 32);
    const dim3 grid((a.B + R - 1) / R, 2);
    const E* const* in = a.in;
    bilstm_bwd_kernel<E, KS, R><<<grid, threads, smem, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], a.dxg, a.hs, a.cs, a.T, a.B, H);
    return (int)cudaGetLastError();
}

template <typename E>
int bwd_entry(const BwdArgs<E>& a, int H, void* stream) {
    if (a.B <= 0 || a.T <= 0 || H <= 0) return 0;
    if (H > 1024) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (tc_fits(H)) {
        // bf16 at these H is staged (asr_bilstm_bwd_bf16_rebuild, _activate,
        // _pass2)
        if constexpr (Elt<E>::BF16) return (int)cudaErrorInvalidValue;
        else return bwd_tc_dispatch<E>(H, a, s, nullptr);
    }
    const int Hp = (H + 31) / 32 * 32;
    // KS threads a hidden unit, as many as 1024 threads a block allow (up
    // to 4), and R = min(KS, 2) rows a block
    if (Hp <= 256) return bwd_launch<E, 4, 2>(a, H, s);
    if (Hp <= 512) return bwd_launch<E, 2, 2>(a, H, s);
    return bwd_launch<E, 1, 1>(a, H, s);
}

template <typename E>
int bwd_plan(int B, int H, int* plan) {
    if (B <= 0 || H <= 0 || H > 1024) return (int)cudaErrorInvalidValue;
    if (!tc_fits(H)) {
        plan[0] = (H + 31) / 32 * 32 <= 512 ? 2 : 1;
        plan[1] = plan[2] = plan[3] = 0;
        return 0;
    }
    BwdArgs<E> a = {};
    a.B = B;
    if constexpr (Elt<E>::BF16) return bwd2_dispatch(H, a, nullptr, plan);
    else return bwd_tc_dispatch<E>(H, a, nullptr, plan);
}

// the stage kernels' grid: a block a (direction, row, AU unit pairs)
inline dim3 stage_grid(int B, int H) {
    return dim3((unsigned)(2 * B * (H / 2 / AU)));
}

}  // namespace

// xg_f, xg_b [T, B, 4H]; m_f, m_b [T, B]; w_hh [2, H, 4H] and its transpose
// w_t [2, 4H, H] (read by the simple kernel only: the cluster kernel
// ignores it); ys_f, ys_b and their
// cotangents gy_f, gy_b [T, B, H]; the final state's cotangents ghT, gcT
// [2, B, H] -> dxg [2, T, B, 4H] (the gate cotangents, = d xg), hs [2, T,
// B, H] (the carried h_{t-1} of each step, for dW_hh), cs [2, T, B, H]
// (scratch).  All float32, contiguous and 16-byte aligned; any H <= 1024
// (the cluster kernel for H in {64, 128, 192, 256}, else the simple one).
// Returns 0 or a cudaError_t.
ASR_API int asr_bilstm_bwd(const float* xg_f, const float* xg_b,
                           const float* m_f, const float* m_b,
                           const float* w_hh, const float* w_t,
                           const float* ys_f, const float* ys_b,
                           const float* gy_f, const float* gy_b,
                           const float* ghT, const float* gcT, float* dxg,
                           float* hs, float* cs, int T, int B, int H,
                           void* stream) {
    const BwdArgs<float> a = {{xg_f, xg_b, m_f, m_b, w_hh, w_t, ys_f, ys_b,
                               gy_f, gy_b, ghT, gcT}, dxg, hs, cs, T, B};
    return bwd_entry<float>(a, H, stream);
}

// The same contract with every operand, output and scratch bf16 (K2-bwd-
// bf16, the backward of asr_bilstm_bf16), for H outside {64, 128, 192,
// 256} (the simple kernel); at those H it returns cudaErrorInvalidValue:
// K2-bwd-bf16 runs there as the stages below and the wrapper's product.
ASR_API int asr_bilstm_bwd_bf16(const bf16* xg_f, const bf16* xg_b,
                                const bf16* m_f, const bf16* m_b,
                                const bf16* w_hh, const bf16* w_t,
                                const bf16* ys_f, const bf16* ys_b,
                                const bf16* gy_f, const bf16* gy_b,
                                const bf16* ghT, const bf16* gcT, bf16* dxg,
                                bf16* hs, bf16* cs, int T, int B, int H,
                                void* stream) {
    const BwdArgs<bf16> a = {{xg_f, xg_b, m_f, m_b, w_hh, w_t, ys_f, ys_b,
                              gy_f, gy_b, ghT, gcT}, dxg, hs, cs, T, B};
    return bwd_entry<bf16>(a, H, stream);
}

// K2-bwd-bf16 at H in {64, 128, 192, 256}, stage (a): ys_f, ys_b [T, B, H],
// m_f, m_b [T, B] -> hs [2, T, B, H], the carried h_{t-1} of each step.
ASR_API int asr_bilstm_bwd_bf16_rebuild(const bf16* ys_f, const bf16* ys_b,
                                        const bf16* m_f, const bf16* m_b,
                                        bf16* hs, int T, int B, int H,
                                        void* stream) {
    if (B <= 0 || T <= 0) return 0;
    if (!tc_fits(H)) return (int)cudaErrorInvalidValue;
    bilstm_bf16_rebuild_kernel<<<stage_grid(B, H), AS * AU, 0,
                                 (cudaStream_t)stream>>>(ys_f, ys_b, m_f,
                                                         m_b, hs, T, B, H);
    return (int)cudaGetLastError();
}

// Stage (c): xg_f, xg_b [T, B, 4H], the masks, pre [2, T, B, 4H] float32
// (= hs @ W_hh, stage (b)) -> the activated gates in dxg [2, T, B, 4H] and
// c_{t-1} in cs [2, T, B, H].
ASR_API int asr_bilstm_bwd_bf16_activate(const bf16* xg_f, const bf16* xg_b,
                                         const bf16* m_f, const bf16* m_b,
                                         const float* pre, bf16* dxg,
                                         bf16* cs, int T, int B, int H,
                                         void* stream) {
    if (B <= 0 || T <= 0) return 0;
    if (!tc_fits(H)) return (int)cudaErrorInvalidValue;
    bilstm_bf16_activate_kernel<<<stage_grid(B, H), AS * AU, 0,
                                  (cudaStream_t)stream>>>(
        xg_f, xg_b, m_f, m_b, pre, dxg, cs, T, B, H);
    return (int)cudaGetLastError();
}

// Pass 2: the masks, w_hh [2, H, 4H], gy_f, gy_b [T, B, H], ghT, gcT
// [2, B, H], stage (c)'s dxg (activated gates, overwritten with the gate
// cotangents) and cs.
ASR_API int asr_bilstm_bwd_bf16_pass2(const bf16* m_f, const bf16* m_b,
                                      const bf16* w_hh, const bf16* gy_f,
                                      const bf16* gy_b, const bf16* ghT,
                                      const bf16* gcT, bf16* dxg,
                                      bf16* cs, int T, int B, int H,
                                      void* stream) {
    if (B <= 0 || T <= 0) return 0;
    if (!tc_fits(H)) return (int)cudaErrorInvalidValue;
    const BwdArgs<bf16> a = {{nullptr, nullptr, m_f, m_b, w_hh, nullptr,
                              nullptr, nullptr, gy_f, gy_b, ghT, gcT},
                             dxg, nullptr, cs, T, B};
    return bwd2_dispatch(H, a, (cudaStream_t)stream, nullptr);
}

// How asr_bilstm_bwd (K2-bwd-bf16's pass 2 for asr_bilstm_bwd_bf16_plan)
// would launch at (B, H), without launching: plan[0] batch rows per
// cluster, plan[1] clusters in the grid, plan[2] clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), plan[3] CTAs a cluster.  For the
// simple kernel (no cluster) plan = {rows a block, 0, 0, 0}.  Returns 0 or
// a cudaError_t.
ASR_API int asr_bilstm_bwd_plan(int B, int H, int* plan) {
    return bwd_plan<float>(B, H, plan);
}

ASR_API int asr_bilstm_bwd_bf16_plan(int B, int H, int* plan) {
    return bwd_plan<bf16>(B, H, plan);
}
