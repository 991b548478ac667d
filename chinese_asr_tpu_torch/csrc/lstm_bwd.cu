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
// bf16 (`asr_bilstm_bwd_bf16`, K2-bwd-bf16, for bf16 training): both
// kernels are templated on the operand type E, with K2-bf16's traits
// (tc.cuh `Elt`).  JAX's bf16 backward is the VJP of its bf16 scan
// (chinese_asr_tpu/ops/rnn.py:297 of :248), every op rounded to bf16.
// Here xg, the masks, W_hh, ys, the cotangents, dxg and the scratch hs and
// cs are bf16; the products are bf16 x bf16 with f32 accumulation
// (`mma.m16n8k16`, one a k16 step where f32 takes three 3xTF32 m16n8k8);
// each step's arithmetic is f32; and the rounding points are
//   pass 1: c rounded at the end of each step, where K2-bf16 rounds it
//     (the rolled-forward c is the forward's, or an ulp from it where sums
//     run in another order); the activated gates rounded as they are kept
//     in dxg's buffer (JAX keeps them in bf16 too); h, rebuilt from ys and
//     0/1 masks, is exact;
//   pass 2: dxg_t rounded as it is stored, that rounded value the A
//     operand of dxg_t @ W_hh^T; the dh and dc carries rounded at the end
//     of each step (JAX's carry type).
// The W_hh slice is held as packed bf16 pairs (64 registers a thread at
// H=256; pass 2 reloads W_hh^T's block in k16 B-fragment order), h and the
// dxg slice sit in shared memory in m16n8k16 A-fragment order (`afrag`),
// and a bf16 mask (2 bytes, under cp.async's 4) is loaded into a register
// a step ahead.  dW_hh = hs^T dxg is accumulated in f32 and rounded once
// (the wrapper's product), where JAX's reverse scan carries it as a bf16
// running sum over the T steps: at [332, 32, 256] the port's dW_hh is
// 4.2e-3 of its magnitude from a float64 VJP of the same bf16 inputs,
// JAX's 5.0e-2 (tests/torch_port_bf16_gap.py).  Bound at [332, 32, 256]
// with 75 % of the steps valid: the bf16 bytes, 0.033 ms; the three
// products at the dense bf16 rate, 0.025 ms.
#include "common.cuh"
#include "tc.cuh"

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

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
    static constexpr bool BF = Elt<E>::BF16;
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
    static constexpr int YS = H + (BF ? 8 : 4);
    using P = std::conditional_t<BF, uint32_t, float2>;   // a unit pair
    // shared memory, byte offsets.  Pass 1: h [2][HB] (E, A-fragment
    // order), part [KG][R][PS] (f32), ys [2][R][YS] (E), masks [2][R]
    // (f32), gates [2][RP*4][NLT] (P).  Pass 2, over the same bytes: recv
    // [2][CL][NSLOT] (float4 partials), the CTA's dxg slice [R][COLS] (E,
    // A-fragment order), prefetch [RP*6][NLT] (P), masks [RP][NLT] (f32).
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
                  && O_XG % 16 == 0 && O_PF % 16 == 0 && SMEM <= 232448,
                  "shape");
};

// Index of element (row r, column k) of an [R, KSTEP*ks] operand kept in
// A-fragment order, so that a warp's A operand of one (m-tile, k-step) is
// one conflict-free 16-byte load a lane.  f32 (m16n8k8 tf32): for m-tile
// m, k8-step s and lane l = 4g + c the float4 (r g, k 8s+c), (g+8, 8s+c),
// (g, 8s+c+4), (g+8, 8s+c+4).  bf16 (m16n8k16): for k16-step s the eight
// (g, 16s+2c), (g, 16s+2c+1), (g+8, 16s+2c), (g+8, 16s+2c+1), then the
// same at columns 16s+2c+8 and +9 (K2-bf16's layout); units 2c and 2c+1
// of a row are one word.
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
    constexpr bool BF = S::BF;
    constexpr int H4 = 4 * H;
    constexpr int R = S::R, UC = S::UC, NLT = S::NLT, RP = S::RP;
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
    // pass (f32, split into TF32 hi/lo at each use; or bf16 pairs: rows k,
    // k+1 of one column in a word); pass 2 reloads them.
    typename X::W wr[S::KPW][S::NPW][2];
    {
        const int kg = warp / NG, ng = warp % NG;
#pragma unroll
        for (int ks = 0; ks < S::KPW; ++ks) {
#pragma unroll
            for (int j = 0; j < S::NPW; ++j) {
                const int col = (ng * S::NPW + j) * 8 + g;
                const int c0 = (col / UC) * H + rank * UC + col % UC;
                if constexpr (BF) {
                    const int k = (kg * S::KPW + ks) * 16 + 2 * tig;
                    const E* w = W + (size_t)k * H4 + c0;
                    wr[ks][j][0] = pack_bf16(w[0], w[H4]);
                    wr[ks][j][1] = pack_bf16(w[(size_t)8 * H4],
                                             w[(size_t)9 * H4]);
                } else {
                    const int k = (kg * S::KPW + ks) * 8 + tig;
                    const E* w = W + (size_t)k * H4 + c0;
                    wr[ks][j][0] = w[0];
                    wr[ks][j][1] = w[(size_t)4 * H4];
                }
            }
        }
    }
    {                                                          // h_{-1}
        uint32_t* hw = reinterpret_cast<uint32_t*>(hbuf);
        constexpr int NW = (int)(S::HB * sizeof(E) / 4);
        for (int i = tid; i < NW; i += TC_THREADS) hw[i] = 0u;
    }

    // step t's ys rows and masks (the rebuild's) and this thread's gates,
    // into buffer b; rows past B read as zeros.  A bf16 mask (2 bytes, no
    // cp.async) is loaded into mnext and stored by put_mask.
    float mnext = 0.f;
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
            if constexpr (BF)
                mnext = v ? X::ld(mk + (size_t)t * B + b0 + tid) : 0.f;
            else
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
    auto put_mask = [&](int b) {
        if constexpr (BF)
            if (tid < R) mkb[b * R + tid] = mnext;
    };

    float c[S::PP];
#pragma unroll
    for (int p = 0; p < S::PP; ++p) c[p] = 0.f;
    fetch1(0, 0);
    put_mask(0);
    cp_async_wait_all();
    __syncthreads();
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
                if constexpr (BF) {
                    // bf16 x bf16, f32 accumulation: one mma a k16 step
                    uint4 a[MT];
#pragma unroll
                    for (int m = 0; m < MT; ++m)
                        a[m] = *reinterpret_cast<const uint4*>(
                            hc + ((m * S::KS + s) * 32 + lane) * 8);
#pragma unroll
                    for (int j = 0; j < S::NPW; ++j)
#pragma unroll
                        for (int m = 0; m < MT; ++m)
                            mma_bf16(acc[m][j], a[m], wr[ks][j][0],
                                     wr[ks][j][1]);
                } else {
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
            }
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
                    // bf16 rounds c where K2-bf16 does
                    c[p] = X::rnd(m * (a[1][e] * c[p] + a[0][e] * a[2][e])
                                  + (1.f - m) * c[p]);
                }
                if (valid[rp]) {
                    const size_t row = (size_t)t * B + b0 + r;
                    E* d = dx + row * H4 + U0;
                    // the activated gates, rounded to E for pass 2
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        st2(d + q * H, a[q][0], a[q][1]);
                    if constexpr (BF) {
                        *reinterpret_cast<uint32_t*>(hq + row * H + U0) =
                            *reinterpret_cast<const uint32_t*>(
                                hc + afrag<E, S::KS>(r, U0));
                    } else {
                        st2(hq + row * H + U0, hc[afrag<E, S::KS>(r, U0)],
                            hc[afrag<E, S::KS>(r, U0 + 1)]);
                    }
                    st2(cq + row * H + U0, cp[0], cp[1]);
                }
            }
        }
        // ---- the rebuild: h_t = y_t + (1 - m_t) h_{t-1}, all units ----
        if (t + 1 < T) {
            const E* yb = ysb + cur * R * S::YS;
            const float* mb = mkb + cur * R;
            if constexpr (BF) {
                // one 16-byte chunk (m, s, lane) a thread: rows r, r+8 by
                // units k, k+1, k+8, k+9 (afrag's order)
                const uint4* hp4 = reinterpret_cast<const uint4*>(hc);
                uint4* hn4 = reinterpret_cast<uint4*>(hbuf + (cur ^ 1) * S::HB);
                for (int i = tid; i < S::HB / 8; i += TC_THREADS) {
                    const int r = (i / (S::KS * 32)) * 16 + ((i & 31) >> 2);
                    const int k = ((i >> 5) % S::KS) * 16 + 2 * (i & 3);
                    const float k0 = 1.f - mb[r], k1 = 1.f - mb[r + 8];
                    auto yw = [&](int rr, int kk) {
                        return *reinterpret_cast<const uint32_t*>(
                            yb + rr * S::YS + kk);
                    };
                    const uint4 h = hp4[i];
                    hn4[i] = make_uint4(rebuild2(yw(r, k), h.x, k0),
                                        rebuild2(yw(r + 8, k), h.y, k1),
                                        rebuild2(yw(r, k + 8), h.z, k0),
                                        rebuild2(yw(r + 8, k + 8), h.w, k1));
                }
            } else {
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
            put_mask(cur ^ 1);
        }
        cp_async_wait_all();
        __syncthreads();
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
            if constexpr (BF) {
                const int k = 16 * s + 2 * tig;
                wr[s][j][0] = pack_bf16(wt(k), wt(k + 1));
                wr[s][j][1] = pack_bf16(wt(k + 8), wt(k + 9));
            } else {
                wr[s][j][0] = wt(8 * s + tig);
                wr[s][j][1] = wt(8 * s + tig + 4);
            }
        }
    }
    // step t's activated gates, c_{t-1}, gy_t and mask of this thread's
    // elements (what it wrote in pass 1), zeros past B; a bf16 mask goes
    // to mreg
    float mreg[RP];
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) mreg[rp] = 0.f;
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
            if constexpr (BF)
                mreg[rp] = v ? X::ld(mk + row) : 0.f;
            else
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
        }
        // ---- the cell: dxg_t of this thread's elements ----
        if (nl) {
            cp_async_wait_all();
#pragma unroll
            for (int rp = 0; rp < RP; ++rp) {
                const int r = rrow(rp);
                float2 a[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    a[q] = unpack2(pf[(rp * 6 + q) * NLT + tid]);
                const float2 cp2 = unpack2(pf[(rp * 6 + 4) * NLT + tid]);
                const float2 gy2 = unpack2(pf[(rp * 6 + 5) * NLT + tid]);
                const float m = BF ? mreg[rp] : pm[rp * NLT + tid];
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
                    // dxg_t as it is stored (bf16: rounded, then the
                    // product's operand)
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
                    if constexpr (BF) {
                        st2(atile + afrag<E, S::KS2>(r, k), da[q][0],
                            da[q][1]);
                    } else {
                        atile[afrag<E, S::KS2>(r, k)] = da[q][0];
                        atile[afrag<E, S::KS2>(r, k + 1)] = da[q][1];
                    }
                }
                if (valid[rp]) {
                    E* d = dx + ((size_t)t * B + b0 + r) * H4 + U0;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        st2(d + q * H, da[q][0], da[q][1]);
                }
            }
        }
        if (t == 0) break;            // h_{-1} = 0 is no input: no dh_{-1}
        __syncthreads();

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
            if constexpr (BF) {
                uint4 a[MT];
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    a[m] = *reinterpret_cast<const uint4*>(
                        atile + ((m * S::KS2 + s) * 32 + lane) * 8);
#pragma unroll
                for (int j = 0; j < S::NTU; ++j)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
                        mma_bf16(acc[m][j], a[m], wr[s][j][0], wr[s][j][1]);
            } else {
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
        }
        // the partial of CTA `warp`'s units into its slot for this CTA
        float4* out = recv + ((t & 1) * CL + rank) * S::NSLOT + lane;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < S::NTU; ++j)
                *cluster.map_shared_rank(out + (m * S::NTU + j) * 32, warp) =
                    make_float4(acc[m][j][0], acc[m][j][1], acc[m][j][2],
                                acc[m][j][3]);
        cluster_arrive_release();
        // while the barrier completes: fetch step t-1's operands
        if (nl) fetch2(t - 1);
    }
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
    if (tc_fits(H)) return bwd_tc_dispatch<E>(H, a, s, nullptr);
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
        plan[1] = plan[2] = 0;
        return 0;
    }
    BwdArgs<E> a = {};
    a.B = B;
    return bwd_tc_dispatch<E>(H, a, nullptr, plan);
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
// bf16, the backward of asr_bilstm_bf16).
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

// How asr_bilstm_bwd (asr_bilstm_bwd_bf16) would launch at (B, H), without
// launching: plan[0] batch rows per cluster, plan[1] clusters in the grid,
// plan[2] clusters the card holds at once (cudaOccupancyMaxActiveClusters).
// For the simple kernel (no cluster) plan = {rows a block, 0, 0}.  Returns
// 0 or a cudaError_t.
ASR_API int asr_bilstm_bwd_plan(int B, int H, int* plan) {
    return bwd_plan<float>(B, H, plan);
}

ASR_API int asr_bilstm_bwd_bf16_plan(int B, int H, int* plan) {
    return bwd_plan<bf16>(B, H, plan);
}
