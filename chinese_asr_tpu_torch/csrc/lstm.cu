// K2: bidirectional LSTM time loop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/lstm.py:142
// (`bidir_lstm_time_loop`, body `_kernel` :43): both directions' T-step
// recurrence of one encoder layer,
//   gates = xg_t + h @ W_hh  (i, f, g, o order)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c');  y = h' m
//   h <- y + (1 - m) h;  c <- m c' + (1 - m) c   (mask freezes the carry)
// The input projections xg = x @ W_ih + b are precomputed outside (one
// large matmul per direction), the backward direction already flipped in
// time, so its outputs come back in that flipped order.
//
// What bounds it on the H100: the recurrence is serial in T, and every step
// needs all of W_hh (H x 4H f32: 1 MiB per direction at H=256), over the
// 227 KB of shared memory a block can hold.  Counted against the card, the
// layer is bound by its 2 * 2 * T * B * H * 4H flops (0.51 ms at the f32
// rate at [332, 128, 256]; 0.21 ms as 3xTF32 at a third of the TF32 rate);
// in practice each step is bound by the product's latency on the few SMs
// one row tile can use, by the exchange of h between them and by one
// synchronisation per step.
//
// Three kernels, one contract:
//
// * `bilstm_tc_kernel` (f32, H in {64, 128, 192, 256}; the flagship H=256): a
//   thread-block cluster of 8 CTAs shares one direction and one tile of 16
//   or 32 batch rows (B alone picks: 16 while both directions' clusters fit
//   the card at once, so B <= 224 runs in one wave).  CTA r owns hidden
//   units [r*H/8, (r+1)*H/8), i.e. their 4 gate columns of W_hh: its
//   [H, 4H/8] slice (128 KB at H=256) stays in registers for the whole time
//   loop as the B fragments of `mma.m16n8k8` (128 a thread, 8 warps).  Each
//   step the product h[R, H] @ slice runs on the tensor cores with f32
//   accuracy (3xTF32: lo*hi + hi*lo + hi*hi; h is split with cvt.rna as it
//   is loaded, the slice by truncation at each use); the 8 warps are 2
//   k-halves x 4 column groups, whose partial sums meet in shared memory.
//   The cell update (exact expf/tanhf, c in registers) then writes the
//   CTA's slice of the new h into every CTA of the cluster through
//   distributed shared memory, in A-fragment order; one cluster barrier per
//   step publishes it (h double-buffered), and the y stores and the cp.async
//   of step t+1's gates are issued between its arrive and its wait.
// * `bilstm_kernel` (any other H <= 1024; the golden model's 16): the
//   simple persistent kernel, grid = (batch tiles of 8 rows, 2 above
//   H = 512 where a block has up to 1024 threads and a thread 64
//   registers) x (2 directions); each block owns its rows' h (shared
//   memory) and c (registers) for the whole loop and re-reads W_hh from L2
//   every step; f32 and bf16 instances.
// * `bilstm_bf16_tc_kernel` (bf16 at H in {64, 128, 192, 256}): below.
//
// No block ever waits on a block outside its cluster.
//
// A step of the tensor-core kernel is three serial parts: the products
// (three `mma.sync` per k8 step and tile, the slice split at each use),
// the cell update with its distributed-shared-memory stores, and the
// cluster barrier.  32 rows double the first part, which is why B alone
// picks 16 rows until the grid would need a second wave.
// Left for later: `wgmma` for the step's product; the bf16 kernel's bulk
// copies on mbarriers in place of the cluster barrier (in bf16 the
// barrier's exchange was 2.7 of a 3.6 us step, PERF.md); 16-CTA clusters
// so that B=128 uses 128 SMs.
//
// K2-bf16 (`asr_bilstm_bf16`, for compute_dtype="bfloat16"; JAX runs a
// bf16 layer through a lax.scan whose carry is bf16,
// chinese_asr_tpu/ops/rnn.py:246 `_bidir_core_scan`): xg, the masks, W_hh
// and every output are bf16; h @ W_hh is bf16 x bf16 products with f32
// accumulation (`mma.m16n8k16`: one mma a k16 step and tile where f32
// takes three a k8 step), xg_t is added in f32, the cell update is f32
// (exact expf / tanhf), and y, h and c are rounded to bf16 at the end of
// each step.  Its cluster kernel, `bilstm_bf16_tc_kernel` below, has a
// plan and an exchange of its own (16 rows a cluster of 8 or 4 CTAs, h
// sent as bulk copies completing on mbarriers); at other H it runs the
// simple kernel's bf16 instance.  Bound at [332, 128, 256]: 2 * 2 * T * B
// * H * 4H flops at the dense bf16 rate, 0.035 ms; bytes 0.06 ms.
//
// The f32 tensor-core kernel below is float only: its template parameter
// E is float (the bf16 kernel has its own template).
#include "common.cuh"
#include "stamp.cuh"
#include "tc.cuh"

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// phase sums of the measurement build (stamp.cuh; empty in the product)
STAMP_EXPORT(asr_stamp_lstm, asr_stamp_read_lstm, asr_stamp_ctas_lstm)

namespace {

// ---------------------------------------------------------------------------
// tensor-core cluster kernel (CL, TC_THREADS and the helpers: tc.cuh)
// ---------------------------------------------------------------------------
constexpr int KG = 2;              // 8 warps = 2 k-groups x 4 n-groups
constexpr int NG = 4;

// The shapes of one instantiation: operand type E, hidden size H (a
// multiple of 64, at most 256), MT m16 tiles of batch rows per cluster.
template <typename E, int H, int MT>
struct TcShape {
    static constexpr int KSTEP = Elt<E>::KSTEP;
    static constexpr int UC = H / CL;       // hidden units of one CTA
    static constexpr int COLS = 4 * UC;     // its gate columns (q*UC + u)
    static constexpr int NT = COLS / 8;     // n8 tiles of those columns
    static constexpr int NPW = NT / NG;     // n-tiles of one warp
    static constexpr int KS = H / KSTEP;    // mma k-steps over h
    static constexpr int KPW = KS / KG;     // k-steps of one warp
    static constexpr int SPC = UC / 8;      // 8-unit groups one CTA produces
    static constexpr int R = 16 * MT;       // batch rows of one cluster
    static constexpr int PS = COLS + 8;     // partial-sum row stride
    static constexpr int HBUF = MT * 16 * H;       // elements of one h buffer
    static constexpr int NSLOT = MT * SPC * 32;    // 4-element slots of a slice
    // (row, unit) pairs per thread of the cell update: the four of a slot,
    // or two where the CTA has the threads
    static constexpr int PP = 2 * NSLOT <= TC_THREADS ? 2 : 4;
    static constexpr int NLT = NSLOT * 4 / PP;     // threads of the cell update
    // 32-bit words of one thread's prefetched gates: 4 gates of each pair
    static constexpr int XGW = 4 * PP;
    static constexpr size_t SMEM = (size_t)2 * HBUF * sizeof(E)
        + (size_t)(KG * R * PS + XGW * NLT) * sizeof(float);
    static_assert(H % 64 == 0 && NPW >= 1 && NLT <= TC_THREADS
                  && KS % KG == 0 && !Elt<E>::BF16, "shape");
};

// h lives in shared memory in A-fragment order (m16n8k8, tf32): for
// m-tile m, k8-step s and lane l = 4g + c, the float4
//   h(g, 8s+c), h(g+8, 8s+c), h(g, 8s+c+4), h(g+8, 8s+c+4)
// (rows within the m-tile, units over H), so a warp's A operand of one
// (m, s) is one conflict-free float4 load, split into TF32 hi and lo as it
// is loaded.  The unit group of 8 units 8j .. 8j+7 of one m-tile is a
// "slot" per lane: 4 elements, 16 bytes at k8-step j; element e of a slot
// is row g + 8 (e & 1), unit c + 4 (e >> 1).  The threads of the cell
// update that own a slot's elements write them with one store into every
// CTA of the cluster.
template <typename E, int H, int MT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(TC_THREADS, 1)
bilstm_tc_kernel(const E* __restrict__ xg_f,
                 const E* __restrict__ xg_b,
                 const E* __restrict__ m_f,
                 const E* __restrict__ m_b,
                 const E* __restrict__ w_hh,
                 E* __restrict__ ys_f,
                 E* __restrict__ ys_b,
                 E* __restrict__ hT,
                 E* __restrict__ cT,
                 int T, int B) {
    using S = TcShape<E, H, MT>;
    using X = Elt<E>;
    STAMP_BEGIN;
    extern __shared__ float4 smem4[];
    E* hbuf = reinterpret_cast<E*>(smem4);           // [2][MT][KS][32][4]
    float* part = reinterpret_cast<float*>(hbuf + 2 * S::HBUF);  // [KG][R][PS]
    float* xgs = part + KG * S::R * S::PS;           // [XGW][NLT] gates
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    constexpr int H4 = 4 * H;
    const int dir = blockIdx.y;
    const int b0 = (blockIdx.x / CL) * S::R;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int kg = warp / NG, ng = warp % NG;
    const E* xg = dir ? xg_b : xg_f;
    const E* mk = dir ? m_b : m_f;
    E* ys = dir ? ys_b : ys_f;
    const E* W = w_hh + (size_t)dir * H * H4;

    // This warp's B fragments of the W_hh slice stay in registers for the
    // whole time loop (split into TF32 hi/lo at each use).
    typename X::W wr[S::KPW][S::NPW][2];
#pragma unroll
    for (int ks = 0; ks < S::KPW; ++ks) {
#pragma unroll
        for (int j = 0; j < S::NPW; ++j) {
            const int col = (ng * S::NPW + j) * 8 + g;
            const int q = col / S::UC, u = col % S::UC;
            const int k = (kg * S::KPW + ks) * 8 + tig;
            const E* w = W + (size_t)k * H4 + q * H + rank * S::UC + u;
            wr[ks][j][0] = w[0];
            wr[ks][j][1] = w[(size_t)4 * H4];
        }
    }
    {
        uint32_t* hw = reinterpret_cast<uint32_t*>(hbuf);
        constexpr int NW = (int)(2 * S::HBUF * sizeof(E) / 4);
        for (int i = tid; i < NW; i += TC_THREADS) hw[i] = 0u;
    }
    // every CTA's buffers are zero before any CTA of the cluster writes
    cluster.sync();

    // cell-update role: elements e = p + 2 uh (p < PP) of one slot (all
    // four, or the two of half uh)
    constexpr int PP = S::PP;
    const bool nl = tid < S::NLT;
    const int slot = tid % S::NSLOT, uh = PP == 2 ? tid / S::NSLOT : 0;
    const int sl = (slot >> 5) % S::SPC;             // unit group of this CTA
    const int mm = slot / (32 * S::SPC);             // m-tile
    const int rr = mm * 16 + g;                      // row in the cluster
    const int row0 = b0 + rr;
    const bool valid0 = nl && row0 < B, valid1 = nl && row0 + 8 < B;
    const int ub = rank * S::UC + sl * 8;            // first unit of the group
    // the slot's place in the fragment order of the h buffers
    const int ug8 = rank * S::SPC + sl;
    const int dst = ((mm * S::KS + ug8) * 32 + lane) * 4 + 2 * uh;
    // row bit and unit offset (within the group) of element e
    auto rowbit = [](int e) { return e & 1; };
    auto uoff = [&](int e) { return tig + 4 * (e >> 1); };
    // gates of step t for this thread's pairs, brought into shared memory
    // by cp.async (zeros for rows past B) one step ahead: one word a
    // (pair, gate) at xgs[(p*4 + q)*NLT + tid]
    auto fetch = [&](int t) {
#pragma unroll
        for (int p = 0; p < PP; ++p) {
            const int e = p + 2 * uh;
            const bool v = rowbit(e) ? valid1 : valid0;
            const E* x = xg + ((size_t)t * B + row0 + 8 * rowbit(e)) * H4
                         + ub + uoff(e);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                cp_async<4>(xgs + (p * 4 + q) * S::NLT + tid,
                            v ? x + q * H : xg, v);
        }
        cp_async_commit();
    };
    auto xgate = [&](int p, int q) -> float {
        return xgs[(p * 4 + q) * S::NLT + tid];
    };
    float h[PP], c[PP], nm0 = 0.f, nm1 = 0.f;
#pragma unroll
    for (int p = 0; p < PP; ++p) {
        h[p] = 0.f;
        c[p] = 0.f;
    }
    if (nl && T > 0) {
        fetch(0);
        if (valid0) nm0 = X::ld(mk + row0);
        if (valid1) nm1 = X::ld(mk + row0 + 8);
    }

    STAMP(7);                                        // prologue
    int cur = 0;
    for (int t = 0; t < T; ++t) {
        // ---- gates' h @ W_hh part on the tensor cores ----
        const E* hc = hbuf + cur * S::HBUF;
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
            // the three products term by term, so that consecutive mma
            // instructions use different accumulators
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
        STAMP(0);                                    // products
        // partial sums of this k-group: rows g, g+8 of each m-tile, columns
        // 2c, 2c+1 of each n-tile
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int j = 0; j < S::NPW; ++j) {
                const int col = (ng * S::NPW + j) * 8 + 2 * tig;
                float* p0 = part + (kg * S::R + m * 16 + g) * S::PS + col;
                *reinterpret_cast<float2*>(p0) =
                    make_float2(acc[m][j][0], acc[m][j][1]);
                *reinterpret_cast<float2*>(p0 + 8 * S::PS) =
                    make_float2(acc[m][j][2], acc[m][j][3]);
            }
        }
        __syncthreads();
        STAMP(1);                                    // partials, barrier

        // ---- the cell update (f32, exact expf / tanhf) ----
        float y[PP];
        if (nl) {
            cp_async_wait_all();
            STAMP(2);                                // the gates' arrival
#pragma unroll
            for (int p = 0; p < PP; ++p) {
                const int e = p + 2 * uh;
                const int r = rr + 8 * rowbit(e);
                const int u = sl * 8 + uoff(e);
                float gt[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int o = r * S::PS + q * S::UC + u;
                    gt[q] = xgate(p, q)
                            + (part[o] + part[S::R * S::PS + o]);
                }
                const float m = rowbit(e) ? nm1 : nm0;
                const float ig = sigmoid(gt[0]);
                const float fg = sigmoid(gt[1]);
                const float gg = tanhf(gt[2]);
                const float og = sigmoid(gt[3]);
                const float c2 = fg * c[p] + ig * gg;
                const float h2 = og * tanhf(c2);
                y[p] = X::rnd(h2 * m);
                h[p] = X::rnd(y[p] + (1.f - m) * h[p]);
                c[p] = X::rnd(m * c2 + (1.f - m) * c[p]);
            }
            STAMP(3);                                // cell update
            // publish this CTA's slice of the new h to the whole cluster
            E* d = hbuf + (cur ^ 1) * S::HBUF + dst;
            if constexpr (PP == 4) {
                float4* d4 = reinterpret_cast<float4*>(d);
                const float4 v = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
                for (int q = 0; q < CL; ++q)
                    *cluster.map_shared_rank(d4, q) = v;
            } else {
                float2* d2 = reinterpret_cast<float2*>(d);
                const float2 v = make_float2(h[0], h[1]);
#pragma unroll
                for (int q = 0; q < CL; ++q)
                    *cluster.map_shared_rank(d2, q) = v;
            }
            STAMP(4);                                // remote stores
        }
        cluster_arrive_release();
        // while the barrier completes: store y, fetch step t+1's gates
        if (nl) {
#pragma unroll
            for (int p = 0; p < PP; ++p) {
                const int e = p + 2 * uh;
                if (rowbit(e) ? valid1 : valid0)
                    ys[((size_t)t * B + row0 + 8 * rowbit(e)) * H + ub
                       + uoff(e)] = y[p];
            }
            if (t + 1 < T) {
                fetch(t + 1);
                if (valid0) nm0 = X::ld(mk + (size_t)(t + 1) * B + row0);
                if (valid1) nm1 = X::ld(mk + (size_t)(t + 1) * B + row0 + 8);
            }
        }
        STAMP(5);                        // arrive, y stores, next fetch
        cluster_wait_acquire();
        STAMP(6);                                    // cluster barrier
        cur ^= 1;
    }

#pragma unroll
    for (int p = 0; p < PP; ++p) {
        const int e = p + 2 * uh;
        if (rowbit(e) ? valid1 : valid0) {
            const size_t o = ((size_t)dir * B + row0 + 8 * rowbit(e)) * H
                             + ub + uoff(e);
            X::st(hT + o, h[p]);
            X::st(cT + o, c[p]);
        }
    }
    STAMP(8);                                        // epilogue
    STAMP_END(asr_stamp_lstm);
}

// The operands of one call of either kernel.
template <typename E>
struct Args {
    const E *xg_f, *xg_b, *m_f, *m_b, *w_hh;
    E *ys_f, *ys_b, *hT, *cT;
    int T, B;
};

template <typename E, int H, int MT>
int tc_launch(const Args<E>& a, cudaStream_t s, int* plan) {
    using S = TcShape<E, H, MT>;
    const int rc = asr_allow_smem(bilstm_tc_kernel<E, H, MT>, S::SMEM);
    if (rc) return rc;
    const dim3 grid((a.B + S::R - 1) / S::R * CL, 2);
    if (plan) {                 // rows per cluster, clusters, max resident
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(TC_THREADS);
        cfg.dynamicSmemBytes = S::SMEM;
        int n = 0;
        const cudaError_t e = cudaOccupancyMaxActiveClusters(
            &n, (const void*)bilstm_tc_kernel<E, H, MT>, &cfg);
        if (e != cudaSuccess) return (int)e;
        plan[0] = S::R;
        plan[1] = (int)(grid.x / CL * grid.y);
        plan[2] = n;
        plan[3] = CL;
        return 0;
    }
    bilstm_tc_kernel<E, H, MT><<<grid, TC_THREADS, S::SMEM, s>>>(
        a.xg_f, a.xg_b, a.m_f, a.m_b, a.w_hh, a.ys_f, a.ys_b, a.hT, a.cT, a.T,
        a.B);
    return (int)cudaGetLastError();
}

template <typename E, int H>
int tc_dispatch_mt(const Args<E>& a, cudaStream_t s, int* plan) {
    if (tc_mtiles(a.B) == 1) return tc_launch<E, H, 1>(a, s, plan);
    return tc_launch<E, H, 2>(a, s, plan);
}

template <typename E>
int tc_dispatch(int H, const Args<E>& a, cudaStream_t s, int* plan) {
    switch (H) {
    case 64:
        return tc_dispatch_mt<E, 64>(a, s, plan);
    case 128:
        return tc_dispatch_mt<E, 128>(a, s, plan);
    case 192:
        return tc_dispatch_mt<E, 192>(a, s, plan);
    default:
        return tc_dispatch_mt<E, 256>(a, s, plan);
    }
}

// ---------------------------------------------------------------------------
// K2-bf16's cluster kernel: a plan and an exchange of its own
// ---------------------------------------------------------------------------
// CLB CTAs (8 or 4, tc.cuh `bf16_ctas`) share one direction and 16 batch
// rows; CTA r owns units [r*H/CLB, (r+1)*H/CLB) and their 4 gate columns,
// whose W_hh slice stays in registers as packed bf16 pairs, 64 registers a
// thread at H = 256 (256 threads a CTA of 8, 512 a CTA of 4, so that a
// thread's share of the product and of the cell is the same in both).  The
// step is the f32 kernel's (K2's product with one bf16 mma a k16 step,
// partial sums of the two k-halves in shared memory, the cell in f32, exact
// expf / tanhf), but h is laid out so that a CTA's slice of it is one
// contiguous block (below), and travels as bulk copies: the cell threads
// write the new slice into their own CTA's next h buffer, and after a block
// barrier CLB - 1 threads each copy the block into one other CTA's buffer
// with `cp.async.bulk`, completing on that CTA's mbarrier of the buffer; a
// CTA waits for its own barrier (the other slices of h_t) before the next
// product, never for the whole cluster.  The gates of step t+1 come in
// 16-byte cp.async chunks spread over all threads, issued while h_t
// travels.
//
// The exchanges timed against this one at [332, B, 256] on an H100 80GB
// HBM3 at 700 W (tools/lstm_stamp.py, PERF.md) and then deleted: every
// cell thread storing its h into every CTA and one cluster barrier a step
// (the f32 kernel's): 0.997 ms at B=32 (8 CTAs), 1.179 ms at B=128 (4
// CTAs of 512 threads), against 0.750 and 1.009 ms in the same call; the
// same stores as st.async on the mbarriers: 1.213 ms at B=32, 1.197 at
// B=128 (256 threads), each 4- or 8-byte remote store a transaction of
// its own.  Clusters of 8 at B=128 need 16 of the card's 15: two waves,
// 1.390 ms; clusters of 4 at B=32 double a CTA's share: 0.989 ms.
//
// h in shared memory: unit group j (units 8j .. 8j+7) is 32 lanes x 4
// bf16, lane l = 4g + c holding h(g, 8j+2c), h(g, 8j+2c+1), h(g+8, 8j+2c),
// h(g+8, 8j+2c+1); a warp's A operand of k16 step s is groups 2s and
// 2s+1 of its lane (two conflict-free 8-byte loads), and CTA r's units
// are groups [r SPC, (r+1) SPC), SPC * 256 contiguous bytes.
template <int H, int CLB>
struct Bf16Shape {
    static constexpr int THREADS = 2048 / CLB;  // 64 warps a cluster
    static constexpr int NGW = THREADS / 32 / KG;   // column groups
    static constexpr int UC = H / CLB;      // hidden units of one CTA
    static constexpr int COLS = 4 * UC;     // its gate columns (q*UC + u)
    static constexpr int NPW = COLS / 8 / NGW;  // n8 tiles of one warp
    static constexpr int KS = H / 16;       // k16 steps over h
    static constexpr int KPW = KS / KG;     // k-steps of one warp
    static constexpr int SPC = UC / 8;      // 8-unit groups of one CTA
    static constexpr int R = 16;            // batch rows of one cluster
    static constexpr int PS = COLS + 8;     // partial-sum row stride
    static constexpr int HBUF = R * H;      // elements of one h buffer
    static constexpr int NSLOT = SPC * 32;  // 4-element slots of a slice
    static constexpr int PP = 2 * NSLOT <= THREADS ? 2 : 4;
    static constexpr int NLT = NSLOT * 4 / PP;  // threads of the cell
    static constexpr int SLICE = SPC * 256; // bytes of one CTA's slice of h
    // a step's gates of the CTA's units: a row's 4 x UC, padded so that
    // the 8 rows of a warp's reads fall in different banks
    static constexpr int XR = COLS + 8;     // row stride, elements
    static constexpr int NCH = R * COLS / 8;    // 16-byte chunks a step
    // shared memory, bytes: h [2][HBUF] bf16, part [KG][R][PS] f32, gates
    // [R][XR] bf16, the two h buffers' mbarriers
    static constexpr size_t O_PART = (size_t)2 * HBUF * 2;
    static constexpr size_t O_XG = O_PART + (size_t)KG * R * PS * 4;
    static constexpr size_t O_BAR = O_XG + (size_t)R * XR * 2;
    static constexpr size_t SMEM = O_BAR + 16;
    static_assert(H % 64 == 0 && NPW >= 1 && NLT <= THREADS
                  && COLS % (8 * NGW) == 0 && KS % KG == 0
                  && O_XG % 16 == 0 && XR * 2 % 16 == 0 && O_BAR % 8 == 0,
                  "shape");
};

template <int H, int CLB>
__global__ void __launch_bounds__(2048 / CLB, 1)
bilstm_bf16_tc_kernel(const bf16* __restrict__ xg_f,
                      const bf16* __restrict__ xg_b,
                      const bf16* __restrict__ m_f,
                      const bf16* __restrict__ m_b,
                      const bf16* __restrict__ w_hh,
                      bf16* __restrict__ ys_f,
                      bf16* __restrict__ ys_b,
                      bf16* __restrict__ hT,
                      bf16* __restrict__ cT,
                      int T, int B) {
    using S = Bf16Shape<H, CLB>;
    using X = Elt<bf16>;
    STAMP_BEGIN;
    extern __shared__ float4 smem4[];
    char* smc = reinterpret_cast<char*>(smem4);
    bf16* hbuf = reinterpret_cast<bf16*>(smc);           // [2][H/8][32][4]
    float* part = reinterpret_cast<float*>(smc + S::O_PART);
    bf16* xgb = reinterpret_cast<bf16*>(smc + S::O_XG);  // [R][XR]
    uint64_t* bar = reinterpret_cast<uint64_t*>(smc + S::O_BAR);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    constexpr int H4 = 4 * H;
    const int dir = blockIdx.y;
    const int b0 = (blockIdx.x / CLB) * S::R;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int kg = warp / S::NGW, ng = warp % S::NGW;
    const bf16* xg = dir ? xg_b : xg_f;
    const bf16* mk = dir ? m_b : m_f;
    bf16* ys = dir ? ys_b : ys_f;
    const bf16* W = w_hh + (size_t)dir * H * H4;

    // this warp's B fragments of the W_hh slice: rows k, k+1 of one column
    // in a word, for the whole time loop
    uint32_t wr[S::KPW][S::NPW][2];
#pragma unroll
    for (int ks = 0; ks < S::KPW; ++ks) {
#pragma unroll
        for (int j = 0; j < S::NPW; ++j) {
            const int col = (ng * S::NPW + j) * 8 + g;
            const int q = col / S::UC, u = col % S::UC;
            const int k = (kg * S::KPW + ks) * 16 + 2 * tig;
            const bf16* w = W + (size_t)k * H4 + q * H + rank * S::UC + u;
            wr[ks][j][0] = pack_bf16(w[0], w[H4]);
            wr[ks][j][1] = pack_bf16(w[(size_t)8 * H4], w[(size_t)9 * H4]);
        }
    }
    {
        uint32_t* hw = reinterpret_cast<uint32_t*>(hbuf);
        for (int i = tid; i < S::HBUF; i += S::THREADS) hw[i] = 0u;
    }
    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        mbar_init_fence();
    }
    // every CTA's buffers and barriers are ready before any CTA writes
    cluster.sync();

    // the cell role: elements e = p + 2 uh (p < PP) of one slot, rows
    // g + 8 (e >> 1), units 2c + (e & 1) of unit group sl
    constexpr int PP = S::PP;
    const bool nl = tid < S::NLT;
    const int slot = tid % S::NSLOT, uh = PP == 2 ? tid / S::NSLOT : 0;
    const int sl = slot >> 5;
    const int row0 = b0 + g;
    const bool valid0 = nl && row0 < B, valid1 = nl && row0 + 8 < B;
    const int ub = rank * S::UC + sl * 8;            // first unit of the group
    const int dst = ((rank * S::SPC + sl) * 32 + lane) * 4 + 2 * uh;
    // gates of step t (zeros for rows past B) and this thread's masks
    float nm0 = 0.f, nm1 = 0.f;
    auto fetch = [&](int t) {
        constexpr int CPR = S::COLS / 8, CPS = S::UC / 8;  // chunks a row, gate
        for (int i = tid; i < S::NCH; i += S::THREADS) {
            const int r = i / CPR, q = i % CPR / CPS, u = i % CPS * 8;
            const bool v = b0 + r < B;
            cp_async<16>(xgb + r * S::XR + q * S::UC + u,
                         v ? xg + ((size_t)t * B + b0 + r) * H4 + q * H
                                 + rank * S::UC + u
                           : xg, v);
        }
        cp_async_commit();
        if (valid0) nm0 = X::ld(mk + (size_t)t * B + row0);
        if (valid1) nm1 = X::ld(mk + (size_t)t * B + row0 + 8);
    };
    float h[PP], c[PP];
#pragma unroll
    for (int p = 0; p < PP; ++p) {
        h[p] = 0.f;
        c[p] = 0.f;
    }
    if (T > 0) fetch(0);
    STAMP(7);                                        // prologue

    for (int t = 0; t < T; ++t) {
        const int cur = t & 1;
        const bool send = t + 1 < T;                 // h_t has a reader
        if (tid == 0 && send)
            mbar_expect(&bar[cur ^ 1], (CLB - 1) * S::SLICE);
        // ---- gates' h @ W_hh part: bf16 x bf16, f32 accumulation ----
        const bf16* hc = hbuf + cur * S::HBUF;
        float acc[S::NPW][4];
#pragma unroll
        for (int j = 0; j < S::NPW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < S::KPW; ++ks) {
            const bf16* ha = hc + ((kg * S::KPW + ks) * 64 + lane) * 4;
            const uint2 lo = *reinterpret_cast<const uint2*>(ha);
            const uint2 hi = *reinterpret_cast<const uint2*>(ha + 128);
            const uint4 a = make_uint4(lo.x, lo.y, hi.x, hi.y);
#pragma unroll
            for (int j = 0; j < S::NPW; ++j)
                mma_bf16(acc[j], a, wr[ks][j][0], wr[ks][j][1]);
        }
        STAMP(0);                                    // products
#pragma unroll
        for (int j = 0; j < S::NPW; ++j) {
            const int col = (ng * S::NPW + j) * 8 + 2 * tig;
            float* p0 = part + (kg * S::R + g) * S::PS + col;
            *reinterpret_cast<float2*>(p0) = make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(p0 + 8 * S::PS) =
                make_float2(acc[j][2], acc[j][3]);
        }
        cp_async_wait_all();                         // this thread's gates
        __syncthreads();                             // partials, all gates
        STAMP(1);                                    // partials, barrier

        // ---- the cell update (f32, exact expf / tanhf) ----
        float y[PP];
        if (nl) {
#pragma unroll
            for (int p = 0; p < PP; ++p) {
                const int e = p + 2 * uh;
                const int r = g + 8 * (e >> 1);
                const int u = sl * 8 + 2 * tig + (e & 1);
                float gt[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int o = r * S::PS + q * S::UC + u;
                    gt[q] = __bfloat162float(xgb[r * S::XR + q * S::UC + u])
                            + (part[o] + part[S::R * S::PS + o]);
                }
                const float m = (e >> 1) ? nm1 : nm0;
                const float ig = sigmoid(gt[0]);
                const float fg = sigmoid(gt[1]);
                const float gg = tanhf(gt[2]);
                const float og = sigmoid(gt[3]);
                const float c2 = fg * c[p] + ig * gg;
                const float h2 = og * tanhf(c2);
                // the carry's precision: y, h and c rounded to bf16 here
                y[p] = X::rnd(h2 * m);
                h[p] = X::rnd(y[p] + (1.f - m) * h[p]);
                c[p] = X::rnd(m * c2 + (1.f - m) * c[p]);
            }
            STAMP(3);                                // cell update
            // this thread's new h into its CTA's next buffer
            if (send) {
                bf16* d = hbuf + (cur ^ 1) * S::HBUF + dst;
                const uint32_t v0 = pack_bf16(h[0], h[1]);
                if constexpr (PP == 4)
                    *reinterpret_cast<uint2*>(d) =
                        make_uint2(v0, pack_bf16(h[2], h[3]));
                else
                    *reinterpret_cast<uint32_t*>(d) = v0;
                fence_proxy_async();                 // for the bulk copies
            }
            STAMP(4);                                // the slice's stores
        }
        if (send) {
            __syncthreads();        // the slice is whole, the gates read
            if (tid < CLB - 1) {
                // one thread a destination: the slice to CTA q
                const int q = (rank + 1 + tid) % CLB;
                const uint32_t src = smem_u32(hbuf + (cur ^ 1) * S::HBUF)
                                     + rank * S::SLICE;
                bulk_copy_cluster(cluster_u32(src, q), src, S::SLICE,
                                  cluster_u32(smem_u32(&bar[cur ^ 1]), q));
            }
        }
        // while h_t travels: store y, fetch step t+1's gates and masks
        if (nl) {
#pragma unroll
            for (int rp = 0; rp < PP / 2; ++rp) {
                const int rb = rp + uh;
                if (rb ? valid1 : valid0)
                    *reinterpret_cast<uint32_t*>(
                        ys + ((size_t)t * B + row0 + 8 * rb) * H + ub
                        + 2 * tig) = pack_bf16(y[2 * rp], y[2 * rp + 1]);
            }
        }
        if (send) fetch(t + 1);
        STAMP(5);                    // block barrier, copies, y, next fetch
        // buffer cur ^ 1 fills at the steps of one parity: phase t / 2
        if (send) mbar_wait(&bar[cur ^ 1], (t >> 1) & 1);
        STAMP(6);                                    // the exchange's wait
    }

#pragma unroll
    for (int p = 0; p < PP; ++p) {
        const int e = p + 2 * uh;
        if ((e >> 1) ? valid1 : valid0) {
            const size_t o = ((size_t)dir * B + row0 + 8 * (e >> 1)) * H + ub
                             + 2 * tig + (e & 1);
            X::st(hT + o, h[p]);
            X::st(cT + o, c[p]);
        }
    }
    // no CTA leaves while a copy of the cluster may still be in flight
    cluster.sync();
    STAMP(8);                                        // epilogue
    STAMP_END(asr_stamp_lstm);
}

template <int H, int CLB>
int bf16_launch(const Args<bf16>& a, cudaStream_t s, int* plan) {
    using S = Bf16Shape<H, CLB>;
    const dim3 grid((a.B + S::R - 1) / S::R * CLB, 2);
    return launch_clusters(bilstm_bf16_tc_kernel<H, CLB>, CLB, S::R,
                           S::THREADS, grid, S::SMEM, s, plan, a.xg_f,
                           a.xg_b, a.m_f, a.m_b, a.w_hh, a.ys_f, a.ys_b,
                           a.hT, a.cT, a.T, a.B);
}

template <int H>
int bf16_dispatch_cl(const Args<bf16>& a, cudaStream_t s, int* plan) {
    if (STAMP_CTAS(bf16_ctas(a.B)) == 8) return bf16_launch<H, 8>(a, s, plan);
    return bf16_launch<H, 4>(a, s, plan);
}

int bf16_dispatch(int H, const Args<bf16>& a, cudaStream_t s, int* plan) {
    switch (H) {
    case 64:
        return bf16_dispatch_cl<64>(a, s, plan);
    case 128:
        return bf16_dispatch_cl<128>(a, s, plan);
    case 192:
        return bf16_dispatch_cl<192>(a, s, plan);
    default:
        return bf16_dispatch_cl<256>(a, s, plan);
    }
}

// ---------------------------------------------------------------------------
// simple per-block kernel
// ---------------------------------------------------------------------------
// BT batch rows a block, one thread a hidden unit.  A thread keeps ~12 f32
// values a row live (h, c, the prefetched gates and mask, the sums), so 8
// rows fit the 128 registers a thread of a 512-thread block may use, and
// 2 rows (with fewer W_hh loads in flight) the 64 of a 1024-thread block
// (H > 512).
inline int simple_rows(int H) {
    return (H + 31) / 32 * 32 <= 512 ? 8 : 2;
}

template <typename E, int BT>
__global__ void __launch_bounds__(BT == 8 ? 512 : 1024)
bilstm_kernel(const E* __restrict__ xg_f,
              const E* __restrict__ xg_b,
              const E* __restrict__ m_f,
              const E* __restrict__ m_b,
              const E* __restrict__ w_hh,
              E* __restrict__ ys_f,
              E* __restrict__ ys_b,
              E* __restrict__ hT,
              E* __restrict__ cT,
              int T, int B, int H) {
    using X = Elt<E>;
    extern __shared__ float hs[];  // [2][BT][H]
    const int dir = blockIdx.y;
    const int b0 = blockIdx.x * BT;
    const int nb = min(BT, B - b0);
    const int j = threadIdx.x;
    const bool active = j < H;
    const int H4 = 4 * H;
    const E* xg = dir ? xg_b : xg_f;
    const E* mk = dir ? m_b : m_f;
    E* ys = dir ? ys_b : ys_f;
    const E* W = w_hh + (size_t)dir * H * H4;

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
                const E* x = xg + ((size_t)b0 + b) * H4 + j;
#pragma unroll
                for (int g = 0; g < 4; ++g) nx[b][g] = X::ld(x + g * H);
                nm[b] = X::ld(mk + b0 + b);
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
                        const E* x =
                            xg + ((size_t)(t + 1) * B + b0 + b) * H4 + j;
#pragma unroll
                        for (int g = 0; g < 4; ++g)
                            nx[b][g] = X::ld(x + g * H);
                        nm[b] = X::ld(mk + (size_t)(t + 1) * B + b0 + b);
                    }
                }
            }
            const E* wj = W + j;
#pragma unroll(BT == 8 ? 4 : 2)
            for (int kk = 0; kk < H; ++kk) {
                const E* wr = wj + (size_t)kk * H4;
                const float w0 = X::ldg(wr);
                const float w1 = X::ldg(wr + H);
                const float w2 = X::ldg(wr + 2 * H);
                const float w3 = X::ldg(wr + 3 * H);
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
                    // the carry's precision: bf16 rounds y, h and c here
                    const float y = X::rnd(h2 * m[b]);
                    h[b] = X::rnd(y + (1.f - m[b]) * h[b]);
                    c[b] = X::rnd(m[b] * c2 + (1.f - m[b]) * c[b]);
                    X::st(ys + ((size_t)t * B + b0 + b) * H + j, y);
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
                X::st(hT + o, h[b]);
                X::st(cT + o, c[b]);
            }
        }
    }
}

template <typename E, int BT>
int simple_launch(const Args<E>& a, int H, cudaStream_t s) {
    const size_t smem = (size_t)2 * BT * H * sizeof(float);
    const int rc = asr_allow_smem(bilstm_kernel<E, BT>, smem);
    if (rc) return rc;
    const int threads = (H + 31) / 32 * 32;
    const dim3 grid((a.B + BT - 1) / BT, 2);
    bilstm_kernel<E, BT><<<grid, threads, smem, s>>>(
        a.xg_f, a.xg_b, a.m_f, a.m_b, a.w_hh, a.ys_f, a.ys_b, a.hT, a.cT, a.T,
        a.B, H);
    return (int)cudaGetLastError();
}

template <typename E>
int bilstm_entry(const Args<E>& a, int H, void* stream) {
    if (a.B <= 0 || H <= 0) return 0;
    if (H > 1024) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (tc_fits(H)) {
        if constexpr (Elt<E>::BF16) return bf16_dispatch(H, a, s, nullptr);
        else return tc_dispatch<E>(H, a, s, nullptr);
    }
    if (simple_rows(H) == 8) return simple_launch<E, 8>(a, H, s);
    return simple_launch<E, 2>(a, H, s);
}

template <typename E>
int bilstm_plan(int B, int H, int* plan) {
    if (B <= 0 || H <= 0 || H > 1024) return (int)cudaErrorInvalidValue;
    if (!tc_fits(H)) {
        plan[0] = simple_rows(H);
        plan[1] = plan[2] = plan[3] = 0;
        return 0;
    }
    Args<E> a = {};
    a.B = B;
    if constexpr (Elt<E>::BF16) return bf16_dispatch(H, a, nullptr, plan);
    else return tc_dispatch<E>(H, a, nullptr, plan);
}

}  // namespace

// xg_f, xg_b [T, B, 4H]; m_f, m_b [T, B]; w_hh [2, H, 4H] ->
// ys_f, ys_b [T, B, H]; hT, cT [2, B, H].  All float32 and contiguous.
// H alone picks the kernel (the tensor-core cluster kernel for H in
// {64, 128, 192, 256}, else the simple one), B alone its rows per cluster.
ASR_API int asr_bilstm(const float* xg_f, const float* xg_b, const float* m_f,
                       const float* m_b, const float* w_hh, float* ys_f,
                       float* ys_b, float* hT, float* cT, int T, int B, int H,
                       void* stream) {
    const Args<float> a = {xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, hT, cT,
                           T, B};
    return bilstm_entry<float>(a, H, stream);
}

// The same contract with every operand bf16 (xg 4-byte aligned).
ASR_API int asr_bilstm_bf16(const bf16* xg_f, const bf16* xg_b,
                            const bf16* m_f, const bf16* m_b,
                            const bf16* w_hh, bf16* ys_f, bf16* ys_b,
                            bf16* hT, bf16* cT, int T, int B, int H,
                            void* stream) {
    const Args<bf16> a = {xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, hT, cT,
                          T, B};
    return bilstm_entry<bf16>(a, H, stream);
}

// How asr_bilstm (asr_bilstm_bf16) would launch at (B, H), without
// launching: plan[0] batch rows per cluster, plan[1] clusters in the grid,
// plan[2] clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// plan[3] CTAs a cluster.  For the simple kernel (no cluster) plan = {rows
// a block, 0, 0, 0}: 8, or 2 above H = 512.  Returns 0 or a cudaError_t.
ASR_API int asr_bilstm_plan(int B, int H, int* plan) {
    return bilstm_plan<float>(B, H, plan);
}

ASR_API int asr_bilstm_bf16_plan(int B, int H, int* plan) {
    return bilstm_plan<bf16>(B, H, plan);
}
