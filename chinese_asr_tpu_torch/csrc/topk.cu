// K3: exact row-wise top-k, and K4: the same selection fused behind the
// beam's logp transform, for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/topk.py
// (`_kernel` / `_extract_grouped_onepass`, reached through `_top_k_impl`
// -> `top_k`): x [R, V] f32 -> (values [R, k] f32, indices [R, k] int32),
// descending, with exactly the Pallas semantics:
//   * a tie goes to the LOWER column (jax.lax.top_k order);
//   * NaN ranks with +inf (key = +inf, ties by column) and an extracted
//     +inf key reads back as NaN;
//   * a row of all -inf yields its lowest columns in order (the beam's
//     step 0, where every beam but the first is masked to -inf);
//   * only columns < V exist, so padding can never be picked.
//
// K4 replaces `_fused_kernel` (reached through `_top_k_fused_impl` ->
// `top_k_fused`): logit [R, V] f32, bias [R] f32, temperature T ->
// the top-k of key = fl(fl(x - lse) + b), with x = logit / T rounded as
// the IEEE f32 divide rounds it (not a multiply by an f32 1/T) and lse =
// log(sum exp(x)) of the row.  A NaN or +inf logit anywhere (or all logits
// -inf, or a NaN or +inf bias) makes the row's keys NaN: it reads back NaN
// with indices 0..k-1.  Where the bias is -inf the row reads back -inf
// with indices 0..k-1, whatever the logits hold (the beam's disabled
// step-0 rows).
//
// What bounds both on the H100: memory.  Each must read R*V*4 bytes once
// (41 MB for the beam's 2048 x 5004 at bw 16) and does little arithmetic
// per byte; the floor is bytes / 3.35 TB/s.
//
// Design: each row is read from HBM once, into registers.
//   * W warps own a row (W = 1 or 4; ops/cuda/topk.py `plan` picks W
//     from R and V so that the grid fills the card).  Thread t of the row
//     streams float4 t + j*32W (ld.global.nc.v4, 8 in flight a thread)
//     where V % 4 == 0 and the row is 16-byte aligned, else column
//     t + j*32W.  A thread's columns ascend in scan order.
//   * Keys are order-preserving u32 words of the f32 value (-0 as +0, in
//     K3 NaN as +inf), so an integer compare is the float order and equal
//     floats stay equal.  Each lane keeps a sorted list of its top-S
//     (S = 8) (key, column) candidates in registers.  Empty slots hold key
//     0, below every real key (-inf is 0x007fffff), and column INT_MAX:
//     real -inf elements displace them, so an all -inf row needs no
//     special case.  Columns ascend, so a strict `>` keeps the lower
//     column on ties.
//   * The first S elements of a lane fill its list through a sorting
//     network.  Then the warp's threshold: the k-th largest of the 32
//     lanes' best keys (a bitonic sort across the warp), refreshed after
//     each batch of 32 elements a lane.  k scanned elements lie at or
//     above it, so an element below it is not in the top k.  An element
//     enters the list only if its key exceeds the lane's S-th key and
//     reaches the threshold; the test is one float compare against the
//     bar's float, so most elements cost that compare alone, not the
//     S-stage insertion.
//   * Extraction: k rounds of the warp's largest head key (redux.sync),
//     then the lowest column holding it; the winner's list shifts up.
//     With W > 1 each warp extracts its own top k into shared memory, and
//     each of the W*k entries finds its rank in the merged order by a
//     binary search of the other lists.
//   * Exhaustion: a lane whose last candidate precedes or equals the k-th
//     pick may hide an element that belongs above it (the test of
//     `_extract_grouped_onepass` without its -inf clause).  Such a row
//     reruns the flat threshold-exclusion extraction (`_extract_desc`: k
//     passes over the row, read again from L2) and adds one to the
//     optional `fallbacks` counter.  A row with its top 17 at random
//     columns falls back with probability ~C(17, 8) / 32^7 ~ 7e-7.
//   * k > 32 takes the flat extraction directly.
// K4 in the same single read: each lane also keeps an online (max, sum of
// exp) of x, and its candidates are ordered by x; the lanes' pairs combine
// into lse.  The key does not decrease with x, so the top k by key lie
// among the top candidates by x, except that rounding can merge distinct
// x into one key, where the lower column must win.  So the candidates'
// keys are computed in the order of operations above, each lane's list is
// re-sorted by (key, column), and the row falls back whenever some lane's
// largest hidden x (its last candidate's, or the warp threshold's) has a
// key >= the k-th key.  A row with a -inf bias is not read at all.
#include "common.cuh"

#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int S = 8;                  // candidates a lane keeps
constexpr int U = 8;                  // float4 loads in flight a thread
constexpr int NE = 4 * U;             // elements a thread takes per batch
constexpr int KMAX = 32;              // a larger k: flat extraction only
constexpr unsigned KEY_NONE = 0u;     // an empty slot, below -inf
constexpr unsigned KEY_INF = 0xff800000u;   // +inf (and NaN in K3)
constexpr unsigned KEY_TOP = 0xffffffffu;   // above every key

// order-preserving u32 of a float; -0 maps to +0's word
__device__ __forceinline__ unsigned okey(float f) {
    unsigned u = __float_as_uint(f);
    u = u == 0x80000000u ? 0u : u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ofloat(unsigned key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// an extracted key as the value it reports: +inf reads back as NaN
__device__ __forceinline__ float out_value(unsigned key) {
    return key == KEY_INF ? NAN : ofloat(key);
}

__device__ __forceinline__ unsigned plain_key(float v) {
    return isnan(v) ? KEY_INF : okey(v);
}

// x = logit / T from rt = 1 / T rounded in f64 (on the host): the f64
// product rounded to f32 is the correctly rounded f32 quotient (its error,
// <= 2^-52 relative, is below the least distance 2^-49 of a quotient of two
// f32 from a midpoint of f32), so this is the IEEE divide without the
// divide's slow-path call
__device__ __forceinline__ float scaled(float logit, double rt) {
    return __double2float_rn(__dmul_rn((double)logit, rt));
}

__device__ __forceinline__ unsigned fused_key(float x, float lse, float b) {
    return okey(__fadd_rn(__fsub_rn(x, lse), b));
}

// (ka, ca) precedes (kb, cb): larger key first, then lower column
__device__ __forceinline__ bool precedes(unsigned ka, int ca, unsigned kb,
                                         int cb) {
    return ka > kb || (ka == kb && ca < cb);
}

// the k-th largest (1 <= k <= 32) of the warp's 32 values: a bitonic sort
// across the lanes, descending
__device__ __forceinline__ unsigned warp_kth(unsigned v, int k) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
        const bool desc = (lane & size) == 0;
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const unsigned o = __shfl_xor_sync(FULL, v, stride);
            v = (((lane & stride) == 0) == desc) ? max(v, o) : min(v, o);
        }
    }
    return __shfl_sync(FULL, v, k - 1);
}

// insert (key, col), known to exceed the last slot, into the sorted list
__device__ __forceinline__ void insert(unsigned (&ck)[S], int (&cc)[S],
                                       unsigned key, int col) {
#pragma unroll
    for (int j = S - 1; j > 0; --j) {
        if (key > ck[j]) {
            const bool up = key > ck[j - 1];
            ck[j] = up ? ck[j - 1] : key;
            cc[j] = up ? cc[j - 1] : col;
        }
    }
    if (key > ck[0]) {
        ck[0] = key;
        cc[0] = col;
    }
}

// a lane's bar: insert iff key > max(last slot, threshold - 1)
__device__ __forceinline__ unsigned lane_bar(unsigned last, unsigned thr) {
    return max(last, thr ? thr - 1 : 0u);
}

// the bar as a float f, so that key > bar implies !(v <= f) for every v (a
// NaN passes; a bar below -inf's key gives a NaN f, which passes all):
// 0x7fffffff is -0's raw word, which okey never makes, and stands for the
// largest key below +0's
__device__ __forceinline__ float bar_float(unsigned bar) {
    return ofloat(bar == 0x7fffffffu ? 0x7ffffffeu : bar);
}

// compare-exchange: slot a ends before slot b under precedes()
__device__ __forceinline__ void cmpx(unsigned (&ck)[S], int (&cc)[S], int a,
                                     int b) {
    if (precedes(ck[b], cc[b], ck[a], cc[a])) {
        const unsigned tk = ck[a];
        const int tc = cc[a];
        ck[a] = ck[b];
        cc[a] = cc[b];
        ck[b] = tk;
        cc[b] = tc;
    }
}

// sort the S = 8 slots by (key descending, column ascending): Batcher's
// odd-even merge network, 19 compare-exchanges
__device__ __forceinline__ void sort_list(unsigned (&ck)[S], int (&cc)[S]) {
    static_assert(S == 8, "the network sorts 8 slots");
    cmpx(ck, cc, 0, 1); cmpx(ck, cc, 2, 3); cmpx(ck, cc, 4, 5);
    cmpx(ck, cc, 6, 7); cmpx(ck, cc, 0, 2); cmpx(ck, cc, 1, 3);
    cmpx(ck, cc, 4, 6); cmpx(ck, cc, 5, 7); cmpx(ck, cc, 1, 2);
    cmpx(ck, cc, 5, 6); cmpx(ck, cc, 0, 4); cmpx(ck, cc, 1, 5);
    cmpx(ck, cc, 2, 6); cmpx(ck, cc, 3, 7); cmpx(ck, cc, 2, 4);
    cmpx(ck, cc, 3, 5); cmpx(ck, cc, 1, 2); cmpx(ck, cc, 3, 4);
    cmpx(ck, cc, 5, 6);
}

// the warp's first head under precedes(), in every lane: the largest key
// (redux.sync), then the lowest column holding it
__device__ __forceinline__ void warp_first(unsigned key, int col,
                                           unsigned& bk, int& bc) {
    bk = __reduce_max_sync(FULL, key);
    bc = (int)__reduce_min_sync(FULL, key == bk ? (unsigned)col : ~0u);
}

// how many entries of a sorted list of n precede (ek, ec): binary search
__device__ __forceinline__ int count_before(const unsigned* lk,
                                            const int* lc, int n,
                                            unsigned ek, int ec) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (precedes(lk[mid], lc[mid], ek, ec)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

template <bool B>
struct Flag {
    static constexpr bool value = B;
};

// A lane's candidate list: its top-S (key, column) in precedes() order,
// the warp's threshold and the lane's bar.
struct Lists {
    unsigned ck[S];
    int cc[S];
    unsigned thr;                         // k scanned keys are >= thr
    unsigned bar;                         // insert iff key > bar
};

// One read of the row by its 32W threads (thread t), in batches of NE
// elements a thread.  `xform(e)` turns a batch of loaded values into
// scores in place (it may also accumulate over them); with `lists` each
// lane keeps its top-S candidates by plain_key(score).  Past the row's
// end a batch holds -inf: such an element sorts after every real one (-inf
// at a column >= V), takes only an empty slot, and adds nothing to K4's
// max or sum of exp.  If one is ever picked, the lists held fewer than k
// real candidates, which the exhaustion test sends to the flat extraction.
template <int W, bool VEC, class Xform>
__device__ __forceinline__ void scan_row(const float* __restrict__ row,
                                         int V, int k, int t, bool lists,
                                         Lists& L, Xform xform) {
    constexpr int NT = 32 * W;
    constexpr int STEP = VEC ? U * NT : NE * NT;
    const int n = VEC ? V / 4 : V;        // float4s or floats
#pragma unroll
    for (int j = 0; j < S; ++j) {
        L.ck[j] = KEY_NONE;
        L.cc[j] = INT_MAX;
    }
    L.thr = KEY_NONE;
    L.bar = KEY_NONE;
    float barf = bar_float(L.bar);
    // element i of the batch at base: its float4 (or float) q, its column
    auto q_of = [&](int base, int i) {
        return base + (VEC ? i >> 2 : i) * NT + t;
    };
    auto load = [&](float (&e)[NE], int base) {
        if constexpr (VEC) {
            const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int q = q_of(base, 4 * u);
                const float4 f =
                    q < n ? __ldg(row4 + q)
                          : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                        -INFINITY);
                e[4 * u] = f.x;
                e[4 * u + 1] = f.y;
                e[4 * u + 2] = f.z;
                e[4 * u + 3] = f.w;
            }
        } else {
#pragma unroll
            for (int u = 0; u < NE; ++u)
                e[u] = q_of(base, u) < n ? __ldg(row + q_of(base, u))
                                         : -INFINITY;
        }
    };
    // the first batch sorts its first S elements into the list and takes
    // a first threshold before it inserts the rest
    auto process = [&](auto first, float (&e)[NE], int base) {
        constexpr bool FIRST = decltype(first)::value;
        auto col_of = [&](int i) {
            return VEC ? 4 * q_of(base, i) + (i & 3) : q_of(base, i);
        };
        xform(e);
        if (!lists) return;
        if constexpr (FIRST) {
#pragma unroll
            for (int i = 0; i < S; ++i) {
                L.ck[i] = plain_key(e[i]);
                L.cc[i] = col_of(i);
            }
            sort_list(L.ck, L.cc);
            L.thr = warp_kth(L.ck[0], k);
            L.bar = lane_bar(L.ck[S - 1], L.thr);
            barf = bar_float(L.bar);
        }
#pragma unroll
        for (int i = FIRST ? S : 0; i < NE; ++i) {
            if (!(e[i] <= barf)) {        // rare once the list is full
                const unsigned key = plain_key(e[i]);
                if (key > L.bar) {
                    insert(L.ck, L.cc, key, col_of(i));
                    L.bar = lane_bar(L.ck[S - 1], L.thr);
                    barf = bar_float(L.bar);
                }
            }
        }
        if (base + STEP < n) {
            L.thr = warp_kth(L.ck[0], k);
            L.bar = lane_bar(L.ck[S - 1], L.thr);
            barf = bar_float(L.bar);
        }
    };
    float e[NE];
    load(e, 0);
    process(Flag<true>{}, e, 0);
    for (int base = STEP; base < n; base += STEP) {
        load(e, base);
        process(Flag<false>{}, e, base);
    }
}

// The row's top k among its lanes' lists, in (pk, pc) the k-th pick; the
// picks go to (ok, oc) of lane j (W == 1) or to (sk, sc)[j] (W > 1).  Each
// warp extracts its own top k (k rounds: the warp's largest head key by
// redux.sync, then the lowest column holding it; the winner's list shifts
// up); with W > 1 each of the W*k entries then finds its rank in the
// merged order by a binary search of the other warps' lists.  Empty slots
// (KEY_NONE, INT_MAX) are never written.  If the lists ran out, pick k is
// an empty slot or a -inf past the row's end, and the exhaustion test
// sends the row to the fallback.
template <int W>
__device__ __forceinline__ void extract(Lists& L, int k, int t,
                                        unsigned (*wk)[KMAX],
                                        int (*wc)[KMAX], unsigned* sk,
                                        int* sc, unsigned& pk, int& pc,
                                        unsigned& ok, int& oc) {
    const int lane = t & 31;
    ok = KEY_NONE;
    oc = INT_MAX;
    for (int j = 0; j < k; ++j) {
        warp_first(L.ck[0], L.cc[0], pk, pc);
        if (lane == j) {
            ok = pk;
            oc = pc;
        }
        if (L.ck[0] == pk && L.cc[0] == pc) {
#pragma unroll
            for (int q = 0; q + 1 < S; ++q) {
                L.ck[q] = L.ck[q + 1];
                L.cc[q] = L.cc[q + 1];
            }
            L.ck[S - 1] = KEY_NONE;
            L.cc[S - 1] = INT_MAX;
        }
    }
    if constexpr (W > 1) {
        const int wr = t >> 5;
        if (lane < k) {
            wk[wr][lane] = ok;
            wc[wr][lane] = oc;
        }
        if (t < k) {
            sk[t] = KEY_NONE;
            sc[t] = INT_MAX;
        }
        __syncthreads();
        if (t < W * k) {
            const int w = t / k, i = t % k;
            const unsigned ek = wk[w][i];
            const int ec = wc[w][i];
            int rank = i;
#pragma unroll
            for (int o = 0; o < W; ++o)
                if (o != w) rank += count_before(wk[o], wc[o], k, ek, ec);
            if (rank < k && ec != INT_MAX) {
                sk[rank] = ek;
                sc[rank] = ec;
            }
        }
        __syncthreads();
        pk = sk[k - 1];
        pc = sc[k - 1];
    }
}

// any thread of the row's group: a warp (W == 1) or the block (W > 1)
template <int W>
__device__ __forceinline__ bool row_any(bool p) {
    if constexpr (W > 1) {
        return __syncthreads_or(p) != 0;
    } else {
        return __any_sync(FULL, p);
    }
}

// the k picks of extract() to the row's outputs
template <int W>
__device__ __forceinline__ void write_picks(float* rv, int* ri, int k, int t,
                                            const unsigned* sk, const int* sc,
                                            unsigned ok, int oc) {
    if (t < k) {
        rv[t] = out_value(W > 1 ? sk[t] : ok);
        ri[t] = W > 1 ? sc[t] : oc;
    }
}

// whole-row outcomes: value v at indices 0..k-1
__device__ void write_row(float* rv, int* ri, int k, int t, int nt,
                          float v) {
    for (int j = t; j < k; j += nt) {
        rv[j] = v;
        ri[j] = j;
    }
}

// The flat extraction: k threshold-exclusion passes over the row, read
// from global memory (L2) with each element's key recomputed; exclusion
// is implied by the last pick (tk, ti), as in `_extract_desc`.  Called by
// all 32W threads of the row.
template <int W, bool FUSED>
__device__ __forceinline__ void flat_extract(
    const float* __restrict__ row, int V, int k, double rt, float lse,
    float b, float* rv, int* ri, int t, unsigned (*sk)[W], int (*sc)[W]) {
    constexpr int NT = 32 * W;
    unsigned tk = KEY_TOP;
    int ti = -1;
    for (int j = 0; j < k; ++j) {
        unsigned bk = KEY_NONE;
        int bc = INT_MAX;
#pragma unroll 4
        for (int c = t; c < V; c += NT) {
            const float v = __ldg(row + c);
            const unsigned key = FUSED ? fused_key(scaled(v, rt), lse, b)
                                       : plain_key(v);
            const bool taken = key > tk || (key == tk && c <= ti);
            if (!taken && precedes(key, c, bk, bc)) {
                bk = key;
                bc = c;
            }
        }
        warp_first(bk, bc, bk, bc);
        if constexpr (W > 1) {
            // double-buffered by pass: one barrier a pass
            if ((t & 31) == 0) {
                sk[j & 1][t >> 5] = bk;
                sc[j & 1][t >> 5] = bc;
            }
            __syncthreads();
#pragma unroll
            for (int w = 0; w < W; ++w) {
                if (precedes(sk[j & 1][w], sc[j & 1][w], bk, bc)) {
                    bk = sk[j & 1][w];
                    bc = sc[j & 1][w];
                }
            }
        }
        if (t == 0) {
            rv[j] = out_value(bk);
            ri[j] = bc;
        }
        tk = bk;
        ti = bc;
    }
}

// At least one block an SM: with the thread bound alone, ptxas spilled a
// few registers of the float4 variants to raise occupancy.  Those, which
// the main path runs, still fit its grids in one wave (<= 128 registers).
template <int W, bool VEC, bool FUSED>
__global__ void __launch_bounds__(128, 1)
topk_kernel(const float* __restrict__ x, const float* __restrict__ bias,
            float* __restrict__ vals, int* __restrict__ idx, int R, int V,
            int k, double rt, unsigned* __restrict__ fallbacks) {
    constexpr int NT = 32 * W;            // threads of a row
    constexpr int RPB = W == 1 ? 4 : 1;   // rows of a block
    __shared__ unsigned sh_wk[W][KMAX];   // each warp's top k (W > 1)
    __shared__ int sh_wc[W][KMAX];
    __shared__ unsigned sh_k[KMAX];       // the row's top k (W > 1)
    __shared__ int sh_c[KMAX];
    __shared__ unsigned sh_fk[2][W];      // flat passes' warp bests
    __shared__ int sh_fc[2][W];
    __shared__ float sh_m[W], sh_s[W];
    __shared__ int sh_bad[W];

    const int t = threadIdx.x % NT;
    const int lane = threadIdx.x & 31;
    const int wr = t >> 5;
    const int r = blockIdx.x * RPB + threadIdx.x / NT;
    if (r >= R) return;                   // W == 1 only: whole warps
    const float* row = x + (size_t)r * V;
    float* rv = vals + (size_t)r * k;
    int* ri = idx + (size_t)r * k;
    const bool cand = k <= KMAX;
    Lists L;
    unsigned pk, ok;
    int pc, oc;

    if constexpr (!FUSED) {
        if (cand) {
            scan_row<W, VEC>(row, V, k, t, true, L, [](float (&)[NE]) {});
            const unsigned last_k = L.ck[S - 1];
            const int last_c = L.cc[S - 1];
            extract<W>(L, k, t, sh_wk, sh_wc, sh_k, sh_c, pk, pc, ok, oc);
            // the last candidate precedes or equals the k-th pick
            if (!row_any<W>(!precedes(pk, pc, last_k, last_c))) {
                write_picks<W>(rv, ri, k, t, sh_k, sh_c, ok, oc);
                return;
            }
            if (t == 0 && fallbacks != nullptr) atomicAdd(fallbacks, 1u);
        }
        flat_extract<W, false>(row, V, k, rt, 0.0f, 0.0f, rv, ri, t, sh_fk,
                               sh_fc);
    } else {
        const float b = bias[r];
        if (!(b > -INFINITY && b < INFINITY)) {     // -inf, +inf or NaN
            write_row(rv, ri, k, t, NT, b == -INFINITY ? -INFINITY : NAN);
            return;
        }
        // the one read: x = logit / T, its online max and sum of exp, and
        // the candidates by x
        float m = -INFINITY, s = 0.0f;
        bool bad = false;                 // a NaN or +inf x
        scan_row<W, VEC>(row, V, k, t, cand, L, [&](float (&e)[NE]) {
            if (rt != 1.0) {
#pragma unroll
                for (int i = 0; i < NE; ++i) e[i] = scaled(e[i], rt);
            }
            float mb = -INFINITY;
#pragma unroll
            for (int i = 0; i < NE; ++i) {
                bad |= !(e[i] < INFINITY);
                mb = fmaxf(mb, e[i]);
            }
            const float mn = fmaxf(m, mb);
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < NE; ++i)
                acc += e[i] != -INFINITY ? expf(e[i] - mn) : 0.0f;
            s = (m == mn ? s : s * expf(m - mn)) + acc;
            m = mn;
        });
        float M = m;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
        float sum = m == -INFINITY ? 0.0f : s * expf(m - M);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(FULL, sum, off);
        bool poison = __any_sync(FULL, bad);
        if constexpr (W > 1) {
            if (lane == 0) {
                sh_m[wr] = M;
                sh_s[wr] = sum;
                sh_bad[wr] = poison;
            }
            __syncthreads();
            M = sh_m[0];
#pragma unroll
            for (int w = 1; w < W; ++w) M = fmaxf(M, sh_m[w]);
            sum = 0.0f;
            poison = false;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                sum += sh_m[w] == -INFINITY ? 0.0f
                                            : sh_s[w] * expf(sh_m[w] - M);
                poison |= sh_bad[w] != 0;
            }
        }
        if (poison || M == -INFINITY) {
            write_row(rv, ri, k, t, NT, NAN);
            return;
        }
        const float lse = M + logf(sum);
        if (cand) {
            // every x the lane did not keep is <= its bar, so its key is
            // <= the bar's key
            const unsigned hid = L.bar < okey(-INFINITY)
                                     ? KEY_NONE
                                     : fused_key(ofloat(L.bar), lse, b);
#pragma unroll
            for (int j = 0; j < S; ++j)
                if (L.ck[j] != KEY_NONE)
                    L.ck[j] = fused_key(ofloat(L.ck[j]), lse, b);
            sort_list(L.ck, L.cc);        // equal keys out of column order
            extract<W>(L, k, t, sh_wk, sh_wc, sh_k, sh_c, pk, pc, ok, oc);
            // a hidden x could tie the k-th key with a lower column
            if (!row_any<W>(hid >= pk)) {
                write_picks<W>(rv, ri, k, t, sh_k, sh_c, ok, oc);
                return;
            }
            // read the row again (from L2), its candidates now by the
            // exact keys: K3's scheme and test
            if (t == 0 && fallbacks != nullptr) atomicAdd(fallbacks + 1, 1u);
            scan_row<W, VEC>(row, V, k, t, true, L, [&](float (&e)[NE]) {
#pragma unroll
                for (int i = 0; i < NE; ++i)
                    e[i] = __fadd_rn(__fsub_rn(scaled(e[i], rt), lse), b);
            });
            const unsigned last_k = L.ck[S - 1];
            const int last_c = L.cc[S - 1];
            extract<W>(L, k, t, sh_wk, sh_wc, sh_k, sh_c, pk, pc, ok, oc);
            if (!row_any<W>(!precedes(pk, pc, last_k, last_c))) {
                write_picks<W>(rv, ri, k, t, sh_k, sh_c, ok, oc);
                return;
            }
            if (t == 0 && fallbacks != nullptr) atomicAdd(fallbacks, 1u);
        }
        flat_extract<W, true>(row, V, k, rt, lse, b, rv, ri, t, sh_fk,
                              sh_fc);
    }
}

template <int W, bool VEC, bool FUSED>
int launch(const float* x, const float* bias, float* vals, int* idx, int R,
           int V, int k, double rt, unsigned* fallbacks,
           cudaStream_t stream) {
    constexpr int RPB = W == 1 ? 4 : 1;
    topk_kernel<W, VEC, FUSED><<<(R + RPB - 1) / RPB, RPB * 32 * W, 0,
                                 stream>>>(x, bias, vals, idx, R, V, k, rt,
                                           fallbacks);
    return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const float* x, const float* bias, float* vals, int* idx,
             int R, int V, int k, int W, float temp, unsigned* fallbacks,
             void* stream) {
    if (R <= 0 || k <= 0) return 0;
    if (k > V) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec = V % 4 == 0 && ((uintptr_t)x & 15) == 0;
    const double rt = 1.0 / (double)temp;     // see scaled()
#define ASR_TOPK_GO(w)                                                      \
    return vec ? launch<w, true, FUSED>(x, bias, vals, idx, R, V, k, rt,   \
                                        fallbacks, st)                      \
               : launch<w, false, FUSED>(x, bias, vals, idx, R, V, k, rt,   \
                                         fallbacks, st)
    switch (W) {
        case 1: ASR_TOPK_GO(1);
        case 4: ASR_TOPK_GO(4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef ASR_TOPK_GO
}

}  // namespace

// x [R, V] -> vals [R, k], idx [R, k]; float32 / int32, contiguous.  W
// warps a row (1 or 4: ops/cuda/topk.py `plan`); `fallbacks` (may be
// null) is [2]: [0] counts the rows that took the flat extraction, [1]
// K4's rows read again by their exact keys.
ASR_API int asr_topk(const float* x, float* vals, int* idx, int R, int V,
                     int k, int W, unsigned* fallbacks, void* stream) {
    return dispatch<false>(x, nullptr, vals, idx, R, V, k, W, 1.0f,
                           fallbacks, stream);
}

// logit [R, V], bias [R] -> vals [R, k], idx [R, k]; float32 / int32,
// contiguous; W and fallbacks as for asr_topk.
ASR_API int asr_topk_fused(const float* logit, const float* bias,
                           float* vals, int* idx, int R, int V, int k, int W,
                           float temp, unsigned* fallbacks, void* stream) {
    return dispatch<true>(logit, bias, vals, idx, R, V, k, W, temp,
                          fallbacks, stream);
}
