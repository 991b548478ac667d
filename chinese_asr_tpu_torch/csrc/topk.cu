// K3: exact row-wise top-k, and K4: the same extraction fused behind the
// beam's logp transform, for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/topk.py
// (`_kernel` / `_extract_desc`, reached through `_top_k_impl` -> `top_k`):
// x [R, V] f32 -> (values [R, k] f32, indices [R, k] int32), descending,
// with exactly the Pallas semantics:
//   * a tie goes to the LOWER column (jax.lax.top_k order);
//   * NaN ranks above +inf (key = +inf) and an extracted +inf key reads
//     back as NaN;
//   * a row of all -inf yields its lowest columns in order (the beam's
//     step 0, where every beam but the first is masked to -inf);
//   * only columns < V exist, so padding can never be picked.
//
// K4 replaces `_fused_kernel` (reached through `_top_k_fused_impl` ->
// `top_k_fused`): logit [R, V] f32, bias [R] f32, temperature T ->
// the top-k of key = x - lse + bias, with x = logit / T (an IEEE f32
// divide, not a multiply by 1/T), lse = m + log(sum exp(x - m)) and m the
// row max.  A NaN key ranks first (+inf): a NaN logit anywhere makes the
// row's lse NaN, so the whole row reads back NaN.  Where bias == -inf the
// key is -inf whatever the logits hold (the beam's disabled step-0 rows).
// Then K3's extraction.
//
// What bounds both on the H100: memory.  Each must read R*V*4 bytes once
// (41 MB for the beam's 2048 x 5004 at bw 16) and does little arithmetic
// per byte; the floor is bytes / 3.35 TB/s.  K4's point is to skip the
// unfused path's [R, V] logp write and re-read.
//
// Design: one block per row.  The row is loaded once into shared memory
// (5004 f32 = 20 KB).  K3 maps NaN to +inf on the way in; K4 stores x,
// reduces the row max and then the exp-sum block-wide over shared memory,
// and rewrites the keys in place.  Then k extraction passes, each a
// block-wide arg-max over the not-yet-extracted columns under the (value
// descending, column ascending) order.  As in `_extract_desc`, exclusion
// is implied by the last extracted (value v, column i): an element is
// already taken iff key > v, or key == v and column <= i, so no "taken"
// mask is kept.  Each pass is a strided sweep of shared memory per
// thread, a warp-shuffle reduction and one cross-warp step.  Rows run in
// parallel across the SMs (many 20 KB blocks fit on one SM).  The TPU
// kernel's grouped/one-pass schemes and row blocking were VMEM choices
// and are not ported.
#include "common.cuh"

#include <climits>
#include <math.h>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;

// (v, i) precedes (bv, bi): larger value first, then lower column.
__device__ __forceinline__ bool precedes(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

// The k threshold-exclusion passes over key[0, V) in shared memory; the
// row's results go to vals[j], idx[j].  Called by all TPB threads after
// the keys are in place (the caller's __syncthreads).
__device__ void extract_desc(const float* key, float* vals, int* idx,
                             int V, int k) {
    __shared__ float warp_v[WARPS];
    __shared__ int warp_i[WARPS];
    __shared__ float pick_v;
    __shared__ int pick_i;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float tv = INFINITY;  // last extracted (value, column): the threshold
    int ti = -1;
    for (int j = 0; j < k; ++j) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int c = threadIdx.x; c < V; c += TPB) {
            const float v = key[c];
            const bool taken = v > tv || (v == tv && c <= ti);
            if (!taken && precedes(v, c, bv, bi)) {
                bv = v;
                bi = c;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(FULL, bv, off);
            const int oi = __shfl_down_sync(FULL, bi, off);
            if (precedes(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if (lane == 0) {
            warp_v[warp] = bv;
            warp_i[warp] = bi;
        }
        __syncthreads();
        if (warp == 0) {
            bv = lane < WARPS ? warp_v[lane] : -INFINITY;
            bi = lane < WARPS ? warp_i[lane] : INT_MAX;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_down_sync(FULL, bv, off);
                const int oi = __shfl_down_sync(FULL, bi, off);
                if (precedes(ov, oi, bv, bi)) {
                    bv = ov;
                    bi = oi;
                }
            }
            if (lane == 0) {
                pick_v = bv;
                pick_i = bi;
                vals[j] = bv == INFINITY ? NAN : bv;
                idx[j] = bi;
            }
        }
        __syncthreads();
        tv = pick_v;
        ti = pick_i;
    }
}

// Block-wide max (fmaxf: NaN is dropped, the caller's exp-sum carries
// it) or sum of one float per thread; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v) {
    __shared__ float part[WARPS];
    __shared__ float total;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_down_sync(FULL, v, off);
        v = MAX ? fmaxf(v, o) : v + o;
    }
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        v = threadIdx.x < WARPS ? part[threadIdx.x]
                                : (MAX ? -INFINITY : 0.0f);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_down_sync(FULL, v, off);
            v = MAX ? fmaxf(v, o) : v + o;
        }
        if (threadIdx.x == 0) total = v;
    }
    __syncthreads();
    return total;
}

__global__ void __launch_bounds__(TPB)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int* __restrict__ idx, int V, int k) {
    extern __shared__ float key[];  // [V]
    const size_t r = blockIdx.x;
    const float* row = x + r * V;
    for (int c = threadIdx.x; c < V; c += TPB) {
        const float v = row[c];
        key[c] = isnan(v) ? INFINITY : v;
    }
    __syncthreads();
    extract_desc(key, vals + r * k, idx + r * k, V, k);
}

__global__ void __launch_bounds__(TPB)
topk_fused_kernel(const float* __restrict__ logit,
                  const float* __restrict__ bias, float* __restrict__ vals,
                  int* __restrict__ idx, int V, int k, float temp) {
    extern __shared__ float key[];  // [V]: x, then the keys in place
    const size_t r = blockIdx.x;
    const float* row = logit + r * V;
    float m = -INFINITY;
    for (int c = threadIdx.x; c < V; c += TPB) {
        const float x = __fdiv_rn(row[c], temp);
        key[c] = x;
        m = fmaxf(m, x);
    }
    m = block_reduce<true>(m);
    // exp(x - m) is NaN for a NaN x, and for x = m = +-inf, so the sum,
    // hence lse, is NaN exactly where the Pallas kernel's is
    float s = 0.0f;
    for (int c = threadIdx.x; c < V; c += TPB) s += expf(key[c] - m);
    s = block_reduce<false>(s);
    const float lse = m + logf(s);
    const float b = bias[r];
    for (int c = threadIdx.x; c < V; c += TPB) {
        const float v = key[c] - lse + b;
        key[c] = b == -INFINITY ? -INFINITY : (isnan(v) ? INFINITY : v);
    }
    __syncthreads();
    extract_desc(key, vals + r * k, idx + r * k, V, k);
}

}  // namespace

// x [R, V] -> vals [R, k], idx [R, k]; float32 / int32, contiguous.
ASR_API int asr_topk(const float* x, float* vals, int* idx, int R, int V,
                     int k, void* stream) {
    if (R <= 0 || k <= 0) return 0;
    if (k > V) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)V * sizeof(float);
    const int rc = asr_allow_smem(topk_kernel, smem);
    if (rc) return rc;
    topk_kernel<<<R, TPB, smem, (cudaStream_t)stream>>>(x, vals, idx, V, k);
    return (int)cudaGetLastError();
}

// logit [R, V], bias [R] -> vals [R, k], idx [R, k]; float32 / int32,
// contiguous.
ASR_API int asr_topk_fused(const float* logit, const float* bias,
                           float* vals, int* idx, int R, int V, int k,
                           float temp, void* stream) {
    if (R <= 0 || k <= 0) return 0;
    if (k > V) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)V * sizeof(float);
    const int rc = asr_allow_smem(topk_fused_kernel, smem);
    if (rc) return rc;
    topk_fused_kernel<<<R, TPB, smem, (cudaStream_t)stream>>>(
        logit, bias, vals, idx, V, k, temp);
    return (int)cudaGetLastError();
}
