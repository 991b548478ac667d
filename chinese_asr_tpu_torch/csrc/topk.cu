// K3: exact row-wise top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chinese_asr_tpu/ops/pallas/topk.py
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
// What bounds it on the H100: memory.  The function must read R*V*4 bytes
// once (41 MB for the beam's 2048 x 5004 at bw 16) and does little
// arithmetic per byte; the floor is bytes / 3.35 TB/s.
//
// Design: one block per row.  The row is loaded once into shared memory
// (5004 f32 = 20 KB), with NaN mapped to +inf.  Then k extraction passes,
// each a block-wide arg-max over the not-yet-extracted columns under the
// (value descending, column ascending) order.  As in `_extract_desc`,
// exclusion is implied by the last extracted (value v, column i): an
// element is already taken iff key > v, or key == v and column <= i, so
// no "taken" mask is kept.  Each pass is a strided sweep of shared memory
// per thread, a warp-shuffle reduction and one cross-warp step.  Rows
// run in parallel across the SMs (many 20 KB blocks fit on one SM).
// The TPU kernel's grouped/one-pass schemes and row blocking were VMEM
// choices and are not ported.
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

__global__ void __launch_bounds__(TPB)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int* __restrict__ idx, int V, int k) {
    extern __shared__ float key[];  // [V]
    __shared__ float warp_v[WARPS];
    __shared__ int warp_i[WARPS];
    __shared__ float pick_v;
    __shared__ int pick_i;

    const size_t r = blockIdx.x;
    const float* row = x + r * V;
    for (int c = threadIdx.x; c < V; c += TPB) {
        const float v = row[c];
        key[c] = isnan(v) ? INFINITY : v;
    }
    __syncthreads();

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
                vals[r * k + j] = bv == INFINITY ? NAN : bv;
                idx[r * k + j] = bi;
            }
        }
        __syncthreads();
        tv = pick_v;
        ti = pick_i;
    }
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
