// K6: the beam's additive-attention read, for Hopper (sm_90a).
//
//   align[b, j, :] = softmax_L(mask[b, :] + sum_a tanh(keys[b, :, a]
//                                                  + q[b, j, a]) * v[a])
//
// mask [B, L] additive, q [B, k, a] (k beams a sample), keys [B, L, a],
// v [a], all float32 or all bfloat16 -> align [B, k, L] in that type.
//
// K6 replaces no TPU kernel: the JAX package writes the expression in
// jnp (models/attention.py `attend_beam`) and XLA fuses it.  PyTorch does
// not: it writes and reads a [B, k, L, a] tensor four times a decode step
// (the broadcast add, tanh, the product with v, the sum over a), which the
// device trace of the offline beam decode showed as the largest device
// time outside the GEMMs.  K6 computes the same function without that
// tensor.
//
// What bounds it on the H100: arithmetic.  Its bytes are keys once a
// sample and align once (~1 MB a step at B=128, k=16, L=433), but it
// takes B*k*L*a accurate tanhf, each two special-function operations
// (ex2 and rcp, 16 a clock an SM) and ~15 FP32 instructions, and a
// multiply-add.
//
// Design:
//   * A block owns a sample b and a group of kb of its k beams
//     (ops/cuda/attention.py `plan` picks kb from the shape: a block a
//     sample where B fills the card twice over, beam groups for smaller
//     B).  Blocks of one sample are adjacent, so their keys reads meet in
//     L2.
//   * The sample's keys stream through shared memory in tiles of `tile`
//     frames, double-buffered: one warp asks for each row of the next
//     tile by `cp.async.bulk`, completing on the buffer's mbarrier, while
//     the block computes on the other buffer.  Rows land at a stride of an
//     odd number of 16-byte units, so the 8 lanes of a 16-byte shared load
//     read 8 rows on 32 distinct banks.  Each tile serves all kb beams.
//     q[b, group] and v are held in shared memory in float32.
//   * A warp takes 32 frames of one beam: lane = frame.  Each thread forms
//     its (beam, frame) dot product over a whole: a = 0, 1, ..., a-1 in
//     that order, acc = fmaf(tanhf(key + q), v, acc) in float32, with no
//     rounding to the input type in between (bf16 operands are widened on
//     load).  The lanes of a warp read the same q and v (broadcasts) and
//     their own key rows.
//   * Frames from the last one whose mask is not -inf onward are neither
//     copied nor computed: their score is -inf, which adds exactly 0 after
//     the softmax.  Earlier frames whose mask is -inf skip their tanh.
//   * Scores mask + dot live in shared memory, kb x L float32, and the
//     masked softmax over L runs in the block, one warp a beam, with
//     butterfly reductions (max, then the sum of expf(s - max)), and
//     writes align = expf(s - max) / sum in the input type.  A row masked
//     everywhere gives NaN, as torch.softmax does.  Where kb x L scores
//     do not fit beside the tiles (`plan`'s split), they go to a float32
//     scratch in device memory that the wrapper allocates, and the same
//     block reads them back for its softmax.
//   * Accurate tanhf and expf (no --use_fast_math, no tanh.approx, no
//     __expf); nothing runs on tensor cores.
// Inside the decode's CUDA graph: no host synchronisation and no
// allocation; the launch's error is returned to the wrapper.
#include "common.cuh"
#include "tc.cuh"

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// 16 bytes of a key row widened to float32: 4 floats or 8 bf16
template <typename T> struct Row16;

template <> struct Row16<float> {
    static constexpr int N = 4;
    __device__ static void unpack(uint4 u, float* o) {
        o[0] = __uint_as_float(u.x);
        o[1] = __uint_as_float(u.y);
        o[2] = __uint_as_float(u.z);
        o[3] = __uint_as_float(u.w);
    }
};

template <> struct Row16<bf16> {
    static constexpr int N = 8;
    __device__ static void unpack(uint4 u, float* o) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            o[2 * i] = __uint_as_float(w[i] << 16);
            o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

// A key row's stride in shared memory: its bytes rounded to an odd
// number of 16-byte units (ops/cuda/attention.py `row_stride`).
__host__ __device__ inline int row_stride(int row_bytes) {
    const int u = row_bytes / 16;
    return 16 * (u + 1 + (u & 1));
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory to this CTA's shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// sum_a tanh(key[a] + q[a]) * v[a], a in order, float32 multiply-adds
template <typename T>
__device__ __forceinline__ float dot_tanh(const unsigned char* krow,
                                          const float* qj, const float* v,
                                          int a) {
    constexpr int P = Row16<T>::N;
    const uint4* k16 = reinterpret_cast<const uint4*>(krow);
    float acc = 0.f;
#pragma unroll 2
    for (int c = 0; c < a / P; ++c) {
        float kk[P], qq[P], vv[P];
        Row16<T>::unpack(k16[c], kk);
#pragma unroll
        for (int i = 0; i < P; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qj + c * P + i);
            const float4 v4 = *reinterpret_cast<const float4*>(v + c * P + i);
            qq[i] = q4.x; qq[i + 1] = q4.y; qq[i + 2] = q4.z; qq[i + 3] = q4.w;
            vv[i] = v4.x; vv[i + 1] = v4.y; vv[i + 2] = v4.z; vv[i + 3] = v4.w;
        }
#pragma unroll
        for (int i = 0; i < P; ++i)
            acc = fmaf(tanhf(kk[i] + qq[i]), vv[i], acc);
    }
    return acc;
}

// Warp 0 asks for tile t of a sample's keys (rows t*tile .. of keys_b,
// up to Lv) in buffer t & 1, completing on that buffer's mbarrier.
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* tiles,
                                          uint64_t* bars, const T* keys_b,
                                          int a, int RB, int SB, int tile,
                                          int Lv, int t, int lane) {
    const int l0 = t * tile;
    const int rows = min(tile, Lv - l0);
    uint64_t* bar = bars + (t & 1);
    unsigned char* buf = tiles + (t & 1) * tile * SB;
    if (lane == 0) mbar_expect(bar, (uint32_t)(rows * RB));
    for (int r = lane; r < rows; r += 32)
        bulk_load(smem_u32(buf + r * SB), keys_b + (size_t)(l0 + r) * a,
                  (uint32_t)RB, smem_u32(bar));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename T>
__global__ void __launch_bounds__(256)
beam_attention_kernel(const T* __restrict__ mask, const T* __restrict__ q,
                      const T* __restrict__ keys, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ scratch,
                      int k, int L, int a, int kb, int tile) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ unsigned warp_last[8];
    const int RB = a * (int)sizeof(T);
    const int SB = row_stride(RB);
    unsigned char* tiles = smem;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * tile * SB);
    float* v_s = reinterpret_cast<float*>(bars + 2);
    float* q_s = v_s + a;
    float* sc_s = q_s + kb * a;

    const int groups = (k + kb - 1) / kb;
    const int b = blockIdx.x / groups;
    const int j0 = (blockIdx.x % groups) * kb;
    const int nb = min(kb, k - j0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int W = blockDim.x >> 5;
    const T* mrow = mask + (size_t)b * L;

    // Lv: one past the last frame whose mask is not -inf
    unsigned last = 0;
    for (int l = tid; l < L; l += blockDim.x)
        if (Elt<T>::ld(mrow + l) != -INFINITY) last = l + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) warp_last[warp] = last;
    if (tid == 0) {
        mbar_init(bars);
        mbar_init(bars + 1);
        mbar_init_fence();
    }
    for (int i = tid; i < a; i += blockDim.x) v_s[i] = Elt<T>::ld(v + i);
    for (int i = tid; i < nb * a; i += blockDim.x)
        q_s[i] = Elt<T>::ld(q + ((size_t)b * k + j0) * a + i);
    __syncthreads();
    int Lv = 0;
    for (int w = 0; w < W; ++w) Lv = max(Lv, (int)warp_last[w]);

    const int nt = (Lv + tile - 1) / tile;
    const T* keys_b = keys + (size_t)b * L * a;
    if (warp == 0)
        for (int t = 0; t < min(nt, 2); ++t)
            load_tile(tiles, bars, keys_b, a, RB, SB, tile, Lv, t, lane);

    float* sc = scratch ? scratch + ((size_t)b * k + j0) * L : sc_s;
    const int stripes = tile / 32;
    for (int t = 0; t < nt; ++t) {
        mbar_wait(bars + (t & 1), (t >> 1) & 1);
        const unsigned char* buf = tiles + (t & 1) * tile * SB;
        const int l0 = t * tile;
        for (int u = warp; u < nb * stripes; u += W) {
            const int j = u % nb;
            const int r = (u / nb) * 32 + lane;
            const int l = l0 + r;
            if (l < Lv) {
                const float m = Elt<T>::ld(mrow + l);
                sc[(size_t)j * L + l] =
                    m == -INFINITY ? -INFINITY
                                   : m + dot_tanh<T>(buf + r * SB,
                                                     q_s + j * a, v_s, a);
            }
        }
        __syncthreads();                // buffer t & 1 is free again
        if (warp == 0 && t + 2 < nt)
            load_tile(tiles, bars, keys_b, a, RB, SB, tile, Lv, t + 2, lane);
    }

    // the masked softmax over L, one warp a beam
    for (int j = warp; j < nb; j += W) {
        const float* s = sc + (size_t)j * L;
        float m = -INFINITY;
        for (int l = lane; l < Lv; l += 32) m = fmaxf(m, s[l]);
        m = warp_max(m);
        float sum = 0.f;
        for (int l = lane; l < Lv; l += 32) sum += expf(s[l] - m);
        sum = warp_sum(sum);
        T* o = out + ((size_t)b * k + j0 + j) * L;
        for (int l = lane; l < L; l += 32) {
            const float x = l < Lv ? s[l] : -INFINITY;
            Elt<T>::st(o + l, expf(x - m) / sum);
        }
    }
}

template <typename T>
int launch(const void* mask, const void* q, const void* keys, const void* v,
           void* out, float* scratch, int B, int k, int L, int a, int kb,
           int tile, int threads, cudaStream_t stream) {
    const int SB = row_stride(a * (int)sizeof(T));
    const size_t smem = (size_t)2 * tile * SB + 16 + 4 * (size_t)a
                        + 4 * (size_t)kb * a
                        + (scratch ? 0 : 4 * (size_t)kb * L);
    auto kernel = beam_attention_kernel<T>;
    int rc = asr_allow_smem(kernel, smem);
    if (rc) return rc;
    const int groups = (k + kb - 1) / kb;
    kernel<<<B * groups, threads, smem, stream>>>(
        static_cast<const T*>(mask), static_cast<const T*>(q),
        static_cast<const T*>(keys), static_cast<const T*>(v),
        static_cast<T*>(out), scratch, k, L, a, kb, tile);
    return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 for float32 operands, 1 for bfloat16; kb, tile, threads from
// ops/cuda/attention.py `plan`; scratch a float32 [B, k, L] buffer for
// the split plan, else null.
ASR_API int asr_beam_attention(const void* mask, const void* q,
                               const void* keys, const void* v, void* out,
                               float* scratch, int B, int k, int L, int a,
                               int is_bf16, int kb, int tile, int threads,
                               void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<bf16>(mask, q, keys, v, out, scratch, B, k, L,
                                  a, kb, tile, threads, st)
                   : launch<float>(mask, q, keys, v, out, scratch, B, k, L,
                                   a, kb, tile, threads, st);
}
