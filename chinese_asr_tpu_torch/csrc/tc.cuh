// Device helpers shared by K2 (lstm.cu) and K2-bwd (lstm_bwd.cu): the
// thread-block-cluster plans of their f32 and bf16 kernels for H in {64,
// 128, 192, 256}, the 3xTF32 and bf16 tensor-core products, the
// operand-type traits, the split cluster barrier, the bf16 kernels'
// mbarrier exchanges (bulk copies, st.async) and cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CL = 8;              // CTAs per cluster (portable maximum)
constexpr int TC_THREADS = 256;    // 8 warps a CTA
constexpr int CLUSTER_BUDGET = 14; // clusters of 8 the H100 holds at once
                                   // (15, less one of margin)

// Batch rows per cluster, in m16 tiles, from B alone: 16 rows while both
// directions' clusters fit the card at once, else 32 (B <= 224 in one
// wave).
inline int tc_mtiles(int B) {
    return 2 * ((B + 15) / 16) <= CLUSTER_BUDGET ? 1 : 2;
}

// The hidden sizes the cluster kernels take: CTA r of 8 owns H/8 units,
// a whole number of n8 tiles of each of the four gates.
inline bool tc_fits(int H) {
    return H == 64 || H == 128 || H == 192 || H == 256;
}

__device__ __forceinline__ float sigmoid(float x) {
    return 1.f / (1.f + expf(-x));
}

// One cluster barrier split in two halves: arrive publishes this thread's
// prior writes (distributed-shared-memory stores included) to the cluster,
// wait makes every other thread's visible here.
__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

// w = hi + lo, both TF32 (truncated).  The asm is volatile so that the
// split stays inside the time loop: hoisted out of it, the split slice
// would take twice the registers of the f32 one and spill.
__device__ __forceinline__ void split_tf32(float w, float& hi, float& lo) {
    uint32_t h, l;
    asm volatile("and.b32 %0, %1, 0xffffe000;"
                 : "=r"(h) : "r"(__float_as_uint(w)));
    hi = __uint_as_float(h);
    asm volatile("and.b32 %0, %1, 0xffffe000;"
                 : "=r"(l) : "r"(__float_as_uint(w - hi)));
    lo = __uint_as_float(l);
}

// a = hi + lo, both rounded to TF32 with cvt.rna (the A operand's split)
__device__ __forceinline__ void split_rna(const float4& a, float4& hi,
                                          float4& lo) {
    hi = make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z),
                     tf32_rna(a.w));
    lo = make_float4(tf32_rna(a.x - hi.x), tf32_rna(a.y - hi.y),
                     tf32_rna(a.z - hi.z), tf32_rna(a.w - hi.w));
}

// d += a * b on the tensor cores, TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float4& a,
                                         float b0, float b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
          "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
          "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

using bf16 = __nv_bfloat16;

// What the two operand types differ in.  Loads widen to f32; `rnd` rounds
// an f32 value to the type's precision (where the carry is rounded).  The
// f32 tensor-core kernels read KSTEP and W; the bf16 ones have their own.
template <typename E>
struct Elt;

template <>
struct Elt<float> {
    static constexpr bool BF16 = false;
    static constexpr int KSTEP = 8;     // k depth of one mma (tf32 m16n8k8)
    using W = float;                    // a register of the W_hh fragments
    static __device__ __forceinline__ float ld(const float* p) { return *p; }
    static __device__ __forceinline__ float ldg(const float* p) {
        return __ldg(p);
    }
    static __device__ __forceinline__ float rnd(float x) { return x; }
    static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
};

template <>
struct Elt<bf16> {
    static constexpr bool BF16 = true;
    static __device__ __forceinline__ float ld(const bf16* p) {
        return __bfloat162float(*p);
    }
    static __device__ __forceinline__ float ldg(const bf16* p) {
        return __bfloat162float(*p);
    }
    static __device__ __forceinline__ float rnd(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
    static __device__ __forceinline__ void st(bf16* p, float x) {
        *p = __float2bfloat16_rn(x);
    }
};

// two bf16-exact floats -> one 32-bit word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 a, bf16 b) {
    return (uint32_t)__bfloat16_as_ushort(a)
           | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// d += a * b on the tensor cores, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The bf16 kernels' own cluster plan and exchange (K2-bf16, K2-bwd-bf16's
// pass 2; lstm.cu, lstm_bwd.cu)
// ---------------------------------------------------------------------------
// CTAs a cluster of the bf16 kernels, from B alone; they always run 16
// batch rows a cluster.  8 CTAs while both directions' clusters of 8 fit
// the card at once (B <= 112), else 4, so that B <= 224 stays one wave.
inline int bf16_ctas(int B) {
    return 2 * ((B + 15) / 16) <= CLUSTER_BUDGET ? 8 : 4;
}

// Launch `kernel` (`threads` a CTA) in clusters of `clb` CTAs along x, or,
// with plan != nullptr, report {rows, clusters, clusters the card holds at
// once, clb} without launching.  Returns 0 or a cudaError_t.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), int clb, int rows, int threads,
                    dim3 grid, size_t smem, cudaStream_t s, int* plan,
                    Args... args) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = clb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (plan) {
        int n = 0;
        rc = (int)cudaOccupancyMaxActiveClusters(&n, (const void*)kernel,
                                                 &cfg);
        if (rc) return rc;
        plan[0] = rows;
        plan[1] = (int)(grid.x / clb * grid.y);
        plan[2] = n;
        plan[3] = clb;
        return 0;
    }
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
    return rc ? rc : (int)cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared::cluster address of shared::cta address `a` in CTA `rank`
__device__ __forceinline__ uint32_t cluster_u32(uint32_t a, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

// An mbarrier completes a phase when its one arrival (the receiver's
// expect) is in and the bytes it expects have landed: a bulk copy or an
// st.async from any CTA of the cluster signals the bytes it wrote
// (complete_tx), so a receiver that waits sees them.  Bytes may land
// before the expect (the tx count runs negative meanwhile).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(smem_u32(bar)) : "memory");
}

// make this CTA's mbarrier inits visible to the cluster (before the
// cluster barrier that precedes any remote complete_tx)
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `parity` to complete.  A wait that outlasts any
// step by far (2^26 polls, each bounded by the hardware's own time limit)
// traps, so that a lost exchange fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    for (uint32_t n = 0;; ++n) {
        uint32_t ok;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                     " p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(ok) : "r"(a), "r"(parity) : "memory");
        if (ok) return;
        if (n == (1u << 26)) __trap();
    }
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (a bulk copy that reads them).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) from this CTA's shared
// memory at `src` to shared::cluster address `dst`, completing on the
// mbarrier at shared::cluster address `bar` (of the destination CTA).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// 16 bytes into shared::cluster address `dst`, signalled to the mbarrier
// at shared::cluster address `bar` (of the same CTA)
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                 ".v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
                 ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
                   "r"(bar) : "memory");
}

// N bytes (4, 8 or 16) global -> shared, zero-filled where !pred
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 ::"r"(d), "l"(src), "n"(N), "r"(pred ? N : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace
