// The Hopper pieces of the persistent 3xTF32 tensor-core kernels K7
// (gemm.cu) and K8 (subsample.cu): mbarriers for a TMA ring, 2-d TMA
// loads of 128-byte-swizzled tiles, the wgmma descriptor of such a tile,
// wgmma.m64n128k8 TF32 with A from registers and its fences, and the
// host's tensor maps (cuTensorMapEncodeTiled through the runtime's
// entry-point query, so no -lcuda at the link).
#pragma once

#include "common.cuh"
#include "tc.cuh"

#include <cuda.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 ::"r"(smem_u32(bar)) : "memory");
}

// a 2-d TMA load of the box at (c0 innermost, c1) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
                 ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
                   "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled (as TMA wrote it): start address, the 8-row stride (1024
// bytes) and the swizzle mode.  The leading offset is unused in this
// layout.  Adding 2 advances the start by one k8 step (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void consumer_sync(int wg) {
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = a[64 x 8] b[8 x 128] (+ d if `accumulate`): TF32 inputs
// (A four registers a thread, B the K-major tile at `desc`), float32
// accumulators
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no -lcuda at the link)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

// A 2-d float32 map of `rows` x `cols` (row stride `ld` floats), boxes
// of `box_rows` x 32 (128-byte rows), 128-byte swizzled, zeros outside.
// Returns 0 or a cudaError_t.
int make_map(CUtensorMap* map, const float* ptr, int rows, int cols, int ld,
             int box_rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
    cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
    cuuint32_t elem[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptr, dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The card's SM count (the persistent kernels' grid), queried once.
// Returns 0 or a cudaError_t.
int sm_count(int* sms) {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        int rc = (int)cudaGetDevice(&dev);
        if (!rc) rc = (int)cudaDeviceGetAttribute(
            &n, cudaDevAttrMultiProcessorCount, dev);
        if (rc) return rc;
    }
    *sms = n;
    return 0;
}

}  // namespace
