// Error reporting for the Python wrappers (turns the cudaError_t an entry
// point returned into CUDA's own message), and the decode programs' one
// graph (utils/graphs.py ``Graphed``): captured parts composed into a
// graph whose later parts each run inside a conditional IF node, so that
// the decode loop's stop test runs on the card, as XLA's while_loop does.
#include "common.cuh"

ASR_API const char* asr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The IF node's handle: its body runs while the loop's stop flag is false.
__global__ void asr_unless_kernel(cudaGraphConditionalHandle handle,
                                  const bool* done) {
    cudaGraphSetConditional(handle, *done ? 0u : 1u);
}

static cudaError_t compose(const unsigned long long* parts,
                           const int* guarded, int n, const bool* done,
                           cudaGraph_t top) {
    cudaGraphNode_t prev = nullptr;
    for (int i = 0; i < n; ++i) {
        cudaGraph_t part = (cudaGraph_t)parts[i];
        cudaError_t e;
        if (!guarded[i]) {
            cudaGraphNode_t child;
            e = cudaGraphAddChildGraphNode(&child, top, prev ? &prev : nullptr,
                                           prev ? 1 : 0, part);
            if (e != cudaSuccess) return e;
            prev = child;
            continue;
        }
        cudaGraphConditionalHandle handle;
        e = cudaGraphConditionalHandleCreate(&handle, top, 0,
                                             cudaGraphCondAssignDefault);
        if (e != cudaSuccess) return e;
        void* args[] = {&handle, (void*)&done};
        cudaKernelNodeParams kp = {};
        kp.func = (void*)asr_unless_kernel;
        kp.gridDim = dim3(1);
        kp.blockDim = dim3(1);
        kp.kernelParams = args;
        cudaGraphNode_t set;
        e = cudaGraphAddKernelNode(&set, top, prev ? &prev : nullptr,
                                   prev ? 1 : 0, &kp);
        if (e != cudaSuccess) return e;
        cudaGraphNodeParams cp = {};
        cp.type = cudaGraphNodeTypeConditional;
        cp.conditional.handle = handle;
        cp.conditional.type = cudaGraphCondTypeIf;
        cp.conditional.size = 1;
        cudaGraphNode_t cond;
        e = cudaGraphAddNode(&cond, top, &set, 1, &cp);
        if (e != cudaSuccess) return e;
        cudaGraphNode_t child;
        e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                       nullptr, 0, part);
        if (e != cudaSuccess) return e;
        prev = cond;
    }
    return cudaSuccess;
}

// One executable graph of the captured ``parts`` (cudaGraph_t handles, in
// order, each added as a copy): part i runs after part i - 1, and a part
// with ``guarded[i]`` inside an IF node whose handle a one-thread kernel
// sets from ``done`` (a device bool) just before it.  Writes the graph and
// its instance; on an error destroys what it made.
ASR_API int asr_graph_compose(const unsigned long long* parts,
                              const int* guarded, int n, const void* done,
                              unsigned long long* graph_out,
                              unsigned long long* exec_out) {
    cudaGraph_t top = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaError_t e = cudaGraphCreate(&top, 0);
    if (e != cudaSuccess) return (int)e;
    e = compose(parts, guarded, n, (const bool*)done, top);
    if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, top, 0);
    if (e != cudaSuccess) {
        cudaGraphDestroy(top);
        return (int)e;
    }
    *graph_out = (unsigned long long)top;
    *exec_out = (unsigned long long)exec;
    return 0;
}

ASR_API int asr_graph_launch(unsigned long long exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

ASR_API int asr_graph_destroy(unsigned long long graph,
                              unsigned long long exec) {
    cudaError_t e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
    return (int)(e != cudaSuccess ? e : f);
}
