"""ebranchformer_device_ms.offline: device milliseconds a chunk, in the
traced call, in the kernels that only the E-Branchformer encoder
launches in the offline cell: the subsampling's cuDNN convolutions, the
depthwise convolutions (the cgMLP's and the merge's), LayerNorm, the
attention's softmax, the cgMLP's GELU and the FFNs' Swish, by the names
the card's trace gives them (``NAMES``).  Its products (K7) and the
copies, concatenations, gate products and residual adds around them run
in kernels the decoder also launches: those count in
``library_device_ms.offline``, not here.

It reads the program's counter of E-Branchformer blocks,
``e_branchformer.blocks`` (``kernels/e_branchformer.json``): None unless
the window counted the configuration's ``num_layers`` blocks a chunk and
the trace holds a GELU record for each, so that a trace that lost the
encoder's records reads as missing, not as fast; None for any other
``encoder_type``."""

from port_bench.lib import trace

NAMES = ("xmma_fprop_implicit_gemm",          # cuDNN: the subsampling
         "conv_depthwise2d_forward_kernel",   # the depthwise convs
         "vectorized_layer_norm_kernel",
         "softmax_warp_forward",
         "GeluCUDAKernelImpl",
         "silu_kernel")


def read(rec):
    t = rec.get("trace")
    cfg = rec["cfg"]
    if rec["kind"] != "offline" or not t \
            or cfg["encoder"]["encoder_type"] != "E_BRANCHFORMER":
        return None
    chunks = len(t["work"])
    blocks = t["counted"].get("e_branchformer.blocks")
    marks = rec["kernels"].get("E-Branchformer")
    if not chunks or marks is None \
            or blocks != cfg["encoder"]["num_layers"] * chunks \
            or trace.kernel_seconds(t, marks["names"])[1] != blocks:
        return None
    secs, _ = trace.kernel_seconds(t, NAMES)
    return 1e3 * secs / chunks
