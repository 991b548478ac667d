"""conformer_device_ms.offline: device milliseconds a chunk, in the
traced call, in the kernels that only the Conformer encoder launches in
the offline cell: its convolutions (the subsampling's and the depthwise
one), LayerNorm, the attention's softmax, GLU, Swish and BatchNorm, by
the names the card's trace gives them (``NAMES``).  Its products (the
subsampling's linear map, the FFNs, the attention's and the pointwise
convolutions' GEMMs) run in the cuBLAS kernels the decoder also
launches, and the residual adds in PyTorch's elementwise kernels: those
count in ``library_device_ms.offline``, not here.

It reads the program's counter of Conformer blocks, ``conformer.blocks``
(``kernels/conformer.json``): None unless the window counted the
configuration's ``num_layers`` blocks a chunk and the trace holds a GLU
record for each, so that a trace that lost the encoder's records reads
as missing, not as fast."""

from port_bench.lib import trace

NAMES = ("xmma_fprop_implicit_gemm",          # cuDNN: the subsampling
         "conv_depthwise2d_forward_kernel",   # the depthwise conv
         "vectorized_layer_norm_kernel",
         "softmax_warp_forward",
         "glu_kernel",
         "silu_kernel",
         "bn_fw_inf")                         # cuDNN's inference BatchNorm


def read(rec):
    t = rec.get("trace")
    cfg = rec["cfg"]
    if rec["kind"] != "offline" or not t \
            or cfg["encoder"]["encoder_type"] != "CONFORMER":
        return None
    chunks = len(t["work"])
    blocks = t["counted"].get("conformer.blocks")
    marks = rec["kernels"].get("Conformer")
    if not chunks or marks is None \
            or blocks != cfg["encoder"]["num_layers"] * chunks \
            or trace.kernel_seconds(t, marks["names"])[1] != blocks:
        return None
    secs, _ = trace.kernel_seconds(t, NAMES)
    return 1e3 * secs / chunks
