"""Device selection for the port's entry points.

Entry points default to the GPU and never fall back to the CPU on their
own: a caller who wants the CPU (the tests, a debug run) says so.  The
same function pins float32 matmuls/convolutions to full precision, since
TF32 keeps only ~3 decimal digits and the port is compared against the
JAX reference in float32.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is present); anything else
    is taken as given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
