"""Device selection for the port's entry points.

Entry points default to the GPU and never fall back to the CPU on their
own: a caller who wants the CPU (the tests, a debug run) says so.  The
same function pins float32 matmuls/convolutions to full precision, since
TF32 keeps only ~3 decimal digits and the port is compared against the
JAX reference in float32.

On a mesh (``torch.distributed`` initialised) every rank takes its own
card, ``cuda:{local_rank % device_count}``, never a bare ``cuda``: ranks
that outnumber the cards share them (``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is present); anything else
    is taken as given.  On a mesh, ``None`` and a bare ``cuda`` name this
    rank's card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and dist.is_available() and dist.is_initialized()):
        from ..parallel.sharding import local_rank
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device
