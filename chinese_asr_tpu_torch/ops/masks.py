"""Length masks (port of ``chinese_asr_tpu/ops/masks.py``), batch-major
[B, L] like the JAX package."""

from __future__ import annotations

import torch


def length_mask(lens, max_len: int, dtype=torch.float32):
    """1.0 for valid positions, 0.0 for padding; shape [B, L]."""
    pos = torch.arange(max_len, device=lens.device)[None, :]
    return (pos < lens[:, None]).to(dtype)


def softmax_mask(lens, max_len: int, dtype=torch.float32):
    """Additive mask: 0 for valid, -inf for padding; shape [B, L]."""
    pos = torch.arange(max_len, device=lens.device)[None, :]
    invalid = pos >= lens[:, None]
    return torch.where(invalid, torch.full((), float("-inf"), dtype=dtype,
                                           device=lens.device),
                       torch.zeros((), dtype=dtype, device=lens.device))
