"""Losses (port of ``chinese_asr_tpu/train/loss.py``; reference util.py:
265-295 label smoothing, model.py:53-56 CE).

Label-smoothed cross entropy from logits with a single logsumexp: the
smoothed target puts (1 - ls) on the target class and ls/(K-1) on each of
the K-1 others.
"""

from __future__ import annotations

import torch


def label_smoothed_ce(logits, targets, mask=None, label_smooth: float = 0.1,
                      n_valid=None):
    """Per-token smoothed CE, averaged over valid tokens.

    logits [..., V]; targets [...] int; mask [...] (1 valid / 0 pad).
    With label_smooth == 0 this is exact cross entropy.  ``n_valid``: the
    count to divide the masked sum by, in place of ``mask.sum()`` (on a
    mesh the global batch's, so each data rank's loss is its share of the
    global mean; never the mean of the ranks' means)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    if label_smooth == 0.0:
        per_tok = lse - tgt
    else:
        off = label_smooth / (logits.shape[-1] - 1)
        per_tok = (lse - (1.0 - label_smooth) * tgt
                   - off * (logits.sum(dim=-1) - tgt))
    if mask is None:
        return per_tok.mean()
    mask = mask.to(per_tok.dtype)
    n = mask.sum() if n_valid is None else n_valid.to(per_tok.dtype)
    return (per_tok * mask).sum() / torch.clamp(n, min=1.0)
