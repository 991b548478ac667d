"""Batched Levenshtein distance on tensors (port of
``chinese_asr_tpu/ops/edit_distance_jax.py``): the DP table swept along
anti-diagonals, P+R steps of vectorized [B, R+1] updates instead of P*R
scalar cells (the reference computes CER on the host one string at a
time, util.py:237-262).

Distance at cell (i, j) (i chars of pred, j chars of ref):
  d[i,j] = min(d[i-1,j] + 1, d[i,j-1] + 1, d[i-1,j-1] + (pred_i != ref_j))
Diagonal k holds the cells with i + j == k; each step reads diagonals k-1
and k-2 only.
"""

from __future__ import annotations

import torch

_BIG = 1 << 20


def batched_edit_distance(pred, pred_lens, ref, ref_lens):
    """pred [B, P], ref [B, R] int (zero-padded), true lengths pred_lens /
    ref_lens [B] -> int32 distances [B]."""
    B, P = pred.shape
    R = ref.shape[1]
    dev = pred.device
    i32 = torch.int32
    j_idx = torch.arange(R + 1, dtype=i32, device=dev)[None, :]   # [1, R+1]
    big = torch.full((B, 1), _BIG, dtype=i32, device=dev)
    # ref char j-1 at column j (column 0 unused)
    ch_r = torch.cat([torch.zeros((B, 1), dtype=ref.dtype, device=dev), ref],
                     dim=1)
    d2 = torch.where(j_idx == 0, 0, _BIG).to(i32).expand(B, R + 1)  # k = 0
    d1 = torch.where(j_idx <= 1, 1, _BIG).to(i32).expand(B, R + 1)  # k = 1
    diags = [d2, d1]
    for k in range(2, P + R + 1):
        i = k - j_idx                                              # [1, R+1]
        up = d1 + 1                                     # (i-1, j)
        left = torch.cat([big, d1[:, :-1] + 1], dim=1)   # (i, j-1)
        ch_p = pred[:, torch.clamp(i - 1, 0, max(P - 1, 0))[0]]   # [B, R+1]
        cost = (ch_p != ch_r).to(i32)
        sub = torch.cat([big, d2[:, :-1] + cost[:, 1:]], dim=1)   # (i-1, j-1)
        d = torch.minimum(torch.minimum(up, left), sub)
        d = torch.where(i == 0, j_idx, d)                          # top row
        d = torch.where(j_idx == 0, torch.full_like(d, k), d)     # left col
        d = torch.where((i < 0) | (i > P), _BIG, d)               # outside
        d2, d1 = d1, d
        diags.append(d)
    all_diags = torch.stack(diags)                        # [K+1, B, R+1]
    k_out = (pred_lens.long() + ref_lens.long())          # [B]
    picked = all_diags[k_out, torch.arange(B, device=dev)]          # [B, R+1]
    return torch.gather(picked, 1, ref_lens.long()[:, None])[:, 0].to(i32)


def batched_cer(pred, pred_lens, ref, ref_lens):
    """Normalized per-utterance CER [B] float32 (distance / ref_len,
    reference util.py:237-251)."""
    d = batched_edit_distance(pred, pred_lens, ref, ref_lens)
    return d.to(torch.float32) / torch.clamp(ref_lens.to(torch.float32),
                                             min=1.0)
