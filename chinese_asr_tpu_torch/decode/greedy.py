"""Greedy decoding (port of ``chinese_asr_tpu/decode/greedy.py``, reference
model.py:503-602).

The token loop is an eager Python loop with the batch-wide early exit of
the reference (``if finished.all(): break``, model.py:578-579).  Reading
that flag costs one device->host sync per step.

Scoring bookkeeping replicates model.py:567-576 exactly: the eos step's
logp enters via the first conditional add; subsequent steps of a finished
sample contribute nothing; ``final_lens`` counts tokens before eos.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..models import decoder as dec_ops
from ..models import las
from ..ops.metrics import cer


class GreedyResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_len] int32
    final_lens: torch.Tensor   # [B] int32 (length before eos)
    scores: torch.Tensor       # [B] accumulated logp
    finished: torch.Tensor     # [B] bool
    alignments: torch.Tensor   # [B, max_len, L]


@torch.no_grad()
def greedy_decode(params, cfg: Config, feats, feat_lens) -> GreedyResult:
    B = feats.shape[0]
    dev = feats.device
    max_len = cfg.decode.max_len
    eb = las.encode(params, cfg, feats, feat_lens)
    L = eb.enc_out.shape[1]
    dcfg, acfg = cfg.decoder, cfg.attention
    ctx = dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])

    cell = eb.init_cell_state
    if cell is None:
        z = feats.new_zeros((B, dcfg.hidden_size))
        cell = [(z, z)] * dcfg.num_layers
    tokens = torch.full((B,), cfg.vocab.sos, dtype=torch.int64, device=dev)
    attn_hidden = feats.new_zeros((B, ctx))
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    final_lens = torch.zeros(B, dtype=torch.int32, device=dev)
    accum = torch.zeros(B, dtype=torch.float32, device=dev)
    out = torch.full((B, max_len), cfg.vocab.pad, dtype=torch.int32,
                     device=dev)
    align = feats.new_zeros((B, max_len, L))

    for l in range(max_len):
        step = dec_ops.decoder_step(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, tokens, cell, attn_hidden)
        logit = step.logit.to(torch.float32)
        logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
        lp, tok = torch.max(logp, dim=1)    # first max, like jnp.argmax
        cur_fin = tok == cfg.vocab.eos
        accum = accum + torch.where(~finished & cur_fin, lp,
                                    torch.zeros_like(lp))
        finished = finished | cur_fin
        final_lens = final_lens + (~finished).to(torch.int32)
        accum = accum + torch.where(~finished, lp, torch.zeros_like(lp))
        out[:, l] = tok.to(torch.int32)
        align[:, l, :] = step.alignment
        tokens, cell, attn_hidden = tok, step.cell_state, step.attn_hidden_state
        if bool(finished.all()):            # one host sync per step
            break
    return GreedyResult(out, final_lens, accum, finished, align)


class EvalOutput(NamedTuple):
    pred_text: List[str]
    score: List[float]
    text: Optional[List[str]] = None    # reference texts, when given
    wer: Optional[float] = None         # mean CER against them
    n: Optional[int] = None             # rows (greedy)
    alignment: Optional[np.ndarray] = None       # [B, max_len, L] (greedy)
    audio_feat_len: Optional[np.ndarray] = None  # [B] (greedy)
    text_len: Optional[np.ndarray] = None        # [B] tokens before eos


def with_cer(pred_text, score, vocab, text, **rest) -> EvalOutput:
    """The output rows, with the reference texts (token ids or strings)
    and the mean CER against them when ``text`` is given."""
    if text is None:
        return EvalOutput(pred_text, score, **rest)
    ref_text = [t if isinstance(t, str) else vocab.decode(t) for t in text]
    wer = float(np.mean([cer(p, r) for p, r in zip(pred_text, ref_text)]))
    return EvalOutput(pred_text, score, ref_text, wer, **rest)


def finalize_greedy(res: GreedyResult, vocab, text=None, feat_lens=None,
                    want_alignment: bool = False) -> EvalOutput:
    """Host detokenization (reference model.py:582-601); the score is the
    accumulated logp over (tokens before eos + 1 if eos was reached).
    With ``text`` (reference texts) the output carries the mean CER;
    ``want_alignment`` gates the [B, max_len, L] alignment copy."""
    tokens = res.tokens.cpu().numpy()
    final_lens = res.final_lens.cpu().numpy()
    finished = res.finished.cpu().numpy()
    accum = res.scores.cpu().numpy()
    pred_text, score = [], []
    for i in range(tokens.shape[0]):
        ids = tokens[i, : final_lens[i]]
        if len(ids) == 0:
            pred_text.append("")
            score.append(0.0)
        else:
            pred_text.append(vocab.decode(ids))
            score.append(float(accum[i])
                         / (int(final_lens[i]) + int(finished[i])))
    return with_cer(
        pred_text, score, vocab, text, n=tokens.shape[0],
        alignment=res.alignments.cpu().numpy() if want_alignment else None,
        audio_feat_len=None if feat_lens is None
        else np.asarray(feat_lens.cpu() if isinstance(feat_lens, torch.Tensor)
                        else feat_lens),
        text_len=final_lens)
