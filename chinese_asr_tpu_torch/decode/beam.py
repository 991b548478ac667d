"""Batched beam search (port of ``chinese_asr_tpu/decode/beam.py``,
reference model.py:604-987), acoustic modes only (no ``lm_track``).

Per step over the [B, k*V] accumulated scores: a two-stage exact top-2k
(per-beam top-(k+1) through kernel K3, then a stable top-2k over the
k(k+1) union; step 0 keeps only beam 0's slice), eos harvest of the top-k
candidates into a fixed slot-per-step n-best buffer, survivors by the
offsets + eos-penalty smallest-k trick (model.py:904-909), and the
reference's early stop when every sample's top candidate is eos
(model.py:897-901) -- on that step the survivors are NOT applied.

Beam reorders are exact integer gathers (the JAX package used one-hot
einsums at HIGHEST precision for the same effect).  enc/keys/values/mask
are never tiled nor reordered: the beam dim lives on the attention query.
The loop is eager Python; reading the stop flag costs one device->host
sync per step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..models import decoder as dec_ops
from ..models import las
from ..ops.cuda import topk as topk_k
from .greedy import EvalOutput


class BeamResult(NamedTuple):
    fin_tokens: torch.Tensor    # [B, CAP, max_len] int32 (no sos/eos);
                                #   cap index = harvest_step*k + cand_rank
    fin_lens: torch.Tensor      # [B, CAP] int32 (== harvest step)
    fin_scores: torch.Tensor    # [B, CAP] f32; -inf marks EMPTY slots
    fin_count: torch.Tensor     # [B] int32 (number of finite slots)
    live_tokens: torch.Tensor   # [B, k, max_len] final history (no sos)
    live_scores: torch.Tensor   # [B, k] accumulated logp of live beams
    l_final: int                # the reference's loop variable at exit


def _stable_top(x, n: int):
    """Top-n along dim 1, descending, ties to the lower index (the
    jax.lax.top_k order; torch.topk does not promise it)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _rows(t3, idx):
    """Per-sample row gather: t3 [B, k, ...], idx [B, j] -> [B, j, ...]."""
    return t3[torch.arange(t3.shape[0], device=t3.device)[:, None], idx]


@torch.no_grad()
def beam_decode(params, cfg: Config, bw: int, feats, feat_lens) -> BeamResult:
    B = feats.shape[0]
    dev = feats.device
    k = bw
    V = cfg.vocab.vocab_size
    max_len = cfg.decode.max_len
    cap = k * max_len
    cand = 2 * k
    eos = cfg.vocab.eos
    dcfg, acfg = cfg.decoder, cfg.attention

    eb = las.encode(params, cfg, feats, feat_lens)
    ctx = dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])

    # tile only true per-beam state: row r = b*k + beam
    cell = eb.init_cell_state
    if cell is None:
        z = feats.new_zeros((B * k, dcfg.hidden_size))
        cell = [(z, z)] * dcfg.num_layers
    else:
        cell = [tuple(e.repeat_interleave(k, dim=0) for e in s) for s in cell]

    hist = torch.full((B * k, max_len + 1), cfg.vocab.pad, dtype=torch.int64,
                      device=dev)
    hist[:, 0] = cfg.vocab.sos
    logp_scores = torch.zeros(B * k, dtype=torch.float32, device=dev)
    attn_hidden = feats.new_zeros((B * k, ctx))
    top_beam_finished = torch.zeros(B, dtype=torch.bool, device=dev)
    fin_tokens = torch.zeros((B, max_len, k, max_len), dtype=torch.int32,
                             device=dev)
    fin_scores = torch.full((B, max_len, k), float("-inf"),
                            dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    cand_offsets = torch.arange(cand, device=dev)[None, :]          # [1, 2k]
    l_final = max_len - 1

    for l in range(max_len):
        out = dec_ops.decoder_step_beam(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, hist[:, l], cell, attn_hidden)

        # stage 1: per-beam top-(k+1) over V (kernel K3)
        logit = out.logit.to(torch.float32) / cfg.decoder.temperature
        logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
        logp = logp + logp_scores[:, None]                           # [B*k, V]
        if l == 0:                     # all beams identical: beam 0 only
            logp.view(B, k, V)[:, 1:] = float("-inf")
        v1, t1 = topk_k.top_k(logp, k + 1)
        # stage 2: top-2k of the k(k+1) union (lower beam, then lower
        # rank on ties -- the flat top_k order)
        cand_scores, i2 = _stable_top(v1.reshape(B, k * (k + 1)), cand)
        cand_beams = torch.div(i2, k + 1, rounding_mode="floor")     # [B, 2k]
        cand_tokens = torch.gather(t1.reshape(B, k * (k + 1)), 1,
                                   i2).to(torch.int64)

        # harvest finished among the top-k (model.py:875-889) into slot l
        top_tokens = cand_tokens[:, :k]
        fmask = top_tokens == eos                                    # [B, k]
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens[:, l] = _rows(hist3, cand_beams[:, :k])[:, :, 1:].to(
            torch.int32)
        fin_scores[:, l] = torch.where(fmask, cand_scores[:, :k], neg_inf)

        # early stop (model.py:897-901): on the stopping step the
        # survivors are not applied
        top_beam_finished |= top_tokens[:, 0] == eos
        if bool(top_beam_finished.all()):          # one host sync per step
            l_final = l
            break

        # survivors (model.py:904-909): the k smallest of offset + 2k*eos
        # (all distinct, so any sort picks the same set in the same order)
        rank = cand_offsets + (cand_tokens == eos).to(torch.int64) * cand
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)                # [B, k]
        k_toks = torch.gather(cand_tokens, 1, active)
        logp_scores = torch.gather(cand_scores, 1, active).reshape(-1)

        hist = _rows(hist3, k_beams).reshape(B * k, max_len + 1)
        hist[:, l + 1] = k_toks.reshape(-1)

        def reorder(t):
            return _rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        cell = [tuple(reorder(e) for e in st) for st in out.cell_state]
        attn_hidden = reorder(out.attn_hidden_state)

    fin_scores = fin_scores.reshape(B, cap)
    fin_lens = torch.arange(max_len, dtype=torch.int32, device=dev
                            ).repeat_interleave(k)[None, :].expand(B, cap)
    return BeamResult(
        fin_tokens=fin_tokens.reshape(B, cap, max_len),
        fin_lens=fin_lens,
        fin_scores=fin_scores,
        fin_count=torch.isfinite(fin_scores).sum(dim=1).to(torch.int32),
        live_tokens=hist[:, 1:].reshape(B, k, max_len).to(torch.int32),
        live_scores=logp_scores.reshape(B, k),
        l_final=l_final)


class BestResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_len] int32
    lens: torch.Tensor      # [B] int32
    scores: torch.Tensor    # [B] f32
    finished: torch.Tensor  # [B] bool (False -> live-beam fallback was used)


def select_merge(res: BeamResult, fin_sel, live_tok, live_sc,
                 live_len) -> BestResult:
    """Winner selection: first-max argmax over the caller's -inf-masked
    per-slot scores (ties resolve in harvest order), the winner's
    tokens/len/raw score gathered from the n-best buffers, and the
    live-beam fallback merged in for rows that never finished."""
    rows = torch.arange(fin_sel.shape[0], device=fin_sel.device)
    slot = torch.argmax(fin_sel, dim=1)                              # [B]
    has_fin = res.fin_count > 0
    return BestResult(
        tokens=torch.where(has_fin[:, None], res.fin_tokens[rows, slot],
                           live_tok),
        lens=torch.where(has_fin, res.fin_lens[rows, slot], live_len),
        scores=torch.where(has_fin, res.fin_scores[rows, slot], live_sc),
        finished=has_fin)


def live_fallback(res: BeamResult, length_weight: float):
    """The reference's never-finished fallback (model.py:961-972): best
    live beam by ``logp + length_weight * (l_final + 1)``."""
    act = res.live_scores + length_weight * float(res.l_final + 1)  # [B, k]
    j = torch.argmax(act, dim=1)
    rows = torch.arange(act.shape[0], device=act.device)
    live_len = torch.full_like(res.fin_lens[:, 0], res.l_final + 1)
    return res.live_tokens[rows, j], act[rows, j], live_len


def select_best(res: BeamResult, length_weight: float) -> BestResult:
    """Best finished hypothesis by raw logp (non-finite slots masked, first
    max wins), else the live-beam fallback."""
    fin_sel = torch.where(torch.isfinite(res.fin_scores), res.fin_scores,
                          torch.full_like(res.fin_scores, float("-inf")))
    return select_merge(res, fin_sel, *live_fallback(res, length_weight))


def beam_decode_best(params, cfg: Config, bw: int, feats,
                     feat_lens) -> BestResult:
    """Decode + on-device best-hypothesis selection (transcription without
    a second pass)."""
    return select_best(beam_decode(params, cfg, bw, feats, feat_lens),
                       cfg.decode.length_weight)


def finalize_best(best: BestResult, vocab) -> EvalOutput:
    """Host detokenization of a device-selected ``BestResult``."""
    tokens = best.tokens.cpu().numpy()
    lens = best.lens.cpu().numpy()
    scores = best.scores.cpu().numpy()
    return EvalOutput(
        [vocab.decode(tokens[b, : lens[b]]) for b in range(tokens.shape[0])],
        [float(s) for s in scores])
