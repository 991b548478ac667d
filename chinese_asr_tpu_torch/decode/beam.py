"""Batched beam search (port of ``chinese_asr_tpu/decode/beam.py``,
reference model.py:604-987), with the passive LM track of the second pass
and the host-side n-best finalization.

Per step over the [B, k*V] accumulated scores: a two-stage exact top-2k
(per-beam top-(k+1) through kernel K3 -- or K4, which folds the logp
transform in, under the JAX package's opt-in ``CHINESE_ASR_PALLAS_FUSED=1``
-- then a stable top-2k over the k(k+1) union; step 0 keeps only beam 0's
slice), eos harvest of the top-k
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

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..lm import device_ngram as dev_lm
from ..models import decoder as dec_ops
from ..models import las
from ..ops.cuda import topk as topk_k
from .greedy import EvalOutput, with_cer


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


def use_fused_logp() -> bool:
    """The JAX package's opt-in (``use_fused_logp``): the beam's stage 1
    runs K4, folding ``logit/T - logsumexp + score`` into the top-k, when
    ``CHINESE_ASR_PALLAS_FUSED`` is set to anything but "0".  Off by
    default: its logsumexp is summed in another order than the unfused
    transform's, which can flip near-tied survivors."""
    return os.environ.get("CHINESE_ASR_PALLAS_FUSED", "0") != "0"


@torch.no_grad()
def beam_decode(params, cfg: Config, bw: int, feats, feat_lens,
                fused_logp: Optional[bool] = None, lm_track=None):
    """``fused_logp``: None reads ``use_fused_logp()``.

    ``lm_track`` (optional): ``(dlm, tok2lm, bos_id, eos_id)`` -- a
    ``DeviceNgramLM`` and the token -> LM word map.  The loop then
    PASSIVELY tracks each live beam's cumulative LM score (the bos=True
    chain of ``rescore.score_sequences``; the totals agree to summation
    order, atol 2e-4) and harvests each finished hypothesis's full
    sentence LM score (cum + the </s> term) into an extra buffer,
    returned as ``(BeamResult, fin_lm [B, cap])``.  The LM never steers
    the search, so the decode is identical to the untracked one.  Cost:
    two [B*k, 1] LM scorings per step (the </s> probe and the chosen
    token's advance)."""
    if fused_logp is None:
        fused_logp = use_fused_logp()
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
    if lm_track is not None:
        dlm, tok2lm, lm_bos, lm_eos = lm_track
        lm_ctx = torch.full((B * k, max(dlm.order - 1, 1)), -1,
                            dtype=torch.int64, device=dev)
        if dlm.order > 1:
            lm_ctx[:, -1] = lm_bos                    # bos=True chain
        lm_cum = torch.zeros(B * k, dtype=torch.float32, device=dev)
        fin_lm = torch.zeros((B, max_len, k), dtype=torch.float32,
                             device=dev)
        eos_col = torch.full((B * k, 1), lm_eos, dtype=torch.int64,
                             device=dev)

    for l in range(max_len):
        out = dec_ops.decoder_step_beam(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, hist[:, l], cell, attn_hidden)

        # stage 1: per-beam top-(k+1) over V
        if fused_logp:
            # K4: the transform rides in the kernel; a -inf row bias
            # disables beams > 0 at step 0 (all beams identical)
            bias = logp_scores[:, None].clone()                      # [B*k, 1]
            if l == 0:
                bias.view(B, k)[:, 1:] = float("-inf")
            v1, t1 = topk_k.top_k_fused(out.logit.to(torch.float32), bias,
                                        k + 1, cfg.decoder.temperature)
        else:
            # the logp transform, then K3
            logit = out.logit.to(torch.float32) / cfg.decoder.temperature
            logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
            logp = logp + logp_scores[:, None]                       # [B*k, V]
            if l == 0:                 # all beams identical: beam 0 only
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
        if lm_track is not None:
            # full-sentence LM total of each harvested hypothesis: the
            # parent beam's cum chain + the </s> term in its context
            # (reference model.py:755 scores with bos=True, eos=True);
            # recorded on the stopping step too, as in JAX
            eos_base = dev_lm.score_candidates(dlm, lm_ctx, eos_col)[:, 0]
            lm_tot = (lm_cum + eos_base).reshape(B, k)
            fin_lm[:, l] = torch.where(
                fmask, torch.gather(lm_tot, 1, cand_beams[:, :k]), 0.0)

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
        if lm_track is not None:
            # advance the passive chain along the survivors (never eos:
            # the rank trick picks non-eos), so it stays a word chain
            ctx_sel = reorder(lm_ctx)
            chosen = tok2lm[k_toks.reshape(-1)]
            base = dev_lm.score_candidates(dlm, ctx_sel, chosen[:, None])
            lm_cum = reorder(lm_cum[:, None])[:, 0] + base[:, 0]
            lm_ctx = dev_lm.advance_context(ctx_sel, chosen)

    fin_scores = fin_scores.reshape(B, cap)
    fin_lens = torch.arange(max_len, dtype=torch.int32, device=dev
                            ).repeat_interleave(k)[None, :].expand(B, cap)
    res = BeamResult(
        fin_tokens=fin_tokens.reshape(B, cap, max_len),
        fin_lens=fin_lens,
        fin_scores=fin_scores,
        fin_count=torch.isfinite(fin_scores).sum(dim=1).to(torch.int32),
        live_tokens=hist[:, 1:].reshape(B, k, max_len).to(torch.int32),
        live_scores=logp_scores.reshape(B, k),
        l_final=l_final)
    if lm_track is not None:
        return res, fin_lm.reshape(B, cap)
    return res


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


def finalize_best(best: BestResult, vocab, text=None) -> EvalOutput:
    """Host detokenization of a device-selected ``BestResult``; with
    ``text`` (reference texts) also the mean CER."""
    tokens = best.tokens.cpu().numpy()
    lens = best.lens.cpu().numpy()
    scores = best.scores.cpu().numpy()
    return with_cer(
        [vocab.decode(tokens[b, : lens[b]]) for b in range(tokens.shape[0])],
        [float(s) for s in scores], vocab, text)


def compact_nbest(res: BeamResult, bucket: int = 32) -> BeamResult:
    """Gather the finite n-best slots into a dense [B, max_fin] prefix on
    the device before the host transfer of the second pass.  Lossless:
    every finite slot is kept, in harvest order (a stable sort on "not
    finite"), so the rescored winners are the same; max_fin is the
    largest ``fin_count`` rounded up to ``bucket``.  Reading fin_count
    costs one small device->host copy."""
    B, cap = res.fin_scores.shape
    n = int(res.fin_count.max()) if B else 0
    max_fin = min(cap, -(-max(n, 1) // bucket) * bucket)
    if max_fin >= cap:
        return res
    finite = torch.isfinite(res.fin_scores)
    order = torch.argsort((~finite).to(torch.int32), dim=1,
                          stable=True)[:, :max_fin]
    rows = torch.arange(B, device=order.device)[:, None]
    return res._replace(fin_tokens=res.fin_tokens[rows, order],
                        fin_lens=res.fin_lens[rows, order],
                        fin_scores=res.fin_scores[rows, order])


def finalize_beam(res: BeamResult, cfg: Config, vocab, text=None,
                  lm_model=None, second_pass: bool = False,
                  lm_weight: float = 0.0,
                  length_weight: float = 0.0) -> EvalOutput:
    """Host finalization (reference parse_finished_tensors, model.py:
    708-765, and the never-finished fallback, 961-972): per sample the
    finished slot with the best selection score -- the raw logp, or with
    ``second_pass`` the rescore ``logp + lm_weight * lm + length_weight *
    len`` with ``lm`` = ``lm_model.score(' '.join(words), bos=True)``
    (model.py:749-763) -- first max in harvest order, its RAW logp
    reported; a sample with nothing finished takes the best live beam by
    ``logp + length_weight * (l_final + 1)``.

    A C++-backed ``NgramLM`` (``has_batch_states``) scores every
    hypothesis in one call over LM word ids (``score_batch_ids``, no
    strings); any other LM goes through its string path.  With ``text``
    (reference texts) the output also carries the mean CER."""
    fin_tokens = res.fin_tokens.cpu().numpy()
    fin_lens = res.fin_lens.cpu().numpy()
    fin_scores = res.fin_scores.cpu().numpy()
    fin_count = res.fin_count.cpu().numpy()
    live_tokens = res.live_tokens.cpu().numpy()
    live_scores = res.live_scores.cpu().numpy()
    l_final = int(res.l_final)
    B, cap = fin_scores.shape
    valid = np.isfinite(fin_scores)                                # [B, cap]
    if second_pass and lm_model is None:
        raise ValueError("the second pass needs a language model")

    if second_pass and valid.any():
        vb, vs = np.nonzero(valid)                    # flat slot coordinates
        lens_v = fin_lens[vb, vs]
        if getattr(lm_model, "has_batch_states", False):
            # token ids -> LM word ids through a cached table, every
            # hypothesis scored in ONE FFI call
            table = lm_model.token_id_table(vocab)
            toks = fin_tokens[vb, vs]                 # [N, max_len]
            pos = np.arange(toks.shape[1])[None, :] < lens_v[:, None]
            offsets = np.zeros(len(vb) + 1, np.int64)
            np.cumsum(lens_v, out=offsets[1:])
            lm_all = lm_model.score_batch_ids(table[toks[pos]], offsets,
                                              bos=True)
        else:
            sents = [" ".join(vocab.int2word[i]
                              for i in fin_tokens[b, s, : fin_lens[b, s]])
                     for b, s in zip(vb, vs)]
            lm_all = np.asarray([lm_model.score(s, bos=True)
                                 for s in sents])
        sel = np.full((B, cap), -np.inf)
        sel[vb, vs] = (fin_scores[vb, vs] + lm_weight * lm_all
                       + length_weight * lens_v)
    else:
        sel = np.where(valid, fin_scores, -np.inf)

    best = np.argmax(sel, axis=1)                                  # [B]
    outputs = []
    for b in range(B):
        if fin_count[b] > 0:
            s = best[b]
            outputs.append((fin_tokens[b, s, : fin_lens[b, s]].tolist(),
                            float(fin_scores[b, s])))
        else:
            act = live_scores[b] + length_weight * (l_final + 1)
            j = int(np.argmax(act))
            outputs.append((live_tokens[b, j, : l_final + 1].tolist(),
                            float(act[j])))
    return with_cer([vocab.decode(ids) for ids, _ in outputs],
                     [s for _, s in outputs], vocab, text)
