"""LM-driven first-pass beam decode with the LM on the device (port of
``chinese_asr_tpu/decode/lm_fused.py``; ``ASR(lm_mode="first")``,
reference ``eval_with_lm``, model.py:989-1360).

Per step: the decoder step, the acoustic PROPOSAL (kernel K3's top-``topn``
of the f32 logits, per beam row), the Katz-backoff LM scores of the
proposals on the device tables (``lm/device_ngram.py``), the pool
selection, the harvest of finished hypotheses into a slot-per-step n-best
buffer and the survivor reorder, all on the device.  It returns the same
packed ``BeamResult`` as ``decode/beam.py``, so ``select_merge`` and the
n-best unpacking work unchanged.

Semantics mirror the host loop (``decode/lm_first_pass.py``): the same
proposals, the same LM-only pool scores ``cum + base`` (f32 here, f64
there), the same (score desc, beam*V + token asc) candidate order, the
first k non-eos candidates as survivors, the stop once every sample has a
finished hypothesis, and the null LM context (the host scores with
``bos=False``).  Strict parity needs ``topn >= bw``: at step 0 the host
pool is beam 0's ``topn`` proposals, while here the other beams' slots
are -inf pads, which could only surface as survivors in a sample with
fewer than ``bw`` live candidates.

The JAX package's ``legacy_select`` (its first-cut step body, an A/B
switch with the same output) is not ported.  Beam reorders are exact
integer gathers.  The loop is eager Python; reading the stop flag costs
one device->host sync per step.  On a mesh (``mesh``) it runs as
``decode/beam.py`` does there, the LM tables replicated on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..lm import device_ngram
from ..models import decoder as dec_ops
from ..models import las
from ..ops.cuda import topk as topk_k
from ..ops.rnn import map_state
from ..parallel import sharding
from .beam import BeamResult, BestResult, _rows, _stable_top, select_merge


@torch.no_grad()
def lm_fused_decode(params, cfg: Config, bw: int, feats, feat_lens,
                    dlm: device_ngram.DeviceNgramLM, tok2lm,
                    topn: int = 20, mesh=None) -> BeamResult:
    """tok2lm: [V] int64 tensor on the device mapping token id -> LM word
    id (``dlm.token_id_table(vocab)``), the table the host loop uses.  On
    a mesh the result holds this rank's rows, as ``beam.beam_decode``."""
    B = feats.shape[0]
    dev = feats.device
    k = bw
    V = cfg.vocab.vocab_size
    max_len = cfg.decode.max_len
    cap = k * max_len
    cand = 2 * k
    eos = cfg.vocab.eos
    dcfg, acfg = cfg.decoder, cfg.attention
    assert topn >= k, "strict host parity needs topn >= bw (see docstring)"
    assert topn >= 2, "topn=1 can dead-end every candidate row (all-eos)"

    eb = las.encode(params, cfg, feats, feat_lens)
    cell = eb.init_cell_state
    if cell is None:
        cell = dec_ops.zero_cell_state(dcfg, feats, B * k)
    else:
        cell = map_state(lambda e: e.repeat_interleave(k, dim=0), cell)
    attn_hidden = feats.new_zeros(
        (B * k, dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])))

    M1 = max(dlm.order - 1, 1)
    pool_w = k * topn
    hist = torch.full((B * k, max_len + 1), cfg.vocab.pad, dtype=torch.int64,
                      device=dev)
    hist[:, 0] = cfg.vocab.sos
    cum = torch.zeros(B * k, dtype=torch.float32, device=dev)
    lm_ctx = torch.full((B * k, M1), -1, dtype=torch.int64, device=dev)
    has_finished = torch.zeros(B, dtype=torch.bool, device=dev)
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
            eb.keys, eb.values, hist[:, l], cell, attn_hidden, mesh=mesh)
        # acoustic PROPOSALS only: K3's top-topn per beam row.  Only the
        # indices are used, and their set does not change under the
        # positive 1/temperature scale, so the divide is skipped.  Sorted
        # ascending within each row, the pool's flat index order equals
        # (beam*V + token) asc, so the stable pool top-2k below gives the
        # host's candidate order.
        _, top = topk_k.top_k(out.logit.to(torch.float32), topn)
        top_toks = torch.sort(top.to(torch.int64), dim=1).values    # [B*k, n]
        base = device_ngram.score_candidates(dlm, lm_ctx, tok2lm[top_toks])
        pool_sc = (cum[:, None] + base).reshape(B, pool_w)
        pool_tok = top_toks.reshape(B, pool_w)
        if l == 0:                 # all beams identical: beam 0's are real
            pool_sc[:, topn:] = float("-inf")
        cand_scores, i2 = _stable_top(pool_sc, cand)                # [B, 2k]
        cand_beams = torch.div(i2, topn, rounding_mode="floor")
        cand_toks = torch.gather(pool_tok, 1, i2)

        # harvest the finished among the top-k candidates into slot l
        fmask = cand_toks[:, :k] == eos                              # [B, k]
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens[:, l] = _rows(hist3, cand_beams[:, :k])[:, :, 1:].to(
            torch.int32)
        fin_scores[:, l] = torch.where(fmask, cand_scores[:, :k], neg_inf)
        has_finished |= fmask.any(dim=1)

        # survivors: the first k non-eos candidates in candidate order
        # (offset + 2k*eos, all distinct, k smallest); at most k of the 2k
        # are eos (each beam's proposals are distinct tokens; at step 0
        # the -inf pads are other beams' copies), so k are always live.
        # The chosen candidate's pool score is the host's cum[sel] +
        # base(chosen | ctx[sel]), the same two f32 addends.
        rank = cand_offsets + (cand_toks == eos).to(torch.int64) * cand
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)                # [B, k]
        k_toks = torch.gather(cand_toks, 1, active)
        cum = torch.gather(cand_scores, 1, active).reshape(-1)

        def reorder(t):
            return _rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        hist = _rows(hist3, k_beams).reshape(B * k, max_len + 1)
        hist[:, l + 1] = k_toks.reshape(-1)
        chosen = tok2lm[k_toks.reshape(-1)]
        lm_ctx = device_ngram.advance_context(reorder(lm_ctx), chosen)
        cell = map_state(reorder, out.cell_state)
        attn_hidden = reorder(out.attn_hidden_state)
        # the host loop's stop: every sample has a finished hypothesis
        # (this step's survivors are kept, as in JAX's while_loop body)
        if sharding.all_finished(has_finished, mesh):   # a host sync
            l_final = l
            break

    fin_scores = fin_scores.reshape(B, cap)
    fin_lens = torch.arange(max_len, dtype=torch.int32, device=dev
                            ).repeat_interleave(k)[None, :].expand(B, cap)
    return BeamResult(
        fin_tokens=fin_tokens.reshape(B, cap, max_len),
        fin_lens=fin_lens,
        fin_scores=fin_scores,
        fin_count=torch.isfinite(fin_scores).sum(dim=1).to(torch.int32),
        live_tokens=hist[:, 1:].reshape(B, k, max_len).to(torch.int32),
        live_scores=cum.reshape(B, k),
        l_final=l_final)


def select_best_first_pass(res: BeamResult) -> BestResult:
    """Device-side replica of ``nbest_lists(res)[b][0]``: the best
    finished hypothesis by LM score (first max in harvest order, like the
    host loop's stable sort), else live beam 0 with score 0.0 and its
    length clamped to the buffer -- the host loop's fallback, not
    ``beam.live_fallback``'s."""
    B, k, max_len = res.live_tokens.shape
    fin_sel = torch.where(torch.isfinite(res.fin_scores), res.fin_scores,
                          torch.full_like(res.fin_scores, float("-inf")))
    live_len = torch.full_like(res.fin_lens[:, 0],
                               min(res.l_final + 1, max_len))
    return select_merge(res, fin_sel, res.live_tokens[:, 0],
                        res.fin_scores.new_zeros(B), live_len)


def lm_fused_decode_best(params, cfg: Config, bw: int, feats, feat_lens,
                         dlm, tok2lm, topn: int = 20,
                         mesh=None) -> BestResult:
    """The LM-driven decode and the winner picked on the device:
    ``ASR(lm_mode="first")``'s transcription path.  On a mesh, every rank
    returns the whole batch's."""
    return sharding.gather_rows(select_best_first_pass(lm_fused_decode(
        params, cfg, bw, feats, feat_lens, dlm, tok2lm, topn, mesh)), mesh)


def nbest_lists(res: BeamResult):
    """A ``BeamResult`` of the fused decode in the host loop's format: per
    sample the finished (token list, score) pairs sorted score desc (ties
    keep harvest order), or ``[(live beam 0, 0.0)]`` when none finished --
    the ``lm_first_pass_decode`` contract."""
    fin_tokens = res.fin_tokens.cpu().numpy()
    fin_lens = res.fin_lens.cpu().numpy()
    fin_scores = res.fin_scores.cpu().numpy()
    live = res.live_tokens.cpu().numpy()
    out = []
    for b in range(fin_tokens.shape[0]):
        hyps = [(fin_tokens[b, i, :fin_lens[b, i]].astype(int).tolist(),
                 float(fin_scores[b, i]))
                for i in range(fin_tokens.shape[1])
                if np.isfinite(fin_scores[b, i])]
        if hyps:
            hyps.sort(key=lambda h: -h[1])
            out.append(hyps)
        else:
            n = min(res.l_final + 1, live.shape[2])
            out.append([(live[b, 0, :n].astype(int).tolist(), 0.0)])
    return out
