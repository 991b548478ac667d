"""First-pass-LM beam decode, the host-loop oracle (port of
``chinese_asr_tpu/decode/lm_first_pass.py``; reference ``eval_with_lm``,
model.py:989-1360).

Per step the acoustic model only *proposes*: the decoder's top-``topn``
tokens per beam (kernel K3 on the card) are rescored by the n-gram LM over
the full prefix (reference calc_lm_score, model.py:1182-1194: ``lm.score('
'.join(hist + [tok]), bos=False, eos=False)``), every other token is out,
and the fairseq-style 2k-candidate selection runs on the LM scores alone.

The decoder step (with the survivor reorder in front of it) and the
proposal run on the device; the proposals are pulled to the host each
step, where the C++ LM (``lm/ngram.py`` ``NgramLM``) scores them by its
incremental batch state API (or, for an LM without batch states, the
full-prefix strings), and the beam bookkeeping is numpy.  The next step
is launched as soon as the survivors are known, before the host's harvest
and LM state advance.  ``decode/lm_fused.py`` is the same search with the
LM on the device; this loop is its oracle.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..config import Config
from ..models import decoder as dec_ops
from ..models import las
from ..ops.cuda import topk as topk_k
from ..ops.rnn import map_state


def _step(params, cfg: Config, eb, tokens, sel, cell_state, attn_hidden,
          topn: int):
    """The survivor reorder, one decoder step and the top-``topn``
    proposal (K3) of ``logit / temperature`` -> (top tokens [B*k, topn]
    int32, cell state, attention hidden)."""
    cell_state = map_state(lambda e: e[sel], cell_state)
    out = dec_ops.decoder_step_beam(
        params["decoder"], params["attention"], cfg.decoder, cfg.attention,
        eb.mask, eb.keys, eb.values, tokens, cell_state, attn_hidden[sel])
    logit = out.logit.to(torch.float32) / cfg.decoder.temperature
    _, top_tokens = topk_k.top_k(logit, topn)
    return top_tokens, out.cell_state, out.attn_hidden_state


@torch.no_grad()
def lm_first_pass_decode(params, cfg: Config, bw: int, feats, feat_lens,
                         lm, vocab, topn: int = 20, incremental: bool = None,
                         profile: dict = None):
    """Returns the n-best list per sample: (token list, LM score) pairs,
    best first (ties keep harvest order), or ``[(live beam 0, 0.0)]`` for
    a sample that never finished.

    ``incremental`` (default: when the LM has batch states, i.e. the C++
    reader) keeps one n-gram state per beam and scores each candidate by
    the batched base score: ``score(prefix + w) == cum(prefix) +
    base(state(prefix), w)``.  Otherwise every (beam, candidate) prefix is
    scored as a string, in one batched call per step.

    ``profile`` (optional dict) accumulates host wall seconds per loop
    stage ("encode_prologue", "pull_top", "lm_score", "select",
    "reorder_dispatch", "harvest", "lm_advance") and the step count
    ("steps")."""
    if profile is None:
        def _tic():
            return 0.0

        def _toc(key, t0):
            pass
    else:
        def _tic():
            return time.perf_counter()

        def _toc(key, t0):
            profile[key] = profile.get(key, 0.0) + time.perf_counter() - t0
    if incremental is None:
        incremental = bool(getattr(lm, "has_batch_states", False))
    B = feats.shape[0]
    dev = feats.device
    k = bw
    V = cfg.vocab.vocab_size
    max_len = cfg.decode.max_len
    eos, sos = cfg.vocab.eos, cfg.vocab.sos
    cand = 2 * k

    t0 = _tic()
    eb = las.encode(params, cfg, feats, feat_lens)
    cell = eb.init_cell_state
    if cell is None:
        cell = dec_ops.zero_cell_state(cfg.decoder, feats, B * k)
    else:
        cell = map_state(lambda e: e.repeat_interleave(k, dim=0), cell)
    attn_hidden = feats.new_zeros(
        (B * k, dec_ops.attn_hidden_width(cfg.attention,
                                          eb.values.shape[-1])))

    hist = [[] for _ in range(B * k)]                    # token prefixes
    tokens = np.full(B * k, sos, np.int64)
    finished: List[List] = [[] for _ in range(B)]

    def words(ids):
        return [vocab.int2word[int(i)] for i in ids]

    if incremental:
        tok2lm = lm.word_ids([vocab.int2word[t] for t in range(V)])
        states = np.zeros((B * k, lm.state_capacity()), np.uint32)
        state_lens = np.zeros(B * k, np.int32)
        cum = np.zeros(B * k, np.float64)

    def dispatch(tok_np, sel_np, cell_, attn_):
        return _step(params, cfg, eb, torch.from_numpy(tok_np).to(dev),
                     torch.from_numpy(sel_np).to(dev), cell_, attn_, topn)

    # step l+1 is launched as soon as step l's survivors are known, before
    # the host harvests step l and advances the LM states
    out = dispatch(tokens, np.arange(B * k, dtype=np.int64), cell,
                   attn_hidden)
    _toc("encode_prologue", t0)
    for l in range(max_len):
        if profile is not None:
            profile["steps"] = profile.get("steps", 0) + 1
        t0 = _tic()
        top_tokens = out[0].cpu().numpy()                # [B*k, n]
        _toc("pull_top", t0)

        t0 = _tic()
        if incremental:
            # one batched base-score call over all (beam, candidate) pairs
            base = lm.base_score_batch_np(
                np.repeat(states, topn, axis=0),
                np.repeat(state_lens, topn),
                tok2lm[top_tokens.ravel()].astype(np.uint32))
            lm_scores = cum[:, None] + base.reshape(B * k, topn)
        else:
            sents = []
            for i in range(B * k):
                base_w = words(hist[i])
                for j in range(topn):
                    sents.append(" ".join(base_w + words([top_tokens[i, j]])))
            lm_scores = np.asarray(
                lm.score_batch(sents, bos=False, eos=False)
            ).reshape(B * k, topn)
        _toc("lm_score", t0)

        t0 = _tic()
        # candidates from the POOL of real proposals (k*topn per sample),
        # ordered by score desc, then (beam*V + token) asc -- the only
        # well-defined part of the reference's torch.topk order (every
        # non-proposal is -inf there and never becomes a candidate)
        pool_sc = lm_scores.reshape(B, k * topn)
        pool_tok = top_tokens.reshape(B, k * topn)
        pool_beam = np.repeat(np.arange(k, dtype=np.int64), topn)[None, :]
        if l == 0:                                   # beams identical
            pool_sc = pool_sc[:, :topn]
            pool_tok = pool_tok[:, :topn]
            pool_beam = pool_beam[:, :topn]
        pw = pool_sc.shape[1]
        ncand = min(cand, pw)
        pool_col = pool_beam * V + pool_tok          # dense-col identity
        if pw > ncand:
            part = np.argpartition(-pool_sc, ncand - 1, axis=1)[:, :ncand]
        else:
            part = np.broadcast_to(np.arange(pw), (B, pw))
        ps = np.take_along_axis(pool_sc, part, axis=1)
        pc = np.take_along_axis(pool_col, part, axis=1)
        order = np.lexsort((pc, -ps), axis=-1)
        sel_p = np.take_along_axis(part, order, axis=1)
        cand_scores = np.take_along_axis(pool_sc, sel_p, axis=1)
        cand_beams = np.take_along_axis(
            np.broadcast_to(pool_beam, pool_sc.shape), sel_p, axis=1)
        cand_toks = np.take_along_axis(pool_tok, sel_p, axis=1)

        # survivors: the first k non-eos candidates in candidate order; the
        # last live one repeats when fewer are live, and a row with none
        # live pads with (beam 0, unk)
        is_eos = cand_toks == eos                        # [B, ncand]
        nlive = np.minimum((~is_eos).sum(axis=1), k)     # [B]
        order = np.argsort(is_eos, axis=1, kind="stable")
        pos = np.minimum(np.arange(k)[None, :],
                         np.maximum(nlive - 1, 0)[:, None])
        pick = np.take_along_axis(order, pos, axis=1)    # [B, k]
        sel2 = (np.take_along_axis(cand_beams, pick, axis=1)
                + np.arange(B)[:, None] * k)             # [B, k] flat rows
        tok2 = np.take_along_axis(cand_toks, pick, axis=1)
        dead = nlive == 0
        sel2[dead] = (np.arange(B)[dead] * k)[:, None]
        tok2[dead] = cfg.vocab.unk
        sel = sel2.reshape(-1).astype(np.int64)
        new_tokens = tok2.reshape(-1).astype(np.int64)
        _toc("select", t0)

        t0 = _tic()
        hist_prev = hist                                 # harvest reads l's
        hist = [hist[s] + [int(new_tokens[i])] for i, s in enumerate(sel)]
        if l + 1 < max_len:
            out = dispatch(new_tokens, sel, out[1], out[2])
        _toc("reorder_dispatch", t0)

        t0 = _tic()
        # harvest the finished among the top-k candidates
        for b in range(B):
            for j in range(min(k, ncand)):
                if is_eos[b, j]:
                    src = b * k + int(cand_beams[b, j])
                    finished[b].append((list(hist_prev[src]),
                                        float(cand_scores[b, j])))
        _toc("harvest", t0)
        if all(len(f) > 0 for f in finished):
            break                    # the step in flight is discarded

        if incremental:
            t0 = _tic()
            # contexts follow the survivors; fold in the chosen word's
            # score and advance the n-gram states in place
            states = np.ascontiguousarray(states[sel])
            state_lens = np.ascontiguousarray(state_lens[sel])
            chosen = tok2lm[new_tokens].astype(np.uint32)
            cum = cum[sel] + lm.base_score_batch_np(states, state_lens,
                                                    chosen)
            lm.advance_batch_np(states, state_lens, chosen)
            _toc("lm_advance", t0)

    results = []
    for b in range(B):
        if finished[b]:
            results.append(sorted(finished[b], key=lambda h: -h[1]))
        else:
            results.append([(hist[b * k], 0.0)])         # best live fallback
    return results


def transcribe_lm_first_pass(params, cfg: Config, bw: int, feats, feat_lens,
                             lm, vocab, topn: int = 20) -> List[str]:
    nbest = lm_first_pass_decode(params, cfg, bw, feats, feat_lens, lm,
                                 vocab, topn)
    return [vocab.decode(hyps[0][0]) for hyps in nbest]
