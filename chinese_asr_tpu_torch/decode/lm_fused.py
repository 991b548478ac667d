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
integer gathers.  The loop (``LmFusedLoop``) is a chain of guarded steps
with its stop flag on the device, run eagerly by ``lm_fused_decode``
(one host read of the flag every ``unroll`` steps) and as one CUDA graph
on the card, which tests the flag there, by the ``*_jit`` forms
(``utils/graphs.py``).  On a mesh
(``mesh``; eager only) it runs as ``decode/beam.py`` does there, the LM
tables replicated on every rank.
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
from ..utils import graphs
from .beam import (BeamResult, BestResult, _rows, _stable_top,
                   pack_result, select_merge)


class LmFusedLoop:
    """``lm_fused_decode`` as a loop of guarded steps (``utils/graphs.py``):
    JAX's ``while_loop`` body, whose stopping step keeps its survivors, so
    only a guarded step taken after the stop (``done``) is an identity.
    An unguarded step (one no later step can follow, ``utils/graphs.py``)
    has no guard at all."""

    def __init__(self, params, cfg: Config, bw: int,
                 dlm: device_ngram.DeviceNgramLM, tok2lm, topn: int = 20,
                 mesh=None):
        assert topn >= bw, "strict host parity needs topn >= bw (see docstring)"
        assert topn >= 2, "topn=1 can dead-end every candidate row (all-eos)"
        self.params, self.cfg, self.k = params, cfg, bw
        self.dlm, self.tok2lm, self.topn, self.mesh = dlm, tok2lm, topn, mesh
        self.max_len = cfg.decode.max_len

    def init(self, feats, feat_lens) -> dict:
        cfg, k, max_len = self.cfg, self.k, self.max_len
        B = feats.shape[0]
        dev = feats.device
        dcfg, acfg = cfg.decoder, cfg.attention
        eb = las.encode(self.params, cfg, feats, feat_lens)
        cell = eb.init_cell_state
        if cell is None:
            cell = dec_ops.zero_cell_state(dcfg, feats, B * k)
        else:
            cell = map_state(lambda e: e.repeat_interleave(k, dim=0), cell)
        hist = torch.full((B * k, max_len + 1), cfg.vocab.pad,
                          dtype=torch.int64, device=dev)
        hist[:, 0] = cfg.vocab.sos
        return dict(
            eb=eb, done=torch.zeros((), dtype=torch.bool, device=dev),
            cand_offsets=torch.arange(2 * k, device=dev)[None, :],  # [1, 2k]
            l_final=torch.full((), max_len - 1, dtype=torch.int32,
                               device=dev),
            hist=hist, cum=torch.zeros(B * k, dtype=torch.float32, device=dev),
            lm_ctx=torch.full((B * k, max(self.dlm.order - 1, 1)), -1,
                              dtype=torch.int64, device=dev),
            cell=cell,
            attn_hidden=feats.new_zeros(
                (B * k, dec_ops.attn_hidden_width(acfg,
                                                  eb.values.shape[-1]))),
            has_finished=torch.zeros(B, dtype=torch.bool, device=dev),
            fin_tokens=torch.zeros((B, max_len, k, max_len),
                                   dtype=torch.int32, device=dev),
            fin_scores=torch.full((B, max_len, k), float("-inf"),
                                  dtype=torch.float32, device=dev))

    def step(self, s: dict, l: int, guard: bool = True) -> dict:
        cfg, k, topn, max_len = self.cfg, self.k, self.topn, self.max_len
        eb, done, hist = s["eb"], s["done"], s["hist"]
        frozen = done if guard else None        # None: no guard needed
        B = s["has_finished"].shape[0]
        pool_w = k * topn
        cand = 2 * k
        eos = cfg.vocab.eos
        out = dec_ops.decoder_step_beam(
            self.params["decoder"], self.params["attention"], cfg.decoder,
            cfg.attention, eb.mask, eb.keys, eb.values, hist[:, l], s["cell"],
            s["attn_hidden"], mesh=self.mesh)
        # acoustic PROPOSALS only: K3's top-topn per beam row.  Only the
        # indices are used, and their set does not change under the
        # positive 1/temperature scale, so the divide is skipped.  Sorted
        # ascending within each row, the pool's flat index order equals
        # (beam*V + token) asc, so the stable pool top-2k below gives the
        # host's candidate order.
        _, top = topk_k.top_k(out.logit.to(torch.float32), topn)
        top_toks = torch.sort(top.to(torch.int64), dim=1).values    # [B*k, n]
        base = device_ngram.score_candidates(self.dlm, s["lm_ctx"],
                                             self.tok2lm[top_toks])
        pool_sc = (s["cum"][:, None] + base).reshape(B, pool_w)
        pool_tok = top_toks.reshape(B, pool_w)
        if l == 0:                 # all beams identical: beam 0's are real
            pool_sc[:, topn:] = float("-inf")
        cand_scores, i2 = _stable_top(pool_sc, cand)                # [B, 2k]
        cand_beams = torch.div(i2, topn, rounding_mode="floor")
        cand_toks = torch.gather(pool_tok, 1, i2)

        # harvest the finished among the top-k candidates into slot l,
        # only while the loop runs
        fmask = cand_toks[:, :k] == eos                              # [B, k]
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens, fin_scores = s["fin_tokens"], s["fin_scores"]
        fin_tokens[:, l] = graphs.where_tree(
            frozen, fin_tokens[:, l],
            _rows(hist3, cand_beams[:, :k])[:, :, 1:].to(torch.int32))
        fin_scores[:, l] = graphs.where_tree(
            frozen, fin_scores[:, l],
            torch.where(fmask, cand_scores[:, :k], float("-inf")))
        has_finished = s["has_finished"] | fmask.any(dim=1)

        # survivors: the first k non-eos candidates in candidate order
        # (offset + 2k*eos, all distinct, k smallest); at most k of the 2k
        # are eos (each beam's proposals are distinct tokens; at step 0
        # the -inf pads are other beams' copies), so k are always live.
        # The chosen candidate's pool score is the host's cum[sel] +
        # base(chosen | ctx[sel]), the same two f32 addends.
        rank = (s["cand_offsets"]
                + (cand_toks == eos).to(torch.int64) * cand)
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)                # [B, k]
        k_toks = torch.gather(cand_toks, 1, active)

        def reorder(t):
            return _rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        new_hist = _rows(hist3, k_beams).reshape(B * k, max_len + 1)
        new_hist[:, l + 1] = k_toks.reshape(-1)
        chosen = self.tok2lm[k_toks.reshape(-1)]
        names = ("hist", "cum", "lm_ctx", "cell", "attn_hidden",
                 "has_finished")
        kept = graphs.where_tree(frozen, {n: s[n] for n in names}, dict(
            hist=new_hist,
            cum=torch.gather(cand_scores, 1, active).reshape(-1),
            lm_ctx=device_ngram.advance_context(reorder(s["lm_ctx"]), chosen),
            cell=map_state(reorder, out.cell_state),
            attn_hidden=reorder(out.attn_hidden_state),
            has_finished=has_finished))
        # the host loop's stop: every sample has a finished hypothesis
        # (this step's survivors are kept, as in JAX's while_loop body)
        stops = sharding.all_true(kept["has_finished"], self.mesh)
        return {**s, **kept, "done": done | stops if guard else stops,
                "l_final": torch.where(stops & ~done if guard else stops, l,
                                       s["l_final"])}

    def result(self, s: dict) -> BeamResult:
        return pack_result(s, s["cum"])


@torch.no_grad()
def lm_fused_decode(params, cfg: Config, bw: int, feats, feat_lens,
                    dlm: device_ngram.DeviceNgramLM, tok2lm,
                    topn: int = 20, mesh=None, unroll: int = 1) -> BeamResult:
    """tok2lm: [V] int64 tensor on the device mapping token id -> LM word
    id (``dlm.token_id_table(vocab)``), the table the host loop uses.  On
    a mesh the result holds this rank's rows, as ``beam.beam_decode``.
    ``unroll``: the guarded steps run between two host reads of the stop
    flag; any value gives the same result."""
    return graphs.run_loop(
        LmFusedLoop(params, cfg, bw, dlm, tok2lm, topn, mesh),
        (feats, feat_lens), unroll)


def _key(name: str, params, cfg: Config, bw: int, dlm, tok2lm,
         topn: int) -> tuple:
    return (name, cfg, bw, topn, graphs.tensor_ids(params, tok2lm),
            dlm.graph_key())


@torch.no_grad()
def lm_fused_decode_jit(params, cfg: Config, bw: int, feats, feat_lens,
                        dlm, tok2lm, topn: int = 20,
                        unroll: int = graphs.UNROLL) -> BeamResult:
    """``lm_fused_decode`` as one compiled program: on the card its
    graphs' replay (``utils/graphs.py``; the outputs are copied out of
    the graphs), on the CPU the guarded loop."""
    return graphs.run(_key("lm_fused", params, cfg, bw, dlm, tok2lm, topn),
                      LmFusedLoop(params, cfg, bw, dlm, tok2lm, topn),
                      (feats, feat_lens), unroll)


def select_best_first_pass(res: BeamResult) -> BestResult:
    """Device-side replica of ``nbest_lists(res)[b][0]``: the best
    finished hypothesis by LM score (first max in harvest order, like the
    host loop's stable sort), else live beam 0 with score 0.0 and its
    length clamped to the buffer -- the host loop's fallback, not
    ``beam.live_fallback``'s."""
    B, k, max_len = res.live_tokens.shape
    fin_sel = torch.where(torch.isfinite(res.fin_scores), res.fin_scores,
                          torch.full_like(res.fin_scores, float("-inf")))
    live_len = torch.clamp(res.l_final + 1, max=max_len).to(
        res.fin_lens.dtype).expand(B)
    return select_merge(res, fin_sel, res.live_tokens[:, 0],
                        res.fin_scores.new_zeros(B), live_len)


def lm_fused_decode_best(params, cfg: Config, bw: int, feats, feat_lens,
                         dlm, tok2lm, topn: int = 20, mesh=None,
                         unroll: int = 1) -> BestResult:
    """The LM-driven decode and the winner picked on the device:
    ``ASR(lm_mode="first")``'s transcription path.  On a mesh, every rank
    returns the whole batch's."""
    return sharding.gather_rows(select_best_first_pass(lm_fused_decode(
        params, cfg, bw, feats, feat_lens, dlm, tok2lm, topn, mesh,
        unroll)), mesh)


@torch.no_grad()
def lm_fused_decode_best_jit(params, cfg: Config, bw: int, feats,
                             feat_lens, dlm, tok2lm, topn: int = 20,
                             unroll: int = graphs.UNROLL) -> BestResult:
    """``lm_fused_decode_best`` as one compiled program
    (``lm_fused_decode_jit``): the decode and the selection in one set of
    graphs."""
    return graphs.run(
        _key("lm_fused_best", params, cfg, bw, dlm, tok2lm, topn),
        LmFusedLoop(params, cfg, bw, dlm, tok2lm, topn), (feats, feat_lens),
        unroll, select_best_first_pass)


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
            n = min(int(res.l_final) + 1, live.shape[2])
            out.append([(live[b, 0, :n].astype(int).tolist(), 0.0)])
    return out
