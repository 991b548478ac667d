"""On-device second-pass LM rescore (port of
``chinese_asr_tpu/decode/rescore.py``).

The reference's second pass rescores every finished hypothesis with
``logp + 1.5 * lm_model.score(' '.join(chars), bos=True) + 1.5 * len``
and returns the argmax's tokens and RAW acoustic score (reference
model.py:749-763).  With the n-gram tables on the device
(``lm/device_ngram.py``) the whole second pass stays there: the beam
harvests each finished hypothesis's full-sentence LM total as it decodes
(``beam_decode(lm_track=...)``), or ``score_sequences`` computes them all
after the decode in one ``score_candidates`` call, and the winner is
picked on the device; only the winning [B, max_len] rows reach the host.
The host rescorer (``beam.finalize_beam(second_pass=True)``) is the
oracle and ``lm_mode="second_host"``.  The ``*_jit`` forms run as CUDA
graphs on the card (``utils/graphs.py``).
"""

from __future__ import annotations

import torch

from ..lm import device_ngram
from ..parallel import sharding
from ..utils import graphs
from . import beam as beam_mod
from .beam import BeamResult, BestResult


def score_sequences(dlm: device_ngram.DeviceNgramLM, toks_lm, lens,
                    bos_id: int, eos_id: int):
    """Full-sentence LM scores, all positions at once.

    toks_lm [Q, T] LM word ids (anything past ``lens`` is ignored), lens
    [Q] -> [Q] f32 log10 scores equal (to f32) to kenlm's ``score(
    sentence, bos=True, eos=True)`` (reference model.py:755).  Position t
    scores token t in the context of the order-1 tokens before it, with
    ``<s>`` at position -1 and absent (-1) further left; position
    t == len scores ``</s>``; positions past len are masked out of the
    sum, so a hypothesis of length 0 scores ``</s>`` alone."""
    Q, T = toks_lm.shape
    M1 = max(dlm.order - 1, 1)
    toks_lm = toks_lm.to(torch.int64)
    left = torch.full((Q, M1), -1, dtype=torch.int64, device=toks_lm.device)
    left[:, -1] = bos_id
    padded = torch.cat([left, toks_lm], dim=1)                 # [Q, M1 + T]
    ctx = torch.stack([padded[:, j: j + T + 1] for j in range(M1)],
                      dim=-1)                                  # [Q, T+1, M1]
    t = torch.arange(T + 1, device=toks_lm.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    cand = torch.cat([toks_lm, toks_lm[:, -1:]], dim=1)
    cand = torch.where(t == lens, eos_id, cand)                # [Q, T+1]
    base = device_ngram.score_candidates(
        dlm, ctx.reshape(Q * (T + 1), M1),
        cand.reshape(Q * (T + 1), 1)).reshape(Q, T + 1)
    return torch.where(t <= lens, base, 0.0).sum(dim=1)


def select_rescored(res: BeamResult, lm_sc, lm_weight: float,
                    length_weight: float) -> BestResult:
    """The selection, given per-slot LM totals (harvested by
    ``beam_decode(lm_track=...)`` or computed by ``rescore_select``): the
    rescored sum picks the slot (``beam.select_merge``'s first max), the
    winner's RAW acoustic score is reported, and never-finished rows take
    the live fallback."""
    sel = torch.where(torch.isfinite(res.fin_scores),
                      res.fin_scores + lm_weight * lm_sc
                      + length_weight * res.fin_lens.to(torch.float32),
                      float("-inf"))
    return beam_mod.select_merge(
        res, sel, *beam_mod.live_fallback(res, length_weight))


def rescore_select(res: BeamResult, dlm: device_ngram.DeviceNgramLM,
                   tok2lm, lm_weight: float, length_weight: float,
                   bos_id: int, eos_id: int) -> BestResult:
    """Device replica of ``finalize_beam(second_pass=True)``'s selection
    on a decoded n-best: every slot's LM total by ``score_sequences``,
    then ``select_rescored``.  Run it on a ``compact_nbest``-ed result so
    the LM scores only the finite prefix."""
    B, cap = res.fin_scores.shape
    T = res.fin_tokens.shape[2]
    toks_lm = tok2lm[res.fin_tokens.to(torch.int64)].reshape(B * cap, T)
    lm_sc = score_sequences(dlm, toks_lm, res.fin_lens.reshape(B * cap),
                            bos_id, eos_id).reshape(B, cap)
    return select_rescored(res, lm_sc, lm_weight, length_weight)


@torch.no_grad()
def rescore_select_jit(res: BeamResult, dlm, tok2lm, lm_weight: float,
                       length_weight: float, bos_id: int,
                       eos_id: int) -> BestResult:
    """``rescore_select`` as one compiled program: on the card a graph
    replayed on a copy of ``res`` (``utils/graphs.py``; the outputs are
    copied out of the graph), on the CPU the plain call."""
    return graphs.run(
        ("rescore_select", lm_weight, length_weight, bos_id, eos_id,
         graphs.tensor_ids(tok2lm), dlm.graph_key()),
        _Select(dlm, tok2lm, lm_weight, length_weight, bos_id, eos_id),
        tuple(res), 1)


class _Select:
    """``rescore_select`` as a loop of no steps, for ``graphs.run``."""
    max_len = 0

    def __init__(self, *args):
        self.args = args

    def init(self, *fields):
        return rescore_select(BeamResult(*fields), *self.args)

    def result(self, best):
        return best


def beam_rescored_best(params, cfg, bw: int, feats, feat_lens, dlm,
                       tok2lm, lm_weight: float, length_weight: float,
                       bos_id: int, eos_id: int, mesh=None,
                       unroll: int = 1) -> BestResult:
    """Second-pass-rescored transcription (``ASR(lm_mode="second")``): the
    beam decode tracks the LM chains passively, harvests full-sentence LM
    totals, and the winner is selected on the device, with no n-best
    transfer between decode and rescore.  On a mesh (the LM tables
    replicated), every rank returns the whole batch's winners."""
    res, fin_lm = beam_mod.beam_decode(
        params, cfg, bw, feats, feat_lens,
        lm_track=(dlm, tok2lm, bos_id, eos_id), mesh=mesh, unroll=unroll)
    return sharding.gather_rows(
        select_rescored(res, fin_lm, lm_weight, length_weight), mesh)


@torch.no_grad()
def beam_rescored_best_jit(params, cfg, bw: int, feats, feat_lens, dlm,
                           tok2lm, lm_weight: float, length_weight: float,
                           bos_id: int, eos_id: int,
                           unroll: int = graphs.UNROLL) -> BestResult:
    """``beam_rescored_best`` as one compiled program: the tracked beam
    and ``select_rescored`` in one set of graphs on the card
    (``utils/graphs.py``), the guarded loop on the CPU."""
    fused = beam_mod.use_fused_logp()
    return graphs.run(
        beam_mod.beam_key("beam_rescored", params, cfg, bw, fused,
                          lm_weight, length_weight, bos_id, eos_id,
                          graphs.tensor_ids(tok2lm), dlm.graph_key()),
        beam_mod.BeamLoop(params, cfg, bw, fused,
                          lm_track=(dlm, tok2lm, bos_id, eos_id)),
        (feats, feat_lens), unroll,
        lambda out: select_rescored(*out, lm_weight, length_weight))
