"""Greedy decoding (port of ``chinese_asr_tpu/decode/greedy.py``, reference
model.py:503-602).

The token loop (``GreedyLoop``) has the batch-wide early exit of the
reference (``if finished.all(): break``, model.py:578-579) as a stop flag
on the device: each step is guarded, an identity once every sample is
finished.  ``greedy_decode`` runs it eagerly and reads the flag on the
host once every ``unroll`` steps; ``greedy_decode_jit`` runs it as CUDA
graphs on the card (``utils/graphs.py``).  On a mesh (eager only) the flag
is the AND over the whole mesh (``sharding.all_true``), as JAX's loop
reads the global batch.

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
from ..parallel import sharding
from ..utils import graphs


class GreedyResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_len] int32
    final_lens: torch.Tensor   # [B] int32 (length before eos)
    scores: torch.Tensor       # [B] accumulated logp
    finished: torch.Tensor     # [B] bool
    alignments: torch.Tensor   # [B, max_len, L]


class GreedyLoop:
    """``greedy_decode`` as a loop of guarded steps (``utils/graphs.py``):
    JAX's ``while_loop`` body, which stops once every sample is finished,
    so a guarded step taken after that (``done``) writes no ``out[:, l]``
    nor ``align[:, l]`` and moves no state.  An unguarded step (one no
    later step can follow, ``utils/graphs.py``) has no guard at all."""

    def __init__(self, params, cfg: Config, mesh=None):
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.max_len = cfg.decode.max_len

    def init(self, feats, feat_lens) -> dict:
        cfg = self.cfg
        B = feats.shape[0]
        dev = feats.device
        eb = las.encode(self.params, cfg, feats, feat_lens)
        L = eb.enc_out.shape[1]
        ctx = dec_ops.attn_hidden_width(cfg.attention, eb.values.shape[-1])
        cell = eb.init_cell_state
        if cell is None:
            cell = dec_ops.zero_cell_state(cfg.decoder, feats, B)
        return dict(
            eb=eb, done=torch.zeros((), dtype=torch.bool, device=dev),
            tokens=torch.full((B,), cfg.vocab.sos, dtype=torch.int64,
                              device=dev),
            cell=cell, attn_hidden=feats.new_zeros((B, ctx)),
            finished=torch.zeros(B, dtype=torch.bool, device=dev),
            final_lens=torch.zeros(B, dtype=torch.int32, device=dev),
            accum=torch.zeros(B, dtype=torch.float32, device=dev),
            out=torch.full((B, self.max_len), cfg.vocab.pad,
                           dtype=torch.int32, device=dev),
            align=feats.new_zeros((B, self.max_len, L)))

    def step(self, s: dict, l: int, guard: bool = True) -> dict:
        cfg, eb, done = self.cfg, s["eb"], s["done"]
        frozen = done if guard else None        # None: no guard needed
        step = dec_ops.decoder_step(
            self.params["decoder"], self.params["attention"], cfg.decoder,
            cfg.attention, eb.mask, eb.keys, eb.values, s["tokens"],
            s["cell"], s["attn_hidden"], mesh=self.mesh)
        logit = step.logit.to(torch.float32)
        logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
        lp, tok = torch.max(logp, dim=1)    # first max, like jnp.argmax
        cur_fin = tok == cfg.vocab.eos
        finished = s["finished"]
        accum = s["accum"] + torch.where(~finished & cur_fin, lp,
                                         torch.zeros_like(lp))
        finished = finished | cur_fin
        final_lens = s["final_lens"] + (~finished).to(torch.int32)
        accum = accum + torch.where(~finished, lp, torch.zeros_like(lp))
        out, align = s["out"], s["align"]
        out[:, l] = graphs.where_tree(frozen, out[:, l], tok.to(torch.int32))
        # several heads: the first head's alignment, as in JAX
        align[:, l, :] = graphs.where_tree(
            frozen, align[:, l, :],
            step.alignment if cfg.attention.heads == 1
            else step.alignment[..., 0])
        names = ("tokens", "cell", "attn_hidden", "finished", "final_lens",
                 "accum")
        kept = graphs.where_tree(
            frozen, {n: s[n] for n in names},
            dict(tokens=tok, cell=step.cell_state,
                 attn_hidden=step.attn_hidden_state, finished=finished,
                 final_lens=final_lens, accum=accum))
        stops = sharding.all_true(kept["finished"], self.mesh)
        return {**s, **kept, "done": done | stops if guard else stops}

    def result(self, s: dict) -> GreedyResult:
        return GreedyResult(s["out"], s["final_lens"], s["accum"],
                            s["finished"], s["align"])


@torch.no_grad()
def greedy_decode(params, cfg: Config, feats, feat_lens,
                  mesh=None, unroll: int = 1) -> GreedyResult:
    """On a mesh (``mesh``; ``params`` from ``sharding.shard_params``) the
    feats are this rank's data shard and the result holds its rows;
    ``sharding.gather_rows`` makes the whole batch's.  ``unroll``: the
    guarded steps run between two host reads of the stop flag; any value
    gives the same result."""
    return graphs.run_loop(GreedyLoop(params, cfg, mesh), (feats, feat_lens),
                           unroll)


@torch.no_grad()
def greedy_decode_jit(params, cfg: Config, feats, feat_lens,
                      unroll: int = graphs.UNROLL) -> GreedyResult:
    """``greedy_decode`` as one compiled program: on the card its graphs'
    replay (``utils/graphs.py``; the outputs are copied out of the
    graphs), on the CPU the guarded loop."""
    return graphs.run(("greedy", cfg, graphs.tensor_ids(params)),
                      GreedyLoop(params, cfg), (feats, feat_lens), unroll)


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
