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

The loop (``BeamLoop``) is a chain of guarded steps over a state that
lives on the device, its stop flag included (JAX's ``while_loop`` body
with ``keep``).  ``beam_decode`` runs it eagerly and reads the flag on
the host once every ``unroll`` steps; the ``*_jit`` forms run it as one
compiled program: one CUDA graph on the card, which tests the flag there
(``utils/graphs.py``), the same eager loop on the CPU.  On a mesh (``mesh``,
``parallel/sharding.py``; eager only) each rank decodes its data
shard's rows over full logit rows (the model ranks' slices all-gathered
before stage 1), the stop flag is the AND over the whole mesh, and the
``*_best`` functions all-gather the winners.
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
from ..ops.rnn import map_state
from ..parallel import sharding
from ..utils import graphs
from .greedy import EvalOutput, with_cer


class BeamResult(NamedTuple):
    fin_tokens: torch.Tensor    # [B, CAP, max_len] int32 (no sos/eos);
                                #   cap index = harvest_step*k + cand_rank
    fin_lens: torch.Tensor      # [B, CAP] int32 (== harvest step)
    fin_scores: torch.Tensor    # [B, CAP] f32; -inf marks EMPTY slots
    fin_count: torch.Tensor     # [B] int32 (number of finite slots)
    live_tokens: torch.Tensor   # [B, k, max_len] final history (no sos)
    live_scores: torch.Tensor   # [B, k] accumulated logp of live beams
    l_final: torch.Tensor       # 0-d int32: the reference's loop
                                #   variable at exit


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


class BeamLoop:
    """``beam_decode`` as a loop of guarded steps (``utils/graphs.py``):
    ``init`` encodes and makes the loop state, ``step`` is JAX's ``body``
    with ``keep`` (``chinese_asr_tpu/decode/beam.py``), ``result`` packs
    the ``BeamResult``.

    A guarded step writes its harvest into slot ``l`` only while
    ``~done``; once every sample's top candidate is eos (``new_done``) a
    step records ``l_final`` and keeps the survivors and every carried
    tensor as they were, so the stopping step applies no survivors and
    every later guarded step changes nothing.  An unguarded step (one no
    later step can follow, ``utils/graphs.py``) keeps only that stopping
    rule."""

    def __init__(self, params, cfg: Config, bw: int, fused_logp: bool,
                 lm_track=None, mesh=None):
        self.params, self.cfg, self.k = params, cfg, bw
        self.fused_logp, self.lm_track, self.mesh = fused_logp, lm_track, mesh
        self.max_len = cfg.decode.max_len

    def init(self, feats, feat_lens) -> dict:
        cfg, k, max_len = self.cfg, self.k, self.max_len
        B = feats.shape[0]
        dev = feats.device
        dcfg, acfg = cfg.decoder, cfg.attention
        eb = las.encode(self.params, cfg, feats, feat_lens)
        ctx = dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])
        # tile only true per-beam state: row r = b*k + beam
        cell = eb.init_cell_state
        if cell is None:
            cell = dec_ops.zero_cell_state(dcfg, feats, B * k)
        else:
            cell = map_state(lambda e: e.repeat_interleave(k, dim=0), cell)
        hist = torch.full((B * k, max_len + 1), cfg.vocab.pad,
                          dtype=torch.int64, device=dev)
        hist[:, 0] = cfg.vocab.sos
        s = dict(
            eb=eb, done=torch.zeros((), dtype=torch.bool, device=dev),
            cand_offsets=torch.arange(2 * k, device=dev)[None, :],  # [1, 2k]
            l_final=torch.full((), max_len - 1, dtype=torch.int32,
                               device=dev),
            hist=hist,
            logp_scores=torch.zeros(B * k, dtype=torch.float32, device=dev),
            cell=cell, attn_hidden=feats.new_zeros((B * k, ctx)),
            top_beam_finished=torch.zeros(B, dtype=torch.bool, device=dev),
            fin_tokens=torch.zeros((B, max_len, k, max_len),
                                   dtype=torch.int32, device=dev),
            fin_scores=torch.full((B, max_len, k), float("-inf"),
                                  dtype=torch.float32, device=dev))
        if self.lm_track is not None:
            dlm, _tok2lm, lm_bos, _lm_eos = self.lm_track
            lm_ctx = torch.full((B * k, max(dlm.order - 1, 1)), -1,
                                dtype=torch.int64, device=dev)
            if dlm.order > 1:
                lm_ctx[:, -1] = lm_bos                # bos=True chain
            s.update(lm_ctx=lm_ctx,
                     lm_cum=torch.zeros(B * k, dtype=torch.float32,
                                        device=dev),
                     fin_lm=torch.zeros((B, max_len, k), dtype=torch.float32,
                                        device=dev))
        return s

    def step(self, s: dict, l: int, guard: bool = True) -> dict:
        cfg, k, max_len, eb = self.cfg, self.k, self.max_len, s["eb"]
        B = s["top_beam_finished"].shape[0]
        V = cfg.vocab.vocab_size
        cand = 2 * k
        eos = cfg.vocab.eos
        done, hist = s["done"], s["hist"]
        frozen = done if guard else None        # None: no guard needed
        out = dec_ops.decoder_step_beam(
            self.params["decoder"], self.params["attention"], cfg.decoder,
            cfg.attention, eb.mask, eb.keys, eb.values, hist[:, l], s["cell"],
            s["attn_hidden"], mesh=self.mesh)

        # stage 1: per-beam top-(k+1) over V
        if self.fused_logp:
            # K4: the transform rides in the kernel; a -inf row bias
            # disables beams > 0 at step 0 (all beams identical)
            bias = s["logp_scores"][:, None].clone()                 # [B*k, 1]
            if l == 0:
                bias.view(B, k)[:, 1:] = float("-inf")
            v1, t1 = topk_k.top_k_fused(out.logit.to(torch.float32), bias,
                                        k + 1, cfg.decoder.temperature)
        else:
            # the logp transform, then K3
            logit = out.logit.to(torch.float32) / cfg.decoder.temperature
            logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
            logp = logp + s["logp_scores"][:, None]                  # [B*k, V]
            if l == 0:                 # all beams identical: beam 0 only
                logp.view(B, k, V)[:, 1:] = float("-inf")
            v1, t1 = topk_k.top_k(logp, k + 1)
        # stage 2: top-2k of the k(k+1) union (lower beam, then lower
        # rank on ties -- the flat top_k order)
        cand_scores, i2 = _stable_top(v1.reshape(B, k * (k + 1)), cand)
        cand_beams = torch.div(i2, k + 1, rounding_mode="floor")     # [B, 2k]
        cand_tokens = torch.gather(t1.reshape(B, k * (k + 1)), 1,
                                   i2).to(torch.int64)

        # harvest finished among the top-k (model.py:875-889) into slot l,
        # only while the loop runs
        top_tokens = cand_tokens[:, :k]
        fmask = top_tokens == eos                                    # [B, k]
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens, fin_scores = s["fin_tokens"], s["fin_scores"]
        fin_tokens[:, l] = graphs.where_tree(
            frozen, fin_tokens[:, l],
            _rows(hist3, cand_beams[:, :k])[:, :, 1:].to(torch.int32))
        fin_scores[:, l] = graphs.where_tree(
            frozen, fin_scores[:, l],
            torch.where(fmask, cand_scores[:, :k], float("-inf")))
        if self.lm_track is not None:
            # full-sentence LM total of each harvested hypothesis: the
            # parent beam's cum chain + the </s> term in its context
            # (reference model.py:755 scores with bos=True, eos=True);
            # recorded on the stopping step too, as in JAX
            dlm, tok2lm, _lm_bos, lm_eos = self.lm_track
            eos_col = torch.full((B * k, 1), lm_eos, dtype=torch.int64,
                                 device=hist.device)
            eos_base = dev_lm.score_candidates(dlm, s["lm_ctx"],
                                               eos_col)[:, 0]
            lm_tot = (s["lm_cum"] + eos_base).reshape(B, k)
            fin_lm = s["fin_lm"]
            fin_lm[:, l] = graphs.where_tree(
                frozen, fin_lm[:, l], torch.where(
                    fmask, torch.gather(lm_tot, 1, cand_beams[:, :k]), 0.0))

        # early stop (model.py:897-901): on the stopping step the
        # survivors are not applied
        top_beam_finished = graphs.where_tree(
            frozen, s["top_beam_finished"],
            s["top_beam_finished"] | (top_tokens[:, 0] == eos))
        stops = sharding.all_true(top_beam_finished, self.mesh)
        new_done = done | stops if guard else stops
        l_final = torch.where(stops & ~done if guard else stops, l,
                              s["l_final"])

        # survivors (model.py:904-909): the k smallest of offset + 2k*eos
        # (all distinct, so any sort picks the same set in the same order)
        rank = (s["cand_offsets"]
                + (cand_tokens == eos).to(torch.int64) * cand)
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)                # [B, k]
        k_toks = torch.gather(cand_tokens, 1, active)

        def reorder(t):
            return _rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        new_hist = _rows(hist3, k_beams).reshape(B * k, max_len + 1)
        new_hist[:, l + 1] = k_toks.reshape(-1)
        carried = dict(
            hist=new_hist,
            logp_scores=torch.gather(cand_scores, 1, active).reshape(-1),
            cell=map_state(reorder, out.cell_state),
            attn_hidden=reorder(out.attn_hidden_state))
        if self.lm_track is not None:
            # advance the passive chain along the survivors (never eos:
            # the rank trick picks non-eos), so it stays a word chain
            ctx_sel = reorder(s["lm_ctx"])
            chosen = tok2lm[k_toks.reshape(-1)]
            base = dev_lm.score_candidates(dlm, ctx_sel, chosen[:, None])
            carried.update(
                lm_cum=reorder(s["lm_cum"][:, None])[:, 0] + base[:, 0],
                lm_ctx=dev_lm.advance_context(ctx_sel, chosen))
        kept = graphs.where_tree(new_done, {n: s[n] for n in carried},
                                 carried)
        return {**s, **kept, "done": new_done, "l_final": l_final,
                "top_beam_finished": top_beam_finished}

    def result(self, s: dict):
        res = pack_result(s, s["logp_scores"])
        if self.lm_track is not None:
            return res, s["fin_lm"].reshape(res.fin_scores.shape)
        return res


def pack_result(s: dict, live_scores) -> BeamResult:
    """A beam loop's state -> the packed ``BeamResult``: the
    slot-per-step buffers flattened to cap = max_len * k slots (slot
    index = harvest step * k + candidate rank, its length = the step)."""
    B, max_len, k = s["fin_scores"].shape
    cap = k * max_len
    fin_scores = s["fin_scores"].reshape(B, cap)
    fin_lens = torch.arange(max_len, dtype=torch.int32,
                            device=fin_scores.device
                            ).repeat_interleave(k)[None, :].expand(B, cap)
    return BeamResult(
        fin_tokens=s["fin_tokens"].reshape(B, cap, max_len),
        fin_lens=fin_lens,
        fin_scores=fin_scores,
        fin_count=torch.isfinite(fin_scores).sum(dim=1).to(torch.int32),
        live_tokens=s["hist"][:, 1:].reshape(B, k, max_len).to(torch.int32),
        live_scores=live_scores.reshape(B, k),
        l_final=s["l_final"])


@torch.no_grad()
def beam_decode(params, cfg: Config, bw: int, feats, feat_lens,
                fused_logp: Optional[bool] = None, lm_track=None,
                mesh=None, unroll: int = 1):
    """``fused_logp``: None reads ``use_fused_logp()``.  ``unroll``: the
    guarded steps run between two host reads of the stop flag (JAX's
    ``unroll``); any value gives the same result.

    On a mesh (``mesh``; ``params`` from ``sharding.shard_params``) the
    feats are this rank's data shard and the result holds its rows
    (``l_final`` is the whole mesh's).

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
    return graphs.run_loop(
        BeamLoop(params, cfg, bw, fused_logp, lm_track, mesh),
        (feats, feat_lens), unroll)


def beam_key(name: str, params, cfg: Config, bw: int, fused_logp: bool,
             *rest) -> tuple:
    """A ``*_jit`` program's cache key: what a replay depends on besides
    its inputs (``utils/graphs.py``)."""
    return (name, cfg, bw, fused_logp, graphs.tensor_ids(params), *rest)


@torch.no_grad()
def beam_decode_jit(params, cfg: Config, bw: int, feats, feat_lens,
                    unroll: int = graphs.UNROLL) -> BeamResult:
    """``beam_decode`` as one compiled program: on the card its graphs'
    replay (``utils/graphs.py``; the outputs are copied out of the
    graphs), on the CPU the guarded loop."""
    fused = use_fused_logp()
    return graphs.run(beam_key("beam", params, cfg, bw, fused),
                      BeamLoop(params, cfg, bw, fused),
                      (feats, feat_lens), unroll)


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
    act = res.live_scores + length_weight * (
        res.l_final + 1).to(torch.float32)                         # [B, k]
    j = torch.argmax(act, dim=1)
    rows = torch.arange(act.shape[0], device=act.device)
    live_len = (res.l_final + 1).to(res.fin_lens.dtype).expand(act.shape[0])
    return res.live_tokens[rows, j], act[rows, j], live_len


def select_best(res: BeamResult, length_weight: float) -> BestResult:
    """Best finished hypothesis by raw logp (non-finite slots masked, first
    max wins), else the live-beam fallback."""
    fin_sel = torch.where(torch.isfinite(res.fin_scores), res.fin_scores,
                          torch.full_like(res.fin_scores, float("-inf")))
    return select_merge(res, fin_sel, *live_fallback(res, length_weight))


def beam_decode_best(params, cfg: Config, bw: int, feats,
                     feat_lens, mesh=None, unroll: int = 1) -> BestResult:
    """Decode + on-device best-hypothesis selection (transcription without
    a second pass).  On a mesh, every rank returns the whole batch's."""
    return sharding.gather_rows(select_best(
        beam_decode(params, cfg, bw, feats, feat_lens, mesh=mesh,
                    unroll=unroll), cfg.decode.length_weight), mesh)


@torch.no_grad()
def beam_decode_best_jit(params, cfg: Config, bw: int, feats, feat_lens,
                         unroll: int = graphs.UNROLL) -> BestResult:
    """``beam_decode_best`` as one compiled program (``beam_decode_jit``):
    the decode and the selection in one set of graphs."""
    fused = use_fused_logp()
    lw = cfg.decode.length_weight
    return graphs.run(beam_key("beam_best", params, cfg, bw, fused),
                      BeamLoop(params, cfg, bw, fused), (feats, feat_lens),
                      unroll, lambda res: select_best(res, lw))


def finalize_best(best: BestResult, vocab, text=None) -> EvalOutput:
    """Host detokenization of a device-selected ``BestResult``; with
    ``text`` (reference texts) also the mean CER."""
    tokens = best.tokens.cpu().numpy()
    lens = best.lens.cpu().numpy()
    scores = best.scores.cpu().numpy()
    graphs.settle()             # the result is read: its chunks' launches
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
    graphs.settle()             # the result is read: its chunks' launches
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
