"""The training step (port of ``chinese_asr_tpu/train/step.py``):
teacher-forced decode over the whole target matrix, label-smoothed CE,
gradients, the optimizer update.

The reference trains by looping over ``PackedSequence`` steps with a
shrinking batch (reference model.py:414-453) and one CE over all steps
(model.py:456-469).  Here, as in JAX, fixed [B, S] token matrices and
masks replace the packed batch, and scheduled sampling (model.py:434-443)
is a per-step Bernoulli draw.  The step's code is eager: the encoder's
recurrences through K2 forward and K2-bwd backward (``ops/cuda/lstm.py``
``bidir_lstm``), the decoder as a Python loop of S steps under autograd.
``train_step`` runs it so (the mesh's step, and the oracle);
``CompiledStep`` is JAX's jitted step with params and optimizer state
donated: on the card one CUDA graph a (T, S) bucket that writes the new
state into the trainer's own tensors (``utils/graphs.py``
``StepGraphs``), on the CPU the same code eagerly.

Mixed precision (``train.compute_dtype="bfloat16"``), as in JAX: the
forward and backward run in bf16 (K2-bf16 and K2-bwd-bf16 on the card),
while the master params, the optimizer state, the CE and the gradient
norm stay float32; the gradients come back float32 from the cast inside
``loss_fn``.

On a (data x model) mesh (``mesh``, ``parallel/sharding.py``) the step
equals the single device's: the batch is this rank's rows of the global
batch, the CE divides by the global token count, BatchNorm takes the
global batch's statistics, scheduled sampling draws the global coins and
keeps this rank's, the gradients are summed over the data axis and the
clip's and the reported norm are the whole model's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..config import Config
from ..data.dataset import Batch
from ..models import decoder as dec_ops
from ..models import las
from ..ops import conv as conv_ops
from ..parallel import sharding
from ..utils import graphs
from . import optim
from .loss import label_smoothed_ce


def _step(body, remat: bool, *args):
    """One decoder step; under ``remat`` its activations are dropped and
    recomputed in the backward (``jax.checkpoint`` of the scan body)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False, preserve_rng_state=False)
    return body(*args)


def draw_coins(gen: torch.Generator, S: int, B: int, ss: float,
               mesh=None) -> torch.Tensor:
    """Scheduled sampling's coins [S, B], bool on ``gen``'s device (True:
    step t feeds the model's own token): drawn from ``gen`` for the global
    batch ([S, B * data ranks] at once, so every rank consumes ``gen``
    alike), this rank's columns kept."""
    Bg = B * sharding.data_size(mesh)
    coins = torch.rand((S, Bg), generator=gen, device=gen.device)
    return coins[:, sharding.row_slice(Bg, mesh)] < ss


def forward_logits(params, cfg: Config, batch: Batch,
                   gen: Optional[torch.Generator] = None, ss: float = 0.0,
                   bn_updates=None,
                   gate_hoist: Optional[bool] = None,
                   mesh=None, coins: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Teacher-forced logits [B, S, V] for the whole target matrix.

    ``ss`` > 0 with a generator ``gen`` turns on scheduled sampling: with
    probability ss the input token at step t > 0 is the model's own argmax
    from step t-1 instead of gold (reference model.py:434-443).  The coins
    are drawn from ``gen`` on its own device ([S, B] at once,
    ``draw_coins``), so a seed gives the same draws on the CPU and the
    card; or they are given, drawn before the step (``coins``, [S, B] bool
    on the batch's device; ``CompiledStep``).

    Without it (the flagship regime) the inputs are known up front, so the
    embedding and the logit products leave the step loop: one [B*S, .]
    product each way, the loop carrying only the [S, B, H+ctx] trajectory.
    ``gate_hoist`` also hoists layer 0's embedding part of the gate product
    with both biases (JAX: on by default from B >= 64; LSTM decoder with
    input feeding only).  The encoder runs in train mode: its BatchNorms
    normalize with batch statistics and record them into ``bn_updates``.
    On a mesh, ``batch`` is this data rank's rows, the coins this rank's
    columns of the global batch's, and the logits are full [B, S, V] rows.
    """
    B, S = batch.tokens_in.shape
    dcfg, acfg = cfg.decoder, cfg.attention
    remat = cfg.train.remat
    eb = las.encode(params, cfg, batch.feats, batch.feat_lens, train=True,
                    bn_updates=bn_updates)
    ctx = dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])
    cell0 = eb.init_cell_state
    if cell0 is None:
        cell0 = dec_ops.zero_cell_state(dcfg, batch.feats, B)
    attn0 = batch.feats.new_zeros((B, ctx))
    dp, ap = params["decoder"], params["attention"]

    if ss > 0.0 and (coins is not None or gen is not None):
        # each step's logits are needed inside the loop (the argmax feeds
        # step t+1), so nothing hoists
        if coins is None:
            coins = draw_coins(gen, S, B, ss, mesh).to(
                batch.tokens_in.device)

        def body(cell, attn, tok):
            out = dec_ops.decoder_step(dp, ap, dcfg, acfg, eb.mask, eb.keys,
                                       eb.values, None, cell, attn,
                                       token_emb=dec_ops.embed(dp, tok, mesh),
                                       mesh=mesh)
            return out.cell_state, out.attn_hidden_state, out.logit

        cell, attn = cell0, attn0
        prev = batch.tokens_in[:, 0]
        logits = []
        for t in range(S):
            tok = batch.tokens_in[:, t]
            if t > 0:
                tok = torch.where(coins[t], prev, tok)
            cell, attn, logit = _step(body, remat, cell, attn, tok)
            prev = torch.argmax(logit, dim=-1)
            logits.append(logit)
        return torch.stack(logits, dim=1)                      # [B, S, V]

    emb_seq = dec_ops.embed(dp, batch.tokens_in, mesh)         # [B, S, E]
    if gate_hoist is None:      # by the global batch, as JAX traces it
        gate_hoist = B * sharding.data_size(mesh) >= 64
    gate_hoist = (gate_hoist and dcfg.decoder_type == "LSTM"
                  and dcfg.input_feeding)
    if gate_hoist:
        p0 = dp["cells"][0]
        E = emb_seq.shape[-1]
        xs = (emb_seq.reshape(B * S, E) @ p0["w_ih"][:E]
              + p0["b_ih"] + p0["b_hh"]).reshape(B, S, -1)     # [B, S, 4H]
    else:
        xs = emb_seq

    def body(cell, attn, x_t):
        out = dec_ops.decoder_step(
            dp, ap, dcfg, acfg, eb.mask, eb.keys, eb.values, None, cell,
            attn, compute_logit=False,
            token_emb=None if gate_hoist else x_t,
            gate_partial=x_t if gate_hoist else None)
        return out.cell_state, out.attn_hidden_state

    cell, attn = cell0, attn0
    h_seq, a_seq = [], []
    for t in range(S):
        cell, attn = _step(body, remat, cell, attn, xs[:, t])
        h_seq.append(dec_ops.last_hidden(dcfg, cell))
        a_seq.append(attn)
    logits = dec_ops.project(dp, acfg, torch.stack(h_seq),
                             torch.stack(a_seq), mesh)         # [S, B, V]
    return logits.transpose(0, 1)


def loss_fn(params, cfg: Config, batch: Batch,
            gen: Optional[torch.Generator] = None, mesh=None,
            coins: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """(label-smoothed CE over the valid tokens, {"accuracy",
    "num_tokens", "bn_stats"}); the CE is taken from float32 logits.
    ``bn_stats`` is the encoder's BatchNorm batch statistics as a tree
    mirroring ``params`` (``ops/conv.py`` bn_stats_tree, detached: running
    stats are a moving average, not learned), None without BatchNorm.

    Under ``train.compute_dtype="bfloat16"`` the float leaves of ``params``
    and ``batch.feats`` are cast to bf16 here, inside the differentiated
    function (JAX ``train/step.py:174-181``), so the forward and backward
    run in bf16 and autograd hands back float32 gradients at the cast.

    On a mesh the CE is this data rank's share of the global batch's (its
    masked sum over the global token count: the shares sum to the global
    CE), and the accuracy and ``num_tokens`` are the global batch's."""
    cd = getattr(torch, cfg.train.compute_dtype)
    if cd != torch.float32:
        params = las.tree_map(
            lambda t: t.to(cd) if t.is_floating_point() else t, params)
        batch = batch._replace(feats=batch.feats.to(cd))
    bn_updates = [] if sharding.data_size(mesh) == 1 else \
        conv_ops.ShardStats(lambda t: sharding.sum_shares_over_data(t, mesh),
                            sharding.data_size(mesh))
    logits = forward_logits(params, cfg, batch, gen, cfg.train.ss,
                            bn_updates, mesh=mesh, coins=coins).float()
    S = batch.tokens_out.shape[1]
    mask = (torch.arange(S, device=logits.device)[None, :]
            < batch.text_lens[:, None])
    tokens_out = batch.tokens_out.long()
    n = sharding.sum_over_data(mask.sum(), mesh)
    loss = label_smoothed_ce(logits, tokens_out, mask,
                             cfg.train.label_smooth,
                             n_valid=None if mesh is None else n)
    hits = ((torch.argmax(logits, -1) == tokens_out) & mask).sum()
    acc = sharding.sum_over_data(hits, mesh) / torch.clamp(n, min=1)
    # the recordings key on the sub-dicts of the tree the forward ran on
    # (the bf16 cast's under mixed precision), so the tree is built here
    bn_tree = las.tree_map(lambda t: None if t is None else t.detach(),
                           conv_ops.bn_stats_tree(params, bn_updates))
    return loss, {"accuracy": acc, "num_tokens": n, "bn_stats": bn_tree}


def train_step(params, opt_state, cfg: Config, tx: optim.Optimizer,
               batch: Batch, gen: Optional[torch.Generator] = None,
               mesh=None, coins: Optional[torch.Tensor] = None):
    """One update.  Returns (params, opt_state, metrics); the metrics are
    tensors on the device (no host sync here), and ``params`` and
    ``opt_state`` are left as they were.  On a mesh, ``params`` and
    ``opt_state`` are this rank's shards (``sharding.shard_params``),
    ``batch`` its rows (``sharding.shard_batch``), and the metrics the
    global batch's.  ``coins``: scheduled sampling's draws, made before
    the step (``forward_logits``).

    A non-finite loss skips the update: params and optimizer state come
    back unchanged, the reference's NaN/Inf guard (model.py:473-475).
    BatchNorm running stats are buffers: the optimizer leaves them alone,
    and the batch statistics of the forward fold into them after the
    update (torch's momentum-0.1 moving average, JAX
    ``conv.merge_bn_stats``)."""
    flat = optim.flatten(params)
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    loss, aux = loss_fn(optim.unflatten(params, leaves), cfg, batch, gen,
                        mesh, coins)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    with torch.no_grad():
        grads = sharding.sum_grads_over_data(
            {n: torch.zeros_like(flat[n]) if g is None else g
             for n, g in zip(leaves, grads)}, mesh)
        gnorm = torch.sqrt(sharding.sq_norm(
            {n: g.float() for n, g in grads.items()}, mesh))
        loss = sharding.sum_over_data(loss.detach(), mesh)
        finite = torch.isfinite(loss)       # the same on every rank
        grads = {n: torch.where(finite, g, torch.zeros_like(g))
                 for n, g in grads.items()}
        updates, new_state = tx.update(grads, opt_state, flat, mesh)
        merged = optim.flatten(conv_ops.merge_bn_stats(
            optim.unflatten(params, {n: p + updates[n]
                                     for n, p in flat.items()}),
            aux.pop("bn_stats")))
        new_flat = {n: torch.where(finite, merged[n], p)
                    for n, p in flat.items()}
        new_state = {k: torch.where(finite, v, opt_state[k])
                     for k, v in new_state.items()}
    metrics = {"loss": loss, "grad_norm": gnorm, "skipped": ~finite, **aux}
    return optim.unflatten(params, new_flat), new_state, metrics


class CompiledStep:
    """``train_step`` compiled, as JAX's trainer jits it with params and
    optimizer state donated (JAX ``train/trainer.py:45-52``):
    ``step(params, opt_state, batch, gen)`` writes the new params and
    optimizer state into the tensors of ``params`` and ``opt_state`` and
    returns them with the metrics (a copy, the caller's).  On the card it
    replays one CUDA graph a key (the batch's shapes, so a (T, S) bucket
    and the batch size; the config, whose ``compute_dtype`` it holds; the
    math switches; the state tensors' addresses), all of one step in one
    shared pool (``utils/graphs.py`` ``StepGraphs``): the encoder (K2 or
    K2-bf16), the S decoder steps, the CE, the backward (K2-bwd or
    K2-bwd-bf16 and autograd's kernels), the gradient norm, the optimizer
    update, the BatchNorm fold and the non-finite skip.  On the CPU the
    same code runs eagerly.

    Scheduled sampling's coins are drawn on the host before the replay,
    from ``gen`` in ``train_step``'s order (``draw_coins``), and copied
    into the graph's input: the same numbers as the eager step's.  One
    device only: a mesh steps with ``train_step``."""

    def __init__(self, cfg: Config, tx: optim.Optimizer):
        self.cfg, self.tx = cfg, tx
        self.graphs = graphs.StepGraphs()

    def __call__(self, params, opt_state, batch: Batch,
                 gen: Optional[torch.Generator] = None):
        cfg, tx = self.cfg, self.tx
        inputs = tuple(batch)
        if cfg.train.ss > 0.0 and gen is not None:
            B, S = batch.tokens_in.shape
            inputs += (draw_coins(gen, S, B, cfg.train.ss).to(
                batch.tokens_in.device),)

        def step(*ins):
            new_params, new_state, metrics = train_step(
                params, opt_state, cfg, tx, Batch(*ins[:5]),
                coins=ins[5] if len(ins) > 5 else None)
            return ((params, new_params), (opt_state, new_state)), metrics

        metrics = self.graphs(
            ("train_step", cfg, graphs.tensor_ids(params, opt_state)), step,
            inputs)
        return params, opt_state, metrics
