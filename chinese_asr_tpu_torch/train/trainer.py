"""Training loop (port of ``chinese_asr_tpu/train/trainer.py``; reference
Model.train, model.py:84-345): epoch loop, LR ramp-up, EMA-smoothed
console line, periodic greedy eval with CER, reduce-on-plateau LR, a
checkpoint per eval named ``step-X_wer-Y.ckpt``.

On one device the step is ``train/step.py`` ``CompiledStep``, JAX's
jitted step with params and optimizer state donated: on the card one
CUDA graph a (T, S) bucket, replayed, that writes the new params and
optimizer state into the trainer's own tensors; on the CPU the same code
eagerly.  So ``params`` and ``opt_state`` keep their tensors for the
trainer's life: the LR moves (``optim.set_lr``) and ``resume`` write into
them, and ``evaluate`` decodes through ``greedy_decode_jit``, whose graph,
keyed on the params' addresses, is captured once and sees every step's
values.  ``fit`` reads the loss (and the grad norm with it) once a step.
Each step's parts are spans (``utils/observe.py``): ``asr.train.load``
(the next batch from the loader), ``asr.train.step`` (the step call),
``asr.train.read`` (the loss read, which waits for the step) and
``asr.train.log``.

Over a (data x model) mesh (``mesh=``, ``parallel/sharding.py``) every
rank runs this loop on the same global batches: it keeps its shard of the
params (and of their optimizer state) and its rows of each batch, and the
step equals the single device's (``train/step.py`` ``train_step``, eager:
it returns new tensors).  Evaluation decodes on the mesh, eagerly; its CER
is the global batch's.  Rank 0 writes the checkpoints
from the gathered params, in the single-device format, and the other ranks
log under ``save_dir/rank<r>``.

Checkpoints are ``chinese_asr_tpu.v1`` (``utils/checkpoint.py``): the JAX
package loads the params of one written here, and a checkpoint of the JAX
trainer resumes here (its optax optimizer state does not carry over).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..decode.greedy import (finalize_greedy, greedy_decode,
                             greedy_decode_jit)
from ..models import las
from ..parallel import sharding
from ..utils.checkpoint import CheckpointManager, TrainVar, load_checkpoint
from ..utils.device import resolve_device
from ..utils.graphs import copy_tree
from ..utils.observe import (EMA, Duration, MetricsLogger,
                             batch_alignment_images, rand_disp_list, span)
from . import optim, step as step_mod
from .step import Batch


class Trainer:
    def __init__(self, cfg: Config, params, vocab=None,
                 logger: Optional[MetricsLogger] = None, device=None,
                 mesh=None):
        """``params``: a parameter tree (``las.init_params``), moved to
        ``device`` in float32, the master copy whatever
        ``train.compute_dtype`` (the optimizer state and the checkpoints
        stay float32 too, and ``evaluate`` decodes in float32, as in JAX);
        ``device`` defaults to ``cuda`` and raises without a GPU.  The
        trainer keeps copies: its steps write into them, not into
        ``params``.
        ``mesh``: a ``DeviceMesh`` from ``sharding.make_mesh``, or "auto";
        ``params`` is the whole tree, the same on every rank."""
        self.mesh = mesh = sharding.resolve_mesh(mesh, cfg, device)
        self.rank = 0 if mesh is None else torch.distributed.get_rank()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.params = las.tree_map(
            lambda t: t.detach().to(self.device, torch.float32, copy=True),
            params)
        if mesh is not None:
            self.params = sharding.shard_params(self.params, cfg, mesh)
        self.tx = optim.make_optimizer(cfg.train)
        self.opt_state = self.tx.init(self.params)
        if mesh is None:        # JAX: jit, params and opt_state donated
            self._step_fn = step_mod.CompiledStep(cfg, self.tx)
        else:
            self._step_fn = lambda p, o, batch, gen: step_mod.train_step(
                p, o, cfg, self.tx, batch, gen, mesh)
        self.tv = TrainVar(lr=cfg.train.base_lr)
        self.plateau = optim.PlateauLR(cfg.train)
        self.ckpt = CheckpointManager(cfg.train.save_dir)
        self.logger = logger or MetricsLogger(
            cfg.train.save_dir if self.rank == 0
            else os.path.join(cfg.train.save_dir, f"rank{self.rank}"))
        self.ema = EMA(0.99)
        self.duration = Duration()
        # scheduled sampling's coins, drawn on the CPU
        self._gen = torch.Generator().manual_seed(cfg.train.seed)

    # ---- resume (reference model.py:137-158) ------------------------------
    def resume(self, path: Optional[str] = None) -> bool:
        """Params and train state from ``path`` (default: the config's
        ``continue_train_ckpt_path`` or the newest checkpoint in the save
        dir).  A checkpoint of this port resumes in full; one of the JAX
        trainer (optax state) or of another optimizer gives params and
        train state, and the optimizer state starts fresh.  Everything is
        written into the trainer's tensors."""
        path = path or self.cfg.train.continue_train_ckpt_path \
            or self.ckpt.latest_checkpoint()
        if not path:
            return False
        payload = load_checkpoint(path)
        params = las.params_from_numpy(payload["params"], self.device)
        if self.mesh is not None:       # a checkpoint holds the whole model
            params = sharding.shard_params(params, self.cfg, self.mesh)
        _assign(self.params, params, path)
        _assign(self.opt_state, self.tx.init(self.params), path)
        saved = payload.get("opt_state")
        if (payload.get("extra", {}).get("optimizer") == self.tx.kind
                and isinstance(saved, dict)
                and set(saved) == set(self.opt_state)):
            _assign(self.opt_state, sharding.shard_flat(
                {k: torch.as_tensor(np.asarray(v)).to(
                    self.device, self.opt_state[k].dtype)
                 for k, v in saved.items()}, self.mesh), path)
        elif saved is not None:
            print(f"resume: {path} holds no {self.tx.kind} state of this "
                  f"port (a JAX trainer's optax state, or another "
                  f"optimizer's); the optimizer state starts fresh",
                  file=sys.stderr)
        if payload.get("train_var") is not None:
            self.tv = TrainVar.from_dict(payload["train_var"])
            self.plateau = optim.PlateauLR(
                self.cfg.train, lr=self.tv.lr, best=self.tv.best_wer,
                num_no_imprv=self.tv.num_no_imprv)
            self.duration.seconds = self.tv.duration
            self.opt_state = optim.set_lr(self.opt_state, self.tv.lr)
        return True

    # ---- eval (reference model.py:240-261) ---------------------------------
    def evaluate(self, eval_loader: Iterable[Batch]) -> float:
        cers, weights = [], []
        first = True
        for b in eval_loader:
            res = self._greedy(b.feats, b.feat_lens)
            to_np = b.tokens_out.cpu().numpy()
            tl_np = b.text_lens.cpu().numpy()
            text = [to_np[i, : tl_np[i] - 1].tolist()
                    for i in range(len(tl_np))]                # strip eos
            out = finalize_greedy(res, self.vocab, text=text,
                                  want_alignment=first)
            cers.append(out.wer)
            weights.append(out.n)
            if first:
                # alignment heatmaps + sample transcripts of the first eval
                # batch (reference model.py:268-281)
                first = False
                lens = b.feat_lens.cpu().numpy()
                tl = res.final_lens.cpu().numpy()
                for i, img in enumerate(batch_alignment_images(
                        out.alignment[:2], lens[:2], np.maximum(tl[:2], 1))):
                    self.logger.image(f"eval/alignment{i}", img, self.tv.step)
                for line in rand_disp_list(out.pred_text, out.text,
                                           n=min(3, out.n)):
                    self.logger.text("eval/sample", line, self.tv.step)
        if not cers:
            return float("inf")
        return float(np.average(cers, weights=weights))

    def _greedy(self, feats, feat_lens):
        """Greedy decode of an eval batch: on one device
        ``greedy_decode_jit``, as JAX's trainer decodes; on a mesh the
        eager loop, the whole batch's result from this rank's rows
        (``sharding.pad_shard_rows``)."""
        mesh = self.mesh
        if mesh is None:
            return greedy_decode_jit(self.params, self.cfg, feats, feat_lens)
        res = greedy_decode(self.params, self.cfg,
                            *sharding.pad_shard_rows(mesh, feats, feat_lens),
                            mesh)
        return sharding.trim_rows(sharding.gather_rows(res, mesh),
                                  feats.shape[0])

    # ---- main loop (reference model.py:160-345) ----------------------------
    def fit(self, train_loader_fn: Callable[[], Iterable[Batch]],
            eval_loader_fn: Optional[Callable[[], Iterable[Batch]]] = None,
            max_steps: Optional[int] = None) -> TrainVar:
        cfg = self.cfg.train
        steps_per_eval = cfg.num_eval_steps
        for epoch in range(cfg.epochs):
            batches = iter(train_loader_fn())
            while True:
                n = self.tv.step + 1
                with span("asr.train.load", lambda: f"step {n}"):
                    batch = next(batches, None)
                if batch is None:
                    break
                self.duration.tic()
                with span("asr.train.step", lambda: f"step {n} T "
                          f"{batch.feats.shape[1]} S "
                          f"{batch.tokens_in.shape[1]}"):
                    # LR ramp-up (model.py:185-187)
                    if cfg.ramp_up_iters > 0 and \
                            self.tv.step < cfg.ramp_up_iters:
                        self.opt_state = optim.set_lr(
                            self.opt_state,
                            optim.ramp_up_lr(self.plateau.lr, self.tv.step,
                                             cfg.ramp_up_iters))
                    if self.mesh is not None:
                        batch = sharding.shard_batch(batch, self.cfg,
                                                     self.mesh)
                    self.params, self.opt_state, metrics = self._step_fn(
                        self.params, self.opt_state, batch, self._gen)
                with span("asr.train.read", lambda: f"step {n}"):
                    # the step's one host read
                    loss, gnorm = torch.stack(
                        (metrics["loss"], metrics["grad_norm"])).tolist()
                with span("asr.train.log", lambda: f"step {n}"):
                    self.tv.step += 1
                    self.tv.loss = loss
                    dt = self.duration.toc()
                    ema = self.ema.update(loss)
                    if self.cfg.verbose and self.tv.step % 10 == 0:
                        # console line (model.py:216-224)
                        print(f"step {self.tv.step} epoch {epoch} "
                              f"loss {loss:.4f} ema {ema:.4f} "
                              f"{dt * 1e3:.0f}ms "
                              f"lr {optim.get_lr(self.opt_state):.2e} "
                              f"best_wer {self.tv.best_wer:.5f} "
                              f"no_imprv {self.plateau.num_no_imprv}",
                              file=sys.stderr)
                    self.logger.scalar("train/loss", loss, self.tv.step)
                    self.logger.scalar("train/grad_norm", gnorm,
                                       self.tv.step)
                if steps_per_eval > 0 and self.tv.step % steps_per_eval == 0:
                    self._eval_and_checkpoint(eval_loader_fn)
                if max_steps is not None and self.tv.step >= max_steps:
                    self._eval_and_checkpoint(eval_loader_fn)
                    return self.tv
            # num_eval_steps == -1 -> eval once per epoch (gpd.py:117)
            if steps_per_eval <= 0:
                self._eval_and_checkpoint(eval_loader_fn)
        return self.tv

    def _eval_and_checkpoint(self, eval_loader_fn) -> str:
        wer = self.evaluate(eval_loader_fn()) if eval_loader_fn else \
            float(self.tv.loss)
        self.tv.best_wer = min(self.tv.best_wer, wer)
        self.logger.scalar("eval/wer", wer, self.tv.step)
        # plateau LR (model.py:286-291, util.py:673-688)
        if self.plateau.step(wer):
            self.opt_state = optim.set_lr(self.opt_state, self.plateau.lr)
        self.tv.lr = self.plateau.lr
        self.tv.num_no_imprv = self.plateau.num_no_imprv
        self.tv.duration = self.duration.seconds
        # checkpoint per eval (model.py:294); on a mesh the whole model,
        # gathered on every rank, written by rank 0
        params, opt_state = self.params, self.opt_state
        if self.mesh is not None:
            params = sharding.unshard_params(params, self.cfg, self.mesh)
            opt_state = sharding.unshard_flat(opt_state, self.mesh)
        path = self.ckpt.path_for(self.tv.step, wer)
        if self.rank == 0:
            path = self.ckpt.save(
                self.tv.step, wer, las.params_to_numpy(params),
                {k: v.cpu().numpy() for k, v in opt_state.items()},
                self.tv, self.cfg.to_json(),
                extra={"optimizer": self.tx.kind})
        if self.mesh is not None:
            torch.distributed.barrier()     # the file exists for every rank
        return path


def _assign(dst, src, path: str) -> None:
    """Copy the tree ``src`` into the tensors of ``dst`` (the trainer's
    params or optimizer state, which a compiled step reads in place);
    the two must match leaf for leaf in name and shape."""
    d, s = optim.flatten(dst), optim.flatten(src)
    wrong = sorted(n for n in d.keys() | s.keys()
                   if n not in d or n not in s or d[n].shape != s[n].shape)
    if wrong:
        raise ValueError(f"resume: {path} does not match the trainer's "
                         f"tree at {wrong[:5]}")
    copy_tree(dst, src)
