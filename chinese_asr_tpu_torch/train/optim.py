"""Optimizers and LR control (port of ``chinese_asr_tpu/train/optim.py``;
reference model.py:105-119, util.py:673-688, util.py:2124-2353).

The JAX package builds its optimizers from optax; this module computes the
same updates on dicts of tensors, transform for transform:

* ADAM: ``clip_by_global_norm`` -> ``add_decayed_weights(l2)`` ->
  ``scale_by_adam()`` -> ``scale(-lr)`` (torch-style L2: the decay joins
  the gradient before the moments, as ``torch.optim.Adam(weight_decay=)``);
* SGD: the clip -> the same decay -> ``trace(momentum)`` -> ``scale(-lr)``;
* ADABOUND / ADABOUNDW: the clip -> Adam whose per-parameter step size is
  clipped into a band that tightens toward a final SGD rate (``final_lr``
  rescaled by lr/base_lr as the lr moves); W decouples the weight decay.

BatchNorm running-stat buffers (``bn_mean``, ``bn_var``) and, with
``train.fine_tune``, everything but the output projection and the
attention get a zero update and keep no state; the clip's global norm is
taken over the parameters that train, as optax's masks give it.

The state is a flat dict of tensors: ``learning_rate`` (the injected
hyperparameter that ``set_lr`` moves in place), ``count`` (the update
count of Adam and AdaBound) and one moment per trainable parameter, keyed
``mu/<name>``, ``nu/<name>`` or ``trace/<name>`` with ``name`` the
parameter's path (``decoder/cells/0/w_ih``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import TrainConfig
from ..models import las
from ..parallel import sharding

Flat = Dict[str, torch.Tensor]

KINDS = ("ADAM", "SGD", "ADABOUND", "ADABOUNDW")
_BUFFERS = ("bn_mean", "bn_var")
_FINE_TUNE = ("proj_w", "proj_b", "attention")
# optax.scale_by_adam's defaults, and the AdaBound ones (optim.py:75-92)
B1, B2, EPS = 0.9, 0.999, 1e-8
GAMMA = 1e-3


# --------------------------------------------------------------------------
# parameter trees <-> flat dicts
# --------------------------------------------------------------------------
def flatten(tree) -> Flat:
    """{path: leaf} in ``jax.tree_util`` order, each path joined by "/"."""
    return {"/".join(map(str, p)): leaf for p, leaf in las.tree_paths(tree)}


def unflatten(like, flat: Flat, prefix: str = ""):
    """The tree ``like`` with each leaf replaced by ``flat[path]``."""
    if isinstance(like, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return flat[prefix[:-1]]


def trainable(name: str, fine_tune: bool = False) -> bool:
    """False for BatchNorm buffers and, under fine-tuning, for everything
    but the output projection and the attention (reference fine-tune
    intent, model.py:62-66; JAX ``fine_tune_mask`` and ``buffer_mask``)."""
    parts = name.split("/")
    if parts[-1] in _BUFFERS:
        return False
    return not fine_tune or any(p in _FINE_TUNE for p in parts)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, as an optax ``GradientTransformation``;
    ``params + updates`` is the step.  ``init`` takes the parameter tree,
    ``update`` flat dicts (``flatten``)."""

    def __init__(self, tcfg: TrainConfig):
        self.kind = tcfg.optimizer.upper()
        if self.kind not in KINDS:
            raise ValueError(f"unknown optimizer {tcfg.optimizer}")
        self.tcfg = tcfg

    def _names(self, params: Flat) -> List[str]:
        return [n for n in params if trainable(n, self.tcfg.fine_tune)]

    def init(self, params) -> Flat:
        params = flatten(params)
        names = self._names(params)
        dev = next(iter(params.values())).device
        state = {"learning_rate": torch.tensor(self.tcfg.base_lr,
                                               dtype=torch.float32,
                                               device=dev),
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        for m in ("trace",) if self.kind == "SGD" else ("mu", "nu"):
            for n in names:
                state[f"{m}/{n}"] = torch.zeros_like(params[n])
        return state

    @torch.no_grad()
    def update(self, grads: Flat, state: Flat, params: Flat, mesh=None
               ) -> Tuple[Flat, Flat]:
        """On a mesh (``mesh``) the dicts hold this rank's shards; the
        clip's global norm sums the vocab-sharded leaves over the model
        axis (``sharding.sq_norm``), so it is the whole model's."""
        tc = self.tcfg
        names = self._names(params)
        lr = state["learning_rate"]
        g = {n: grads[n] for n in names}
        if tc.clip > 0:
            # optax.clip_by_global_norm: t if norm < max, else t / norm * max
            norm = torch.sqrt(sharding.sq_norm(g, mesh))
            keep = norm < tc.clip
            g = {n: torch.where(keep, x, x / norm * tc.clip)
                 for n, x in g.items()}
        new = dict(state)
        count = state["count"] + 1
        t = count.to(torch.float32)
        upd = {}
        if self.kind in ("ADAM", "SGD"):
            for n in names:
                u = g[n] + tc.l2_decay * params[n]    # add_decayed_weights
                if self.kind == "ADAM":
                    mu = (1 - B1) * u + B1 * state[f"mu/{n}"]
                    nu = (1 - B2) * u ** 2 + B2 * state[f"nu/{n}"]
                    new[f"mu/{n}"], new[f"nu/{n}"] = mu, nu
                    mu_hat = mu / (1 - B1 ** t)
                    nu_hat = nu / (1 - B2 ** t)
                    u = mu_hat / (torch.sqrt(nu_hat) + EPS)
                else:
                    u = u + tc.momentum * state[f"trace/{n}"]
                    new[f"trace/{n}"] = u
                upd[n] = (u * -1.0) * lr                 # scale(-1), scale(lr)
        else:
            decoupled = self.kind == "ADABOUNDW"
            wd = tc.l2_decay
            final_lr = 0.1 * lr / tc.base_lr
            step_size = lr * torch.sqrt(1 - B2 ** t) / (1 - B1 ** t)
            lower = final_lr * (1 - 1 / (GAMMA * t + 1))
            upper = final_lr * (1 + 1 / (GAMMA * t))
            for n in names:
                gn = g[n] + wd * params[n] if (wd and not decoupled) else g[n]
                mu = B1 * state[f"mu/{n}"] + (1 - B1) * gn
                nu = B2 * state[f"nu/{n}"] + (1 - B2) * gn * gn
                new[f"mu/{n}"], new[f"nu/{n}"] = mu, nu
                eta = torch.clamp(step_size / (torch.sqrt(nu) + EPS),
                                  lower, upper)
                u = -eta * mu
                if wd and decoupled:
                    u = u - lr * wd * params[n]
                upd[n] = u
        if self.kind != "SGD":
            new["count"] = count
        for n in params:
            if n not in upd:
                upd[n] = torch.zeros_like(params[n])
        return upd, new


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    """The optimizer ``tcfg.optimizer`` names (JAX ``make_optimizer``; its
    masks follow each parameter's name here, so it needs no params)."""
    return Optimizer(tcfg)


def set_lr(opt_state: Flat, lr: float) -> Flat:
    """Writes ``lr`` into the state's ``learning_rate`` tensor, in place
    (a compiled step reads that tensor: ``train/step.py``
    ``CompiledStep``), and returns the state."""
    opt_state["learning_rate"].fill_(lr)
    return opt_state


def get_lr(opt_state: Flat) -> float:
    return float(opt_state["learning_rate"])


def ramp_up_lr(base_lr: float, step: int, ramp_up_iters: int) -> float:
    """Linear warmup (reference model.py:185-187)."""
    if ramp_up_iters <= 0 or step >= ramp_up_iters:
        return base_lr
    return base_lr * (step + 1) / ramp_up_iters


# --------------------------------------------------------------------------
# reduce-on-plateau (reference util.py:673-688)
# --------------------------------------------------------------------------
class PlateauLR:
    """Tracks a minimized metric (dev CER); reduces lr after ``patience``
    evals without improvement beyond ``threshold``."""

    def __init__(self, tcfg: TrainConfig, lr: Optional[float] = None,
                 best: float = float("inf"), num_no_imprv: int = 0):
        self.patience = tcfg.patience
        self.factor = tcfg.factor
        self.min_lr = tcfg.min_lr
        self.threshold = tcfg.dec_rate_threshold
        self.lr = tcfg.base_lr if lr is None else lr
        self.best = best
        self.num_no_imprv = num_no_imprv

    def step(self, metric: float) -> bool:
        """Feed one eval metric; returns True if lr was reduced."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = min(self.best, metric)
            self.num_no_imprv = 0
            return False
        self.best = min(self.best, metric)
        self.num_no_imprv += 1
        if self.num_no_imprv > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            reduced = new_lr < self.lr
            self.lr = new_lr
            self.num_no_imprv = 0
            return reduced
        return False
