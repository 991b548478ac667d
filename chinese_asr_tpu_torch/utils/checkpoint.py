"""``chinese_asr_tpu.v1`` checkpoints (the JAX package's
``utils/checkpoint.py`` format), read and written without JAX.

The payload is a pickle of plain containers: ``params`` is the JAX
package's parameter tree with numpy leaves (``models.las.params_to_numpy``
/ ``params_from_numpy`` carry it to and from tensors), ``opt_state`` the
optimizer state (the port writes a flat dict of numpy arrays), and
``train_var`` a dict.  The port writes no torch class into it, so the JAX
package reads a port checkpoint without torch.

A checkpoint the JAX trainer wrote holds its optimizer state as optax
classes (``optax._src.transform.ScaleByAdamState`` ...).  Reading one
needs no optax: every class from a module under ``optax``, ``jax`` or
``jaxlib`` unpickles as a plain stand-in that keeps its fields.

Filename contract kept verbatim (reference util.py:1600-1618):
``step-{step}_wer-{wer:.5f}.ckpt``.  Only load checkpoints you trust:
unpickling can run arbitrary code.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

FORMAT = "chinese_asr_tpu.v1"

# top-level modules whose classes unpickle as stand-ins
_FOREIGN = ("optax", "jax", "jaxlib")


@dataclass
class TrainVar:
    """Resume state (reference util.py:2356-2363)."""

    step: int = 0
    loss: float = 0.0
    best_wer: float = float("inf")
    lr: float = 1e-3
    duration: float = 0.0        # accumulated train seconds
    num_no_imprv: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainVar":
        fields = {f.name for f in dataclasses.fields(TrainVar)}
        return TrainVar(**{k: v for k, v in d.items() if k in fields})


class ForeignObject:
    """Stand-in for an unpickled object of a JAX or optax class: ``fields``
    holds what the pickle gave it, the constructor's arguments as a tuple
    (a NamedTuple's fields) or the object's state as a dict."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.fields = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.fields = state

    def __repr__(self) -> str:
        return f"{type(self).__module__}.{type(self).__name__}{self.fields!r}"


class _Unpickler(pickle.Unpickler):
    _stand_ins: Dict[Tuple[str, str], type] = {}

    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            key = (module, name)
            if key not in self._stand_ins:
                self._stand_ins[key] = type(name, (ForeignObject,),
                                            {"__module__": module})
            return self._stand_ins[key]
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload: {"format", "params", "opt_state", "train_var",
    "config_json", "extra"}; ``train_var`` stays a plain dict."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} checkpoint: {path}")
    return payload


def save_checkpoint(path: str, params, opt_state=None,
                    train_var: Optional[TrainVar] = None,
                    config_json: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint (reference Model.save, model.py:347-355).
    ``params``: the JAX-layout tree with numpy leaves
    (``las.params_to_numpy``); ``opt_state``: a dict of numpy arrays.
    Written to a temporary file and renamed, so a reader never sees half
    a checkpoint."""
    payload = {
        "format": FORMAT,
        "params": params,
        "opt_state": opt_state,
        "train_var": None if train_var is None else train_var.to_dict(),
        "config_json": config_json,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def view_ckpt(path: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Inspector (reference util.py:691-723 / test.py:16-21): (flat name,
    shape, dtype) of every tensor in the checkpoint's params."""
    from ..models.las import tree_paths

    payload = load_checkpoint(path)
    # each name as jax.tree_util.keystr spells it: ['decoder']['cells'][0]
    return [("".join(f"[{k!r}]" for k in p), tuple(np.shape(leaf)),
             str(np.asarray(leaf).dtype))
            for p, leaf in tree_paths(payload["params"])]


# --------------------------------------------------------------------------
# run-directory manager (reference Checkpoint, util.py:1591-1621)
# --------------------------------------------------------------------------
_CKPT_RE = re.compile(r"^step-(\d+)_wer-([0-9.]+?)\.ckpt$")


class CheckpointManager:
    def __init__(self, save_dir: str, keep: int = 0):
        self.save_dir = save_dir
        self.keep = keep
        os.makedirs(save_dir, exist_ok=True)

    def _entries(self) -> List[Tuple[int, float, str]]:
        out = []
        for name in os.listdir(self.save_dir):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)), float(m.group(2)),
                            os.path.join(self.save_dir, name)))
        return out

    def latest_checkpoint(self) -> Optional[str]:
        entries = self._entries()
        return max(entries, key=lambda e: e[0])[2] if entries else None

    def best_checkpoint(self) -> Optional[str]:
        entries = self._entries()
        return min(entries, key=lambda e: e[1])[2] if entries else None

    def path_for(self, step: int, wer: float) -> str:
        return os.path.join(self.save_dir, f"step-{step}_wer-{wer:.5f}.ckpt")

    def save(self, step: int, wer: float, params, opt_state=None,
             train_var: Optional[TrainVar] = None,
             config_json: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        path = self.path_for(step, wer)
        save_checkpoint(path, params, opt_state, train_var, config_json,
                        extra)
        if self.keep > 0:
            self._gc()
        return path

    def _gc(self) -> None:
        """Keep the best + the ``keep`` latest checkpoints."""
        entries = self._entries()
        if len(entries) <= self.keep:
            return
        best = min(entries, key=lambda e: e[1])[2]
        latest = [e[2] for e in
                  sorted(entries, key=lambda e: -e[0])[: self.keep]]
        for _, _, p in entries:
            if p != best and p not in latest:
                try:
                    os.remove(p)
                except OSError:
                    pass
