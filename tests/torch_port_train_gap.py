"""Training over many steps, the port against the JAX package: both
packages' ``Trainer.fit`` on the CPU over the golden shard's six
utterances (features made once by the port and handed to both; targets
the golden greedy transcripts), from one seed (JAX's ``init_params``
carried to the port), ADAM at lr 1e-3 with a 20-step ramp-up and clip 1,
in float32 and in bf16 mixed precision.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_train_gap.py \
        [steps [every]]

prints one JSON line a dtype: at every ``every``-th step the loss of
each package, their gap relative to JAX's, and the largest absolute gap
of the params; and, for scale, one line a package: its bf16 run's loss
and param gaps to its own f32 run.  Two f32 runs whose sums differ in
order drift apart at the rate the training amplifies rounding; a fault
shows as a bf16 gap between the packages that grows past the f32 gap
and past the bf16-against-f32 gap of either package.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu.train.trainer import Trainer as JTrainer
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features
from chinese_asr_tpu_torch.data import audio_io
from chinese_asr_tpu_torch.data.dataset import Batch as TBatch
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train.trainer import Trainer
from chinese_asr_tpu_torch.vocab import Vocab

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_util import (CHARS, GOLD, golden_cfg,  # noqa: E402
                             golden_wav_paths, jax_params_numpy)


def golden_batch(cfg):
    """The six golden wavs featurized by the port (CPU) and their golden
    greedy transcripts as teacher-forcing targets, as numpy."""
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        texts = json.load(f)["modes"]["greedy"]
    wavs = [audio_io.read_wav(p, 16000)[0] for p in golden_wav_paths()]
    mat = np.zeros((len(wavs), max(map(len, wavs))), np.float32)
    for i, w in enumerate(wavs):
        mat[i, :len(w)] = w
    feats, flens = features.featurize_batch(
        torch.from_numpy(mat), torch.tensor([len(w) for w in wavs]),
        cfg.audio)
    ids = [vocab.encode(t) for t in texts]
    B, S = len(ids), max(map(len, ids)) + 1
    ti = np.full((B, S), cfg.vocab.pad, np.int32)
    to = np.full((B, S), cfg.vocab.pad, np.int32)
    tl = np.zeros(B, np.int32)
    for i, t in enumerate(ids):
        ti[i, 0], ti[i, 1:1 + len(t)] = cfg.vocab.sos, t
        to[i, :len(t)], to[i, len(t)] = t, cfg.vocab.eos
        tl[i] = len(t) + 1
    return (feats.numpy(), flens.numpy().astype(np.int32), ti, to, tl)


def run(trainer, batch, steps, every, params_np):
    """``trainer.fit`` for ``steps`` steps of ``batch``: the loss of each
    step and the flat params (numpy) at every ``every``-th."""
    losses, snaps, orig = [], {}, trainer._step_fn

    def rec(*a):
        out = orig(*a)
        losses.append(float(out[2]["loss"]))
        if len(losses) % every == 0:
            snaps[len(losses)] = params_np(out[0])
        return out

    trainer._step_fn = rec
    trainer.fit(lambda: iter([batch]), None, max_steps=steps)
    return losses, snaps


def main(steps=300, every=50):
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            train = dict(base_lr=1e-3, clip=1.0, ramp_up_iters=20,
                         epochs=steps, num_eval_steps=10 ** 6,
                         compute_dtype=dtype)
            cj = golden_cfg(jcfg).with_(
                "train", save_dir=os.path.join(tmp, "j" + dtype), **train)
            ct = golden_cfg(tcfg).with_(
                "train", save_dir=os.path.join(tmp, "t" + dtype), **train)
            nb = golden_batch(ct)
            pj = jlas.init_params(jax.random.PRNGKey(0), cj)
            jl, js = run(JTrainer(cj, pj), jstep.Batch(*map(jnp.asarray, nb)),
                         steps, every, lambda p: toptim.flatten(
                             jax.tree_util.tree_map(np.asarray, p)))
            tr = Trainer(ct, tlas.params_from_numpy(jax_params_numpy(pj)),
                         device="cpu")
            tl, ts = run(tr, TBatch(*map(torch.from_numpy, nb)), steps,
                         every, lambda p: {n: t.detach().numpy().copy()
                                           for n, t in
                                           toptim.flatten(p).items()})
            out[dtype] = dict(jax=jl, port=tl, jsnap=js, tsnap=ts)
    rows = {}
    for dtype, r in out.items():
        logged = sorted(r["jsnap"])
        rows[dtype] = dict(
            steps=logged,
            loss_jax=[r["jax"][s - 1] for s in logged],
            loss_port=[r["port"][s - 1] for s in logged],
            loss_gap=[abs(r["port"][s - 1] / r["jax"][s - 1] - 1)
                      for s in logged],
            max_loss_gap=max(abs(a / b - 1)
                             for a, b in zip(r["port"], r["jax"])),
            param_gap=[max(float(np.abs(r["tsnap"][s][n]
                                        - r["jsnap"][s][n]).max())
                           for n in r["jsnap"][s]) for s in logged])
    logged = rows["float32"]["steps"]
    for pkg, snap in (("jax", "jsnap"), ("port", "tsnap")):
        f32, bf16 = out["float32"], out["bfloat16"]
        rows[f"bf16_vs_f32_{pkg}"] = dict(
            loss_gap=[abs(bf16[pkg][s - 1] / f32[pkg][s - 1] - 1)
                      for s in logged],
            param_gap=[max(float(np.abs(bf16[snap][s][n]
                                        - f32[snap][s][n]).max())
                           for n in f32[snap][s]) for s in logged])
    for k, v in rows.items():
        print(json.dumps({k: v}), flush=True)
    return rows


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
