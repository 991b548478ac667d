"""Training CLI (port of ``chinese_asr_tpu/train/__main__.py``; the
reference's train loop and argparse are commented out, model.py:84-345,
main.py:107-120):

    python -m chinese_asr_tpu_torch.train \\
        --train-manifest train.tsv --eval-manifest dev.tsv \\
        --vocab dict.pkl --save-dir ./ckpt [--config cfg.json] \\
        [--bf16] [--remat] [--resume] [--max-steps N] [--device cpu]

    torchrun --nproc_per_node N -m chinese_asr_tpu_torch.train ... --mesh auto

Manifests are TSV lines of ``wav_path\\ttranscript``.  ``--vocab`` takes
the reference's ``dict.pkl`` or a plain word list; without it a character
vocab is built from the train manifest.  The features are made on the
device (``data.dataset.batches_to_device``, K1 on the card).  The device
defaults to ``cuda`` and the CLI raises without a GPU unless ``--device
cpu`` is given.  ``--bf16`` trains in mixed precision
(``train.compute_dtype="bfloat16"``: the forward and backward in bf16, the
master params, optimizer state and checkpoints float32).  ``--mesh
auto`` trains over a (data x model) mesh of every rank torchrun (or
``python -m torch.distributed.run``) starts, laid out by the config's
``mesh`` (``parallel/sharding.py``: NCCL with a card a rank, gloo when
ranks share a card or run on the CPU); the train loader then drops the
last, short batch, so every batch splits over the data axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_config(args):
    from ..config import Config

    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    train_over = {}
    for field, name in [("batch_size", "batch_size"), ("epochs", "epochs"),
                        ("base_lr", "lr"), ("save_dir", "save_dir"),
                        ("ss", "ss"), ("seed", "seed")]:
        v = getattr(args, name)
        if v is not None:
            train_over[field] = v
    if args.bf16:
        train_over["compute_dtype"] = "bfloat16"
    if args.remat:
        train_over["remat"] = True
    if train_over:
        cfg = cfg.with_("train", **train_over)
    if args.verbose:
        cfg = dataclasses.replace(cfg, verbose=True)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chinese_asr_tpu_torch.train",
        description="Train the LAS recognizer from wav manifests.")
    ap.add_argument("--train-manifest", required=True,
                    help="TSV: wav_path<TAB>transcript per line")
    ap.add_argument("--eval-manifest", default=None)
    ap.add_argument("--vocab", default=None,
                    help="dict.pkl / word list; default: build from the "
                         "train manifest's transcripts")
    ap.add_argument("--config", default=None, help="Config JSON file")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ss", type=float, default=None,
                    help="scheduled-sampling probability")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: forward and backward in bf16, "
                         "master params and optimizer state float32")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each decoder step in the backward")
    ap.add_argument("--mesh", default=None, choices=[None, "auto"],
                    help="train over a (data x model) mesh of the ranks "
                         "torchrun starts")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in save-dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .. import vocab as vocab_mod
    from ..data import dataset
    from ..models import las
    from ..utils.device import resolve_device
    from .trainer import Trainer

    cfg = build_config(args)
    device = resolve_device(None if args.device == "cuda" else args.device)

    if args.vocab:
        vocab = vocab_mod.Vocab.load(args.vocab)
    else:
        utts = dataset.read_manifest(args.train_manifest)
        vocab = vocab_mod.Vocab.build(
            (u.text for u in utts if u.text), cfg.vocab.max_num_words)
    if len(vocab) != cfg.vocab.vocab_size:
        cfg = cfg.with_("vocab", max_num_words=len(vocab) - 4)

    params = las.init_params(cfg, cfg.train.seed)
    tr = Trainer(cfg, params, vocab, device=device, mesh=args.mesh)
    mesh = tr.mesh
    if args.resume:
        tr.resume()

    def train_loader_fn():
        loader = dataset.make_train_loader(args.train_manifest, cfg, vocab,
                                           seed=cfg.train.seed,
                                           drop_last=mesh is not None)
        return dataset.batches_to_device(loader, cfg, tr.device)

    eval_loader_fn = None
    if args.eval_manifest:
        def eval_loader_fn():
            loader = dataset.make_eval_loader(args.eval_manifest, cfg, vocab)
            return dataset.batches_to_device(loader, cfg, tr.device)

    try:
        tv = tr.fit(train_loader_fn, eval_loader_fn,
                    max_steps=args.max_steps)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    if tr.rank == 0:
        print(f"done: step {tv.step} loss {tv.loss:.4f} "
              f"best_wer {tv.best_wer:.5f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
