"""The compiled train step's memory over one epoch's mix of keys, on one
card.

    python3 -m chinese_asr_tpu_torch.tools.step_memory [--keys N]
        [--dtype float32|bfloat16] [--orders loader,shuffled,largest_first]
        [--budget F] [--out FILE]

The corpus is a model of AISHELL-1's training set (120,098 utterances,
about 150 h: ``SURVEY.md``): durations log-normal around 4.2 s, cut to
1.2-14.5 s; 3.3 characters a second with noise, cut to 1-44.  The
loader's own order (``data/dataset.py`` ``train_sampler_order``: shuffled,
then sorted by length in windows of ``shuffle_updates`` batches) and its
padding (4,800-sample wav buckets, 8-token text buckets, the remainder
batch) give each batch of one epoch its key: (rows, samples, tokens).

Each distinct key then takes one step of ``Trainer`` at the flagship
``Config()`` (``batch_size`` 256, seed-0 random weights) on the card, on
seeded noise wavs featurized there and random targets: the first step of
a key captures its graph (``train/step.py`` ``CompiledStep``,
``utils/graphs.py`` ``StepGraphs``).  The keys come in the order the
epoch first meets them ("loader": the first window's batches short to
long), shuffled, or longest first ("largest_first": the first capture is
the largest key's need alone).  After each step it records the pool's
bytes, the static input buffers' bytes, the card's reserved and
allocated bytes, the resets and the capture's ms.  ``--budget`` sets the graphs' byte
budget as a share of the card (by default ``StepGraphs``'s own); a
budget of 0 measures the pool with no bound, and then a sweep stops
before the card holds 85 % of its memory.

Prints the card's name and power limit, the epoch's key statistics, one
JSON line a sweep; with ``--out`` also every step's record.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

UTTERANCES = 120_098            # AISHELL-1's training set (SURVEY.md)
MEDIAN_S, SIGMA = 4.2, 0.35     # the duration model, log-normal
MIN_S, MAX_S = 1.2, 14.5
CHARS_PER_S = 3.3
RATE = 16000
STOP_SHARE = 0.85               # an unbounded sweep stops past this


def corpus(seed: int = 0):
    """(samples, characters) of every utterance of the corpus model."""
    import numpy as np
    rng = np.random.RandomState(seed)
    secs = np.clip(np.exp(np.log(MEDIAN_S) + SIGMA
                          * rng.randn(UTTERANCES)), MIN_S, MAX_S)
    chars = np.clip(np.round(secs * CHARS_PER_S
                             * np.exp(0.2 * rng.randn(UTTERANCES))), 1, 44)
    return (secs * RATE).astype(np.int64), chars.astype(np.int64)


def epoch_keys(cfg, samples, chars, seed: int = 0,
               wav_bucket: int = 4800, text_bucket: int = 8) -> list:
    """The key (rows, padded samples, padded tokens) of every batch of one
    epoch, in the loader's order (``data/dataset.py`` ``Loader``)."""
    import numpy as np
    from chinese_asr_tpu_torch.data.dataset import (round_up,
                                                    train_sampler_order)
    b = cfg.train.batch_size
    order = train_sampler_order(samples, b, cfg.train.shuffle_updates,
                                np.random.RandomState(seed))
    out = []
    for s in range(0, len(order), b):
        idx = order[s:s + b]
        out.append((len(idx), round_up(int(samples[idx].max()), wav_bucket),
                    round_up(int(chars[idx].max()) + 1, text_bucket)))
    return out


def make_batch(torch, cfg, key, dev, seed: int):
    """A batch of the key's shapes on ``dev``: seeded noise wavs of
    lengths up to the padded one, featurized there, and random targets."""
    from chinese_asr_tpu_torch.audio import features
    from chinese_asr_tpu_torch.data.dataset import Batch
    B, N, S = key
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(max(1, N - 4800) + 1, N + 1, (B,), generator=g,
                         device=dev, dtype=torch.int32)
    lens[0] = N
    wav = 0.1 * torch.randn((B, N), generator=g, device=dev)
    wav = wav * (torch.arange(N, device=dev)[None, :] < lens[:, None])
    feats, flens = features.featurize_batch(wav, lens, cfg.audio)
    V = cfg.vocab.vocab_size
    text = torch.randint(4, V, (B, S), generator=g, device=dev,
                         dtype=torch.int32)
    tl = torch.randint(max(1, S - 8) + 1, S + 1, (B,), generator=g,
                       device=dev, dtype=torch.int32)
    tl[0] = S
    pos = torch.arange(S, device=dev)[None, :]
    to = torch.where(pos < tl[:, None] - 1, text,
                     torch.where(pos == tl[:, None] - 1, cfg.vocab.eos,
                                 cfg.vocab.pad)).to(torch.int32)
    ti = torch.cat([torch.full((B, 1), cfg.vocab.sos, device=dev,
                               dtype=torch.int32), to[:, :-1]], 1)
    ti = torch.where(pos < tl[:, None], ti, cfg.vocab.pad).to(torch.int32)
    return Batch(feats, flens, ti, to, tl)


def sweep(torch, cfg, keys, dev, budget) -> dict:
    """One step a key through a new ``Trainer``'s compiled step; the
    records after each and the sweep's summary."""
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train.trainer import Trainer
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.empty_cache()
    tr = Trainer(cfg, las.init_params(cfg, 0), None, device=dev)
    g = tr._step_fn.graphs
    g.budget_fraction = budget if budget > 0 else math.inf
    base = torch.cuda.memory_reserved(dev)
    rows, stop = [], None
    for i, key in enumerate(keys):
        if (budget <= 0
                and torch.cuda.memory_reserved(dev) > STOP_SHARE * total):
            stop = f"the card held over {STOP_SHARE:.0%} before key {i}"
            break
        batch = make_batch(torch, cfg, key, dev, seed=i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            loss = float(tr._step_fn(tr.params, tr.opt_state, batch,
                                     None)[2]["loss"])
        except torch.cuda.OutOfMemoryError as e:
            stop = f"out of memory at key {i} {key}: {str(e)[:200]}"
            break
        ms = (time.perf_counter() - t) * 1e3
        key_input_bytes = sum(x.numel() * x.element_size() for x in batch)
        del batch
        newest = g.programs()[-1][1]        # this key's program
        rows.append(dict(
            key=list(key), key_input_bytes=key_input_bytes, loss=loss,
            step_ms=ms, capture_bytes=(newest.reserved_bytes
                                       if newest.replays == 1 else 0),
            captures=g.captures,
            resets=g.resets, pool_bytes=g.pool_bytes,
            input_bytes=g.input_bytes(),
            reserved_bytes=torch.cuda.memory_reserved(dev) - base,
            allocated_bytes=torch.cuda.memory_allocated(dev)))
    out = dict(keys=len(rows), captures=g.captures, resets=g.resets,
               pool_bytes=g.pool_bytes, input_bytes=g.input_bytes(),
               peak_pool_bytes=max((r["pool_bytes"] for r in rows),
                                   default=0),
               peak_reserved_bytes=max((r["reserved_bytes"] for r in rows),
                                       default=0),
               largest_capture_bytes=max(
                   (r["capture_bytes"] for r in rows), default=0),
               largest_key_input_bytes=max(
                   (r["key_input_bytes"] for r in rows), default=0),
               capture_ms=g.capture_ms, budget=budget if budget > 0 else None,
               stopped=stop, finite=all(math.isfinite(r["loss"])
                                        for r in rows))
    del tr, g
    torch.cuda.empty_cache()
    return dict(summary=out, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=0,
                    help="the first N keys of each order (0: all)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--orders", default="loader,shuffled")
    ap.add_argument("--budget", type=float, default=None,
                    help="the graphs' budget, a share of the card; 0: none")
    ap.add_argument("--out", default=None, help="write every record here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.utils import graphs
    from chinese_asr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    cfg = Config().with_("train", compute_dtype=args.dtype, save_dir=os.path
                         .join(os.environ.get("TMPDIR", "/tmp"), "step_mem"))
    samples, chars = corpus()
    batches = epoch_keys(cfg, samples, chars)
    first = list(dict.fromkeys(batches))
    stats = dict(utterances=UTTERANCES, batches=len(batches),
                 keys=len(first), wav_buckets=len({k[1] for k in first}),
                 text_buckets=len({k[2] for k in first}),
                 batch_rows=sorted({k[0] for k in first}),
                 seconds=[float(samples.min()) / RATE,
                          float(np.median(samples)) / RATE,
                          float(samples.max()) / RATE],
                 chars=[int(chars.min()), float(np.median(chars)),
                        int(chars.max())])
    print(f"epoch: {json.dumps(stats)}", flush=True)
    budget = (graphs.STEP_BUDGET_FRACTION if args.budget is None
              else args.budget)
    orders = {"loader": first,
              "shuffled": [first[i] for i in
                           np.random.RandomState(1).permutation(len(first))],
              "largest_first": sorted(first, key=lambda k: (-k[1], -k[2],
                                                            -k[0]))}
    report = dict(gpu=gpu, dtype=args.dtype, epoch=stats, sweeps={})
    for name in args.orders.split(","):
        keys = orders[name][:args.keys or None]
        res = sweep(torch, cfg, keys, dev, budget)
        report["sweeps"][name] = res
        print(f"{name} ({args.dtype}, budget {budget}): "
              f"{json.dumps(res['summary'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
