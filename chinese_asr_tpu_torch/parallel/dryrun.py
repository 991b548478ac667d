"""Multi-device dry run (the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip``): spawn ``n`` ranks sharing the card (or, asked for,
gloo on the CPU), build a (n/2 x 2) mesh (n x 1 for odd n) at a narrow
width whose vocab (V = 16) splits over the model axis, and check on
every rank that
the sharded programs equal the single-device ones on the same inputs: the
beam decode (bw 2), the LM-driven first pass (``lm_fused``), the device
second-pass rescore (``rescore_select`` and ``beam_rescored_best``), and
the f32 and bf16 train steps.  Prints one line of the shape of JAX's:

    python -m chinese_asr_tpu_torch.parallel.dryrun [--ranks 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rank(n: int, device_type: str) -> str:
    import torch

    from ..api import _identity_vocab
    from ..config import Config
    from ..data.dataset import Batch
    from ..decode import beam, lm_fused, rescore
    from ..lm.device_ngram import DeviceNgramLM
    from ..models import las
    from ..train import optim, step as step_mod
    from ..utils.device import resolve_device
    from . import sharding

    mp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // mp
    cfg = (Config()
           .with_("audio", n_mels=8, delta_delta=False, downsample=False)
           .with_("encoder", hidden_size=16, num_layers=2)
           .with_("decoder", hidden_size=32, embed_dim=12)
           .with_("attention", attn_size=8)
           .with_("vocab", max_num_words=12)    # V=16: splits on mp=2
           .with_("mesh", data_parallel=dp, model_parallel=mp))
    mesh = sharding.make_mesh(cfg, device_type)
    dev = resolve_device("cpu" if device_type == "cpu" else None)
    # seed 21: random weights whose beams emit eos (289 finished slots in
    # 7 of the 8 rows at n=8), so the n-best harvest check has content
    params = las.init_params(cfg, 21, dev)
    sp = sharding.shard_params(params, cfg, mesh)

    B, T, S = 2 * dp, 9, 6
    rng = np.random.RandomState(0)
    feats = torch.tensor(rng.randn(B, T, cfg.audio.feat_dim)
                         .astype(np.float32), device=dev)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    text = rng.randint(4, cfg.vocab.vocab_size, size=(B, S - 1))
    batch = Batch(feats, lens, *(torch.tensor(a.astype(np.int32), device=dev)
                                 for a in (
        np.concatenate([np.full((B, 1), cfg.vocab.sos), text], 1),
        np.concatenate([text, np.full((B, 1), cfg.vocab.eos)], 1),
        np.full(B, S))))
    rows = sharding.row_slice(B, mesh)

    def close(a, b, what):
        np.testing.assert_allclose(b.float().cpu().numpy(),
                                   a.float().cpu().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=what)

    def equal(a, b, what):
        np.testing.assert_array_equal(b.cpu().numpy(), a.cpu().numpy(),
                                      err_msg=what)

    bw = 2
    r1 = beam.beam_decode(params, cfg, bw, feats, lens)
    r2 = sharding.gather_rows(beam.beam_decode(sp, cfg, bw, feats[rows],
                                               lens[rows], mesh=mesh), mesh)
    equal(r1.live_tokens, r2.live_tokens, "beam live_tokens")
    equal(r1.fin_count, r2.fin_count, "beam fin_count")
    close(r1.fin_scores, r2.fin_scores, "beam fin_scores")
    n_fin = int(r2.fin_count.sum())

    vocab = _identity_vocab(cfg.vocab.vocab_size)
    words = [vocab.int2word[i] for i in range(4, cfg.vocab.vocab_size)]
    arpa_lines = (["\\data\\", f"ngram 1={len(words) + 3}", "",
                   "\\1-grams:", "-2.5\t<unk>", "-2.0\t<s>", "-0.8\t</s>"]
                  + [f"{-0.5 - 0.1 * i}\t{w}" for i, w in enumerate(words)]
                  + ["", "\\end\\", ""])
    with tempfile.TemporaryDirectory() as tmp:
        arpa = os.path.join(tmp, "unigram.arpa")
        with open(arpa, "w", encoding="utf-8") as f:
            f.write("\n".join(arpa_lines))
        dlm = DeviceNgramLM.from_path(arpa, dev)
    tok2lm = torch.from_numpy(dlm.token_id_table(vocab)).to(dev, torch.int64)
    f1 = lm_fused.lm_fused_decode(params, cfg, bw, feats, lens, dlm, tok2lm,
                                  topn=8)
    f2 = sharding.gather_rows(lm_fused.lm_fused_decode(
        sp, cfg, bw, feats[rows], lens[rows], dlm, tok2lm, 8, mesh), mesh)
    equal(f1.live_tokens, f2.live_tokens, "lm_fused live_tokens")
    close(f1.fin_scores, f2.fin_scores, "lm_fused fin_scores")
    n_lm_fin = int(f2.fin_count.sum())

    bos, eos = (int(x) for x in dlm.word_ids(["<s>", "</s>"]))
    w_lm, w_len = cfg.decode.lm_weight, cfg.decode.length_weight
    b1 = rescore.rescore_select(beam.compact_nbest(r1), dlm, tok2lm, w_lm,
                                w_len, bos, eos)
    b2 = rescore.rescore_select(beam.compact_nbest(r2), dlm, tok2lm, w_lm,
                                w_len, bos, eos)
    equal(b1.tokens, b2.tokens, "rescore tokens")
    close(b1.scores, b2.scores, "rescore scores")
    t1 = rescore.beam_rescored_best(params, cfg, bw, feats, lens, dlm,
                                    tok2lm, w_lm, w_len, bos, eos)
    t2 = rescore.beam_rescored_best(sp, cfg, bw, feats[rows], lens[rows],
                                    dlm, tok2lm, w_lm, w_len, bos, eos, mesh)
    equal(t1.tokens, t2.tokens, "beam_rescored_best tokens")
    close(t1.scores, t2.scores, "beam_rescored_best scores")

    losses = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.with_("train", compute_dtype=dtype)
        tx = optim.make_optimizer(c.train)
        p1, _, m1 = step_mod.train_step(params, tx.init(params), c, tx, batch)
        p2, _, m2 = step_mod.train_step(
            sp, tx.init(sp), c, tx, sharding.shard_batch(batch, c, mesh),
            None, mesh)
        loss = float(m2["loss"])
        _check(np.isfinite(loss), f"{dtype}: non-finite loss {loss}")
        np.testing.assert_allclose(loss, float(m1["loss"]),
                                   rtol=1e-5 if dtype == "float32" else 1e-2,
                                   err_msg=f"{dtype} loss")
        _check(all(t.dtype == torch.float32 for t in las.tree_leaves(p2)),
               f"{dtype}: master params not float32")
        if dtype == "float32":
            full = optim.flatten(sharding.unshard_params(p2, c, mesh))
            for name, t in optim.flatten(p1).items():
                np.testing.assert_allclose(full[name].cpu().numpy(),
                                           t.cpu().numpy(), rtol=2e-4,
                                           atol=2e-5, err_msg=name)
        losses[dtype] = loss
    _check(abs(losses["bfloat16"] - losses["float32"]) < 0.1,
           f"bf16 loss {losses['bfloat16']} far from f32 {losses['float32']}")
    return (f"dryrun_multichip ok: mesh=({dp}x{mp}) "
            f"loss={losses['float32']:.4f} "
            f"bf16_loss={losses['bfloat16']:.4f} beam_decode ok (bw={bw}, "
            f"{n_fin} finished hyps, sharded == single-device) lm_fused ok "
            f"({n_lm_fin} finished hyps, sharded == single-device) "
            f"device_rescore ok (sharded == single-device)")


def dryrun_multichip(n: int = 8, device_type: str = "cuda",
                     timeout_s: float = 600.0) -> str:
    """Run the dry run on ``n`` ranks sharing the card (``device_type=
    "cpu"``: on the CPU); print and return its line.  Raises when any
    rank's check fails, and without a GPU unless the CPU is asked for."""
    from ..utils.device import resolve_device
    from .launch import run_ranks

    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type={device_type!r}: cpu or cuda")
    if device_type == "cuda":
        resolve_device(None)            # raises when no GPU is present

    line = run_ranks(_rank, n, args=(n, device_type), device_type=device_type,
                     timeout_s=timeout_s,
                     threads=1 if device_type == "cpu" else 0)[0]
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chinese_asr_tpu_torch.parallel.dryrun",
        description="Sharded == single-device on a spawned mesh.")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default; raises without a GPU): every rank "
                         "shares the card(s); cpu: gloo on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
