"""Dataset-level evaluation (port of ``chinese_asr_tpu/evaluate.py``;
reference ``test_model``, model.py:1370-1443): decode a whole manifest
with greedy, beam or an LM mode, aggregate the CER, and compare modes.

The manifest goes through the eval loader's padded batches
(``wav_bucket=4800``) and ``featurize_batch`` on the device of the
params, as the JAX harness does, so its CER is comparable with JAX's.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import torch

from .config import Config
from .data import dataset as ds_mod
from .decode import beam as beam_mod
from .decode import greedy as greedy_mod
from .decode import lm_fused
from .decode import rescore as rescore_mod
from .lm import ngram
from .lm.device_ngram import DeviceNgramLM
from .ops.metrics import batch_cer
from .parallel import sharding
from .vocab import Vocab


def _device_lm(lm, device) -> DeviceNgramLM:
    """A path, a DeviceNgramLM or an NgramLM -> the device tables on
    ``device``."""
    if isinstance(lm, DeviceNgramLM):
        return lm.to(device)
    if isinstance(lm, ngram.NgramLM):
        return (DeviceNgramLM.from_arpa(lm.path, device)
                if lm._py is not None else DeviceNgramLM.from_lm(lm, device))
    return DeviceNgramLM.from_path(lm, device)


@torch.no_grad()
def evaluate_manifest(params, cfg: Config, vocab: Vocab, manifest_path: str,
                      bw: Optional[int] = None, lm=None,
                      lm_mode: str = "second", topn: int = 20,
                      verbose: bool = True, mesh=None) -> Dict:
    """Returns {"cer", "n", "pred", "ref", "seconds", "utts_per_sec"}.

    Decodes on the device of ``params``.  ``lm_mode``: "second" (default)
    rescores the acoustic n-best on the device (reference model.py:
    749-763 semantics; ``decode/rescore.py``); "second_host" uses the
    host scorer (reference model.py:755; ``lm`` must then be an
    NgramLM); "first" runs the LM-driven first pass on the device
    (``decode/lm_fused.py``).  For the device modes ``lm`` may be an
    ARPA/.klm path, a DeviceNgramLM or an NgramLM.  The features are made
    in float32 and cast to the dtype of the params' floating leaves, as
    ``ASR(compute_dtype=...)`` casts them, so the params of a bf16 ASR
    decode in bf16.

    One device decodes through the ``*_jit`` forms (CUDA graphs on the
    card, ``utils/graphs.py``).  On a mesh (``mesh``; ``params`` this
    rank's shard, as an ``ASR(mesh=)``'s) every rank reads the whole
    manifest, decodes its rows of each batch through the eager functions
    and returns the whole CER."""
    dev = params["decoder"]["embedding"].device
    dtype = params["decoder"]["embedding"].dtype
    dlm = tok2lm = None
    if lm is not None and lm_mode in ("first", "second") and bw and bw > 1:
        dlm = _device_lm(lm, dev)
        tok2lm = torch.from_numpy(dlm.token_id_table(vocab)).to(dev,
                                                                torch.int64)
        lm_bos, lm_eos = (int(x) for x in dlm.word_ids(["<s>", "</s>"]))
    dcfg = cfg.decode
    loader = ds_mod.make_eval_loader(manifest_path, cfg, vocab)
    preds: List[str] = []
    refs: List[str] = []
    t0 = time.perf_counter()
    for b in ds_mod.batches_to_device(loader, cfg, dev):
        feats, feat_lens = b.feats.to(dtype), b.feat_lens
        # one device->host copy per batch for the reference token rows
        to_np = b.tokens_out.cpu().numpy()
        tl_np = b.text_lens.cpu().numpy()
        text = [to_np[i, : tl_np[i] - 1].tolist() for i in range(len(tl_np))]
        B = feats.shape[0]
        feats, feat_lens = sharding.pad_shard_rows(mesh, feats, feat_lens)

        def whole(res):             # the whole batch's rows, on every rank
            return sharding.trim_rows(sharding.gather_rows(res, mesh), B)

        # one device: the *_jit forms, as JAX's evaluate.py; a mesh: the
        # eager functions
        if not bw or bw <= 1:
            res = (greedy_mod.greedy_decode_jit(params, cfg, feats, feat_lens)
                   if mesh is None else whole(greedy_mod.greedy_decode(
                       params, cfg, feats, feat_lens, mesh)))
            out = greedy_mod.finalize_greedy(res, vocab, text=text)
        elif dlm is not None and lm_mode == "first":
            best = (lm_fused.lm_fused_decode_best_jit(
                params, cfg, bw, feats, feat_lens, dlm, tok2lm, topn)
                if mesh is None else sharding.trim_rows(
                    lm_fused.lm_fused_decode_best(
                        params, cfg, bw, feats, feat_lens, dlm, tok2lm, topn,
                        mesh), B))
            out = beam_mod.finalize_best(best, vocab, text=text)
        else:
            res = (beam_mod.beam_decode_jit(params, cfg, bw, feats, feat_lens)
                   if mesh is None else whole(beam_mod.beam_decode(
                       params, cfg, bw, feats, feat_lens, mesh=mesh)))
            if dlm is not None:
                select = (rescore_mod.rescore_select_jit if mesh is None
                          else rescore_mod.rescore_select)
                best = select(beam_mod.compact_nbest(res), dlm, tok2lm,
                              dcfg.lm_weight, dcfg.length_weight, lm_bos,
                              lm_eos)
                out = beam_mod.finalize_best(best, vocab, text=text)
            else:
                out = beam_mod.finalize_beam(
                    res, cfg, vocab, text=text, lm_model=lm,
                    second_pass=lm is not None, lm_weight=dcfg.lm_weight,
                    length_weight=dcfg.length_weight)
        preds.extend(out.pred_text)
        refs.extend(out.text)
        if verbose:
            print(f"  {len(preds)} utts, running CER "
                  f"{batch_cer(preds, refs):.5f}", file=sys.stderr)
    dt = time.perf_counter() - t0
    return {
        "cer": batch_cer(preds, refs),
        "n": len(preds),
        "pred": preds,
        "ref": refs,
        "seconds": dt,
        "utts_per_sec": len(preds) / dt if dt > 0 else float("inf"),
    }


def compare_modes(params, cfg: Config, vocab: Vocab, manifest_path: str,
                  beam_widths=(4,), lm=None) -> Dict[str, Dict]:
    """Greedy vs beam at several widths (the reference's beam-vs-greedy
    comparison, model.py:1420-1441)."""
    out = {"greedy": evaluate_manifest(params, cfg, vocab, manifest_path,
                                       verbose=False)}
    for bw in beam_widths:
        out[f"beam{bw}"] = evaluate_manifest(params, cfg, vocab,
                                             manifest_path, bw=bw, lm=lm,
                                             verbose=False)
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="evaluate a manifest (CER)")
    ap.add_argument("--manifest", required=True, help="path<TAB>text file")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--vocab", default=None, help="dict.pkl")
    ap.add_argument("--bw", type=int, default=None)
    ap.add_argument("--lm", default=None, help="n-gram LM (ARPA or .klm)")
    ap.add_argument("--lm-mode", default="second",
                    choices=("second", "second_host", "first"),
                    help="second: n-best rescore on the device; "
                         "second_host: n-best rescore on the host; first: "
                         "the LM-driven first pass on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from .api import ASR
    asr = ASR(ckpt_path=args.ckpt, vocab=args.vocab, device=args.device)
    use_lm = args.lm if args.bw and args.bw > 1 else None
    lm = ngram.load_lm(use_lm) if args.lm_mode == "second_host" else use_lm
    res = evaluate_manifest(asr.params, asr.cfg, asr.vocab, args.manifest,
                            bw=args.bw, lm=lm, lm_mode=args.lm_mode)
    print(f"cer={res['cer']:.5f} n={res['n']} "
          f"utts/s={res['utts_per_sec']:.2f}")


if __name__ == "__main__":
    main()
