"""Offline transcription: the window calls ``ASR.transcribe_wavs`` again
and again on one corpus made from the seed, as a batch transcriber
does.  Each call sorts the corpus by length and runs its chunks of
``max_batch`` in the dispatch-ahead order of the program.

Host spans wrap the program's bound methods (``_prep``, ``_upload``,
``_featurize``, ``_decode_dispatch``, ``_decode_finalize``); the
finalize's span also keeps what the call produced for each row: the
winning hypothesis's tokens, its score and whether it ended with eos, as
the program hands them to its detokenizer, and the transcript it
returned.  After the window a sample of those rows, drawn from the seed
with the longest utterance in it, is judged by the plain reference: the
score of each served hypothesis, and whether the reference's own beam
search finds a better one.
"""

from __future__ import annotations

import gc
import json
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import encoders
from port_bench.lib import trace, traffic, weights
from port_bench.reference import las as ref

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SECTIONS = ("audio", "vocab", "encoder", "attention", "decoder", "decode",
             "train")


def port_config(cfg: dict):
    """The program's ``Config`` for a configuration file."""
    from chinese_asr_tpu_torch.config import Config
    return Config.from_json(json.dumps({k: cfg[k] for k in _SECTIONS
                                        if k in cfg}))


def set_precision(cfg: dict) -> None:
    """The configuration's matmul precision: TF32 as it states."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.set_float32_matmul_precision("high" if cfg["tf32"] else "highest")


class Parts:
    """Seconds of each part of the set-up, for standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: List[tuple] = []

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.parts.append((name, t - self.t))
        self.t = t

    def line(self) -> str:
        return "set-up parts (s): " + ", ".join(f"{n} {s:.2f}"
                                               for n, s in self.parts)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cell: dict, cfg: dict, mix: dict, seed: int,
                 device: str = "cuda"):
        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        encoders.of(cfg)        # no family module: stop before set-up
        self.device = torch.device(device)
        self.spans = trace.Spans()
        self.calls: List[dict] = []          # per completed call
        self._call: Dict = None
        self.parts = Parts()

    # ---- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from chinese_asr_tpu_torch.api import ASR
        cfg, mix = self.cfg, self.mix
        set_precision(cfg)
        mark = self.parts.mark
        self.wavs, self.secs = traffic.corpus(mix, self.seed, self.device)
        self.index = {id(w): i for i, w in enumerate(self.wavs)}
        mark("corpus")
        self.params = weights.make_params(cfg, self.seed, self.device)
        dtype = _DTYPES[cfg["precision"]]
        self.served = weights.served(self.params, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mark("weights")
        asr = ASR(bw=cfg["beam_width"], cfg=port_config(cfg),
                  compute_dtype=cfg["precision"], wire=mix["wire"],
                  device=self.device)
        asr.params = self.served
        mark("program")
        self.asr = asr
        sp = self.spans
        sp.wrap(asr, "_prep", "bench.prep", after=self._on_prep)
        sp.wrap(asr, "_upload", "bench.upload", after=self._on_upload)
        sp.wrap(asr, "_featurize", "bench.featurize")
        sp.wrap(asr, "_decode_dispatch", "bench.dispatch")
        sp.wrap(asr, "_decode_finalize", "bench.finalize",
                after=self._on_finalize)
        # every key the corpus makes is captured by the first call; the
        # second must capture none
        self.call()
        mark("first call")
        self.call()
        mark("second call")
        self.calls.clear()

    def _on_prep(self, a, kw, out):
        self._call["chunks"].append(
            {"rows": [self.index[id(w)] for w in a[0]]})

    def _on_upload(self, a, kw, out):
        for c in self._call["chunks"]:
            if "N" not in c:
                c["N"] = int(out.N)
                break

    def _on_finalize(self, a, kw, out):
        res = a[0]
        best = res.res if hasattr(res, "ready") else res
        chunk = self._call["chunks"][self._call["done"]]
        chunk.update(tokens=best.tokens.cpu().numpy().copy(),
                     lens=best.lens.cpu().numpy().copy(),
                     scores=best.scores.cpu().numpy().copy(),
                     finished=best.finished.cpu().numpy().copy())
        self._call["done"] += 1

    def call(self) -> dict:
        self._call = {"chunks": [], "done": 0}
        texts = self.asr.transcribe_wavs(self.wavs,
                                         max_batch=self.mix["max_batch"])
        self._call["texts"] = texts
        self.calls.append(self._call)
        return self._call

    # ---- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        from chinese_asr_tpu_torch.utils import graphs
        caps = graphs.captures
        t0 = time.perf_counter()
        ends = []
        while True:
            self.call()
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        sync(self.device)
        t = time.perf_counter()
        n = len(self.calls)
        return {"seconds": t - t0, "calls": n,
                "call_s": list(np.diff([t0] + ends)),
                "audio_s": n * float(self.secs.sum()),
                "attempted": n * len(self.wavs), "failed": 0,
                "captures": graphs.captures - caps}

    def traced(self, counters: dict) -> dict:
        """The fullest trace of one call, with the shapes of its chunks."""
        def one():
            self.calls.clear()
            c = self.call()
            return [{"lens": [len(self.wavs[i]) for i in ch["rows"]],
                     "N": ch["N"]} for ch in c["chunks"]]
        s = trace.fullest(one, self.spans, counters)
        s["window"] = {"attempted": len(self.wavs), "failed": 0}
        return s

    def notes(self, rec: dict) -> List[str]:
        """Lines for standard error: captures inside the window, and the
        trace's kernel counts against the launch counters."""
        out = [self.parts.line()]
        if "call_s" in rec["window"]:
            out.append("calls of the window (s): " + " ".join(
                f"{c:.3f}" for c in rec["window"]["call_s"]))
        caps = rec["window"].get("captures", 0)
        if caps:
            out.append(f"note: {caps} program(s) captured inside the window")
        if "trace" in rec:
            out += trace.count_notes(rec["trace"], rec["kernels"])
        return out

    def release(self) -> None:
        from chinese_asr_tpu_torch.utils import graphs
        self.asr = None
        graphs.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness ----------------------------------------------------
    def sample(self, n: int) -> List[tuple]:
        """(call, row) pairs: the longest utterance and ``n`` - 1 others,
        drawn from the seed, each from a call drawn from the seed."""
        r = traffic.rng(self.seed, 3)
        longest = int(np.argmax([len(w) for w in self.wavs]))
        others = [i for i in r.permutation(len(self.wavs)) if i != longest]
        rows = [longest] + [int(i) for i in others[:n - 1]]
        return [(int(r.integers(len(self.calls))), i) for i in rows]

    def produced(self, call: int, row: int) -> dict:
        c = self.calls[call]
        for ch in c["chunks"]:
            if row in ch["rows"]:
                j = ch["rows"].index(row)
                n = int(ch["lens"][j])
                return {"tokens": ch["tokens"][j, :n].tolist(),
                        "score": float(ch["scores"][j]),
                        "finished": bool(ch["finished"][j]),
                        "text": c["texts"][row]}
        raise KeyError(row)

    def check(self, precision: str = "float32") -> Dict[str, float]:
        """The sampled rows judged by the reference (``precision``: its
        arithmetic; the benchmark's runs judge in float32)."""
        picks = self.sample(self.cell["check"]["sample"])
        got = [self.produced(c, i) for c, i in picks]
        as_served = weights.tree_map(lambda t: t.float(), self.served)
        return judge(self.cfg, as_served, [self.wavs[i] for _, i in picks],
                     got, self.device, precision)


def judge(cfg: dict, params: dict, wavs, got: List[dict], device,
          precision: str = "float32") -> Dict[str, float]:
    """The numbers compared for served hypotheses ``got`` (tokens, score,
    finished, text) of utterances ``wavs``: the widest gap between a
    reported score and the reference's score of the same hypothesis
    (``score_gap``); the widest margin by which the reference's own beam
    search over the same utterances finds a better hypothesis than the
    one served, both scored by the reference (``best_gap``, 0 where it
    finds none better); and the transcripts that are not the
    hypothesis's tokens (``text_mismatch``); ``hyp_mismatch``, the share
    of rows whose served tokens are not those the reference's beam
    chose.  A
    cell compares those of these numbers that it gives a limit.

    ``best_gap`` and ``hyp_mismatch`` take the rows where neither the served hypothesis nor
    the reference's ended with eos.  A finished hypothesis wins by its
    raw log-probability, so one harvested a step earlier or later wins
    by a whole token's score: whether eos entered the top k at a near
    tie decides that, not the selection.  Those rows are judged by
    ``score_gap`` alone."""
    prec = ref.Precision(precision)
    voc, dec = cfg["vocab"], cfg["decode"]
    lw = dec["length_weight"]
    with torch.no_grad(), prec.active():
        feats = [ref.features(w, cfg["audio"], prec, device) for w in wavs]
        enc, lens, state = ref.encode(prec, params, feats, cfg)
        searched = ref.beam_search(prec, params, enc, lens, state,
                                   cfg["beam_width"], dec["max_len"],
                                   voc["sos"], voc["eos"], lw)
        hyps = [g["tokens"] for g in got] + [t for t, _, _ in searched]
        fin = [g["finished"] for g in got] + [f for _, f, _ in searched]
        scores = ref.teacher_forced(
            prec, params, torch.cat([enc, enc]), torch.cat([lens, lens]),
            tuple(torch.cat([x, x]) for x in state), hyps, fin, voc["sos"],
            voc["eos"])
    want = ref.served_score(scores, hyps, fin, lw)
    served, best = want[:len(got)], want[len(got):]
    score_gap = max(abs(g["score"] - w) for g, w in zip(got, served))
    live = [(b - w, g["tokens"] != t) for b, w, g, (t, f, _) in
            zip(best, served, got, searched) if not g["finished"] and not f]
    best_gap = max([0.0] + [gap for gap, _ in live])
    texts = sum(g["text"] != ref.detokenize(g["tokens"], voc["specials"])
                for g in got)
    return {"score_gap": float(score_gap), "best_gap": float(best_gap),
            "hyp_mismatch": sum(m for _, m in live) / max(len(live), 1),
            "text_mismatch": float(texts)}


def control(cell: dict, cfg: dict, mix: dict, seed: int, precision: str,
            device="cuda") -> Dict[str, float]:
    """The control of a cell: the reference put in the program's place,
    computed in ``precision``, over the chunks of 128 (``max_batch``) that
    hold the rows a run would sample, then judged as a run judges the
    program."""
    dev = torch.device(device)
    d = Driver(cell, cfg, mix, seed, device=dev)
    d.wavs, d.secs = traffic.corpus(mix, seed, dev)
    params = weights.make_params(cfg, seed, dev)
    as_served = weights.tree_map(
        lambda t: t.to(_DTYPES[cfg["precision"]]).float(), params)
    d.calls = [None]
    rows = [i for _, i in d.sample(cell["check"]["sample"])]
    order = sorted(range(len(d.wavs)), key=lambda i: len(d.wavs[i]))
    mb = mix["max_batch"]
    chunks = [order[s:s + mb] for s in range(0, len(order), mb)]
    prec = ref.Precision(precision)
    voc = cfg["vocab"]
    got = {}
    with torch.no_grad(), prec.active():
        for ch in chunks:
            if not set(ch) & set(rows):
                continue
            feats = [ref.features(d.wavs[i], cfg["audio"], prec, dev)
                     for i in ch]
            enc, lens, state = ref.encode(prec, as_served, feats, cfg)
            out = ref.beam_search(prec, as_served, enc, lens, state,
                                  cfg["beam_width"], cfg["decode"]["max_len"],
                                  voc["sos"], voc["eos"],
                                  cfg["decode"]["length_weight"])
            for i, (toks, fin, sc) in zip(ch, out):
                got[i] = {"tokens": toks, "finished": fin, "score": sc,
                          "text": ref.detokenize(toks, voc["specials"])}
    return judge(cfg, as_served, [d.wavs[i] for i in rows],
                 [got[i] for i in rows], dev)
