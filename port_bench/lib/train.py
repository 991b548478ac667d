"""Training: the window drives ``Trainer.fit`` (one ``CompiledStep``
graph replay a step on the card) over a fixed set of batches cut from a
length-sorted corpus made from the seed, cycled, each batch one (T, S)
key.  The batches reach the trainer through the program's own device
loader (``data/dataset.py`` ``batches_to_device``: the host batch
uploaded, featurized by ``featurize_batch_jit`` with K1 inside);
evaluation and checkpoints are off.

Set-up builds the one trainer the window uses and drives it through one
pass of the batches, which captures every key.  The pass starts with the
longest batch, a middle one and the shortest; those first three steps
are kept for the reference: their losses, the Adam first moment after
step one (the first gradient as the optimizer got it) and the parameters
after step three.  The reference repeats those three steps from the same
weights on the same batches.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import encoders
from port_bench.lib import trace, traffic, weights
from port_bench.lib.offline import Parts, port_config, set_precision, sync
from port_bench.reference import las as ref

FOLLOWED = 3            # steps the reference repeats


class _NoLog:
    """The trainer's metrics logger, kept off the disk."""

    def scalar(self, *a):
        pass

    def text(self, *a):
        pass

    def image(self, *a):
        pass


class Driver:
    def __init__(self, cell: dict, cfg: dict, mix: dict, seed: int,
                 device: str = "cuda"):
        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        encoders.of(cfg)        # no family module: stop before set-up
        self.device = torch.device(device)
        self.spans = trace.Spans()
        self.steps = 0
        self.kept: Dict = {}
        self.parts = Parts()

    # ---- set-up -------------------------------------------------------------
    def _batches(self):
        """The mix's batches as the program's loader collates them: wavs
        padded to ``wav_bucket``, <s> + text and text + </s> padded to
        ``text_bucket``, cut from the length-sorted corpus, in the order
        the window cycles them."""
        mix, voc = self.mix, self.cfg["vocab"]
        wavs, secs = traffic.corpus(mix, self.seed, self.device)
        texts = traffic.transcripts(secs, mix, self.seed,
                                    voc["max_num_words"] + 4, 4)
        order = np.argsort([len(w) for w in wavs], kind="stable")
        B = mix["batch_size"]
        out = []
        for s in range(0, len(order) - B + 1, B):
            idx = order[s:s + B]
            N = -(-max(len(wavs[i]) for i in idx) // mix["wav_bucket"]) \
                * mix["wav_bucket"]
            wav = np.zeros((B, N), np.int16)
            lens = np.zeros(B, np.int32)
            S = -(-(max(len(texts[i]) for i in idx) + 1)
                  // mix["text_bucket"]) * mix["text_bucket"]
            ti = np.full((B, S), voc["pad"], np.int32)
            to = np.full((B, S), voc["pad"], np.int32)
            tl = np.zeros(B, np.int32)
            for j, i in enumerate(idx):
                wav[j, :len(wavs[i])] = wavs[i]
                lens[j] = len(wavs[i])
                t = texts[i]
                ti[j, 0] = voc["sos"]
                ti[j, 1:1 + len(t)] = t
                to[j, :len(t)] = t
                to[j, len(t)] = voc["eos"]
                tl[j] = len(t) + 1
            out.append({"host": (wav, lens, ti, to, tl),
                        "audio_s": float(secs[idx].sum()),
                        "wavs": [wavs[i] for i in idx]})
        # the cycle starts with the longest batch, a middle one and the
        # shortest, so that the steps the reference follows span the keys
        first = list(dict.fromkeys([len(out) - 1, len(out) // 2, 0]))
        return [out[i] for i in first] + [b for i, b in enumerate(out)
                                          if i not in first]

    def setup(self) -> None:
        from chinese_asr_tpu_torch.train.trainer import Trainer
        cfg = self.cfg
        set_precision(cfg)
        mark = self.parts.mark
        self.batches = self._batches()
        mark("corpus")
        self.params = weights.make_params(cfg, self.seed, self.device)
        if self.device.type == "cuda":
            sync(self.device)
            torch.cuda.reset_peak_memory_stats()
        mark("weights")
        pcfg = port_config(cfg)
        pcfg = pcfg.with_("train", save_dir=os.path.join(
            tempfile.gettempdir(), "port_bench_train"), seed=self.seed)
        self.pcfg = pcfg = pcfg.replace(verbose=False)
        tr = Trainer(pcfg, self.params, logger=_NoLog(), device=self.device)
        self.trainer = tr
        mark("program")
        step_fn = tr._step_fn

        def kept(params, opt_state, batch, gen):
            out = step_fn(params, opt_state, batch, gen)
            n = len(self.kept.setdefault("loss", []))
            if n < FOLLOWED:
                self.kept["loss"].append(out[2]["loss"].detach().clone())
                if n == 0:
                    self.kept["mu"] = {k[3:]: v.detach().clone()
                                       for k, v in out[1].items()
                                       if k.startswith("mu/")}
                if n == FOLLOWED - 1:
                    from chinese_asr_tpu_torch.train import optim
                    self.kept["params"] = {
                        k: v.detach().clone()
                        for k, v in optim.flatten(out[0]).items()}
            return out

        tr._step_fn = kept
        self._fit(len(self.batches))
        tr._step_fn = step_fn
        self.spans.wrap(tr, "_step_fn", "bench.step")
        mark("first pass")
        self.step_fn = step_fn

    def _loader(self, n: int = None, seconds: float = None):
        """Batches through the program's device loader: ``n`` of them, or
        as many as start within ``seconds`` (one at least)."""
        from chinese_asr_tpu_torch.data.dataset import batches_to_device
        t0 = time.perf_counter()
        cycle = self.batches

        class Source:
            def __iter__(self_inner):
                i = 0
                while True:
                    yield cycle[i % len(cycle)]["host"]
                    i += 1

        def gen():
            inner = batches_to_device(Source(), self.pcfg, self.device)
            try:
                i = 0
                for b in inner:
                    if n is not None and i >= n:
                        return
                    if seconds is not None and i and \
                            time.perf_counter() - t0 >= seconds:
                        return
                    self.steps += 1
                    self.audio_s += cycle[i % len(cycle)]["audio_s"]
                    self.starts.append(time.perf_counter())
                    i += 1
                    yield b
            finally:
                inner.close()
        return gen

    def _fit(self, n: int = None, seconds: float = None):
        self.audio_s = 0.0
        self.steps = 0
        self.starts: List[float] = []
        self.trainer.fit(self._loader(n, seconds))
        sync(self.device)

    # ---- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        g = getattr(self.step_fn, "graphs", None)
        caps = g.captures if g is not None else 0
        t0 = time.perf_counter()
        self._fit(seconds=seconds)
        t = time.perf_counter()
        return {"seconds": t - t0, "steps": self.steps,
                "pass_s": [b - a for a, b in zip(
                    self.starts[::len(self.batches)],
                    self.starts[len(self.batches)::len(self.batches)])],
                "audio_s": self.audio_s, "attempted": self.steps,
                "failed": 0,
                "captures": (g.captures if g is not None else 0) - caps}

    def traced(self, counters: dict) -> dict:
        """The fullest trace of one pass over the batches."""
        n = len(self.batches)

        def one():
            self._fit(n)
            return [{"lens": [len(w) for w in b["wavs"]],
                     "tokens": int(b["host"][4].sum())}
                    for b in self.batches]
        s = trace.fullest(one, self.spans, counters)
        s["window"] = {"attempted": n, "failed": 0}
        return s

    def notes(self, rec: dict) -> List[str]:
        out = [self.parts.line()]
        if "pass_s" in rec["window"]:
            out.append("passes over the batches in the window (s): "
                       + " ".join(f"{p:.3f}" for p in rec["window"]["pass_s"]))
        caps = rec["window"].get("captures", 0)
        if caps:
            out.append(f"note: {caps} step graph(s) captured inside the "
                       f"window")
        if "trace" in rec:
            out += trace.count_notes(rec["trace"], rec["kernels"])
        return out

    def release(self) -> None:
        self.trainer = None
        self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness ----------------------------------------------------
    def check(self, precision: str = "float32") -> Dict[str, float]:
        got = {"loss": [float(x) for x in self.kept["loss"]],
               "first": {k: v / (1 - 0.9) for k, v in self.kept["mu"].items()},
               "params": self.kept["params"]}
        return judge(self.cfg, self.params, self.batches[:FOLLOWED], got,
                     self.device, precision)


def ref_batches(cfg: dict, batches, device, prec):
    """The reference's inputs of each batch: its own features of the
    batch's wavs, and the token matrices."""
    out = []
    for b in batches:
        _, _, ti, to, tl = b["host"]
        feats = [ref.features(w, cfg["audio"], prec, device)
                 for w in b["wavs"]]
        out.append((feats, *(torch.from_numpy(a).long().to(device)
                             for a in (ti, to, tl))))
    return out


def judge(cfg: dict, params: dict, batches, got: dict, device,
          precision: str = "float32") -> Dict[str, float]:
    """The numbers compared for three training steps ``got`` (each
    step's loss, the first gradient as Adam got it, the parameters after
    the third step) against the reference's from the same weights and
    batches: ``loss_gap``, the widest relative gap of a step's loss;
    ``grad_gap`` and ``update_gap``, the worst leaf's gap between the
    norms of its first gradient, and of its change over the three steps,
    relative to the larger of the reference's norm of that leaf and of
    the median leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam
    and are left out of ``update_gap``."""
    prec = ref.Precision(precision)
    with prec.active():
        with torch.no_grad():
            rb = ref_batches(cfg, batches, device, prec)
        losses, first, after = ref.adam_steps(prec, params, rb, cfg, len(rb))
    p0 = ref.leaves(params)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], losses))
    gn = {n: float(first[n].norm()) for n in first}
    med_g = float(np.median(list(gn.values())))
    grad_gap = max(abs(float(got["first"][n].norm()) - gn[n])
                   / max(gn[n], med_g) for n in gn)
    moved = [n for n in gn if gn[n] >= 1e-3 * med_g]
    dn = {n: float((after[n] - p0[n]).norm()) for n in moved}
    med_d = float(np.median(list(dn.values())))
    update_gap = max(abs(float((got["params"][n] - p0[n]).norm()) - dn[n])
                     / max(dn[n], med_d) for n in moved)
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "update_gap": float(update_gap)}


def control(cell: dict, cfg: dict, mix: dict, seed: int, precision: str,
            device="cuda") -> Dict[str, float]:
    """The control of a training cell: the reference's three steps in
    ``precision`` put in the program's place, judged as a run judges the
    program."""
    dev = torch.device(device)
    d = Driver(cell, cfg, mix, seed, device=dev)
    batches = d._batches()[:FOLLOWED]
    params = weights.make_params(cfg, seed, dev)
    prec = ref.Precision(precision)
    with prec.active():
        with torch.no_grad():
            rb = ref_batches(cfg, batches, dev, prec)
        losses, first, after = ref.adam_steps(prec, params, rb, cfg, len(rb))
    got = {"loss": losses, "first": first, "params": after}
    return judge(cfg, params, batches, got, dev)
