"""N-gram language model on the host (a copy of ``PyNgramLM`` from
``chinese_asr_tpu/lm/ngram.py``, kept so this package never imports the
JAX one).

``PyNgramLM`` parses an ARPA text file and scores sentences with Katz
backoff, as kenlm does (reference model.py:749-763 calls
``lm_model.score(' '.join(chars), bos=True)``): the longest matching
n-gram wins, plus the backoff weights of every existing longer context;
OOV words map to ``<unk>``, and an ARPA without ``<unk>`` gets kenlm's
synthesized -100 unigram.  Scores are log10.  It is the port's host
oracle and the scorer of ``lm_mode="second_host"``.

The C++ scorer of KenLM binaries (``.klm``) comes with a later slice of
the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

_LATER = "comes with a later slice of the PyTorch port"


class PyNgramLM:
    """Pure-Python ARPA scorer."""

    def __init__(self, path: str):
        self.grams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        cur = 0
        with open(path, "r", encoding="utf-8") as f:
            section = None
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur = int(line[1:line.index("-")])
                    self.order = max(self.order, cur)
                    section = "grams"
                    continue
                if line == "\\end\\":
                    break
                if section == "data":
                    continue
                if section == "grams":
                    parts = line.split()
                    if len(parts) < cur + 1:
                        continue
                    logp = float(parts[0])
                    words = tuple(parts[1:1 + cur])
                    backoff = float(parts[cur + 1]) if len(parts) >= cur + 2 \
                        else 0.0
                    self.grams[words] = (logp, backoff)
        self.has_unk = ("<unk>",) in self.grams

    def _vocab_map(self, w: str) -> str:
        if (w,) in self.grams or w in ("<s>", "</s>"):
            return w
        return "<unk>" if self.has_unk else w

    def _score_one(self, ctx: Tuple[str, ...], w: str) -> float:
        ctx = ctx[-(self.order - 1):] if self.order > 1 else ()
        backoff_sum = 0.0
        for use in range(len(ctx), -1, -1):
            key = ctx[len(ctx) - use:] + (w,)
            if key in self.grams:
                return backoff_sum + self.grams[key][0]
            if use > 0:
                c = ctx[len(ctx) - use:]
                if c in self.grams:
                    backoff_sum += self.grams[c][1]
        if self.has_unk:
            return backoff_sum + self.grams[("<unk>",)][0]
        # kenlm synthesizes an <unk> unigram at -100 when the ARPA lacks
        # one, so context backoffs still apply
        return backoff_sum - 100.0

    def score(self, sentence: str, bos: bool = True, eos: bool = True) -> float:
        words = [self._vocab_map(w) for w in sentence.split()]
        ctx: Tuple[str, ...] = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self._score_one(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
        if eos:
            total += self._score_one(ctx, "</s>")
        return total


def is_kenlm_binary(path: str) -> bool:
    """KenLM binaries start with the ``mmap lm`` magic."""
    with open(path, "rb") as f:
        return f.read(9).startswith(b"mmap lm")


def load_lm(path: Optional[str]) -> Optional[PyNgramLM]:
    """Reference main.py:78-84: a None path -> no LM; an ARPA text file ->
    ``PyNgramLM``.  KenLM binaries raise."""
    if not path:
        return None
    if is_kenlm_binary(path):
        raise NotImplementedError(
            f"{path}: KenLM binary models (the C++ scorer and the hashed "
            f"device layout) {_LATER}; pass the ARPA text model")
    return PyNgramLM(path)
