"""Vocabulary: character <-> id mapping (a copy of
``chinese_asr_tpu/vocab.py``, kept so this package never imports the JAX one).

Mirrors the reference's ``dict.pkl`` contract (reference data.py:371-383):
a pickled ``(word2int, int2word)`` pair with specials ``<pad>=0, <s>=1,
</s>=2, <unk>=3`` followed by Hanzi ordered by corpus frequency
(gpd.py:47 ``max_num_words``).  Also provides the ``make_dict`` builder the
reference references but never shipped (data.py:675).
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, Iterable, List, Sequence

PAD, SOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")


class Vocab:
    def __init__(self, word2int: Dict[str, int], int2word: Dict[int, str]):
        self.word2int = dict(word2int)
        self.int2word = dict(int2word)
        for i, tok in enumerate(SPECIALS):
            assert self.word2int.get(tok) == i, f"special {tok} must map to {i}"

    def __len__(self) -> int:
        return len(self.word2int)

    # ---- text <-> ids ----------------------------------------------------
    def encode(self, text: str) -> List[int]:
        """Character-level ids with <unk> fallback (reference data.py:456)."""
        unk = self.word2int["<unk>"]
        return [self.word2int.get(ch, unk) for ch in text]

    def decode(self, ids: Sequence[int]) -> str:
        """Join ids to a string; specials are rendered verbatim, matching the
        reference detokenizer ``''.join(int2word[e] ...)`` (model.py:592)."""
        return "".join(self.int2word[int(i)] for i in ids)

    # ---- persistence -----------------------------------------------------
    @staticmethod
    def load(path: str) -> "Vocab":
        with open(path, "rb") as f:
            word2int, int2word = pickle.load(f)
        # normalize key types (pickled int2word may have str or int keys)
        int2word = {int(k): v for k, v in int2word.items()}
        return Vocab(word2int, int2word)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump((self.word2int, self.int2word), f)

    # ---- builder (the make_dict the reference lacks, data.py:675) --------
    @staticmethod
    def build(texts: Iterable[str], max_num_words: int = 5000) -> "Vocab":
        counter: Counter = Counter()
        for t in texts:
            counter.update(t)
        word2int = {tok: i for i, tok in enumerate(SPECIALS)}
        for w, _ in counter.most_common(max_num_words):
            word2int[w] = len(word2int)
        int2word = {i: w for w, i in word2int.items()}
        return Vocab(word2int, int2word)
