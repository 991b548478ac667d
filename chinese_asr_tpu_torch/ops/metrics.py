"""Character error rate (reference util.py:186-262, called "wer" there);
a copy of ``chinese_asr_tpu/ops/metrics.py``.

The edit distance runs in the C++ library (``runtime/cpp/
edit_distance.cpp``, bound by ``runtime/native.py``) where it builds,
else in the pure-Python DP (the reference keeps one too, util.py:186-234).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..runtime import native


def _edit_distance_py(pred: Sequence, ref: Sequence) -> int:
    m, n = len(ref), len(pred)
    if n == 0:
        return m
    if m == 0:
        return n
    dist = list(range(n + 1))
    for i in range(1, m + 1):
        pre = i
        cur = i
        for j in range(1, n + 1):
            if pred[j - 1] == ref[i - 1]:
                cur = dist[j - 1]
            else:
                cur = min(pre, dist[j], dist[j - 1]) + 1
            dist[j - 1] = pre
            pre = cur
        dist[n] = cur
    return dist[n]


def edit_distance(pred: str, ref: str) -> int:
    lib = native.get()
    if lib is not None:
        return lib.edit_distance(pred, ref)
    return _edit_distance_py(pred, ref)


def cer(pred: str, ref: str, normalize: bool = True) -> float:
    """Reference get_wer (util.py:237-251): distance / len(ref)."""
    d = edit_distance(pred, ref)
    if normalize:
        return d / (1.0 * len(ref))
    return float(d)


def cer_detail(pred: str, ref: str, normalize: bool = True
               ) -> Tuple[float, float, float, float]:
    """(all, insert, delete, replace) like get_wer(return_tuple=True)
    (util.py:253-262).  Counts ops transforming pred -> ref."""
    m, n = len(ref), len(pred)
    # DP with op backtrace
    D = np.zeros((n + 1, m + 1), np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if pred[i - 1] == ref[j - 1] else 1
            D[i, j] = min(D[i - 1, j] + 1,      # delete from pred
                          D[i, j - 1] + 1,      # insert into pred
                          D[i - 1, j - 1] + cost)
    i, j = n, m
    ins = dele = rep = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] and pred[i - 1] == ref[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + 1:
            rep += 1
            i, j = i - 1, j - 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            dele += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    total = ins + dele + rep
    out = (total, ins, dele, rep)
    if normalize:
        return tuple(x / (1.0 * m) for x in out)
    return tuple(float(x) for x in out)


def batch_cer(preds: List[str], refs: List[str]) -> float:
    """Mean per-utterance CER (the reference's aggregation, model.py:598)."""
    lib = native.get()
    if lib is not None:
        return lib.batch_cer(preds, refs)
    return float(np.mean([cer(p, r) for p, r in zip(preds, refs)]))
