"""On-device n-gram LM: Katz-backoff scoring as tensor gathers (port of
``chinese_asr_tpu/lm/device_ngram.py``).

Every n-gram order's (logp, backoff) table is a linear-probing hash table
held on the device as one packed int32 tensor, and scoring a batch of
(context, candidate) pairs is a handful of gathers and compares, so the
beam's passive LM track (``decode/beam.py``), the second pass
(``decode/rescore.py``) and the LM-driven first pass
(``decode/lm_fused.py``) never leave the device.  Scores equal the host
scorers' (``lm/ngram.py``) to f32: longest matching (context suffix +
word) n-gram wins, plus the backoffs of every existing longer context;
OOV words map to ``<unk>``; an ARPA without ``<unk>`` gets kenlm's
synthesized -100 unigram.  log10, like kenlm.

Two key layouts, as in the JAX package, which share all the machinery:
- **hashed** (``from_lm``; what ``from_path`` builds whenever the C++
  reader of ``lm/ngram.py`` builds, as the JAX package's ``from_path``
  does): the reader enumerates each order of an ARPA or any ``.klm``
  layout (``NgramLM.dump_order``), word ids are the reader's, level-1
  keys are [id] and level-k >= 2 keys are kenlm's 64-bit ``ngram_hash``
  split into [hi, lo] int32 (probing binaries store only hashes).  The
  lookup computes the same hash chain (kenlm's ``CombineWordHash``,
  ``_combine_word_hash``) on int64 tensors holding the u64 bit patterns,
  relying on the int64 product to wrap mod 2^64 as torch's CPU and CUDA
  kernels do (tests pin the hashes bit for bit against the C++ reader's
  keys on both).  Exact compare on the stored 64-bit key: the collision
  model kenlm's own probing tables accept.
- **tuple** (``from_arpa``; the fallback without a compiler): words are
  numbered in ARPA unigram order and level-k keys are the full word-id
  tuple, compared exactly.

Table layout (the same numpy build as the JAX package's):
- Empty slots hold -1, which is also the "absent context" id of a query,
  so a history shorter than order-1 falls through to lower orders for
  free (the hashed layout masks such levels explicitly).
- Open addressing at load <= 0.5.  The build records the worst
  displacement D, so a lookup probes exactly P = D+1 slots and decides
  membership with no early exit.
- A level is ONE packed [cap + P - 1, kcols + 2] int32 tensor (key
  columns, then logp/backoff bitcast), its first P-1 rows repeated past
  the end so a probe window never wraps; within a 2 GB budget, levels are
  widened smallest-first to [cap, P*(kcols+2)] so one row holds the whole
  window.
- Stored keys are unique, so at most one probe slot matches: the value is
  a masked sum of int32 bit patterns.
- Level 1 is a dense [max_id+1, 2] f32 table (NaN logp = absent).
- The slot hash is FNV-1a over the key words with a murmur finalizer, in
  uint32 arithmetic; torch has no general uint32, so the device side
  computes it in int64 and keeps the low 32 bits of each product.

Not ported: the JAX package's layout/width/gate A/B switches (identical
scores by test; the gate, ``ctx_gated``, was a measured negative).  The
probes have no Pallas kernel in the JAX package, so they are plain torch
indexing here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.graphs import tensor_ids
from . import ngram
from .ngram import PyNgramLM

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_U32 = 0xFFFFFFFF


def _hash_np(keys: np.ndarray) -> np.ndarray:
    """FNV-1a + murmur finalizer over int32 id rows.  keys [n, k]."""
    with np.errstate(over="ignore"):
        h = np.full(keys.shape[:-1], _FNV_OFFSET, np.uint32)
        for j in range(keys.shape[-1]):
            h = (h ^ keys[..., j].astype(np.uint32)) * np.uint32(_FNV_PRIME)
        h ^= h >> np.uint32(16)
        h *= np.uint32(_MIX1)
        h ^= h >> np.uint32(13)
        h *= np.uint32(_MIX2)
        h ^= h >> np.uint32(16)
    return h


# Probe-count targeting: at most 2 doublings past load 0.5 to bring the
# probe window to _TARGET_PROBES, never past _MEM_CAP bytes per level.
_TARGET_PROBES = 4
_MEM_CAP = 512 << 20
# total bytes the wide (one row per probe window) levels may take
_WIDE_TOTAL_CAP = 2 << 30


def _widen_tables(tbls, probes, skip=(), budget: int = _WIDE_TOTAL_CAP):
    """Widen narrow packed numpy tables smallest-first within a total
    byte budget; levels in ``skip`` (the dense-unigram level the lookup
    never probes) stay narrow.  Widened level i becomes [cap, P*(k+2)]
    (see `_pack_wide`)."""
    out = list(tbls)
    order = sorted(range(len(tbls)),
                   key=lambda i: tbls[i].nbytes * probes[i])
    spent = 0
    for i in order:
        if i in skip or probes[i] <= 1:
            continue
        k = tbls[i].shape[1] - 2
        wide_bytes = (tbls[i].shape[0] - (probes[i] - 1)) \
            * probes[i] * (k + 2) * 4
        if spent + wide_bytes > budget:
            continue
        out[i] = _pack_wide(tbls[i], probes[i], k)
        spent += wide_bytes
    return out


def _build_table(keys: np.ndarray, vals: np.ndarray):
    """Vectorized linear-probing build: keys [n, k] int32 (unique rows),
    vals [n, 2] f32 -> (tbl [cap + probes - 1, k + 2] int32 packed,
    probes).  Capacity doubles (at most twice) while that shortens the
    probe window past _TARGET_PROBES."""
    n, k = keys.shape
    cap0 = 1 << max(3, int(np.ceil(np.log2(max(2 * n, 1) + 1))))
    best = None
    cap = cap0
    while True:
        built = _build_table_at(keys, vals, cap)
        if best is None or built[2] < best[2]:
            best = built
        if (built[2] <= _TARGET_PROBES or cap >= cap0 * 4
                or cap * (k + 2) * 4 * 2 > _MEM_CAP):
            ids, tv, probes = best
            return _pack_table(ids, tv, probes), probes
        cap *= 2


def _pack_table(ids: np.ndarray, tv: np.ndarray, probes: int) -> np.ndarray:
    """[cap, k] keys + [cap, 2] f32 vals -> [cap + probes - 1, k + 2]
    int32 (vals bitcast), first probes-1 rows appended for wrap-free
    contiguous probe windows."""
    tbl = np.concatenate([ids, tv.view(np.int32)], axis=1)
    if probes > 1:
        tbl = np.concatenate([tbl, tbl[: probes - 1]], axis=0)
    return np.ascontiguousarray(tbl)


def _pack_wide(tbl: np.ndarray, probes: int, k: int) -> np.ndarray:
    """Narrow packed [cap + P - 1, k + 2] -> wide [cap, P * (k + 2)]:
    row i holds slots i..i+P-1 concatenated, so a probe window is ONE
    row gather."""
    cap = tbl.shape[0] - (probes - 1)
    idx = np.arange(cap)[:, None] + np.arange(probes)[None, :]
    return np.ascontiguousarray(
        tbl[idx].reshape(cap, probes * (k + 2)))


def _build_table_at(keys: np.ndarray, vals: np.ndarray, cap: int):
    """Insert in ascending-home order: linear probing is then a parking
    function, pos_i = max(home_i, pos_{i-1} + 1), one prefix max.  The
    few entries pushed past the end wrap to the front in a short loop.
    -> (ids [cap, k], vals [cap, 2], probes = worst displacement + 1)."""
    n, k = keys.shape
    ids = np.full((cap, k), -1, np.int32)
    tv = np.zeros((cap, 2), np.float32)
    if n == 0:
        return ids, tv, 1
    home = (_hash_np(keys) & np.uint32(cap - 1)).astype(np.int64)
    order = np.argsort(home, kind="stable")
    hs = home[order]
    ar = np.arange(n, dtype=np.int64)
    pos = np.maximum.accumulate(hs - ar) + ar
    disp = pos - hs
    wrap = pos >= cap
    fit = ~wrap
    ids[pos[fit]] = keys[order[fit]]
    tv[pos[fit]] = vals[order[fit]]
    max_disp = int(disp[fit].max()) if fit.any() else 0
    if wrap.any():
        occupied = np.zeros(cap, bool)
        occupied[pos[fit]] = True
        for i in np.nonzero(wrap)[0]:
            s = int(hs[i])
            d = 0
            while occupied[s]:
                s = (s + 1) & (cap - 1)
                d += 1
            occupied[s] = True
            ids[s] = keys[order[i]]
            tv[s] = vals[order[i]]
            if d > max_disp:
                max_disp = d
    return ids, tv, max_disp + 1


def _build_dense_uni(keys1: np.ndarray, vals: np.ndarray):
    """Dense [max_id+1, 2] f32 unigram table (logp, backoff); absent ids
    hold logp=NaN (no real logp is NaN, so presence tests as ~isnan)."""
    capu = int(keys1.max()) + 1 if keys1.size else 1
    uni = np.full((capu, 2), np.nan, np.float32)
    uni[keys1, 0] = vals[:, 0]
    uni[keys1, 1] = vals[:, 1]
    return uni


class DeviceNgramLM:
    """Per-order probing hash tables as tensors on one device.  The word
    map stays on the host (token mapping happens before the decode):
    ``word2id`` for the tuple layout, the C++ reader (``host_lm``) for
    the hashed one."""

    def __init__(self, order: int, tbls, probes, unk_id: int,
                 word2id: Optional[Dict[str, int]], uni,
                 hashed: bool = False, host_lm=None, bos_id=None):
        self.order = order
        self.tbls = tuple(tbls)     # tbls[k]: narrow or wide packed int32
        self.probes = tuple(probes)
        self.unk_id = unk_id
        self.word2id = word2id
        self.uni = uni              # dense [max_id+1, 2] f32, NaN = absent
        self.hashed = hashed
        self.host_lm = host_lm      # lm.ngram.NgramLM behind from_lm
        self._bos_id = bos_id if bos_id is not None else \
            word2id.get("<s>", unk_id)

    # ---------------------------------------------------------------- build
    @classmethod
    def from_arpa(cls, path: str, device=None) -> "DeviceNgramLM":
        """``device``: None -> ``cuda`` (raises without a GPU), as the
        port's entry points resolve it."""
        device = resolve_device(device)
        py = PyNgramLM(path)
        order = py.order
        # id assignment: unigram enumeration order (stable)
        word2id: Dict[str, int] = {}
        for key in py.grams:
            if len(key) == 1 and key[0] not in word2id:
                word2id[key[0]] = len(word2id)
        if "<unk>" not in word2id:      # kenlm's synthesized -100 unigram
            word2id["<unk>"] = len(word2id)
            py.grams[("<unk>",)] = (-100.0, 0.0)
        per_order: List[List] = [[] for _ in range(order)]
        for key, (logp, bo) in py.grams.items():
            if all(w in word2id for w in key):
                per_order[len(key) - 1].append(
                    ([word2id[w] for w in key], (logp, bo)))
        tbls, probes = [], []
        uni = None
        for k in range(order):
            rows = per_order[k]
            if rows:
                keys_np = np.asarray([r[0] for r in rows], np.int32)
                vals_np = np.asarray([r[1] for r in rows], np.float32)
            else:
                keys_np = np.zeros((0, k + 1), np.int32)
                vals_np = np.zeros((0, 2), np.float32)
            t, p = _build_table(keys_np, vals_np)
            tbls.append(t)
            probes.append(p)
            if k == 0:
                uni = _build_dense_uni(keys_np[:, 0], vals_np)
        tbls = [torch.from_numpy(t).to(device)
                for t in _widen_tables(tbls, probes, skip=(0,))]
        return cls(order, tbls, probes, word2id["<unk>"], word2id,
                   torch.from_numpy(uni).to(device))

    @classmethod
    def from_lm(cls, lm: "ngram.NgramLM", device=None) -> "DeviceNgramLM":
        """The hashed layout from a C++-backed ``NgramLM`` (ARPA text or
        any ``.klm`` layout its reader takes), through the reader's
        per-order enumeration ``dump_order``: level-1 keys are the word
        ids, level-k >= 2 keys kenlm's ngram_hash as [hi, lo] int32.
        ``device`` as for ``from_arpa``."""
        device = resolve_device(device)
        tbls, probes = [], []
        uni = None
        for k in range(1, lm.order + 1):
            hi, lo, prob, bo = lm.dump_order(k)
            if k == 1:
                assert lo.size == 0 or int(lo.max()) < 2**31, \
                    "word ids must fit int31"
                keys = lo.astype(np.int32)[:, None]
            else:
                keys = np.stack([hi.view(np.int32), lo.view(np.int32)],
                                axis=1)
            vals_np = np.stack([prob, bo], axis=1).astype(np.float32)
            t, p = _build_table(np.ascontiguousarray(keys), vals_np)
            tbls.append(t)
            probes.append(p)
            if k == 1:
                uni = _build_dense_uni(keys[:, 0], vals_np)
        tbls = [torch.from_numpy(t).to(device)
                for t in _widen_tables(tbls, probes, skip=(0,))]
        unk_id, bos_id = (int(x) for x in lm.word_ids(["<unk>", "<s>"]))
        return cls(lm.order, tbls, probes, unk_id, None,
                   torch.from_numpy(uni).to(device), hashed=True,
                   host_lm=lm, bos_id=bos_id)

    @classmethod
    def from_path(cls, path: str, device=None) -> "DeviceNgramLM":
        """ARPA text or any ``.klm`` layout: the hashed layout through the
        C++ reader (``from_lm``); the tuple layout from the pure-Python
        ARPA parse (``from_arpa``) only when the reader cannot be built,
        as the JAX package's ``from_path`` does.  A ``.klm`` without a
        compiler raises (``NgramLM``)."""
        lm = ngram.NgramLM(path)
        if lm.has_batch_states:
            return cls.from_lm(lm, device)
        return cls.from_arpa(path, device)

    def to(self, device) -> "DeviceNgramLM":
        """The same LM with its tables on ``device`` (the word map and the
        host reader are shared)."""
        return DeviceNgramLM(self.order, [t.to(device) for t in self.tbls],
                             self.probes, self.unk_id, self.word2id,
                             self.uni.to(device), hashed=self.hashed,
                             host_lm=self.host_lm, bos_id=self._bos_id)

    # ------------------------------------------------------------- host API
    def word_ids(self, words: Sequence[str]) -> np.ndarray:
        """LM word ids (OOV -> <unk>) in this LM's own numbering: the
        ARPA order of the tuple layout, the C++ reader's for the hashed
        one."""
        if self.word2id is None:
            return np.asarray(self.host_lm.word_ids(list(words)), np.int32)
        return np.asarray([self.word2id.get(w, self.unk_id) for w in words],
                          np.int32)

    def token_id_table(self, vocab) -> np.ndarray:
        """token id -> LM word id (OOV -> <unk>), like NgramLM's."""
        return self.word_ids([vocab.int2word[t]
                              for t in range(len(vocab.int2word))])

    def begin_context(self, n_rows: int) -> np.ndarray:
        """[n_rows, order-1] histories = (<s>,) -- kenlm begin state."""
        ctx = np.full((n_rows, max(self.order - 1, 1)), -1, np.int32)
        if self.order > 1:
            ctx[:, -1] = self._bos_id
        return ctx

    def null_context(self, n_rows: int) -> np.ndarray:
        """[n_rows, order-1] empty histories -- kenlm null state."""
        return np.full((n_rows, max(self.order - 1, 1)), -1, np.int32)

    def graph_key(self) -> tuple:
        """Everything of this LM that its probes read: a part of the key
        of a compiled decode that scores with it (``utils/graphs.py``)."""
        return (self.order, self.probes, self.unk_id, self.hashed,
                self._bos_id, tensor_ids(self.tbls, self.uni))


def _mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) int64 and a u32 constant.  The
    int64 product wraps mod 2^64 (two's complement, as torch's CPU and
    CUDA kernels multiply; pinned bit for bit on both by tests), which
    keeps its low 32 bits."""
    return (h * c) & _U32


def _hash_cols(cols) -> torch.Tensor:
    """:func:`_hash_np` over a list of same-shaped id tensors, in int64
    holding uint32 values; a -1 id hashes as 0xFFFFFFFF, like numpy's
    ``astype(uint32)``."""
    h = torch.full(cols[0].shape, _FNV_OFFSET, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        h = _mul32(h ^ (c.to(torch.int64) & _U32), _FNV_PRIME)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


# kenlm's CombineWordHash multipliers (lm/search_hashed.hh; runtime/cpp
# ngram_hash()) as int64 bit patterns
_M1 = 8978948897894561157
_M2 = 17894857484156487943 - 2**64


def _combine_word_hash(h, nxt):
    """kenlm CombineWordHash, h * M1 ^ (1 + next) * M2 mod 2^64, on int64
    tensors holding u64 bit patterns (the products wrap, see ``_mul32``);
    ``nxt`` u32 word ids, 1 + next taken in 64 bits as the C++ does."""
    return (h * _M1) ^ ((nxt + 1) * _M2)


def _hash_key(h):
    """A 64-bit hash -> the key columns ``from_lm`` stores for it: the
    int32 views of its high and low halves."""
    return [h >> 32, h.to(torch.int32)]


def _lookup_cols(tbl, probes: int, cols):
    """Probe one packed table with the key COLUMNS as separate id tensors
    (shape [...] each) -> (hit [...] bool, logp [...] f32, backoff [...]
    f32); a miss returns (False, 0.0, 0.0).  A wide level fetches its
    whole window as one row; a narrow one gathers P consecutive rows."""
    k = len(cols)
    P = probes
    wide = P > 1 and tbl.shape[1] == P * (k + 2)   # see _pack_wide
    cap_mask = tbl.shape[0] - 1 if wide else tbl.shape[0] - (P - 1) - 1
    shape = cols[0].shape
    flat = [c.reshape(-1).to(torch.int64) for c in cols]      # k x [N]
    h = _hash_cols(flat) & cap_mask                           # [N]
    if wide:
        win = tbl[h].view(-1, P, k + 2)                       # [N, P, k+2]
    else:
        slots = h[:, None] + torch.arange(P, device=h.device)
        win = tbl[slots]                                      # [N, P, k+2]
    hit_p = win[:, :, 0] == flat[0][:, None]                  # [N, P]
    for j in range(1, k):
        hit_p = hit_p & (win[:, :, j] == flat[j][:, None])
    hit = hit_p.any(dim=1)
    # at most one slot matches: a masked sum of int32 bit patterns (the
    # sum comes back as int64, exact, cast back before the bitcast)
    v = torch.where(hit_p[:, :, None], win[:, :, k:],
                    torch.zeros((), dtype=win.dtype, device=win.device))
    v = v.sum(dim=1).to(torch.int32).view(torch.float32)      # [N, 2]
    return hit.reshape(shape), v[:, 0].reshape(shape), v[:, 1].reshape(shape)


def _lookup_uni(uni, key1):
    """Dense level-1 lookup.  key1 [...] word ids (may be -1 or out of
    range) -> (hit, logp, backoff); absent slots hold NaN logp."""
    shape = key1.shape
    capu = uni.shape[0]
    k1 = key1.reshape(-1).to(torch.int64)
    v = uni[torch.clamp(k1, 0, capu - 1)]                    # [N, 2]
    hit = (k1 >= 0) & (k1 < capu) & ~torch.isnan(v[:, 0])
    return (hit.reshape(shape), v[:, 0].reshape(shape),
            torch.where(hit, v[:, 1], 0.0).reshape(shape))


def _lookup_level(lm: DeviceNgramLM, k: int, cols):
    """Level-k (0-based) lookup over key column tensors; level 0 takes the
    dense path."""
    if k == 0:
        return _lookup_uni(lm.uni, cols[0])
    return _lookup_cols(lm.tbls[k], lm.probes[k], cols)


def _hashed_probes(lm: DeviceNgramLM, ctx_ids, cand_ids):
    """The hashed layout's probes: kenlm ngram_hash chains, computed
    incrementally right to left (the predicted word seeds a gram's hash,
    then the history words fold in, most recent first).  Level k is
    usable only where the k-th most recent context word exists (-1
    padded histories are contiguous on the left).  -> (backoffs of the
    existing contexts per level 1..M-1, (hit, logp, backoff) per gram
    level 0..M-1)."""
    M = lm.order
    g, c = cand_ids, None
    gram_keys, ctx_keys, valid = [[cand_ids]], [None], [None]
    for k in range(1, M):
        w_k = ctx_ids[:, M - 1 - k]                          # [Q]
        valid.append(w_k >= 0)
        wk_u = w_k & _U32
        g = _combine_word_hash(g, wk_u[:, None])
        gram_keys.append(_hash_key(g))
        if k == 1:
            ctx_keys.append([w_k])
            c = wk_u
        else:
            c = _combine_word_hash(c, wk_u)
            ctx_keys.append(_hash_key(c))
    bo_val = []
    for k in range(1, M):
        h, _lp, bo = _lookup_level(lm, k - 1, ctx_keys[k])
        bo_val.append(torch.where(h & valid[k], bo, 0.0))
    gram = []
    for k in range(M):
        h, lp, bo = _lookup_level(lm, k, gram_keys[k])
        if k > 0:
            h = h & valid[k][:, None]
        gram.append((h, lp, bo))
    return bo_val, gram


def score_candidates(lm: DeviceNgramLM, ctx_ids, cand_ids):
    """Batch Katz-backoff base scores, on the tables' device.

    ctx_ids  [Q, order-1] LM word ids, -1 = absent, most recent word
             RIGHTMOST (row q is one beam's history).
    cand_ids [Q, C] candidate LM word ids (>= 0; OOV pre-mapped to <unk>
             by ``token_id_table``).
    Returns  [Q, C] f32 log10 scores, equal (to f32) to the host
             scorers' (``NgramLM``, ``PyNgramLM``) on the same (context,
             word) pairs.
    """
    M = lm.order
    ctx_ids = ctx_ids.to(torch.int64)
    cand_ids = cand_ids.to(torch.int64)
    if lm.hashed:
        bo_val, gram = _hashed_probes(lm, ctx_ids, cand_ids)
    else:
        # context lookups (shared across a row's candidates): level k
        # uses the last k context words
        bo_val = []
        for k in range(1, M):
            cols = [ctx_ids[:, j] for j in range(M - 1 - k, M - 1)]
            h, _lp, bo = _lookup_level(lm, k - 1, cols)
            bo_val.append(torch.where(h, bo, 0.0))
        # gram lookups: level k keys = (last k context words, candidate)
        gram = []
        for k in range(M):
            cols = [ctx_ids[:, j][:, None].expand(cand_ids.shape)
                    for j in range(M - 1 - k, M - 1)] + [cand_ids]
            gram.append(_lookup_level(lm, k, cols))
    # longest hitting level wins; add the backoffs of every existing
    # context LONGER than the match (the host scorer's shrinking loop)
    S = torch.zeros(cand_ids.shape, dtype=torch.float32,
                    device=cand_ids.device)
    out = torch.zeros_like(S)
    chosen = torch.zeros(cand_ids.shape, dtype=torch.bool,
                         device=cand_ids.device)
    for k in range(M - 1, -1, -1):
        hit, lp, _bo = gram[k]
        if k == 0:
            # the unigram level always resolves: a miss is kenlm's
            # synthesized <unk> (in the table by construction, so only
            # ids outside the vocab reach it)
            lp = torch.where(hit, lp, -100.0)
            hit = torch.ones_like(hit)
        total = lp + S
        out = torch.where(chosen, out, torch.where(hit, total, out))
        chosen = chosen | hit
        if k > 0:
            S = S + bo_val[k - 1][:, None]
    return out


def advance_context(ctx_ids, new_ids):
    """Shift one word into each history: ctx [Q, M-1], new [Q] ->
    [Q, M-1].  A window, not kenlm's state minimization: the extra words
    only miss, so the scores are the same."""
    if ctx_ids.shape[-1] == 0:
        return ctx_ids
    return torch.cat([ctx_ids[:, 1:], new_ids[:, None].to(ctx_ids.dtype)],
                     dim=1)
