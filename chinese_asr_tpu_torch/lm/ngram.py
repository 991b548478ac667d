"""N-gram language model on the host (port of ``chinese_asr_tpu/lm/
ngram.py``; nothing of the JAX package is imported).

The reference loads a KenLM binary model and calls
``lm_model.score(' '.join(chars), bos=True)`` during second-pass rescoring
(reference main.py:82, model.py:749-763) and uses the incremental
``BaseScore`` state API in its first-pass-LM decode (model.py:1131-1180).
Here the scorer is first-party:

* ``NgramLM`` loads an **ARPA** text file or a **KenLM binary** (``.klm``:
  the PROBING layout of the reference's shipped artifact
  ``zh_giga.no_cna_cmn.prune01244.klm``, reference gpd.py:121 /
  main.py:126, and the TRIE family: TRIE / QUANT_TRIE / ARRAY_TRIE /
  QUANT_ARRAY_TRIE) through the C++ reader (``runtime/cpp/ngram_lm.cpp``,
  a copy of the JAX package's, built by ``runtime/native.py``), with the
  pure-Python ``PyNgramLM`` as its fallback for ARPA text when no
  compiler is present.  The API mirrors kenlm: ``score(sentence,
  bos=True, eos=True)`` is the sum of log10 conditional probabilities
  with Katz backoff (the longest matching n-gram wins, plus the backoffs
  of every existing longer context; OOV words map to ``<unk>``, and an
  ARPA without ``<unk>`` gets kenlm's synthesized -100 unigram);
  ``base_score`` is the incremental variant.
* ``score_batch``/``score_batch_ids`` score a whole n-best list in one
  FFI call; ``base_score_batch_np``/``advance_batch_np`` are the batched
  state API of the first-pass host loop (``decode/lm_first_pass.py``);
  ``dump_order`` enumerates each order for the device tables
  (``lm/device_ngram.py`` ``from_lm``); ``write_binary`` writes any
  supported ``.klm`` layout.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime import native


class PyNgramLM:
    """Pure-Python ARPA scorer (the fallback of ``NgramLM`` without a
    compiler, and the differential-test oracle)."""

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

    def context_property(self) -> bool:
        """True iff every n-gram's (n-1)-word prefix context is itself
        an entry (see NgramLM.context_property)."""
        return all(key[:-1] in self.grams
                   for key in self.grams if len(key) >= 2)

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


# ----------------------------------------------------------------------------
# ctypes binding to the C++ kernel
# ----------------------------------------------------------------------------
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _load_lib() -> Optional[ctypes.CDLL]:
    so = native.compile_source("ngram_lm")
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.lm_load_arpa.restype = ctypes.c_void_p
    lib.lm_load_arpa.argtypes = [ctypes.c_char_p]
    lib.lm_last_error.restype = ctypes.c_char_p
    lib.lm_last_error.argtypes = []
    lib.lm_write_binary.restype = ctypes.c_int32
    lib.lm_write_binary.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.lm_write_binary_ex.restype = ctypes.c_int32
    lib.lm_write_binary_ex.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32]
    lib.lm_model_type.restype = ctypes.c_int32
    lib.lm_model_type.argtypes = [ctypes.c_void_p]
    lib.lm_free.argtypes = [ctypes.c_void_p]
    lib.lm_order.restype = ctypes.c_int32
    lib.lm_order.argtypes = [ctypes.c_void_p]
    lib.lm_num_ngrams.restype = ctypes.c_int64
    lib.lm_num_ngrams.argtypes = [ctypes.c_void_p]
    lib.lm_vocab_id.restype = ctypes.c_int64
    lib.lm_vocab_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.lm_score_ids.restype = ctypes.c_double
    lib.lm_score_ids.argtypes = [ctypes.c_void_p, _u32p, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.lm_score_batch.restype = None
    lib.lm_score_batch.argtypes = [ctypes.c_void_p, _u32p, _i64p,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, _f64p]
    lib.lm_state_capacity.restype = ctypes.c_int32
    lib.lm_state_capacity.argtypes = [ctypes.c_void_p]
    lib.lm_base_score.restype = ctypes.c_double
    lib.lm_base_score.argtypes = [ctypes.c_void_p, _u32p, ctypes.c_int32,
                                  ctypes.c_uint32, _u32p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.lm_bos_id.restype = ctypes.c_uint32
    lib.lm_bos_id.argtypes = [ctypes.c_void_p]
    _i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lm_base_score_batch.restype = None
    lib.lm_base_score_batch.argtypes = [ctypes.c_void_p, _u32p, _i32p,
                                        ctypes.c_int32, _u32p,
                                        ctypes.c_int32, _f64p]
    lib.lm_advance_batch.restype = None
    lib.lm_advance_batch.argtypes = [ctypes.c_void_p, _u32p, _i32p,
                                     ctypes.c_int32, _u32p, ctypes.c_int32]
    _f32p = ctypes.POINTER(ctypes.c_float)
    lib.lm_dump_order.restype = ctypes.c_int64
    lib.lm_dump_order.argtypes = [ctypes.c_void_p, ctypes.c_int32, _u32p,
                                  _u32p, _f32p, _f32p, ctypes.c_int64]
    lib.lm_context_property.restype = ctypes.c_int32
    lib.lm_context_property.argtypes = [ctypes.c_void_p]
    return lib


_lib_cache = {"lib": None, "tried": False}


def _lib() -> Optional[ctypes.CDLL]:
    if not _lib_cache["tried"]:
        _lib_cache["tried"] = True
        try:
            _lib_cache["lib"] = _load_lib()
        except Exception:
            _lib_cache["lib"] = None
    return _lib_cache["lib"]


class State:
    """Opaque LM context (kenlm.State parity)."""

    __slots__ = ("ids",)

    def __init__(self, ids: Tuple[int, ...] = ()):
        self.ids = tuple(ids)


class NgramLM:
    """ARPA n-gram LM, C++-backed when the toolchain is available."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(9)
        is_binary = magic.startswith(b"mmap lm")
        lib = _lib()
        self._h = None
        self._py: Optional[PyNgramLM] = None
        if lib is not None:
            # lm_load_arpa auto-detects kenlm binaries by magic and loads
            # the PROBING layout directly (runtime/cpp/ngram_lm.cpp)
            h = lib.lm_load_arpa(path.encode("utf-8"))
            if h:
                self._h = ctypes.c_void_p(h)
                self._lib = lib
                self.order = int(lib.lm_order(self._h))
                self._id_cache: Dict[str, int] = {}
                return
            err = lib.lm_last_error().decode("utf-8", "replace")
            raise ValueError(f"failed to load LM {path}: {err}")
        if is_binary:
            raise ValueError(
                f"{path} is a KenLM binary model, which needs the C++ LM "
                "kernel, and no C++ toolchain is available to build it. "
                "Install a compiler (g++/clang++) or provide the ARPA "
                "text model instead.")
        self._py = PyNgramLM(path)
        self.order = self._py.order

    #: kenlm lm/model_type.hh values accepted by write_binary
    LAYOUTS = {"probing": 0, "trie": 2, "quant_trie": 3, "array_trie": 4,
               "quant_array_trie": 5}

    def write_binary(self, path: str, layout: str = "probing",
                     prob_bits: int = 8, backoff_bits: int = 8,
                     bhiksha_bits: int = 22) -> None:
        """Write this (ARPA-loaded) model as a KenLM binary — the
        build_binary equivalent.  ``layout`` picks the search family:
        ``probing`` (kenlm's default), ``trie``, ``quant_trie`` (kenlm
        ``trie -q N -b M``), ``array_trie`` / ``quant_array_trie``
        (``-a K`` Bhiksha pointer compression).  The output loads through
        both this class and kenlm itself."""
        if self._py is not None:
            raise RuntimeError("write_binary needs the C++ LM kernel")
        mt = self.LAYOUTS.get(layout)
        if mt is None:
            raise ValueError(f"unknown layout {layout!r}; "
                             f"one of {sorted(self.LAYOUTS)}")
        if not self._lib.lm_write_binary_ex(self._h, path.encode("utf-8"),
                                            mt, prob_bits, backoff_bits,
                                            bhiksha_bits):
            err = self._lib.lm_last_error().decode("utf-8", "replace")
            raise RuntimeError(f"write_binary failed: {err}")

    @property
    def model_type(self) -> int:
        """-1 for ARPA-loaded models, else the kenlm binary model_type
        (0 PROBING, 2 TRIE, 3 QUANT_TRIE, 4 ARRAY_TRIE,
        5 QUANT_ARRAY_TRIE)."""
        if self._py is not None:
            return -1
        return int(self._lib.lm_model_type(self._h))

    def context_property(self) -> bool:
        """True iff every n-gram's (n-1)-word prefix context is itself
        an entry — the ARPA property kenlm's own builder/loader enforce.
        ARPA-loaded models are checked exactly; kenlm binaries are True
        by construction (see lm_context_property in the C++ kernel).
        lm/device_ngram.py gates its high-order probe gathers on it."""
        if self._py is not None:
            return self._py.context_property()
        return bool(self._lib.lm_context_property(self._h))

    # ---- helpers -----------------------------------------------------------
    def _ids(self, words: Sequence[str]) -> np.ndarray:
        cache = self._id_cache
        lib = self._lib
        out = np.empty(len(words), np.uint32)
        for i, w in enumerate(words):
            v = cache.get(w)
            if v is None:
                v = int(lib.lm_vocab_id(self._h, w.encode("utf-8")))
                if v < 0:
                    v = 0
                cache[w] = v
            out[i] = v
        return out

    # ---- kenlm-parity API --------------------------------------------------
    def score(self, sentence: str, bos: bool = True, eos: bool = True) -> float:
        if self._py is not None:
            return self._py.score(sentence, bos, eos)
        ids = self._ids(sentence.split())
        p = ids.ctypes.data_as(_u32p)
        return float(self._lib.lm_score_ids(self._h, p, len(ids),
                                            int(bos), int(eos)))

    def score_batch(self, sentences: List[str], bos: bool = True,
                    eos: bool = True) -> np.ndarray:
        """One FFI call for a whole n-best list."""
        if self._py is not None:
            return np.array([self._py.score(s, bos, eos) for s in sentences])
        id_lists = [self._ids(s.split()) for s in sentences]
        offsets = np.zeros(len(sentences) + 1, np.int64)
        np.cumsum([len(x) for x in id_lists], out=offsets[1:])
        flat = np.concatenate(id_lists) if offsets[-1] else \
            np.zeros(1, np.uint32)
        out = np.zeros(len(sentences), np.float64)
        self._lib.lm_score_batch(
            self._h, flat.ctypes.data_as(_u32p),
            offsets.ctypes.data_as(_i64p), len(sentences),
            int(bos), int(eos), out.ctypes.data_as(_f64p))
        return out

    def begin_state(self) -> State:
        """State containing <s> (kenlm BeginSentenceWrite)."""
        if self._py is not None:
            return State(("<s>",))
        return State((int(self._lib.lm_bos_id(self._h)),))

    def null_state(self) -> State:
        return State(())

    def base_score(self, state: State, word: str) -> Tuple[float, State]:
        """Incremental score of one word given a context state
        (kenlm BaseScore parity; reference model.py:1140-1179)."""
        if self._py is not None:
            ctx = tuple(self._py._vocab_map(w) for w in state.ids)
            w = self._py._vocab_map(word)
            s = self._py._score_one(ctx, w)
            new = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
            return s, State(new)
        cap = max(1, self.order - 1)
        in_ids = np.asarray(state.ids, np.uint32)
        out_ids = np.zeros(cap, np.uint32)
        out_len = ctypes.c_int32(0)
        wid = self._ids([word])[0]
        in_p = in_ids.ctypes.data_as(_u32p) if in_ids.size else \
            ctypes.cast(0, _u32p)
        s = self._lib.lm_base_score(self._h, in_p, len(state.ids),
                                    int(wid), out_ids.ctypes.data_as(_u32p),
                                    ctypes.byref(out_len))
        return float(s), State(tuple(int(x) for x in out_ids[: out_len.value]))

    # ---- numpy-level incremental batch API (C++ backend only) --------------
    @property
    def has_batch_states(self) -> bool:
        return self._py is None

    def state_capacity(self) -> int:
        return max(1, self.order - 1)

    def word_ids(self, words: Sequence[str]) -> np.ndarray:
        """Map word strings to LM vocab ids (OOV -> <unk>)."""
        assert self._py is None
        return self._ids(list(words))

    def base_score_batch_np(self, states: np.ndarray, state_lens: np.ndarray,
                            words: np.ndarray) -> np.ndarray:
        """Score n (state, word) pairs in ONE FFI call; states unchanged.

        states [n, cap] uint32 C-contiguous, state_lens [n] int32,
        words [n] uint32 -> [n] float64 log10."""
        assert self._py is None
        n, cap = states.shape
        out = np.zeros(n, np.float64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.lm_base_score_batch(
            self._h, np.ascontiguousarray(states).ctypes.data_as(_u32p),
            np.ascontiguousarray(state_lens).ctypes.data_as(i32p), cap,
            np.ascontiguousarray(words).ctypes.data_as(_u32p), n,
            out.ctypes.data_as(_f64p))
        return out

    def advance_batch_np(self, states: np.ndarray, state_lens: np.ndarray,
                         words: np.ndarray) -> None:
        """Advance n states by one word each, IN PLACE."""
        assert self._py is None
        n, cap = states.shape
        assert states.flags["C_CONTIGUOUS"] and state_lens.flags["C_CONTIGUOUS"]
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.lm_advance_batch(
            self._h, states.ctypes.data_as(_u32p),
            state_lens.ctypes.data_as(i32p), cap,
            np.ascontiguousarray(words).ctypes.data_as(_u32p), n)

    def score_batch_ids(self, flat_ids: np.ndarray, offsets: np.ndarray,
                        bos: bool = True, eos: bool = True) -> np.ndarray:
        """Sentence-level batch scoring over pre-mapped LM word ids: one FFI
        call, zero string work.  ``flat_ids`` [sum(lens)] uint32 (from
        ``token_id_table``), ``offsets`` [n+1] int64 row boundaries."""
        assert self._py is None
        n = len(offsets) - 1
        flat_ids = np.ascontiguousarray(flat_ids, np.uint32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        if flat_ids.size == 0:
            flat_ids = np.zeros(1, np.uint32)
        out = np.zeros(n, np.float64)
        self._lib.lm_score_batch(
            self._h, flat_ids.ctypes.data_as(_u32p),
            offsets.ctypes.data_as(_i64p), n,
            int(bos), int(eos), out.ctypes.data_as(_f64p))
        return out

    def token_id_table(self, vocab) -> np.ndarray:
        """[vocab_size] uint32 mapping decoder token ids -> LM word ids
        (OOV -> <unk>); built once and cached per vocab object."""
        assert self._py is None
        cache = getattr(self, "_tok_tables", None)
        if cache is None:
            cache = self._tok_tables = {}
        # key by id() but HOLD the vocab: a collected vocab's address can
        # be reused by a different Vocab, which would silently alias tables
        key = id(vocab)
        hit = cache.get(key)
        if hit is not None and hit[0] is vocab:
            return hit[1]
        n = max(vocab.int2word) + 1
        words = [vocab.int2word.get(i, "<unk>") for i in range(n)]
        tab = self.word_ids(words)
        cache[key] = (vocab, tab)
        return tab

    def num_ngrams(self) -> int:
        if self._py is not None:
            return len(self._py.grams)
        return int(self._lib.lm_num_ngrams(self._h))

    def dump_order(self, k: int):
        """Enumerate every order-``k`` entry for the on-device LM build
        (``lm/device_ngram.py``): (key_hi, key_lo, prob, backoff) uint32/
        uint32/f32/f32 arrays, uniform across text/probing/trie backends.
        k==1 keys are the word id itself (key_hi 0); k>=2 keys are
        kenlm's ngram_hash over the model's word ids."""
        assert self._py is None
        f32p = ctypes.POINTER(ctypes.c_float)
        z = np.zeros(1, np.uint32)
        zf = np.zeros(1, np.float32)
        n = int(self._lib.lm_dump_order(
            self._h, k, z.ctypes.data_as(_u32p), z.ctypes.data_as(_u32p),
            zf.ctypes.data_as(f32p), zf.ctypes.data_as(f32p), 0))
        if n < 0:
            raise ValueError(self._lib.lm_last_error().decode())
        hi = np.zeros(n, np.uint32)
        lo = np.zeros(n, np.uint32)
        prob = np.zeros(n, np.float32)
        backoff = np.zeros(n, np.float32)
        if n:
            got = int(self._lib.lm_dump_order(
                self._h, k, hi.ctypes.data_as(_u32p),
                lo.ctypes.data_as(_u32p), prob.ctypes.data_as(f32p),
                backoff.ctypes.data_as(f32p), n))
            assert got == n, (got, n)
        return hi, lo, prob, backoff

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.lm_free(h)
            except Exception:
                pass


def load_lm(path: Optional[str]) -> Optional[NgramLM]:
    """Reference main.py:78-84: a None path -> no LM; ARPA text or a KenLM
    binary -> ``NgramLM``."""
    return None if not path else NgramLM(path)
