"""Public API / CLI (port of ``chinese_asr_tpu/api.py``, reference main.py):

  1. greedy                 ASR(ckpt)                      bw in (None, 0, 1)
  2. beam search            ASR(ckpt, bw=4/8/16)
  3. beam + LM second pass  ASR(ckpt, lm_path=..., bw>1)   rescore n-best
     -- on the device by default (``decode/rescore.py``: the n-gram
     tables live on ``device``, the beam tracks LM totals and the winner
     is picked there); ``lm_mode="second_host"`` rescores the n-best on
     the host through the C++ LM (the oracle)
  4. LM-driven first pass   ASR(..., lm_mode="first")     the n-gram LM
     on the device picks the tokens among the decoder's top-``lm_topn``
     proposals (``decode/lm_fused.py``)

The LM is an ARPA text file or a KenLM binary (``.klm``), read by the C++
reader of ``lm/ngram.py`` in every mode.

[optional ffmpeg transcode] -> wav read + peak scale (in-process ``sox
--norm=-1``) -> upload over the flat (default), padded, 8-bit mu-law or
4-bit ADPCM wire -> featurization with per-utterance instance norm (eps
1e-6, reference main.py:37) -> greedy/beam decode (in float32, or with
``compute_dtype="bfloat16"`` weights and activations in bf16 and the
score arithmetic in float32) -> winner picked on the device (or by
the host rescorer) -> host detokenize.  ``transcribe_bytes`` takes audio
bytes, ``transcribe_long`` cuts long audio at silences, and the CLI's
``--serve``/``--serve-http`` keep a model loaded (``serve.py``).

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without an explicit device the constructor raises.  On one card the
front end is one graph a key and the decode one graph whose loop tests
its stop flag on the card, so ``_decode_dispatch`` returns while the card
decodes and ``transcribe_wavs`` prepares the next chunk meanwhile (JAX's
dispatch-ahead order); ``_decode_finalize`` reads the result.

Over a (data x model) mesh (``mesh=``, ``parallel/sharding.py``) every
rank is one process that is called with the same wavs: it prepares and
uploads only its data shard of each chunk, in the chunk's globally padded
layout, decodes it with its V/mp slice of the embedding and the
projection, and returns the whole call's transcripts.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .audio import features
from .config import Config
from .data import audio_io
from .decode import beam as beam_mod
from .decode import greedy as greedy_mod
from .decode import lm_fused as lm_fused_mod
from .decode import rescore as rescore_mod
from .lm import ngram
from .lm.device_ngram import DeviceNgramLM
from .models import las
from .parallel import sharding
from .utils.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .utils.observe import span
from .vocab import SPECIALS, Vocab

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WIRES = ("flat", "mulaw", "adpcm", "padded")


def _identity_vocab(n: int) -> Vocab:
    """Fallback vocab rendering ids as <id> markers (random weights)."""
    word2int = {t: i for i, t in enumerate(SPECIALS)}
    for i in range(4, n):
        word2int[f"<{i}>"] = i
    return Vocab(word2int, {i: w for w, i in word2int.items()})


class _Upload(NamedTuple):
    """A prepared batch on its way to the device: the (wire buffer, lens,
    scales) tensors and the padded length N; on the card also the event
    recorded after their copies and the pinned host buffers they are
    copied from, kept alive until that event has completed.  ``offset``:
    the sample of the flat buffer at which the first row starts (a mesh
    rank's rows of a whole chunk's ADPCM wire; else 0)."""
    tensors: tuple
    N: int
    done: Optional[torch.cuda.Event]
    pinned: Optional[list]
    offset: int = 0


class _InFlight(NamedTuple):
    """A dispatched decode on the card: its result with the fields the
    finalization reads on their way to pinned host memory, and the event
    after those copies.  The copies are queued right behind the decode,
    so a finalization waits for its own batch alone, not for the batches
    dispatched after it (JAX's result buffers reach the host that way)."""
    res: tuple
    ready: torch.cuda.Event


class ASR:
    """Speech recognizer service (reference ASR, main.py:68-102)."""

    def __init__(self, ckpt_path: Optional[str] = None,
                 lm_path: Optional[str] = None,
                 bw: Optional[int] = None,
                 cfg: Optional[Config] = None,
                 vocab: Union[Vocab, str, None] = None,
                 wav_bucket: int = 16000,
                 compute_dtype: str = "float32",
                 wire: str = "flat",
                 flat_pow2: bool = False,
                 mesh=None,
                 lm_mode: str = "second",
                 lm_topn: int = 20,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """``wire``: "flat" ships exactly sum(lens) samples and expands to
        the padded layout on the device (lossless); "mulaw" companders
        them to 8-bit mu-law codes (half the bytes, lossy); "adpcm" codes
        4-bit block-adaptive ADPCM (a quarter, lossy; decoded on the card
        by kernel K5); "padded" ships the zero-padded [B, N] matrix.  The
        lossy wires need int16 PCM: a batch holding a float wav ships
        over the float32 flat wire.  The flat buffer's length rounds up to
        a multiple of ``8 * wav_bucket``, or with ``flat_pow2`` to the
        next power-of-two multiple of ``wav_bucket``: at most 2x wire
        padding, but log-many buffer shapes for a server's arbitrary
        traffic (``serve.MicroBatcher`` pairs it with its power-of-two
        batch ladder).  Without ``ckpt_path`` the weights are
        random, drawn from ``seed``.  ``compute_dtype="bfloat16"`` casts
        the floating weights and the features to bf16 (the front end
        runs in float32; the decode's scores stay float32).  The LM
        (ARPA text or ``.klm``) loads only for beam widths > 1
        (main.py:78-84); ``lm_topn`` is the number of proposals per beam
        of ``lm_mode="first"``.

        ``mesh``: a ``DeviceMesh`` from ``sharding.make_mesh``, or "auto"
        (the whole world, ``cfg.mesh``'s layout): the parameters take this
        rank's shard, the LM tables load on every rank, each call pads to
        a multiple of the data axis with one-sample wavs whose transcripts
        are dropped, and ``max_batch`` is clamped to a multiple of it (JAX
        ``api.py``).  A rank ships its rows of each chunk over the wire the
        whole chunk takes on one device, so its transcripts are one
        device's."""
        if lm_mode not in ("second", "second_host", "first"):
            raise ValueError(f"lm_mode={lm_mode!r}: one of second, "
                             f"second_host, first")
        use_lm = bool(lm_path and bw and bw > 1)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={compute_dtype!r}: one of "
                             f"{', '.join(_DTYPES)}")
        if wire not in _WIRES:
            raise ValueError(f"wire={wire!r}: one of {', '.join(_WIRES)}")
        self.cfg = cfg or Config()
        self.mesh = mesh = sharding.resolve_mesh(mesh, self.cfg, device)
        self.device = resolve_device(device)
        self.bw = bw
        self.lm_mode = lm_mode
        self.lm_topn = lm_topn
        self.wav_bucket = wav_bucket
        self.wire = wire
        self.flat_pow2 = flat_pow2
        self.compute_dtype = _DTYPES[compute_dtype]
        self._copy_stream = None        # the card's upload stream, at first use
        self._calls = 0                 # transcribe_wavs calls, for the spans
        if isinstance(vocab, str):
            self.vocab = Vocab.load(vocab)
        elif isinstance(vocab, Vocab):
            self.vocab = vocab
        else:
            self.vocab = _identity_vocab(self.cfg.vocab.vocab_size)

        # "second": the tables on the device, LM totals tracked by the
        # beam, the winner picked there; "second_host": the host rescorer;
        # "first": the tables on the device drive the search
        self.lm = ngram.load_lm(lm_path) \
            if (use_lm and lm_mode == "second_host") else None
        self.dlm = self.tok2lm = None
        self._lm_bos = self._lm_eos = None
        if use_lm and lm_mode in ("second", "first"):
            self.dlm = DeviceNgramLM.from_path(lm_path, self.device)
            self.tok2lm = torch.from_numpy(
                self.dlm.token_id_table(self.vocab)).to(self.device,
                                                        torch.int64)
            bos_eos = self.dlm.word_ids(["<s>", "</s>"])
            self._lm_bos, self._lm_eos = int(bos_eos[0]), int(bos_eos[1])

        if ckpt_path is None:
            self.params = las.init_params(self.cfg, seed, self.device)
        elif ckpt_path.endswith(".ckpt") and self._is_torch_ckpt(ckpt_path):
            self.params = las.load_torch_checkpoint(ckpt_path, self.cfg,
                                                    self.device)
        else:
            self.params = las.params_from_numpy(
                load_checkpoint(ckpt_path)["params"], self.device)

        emb_rows = self.params["decoder"]["embedding"].shape[0]
        if emb_rows != self.cfg.vocab.vocab_size:
            raise ValueError(
                f"checkpoint vocab size {emb_rows} != config vocab size "
                f"{self.cfg.vocab.vocab_size}; pass cfg=Config().with_("
                f"'vocab', max_num_words={emb_rows - 4})")
        if self.compute_dtype != torch.float32:
            self.params = las.tree_map(
                lambda t: t.to(self.compute_dtype)
                if t.is_floating_point() else t, self.params)
        if mesh is not None:
            self.params = sharding.shard_params(self.params, self.cfg, mesh)

    @staticmethod
    def _is_torch_ckpt(path: str) -> bool:
        """torch.save zip archives start with PK; our pickles don't."""
        with open(path, "rb") as f:
            return f.read(2) == b"PK"

    # ---- host preparation + upload ------------------------------------------
    @staticmethod
    def _as_wav(w) -> np.ndarray:
        """Integer PCM stays int16 (the featurizer does the /32768 on the
        device); floats pass through as float32."""
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            return w.astype(np.int16)
        return w.astype(np.float32)

    def _flat_len(self, total: int) -> int:
        n = max(1, total)
        if not self.flat_pow2:
            return audio_io.round_up(n, 8 * self.wav_bucket)
        b = self.wav_bucket
        while b < n:
            b *= 2
        return b

    def _prep_rows(self, wavs: List[np.ndarray], scales, rows: slice):
        """A mesh rank's ``rows`` of a chunk, prepared as one device
        prepares the whole chunk -> (``_prep``'s tuple, offset): the
        chunk's padded length N and its wire (a float wav anywhere in the
        chunk puts every rank on the float32 flat wire).  ADPCM blocks
        span rows, so over that wire each rank codes the whole chunk's
        buffer, as one device does, and ``offset`` is the sample at which
        its first row starts; over the others it ships its own rows."""
        N = audio_io.round_up(max(1, max(len(w) for w in wavs)),
                              self.wav_bucket)
        i16 = all(np.issubdtype(np.asarray(w).dtype, np.integer)
                  for w in wavs)
        if i16 and self.wire == "adpcm":
            buf, lens, sc, N = self._prep(wavs, scales)
            return (buf, lens[rows], sc[rows], N), int(lens[:rows.start].sum())
        mine = [self._as_wav(w) for w in wavs[rows]]
        if not i16:
            mine = [w if w.dtype == np.float32
                    else w.astype(np.float32) / 32768.0 for w in mine]
        return self._prep(mine, None if scales is None else scales[rows],
                          N), 0

    def _prep(self, wavs: List[np.ndarray], scales, N: Optional[int] = None):
        """(wire buffer, lens [B] int32, scales [B] f32, padded length N;
        ``N`` given: a mesh rank's rows of a chunk padded to the chunk's
        N, ``_prep_rows``).
        The flat wires concatenate the wavs with no padding bytes (as raw
        PCM, mu-law codes, or the ADPCM wire of the buffer rounded up to
        whole blocks); the padded wire is the zero-padded [B, N] matrix.
        A uniform int16 batch ships raw PCM (or its lossy code); any
        float wav makes it float32 (int16 members are scaled on the
        host)."""
        wavs = [self._as_wav(w) for w in wavs]
        lens = np.array([len(w) for w in wavs], np.int32)
        if N is None:
            N = audio_io.round_up(max(1, int(lens.max())), self.wav_bucket)
        all_i16 = all(w.dtype == np.int16 for w in wavs)
        dt = np.int16 if all_i16 else np.float32
        wavs = [w if w.dtype == dt else w.astype(np.float32) / 32768.0
                for w in wavs]
        if self.wire != "padded":
            codec = self.wire if all_i16 else "flat"
            total = int(lens.sum())
            n = self._flat_len(total)
            if codec == "adpcm":
                # whole blocks: a multiple of wav_bucket need not be one
                # of ADPCM_K, and the block boundaries fix the code
                n = audio_io.round_up(n, features.ADPCM_K)
            buf = np.zeros(n, dt)
            buf[:total] = np.concatenate(wavs) if total else 0
            if codec == "adpcm":
                buf = features.adpcm_encode_flat(buf)
            elif codec == "mulaw":                  # padding bytes stay 0
                code = np.zeros(n, np.uint8)
                code[:total] = features.mulaw_encode_i16(buf[:total])
                buf = code
        else:
            buf = np.zeros((len(wavs), N), dt)
            for i, w in enumerate(wavs):
                buf[i, : len(w)] = w
        sc = (np.ones(len(wavs), np.float32) if scales is None
              else np.asarray(scales, np.float32))
        return buf, lens, sc, N

    def _upload(self, prep, offset: int = 0) -> _Upload:
        """Issue the host->device copy of a ``_prep``-ed batch.  On the card
        the arrays go through pinned buffers on a side stream, so the copy
        can run beside the compute stream's work, and an event marks its
        end; ``_featurize`` makes the compute stream wait on
        it.  On the CPU the tensors are the arrays themselves."""
        buf, lens, sc, N = prep
        host = [torch.from_numpy(a) for a in (buf, lens, sc)]
        if self.device.type != "cuda":
            return _Upload(tuple(t.to(self.device) for t in host), N,
                           None, None, offset)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(self._copy_stream):
            tensors = tuple(t.to(self.device, non_blocking=True)
                            for t in pinned)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return _Upload(tensors, N, done, pinned, offset)

    def _featurize(self, up: _Upload):
        """The features of an uploaded batch, (feats in ``compute_dtype``,
        feat_lens clamped to 1): one device program a key
        (``features.front_end_jit``: the wire, the buffer's length and
        type, B, N, the dtype), JAX's ``_feat_fns``; a mesh featurizes
        eagerly."""
        buf_d, lens_d, sc_d = up.tensors
        if up.done is not None:
            # the compute stream waits for the copy; the tensors, made on
            # the copy stream, are marked in use by the compute stream so
            # the allocator does not hand their memory out before it is done
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(up.done)
            for t in up.tensors:
                t.record_stream(stream)
        # a batch holding a float wav ships over the float32 flat wire
        # whatever ``wire`` says, so the buffer's dtype picks the decode
        wire = self.wire
        if wire == "adpcm" and buf_d.dtype != torch.uint8:
            wire = "flat"
        elif wire == "mulaw":
            wire = "flat"           # the codes' dtype picks their decode
        fe = features.front_end if self.mesh is not None \
            else features.front_end_jit
        return fe(wire, buf_d, lens_d, sc_d, up.N, self.cfg.audio,
                  norm_eps=1e-6, dtype=self.compute_dtype, offset=up.offset)

    # ---- transcription ------------------------------------------------------
    def _decode_dispatch(self, featurized):
        """Start the decode of a featurized batch and return its result on
        the device, as JAX's ``_decode_dispatch`` does: one device issues
        the ``*_jit`` program JAX picks for the mode (greedy,
        ``beam_best``, ``beam`` before the host LM, ``beam_rescored_best``,
        ``lm_fused_best``), queues the copy of its result to pinned host
        memory behind it (``_to_host``) and returns while the card
        decodes.  On the CPU the result is finished; on a mesh (``feats``
        this rank's shard) it is the whole batch's, decoded by the eager
        functions."""
        feats, feat_lens = featurized
        mesh = self.mesh
        dcfg = self.cfg.decode
        p, cfg, bw = self.params, self.cfg, self.bw
        if mesh is not None:
            return self._decode_mesh(feats, feat_lens)
        if not bw or bw <= 1:
            # the [B, max_len, L] alignments stay on the card: unread
            return self._to_host(greedy_mod.greedy_decode_jit(
                p, cfg, feats, feat_lens), skip=("alignments",))
        if self.dlm is not None and self.lm_mode == "first":
            res = lm_fused_mod.lm_fused_decode_best_jit(
                p, cfg, bw, feats, feat_lens, self.dlm, self.tok2lm,
                self.lm_topn)
        elif self.dlm is not None:
            res = rescore_mod.beam_rescored_best_jit(
                p, cfg, bw, feats, feat_lens, self.dlm, self.tok2lm,
                dcfg.lm_weight, dcfg.length_weight, self._lm_bos,
                self._lm_eos)
        elif self.lm is None:
            res = beam_mod.beam_decode_best_jit(p, cfg, bw, feats, feat_lens)
        else:
            # the whole n-best crosses (~13 MB at B=128, bw 16); the
            # host compacts it before the host LM rescores it
            res = beam_mod.beam_decode_jit(p, cfg, bw, feats, feat_lens)
        return self._to_host(res)

    def _decode_mesh(self, feats, feat_lens):
        """A mesh rank's decode through the eager functions: the whole
        batch's result, finished."""
        mesh, p, cfg, bw = self.mesh, self.params, self.cfg, self.bw
        dcfg = cfg.decode
        if not bw or bw <= 1:
            return sharding.gather_rows(greedy_mod.greedy_decode(
                p, cfg, feats, feat_lens, mesh), mesh)
        if self.dlm is not None and self.lm_mode == "first":
            return lm_fused_mod.lm_fused_decode_best(
                p, cfg, bw, feats, feat_lens, self.dlm, self.tok2lm,
                self.lm_topn, mesh)
        if self.dlm is not None:
            return rescore_mod.beam_rescored_best(
                p, cfg, bw, feats, feat_lens, self.dlm, self.tok2lm,
                dcfg.lm_weight, dcfg.length_weight, self._lm_bos,
                self._lm_eos, mesh)
        if self.lm is None:
            return beam_mod.beam_decode_best(p, cfg, bw, feats, feat_lens,
                                             mesh)
        return sharding.gather_rows(beam_mod.beam_decode(
            p, cfg, bw, feats, feat_lens, mesh=mesh), mesh)

    def _to_host(self, res, skip=()):
        """``res`` (a named tuple of tensors) with each field but ``skip``
        copied into pinned host memory behind the work queued so far, as
        an ``_InFlight``; on the CPU ``res`` itself."""
        if self.device.type != "cuda":
            return res
        host = {}
        for name, t in res._asdict().items():
            if name not in skip:
                host[name] = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                host[name].copy_(t, non_blocking=True)
        return _InFlight(res._replace(**host), torch.cuda.current_stream(
            self.device).record_event())

    def _decode_finalize(self, res) -> List[str]:
        """The transcripts of a ``_decode_dispatch`` result: its host copy
        waited for, then detokenized (the host LM's second pass first
        compacts the n-best, then rescores it on the host)."""
        with span("asr.finalize.wait"):
            if isinstance(res, _InFlight):
                res.ready.synchronize()
                res = res.res
        with span("asr.finalize.detok"):
            if not self.bw or self.bw <= 1:
                return greedy_mod.finalize_greedy(res, self.vocab).pred_text
            if self.dlm is not None or self.lm is None:
                # the winner is picked on the device (with the LM's totals
                # under a device LM)
                return beam_mod.finalize_best(res, self.vocab).pred_text
            dcfg = self.cfg.decode
            # only the finite n-best slots cross to the host rescorer
            return beam_mod.finalize_beam(
                beam_mod.compact_nbest(res), self.cfg, self.vocab,
                lm_model=self.lm, second_pass=True, lm_weight=dcfg.lm_weight,
                length_weight=dcfg.length_weight).pred_text

    def _decode_batch(self, featurized) -> List[str]:
        """The transcripts of a featurized batch, serially."""
        return self._decode_finalize(self._decode_dispatch(featurized))

    def transcribe_wavs(self, wavs: Sequence[np.ndarray],
                        max_batch: int = 128, scales=None) -> List[str]:
        """Transcribe a list of waveforms.  Lists longer than ``max_batch``
        are length-sorted and chunked (order restored), so a chunk pads
        only to its own longest wav.  The chunks run in JAX's order:
        chunk c is featurized and its decode dispatched, then chunk c+1 is
        prepared on the host and its copy issued, then chunk c-1 is
        finalized, all while the card decodes chunk c; the last chunk is
        finalized at the end.  ``scales`` (one float per wav) is a
        per-utterance gain applied on the device.

        On a mesh every rank is called with the same wavs; ``max_batch``
        is clamped to a multiple of the data axis and the call padded to
        one with one-sample wavs, whose transcripts are dropped.  A mesh's
        dispatch returns its decode finished, so its chunks run
        serially.

        The call's spans (``utils/observe.py``): ``asr.call`` around it,
        and for each chunk ``asr.prep``, ``asr.upload``,
        ``asr.featurize``, ``asr.dispatch`` and ``asr.finalize`` around
        its stages, each with the chunk's index."""
        if not wavs:
            return []
        wavs = list(wavs)
        n_real = len(wavs)
        dp = sharding.data_size(self.mesh)
        if dp > 1:
            max_batch = max(dp, max_batch - max_batch % dp)
        pad = (-n_real) % dp
        self._calls += 1
        call = self._calls
        with span("asr.call", lambda: f"call {call} rows {n_real} chunks "
                  f"{-(-(n_real + pad) // max_batch)}"):
            if pad:
                dt = np.int16 if all(np.issubdtype(np.asarray(w).dtype,
                                                   np.integer)
                                     for w in wavs) else np.float32
                wavs += [np.zeros(1, dt)] * pad
                if scales is not None:
                    scales = list(scales) + [1.0] * pad
            order = sorted(range(len(wavs)), key=lambda i: len(wavs[i])) \
                if len(wavs) > max_batch else list(range(len(wavs)))
            chunks = [order[s:s + max_batch]
                      for s in range(0, len(order), max_batch)]

            def upload(c):      # one chunk at a time: host memory O(chunk)
                idx = chunks[c]
                chunk = [wavs[i] for i in idx]
                sc = None if scales is None else [scales[i] for i in idx]

                def prep_detail():
                    N = audio_io.round_up(max(1, max(map(len, chunk))),
                                          self.wav_bucket)
                    return f"chunk {c} B {len(idx)} N {N}"
                with span("asr.prep", prep_detail):
                    if self.mesh is None:
                        prep = (self._prep(chunk, sc),)
                    else:
                        prep = self._prep_rows(
                            chunk, sc, sharding.row_slice(len(idx), self.mesh))
                with span("asr.upload", lambda: f"chunk {c} bytes "
                          f"{sum(a.nbytes for a in prep[0][:3])}"):
                    return self._upload(*prep)

            out: List[str] = [""] * len(wavs)

            def finalize(pend):
                c, _, res = pend
                with span("asr.finalize", lambda: f"chunk {c}"):
                    texts = self._decode_finalize(res)
                for i, text in zip(chunks[c], texts):
                    out[i] = text
                # the upload (its pinned buffers) lived until here: the
                # decode the finalization read waited for its copy

            up = upload(0)
            pend = None     # (chunk index, its upload, in-flight result)
            for c in range(len(chunks)):
                with span("asr.featurize", lambda: f"chunk {c}"):
                    feats = self._featurize(up)
                with span("asr.dispatch", lambda: f"chunk {c}"):
                    res = self._decode_dispatch(feats)
                cur, up = up, (upload(c + 1) if c + 1 < len(chunks)
                               else None)
                if pend is not None:
                    finalize(pend)
                pend = (c, cur, res)
            finalize(pend)
            return out[:n_real]

    def transcribe_files(self, paths: Sequence[str],
                         transcode: bool = False) -> List[str]:
        """Audio files -> transcripts.  A wav is read as raw PCM16 with a
        device-side peak gain (the ``sox --norm=-1`` math of the
        reference's ingest); other formats, or every file under
        ``transcode``, go through ffmpeg (``audio_io.transcode``) and are
        peak-normalized on the host."""
        wavs, scales = [], []
        for p in paths:
            if transcode or not p.lower().endswith(".wav"):
                with tempfile.NamedTemporaryFile(suffix=".wav",
                                                 delete=False) as tf:
                    tmp = tf.name
                try:
                    audio_io.transcode(p, tmp, self.cfg.audio.sample_rate)
                    wav, _ = audio_io.read_wav(tmp,
                                               self.cfg.audio.sample_rate)
                finally:
                    os.unlink(tmp)
                scales.append(1.0)
            else:
                wav, _ = audio_io.read_wav(p, self.cfg.audio.sample_rate,
                                           dtype="int16")
                scales.append(audio_io.peak_scale(wav))
            wavs.append(wav)
        return self.transcribe_wavs(wavs, scales=scales)

    def __call__(self, path: str) -> str:
        """One utterance in, transcript out (main.py:100-102)."""
        return self.transcribe_files([path])[0]

    def transcribe_bytes(self, data: bytes, suffix: str = "") -> str:
        """Transcribe audio BYTES (the in-memory service variant the
        reference sketches, main.py:9-16).  WAV bytes decode directly;
        anything else goes through ffmpeg.  ``suffix`` (e.g. ".amr") helps
        ffmpeg pick a demuxer for headerless containers."""
        is_wav = data[:4] == b"RIFF" and data[8:12] == b"WAVE"
        with tempfile.NamedTemporaryFile(
                suffix=suffix or (".wav" if is_wav else ".bin"),
                delete=False) as tf:
            tf.write(data)
            tmp = tf.name
        try:
            return self.transcribe_files([tmp], transcode=not is_wav)[0]
        finally:
            os.unlink(tmp)

    def transcribe_long(self, path: str, chunk_s: float = 10.0,
                        search_s: float = 0.5) -> str:
        """Long-form audio beyond the reference's 10-second guidance (its
        comment at main.py:34): split into DISJOINT ~``chunk_s`` windows,
        each cut at the lowest-energy sample within +-``search_s`` of the
        nominal boundary so chunks break at silence, decode the chunks in
        one call and concatenate their transcripts.  Disjoint cuts mean no
        audio is transcribed twice."""
        wav, _ = audio_io.read_wav(path, self.cfg.audio.sample_rate,
                                   dtype="int16")
        gain = audio_io.peak_scale(wav)     # peak-normalize on the device
        sr = self.cfg.audio.sample_rate
        step = int(chunk_s * sr)
        search = max(1, int(search_s * sr))
        if len(wav) <= step + search:
            return self.transcribe_wavs([wav], scales=[gain])[0]
        smooth = max(1, int(0.025 * sr))           # 25 ms energy window
        cuts = [0]
        while cuts[-1] + step < len(wav) - search:
            c = cuts[-1] + step
            lo = max(cuts[-1] + search, c - search)
            hi = min(len(wav) - 1, c + search)
            energy = np.convolve(
                np.square(wav[lo:hi].astype(np.float64)),
                np.ones(smooth) / smooth, mode="same")
            cuts.append(lo + int(np.argmin(energy)))
        cuts.append(len(wav))
        chunks = [wav[a:b] for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
        return "".join(self.transcribe_wavs(chunks,
                                            scales=[gain] * len(chunks)))


def main(argv: Optional[List[str]] = None) -> None:
    """CLI (the argparse interface the reference sketches, main.py:107-120)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="chinese_asr_tpu_torch transcriber (PyTorch/CUDA)")
    ap.add_argument("--wav", nargs="*", default=[],
                    help="audio file(s); optional under --serve/--serve-http")
    ap.add_argument("--ckpt", default=None, help="checkpoint path "
                    "(chinese_asr_tpu.v1 .ckpt or reference torch .ckpt); "
                    "random weights when omitted")
    ap.add_argument("--vocab", default=None, help="dict.pkl path")
    ap.add_argument("--lm", default=None, help="n-gram LM path "
                    "(ARPA text or KenLM binary .klm)")
    ap.add_argument("--lm-mode", default="second",
                    choices=("second", "second_host", "first"),
                    help="second: n-best rescore on the device; "
                         "second_host: n-best rescore on the host; first: "
                         "the LM-driven first pass on the device")
    ap.add_argument("--bw", type=int, default=None, help="beam width")
    ap.add_argument("--transcode", action="store_true",
                    help="force ffmpeg ingest")
    ap.add_argument("--serve", action="store_true",
                    help="after the --wav files, read audio paths from "
                         "stdin, one transcript per line")
    ap.add_argument("--serve-http", type=int, default=None, metavar="PORT",
                    help="serve POST /transcribe (audio bytes -> JSON) "
                         "with request micro-batching; see serve.py")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if not args.wav and args.serve_http is None and not args.serve:
        ap.error("nothing to do: pass --wav and/or --serve/--serve-http")

    asr = ASR(ckpt_path=args.ckpt, lm_path=args.lm, bw=args.bw,
              vocab=args.vocab, lm_mode=args.lm_mode, device=args.device)
    if args.wav:
        for path, text in zip(args.wav, asr.transcribe_files(
                args.wav, transcode=args.transcode)):
            print(f"{path}\t{text}", flush=True)
    if args.serve_http is not None:
        from .serve import serve_http
        server = serve_http(asr, port=args.serve_http, host="0.0.0.0")
        print(f"serving on :{server.server_port}", flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
    if args.serve:
        import sys
        for line in sys.stdin:
            path = line.strip()
            if not path:
                continue
            try:
                print(f"{path}\t{asr(path)}", flush=True)
            except Exception as e:                  # report it, keep serving
                print(f"{path}\tERROR: {e}", flush=True)


if __name__ == "__main__":
    main()
