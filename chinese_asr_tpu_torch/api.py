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

wav read + peak scale (in-process ``sox --norm=-1``) -> upload over the
flat (default) or padded wire -> featurization with per-utterance
instance norm (eps 1e-6, reference main.py:37) -> greedy/beam decode ->
winner picked on the device (or by the host rescorer) -> host detokenize.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without an explicit device the constructor raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

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
from .utils.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .vocab import SPECIALS, Vocab

_LATER = "comes with a later slice of the PyTorch port"


def _identity_vocab(n: int) -> Vocab:
    """Fallback vocab rendering ids as <id> markers (random weights)."""
    word2int = {t: i for i, t in enumerate(SPECIALS)}
    for i in range(4, n):
        word2int[f"<{i}>"] = i
    return Vocab(word2int, {i: w for w, i in word2int.items()})


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
                 mesh=None,
                 lm_mode: str = "second",
                 lm_topn: int = 20,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """``wire``: "flat" ships exactly sum(lens) samples and expands to
        the padded layout on the device (lossless); "padded" ships the
        zero-padded [B, N] matrix.  Without ``ckpt_path`` the weights are
        random, drawn from ``seed``.  The LM (ARPA text or ``.klm``) loads
        only for beam widths > 1 (main.py:78-84); ``lm_topn`` is the
        number of proposals per beam of ``lm_mode="first"``."""
        if lm_mode not in ("second", "second_host", "first"):
            raise ValueError(f"lm_mode={lm_mode!r}: one of second, "
                             f"second_host, first")
        use_lm = bool(lm_path and bw and bw > 1)
        if mesh is not None:
            raise NotImplementedError(f"multi-device decoding {_LATER}")
        if compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype={compute_dtype!r} "
                                      f"(bf16 inference) {_LATER}")
        if wire not in ("flat", "padded"):
            raise NotImplementedError(f"the lossy {wire!r} wire {_LATER}")
        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        self.bw = bw
        self.lm_mode = lm_mode
        self.lm_topn = lm_topn
        self.wav_bucket = wav_bucket
        self.wire = wire
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

    def _prep(self, wavs: List[np.ndarray], scales):
        """(wire buffer, lens [B] int32, scales [B] f32, padded length N).
        The flat wire concatenates the wavs with no padding bytes; the
        padded wire is the zero-padded [B, N] matrix.  A uniform int16
        batch ships raw PCM; any float wav makes it float32 (int16
        members are scaled on the host)."""
        wavs = [self._as_wav(w) for w in wavs]
        lens = np.array([len(w) for w in wavs], np.int32)
        N = audio_io.round_up(max(1, int(lens.max())), self.wav_bucket)
        all_i16 = all(w.dtype == np.int16 for w in wavs)
        dt = np.int16 if all_i16 else np.float32
        wavs = [w if w.dtype == dt else w.astype(np.float32) / 32768.0
                for w in wavs]
        if self.wire == "flat":
            total = int(lens.sum())
            buf = np.zeros(audio_io.round_up(max(1, total),
                                             8 * self.wav_bucket), dt)
            buf[:total] = np.concatenate(wavs) if total else 0
        else:
            buf = np.zeros((len(wavs), N), dt)
            for i, w in enumerate(wavs):
                buf[i, : len(w)] = w
        sc = (np.ones(len(wavs), np.float32) if scales is None
              else np.asarray(scales, np.float32))
        return buf, lens, sc, N

    def _featurize(self, prep):
        buf, lens, sc, N = prep
        dev = self.device
        buf_d = torch.from_numpy(buf).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        sc_d = torch.from_numpy(sc).to(dev)
        if self.wire == "flat":
            feats, feat_lens = features.featurize_flat(
                buf_d, lens_d, N, self.cfg.audio, norm_eps=1e-6, scale=sc_d)
        else:
            feats, feat_lens = features.featurize_batch(
                buf_d, lens_d, self.cfg.audio, norm_eps=1e-6, scale=sc_d)
        # degenerate (shorter than one frame) utterances attend to one zero
        # frame instead of an all -inf softmax mask
        return feats, torch.clamp(feat_lens, min=1)

    # ---- transcription ------------------------------------------------------
    def _decode(self, feats, feat_lens) -> List[str]:
        if not self.bw or self.bw <= 1:
            res = greedy_mod.greedy_decode(self.params, self.cfg, feats,
                                           feat_lens)
            return greedy_mod.finalize_greedy(res, self.vocab).pred_text
        dcfg = self.cfg.decode
        if self.dlm is not None and self.lm_mode == "first":
            best = lm_fused_mod.lm_fused_decode_best(
                self.params, self.cfg, self.bw, feats, feat_lens, self.dlm,
                self.tok2lm, self.lm_topn)
        elif self.dlm is not None:
            best = rescore_mod.beam_rescored_best(
                self.params, self.cfg, self.bw, feats, feat_lens, self.dlm,
                self.tok2lm, dcfg.lm_weight, dcfg.length_weight,
                self._lm_bos, self._lm_eos)
        elif self.lm is not None:
            # only the finite n-best slots cross to the host rescorer
            res = beam_mod.beam_decode(self.params, self.cfg, self.bw,
                                       feats, feat_lens)
            return beam_mod.finalize_beam(
                beam_mod.compact_nbest(res), self.cfg, self.vocab,
                lm_model=self.lm, second_pass=True,
                lm_weight=dcfg.lm_weight,
                length_weight=dcfg.length_weight).pred_text
        else:
            best = beam_mod.beam_decode_best(self.params, self.cfg, self.bw,
                                             feats, feat_lens)
        return beam_mod.finalize_best(best, self.vocab).pred_text

    def transcribe_wavs(self, wavs: Sequence[np.ndarray],
                        max_batch: int = 128, scales=None) -> List[str]:
        """Transcribe a list of waveforms.  Lists longer than ``max_batch``
        are length-sorted and chunked (order restored), so a chunk pads
        only to its own longest wav.  ``scales`` (one float per wav) is a
        per-utterance gain applied on the device."""
        if not wavs:
            return []
        wavs = list(wavs)
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i])) \
            if len(wavs) > max_batch else list(range(len(wavs)))
        out: List[str] = [""] * len(wavs)
        for s in range(0, len(order), max_batch):
            idx = order[s:s + max_batch]
            prep = self._prep([wavs[i] for i in idx],
                              None if scales is None
                              else [scales[i] for i in idx])
            for i, text in zip(idx, self._decode(*self._featurize(prep))):
                out[i] = text
        return out

    def transcribe_files(self, paths: Sequence[str]) -> List[str]:
        """Wav files -> transcripts: raw PCM16 plus a device-side peak gain
        (the ``sox --norm=-1`` math of the reference's ingest)."""
        wavs, scales = [], []
        for p in paths:
            if not p.lower().endswith(".wav"):
                raise NotImplementedError(
                    f"{p}: non-wav ingest (ffmpeg transcode) {_LATER}")
            wav, _ = audio_io.read_wav(p, self.cfg.audio.sample_rate,
                                       dtype="int16")
            wavs.append(wav)
            scales.append(audio_io.peak_scale(wav))
        return self.transcribe_wavs(wavs, scales=scales)

    def __call__(self, path: str) -> str:
        """One utterance in, transcript out (main.py:100-102)."""
        return self.transcribe_files([path])[0]


def main(argv: Optional[List[str]] = None) -> None:
    """CLI (the argparse interface the reference sketches, main.py:107-120)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="chinese_asr_tpu_torch transcriber (PyTorch/CUDA)")
    ap.add_argument("--wav", nargs="+", required=True, help="wav file(s)")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    asr = ASR(ckpt_path=args.ckpt, lm_path=args.lm, bw=args.bw,
              vocab=args.vocab, lm_mode=args.lm_mode, device=args.device)
    for path, text in zip(args.wav, asr.transcribe_files(args.wav)):
        print(f"{path}\t{text}")


if __name__ == "__main__":
    main()
