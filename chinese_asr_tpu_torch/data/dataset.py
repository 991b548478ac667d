"""Dataset / sampler / loader (port of ``chinese_asr_tpu/data/dataset.py``,
reference data.py:346-540).

* The host only reads wavs, augments and tokenizes; raw 16 kHz samples go
  to the device, and the featurizer runs there (``batches_to_device``
  through ``audio/features.featurize_batch``, so on the card through K1).
* Batches are padded to fixed shapes whose lengths round up to bucket
  multiples (``wav_bucket`` samples, ``text_bucket`` tokens) in place of
  the reference's ``PackedSequence`` collation (data.py:478-493).
* ``train_sampler_order`` keeps the reference's TrainSampler (data.py:
  346-367): a global shuffle, then a length sort inside windows of
  ``shuffle_updates * batch`` utterances.

Manifest format: one UTF-8 line per utterance, ``path<TAB>text`` (text
empty or absent for inference).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..vocab import Vocab
from . import audio_io, augment as aug_mod
from .audio_io import round_up

__all__ = ["Batch", "Utterance", "read_manifest", "write_manifest",
           "AudioDataset", "train_sampler_order", "round_up", "Loader",
           "make_train_loader", "make_eval_loader", "prefetch",
           "batches_to_device"]


class Batch(NamedTuple):
    """Teacher-forcing batch on the device (the fields of JAX
    ``train/step.py`` ``Batch``).

    feats      [B, T, D]  zero-padded features
    feat_lens  [B]        true feature lengths
    tokens_in  [B, S]     <s> + text            (reference data.py:485-487)
    tokens_out [B, S]     text + </s>
    text_lens  [B]        true lengths of tokens_out (incl. eos)
    """

    feats: torch.Tensor
    feat_lens: torch.Tensor
    tokens_in: torch.Tensor
    tokens_out: torch.Tensor
    text_lens: torch.Tensor


@dataclass
class Utterance:
    path: str
    text: Optional[str] = None
    num_samples: Optional[int] = None


def read_manifest(path: str) -> List[Utterance]:
    utts = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            utts.append(Utterance(parts[0],
                                  parts[1] if len(parts) > 1 else None))
    return utts


def write_manifest(path: str, utts: Sequence[Utterance]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for u in utts:
            f.write(u.path + ("\t" + u.text if u.text is not None else "")
                    + "\n")


class AudioDataset:
    """mode: 'train' (augment + dither + tokens), 'eval' (tokens), 'infer'
    (audio only) -- reference AudioDst modes (data.py:392-459)."""

    def __init__(self, utts: Sequence[Utterance], cfg: Config, vocab: Vocab,
                 mode: str = "train", seed: int = 0):
        if mode not in ("train", "eval", "infer"):
            raise ValueError(f"mode={mode!r}: one of train, eval, infer")
        self.utts = list(utts)
        self.cfg = cfg
        self.vocab = vocab
        self.mode = mode
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.utts)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, Optional[List[int]]]:
        u = self.utts[i]
        if self.mode == "train":
            wav, _ = audio_io.read_wav(u.path, self.cfg.audio.sample_rate)
            wav = aug_mod.augment(wav, self.cfg.augment, self.rng,
                                  self.cfg.audio.sample_rate)
            if self.cfg.audio.dither > 0:
                # train-only Gaussian dither (reference data.py:199-200)
                wav = wav + (self.cfg.audio.dither *
                             self.rng.randn(len(wav))).astype(np.float32)
            wav = wav.astype(np.float32)
        else:
            # eval/infer: raw PCM16 to the device, where the featurizer
            # does the /32768 (half the host->device bytes)
            wav, _ = audio_io.read_wav(u.path, self.cfg.audio.sample_rate,
                                       dtype="int16")
        ids = None
        if self.mode != "infer":
            # text -> ids with <unk> fallback (data.py:444-459)
            ids = self.vocab.encode(u.text or "")
        return wav, ids

    def sample_lengths(self) -> np.ndarray:
        """Utterance lengths in samples (cached in the manifest when
        available; otherwise read from the wavs once)."""
        out = np.zeros(len(self.utts), np.int64)
        for i, u in enumerate(self.utts):
            if u.num_samples is None:
                wav, _ = audio_io.read_wav(u.path, None)
                u.num_samples = len(wav)
            out[i] = u.num_samples
        return out


def train_sampler_order(lengths: np.ndarray, batch_size: int,
                        shuffle_updates: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Reference TrainSampler (data.py:346-367): shuffle everything, then
    length-sort inside each window of shuffle_updates*batch_size."""
    n = len(lengths)
    order = rng.permutation(n)
    window = max(1, shuffle_updates * batch_size)
    for s in range(0, n, window):
        chunk = order[s:s + window]
        order[s:s + window] = chunk[np.argsort(lengths[chunk], kind="stable")]
    return order


class Loader:
    """Collates padded fixed-shape host batches.

    Wav lengths pad to multiples of ``wav_bucket`` samples and token
    lengths to multiples of ``text_bucket``, so the shapes the device sees
    stay few (the reference re-packs per batch instead, data.py:478-540)."""

    def __init__(self, dataset: AudioDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 wav_bucket: int = 4800, text_bucket: int = 8,
                 drop_last: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.wav_bucket = wav_bucket
        self.text_bucket = text_bucket
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.ds)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _order(self) -> np.ndarray:
        if self.shuffle:
            lengths = self.ds.sample_lengths()
            return train_sampler_order(
                lengths, self.batch_size,
                self.ds.cfg.train.shuffle_updates, self.rng)
        return np.arange(len(self.ds))

    def __iter__(self) -> Iterator:
        cfg = self.ds.cfg
        order = self._order()
        b = self.batch_size
        for s in range(0, len(order), b):
            idx = order[s:s + b]
            if self.drop_last and len(idx) < b:
                break
            items = [self.ds[int(i)] for i in idx]
            wavs = [w for w, _ in items]
            N = round_up(max(len(w) for w in wavs), self.wav_bucket)
            wav_mat = np.zeros((len(wavs), N), wavs[0].dtype)
            wav_lens = np.zeros(len(wavs), np.int32)
            for j, w in enumerate(wavs):
                wav_mat[j, : len(w)] = w
                wav_lens[j] = len(w)
            if self.ds.mode == "infer":
                yield wav_mat, wav_lens, None, None, None
                continue
            texts = [ids for _, ids in items]
            S = round_up(max(len(t) for t in texts) + 1, self.text_bucket)
            tokens_in = np.full((len(texts), S), cfg.vocab.pad, np.int32)
            tokens_out = np.full((len(texts), S), cfg.vocab.pad, np.int32)
            text_lens = np.zeros(len(texts), np.int32)
            for j, t in enumerate(texts):
                # sos + text / text + eos packing (reference data.py:485-487)
                tokens_in[j, 0] = cfg.vocab.sos
                tokens_in[j, 1:1 + len(t)] = t
                tokens_out[j, : len(t)] = t
                tokens_out[j, len(t)] = cfg.vocab.eos
                text_lens[j] = len(t) + 1
            yield wav_mat, wav_lens, tokens_in, tokens_out, text_lens


def make_train_loader(manifest_path: str, cfg: Config, vocab: Vocab,
                      seed: int = 0, drop_last: bool = False) -> Loader:
    """``drop_last=True`` when every batch must have the full size (the
    remainder batch is dropped, reshuffled into the next epoch)."""
    ds = AudioDataset(read_manifest(manifest_path), cfg, vocab, "train", seed)
    return Loader(ds, cfg.train.batch_size, shuffle=True, seed=seed,
                  drop_last=drop_last)


def make_eval_loader(manifest_path: str, cfg: Config, vocab: Vocab) -> Loader:
    ds = AudioDataset(read_manifest(manifest_path), cfg, vocab, "eval")
    return Loader(ds, cfg.train.eval_batch_size, shuffle=False)


def prefetch(iterator, size: int = 2):
    """Background-thread prefetch: host wav reading and collation overlap
    the device's work (the role of the reference's DataLoader workers,
    data.py:467-474).

    The worker must not outlive its consumer: an abandoned generator
    (a consumer stopping mid-epoch) would otherwise leave the thread
    blocked in ``q.put`` forever, holding the source iterator alive; the
    stop event and timed puts end it within ~100 ms."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    END = object()
    stop = threading.Event()
    err = []

    def worker():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:   # handed to the consumer, re-raised there
            err.append(e)
        finally:
            while True:               # the consumer needs END even when the
                try:                  # queue is full of undrained items
                    q.put(END, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break         # consumer gone; nobody waits

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()                    # consumer closed/abandoned early


def batches_to_device(loader: Loader, cfg: Config, device=None):
    """Host batches -> device batches, featurized on the device
    (``featurize_batch``; on the card through K1).  Yields ``(feats,
    feat_lens)`` in infer mode and a :class:`Batch` otherwise.  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    from ..audio import features
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    for wav_mat, wav_lens, ti, to, tl in prefetch(iter(loader)):
        feats, feat_lens = features.featurize_batch(
            torch.from_numpy(wav_mat).to(dev),
            torch.from_numpy(wav_lens).to(dev), cfg.audio)
        if ti is None:
            yield feats, feat_lens
        else:
            yield Batch(feats, feat_lens, *(torch.from_numpy(a).to(dev)
                                            for a in (ti, to, tl)))
