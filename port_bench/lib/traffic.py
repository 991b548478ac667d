"""The one traffic generator: it reads a mix's data file
(``port_bench/traffic/<mix>.json``) and makes the mix's inputs from the
seed.

Utterance lengths are a fixed set for a mix, the quantiles of its length
distribution, so every seed asks for the same work; the seed orders
them, and draws the audio and the transcripts.
"""

from __future__ import annotations

import math
import statistics
from typing import List

import numpy as np
import torch


def lengths_s(spec: dict) -> np.ndarray:
    """The mix's utterance lengths in seconds, ascending: ``count``
    quantiles (i + 0.5) / count of a log-normal with ``median_s`` and
    ``sigma``, clipped to [``min_s``, ``max_s``]."""
    if spec["distribution"] != "lognormal":
        raise ValueError(f"length distribution {spec['distribution']!r}")
    n = spec["count"]
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    s = spec["median_s"] * np.exp(spec["sigma"] * z)
    return np.clip(s, spec["min_s"], spec["max_s"])


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use (``stream``) of a seed."""
    return np.random.default_rng([seed % (1 << 63), stream])


def speech_like(samples: np.ndarray, seed: int, device) -> List[np.ndarray]:
    """int16 utterances of ``samples`` lengths, made on ``device`` in one
    flat buffer: a gliding harmonic tone (five harmonics of a 90-250 Hz
    fundamental with a slow vibrato) under a syllable-rate envelope, with
    noise.  Returns views into one host array, in the given order."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    n = len(samples)
    lens = torch.as_tensor(samples, dtype=torch.int64, device=device)
    total = int(lens.sum())
    row = torch.repeat_interleave(torch.arange(n, device=device), lens)
    start = torch.cumsum(lens, 0) - lens
    t = (torch.arange(total, device=device) - start[row]).double() / 16000.0
    f0 = 90.0 + 160.0 * torch.rand(n, generator=gen, device=device,
                                   dtype=torch.float64)
    syll = 2.0 + 3.0 * torch.rand(n, generator=gen, device=device,
                                  dtype=torch.float64)
    f = f0[row] * (1.0 + 0.1 * torch.sin(2 * math.pi * 0.7 * t))
    phase = torch.cumsum(f, 0) / 16000.0
    phase = 2 * math.pi * (phase - (phase[start] - f[start] / 16000.0)[row])
    x = sum(torch.sin(h * phase) / h for h in range(1, 6))
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * syll[row] * t) ** 2
    noise = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float64)
    y = (0.2 * env * x + 0.01 * noise) * 32767.0
    pcm = y.clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    return np.split(pcm, np.cumsum(samples)[:-1])


def corpus(spec: dict, seed: int, device):
    """(wavs, seconds of each): the mix's utterances in the seed's order."""
    secs = lengths_s(spec["lengths"])
    sr = spec["sample_rate"]
    order = rng(seed, 0).permutation(len(secs))
    samples = np.round(secs[order] * sr).astype(np.int64)
    return speech_like(samples, seed, device), samples / sr


def transcripts(seconds: np.ndarray, spec: dict, seed: int, vocab: int,
                first_id: int) -> List[np.ndarray]:
    """Token ids of a transcript for each utterance: ``chars_per_s`` of
    them a second of audio (at least one), drawn uniformly from the
    characters ``first_id`` .. ``vocab`` - 1."""
    r = rng(seed, 1)
    n = np.maximum(1, np.round(seconds * spec["chars_per_s"])).astype(int)
    return [r.integers(first_id, vocab, size=k) for k in n]
