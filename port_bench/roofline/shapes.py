"""Frame counts of the configuration's front end: what a wav of n samples
becomes (the STFT's frames on the pre-emphasised signal, then the x3
stacking)."""

from __future__ import annotations


def frames(n_samples: int, audio: dict) -> int:
    """STFT frames of a wav of ``n_samples`` (center=False)."""
    hop = int(audio["sample_rate"] * audio["window_step"])
    n = n_samples - (1 if audio["preemphasis"] > 0 else 0)
    return max(0, 1 + (n - audio["n_fft"]) // hop)


def encoder_frames(n_samples: int, audio: dict) -> int:
    """Encoder frames of a wav: a third of its STFT frames, at least one."""
    return max(1, frames(n_samples, audio) // 3)
