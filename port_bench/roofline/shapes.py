"""Frame counts and widths of the configuration's front end: what a wav
of n samples becomes (the STFT's frames on the pre-emphasised signal,
then, with ``downsample``, the x3 stacking), and how wide a frame is."""

from __future__ import annotations


def frames(n_samples: int, audio: dict) -> int:
    """STFT frames of a wav of ``n_samples`` (center=False)."""
    hop = int(audio["sample_rate"] * audio["window_step"])
    n = n_samples - (1 if audio["preemphasis"] > 0 else 0)
    return max(0, 1 + (n - audio["n_fft"]) // hop)


def encoder_frames(n_samples: int, audio: dict) -> int:
    """Frames of a wav as the front end hands them to the encoder: a
    third of its STFT frames where it stacks them x3, at least one.  The
    encoder's family subsamples further (``port_bench/encoders``
    ``frames``)."""
    f = frames(n_samples, audio)
    return max(1, f // 3 if audio["downsample"] else f)


def feature_width(audio: dict) -> int:
    """Features a frame: the mels, x3 with delta and delta-delta, x3
    stacked."""
    return (audio["n_mels"] * (3 if audio["delta_delta"] else 1)
            * (3 if audio["downsample"] else 1))
