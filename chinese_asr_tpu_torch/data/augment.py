"""Waveform augmentation (a copy of ``chinese_asr_tpu/data/augment.py``;
reference data.py:283-343, applied with probability ``aug_prob`` per
utterance, data.py:180-197).

Host-side numpy, applied by the train loader before batching:
augmentation acts on the raw waveform (speed changes its length), so it
cannot live in the featurizer on the device.
"""

from __future__ import annotations

import numpy as np

from ..config import AugmentConfig


def gain_db(x: np.ndarray, db: float) -> np.ndarray:
    """Volume gain in dB (reference data.py:283-294)."""
    return (x * 10.0 ** (db / 20.0)).astype(np.float32)


def change_speed(x: np.ndarray, rate: float) -> np.ndarray:
    """Speed perturbation via linear interpolation (data.py:297-317):
    rate > 1 -> faster (shorter)."""
    if rate == 1.0:
        return x
    old_n = len(x)
    new_n = int(old_n / rate)
    old_idx = np.arange(old_n)
    new_idx = np.linspace(0, old_n - 1, new_n)
    return np.interp(new_idx, old_idx, x).astype(np.float32)


def shift(x: np.ndarray, shift_ms: float, rate: int = 16000) -> np.ndarray:
    """Time shift with zero fill (data.py:320-343): positive -> shift right
    (delay), negative -> shift left."""
    n = int(rate * shift_ms / 1000.0)
    out = np.zeros_like(x)
    if n == 0:
        return x.copy()
    if n > 0:
        out[n:] = x[:-n]
    else:
        out[:n] = x[-n:]
    return out


def augment(x: np.ndarray, cfg: AugmentConfig, rng: np.random.RandomState,
            sample_rate: int = 16000) -> np.ndarray:
    """Apply each augmentation independently with prob ``aug_prob``
    (reference data.py:180-197)."""
    if cfg.aug_prob <= 0.0:
        return x
    if rng.rand() < cfg.aug_prob:
        x = gain_db(x, rng.uniform(cfg.volume_gain_min, cfg.volume_gain_max))
    if rng.rand() < cfg.aug_prob:
        x = change_speed(x, rng.uniform(cfg.speed_rate_min, cfg.speed_rate_max))
    if rng.rand() < cfg.aug_prob:
        x = shift(x, rng.uniform(cfg.shift_ms_min, cfg.shift_ms_max),
                  sample_rate)
    return x
