"""Log-mel front end (port of ``chinese_asr_tpu/audio/features.py``).

  preemphasis -> framing -> window+DFT -> power -> mel -> eps-floor -> log
  -> delta/delta-delta -> x3 frame stacking -> instance norm

The framing/DFT/mel/log core is kernel K1 (``ops/cuda/logmel.py``) on a
CUDA tensor and its plain twin on a CPU tensor; everything around it is
plain PyTorch with the JAX module's parity details:

* ``torch.stft(n_fft=512, hop=160, win_length=400, hann, center=False)``
  framing of the reference (data.py:205-209): the 400-tap periodic Hann
  window sits centred in the 512-point frame (offset 56), and window +
  DFT basis fold into two [400, 257] tables;
* the reference's mel filterbank including its linspace(f_min, f_max,
  257) bin-centre quirk (data.py:43);
* zero power floored to float32 eps before the log (data.py:223-224);
* 9-tap identity/delta/delta-delta filters, L2-normalized, zero-padded
  'same' (data.py:129-164), and channel-major x3 stacking (data.py:244).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..ops.cuda import logmel as logmel_k


# --------------------------------------------------------------------------
# host-side constants (computed once per AudioConfig)
# --------------------------------------------------------------------------
def hann_window_periodic(win_length: int) -> np.ndarray:
    """torch.hann_window default (periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def mel_filterbank(n_stft: int, f_min: float, f_max: float, n_mels: int) -> np.ndarray:
    """HTK triangular filterbank, reference formula data.py:21-57 (note the
    reference's stft_freqs = linspace(f_min, f_max, n_stft) quirk)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    stft_freqs = np.linspace(f_min, f_max, n_stft)
    m_min = 0.0 if f_min == 0 else hz_to_mel(f_min)
    m_max = hz_to_mel(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels + 1,)
    slopes = f_pts[None, :] - stft_freqs[:, None]         # (n_stft, n_mels + 2)
    down = (-slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def delta_filter_stack() -> np.ndarray:
    """[9, 3] tap stack: identity / delta / delta-delta, each L2-normalized
    (reference data.py:137-147)."""
    delta = np.array([2, 1, 0, -1, -2], dtype=np.float64)
    dd = np.convolve(delta, delta, mode="full")           # 9 taps
    stack = np.stack([
        np.pad([1.0], (4, 4)),
        np.pad(delta, (2, 2)),
        dd,
    ], axis=1)                                            # [9, 3]
    stack = stack / np.sqrt((stack ** 2).sum(axis=0, keepdims=True))
    return stack.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _constants(cfg: AudioConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(cos_mat [win,257], sin_mat [win,257], mel_fb [257,80], deltas [9,3]).

    Window + centered zero-pad offset + DFT basis folded together:
    frame_sample m sits at DFT position (n_fft-win)//2 + m.
    """
    n_fft = cfg.n_fft
    win = cfg.win_length
    n_bins = n_fft // 2 + 1
    w = hann_window_periodic(win).astype(np.float64)
    offset = (n_fft - win) // 2
    n = offset + np.arange(win, dtype=np.float64)         # positions in 512 frame
    k = np.arange(n_bins, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft          # [win, bins]
    cos_mat = (np.cos(phase) * w[:, None]).astype(np.float32)
    sin_mat = (-np.sin(phase) * w[:, None]).astype(np.float32)
    fb = mel_filterbank(n_bins, cfg.f_min, cfg.f_max, cfg.n_mels)
    return cos_mat, sin_mat, fb, delta_filter_stack()


def _floor_div(a, b: int):
    if isinstance(a, torch.Tensor):
        return torch.div(a, b, rounding_mode="floor")
    return a // b


def num_frames(n_samples, cfg: AudioConfig):
    """Frames for center=False STFT on the *post-preemphasis* signal
    (preemphasis drops one sample, data.py:202).  Floor division, so a
    wav shorter than one frame gives a count <= 0."""
    n = n_samples - (1 if cfg.preemphasis > 0 else 0)
    return 1 + _floor_div(n - cfg.n_fft, cfg.hop_length)


def feat_len_from_samples(n_samples, cfg: AudioConfig):
    t = num_frames(n_samples, cfg)
    return _floor_div(t, 3) if cfg.downsample else t


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------
def log_mel(audio, n_frames_max: int, cfg: AudioConfig, frame_mask=None):
    """audio [..., N] float32 -> log-mel [..., T, n_mels].

    frame_mask [..., T] (1 valid / 0 pad): if given, padded frames are zeroed
    *after* the log so the delta conv sees zeros beyond the true end, exactly
    like the reference's per-utterance zero padding (data.py:157-159).
    """
    if cfg.preemphasis > 0.0:
        audio = audio[..., 1:] - cfg.preemphasis * audio[..., :-1]
    lead = audio.shape[:-1]
    out = logmel_k.log_mel(audio.reshape(-1, audio.shape[-1]).contiguous(),
                           n_frames_max, cfg)
    out = out.reshape(*lead, n_frames_max, cfg.n_mels)
    if frame_mask is not None:
        out = out * frame_mask[..., None]
    return out


def _pad_time(feat):
    """Zero-pad the time axis (-2) by 4 frames on each side."""
    return torch.nn.functional.pad(feat, (0, 0, 4, 4))


def add_delta_deltas(feat):
    """feat [..., T, n_mels] -> [..., 3, T, n_mels] (reference data.py:129-164)."""
    taps = torch.from_numpy(delta_filter_stack()).to(feat.device, feat.dtype)
    x = _pad_time(feat)
    T = feat.shape[-2]
    shifts = torch.stack([x[..., j:j + T, :] for j in range(9)], dim=-2)
    return torch.einsum("...tjm,jc->...ctm", shifts, taps)


def stack3(feat3):
    """[..., 3, T, M] -> [..., T//3, 9*M] channel-major stacking
    (reference data.py:244-249: view(3, T//3, 3M) -> transpose -> flatten)."""
    *lead, C, T, M = feat3.shape
    T3 = (T // 3) * 3
    f = feat3[..., :T3, :].reshape(*lead, C, T3 // 3, 3 * M)
    f = torch.movedim(f, -3, -2)                          # [..., T//3, C, 3M]
    return f.reshape(*lead, T3 // 3, C * 3 * M)


def deltas_stack3(feat):
    """Fused ``stack3(add_delta_deltas(feat))``: [..., T, M] -> [..., T//3, 9M].

    Output column c*3M + r*M + m is ``sum_j taps[j, c] * x_pad[3*t3 + r + j,
    m]``: nine 9-tap strided weighted sums concatenated on the feature
    axis, taps summed j-ascending (the JAX module's order)."""
    taps = delta_filter_stack()
    T = feat.shape[-2]
    T3 = T // 3
    if T3 == 0:                                           # < one output frame
        return feat.new_zeros(feat.shape[:-2] + (0, 9 * feat.shape[-1]))
    x = _pad_time(feat)
    comps = []
    for c in range(3):
        for r in range(3):
            acc = None
            for j in range(9):
                w = float(taps[j, c])
                if w == 0.0:
                    continue
                sl = x[..., r + j: r + j + 3 * (T3 - 1) + 1: 3, :]
                acc = w * sl if acc is None else acc + w * sl
            comps.append(acc)                             # [..., T3, M]
    return torch.cat(comps, dim=-1)                       # [..., T3, 9M]


def instance_norm(feat, mask=None, eps: float = 1e-6, unbiased: bool = True):
    """(x - mean_t) / (std_t + eps) per utterance over valid frames
    (reference main.py:37 eps=1e-6).  torch .std() is unbiased (n-1)."""
    if mask is None:
        n = feat.shape[-2]
        mean = feat.mean(dim=-2, keepdim=True)
        var = ((feat - mean) ** 2).sum(dim=-2, keepdim=True) / max(n - 1, 1)
    else:
        m = mask[..., None]
        n = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
        mean = (feat * m).sum(dim=-2, keepdim=True) / n
        dof = torch.clamp(n - 1.0, min=1.0) if unbiased else n
        var = (((feat - mean) * m) ** 2).sum(dim=-2, keepdim=True) / dof
    out = (feat - mean) / (torch.sqrt(var) + eps)
    if mask is not None:
        out = out * mask[..., None]
    return out


def featurize(audio, n_frames_max: int, cfg: AudioConfig, frame_mask=None):
    """Full front end: audio [..., N] -> features [..., T', feat_dim]
    (feat_dim = 720 for the defaults)."""
    lm = log_mel(audio, n_frames_max, cfg, frame_mask)   # [..., T, 80]
    if cfg.delta_delta and cfg.downsample:
        return deltas_stack3(lm)                          # fused, final layout
    if cfg.delta_delta:
        f3 = add_delta_deltas(lm)                         # [..., 3, T, 80]
    else:
        f3 = lm[..., None, :, :]
    if cfg.downsample:
        return stack3(f3)
    # no downsample: [..., T, C*M]
    f = torch.movedim(f3, -3, -2)
    return f.reshape(f.shape[:-2] + (-1,))


def featurize_batch(wavs, wav_lens, cfg: AudioConfig, norm_eps: float = 1e-7,
                    scale=None):
    """wavs [B, N] zero-padded (int16 PCM or float32), wav_lens [B] ->
    (features [B, T', D], feat_lens [B]).

    Padded frames are zeroed pre-delta (parity with per-utterance zero conv
    padding) and excluded from the instance-norm statistics.  ``scale``
    ([B] float32, optional) multiplies each utterance after the int16 ->
    float conversion (device-side peak normalization)."""
    if wavs.dtype == torch.int16:
        wavs = wavs.to(torch.float32) / 32768.0
    if scale is not None:
        wavs = wavs * scale[:, None].to(wavs.dtype)
    B, N = wavs.shape
    T = int(num_frames(N, cfg))
    # clamp: wavs shorter than one frame yield 0 valid frames, not negative
    valid_frames = torch.clamp(num_frames(wav_lens, cfg), min=0)   # [B]
    ar = torch.arange(T, device=wavs.device)
    fmask = (ar[None, :] < valid_frames[:, None]).to(wavs.dtype)
    feats = featurize(wavs, T, cfg, frame_mask=fmask)     # [B, T', D]
    feat_lens = _floor_div(valid_frames, 3) if cfg.downsample else valid_frames
    Tp = feats.shape[1]
    out_mask = (torch.arange(Tp, device=wavs.device)[None, :]
                < feat_lens[:, None]).to(feats.dtype)
    if cfg.normalize:
        feats = instance_norm(feats, out_mask, eps=norm_eps)
    else:
        feats = feats * out_mask[..., None]
    return feats, feat_lens


def unpack_flat(flat, lens, N: int):
    """Expand a flat concatenated wav buffer ([sum(lens)+pad] int16 PCM or
    float32) to the padded [B, N] float32 batch, with exact zeros in the
    padding region.  Row b is the contiguous run starting at the exclusive
    cumsum of ``lens``."""
    lens = lens.to(torch.int64)
    start = torch.cumsum(lens, 0) - lens
    # pad by N so every row's window [start, start+N) is in bounds
    flat = torch.cat([flat, flat.new_zeros(N)])
    x = flat.unfold(0, N, 1)[start]                       # [B, N] row copies
    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
    else:
        x = x.to(torch.float32)
    mask = torch.arange(N, device=x.device)[None, :] < lens[:, None]
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def featurize_flat(flat, lens, N: int, cfg: AudioConfig,
                   norm_eps: float = 1e-7, scale=None):
    """featurize_batch over the flat wire layout (see unpack_flat)."""
    return featurize_batch(unpack_flat(flat, lens, N), lens, cfg,
                           norm_eps=norm_eps, scale=scale)
