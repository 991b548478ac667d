"""K1: fused log-mel kernel (``csrc/logmel.cu``) and its plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/logmel.py`` ``pallas_log_mel``:
pre-emphasized wav [B, N] f32 -> unmasked log-mel [B, T, n_mels] f32.
Pre-emphasis (before) and the frame mask (after) stay torch ops in
``audio/features.log_mel``, as in the JAX wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

launches = 0          # kernel launches (the twin never counts)

_EPS = float(np.finfo(np.float32).eps)
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=16)
def _tables(cfg, device: torch.device):
    """Window-folded DFT tables cos/sin [win, bins] and the mel filterbank
    [bins, n_mels] as f32 tensors on ``device``."""
    from ...audio.features import _constants
    cos_m, sin_m, fb, _ = _constants(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_m, sin_m, fb))


def _frame_offset(cfg) -> int:
    return (cfg.n_fft - cfg.win_length) // 2


def log_mel_plain(wav, n_frames: int, cfg):
    """The kernel's math in plain PyTorch: frame gather -> windowed DFT as
    two matmuls -> power -> mel matmul -> eps floor -> log.  Samples past
    the end of a row read as zero (the kernel does the same)."""
    cos_m, sin_m, fb = _tables(cfg, wav.device)
    win, hop = cfg.win_length, cfg.hop_length
    idx = (torch.arange(n_frames, device=wav.device)[:, None] * hop
           + _frame_offset(cfg)
           + torch.arange(win, device=wav.device)[None, :])        # [T, win]
    need = (n_frames - 1) * hop + _frame_offset(cfg) + win if n_frames else 0
    if need > wav.shape[-1]:
        wav = torch.nn.functional.pad(wav, (0, need - wav.shape[-1]))
    frames = wav[..., idx]                                         # [B, T, win]
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb
    mel = torch.where(mel == 0.0, torch.full_like(mel, _EPS), mel)
    return torch.log(mel)


def log_mel(wav, n_frames: int, cfg):
    """wav [B, N] f32 (pre-emphasized) -> [B, n_frames, n_mels].  A CPU
    tensor takes the plain twin; a CUDA tensor launches the kernel."""
    if wav.device.type == "cpu":
        return log_mel_plain(wav, n_frames, cfg)
    B, N = wav.shape
    nbins = cfg.n_fft // 2 + 1
    build.require("log_mel wav", wav, torch.float32, (B, N))
    cos_m, sin_m, fb = _tables(cfg, wav.device)
    out = torch.empty((B, n_frames, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    fn = build.kernel("asr_logmel", [_P] * 5 + [_I] * 8
                      + [ctypes.c_float, _P])
    rc = fn(wav.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
            fb.data_ptr(), out.data_ptr(), B, N, n_frames, cfg.win_length,
            cfg.hop_length, _frame_offset(cfg), nbins, cfg.n_mels, _EPS,
            torch.cuda.current_stream(wav.device).cuda_stream)
    build.check("asr_logmel", rc)
    global launches
    launches += 1
    return out
