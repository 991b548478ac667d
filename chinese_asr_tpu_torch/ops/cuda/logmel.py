"""K1: fused log-mel kernel (``csrc/logmel.cu``) and its plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/logmel.py`` ``pallas_log_mel``:
pre-emphasized wav [B, N] f32 -> unmasked log-mel [B, T, n_mels] f32.
Pre-emphasis (before) and the frame mask (after) stay torch ops in
``audio/features.log_mel``, as in the JAX wrapper.

On the card the windowed DFT runs on the tensor cores as 3xTF32 products
(``csrc/logmel.cu``); ``_kernel_tables`` prepares its split, fragment-order
table and the filterbank's nonzero bin ranges once per config and device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils import observe
from . import build

launches = 0          # kernel launches (the twin never counts)
observe.register_counters(__name__, "launches")

_EPS = float(np.finfo(np.float32).eps)
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=16)
def _tables(cfg, device: torch.device):
    """Window-folded DFT tables cos/sin [win, bins] and the mel filterbank
    [bins, n_mels] as f32 tensors on ``device``."""
    from ...audio.features import _constants
    cos_m, sin_m, fb, _ = _constants(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_m, sin_m, fb))


def round_tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does; the result is an f32 array whose low 13
    bits are zero."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


_NPG = 4              # n-tiles per warp pass (csrc/logmel.cu NPG)
_NX = 4               # lowest bins done in f32 (csrc/logmel.cu NX)
_PF = 1               # k-steps the kernel prefetches (csrc/logmel.cu PF)


@functools.lru_cache(maxsize=16)
def _kernel_tables(cfg, device: torch.device):
    """The kernel's constants on ``device``, built once per config:

    * the window-folded DFT table of bins 0 .. bins-2 with the cos and sin
      columns of a bin interleaved, zero-padded to k-steps of 8 taps and to
      groups of 4 n-tiles of 8 columns, split into TF32 hi and lo (lo =
      rna(x - hi)) and laid out in ``mma.m16n8k8`` B-fragment order:
      [k-steps + 1, n-tiles, 32 lanes, 4] = (b0 hi, b1 hi, b0 lo, b1 lo) with
      b0 = B[8s + lane % 4, 8nt + lane // 4], b1 four taps further;
    * each mel filter's nonzero bin range: [3, n_mels] int32 (first bin,
      count, offset) and the packed weights;
    * the bins below ``_NX`` and the last bin that some filter uses: the
      kernel computes those in f32 on the CUDA cores.
    Returns (bfrag, mel_w, mel_idx, exbins, ksteps, ngroups)."""
    from ...audio.features import _constants
    cos_m, sin_m, fb, _ = _constants(cfg)
    win, nbins = cos_m.shape
    ksteps = -(-win // 8)
    ksteps = -(-ksteps // _PF) * _PF
    ngroups = -(-2 * (nbins - 1) // (8 * _NPG))
    ntiles = ngroups * _NPG
    bmat = np.zeros(((ksteps + _PF) * 8, ntiles * 8), np.float32)
    bmat[:win, 0:2 * (nbins - 1):2] = cos_m[:, :nbins - 1]
    bmat[:win, 1:2 * (nbins - 1):2] = sin_m[:, :nbins - 1]
    hi = round_tf32(bmat)
    lo = round_tf32(bmat - hi)
    # [s, half, tig, nt, g] -> [s, nt, g, tig, (hi, lo), half]
    parts = [x.reshape(ksteps + _PF, 2, 4, ntiles, 8).transpose(0, 3, 4, 2, 1)
             for x in (hi, lo)]
    bfrag = np.ascontiguousarray(np.stack(parts, axis=-2)).reshape(
        ksteps + _PF, ntiles, 32, 4)
    idx = np.zeros((3, fb.shape[1]), np.int32)
    weights = []
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            lo_b, hi_b = int(nz[0]), int(nz[-1]) + 1
            idx[:, m] = (lo_b, hi_b - lo_b, sum(len(w) for w in weights))
            weights.append(fb[lo_b:hi_b, m])
    mel_w = np.ascontiguousarray(
        np.concatenate(weights) if weights else np.zeros(1), np.float32)
    used = fb.any(axis=1)
    exbins = np.array([b for b in [*range(_NX), nbins - 1] if used[b]],
                      np.int32)
    return (torch.from_numpy(bfrag).to(device),
            torch.from_numpy(mel_w).to(device),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(np.append(exbins, 0).astype(np.int32)).to(device),
            ksteps, ngroups)


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
    cos_m, sin_m, _ = _tables(cfg, wav.device)
    bfrag, mel_w, mel_idx, exbins, ksteps, ngroups = _kernel_tables(
        cfg, wav.device)
    out = torch.empty((B, n_frames, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    fn = build.kernel("asr_logmel", [_P] * 8 + [_I] * 12
                      + [ctypes.c_float, _P])
    rc = fn(wav.data_ptr(), bfrag.data_ptr(), cos_m.data_ptr(),
            sin_m.data_ptr(), mel_w.data_ptr(), mel_idx.data_ptr(),
            exbins.data_ptr(), out.data_ptr(), B, N, n_frames,
            cfg.win_length, cfg.hop_length, _frame_offset(cfg), ksteps,
            ngroups, nbins, cfg.n_mels, mel_w.numel(), exbins.numel() - 1,
            _EPS,
            torch.cuda.current_stream(wav.device).cuda_stream)
    build.check("asr_logmel", rc)
    global launches
    launches += 1
    return out
