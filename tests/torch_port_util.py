"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both frameworks;
JAX runs on the CPU (tests/conftest.py), the port with ``device="cpu"``,
so every port wrapper takes its kernel's plain twin.
"""

import os

import numpy as np
import torch

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CHARS = "的一是不了人我在"          # the golden shard's 8 Hanzi


def golden_cfg(config_module):
    """The golden shard's config (tests/test_golden_shard.py), built from
    either package's ``config`` module."""
    return (config_module.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=8))


def small_cfg(config_module, **encoder):
    """Flagship audio front end (80 mels, deltas, x3 stack) with a narrow
    2-layer model: the shapes of the main path at test size."""
    enc = dict(hidden_size=16, num_layers=2)
    enc.update(encoder)
    return (config_module.Config()
            .with_("encoder", **enc)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("decode", max_len=10))


def golden_wav_paths():
    return [os.path.join(GOLD, f"utt{i}.wav") for i in range(6)]


def T(a):
    """numpy -> CPU tensor (copies, so the tensor owns writable memory)."""
    return torch.tensor(np.asarray(a))


def N(t):
    """tensor or jax array -> numpy"""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def jax_params_numpy(params):
    import jax
    return jax.tree_util.tree_map(np.asarray, params)


def random_wavs(rng, lens, int16=True):
    wavs = []
    for n in lens:
        x = 0.3 * np.sin(np.arange(n) * rng.uniform(0.01, 0.2)) \
            + 0.05 * rng.standard_normal(n)
        wavs.append((x * 32767).astype(np.int16) if int16
                    else x.astype(np.float32))
    return wavs


def pad_batch(wavs, N):
    mat = np.zeros((len(wavs), N), wavs[0].dtype)
    for i, w in enumerate(wavs):
        mat[i, : len(w)] = w
    return mat, np.array([len(w) for w in wavs], np.int32)


def round_tf32(t):
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does (finite inputs): add half a TF32 ulp to the
    magnitude bits and clear the 13 bits below it."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(t):
    """Truncate f32 to TF32: clear the 13 low mantissa bits."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(t, mode):
    """t = hi + lo (+ what the split drops), both TF32, as the kernels split
    an operand: ``mode`` "rna" (cvt.rna) or "trunc" (bit mask)."""
    r = round_tf32 if mode == "rna" else trunc_tf32
    hi = r(t)
    return hi, r(t - hi)


def matmul_tf32x3(a, b, a_mode="rna", b_mode="rna"):
    """The kernels' 3xTF32 product in plain torch: the operands split into
    TF32 hi and lo, and lo*hi + hi*lo + hi*hi summed in f32 (the lo*lo
    term dropped).  The products of TF32 values are exact in f32."""
    ah, al = split_tf32(a, a_mode)
    bh, bl = split_tf32(b, b_mode)
    return al @ bh + ah @ bl + ah @ bh


def matmul_tf32x1(a, b, a_mode="rna", b_mode="rna"):
    """One TF32 product: hi*hi only."""
    return split_tf32(a, a_mode)[0] @ split_tf32(b, b_mode)[0]


def speech_like_wavs(rng, n, seconds, sr=16000):
    """Seeded speech-like float32 wavs (chip_smoke.py's generator): gliding
    harmonic tones under noise, with a syllable-rate envelope."""
    out = []
    for _ in range(n):
        t = np.arange(int(seconds * sr)) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(np.sin(h * phase) / h for h in range(1, 6))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
        x = 0.2 * env * x + 0.01 * rng.standard_normal(len(t))
        out.append(np.round(np.clip(x * 32767, -32768, 32767)) / 32768.0)
    return np.stack(out).astype(np.float32)
