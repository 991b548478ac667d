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
