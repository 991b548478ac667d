"""PyTorch port on the card: each CUDA kernel against its plain twin at
small and edge shapes, and the golden shard through the kernels.  Marked
``cuda``; every test skips when no GPU is present (decided inside the
fixture, never at import).  Run on a GPU machine with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -o addopts=""

Tolerances are the ones chip_smoke.py states: log-mel 2e-3 absolute,
BiLSTM 1e-4 absolute, top-k exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.ops.cuda import logmel as tlogmel
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.ops.cuda import topk as ttopk
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chinese_asr_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.parametrize("cfg", [tcfg.AudioConfig(),
                                 golden_cfg(tcfg).audio])
@pytest.mark.parametrize("n", [400, 16000, 23457])
def test_logmel_kernel_matches_twin(dev, cfg, n):
    wav = 0.1 * torch.randn(3, n, device=dev)
    T = max(1, (n - 1 - cfg.n_fft) // cfg.hop_length + 3)   # past the end too
    before = tlogmel.launches
    got = tlogmel.log_mel(wav, T, cfg)
    assert tlogmel.launches == before + 1
    ref = tlogmel.log_mel_plain(wav, T, cfg)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 2e-3


@pytest.mark.parametrize("T,B,H", [(1, 1, 16), (9, 5, 16), (40, 13, 256),
                                   (7, 3, 100), (1, 1, 256), (6, 37, 64)])
def test_lstm_kernel_matches_twin(dev, T, B, H):
    g = torch.Generator(device=dev).manual_seed(T * B * H)
    xg_f = torch.randn(T, B, 4 * H, device=dev, generator=g)
    xg_b = torch.randn(T, B, 4 * H, device=dev, generator=g)
    w = torch.randn(2, H, 4 * H, device=dev, generator=g) / H ** 0.5
    lens = torch.randint(1, T + 1, (B,), device=dev, generator=g)
    m_f = (torch.arange(T, device=dev)[:, None] < lens[None]).float()
    m_b = torch.flip(m_f, dims=(0,)).contiguous()
    # H a multiple of 64 runs the cluster kernel, any other H the simple one
    before = tlstm.launches
    got = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    assert tlstm.launches == before + 1
    ref = tlstm.bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("R,V,k", [(1, 1, 1), (7, 33, 33), (300, 5004, 17),
                                   (5, 70000, 3)])
def test_topk_kernel_matches_twin_exactly(dev, R, V, k):
    g = torch.Generator(device=dev).manual_seed(R + V)
    x = torch.randn(R, V, device=dev, generator=g).round()   # many ties
    x[0, V // 2] = float("nan")
    if R > 3:
        x[1, :] = float("-inf")
        x[2, :] = float("nan")
        x[3, 0] = float("inf")
    if V > 56000:
        with pytest.raises(ValueError):
            ttopk.top_k(x, k)
        return
    vk, ik = ttopk.top_k(x, k)
    vp, ip = ttopk.top_k_plain(x, k)
    assert torch.equal(ik, ip)
    assert torch.equal(torch.isnan(vk), torch.isnan(vp))
    assert torch.equal(torch.nan_to_num(vk), torch.nan_to_num(vp))


def test_kernels_reject_bad_operands(dev):
    with pytest.raises(ValueError):
        ttopk.top_k(torch.randn(4, 10, device=dev).double(), 2)
    with pytest.raises(ValueError):
        ttopk.top_k(torch.randn(10, 4, device=dev).t(), 2)   # not contiguous


@pytest.mark.parametrize("mode,bw", [("greedy", None), ("beam_bw4", 4)])
def test_golden_shard_on_the_card(dev, mode, bw):
    from chinese_asr_tpu_torch.api import ASR
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"][mode]
    asr = ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
              cfg=golden_cfg(tcfg), vocab=Vocab.build([CHARS * 3],
                                                     max_num_words=8),
              bw=bw)
    counts = (tlogmel.launches, tlstm.launches, ttopk.launches)
    assert asr.transcribe_files(golden_wav_paths()) == expected
    assert tlogmel.launches > counts[0] and tlstm.launches > counts[1]
    assert bw is None or ttopk.launches > counts[2]
