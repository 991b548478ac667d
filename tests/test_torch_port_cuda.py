"""PyTorch port on the card: each CUDA kernel against its plain twin at
small and edge shapes, and the golden shard through the kernels.  Marked
``cuda``; every test skips when no GPU is present (decided inside the
fixture, never at import).  Run on a GPU machine with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -o addopts=""

Tolerances are the ones chip_smoke.py states: log-mel 2e-3 absolute,
BiLSTM 1e-4 absolute, top-k exact, fused top-k 1e-5 absolute on values
(the logsumexp is summed in another order), indices exact where the
values are separated by more than that.
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


@pytest.mark.parametrize("cfg", [tcfg.AudioConfig(),
                                 golden_cfg(tcfg).audio],
                         ids=["flagship", "golden"])
@pytest.mark.parametrize("B,n,T", [(3, 11000, 65),    # T not a multiple of 64
                                   (2, 48000, 130),
                                   (2, 16000, 1),     # T = 1
                                   (2, 300, 1),       # shorter than a frame
                                   (1, 16000, 99)])   # B = 1
def test_logmel_kernel_edge_shapes(dev, cfg, B, n, T):
    g = torch.Generator(device=dev).manual_seed(B * n + T)
    wav = 0.1 * torch.randn(B, n, device=dev, generator=g)
    before = tlogmel.launches
    got = tlogmel.log_mel(wav, T, cfg)
    assert tlogmel.launches == before + 1
    ref = tlogmel.log_mel_plain(wav, T, cfg)
    assert got.shape == (B, T, cfg.n_mels) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 2e-3


@pytest.mark.parametrize("T,B,H", [(5, 1, 256), (4, 128, 256), (4, 129, 256),
                                   (7, 37, 256), (1, 9, 128), (6, 20, 64),
                                   (9, 129, 64), (3, 130, 128), (1, 128, 64)])
def test_lstm_kernel_edge_shapes(dev, T, B, H):
    """Rows masked from step 0 (length 0), ragged tiles, B on both sides
    of the 16/32 rows-per-cluster switch, T = 1."""
    g = torch.Generator(device=dev).manual_seed(T * B + H)
    xg_f = torch.randn(T, B, 4 * H, device=dev, generator=g)
    xg_b = torch.randn(T, B, 4 * H, device=dev, generator=g)
    w = torch.randn(2, H, 4 * H, device=dev, generator=g) / H ** 0.5
    lens = torch.randint(0, T + 1, (B,), device=dev, generator=g)
    lens[0] = 0
    m_f = (torch.arange(T, device=dev)[:, None] < lens[None]).float()
    m_b = torch.flip(m_f, dims=(0,)).contiguous()
    before = tlstm.launches
    got = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    assert tlstm.launches == before + 1
    ref = tlstm.bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-4
    assert float(got[0][m_f == 0].abs().max()) == 0.0
    assert float(got[2][:, 0].abs().max()) == 0.0      # row 0: never stepped
    plan = tlstm.plan(B, H)
    assert plan["rows"] == (16 if B <= 112 else 32)
    assert plan["waves"] == 1


@pytest.mark.parametrize("R,V,k,W", [(1, 1, 1, 1), (7, 33, 33, 1),
                                     (300, 5004, 17, 4), (5, 70000, 3, 4),
                                     (1024, 5004, 17, 1),
                                     # V % 4 != 0: single-column loads
                                     (300, 5003, 17, 4),
                                     (1100, 5003, 17, 1)])
def test_topk_kernel_matches_twin_exactly(dev, R, V, k, W):
    assert ttopk.plan(R, V, k)["warps_per_row"] == W
    g = torch.Generator(device=dev).manual_seed(R + V)
    x = torch.randn(R, V, device=dev, generator=g).round()   # many ties
    x[0, V // 2] = float("nan")
    if R > 3:
        x[1, :] = float("-inf")
        x[2, :] = float("nan")
        x[3, 0] = float("inf")
    # any V: 70000 is past what a block's shared memory could hold
    vk, ik = ttopk.top_k(x, k)
    vp, ip = ttopk.top_k_plain(x, k)
    assert torch.equal(ik, ip)
    assert torch.equal(torch.isnan(vk), torch.isnan(vp))
    assert torch.equal(torch.nan_to_num(vk), torch.nan_to_num(vp))


def _assert_topk_exact(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    assert torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want[0]))


def _lane0_cols(W, k):
    """k columns that thread 0 of a row streams (float4 t + j * 32W)."""
    return [4 * (j * 32 * W) + i for j in range(-(-k // 4))
            for i in range(4)][:k]


@pytest.mark.parametrize("R,W", [(2048, 1), (512, 4)])
def test_topk_kernel_main_path_shapes(dev, R, W):
    """The beam's stage 1 at B=128 and B=32 (bw 16): beam-like rows (a
    log-softmax plus a score, 15 of 16 rows -inf at step 0) and random
    rows are exact and take no fallback; all 17 winners in one lane's
    columns fall back and stay exact."""
    V, k = 5004, 17
    assert ttopk.plan(R, V, k)["warps_per_row"] == W
    g = torch.Generator(device=dev).manual_seed(R)
    lg = 3 * torch.randn(R, V, device=dev, generator=g)
    lp = lg - torch.logsumexp(lg, dim=1, keepdim=True) \
        - 20 * torch.rand(R, 1, device=dev, generator=g)
    lp.view(R // 16, 16, V)[:, 1:] = float("-inf")
    fb = torch.zeros(2, dtype=torch.int32, device=dev)
    for x in (lp, torch.randn(R, V, device=dev, generator=g)):
        _assert_topk_exact(ttopk.top_k(x, k, fallbacks=fb),
                           ttopk.top_k_plain(x, k))
    assert fb.tolist() == [0, 0]
    x = torch.randn(R, V, device=dev, generator=g)
    x[:, _lane0_cols(W, k)] = 10 + torch.rand(R, k, device=dev, generator=g)
    x[1, _lane0_cols(W, k)] = 10.0                   # tied as well
    before = ttopk.launches
    _assert_topk_exact(ttopk.top_k(x, k, fallbacks=fb),
                       ttopk.top_k_plain(x, k))
    assert ttopk.launches == before + 1 and fb.tolist() == [R, 0]


def _fused_case(dev, R, V, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    logit = 3 * torch.randn(R, V, device=dev, generator=g)
    bias = -20 * torch.rand(R, 1, device=dev, generator=g)
    if R > 4:
        bias[1::4] = float("-inf")                 # disabled rows
        logit[2, V // 3] = float("nan")            # poisons row 2's lse
        logit[5, 0] = float("nan")                 # NaN under a -inf bias
        logit[3, :] = logit[3, :].round()          # exact ties
    return logit, bias


def _assert_fused_close(got, want, tol):
    vk, ik = got
    vp, ip = want
    assert torch.equal(torch.isnan(vk), torch.isnan(vp))
    assert torch.equal(torch.isinf(vk), torch.isinf(vp))
    fin = torch.isfinite(vp)
    if fin.any():
        assert float((vk[fin] - vp[fin]).abs().max()) <= tol
    # indices agree wherever the twin's values are separated by more than
    # the tolerance (or are exact: -inf and NaN rows)
    gap = (vp[:, :-1] - vp[:, 1:]).nan_to_num(nan=float("inf"))
    sep = (gap > tol).all(dim=1) | ~torch.isfinite(vp).any(dim=1)
    assert torch.equal(ik[sep], ip[sep])


@pytest.mark.parametrize("R,V,k,temp,W", [(1, 1, 1, 1.0, 1),
                                          (1, 33, 5, 0.7, 1),
                                          (40, 97, 97, 1.0, 1),
                                          (64, 5004, 17, 1.0, 4),
                                          (16, 1000, 9, 1.3, 1),
                                          (6, 70000, 3, 1.0, 4),
                                          (1024, 5004, 17, 1.0, 1),
                                          # single-column loads
                                          (300, 5003, 17, 0.7, 4),
                                          (1100, 5003, 17, 1.0, 1)])
def test_fused_topk_kernel_matches_twin(dev, R, V, k, temp, W):
    assert ttopk.plan(R, V, k)["warps_per_row"] == W
    logit, bias = _fused_case(dev, R, V, seed=R * V + k)
    before = (ttopk.launches, ttopk.fused_launches)
    got = ttopk.top_k_fused(logit, bias, k, temp)
    assert (ttopk.launches, ttopk.fused_launches) == (before[0],
                                                      before[1] + 1)
    want = ttopk.top_k_fused_plain(logit, bias, k, temp)
    _assert_fused_close(got, want, 1e-5)
    if R > 4:
        assert torch.isnan(got[0][2]).all()            # NaN row reads NaN
        assert (got[0][1] == float("-inf")).all()      # -inf bias wins
        assert got[1][1].tolist() == list(range(k))
        assert (got[0][5] == float("-inf")).all()      # ...even over NaN


@pytest.mark.parametrize("R", [2048, 512])
def test_fused_topk_exhausted_lanes_and_equal_keys(dev, R):
    """K4 at the main path's shapes: winners in one lane's columns are
    read again by their keys, then take the flat extraction (within 1e-5,
    indices exact where separated); rows whose lse is exactly 0 under a
    bias of 1e4 tie many keys, and the lower column wins exactly as in
    the twin."""
    V, k = 5004, 17
    W = ttopk.plan(R, V, k)["warps_per_row"]
    g = torch.Generator(device=dev).manual_seed(R + 1)
    logit = 3 * torch.randn(R, V, device=dev, generator=g)
    logit[:, _lane0_cols(W, k)] = 30 + torch.rand(R, k, device=dev,
                                                  generator=g)
    bias = -20 * torch.rand(R, 1, device=dev, generator=g)
    fb = torch.zeros(2, dtype=torch.int32, device=dev)
    _assert_fused_close(ttopk.top_k_fused(logit, bias, k, fallbacks=fb),
                        ttopk.top_k_fused_plain(logit, bias, k), 1e-5)
    assert fb.tolist() == [R, R]
    eq = -201 + torch.rand(R, V, device=dev, generator=g)
    eq[:, 1234] = 0.0
    bias = torch.full((R, 1), 1e4, device=dev)
    got = ttopk.top_k_fused(eq, bias, k)
    want = ttopk.top_k_fused_plain(eq, bias, k)
    assert len(torch.unique(want[0][0])) < 8          # the keys do tie
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_topk_all_rows_disabled(dev):
    logit = torch.randn(8, 300, device=dev)
    bias = torch.full((8, 1), float("-inf"), device=dev)
    v, i = ttopk.top_k_fused(logit, bias, 4)
    assert (v == float("-inf")).all()
    assert torch.equal(i, torch.arange(4, device=dev, dtype=torch.int32)
                       .expand(8, 4))


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


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("lm_mode", ["second", "second_host"])
def test_golden_lm_modes_on_the_card(dev, lm_mode, fused, monkeypatch):
    from chinese_asr_tpu_torch.api import ASR
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"]["lm_" + lm_mode]
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", fused)
    asr = ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
              cfg=golden_cfg(tcfg), vocab=Vocab.build([CHARS * 3],
                                                     max_num_words=8),
              bw=4, lm_path=os.path.join(GOLD, "lm.arpa"), lm_mode=lm_mode)
    if lm_mode == "second":
        assert asr.dlm.uni.device.type == "cuda"
    counts = (ttopk.launches, ttopk.fused_launches)
    assert asr.transcribe_files(golden_wav_paths()) == expected
    if fused == "1":
        assert ttopk.fused_launches > counts[1] and ttopk.launches == counts[0]
    else:
        assert ttopk.launches > counts[0] and ttopk.fused_launches == counts[1]
