"""PyTorch port on the card: each CUDA kernel against its plain twin at
small and edge shapes, and the golden shard through the kernels.  Marked
``cuda``; every test skips when no GPU is present (decided inside the
fixture, never at import).  Run on a GPU machine with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -o addopts=""

Tolerances are the ones chip_smoke.py states: log-mel 2e-3 absolute,
BiLSTM 1e-4 absolute (bf16: TOL_LSTM_BF16, below), top-k exact, fused
top-k 1e-5 absolute on values (the logsumexp is summed in another order),
indices exact where the values are separated by more than that, ADPCM
decode exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.ops.cuda import adpcm as tadpcm
from chinese_asr_tpu_torch.ops.cuda import logmel as tlogmel
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.ops.cuda import topk as ttopk
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths

pytestmark = pytest.mark.cuda

# K2-bf16 against its twin: both round y, h and c to bf16 at the end of
# each step from f32 sums taken in other orders, so a value within an f32
# rounding of a bf16 rounding boundary lands one bf16 ulp apart (<= 7.8e-3
# below 2) and the recurrence carries it on; chip_smoke.py's bound
TOL_LSTM_BF16 = 3e-2


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [12, 500, 1000, 1024])
def test_lstm_kernel_any_hidden_size(dev, H, dtype):
    """The simple kernel at every H the wrapper accepts: 8 rows a block up
    to H = 512, 2 rows (1024 threads, 64 registers a thread) above; H=1024
    used to be refused with CUDA error 701 (too many resources)."""
    T, B = 9, 11
    g = torch.Generator(device=dev).manual_seed(H)
    xg_f, xg_b = (torch.randn(T, B, 4 * H, device=dev, generator=g).to(dtype)
                  for _ in range(2))
    w = (torch.randn(2, H, 4 * H, device=dev, generator=g)
         / H ** 0.5).to(dtype)
    m_f, m_b = ((torch.rand(T, B, device=dev, generator=g) > 0.3).to(dtype)
                for _ in range(2))
    before = tlstm.launches + tlstm.bf16_launches
    got = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    torch.cuda.synchronize()
    assert tlstm.launches + tlstm.bf16_launches == before + 1
    ref = tlstm.bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w)
    tol = 1e-4 if dtype == torch.float32 else TOL_LSTM_BF16
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= tol
    assert tlstm.plan(B, H, dtype) == dict(
        rows=8 if H <= 512 else 2, clusters=0, max_active_clusters=0,
        waves=0)


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


@pytest.mark.parametrize("R,W", [(2048, 1), (512, 4)])
def test_topk_kernel_first_pass_shapes(dev, R, W):
    """The LM first pass's proposal, k = topn = 20 over the decoder's
    logits (B*bw rows at B=128 and B=32): logit-like rows, rows of tied
    values, and rows with all 20 winners in one lane's columns (which
    fall back) are exact."""
    V, k = 5004, 20
    assert ttopk.plan(R, V, k) == dict(ttopk.plan(R, V, k), warps_per_row=W,
                                       candidates=True)
    g = torch.Generator(device=dev).manual_seed(R + k)
    fb = torch.zeros(2, dtype=torch.int32, device=dev)
    lg = 3 * torch.randn(R, V, device=dev, generator=g)
    _assert_topk_exact(ttopk.top_k(lg, k, fallbacks=fb),
                       ttopk.top_k_plain(lg, k))
    assert fb.tolist() == [0, 0]
    tied = torch.randn(R, V, device=dev, generator=g).round()
    tied[0] = 2.0                                      # one value, all V
    tied[1, ::7] = 5.0                                 # 715-way tie on top
    _assert_topk_exact(ttopk.top_k(tied, k), ttopk.top_k_plain(tied, k))
    x = torch.randn(R, V, device=dev, generator=g)
    x[:, _lane0_cols(W, k)] = 10 + torch.rand(R, k, device=dev, generator=g)
    x[1, _lane0_cols(W, k)] = 10.0
    fb.zero_()
    _assert_topk_exact(ttopk.top_k(x, k, fallbacks=fb),
                       ttopk.top_k_plain(x, k))
    assert fb.tolist() == [R, 0]


def _golden_feats(dev_cuda):
    """The golden shard's features, made once on the CPU: (cpu, card)."""
    from chinese_asr_tpu_torch.api import ASR
    asr = ASR(cfg=golden_cfg(tcfg), device="cpu")
    wavs = [asr._as_wav(w) for w in _golden_wavs()]
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    return (feats, lens), (feats.to(dev_cuda), lens.to(dev_cuda))


def _golden_wavs():
    from chinese_asr_tpu_torch.data import audio_io
    return [audio_io.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]


def test_lm_fused_decode_on_the_card_equals_cpu(dev):
    """The fused first pass (golden model and LM, bw 4, topn 8) on the
    card against the CPU path on the same features: tokens, lengths and
    the stop step exact, scores within 1e-5; K3 proposes, K4 never
    runs."""
    from chinese_asr_tpu_torch.decode import lm_fused
    from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint
    cfg = golden_cfg(tcfg)
    raw = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    out = {}
    for d, (feats, lens) in zip(("cpu", dev), _golden_feats(dev)):
        dlm = DeviceNgramLM.from_path(os.path.join(GOLD, "lm.arpa"), d)
        assert dlm.hashed
        tok2lm = torch.from_numpy(dlm.token_id_table(vocab)).to(d).long()
        counts = (ttopk.launches, ttopk.fused_launches)
        out[d] = lm_fused.lm_fused_decode(las.params_from_numpy(raw, d),
                                          cfg, 4, feats, lens, dlm, tok2lm,
                                          topn=8)
        if d == dev:
            assert ttopk.launches > counts[0]
            assert ttopk.fused_launches == counts[1]
    a, b = out["cpu"], out[dev]
    assert a.l_final == b.l_final
    for f in ("fin_tokens", "fin_lens", "fin_count", "live_tokens"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    for f in ("fin_scores", "live_scores"):
        x, y = getattr(a, f), getattr(b, f).cpu()
        assert torch.equal(torch.isfinite(x), torch.isfinite(y))
        fin = torch.isfinite(x)
        assert float((x[fin] - y[fin]).abs().max()) <= 1e-5, f


def test_hashed_score_candidates_on_the_card_equal_cpu(dev, tmp_path):
    """The hashed probes (a .klm fixture and a random order-5 ARPA) give
    the same scores on the card as the same tables on the CPU: the same
    gathers and f32 sums, so exactly equal."""
    from chinese_asr_tpu_torch.lm import device_ngram as tdn
    rng = np.random.default_rng(3)
    lines = ["\\data\\", "ngram 1=23", "ngram 2=40", "ngram 3=40",
             "ngram 4=40", "ngram 5=40", "", "\\1-grams:",
             "-1.5\t<unk>", "-9\t<s>\t-0.4", "-1.2\t</s>"]
    words = [f"w{i}" for i in range(20)]
    lines += [f"{-rng.uniform(0.1, 3):.4f}\t{w}\t{-rng.uniform(0, 1):.4f}"
              for w in words]
    for o in range(2, 6):
        lines += ["", f"\\{o}-grams:"]
        seen = set()
        while len(seen) < 40:
            seen.add(" ".join(rng.choice(words, o)))
        bo = "" if o == 5 else f"\t{-rng.uniform(0, 1):.4f}"
        lines += [f"{-rng.uniform(0.1, 3):.4f}\t{g}{bo}" for g in sorted(seen)]
    lines += ["", "\\end\\", ""]
    arpa = tmp_path / "o5.arpa"
    arpa.write_text("\n".join(lines))
    klm = os.path.join(os.path.dirname(GOLD), "data",
                       "golden_tri_probing.klm")
    for path in (klm, str(arpa)):
        card = tdn.DeviceNgramLM.from_path(path, dev)
        cpu = card.to("cpu")
        assert card.hashed and card.uni.device.type == "cuda"
        nw, M1 = card.uni.shape[0], card.order - 1
        ctx = torch.from_numpy(rng.integers(-1, nw, (4096, M1)))
        cand = torch.from_numpy(rng.integers(0, nw + 2, (4096, 6)))
        assert torch.equal(tdn.score_candidates(card, ctx.to(dev),
                                                cand.to(dev)).cpu(),
                           tdn.score_candidates(cpu, ctx, cand))


def test_int64_hash_products_wrap_on_the_card(dev):
    """The LM probes' int64 products wrap mod 2^64 on the card as on the
    CPU: the slot hash equals numpy's uint32 hash, CombineWordHash equals
    Python integers, and the chain over the golden LM's n-grams gives the
    keys the C++ reader enumerates."""
    from chinese_asr_tpu_torch.lm import device_ngram as tdn
    from chinese_asr_tpu_torch.lm import ngram as tngram
    rng = np.random.default_rng(1)
    keys = rng.integers(-2**31, 2**31, (4096, 3)).astype(np.int32)
    keys[:8] = -1
    got = tdn._hash_cols([torch.from_numpy(keys[:, j]).to(dev)
                          for j in range(3)])
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint32),
                                  tdn._hash_np(keys))
    u64 = (1 << 64) - 1
    h = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    h[:3] = [0, -1, -2**63]
    nxt = rng.integers(0, 2**32, 4096, dtype=np.int64)
    nxt[:2] = [0, 2**32 - 1]
    comb = tdn._combine_word_hash(torch.from_numpy(h).to(dev),
                                  torch.from_numpy(nxt).to(dev))
    assert [int(x) & u64 for x in comb.cpu().tolist()] == [
        ((int(a) & u64) * tdn._M1 ^ (1 + int(b)) * tdn._M2) & u64
        for a, b in zip(h, nxt)]
    path = os.path.join(GOLD, "lm.arpa")
    lm = tngram.NgramLM(path)
    grams = tngram.PyNgramLM(path).grams
    for k in range(2, lm.order + 1):
        ids = torch.tensor(np.stack([lm.word_ids(list(g)) for g in grams
                                     if len(g) == k]).astype(np.int64),
                           device=dev)
        g = ids[:, -1]
        for j in range(k - 2, -1, -1):
            g = tdn._combine_word_hash(g, ids[:, j])
        hi, lo, _, _ = lm.dump_order(k)
        assert {int(x) & u64 for x in g.cpu().tolist()} == {
            (int(a) << 32) | int(b) for a, b in zip(hi, lo)}


@pytest.mark.parametrize("lm", ["lm.arpa", "golden_tri_probing.klm"])
def test_golden_lm_first_on_the_card(dev, lm):
    """Golden ``lm_first`` (bw 4, topn 8) on the card through K3; the
    ``.klm`` fixture through the first and the device second pass gives
    the transcripts of the host C++ second pass over the same file."""
    from chinese_asr_tpu_torch.api import ASR
    kw = dict(ckpt_path=os.path.join(GOLD, "model.ckpt"),
              cfg=golden_cfg(tcfg), vocab=Vocab.build([CHARS * 3],
                                                     max_num_words=8),
              bw=4, lm_topn=8)
    if lm == "lm.arpa":
        with open(os.path.join(GOLD, "expected.json"),
                  encoding="utf-8") as f:
            expected = json.load(f)["modes"]["lm_first"]
        asr = ASR(lm_path=os.path.join(GOLD, lm), lm_mode="first", **kw)
        counts = (ttopk.launches, ttopk.fused_launches)
        assert asr.transcribe_files(golden_wav_paths()) == expected
        assert ttopk.launches > counts[0]
        assert ttopk.fused_launches == counts[1]
        return
    path = os.path.join(os.path.dirname(GOLD), "data", lm)
    texts = {m: ASR(lm_path=path, lm_mode=m, **kw).transcribe_files(
        golden_wav_paths()) for m in ("first", "second", "second_host")}
    cpu = ASR(lm_path=path, lm_mode="first", device="cpu", **kw)
    assert texts["first"] == cpu.transcribe_files(golden_wav_paths())
    assert texts["second"] == texts["second_host"]


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


def _golden_asr(**kw):
    from chinese_asr_tpu_torch.api import ASR
    return ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
               cfg=golden_cfg(tcfg),
               vocab=Vocab.build([CHARS * 3], max_num_words=8), **kw)


def test_served_burst_on_the_card(dev):
    """The golden shard served over HTTP on the card: six concurrent
    requests form one batch whose replies equal expected.json; K1 and K2
    launched on the worker thread, /healthz reports cuda."""
    import threading
    import urllib.request
    from chinese_asr_tpu_torch.serve import serve_http
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"]["greedy"]
    srv = serve_http(_golden_asr(), port=0, window_ms=2000.0, max_batch=8)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["backend"] == "cuda"
        counts = (tlogmel.launches, tlstm.launches)
        out = [None] * 6

        def post(i):
            with open(golden_wav_paths()[i], "rb") as f:
                req = urllib.request.Request(url + "/transcribe",
                                             data=f.read(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                out[i] = json.loads(r.read())["text"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert out == expected and srv.batcher.batches == 1
        assert tlogmel.launches > counts[0] and tlstm.launches > counts[1]
    finally:
        srv.shutdown()
        srv.server_close()


def test_overlapped_chunks_on_the_card(dev):
    """Three chunks uploaded on the side stream while the one before
    decodes: the transcripts equal each sorted chunk decoded alone, two
    runs agree, and the CPU path gives the same."""
    rng = np.random.default_rng(4)
    wavs = _golden_wavs()
    wavs = wavs + [w[: int(rng.integers(8000, 16000))] for w in wavs]
    asr = _golden_asr(bw=4)
    first = asr.transcribe_wavs(wavs, max_batch=4)
    assert asr._copy_stream is not None
    assert asr.transcribe_wavs(wavs, max_batch=4) == first
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
    for s in range(0, len(order), 4):
        idx = order[s:s + 4]
        assert [first[i] for i in idx] == asr.transcribe_wavs(
            [wavs[i] for i in idx])
    assert first == _golden_asr(bw=4, device="cpu").transcribe_wavs(
        wavs, max_batch=4)


@pytest.mark.parametrize("H", [16, 256])
@pytest.mark.parametrize("B", [1, 32, 128, 224, 225])
def test_lstm_bf16_kernel_matches_twin(dev, B, H):
    """K2-bf16: the cluster kernel (H=256) and the simple one (H=16), B on
    both sides of the rows-per-cluster switch and of one wave (224), with
    ragged masks (row 0 never stepped)."""
    T = 12
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(B * H)
    xg_f = torch.randn(T, B, 4 * H, device=dev, generator=g).to(bf)
    xg_b = torch.randn(T, B, 4 * H, device=dev, generator=g).to(bf)
    w = (torch.randn(2, H, 4 * H, device=dev, generator=g) / H ** 0.5).to(bf)
    lens = torch.randint(0, T + 1, (B,), device=dev, generator=g)
    lens[0] = 0
    m_f = (torch.arange(T, device=dev)[:, None] < lens[None]).to(bf)
    m_b = torch.flip(m_f, dims=(0,)).contiguous()
    before = (tlstm.launches, tlstm.bf16_launches)
    got = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    assert (tlstm.launches, tlstm.bf16_launches) == (before[0],
                                                     before[1] + 1)
    ref = tlstm.bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w)
    for a, b in zip(got, ref):
        assert a.dtype == bf and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= TOL_LSTM_BF16
    assert float(got[0][m_f == 0].float().abs().max()) == 0.0
    assert float(got[2][:, 0].float().abs().max()) == 0.0
    if H == 256:
        plan = tlstm.plan(B, H, bf)
        assert plan["rows"] == (16 if B <= 112 else 32)
        assert plan["waves"] == 1 or B > 224


def _adpcm_wire(x):
    buf = tfeat.adpcm_encode_flat(x)
    return torch.from_numpy(buf), len(x) // tfeat.ADPCM_K


@pytest.mark.parametrize("case", ["one_block", "odd", "square", "silence",
                                  "speech_like"])
def test_adpcm_kernel_matches_twin_exactly(dev, case):
    """K5: nb = 1, an odd nb (a partial last warp), a full-scale square
    wave (step index up to 95) and silence (down to 0)."""
    K = tfeat.ADPCM_K
    rng = np.random.default_rng(3)
    x = {"one_block": lambda: rng.standard_normal(K) * 4000,
         "odd": lambda: rng.standard_normal(37 * K) * 9000,
         "square": lambda: np.where((np.arange(65 * K) // 16) % 2,
                                    32767.0, -32768.0),
         "silence": lambda: np.zeros(33 * K),
         "speech_like": lambda: 12000 * np.sin(
             np.cumsum(rng.uniform(0.01, 0.2, 1001 * K)))}[case]()
    buf, nb = _adpcm_wire(np.clip(x, -32768, 32767).astype(np.int16))
    ref = tadpcm.adpcm_decode_flat_plain(buf, nb)
    before = tadpcm.launches
    got = tfeat.adpcm_decode_flat(buf.to(dev), nb)
    assert tadpcm.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("mode,bw", [("greedy", None), ("beam_bw4", 4)])
@pytest.mark.parametrize("kw", [dict(compute_dtype="bfloat16"),
                                dict(wire="mulaw"), dict(wire="adpcm")],
                         ids=["bf16", "mulaw", "adpcm"])
def test_golden_shard_lossy_modes_on_the_card(dev, kw, mode, bw):
    """bf16 and the lossy wires on the card give the CPU port's
    transcripts, through K2's bf16 instance and K5."""
    card = _golden_asr(bw=bw, **kw)
    counts = (tlstm.launches, tlstm.bf16_launches, tadpcm.launches)
    got = card.transcribe_files(golden_wav_paths())
    bf16 = "compute_dtype" in kw
    assert (tlstm.launches > counts[0]) != bf16
    assert (tlstm.bf16_launches > counts[1]) == bf16
    assert (tadpcm.launches > counts[2]) == (kw.get("wire") == "adpcm")
    assert got == _golden_asr(bw=bw, device="cpu", **kw).transcribe_files(
        golden_wav_paths())


def test_lstm_bf16_and_adpcm_reject_bad_operands(dev):
    T, B, H = 3, 2, 64
    bf = torch.bfloat16
    odd = torch.zeros(T * B * 4 * H + 1, device=dev, dtype=bf)[1:]
    xg = odd.view(T, B, 4 * H)                  # contiguous, 2-byte aligned
    m = torch.ones(T, B, device=dev, dtype=bf)
    w = torch.zeros(2, H, 4 * H, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="aligned"):
        tlstm.bidir_lstm_time_loop(xg, xg, m, m, w)
    with pytest.raises(ValueError):
        tlstm.bidir_lstm_time_loop(xg.double(), xg.double(), m, m, w)
    with pytest.raises(ValueError):                       # wrong wire size
        tadpcm.adpcm_decode_flat(torch.zeros(130, dtype=torch.uint8,
                                             device=dev), 1)


# K2-bwd against its twin: sums in other orders over 4H-term products and
# through the reverse recurrence; relative to the output's magnitude (dW
# sums T*B terms), chip_smoke.py's bound.
TOL_LSTM_BWD = 1e-4


def _lstm_bwd_case(dev, T, B, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def f(*s):
        return torch.randn(*s, device=dev, generator=g)

    xg_f, xg_b, w = f(T, B, 4 * H), f(T, B, 4 * H), f(2, H, 4 * H) / H ** 0.5
    # random non-prefix masks (the backward direction's padding comes first
    # once flipped, which random masks cover)
    m_f, m_b = ((torch.rand(T, B, device=dev, generator=g) > 0.3).float()
                for _ in range(2))
    ys_f, ys_b, _, _ = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    return (xg_f, xg_b, m_f, m_b, w, ys_f, ys_b, f(T, B, H), f(T, B, H),
            f(2, B, H), f(2, B, H))


def _rel_err(got, ref):
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(got, ref))


@pytest.mark.parametrize("H", [16, 256])
@pytest.mark.parametrize("T,B", [(40, 1), (33, 5), (64, 32)])
def test_lstm_bwd_kernel_matches_twin(dev, T, B, H):
    args = _lstm_bwd_case(dev, T, B, H, seed=T + B + H)
    before = tlstm.bwd_launches
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert tlstm.bwd_launches == before + 1
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _rel_err(got, ref) <= TOL_LSTM_BWD


@pytest.mark.parametrize("H", [12, 500, 1024])
def test_lstm_bwd_kernel_any_hidden_size(dev, H):
    """The simple kernel for every H <= 1024 outside the cluster kernel's
    (4, 2 or 1 threads a hidden unit)."""
    args = _lstm_bwd_case(dev, 6, 3, H, seed=H)
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert _rel_err(got, tlstm.bidir_lstm_time_loop_bwd_plain(*args)) \
        <= TOL_LSTM_BWD


@pytest.mark.parametrize("T", [1, 33])
@pytest.mark.parametrize("B", [1, 5, 16, 17, 32, 113, 128])
@pytest.mark.parametrize("H", [64, 128, 192, 256])
def test_lstm_bwd_cluster_kernel_matches_twin(dev, H, B, T):
    """The cluster kernel: one and two row tiles, a ragged tile, K2's
    16 -> 32 rows-per-cluster switch at B = 113; random non-prefix masks
    and nonzero ghT, gcT; one launch a call."""
    args = _lstm_bwd_case(dev, T, B, H, seed=7 * T + B + H)
    before = tlstm.bwd_launches
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert tlstm.bwd_launches == before + 1
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _rel_err(got, ref) <= TOL_LSTM_BWD


@pytest.mark.parametrize("H", [64, 256])
def test_lstm_bwd_cluster_plan_and_past_one_wave(dev, H):
    """``bwd_plan`` shows the cluster geometry (K2's rows rule: one wave up
    to B = 224), and B = 225, past one wave, is still right."""
    for B, rows in ((32, 16), (112, 16), (113, 32), (224, 32)):
        plan = tlstm.bwd_plan(B, H)
        assert plan["rows"] == rows
        assert plan["clusters"] == 2 * -(-B // rows)
        assert plan["max_active_clusters"] >= 14 and plan["waves"] == 1
    plan = tlstm.bwd_plan(225, H)
    assert plan["rows"] == 32 and plan["clusters"] == 16
    assert plan["waves"] == -(-16 // plan["max_active_clusters"])
    assert tlstm.bwd_plan(32, 16) == dict(rows=2, clusters=0,
                                          max_active_clusters=0, waves=0)
    args = _lstm_bwd_case(dev, 5, 225, H, seed=H)
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert _rel_err(got, tlstm.bidir_lstm_time_loop_bwd_plain(*args)) \
        <= TOL_LSTM_BWD


def test_lstm_bwd_takes_unaligned_operands(dev):
    """Operands that are contiguous views at a 4-byte offset (the cluster
    kernel copies 16-byte chunks) give the aligned call's result."""
    args = _lstm_bwd_case(dev, 9, 5, 64, seed=3)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, device=dev, dtype=a.dtype)
        return buf[1:].view(a.shape).copy_(a)

    moved = [shifted(a) for a in args]
    assert all(a.data_ptr() % 16 for a in moved)
    for a, b in zip(tlstm.bidir_lstm_time_loop_bwd(*moved),
                    tlstm.bidir_lstm_time_loop_bwd(*args)):
        assert torch.equal(a, b)


def test_k2_autograd_on_the_card_launches_k2_and_k2_bwd(dev):
    args = _lstm_bwd_case(dev, 20, 4, 16, seed=1)
    prim = [a.detach().clone().requires_grad_(i in (0, 1, 4))
            for i, a in enumerate(args[:5])]
    before = (tlstm.launches, tlstm.bwd_launches)
    out = tlstm.bidir_lstm(*prim)
    got = torch.autograd.grad(out, [prim[0], prim[1], prim[4]],
                              list(args[7:]))
    assert (tlstm.launches, tlstm.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    cpu = [a.detach().cpu().requires_grad_(a.requires_grad) for a in prim]
    out_c = tlstm.bidir_lstm(*cpu)
    ref = torch.autograd.grad(out_c, [cpu[0], cpu[1], cpu[4]],
                              [a.cpu() for a in args[7:]])
    assert _rel_err([a.cpu() for a in got], ref) <= TOL_LSTM_BWD
    with torch.no_grad():
        tlstm.bidir_lstm(*prim)
    assert tlstm.bwd_launches == before[1] + 1


def test_golden_train_step_on_the_card_equals_cpu(dev):
    """One train_step of the golden model from the same params and batch:
    the card (K1 outside, K2, K2-bwd, cuBLAS f32) against the CPU port
    (the twins).  Loss 1e-5 relative, grad norm 1e-4 relative, params
    2e-5 absolute (an ADAM step of lr 1e-3)."""
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = golden_cfg(tcfg).with_("train", clip=1.0)
    pn = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    rng = np.random.RandomState(0)
    B, T, S = 6, 40, 5
    feats = rng.randn(B, T, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([40, 31, 40, 25, 12, 40], np.int32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0
    text = rng.randint(4, cfg.vocab.vocab_size, (B, S))
    ti = np.concatenate([np.full((B, 1), 1), text[:, :-1]], 1)
    to = np.concatenate([text[:, :-1], np.full((B, 1), 2)], 1)
    tl = np.full(B, S, np.int32)
    out = {}
    for d in ("cpu", dev):
        params = las.params_from_numpy(pn, d)
        tx = optim.make_optimizer(cfg.train)
        batch = Batch(*(torch.tensor(a).to(d) for a in (feats, lens, ti, to,
                                                        tl)))
        before = tlstm.bwd_launches
        p, _, m = step.train_step(params, tx.init(params), cfg, tx, batch)
        out[str(d)] = (p, m, tlstm.bwd_launches - before)
    (pc, mc, nc), (pg, mg, ng) = out["cpu"], out[str(dev)]
    assert nc == 0 and ng == cfg.encoder.num_layers
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-4)
    for a, b in zip(las.tree_leaves(pg), las.tree_leaves(pc)):
        assert float((a.cpu() - b).abs().max()) <= 2e-5


# K2-bwd-bf16 against its bf16 twin: both round the kept gates, the stored
# dxg_t, the dh and dc carries and the rolled-forward c to bf16 from f32
# sums taken in other orders, so a value within an f32 rounding of a bf16
# boundary lands one bf16 ulp (2^-8 relative) apart and the reverse
# recurrence carries it on; relative to max(1, |ref|) of each output,
# chip_smoke.py's bound.  A layout bug errs by O(1).
TOL_LSTM_BWD_BF16 = 3e-2


def _bf16_case(args):
    """A K2-bwd case in bf16: the operands rounded, ys from K2-bf16."""
    bf = torch.bfloat16
    xg_f, xg_b, m_f, m_b, w = (a.to(bf) for a in args[:5])
    ys_f, ys_b, _, _ = tlstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    return (xg_f, xg_b, m_f, m_b, w, ys_f, ys_b) + tuple(a.to(bf)
                                                         for a in args[7:])


def _rel_err16(got, ref):
    return _rel_err([a.float() for a in got], [b.float() for b in ref])


@pytest.mark.parametrize("H", [16, 256])
@pytest.mark.parametrize("B", [32, 128])
def test_lstm_bwd_bf16_kernel_matches_twin(dev, B, H):
    """K2-bwd-bf16: the cluster kernel (H=256; 16 rows a cluster at B=32,
    32 at B=128) and the simple one (H=16), with ragged prefix masks (row
    0 full, row 1 never stepped) and nonzero ghT, gcT; one bf16 launch,
    the f32 counter unchanged."""
    T = 40
    args = _lstm_bwd_case(dev, T, B, H, seed=B + H)
    g = torch.Generator(device=dev).manual_seed(B * H)
    lens = torch.randint(0, T + 1, (B,), device=dev, generator=g)
    lens[0], lens[1] = T, 0
    m_f = (torch.arange(T, device=dev)[:, None] < lens[None]).float()
    args = _bf16_case(args[:2] + (m_f, torch.flip(m_f, dims=(0,)))
                      + args[4:])
    before = (tlstm.bwd_launches, tlstm.bwd_bf16_launches)
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert (tlstm.bwd_launches, tlstm.bwd_bf16_launches) == (before[0],
                                                             before[1] + 1)
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert all(a.dtype == torch.bfloat16 and a.shape == b.shape
               for a, b in zip(got, ref))
    assert all(bool(torch.isfinite(a.float()).all()) for a in got)
    assert _rel_err16(got, ref) <= TOL_LSTM_BWD_BF16
    # the row never stepped has no gate cotangent
    assert float(got[0][:, 1].float().abs().max()) == 0.0
    if H == 256:
        assert tlstm.bwd_plan(B, H, torch.bfloat16)["rows"] == \
            (16 if B <= 112 else 32)


@pytest.mark.parametrize("T", [1, 33])
@pytest.mark.parametrize("B", [1, 17, 113])
@pytest.mark.parametrize("H", [64, 128, 192, 256])
def test_lstm_bwd_bf16_cluster_kernel_matches_twin(dev, H, B, T):
    """The bf16 cluster kernel at every H it takes: one and two row tiles,
    a ragged tile, 32 rows a cluster from B = 113; random non-prefix
    masks."""
    args = _bf16_case(_lstm_bwd_case(dev, T, B, H, seed=5 * T + B + H))
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert _rel_err16(got, ref) <= TOL_LSTM_BWD_BF16


def test_lstm_bwd_bf16_rejects_bad_operands(dev):
    """An operand of another type than xg (the masks excepted) and a bf16
    operand that is not 4-byte aligned (read two units a word) raise; one
    at a 4-byte offset is copied and gives the aligned call's result."""
    bf = torch.bfloat16
    args = list(_bf16_case(_lstm_bwd_case(dev, 3, 2, 64, seed=5)))
    mixed = args[:7] + [args[7].float()] + args[8:]
    with pytest.raises(ValueError, match="float32"):
        tlstm.bidir_lstm_time_loop_bwd(*mixed)
    with pytest.raises(ValueError, match="unsupported"):
        tlstm.bidir_lstm_time_loop_bwd(*(a.double() for a in args))

    def at(a, offset):
        buf = torch.empty(a.numel() + offset, device=dev, dtype=bf)
        return buf[offset:].view(a.shape).copy_(a)

    with pytest.raises(ValueError, match="aligned"):
        tlstm.bidir_lstm_time_loop_bwd(*args[:7], at(args[7], 1), *args[8:])
    moved = [at(a, 2) for a in args]
    assert all(a.data_ptr() % 16 for a in moved)
    for a, b in zip(tlstm.bidir_lstm_time_loop_bwd(*moved),
                    tlstm.bidir_lstm_time_loop_bwd(*args)):
        assert torch.equal(a, b)


def test_k2_autograd_bf16_on_the_card_launches_k2_bf16_and_k2_bwd_bf16(dev):
    """bf16 operands under autograd run K2-bf16 forward and K2-bwd-bf16
    backward (no f32 launch), equal to the CPU twins'; an output the loss
    does not reach gets bf16 zeros."""
    args = _bf16_case(_lstm_bwd_case(dev, 20, 4, 64, seed=2))
    prim = [a.detach().clone().requires_grad_(i in (0, 1, 4))
            for i, a in enumerate(args[:5])]
    counts = lambda: (tlstm.launches, tlstm.bf16_launches,   # noqa: E731
                      tlstm.bwd_launches, tlstm.bwd_bf16_launches)
    before = counts()
    out = tlstm.bidir_lstm(*prim)
    got = torch.autograd.grad(out, [prim[0], prim[1], prim[4]],
                              list(args[7:]))
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    assert all(a.dtype == torch.bfloat16 for a in got)
    cpu = [a.detach().cpu().requires_grad_(a.requires_grad) for a in prim]
    out_c = tlstm.bidir_lstm(*cpu)
    ref = torch.autograd.grad(out_c, [cpu[0], cpu[1], cpu[4]],
                              [a.cpu() for a in args[7:]])
    assert _rel_err16([a.cpu() for a in got], ref) <= TOL_LSTM_BWD_BF16
    out = tlstm.bidir_lstm(*prim)
    only = torch.autograd.grad(out[0], [prim[0], prim[4]], args[7])
    assert all(a.dtype == torch.bfloat16 and bool(torch.isfinite(
        a.float()).all()) for a in only)


def test_golden_bf16_train_step_on_the_card_equals_cpu(dev):
    """One bf16 train_step of the golden model from the same params and
    batch: the card (K2-bf16, K2-bwd-bf16, cuBLAS bf16) against the CPU
    port (the bf16 twins).  Both round to bf16 from sums in other orders:
    loss 1e-2 relative, grad norm 2e-2 relative; params 2.5e-3 absolute,
    one ADAM step's flip (a step of lr 1e-3 moves each element by about
    lr times the sign of its gradient, and a gradient near zero may take
    the other sign), with at most 1 % of the elements farther apart than
    1e-4; one K2-bwd-bf16 launch a layer and no f32 K2-bwd."""
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = golden_cfg(tcfg).with_("train", clip=1.0,
                                 compute_dtype="bfloat16")
    pn = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    rng = np.random.RandomState(0)
    B, T, S = 6, 40, 5
    feats = rng.randn(B, T, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([40, 31, 40, 25, 12, 40], np.int32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0
    text = rng.randint(4, cfg.vocab.vocab_size, (B, S))
    ti = np.concatenate([np.full((B, 1), 1), text[:, :-1]], 1)
    to = np.concatenate([text[:, :-1], np.full((B, 1), 2)], 1)
    tl = np.full(B, S, np.int32)
    out = {}
    for d in ("cpu", dev):
        params = las.params_from_numpy(pn, d)
        tx = optim.make_optimizer(cfg.train)
        batch = Batch(*(torch.tensor(a).to(d) for a in (feats, lens, ti, to,
                                                        tl)))
        before = (tlstm.bwd_launches, tlstm.bwd_bf16_launches)
        p, o, m = step.train_step(params, tx.init(params), cfg, tx, batch)
        out[str(d)] = (p, o, m, tlstm.bwd_launches - before[0],
                       tlstm.bwd_bf16_launches - before[1])
    (pc, _, mc, *nc), (pg, og, mg, *ng) = out["cpu"], out[str(dev)]
    assert nc == [0, 0] and ng == [0, cfg.encoder.num_layers]
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-2)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=2e-2)
    diff = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                      zip(las.tree_leaves(pg), las.tree_leaves(pc))])
    assert float(diff.max()) <= 2.5e-3
    assert float((diff > 1e-4).float().mean()) <= 1e-2
    assert all(t.dtype == torch.float32 for t in las.tree_leaves(pg))
    assert all(v.dtype == torch.float32 for v in og.values()
               if v.is_floating_point())


# --------------------------------------------------------------------------
# the encoder families and variants (plain torch ops on the card: cuDNN
# convs, cuBLAS products with TF32 off, Python time loops) against the CPU
# port, on the same features: 1e-4 of max(1, max |ref|), chip_smoke.py's
# TOL_FAMILY_ENC; greedy tokens equal
# --------------------------------------------------------------------------
FAMILIES = ["LSTM", "GRU", "RNN_TANH", "RNN_RELU", "CNN1D", "CNN2D",
            "CNN1D_RNN", "CNN1D_SELF_ATTENTION", "SELF_ATTENTION",
            "SELF_LOCAL_ATTENTION", "CRNN", "DCNN"]


def _family_cfg(et, **over):
    cfg = (tcfg.Config()
           .with_("encoder", encoder_type=et, hidden_size=64, num_layers=2,
                  conv_channels=8, dcnn_middle=1, ffn_size=96)
           .with_("decoder", hidden_size=64, embed_dim=16)
           .with_("attention", attn_size=32)
           .with_("vocab", max_num_words=50)
           .with_("decode", max_len=12))
    for sec, kw in over.items():
        cfg = cfg.with_(sec, **kw)
    return cfg


@pytest.mark.parametrize("et", FAMILIES)
@pytest.mark.parametrize("train", [False, True])
def test_family_encoder_on_the_card_equals_cpu(dev, et, train):
    from chinese_asr_tpu_torch.decode import greedy
    from chinese_asr_tpu_torch.models import encoder as tenc
    from chinese_asr_tpu_torch.models import las
    cfg = _family_cfg(et)
    rng = np.random.RandomState(7)
    B, T = 3, 57
    feats = rng.randn(B, T, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([57, 40, 9], np.int32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0
    out = {}
    for d in ("cpu", dev):
        p = las.init_params(cfg, 3, d)
        x, n = torch.tensor(feats).to(d), torch.tensor(lens).to(d)
        up = []
        enc = tenc.apply_encoder(p["encoder"], cfg, x, n, train=train,
                                 bn_updates=up)
        g = None if train else greedy.greedy_decode(p, cfg, x, n)
        out[str(d)] = (enc, up, g)
    (ec, uc, gc), (eg, ug, gg) = out["cpu"], out[str(dev)]
    ref = ec.out
    err = float((eg.out.cpu() - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), (et, err)
    assert torch.equal(eg.out_lens.cpu(), ec.out_lens)
    assert len(ug) == len(uc)
    for (_, mg, vg, _), (_, mc, vc, _) in zip(ug, uc):
        assert float((mg.cpu() - mc).abs().max()) <= 1e-5
        assert float((vg.cpu() - vc).abs().max()) <= 1e-5 * max(
            1.0, float(vc.abs().max()))
    if not train:
        assert torch.equal(gg.tokens.cpu(), gc.tokens)


@pytest.mark.parametrize("over", [
    dict(encoder=dict(bidirectional=False)),
    dict(decoder=dict(decoder_type="GRU")),
    dict(attention=dict(attn_type="L")),
    dict(attention=dict(heads=4, map_enc=True, linear_map=True))],
    ids=["unidirectional", "gru_decoder", "luong", "heads4"])
def test_variant_beam_on_the_card_equals_cpu(dev, over):
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.models import las
    cfg = _family_cfg("LSTM", **over)
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 31, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([31, 17], np.int32)
    feats[1, 17:] = 0
    res = {}
    for d in ("cpu", dev):
        p = las.init_params(cfg, 4, d)
        res[str(d)] = beam.select_best(
            beam.beam_decode(p, cfg, 4, torch.tensor(feats).to(d),
                             torch.tensor(lens).to(d)),
            cfg.decode.length_weight)
    c, g = res["cpu"], res[str(dev)]
    assert torch.equal(g.tokens.cpu(), c.tokens)
    assert torch.equal(g.lens.cpu(), c.lens)
    assert float((g.scores.cpu() - c.scores).abs().max()) <= 1e-4


@pytest.mark.parametrize("ranks,shape", [(1, "1x1"), (4, "2x2")])
def test_dryrun_multichip_on_the_card(dev, ranks, shape):
    """The mesh on the card (``parallel/dryrun.py``): one rank over NCCL,
    and four ranks sharing the card over gloo; the beam, the LM first
    pass, the device rescore and the f32 and bf16 train steps sharded
    equal one device's."""
    from chinese_asr_tpu_torch.parallel.dryrun import dryrun_multichip
    line = dryrun_multichip(ranks, "cuda", timeout_s=300)
    assert line.startswith(f"dryrun_multichip ok: mesh=({shape})")


# --------------------------------------------------------------------------
# the compiled decode entry points (``*_jit``): CUDA-graph replays
# --------------------------------------------------------------------------
JIT_MODES = ("greedy", "beam", "beam_best", "lm_second", "lm_second_select",
             "lm_first", "lm_first_best")


def _jit_setup(dev, dtype=torch.float32):
    """The golden model, its features, LM tables and token map on the
    card, in ``dtype``."""
    from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
    asr = _golden_asr(device=dev, compute_dtype=(
        "bfloat16" if dtype == torch.bfloat16 else "float32"))
    wavs = [asr._as_wav(w) for w in _golden_wavs()]
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    dlm = DeviceNgramLM.from_path(os.path.join(GOLD, "lm.arpa"), dev)
    tok2lm = torch.from_numpy(dlm.token_id_table(asr.vocab)).to(dev).long()
    return asr, feats, lens, dlm, tok2lm


def _jit_call(mode, asr, feats, lens, dlm, tok2lm, jit: bool):
    """One mode's ``*_jit`` form (``jit``) or its eager function, with the
    same arguments."""
    from chinese_asr_tpu_torch.decode import beam, greedy, lm_fused, rescore
    p, cfg, dc = asr.params, asr.cfg, asr.cfg.decode
    bos, eos = (int(x) for x in dlm.word_ids(["<s>", "</s>"]))
    lm = (dlm, tok2lm, dc.lm_weight, dc.length_weight, bos, eos)
    if mode == "greedy":
        out = (greedy.greedy_decode_jit if jit else greedy.greedy_decode)(
            p, cfg, feats, lens)
    elif mode == "beam":
        out = (beam.beam_decode_jit if jit else beam.beam_decode)(
            p, cfg, 4, feats, lens)
    elif mode == "beam_best":
        out = (beam.beam_decode_best_jit if jit else beam.beam_decode_best)(
            p, cfg, 4, feats, lens)
    elif mode == "lm_second":
        out = (rescore.beam_rescored_best_jit if jit
               else rescore.beam_rescored_best)(p, cfg, 4, feats, lens, *lm)
    elif mode == "lm_second_select":
        res = beam.compact_nbest(beam.beam_decode(p, cfg, 4, feats, lens))
        out = (rescore.rescore_select_jit if jit
               else rescore.rescore_select)(res, *lm)
    elif mode == "lm_first":
        out = (lm_fused.lm_fused_decode_jit if jit
               else lm_fused.lm_fused_decode)(p, cfg, 4, feats, lens, dlm,
                                              tok2lm, 8)
    else:
        out = (lm_fused.lm_fused_decode_best_jit if jit
               else lm_fused.lm_fused_decode_best)(p, cfg, 4, feats, lens,
                                                   dlm, tok2lm, 8)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", JIT_MODES)
def test_jit_graph_equals_eager_on_the_card(dev, mode, dtype):
    """Each ``*_jit`` form's graph replay equals its eager function
    exactly, field by field, at its first call (the capture) and at a
    replay; the program is cached once."""
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    args = _jit_setup(dev, dtype)
    want = _jit_call(mode, *args, jit=False)
    for _ in range(2):
        got = _jit_call(mode, *args, jit=True)
        for name, w in want._asdict().items():
            assert torch.equal(getattr(got, name), w), name
    assert len(graphs.programs()) == 1
    assert graphs.programs()[0][1].replays == 2


def test_jit_replays_count_launches_on_the_card(dev):
    """The launch counters under replay: a replay adds what its graphs
    launch (K3 once a replayed step, K2 once a layer) and a capture adds
    nothing of its own (the first call counts its eager warm-up and its
    replay)."""
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, _, _ = _jit_setup(dev)
    eager = []
    for run in range(3):
        before = (tlstm.launches, ttopk.launches)
        if run == 0:
            res = beam.beam_decode(asr.params, asr.cfg, 4, feats, lens,
                                   unroll=graphs.UNROLL)
        else:
            res = beam.beam_decode_jit(asr.params, asr.cfg, 4, feats, lens)
        eager.append((tlstm.launches - before[0], ttopk.launches - before[1]))
    steps = (int(res.l_final) // graphs.UNROLL + 1) * graphs.UNROLL
    assert int(res.l_final) < asr.cfg.decode.max_len - 1    # stops early
    layers = asr.cfg.encoder.num_layers
    assert eager[0] == (layers, steps)
    assert eager[1] == (2 * layers, 2 * steps)   # warm-up + first replay
    assert eager[2] == (layers, steps)
    (_, prog), = graphs.programs()
    assert prog.done_reads == 2 and prog.capture_ms > 0
    assert prog.reserved_bytes > 0


def test_jit_rekeys_on_rebound_params_and_fused_flag(dev, monkeypatch):
    """A graph never replays on tensors it did not capture: rebinding a
    parameter leaf to a new tensor captures a new program, whose result
    is the eager loop's on the new params; flipping
    ``CHINESE_ASR_PALLAS_FUSED`` captures another, which launches K4."""
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, _, _ = _jit_setup(dev)
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", "0")
    p, cfg = asr.params, asr.cfg
    beam.beam_decode_best_jit(p, cfg, 4, feats, lens)
    p["decoder"]["proj_b"] = p["decoder"]["proj_b"] + 0.5     # a new tensor
    got = beam.beam_decode_best_jit(p, cfg, 4, feats, lens)
    want = beam.beam_decode_best(p, cfg, 4, feats, lens)
    for name, w in want._asdict().items():
        assert torch.equal(getattr(got, name), w), name
    assert len(graphs.programs()) == 2
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", "1")
    counts = (ttopk.launches, ttopk.fused_launches)
    beam.beam_decode_best_jit(p, cfg, 4, feats, lens)
    assert len(graphs.programs()) == 3
    counts2 = (ttopk.launches, ttopk.fused_launches)
    beam.beam_decode_best_jit(p, cfg, 4, feats, lens)       # a replay
    assert ttopk.launches == counts2[0] == counts[0]
    assert ttopk.fused_launches > counts2[1] > counts[1]


def test_jit_eviction_frees_memory_on_the_card(dev, monkeypatch):
    """The cache holds at most ``BUDGET_FRACTION`` of the card in its
    programs' pools, least recently used out (the newest stays); evicting
    a program releases its private pool."""
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, _, _ = _jit_setup(dev)
    beam.beam_decode_best_jit(asr.params, asr.cfg, 4, feats, lens)
    (key_a, prog), = graphs.programs()
    pool_bytes = prog.reserved_bytes
    assert 0 < pool_bytes <= graphs.budget_bytes(dev)
    del prog
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev)
    gone = graphs.evictions
    # a budget below one program's pool: the new program evicts the old
    monkeypatch.setattr(graphs, "BUDGET_FRACTION",
                        pool_bytes / 2 / torch.cuda.get_device_properties(
                            dev).total_memory)
    beam.beam_decode_best_jit(asr.params, asr.cfg, 4, feats[:3], lens[:3])
    (key_b, _), = graphs.programs()
    assert key_b != key_a and graphs.evictions == gone + 1
    graphs.clear()
    assert graphs.programs() == []
    assert torch.cuda.memory_reserved(dev) <= held - pool_bytes


def test_jit_two_threads_at_one_key_get_their_own_results(dev):
    """Two threads decode different batches of one shape (one program)
    through ``beam_decode_best_jit`` and ``beam_decode_jit``: every call
    returns its own batch's result, equal to the eager function's, since
    a call copies its outputs out of the graphs before another can
    replay them."""
    import threading
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, _, _ = _jit_setup(dev)
    p, cfg = asr.params, asr.cfg
    batches = [(feats, lens), (feats.flip(0), lens.flip(0))]
    fns = {"best": (beam.beam_decode_best_jit, beam.beam_decode_best),
           "beam": (beam.beam_decode_jit, beam.beam_decode)}
    want = {(name, i): eager(p, cfg, 4, *b)
            for name, (_, eager) in fns.items()
            for i, b in enumerate(batches)}
    assert not torch.equal(want["best", 0].tokens, want["best", 1].tokens)
    wrong, errors = [], []

    def worker(i):
        try:
            for _ in range(8):
                for name, (jit, _) in fns.items():
                    got = jit(p, cfg, 4, *batches[i])
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in
                               zip(got, want[name, i])):
                        wrong.append((name, i))
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not wrong
    assert len(graphs.programs()) == 2
