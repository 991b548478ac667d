"""PyTorch port on the card: each CUDA kernel against its plain twin at
small and edge shapes, and the golden shard through the kernels.  Marked
``cuda``; every test skips when no GPU is present (decided inside the
fixture, never at import).  Run on a GPU machine with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -o addopts=""

Tolerances are the ones chip_smoke.py states: log-mel 2e-3 absolute,
BiLSTM 1e-4 absolute (bf16: TOL_LSTM_BF16, below), top-k exact, fused
top-k 1e-5 absolute on values (the logsumexp is summed in another order),
indices exact where the values are separated by more than that, ADPCM
decode exact, the beam's attention read (K6) 1e-5 absolute on align in
float32 (the sum over a is taken in another order) and, in bf16, one
bf16 rounding of the twin evaluated in float32 on the same bf16 inputs;
the 3xTF32 GEMM (K7) within 4x of cuBLAS's float32 error against the
float64 product, each error measured against |x| @ |w| + |b|.
"""

import json
import os

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.models import attention as tattn_ops
from chinese_asr_tpu_torch.models import conformer as tconf
from chinese_asr_tpu_torch.ops import conv as tconv
from chinese_asr_tpu_torch.ops.cuda import adpcm as tadpcm
from chinese_asr_tpu_torch.ops.cuda import attention as tattn
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
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
# K6 in bf16 against the bf16 twin, which rounds the sum, tanh, the
# product with v and the sum over a to bf16 before its softmax: a score's
# rounding (2^-9 of |score| <= 4) moves its softmax weight by up to ~0.8 %
# of itself, and align's own rounding 2^-9 of it: ~1.2e-2 at align 1
TOL_ATTN_BF16_TWIN = 1.6e-2


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
        rows=8 if H <= 512 else 2, ctas=0, clusters=0,
        max_active_clusters=0, waves=0)


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
        shape = tlstm.cluster_shape(B, H, bf)
        assert {k: plan[k] for k in shape} == shape
        assert plan["rows"] == 16
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
    assert tlstm.bwd_plan(32, 16) == dict(rows=2, ctas=0, clusters=0,
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
        plan = tlstm.bwd_plan(B, H, torch.bfloat16)
        shape = tlstm.cluster_shape(B, H, torch.bfloat16)
        assert {k: plan[k] for k in shape} == shape and plan["rows"] == 16


@pytest.mark.parametrize("T", [1, 33])
@pytest.mark.parametrize("B", [1, 17, 113])
@pytest.mark.parametrize("H", [64, 128, 192, 256])
def test_lstm_bwd_bf16_cluster_kernel_matches_twin(dev, H, B, T):
    """The bf16 stages and pass 2's cluster kernel at every H it takes:
    one and two row tiles, a ragged tile, clusters of 4 from B = 113;
    random non-prefix masks."""
    args = _bf16_case(_lstm_bwd_case(dev, T, B, H, seed=5 * T + B + H))
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert _rel_err16(got, ref) <= TOL_LSTM_BWD_BF16


@pytest.mark.parametrize("H", [64, 192, 256])
@pytest.mark.parametrize("T,B", [(1, 1), (29, 17), (40, 128)])
def test_lstm_bwd_bf16_stage_kernels_match_plain_stages(dev, T, B, H):
    """K2-bwd-bf16's pass-1 stage kernels against their plain stages on
    the same inputs: (a) the rebuild of hs exactly; (c) the activation and
    c's roll from the same f32 pre-activations of (b), within the bf16
    bound (a sum within an f32 rounding of a bf16 boundary rounds one ulp
    apart and c carries it on).  No stage counts a launch."""
    args = _bf16_case(_lstm_bwd_case(dev, T, B, H, seed=T * B + H))
    counts = (tlstm.bwd_launches, tlstm.bwd_bf16_launches)
    hs = tlstm.rebuild_hs(args[5], args[6], args[2], args[3])
    assert torch.equal(hs, tlstm.rebuild_hs_plain(args[5], args[6], args[2],
                                                  args[3]))
    pre = tlstm.pre_gates(hs, args[4])
    assert pre.dtype == torch.float32
    ref_pre = tlstm.pre_gates(hs.cpu(), args[4].cpu())
    assert float((pre.cpu() - ref_pre).abs().max()) <= 1e-4 * max(
        1.0, float(ref_pre.abs().max()))
    got = tlstm.activate(*args[:4], pre)
    ref = tlstm.activate_plain(*args[:4], pre)
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert _rel_err16(got, ref) <= TOL_LSTM_BWD_BF16
    assert (tlstm.bwd_launches, tlstm.bwd_bf16_launches) == counts


@pytest.mark.parametrize("B", [32, 128, 200])
def test_lstm_bf16_kernels_at_flagship_width(dev, B):
    """K2-bf16 and K2-bwd-bf16 against their twins at H = 256 (the
    flagship layer) with random non-prefix masks, on the bf16 plan: 16
    rows a cluster at every B, 8 CTAs at B = 32, 4 at B = 128 and 200;
    one bf16 count a call and no f32 count, forward and backward."""
    H, T, bf = 256, 48, torch.bfloat16
    args = _bf16_case(_lstm_bwd_case(dev, T, B, H, seed=B))
    counts = lambda: (tlstm.launches, tlstm.bf16_launches,   # noqa: E731
                      tlstm.bwd_launches, tlstm.bwd_bf16_launches)
    before = counts()
    got = tlstm.bidir_lstm_time_loop(*args[:5])
    assert counts() == (before[0], before[1] + 1, before[2], before[3])
    ref = tlstm.bidir_lstm_time_loop_plain(*args[:5])
    for a, b in zip(got, ref):
        assert a.dtype == bf
        assert float((a.float() - b.float()).abs().max()) <= TOL_LSTM_BF16
    before = counts()
    got = tlstm.bidir_lstm_time_loop_bwd(*args)
    assert counts() == (before[0], before[1], before[2], before[3] + 1)
    assert _rel_err16(got, tlstm.bidir_lstm_time_loop_bwd_plain(*args)) \
        <= TOL_LSTM_BWD_BF16
    for plan in (tlstm.plan(B, H, bf), tlstm.bwd_plan(B, H, bf)):
        assert plan["rows"] == 16 and plan["ctas"] == (8 if B <= 112 else 4)
        assert plan["waves"] == 1


def test_lstm_bf16_plan_is_one_wave_at_b128(dev):
    """The bf16 plan at the main path's B = 128: 16 clusters of 4 CTAs, 16
    rows each, in one wave, for K2-bf16 and K2-bwd-bf16's pass 2 alike;
    the f32 kernels keep 8 clusters of 8 at 32 rows."""
    bf = torch.bfloat16
    for plan in (tlstm.plan(128, 256, bf), tlstm.bwd_plan(128, 256, bf)):
        assert {k: plan[k] for k in ("rows", "ctas", "clusters")} == dict(
            rows=16, ctas=4, clusters=16)
        assert plan["max_active_clusters"] >= 16 and plan["waves"] == 1
    for plan in (tlstm.plan(128, 256), tlstm.bwd_plan(128, 256)):
        assert {k: plan[k] for k in ("rows", "ctas", "clusters")} == dict(
            rows=32, ctas=8, clusters=8)


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
    card, in ``dtype``; the front end's program is dropped, so the cache
    holds the decode programs alone."""
    from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
    from chinese_asr_tpu_torch.utils import graphs
    asr = _golden_asr(device=dev, compute_dtype=(
        "bfloat16" if dtype == torch.bfloat16 else "float32"))
    wavs = [asr._as_wav(w) for w in _golden_wavs()]
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    graphs.clear()
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
    """The launch counters under replay: a replay adds what its graph
    launches (K3 and K6 once a step of a chunk that ran, K2 once a layer)
    once ``graphs.settle`` has read how many guarded chunks ran, and a
    capture adds nothing of its own (the first call counts its eager
    warm-up and its replay); the chunks skipped after the stop add
    nothing."""
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, _, _ = _jit_setup(dev)
    eager = []
    for run in range(3):
        before = (tlstm.launches, ttopk.launches, tattn.launches)
        if run == 0:
            res = beam.beam_decode(asr.params, asr.cfg, 4, feats, lens,
                                   unroll=graphs.UNROLL)
        else:
            res = beam.beam_decode_jit(asr.params, asr.cfg, 4, feats, lens)
        graphs.settle(wait=True)
        eager.append((tlstm.launches - before[0], ttopk.launches - before[1],
                      tattn.launches - before[2]))
    steps = (int(res.l_final) // graphs.UNROLL + 1) * graphs.UNROLL
    assert int(res.l_final) < asr.cfg.decode.max_len - 1    # stops early
    layers = asr.cfg.encoder.num_layers
    assert eager[0] == (layers, steps, steps)
    assert eager[1] == (2 * layers, 2 * steps, 2 * steps)   # warm-up + replay
    assert eager[2] == (layers, steps, steps)
    (_, prog), = graphs.programs()
    assert prog.chunks == -(-asr.cfg.decode.max_len // graphs.UNROLL)
    assert steps < prog.chunks * graphs.UNROLL and prog.capture_ms > 0
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
    a program releases its private pool (the earlier tests' garbage
    collected first, so that only the programs move the card's memory)."""
    import gc
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    gc.collect()
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
    (key_b,) = [k for k, _ in graphs.programs()]     # holds no program
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


# --------------------------------------------------------------------------
# dispatch-ahead: the decode loop's stop test on the card (each chunk after
# the first inside a conditional IF node), ASR._decode_dispatch returning
# before the decode ends, and the front end as one graph a key
# --------------------------------------------------------------------------
LOOP_MODES = ("greedy", "beam", "beam_best", "lm_second", "lm_first",
              "lm_first_best")


def _loop_call(mode, asr, feats, lens, dlm, tok2lm, jit: bool, unroll: int):
    """``_jit_call`` of a looping mode with ``unroll`` passed to both the
    ``*_jit`` form and its eager function (``run_loop``)."""
    from chinese_asr_tpu_torch.decode import beam, greedy, lm_fused, rescore
    p, cfg, dc = asr.params, asr.cfg, asr.cfg.decode
    bos, eos = (int(x) for x in dlm.word_ids(["<s>", "</s>"]))
    lm = (dlm, tok2lm, dc.lm_weight, dc.length_weight, bos, eos)
    kw = dict(unroll=unroll)
    if mode == "greedy":
        fn = greedy.greedy_decode_jit if jit else greedy.greedy_decode
        return fn(p, cfg, feats, lens, **kw)
    if mode == "beam":
        fn = beam.beam_decode_jit if jit else beam.beam_decode
        return fn(p, cfg, 4, feats, lens, **kw)
    if mode == "beam_best":
        fn = beam.beam_decode_best_jit if jit else beam.beam_decode_best
        return fn(p, cfg, 4, feats, lens, **kw)
    if mode == "lm_second":
        fn = (rescore.beam_rescored_best_jit if jit
              else rescore.beam_rescored_best)
        return fn(p, cfg, 4, feats, lens, *lm, **kw)
    fn = {("lm_first", True): lm_fused.lm_fused_decode_jit,
          ("lm_first", False): lm_fused.lm_fused_decode,
          ("lm_first_best", True): lm_fused.lm_fused_decode_best_jit,
          ("lm_first_best", False): lm_fused.lm_fused_decode_best}[mode, jit]
    return fn(p, cfg, 4, feats, lens, dlm, tok2lm, 8, **kw)


@pytest.mark.parametrize("model", ["golden", "random"])
@pytest.mark.parametrize("mode", LOOP_MODES)
def test_jit_conditional_chunks_equal_run_loop_on_the_card(dev, mode, model):
    """Each looping ``*_jit`` form (one graph, every chunk after the first
    under an IF node on ``~done``) equals its eager function, which runs
    ``run_loop`` reading ``done`` on the host, field by field, at unroll
    1, 2, 3 and 4: on the golden model, which stops early (at unroll 1
    on a chunk boundary, and at some larger unroll inside a chunk), and
    at random weights."""
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    asr, feats, lens, dlm, tok2lm = _jit_setup(dev)
    if model == "random":
        asr.params = las.init_params(asr.cfg, 3, dev)
    stop = beam.beam_decode(asr.params, asr.cfg, 4, feats, lens).l_final
    stops = int(stop) + 1
    max_len = asr.cfg.decode.max_len
    mid = []
    for unroll in (1, 2, 3, 4):
        want = _loop_call(mode, asr, feats, lens, dlm, tok2lm, False, unroll)
        for _ in range(2):
            got = _loop_call(mode, asr, feats, lens, dlm, tok2lm, True,
                             unroll)
            for name, w in want._asdict().items():
                assert torch.equal(getattr(got, name), w), (unroll, name)
        mid.append(stops % unroll != 0)
    if model == "golden":
        assert stops < max_len - 1 and any(mid)
    assert len(graphs.programs()) == 4


def test_decode_dispatch_returns_before_the_decode_ends_on_the_card(dev):
    """``ASR(bw=16)._decode_dispatch`` of a featurized B=32 batch of 9-10 s
    wavs at the flagship width returns with the decode still queued on
    the stream; its finalization gives the serial call's transcripts."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.utils import graphs
    from torch_port_util import random_wavs
    graphs.clear()
    asr = ASR(bw=16, device=dev, seed=0)
    rng = np.random.default_rng(0)
    wavs = random_wavs(rng, rng.integers(144000, 160000, 32))
    first = asr._decode_batch(asr._featurize(asr._upload(asr._prep(wavs,
                                                                   None))))
    feats = asr._featurize(asr._upload(asr._prep(wavs, None)))
    torch.cuda.synchronize()
    res = asr._decode_dispatch(feats)
    assert not torch.cuda.current_stream().query()
    assert asr._decode_finalize(res) == first
    graphs.clear()


@pytest.mark.parametrize("mode,kw", [
    ("greedy", dict(bw=None)), ("beam_bw4", dict(bw=4)),
    ("lm_second", dict(bw=4, lm_mode="second")),
    ("lm_second_host", dict(bw=4, lm_mode="second_host")),
    ("lm_first", dict(bw=4, lm_mode="first", lm_topn=8))])
def test_two_dispatches_of_one_key_get_their_own_batches_on_the_card(
        dev, mode, kw):
    """Two golden batches of one key (the shard and the shard reversed)
    dispatched one after the other before either is finalized: each
    finalization gives its own batch's serial transcripts, and the two
    share one front-end and one decode program."""
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()
    if "lm_mode" in kw:
        kw = dict(kw, lm_path=os.path.join(GOLD, "lm.arpa"))
    asr = _golden_asr(device=dev, **kw)
    batches = [_golden_wavs(), _golden_wavs()[::-1]]

    def featurized(w):
        return asr._featurize(asr._upload(asr._prep(w, None)))
    want = [asr._decode_batch(featurized(w)) for w in batches]
    assert want[0] != want[1]
    held = len(graphs.programs())
    pend = [asr._decode_dispatch(featurized(w)) for w in batches]
    assert [asr._decode_finalize(r) for r in pend] == want
    assert len(graphs.programs()) == held == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["flat", "padded", "mulaw", "adpcm"])
def test_front_end_graph_equals_eager_on_the_card(dev, wire, dtype):
    """``ASR._featurize`` (one graph a key, ``features.front_end_jit``) at
    its capture and at a replay equals the eager ``features.front_end``
    on the same upload bit for bit; a replay counts K1 once (and K5 once
    over the ADPCM wire)."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.utils import graphs
    from torch_port_util import random_wavs
    graphs.clear()
    asr = ASR(device=dev, wire=wire, compute_dtype=dtype, seed=0)
    rng = np.random.default_rng(2)
    wavs = random_wavs(rng, [16000, 7000, 300, 23000])
    scales = [1.0, 0.5, 2.0, 1.3]
    for _ in range(2):
        before = (tlogmel.launches, tadpcm.launches)
        up = asr._upload(asr._prep(wavs, scales))
        feats, lens = asr._featurize(up)
        counted = (tlogmel.launches - before[0], tadpcm.launches - before[1])
        name = "flat" if wire == "mulaw" else wire
        ef, el = tfeat.front_end(name, *up.tensors, up.N, asr.cfg.audio,
                                 1e-6, asr.compute_dtype)
        assert feats.dtype == asr.compute_dtype
        assert torch.equal(feats, ef) and torch.equal(lens, el)
    assert counted == (1, int(wire == "adpcm"))
    (key, prog), = graphs.programs()
    assert key[0] == "front_end" and prog.replays == 2
    wav = torch.from_numpy(np.stack([w[:7000] for w in wavs[:2]])).to(dev)
    wl = torch.tensor([7000, 6000], dtype=torch.int32, device=dev)
    for _ in range(2):
        got = tfeat.featurize_batch_jit(wav, wl, asr.cfg.audio)
        want = tfeat.featurize_batch(wav, wl, asr.cfg.audio)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    graphs.clear()


# --------------------------------------------------------------------------
# the compiled train step (train/step.py CompiledStep): one CUDA graph a
# key in one shared pool, against the eager train_step on the card
# --------------------------------------------------------------------------
# graph against eager: the same kernels in the same order, so bit for bit


def _golden_train_setup(dev, dtype="float32", B=6, T=40, S=5, seed=0):
    """The golden model's config (clip 1.0, ``dtype``), its params on the
    card and a seeded batch [B, T] x [B, S] there."""
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = golden_cfg(tcfg).with_("train", clip=1.0, compute_dtype=dtype)
    pn = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, cfg.audio.feat_dim).astype(np.float32)
    lens = rng.randint(T // 3, T + 1, B).astype(np.int32)
    lens[0] = T
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0
    text = rng.randint(4, cfg.vocab.vocab_size, (B, S))
    ti = np.concatenate([np.full((B, 1), 1), text[:, :-1]], 1)
    to = np.concatenate([text[:, :-1], np.full((B, 1), 2)], 1)
    tl = np.full(B, S, np.int32)
    batch = Batch(*(torch.tensor(a).to(dev) for a in (feats, lens, ti, to,
                                                      tl)))
    return cfg, las.params_from_numpy(pn, dev), batch


def _state_leaves(params, opt_state):
    from chinese_asr_tpu_torch.models import las
    return las.tree_leaves(params) + [opt_state[k] for k in sorted(opt_state)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_train_step_equals_eager_on_the_card(dev, dtype):
    """Three steps of the golden model through ``CompiledStep`` (a capture,
    then replays) against the eager ``train_step`` on the card from the
    same params: the same kernels in the same order, so the loss, the grad
    norm, every param and every optimizer state tensor are equal bit for
    bit at every step; the state keeps its tensors."""
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step

    cfg, params, batch = _golden_train_setup(dev, dtype)
    tx = optim.make_optimizer(cfg.train)
    p_g = las.tree_map(torch.clone, params)
    o_g = tx.init(p_g)
    p_e, o_e = params, tx.init(params)
    ptrs = [t.data_ptr() for t in _state_leaves(p_g, o_g)]
    compiled = step.CompiledStep(cfg, tx)
    for i in range(3):
        _, _, m_g = compiled(p_g, o_g, batch)
        p_e, o_e, m_e = step.train_step(p_e, o_e, cfg, tx, batch)
        for k in ("loss", "grad_norm", "skipped"):
            assert torch.equal(m_g[k], m_e[k]), (i, k)
        assert not bool(m_g["skipped"])
        for a, b in zip(_state_leaves(p_g, o_g), _state_leaves(p_e, o_e)):
            assert torch.equal(a, b), i
    assert compiled.graphs.captures == 1 and compiled.graphs.replays == 3
    assert ptrs == [t.data_ptr() for t in _state_leaves(p_g, o_g)]


def test_graph_train_step_skips_a_non_finite_loss_on_the_card(dev):
    """A replay whose loss is not finite leaves every param and optimizer
    state tensor as it was, and reports the skip; the next finite batch
    of the key steps again."""
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step

    cfg, params, batch = _golden_train_setup(dev)
    tx = optim.make_optimizer(cfg.train)
    state = tx.init(params)
    compiled = step.CompiledStep(cfg, tx)
    compiled(params, state, batch)                  # capture, one step
    before = [t.clone() for t in las.tree_leaves(params)
              + list(state.values())]
    bad = batch._replace(feats=batch.feats.clone())
    bad.feats[0, 0, 0] = float("nan")
    _, _, m = compiled(params, state, bad)
    assert compiled.graphs.captures == 1            # a replay
    assert bool(m["skipped"]) and not torch.isfinite(m["loss"])
    for a, b in zip(las.tree_leaves(params) + list(state.values()), before):
        assert torch.equal(a, b)
    _, _, m = compiled(params, state, batch)
    assert not bool(m["skipped"]) and int(state["count"]) == 2


def test_graph_train_step_second_bucket_shares_the_pool_on_the_card(dev):
    """A second (T, S) bucket captures a second graph into the same pool
    and views the same static input buffers; a return to the first
    replays it; the larger bucket captured first, the pool grows to about
    its need, not the sum."""
    from chinese_asr_tpu_torch.train import optim, step

    cfg, params, b1 = _golden_train_setup(dev, T=40, S=5)
    _, _, b2 = _golden_train_setup(dev, T=64, S=8, seed=1)
    tx = optim.make_optimizer(cfg.train)
    state = tx.init(params)
    compiled = step.CompiledStep(cfg, tx)
    compiled(params, state, b2)
    first = compiled.graphs.pool_bytes
    compiled(params, state, b1)
    compiled(params, state, b2)
    g = compiled.graphs
    assert g.captures == 2 and g.replays == 3
    progs = [p for _, p in g.programs()]
    assert len(progs) == 2 and [p.replays for p in progs] == [1, 2]
    assert first > 0 and g.pool_bytes == sum(p.reserved_bytes for p in progs)
    # the smaller bucket, captured second, fits in what the first left
    assert g.pool_bytes < 2 * first
    for a, b in zip(progs[0].inputs, progs[1].inputs):
        assert a.data_ptr() == b.data_ptr()
    assert g.input_bytes() == sum(t.numel() * t.element_size()
                                  for t in progs[1].inputs)


def test_graph_train_step_resets_its_pool_past_the_budget_on_the_card(dev):
    """Past its byte budget (here any pool), a new key first drops every
    graph and the pool: one graph is left, a key met again is captured
    anew, and every step still equals the eager one bit for bit."""
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step

    cfg, params, b1 = _golden_train_setup(dev, T=40, S=5)
    _, _, b2 = _golden_train_setup(dev, T=64, S=8, seed=1)
    tx = optim.make_optimizer(cfg.train)
    p_g = las.tree_map(torch.clone, params)
    o_g = tx.init(p_g)
    p_e, o_e = params, tx.init(params)
    compiled = step.CompiledStep(cfg, tx)
    g = compiled.graphs
    g.budget_fraction = 1e-12
    for b in (b1, b2, b2, b1):
        _, _, m_g = compiled(p_g, o_g, b)
        p_e, o_e, m_e = step.train_step(p_e, o_e, cfg, tx, b)
        assert torch.equal(m_g["loss"], m_e["loss"])
        for x, y in zip(_state_leaves(p_g, o_g), _state_leaves(p_e, o_e)):
            assert torch.equal(x, y)
    assert (g.captures, g.resets, g.replays) == (3, 2, 4)
    assert len(g.programs()) == 1 and g.pool_bytes > 0


def test_graph_train_step_counts_replays_on_the_card(dev):
    """K2 and K2-bwd counters under the step graph: the first call counts
    its eager warm-up and its replay, a later call one launch a layer
    each; the bf16 kernels likewise in bf16."""
    from chinese_asr_tpu_torch.train import optim, step

    layers = golden_cfg(tcfg).encoder.num_layers
    for dtype, (fwd, bwd) in (("float32", ("launches", "bwd_launches")),
                              ("bfloat16", ("bf16_launches",
                                            "bwd_bf16_launches"))):
        cfg, params, batch = _golden_train_setup(dev, dtype)
        tx = optim.make_optimizer(cfg.train)
        state = tx.init(params)
        compiled = step.CompiledStep(cfg, tx)
        counts = []
        for _ in range(3):
            before = (getattr(tlstm, fwd), getattr(tlstm, bwd))
            compiled(params, state, batch)
            counts.append((getattr(tlstm, fwd) - before[0],
                           getattr(tlstm, bwd) - before[1]))
        assert counts == [(2 * layers, 2 * layers), (layers, layers),
                          (layers, layers)], dtype


def test_trainer_evaluate_replays_one_greedy_program_on_the_card(dev,
                                                                 tmp_path):
    """``Trainer.evaluate`` on the card decodes through
    ``greedy_decode_jit``: one capture at the first eval, none after a
    training step and a second eval (the params keep their tensors), and
    the CER equals the eager greedy's on the same params."""
    from chinese_asr_tpu_torch.data import dataset
    from chinese_asr_tpu_torch.decode import greedy
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.ops.metrics import cer
    from chinese_asr_tpu_torch.train.trainer import Trainer
    from chinese_asr_tpu_torch.utils import graphs
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    graphs.clear()
    cfg = golden_cfg(tcfg).with_("train", eval_batch_size=6,
                                 save_dir=str(tmp_path))
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    refs = [CHARS[i:i + 3] for i in range(6)]
    mpath = str(tmp_path / "m.tsv")
    dataset.write_manifest(mpath, [dataset.Utterance(p, r) for p, r in
                                   zip(golden_wav_paths(), refs)])
    pn = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    tr = Trainer(cfg, las.params_from_numpy(pn), vocab, device=dev)

    def loader():
        return dataset.batches_to_device(
            dataset.make_eval_loader(mpath, cfg, vocab), cfg, dev)

    def eager_cer():
        b = next(iter(loader()))
        out = greedy.finalize_greedy(
            greedy.greedy_decode(tr.params, cfg, b.feats, b.feat_lens),
            vocab)
        return float(np.mean([cer(p, r) for p, r in zip(out.pred_text,
                                                        refs)]))

    first = tr.evaluate(loader())
    assert graphs.captures >= 1
    captured = graphs.captures
    assert first == pytest.approx(eager_cer(), abs=1e-12)
    _, _, b = _golden_train_setup(dev)
    tr._step_fn(tr.params, tr.opt_state, b, None)
    second = tr.evaluate(loader())
    assert graphs.captures == captured
    assert second == pytest.approx(eager_cer(), abs=1e-12)


@pytest.mark.parametrize("over,rows", [
    (dict(encoder=dict(encoder_type="CNN1D_RNN")), 5),
    (dict(decoder=dict(num_layers=2)), 5),
    (dict(decoder=dict(init_cell_state_as_param=True, num_layers=2)), 5),
    (dict(decoder=dict(init_cell_state_as_param=True, num_layers=2)), 1)],
    ids=["zero_state", "enc_state_2_layers", "learned_init",
         "learned_init_1_row"])
def test_jit_graph_equals_eager_when_the_init_state_aliases(dev, over, rows):
    """Decoders whose initial state aliases (the zero state's one tensor
    in every slot, the encoder's state shared by two layers, a learned
    init state's expanded row, at one row a plain view of its parameter):
    ``greedy_decode_jit`` and ``beam_decode_jit`` equal their eager
    functions field by field on the card, twice, and leave the params as
    they were: the graphs' state owns its memory (``own_tree``)."""
    from chinese_asr_tpu_torch.decode import beam, greedy
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.utils import graphs
    from torch_port_util import small_cfg

    graphs.clear()
    cfg = small_cfg(tcfg)
    for sec, kw in over.items():
        cfg = cfg.with_(sec, **kw)
    params = las.tree_map(lambda t: t.to(dev), las.init_params(cfg, 0))
    before = [t.clone() for t in las.tree_leaves(params)]
    rng = np.random.RandomState(0)
    feats = torch.tensor(rng.randn(rows, 48, cfg.audio.feat_dim),
                         dtype=torch.float32, device=dev)
    lens = torch.tensor([48, 40, 33, 21, 12][:rows], device=dev)
    for jit, eager in ((greedy.greedy_decode_jit, greedy.greedy_decode),
                       (lambda *a: beam.beam_decode_jit(a[0], a[1], 3,
                                                        *a[2:]),
                        lambda *a: beam.beam_decode(a[0], a[1], 3,
                                                    *a[2:]))):
        want = eager(params, cfg, feats, lens)
        for _ in range(2):
            got = jit(params, cfg, feats, lens)
            for name, w in want._asdict().items():
                assert torch.equal(getattr(got, name), w), name
            for x, y in zip(las.tree_leaves(params), before):
                assert torch.equal(x, y)


def _attn_inputs(dev, B, k, L, a, dtype, seed):
    """K6's operands: rows of unequal length, the first full and, from
    B = 3 on, the last masked everywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randn(B, L, a, device=dev, generator=g)
    q = torch.randn(B, k, a, device=dev, generator=g)
    v = 0.1 * torch.randn(a, device=dev, generator=g)
    lens = torch.randint(1, L + 1, (B,), device=dev, generator=g)
    lens[0] = L
    if B >= 3:
        lens[-1] = 0
    mask = torch.where(torch.arange(L, device=dev)[None] < lens[:, None],
                       0.0, float("-inf"))
    return [t.to(dtype).contiguous() for t in (mask, q, keys, v)]


def _attn_against_twins(got, ops):
    """K6's align against the twin in float32 on the same operands (NaN
    rows alike; f32 1e-5 absolute, bf16 one bf16 rounding) and, in bf16,
    against the bf16 twin within TOL_ATTN_BF16_TWIN."""
    ref = tattn.beam_scores_softmax_plain(*[t.float() for t in ops])
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    err = (got.float() - ref)[~nan].abs()
    if got.dtype == torch.float32:
        assert err.numel() == 0 or float(err.max()) <= 1e-5
        return
    assert bool((err <= 2 ** -8 * ref[~nan].abs() + 1e-6).all())
    ref16 = tattn.beam_scores_softmax_plain(*ops).float()
    err16 = (got.float() - ref16)[~nan].abs()
    assert err16.numel() == 0 or float(err16.max()) <= TOL_ATTN_BF16_TWIN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("a", [8, 128])
@pytest.mark.parametrize("L", [1, 7, 100, 433, 3100])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_beam_attention_kernel_matches_twin(dev, k, L, a, B, dtype,
                                            monkeypatch):
    """K6 at each shape against its twin; at L = 3100 under the split plan
    (scores in a device scratch), which these B take only when forced."""
    ops = _attn_inputs(dev, B, k, L, a, dtype, seed=B * 7919 + k * 31 + L)
    if L == 3100:
        plan = tattn.plan
        monkeypatch.setattr(tattn, "plan",
                            lambda *x: {**plan(*x), "split": True})
    before = tattn.launches
    with torch.no_grad():
        got = tattn.beam_scores_softmax(*ops)
    assert tattn.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, k, L)
    _attn_against_twins(got, ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_beam_attention_kernel_split_plan_where_plan_takes_it(dev, dtype):
    """A block a sample (B past twice the SMs) with more scores than
    shared memory holds: plan itself picks the split."""
    B, k, L, a = 280, 16, 3600, 8
    assert tattn.plan(B, k, L, a, dtype)["split"]
    assert not tattn.plan(B, k, 3000, a, dtype)["split"]
    ops = _attn_inputs(dev, B, k, L, a, dtype, seed=5)
    with torch.no_grad():
        _attn_against_twins(tattn.beam_scores_softmax(*ops), ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_beam_attention_kernel_in_a_cuda_graph(dev, dtype):
    """Captured and replayed as the decode graph holds it: the replay on
    new operands equals an eager launch bit for bit, and counts one
    launch at capture."""
    B, k, L, a = 128, 16, 166, 128
    ops = _attn_inputs(dev, B, k, L, a, dtype, seed=9)
    static = [t.clone() for t in ops]
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tattn.beam_scores_softmax(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = tattn.launches
        with torch.cuda.graph(graph):
            out = tattn.beam_scores_softmax(*static)
        assert tattn.launches == before + 1
        new = _attn_inputs(dev, B, k, L, a, dtype, seed=10)
        for s_, n_ in zip(static, new):
            s_.copy_(n_)
        graph.replay()
        torch.cuda.synchronize()
        want = tattn.beam_scores_softmax(*new)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(want))


def test_beam_attention_kernel_rejects_bad_operands(dev):
    """Malformed operands raise, and so does a width whose key tiles
    overflow shared memory; a key row off the 16-byte grain (7 f32 words)
    launches K6 at ``grain(a)`` on zero-padded operands, and keys off a
    16-byte boundary launch it on an aligned copy, each matching the
    twin."""
    mask, q, keys, v = _attn_inputs(dev, 2, 4, 10, 8, torch.float32, seed=1)
    with torch.no_grad():
        with pytest.raises(ValueError):                  # mixed dtypes
            tattn.beam_scores_softmax(mask.bfloat16(), q, keys, v)
        with pytest.raises(ValueError):                  # not contiguous
            tattn.beam_scores_softmax(
                mask, q, keys.transpose(0, 1).contiguous().transpose(0, 1),
                v)
        odd = torch.empty(keys.numel() + 1, device=dev)[1:].view(
            keys.shape).copy_(keys)                      # 4 bytes off
        for ops in ((mask, q[..., :7].contiguous(),      # 7 * 4 bytes a row
                     keys[..., :7].contiguous(), v[:7].contiguous()),
                    (mask, q, odd, v)):
            before = tattn.launches
            got = tattn.beam_scores_softmax(*ops)
            assert tattn.launches == before + 1
            _attn_against_twins(got, ops)
        with pytest.raises(ValueError):                  # float64
            tattn.beam_scores_softmax(mask.double(), q.double(),
                                      keys.double(), v.double())
        wide = _attn_inputs(dev, 2, 4, 10, 4096, torch.float32, seed=2)
        with pytest.raises(ValueError):                  # tiles overflow
            tattn.beam_scores_softmax(*wide)
    with pytest.raises(ValueError):                      # needs a gradient
        tattn.beam_scores_softmax(mask, q.requires_grad_(), keys, v)
    before = tattn.launches
    cpu = [t.detach().cpu() for t in (mask, q, keys, v)]
    tattn.beam_scores_softmax(*cpu)                      # the twin
    assert tattn.launches == before


@pytest.mark.parametrize("attn_size,dtype", [(100, "bfloat16"),
                                             (6, "float32")],
                         ids=["a100_bf16", "a6_f32"])
def test_beam_decode_at_widths_off_k6s_grain(dev, attn_size, dtype,
                                             monkeypatch):
    """``ASR(bw=4)`` at an attention width whose key row is off K6's
    16-byte grain (200 and 24 bytes): the one-head beam decode launches
    K6 at ``grain(a)``, each eager call within the twin's tolerance on
    its own operands; the compiled decode gives the eager loop's tokens,
    and ``transcribe_wavs`` transcribes."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    from torch_port_util import random_wavs
    graphs.clear()
    cfg = tcfg.Config().with_("attention", attn_size=attn_size)
    asr = ASR(bw=4, cfg=cfg, device=dev, compute_dtype=dtype, seed=0)
    wavs = random_wavs(np.random.default_rng(3), [16000, 24000, 9000])
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    kernel, checked = tattn.beam_scores_softmax, []

    def against_twin(*ops):
        got = kernel(*ops)
        _attn_against_twins(got, ops)
        checked.append(ops[2].shape[-1])
        return got

    before = tattn.launches
    with torch.no_grad():
        got = beam.beam_decode_best_jit(asr.params, asr.cfg, 4, feats, lens)
        graphs.settle(wait=True)
        assert tattn.launches > before
        monkeypatch.setattr(tattn, "beam_scores_softmax", against_twin)
        before = tattn.launches
        want = beam.beam_decode_best(asr.params, asr.cfg, 4, feats, lens)
        monkeypatch.undo()
    assert checked and set(checked) == {attn_size}
    assert tattn.launches - before == len(checked)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.lens, want.lens)
    before = tattn.launches
    texts = asr.transcribe_wavs(wavs)
    assert len(texts) == 3 and tattn.launches > before
    graphs.clear()


# ---- K7: the 3xTF32 GEMM (csrc/gemm.cu) ------------------------------------
def _gemm_err(y, x, w, b):
    """max |y - x @ w - b| over |x| @ |w| + |b|, in float64."""
    x64, w64 = x.double(), w.double()
    ref = x64 @ w64
    scale = x64.abs() @ w64.abs()
    if b is not None:
        ref, scale = ref + b.double(), scale + b.double().abs()
    return float(((y.double() - ref).abs() / scale).max())


def _gemm_inputs(dev, M, K, N, bias=True, seed=0, transposed=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if transposed:          # the pointwise-2 input: [B, L, D] of [B, D, L]
        x = torch.randn(M // 317, K, 317, device=dev,
                        generator=g).transpose(1, 2)
    else:
        x = torch.randn(M, K, device=dev, generator=g)
    w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
    b = torch.randn(N, device=dev, generator=g) if bias else None
    return x, w, b


# (M, K, N, bias, transposed): the Conformer's products at ragged M (8
# sorted chunks of 128 rows, the longest 317 frames): the FFN's two, QKV,
# the output map, the pointwise convolutions (the second on its
# transposed input), the subsampling's map of 512 x 19 features; then the
# E-Branchformer's four that the Conformer lacks: the cgMLP's two, the
# merge's (its FFN's second) and its FFN's first
GEMM_SHAPES = [(128 * 317, 512, 2048, True, False),
               (1000, 2048, 512, True, False),
               (1000, 512, 1536, True, False),
               (1000, 512, 512, False, False),
               (1000, 512, 1024, True, False),
               (4 * 317, 512, 512, True, True),
               (2000, 9728, 512, True, False),
               (1000, 512, 3072, True, False),
               (1000, 1536, 512, True, False),
               (1000, 1024, 512, True, False)]


@pytest.mark.parametrize("M,K,N,bias,transposed", GEMM_SHAPES)
def test_gemm_kernel_within_cublas_error(dev, M, K, N, bias, transposed):
    """K7 against the float64 product at each Conformer and E-Branchformer
    shape: one launch a call, and no farther from it than 4x cuBLAS's
    float32 product (TF32 off), both measured against |x| @ |w| + |b|."""
    x, w, b = _gemm_inputs(dev, M, K, N, bias, seed=K + N, transposed=transposed)
    with torch.no_grad():
        before, fell = tgemm.launches, tgemm.fallbacks
        y = tgemm.linear(x, w, b)
        torch.cuda.synchronize()
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (1, 0)
        lib = torch.nn.functional.linear(x, w.t(), b)
    assert y.shape == (*x.shape[:-1], N)
    err, lib_err = _gemm_err(y, x, w, b), _gemm_err(lib, x, w, b)
    assert err <= 4 * lib_err, (err, lib_err)


@pytest.mark.parametrize("M,K,N", [(7, 8, 3), (130, 40, 200), (129, 8, 129),
                                   (1, 512, 2048), (300, 16, 1)])
def test_gemm_kernel_edge_shapes(dev, M, K, N):
    """Ragged M and N, K under a stage, an odd N (scalar stores): within
    2^-20 of |x| @ |w| + |b| (a few float32 roundings)."""
    x, w, b = _gemm_inputs(dev, M, K, N, seed=M)
    with torch.no_grad():
        y = tgemm.linear(x, w, b)
        assert _gemm_err(y, x, w, b) <= 2 ** -20
        y0 = tgemm.linear(x, w, None)
        assert _gemm_err(y0, x, w, None) <= 2 ** -20
        assert tgemm.linear(x[:0], w, b).shape == (0, N)


def test_gemm_dispatch_falls_back_where_the_kernel_does_not_run(dev):
    """``gemm.linear`` takes K7 for float32 without a graph to record, K
    off a multiple of 8 on zero-padded operands and x off a 16-byte
    boundary on an aligned copy, within 2^-20 of |x| @ |w| + |b|; under
    autograd, in bf16 and in float64 it takes ``x @ w + b``, bit for bit,
    counted."""
    x, w, b = _gemm_inputs(dev, 64, 32, 48, seed=3)
    odd = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    with torch.no_grad():
        for xx, ww in ((x[:, :30], w[:30]),              # K % 8 != 0
                       (x[:, :5].contiguous(), w[:5]),   # K under 8
                       (odd, w)):                        # 4 bytes off
            before, fell = tgemm.launches, tgemm.fallbacks
            got = tgemm.linear(xx, ww, b)
            assert (tgemm.launches - before, tgemm.fallbacks - fell) == (1, 0)
            assert _gemm_err(got, xx, ww, b) <= 2 ** -20
    cases = [(x.requires_grad_(), w, b),                   # autograd
             (x.detach().bfloat16(), w.bfloat16(), b.bfloat16()),
             (x.detach().double(), w.double(), b.double())]
    for xx, ww, bb in cases:
        before, fell = tgemm.launches, tgemm.fallbacks
        got = tgemm.linear(xx, ww, bb)
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (0, 1)
        assert torch.equal(got, xx @ ww + bb)
        assert got.requires_grad == xx.requires_grad


def test_gemm_weight_split_follows_updates_in_place(dev):
    """The cached hi / lo split of a weight is made again after an update
    in place (its version counter), and goes with the weight."""
    x, w, b = _gemm_inputs(dev, 256, 64, 128, seed=4)
    with torch.no_grad():
        y1 = tgemm.linear(x, w, b)
        assert id(w) in tgemm._splits
        w.mul_(-2.0)
        y2 = tgemm.linear(x, w, b)
    assert _gemm_err(y2, x, w, b) <= 2 ** -20
    assert not torch.allclose(y1, y2)
    key = id(w)
    del w
    assert key not in tgemm._splits


def test_gemm_kernel_in_a_cuda_graph(dev):
    """Captured as the decode graph holds it (after a warm-up that fills the
    split cache): a replay on new inputs equals an eager launch bit for
    bit, and the capture counts one launch."""
    x, w, b = _gemm_inputs(dev, 2 * 317, 512, 1024, seed=5)
    static = x.clone()
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tgemm.linear(static, w, b)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = tgemm.launches
        with torch.cuda.graph(graph):
            out = tgemm.linear(static, w, b)
        assert tgemm.launches == before + 1
        new = torch.randn_like(x)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = tgemm.linear(new, w, b)
    assert torch.equal(out, want)


# (M, K, N): the beam decode step's f32 products at B = 128, k = 16: the
# output projection [h, context] -> 5004 logits, the LSTM cell's input
# (embedding and fed-back context) and recurrent gate products
GEMM_DECODE_SHAPES = [(2048, 1024, 5004), (2048, 768, 2048), (2048, 512, 2048)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N", GEMM_DECODE_SHAPES)
def test_gemm_kernel_at_the_decode_shapes(dev, M, K, N, bias):
    """K7 at the decode step's three shapes, with and without the bias in
    its epilogue: one launch, and no farther from the float64 product than
    cuBLAS's float32 product (TF32 off) on the same operands, both
    measured against |x| @ |w| + |b|."""
    x, w, b = _gemm_inputs(dev, M, K, N, bias, seed=K + N + bias)
    with torch.no_grad():
        before, fell = tgemm.launches, tgemm.fallbacks
        y = tgemm.linear(x, w, b)
        torch.cuda.synchronize()
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (1, 0)
        lib = x @ w if b is None else x @ w + b
    err, lib_err = _gemm_err(y, x, w, b), _gemm_err(lib, x, w, b)
    assert err <= lib_err, (err, lib_err)


def test_beam_decode_runs_its_step_products_on_k7(dev):
    """A captured f32 beam decode (``ASR(bw=16)`` at the flagship widths)
    launches K7 three times a step, as often as K6 (once a step) three
    times over, none falling back; its hypotheses and scores match the
    eager loop's, which launches K7 as often."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.decode import beam
    from chinese_asr_tpu_torch.utils import graphs
    from torch_port_util import random_wavs
    graphs.clear()
    asr = ASR(bw=16, device=dev, seed=0)
    wavs = random_wavs(np.random.default_rng(5), [16000, 24000, 9000])
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    counts = lambda: (tgemm.launches, tgemm.fallbacks, tattn.launches)
    ran = []
    with torch.no_grad():
        for fn in (beam.beam_decode_best_jit, beam.beam_decode_best_jit,
                   beam.beam_decode_best):
            before = counts()
            out = fn(asr.params, asr.cfg, 16, feats, lens)
            graphs.settle(wait=True)
            k7, fell, k6 = (a - b for a, b in zip(counts(), before))
            assert k6 > 0 and (k7, fell) == (3 * k6, 0), (k7, fell, k6)
            ran.append(out)
    for got in ran[:2]:
        assert torch.equal(got.tokens, ran[2].tokens)
        assert torch.equal(got.lens, ran[2].lens)
        torch.testing.assert_close(got.scores, ran[2].scores, atol=1e-5,
                                   rtol=0)
    graphs.clear()


def test_bf16_beam_step_launches_no_k7(dev):
    """A bf16 beam decode step at the flagship widths (B = 8, k = 16)
    leaves its three products to the parent's expressions: no K7 launch,
    three fallbacks, and logits and gates equal bit for bit to ``x @ w +
    b`` and ``x @ w_ih + h @ w_hh + b_ih + b_hh`` on the same operands."""
    from chinese_asr_tpu_torch.models import decoder as tdec
    from chinese_asr_tpu_torch.models import las as tlas
    from chinese_asr_tpu_torch.ops import rnn as trnn
    from chinese_asr_tpu_torch.ops.masks import softmax_mask
    cfg = tcfg.Config()
    p = tlas.tree_map(lambda t: t.to(dev, torch.bfloat16),
                      tlas.init_params(cfg, 1))
    dp, ap = p["decoder"], p["attention"]
    g = torch.Generator(device=dev).manual_seed(6)
    B, k, L, H = 8, 16, 50, cfg.decoder.hidden_size
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g).bfloat16()
    enc = rnd(B, L, dp["proj_w"].shape[0] - H)
    keys, values = tattn_ops.compute_key_value(ap, cfg.attention, enc)
    mask = softmax_mask(torch.randint(1, L + 1, (B,), device=dev,
                                      generator=g), L, torch.bfloat16)
    h0, c0, ahs = rnd(B * k, H), rnd(B * k, H), rnd(B * k, values.shape[-1])
    token = torch.randint(0, cfg.vocab.vocab_size, (B * k,), device=dev,
                          generator=g)
    with torch.no_grad():
        before, fell = tgemm.launches, tgemm.fallbacks
        out = tdec.decoder_step_beam(dp, ap, cfg.decoder, cfg.attention, mask,
                                     keys, values, token, [(h0, c0)], ahs)
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (0, 3)
        cell = dp["cells"][0]
        x = torch.cat([dp["embedding"][token], ahs], dim=1)
        gates = x @ cell["w_ih"] + h0 @ cell["w_hh"] + cell["b_ih"] \
            + cell["b_hh"]
        h, c = trnn.lstm_from_gates(gates, c0)
        assert torch.equal(out.cell_state[0][0], h)
        assert torch.equal(out.cell_state[0][1], c)
        want = (torch.cat([h, out.attn_hidden_state], dim=-1) @ dp["proj_w"]
                + dp["proj_b"])
    assert out.logit.dtype == torch.bfloat16
    assert torch.equal(out.logit, want)


def _small_conformer_cfg():
    return tcfg.Config(
        audio=tcfg.AudioConfig(delta_delta=False, downsample=False),
        encoder=tcfg.EncoderConfig(encoder_type="CONFORMER", hidden_size=64,
                                   num_layers=2, ffn_size=128,
                                   self_attn_heads=4, ks=8))


def _small_conformer_feats():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 90, 80, generator=g)
    lens = torch.tensor([90, 61, 17])
    x[torch.arange(90)[None] >= lens[:, None]] = 0.0
    return x, lens


def test_conformer_on_the_card_runs_its_products_on_k7(dev):
    """A small Conformer (d 64, 2 blocks) on the card: 8 K7 launches a block
    and one for the subsampling's map, none falling back, its output
    within 1e-4 of the CPU's (``x @ w + b`` there)."""
    cfg = _small_conformer_cfg()
    params = tconf.init_conformer(torch.Generator().manual_seed(0), cfg)
    x, lens = _small_conformer_feats()
    want, wl = tconf.apply_conformer(params, cfg, x, lens)
    on = lambda t: ({k: on(v) for k, v in t.items()} if isinstance(t, dict)
                    else [on(v) for v in t] if isinstance(t, list)
                    else t.to(dev))
    with torch.no_grad():
        before, fell = tgemm.launches, tgemm.fallbacks
        got, gl = tconf.apply_conformer(on(params), cfg, x.to(dev),
                                        lens.to(dev))
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (
            8 * 2 + 1, 0)
    assert torch.equal(gl.cpu(), wl)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


# (K, N): the E-Branchformer's products that the Conformer lacks: the
# cgMLP's two (d -> 3072, the gated half 1536 -> d), the merge's (2d -> d)
# and the macaron FFN's first (d -> 1024; its second is the merge's shape)
GEMM_EBRANCHFORMER_SHAPES = [(512, 3072), (1536, 512), (1024, 512),
                             (512, 1024)]


@pytest.mark.parametrize("M", [128 * 317, 128 * 73])
@pytest.mark.parametrize("K,N", GEMM_EBRANCHFORMER_SHAPES)
def test_gemm_kernel_at_the_ebranchformer_shapes(dev, K, N, M):
    """K7 at the E-Branchformer's four new shapes over the cell's longest
    and shortest chunks (128 rows of 317 and of 73 frames), with the bias
    in its epilogue: one launch, and no farther from the float64 product
    than cuBLAS's float32 product (TF32 off) on the same operands, both
    measured against |x| @ |w| + |b|.  At a ragged M of 1000, below any
    chunk of the cell, they are held to the Conformer shapes' 4x
    (``GEMM_SHAPES``): there cuBLAS takes a kernel that comes closer."""
    x, w, b = _gemm_inputs(dev, M, K, N, seed=K + N + 26)
    with torch.no_grad():
        before, fell = tgemm.launches, tgemm.fallbacks
        y = tgemm.linear(x, w, b)
        torch.cuda.synchronize()
        assert (tgemm.launches - before, tgemm.fallbacks - fell) == (1, 0)
        lib = x @ w + b
    err, lib_err = _gemm_err(y, x, w, b), _gemm_err(lib, x, w, b)
    assert err <= lib_err, (err, lib_err)


@pytest.mark.parametrize("C", [1536, 1024])
def test_depthwise_conv_at_31_taps_equals_the_cpu(dev, C):
    """``ops/conv.py`` ``depthwise_conv1d_same`` at the E-Branchformer's
    31 taps (15 frames each side) over the cgMLP's 1536 and the merge's
    1024 channels, ragged rows: the card's result within 1e-5 of the
    CPU's (sums of 31 products of unit normals, ~6 in magnitude, in
    another order), padding frames read as zero."""
    g = torch.Generator().manual_seed(C)
    x, w, b = (torch.randn(16, 200, C, generator=g),
               torch.randn(31, C, generator=g), torch.randn(C, generator=g))
    lens = torch.randint(1, 201, (16,), generator=g)
    lens[0] = 200
    want = tconv.depthwise_conv1d_same(x, w, b, lens)
    with torch.no_grad():
        got = tconv.depthwise_conv1d_same(x.to(dev), w.to(dev), b.to(dev),
                                          lens.to(dev))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def test_ebranchformer_on_the_card_matches_the_reference(dev):
    """The tiny E-Branchformer (d 32, 2 blocks, cgMLP 96, kernels 7 and
    5) on the card, on the benchmark's seeded weights: 9 K7 launches a
    block and one for the subsampling's map, none falling back, 2 blocks
    counted, its output within 1e-4 of the benchmark's plain reference on
    the CPU (K7's 3xTF32 against float32, over 2 blocks)."""
    from chinese_asr_tpu_torch.models import e_branchformer as teb
    from chinese_asr_tpu_torch.models import encoder as tenc
    from chinese_asr_tpu_torch.models import las
    from port_bench import encoders
    from port_bench.lib import common, offline, weights
    from port_bench.reference import las as ref
    from port_bench.tests.conftest import TINY_SEED, tiny_config
    cfg = tiny_config(common.load("configs", "las_ebranchformer_l_f32"))
    params = weights.make_params(cfg, TINY_SEED, "cpu")
    x, lens = _small_conformer_feats()
    want, wl, _ = encoders.of(cfg).encode(ref.Precision(), params, x, lens,
                                          cfg)
    on_card = las.tree_map(lambda t: t.to(dev), params)
    with torch.no_grad():
        before = tgemm.launches, tgemm.fallbacks, teb.blocks
        got = tenc.apply_encoder(on_card["encoder"], offline.port_config(cfg),
                                 x.to(dev), lens.to(dev))
        torch.cuda.synchronize()
        assert (tgemm.launches - before[0], tgemm.fallbacks - before[1],
                teb.blocks - before[2]) == (9 * 2 + 1, 0, 2)
    assert torch.equal(got.out_lens.cpu(), wl)
    torch.testing.assert_close(got.out.cpu(), want, atol=1e-4, rtol=0)


def test_gemm_split_follows_weights_updated_between_replays(dev):
    """A decode program captured with K7's weight splits, its weights then
    updated in place (as a trainer between evaluations): the next replay
    decodes as the eager loop does on the new weights, not on the splits
    cached at capture."""
    from chinese_asr_tpu_torch.decode import greedy
    from chinese_asr_tpu_torch.models import las
    cfg = _small_conformer_cfg()
    params = las.init_params(cfg, seed=2, device=dev)
    x, lens = _small_conformer_feats()
    x, lens = x.to(dev), lens.to(dev)
    with torch.no_grad():
        greedy.greedy_decode_jit(params, cfg, x, lens)
        for blk in params["encoder"]["blocks"]:
            blk["ffn1"]["w1"].mul_(-1.5)
            blk["mhsa"]["w_o"].add_(0.05)
        got = greedy.greedy_decode_jit(params, cfg, x, lens)
        want = greedy.greedy_decode(params, cfg, x, lens)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.scores, want.scores, atol=1e-4, rtol=0)


def test_step_graph_replays_count_in_the_states_versions(dev):
    """A step program's replay writes its state in place on the card: each
    replay counts one write in every state tensor's version counter, as
    the eager copy does (K7's weight splits key on it)."""
    from chinese_asr_tpu_torch.utils import graphs
    state = {"w": torch.zeros(8, device=dev), "m": [torch.ones(8, device=dev)]}
    fn = lambda x: ([(state, {"w": state["w"] + x,
                              "m": [state["m"][0] * 2]})], state["w"].sum())
    steps = graphs.StepGraphs()
    x = torch.ones(8, device=dev)
    steps(("toy",), fn, [x])                       # capture
    v = (state["w"]._version, state["m"][0]._version)
    for _ in range(3):
        steps(("toy",), fn, [x])
    assert (state["w"]._version - v[0], state["m"][0]._version - v[1]) == (
        3, 3)
    assert steps.captures == 1 and float(state["w"][0]) == 4.0
