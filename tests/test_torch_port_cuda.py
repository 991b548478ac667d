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
