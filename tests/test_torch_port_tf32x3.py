"""The 3xTF32 arithmetic of the tensor-core kernels K1 (log-mel), K2
(BiLSTM time loop), K2-bwd's cluster kernel (its backward) and K7 (the
Conformer's dense products), emulated in plain torch on the CPU at the
flagship widths.

Each operand of a tensor-core product is split into a TF32 hi word and a
TF32 lo word, and lo*hi + hi*lo + hi*hi is summed in f32 (the lo*lo term is
dropped).  K1 rounds its samples' hi word and its DFT table with
``cvt.rna`` (round to nearest, ties away) and truncates the samples' exact
rest to TF32; K2 rounds h with ``cvt.rna`` and truncates its W_hh slice.
The emulation takes the kernels' own split tables (``ops/cuda/logmel.py``
``_kernel_tables``) where they have them, so the fragment layout is
checked too.  K2-bwd splits both its products the way K2 does: the
rebuilt h (pass 1) and dxg_t (pass 2) with ``cvt.rna``, its W_hh slice by
truncation.  K7 rounds both operands with ``cvt.rna`` (its weight's
split made once on the host, ``ops/cuda/gemm.py`` ``weight_split``), sums
each 32-k stage's three products on the tensor cores and adds the
stages in float32.  Tolerances are chip_smoke.py's: log-mel 2e-3
absolute, BiLSTM 1e-4 absolute, K2-bwd 1e-4 of each output's scale; K7
within 4x of a float32 product's distance from the float64 one, measured
against |x| @ |w|.  Inputs are made with numpy from a seed.  The decode
step's output projection and LSTM gate products go through K7's
dispatch (``gemm.linear``, ``gemm.linear_pair``); off K7 they are the
decoder's expressions before K7, bit for bit.
"""

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.models import attention as tattn
from chinese_asr_tpu_torch.models import decoder as tdec
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops import masks as tmasks
from chinese_asr_tpu_torch.ops import rnn as trnn
from chinese_asr_tpu_torch.ops.cuda import build
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
from chinese_asr_tpu_torch.ops.cuda import logmel as tlogmel
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm

from torch_port_util import (golden_cfg, matmul_tf32x1, matmul_tf32x3,
                             round_tf32, small_cfg, speech_like_wavs,
                             split_tf32, trunc_tf32)

TOL_LOGMEL = 2e-3
TOL_LSTM = 1e-4
TOL_LSTM_BWD = 1e-4


def _fp32(bits):
    return np.array(bits, np.uint32).view(np.float32)


def test_round_tf32_is_rna():
    # 1 + half a TF32 ulp is a tie: away from zero, on both signs
    one, ulp_half = 0x3F800000, 0x1000
    x = _fp32([one + ulp_half, one + ulp_half - 1, one + 0x2000 + ulp_half,
               0x80000000 | (one + ulp_half), 0x7F7FDFFF, 0])
    want = _fp32([one + 0x2000, one, one + 0x4000,
                  0x80000000 | (one + 0x2000), 0x7F7FE000, 0])
    got = round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the kernels' host-side split uses the same rounding
    np.testing.assert_array_equal(tlogmel.round_tf32(x).view(np.uint32),
                                  want.view(np.uint32))
    assert (trunc_tf32(torch.from_numpy(x)).numpy().view(np.uint32)
            == (x.view(np.uint32) & 0xFFFFE000)).all()


def _kernel_dft_tables(cfg):
    """(B hi, B lo) [taps, 2 * (bins - 1)] rebuilt from the kernel's
    fragment-order table, and the dense filterbank rebuilt from the
    kernel's per-filter bin ranges."""
    bfrag, mel_w, mel_idx, _, ksteps, ngroups = tlogmel._kernel_tables(
        cfg, torch.device("cpu"))
    nt = ngroups * 4
    f = bfrag.numpy()[:ksteps]                        # [s, nt, 32, 4]
    # lane = 4 g + c holds (b0, b1) = B[8s + c, 8nt + g], B[8s + c + 4, .]
    f = f.reshape(ksteps, nt, 8, 4, 2, 2)             # [s, nt, g, c, hilo, h]
    mats = f.transpose(4, 0, 5, 3, 1, 2).reshape(2, ksteps * 8, nt * 8)
    _, _, fb, _ = tfeat._constants(cfg)
    nbins = fb.shape[0]
    dense = np.zeros_like(fb)
    lo, cnt, off = mel_idx.numpy()
    for m in range(fb.shape[1]):
        dense[lo[m]:lo[m] + cnt[m], m] = mel_w.numpy()[off[m]:off[m] + cnt[m]]
    return (torch.from_numpy(mats[0][:, :2 * (nbins - 1)].copy()),
            torch.from_numpy(mats[1][:, :2 * (nbins - 1)].copy()),
            dense)


@pytest.mark.parametrize("cfg", [tcfg.AudioConfig(), golden_cfg(tcfg).audio],
                         ids=["flagship", "golden"])
def test_kernel_tables_hold_the_twins_tables(cfg):
    bhi, blo, dense = _kernel_dft_tables(cfg)
    cos_m, sin_m, fb = (t.numpy() for t in tlogmel._tables(
        cfg, torch.device("cpu")))
    win, nbins = cos_m.shape
    inter = np.zeros((bhi.shape[0], 2 * (nbins - 1)), np.float32)
    inter[:win, 0::2] = cos_m[:, :-1]
    inter[:win, 1::2] = sin_m[:, :-1]
    np.testing.assert_array_equal(bhi.numpy(), tlogmel.round_tf32(inter))
    np.testing.assert_array_equal(
        blo.numpy(), tlogmel.round_tf32(inter - bhi.numpy()))
    np.testing.assert_array_equal(dense, fb)           # exact zeros elsewhere
    # the bins done in f32: those below 4 and the last that a filter uses
    exbins = tlogmel._kernel_tables(cfg, torch.device("cpu"))[3][:-1]
    used = fb.any(axis=1)
    assert exbins.tolist() == [b for b in (0, 1, 2, 3, nbins - 1) if used[b]]


def _log_mel_tf32x3(wav, n_frames, cfg):
    """K1's arithmetic: each sample split into an rna hi and the exact rest,
    the rest truncated to TF32 for the products; the kernel's split table;
    re/im as 3xTF32 products, except the lowest bins and the last one that
    the filterbank uses (f32 products of the exact samples); then power,
    mel, eps floor, log."""
    bhi, blo, fb = _kernel_dft_tables(cfg)
    win, hop = cfg.win_length, cfg.hop_length
    off = (cfg.n_fft - win) // 2
    idx = (torch.arange(n_frames)[:, None] * hop + off
           + torch.arange(bhi.shape[0])[None, :])
    pad = int(idx.max()) + 1 - wav.shape[-1]
    frames = torch.nn.functional.pad(wav, (0, max(pad, 0)))[..., idx]
    fh = round_tf32(frames)
    fl = trunc_tf32(frames - fh)
    spec = fl @ bhi + fh @ blo + fh @ bhi             # [B, T, 2 (bins - 1)]
    re, im = spec[..., 0::2], spec[..., 1::2]
    cos_m, sin_m, _ = tlogmel._tables(cfg, torch.device("cpu"))
    x = frames[..., :win]
    exact = tlogmel._kernel_tables(cfg, torch.device("cpu"))[3][:-1].tolist()
    re = torch.cat([re, torch.zeros_like(re[..., :1])], -1)
    im = torch.cat([im, torch.zeros_like(im[..., :1])], -1)
    re[..., exact] = x @ cos_m[:, exact]
    im[..., exact] = x @ sin_m[:, exact]
    mel = (re * re + im * im) @ torch.from_numpy(fb)
    return torch.log(torch.where(mel == 0, torch.full_like(mel, 1.1920929e-07),
                                 mel))


@pytest.mark.parametrize("cfg", [tcfg.AudioConfig(), golden_cfg(tcfg).audio],
                         ids=["flagship", "golden"])
def test_logmel_3xtf32_within_tolerance(cfg):
    rng = np.random.default_rng(3)
    wav = torch.from_numpy(speech_like_wavs(rng, 2, 1.0))      # [2, 16000]
    pre = wav[:, 1:] - cfg.preemphasis * wav[:, :-1]
    T = int(tfeat.num_frames(wav.shape[1], cfg)) + 2            # past the end
    got = _log_mel_tf32x3(pre, T, cfg)
    want = tlogmel.log_mel_plain(pre, T, cfg)
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all()
    assert err <= TOL_LOGMEL, err


def _lstm_emulated(xg_f, xg_b, m_f, m_b, w_hh, product):
    """The twin's recurrence with h @ W_hh computed by ``product``."""
    T, B, H4 = xg_f.shape
    H = H4 // 4
    z = xg_f.new_zeros((B, H))
    h, c = [z, z], [z, z]
    ys = [xg_f.new_empty((T, B, H)), xg_f.new_empty((T, B, H))]
    for t in range(T):
        for d, (xg, mk) in enumerate(((xg_f, m_f), (xg_b, m_b))):
            gates = xg[t] + product(h[d], w_hh[d])
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c2 = torch.sigmoid(f) * c[d] + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            m = mk[t][:, None]
            y = h2 * m
            ys[d][t] = y
            h[d] = y + (1.0 - m) * h[d]
            c[d] = m * c2 + (1.0 - m) * c[d]
    return ys[0], ys[1], torch.stack(h), torch.stack(c)


def _lstm_case(T=332, B=4, H=256, seed=5):
    rng = np.random.default_rng(seed)
    xg_f = torch.from_numpy(rng.standard_normal((T, B, 4 * H), np.float32))
    xg_b = torch.from_numpy(rng.standard_normal((T, B, 4 * H), np.float32))
    w = torch.from_numpy((rng.standard_normal((2, H, 4 * H)) / H ** 0.5)
                         .astype(np.float32))
    lens = np.array([T, T - 1, T // 2, 1])[:B]
    m_f = torch.from_numpy((np.arange(T)[:, None] < lens[None]).astype(
        np.float32))
    m_b = torch.flip(m_f, dims=(0,)).contiguous()
    return xg_f, xg_b, m_f, m_b, w


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def test_lstm_3xtf32_within_tolerance():
    args = _lstm_case()
    want = tlstm.bidir_lstm_time_loop_plain(*args)
    got = _lstm_emulated(*args, lambda h, w: matmul_tf32x3(h, w, "rna",
                                                           "trunc"))
    assert _max_err(got, want) <= TOL_LSTM
    assert float(got[0][args[2] == 0].abs().max()) == 0.0   # masked steps


def test_lstm_one_tf32_product_is_not_enough():
    """Why three: hi*hi alone (h and W_hh each rounded once to TF32) drifts
    past the tolerance over the 332 steps."""
    args = _lstm_case()
    want = tlstm.bidir_lstm_time_loop_plain(*args)
    got = _lstm_emulated(*args, lambda h, w: matmul_tf32x1(h, w, "rna",
                                                           "rna"))
    assert _max_err(got, want) > TOL_LSTM


def _lstm_bwd_emulated(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, gy_f, gy_b,
                       ghT, gcT, product):
    """K2-bwd's twin with both serial products, the gates' recompute
    h_{t-1} @ W_hh and dh's dxg_t @ W_hh^T, computed by ``product``; dW_hh
    is the wrapper's f32 batched product."""
    T, B, H4 = xg_f.shape
    dxgs, dws = [], []
    for d, (xg, m, ys, gy) in enumerate(((xg_f, m_f, ys_f, gy_f),
                                         (xg_b, m_b, ys_b, gy_b))):
        w = w_hh[d]
        h = xg.new_zeros((B, H4 // 4))
        c = xg.new_zeros((B, H4 // 4))
        hs, cs, acts = [], [], []
        for t in range(T):
            mt = m[t][:, None]
            i, f, g, o = torch.chunk(xg[t] + product(h, w), 4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            hs.append(h)
            cs.append(c)
            acts.append((i, f, g, o))
            c = mt * (f * c + i * g) + (1.0 - mt) * c
            h = ys[t] + (1.0 - mt) * h
        dh, dc = ghT[d], gcT[d]
        dxg = xg.new_empty((T, B, H4))
        for t in range(T - 1, -1, -1):
            mt = m[t][:, None]
            i, f, g, o = acts[t]
            cp = cs[t]
            tc = torch.tanh(f * cp + i * g)
            dh2 = (gy[t] + dh) * mt
            dc2 = mt * dc + dh2 * o * (1.0 - tc * tc)
            da = torch.cat([dc2 * g * i * (1.0 - i), dc2 * cp * f * (1.0 - f),
                            dc2 * i * (1.0 - g * g), dh2 * tc * o * (1.0 - o)],
                           dim=-1)
            dxg[t] = da
            dc = (1.0 - mt) * dc + dc2 * f
            dh = (1.0 - mt) * dh + product(da, w.T)
        dxgs.append(dxg)
        dws.append(torch.stack(hs).reshape(T * B, -1).T
                   @ dxg.reshape(T * B, H4))
    return dxgs[0], dxgs[1], torch.stack(dws)


def _lstm_bwd_case(T=332, B=4, H=256, seed=6):
    """Random non-prefix masks (the backward direction's too), ys from the
    forward twin, random cotangents of ys and of the final state."""
    rng = np.random.default_rng(seed)
    xg_f, xg_b = (torch.from_numpy(rng.standard_normal((T, B, 4 * H),
                                                       np.float32))
                  for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((2, H, 4 * H)) / H ** 0.5)
                         .astype(np.float32))
    m_f, m_b = (torch.from_numpy((rng.random((T, B)) > 0.3)
                                 .astype(np.float32)) for _ in range(2))
    ys_f, ys_b, _, _ = tlstm.bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b,
                                                        w)
    cot = [torch.from_numpy(rng.standard_normal(s, np.float32))
           for s in ((T, B, H), (T, B, H), (2, B, H), (2, B, H))]
    return (xg_f, xg_b, m_f, m_b, w, ys_f, ys_b, *cot)


def _rel_err(got, want):
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(got, want))


@pytest.fixture(scope="module")
def lstm_bwd_case():
    args = _lstm_bwd_case()
    return args, tlstm.bidir_lstm_time_loop_bwd_plain(*args)


def test_lstm_bwd_3xtf32_within_tolerance(lstm_bwd_case):
    args, want = lstm_bwd_case
    got = _lstm_bwd_emulated(*args, lambda a, b: matmul_tf32x3(a, b, "rna",
                                                               "trunc"))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _rel_err(got, want) <= TOL_LSTM_BWD


def test_lstm_bwd_one_tf32_product_is_not_enough(lstm_bwd_case):
    """Why three, in the backward too: hi*hi alone drifts past the
    tolerance through the reverse recurrence and the gates' recompute."""
    args, want = lstm_bwd_case
    got = _lstm_bwd_emulated(*args, lambda a, b: matmul_tf32x1(a, b, "rna",
                                                               "rna"))
    assert _rel_err(got, want) > TOL_LSTM_BWD


# ---- K7: the Conformer's dense products (csrc/gemm.cu) ---------------------
K7_STAGE = 32          # k a stage: the tensor cores' partial sums


def _gemm_case(K, M=64, N=96, seed=7):
    rng = np.random.default_rng(seed + K)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32) / np.sqrt(K))
    return x, w.float()


def _gemm_err(y, x, w):
    x64, w64 = x.double(), w.double()
    return float(((y.double() - x64 @ w64).abs() / (x64.abs() @ w64.abs()))
                 .max())


def _gemm_staged(x, w, product):
    """K7's sum: ``product`` of each 32-k stage, the stages added in f32."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], K7_STAGE):
        acc = acc + product(x[:, k0:k0 + K7_STAGE], w[k0:k0 + K7_STAGE])
    return acc


def test_gemm_split_is_the_kernels_rounding():
    """K7's split, host side (the weight's, cached K-major) and the twin's,
    is cvt.rna's: the one ``matmul_tf32x3`` emulates."""
    x, w = _gemm_case(512)
    for got, want in zip(tgemm.split_tf32(x), split_tf32(x, "rna")):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hl = tgemm.weight_split(w)
    assert hl.shape == (2, w.shape[1], w.shape[0]) and hl.is_contiguous()
    for got, want in zip(hl, split_tf32(w, "rna")):
        assert torch.equal(got.t(), want)
    assert tgemm.weight_split(w) is hl                  # cached


def test_gemm_weight_split_is_made_again_in_place():
    """An update of the weight in place (its version counter) makes the
    split again at the same address, which captured graphs hold: at the
    next call, or at ``refresh`` before a graph's replay (which the graph
    runner calls through ``build.refresh``)."""
    x, w = _gemm_case(64, N=24)
    hl = tgemm.weight_split(w)
    ptr = hl.data_ptr()
    for update in (lambda: tgemm.weight_split(w), tgemm.refresh,
                   build.refresh):
        w.mul_(-3.0).add_(0.25)
        update()
        assert hl.data_ptr() == ptr and tgemm.weight_split(w) is hl
        for got, want in zip(hl, split_tf32(w, "rna")):
            assert torch.equal(got.t(), want)


@pytest.mark.parametrize("K", [512, 2048, 9728])
def test_gemm_3xtf32_within_f32_error(K):
    """K7's arithmetic, staged as the kernel sums, no farther from the
    float64 product than 4x a float32 product (the bound the card's test
    holds the kernel to against cuBLAS), at the Conformer's K."""
    x, w = _gemm_case(K)
    f32 = _gemm_err(x @ w, x, w)
    got = _gemm_staged(x, w, lambda a, b: matmul_tf32x3(a, b, "rna", "rna"))
    assert _gemm_err(got, x, w) <= 4 * f32
    assert _gemm_err(tgemm.linear_plain(x, w), x, w) <= 4 * f32


@pytest.mark.parametrize("K", [512, 9728])
def test_gemm_one_tf32_product_is_not_enough(K):
    """Why three: hi*hi alone sits over 100x farther from float64."""
    x, w = _gemm_case(K)
    f32 = _gemm_err(x @ w, x, w)
    got = _gemm_staged(x, w, lambda a, b: matmul_tf32x1(a, b, "rna", "rna"))
    assert _gemm_err(got, x, w) > 100 * f32


@pytest.mark.parametrize("case", ["cpu", "autograd", "bf16", "no_bias"])
def test_linear_off_the_card_is_f_linear(case):
    """``ops/cuda/gemm.py`` ``linear`` off K7 is the plain ``x @ w + b``
    (``x @ w`` without a bias), bit for bit, forward and backward, on CPU
    tensors, under autograd and in bf16, and counts each call as a
    fallback; K7 never launches."""
    x, w = _gemm_case(64, M=12, N=40)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        40, np.float32))
    if case == "bf16":
        x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    if case == "no_bias":
        b = None
    if case == "autograd":
        x.requires_grad_()
    before, fell = tgemm.launches, tgemm.fallbacks
    got = tgemm.linear(x.view(3, 4, 64), w, b)
    assert (tgemm.launches - before, tgemm.fallbacks - fell) == (0, 1)
    xw = x.detach().requires_grad_() if case == "autograd" else x
    want = xw.view(3, 4, 64) @ w if b is None else xw.view(3, 4, 64) @ w + b
    assert got.dtype == want.dtype and torch.equal(got, want)
    if case == "autograd":
        dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
        (got * dy).sum().backward()
        (want * dy).sum().backward()
        assert torch.equal(x.grad, xw.grad)


# ---- the decoder's products through ``gemm.linear`` -----------------------
def _parent_cells(layers, x, state):
    """The LSTM cell stack as the decoder ran it before K7."""
    out = []
    for p, (h, c) in zip(layers, state):
        gates = x @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
        x, c = trnn.lstm_from_gates(gates, c)
        out.append((x, c))
    return out


def _parent_logit(p, h, ahs):
    return torch.cat([h, ahs], dim=-1) @ p["proj_w"] + p["proj_b"]


def _decoder_case(mode, dtype):
    """(cfg, params, step inputs): a small LAS decoder (one LSTM layer; two
    for the teacher-forced path, whose layer 0 takes ``gate_partial``) at
    B = 3 samples, k = 4 beams a sample for ``beam``."""
    layers = 2 if mode == "teacher" else 1
    cfg = small_cfg(tcfg).with_("decoder", num_layers=layers)
    params = tlas.tree_map(lambda t: t.to(dtype), tlas.init_params(cfg, 3))
    g = torch.Generator().manual_seed(4)
    B, L, rows = 3, 7, 3 * (4 if mode == "beam" else 1)
    H, V = cfg.decoder.hidden_size, cfg.vocab.vocab_size
    enc = torch.randn(B, L, params["decoder"]["proj_w"].shape[0] - H,
                      generator=g).to(dtype)
    keys, values = tattn.compute_key_value(params["attention"],
                                           cfg.attention, enc)
    mask = tmasks.softmax_mask(torch.tensor([7, 3, 1]), L, dtype)
    state = [(torch.randn(rows, H, generator=g).to(dtype),
              torch.randn(rows, H, generator=g).to(dtype))
             for _ in range(layers)]
    ahs = torch.randn(rows, values.shape[-1], generator=g).to(dtype)
    token = torch.randint(0, V, (rows,), generator=g)
    return cfg, params, (mask, keys, values, token, state, ahs)


@pytest.mark.parametrize("mode,dtype", [("beam", torch.float32),
                                        ("beam", torch.bfloat16),
                                        ("step", torch.float32),
                                        ("step", torch.bfloat16),
                                        ("teacher", torch.float32)])
def test_decoder_products_go_through_linear(mode, dtype):
    """The decode step's output projection and LSTM gate products go
    through ``gemm.linear`` (on the card in float32, K7): 3 a step, each
    counted as a fallback on the CPU, where the step is bit for bit the
    decoder's expressions before K7 (``x @ w + b``; ``x @ w_ih + h @
    w_hh + b_ih + b_hh``) in f32 and bf16.  The trainer's teacher-forced
    step (``gate_partial``, ``compute_logit=False``, then ``project``)
    under autograd too, with its gradients."""
    cfg, p, (mask, keys, values, token, state, ahs) = _decoder_case(mode,
                                                                    dtype)
    dcfg, acfg = cfg.decoder, cfg.attention
    dp, ap = p["decoder"], p["attention"]
    B = mask.shape[0]
    before = tgemm.launches, tgemm.fallbacks
    if mode == "teacher":
        leaves = [dp["proj_w"], dp["proj_b"], *dp["cells"][1].values(),
                  dp["cells"][0]["w_hh"], ap["w_hidden"]]
        for t in leaves:
            t.requires_grad_()
        E = dcfg.embed_dim
        p0 = dp["cells"][0]
        gp = dp["embedding"][token] @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]
        out = tdec.decoder_step(dp, ap, dcfg, acfg, mask, keys, values, None,
                                state, ahs, compute_logit=False,
                                gate_partial=gp)
        assert out.logit is None
        got = (tdec.project(dp, acfg, out.cell_state[-1][0],
                            out.attn_hidden_state), out.attn_hidden_state,
               out.cell_state)
    elif mode == "beam":
        got = tuple(tdec.decoder_step_beam(dp, ap, dcfg, acfg, mask, keys,
                                           values, token, state, ahs))
        got = got[0], got[1], got[3]
    else:
        got = tuple(tdec.decoder_step(dp, ap, dcfg, acfg, mask, keys, values,
                                      token, state, ahs))
        got = got[0], got[1], got[3]
    assert (tgemm.launches - before[0], tgemm.fallbacks - before[1]) == (0, 3)

    if mode == "teacher":
        h0, c0 = state[0]
        gates = gp + ahs @ p0["w_ih"][E:] + h0 @ p0["w_hh"]
        cells = [trnn.lstm_from_gates(gates, c0)]
        cells += _parent_cells(dp["cells"][1:], cells[0][0], state[1:])
    else:
        x = torch.cat([dp["embedding"][token], ahs], dim=1)
        cells = _parent_cells(dp["cells"], x, state)
    h = cells[-1][0]
    if mode == "beam":
        ctx, _ = tattn.attend_beam(ap, acfg, mask, h.reshape(B, 4, -1), keys,
                                   values)
        ctx = ctx.reshape(h.shape[0], -1)
    else:
        ctx, _ = tattn.attend(ap, acfg, mask, h, keys, values)
    want = _parent_logit(dp, h, ctx), ctx, cells
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for (gh, gc), (wh, wc) in zip(got[2], want[2]):
        assert torch.equal(gh, wh) and torch.equal(gc, wc)
    if mode == "teacher":
        dy = torch.randn(got[0].shape, generator=torch.Generator().manual_seed(5))
        grads = [torch.autograd.grad((y * dy).sum(), leaves)
                 for y in (got[0], want[0])]
        for a, b in zip(*grads):
            assert torch.equal(a, b)
