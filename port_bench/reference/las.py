"""The plain reference of the LAS configurations: the log-mel front end,
the Bahdanau attention decoder with input feeding, beam search and the
training loss, written from the published model (shawnthu/chinese-asr:
data.py's features, attention.py, decoder.py, model.py's beam search) in
plain PyTorch.  The encoder is the configuration's family's
(``port_bench/encoders/<encoder_type>.py``, from encoder.py).

It imports nothing of the program under test and takes nothing it made:
the weights are the benchmark's own tensors (``port_bench/lib/weights.py``)
and the audio the benchmark's own int16 arrays.  Every matrix product
goes through ``mm`` so that one switch, ``Precision``, computes the whole
model in float32 with TF32 off (the reference), TF32 (the control of a
float32 configuration) or with every product's operands rounded to fp8
e4m3 under a per-tensor scale (the control of a bfloat16 one).  Elementwise
math is float32 throughout; sums of scores are float64.

Departures from the published code, each the program's documented
semantics: the eps floor of the mel power applies to exact zeros only;
beam search keeps 2k candidates a step, harvests finished hypotheses
among the top k, and stops when every row's best candidate is eos
(model.py:875-909).  The families note their own.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench import encoders

F32_EPS = float(np.finfo(np.float32).eps)


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------
@dataclass
class Precision:
    """``mode``: "float32" (TF32 off), "tf32" or "fp8"."""
    mode: str = "float32"

    def mm(self, a, b):
        if self.mode == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self):
        """The backend's TF32 switches for the duration, restored after."""
        m = torch.backends.cuda.matmul
        c = torch.backends.cudnn
        old = (m.allow_tf32, c.allow_tf32, torch.get_float32_matmul_precision())
        tf32 = self.mode == "tf32"
        m.allow_tf32 = c.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            yield self
        finally:
            m.allow_tf32, c.allow_tf32 = old[0], old[1]
            torch.set_float32_matmul_precision(old[2])


def fp8_round(x):
    """``x`` rounded through float8 e4m3 under one scale for the tensor
    (its largest magnitude to 448), back in float32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


# --------------------------------------------------------------------------
# front end (reference data.py:21-57, 129-164, 196-249; main.py:37)
# --------------------------------------------------------------------------
def _mel_filterbank(n_bins: int, f_min: float, f_max: float, n_mels: int):
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(f_min, f_max, n_bins)        # the reference's quirk
    m = np.linspace(0.0 if f_min == 0 else hz_to_mel(f_min), hz_to_mel(f_max),
                    n_mels + 2)
    f = mel_to_hz(m)
    fb = np.zeros((n_bins, n_mels))
    for j in range(n_mels):
        lo, mid, hi = f[j], f[j + 1], f[j + 2]
        fb[:, j] = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo),
                                              (hi - freqs) / (hi - mid)))
    return fb


def _delta_taps():
    delta = np.array([2.0, 1.0, 0.0, -1.0, -2.0])
    taps = np.stack([np.pad([1.0], (4, 4)), np.pad(delta, (2, 2)),
                     np.convolve(delta, delta)], axis=1)          # [9, 3]
    return taps / np.sqrt((taps ** 2).sum(axis=0, keepdims=True))


@functools.lru_cache(maxsize=8)
def _tables(sr: int, n_fft: int, window_len: float, f_min: float,
            f_max: float, n_mels: int, device: str):
    """The windowed DFT's cos and sin tables [n_fft, bins] (the
    ``win``-tap periodic Hann window centred in the frame), the mel
    filterbank [bins, n_mels] and the delta taps [9, 3], on ``device``."""
    win = int(sr * window_len)
    n = np.arange(win)
    window = np.zeros(n_fft)
    off = (n_fft - win) // 2
    window[off:off + win] = 0.5 - 0.5 * np.cos(2 * np.pi * n / win)
    k = np.arange(n_fft // 2 + 1)
    ang = 2 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    return tuple(torch.from_numpy(a).float().to(device) for a in (
        window[:, None] * np.cos(ang), -window[:, None] * np.sin(ang),
        _mel_filterbank(n_fft // 2 + 1, f_min, f_max, n_mels),
        _delta_taps()))


def features(wav_i16: np.ndarray, audio: dict, prec: Precision, device):
    """One utterance of int16 PCM -> its features [T', D] float32: the
    reference's stft(n_fft, hop, win_length, hann, center=False) power,
    mel and log; with ``delta_delta`` identity / delta / delta-delta
    channels; with ``downsample`` x3 channel-major stacking of frames
    (T' = T // 3); with ``normalize`` the per-utterance normalisation
    (unbiased std, eps 1e-6).  D is n_mels, x3 with deltas, x3 stacked,
    channel-major as the program's ``audio/features.py`` lays it out."""
    sr, n_fft = audio["sample_rate"], audio["n_fft"]
    hop = int(sr * audio["window_step"])
    cos, sin, fb, taps = _tables(sr, n_fft, audio["window_len"],
                                 audio["f_min"], audio["f_max"],
                                 audio["n_mels"], str(device))
    x = torch.from_numpy(wav_i16.astype(np.float32) / 32768.0).to(device)
    x = x[1:] - audio["preemphasis"] * x[:-1]
    T = 1 + (x.shape[0] - n_fft) // hop
    n = T // 3 if audio["downsample"] else T
    if n < 1:
        raise ValueError("an utterance shorter than one encoder frame")
    frames = x.unfold(0, n_fft, hop)[:T]                          # [T, n_fft]
    power = prec.mm(frames, cos) ** 2 + prec.mm(frames, sin) ** 2
    mel = prec.mm(power, fb)
    mel = torch.where(mel == 0.0, torch.full_like(mel, F32_EPS), mel)
    lm = torch.log(mel)                                           # [T, M]
    if audio["delta_delta"]:
        pad = torch.nn.functional.pad(lm, (0, 0, 4, 4))
        shifts = torch.stack([pad[j:j + T] for j in range(9)])    # [9, T, M]
        chans = torch.einsum("jtm,jc->ctm", shifts, taps)         # [3, T, M]
    else:
        chans = lm[None]                                          # [1, T, M]
    C, M = chans.shape[0], lm.shape[1]
    if audio["downsample"]:
        f = chans[:, :n * 3].reshape(C, n, 3 * M).transpose(0, 1)
        f = f.reshape(n, 3 * C * M)
    else:
        f = chans.transpose(0, 1).reshape(n, C * M)
    if not audio["normalize"]:
        return f
    mean = f.mean(dim=0, keepdim=True)
    std = f.std(dim=0, unbiased=True, keepdim=True) if n > 1 else \
        torch.zeros_like(mean)
    return (f - mean) / (std + 1e-6)


def pad_batch(feats: Sequence[torch.Tensor]):
    """[B, T, D] zero-padded and the lengths [B]."""
    T = max(f.shape[0] for f in feats)
    out = feats[0].new_zeros((len(feats), T, feats[0].shape[1]))
    for i, f in enumerate(feats):
        out[i, :f.shape[0]] = f
    return out, torch.tensor([f.shape[0] for f in feats],
                             device=feats[0].device)


# --------------------------------------------------------------------------
# the LSTM cell (the decoder's and the LSTM family's), and the decoder's
# initial state from an encoder family's (``port_bench/encoders/``)
# --------------------------------------------------------------------------
def _lstm_cell(prec, p, x_gates, h, c):
    g = x_gates + prec.mm(h, p["w_hh"])
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def initial_state(params, enc, state=None):
    """The decoder's initial (h, c) for the encoded batch ``enc``: the
    encoder's final ``state`` where it has the decoder's width, else zeros
    (reference decoder.py:56-73, with no learned initial state)."""
    Hd = params["decoder"]["cells"][0]["w_hh"].shape[0]
    if state is not None and state[0].shape[-1] == Hd:
        return state
    z = enc.new_zeros((enc.shape[0], Hd))
    return z, z


# --------------------------------------------------------------------------
# decoder (reference decoder.py:94-137, attention.py:67-111)
# --------------------------------------------------------------------------
class Decoder:
    """The attention decoder over one encoded batch, ``rep`` hypotheses a
    row (rows of the state are row-major: utterance b, hypothesis j at
    b * rep + j)."""

    def __init__(self, prec, params, enc, lens, enc_state, rep: int):
        ap = params["attention"]
        self.prec, self.p, self.ap, self.rep = prec, params["decoder"], ap, rep
        B, L, _ = enc.shape
        self.keys = prec.mm(enc, ap["w_enc"]) + ap["b_attn"]       # [B, L, a]
        self.values = enc
        pos = torch.arange(L, device=enc.device)[None, :]
        self.mask = torch.where(pos < lens[:, None], 0.0, float("-inf"))
        h, c = (s.repeat_interleave(rep, dim=0) for s in enc_state)
        self.h, self.c = h, c
        self.ahs = enc.new_zeros((B * rep, enc.shape[2]))

    def step(self, tokens):
        """Feed ``tokens`` [B * rep] -> log-probabilities [B * rep, V]."""
        prec, p, ap, rep = self.prec, self.p, self.ap, self.rep
        cell = p["cells"][0]
        x = torch.cat([p["embedding"][tokens], self.ahs], dim=-1)
        g = prec.mm(x, cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]
        self.h, self.c = _lstm_cell(prec, cell, g, self.h, self.c)
        B = self.keys.shape[0]
        q = prec.mm(self.h, ap["w_hidden"]).reshape(B, rep, 1, -1)
        e = torch.tanh(self.keys[:, None] + q)                    # [B, r, L, a]
        scores = prec.mm(e, ap["v"][:, None])[..., 0]             # [B, r, L]
        align = torch.softmax(scores + self.mask[:, None], dim=-1)
        ctx = prec.mm(align, self.values)                         # [B, r, d]
        self.ahs = ctx.reshape(B * rep, -1)
        logit = prec.mm(torch.cat([self.h, self.ahs], -1), p["proj_w"]) \
            + p["proj_b"]
        return torch.log_softmax(logit, dim=-1)

    def reorder(self, rows):
        """Keep the state rows ``rows`` [B * rep] (beam survivors)."""
        self.h, self.c, self.ahs = self.h[rows], self.c[rows], self.ahs[rows]


def encode(prec, params, feats, cfg=None):
    """Padded features of a batch -> (enc, lens, the decoder's initial
    state), by the encoder family of the configuration ``cfg``
    (``port_bench/encoders``; the flagship's, LSTM, where None)."""
    x, lens = pad_batch(feats)
    family = encoders.of(cfg) if cfg else encoders.load("LSTM")
    return family.encode(prec, params, x, lens, cfg)


# --------------------------------------------------------------------------
# judging a served hypothesis, and beam search (the control)
# --------------------------------------------------------------------------
def teacher_forced(prec, params, enc, lens, state, hyps: List[List[int]],
                   finished: Sequence[bool], sos: int, eos: int):
    """For each hypothesis (its tokens, and whether it ended with eos):
    the float64 sum of its tokens' log-probabilities, with the eos term
    when finished, [B]."""
    B = len(hyps)
    dec = Decoder(prec, params, enc, lens, state, 1)
    S = max(len(h) + (1 if f else 0) for h, f in zip(hyps, finished))
    targets = torch.full((B, max(S, 1)), -1, dtype=torch.long,
                         device=enc.device)
    for b, (h, f) in enumerate(zip(hyps, finished)):
        seq = list(h) + ([eos] if f else [])
        if seq:
            targets[b, :len(seq)] = torch.tensor(seq, device=enc.device)
    scores = torch.zeros(B, dtype=torch.float64, device=enc.device)
    tok = torch.full((B,), sos, dtype=torch.long, device=enc.device)
    for t in range(S):
        logp = dec.step(tok)
        tgt = targets[:, t]
        live = tgt >= 0
        safe = tgt.clamp(min=0)
        chosen = logp.gather(1, safe[:, None])[:, 0]
        scores += torch.where(live, chosen.double(), 0.0)
        tok = safe
    return scores


def beam_search(prec, params, enc, lens, state, k: int, max_len: int,
                sos: int, eos: int, length_weight: float):
    """Beam search of width ``k`` -> per row (tokens, finished, score): the
    best finished hypothesis by its log-probability (first found on
    ties), else the best live beam by log-probability plus
    ``length_weight`` times its length (model.py:708-765, 961-972)."""
    B = enc.shape[0]
    dev = enc.device
    dec = Decoder(prec, params, enc, lens, state, k)
    hist = torch.full((B, k, max_len), 0, dtype=torch.long, device=dev)
    score = torch.zeros(B, k, dtype=torch.float32, device=dev)
    tok = torch.full((B * k,), sos, dtype=torch.long, device=dev)
    best: List[Optional[tuple]] = [None] * B
    top_eos = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = max_len
    for t in range(max_len):
        logp = dec.step(tok).reshape(B, k, -1)
        tot = logp + score[..., None]
        if t == 0:
            tot[:, 1:] = float("-inf")
        v1, i1 = torch.topk(tot, k + 1, dim=-1)                   # [B, k, k+1]
        flat_v = v1.reshape(B, -1)
        order = torch.sort(flat_v, dim=1, descending=True, stable=True)[1]
        order = order[:, :2 * k]
        cand_v = flat_v.gather(1, order)
        cand_beam = order // (k + 1)
        cand_tok = i1.reshape(B, -1).gather(1, order)
        # finished among the top k, in rank order
        fin = (cand_tok[:, :k] == eos).cpu().numpy()
        for b, r in zip(*np.nonzero(fin)):
            sc = float(cand_v[b, r])
            if best[b] is None or (best[b][1] and sc > best[b][2]):
                toks = hist[b, int(cand_beam[b, r]), :t].tolist()
                best[b] = (toks, True, sc)
        top_eos |= cand_tok[:, 0] == eos
        if bool(top_eos.all()):
            steps = t
            break
        rank = torch.arange(2 * k, device=dev)[None, :] \
            + (cand_tok == eos).long() * 2 * k
        keep = torch.argsort(rank, dim=1)[:, :k]
        beams = cand_beam.gather(1, keep)
        toks = cand_tok.gather(1, keep)
        hist = hist.gather(1, beams[..., None].expand(-1, -1, max_len)).clone()
        hist[:, :, t] = toks
        score = cand_v.gather(1, keep)
        rows = (torch.arange(B, device=dev)[:, None] * k + beams).reshape(-1)
        dec.reorder(rows)
        tok = toks.reshape(-1)
    out = []
    for b in range(B):
        if best[b] is not None:
            out.append(best[b])
            continue
        n = steps if steps < max_len else max_len
        j = int(torch.argmax(score[b]))
        out.append((hist[b, j, :n].tolist(), False,
                    float(score[b, j]) + length_weight * n))
    return out


def served_score(scores64, hyps, finished, length_weight: float):
    """The score the beam reports for a hypothesis: its log-probability
    when finished, plus ``length_weight`` times its length when live."""
    return [float(s) + (0.0 if f else length_weight * len(h))
            for s, h, f in zip(scores64.tolist(), hyps, finished)]


def detokenize(tokens: Sequence[int], specials: Sequence[str]) -> str:
    """Random weights have no vocabulary: ids past the specials render as
    ``<id>``."""
    return "".join(specials[t] if t < len(specials) else f"<{t}>"
                   for t in tokens)


# --------------------------------------------------------------------------
# training (reference model.py:414-469, util.py:265-295; optax adam)
# --------------------------------------------------------------------------
def train_loss(prec, params, feats, tokens_in, tokens_out, text_lens,
               cfg: dict):
    """Teacher-forced label-smoothed cross entropy over the valid target
    tokens of a batch, averaged over them."""
    label_smooth = cfg["train"]["label_smooth"]
    enc, lens, state = encode(prec, params, feats, cfg)
    B, S = tokens_in.shape
    dec = Decoder(prec, params, enc, lens, state, 1)
    logps = [dec.step(tokens_in[:, t]) for t in range(S)]
    logp = torch.stack(logps, dim=1)                              # [B, S, V]
    V = logp.shape[-1]
    tgt = logp.gather(-1, tokens_out[..., None])[..., 0]
    off = label_smooth / (V - 1)
    per = -(1.0 - label_smooth) * tgt - off * (logp.sum(-1) - tgt)
    mask = (torch.arange(S, device=logp.device)[None, :]
            < text_lens[:, None]).float()
    return (per * mask).sum() / mask.sum().clamp(min=1.0)


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's tensors by path, "encoder/layers/0/fwd/w_ih" style."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def adam_steps(prec, params, batches, cfg: dict, steps: int):
    """``steps`` Adam steps (optax.adam after add_decayed_weights, as the
    reference's torch Adam with weight decay) -> per step the loss, the
    first step's gradient with the decay added (what Adam's first moment
    is made of) and the parameters after the last step, by leaf path."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, wd = cfg["train"]["base_lr"], cfg["train"]["l2_decay"]
    p = {n: t.detach().clone().requires_grad_(True)
         for n, t in leaves(params).items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first = [], None
    for s in range(steps):
        tree = _tree_like(params, p)
        loss = train_loss(prec, tree, *batches[s], cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (n, t), g in zip(p.items(), grads):
                u = g + wd * t
                if s == 0:
                    first = {} if first is None else first
                    first[n] = u.clone()
                mu[n] = b1 * mu[n] + (1 - b1) * u
                nu[n] = b2 * nu[n] + (1 - b2) * u * u
                m_hat = mu[n] / (1 - b1 ** (s + 1))
                v_hat = nu[n] / (1 - b2 ** (s + 1))
                t -= lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, {n: t.detach() for n, t in p.items()}


def _tree_like(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return flat[prefix[:-1]]
