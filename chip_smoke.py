#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chinese_asr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. build the hand-written CUDA kernels from ``chinese_asr_tpu_torch/csrc``
   (nvcc, one process per source, all in parallel) and print the build
   time and the card's name and power limit;
2. hold each kernel against its plain PyTorch twin on the card at the
   main path's shapes (K1 log-mel on [32, 160000] wavs, K2 BiLSTM loop on
   [332, 128, 1024] gates with ragged masks, K3 top-k on [2048, 5004] at
   k=17 with planted ties, NaN, +-inf and all -inf rows), and time kernel,
   twin and the nearest single PyTorch call;
3. drive the main path: ``ASR(bw=16).transcribe_wavs`` at the flagship
   ``Config()`` with seeded random weights on 32 synthetic 9-10 s int16
   wavs over the flat wire, then greedy on the same batch, checking that
   every kernel of the path launched, that two runs agree exactly, that
   the card's output matches the plain CPU path on a small input, and that
   the golden shard (tests/golden) reproduces its expected transcripts;
   each wall time is the median of warm runs, and one more warm run of
   the beam path goes under torch.profiler for the device-time split;
4. print one ``{"kernels": [...]}`` line and, last, the ok line.

It imports nothing of JAX nor of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

# Tolerances (max abs error, kernel vs its plain twin, both f32 on the card).
# K1: the 400-tap DFT and the 257-bin mel sums are accumulated in another
#     order than cuBLAS's; log-mel of speech-level power differs by ~1e-6
#     relative (up to ~3e-4 absolute on low-energy bins in the CPU
#     parity tests), so 2e-3 is a margin; a framing bug errs by O(1).
# K2: 332 recurrent steps of 256-term dot products in another order; the
#     LSTM's saturating gates keep the drift at f32 rounding level.
# K3: exact -- values and indices must be equal (NaN where NaN).
TOL_LOGMEL = 2e-3
TOL_LSTM = 1e-4
# card output vs the plain CPU path on a small input (same weights)
TOL_FEATS = 1e-3
TOL_ENC = 1e-3

TIMED_RUNS = 7                  # warm main-path runs behind each wall time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _synthetic_wavs(np, rng, n: int, lo_s: float, hi_s: float, sr=16000):
    """Speech-like int16 wavs: a few gliding harmonic tones under noise,
    with a slow amplitude envelope (syllable-rate bursts)."""
    wavs = []
    for _ in range(n):
        L = int(rng.integers(int(lo_s * sr), int(hi_s * sr) + 1))
        t = np.arange(L) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(np.sin(h * phase) / h for h in range(1, 6))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
        x = 0.2 * env * x + 0.01 * rng.standard_normal(L)
        wavs.append(np.clip(x * 32767, -32768, 32767).astype(np.int16))
    return wavs


def _profile_main_path(torch, asr, wavs, label: str, wall_ms: float) -> None:
    """Where the time goes: one extra (warm) run under torch.profiler;
    prints device time by kernel and the kernels' busy time as a share of
    ``wall_ms``, the median wall of the path's timed warm runs.
    Informational: its launches are not the main path's counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    asr.transcribe_wavs(wavs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        asr.transcribe_wavs(wavs)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side kernel events only (the aten ops that launched them
    # carry the same time again)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda e: -dev_us(e))
    if not rows:
        print(f"profile {label}: no device time in the trace (not measured)")
        return
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"profile {label}: kernels busy {busy_ms:.1f} ms in the profiled "
          f"run = {100 * busy_ms / wall_ms:.1f}% of the median warm wall "
          f"{wall_ms:.1f} ms, {sum(e.count for e in rows)} kernel launches")
    for e in rows[:12]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.items.append(what)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.audio import features
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.ops.cuda import build
    from chinese_asr_tpu_torch.ops.cuda import logmel as logmel_k
    from chinese_asr_tpu_torch.ops.cuda import lstm as lstm_k
    from chinese_asr_tpu_torch.ops.cuda import topk as topk_k
    from chinese_asr_tpu_torch.utils.device import resolve_device
    from chinese_asr_tpu_torch.vocab import Vocab

    fails = Failures()
    dev = resolve_device("cuda")            # also pins TF32 off
    gpu = _gpu_line()
    print(gpu, flush=True)                  # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.time()
    so = build.build()
    print(f"build: {time.time() - t0:.2f} s -> {os.path.relpath(so)}",
          flush=True)
    log = os.path.join(build.BUILD_DIR, f"build-{build._digest()}.log")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or line.startswith("=="):
                    print("  ptxas:", line.rstrip())
    rng = np.random.default_rng(0)
    kernels = {}

    # ---- phase 2a: K1 log-mel ------------------------------------------------
    acfg = Config().audio
    B1, N1 = 32, 160000
    wav = torch.from_numpy(np.concatenate(
        [w[None, :N1].astype(np.float32) / 32768.0
         for w in _synthetic_wavs(np, rng, B1, 10.0, 10.0)])).to(dev)
    pre = (wav[:, 1:] - acfg.preemphasis * wav[:, :-1]).contiguous()
    T1 = int(features.num_frames(N1, acfg))
    got = logmel_k.log_mel(pre, T1, acfg)
    ref = logmel_k.log_mel_plain(pre, T1, acfg)
    err1 = float((got - ref).abs().max())
    fails.check(bool(torch.isfinite(got).all()) and err1 <= TOL_LOGMEL,
                f"K1 log-mel [{B1},{N1}] T={T1}: max_abs_err {err1:.3g} "
                f"<= {TOL_LOGMEL}")
    cos_m, sin_m, fb = logmel_k._tables(acfg, dev)
    window = torch.hann_window(acfg.win_length, device=dev)
    eps = float(np.finfo(np.float32).eps)

    def stft_logmel():
        spec = torch.stft(pre, acfg.n_fft, acfg.hop_length, acfg.win_length,
                          window, center=False, return_complex=True)
        mel = spec.abs().pow(2).transpose(1, 2) @ fb
        return torch.log(torch.where(mel == 0, eps, mel))

    lib = stft_logmel()
    print(f"  K1 vs torch.stft path: max_abs_err "
          f"{float((lib - got).abs().max()):.3g}", flush=True)
    nb, nm = acfg.n_fft // 2 + 1, acfg.n_mels
    # What log-mel needs, not what this kernel does: the wav read, the
    # window and filterbank read and the features written once; per frame
    # a real n_fft-point FFT (~2.5 n log2 n operations), the windowing,
    # the power, the bins x mels product and the log.
    fft_ops = 2.5 * acfg.n_fft * np.log2(acfg.n_fft)
    bound, by = _bound_ms(
        4 * (B1 * (N1 - 1) + B1 * T1 * nm + acfg.win_length + nb * nm),
        B1 * T1 * (fft_ops + acfg.win_length + 3 * nb + 2 * nb * nm + nm))
    kernels["logmel"] = dict(
        name="K1 log-mel", route="cuda",
        source="chinese_asr_tpu_torch/csrc/logmel.cu",
        replaces="chinese_asr_tpu/ops/pallas/logmel.py:107",
        max_abs_err=err1,
        ms=_time_ms(torch, lambda: logmel_k.log_mel(pre, T1, acfg), 20),
        plain_ms=_time_ms(torch, lambda: logmel_k.log_mel_plain(pre, T1, acfg),
                          5),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(torch, stft_logmel, 20),
        shape=f"wav [{B1}, {N1 - 1}] -> [{B1}, {T1}, {nm}]")
    del wav, pre, got, ref, lib

    # ---- phase 2b: K2 BiLSTM time loop ---------------------------------------
    T2, B2, H = 332, 128, 256
    g = torch.Generator(device=dev).manual_seed(1)
    xg_f = torch.randn(T2, B2, 4 * H, device=dev, generator=g)
    xg_b = torch.randn(T2, B2, 4 * H, device=dev, generator=g)
    w_hh = torch.randn(2, H, 4 * H, device=dev, generator=g) / H ** 0.5
    lens2 = torch.from_numpy(rng.integers(T2 // 2, T2 + 1, B2)).to(dev)
    lens2[0] = T2
    m_f = (torch.arange(T2, device=dev)[:, None] < lens2[None, :]).float()
    m_b = torch.flip(m_f, dims=(0,)).contiguous()
    args2 = (xg_f, xg_b, m_f, m_b, w_hh)
    ref = lstm_k.bidir_lstm_time_loop_plain(*args2)
    got = lstm_k.bidir_lstm_time_loop(*args2)
    err2 = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    fails.check(err2 <= TOL_LSTM, f"K2 BiLSTM (cluster kernel) T={T2} B={B2} "
                                  f"H={H}: max_abs_err {err2:.3g} <= {TOL_LSTM}")
    fails.check(float(got[0][m_f == 0].abs().max()) == 0.0,
                "K2 (cluster kernel) masked steps emit exact zeros")
    # H not a multiple of 64 (the golden model's 16) runs the simple kernel
    hs = 16
    small2 = (xg_f[..., :4 * hs].contiguous(), xg_b[..., :4 * hs].contiguous(),
              m_f, m_b, w_hh[:, :hs, :4 * hs].contiguous())
    errs = max(float((a - b).abs().max()) for a, b in
               zip(lstm_k.bidir_lstm_time_loop(*small2),
                   lstm_k.bidir_lstm_time_loop_plain(*small2)))
    fails.check(errs <= TOL_LSTM, f"K2 BiLSTM (simple kernel) T={T2} B={B2} "
                                  f"H={hs}: max_abs_err {errs:.3g} <= {TOL_LSTM}")
    del small2
    # No single PyTorch call computes K2's function (the recurrence alone,
    # on precomputed gates).  The nearest is cuDNN's whole bidirectional
    # layer, input projection included, on a packed batch of the same
    # lengths: timed as an informational yardstick, never used by the port.
    cudnn = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.randn(T2, B2, 2 * H, device=dev, generator=g), lens2.cpu(),
        enforce_sorted=False)
    with torch.no_grad():
        cudnn_ms = _time_ms(torch, lambda: cudnn(packed), 20)
    del cudnn, packed
    steps = int(lens2.sum())                 # valid (row, step) pairs
    bound, by = _bound_ms(
        4 * (2 * T2 * B2 * 4 * H + 2 * T2 * B2 + 2 * H * 4 * H
             + 2 * T2 * B2 * H + 4 * B2 * H),
        2 * steps * (2 * H * 4 * H + 10 * H))
    kernels["lstm"] = dict(
        name="K2 BiLSTM time loop", route="cuda",
        source="chinese_asr_tpu_torch/csrc/lstm.cu",
        replaces="chinese_asr_tpu/ops/pallas/lstm.py:142",
        max_abs_err=err2,
        ms=_time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop(*args2), 20),
        plain_ms=_time_ms(torch,
                          lambda: lstm_k.bidir_lstm_time_loop_plain(*args2),
                          2, warmup=1),
        bound_ms=bound, bound_by=by, library_ms=None,
        cudnn_layer_ms=cudnn_ms,
        shape=f"xg [2 x {T2}, {B2}, {4 * H}] -> ys [2 x {T2}, {B2}, {H}]")
    del args2, xg_f, xg_b, got, ref

    # ---- phase 2c: K3 top-k -------------------------------------------------
    R, V, k = 2048, 5004, 17
    x = torch.randn(R, V, device=dev, generator=g)
    x[0, [3, 17, 29, 4000]] = 9.0              # 4-way tie at the top
    x[1, 7] = float("nan")
    x[2, 11] = float("inf")
    x[2, 12] = float("nan")
    x[3, :] = float("-inf")                    # all -inf (step-0 beams)
    x[16:32, :] = float("-inf")
    x[4, :] = 1.5                              # all tied
    x[5, ::3] = float("-inf")
    x[6, :] = float("nan")
    x[7, V - 5:] = 50.0                        # winners in the ragged tail
    vk, ik = topk_k.top_k(x, k)
    vp, ip = topk_k.top_k_plain(x, k)
    same_nan = torch.equal(torch.isnan(vk), torch.isnan(vp))
    same_v = torch.equal(torch.nan_to_num(vk, nan=0.0),
                         torch.nan_to_num(vp, nan=0.0))
    fails.check(same_nan and same_v and torch.equal(ik, ip),
                f"K3 top-k [{R},{V}] k={k}: values and indices exact "
                f"(ties, NaN, +-inf, all -inf rows)")
    fails.check(ik[3].tolist() == list(range(k))
                and ik[0, :4].tolist() == [3, 17, 29, 4000],
                "K3 all -inf row -> lowest columns; ties -> lower column")
    small = torch.randn(64, 1000, device=dev, generator=g)
    fails.check(all(torch.equal(a, b) for a, b in
                    zip(topk_k.top_k(small, 17), topk_k.top_k_plain(small, 17))),
                "K3 top-k [64,1000] k=17 exact")
    xr = torch.randn(R, V, device=dev, generator=g)
    bound, by = _bound_ms(4 * R * V + 8 * R * k, R * V)
    kernels["topk"] = dict(
        name="K3 exact top-k", route="cuda",
        source="chinese_asr_tpu_torch/csrc/topk.cu",
        replaces="chinese_asr_tpu/ops/pallas/topk.py:277",
        max_abs_err=0.0 if (same_nan and same_v) else float("nan"),
        ms=_time_ms(torch, lambda: topk_k.top_k(xr, k), 50),
        plain_ms=_time_ms(torch, lambda: topk_k.top_k_plain(xr, k), 20),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(torch, lambda: torch.topk(xr, k, dim=1), 50),
        shape=f"[{R}, {V}] k={k}")
    del x, xr, small

    # ---- phase 3: main path --------------------------------------------------
    cfg = Config()
    wavs = _synthetic_wavs(np, rng, 32, 9.0, 10.0)
    # bench.py's headline shape (B=128), timed beside the 32-wav main path
    wavs128 = wavs + _synthetic_wavs(np, rng, 96, 9.0, 10.0)
    mods = {"logmel": logmel_k, "lstm": lstm_k, "topk": topk_k}
    paths = {}
    for mode, bw, batch in (("beam_bw16", 16, wavs), ("greedy", None, wavs),
                            ("beam_bw16_b128", 16, wavs128)):
        audio_s = sum(len(w) for w in batch) / cfg.audio.sample_rate
        asr = ASR(bw=bw, cfg=cfg, seed=0)          # device defaults to cuda
        runs = []
        for rep in range(2):
            for m in mods.values():
                m.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts = asr.transcribe_wavs(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            runs.append((texts, wall, {n: m.launches for n, m in mods.items()}))
        (t1, w1, c1), (t2, w2, c2) = runs
        need = ("logmel", "lstm", "topk") if bw else ("logmel", "lstm")
        fails.check(all(c1[n] > 0 for n in need),
                    f"{mode}: kernels launched in the main path {c1}")
        fails.check(t1 == t2 and len(t1) == len(batch),
                    f"{mode}: two runs give identical transcripts")
        fails.check(all(isinstance(s, str) for s in t1) and any(t1),
                    f"{mode}: non-empty transcripts")
        # host-clock times spread: take the median of TIMED_RUNS warm runs
        walls = [w2]
        for _ in range(TIMED_RUNS - 1):
            t = time.perf_counter()
            asr.transcribe_wavs(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        wall = float(np.median(walls))
        paths[mode] = dict(batch=len(batch), wall_s_first=w1, wall_s=wall,
                           wall_s_min=min(walls), wall_s_max=max(walls),
                           runs=len(walls), launches=c1, audio_s=audio_s,
                           audio_s_per_s=audio_s / wall)
        print(f"{mode}: {len(batch)} wavs, {audio_s:.1f} s audio, wall "
              f"{w1:.3f} s (first), median {wall:.4f} s of {len(walls)} warm "
              f"runs [{min(walls):.4f}, {max(walls):.4f}] -> "
              f"{audio_s / wall:.1f} audio-s/s on {gpu}; launches {c1}; "
              f"first transcript {t1[0][:60]!r}", flush=True)
        if mode == "beam_bw16":
            for n in kernels:
                kernels[n]["launches"] = c1[n]
        del asr
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    for mode, batch in (("beam_bw16", wavs), ("beam_bw16_b128", wavs128)):
        _profile_main_path(torch, ASR(bw=16, cfg=cfg, seed=0), batch, mode,
                           paths[mode]["wall_s"] * 1e3)

    # ---- phase 3b: card vs plain CPU path on a small input -------------------
    small_wavs = _synthetic_wavs(np, rng, 4, 1.0, 2.0)
    cards = {d: ASR(bw=16, cfg=cfg, seed=0, device=d) for d in ("cuda", "cpu")}
    prep = cards["cpu"]._prep(small_wavs, None)
    out = {}
    for d, a in cards.items():
        feats, flens = a._featurize(prep)
        eb = las.encode(a.params, cfg, feats, flens)
        out[d] = (feats.cpu(), eb.enc_out.cpu(), eb.keys.cpu())
    ef = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    ee = max(float((out["cuda"][i] - out["cpu"][i]).abs().max())
             for i in (1, 2))
    fails.check(ef <= TOL_FEATS, f"card vs CPU features: {ef:.3g} <= {TOL_FEATS}")
    fails.check(ee <= TOL_ENC, f"card vs CPU encoder/keys: {ee:.3g} <= {TOL_ENC}")
    for bw in (16, None):
        texts = {}
        for d, a in cards.items():
            a.bw = bw
            texts[d] = a.transcribe_wavs(small_wavs)
        fails.check(texts["cuda"] == texts["cpu"],
                    f"card vs CPU transcripts (bw={bw}) on {len(small_wavs)} "
                    f"short wavs")

    # ---- phase 3c: the golden shard through the kernels ----------------------
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    with open(os.path.join(gold, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"]
    gcfg = (Config().with_("audio", n_mels=8, delta_delta=False,
                           downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=8))
    gvocab = Vocab.build(["的一是不了人我在" * 3], max_num_words=8)
    gpaths = [os.path.join(gold, f"utt{i}.wav") for i in range(6)]
    for mode, bw in (("greedy", None), ("beam_bw4", 4)):
        asr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
                  vocab=gvocab, bw=bw)
        fails.check(asr.transcribe_files(gpaths) == expected[mode],
                    f"golden shard {mode} on the card matches expected.json")

    # ---- phase 4: report -----------------------------------------------------
    print("main path: " + json.dumps(paths), flush=True)
    print(json.dumps({"kernels": [
        dict(kernels[n], kernel_ms=kernels[n]["ms"]) for n in kernels]}),
        flush=True)
    if fails.items:
        print("chip_smoke FAILED: " + "; ".join(fails.items), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
