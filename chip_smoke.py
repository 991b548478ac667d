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
   [332, 128, 1024] gates with ragged masks, also timed at B=32 and with
   its cluster plan (waves); K3 top-k at k=17 on [2048, 5004] and
   [512, 5004] (the stage-1 rows at B=128 and B=32) with planted ties,
   NaN, +-inf and all -inf rows, beam-like rows, and adversarial rows that
   put every winner in one lane (which must take the kernel's flat
   fallback), and on [64, 70000]; K3 at k=20 (the LM first pass's
   proposal) at both R on logit-like, tied and adversarial rows; K4
   fused logp + top-k at both R with step-0 -inf row biases, a NaN row,
   adversarial rows and rows of exactly tied keys, and on [64, 70000];
   each set's fallback rows are printed), and time
   kernel, twin and the nearest single PyTorch call (K3 and K4 as CUDA
   graphs of 50 calls, on inputs cycled past the L2; also at one and at
   four warps a row, at R = 512, 1024 and 2048);
3. drive the main path: ``ASR(bw=16).transcribe_wavs`` at the flagship
   ``Config()`` with seeded random weights on 32 synthetic 9-10 s int16
   wavs over the flat wire, then greedy on the same batch, then the LM
   second pass (``lm_path=``, ``lm_mode="second"``) over a synthetic
   order-3 ARPA written from seed 0, once through K3 and once with the
   fused stage 1 (K4, ``CHINESE_ASR_PALLAS_FUSED=1``), and over a
   synthetic order-5 ARPA at the reference's pruned 5-gram size through
   K3, then the LM-driven first pass (``lm_mode="first"``, topn 20) over
   the order-3 ARPA; every LM's tables are hashed, built through the C++
   reader (the parse and build times are printed, and the order-3 one
   through the pure-Python parse beside it); checking that
   every kernel of each path launched (and K4 on no path but the fused
   one), that two runs agree exactly, that the card's output matches the
   plain CPU path on a small input, that the LM probes on the card equal
   those on the CPU, and that the golden shard (tests/golden) reproduces
   its expected transcripts in every mode (``lm_first`` included), and a
   ``.klm`` fixture gives its ARPA's transcripts through both device LM
   modes; each wall time is the median of warm runs, and one more warm
   run of each beam path goes under torch.profiler for the device-time
   split; the B=128 batch is also decoded with the fused and the unfused
   stage 1, and the first pass's batch by its host-loop oracle, counting
   what differs (report only);
3d. serve the flagship ``ASR(bw=16)`` over HTTP (``serve_http`` on a
   thread, clients in this process): ``warm`` runs the batch ladder,
   ``/healthz`` reports cuda, 32 concurrent requests under a 5000 ms
   window form one batch whose replies equal ``transcribe_wavs`` of that
   batch exactly with K1-K3 launched and K4 not, a bad body gets 400, a
   flood at ``max_queue=1`` with the worker held gets 429s, and the
   golden shard's greedy and beam_bw4 replies equal ``expected.json``;
   reports single-request and burst latencies at the 15 ms window;
3e. check the overlapped chunk upload (160 wavs at ``max_batch=128``,
   twice, against each sorted chunk alone; the profiler's copy/kernel
   overlap reported), ``transcribe_long`` on a 60 s wav,
   ``transcribe_bytes`` against ``transcribe_files``, and
   ``evaluate_manifest`` on the golden shard in all five modes (card
   against CPU); report ``evaluate_manifest`` at flagship width;
4. print one ``{"kernels": [...]}`` line and, last, the ok line.

It imports nothing of JAX nor of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import time

# Tolerances (max abs error, kernel vs its plain twin, both f32 on the card).
# K1: the 400-tap DFT runs as 3xTF32 tensor-core products (the dropped
#     lo*lo term is ~2^-22 relative) summed in another order than cuBLAS's;
#     on speech the log-mel of bins with little energy then moves by a few
#     1e-4 (the lowest bins, where pre-emphasis leaves the least, are
#     computed in the twin's own f32 order); 2e-3 is the margin, a framing
#     bug errs by O(1).
# K2: 332 recurrent steps of 256-term 3xTF32 products in another order;
#     the LSTM's saturating gates keep the drift near f32 rounding level.
# K3: exact -- values and indices must be equal (NaN where NaN).
# K4: the row logsumexp is summed in another order than the twin's; keys
#     of magnitude < 32 then differ by a few f32 ulps (<= 4e-6), so 1e-5;
#     indices must be equal on rows whose top-(k+1) keys are more than
#     that apart, and exact rows (-inf bias, NaN logit) must match exactly.
TOL_LOGMEL = 2e-3
TOL_LSTM = 1e-4
TOL_FUSED = 1e-5
# card output vs the plain CPU path on a small input (same weights)
TOL_FEATS = 1e-3
TOL_ENC = 1e-3

TIMED_RUNS = 7                  # warm main-path runs behind each wall time

# The ARPA text of tests/data/golden_tri_probing.klm (tests/test_lm_binary.py
# ARPA_TRI); phase 3c checks that it rebuilds the fixture byte for byte.
ARPA_TRI = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0\t<unk>
-0.8\t<s>\t-0.5
-0.7\t</s>
-0.5\ta\t-0.3
-0.6\tb\t-0.2

\\2-grams:
-0.4\t<s> a\t-0.1
-0.3\ta b\t-0.2
-0.5\tb </s>
-0.9\ta a

\\3-grams:
-0.2\t<s> a b
-0.4\ta b </s>

\\end\\
"""

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12        # TF32 tensor cores, dense


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


def _synthetic_arpa(np, path: str, words, counts, seed: int = 0):
    """An ARPA of order ``len(counts) + 1`` over ``words`` (every one a
    unigram): random log10 probabilities and backoffs, ``counts[j]``
    distinct n-grams of order j + 2, each extending a listed n-gram of
    the order below whose last word is not ``</s>``.  Returns the n-gram
    counts per order and the top-order n-grams as [n, order] indices into
    ``words`` (the LM's word ids: they follow the unigram order)."""
    rng = np.random.default_rng(seed)
    words = np.asarray(words)
    nw = len(words)
    bos, eos = int(np.nonzero(words == "<s>")[0][0]), \
        int(np.nonzero(words == "</s>")[0][0])
    hist_ids = np.setdiff1d(np.arange(nw), [eos])    # </s> ends a history
    next_ids = np.setdiff1d(np.arange(nw), [bos])    # <s> is never next

    def pairs(n, a_pool, b_pool):
        got = np.zeros((0, 2), np.int64)
        while len(got) < n:
            draw = np.stack([rng.choice(a_pool, 2 * n),
                             rng.choice(b_pool, 2 * n)], axis=1)
            got = np.unique(np.concatenate([got, draw]), axis=0)
        return got[rng.permutation(len(got))[:n]]

    levels = [pairs(counts[0], hist_ids, next_ids)]
    for n in counts[1:]:
        ext = levels[-1][levels[-1][:, -1] != eos]   # n-grams to extend
        p = pairs(n, np.arange(len(ext)), next_ids)
        levels.append(np.concatenate([ext[p[:, 0]], p[:, 1:]], axis=1))

    def lp(n):
        return np.round(-rng.uniform(0.05, 4.0, n), 4)

    def bo(n):
        return np.round(-rng.uniform(0.0, 1.0, n), 4)

    order = len(counts) + 1
    lines = ["\\data\\", f"ngram 1={nw}"]
    lines += [f"ngram {j + 2}={len(g)}" for j, g in enumerate(levels)]
    lines += ["", "\\1-grams:"]
    lines += [f"{p}\t{w}\t{b}" for p, w, b in zip(lp(nw), words, bo(nw))]
    for j, g in enumerate(levels):
        lines += ["", f"\\{j + 2}-grams:"]
        text = [" ".join(r) for r in words[g]]
        if j + 2 < order:
            lines += [f"{p}\t{t}\t{b}"
                      for p, t, b in zip(lp(len(g)), text, bo(len(g)))]
        else:
            lines += [f"{p}\t{t}" for p, t in zip(lp(len(g)), text)]
    lines += ["", "\\end\\", ""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return [nw] + [len(g) for g in levels], levels[-1]


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
    # the twelve largest, then the port's own kernels further down
    ours = [e for e in rows[12:] if any(
        n in e.key for n in ("topk_kernel", "bilstm", "logmel"))]
    for e in rows[:12] + ours:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


def _fused_flips(torch, asr, wavs, beam_mod) -> dict:
    """How often K4 changes the beam: the same batch decoded with the
    fused and the unfused stage 1, counting the n-best entries (the B x bw
    live hypotheses at the end and the harvested finished slots) and the
    transcripts that differ."""
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    res = [beam_mod.beam_decode(asr.params, asr.cfg, asr.bw, feats, lens,
                                fused_logp=f) for f in (False, True)]
    texts = [beam_mod.finalize_best(beam_mod.select_best(
        r, asr.cfg.decode.length_weight), asr.vocab).pred_text for r in res]
    a, b = res
    live = (a.live_tokens != b.live_tokens).any(dim=-1)
    fin_a, fin_b = torch.isfinite(a.fin_scores), torch.isfinite(b.fin_scores)
    fin = (fin_a != fin_b) | (fin_a & (a.fin_tokens != b.fin_tokens).any(-1))
    same_live = ~live
    return dict(
        batch=len(wavs), steps=(a.l_final + 1, b.l_final + 1),
        live_entries=int(live.numel()), live_differ=int(live.sum()),
        finished_entries=int((fin_a | fin_b).sum()),
        finished_differ=int(fin.sum()),
        transcripts_differ=sum(x != y for x, y in zip(*texts)),
        live_score_max_abs_diff=float(
            (a.live_scores - b.live_scores)[same_live].abs().max())
        if bool(same_live.any()) else None)


def _first_pass_vs_host(torch, asr, wavs, fused_texts) -> dict:
    """The LM-driven first pass against its host-loop oracle
    (``lm_first_pass_decode`` over the C++ LM, f64 sums) on the same
    batch at full width: the transcripts and n-best lists that differ,
    the largest score difference where they agree, and the oracle's wall
    and stage split (host clock)."""
    from chinese_asr_tpu_torch.decode import lm_first_pass, lm_fused
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    res = lm_fused.lm_fused_decode(asr.params, asr.cfg, asr.bw, feats, lens,
                                   asr.dlm, asr.tok2lm, asr.lm_topn)
    fused = lm_fused.nbest_lists(res)
    prof = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = lm_first_pass.lm_first_pass_decode(
        asr.params, asr.cfg, asr.bw, feats, lens, asr.dlm.host_lm, asr.vocab,
        topn=asr.lm_topn, profile=prof)
    wall = time.perf_counter() - t
    texts = [asr.vocab.decode(h[0][0]) for h in host]
    same = [b for b in range(len(host))
            if [i for i, _ in host[b]] == [i for i, _ in fused[b]]]
    diff = [abs(a[1] - b[1]) for s in same for a, b in zip(host[s], fused[s])]
    return dict(batch=len(wavs), fused_steps=res.l_final + 1,
                transcripts_differ=sum(a != b for a, b in
                                       zip(texts, fused_texts)),
                nbest_lists_differ=len(host) - len(same),
                max_abs_score_diff=max(diff) if diff else None,
                host_oracle_wall_s=wall,
                host_oracle_stages_s={k: v for k, v in prof.items()})


def _write_wav_i16(path: str, pcm, sr: int = 16000) -> None:
    import wave
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _wav_bytes(pcm, sr: int = 16000) -> bytes:
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post(url: str, data: bytes, timeout: float = 600):
    """(HTTP status, JSON body, seconds) of one POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, method="POST")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t


def _burst(url: str, bodies):
    """POST every body at once, one thread each; (replies in body order,
    wall seconds from the first send to the last reply)."""
    import threading
    out = [None] * len(bodies)
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(i, _post(url, bodies[i])))
        for i in range(len(bodies))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return out, time.perf_counter() - t


def _start_server(asr, **kw):
    import threading
    from chinese_asr_tpu_torch.serve import serve_http
    srv = serve_http(asr, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def _stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()              # stops the batcher's worker too


def _copy_overlap(trace_path: str, min_bytes: int = 1 << 20):
    """Host->device copies of at least ``min_bytes`` in a profiler trace,
    in time order, each with the microseconds during which a kernel ran on
    another stream; None when the trace holds no such copy."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    copies = sorted((e for e in events if e.get("cat") == "gpu_memcpy"
                     and "HtoD" in e.get("name", "")
                     and e.get("args", {}).get("bytes", 0) >= min_bytes),
                    key=lambda e: e["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not copies or not kernels:
        return None
    out = []
    for c in copies:
        a, b = c["ts"], c["ts"] + c["dur"]
        stream = c.get("args", {}).get("stream")
        ov = sum(max(0.0, min(b, k["ts"] + k["dur"]) - max(a, k["ts"]))
                 for k in kernels if k.get("args", {}).get("stream") != stream)
        out.append(dict(mbytes=c["args"]["bytes"] / 2**20, copy_us=c["dur"],
                        stream=stream, overlap_us=ov))
    return out


def _phase_serving(np, torch, fails, ASR, cfg, wavs, counters, gpu, golden):
    """Phase 3d: ``serve_http`` at the flagship width on the card, then the
    golden shard over HTTP.  Returns the latency report."""
    import threading
    import urllib.request
    from chinese_asr_tpu_torch.data import audio_io
    gold, gcfg, gvocab, gpaths, expected = golden
    scales32 = [audio_io.peak_scale(w) for w in wavs]
    bodies = [_wav_bytes(w) for w in wavs]
    audio32 = sum(len(w) for w in wavs) / cfg.audio.sample_rate
    sasr = ASR(bw=16, cfg=cfg, seed=0)
    direct_tw = sasr.transcribe_wavs
    served = []                 # (wavs, scales) of every decode served

    def recording(ws, max_batch=128, scales=None):
        served.append((list(ws), list(scales)))
        return direct_tw(ws, max_batch=max_batch, scales=scales)

    sasr.transcribe_wavs = recording
    srv, url = _start_server(sasr, max_batch=32, window_ms=5000.0)
    n_warm = srv.batcher.warm(wavs[0], scales32[0])
    fails.check(n_warm == 6 and [len(w) for w, _ in served]
                == [1, 2, 4, 8, 16, 32],
                f"serve: warm ran the ladder {[len(w) for w, _ in served]}")
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    fails.check(health.get("backend") == "cuda",
                f"serve: /healthz answers {health}")
    served.clear()
    batches0 = srv.batcher.batches
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    replies, burst_wall = _burst(url + "/transcribe", bodies)
    served_counts = {n: getattr(mod, attr) for n, (mod, attr)
                     in counters.items()}
    ok_all = all(r is not None and r[0] == 200 for r in replies)
    fails.check(ok_all and srv.batcher.batches - batches0 == 1
                and len(served) == 1,
                f"serve: 32 concurrent requests (5000 ms window) formed "
                f"{srv.batcher.batches - batches0} batch(es), statuses "
                f"{sorted({r[0] for r in replies if r})}")
    row_of = {}
    if served:
        rows = {w.tobytes(): j for j, w in enumerate(served[0][0])}
        row_of = {i: rows.get(w.tobytes()) for i, w in enumerate(wavs)}
        direct = direct_tw(served[0][0], max_batch=32, scales=served[0][1])
        same = ok_all and all(
            row_of[i] is not None
            and replies[i][1]["text"] == direct[row_of[i]]
            for i in range(len(wavs)))
    else:
        same = False
    fails.check(same, "serve: every reply equals transcribe_wavs of the "
                      "same 32 wavs, peak scales and row order, exactly")
    fails.check(all(served_counts[n] > 0 for n in ("logmel", "lstm", "topk"))
                and served_counts["topk_fused"] == 0,
                f"serve: kernels launched in the served batch "
                f"{served_counts}")
    in_order = [row_of.get(i) for i in range(len(wavs))] == \
        list(range(len(wavs)))
    plain = direct_tw(wavs, max_batch=32, scales=scales32)
    plain_differ = (sum(r[1]["text"] != t for r, t in zip(replies, plain))
                    if ok_all else None)
    print(f"serve: the batch's rows in request order: {in_order}; "
          f"transcribe_wavs in request order differs on {plain_differ} of "
          f"32 replies (report only: row order may change nothing, but the "
          f"check above compares the batch's own order)", flush=True)
    status, body, _ = _post(url + "/transcribe", b"not audio at all")
    status2, body2, _ = _post(url + "/transcribe", bodies[1])
    fails.check(status == 400 and status2 == 200
                and body2.get("text") == plain[1],
                f"serve: a bad body gets {status}, the next request "
                f"{status2}")
    _stop_server(srv)

    # load shedding: max_queue=1 with the worker held inside a decode
    entered, release = threading.Event(), threading.Event()

    def held(ws, max_batch=128, scales=None):
        entered.set()
        release.wait(120)
        return direct_tw(ws, max_batch=max_batch, scales=scales)

    sasr.transcribe_wavs = held
    osrv, ourl = _start_server(sasr, max_batch=32, max_queue=1)
    first = threading.Thread(target=_post, args=(ourl + "/transcribe",
                                                 bodies[0]))
    first.start()
    entered.wait(120)
    flood_out = [None] * 16
    flood = [threading.Thread(target=lambda i=i: flood_out.__setitem__(
        i, _post(ourl + "/transcribe", bodies[1 + i]))) for i in range(16)]
    for th in flood:
        th.start()
    deadline = time.time() + 120      # every flood request shed or queued
    while (osrv.batcher.rejected + osrv.batcher._q.qsize() < 16
           and time.time() < deadline):
        time.sleep(0.01)
    release.set()
    for th in [first] + flood:
        th.join(timeout=300)
    codes = [o[0] if o else None for o in flood_out]
    fails.check(codes.count(429) > 0 and codes.count(429) + codes.count(200)
                == 16 and osrv.batcher.rejected == codes.count(429),
                f"serve: max_queue=1, worker held: flood of 16 got "
                f"{codes.count(429)} x 429 and {codes.count(200)} x 200")
    _stop_server(osrv)

    # latency at the default 15 ms window (report only)
    sasr.transcribe_wavs = recording
    lsrv, lurl = _start_server(sasr, max_batch=32)
    srv_warm = lsrv.batcher.warm(wavs[0], scales32[0])
    singles = [_post(lurl + "/transcribe", b)[2] for b in bodies[:8]]
    served.clear()
    replies, wall = _burst(lurl + "/transcribe", bodies)
    lat = [r[2] for r in replies if r and r[0] == 200]
    sizes = [sum(len(w) > 1 for w in ws) for ws, _ in served]
    serving = dict(
        window_ms=15.0, warm_calls=srv_warm,
        single_s=singles, single_p50_s=float(np.median(singles)),
        single_max_s=max(singles),
        burst_n=len(bodies), burst_ok=len(lat), burst_wall_s=wall,
        burst_p50_s=float(np.percentile(lat, 50)) if lat else None,
        burst_p99_s=float(np.percentile(lat, 99)) if lat else None,
        burst_req_per_s=len(lat) / wall, burst_audio_s_per_s=audio32 / wall,
        burst_batches=sizes, burst_padded=[len(ws) for ws, _ in served],
        burst_5000ms_wall_s=burst_wall)
    _stop_server(lsrv)
    print(f"serve (report, {gpu}): 8 single requests one after another, "
          f"p50 {serving['single_p50_s'] * 1e3:.1f} ms, max "
          f"{serving['single_max_s'] * 1e3:.1f} ms; burst of 32 (9-10 s "
          f"wavs) p50 {serving['burst_p50_s'] * 1e3:.1f} ms, p99 "
          f"{serving['burst_p99_s'] * 1e3:.1f} ms, "
          f"{serving['burst_req_per_s']:.1f} req/s, "
          f"{serving['burst_audio_s_per_s']:.1f} audio-s/s, batches formed "
          f"{sizes} (padded {serving['burst_padded']})", flush=True)
    del sasr.transcribe_wavs

    # the golden shard served over HTTP
    gbodies = []
    for p in gpaths:
        with open(p, "rb") as f:
            gbodies.append(f.read())
    for mode, bw in (("greedy", None), ("beam_bw4", 4)):
        gasr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
                   vocab=gvocab, bw=bw)
        gsrv, gurl = _start_server(gasr, max_batch=8, window_ms=2000.0)
        got, _ = _burst(gurl + "/transcribe", gbodies)
        fails.check([r[1].get("text") if r else None for r in got]
                    == expected[mode] and gsrv.batcher.batches == 1,
                    f"serve: golden shard {mode} over HTTP on the card "
                    f"matches expected.json")
        _stop_server(gsrv)
    return serving


def _phase_entry_points(np, torch, fails, ASR, cfg, wavs, wavs128, rng,
                        counters, gpu, golden, build_dir):
    """Phase 3e: the overlapped chunk upload, ``transcribe_long``,
    ``transcribe_bytes`` and ``evaluate_manifest`` on the card.  Returns
    the report entries."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from chinese_asr_tpu_torch.data import dataset as ds_mod
    from chinese_asr_tpu_torch.evaluate import evaluate_manifest
    from chinese_asr_tpu_torch.lm import ngram
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint
    gold, gcfg, gvocab, gpaths, expected = golden
    wavs160 = wavs128 + _synthetic_wavs(np, rng, 32, 9.0, 10.0)
    audio160 = sum(len(w) for w in wavs160) / cfg.audio.sample_rate
    casr = ASR(bw=16, cfg=cfg, seed=0)
    chunked = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts = casr.transcribe_wavs(wavs160, max_batch=128)
        torch.cuda.synchronize()
        chunked.append((texts, time.perf_counter() - t))
    order = sorted(range(len(wavs160)), key=lambda i: len(wavs160[i]))
    alone, alone_s = {}, []
    for s in (0, 128):
        idx = order[s:s + 128]
        torch.cuda.synchronize()
        t = time.perf_counter()
        alone.update(zip(idx, casr.transcribe_wavs(
            [wavs160[i] for i in idx], max_batch=128)))
        torch.cuda.synchronize()
        alone_s.append(time.perf_counter() - t)
    fails.check(chunked[0][0] == chunked[1][0]
                and chunked[0][0] == [alone[i] for i in range(len(wavs160))],
                "chunks: 160 wavs at max_batch=128 (chunks of 128 and 32, "
                "the second uploaded on the side stream during the first): "
                "two runs agree and equal each sorted chunk alone")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        casr.transcribe_wavs(wavs160, max_batch=128)
        torch.cuda.synchronize()
    trace = os.path.join(build_dir, "chunks_trace.json")
    prof.export_chrome_trace(trace)
    overlap = _copy_overlap(trace)
    os.remove(trace)
    chunk_walls = [w for _, w in chunked]
    report = {}
    report["chunked_160"] = dict(
        wall_s=chunk_walls, audio_s=audio160,
        audio_s_per_s=[audio160 / w for w in chunk_walls],
        chunks_alone_s=alone_s, copies=overlap)
    print(f"chunks (report, {gpu}): 160 wavs, {audio160:.1f} s audio, wall "
          f"{chunk_walls[0]:.3f} / {chunk_walls[1]:.3f} s -> "
          f"{audio160 / chunk_walls[1]:.1f} audio-s/s; the two chunks alone "
          f"{alone_s[0]:.3f} + {alone_s[1]:.3f} s; host->device copies "
          f">= 1 MiB in the profiled run (time order; overlap with kernels "
          f"on another stream): {json.dumps(overlap)}", flush=True)

    lwav = _synthetic_wavs(np, rng, 1, 60.0, 60.0)[0]
    lpath = os.path.join(build_dir, "long60.wav")
    _write_wav_i16(lpath, lwav)
    calls = []

    def spy(ws, max_batch=128, scales=None):
        calls.append((list(ws), list(scales)))
        return ASR.transcribe_wavs(casr, ws, max_batch=max_batch,
                                   scales=scales)

    casr.transcribe_wavs = spy
    long_text = casr.transcribe_long(lpath)
    del casr.transcribe_wavs
    cut = calls[0][0] if calls else []
    fails.check(bool(calls) and len(cut) >= 6
                and np.array_equal(np.concatenate(cut), lwav)
                and long_text == "".join(casr.transcribe_wavs(
                    cut, scales=calls[0][1])),
                f"transcribe_long: a 60 s wav in {len(cut)} disjoint chunks "
                f"(lengths {[len(c) for c in cut]}) equals the joined "
                f"transcribe_wavs of those chunks")
    one = os.path.join(build_dir, "one.wav")
    _write_wav_i16(one, wavs[3])
    with open(one, "rb") as f:
        data = f.read()
    fails.check(casr.transcribe_bytes(data) == casr.transcribe_files([one])[0],
                "transcribe_bytes of WAV bytes equals transcribe_files of "
                "the file")
    os.remove(lpath)
    os.remove(one)

    # evaluate_manifest on the golden shard, card against CPU
    with open(os.path.join(gold, "expected.json"), encoding="utf-8") as f:
        gtexts = json.load(f)["texts"]
    gman = os.path.join(build_dir, "golden.tsv")
    ds_mod.write_manifest(gman, [ds_mod.Utterance(p, t)
                                 for p, t in zip(gpaths, gtexts)])
    graw = load_checkpoint(os.path.join(gold, "model.ckpt"))["params"]
    gparams = {"card": las.params_from_numpy(graw, casr.device),
               "cpu": las.params_from_numpy(graw, "cpu")}
    garpa = os.path.join(gold, "lm.arpa")
    for mode, kw in (("greedy", {}), ("beam_bw4", dict(bw=4)),
                     ("lm_second", dict(bw=4, lm_mode="second")),
                     ("lm_second_host", dict(bw=4, lm_mode="second_host")),
                     ("lm_first", dict(bw=4, lm_mode="first", topn=8))):
        res = {}
        for d in ("card", "cpu"):
            if "lm_mode" in kw:
                kw["lm"] = (ngram.load_lm(garpa)
                            if kw["lm_mode"] == "second_host" else garpa)
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            res[d] = evaluate_manifest(gparams[d], gcfg, gvocab, gman,
                                       verbose=False, **kw)
            if d == "card":
                ec = {n: getattr(mod, attr) for n, (mod, attr)
                      in counters.items()}
        fails.check(res["card"]["pred"] == expected[mode]
                    and res["card"]["cer"] == res["cpu"]["cer"]
                    and ec["logmel"] > 0 and ec["lstm"] > 0,
                    f"evaluate_manifest golden {mode} on the card: "
                    f"expected.json's predictions, CER "
                    f"{res['card']['cer']:.4f} (CPU {res['cpu']['cer']:.4f}); "
                    f"launches {ec}")
    os.remove(gman)

    # evaluate_manifest at flagship width on phase 3's 32 wavs (report)
    edir = os.path.join(build_dir, "eval32")
    os.makedirs(edir, exist_ok=True)
    eutts = []
    for i, w in enumerate(wavs):
        p = os.path.join(edir, f"w{i}.wav")
        _write_wav_i16(p, w)
        eutts.append(ds_mod.Utterance(p, "x"))
    eman = os.path.join(edir, "m.tsv")
    ds_mod.write_manifest(eman, eutts)
    evals = [evaluate_manifest(casr.params, cfg, casr.vocab, eman, bw=16,
                               verbose=False) for _ in range(2)]
    ediff = sum(a != b for a, b in zip(evals[1]["pred"],
                                       casr.transcribe_wavs(wavs)))
    report["evaluate_32"] = dict(utts_per_s=[e["utts_per_sec"] for e in evals],
                                seconds=[e["seconds"] for e in evals],
                                differ_from_transcribe_wavs=ediff)
    print(f"evaluate_manifest (report, {gpu}): 32 wavs, bw 16, flagship: "
          f"{evals[1]['utts_per_sec']:.1f} utts/s ({evals[1]['seconds']:.3f}"
          f" s; first run {evals[0]['seconds']:.3f} s); {ediff} of 32 "
          f"predictions differ from transcribe_wavs (report only: the eval "
          f"loader pads to 4800-sample buckets with no peak gain and "
          f"instance-norm eps 1e-7, the flat wire pads otherwise with eps "
          f"1e-6, so f32 rounding differs)", flush=True)
    shutil.rmtree(edir)
    return report


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
    from chinese_asr_tpu_torch.api import ASR, _identity_vocab
    from chinese_asr_tpu_torch.audio import features
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.decode import beam as beam_mod
    from chinese_asr_tpu_torch.lm import device_ngram as dev_ngram
    from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.ops.cuda import build
    from chinese_asr_tpu_torch.ops.cuda import logmel as logmel_k
    from chinese_asr_tpu_torch.ops.cuda import lstm as lstm_k
    from chinese_asr_tpu_torch.ops.cuda import topk as topk_k
    from chinese_asr_tpu_torch.tools.timing import cold_cycle, graph_ms
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
    spills = []
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or line.startswith("=="):
                    print("  ptxas:", line.rstrip())
                spilled = re.search(r"(\d+) bytes spill stores", line)
                if spilled and int(spilled.group(1)) > 0:
                    spills.append(line.strip())
    fails.check(os.path.exists(log) and not spills,
                f"ptxas -v: no register spills in any kernel {spills}")
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
    # the same function in f64 (same f32 inputs and tables): how far the
    # kernel and its twin each sit from the exact sums (report only)
    off1 = (acfg.n_fft - acfg.win_length) // 2
    idx1 = (torch.arange(T1, device=dev)[:, None] * acfg.hop_length + off1
            + torch.arange(acfg.win_length, device=dev)[None, :])
    fr64 = torch.nn.functional.pad(pre.double(), (0, acfg.n_fft))[..., idx1]
    mel64 = ((fr64 @ cos_m.double()) ** 2
             + (fr64 @ sin_m.double()) ** 2) @ fb.double()
    ref64 = torch.log(torch.where(mel64 == 0, float(np.finfo(np.float32).eps),
                                  mel64))
    err1_64 = float((got.double() - ref64).abs().max())
    plain_err1_64 = float((ref.double() - ref64).abs().max())
    print(f"  K1 against f64: kernel {err1_64:.3g}, twin {plain_err1_64:.3g}",
          flush=True)
    del fr64, mel64, ref64
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
    # the design's own floor: the DFT as three TF32 products at the
    # tensor cores' dense rate
    dft_ops = 2 * B1 * T1 * acfg.win_length * 2 * nb
    kernels["logmel"] = dict(
        name="K1 log-mel", route="cuda",
        source="chinese_asr_tpu_torch/csrc/logmel.cu",
        replaces="chinese_asr_tpu/ops/pallas/logmel.py:107",
        max_abs_err=err1,
        ms=_time_ms(torch, lambda: logmel_k.log_mel(pre, T1, acfg), 20),
        plain_ms=_time_ms(torch, lambda: logmel_k.log_mel_plain(pre, T1, acfg),
                          5),
        bound_ms=bound, bound_by=by,
        bound_tf32x3_ms=3 * dft_ops / H100_TF32_FLOPS * 1e3,
        err_vs_f64=err1_64, plain_err_vs_f64=plain_err1_64,
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
    plan2 = lstm_k.plan(B2, H)
    fails.check(plan2["waves"] == 1,
                f"K2 at B={B2}: one wave ({plan2['clusters']} clusters of 8, "
                f"{plan2['rows']} rows each; the card holds "
                f"{plan2['max_active_clusters']})")
    # the main path's own batch (B=32) runs 16 rows per cluster
    args32 = tuple(a[:, :32].contiguous() for a in args2[:4]) + (w_hh,)
    err32 = max(float((a - b).abs().max()) for a, b in
                zip(lstm_k.bidir_lstm_time_loop(*args32),
                    lstm_k.bidir_lstm_time_loop_plain(*args32)))
    fails.check(err32 <= TOL_LSTM,
                f"K2 BiLSTM (cluster kernel) T={T2} B=32 H={H}: max_abs_err "
                f"{err32:.3g} <= {TOL_LSTM}")
    ms32 = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop(*args32), 20)
    del args32
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
    ms2 = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop(*args2), 20)
    kernels["lstm"] = dict(
        name="K2 BiLSTM time loop", route="cuda",
        source="chinese_asr_tpu_torch/csrc/lstm.cu",
        replaces="chinese_asr_tpu/ops/pallas/lstm.py:142",
        max_abs_err=max(err2, err32),
        ms=ms2,
        step_us=ms2 * 1e3 / T2,
        waves=plan2["waves"], clusters=plan2["clusters"],
        max_active_clusters=plan2["max_active_clusters"],
        rows_per_cluster=plan2["rows"],
        ms_b32=ms32, step_us_b32=ms32 * 1e3 / T2,
        bound_tf32x3_ms=3 * 2 * steps * 2 * H * 4 * H / H100_TF32_FLOPS * 1e3,
        plain_ms=_time_ms(torch,
                          lambda: lstm_k.bidir_lstm_time_loop_plain(*args2),
                          2, warmup=1),
        bound_ms=bound, bound_by=by, library_ms=None,
        cudnn_layer_ms=cudnn_ms,
        shape=f"xg [2 x {T2}, {B2}, {4 * H}] -> ys [2 x {T2}, {B2}, {H}]")
    del args2, xg_f, xg_b, got, ref

    # ---- phase 2c: K3 top-k -------------------------------------------------
    R, V, k = 2048, 5004, 17
    R32 = 512                       # the stage-1 rows at B=32, bw 16
    fb = torch.zeros(2, dtype=torch.int32, device=dev)

    def fallbacks(fn, *args, **kw):
        """Run one kernel call with the fallback counters; (result, rows
        that took the flat extraction, K4's rows read again by their
        keys)."""
        fb.zero_()
        out = fn(*args, fallbacks=fb, **kw)
        flat, again = fb.tolist()
        return out, flat, again

    def same_topk(a, b):
        return (torch.equal(a[1], b[1])
                and torch.equal(torch.isnan(a[0]), torch.isnan(b[0]))
                and torch.equal(torch.nan_to_num(a[0]),
                                torch.nan_to_num(b[0])))

    def beam_rows(rows):
        # stage 1's unfused input: log-softmax of 3 randn logits plus a
        # score, 15 of every 16 rows -inf (step 0)
        lg = 3 * torch.randn(rows, V, device=dev, generator=g)
        lp = (lg - torch.logsumexp(lg, dim=1, keepdim=True)
              - 20 * torch.rand(rows, 1, device=dev, generator=g))
        lp.view(rows // 16, 16, V)[:, 1:] = float("-inf")
        return lp

    def lane0_cols(rows):
        # k columns that thread 0 of a row streams (float4 t + j * 32W)
        W = topk_k.plan(rows, V, k)["warps_per_row"]
        return [4 * (j * 32 * W) + i for j in range(5) for i in range(4)][:k]

    plans = {rows: topk_k.plan(rows, V, k) for rows in (R, R32)}
    for rows, p in plans.items():
        print(f"  K3/K4 plan at [{rows}, {V}] k={k}: {p}", flush=True)
    fails.check(plans[R]["warps_per_row"] == 1
                and plans[R32]["warps_per_row"] == 4,
                "K3/K4 plan: one warp a row at R=2048, four at R=512")
    fb_counts = {}
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
    # the same planted rows at B=32's R, and rows past what a block's
    # shared memory could hold (V = 70000)
    fails.check(same_topk(topk_k.top_k(x[:R32].contiguous(), k),
                          topk_k.top_k_plain(x[:R32], k)),
                f"K3 top-k [{R32},{V}] k={k} exact (planted rows)")
    wide = torch.randn(64, 70000, device=dev, generator=g).round()
    wide[0, 35000] = float("nan")
    wide[1] = float("-inf")
    fails.check(same_topk(topk_k.top_k(wide, k),
                          topk_k.top_k_plain(wide, k)),
                f"K3 top-k [64,70000] k={k} exact")
    del wide
    for rows in (R, R32):
        for kind, xs in (("beam-like", beam_rows(rows)),
                         ("randn", torch.randn(rows, V, device=dev,
                                               generator=g))):
            got, n, _ = fallbacks(topk_k.top_k, xs, k)
            fb_counts[f"K3 {kind} [{rows},{V}]"] = n
            fails.check(same_topk(got, topk_k.top_k_plain(xs, k)),
                        f"K3 {kind} [{rows},{V}] k={k}: exact, {n} of "
                        f"{rows} rows fell back")
        xs = torch.randn(rows, V, device=dev, generator=g)
        cols = lane0_cols(rows)
        xs[:, cols] = 10 + torch.rand(rows, k, device=dev, generator=g)
        xs[1, cols] = 10.0
        got, n, _ = fallbacks(topk_k.top_k, xs, k)
        fb_counts[f"K3 adversarial [{rows},{V}]"] = n
        fails.check(same_topk(got, topk_k.top_k_plain(xs, k)) and n == rows,
                    f"K3 adversarial [{rows},{V}] (all {k} winners in one "
                    f"lane): exact, {n} of {rows} rows fell back")
    # device times (CUDA graphs) on randn rows, cycling through inputs that
    # together overflow the L2 (each call reads its rows from HBM); ms_l2
    # repeats one input; ms_eager is an eager loop, the wrapper's host cost
    # included
    xr = cold_cycle(lambda: torch.randn(R, V, device=dev, generator=g),
                    4 * R * V)
    xr32 = cold_cycle(lambda: torch.randn(R32, V, device=dev, generator=g),
                      4 * R32 * V)
    bound, by = _bound_ms(4 * R * V + 8 * R * k, R * V)
    bound32, _ = _bound_ms(4 * R32 * V + 8 * R32 * k, R32 * V)
    x1 = xr()
    kernels["topk"] = dict(
        name="K3 exact top-k", route="cuda",
        source="chinese_asr_tpu_torch/csrc/topk.cu",
        replaces="chinese_asr_tpu/ops/pallas/topk.py:277",
        max_abs_err=0.0 if (same_nan and same_v) else float("nan"),
        ms=graph_ms(lambda: topk_k.top_k(xr(), k)),
        plain_ms=_time_ms(torch, lambda: topk_k.top_k_plain(xr(), k), 20),
        bound_ms=bound, bound_by=by,
        library_ms=graph_ms(lambda: torch.topk(xr(), k, dim=1)),
        ms_l2=graph_ms(lambda: topk_k.top_k(x1, k)),
        ms_eager=_time_ms(torch, lambda: topk_k.top_k(xr(), k), 50),
        ms_r512=graph_ms(lambda: topk_k.top_k(xr32(), k)),
        bound_ms_r512=bound32,
        library_ms_r512=graph_ms(lambda: torch.topk(xr32(), k, dim=1)),
        warps_per_row=plans[R]["warps_per_row"],
        warps_per_row_r512=plans[R32]["warps_per_row"],
        shape=f"[{R}, {V}] k={k}; *_r512 at [{R32}, {V}]")
    # the LM first pass's proposal: k = topn = 20 over the decoder's logits
    # at B*bw rows (2048 at B=128, 512 at B=32)
    k20 = 20
    for rows in (R, R32):
        W = topk_k.plan(rows, V, k20)["warps_per_row"]
        lg = 3 * torch.randn(rows, V, device=dev, generator=g)
        got, n, _ = fallbacks(topk_k.top_k, lg, k20)
        fb_counts[f"K3 k={k20} logits [{rows},{V}]"] = n
        fails.check(same_topk(got, topk_k.top_k_plain(lg, k20)),
                    f"K3 k={k20} logits [{rows},{V}]: exact, {n} of {rows} "
                    f"rows fell back")
        tied = torch.randn(rows, V, device=dev, generator=g).round()
        tied[0] = 2.0                                  # one value, all V
        tied[1, ::7] = 5.0                             # 715-way tie on top
        tied[2, :] = float("-inf")
        fails.check(same_topk(topk_k.top_k(tied, k20),
                              topk_k.top_k_plain(tied, k20)),
                    f"K3 k={k20} tied rows [{rows},{V}]: exact")
        adv = torch.randn(rows, V, device=dev, generator=g)
        cols = [4 * (j * 32 * W) + i for j in range(5) for i in range(4)]
        adv[:, cols] = 10 + torch.rand(rows, k20, device=dev, generator=g)
        got, n, _ = fallbacks(topk_k.top_k, adv, k20)
        fb_counts[f"K3 k={k20} adversarial [{rows},{V}]"] = n
        fails.check(same_topk(got, topk_k.top_k_plain(adv, k20)) and n == rows,
                    f"K3 k={k20} adversarial [{rows},{V}]: exact, {n} of "
                    f"{rows} rows fell back")
        del lg, tied, adv
    xr = cold_cycle(lambda: 3 * torch.randn(R, V, device=dev, generator=g),
                    4 * R * V)
    xr32 = cold_cycle(lambda: 3 * torch.randn(R32, V, device=dev, generator=g),
                      4 * R32 * V)
    b20, _ = _bound_ms(4 * R * V + 8 * R * k20, R * V)
    b20_32, _ = _bound_ms(4 * R32 * V + 8 * R32 * k20, R32 * V)
    k3_20 = dict(
        ms=graph_ms(lambda: topk_k.top_k(xr(), k20)),
        bound_ms=b20,
        plain_ms=_time_ms(torch, lambda: topk_k.top_k_plain(xr(), k20), 20),
        library_ms=graph_ms(lambda: torch.topk(xr(), k20, dim=1)),
        ms_r512=graph_ms(lambda: topk_k.top_k(xr32(), k20)),
        bound_ms_r512=b20_32,
        plain_ms_r512=_time_ms(torch,
                               lambda: topk_k.top_k_plain(xr32(), k20), 20),
        library_ms_r512=graph_ms(lambda: torch.topk(xr32(), k20, dim=1)),
        warps_per_row=topk_k.plan(R, V, k20)["warps_per_row"],
        warps_per_row_r512=topk_k.plan(R32, V, k20)["warps_per_row"])
    kernels["topk"]["k20"] = k3_20
    print(f"  K3 k={k20} (the first pass's proposal): [{R},{V}] "
          f"{k3_20['ms']:.4f} ms (bound {b20:.4f} ms, HBM; torch.topk "
          f"{k3_20['library_ms']:.4f}); [{R32},{V}] {k3_20['ms_r512']:.4f} ms "
          f"(bound {b20_32:.4f}; torch.topk {k3_20['library_ms_r512']:.4f})",
          flush=True)
    del x, xr, xr32, x1, small

    # ---- phase 2d: K4 fused logp + top-k ------------------------------------
    temp = Config().decoder.temperature
    err4 = 0.0
    for rows in (R, R32):
        logit = 3 * torch.randn(rows, V, device=dev, generator=g)
        # beam scores; step 0 disables beams kk > 0 of each group of 16
        bias = -20 * torch.rand(rows, 1, device=dev, generator=g)
        bias.view(rows // 16, 16)[:, 1:] = float("-inf")
        logit[32, 100] = float("nan")              # poisons row 32's lse
        logit[33, 7] = float("nan")                # ...but row 33 is -inf
        bias_t = -20 * torch.rand(rows, 1, device=dev, generator=g)
        for step, bb in (("step 0", bias), ("step > 0", bias_t)):
            (vk, ik), n, again = fallbacks(topk_k.top_k_fused, logit, bb, k,
                                           temp)
            fb_counts[f"K4 beam-like {step} [{rows},{V}]"] = [n, again]
            vp, ip = topk_k.top_k_fused_plain(logit, bb, k + 1, temp)
            exact = (bb[:, 0] == float("-inf")) | torch.isnan(logit).any(dim=1)
            sep = exact | (vp[:, :-1] - vp[:, 1:] > TOL_FUSED).all(dim=1)
            vp, ip = vp[:, :k], ip[:, :k]
            same_special = (torch.equal(torch.isnan(vk), torch.isnan(vp))
                            and torch.equal(torch.isinf(vk), torch.isinf(vp)))
            fin = torch.isfinite(vp)
            err = float((vk[fin] - vp[fin]).abs().max())
            err4 = max(err4, err)
            fails.check(same_special and err <= TOL_FUSED
                        and torch.equal(ik[sep], ip[sep])
                        and torch.equal(vk[exact].nan_to_num(),
                                        vp[exact].nan_to_num()),
                        f"K4 fused top-k [{rows},{V}] k={k} T={temp} ({step}):"
                        f" values within {err:.3g} <= {TOL_FUSED}, indices "
                        f"equal on {int(sep.sum())} of {rows} separated or "
                        f"exact rows; {n} rows fell back, {again} read "
                        f"again")
            if step == "step 0":
                fails.check(bool(torch.isnan(vk[32]).all())
                            and bool((vk[33] == float("-inf")).all())
                            and ik[33].tolist() == list(range(k)),
                            "K4: a NaN logit makes its row NaN; a -inf bias "
                            "wins over it")
        # all 17 winners in one lane's columns: the flat extraction
        adv = 3 * torch.randn(rows, V, device=dev, generator=g)
        adv[:, lane0_cols(rows)] = 30 + torch.rand(rows, k, device=dev,
                                                   generator=g)
        (vk, ik), n, again = fallbacks(topk_k.top_k_fused, adv, bias_t, k,
                                       temp)
        fb_counts[f"K4 adversarial [{rows},{V}]"] = [n, again]
        vp, ip = topk_k.top_k_fused_plain(adv, bias_t, k + 1, temp)
        sep = (vp[:, :-1] - vp[:, 1:] > TOL_FUSED).all(dim=1)
        err = float((vk - vp[:, :k]).abs().max())
        err4 = max(err4, err)
        fails.check(n == rows and again == rows and err <= TOL_FUSED
                    and torch.equal(ik[sep], ip[sep, :k]),
                    f"K4 adversarial [{rows},{V}]: {again} of {rows} rows "
                    f"read again, {n} fell back, values within {err:.3g}, "
                    f"indices equal on {int(sep.sum())} separated rows")
        # lse exactly 0 (one logit 0, the rest <= -200) under a bias of
        # 1e4: key = fl(x + 1e4) ties many x; the lower column must win
        eq = -201 + torch.rand(rows, V, device=dev, generator=g)
        eq[:, 1234] = 0.0
        big = torch.full((rows, 1), 1e4, device=dev)
        (vk, ik), n, again = fallbacks(topk_k.top_k_fused, eq, big, k, temp)
        fb_counts[f"K4 equal keys [{rows},{V}]"] = [n, again]
        vp, ip = topk_k.top_k_fused_plain(eq, big, k, temp)
        fails.check(torch.equal(vk, vp) and torch.equal(ik, ip),
                    f"K4 equal keys [{rows},{V}] (~{len(torch.unique(vp[0]))} "
                    f"distinct keys in a row's top {k}): exact, {n} rows fell "
                    f"back, {again} read again")
        del adv, eq, big
    # rows past what a block's shared memory could hold
    wide = 3 * torch.randn(64, 70000, device=dev, generator=g)
    wb = -20 * torch.rand(64, 1, device=dev, generator=g)
    vk, ik = topk_k.top_k_fused(wide, wb, k, temp)
    vp, ip = topk_k.top_k_fused_plain(wide, wb, k + 1, temp)
    sep = (vp[:, :-1] - vp[:, 1:] > TOL_FUSED).all(dim=1)
    err = float((vk - vp[:, :k]).abs().max())
    err4 = max(err4, err)
    fails.check(err <= TOL_FUSED and torch.equal(ik[sep], ip[sep, :k]),
                f"K4 fused top-k [64,70000] k={k}: values within {err:.3g}, "
                f"indices equal on {int(sep.sum())} separated rows")
    print("  fallback rows per set: " + json.dumps(fb_counts), flush=True)
    del logit, bias, bias_t, wide, wb

    def unfused(lg, b):
        # the beam's stage 1 without K4: the logp transform, then K3
        lg = lg / temp
        lp = lg - torch.logsumexp(lg, dim=1, keepdim=True) + b
        return topk_k.top_k(lp, k)

    def library_fused(lg, b):
        lg = lg / temp
        return torch.topk(lg - torch.logsumexp(lg, dim=1, keepdim=True)
                          + b, k, dim=1)

    def fused_inputs(rows):
        return (3 * torch.randn(rows, V, device=dev, generator=g),
                -20 * torch.rand(rows, 1, device=dev, generator=g))

    # the function needs the logits read once, the bias read and the top-k
    # written; per element the divide, the max, the subtract, exp and add
    # of the logsumexp, the key's subtract and add, and one compare
    bound, by = _bound_ms(4 * (R * V + R) + 8 * R * k, 8 * R * V)
    bound32, _ = _bound_ms(4 * (R32 * V + R32) + 8 * R32 * k, 8 * R32 * V)
    lr = cold_cycle(lambda: fused_inputs(R), 4 * R * V)
    lr32 = cold_cycle(lambda: fused_inputs(R32), 4 * R32 * V)
    kernels["topk_fused"] = dict(
        name="K4 fused logp + top-k", route="cuda",
        source="chinese_asr_tpu_torch/csrc/topk.cu",
        replaces="chinese_asr_tpu/ops/pallas/topk.py:416",
        max_abs_err=err4,
        ms=graph_ms(lambda: topk_k.top_k_fused(*lr(), k, temp)),
        plain_ms=_time_ms(torch, lambda: topk_k.top_k_fused_plain(
            *lr(), k, temp), 20),
        bound_ms=bound, bound_by=by,
        library_ms=graph_ms(lambda: library_fused(*lr())),
        unfused_k3_ms=graph_ms(lambda: unfused(*lr())),
        ms_eager=_time_ms(torch, lambda: topk_k.top_k_fused(*lr(), k, temp),
                          50),
        ms_r512=graph_ms(lambda: topk_k.top_k_fused(*lr32(), k, temp)),
        bound_ms_r512=bound32,
        library_ms_r512=graph_ms(lambda: library_fused(*lr32())),
        unfused_k3_ms_r512=graph_ms(lambda: unfused(*lr32())),
        fallback_rows=fb_counts,
        shape=f"logit [{R}, {V}], bias [{R}, 1] k={k}; *_r512 at [{R32}, "
              f"{V}]")
    del lr, lr32

    # warps per row: K3 and K4 at W = 1 and 4 on both sides of plan()'s
    # switch, each capture made with plan()'s choice set to that W
    def graph_ms_at(W, fn):
        plan = topk_k.plan
        topk_k.plan = lambda *a: {**plan(*a), "warps_per_row": W}
        try:
            return graph_ms(fn)
        finally:
            topk_k.plan = plan

    for rows in (R32, topk_k.ONE_WARP_ROWS, R):
        xs = cold_cycle(lambda: torch.randn(rows, V, device=dev, generator=g),
                        4 * rows * V)
        ls = cold_cycle(lambda: fused_inputs(rows), 4 * rows * V)
        for name, fn in (("topk", lambda: topk_k.top_k(xs(), k)),
                         ("topk_fused",
                          lambda: topk_k.top_k_fused(*ls(), k, temp))):
            ms = {W: graph_ms_at(W, fn) for W in (1, 4)}
            kernels[name].setdefault("ms_by_warps_per_row", {})[rows] = ms
            print(f"  {name} [{rows},{V}] ms at 1 / 4 warps a row: "
                  f"{ms[1]:.4f} / {ms[4]:.4f} (plan: "
                  f"{topk_k.plan(rows, V, k)['warps_per_row']})", flush=True)
        del xs, ls

    # ---- phase 3: main path --------------------------------------------------
    cfg = Config()
    wavs = _synthetic_wavs(np, rng, 32, 9.0, 10.0)
    # bench.py's headline shape (B=128), timed beside the 32-wav main path
    wavs128 = wavs + _synthetic_wavs(np, rng, 96, 9.0, 10.0)
    # each kernel's launch counter (module, attribute)
    counters = {"logmel": (logmel_k, "launches"),
                "lstm": (lstm_k, "launches"),
                "topk": (topk_k, "launches"),
                "topk_fused": (topk_k, "fused_launches")}
    # the LMs of the second pass, over the identity vocab's words: an
    # order 3, and an order 5 with the entries per level of the reference's
    # pruned 5-gram class (5k/500k/1M/1M/500k, zh_giga...prune01244.klm)
    ivocab = _identity_vocab(cfg.vocab.vocab_size)
    lm_words = [ivocab.int2word[i] for i in range(len(ivocab.int2word))]
    lm_asrs, lm_tops, lm_build = {}, {}, {}
    for lm_order, counts in ((3, (200_000, 400_000)),
                             (5, (500_000, 1_000_000, 1_000_000, 500_000))):
        arpa = os.path.join(build.BUILD_DIR, f"synthetic_o{lm_order}_seed0.arpa")
        ta = time.time()
        n_per, lm_tops[lm_order] = _synthetic_arpa(np, arpa, lm_words, counts,
                                                   seed=0)
        tb = time.time()
        # the tables as the reference builds them: the C++ reader's
        # enumeration, hashed keys (DeviceNgramLM.from_path)
        a = ASR(bw=16, cfg=cfg, seed=0, lm_path=arpa, lm_mode="second")
        tc = time.time()
        lm_bytes = sum(t.numel() * t.element_size()
                       for t in (*a.dlm.tbls, a.dlm.uni))
        fails.check(a.dlm.order == lm_order and a.dlm.hashed
                    and a.dlm.host_lm._py is None
                    and all(t.device.type == "cuda" for t in a.dlm.tbls),
                    f"order-{lm_order} LM: hashed tables on the card, built "
                    f"through the C++ reader")
        lm_build[lm_order] = dict(ngrams=n_per, write_s=tb - ta,
                                  cpp_parse_build_s=tc - tb,
                                  table_mib=lm_bytes / 2**20)
        print(f"LM: order {lm_order}, n-grams per order {n_per}; ARPA written "
              f"in {tb - ta:.2f} s, read by the C++ reader and built in "
              f"{tc - tb:.2f} s; tables {lm_bytes / 2**20:.1f} MiB on the "
              f"card, probes {a.dlm.probes}, widths "
              f"{[tuple(t.shape) for t in a.dlm.tbls]}", flush=True)
        if lm_order == 3:
            # the LM-driven first pass over the same file, and the tuple
            # layout's pure-Python parse for comparison (not kept)
            lm_asrs["first"] = ASR(bw=16, cfg=cfg, seed=0, lm_path=arpa,
                                   lm_mode="first")
            td = time.time()
            DeviceNgramLM.from_arpa(arpa, dev)
            lm_build[3]["python_parse_build_s"] = time.time() - td
            print(f"  order 3 through the pure-Python parse (tuple layout): "
                  f"{lm_build[3]['python_parse_build_s']:.2f} s", flush=True)
            torch.cuda.empty_cache()
        os.remove(arpa)
        lm_asrs[lm_order] = a

    runs_spec = (  # mode, ASR, batch, fused stage 1, kernels that must run
        ("beam_bw16", ASR(bw=16, cfg=cfg, seed=0), wavs, False,  # cuda
         ("logmel", "lstm", "topk")),
        ("greedy", ASR(bw=None, cfg=cfg, seed=0), wavs, False,
         ("logmel", "lstm")),
        ("beam_bw16_b128", ASR(bw=16, cfg=cfg, seed=0), wavs128, False,
         ("logmel", "lstm", "topk")),
        ("beam_bw16_lm2", lm_asrs[3], wavs, False,
         ("logmel", "lstm", "topk")),
        ("beam_bw16_lm2_fused", lm_asrs[3], wavs, True,
         ("logmel", "lstm", "topk_fused")),
        ("beam_bw16_lm2_o5", lm_asrs[5], wavs, False,
         ("logmel", "lstm", "topk")),
        ("beam_bw16_lm1", lm_asrs["first"], wavs, False,
         ("logmel", "lstm", "topk")))
    # the run each kernel's launch count is read from: K1-K3 the main
    # path's, K4 the fused LM path's
    launches_from = {"logmel": "beam_bw16", "lstm": "beam_bw16",
                     "topk": "beam_bw16", "topk_fused": "beam_bw16_lm2_fused"}
    paths, texts_of = {}, {}
    for mode, asr, batch, fused, need in runs_spec:
        os.environ["CHINESE_ASR_PALLAS_FUSED"] = "1" if fused else "0"
        audio_s = sum(len(w) for w in batch) / cfg.audio.sample_rate
        runs = []
        for rep in range(2):
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts = asr.transcribe_wavs(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            runs.append((texts, wall, {n: getattr(mod, attr) for n, (mod, attr)
                                       in counters.items()}))
        (t1, w1, c1), (t2, w2, c2) = runs
        texts_of[mode] = t1
        fails.check(all(c1[n] > 0 for n in need)
                    and all(c1[n] == 0 for n in ("topk", "topk_fused")
                            if n not in need),
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
        for n in kernels:
            if launches_from[n] == mode:
                kernels[n]["launches"] = c1[n]
    kernels["topk"]["launches_lm1"] = paths["beam_bw16_lm1"]["launches"]["topk"]
    print(f"beam_bw16_lm1: K3 launched {kernels['topk']['launches_lm1']} times "
          f"per batch (k=20 proposals), K4 "
          f"{paths['beam_bw16_lm1']['launches']['topk_fused']}", flush=True)
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "0"
    differ = sum(a != b for a, b in zip(texts_of["beam_bw16_lm2"],
                                        texts_of["beam_bw16_lm2_fused"]))
    print(f"beam_bw16_lm2 vs beam_bw16_lm2_fused: {differ} of {len(wavs)} "
          f"transcripts differ (report only: the fused logsumexp is summed "
          f"in another order, which can flip near-tied survivors)",
          flush=True)
    paths["lm1_vs_host_oracle"] = _first_pass_vs_host(
        torch, lm_asrs["first"], wavs, texts_of["beam_bw16_lm1"])
    print(f"beam_bw16_lm1 vs the host-loop oracle (lm_first_pass, the C++ "
          f"LM, f64 sums; report only): "
          f"{json.dumps(paths['lm1_vs_host_oracle'])}", flush=True)
    paths["fused_flips_b128"] = _fused_flips(
        torch, next(a for m, a, *_ in runs_spec if m == "beam_bw16_b128"),
        wavs128, beam_mod)
    print(f"beam_bw16_b128, stage 1 fused vs unfused (report only): "
          f"{json.dumps(paths['fused_flips_b128'])}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    for mode, asr, batch, fused, _ in runs_spec:
        if mode == "greedy":
            continue
        os.environ["CHINESE_ASR_PALLAS_FUSED"] = "1" if fused else "0"
        _profile_main_path(torch, asr, batch, mode,
                           paths[mode]["wall_s"] * 1e3)
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "0"

    # LM probes on the card against the same tables on the CPU: the gathers
    # and the backoff sums run in the same order, so they must be equal
    qrng = np.random.default_rng(5)
    Q = 1 << 16
    for lm_order, top in lm_tops.items():
        dlm = lm_asrs[lm_order].dlm
        cpu_lm = dlm.to("cpu")
        nw, M1 = len(lm_words), lm_order - 1
        # word indices into lm_words -> the LM's ids (the C++ reader's);
        # index -1 picks the appended -1, an absent word
        wid = np.append(dlm.word_ids(lm_words).astype(np.int64), -1)
        rows = top[qrng.integers(0, len(top), Q)]      # top-order contexts
        ctx = rows[:, :-1].copy()
        short = (qrng.random(Q) < 0.1)[:, None] \
            & (np.arange(M1)[None, :] < qrng.integers(1, M1 + 1, Q)[:, None])
        ctx[short] = -1                                # shorter histories
        ctx[Q // 2:] = qrng.integers(0, nw, (Q - Q // 2, M1))   # random
        ctx[Q // 2:, 0] = qrng.integers(-1, nw, Q - Q // 2)
        cand = np.concatenate([rows[:, -1:], qrng.integers(0, nw, (Q, 3))],
                              axis=1)
        ctx_t = torch.from_numpy(wid[ctx])
        cand_t = torch.from_numpy(wid[cand])
        on_card = dev_ngram.score_candidates(dlm, ctx_t.to(dev),
                                             cand_t.to(dev))
        on_cpu = dev_ngram.score_candidates(cpu_lm, ctx_t, cand_t)
        fails.check(torch.equal(on_card.cpu(), on_cpu),
                    f"order-{lm_order} LM probes (hashed layout) card == CPU "
                    f"on {Q}x4 (context, word) pairs")
        # kenlm's hash chain in wrapping int64 products on the card, over
        # every top-order n-gram, against the keys the C++ reader stores
        ids = torch.from_numpy(wid[top]).to(dev)
        h = ids[:, -1]
        for j in range(lm_order - 2, -1, -1):
            h = dev_ngram._combine_word_hash(h, ids[:, j])
        hi, lo, _, _ = dlm.host_lm.dump_order(lm_order)
        want = np.sort((hi.astype(np.uint64) << np.uint64(32))
                       | lo.astype(np.uint64))
        got = np.sort(h.cpu().numpy().view(np.uint64))
        fails.check(np.array_equal(got, want),
                    f"order-{lm_order}: the hash chain on the card equals "
                    f"the C++ reader's keys of all {len(top)} "
                    f"{lm_order}-grams")
        del cpu_lm
    del lm_asrs, runs_spec

    # ---- phase 3b: card vs plain CPU path on a small input -------------------
    small_wavs = _synthetic_wavs(np, rng, 4, 1.0, 2.0)
    cards = {d: ASR(bw=16, cfg=cfg, seed=0, device=d) for d in ("cuda", "cpu")}
    prep = cards["cpu"]._prep(small_wavs, None)
    out = {}
    for d, a in cards.items():
        feats, flens = a._featurize(a._upload(prep))
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
    for lm_mode in ("second", "second_host"):
        asr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
                  vocab=gvocab, bw=4, lm_path=os.path.join(gold, "lm.arpa"),
                  lm_mode=lm_mode)
        fails.check(asr.dlm.hashed if lm_mode == "second"
                    else asr.lm._py is None,
                    f"golden lm_{lm_mode}: " + (
                        "hashed tables" if lm_mode == "second"
                        else "the C++ NgramLM scores"))
        for fused in ("0", "1"):
            os.environ["CHINESE_ASR_PALLAS_FUSED"] = fused
            fails.check(asr.transcribe_files(gpaths)
                        == expected["lm_" + lm_mode],
                        f"golden shard lm_{lm_mode} (fused stage 1: {fused}) "
                        f"on the card matches expected.json")
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "0"
    asr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
              vocab=gvocab, bw=4, lm_path=os.path.join(gold, "lm.arpa"),
              lm_mode="first", lm_topn=8)
    before = (topk_k.launches, topk_k.fused_launches)
    fails.check(asr.transcribe_files(gpaths) == expected["lm_first"]
                and topk_k.launches > before[0]
                and topk_k.fused_launches == before[1],
                "golden shard lm_first (bw 4, topn 8, K3 proposals) on the "
                "card matches expected.json")
    # a KenLM binary: the probing fixture and the ARPA text it was built
    # from give the same transcripts through both device LM modes, with a
    # vocab whose first two characters are the LM's words a and b
    klm = os.path.join(os.path.dirname(gold), "data", "golden_tri_probing.klm")
    tri = os.path.join(build.BUILD_DIR, "golden_tri.arpa")
    with open(tri, "w", encoding="utf-8") as f:
        f.write(ARPA_TRI)
    from chinese_asr_tpu_torch.lm.ngram import NgramLM
    rebuilt = os.path.join(build.BUILD_DIR, "golden_tri_probing.klm")
    NgramLM(tri).write_binary(rebuilt, layout="probing")
    with open(rebuilt, "rb") as f, open(klm, "rb") as g:
        fails.check(f.read() == g.read(), "the .klm fixture is the probing "
                                          "binary of its ARPA text")
    w2i = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5,
           **{c: 6 + i for i, c in enumerate("是不了人我在")}}
    abvocab = Vocab(w2i, {i: w for w, i in w2i.items()})
    for lm_mode, topn in (("second", 20), ("first", 8)):
        texts = {}
        for name, path in (("klm", klm), ("arpa", tri)):
            asr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
                      vocab=abvocab, bw=4, lm_path=path, lm_mode=lm_mode,
                      lm_topn=topn)
            texts[name] = (asr.dlm.hashed, asr.transcribe_files(gpaths))
        fails.check(texts["klm"] == texts["arpa"] and texts["klm"][0],
                    f"golden_tri_probing.klm through lm_mode={lm_mode!r} on "
                    f"the card (hashed tables) gives its ARPA's transcripts "
                    f"{texts['klm'][1]}")
    os.remove(tri)
    os.remove(rebuilt)


    # ---- phase 3d: the HTTP server at full width ----------------------------
    t3d = time.time()
    golden = (gold, gcfg, gvocab, gpaths, expected)
    paths["serving"] = _phase_serving(np, torch, fails, ASR, cfg, wavs,
                                      counters, gpu, golden)
    print(f"phase 3d: {time.time() - t3d:.1f} s", flush=True)

    # ---- phase 3e: the other entry points on the card -----------------------
    t3e = time.time()
    paths.update(_phase_entry_points(np, torch, fails, ASR, cfg, wavs,
                                     wavs128, rng, counters, gpu, golden,
                                     build.BUILD_DIR))
    print(f"phase 3e: {time.time() - t3e:.1f} s", flush=True)

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
