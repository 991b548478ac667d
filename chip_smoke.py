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
   [512, 5004] (the stage-1 rows at B=128 and B=32) and [256, 5004] (a
   data rank's rows on phase 4b's mesh) with planted ties,
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
2b-bf16. hold K2-bf16 (bf16's own cluster plan: 16 rows a cluster of 8
   or 4 CTAs, h exchanged by bulk copies on mbarriers) against its bf16
   twin at the same shapes, B=32 and H=16, and with random non-prefix
   masks at B=32 and B=128, with its cluster plan (one wave at B=128),
   its registers and spills, and cuDNN's bf16 layer beside it; build
   ``tools/lstm_stamp.py``'s stamped library (beside phase 1's build) and
   print the phase split of a step of K2-bf16 and K2-bwd-bf16 at B=32
   and B=128 beside the parent design's (recorded);
2f. hold K2-bwd, the recurrence's backward, against its twin at the
   flagship layer's shape (xg 2 x [332, 32, 1024], the cluster kernel), at
   B=128 and at H=16 (the simple kernel), with random non-prefix masks and
   nonzero final-state cotangents; print its plan and time it beside its
   bound, its twin and cuDNN's backward of one bidirectional layer at B=32
   and B=128;
2f-bf16. hold K2-bwd-bf16, K2-bwd's bf16 instance (bf16 training: pass 1
   as three stages, pass 2 a cluster kernel of bf16's own plan), against
   its bf16 twin at the same shapes and each stage kernel against its
   plain stage, with its plan, its registers and spills, its time beside
   its bound, its twin, phase 2f's f32 K2-bwd and cuDNN's bf16 backward
   of one bidirectional layer at B=32 and B=128, each stage's time, and
   pass 2's phase split beside the parent design's (recorded);
2g. hold K6, the beam's attention read, against its twin at the offline
   cells' shapes (B=128, k=16, a=128, L = 100, 166 and 433 frames; f32
   and bf16; ragged rows and one masked everywhere) and time it (CUDA
   graphs of 20 calls) beside its twin and its bound (its tanhf's
   special-function operations at the SMs' rate);
2h. hold K7, the 3xTF32 GEMM, against the float64 product at the
   Conformer's FFN shape ([128 x 317, 512] x [512, 2048]) and the
   subsampling's K = 9728 (one row slice, [21 x 317, 9728] x [9728, 512]),
   within 4x of cuBLAS's float32 error, and at the beam decode step's three
   ([2048, 1024] x [1024, 5004] with its bias, the LSTM gates' [2048, 768]
   x [768, 2048] with theirs and [2048, 512] x [512, 2048]), no farther
   than cuBLAS's, and at the E-Branchformer's four that the Conformer
   lacks ([M, 512] x [512, 3072], [M, 1536] x [1536, 512], [M, 1024] x
   [1024, 512], [M, 512] x [512, 1024], each with its bias) no farther
   than cuBLAS's at each chunk's M of its cell (128 x 317 and 128 x 73 to
   128 x 173), one launch a call, and time it (CUDA graphs of 10 calls;
   not the shorter chunks) beside cuBLAS's float32 product (the decode's
   and the E-Branchformer's: ``x @ w (+ b)``, as the decoder ran it
   before K7), its twin and its bound (3 TF32 passes at the tensor cores'
   rate, or its bytes);
2i. hold K8, the subsampling's two convolutions, at the offline cells'
   longest and shortest chunk (128 rows, 316 and 72 frames out, 80
   log-mels, C = 512): one launch, exact under a CUDA graph's replay,
   within 1e-4 of its twin, against the float64 convolutions of |x|,
   |w| and |b| no farther than cuDNN's float32 pair (TF32 off); time it
   (CUDA graphs) beside that pair with its ReLUs and the flatten's copy,
   its twin and its bound;
2e. hold K5, the ADPCM wire decode, against its twin bit for bit on the
   B=32 batch's wire, a B=1 wire, a full-scale square wave and silence,
   and time it beside the C++ host encoder;
3. drive the main path: ``ASR(bw=16).transcribe_wavs`` at the flagship
   ``Config()`` with seeded random weights on 32 synthetic 9-10 s int16
   wavs over the flat wire (one device: the decode through the ``*_jit``
   forms, CUDA graphs captured at the first call, which is timed apart;
   the counted runs replay them), then greedy on the same batch, then the LM
   second pass (``lm_path=``, ``lm_mode="second"``) over a synthetic
   order-3 ARPA written from seed 0, once through K3 and once with the
   fused stage 1 (K4, ``CHINESE_ASR_PALLAS_FUSED=1``), and over a
   synthetic order-5 ARPA at the reference's pruned 5-gram size through
   K3, then the LM-driven first pass (``lm_mode="first"``, topn 20) over
   the order-3 ARPA, then bf16 inference (``compute_dtype="bfloat16"``)
   at B=32 and B=128 and the mu-law and ADPCM wires at B=32 (their wire
   bytes, host preparation and host-to-device copy times printed), then
   the offline cells' two attention encoders, Conformer (L) and
   E-Branchformer (L) at their configuration files' widths
   (``ENCODER_RUNS``), at B=128 (one chunk: K8 once, K7 137 or 154 times
   in the encoder and 120 in the decode); every
   LM's tables are hashed, built through the C++
   reader (the parse and build times are printed, and the order-3 one
   through the pure-Python parse beside it); checking that
   every kernel of each path launched (and K4 on no path but the fused
   one), that two runs agree exactly, that the card's output matches the
   plain CPU path on a small input, that the LM probes on the card equal
   those on the CPU, and that the golden shard (tests/golden) reproduces
   its expected transcripts in every mode (``lm_first`` included), and a
   ``.klm`` fixture gives its ARPA's transcripts through both device LM
   modes, and that bf16, mu-law and ADPCM give the CPU port's golden
   transcripts (greedy and beam; bf16 also with cuBLAS's reduced-precision
   bf16 reductions off, report only); each wall time is the median of
   warm runs (phase 3g profiles each run); the B=128 batch is also
   decoded with the fused and the unfused
   stage 1, and the first pass's batch by its host-loop oracle, counting
   what differs (report only);
3g. every phase-3 run and the golden shard's five modes (f32 and bf16)
   through the graph path (``ASR``'s: the front end's graph, then the
   decode's one graph, its stop test on the card) and through the eager
   functions called by name (front end and decode): identical transcripts (and expected.json in f32), the
   walls in turns graph / eager (7 each, median [min, max]), launch
   calls, graph launches, kernels, busy share and host syncs a batch
   (profiler; the eager LM runs traced on the card alone) with the graph
   path's largest kernels, the eager loop with one stop-flag read beside
   it for
   ``beam_bw16`` and ``greedy``; each captured program's capture ms and
   reserved MB, and a B=1 request's first call against its steady
   p50/p99;
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
   overlap reported); time JAX's dispatch-ahead order
   (``_decode_dispatch``, the next batch prepared, then
   ``_decode_finalize``) against the serial one in turns, equal
   transcripts, on that call and in a sustained B=128 loop in bench.py's
   ``_time_pipelined`` order (flat f32, bf16, ADPCM; walls a batch and
   the profiler's busy share); ``transcribe_long`` on a 60 s wav,
   ``transcribe_bytes`` against ``transcribe_files``, and
   ``evaluate_manifest`` on the golden shard in all five modes (card
   against CPU); report ``evaluate_manifest`` at flagship width;
3f. run every other config the port takes at full width: each
   ``encoder_type`` but LSTM, and on the LSTM encoder the unidirectional
   stack, the GRU decoder, Luong wiring and 4 heads with ``map_enc`` and
   ``linear_map`` (``FAMILY_RUNS``), each ``ASR(bw=16)`` on the B=32
   batch: the launches (K1 1, K3 40, K2 4 only on the bidirectional LSTM
   encoder, K6 40 with one attention head), two runs equal, the card's
   encoder and greedy tokens against the CPU port's on CPU features of 2
   wavs of 2 s; the median of 3 warm
   walls and one device-only profile (launches, busy share) each; then
   ``Trainer.fit`` of CNN1D_RNN (a BatchNorm front, a GRU stack) for 4
   steps of B=32 (graph replays, against the eager step as in phase 4)
   and its train step on the card against the CPU port;
4. train at the flagship ``Config()`` (ADAM, seeded random weights), in
   f32 and then in bf16 mixed precision (``compute_dtype="bfloat16"``):
   ``Trainer.fit`` for 6 steps of B=32 over 32 synthetic 9-10 s wavs with
   seeded 15-30-character transcripts written into ``_build/``, through
   the port's train loader and ``batches_to_device``, ending in one greedy
   eval (f32) and a checkpoint; the trainer steps through
   ``CompiledStep`` (one CUDA graph a (T, S) bucket, replayed) and
   evaluates through ``greedy_decode_jit``; check the launches (K1 1, K2
   4, K2-bwd 4 a step, in bf16 K2-bf16 4 and K2-bwd-bf16 4; the eval K1 1
   and K2 4; the first step and the first eval each once more, their
   eager warm-up), one capture for the 6 steps, that the loss is finite
   and falls, that the master params and the optimizer state stay
   float32, that three more evals replay the eval program with the eager
   greedy's CER; the graph step against the eager ``train_step`` in turns
   (7 walls each), their launch calls, kernels, busy share and host
   syncs, the card's trace of one replay against the K2 / K2-bwd
   counters, at most 20 launch calls a graph step; a fit over two
   buckets (the 9-10 s corpus and one of 4-5 s, in turns) against the
   same fit with the eager step, bit for bit, two captures in one pool;
   one step at the config's own batch of 256 (the pool's bytes); the
   first 12 keys an epoch of an AISHELL-1-sized corpus meets at B=256
   (``tools/step_memory.py``): one capture each, the static inputs
   shared, the pool within its byte budget; the golden model's train
   step on the card against the CPU port and the compiled step against
   the eager one bit for bit, in f32 and bf16; that the f32 checkpoint
   transcribes in ``ASR`` on the card, and the train CLI for 2 steps, f32
   and ``--bf16``; report for each ms per step (median of the warm
   steps), the forward / backward / optimizer split of an eager step by
   CUDA events, the step graphs' captures and pool bytes, and peak
   device memory;
4b. the mesh (``parallel/sharding.py``): (a) a one-rank NCCL group, mesh
   1 x 1: ``ASR(bw=16, mesh=make_mesh(cfg))`` on phase 3's batch equals
   ``ASR(bw=16)`` exactly, with K1 1, K2 4, K3 40 and K6 40 launches; (b)
   four ranks spawned from this script share the card over gloo as a 2 x 2
   mesh at the flagship ``Config()`` (V = 5004, 2502 a model rank; the
   library phase 1 built serves every rank): each runs beam bw 16 and
   greedy on the B=32 batch (16 rows a data rank) against phase 3's
   transcripts, the LM second and first passes over phase 3's order-3
   ARPA (tables built on every rank), the golden shard in all five modes
   against ``expected.json``, and three ``Trainer.fit`` steps at B=32 in
   f32 and bf16 against the single device's (f32 loss 1e-5 relative,
   params 2e-4 / 2e-5; bf16 loss 1e-2; masters float32); every rank's
   launches are checked (K1, K2, K3, K6; K2-bwd in f32 training, K2-bf16
   and K2-bwd-bf16 in bf16); the walls (median of 3 warm runs), the
   collectives and their bytes a batch or step are printed beside the
   card's line, as gloo-through-the-host figures on one shared card, and
   rows that differ from one device (random weights) with their score
   gaps to the runner-up;
5. print one ``{"kernels": [...]}`` line (with each kernel's launches on
   the mesh's rank 0) and, last, the ok line.

It imports nothing of JAX nor of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import threading
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
# K2-bf16: both it and its twin round y, h and c to bf16 at the end of each
#     step from f32 sums taken in other orders; a value within an f32
#     rounding of a bf16 rounding boundary lands one bf16 ulp apart (7.8e-3
#     for values in [1, 2)), and the recurrence carries it on; 3e-2 is the
#     margin, a layout bug errs by O(1).
# K5: integer decode, exact.
# K2-bwd: sums in other orders over 4H-term products and through the
#     reverse recurrence (f32 against f64 on the CPU twin: ~2e-7 of the
#     output's magnitude at the flagship shape); dW sums T*B terms, so the
#     error is taken relative to max(1, max |ref|) of each output; 1e-4 is
#     the margin, a layout bug errs by O(1).
# K2-bwd-bf16: kernel and twin both round the kept gates, the stored dxg_t,
#     the dh and dc carries and the rolled-forward c to bf16 from f32 sums
#     taken in other orders; a value within an f32 rounding of a bf16
#     boundary lands one bf16 ulp (2^-8 relative) apart and the reverse
#     recurrence carries it on; relative to max(1, max |ref|) of each
#     output, 3e-2 (K2-bf16's margin) is the bound, a layout bug errs by
#     O(1).
TOL_LOGMEL = 2e-3
TOL_LSTM = 1e-4
TOL_LSTM_BF16 = 3e-2
TOL_LSTM_BWD = 1e-4
TOL_LSTM_BWD_BF16 = 3e-2
TOL_FUSED = 1e-5
# card output vs the plain CPU path on a small input (same weights)
TOL_FEATS = 1e-3
TOL_ENC = 1e-3

TIMED_RUNS = 7                  # warm main-path runs behind each wall time

# phase 3's attention encoders: run name, the benchmark's configuration file
# (port_bench/configs/), its blocks counter and K7's products a block (the
# encoder adds one more, the subsampling's map)
ENCODER_RUNS = (("conformer_l_b128", "las_conformer_l_f32",
                 "conformer.blocks", 8),
                ("ebranchformer_l_b128", "las_ebranchformer_l_f32",
                 "e_branchformer.blocks", 9))
_CONFIG_SECTIONS = ("audio", "vocab", "encoder", "attention", "decoder",
                    "decode", "train")


def _cell_config(Config, name: str):
    """The program's ``Config`` of a benchmark configuration file, as the
    benchmark makes it (its sections, read as JSON)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "port_bench", "configs", name + ".json")
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    return Config.from_json(json.dumps({k: cfg[k] for k in _CONFIG_SECTIONS
                                        if k in cfg}))


def _encoder_need(cfg, blocks: str, per_block: int) -> dict:
    """The exact launches of one ``ASR(bw=16)`` chunk of an attention
    encoder: K1 once, K8 once, K7 ``per_block`` a block and the
    subsampling's map, then the decode's 40 steps (random weights never
    stop early): K3 and K6 once each, K7 three times (the output
    projection, the LSTM's two gate products)."""
    layers = cfg.encoder.num_layers
    return {"logmel.launches": 1, "subsample.launches": 1, blocks: layers,
            "topk.launches": 40, "attention.launches": 40,
            "gemm.launches": per_block * layers + 1 + 120}

# The phase split of K2-bf16's and K2-bwd-bf16's step before their bf16
# redesign (each the f32 design's bf16 instance), as recorded in PERF.md
# section 6 (chinese_asr_tpu_torch/tools/lstm_stamp.py on an H100 80GB HBM3
# at 700 W, us a step at [332, B, 256]); phases 2b-bf16 and 2f-bf16 print
# it beside this run's split of the design in the tree.
SPLIT_BEFORE = {
    "K2-bf16 B=32 (8 CTAs, 16 rows; 1.186 ms)":
        "products 0.307; partial sums, block barrier 0.097; gates' arrival "
        "0.099; cell update 0.667; remote stores 0.962; release-arrive, y "
        "stores, next fetch 1.344; cluster barrier wait 0.441",
    "K2-bf16 B=128 (8 CTAs, 32 rows; 1.532 ms)":
        "products 0.362; partial sums, block barrier 0.135; gates' arrival "
        "0.111; cell update 1.168; remote stores 0.851; release-arrive, y "
        "stores, next fetch 1.642; cluster barrier wait 0.094",
    "K2-bwd-bf16 B=32 (one kernel; 1.486 ms)":
        "pass 1 2.229 (products 0.795, cell and scratch 0.870, rebuild "
        "0.365); pass 2 2.295 (wait and sum 0.494, operands 0.165, cell "
        "0.314, block barrier 0.092, product 0.323, remote stores 0.177, "
        "release-arrive and next fetch 0.730)",
    "K2-bwd-bf16 B=128 (one kernel; 2.526 ms)":
        "pass 1 3.613 (products 1.149, cell and scratch 1.589, rebuild "
        "0.605); pass 2 3.319 (wait and sum 0.278, operands 0.222, cell "
        "0.513, block barrier 0.223, product 0.410, remote stores 0.209, "
        "release-arrive and next fetch 1.465)"}

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
H100_BF16_FLOPS = 989e12        # bf16 tensor cores, dense
# special-function results a second: 16 a clock an SM, 132 SMs, 1.98 GHz
H100_SFU_PER_S = 16 * 132 * 1.98e9
K6_LENGTHS = (100, 166, 433)    # encoder frames of the offline cells'
                                # shortest, a middle and the longest chunk


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


def _bound_ms(nbytes: float, ops: float, flops: float = H100_F32_FLOPS):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _phase_k6(np, torch, fails, dev, attn_k, graph_ms, gpu) -> dict:
    """Phase 2g: K6 against its twin at the offline cells' shapes (B=128,
    k=16, a=128, L in K6_LENGTHS; f32 and bf16; rows of unequal length,
    the last masked everywhere), timed as CUDA graphs of 20 calls beside
    its twin and its bound: each tanhf the rows need (k * a a frame
    within its row) as two special-function operations (ex2, rcp) at
    H100_SFU_PER_S, or its bytes (keys, q, v and the mask read once,
    align written once) at the HBM's rate."""
    B, k, a = 128, 16, 128
    by_shape = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for L in K6_LENGTHS:
            g = torch.Generator(device=dev).manual_seed(L)
            keys = torch.randn(B, L, a, device=dev, generator=g)
            q = torch.randn(B, k, a, device=dev, generator=g)
            v = 0.1 * torch.randn(a, device=dev, generator=g)
            lens = torch.randint(L // 3, L + 1, (B,), device=dev,
                                 generator=g)
            lens[0], lens[-1] = L, 0
            mask = torch.where(torch.arange(L, device=dev)[None]
                               < lens[:, None], 0.0, float("-inf"))
            ops = [t.to(dtype).contiguous() for t in (mask, q, keys, v)]
            with torch.no_grad():
                before = attn_k.launches
                got = attn_k.beam_scores_softmax(*ops).float()
                launched = attn_k.launches - before
                ref = attn_k.beam_scores_softmax_plain(
                    *[t.float() for t in ops])
                nan = torch.isnan(ref)
                err = (got - ref)[~nan].abs()
                lim = (1e-5 if dtype == torch.float32
                       else 2 ** -8 * ref[~nan].abs() + 1e-6)
                ok = (launched == 1 and torch.equal(torch.isnan(got), nan)
                      and bool((err <= lim).all()))
                what = ("an f32 sum order" if dtype == torch.float32
                        else "a bf16 rounding")
                fails.check(ok, f"K6 {tag} [{B}, {k}, {L}, {a}]: one launch, "
                                f"NaN rows as the twin's, within {what} of "
                                f"the twin in f32 (max "
                                f"{float(err.max()):.3g})")
                ms = graph_ms(lambda: attn_k.beam_scores_softmax(*ops),
                              iters=20)
                plain_ms = graph_ms(
                    lambda: attn_k.beam_scores_softmax_plain(*ops), iters=3)
            es = 2 if dtype == torch.bfloat16 else 4
            # the tanhf these rows need: k * a a frame within its row
            t_ops = 2 * k * a * int(lens.sum()) / H100_SFU_PER_S * 1e3
            t_bytes = (B * L * a + B * k * a + a + B * L + B * k * L) * es \
                / H100_BYTES_PER_S * 1e3
            bound, by = max((t_ops, "operations"), (t_bytes, "bytes"))
            by_shape[f"{tag}_L{L}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                share=bound / ms, max_abs_err=float(err.max()),
                plan=attn_k.plan(B, k, L, a, dtype))
            print(f"K6 {tag} [{B}, {k}, {L}, {a}]: {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}) = {100 * bound / ms:.1f} %, twin "
                  f"{plain_ms:.3f} ms ({plain_ms / ms:.1f}x); max err "
                  f"{float(err.max()):.3g}; plan "
                  f"{json.dumps(by_shape[f'{tag}_L{L}']['plan'])} on {gpu}",
                  flush=True)
    main = by_shape[f"f32_L{K6_LENGTHS[-1]}"]
    return dict(name="K6 beam attention read", route="cuda",
                source="chinese_asr_tpu_torch/csrc/attention.cu",
                replaces=None, max_abs_err=main["max_abs_err"],
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, by_shape=by_shape,
                shape=f"mask [{B}, L], q [{B}, {k}, {a}], keys [{B}, L, "
                      f"{a}] -> align [{B}, {k}, L], L in {K6_LENGTHS}; "
                      f"the main figures f32 at L={K6_LENGTHS[-1]}")


# K7's shapes: the Conformer's FFN d -> 4d at the longest chunk (8 sorted
# chunks of 128 rows, 317 frames), and one row slice of the subsampling's
# map (21 rows at SUBSAMPLE_SLICE_ELEMS, 512 channels x 19 features)
K7_SHAPES = ((128 * 317, 512, 2048), (21 * 317, 9728, 512))
# the beam decode step's products at B = 128, k = 16 (M = 2048 rows), with
# or without a bias in the epilogue: the output projection [h, context] ->
# 5004 logits, the LSTM gates' input product (b_ih + b_hh in its
# epilogue) and their recurrent one; a call of 8 chunks runs each 320 times
K7_DECODE_SHAPES = ((2048, 1024, 5004, True), (2048, 768, 2048, True),
                    (2048, 512, 2048, False))
# the E-Branchformer's four products that the Conformer lacks, each with its
# bias: the cgMLP's two (d -> 3072, the gated half 1536 -> d), the merge's
# (2d -> d) and its FFN's first (d -> 1024); held to cuBLAS's error at the
# M of each of the cell's chunks (128 rows of 317 frames, timed, and of
# 73-173, whole seconds of 3-7 s), where cuBLAS picks other kernels
K7_EBRANCHFORMER_KN = ((512, 3072), (1536, 512), (1024, 512), (512, 1024))
K7_EBRANCHFORMER_CHUNK_M = tuple(128 * L for L in (73, 98, 123, 148, 173))


def _phase_k7(np, torch, fails, dev, gemm_k, graph_ms, gpu) -> dict:
    """Phase 2h: K7 against the float64 product at K7_SHAPES,
    K7_DECODE_SHAPES and K7_EBRANCHFORMER_KN (at M = 128 x 317, then
    untimed at K7_EBRANCHFORMER_CHUNK_M), each error measured against
    |x| @ |w| + |b|: one launch a call and within 4x of cuBLAS's float32
    product (TF32 off) at the Conformer's shapes, no farther than it at
    the decode's and the E-Branchformer's.  Timed as CUDA graphs of 10
    calls beside cuBLAS's product (``library_ms``: the Conformer's ``F.linear``,
    the decode's and the E-Branchformer's ``x @ w (+ b)``), its twin and
    its bound: 3 TF32 passes of 2 M K N at H100_TF32_FLOPS, or its bytes
    (x, w and b read once, y written once) at the HBM's rate."""
    by_shape = {}
    eb_m = 128 * 317
    for M, K, N, has_bias, strict, timed in (
            [(M, K, N, True, False, True) for M, K, N in K7_SHAPES]
            + [(M, K, N, b, True, True) for M, K, N, b in K7_DECODE_SHAPES]
            + [(eb_m, K, N, True, True, True) for K, N in K7_EBRANCHFORMER_KN]
            + [(M, K, N, True, True, False) for K, N in K7_EBRANCHFORMER_KN
               for M in K7_EBRANCHFORMER_CHUNK_M]):
        g = torch.Generator(device=dev).manual_seed(K + N)
        x = torch.randn(M, K, device=dev, generator=g)
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        b = torch.randn(N, device=dev, generator=g) if has_bias else None
        if strict:
            lib_fn = (lambda: x @ w) if b is None else (lambda: x @ w + b)
        else:
            lib_fn = lambda: torch.nn.functional.linear(x, w.t(), b)
        with torch.no_grad():
            before = gemm_k.launches
            y = gemm_k.linear(x, w, b)
            launched = gemm_k.launches - before
            lib = lib_fn()
            x64, w64 = x.double(), w.double()
            ref, scale = x64 @ w64, x64.abs() @ w64.abs()
            if b is not None:
                ref, scale = ref + b.double(), scale + b.double().abs()
            err = float(((y.double() - ref).abs() / scale).max())
            lib_err = float(((lib.double() - ref).abs() / scale).max())
            del x64, w64, ref, scale, y, lib
            within = 1 if strict else 4
            fails.check(launched == 1 and err <= within * lib_err,
                        f"K7 [{M}, {K}] x [{K}, {N}]: one launch, within "
                        f"{within}x of cuBLAS's float32 error against "
                        f"float64 ({err:.3g} against {lib_err:.3g}, of |x| @ "
                        f"|w| + |b|)")
            if not timed:
                by_shape[f"{M}x{K}x{N}"] = dict(err=err, library_err=lib_err,
                                                bias=has_bias)
                del x, w, b
                continue
            ms = graph_ms(lambda: gemm_k.linear(x, w, b), iters=10)
            lib_ms = graph_ms(lib_fn, iters=10)
            plain_ms = graph_ms(lambda: gemm_k.linear_plain(x, w, b),
                                iters=3)
        t_ops = 3 * 2 * M * K * N / H100_TF32_FLOPS * 1e3
        t_bytes = 4 * (M * K + K * N + (N if has_bias else 0)
                       + M * N) / H100_BYTES_PER_S * 1e3
        bound, by = max((t_ops, "operations"), (t_bytes, "bytes"))
        key = f"{M}x{K}x{N}"
        by_shape[key] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, share=bound / ms,
                             err=err, library_err=lib_err, bias=has_bias)
        print(f"K7 [{M}, {K}] x [{K}, {N}]{' + b' if has_bias else ''}: "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}) = "
              f"{100 * bound / ms:.1f} %, cuBLAS f32 {lib_ms:.4f} ms "
              f"({lib_ms / ms:.2f}x), twin {plain_ms:.3f} ms; error "
              f"{err:.3g}, cuBLAS {lib_err:.3g} on {gpu}", flush=True)
        del x, w, b
    main = by_shape[f"{K7_SHAPES[0][0]}x{K7_SHAPES[0][1]}x{K7_SHAPES[0][2]}"]
    return dict(name="K7 3xTF32 GEMM", route="cuda",
                source="chinese_asr_tpu_torch/csrc/gemm.cu", replaces=None,
                max_rel_err=main["err"], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                by_shape=by_shape,
                shape=f"x [M, K] @ w [K, N] + b, (M, K, N) in {K7_SHAPES}, "
                      f"the bias as marked, in {K7_DECODE_SHAPES} and, (K, N) "
                      f"in {K7_EBRANCHFORMER_KN}, at M = {eb_m} and, untimed, "
                      f"at M in {K7_EBRANCHFORMER_CHUNK_M}; the main figures "
                      f"the first")


# K8's shapes: the subsampling of the offline cells' longest chunk (128 rows,
# 316 frames out of the second convolution) and of their shortest (72), over
# 80 log-mels, at C = 512; T = 4 T2 + 4 frames in
K8_T2 = (316, 72)
K8_B, K8_C, K8_F = 128, 512, 80


def _subsample_inputs(torch, dev, T2, seed, positive=False):
    """x [K8_B, 4 T2 + 4, K8_F] and the two convolutions' weights and
    biases at the configuration's widths (xavier-normal scale), made on the
    card from ``seed``; with ``positive`` their magnitudes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = K8_C
    ops = [3 * torch.randn(K8_B, 4 * T2 + 4, K8_F, device=dev, generator=g),
           torch.randn(3, 3, 1, C, device=dev, generator=g) * (2 / (9 + 9 * C)) ** 0.5,
           0.1 * torch.randn(C, device=dev, generator=g),
           torch.randn(3, 3, C, C, device=dev, generator=g) * (1 / (9 * C)) ** 0.5,
           0.1 * torch.randn(C, device=dev, generator=g)]
    return [t.abs() for t in ops] if positive else ops


def _subsample_library(torch, x, w1, b1, w2, b2):
    """The port's subsampling before K8, whole-batch: cuDNN's two float32
    convolutions (TF32 off), each with its ReLU in place, and the
    channel-major flatten's copy."""
    F = torch.nn.functional
    h = F.conv2d(x[:, None], w1.permute(3, 2, 0, 1), b1, stride=2).relu_()
    h = F.conv2d(h, w2.permute(3, 2, 0, 1), b2, stride=2).relu_()
    return h.transpose(1, 2).flatten(2)


def _subsample_f64(torch, x, w1, b1, w2, b2, rows: int = 16):
    """The same two convolutions in float64, ``rows`` rows at a time."""
    x, w1, b1, w2, b2 = (t.double() for t in (x, w1, b1, w2, b2))
    return torch.cat([_subsample_library(torch, x[s:s + rows], w1, b1, w2,
                                         b2)
                      for s in range(0, x.shape[0], rows)])


def _phase_k8(np, torch, fails, dev, sub_k, graph_ms, gpu) -> dict:
    """Phase 2i: K8, the subsampling's two convolutions, at the offline
    cells' longest and shortest chunk (K8_T2): one launch a call, exact
    under a CUDA graph's replay, within 1e-4 of its twin, and against the
    float64 convolutions on |x|, |w| and |b| no farther than cuDNN's
    float32 pair (TF32 off); timed as CUDA graphs beside that pair with
    its ReLUs and the flatten's copy (``library_ms``), its twin and its
    bound (3 TF32 passes of conv2's 2 M 9 C^2 operations at the tensor
    cores' rate, or its bytes: x, the weights and biases read once, y
    written once)."""
    by_shape = {}
    for T2 in K8_T2:
        ops = _subsample_inputs(torch, dev, T2, seed=T2)
        M = K8_B * T2 * 19
        with torch.no_grad():
            before = sub_k.launches
            y = sub_k.convs(*ops)
            torch.cuda.synchronize()
            launched = sub_k.launches - before
            twin = sub_k.convs_plain(*ops)
            twin_err = float((y - twin).abs().max() / twin.abs().max())
            del twin
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                yg = sub_k.convs(*ops)
            graph.replay()
            torch.cuda.synchronize()
            same = torch.equal(yg, y)
            del graph, yg, y
            pos = _subsample_inputs(torch, dev, T2, seed=T2, positive=True)
            ref = _subsample_f64(torch, *pos)
            err = float(((sub_k.convs(*pos).double() - ref) / ref).abs().max())
            lib_err = float(((_subsample_library(torch, *pos).double() - ref)
                             / ref).abs().max())
            del ref, pos
            fails.check(launched == 1 and same and twin_err <= 1e-4
                        and err <= lib_err,
                        f"K8 [{K8_B}, {4 * T2 + 4}, {K8_F}] -> [{K8_B}, {T2}, "
                        f"{K8_C} x 19]: one launch ({launched}), a graph's "
                        f"replay equal ({same}), within 1e-4 of its twin "
                        f"({twin_err:.3g} of its largest value), no farther "
                        f"from float64 than cuDNN's float32 pair ({err:.3g} "
                        f"against {lib_err:.3g}, relative, on |x|, |w|, |b|)")
            ms = graph_ms(lambda: sub_k.convs(*ops), iters=10)
            lib_ms = graph_ms(lambda: _subsample_library(torch, *ops),
                              iters=3)
            plain_ms = graph_ms(lambda: sub_k.convs_plain(*ops), iters=2)
        C, T = K8_C, 4 * T2 + 4
        t_ops = 3 * 2 * M * 9 * C * C / H100_TF32_FLOPS * 1e3
        t_bytes = 4 * (K8_B * T * K8_F + 9 * C + 9 * C * C + 2 * C
                       + M * C) / H100_BYTES_PER_S * 1e3
        bound, by = max((t_ops, "operations"), (t_bytes, "bytes"))
        by_shape[f"T2={T2}"] = dict(ms=ms, library_ms=lib_ms,
                                    plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=by, share=bound / ms, err=err,
                                    library_err=lib_err, twin_err=twin_err)
        print(f"K8 [{K8_B}, {T}, {K8_F}] -> [{K8_B}, {T2}, {C * 19}]: "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}) = "
              f"{100 * bound / ms:.1f} %, cuDNN f32 pair + ReLU + flatten "
              f"{lib_ms:.4f} ms ({lib_ms / ms:.2f}x), twin {plain_ms:.3f} "
              f"ms; error {err:.3g}, cuDNN {lib_err:.3g}, twin {twin_err:.3g}"
              f" on {gpu}", flush=True)
        del ops
        torch.cuda.empty_cache()
    main = by_shape[f"T2={K8_T2[0]}"]
    return dict(name="K8 subsampling convolutions", route="cuda",
                source="chinese_asr_tpu_torch/csrc/subsample.cu",
                replaces=None, max_rel_err=main["err"], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                by_shape=by_shape,
                shape=f"x [{K8_B}, 4 T2 + 4, {K8_F}] -> [{K8_B}, T2, "
                      f"{K8_C} x 19], T2 in {K8_T2}; the main figures the "
                      f"first")


def _k2_ptxas_lines(log_path: str, *markers: str, exclude: str = ""):
    """``-Xptxas -v``'s register and spill lines of the kernel instances
    whose mangled name contains every one of ``markers`` (and not
    ``exclude``)."""
    out, keep = [], False
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = re.search(r"'([^']+)'", line)
                keep = (all(m in line for m in markers) and name is not None
                        and not (exclude and exclude in line))
                if keep:               # the kernel's name and template
                    m = name.group(1)  # arguments, as mangled
                    out.append(m[m.find("bilstm"):m.find("EEv")])
            elif keep and ("registers" in line or "spill" in line):
                out[-1] += " | " + line.strip().replace("ptxas info    : ",
                                                        "")
    return out


def _wire_cost(np, torch, asr, batch) -> dict:
    """One batch's wire: the buffer's type and bytes (lens and scales
    included), the host preparation (encoders included; host clock) and
    the host-to-device copy of the pinned buffers (CUDA events on a side
    stream, median of 5)."""
    t = time.perf_counter()
    prep = asr._prep(batch, None)
    host_ms = (time.perf_counter() - t) * 1e3
    pinned = [torch.from_numpy(a).pin_memory() for a in prep[:3]]
    stream = torch.cuda.Stream()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            for p in pinned:
                p.to("cuda", non_blocking=True)
            end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return dict(buffer=str(prep[0].dtype),
                wire_bytes=int(sum(a.nbytes for a in prep[:3])),
                host_prep_ms=host_ms, htod_ms=float(np.median(times)))


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
        batch=len(wavs), steps=(int(a.l_final) + 1, int(b.l_final) + 1),
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
    return dict(batch=len(wavs), fused_steps=int(res.l_final) + 1,
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


# ---- phase 3g: the compiled decode entry points against the eager loop -----
GRAPH_AB_RUNS = 7               # walls a path in the graph/eager A/B
SERVE_STEADY_RUNS = 20          # single requests behind the steady p50/p99
# the host API calls the profiler records for one launch each, and the
# calls that wait for the card (each host read of a device value is one)
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _eager_featurize(asr, up):
    """``asr._featurize(up)`` through the eager front end
    (``features.front_end``, the compiled one's plain version)."""
    from chinese_asr_tpu_torch.audio import features
    compiled = features.front_end_jit
    features.front_end_jit = features.front_end
    try:
        return asr._featurize(up)
    finally:
        features.front_end_jit = compiled


def _eager_transcribe(asr, wavs, scales=None, unroll: int = 1):
    """``asr.transcribe_wavs`` of one chunk with the front end and the
    decode through the eager functions, called by name (the compiled
    forms' plain versions), reading the stop flag every ``unroll``
    steps."""
    from chinese_asr_tpu_torch.decode import beam, greedy, lm_fused, rescore
    up = asr._upload(asr._prep(wavs, scales))
    feats, lens = _eager_featurize(asr, up)
    p, cfg, dc, bw = asr.params, asr.cfg, asr.cfg.decode, asr.bw
    if not bw or bw <= 1:
        return greedy.finalize_greedy(greedy.greedy_decode(
            p, cfg, feats, lens, unroll=unroll), asr.vocab).pred_text
    if asr.dlm is not None and asr.lm_mode == "first":
        best = lm_fused.lm_fused_decode_best(
            p, cfg, bw, feats, lens, asr.dlm, asr.tok2lm, asr.lm_topn,
            unroll=unroll)
    elif asr.dlm is not None:
        best = rescore.beam_rescored_best(
            p, cfg, bw, feats, lens, asr.dlm, asr.tok2lm, dc.lm_weight,
            dc.length_weight, asr._lm_bos, asr._lm_eos, unroll=unroll)
    elif asr.lm is not None:
        return beam.finalize_beam(
            beam.compact_nbest(beam.beam_decode(p, cfg, bw, feats, lens,
                                                unroll=unroll)),
            cfg, asr.vocab, lm_model=asr.lm, second_pass=True,
            lm_weight=dc.lm_weight, length_weight=dc.length_weight).pred_text
    else:
        best = beam.beam_decode_best(p, cfg, bw, feats, lens, unroll=unroll)
    return beam.finalize_best(best, asr.vocab).pred_text


def _launch_profile(torch, fn, mark=None) -> dict:
    """One call of ``fn`` under torch.profiler (host and card), the
    session's second: the first is its schedule's warm-up step, traced and
    dropped, since a session can lose its first device records (from none
    to all of 64 in a run of this script on torch 2.11; ROADMAP B9).
    ``mark`` is called between the two calls.  Returns
    the kernels' busy ms and count on the card, the host's launch calls
    (kernels, graphs, copies, memsets; ``_LAUNCH_CALLS``), of which graph
    launches, the host's waits for the card (``_SYNC_CALLS``, less the
    profile's own final synchronize), and the card's (us, count, name)
    rows (not the step's own ``ProfilerStep#`` span)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step and mark is not None:
                mark()
            fn()
            torch.cuda.synchronize()
            prof.step()
    out = dict(busy_ms=0.0, kernels=0, launch_calls=0, graph_launches=0,
               host_syncs=-1, rows=[])
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0 and not e.key.startswith("ProfilerStep"):
                out["busy_ms"] += us / 1e3
                out["kernels"] += e.count
                out["rows"].append((us, e.count, e.key))
        elif e.key in _LAUNCH_CALLS:
            out["launch_calls"] += e.count
            if e.key == "cudaGraphLaunch":
                out["graph_launches"] += e.count
        elif e.key in _SYNC_CALLS:
            out["host_syncs"] += e.count
    return out


TRACE_TRIES = 3


def _fullest_trace(torch, fn, counters) -> tuple:
    """(``_launch_profile`` of one call of ``fn``, the launch counters'
    increase over that call): of TRACE_TRIES traced calls, the one whose
    trace holds the most kernel records.  The card's trace of a call can
    lose records (a session's first ones, which ``_launch_profile``'s
    warm-up step takes; earlier, a tenth of a trace of the same graphs),
    and each call of the same graphs on the same inputs runs the same
    kernels, so the fullest trace is the one to hold against the
    counters, over the traced call alone."""
    best = None
    for _ in range(TRACE_TRIES):
        before = {}
        prof = _launch_profile(torch, fn, mark=lambda: before.update(
            {n: getattr(m, a) for n, (m, a) in counters.items()}))
        counted = {n: getattr(m, a) - before[n]
                   for n, (m, a) in counters.items()}
        if best is None or prof["kernels"] > best[0]["kernels"]:
            best = (prof, counted)
    return best


def _graph_vs_eager(np, torch, asr, wavs, scales=None,
                    one_sync: bool = False, host_trace: bool = True) -> dict:
    """The graph path (``asr.transcribe_wavs``, the ``*_jit`` forms) and
    the eager one (``_eager_transcribe``) on the same batch: their
    transcripts, walls in turns graph / eager (GRAPH_AB_RUNS each, host
    clock to a synchronize), and one profile of each (of the graph path
    the fullest of TRACE_TRIES, ``_fullest_trace``).  ``one_sync`` adds
    the eager loop reading the stop flag once (``unroll=max_len``): what
    the eager loop's host syncs cost; ``graph_counted`` is the launch
    counters' increase over the graph path's profiled call, for its
    trace's rows (``graph_rows``).  Without ``host_trace`` the eager
    paths are traced on the card alone (an LM run's 10-32 thousand eager
    launches take the host trace seconds to summarise): their kernels
    stand for their launch calls, which the host-traced runs show equal
    to within a few copies."""
    paths = {"graph": lambda: asr.transcribe_wavs(wavs, scales=scales),
             "eager": lambda: _eager_transcribe(asr, wavs, scales)}
    if one_sync:
        paths["eager_1sync"] = lambda: _eager_transcribe(
            asr, wavs, scales, unroll=asr.cfg.decode.max_len)
    texts = {k: fn() for k, fn in paths.items()}
    walls = {k: [] for k in paths}
    for _ in range(GRAPH_AB_RUNS):
        for k, fn in paths.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t) * 1e3)
    out = dict(texts=texts)
    counters = _kernel_counters()
    for k, fn in paths.items():
        med = float(np.median(walls[k]))
        if k == "graph":
            prof, out["graph_counted"] = _fullest_trace(torch, fn, counters)
            out["graph_rows"] = sorted(prof.pop("rows"), reverse=True)
        elif host_trace:
            prof = _launch_profile(torch, fn)
            prof.pop("rows")
        else:
            busy, n, _ = _device_profile(torch, fn, host_ops=False)
            prof = dict(busy_ms=busy, kernels=n, launch_calls=None,
                        graph_launches=0, host_syncs=None)
        out[k] = dict(wall_ms=med, wall_ms_min=min(walls[k]),
                      wall_ms_max=max(walls[k]), **prof,
                      busy_share=prof["busy_ms"] / med)
    return out


# each kernel of ours by its name in the card's trace, and the launch
# counters (``_kernel_counters``) that count it
_TRACE_KERNELS = (("K1", ("logmel_tc_kernel",), ("logmel.launches",)),
                  ("K2", ("bilstm_tc_kernel<", "bilstm_bf16_tc_kernel<",
                          "bilstm_kernel<"),
                   ("lstm.launches", "lstm.bf16_launches")),
                  ("K3/K4", ("topk_kernel<",),
                   ("topk.launches", "topk.fused_launches")),
                  ("K5", ("adpcm_decode_kernel",), ("adpcm.launches",)),
                  ("K6", ("beam_attention_kernel<",),
                   ("attention.launches",)),
                  ("K7", ("tf32x3_gemm_kernel",), ("gemm.launches",)),
                  ("K8", ("subsample_tf32x3_kernel",),
                   ("subsample.launches",)))


def _ab_line(label: str, r: dict, gpu: str) -> str:
    def one(k):
        x = r[k]
        host = ("(traced on the card alone)" if x["launch_calls"] is None
                else f"launch calls {x['launch_calls']} (graphs "
                     f"{x['graph_launches']}), host syncs {x['host_syncs']}")
        return (f"{k} {x['wall_ms']:.1f} ms [{x['wall_ms_min']:.1f}, "
                f"{x['wall_ms_max']:.1f}], kernels {x['kernels']}, busy "
                f"{x['busy_ms']:.1f} ms = {100 * x['busy_share']:.1f}%, "
                f"{host}")
    return f"3g {label} on {gpu}: " + "; ".join(
        one(k) for k in ("graph", "eager", "eager_1sync") if k in r)


def _graph_mode(np, torch, fails, gpu, mode, asr, batch, fused, need,
                texts) -> dict:
    """Phase 3g of one phase-3 run (``need``, its counters; ``texts``, its
    transcripts): the graph path against the eager functions
    (``_graph_vs_eager``), both giving ``texts``, and the card's trace of
    one graph-path call holding each of our kernels as often as its
    counters count, at least once for each kernel ``need`` names.
    Returns the A/B report."""
    from chinese_asr_tpu_torch.utils import graphs
    t_run = time.time()
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "1" if fused else "0"
    before = graphs.replays
    r = _graph_vs_eager(np, torch, asr, batch,
                        one_sync=mode in ("beam_bw16", "greedy"),
                        host_trace=asr.dlm is None)
    got = r.pop("texts")
    fails.check(all(t == texts for t in got.values())
                and graphs.replays > before,
                f"3g {mode}: the graph replay's transcripts equal the "
                f"eager loop's and phase 3's")
    rows = r.pop("graph_rows")
    counted = r.pop("graph_counted")
    traced = {name: (sum(c for _, c, key in rows
                         if any(k in key for k in keys)),
                     sum(counted[n] for n in ctrs))
              for name, keys, ctrs in _TRACE_KERNELS}
    # K1 and K5 run in the front end's graph, the rest in the decode's
    # (the encoder's K2, K7 and K8 in its first step)
    ran = [name for name, _, ctrs in _TRACE_KERNELS
           if any(n in need for n in ctrs)]
    fails.check(all(t == c for t, c in traced.values())
                and all(traced[name][0] > 0 for name in ran),
                f"3g {mode}: the card's trace of one graph-path call "
                f"launched what the counters count, K1-K8 (traced, "
                f"counted) {traced}, each of {ran} at least once")
    r["traced_vs_counted"] = traced
    print(_ab_line(mode, r, gpu) + f" ({time.time() - t_run:.1f} s)",
          flush=True)
    # where the graph path's device time goes: the twelve largest
    # kernels, then the port's own further down
    ours = [x for x in rows[12:] if any(
        n in x[2] for n in ("topk_kernel", "bilstm", "logmel", "adpcm",
                            "beam_attention", "tf32x3_gemm",
                            "subsample_tf32x3"))]
    for us, count, key in rows[:12] + ours:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return r


def _phase_graphs(np, torch, fails, ASR, gpu, runs_spec, texts_of, golden,
                  cfg, wavs):
    """Phase 3g: every phase-3 run and the golden shard's five modes (f32
    and bf16) through the graph path and the eager functions: identical
    transcripts (and the golden shard's expected.json), the A/B walls,
    launches, busy share and host syncs a batch, each program's capture
    ms and reserved MB, and serving's first request against its steady
    p50/p99."""
    from chinese_asr_tpu_torch.data import audio_io
    from chinese_asr_tpu_torch.utils import graphs

    def replays():
        return graphs.replays

    report = {}
    for mode, asr, batch, fused, need in runs_spec:
        report[mode] = _graph_mode(np, torch, fails, gpu, mode, asr, batch,
                                   fused, need, texts_of[mode])
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "0"

    gold, gcfg, gvocab, gpaths, expected = golden
    gw = [audio_io.read_wav(p, 16000, dtype="int16")[0] for p in gpaths]
    gsc = [audio_io.peak_scale(w) for w in gw]
    modes = (("greedy", dict(bw=None)), ("beam_bw4", dict(bw=4)),
             ("lm_second", dict(bw=4, lm_mode="second")),
             ("lm_second_host", dict(bw=4, lm_mode="second_host")),
             ("lm_first", dict(bw=4, lm_mode="first", lm_topn=8)))
    for dtype in ("float32", "bfloat16"):
        for mode, kw in modes:
            if "lm_mode" in kw:
                kw = dict(kw, lm_path=os.path.join(gold, "lm.arpa"))
            asr = ASR(ckpt_path=os.path.join(gold, "model.ckpt"), cfg=gcfg,
                      vocab=gvocab, compute_dtype=dtype, **kw)
            before = replays()
            graph = asr.transcribe_files(gpaths)
            eager = _eager_transcribe(asr, gw, gsc)
            ok = graph == eager and replays() > before
            if dtype == "float32":
                ok = ok and graph == expected[mode]
            fails.check(ok, f"3g golden {mode} {dtype}: the graph replay "
                            f"equals the eager loop"
                        + (" and expected.json" if dtype == "float32"
                           else f" (expected.json: {graph == expected[mode]})"))
            report[f"golden_{mode}_{dtype}"] = dict(
                equals_eager=graph == eager,
                equals_expected=graph == expected[mode])
    print(f"3g golden shard, five modes in f32 and bf16: "
          f"{json.dumps({k: v for k, v in report.items() if 'golden' in k})}",
          flush=True)

    report["programs"] = _program_lines(graphs,
                                        "phase-3 runs and golden modes")
    graphs.clear()

    # serving's first request (an eager warm-up and a capture) against its
    # steady single requests, on a fresh model
    sasr = ASR(bw=16, cfg=cfg, seed=1)
    one = [wavs[0]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    sasr.transcribe_wavs(one)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    steady = []
    for _ in range(SERVE_STEADY_RUNS):
        t = time.perf_counter()
        sasr.transcribe_wavs(one)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t) * 1e3)
    report["serve_b1"] = dict(first_ms=first_ms,
                              steady_p50_ms=float(np.percentile(steady, 50)),
                              steady_p99_ms=float(np.percentile(steady, 99)))
    print(f"3g one request at B=1 (bw 16, 9-10 s) on {gpu}: first "
          f"{first_ms:.1f} ms (eager warm-up and capture), then "
          f"p50 {report['serve_b1']['steady_p50_ms']:.1f} ms, p99 "
          f"{report['serve_b1']['steady_p99_ms']:.1f} ms of "
          f"{SERVE_STEADY_RUNS}", flush=True)
    report["serving_mix"] = _serving_mix(np, torch, fails, sasr, gpu)
    del sasr
    graphs.clear()
    return report


# the serving mix: batches on the ladder of a ``max_batch=32`` server,
# requests of 1-20 s, graph path against the eager functions
MIX_BATCHES = 40                # batches a pass
MIX_LADDER = (1, 2, 4, 8, 16, 32)
MIX_POOL = 96                   # distinct request wavs, 1-20 s
MIX_OLD_MAXSIZE = 32            # the count bound the cache had before
MIX_STREAM = 2000               # batches of the long stream, keys only


def _mix_pass(np, seed: int, pool, n_batches: int = MIX_BATCHES) -> list:
    """``n_batches`` batches as a ``MicroBatcher(max_batch=32)`` forms
    them: a ladder size, that many requests from ``pool`` or a few fewer,
    the rest one-sample dummies (as its worker pads)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        size = int(rng.choice(MIX_LADDER))
        n = 1 if size == 1 else int(rng.integers(size // 2 + 1, size + 1))
        out.append([pool[i] for i in rng.integers(0, len(pool), n)]
                   + [np.zeros(1, np.int16)] * (size - n))
    return out


def _lru_hits(keys, size: float, cost=None) -> int:
    """Hits of an LRU cache over ``keys`` that holds ``size`` entries, or
    with ``cost`` (key -> bytes) entries of at most ``size`` bytes in all
    (the newest always stays, as ``graphs.evict``)."""
    from collections import OrderedDict
    cache, hits = OrderedDict(), 0
    for k in keys:
        if k in cache:
            hits += 1
            cache.move_to_end(k)
            continue
        cache[k] = 1 if cost is None else cost(k)
        while len(cache) > 1 and sum(cache.values()) > size:
            cache.popitem(last=False)
    return hits


def _serving_mix(np, torch, fails, asr, gpu) -> dict:
    """A seeded mix of 1-20 s requests in batches on the serving ladder,
    two passes (cold: every new key captures; warm: a second seeded
    stream over the programs the first left), through ``ASR`` (the graph
    path) and through the eager functions (``_eager_transcribe``) in
    turns batch by batch: each batch's wall (host clock to a
    synchronize; its latency as served), the cache's hits, captures,
    evictions and reserved memory, and the hit rate the old count bound
    (MIX_OLD_MAXSIZE) would have had on the same keys.  The graph path's
    transcripts must equal the eager loop's."""
    from chinese_asr_tpu_torch.data import audio_io
    from chinese_asr_tpu_torch.utils import graphs
    pool = _synthetic_wavs(np, np.random.default_rng(20), MIX_POOL, 1.0,
                           20.0)
    graphs.clear()
    out, keys, same, key_mb = {}, [], True, {}

    def key_of(wavs):
        return (len(wavs), audio_io.round_up(max(len(w) for w in wavs),
                                             asr.wav_bucket))

    for name, seed in (("cold", 1), ("warm", 2)):
        batches = _mix_pass(np, seed, pool)
        c0, e0, r0 = graphs.captures, graphs.evictions, graphs.replays
        walls = {"graph": [], "eager": []}
        for wavs in batches:
            keys.append(key_of(wavs))
            texts = {}
            for path in ("graph", "eager"):
                n_cap = graphs.captures
                torch.cuda.synchronize()
                t = time.perf_counter()
                texts[path] = (asr.transcribe_wavs(wavs, max_batch=32)
                               if path == "graph"
                               else _eager_transcribe(asr, wavs))
                torch.cuda.synchronize()
                walls[path].append((time.perf_counter() - t) * 1e3)
                if graphs.captures > n_cap:     # the newest program
                    key_mb[keys[-1]] = (graphs.programs()[-1][1]
                                        .reserved_bytes / 2**20)
            same = same and texts["graph"] == texts["eager"]
        calls = graphs.replays - r0
        held = sum(p.reserved_bytes for _, p in graphs.programs())
        out[name] = dict(
            batches=len(batches), calls=calls,
            captures=graphs.captures - c0,
            evictions=graphs.evictions - e0,
            hit_rate=1 - (graphs.captures - c0) / calls,
            programs=len(graphs.programs()),
            programs_reserved_mb=held / 2**20,
            card_reserved_mb=torch.cuda.memory_reserved() / 2**20,
            **{f"{p}_{q}_ms": float(np.percentile(walls[p], q))
               for p in walls for q in (50, 99)},
            **{f"{p}_max_ms": max(walls[p]) for p in walls})
        x = out[name]
        print(f"3g serving mix, {name} pass ({gpu}): {len(batches)} batches "
              f"on the ladder {MIX_LADDER}, requests 1-20 s; graph p50 "
              f"{x['graph_50_ms']:.1f} ms, p99 {x['graph_99_ms']:.1f} ms; "
              f"eager p50 {x['eager_50_ms']:.1f} ms, p99 "
              f"{x['eager_99_ms']:.1f} ms; hits {calls - x['captures']} of "
              f"{calls} ({100 * x['hit_rate']:.1f}%), captures "
              f"{x['captures']}, evictions {x['evictions']}; {x['programs']} "
              f"programs hold {x['programs_reserved_mb']:.0f} MB (the card "
              f"reserves {x['card_reserved_mb']:.0f} MB)", flush=True)
    sizes = sorted(((p.reserved_bytes / 2**20, p.shapes[0][:2])
                    for _, p in graphs.programs()), reverse=True)
    budget_mb = graphs.budget_bytes(torch.device("cuda", 0)) / 2**20
    # a program's pool against its batch's samples (B x padded length),
    # fitted on the programs captured above, for the keys of a long
    # stream of the same mix that this run did not capture
    kk = sorted(key_mb)
    slope, icpt = np.polyfit([b * n for b, n in kk],
                             [key_mb[k] for k in kk], 1)

    def est_mb(k):
        return key_mb.get(k, max(icpt + slope * k[0] * k[1], 1.0))

    stream = [key_of(w) for w in _mix_pass(np, 3, pool, MIX_STREAM)]
    ns = len(stream)
    out.update(
        keys=len(set(keys)), budget_mb=budget_mb,
        largest_mb=sizes[0][0] if sizes else 0.0,
        mb_fit=dict(mb_per_msample=slope * 1e6, intercept_mb=icpt),
        old_bound_hit_rate=_lru_hits(keys, MIX_OLD_MAXSIZE) / len(keys),
        unbounded_hit_rate=_lru_hits(keys, len(keys)) / len(keys),
        stream=dict(
            batches=ns, keys=len(set(stream)),
            keys_mb=sum(est_mb(k) for k in set(stream)),
            old_bound_hit_rate=_lru_hits(stream, MIX_OLD_MAXSIZE) / ns,
            budget_hit_rate=_lru_hits(stream, budget_mb, est_mb) / ns,
            unbounded_hit_rate=_lru_hits(stream, ns) / ns),
        equals_eager=same)
    st = out["stream"]
    print(f"3g serving mix: {out['keys']} keys in {len(keys)} batches; "
          f"hit rate over both passes with no bound "
          f"{100 * out['unbounded_hit_rate']:.1f}%, with the old bound of "
          f"{MIX_OLD_MAXSIZE} programs {100 * out['old_bound_hit_rate']:.1f}%"
          f"; the budget {budget_mb:.0f} MB ({graphs.BUDGET_FRACTION} of the "
          f"card); largest programs (MB, feats [B, T]) "
          f"{[(round(m, 1), s) for m, s in sizes[:6]]}; a program's MB = "
          f"{icpt:.1f} + {slope * 1e6:.2f} a million batch samples (fit on "
          f"{len(kk)}); a stream of {ns} batches of the mix (keys only): "
          f"{st['keys']} keys holding ~{st['keys_mb']:.0f} MB in all, hit "
          f"rate {100 * st['unbounded_hit_rate']:.1f}% with no bound, "
          f"{100 * st['budget_hit_rate']:.1f}% within the budget, "
          f"{100 * st['old_bound_hit_rate']:.1f}% with the old bound of "
          f"{MIX_OLD_MAXSIZE}", flush=True)
    fails.check(same, "3g serving mix: every batch's transcripts through "
                      "the graph path equal the eager loop's")
    out["programs"] = _program_lines(graphs, "serving mix")
    return out


def _program_lines(graphs, what: str) -> list:
    """What each cached program cost to capture and holds on the card,
    printed and returned."""
    progs = [dict(name=p.name, shapes=p.shapes, chunks=p.chunks,
                  capture_ms=p.capture_ms,
                  reserved_mb=p.reserved_bytes / 2**20, replays=p.replays)
             for _, p in graphs.programs()]
    for x in progs:
        print(f"3g program {x['name']} {x['shapes']}: capture "
              f"{x['capture_ms']:.0f} ms, reserved {x['reserved_mb']:.1f} MB,"
              f" {x['chunks']} chunks, {x['replays']} replays", flush=True)
    print(f"3g: {len(progs)} programs of the {what} hold "
          f"{sum(x['reserved_mb'] for x in progs):.0f} MB", flush=True)
    return progs


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
    fails.check(all(served_counts[n] > 0
                    for n in ("logmel.launches", "lstm.launches",
                              "topk.launches", "attention.launches"))
                and served_counts["topk.fused_launches"] == 0,
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


def _serial_transcribe(asr, wavs, max_batch: int = 128):
    """``asr.transcribe_wavs`` in the serial order: each chunk prepared,
    uploaded, featurized, dispatched and finalized before the next is
    prepared (``_decode_finalize(_decode_dispatch(...))`` a chunk)."""
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i])) \
        if len(wavs) > max_batch else list(range(len(wavs)))
    out = [""] * len(wavs)
    for s in range(0, len(order), max_batch):
        idx = order[s:s + max_batch]
        up = asr._upload(asr._prep([wavs[i] for i in idx], None))
        for i, text in zip(idx, asr._decode_batch(asr._featurize(up))):
            out[i] = text
    return out


SUSTAINED_BATCHES = 4           # batches a timed sustained loop
SUSTAINED_RUNS = 7              # loops a order, in turns


def _sustained(asr, batch, n: int, pipelined: bool) -> list:
    """``n`` batches of ``batch`` end to end, each prepared on the host,
    uploaded, featurized, decoded and finalized: pipelined in bench.py's
    ``_time_pipelined`` order (batch i+1 dispatched before batch i is
    finalized, so its host preparation runs while the card decodes batch
    i), or serially.  Returns the transcripts of each batch."""
    def dispatch():
        return asr._decode_dispatch(asr._featurize(
            asr._upload(asr._prep(batch, None))))

    if not pipelined:
        return [asr._decode_finalize(dispatch()) for _ in range(n)]
    texts, pend = [], dispatch()
    for _ in range(n - 1):
        nxt = dispatch()
        texts.append(asr._decode_finalize(pend))
        pend = nxt
    texts.append(asr._decode_finalize(pend))
    return texts


def _pipelined_vs_serial(np, torch, fails, label, fns, gpu, per: int,
                         texts_want=None) -> dict:
    """``fns`` {"pipelined": fn, "serial": fn}, each doing ``per``
    batches: their results equal (and ``texts_want``), walls in turns
    (SUSTAINED_RUNS each, host clock to a synchronize, median [min,
    max], ms a batch), and one device-only profile of each: kernel busy
    ms a batch and its share of the median wall."""
    got = {k: fn() for k, fn in fns.items()}
    fails.check(got["pipelined"] == got["serial"]
                and (texts_want is None or got["serial"] == texts_want),
                f"3e {label}: the pipelined order's transcripts equal the "
                f"serial order's")
    walls = {k: [] for k in fns}
    for _ in range(SUSTAINED_RUNS):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t) * 1e3 / per)
    out = {}
    for k, fn in fns.items():
        busy, kernels, _ = _device_profile(torch, fn, host_ops=False)
        med = float(np.median(walls[k]))
        out[k] = dict(wall_ms=med, wall_ms_min=min(walls[k]),
                      wall_ms_max=max(walls[k]), busy_ms=busy / per,
                      kernels=kernels // per, busy_share=busy / per / med)
    print(f"3e {label} on {gpu}, ms a batch: " + "; ".join(
        f"{k} {x['wall_ms']:.1f} [{x['wall_ms_min']:.1f}, "
        f"{x['wall_ms_max']:.1f}], busy {x['busy_ms']:.1f} = "
        f"{100 * x['busy_share']:.1f}%" for k, x in out.items())
        + f"; pipelined / serial "
        f"{out['pipelined']['wall_ms'] / out['serial']['wall_ms']:.3f}",
        flush=True)
    return out


def _phase_entry_points(np, torch, fails, ASR, cfg, wavs, wavs128, rng,
                        counters, gpu, golden, build_dir):
    """Phase 3e: the overlapped chunk upload, the pipelined order (JAX's
    dispatch-ahead) against the serial one on 160 wavs in two chunks and
    in a sustained B=128 loop (flat f32, bf16, ADPCM),
    ``transcribe_long``, ``transcribe_bytes`` and ``evaluate_manifest``
    on the card.  Returns the report entries."""
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

    # JAX's dispatch-ahead order against the serial one, in turns
    report["pipelined_160"] = _pipelined_vs_serial(
        np, torch, fails, "160 wavs at max_batch=128 (two chunks)",
        {"pipelined": lambda: casr.transcribe_wavs(wavs160, max_batch=128),
         "serial": lambda: _serial_transcribe(casr, wavs160)}, gpu, 1,
        chunked[0][0])
    sustained = {}
    for name, a in (("flat_f32", casr),
                    ("bf16", ASR(bw=16, cfg=cfg, seed=0,
                                 compute_dtype="bfloat16")),
                    ("adpcm", ASR(bw=16, cfg=cfg, seed=0, wire="adpcm"))):
        n = SUSTAINED_BATCHES
        sustained[name] = _pipelined_vs_serial(
            np, torch, fails, f"sustained B=128 {name} ({n} batches a loop)",
            {"pipelined": lambda a=a: _sustained(a, wavs128, n, True),
             "serial": lambda a=a: _sustained(a, wavs128, n, False)}, gpu, n)
    report["sustained_b128"] = sustained

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
                    and ec["logmel.launches"] > 0
                    and ec["lstm.launches"] > 0,
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


def lstm_bwd_case(torch, lstm, g, Tn, B, h, dtype=None):
    """K2-bwd's operands at [Tn, B, h] on ``g``'s device: random gates and
    W_hh, random non-prefix masks (a quarter of the steps masked), ys from
    K2, random cotangents of ys and of the final state; all float32, or
    all rounded to ``dtype`` with ys from K2's instance of that type."""
    dev = g.device
    dt = dtype or torch.float32

    def f(*s):
        return torch.randn(*s, device=dev, generator=g).to(dt)

    xg_f, xg_b = f(Tn, B, 4 * h), f(Tn, B, 4 * h)
    w = (torch.randn(2, h, 4 * h, device=dev, generator=g) / h ** 0.5).to(dt)
    m_f, m_b = ((torch.rand(Tn, B, device=dev, generator=g) > 0.25).to(dt)
                for _ in range(2))
    ys_f, ys_b, _, _ = lstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    return (xg_f, xg_b, m_f, m_b, w, ys_f, ys_b, f(Tn, B, h), f(Tn, B, h),
            f(2, B, h), f(2, B, h))


def rel_err(got, ref) -> float:
    """The largest error of each output relative to max(1, its scale)."""
    return max(float((a.float() - b.float()).abs().max())
               / max(1.0, float(b.float().abs().max()))
               for a, b in zip(got, ref))


def _phase_k2_bwd(np, torch, fails, dev, lstm_k):
    """Phase 2f: K2-bwd against its twin on the card at the flagship
    encoder layer's shape (xg 2 x [332, 32, 1024], the cluster kernel), at
    B=128 and at H=16 (the simple kernel), with random non-prefix masks
    and nonzero final-state cotangents; its plan, time, bound, twin and
    cuDNN's backward of one bidirectional layer at B=32 and B=128.
    Returns the kernel's row of the ``kernels`` line."""
    T, H = 332, 256
    g = torch.Generator(device=dev).manual_seed(7)
    errs, raw, at = {}, {}, {}
    for B, h in ((32, H), (32, 16), (128, H)):
        args = lstm_bwd_case(torch, lstm_k, g, T, B, h)
        before = lstm_k.bwd_launches
        got = lstm_k.bidir_lstm_time_loop_bwd(*args)
        launched = lstm_k.bwd_launches - before
        ref = lstm_k.bidir_lstm_time_loop_bwd_plain(*args)
        raw[B, h] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        errs[B, h] = rel_err(got, ref)
        plan = lstm_k.bwd_plan(B, h)
        kind = "cluster" if plan["clusters"] else "simple"
        fails.check(launched == 1 and errs[B, h] <= TOL_LSTM_BWD
                    and all(bool(torch.isfinite(a).all()) for a in got)
                    and (kind == "cluster") == (h == H),
                    f"K2-bwd ({kind} kernel) T={T} B={B} H={h} (random "
                    f"non-prefix masks, nonzero ghT/gcT): max_abs_err "
                    f"{raw[B, h]:.3g}, relative to max(1, |ref|) "
                    f"{errs[B, h]:.3g} <= {TOL_LSTM_BWD}; one launch; plan "
                    f"{plan}")
        if h == H:
            at[B] = dict(args=args, plan=plan)
        del got, ref
    rows = {}
    for B, run in at.items():
        big = run["args"]
        ms = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop_bwd(*big),
                      10)
        plain_ms = _time_ms(
            torch, lambda: lstm_k.bidir_lstm_time_loop_bwd_plain(*big), 1,
            warmup=1)
        # cuDNN's backward of one bidirectional nn.LSTM layer of the same
        # shape (input 2H, as encoder layers 1-3 take it; the whole layer's
        # backward, input projection and weight gradients included), timed
        # as a yardstick and never used by the port
        cudnn = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev)
        x = torch.randn(T, B, 2 * H, device=dev, generator=g,
                        requires_grad=True)
        out, _ = cudnn(x)
        gout = torch.randn_like(out)
        wts = [x] + list(cudnn.parameters())
        cudnn_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, wts, gout, retain_graph=True), 10)
        del cudnn, x, out, gout, wts
        # the least work: each input read once (xg, masks, W_hh, ys, their
        # cotangents), dxg and dW_hh written once; per valid (row, step)
        # three 2 * H * 4H products (the gates' recompute, dh's and dW's)
        # and ~30 flops a unit of elementwise work, at the f32 rate
        valid = float(big[2].sum() + big[3].sum())
        nbytes = 4 * (2 * T * B * 4 * H * 2 + 2 * T * B + 2 * H * 4 * H * 2
                      + 4 * T * B * H + 4 * B * H)
        prod = valid * 2 * H * 4 * H
        bound, by = _bound_ms(nbytes, 3 * prod + valid * 30 * H)
        # the design's own floor: the kernel's two products as three TF32
        # products each at the tensor cores' dense rate, dW's bmm and the
        # elementwise work at the f32 rate
        bound_tc = max(_bound_ms(nbytes, 0)[0],
                       3 * 2 * prod / H100_TF32_FLOPS * 1e3
                       + (prod + valid * 30 * H) / H100_F32_FLOPS * 1e3)
        plan = run["plan"]
        print(f"K2-bwd at xg 2 x [{T}, {B}, {4 * H}] "
              f"({100 * valid / (2 * T * B):.1f}% of steps valid): {ms:.4f} "
              f"ms ({ms * 1e3 / (2 * T):.2f} us a step of either pass); "
              f"bound {bound:.4f} ms ({by}), {100 * bound / ms:.2f}%; at "
              f"3xTF32 {bound_tc:.4f} ms, {100 * bound_tc / ms:.2f}%; twin "
              f"{plain_ms:.1f} ms; cuDNN's backward of one layer "
              f"{cudnn_ms:.4f} ms; plan {plan['clusters']} clusters of 8 "
              f"CTAs, {plan['rows']} rows each, {plan['waves']} wave(s) "
              f"(the card holds {plan['max_active_clusters']})", flush=True)
        rows[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       bound_tf32x3_ms=bound_tc, cudnn_layer_bwd_ms=cudnn_ms,
                       plan=plan)
        del big
    at.clear()
    r32 = rows[32]
    return dict(
        name="K2-bwd BiLSTM backward", route="cuda",
        source="chinese_asr_tpu_torch/csrc/lstm_bwd.cu",
        replaces="chinese_asr_tpu/ops/rnn.py:297",
        design="cluster of 8 CTAs a tile and direction, W_hh in registers, "
               "3xTF32 mma.sync; pass 2 reduce-scatters dxg_t @ W_hh^T",
        plan=r32["plan"],
        max_abs_err=max(raw.values()), rel_err=max(errs.values()),
        ms=r32["ms"], step_us=r32["ms"] * 1e3 / T,
        pass_step_us=r32["ms"] * 1e3 / (2 * T),
        plain_ms=r32["plain_ms"], bound_ms=r32["bound_ms"],
        bound_by=r32["bound_by"], bound_tf32x3_ms=r32["bound_tf32x3_ms"],
        library_ms=None, cudnn_layer_bwd_ms=r32["cudnn_layer_bwd_ms"],
        b128=rows[128],
        shape=f"xg, dxg [2 x {T}, 32, {4 * H}], W_hh [2, {H}, {4 * H}]")


def _phase_k2_bwd_bf16(np, torch, fails, dev, lstm_k, f32_row, log,
                       splits):
    """Phase 2f-bf16: K2-bwd-bf16 against its bf16 twin on the card at the
    flagship encoder layer's shape (xg 2 x [332, 32, 1024]: pass 1's three
    stages and the cluster kernel of pass 2), at B=128 and at H=16 (the
    simple kernel), with random non-prefix masks and nonzero final-state
    cotangents; each stage kernel against its plain stage; its plan,
    registers, time, bound, twin, the f32 K2-bwd of phase 2f and cuDNN's
    bf16 backward of one bidirectional layer at B=32 and B=128, and from
    ``splits`` (phase 2b-bf16's stamped runs) each stage's time and pass
    2's phase split beside the parent design's.  Returns the kernel's row
    of the ``kernels`` line."""
    T, H = 332, 256
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(9)
    errs, raw, at = {}, {}, {}
    for B, h in ((32, H), (32, 16), (128, H)):
        args = lstm_bwd_case(torch, lstm_k, g, T, B, h, bf)
        before = (lstm_k.bwd_launches, lstm_k.bwd_bf16_launches)
        got = lstm_k.bidir_lstm_time_loop_bwd(*args)
        launched = (lstm_k.bwd_launches - before[0],
                    lstm_k.bwd_bf16_launches - before[1])
        ref = lstm_k.bidir_lstm_time_loop_bwd_plain(*args)
        raw[B, h] = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, ref))
        errs[B, h] = rel_err(got, ref)
        plan = lstm_k.bwd_plan(B, h, bf)
        kind = "cluster" if plan["clusters"] else "simple"
        fails.check(launched == (0, 1) and errs[B, h] <= TOL_LSTM_BWD_BF16
                    and all(a.dtype == bf for a in got)
                    and all(bool(torch.isfinite(a.float()).all())
                            for a in got)
                    and (kind == "cluster") == (h == H),
                    f"K2-bwd-bf16 ({kind} kernel) T={T} B={B} H={h} (random "
                    f"non-prefix masks, nonzero ghT/gcT): bf16 outputs, "
                    f"max_abs_err {raw[B, h]:.3g}, relative to max(1, |ref|) "
                    f"{errs[B, h]:.3g} <= {TOL_LSTM_BWD_BF16}; one bf16 "
                    f"launch, no f32 one; plan {plan}")
        if h == H:
            at[B] = dict(args=args, plan=plan)
            # each stage kernel against its plain stage on the same
            # inputs: (a) exact, (c) from the same f32 pre-activations
            hs = lstm_k.rebuild_hs(args[5], args[6], args[2], args[3])
            pre = lstm_k.pre_gates(hs, args[4])
            got_c = lstm_k.activate(*args[:4], pre)
            ref_c = lstm_k.activate_plain(*args[:4], pre)
            err_a = float((hs.float() - lstm_k.rebuild_hs_plain(
                args[5], args[6], args[2], args[3]).float()).abs().max())
            err_c = rel_err(got_c, ref_c)
            errs[B, "stages"] = err_c
            fails.check(err_a == 0.0 and err_c <= TOL_LSTM_BWD_BF16,
                        f"K2-bwd-bf16 stages at T={T} B={B} H={h}: (a) the "
                        f"rebuild of hs equals its plain stage ({err_a}); "
                        f"(c) the activation and c's roll from the same f32 "
                        f"pre-activations, relative to max(1, |ref|) "
                        f"{err_c:.3g} <= {TOL_LSTM_BWD_BF16}")
            del hs, pre, got_c, ref_c
        del got, ref
    ptx = [line for m in ("bilstm_bf16_bwd2", "bilstm_bf16_rebuild",
                          "bilstm_bf16_activate")
           for line in _k2_ptxas_lines(log, m)]
    ptx += _k2_ptxas_lines(log, "bilstm_bwd_kernel", "nv_bfloat16")
    for line in ptx:
        print("  K2-bwd-bf16 ptxas:", line, flush=True)
    rows = {}
    for B, run in at.items():
        big = run["args"]
        ms = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop_bwd(*big),
                      10)
        plain_ms = _time_ms(
            torch, lambda: lstm_k.bidir_lstm_time_loop_bwd_plain(*big), 1,
            warmup=1)
        # cuDNN's bf16 backward of one bidirectional layer of the same
        # shape, as phase 2f times the f32 one: a yardstick the port never
        # calls
        cudnn = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev, bf)
        x = torch.randn(T, B, 2 * H, device=dev, generator=g).to(bf)
        x.requires_grad_(True)
        out, _ = cudnn(x)
        gout = torch.randn_like(out)
        wts = [x] + list(cudnn.parameters())
        cudnn_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, wts, gout, retain_graph=True), 10)
        del cudnn, x, out, gout, wts
        # the least work: each bf16 input read once (xg, masks, W_hh, ys,
        # their cotangents), dxg and dW_hh written once; per valid (row,
        # step) three 2 * H * 4H products (the gates' recompute, dh's and
        # dW's) at the dense bf16 rate and ~30 flops a unit of the cell at
        # the f32 rate: the least time is the largest of the three
        valid = float(big[2].float().sum() + big[3].float().sum())
        nbytes = 2 * (2 * T * B * 4 * H * 2 + 2 * T * B + 2 * H * 4 * H * 2
                      + 4 * T * B * H + 4 * B * H)
        bound, by = _bound_ms(nbytes, 3 * valid * 2 * H * 4 * H,
                              H100_BF16_FLOPS)
        cell_ms = valid * 30 * H / H100_F32_FLOPS * 1e3
        if cell_ms > bound:
            bound, by = cell_ms, "operations"
        f32_ms = f32_row["ms"] if B == 32 else f32_row["b128"]["ms"]
        plan = run["plan"]
        print(f"K2-bwd-bf16 at xg 2 x [{T}, {B}, {4 * H}] "
              f"({100 * valid / (2 * T * B):.1f}% of steps valid): {ms:.4f} "
              f"ms; the f32 K2-bwd of phase 2f {f32_ms:.4f} ms; bound "
              f"{bound:.4f} ms ({by}), {100 * bound / ms:.2f}%; twin "
              f"{plain_ms:.1f} ms; cuDNN's bf16 backward of one layer "
              f"{cudnn_ms:.4f} ms; pass 2's plan {plan['clusters']} "
              f"clusters of {plan['ctas']} CTAs, {plan['rows']} rows each, "
              f"{plan['waves']} wave(s) (the card holds "
              f"{plan['max_active_clusters']})", flush=True)
        rows[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       f32_ms=f32_ms, cudnn_layer_bwd_ms=cudnn_ms, plan=plan)
        if B in splits:
            r = splits[B]
            rows[B]["stage_ms"] = r.get("bwd_stage_ms")
            rows[B]["pass2_split_us_a_step"] = r["bwd"]["us_a_step"]
        del big
    for k, v in SPLIT_BEFORE.items():
        if k.startswith("K2-bwd-bf16"):
            print(f"  split before the bf16 redesign (recorded, PERF.md), {k},"
                  f" us a step: {v}", flush=True)
    from chinese_asr_tpu_torch.tools.lstm_stamp import lines
    for B, r in splits.items():
        for line in lines(r)["bwd"]:
            print("  split now: " + line.strip(), flush=True)
    at.clear()
    r32 = rows[32]
    return dict(
        name="K2-bwd-bf16 BiLSTM backward (bf16)", route="cuda",
        source="chinese_asr_tpu_torch/csrc/lstm_bwd.cu",
        replaces="chinese_asr_tpu/ops/rnn.py:297",
        design="pass 1 as stages: (a) the rebuild of hs, (b) hs @ W_hh as "
               "one f32 cuBLAS bmm, (c) the activation and c's roll, time-"
               "parallel; pass 2 a cluster of 8 or 4 CTAs (16 rows), W_hh^T "
               "as bf16 pairs in registers, bf16 mma.m16n8k16, partials "
               "reduce-scattered by st.async on mbarriers",
        plan=r32["plan"], ptxas=ptx, stage_ms=r32.get("stage_ms"),
        pass2_split_us_a_step=r32.get("pass2_split_us_a_step"),
        max_abs_err=max(raw.values()), rel_err=max(errs.values()),
        ms=r32["ms"], plain_ms=r32["plain_ms"], bound_ms=r32["bound_ms"],
        bound_by=r32["bound_by"], bound_peak="bf16 989 TFLOP/s",
        library_ms=None, cudnn_layer_bwd_ms=r32["cudnn_layer_bwd_ms"],
        f32_ms=r32["f32_ms"], b128=rows[128],
        shape=f"bf16 xg, dxg [2 x {T}, 32, {4 * H}], W_hh [2, {H}, {4 * H}]")


def _train_corpus(np, rng, root: str, n: int, vocab_chars: str,
                  secs=(9.0, 10.0), chars=(15, 30)):
    """``n`` speech-like int16 wavs of ``secs`` seconds with seeded
    transcripts of ``chars`` characters over ``vocab_chars``, and their
    manifest."""
    from chinese_asr_tpu_torch.data import dataset
    os.makedirs(root, exist_ok=True)
    utts = []
    for i, pcm in enumerate(_synthetic_wavs(np, rng, n, *secs)):
        path = os.path.join(root, f"t{i}.wav")
        _write_wav_i16(path, pcm)
        k = int(rng.integers(chars[0], chars[1] + 1))
        text = "".join(vocab_chars[j] for j in
                       rng.integers(0, len(vocab_chars), k))
        utts.append(dataset.Utterance(path, text))
    manifest = os.path.join(root, "train.tsv")
    dataset.write_manifest(manifest, utts)
    return manifest, utts


def _fit_run(np, torch, fails, dev, gpu, counters, cfg, manifest, vocab,
             want, label, host_trace: bool = True):
    """``Trainer.fit`` at ``cfg`` (f32 or bf16) over the corpus through the
    port's loader, ending in one greedy eval and a checkpoint: its
    launches against ``want``, the loss falling, the masters and the
    optimizer state float32; ms per step (median of the warm steps: graph
    replays); ``Trainer.evaluate`` replaying its one ``greedy_decode_jit``
    program, its CER against the eager greedy's; one more step split by
    CUDA events (eager); the graph step against the eager one
    (``_step_ab``); peak device memory.  Returns (the run's report, the
    trainer)."""
    from chinese_asr_tpu_torch.data import dataset
    from chinese_asr_tpu_torch.decode.greedy import greedy_decode
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step as step_mod
    from chinese_asr_tpu_torch.train.trainer import Trainer
    from chinese_asr_tpu_torch.utils import graphs

    steps = cfg.train.epochs
    tr = Trainer(cfg, las.init_params(cfg, 0), vocab, device=dev)
    compiled = tr._step_fn
    fails.check(isinstance(compiled, step_mod.CompiledStep),
                f"{label}: Trainer on one card steps through CompiledStep "
                f"({type(compiled).__name__})")

    def train_loader():
        return dataset.batches_to_device(
            dataset.make_train_loader(manifest, cfg, vocab, seed=0), cfg, dev)

    def eval_loader():
        return dataset.batches_to_device(
            dataset.make_eval_loader(manifest, cfg, vocab), cfg, dev)

    losses, walls = [], []

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = compiled(*a)
        losses.append(float(out[2]["loss"]))      # the loop's own sync
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    tr._step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30   # earlier phases
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    keys = {k for k, _ in graphs.programs()}
    t_fit = time.perf_counter()
    tv = tr.fit(train_loader, eval_loader, max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launched = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tr._step_fn = compiled
    # the loader's featurizer: one graph a (B, N), whose first batch runs
    # an eager warm-up (K1 once more) before its capture
    fronts = sum(1 for k, _ in graphs.programs()
                 if k[0] == "featurize_batch" and k not in keys)
    full = dict.fromkeys(counters, 0)
    full.update(want)
    full["logmel.launches"] += fronts
    fails.check(all(launched[n] > 0 if v is None else launched[n] == v
                    for n, v in full.items()),
                f"{label}: kernels launched in {steps} "
                f"steps and one eval {launched}, wanted {full} (None: at "
                f"least once; the first step, the first eval and the "
                f"featurizer's {fronts} new key(s) each run an eager warm-up "
                f"before their capture)")
    fails.check(tv.step == steps and all(np.isfinite(losses))
                and losses[-1] < losses[0],
                f"{label}: {steps} steps at the flagship Config() "
                f"(compute_dtype {cfg.train.compute_dtype}), B=32; the loss "
                f"finite and falling {[round(l, 4) for l in losses]}")
    sg = compiled.graphs
    fails.check(sg.captures == 1 and sg.replays == steps,
                f"{label}: {steps} steps of one bucket, {sg.captures} "
                f"capture(s) and {sg.replays} replays")
    masters = [t.dtype for t in las.tree_leaves(tr.params)]
    states = [v.dtype for v in tr.opt_state.values() if v.is_floating_point()]
    fails.check(set(masters) | set(states) == {torch.float32},
                f"{label}: master params and optimizer state float32 "
                f"({len(masters)} leaves, {len(states)} state tensors)")
    ckpt = tr.ckpt.latest_checkpoint()
    fails.check(ckpt is not None and os.path.basename(ckpt).startswith(
        f"step-{steps}_wer-"), f"{label}: fit wrote {ckpt}")
    warm = walls[1:]
    step_ms = float(np.median(warm)) * 1e3
    print(f"{label}: {steps} steps of B=32 (graph replays), fit "
          f"{fit_s:.1f} s with its eval and checkpoint; step walls "
          f"{[round(w * 1e3, 1) for w in walls]} ms (the first with its "
          f"warm-up and capture), median of the warm {step_ms:.1f} ms on "
          f"{gpu}; wer {tv.best_wer:.4f}; peak device memory "
          f"{peak_gib:.2f} GiB, of it {held_gib:.2f} GiB held before the "
          f"phase", flush=True)

    # Trainer.evaluate through greedy_decode_jit: the fit's eval captured
    # its program, these replay it; the eager greedy's CER on these params
    captured = graphs.captures
    eval_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        wer = tr.evaluate(eval_loader())
        torch.cuda.synchronize()
        eval_walls.append((time.perf_counter() - t) * 1e3)
    eval_ms = float(np.median(eval_walls))
    tr._greedy = lambda f, n: greedy_decode(tr.params, cfg, f, n)
    eager_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eager_wer = tr.evaluate(eval_loader())
        torch.cuda.synchronize()
        eager_walls.append((time.perf_counter() - t) * 1e3)
    del tr._greedy
    fails.check(graphs.captures == captured and wer == eager_wer,
                f"{label}: Trainer.evaluate replays its greedy_decode_jit "
                f"program ({graphs.captures - captured} new captures in 3 "
                f"evals), CER {wer:.6f} = the eager greedy's {eager_wer:.6f}")
    eager_eval_ms = float(np.median(eager_walls))
    print(f"{label}: Trainer.evaluate (greedy_decode_jit, "
          f"{sum(1 for _ in eval_loader())} batch(es) of the corpus) "
          f"{eval_ms:.1f} ms, median of {[round(w, 1) for w in eval_walls]}"
          f"; the eager greedy {eager_eval_ms:.1f} ms on {gpu}", flush=True)

    # one more step on the last batch, split by CUDA events (eager)
    batch = next(iter(train_loader()))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    flat = optim.flatten(tr.params)
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = step_mod.loss_fn(optim.unflatten(tr.params, leaves), cfg,
                               batch, tr._gen)
    ev[1].record()
    # BatchNorm's running stats take no gradient (train_step's zeros)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves.values(), torch.autograd.grad(loss, list(leaves.values()),
                                             allow_unused=True))]
    ev[2].record()
    with torch.no_grad():
        upd, _ = tr.tx.update(dict(zip(leaves, grads)), tr.opt_state, flat)
        _ = {n: p + upd[n] for n, p in flat.items()}
    ev[3].record()
    torch.cuda.synchronize()
    print(f"{label} batch: feats {tuple(batch.feats.shape)}, tokens "
          f"{tuple(batch.tokens_in.shape)}", flush=True)
    split = dict(forward_ms=ev[0].elapsed_time(ev[1]),
                 backward_ms=ev[1].elapsed_time(ev[2]),
                 optimizer_ms=ev[2].elapsed_time(ev[3]))
    del leaves, grads, upd, loss
    print(f"{label} eager step split by CUDA events: {json.dumps(split)}",
          flush=True)
    ab = _step_ab(np, torch, fails, tr, batch, label, gpu, host_trace)
    report = dict(steps=steps, batch=32, compute_dtype=cfg.train.compute_dtype,
                  step_ms=step_ms, step_walls_ms=[w * 1e3 for w in walls],
                  fit_s=fit_s, eval_ms=eval_ms, eager_eval_ms=eager_eval_ms,
                  losses=losses, split=split,
                  busy_ms=ab["graph"]["busy_ms"],
                  busy_share=ab["graph"]["busy_share"],
                  launches_per_step=ab["graph"]["launch_calls"],
                  graph_vs_eager=ab, kernel_launches=launched,
                  peak_gib=peak_gib, held_gib=held_gib, ckpt=ckpt)
    return report, tr


# each K2 / K2-bwd kernel of ours by its name in the card's trace, and the
# launch counters that count it (one K2-bwd-bf16 call runs its stages and
# pass 2, counted once: pass 2 stands for it)
_TRACE_TRAIN = (("K2", ("bilstm_tc_kernel<", "bilstm_bf16_tc_kernel<",
                        "bilstm_kernel<"),
                 ("lstm.launches", "lstm.bf16_launches")),
                ("K2-bwd", ("bilstm_bwd_tc_kernel<", "bilstm_bf16_bwd2_kernel",
                            "bilstm_bwd_kernel<"),
                 ("lstm.bwd_launches", "lstm.bwd_bf16_launches")))


def _step_ab(np, torch, fails, tr, batch, label, gpu,
             host_trace: bool = True) -> dict:
    """The trainer's graph step (``CompiledStep``, a replay that updates
    its state) against the eager ``train_step`` on the same state and
    batch (its result dropped), in turns, GRAPH_AB_RUNS walls each to the
    loop's host read of the loss; one profile of each (launch calls,
    kernels, busy share, host syncs; without ``host_trace`` the eager step
    is traced on the card alone; the graph step's the fullest of
    TRACE_TRIES, ``_fullest_trace``), and the card's trace of one replay
    held against the K2 / K2-bwd launch counters (one each a BiLSTM
    layer);
    the step graphs' captures, capture ms and pool bytes."""
    from chinese_asr_tpu_torch.train import step as step_mod
    compiled = tr._step_fn
    cfg = tr.cfg
    enc = cfg.encoder
    layers = (enc.num_layers if enc.encoder_type == "LSTM"
              and enc.bidirectional else 0)
    paths = {
        "graph": lambda: float(compiled(tr.params, tr.opt_state, batch,
                                        tr._gen)[2]["loss"]),
        "eager": lambda: float(step_mod.train_step(
            tr.params, tr.opt_state, cfg, tr.tx, batch, tr._gen)[2]["loss"])}
    for fn in paths.values():
        fn()
    walls = {k: [] for k in paths}
    for _ in range(GRAPH_AB_RUNS):
        for k, fn in paths.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t) * 1e3)
    counters = _kernel_counters()
    out = {}
    for k, fn in paths.items():
        med = float(np.median(walls[k]))
        if k == "graph":
            prof, counted = _fullest_trace(torch, fn, counters)
            rows = sorted(prof.pop("rows"), reverse=True)
        elif host_trace:
            prof = _launch_profile(torch, fn)
            rows = sorted(prof.pop("rows"), reverse=True)
        else:
            busy, n, rows = _device_profile(torch, fn, host_ops=False)
            prof = dict(busy_ms=busy, kernels=n, launch_calls=None,
                        graph_launches=0, host_syncs=None)
        out[k] = dict(wall_ms=med, wall_ms_min=min(walls[k]),
                      wall_ms_max=max(walls[k]), walls_ms=walls[k], **prof,
                      busy_share=prof["busy_ms"] / med)
        if k == "graph":
            traced = {name: (sum(c for _, c, key in rows
                                 if any(x in key for x in keys)),
                             sum(counted[n] for n in ctrs))
                      for name, keys, ctrs in _TRACE_TRAIN}
            out["traced_vs_counted"] = traced
            fails.check(all(t == c == layers for t, c in traced.values()),
                        f"{label}: the card's trace of one step replay "
                        f"launched what the counters count ({layers} each), "
                        f"K2 / K2-bwd (traced, counted) {traced}")
            top = rows[:12]
    g, e = out["graph"], out["eager"]
    fails.check(g["launch_calls"] <= 20 and g["graph_launches"] == 1,
                f"{label}: a graph step makes {g['launch_calls']} launch "
                f"calls ({g['graph_launches']} graph launch) against the "
                f"eager step's {e['launch_calls'] or e['kernels']}")
    sg = compiled.graphs
    out.update(captures=sg.captures, replays=sg.replays,
               pool_bytes=sg.pool_bytes, capture_ms=sg.capture_ms)
    print(_ab_line(f"{label} step", out, gpu).replace("3g ", "4 ", 1)
          + f"; step graphs: {sg.captures} capture(s) "
          f"({sg.capture_ms:.0f} ms), pool {sg.pool_bytes / 2**20:.1f} MiB",
          flush=True)
    for us, count, key in top:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return out


def _bucket_fit(np, torch, fails, dev, cfg, manifests, vocab, label):
    """``Trainer.fit`` over two (T, S) buckets (the long and the short
    corpus, in turns, 4 steps) through the step graphs, against the same
    fit with the eager ``train_step``: one capture a bucket into the one
    pool, every step's metrics and the final params and optimizer state
    equal bit for bit (the same kernels in the same order)."""
    from chinese_asr_tpu_torch.data import dataset
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import step as step_mod
    from chinese_asr_tpu_torch.train.trainer import Trainer

    cfg = cfg.with_("train", save_dir=cfg.train.save_dir + "_buckets")

    def loader():           # long, short, long, short: one batch each
        for _ in range(2):
            for m in manifests:
                yield next(iter(dataset.batches_to_device(
                    dataset.make_train_loader(m, cfg, vocab, seed=0), cfg,
                    dev)))

    runs = {}
    for kind in ("graph", "eager"):
        tr = Trainer(cfg, las.init_params(cfg, 0), vocab, device=dev)
        if kind == "eager":
            tr._step_fn = lambda p, o, b, g, tr=tr: step_mod.train_step(
                p, o, cfg, tr.tx, b, g)
        losses, shapes, orig = [], [], tr._step_fn

        def rec(p, o, b, g, orig=orig, losses=losses, shapes=shapes):
            out = orig(p, o, b, g)
            losses.append(out[2])
            shapes.append((tuple(b.feats.shape), tuple(b.tokens_in.shape)))
            return out

        tr._step_fn = rec
        tr.fit(loader, None, max_steps=4)
        runs[kind] = dict(losses=losses, shapes=shapes, params=tr.params,
                          opt_state=tr.opt_state,
                          graphs=getattr(orig, "graphs", None))
        for f in os.listdir(cfg.train.save_dir):
            if f.endswith(".ckpt"):
                os.remove(os.path.join(cfg.train.save_dir, f))
    g, e = runs["graph"], runs["eager"]
    sg = g["graphs"]
    # the same kernels in the same order: every step bit for bit, and the
    # final params and optimizer state
    differs = [[k for k in ("loss", "grad_norm", "skipped")
                if not torch.equal(a[k], b[k])]
               for a, b in zip(g["losses"], e["losses"])]
    differs.append(_step_differs(torch, las, g["params"], g["opt_state"],
                                 g["losses"][-1], e["params"],
                                 e["opt_state"], e["losses"][-1]))
    progs = sg.programs()
    fails.check(len(set(g["shapes"])) == 2 and sg.captures == 2
                and sg.replays == 4 and len(progs) == 2
                and not any(differs),
                f"{label}: fit over 2 buckets {sorted(set(g['shapes']))}: "
                f"{sg.captures} captures into one pool, {sg.replays} replays;"
                f" graph against eager bit for bit at every step and in the "
                f"final params and optimizer state (what differs: "
                f"{differs})")
    out = dict(shapes=[list(map(list, s)) for s in sorted(set(g["shapes"]))],
               losses_graph=[float(m["loss"]) for m in g["losses"]],
               losses_eager=[float(m["loss"]) for m in e["losses"]],
               differs=differs, captures=sg.captures,
               pool_bytes=sg.pool_bytes, input_bytes=sg.input_bytes(),
               programs=[dict(reserved_bytes=p.reserved_bytes,
                              capture_ms=p.capture_ms, replays=p.replays)
                         for _, p in progs])
    print(f"{label} fit over 2 buckets: {json.dumps(out)}", flush=True)
    return out


def _big_batch_step(np, torch, fails, dev, gpu, cfg, rng):
    """The compiled step at the config's own ``batch_size`` (256): one
    capture and 3 replays on a featurized batch of 9-10 s wavs with
    30-token targets: the pool's bytes, the capture ms, the replay walls
    and peak memory; where it does not fit in the card's memory, that is
    reported."""
    from chinese_asr_tpu_torch.audio import features
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train.trainer import Trainer

    B, S = cfg.train.batch_size, 32
    wavs = _synthetic_wavs(np, rng, B, 9.0, 10.0)
    n = max(len(w) for w in wavs)
    mat = np.zeros((B, n), np.float32)
    for i, w in enumerate(wavs):
        mat[i, :len(w)] = w / 32768.0
    wlens = np.array([len(w) for w in wavs], np.int32)
    text = rng.integers(4, cfg.vocab.vocab_size, (B, S))
    tl = rng.integers(16, S + 1, B).astype(np.int32)
    ti = np.concatenate([np.full((B, 1), cfg.vocab.sos), text[:, :-1]], 1)
    to = text.copy()
    to[np.arange(B), tl - 1] = cfg.vocab.eos
    for i in range(B):
        ti[i, tl[i]:] = to[i, tl[i]:] = cfg.vocab.pad
    feats, flens = features.featurize_batch(
        torch.from_numpy(mat).to(dev), torch.from_numpy(wlens).to(dev),
        cfg.audio)
    batch = Batch(feats, flens, *(torch.from_numpy(a.astype(np.int32)).to(dev)
                                  for a in (ti, to, tl)))
    tr = Trainer(cfg, las.init_params(cfg, 0), None, device=dev)
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(tr._step_fn(tr.params, tr.opt_state, batch,
                                            tr._gen)[2]["loss"]))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    except torch.cuda.OutOfMemoryError as e:
        print(f"4 step at B={B} ({cfg.train.compute_dtype}): does not fit "
              f"on {gpu}: {str(e)[:300]}", flush=True)
        return dict(batch=B, fits=False)
    sg = tr._step_fn.graphs
    fails.check(sg.captures == 1 and all(np.isfinite(losses)),
                f"4 step at B={B} ({cfg.train.compute_dtype}): one capture, "
                f"losses finite {[round(x, 4) for x in losses]}")
    out = dict(batch=B, fits=True, feats=list(feats.shape), tokens=[B, S],
               pool_bytes=sg.pool_bytes, capture_ms=sg.capture_ms,
               first_ms=walls[0], replay_ms=float(np.median(walls[1:])),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"4 step at B={B} ({cfg.train.compute_dtype}) on {gpu}: "
          f"{json.dumps(out)}", flush=True)
    return out


MEMORY_MIX_KEYS = 12     # phase 4: the epoch's first keys at B=256


def _memory_mix(torch, fails, dev, gpu):
    """The compiled step's memory over the first MEMORY_MIX_KEYS keys an
    epoch of the AISHELL-1 model meets in the loader's order (short to
    long), at the flagship ``Config()``'s batch of 256, f32
    (``tools/step_memory.py``; its full sweeps are run apart): every key
    one capture, the static inputs shared (under four times the largest
    key's), the pool and the inputs within the budget plus one capture."""
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.tools import step_memory
    from chinese_asr_tpu_torch.utils import graphs

    cfg = Config().with_("train", save_dir=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "step_mem"))
    samples, chars = step_memory.corpus()
    keys = list(dict.fromkeys(step_memory.epoch_keys(cfg, samples, chars)))
    budget = graphs.STEP_BUDGET_FRACTION
    res = step_memory.sweep(torch, cfg, keys[:MEMORY_MIX_KEYS], dev, budget)
    out, rows = res["summary"], res["rows"]
    bound = (budget * torch.cuda.get_device_properties(dev).total_memory
             + out["largest_capture_bytes"])
    fails.check(out["keys"] == out["captures"] == MEMORY_MIX_KEYS
                and out["finite"] and out["stopped"] is None
                and out["input_bytes"] < 4 * out["largest_key_input_bytes"]
                and all(r["pool_bytes"] + r["input_bytes"] <= bound
                        for r in rows),
                f"4 memory mix: {out['keys']} keys of an epoch at B=256 on "
                f"{gpu}, {out['captures']} captures, {out['resets']} resets;"
                f" pool {out['peak_pool_bytes'] / 2**30:.2f} GiB at most, "
                f"inputs {out['input_bytes'] / 2**20:.0f} MiB against the "
                f"largest key's {out['largest_key_input_bytes'] / 2**20:.0f}")
    print(f"4 memory mix: {json.dumps(out)}", flush=True)
    print("4 memory mix rows: " + json.dumps(
        [[r["key"], r["pool_bytes"], r["input_bytes"], r["capture_bytes"],
          round(r["step_ms"], 1)] for r in rows]), flush=True)
    return out


def _golden_step(np, torch, fails, dev, compute_dtype):
    """The golden model's train_step on the card against the CPU port from
    the same params and batch, at the tolerances of
    tests/test_torch_port_cuda.py: f32 loss 1e-5 relative, grad norm 1e-4,
    params 2e-5 absolute; bf16 (both round to bf16 from sums in other
    orders) loss 1e-2, grad norm 2e-2, params 2.5e-3 (one ADAM step of lr
    1e-3 whose gradient took the other sign) with at most 1 % of the
    elements farther apart than 1e-4."""
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step as step_mod
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    gcfg = (Config().with_("audio", n_mels=8, delta_delta=False,
                           downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=8)
            .with_("train", clip=1.0, compute_dtype=compute_dtype))
    pn = load_checkpoint(os.path.join(gold, "model.ckpt"))["params"]
    grng = np.random.RandomState(0)
    gB, gT, gS = 6, 40, 5
    feats = grng.randn(gB, gT, gcfg.audio.feat_dim).astype(np.float32)
    lens = np.array([40, 31, 40, 25, 12, 40], np.int32)
    feats[np.arange(gT)[None, :] >= lens[:, None]] = 0
    text = grng.randint(4, gcfg.vocab.vocab_size, (gB, gS))
    host = (feats, lens, np.concatenate([np.ones((gB, 1), int), text[:, :-1]],
                                        1),
            np.concatenate([text[:, :-1], np.full((gB, 1), 2)], 1),
            np.full(gB, gS, np.int32))
    res = []
    for d in ("cpu", dev):
        params = las.params_from_numpy(pn, d)
        tx = optim.make_optimizer(gcfg.train)
        b = Batch(*(torch.tensor(a).to(d) for a in host))
        res.append(step_mod.train_step(params, tx.init(params), gcfg, tx, b))
    # the compiled step on the card (a capture, then a replay: its second
    # step against the eager second step from the eager first's state)
    params = las.params_from_numpy(pn, dev)
    tx = optim.make_optimizer(gcfg.train)
    state = tx.init(params)
    b = Batch(*(torch.tensor(a).to(dev) for a in host))
    compiled = step_mod.CompiledStep(gcfg, tx)
    _, _, m1 = compiled(params, state, b)
    graph = [(las.tree_map(torch.clone, params),
              {k: v.clone() for k, v in state.items()}, m1)]
    _, _, m2 = compiled(params, state, b)
    graph.append((params, state, m2))
    pe, oe, _ = res[1]
    eager = [res[1], step_mod.train_step(pe, oe, gcfg, tx, b)]
    if compute_dtype == "float32":
        tol = dict(loss=1e-5, norm=1e-4, par=2e-5, far=0.0)
    else:
        tol = dict(loss=1e-2, norm=2e-2, par=2.5e-3, far=1e-2)

    def gaps(p_got, m_got, p_ref, m_ref):
        diff = torch.cat([(a.cpu() - b.cpu()).abs().ravel() for a, b in
                          zip(las.tree_leaves(p_got),
                              las.tree_leaves(p_ref))])
        return dict(
            loss_rel=abs(float(m_got["loss"]) / float(m_ref["loss"]) - 1),
            grad_norm_rel=abs(float(m_got["grad_norm"])
                              / float(m_ref["grad_norm"]) - 1),
            params=float(diff.max()),
            params_far_share=float((diff > 1e-4).float().mean()))

    def within(g):
        return (g["loss_rel"] <= tol["loss"]
                and g["grad_norm_rel"] <= tol["norm"]
                and g["params"] <= tol["par"]
                and g["params_far_share"] <= tol["far"])

    (pc, _, mc), (pg, _, mg) = res
    out = gaps(pg, mg, pc, mc)
    fails.check(within(out),
                f"golden train_step ({compute_dtype}) card vs CPU port: loss "
                f"rel {out['loss_rel']:.3g} <= {tol['loss']}, grad norm rel "
                f"{out['grad_norm_rel']:.3g} <= {tol['norm']}, params "
                f"{out['params']:.3g} <= {tol['par']}, share of params "
                f"farther apart than 1e-4 {out['params_far_share']:.3g} <= "
                f"{tol['far']}")
    # graph against eager on the card: the same kernels in the same order,
    # so bit for bit
    out["graph_vs_eager"] = [_step_differs(torch, las, *g, *e)
                             for g, e in zip(graph, eager)]
    fails.check(not any(out["graph_vs_eager"])
                and compiled.graphs.captures == 1
                and compiled.graphs.replays == 2,
                f"golden train step ({compute_dtype}) on the card, the "
                f"compiled step (a capture and a replay) against the eager "
                f"one, two steps, bit for bit (what differs: "
                f"{out['graph_vs_eager']})")
    return out


def _step_differs(torch, las, p_got, o_got, m_got, p_ref, o_ref, m_ref):
    """What of one train step's result differs at all from another's: the
    metrics by name, the param and optimizer state leaves by count."""
    bad = [k for k in ("loss", "grad_norm", "skipped")
           if not torch.equal(m_got[k], m_ref[k])]
    n_par = sum(not torch.equal(a, b) for a, b in
                zip(las.tree_leaves(p_got), las.tree_leaves(p_ref)))
    n_opt = sum(not torch.equal(o_got[k], o_ref[k]) for k in o_ref)
    return bad + ([f"{n_par} param leaves"] if n_par else []) + (
        [f"{n_opt} optimizer state leaves"] if n_opt else [])


def _phase_training(np, torch, fails, dev, gpu, counters, build_dir):
    """Phase 4: training at the flagship ``Config()`` on the card (ADAM,
    seeded random weights), in f32 and in bf16 mixed precision:
    ``Trainer.fit`` over a synthetic corpus through the port's loader,
    checks and per-step numbers, the compiled step (``CompiledStep``, a
    graph a bucket) against the eager one (walls in turns, launch calls,
    busy share, the trace against the counters), a fit over two buckets,
    the step at the config's own batch of 256 (pool bytes), the golden
    model's train step against the CPU port and graph against eager in
    both, the f32 checkpoint in ``ASR``, and the train CLI (f32 and
    ``--bf16``).  Returns the path's report."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.utils import graphs
    from chinese_asr_tpu_torch.vocab import Vocab

    rng = np.random.default_rng(8)
    root = os.path.join(build_dir, "train_corpus")
    saves = [os.path.join(build_dir, d) for d in ("train_ckpt",
                                                  "train_ckpt_bf16")]
    chars = "".join(chr(0x4E00 + i) for i in range(5000))
    vocab = Vocab.build([chars], max_num_words=5000)
    steps = 6
    cfg = Config().with_("train", batch_size=32, eval_batch_size=32,
                         epochs=steps, num_eval_steps=1000, save_dir=saves[0],
                         seed=0)
    assert len(vocab) == cfg.vocab.vocab_size
    manifest, utts = _train_corpus(np, rng, root, 32, chars)
    short, _ = _train_corpus(np, rng, root + "_short", 32, chars,
                             secs=(4.0, 5.0), chars=(6, 12))
    # per step K1 1 (the loader featurizes), K2 4 and K2-bwd 4 (their bf16
    # instances in bf16); the f32 eval at the end (one batch of 32) adds K1
    # 1 and K2 4; the first step and the first eval each run an eager
    # warm-up before their capture: K2 4 and K2-bwd 4 more, K2 4 more; K7
    # runs the f32 eval's decode products, none of the steps' (under
    # autograd, counted as fallbacks; None: at least once)
    on_k7 = {"gemm.launches": None, "gemm.fallbacks": None}
    f32, tr = _fit_run(np, torch, fails, dev, gpu, counters, cfg, manifest,
                       vocab, {"logmel.launches": steps + 1,
                               "lstm.launches": 4 * steps + 12,
                               "lstm.bwd_launches": 4 * steps + 4,
                               **on_k7},
                       "training")
    ckpt = f32.pop("ckpt")
    del tr
    graphs.clear()
    cfg16 = cfg.with_("train", compute_dtype="bfloat16", save_dir=saves[1])
    bf16, tr = _fit_run(np, torch, fails, dev, gpu, counters, cfg16, manifest,
                        vocab, {"logmel.launches": steps + 1,
                                "lstm.launches": 8,
                                "lstm.bf16_launches": 4 * steps + 4,
                                "lstm.bwd_bf16_launches": 4 * steps + 4,
                                **on_k7},
                        "training bf16")
    bf16.pop("ckpt")
    del tr
    graphs.clear()
    ab32, ab16 = f32["graph_vs_eager"], bf16["graph_vs_eager"]
    print(f"training bf16 against f32 in this run: graph step "
          f"{ab16['graph']['wall_ms']:.1f} against "
          f"{ab32['graph']['wall_ms']:.1f} ms (eager "
          f"{ab16['eager']['wall_ms']:.1f} against "
          f"{ab32['eager']['wall_ms']:.1f}); busy {bf16['busy_ms']:.1f} "
          f"against {f32['busy_ms']:.1f} ms; backward (eager, events) "
          f"{bf16['split']['backward_ms']:.1f} against "
          f"{f32['split']['backward_ms']:.1f} ms; peak {bf16['peak_gib']:.2f} "
          f"against {f32['peak_gib']:.2f} GiB", flush=True)
    for report, c, label in ((f32, cfg, "training"),
                             (bf16, cfg16, "training bf16")):
        report["buckets"] = _bucket_fit(np, torch, fails, dev, c,
                                        (manifest, short), vocab, label)
        report["batch_256"] = _big_batch_step(
            np, torch, fails, dev, gpu,
            c.with_("train", batch_size=Config().train.batch_size), rng)
        torch.cuda.empty_cache()
    f32["memory_mix"] = _memory_mix(torch, fails, dev, gpu)
    torch.cuda.empty_cache()
    f32["golden_card_vs_cpu"] = _golden_step(np, torch, fails, dev, "float32")
    bf16["golden_card_vs_cpu"] = _golden_step(np, torch, fails, dev,
                                              "bfloat16")

    # the checkpoint fit wrote, in ASR on the card
    asr = ASR(ckpt_path=ckpt, cfg=cfg, vocab=vocab, bw=4, device=dev)
    texts = asr.transcribe_files([u.path for u in utts[:4]])
    fails.check(len(texts) == 4 and all(isinstance(s, str) for s in texts),
                f"training: {os.path.basename(ckpt)} transcribes in ASR on "
                f"the card {[s[:12] for s in texts]}")
    del asr

    # the train CLI, 2 steps on the card (its default device), f32 and bf16
    vpath = os.path.join(root, "vocab.pkl")
    vocab.save(vpath)
    for report, flags in ((f32, []), (bf16, ["--bf16"])):
        cli_save = os.path.join(build_dir,
                                "train_cli_ckpt" + ("_bf16" if flags else ""))
        saves.append(cli_save)
        t = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "chinese_asr_tpu_torch.train",
             "--train-manifest", manifest, "--vocab", vpath, "--batch-size",
             "32", "--epochs", "2", "--max-steps", "2", "--save-dir",
             cli_save, *flags],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
        report["cli_s"] = time.perf_counter() - t
        last = cli.stdout.strip().splitlines()[-1][:100] if cli.stdout else ""
        fails.check(cli.returncode == 0 and "done: step 2" in cli.stdout
                    and any(f.startswith("step-2_wer-")
                            for f in os.listdir(cli_save)),
                    f"train CLI {' '.join(flags)}: 2 steps on the card in "
                    f"{report['cli_s']:.1f} s ({last})")
    for d in [root, root + "_short"] + saves + [
            save + "_buckets" for save in saves[:2]]:
        for f in os.listdir(d):
            if f.endswith((".ckpt", ".wav", ".npy")):
                os.remove(os.path.join(d, f))
    return dict(f32, bf16=bf16)


# phase 3f: each encoder family, and each decoder / attention variant on
# the LSTM encoder, at the flagship Config() with one field changed
FAMILY_RUNS = (
    [(et.lower(), dict(encoder=dict(encoder_type=et)))
     for et in ("CNN1D", "CNN2D", "GRU", "RNN_TANH", "RNN_RELU",
                "SELF_ATTENTION", "SELF_LOCAL_ATTENTION", "CNN1D_RNN",
                "CNN1D_SELF_ATTENTION", "CRNN", "DCNN")]
    + [("lstm_unidirectional", dict(encoder=dict(bidirectional=False))),
       ("decoder_gru", dict(decoder=dict(decoder_type="GRU"))),
       ("attn_luong", dict(attention=dict(attn_type="L"))),
       ("attn_heads4_map_linear", dict(attention=dict(
           heads=4, map_enc=True, linear_map=True)))])
FAMILY_WARM_RUNS = 3            # warm walls behind each family's median
TOL_FAMILY_ENC = 1e-4           # card vs CPU encoder, of max(1, max |ref|)


def _device_profile(torch, fn, host_ops: bool = True):
    """One call of ``fn`` under torch.profiler -> (kernel busy ms, kernel
    launches, the device kernel rows by time); rows is empty when the
    trace has no device time.  ``host_ops=False`` traces the device
    alone, which a run of tens of thousands of launches summarizes much
    faster."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    return (sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows), rows)


def _family_step(np, torch, fails, dev, cfg):
    """One train_step of ``cfg`` (CNN1D_RNN at full width: a BatchNorm
    front and a GRU stack) on the card against the CPU port, from the same
    params and a small batch (B=4, 60 frames, 6 tokens), at PERF.md
    section 2's f32 bounds: loss 1e-5 relative, grad norm 1e-4, params
    2e-5, BN running stats 1e-5.  SGD: the conv bias before each
    BatchNorm has a zero gradient up to rounding, which Adam would turn
    into a full-lr step of either sign on each device."""
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.train import optim, step as step_mod

    cfg = cfg.with_("train", optimizer="SGD", clip=1.0)
    r = np.random.RandomState(3)
    B, T, S = 4, 60, 6
    feats = r.randn(B, T, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([60, 47, 60, 33], np.int32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0
    text = r.randint(4, cfg.vocab.vocab_size, (B, S))
    host = (feats, lens,
            np.concatenate([np.ones((B, 1), int), text[:, :-1]], 1),
            np.concatenate([text[:, :-1], np.full((B, 1), 2)], 1),
            np.full(B, S, np.int32))
    res = []
    for d in ("cpu", dev):
        params = las.init_params(cfg, 0, d)
        tx = optim.make_optimizer(cfg.train)
        b = Batch(*(torch.tensor(a).to(d) for a in host))
        res.append(step_mod.train_step(params, tx.init(params), cfg, tx, b))
    (pc, _, mc), (pg, _, mg) = res
    dloss = abs(float(mg["loss"]) / float(mc["loss"]) - 1)
    dnorm = abs(float(mg["grad_norm"]) / float(mc["grad_norm"]) - 1)
    pairs = list(zip(las.tree_paths(pg), las.tree_paths(pc)))
    dpar = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in pairs)
    dbn = max(float((a.cpu() - b).abs().max()) for (p, a), (_, b) in pairs
              if p[-1] in ("bn_mean", "bn_var"))
    fails.check(dloss <= 1e-5 and dnorm <= 1e-4 and dpar <= 2e-5
                and dbn <= 1e-5,
                f"3f: CNN1D_RNN train_step card vs CPU port: loss rel "
                f"{dloss:.3g} <= 1e-05, grad norm rel {dnorm:.3g} <= 1e-04, "
                f"params {dpar:.3g} <= 2e-05, BN running stats {dbn:.3g} "
                f"<= 1e-05")
    return dict(loss_rel=dloss, grad_norm_rel=dnorm, params=dpar,
                bn_stats=dbn)


def _phase_families(np, torch, fails, ASR, base_cfg, wavs, rng, dev,
                    counters, gpu, build_dir):
    """Phase 3f: each encoder family and decoder / attention variant at
    full width.  For each run of ``FAMILY_RUNS``: ``ASR(bw=16)`` on the
    B=32 batch, its launches (K1 1, K3 40, K2 4 only on a bidirectional
    LSTM encoder), two runs' transcripts equal, the median of
    ``FAMILY_WARM_RUNS`` warm walls and one profiled run's kernel
    launches and busy share; on 2 wavs of 2 s (features from the CPU
    port) the card's encoder output against the CPU port's and their
    greedy tokens.  Then ``Trainer.fit`` of CNN1D_RNN for 4 steps of B=32,
    and its train step card vs CPU.  Returns the report."""
    from chinese_asr_tpu_torch.decode import greedy
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.vocab import Vocab

    cpu_asr = ASR(bw=None, cfg=base_cfg, seed=0, device="cpu")
    small = _synthetic_wavs(np, rng, 2, 2.0, 2.0)
    feats, flens = cpu_asr._featurize(cpu_asr._upload(cpu_asr._prep(small,
                                                                    None)))
    del cpu_asr
    report = {}
    for name, over in FAMILY_RUNS:
        cfg = base_cfg
        for sec, kw in over.items():
            cfg = cfg.with_(sec, **kw)
        t_run = time.time()
        asr = ASR(bw=16, cfg=cfg, seed=0, device=dev)
        runs = []
        for _ in range(2):
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts = asr.transcribe_wavs(wavs)
            torch.cuda.synchronize()
            runs.append((texts, time.perf_counter() - t,
                         {n: getattr(m, a) for n, (m, a)
                          in counters.items()}))
        # the first call captures the decode's graphs (its eager warm-up
        # launches count too); the second replays them
        (t1, w1, _), (t2, w2, c1) = runs
        bilstm = (cfg.encoder.encoder_type == "LSTM"
                  and cfg.encoder.bidirectional)
        want = dict.fromkeys(counters, 0)
        want.update({"logmel.launches": 1, "topk.launches": 40,
                     "lstm.launches": 4 if bilstm else 0,
                     "attention.launches":
                         40 if cfg.attention.heads == 1 else 0,
                     # K7: the projection a step, and an LSTM layer's two
                     # gate products
                     "gemm.launches": 40 * (1 + 2 * cfg.decoder.num_layers
                                            * (cfg.decoder.decoder_type
                                               == "LSTM"))})
        fails.check(c1 == want, f"3f {name}: kernels launched {c1} by a "
                                f"replay, wanted {want}")
        fails.check(t1 == t2 and len(t1) == len(wavs)
                    and all(isinstance(x, str) for x in t1),
                    f"3f {name}: two runs give identical transcripts")
        walls = [w2]
        for _ in range(FAMILY_WARM_RUNS - 1):
            t = time.perf_counter()
            asr.transcribe_wavs(wavs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        wall_ms = float(np.median(walls)) * 1e3
        t_prof = time.time()
        busy_ms, n_launch, rows = _device_profile(
            torch, lambda: asr.transcribe_wavs(wavs), host_ops=False)
        t_prof = time.time() - t_prof
        # the small input: the same CPU features through both devices
        p_cpu = las.tree_map(lambda t: t.cpu(), asr.params)
        ref = las.encode(p_cpu, cfg, feats, flens).enc_out
        got = las.encode(asr.params, cfg, feats.to(asr.device),
                         flens.to(asr.device)).enc_out.cpu()
        err = float((got - ref).abs().max()) / max(1.0,
                                                   float(ref.abs().max()))
        g_cpu = greedy.greedy_decode(p_cpu, cfg, feats, flens)
        g_card = greedy.greedy_decode(asr.params, cfg, feats.to(asr.device),
                                      flens.to(asr.device))
        same = (torch.equal(g_card.tokens.cpu(), g_cpu.tokens)
                and torch.equal(g_card.final_lens.cpu(), g_cpu.final_lens))
        # the graph path on the card against the eager loop, field by field
        g_jit = greedy.greedy_decode_jit(asr.params, cfg,
                                         feats.to(asr.device),
                                         flens.to(asr.device))
        jit_same = all(torch.equal(a, b) for a, b in zip(g_jit, g_card))
        fails.check(err <= TOL_FAMILY_ENC and same and jit_same,
                    f"3f {name}: card vs CPU port on 2 wavs of 2 s: encoder "
                    f"{err:.3g} <= {TOL_FAMILY_ENC} of max(1, max|ref|), "
                    f"greedy tokens equal {same}; greedy_decode_jit equals "
                    f"the eager greedy on the card {jit_same}")
        report[name] = dict(wall_ms=wall_ms, walls_ms=[w * 1e3 for w in walls],
                            wall_ms_first=w1 * 1e3, launches=n_launch,
                            busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
                            kernel_launches=c1, enc_rel_err=err,
                            top=[(round(us / 1e3, 3), n, k[:60])
                                 for us, n, k in rows[:5]])
        print(f"3f {name}: enc {tuple(got.shape)}; wall median "
              f"{wall_ms:.1f} ms of {len(walls)} warm runs "
              f"{[round(w * 1e3, 1) for w in walls]} (first "
              f"{w1 * 1e3:.0f} ms) on {gpu}; {n_launch} kernel launches a "
              f"batch, busy {busy_ms:.1f} ms = "
              f"{100 * busy_ms / wall_ms:.1f}%; counters {c1}; the run took "
              f"{time.time() - t_run:.1f} s, its profile {t_prof:.1f} s",
              flush=True)
        del asr, p_cpu
        torch.cuda.empty_cache()
    slow = max(report, key=lambda n: report[n]["wall_ms"])
    print(f"3f slowest: {slow}, {report[slow]['wall_ms']:.1f} ms, busy "
          f"{100 * report[slow]['busy_share']:.1f}% of its wall; its "
          f"largest kernels {report[slow]['top']}", flush=True)

    # training: CNN1D_RNN under autograd (BatchNorm front + GRU stack)
    t_train = time.time()
    cfg = base_cfg.with_("encoder", encoder_type="CNN1D_RNN")
    report["train_step_card_vs_cpu"] = _family_step(np, torch, fails, dev,
                                                    cfg)
    root = os.path.join(build_dir, "family_corpus")
    chars = "".join(chr(0x4E00 + i) for i in range(5000))
    vocab = Vocab.build([chars], max_num_words=5000)
    manifest, _ = _train_corpus(np, np.random.default_rng(9), root, 32, chars)
    steps = 4
    cfg = cfg.with_("train", batch_size=32, eval_batch_size=32, epochs=steps,
                    num_eval_steps=1000, seed=0,
                    save_dir=os.path.join(build_dir, "family_ckpt"))
    fit, tr = _fit_run(np, torch, fails, dev, gpu, counters, cfg, manifest,
                       vocab, {"logmel.launches": steps + 1,
                               "gemm.launches": None,
                               "gemm.fallbacks": None},
                       "3f training CNN1D_RNN",
                       host_trace=False)
    init = las.init_params(cfg, 0)
    moved = [float((tr.params["encoder"]["front"]["convs"][i][k].cpu()
                    - init["encoder"]["front"]["convs"][i][k]).abs().max())
             for i in range(2) for k in ("bn_mean", "bn_var")]
    fails.check(min(moved) > 0, f"3f training CNN1D_RNN: the BN running "
                                f"stats moved {[round(m, 4) for m in moved]}")
    fit.pop("ckpt")
    report["training_cnn1d_rnn"] = dict(fit, bn_moved=moved)
    print(f"3f training took {time.time() - t_train:.1f} s", flush=True)
    del tr
    for d in (root, cfg.train.save_dir):
        for f in os.listdir(d):
            if f.endswith((".ckpt", ".wav", ".npy")):
                os.remove(os.path.join(d, f))
    return report


# ---- phase 4b: the mesh ------------------------------------------------------
MESH_SHAPE = (2, 2)             # data x model, ranks sharing the one card
MESH_WARM_RUNS = 3              # warm walls behind each mesh run's median
MESH_TRAIN_STEPS = 3
# at random weights a 2x2 mesh may flip a near-tie (cuBLAS may take another
# GEMM at N = 2502 than at 5004): a few rows of 32, each won by at most
# 1/128, the yardstick of f32 reassociation at the flagship width
MESH_MAX_DIFFER = 3
MESH_NEAR_TIE = 1 / 128


def _kernel_counters():
    """The program's registered counters (``utils/observe.py``), name ->
    (module, attribute): every kernel's launches and fallbacks and the
    Conformer's and the E-Branchformer's blocks, once the modules that
    register them are imported."""
    import chinese_asr_tpu_torch.api  # noqa: F401
    import chinese_asr_tpu_torch.models.conformer  # noqa: F401
    import chinese_asr_tpu_torch.models.e_branchformer  # noqa: F401
    from chinese_asr_tpu_torch.utils import observe
    return observe.counters()


def _mesh_decode(torch, np, asr, wavs, counters):
    """One counted ``transcribe_wavs`` (its launches and collectives), then
    MESH_WARM_RUNS timed ones."""
    from chinese_asr_tpu_torch.parallel import sharding

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    sharding.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    texts = asr.transcribe_wavs(wavs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    coll = dict(sharding.counts)
    walls = []
    for _ in range(MESH_WARM_RUNS):
        t = time.perf_counter()
        again = asr.transcribe_wavs(wavs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return dict(texts=texts, stable=again == texts, launches=launches,
                collectives=coll, wall_s_first=first,
                wall_s=float(np.median(walls)), walls_s=walls)


def _mesh_gaps(torch, asr, wavs, rows):
    """For the differing rows ``rows``: the margin by which the winner beat
    its runner-up on the ASR's mesh.  A beam: the winner's selection score
    against the next slot's (raw logp; with the LM second pass the
    rescored sum; the first pass's LM-fused score), or the live beams'
    where no slot finished.  Greedy: the smallest top-2 logp margin along
    the row's path, the step where a near-tie can flip."""
    from typing import NamedTuple

    from chinese_asr_tpu_torch.decode import beam as beam_mod
    from chinese_asr_tpu_torch.decode import greedy as greedy_mod
    from chinese_asr_tpu_torch.decode import lm_fused as lm_fused_mod
    from chinese_asr_tpu_torch.parallel import sharding

    class _Rows(NamedTuple):
        x: torch.Tensor
        n: torch.Tensor

    mesh, cfg = asr.mesh, asr.cfg
    feats = asr._featurize(asr._upload(*asr._prep_rows(
        list(wavs), None, sharding.row_slice(len(wavs), mesh))))
    lw = cfg.decode.length_weight
    if not asr.bw or asr.bw <= 1:
        margins, step = [], greedy_mod.dec_ops.decoder_step

        def record(*a, **k):
            out = step(*a, **k)
            top = torch.log_softmax(out.logit.float(), 1).topk(2, 1).values
            margins.append(top[:, 0] - top[:, 1])
            return out

        greedy_mod.dec_ops.decoder_step = record
        try:
            res = greedy_mod.greedy_decode(asr.params, cfg, *feats, mesh)
        finally:
            greedy_mod.dec_ops.decoder_step = step
        g = sharding.gather_rows(_Rows(torch.stack(margins, 1),
                                       res.final_lens), mesh)
        return {r: float(g.x[r, :int(g.n[r]) + 1].min()) for r in rows}
    if asr.dlm is not None and asr.lm_mode == "first":
        res = lm_fused_mod.lm_fused_decode(
            asr.params, cfg, asr.bw, *feats, asr.dlm, asr.tok2lm,
            asr.lm_topn, mesh)
        sel = res.fin_scores
    elif asr.dlm is not None:
        res, fin_lm = beam_mod.beam_decode(
            asr.params, cfg, asr.bw, *feats, mesh=mesh,
            lm_track=(asr.dlm, asr.tok2lm, asr._lm_bos, asr._lm_eos))
        sel = (res.fin_scores + cfg.decode.lm_weight * fin_lm
               + lw * res.fin_lens.float())
    else:
        res = beam_mod.beam_decode(asr.params, cfg, asr.bw, *feats,
                                   mesh=mesh)
        sel = res.fin_scores
    sel = torch.where(torch.isfinite(res.fin_scores), sel, float("-inf"))
    live = res.live_scores + lw * (res.l_final + 1)
    g = sharding.gather_rows(_Rows(sel, live), mesh)
    gaps = {}
    for r in rows:
        sc = g.x[r][torch.isfinite(g.x[r])]
        if not sc.numel():
            sc = g.n[r]
        top = torch.topk(sc.float(), min(2, sc.numel())).values.tolist()
        gaps[r] = top[0] - top[1] if len(top) > 1 else float("inf")
    return gaps


def _mesh_fit(torch, np, dev, mesh, spec, counters, compute_dtype):
    """``Trainer.fit`` for MESH_TRAIN_STEPS steps of the B=32 batch at the
    flagship ``Config()`` (ADAM, seed 0), featurized on the card each step
    (K1) as ``batches_to_device`` does; on ``mesh`` or one device.  Per
    step the loss, the wall and the collectives; the launches; the whole
    params after the last step (rank 0 / one device)."""
    from chinese_asr_tpu_torch.audio import features
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.data.dataset import Batch
    from chinese_asr_tpu_torch.models import las
    from chinese_asr_tpu_torch.parallel import sharding
    from chinese_asr_tpu_torch.train import optim
    from chinese_asr_tpu_torch.train.trainer import Trainer

    tag = "mesh" if mesh is not None else "one"
    cfg = Config().with_("train", batch_size=32, seed=0,
                         compute_dtype=compute_dtype,
                         save_dir=os.path.join(spec["build_dir"],
                                               f"mesh_ckpt_{tag}"))
    if mesh is not None:
        cfg = cfg.with_("mesh", data_parallel=MESH_SHAPE[0],
                        model_parallel=MESH_SHAPE[1])
    tr = Trainer(cfg, las.init_params(cfg, 0), None, device=dev, mesh=mesh)
    wav_mat, wav_lens, tok_in, tok_out, text_lens = spec["train_batch"]

    def loader():
        for _ in range(MESH_TRAIN_STEPS):
            feats, flens = features.featurize_batch(
                torch.from_numpy(wav_mat).to(dev),
                torch.from_numpy(wav_lens).to(dev), cfg.audio)
            yield Batch(feats, flens, *(torch.from_numpy(a).to(dev)
                                        for a in (tok_in, tok_out,
                                                  text_lens)))

    losses, walls, colls = [], [], []
    orig = tr._step_fn

    def timed(*a):
        sharding.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a)
        losses.append(float(out[2]["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        colls.append(dict(sharding.counts))
        return out

    tr._step_fn = timed
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    tr.fit(loader, None, max_steps=MESH_TRAIN_STEPS)
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    dtypes = sorted({str(t.dtype) for t in las.tree_leaves(tr.params)}
                    | {str(v.dtype) for v in tr.opt_state.values()
                       if v.is_floating_point()})
    params = tr.params if mesh is None else sharding.unshard_params(
        tr.params, cfg, mesh)
    keep = mesh is None or torch.distributed.get_rank() == 0
    flat = ({n: t.detach().cpu().numpy()
             for n, t in optim.flatten(params).items()} if keep else None)
    for f in os.listdir(cfg.train.save_dir):
        if keep and f.endswith(".ckpt"):
            os.remove(os.path.join(cfg.train.save_dir, f))
    return dict(losses=losses, walls_s=walls, collectives=colls,
                launches=launches, dtypes=dtypes, params=flat,
                step_s=float(np.median(walls[1:])))


def _mesh_rank(spec: dict) -> dict:
    """Phase 4b on one rank of the 2 x 2 mesh (gloo, every rank on the one
    card): the beam and greedy on the B=32 batch (16 rows a data rank),
    the LM second and first passes over the order-3 ARPA (the tables
    built on every rank), the golden shard in all five modes, and
    ``Trainer.fit`` in f32 and bf16.  Builds nothing: phase 1's library
    serves every rank."""
    import numpy as np
    import torch

    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.parallel import sharding
    from chinese_asr_tpu_torch.utils.device import resolve_device
    from chinese_asr_tpu_torch.vocab import Vocab

    counters = _kernel_counters()
    cfg = Config().with_("mesh", data_parallel=MESH_SHAPE[0],
                         model_parallel=MESH_SHAPE[1])
    mesh = sharding.make_mesh(cfg, "cuda")
    dev = resolve_device(None)
    rank = torch.distributed.get_rank()
    wavs = spec["wavs"]
    out = dict(rank=rank, device=str(dev),
               backend=torch.distributed.get_backend())
    for label, kw in (("beam_bw16", dict(bw=16)), ("greedy", dict(bw=None)),
                      ("beam_bw16_lm2", dict(bw=16, lm_mode="second")),
                      ("beam_bw16_lm1", dict(bw=16, lm_mode="first"))):
        t = time.perf_counter()
        asr = ASR(cfg=cfg, seed=0, mesh=mesh, **kw,
                  lm_path=spec["arpa3"] if "lm_mode" in kw else None)
        build_s = time.perf_counter() - t
        out[label] = _mesh_decode(torch, np, asr, wavs, counters)
        differ = [i for i, (a, b) in enumerate(zip(out[label]["texts"],
                                                   spec["texts"][label]))
                  if a != b]
        out[label]["differ"] = differ
        # every rank takes part: ``differ`` is the whole batch's on each
        out[label]["gaps"] = (_mesh_gaps(torch, asr, wavs, differ)
                              if differ else {})
        if asr.dlm is not None:
            out[label].update(
                lm_build_s=build_s,
                lm_table_mib=sum(t.numel() * t.element_size()
                                 for t in (*asr.dlm.tbls, asr.dlm.uni))
                / 2**20)
        del asr
    gold = spec["golden"]
    gcfg = Config.from_json(gold["cfg"])
    gvocab = Vocab.build([gold["chars"]], max_num_words=8)
    out["golden"] = {}
    for mode, kw in (("greedy", dict(bw=None)), ("beam_bw4", dict(bw=4)),
                     ("lm_second", dict(bw=4, lm_mode="second")),
                     ("lm_second_host", dict(bw=4, lm_mode="second_host")),
                     ("lm_first", dict(bw=4, lm_mode="first", lm_topn=8))):
        asr = ASR(ckpt_path=gold["ckpt"], cfg=gcfg, vocab=gvocab,
                  lm_path=gold["lm"] if "lm_mode" in kw else None,
                  mesh=mesh, **kw)
        out["golden"][mode] = asr.transcribe_files(gold["paths"])
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        out["train_" + dtype] = _mesh_fit(torch, np, dev, mesh, spec,
                                          counters, dtype)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _phase_mesh(np, torch, fails, gpu, dev, cfg, wavs, texts_of, arpa3,
                build_dir, golden):
    """Phase 4b: (a) ``ASR(bw=16, mesh=make_mesh(cfg))`` over a one-rank
    NCCL group (1 x 1) equal to ``ASR(bw=16)`` exactly; (b) a 2 x 2 mesh of
    four ranks sharing the card over gloo at the flagship width (V = 5004,
    2502 a model rank): decoding against phase 3's transcripts, the golden
    shard, and three train steps in f32 and bf16 against the single
    device's.  Returns the path's report."""
    import torch.distributed as dist

    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.parallel import launch, sharding

    counters = _kernel_counters()
    report = {}
    print("phase 4b: the walls below are gloo-through-the-host figures on "
          "one shared card (the ranks time-slice it; every collective "
          "crosses host memory), not NCCL across cards", flush=True)

    # (a) a one-rank NCCL group
    t = time.time()
    mesh = sharding.make_mesh(cfg, "cuda")
    fails.check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
                f"mesh 1x1: backend {dist.get_backend()}, shape "
                f"{tuple(mesh.shape)}")
    run = _mesh_decode(torch, np, ASR(bw=16, cfg=cfg, seed=0, mesh=mesh),
                       wavs, counters)
    # a 1x1 mesh skips every collective (it decodes as one device); the
    # port's all-reduce and all-gather are driven over NCCL here instead
    x = torch.arange(1.0, 5.0, device=dev)
    sharding.reset_counts()
    nccl_ok = (torch.equal(sharding._all_reduce(x, dist.group.WORLD), x)
               and torch.equal(sharding._all_gather(x, dist.group.WORLD, 0),
                               x)
               and sharding.counts["calls"] == 2)
    dist.destroy_process_group()
    fails.check(nccl_ok and run["collectives"]["calls"] == 0,
                f"mesh 1x1 (NCCL): the port's all-reduce and all-gather on "
                f"the card; the decode issued {run['collectives']['calls']} "
                f"collectives (none: a 1x1 mesh decodes as one device)")
    want = dict.fromkeys(counters, 0)
    want.update({"logmel.launches": 1, "lstm.launches": 4,
                 "topk.launches": 40, "attention.launches": 40,
                 "gemm.launches": 120})
    fails.check(run["launches"] == want,
                f"mesh 1x1 (NCCL) beam_bw16: launches {run['launches']}")
    fails.check(run["texts"] == texts_of["beam_bw16"] and run["stable"],
                "mesh 1x1 (NCCL) beam_bw16: transcripts equal ASR(bw=16)'s "
                "exactly")
    print(f"mesh 1x1 (NCCL, 1 rank): beam_bw16 wall {run['wall_s_first']:.3f}"
          f" s (first), median {run['wall_s']:.4f} s of {MESH_WARM_RUNS} "
          f"warm runs; collectives a batch {run['collectives']} on {gpu}",
          flush=True)
    run.pop("texts")
    report["nccl_1x1"] = dict(run, setup_s=time.time() - t)

    # (b) the 2 x 2 mesh over gloo, four ranks on the one card
    t = time.time()
    rng = np.random.default_rng(12)
    B, S = len(wavs), 32
    N = max(len(w) for w in wavs)
    wav_mat = np.zeros((B, N), np.float32)
    for i, w in enumerate(wavs):
        wav_mat[i, :len(w)] = w
    text_lens = rng.integers(16, 31, B).astype(np.int32)     # 15-30 chars + eos
    tok_in = np.full((B, S), cfg.vocab.pad, np.int32)
    tok_out = np.full((B, S), cfg.vocab.pad, np.int32)
    for i, n in enumerate(text_lens):
        text = rng.integers(4, cfg.vocab.vocab_size, n - 1)
        tok_in[i, 0], tok_in[i, 1:n] = cfg.vocab.sos, text
        tok_out[i, :n - 1], tok_out[i, n - 1] = text, cfg.vocab.eos
    spec = dict(wavs=wavs, arpa3=arpa3, build_dir=build_dir, golden=golden,
                texts={k: texts_of[k] for k in ("beam_bw16", "greedy",
                                                "beam_bw16_lm2",
                                                "beam_bw16_lm1")},
                train_batch=(wav_mat, np.array([len(w) for w in wavs],
                                               np.int32),
                             tok_in, tok_out, text_lens))
    single = {d: _mesh_fit(torch, np, dev, None, spec, counters, d)
              for d in ("float32", "bfloat16")}
    torch.cuda.empty_cache()
    t_spawn = time.time()
    outs = launch.run_ranks(_mesh_rank, MESH_SHAPE[0] * MESH_SHAPE[1],
                            args=(spec,), device_type="cuda", timeout_s=600)
    ranks_s = time.time() - t_spawn
    # K7: the LSTM gates' two products a step (the projection runs on the
    # model axis, off K7)
    front = {"logmel.launches": 1, "lstm.launches": 4, "gemm.launches": None}
    decode_want = {"beam_bw16": {**front, "topk.launches": 40,
                                 "attention.launches": 40,
                                 "gemm.launches": 80},
                   "greedy": front,
                   "beam_bw16_lm2": {**front, "topk.launches": None,
                                     "attention.launches": None},
                   "beam_bw16_lm1": {**front, "topk.launches": None,
                                     "attention.launches": None}}
    steps = MESH_TRAIN_STEPS
    # the decoder's products under autograd: off K7, counted (None: at
    # least once)
    train_want = {"float32": {"logmel.launches": steps,
                              "lstm.launches": 4 * steps,
                              "lstm.bwd_launches": 4 * steps,
                              "gemm.fallbacks": None},
                  "bfloat16": {"logmel.launches": steps,
                               "lstm.bf16_launches": 4 * steps,
                               "lstm.bwd_bf16_launches": 4 * steps,
                               "gemm.fallbacks": None}}
    for o in outs:
        r = o["rank"]
        fails.check(o["backend"] == "gloo" and o["device"] == "cuda:0",
                    f"mesh 2x2 rank {r}: gloo, on {o['device']}")
        for label, need in decode_want.items():
            got = o[label]["launches"]
            fails.check(all(got[n] > 0 if v is None else got[n] == v
                            for n, v in need.items())
                        and all(got[n] == 0 for n in got if n not in need)
                        and o[label]["stable"],
                        f"mesh 2x2 rank {r} {label}: launches {got}, two "
                        f"runs equal")
            fails.check(o[label]["texts"] == outs[0][label]["texts"],
                        f"mesh 2x2 rank {r} {label}: the whole batch's "
                        f"transcripts, as rank 0's")
        fails.check(o["golden"] == {m: golden["expected"][m]
                                    for m in o["golden"]},
                    f"mesh 2x2 rank {r}: the golden shard in all five modes "
                    f"equals expected.json")
        for dtype, need in train_want.items():
            run = o["train_" + dtype]
            full = dict.fromkeys(counters, 0)
            full.update(need)
            ref = single[dtype]["losses"]
            tol = 1e-5 if dtype == "float32" else 1e-2
            got = run["launches"]
            fails.check(all(got[n] > 0 if v is None else got[n] == v
                            for n, v in full.items()),
                        f"mesh 2x2 rank {r} train {dtype}: launches {got}")
            fails.check(all(np.isfinite(run["losses"]))
                        and run["dtypes"] == ["torch.float32"]
                        and np.allclose(run["losses"], ref, rtol=tol,
                                        atol=0),
                        f"mesh 2x2 rank {r} train {dtype}: {steps} steps, "
                        f"losses {run['losses']} against one device's {ref} "
                        f"(rtol {tol}); masters and optimizer state "
                        f"{run['dtypes']}")
    o = outs[0]
    for dtype in ("float32", "bfloat16"):
        got, ref = o["train_" + dtype]["params"], single[dtype]["params"]
        err = {n: float(np.max(np.abs(got[n] - ref[n])
                               - 2e-4 * np.abs(ref[n]))) for n in ref}
        leaf = max(err, key=err.get)
        worst = float(np.max(np.abs(got[leaf] - ref[leaf])))
        if dtype == "float32":
            fails.check(err[leaf] <= 2e-5,
                        f"mesh 2x2 train f32: params after {steps} steps "
                        f"equal one device's (rtol 2e-4, atol 2e-5; "
                        f"farthest leaf {leaf}, |diff| {worst:.3g})")
        else:
            print(f"mesh 2x2 train bf16: params after {steps} steps, "
                  f"farthest leaf {leaf}, |diff| {worst:.3g} from one "
                  f"device's (report)", flush=True)
        o["train_" + dtype].pop("params")
        single[dtype].pop("params")
    for label in decode_want:
        run = o[label]
        fails.check(len(run["differ"]) <= MESH_MAX_DIFFER
                    and all(g <= MESH_NEAR_TIE for g in run["gaps"].values()),
                    f"mesh 2x2 {label}: {len(run['differ'])} of {len(wavs)} "
                    f"transcripts differ from one device's (at most "
                    f"{MESH_MAX_DIFFER}, random weights), each a near-tie: "
                    f"margins to the runner-up {run['gaps']} (at most "
                    f"{MESH_NEAR_TIE})")
        print(f"mesh 2x2 {label}: wall {run['wall_s_first']:.3f} s (first), "
              f"median {run['wall_s']:.4f} s of {MESH_WARM_RUNS} warm runs "
              f"{[round(w, 4) for w in run['walls_s']]}; collectives a batch "
              f"a rank {run['collectives']}"
              + (f"; LM tables built in {run['lm_build_s']:.2f} s, "
                 f"{run['lm_table_mib']:.1f} MiB a rank"
                 if "lm_build_s" in run else "") + f" on {gpu}", flush=True)
        run.pop("texts")
    for dtype in ("float32", "bfloat16"):
        run = o["train_" + dtype]
        print(f"mesh 2x2 train {dtype}: step walls "
              f"{[round(w * 1e3, 1) for w in run['walls_s']]} ms, median of "
              f"the warm {run['step_s'] * 1e3:.1f} ms against one device's "
              f"{single[dtype]['step_s'] * 1e3:.1f} ms in this run; "
              f"collectives a step a rank {run['collectives'][-1]}; losses "
              f"{run['losses']} on {gpu}", flush=True)
    report["gloo_2x2"] = dict(
        {k: v for k, v in o.items() if k != "golden"},
        single_train={d: single[d] for d in single},
        ranks_s=ranks_s, total_s=time.time() - t,
        peak_gib_ranks=[x["peak_gib"] for x in outs])
    return report


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.items.append(what)


def _main_run(np, torch, fails, gpu, counters, mode, asr, batch, fused,
              need, sample_rate) -> tuple:
    """One phase-3 run: ``asr.transcribe_wavs(batch)`` once to capture the
    decode's graphs (an eager warm-up, then the capture; timed apart),
    twice from zeroed counters, replaying them (every counter of ``need``
    at its value, None: at least once, every other 0; the two runs'
    transcripts equal, not all empty), then TIMED_RUNS - 1 more warm
    walls.  Returns (its report, the first counted run's transcripts)."""
    os.environ["CHINESE_ASR_PALLAS_FUSED"] = "1" if fused else "0"
    audio_s = sum(len(w) for w in batch) / sample_rate
    torch.cuda.synchronize()
    t = time.perf_counter()
    asr.transcribe_wavs(batch)
    torch.cuda.synchronize()
    w_capture = time.perf_counter() - t
    runs = []
    for _ in range(2):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts = asr.transcribe_wavs(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs.append((texts, wall, {n: getattr(mod, attr) for n, (mod, attr)
                                   in counters.items()}))
    (t1, w1, c1), (t2, w2, _) = runs
    fails.check(all(c1[n] > 0 if v is None else c1[n] == v
                    for n, v in need.items())
                and all(c1[n] == 0 for n in counters if n not in need),
                f"{mode}: kernels launched in the main path {c1}, "
                f"wanted {need} (None: at least once)")
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
    print(f"{mode}: {len(batch)} wavs, {audio_s:.1f} s audio, wall "
          f"{w_capture:.3f} s (first call: warm-up and capture), "
          f"{w1:.3f} s (first replay), median {wall:.4f} s of "
          f"{len(walls)} warm "
          f"runs [{min(walls):.4f}, {max(walls):.4f}] -> "
          f"{audio_s / wall:.1f} audio-s/s on {gpu}; launches {c1}; "
          f"first transcript {t1[0][:60]!r}", flush=True)
    return dict(batch=len(batch), wall_s_capture=w_capture,
                wall_s_first=w1, wall_s=wall, wall_s_min=min(walls),
                wall_s_max=max(walls), runs=len(walls), launches=c1,
                audio_s=audio_s, audio_s_per_s=audio_s / wall), t1


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
    from chinese_asr_tpu_torch.ops.cuda import adpcm as adpcm_k
    from chinese_asr_tpu_torch.ops.cuda import attention as attn_k
    from chinese_asr_tpu_torch.ops.cuda import build
    from chinese_asr_tpu_torch.ops.cuda import gemm as gemm_k
    from chinese_asr_tpu_torch.ops.cuda import logmel as logmel_k
    from chinese_asr_tpu_torch.ops.cuda import lstm as lstm_k
    from chinese_asr_tpu_torch.ops.cuda import subsample as sub_k
    from chinese_asr_tpu_torch.ops.cuda import topk as topk_k
    from chinese_asr_tpu_torch.tools import lstm_stamp
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
    # the stamped build of K2-bf16 and K2-bwd-bf16 (their phase split,
    # phases 2b-bf16 and 2f-bf16) compiles beside the product's
    stamped = {}

    def build_stamped():
        try:
            stamped["lib"] = lstm_stamp.stamped_library()
        except (RuntimeError, OSError) as e:       # a check of phase 2b-bf16
            stamped["error"] = str(e)[-2000:]

    stamper = threading.Thread(target=build_stamped)
    stamper.start()
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

    # ---- phase 2b-bf16: K2's bf16 instance (K2-bf16) -------------------------
    t2b = time.time()
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    xg_f = torch.randn(T2, B2, 4 * H, device=dev, generator=g).to(bf)
    xg_b = torch.randn(T2, B2, 4 * H, device=dev, generator=g).to(bf)
    w_hh = (torch.randn(2, H, 4 * H, device=dev, generator=g)
            / H ** 0.5).to(bf)
    args16 = (xg_f, xg_b, m_f.to(bf), m_b.to(bf), w_hh)

    def err_bf16(args):
        got = lstm_k.bidir_lstm_time_loop(*args)
        ref = lstm_k.bidir_lstm_time_loop_plain(*args)
        if not all(a.dtype == bf for a in got):
            return float("inf"), got
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, ref)), got

    err16, got = err_bf16(args16)
    fails.check(err16 <= TOL_LSTM_BF16,
                f"K2-bf16 (cluster kernel) T={T2} B={B2} H={H}: bf16 outputs, "
                f"max_abs_err {err16:.3g} <= {TOL_LSTM_BF16}")
    fails.check(float(got[0].float()[m_f == 0].abs().max()) == 0.0,
                "K2-bf16 (cluster kernel) masked steps emit exact zeros")
    plan16 = lstm_k.plan(B2, H, bf)
    rule16 = lstm_k.cluster_shape(B2, H, bf)
    fails.check(plan16["waves"] == 1
                and all(plan16[k] == v for k, v in rule16.items()),
                f"K2-bf16 at B={B2}: one wave ({plan16['clusters']} clusters "
                f"of {plan16['ctas']} CTAs, {plan16['rows']} rows each; the "
                f"card holds {plan16['max_active_clusters']}), as "
                f"cluster_shape's rule {rule16}")
    args16_32 = tuple(a[:, :32].contiguous() for a in args16[:4]) + (w_hh,)
    err16_32, _ = err_bf16(args16_32)
    fails.check(err16_32 <= TOL_LSTM_BF16,
                f"K2-bf16 (cluster kernel) T={T2} B=32 H={H}: max_abs_err "
                f"{err16_32:.3g} <= {TOL_LSTM_BF16}")
    ms16_32 = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop(*args16_32),
                       20)
    plan16_32 = lstm_k.plan(32, H, bf)
    del args16_32
    # random non-prefix masks (a quarter of the steps masked, any row)
    gnp = torch.Generator(device=dev).manual_seed(4)
    err16_np = {}
    for B in (32, B2):
        npargs = lstm_bwd_case(torch, lstm_k, gnp, T2, B, H, bf)[:5]
        err16_np[B], _ = err_bf16(npargs)
        fails.check(err16_np[B] <= TOL_LSTM_BF16,
                    f"K2-bf16 (cluster kernel) T={T2} B={B} H={H}, random "
                    f"non-prefix masks: max_abs_err {err16_np[B]:.3g} <= "
                    f"{TOL_LSTM_BF16}")
        del npargs
    err16_s, _ = err_bf16((xg_f[..., :4 * hs].contiguous(),
                           xg_b[..., :4 * hs].contiguous(), args16[2],
                           args16[3], w_hh[:, :hs, :4 * hs].contiguous()))
    fails.check(err16_s <= TOL_LSTM_BF16,
                f"K2-bf16 (simple kernel) T={T2} B={B2} H={hs}: max_abs_err "
                f"{err16_s:.3g} <= {TOL_LSTM_BF16}")
    ptx16 = _k2_ptxas_lines(log, "nv_bfloat16", exclude="bwd")
    for line in ptx16:
        print("  K2-bf16 ptxas:", line, flush=True)
    # the nearest library call, as for K2: cuDNN's whole bf16 layer
    cudnn = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev, bf)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.randn(T2, B2, 2 * H, device=dev, generator=g).to(bf),
        lens2.cpu(), enforce_sorted=False)
    with torch.no_grad():
        cudnn16_ms = _time_ms(torch, lambda: cudnn(packed), 20)
    del cudnn, packed
    # bytes of bf16 operands; the products at the dense bf16 tensor-core
    # rate, the cell update (10 H operations a row and step, f32) at the
    # f32 rate: the least time is the largest of the three
    bound16, by16 = _bound_ms(
        2 * (2 * T2 * B2 * 4 * H + 2 * T2 * B2 + 2 * H * 4 * H
             + 2 * T2 * B2 * H + 4 * B2 * H),
        2 * steps * 2 * H * 4 * H, H100_BF16_FLOPS)
    cell_ms = 2 * steps * 10 * H / H100_F32_FLOPS * 1e3
    if cell_ms > bound16:
        bound16, by16 = cell_ms, "operations"
    ms16 = _time_ms(torch, lambda: lstm_k.bidir_lstm_time_loop(*args16), 20)
    kernels["lstm_bf16"] = dict(
        name="K2-bf16 BiLSTM time loop (bf16)", route="cuda",
        source="chinese_asr_tpu_torch/csrc/lstm.cu",
        replaces="chinese_asr_tpu/ops/rnn.py:246",
        max_abs_err=max(err16, err16_32, err16_s, *err16_np.values()),
        ms=ms16, step_us=ms16 * 1e3 / T2,
        waves=plan16["waves"], clusters=plan16["clusters"],
        max_active_clusters=plan16["max_active_clusters"],
        rows_per_cluster=plan16["rows"], ctas_per_cluster=plan16["ctas"],
        plan_b32=plan16_32,
        ms_b32=ms16_32, step_us_b32=ms16_32 * 1e3 / T2,
        plain_ms=_time_ms(torch,
                          lambda: lstm_k.bidir_lstm_time_loop_plain(*args16),
                          2, warmup=1),
        bound_ms=bound16, bound_by=by16, bound_peak="bf16 989 TFLOP/s",
        library_ms=None, cudnn_layer_ms=cudnn16_ms, ptxas=ptx16,
        shape=f"xg bf16 [2 x {T2}, {B2}, {4 * H}] -> ys [2 x {T2}, {B2}, "
              f"{H}]")
    print(f"K2-bf16: {ms16:.4f} ms at B={B2} ({ms16_32:.4f} ms at B=32), "
          f"K2 f32 {kernels['lstm']['ms']:.4f} ms; bound {bound16:.4f} ms "
          f"({by16}); cuDNN bf16 layer {cudnn16_ms:.4f} ms; max_abs_err "
          f"{kernels['lstm_bf16']['max_abs_err']:.3g}; plan at B={B2}: "
          f"{plan16['clusters']} clusters of {plan16['ctas']} CTAs, "
          f"{plan16['rows']} rows each, {plan16['waves']} wave(s); at B=32: "
          f"{plan16_32['clusters']} clusters of {plan16_32['ctas']} CTAs, "
          f"{plan16_32['rows']} rows each", flush=True)
    del args16, xg_f, xg_b, w_hh, got
    # the phase split of a step (the stamped build), before and after
    stamper.join()
    fails.check("lib" in stamped,
                f"the stamped build of K2-bf16 and K2-bwd-bf16 "
                f"(tools/lstm_stamp.py) {stamped.get('error', '')}")
    splits = {}
    if "lib" in stamped:
        splits = {B: lstm_stamp.split(torch, stamped["lib"], B)
                  for B in (32, B2)}
        for k, v in SPLIT_BEFORE.items():
            if k.startswith("K2-bf16"):
                print(f"  split before the bf16 redesign (recorded, PERF.md),"
                      f" {k}, us a step: {v}", flush=True)
        for B, r in splits.items():
            for line in lstm_stamp.lines(r)["fwd"]:
                print("  split now: " + line.strip(), flush=True)
        kernels["lstm_bf16"]["split_us_a_step"] = {
            B: r["fwd"]["us_a_step"] for B, r in splits.items()}
    print(f"phase 2b-bf16: {time.time() - t2b:.1f} s", flush=True)

    # ---- phase 2f: K2-bwd, the recurrence's backward ------------------------
    t2f = time.time()
    kernels["lstm_bwd"] = _phase_k2_bwd(np, torch, fails, dev, lstm_k)
    kernels["lstm_bwd"]["ptxas"] = _k2_ptxas_lines(log, "bilstm_bwd")
    for line in kernels["lstm_bwd"]["ptxas"]:
        print("  K2-bwd ptxas:", line, flush=True)
    print(f"phase 2f: {time.time() - t2f:.1f} s", flush=True)

    # ---- phase 2f-bf16: K2-bwd's bf16 instance (K2-bwd-bf16) ---------------
    t2f = time.time()
    kernels["lstm_bwd_bf16"] = _phase_k2_bwd_bf16(np, torch, fails, dev,
                                                  lstm_k, kernels["lstm_bwd"],
                                                  log, splits)
    print(f"phase 2f-bf16: {time.time() - t2f:.1f} s", flush=True)

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

    R_RANK = 256                    # one data rank's rows on phase 4b's mesh
    plans = {rows: topk_k.plan(rows, V, k) for rows in (R, R32, R_RANK)}
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
    for rows in (R32, R_RANK):
        fails.check(same_topk(topk_k.top_k(x[:rows].contiguous(), k),
                              topk_k.top_k_plain(x[:rows], k)),
                    f"K3 top-k [{rows},{V}] k={k} exact (planted rows)")
    wide = torch.randn(64, 70000, device=dev, generator=g).round()
    wide[0, 35000] = float("nan")
    wide[1] = float("-inf")
    fails.check(same_topk(topk_k.top_k(wide, k),
                          topk_k.top_k_plain(wide, k)),
                f"K3 top-k [64,70000] k={k} exact")
    del wide
    for rows in (R, R32, R_RANK):
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

    # ---- phase 2g: K6, the beam's attention read ----------------------------
    t2g = time.time()
    kernels["attention"] = _phase_k6(np, torch, fails, dev, attn_k, graph_ms,
                                     gpu)
    print(f"phase 2g: {time.time() - t2g:.1f} s", flush=True)

    # ---- phase 2h: K7, the Conformer's 3xTF32 GEMM ---------------------------
    t2h = time.time()
    kernels["gemm"] = _phase_k7(np, torch, fails, dev, gemm_k, graph_ms, gpu)
    print(f"phase 2h: {time.time() - t2h:.1f} s", flush=True)

    # ---- phase 2i: K8, the subsampling's two convolutions --------------------
    t2i = time.time()
    kernels["subsample"] = _phase_k8(np, torch, fails, dev, sub_k, graph_ms,
                                     gpu)
    print(f"phase 2i: {time.time() - t2i:.1f} s", flush=True)

    # ---- phase 3: main path --------------------------------------------------
    cfg = Config()
    wavs = _synthetic_wavs(np, rng, 32, 9.0, 10.0)
    # bench.py's headline shape (B=128), timed beside the 32-wav main path
    wavs128 = wavs + _synthetic_wavs(np, rng, 96, 9.0, 10.0)
    # each kernel's launch counter (module, attribute)
    counters = _kernel_counters()

    # ---- phase 2e: K5 ADPCM wire decode ---------------------------------------
    t2e = time.time()
    asr_adpcm = ASR(bw=16, cfg=cfg, seed=0, wire="adpcm")
    K5 = features.ADPCM_K
    t = time.perf_counter()
    wires = {"b32": asr_adpcm._prep(wavs, None)[0],
             "b1": asr_adpcm._prep(wavs[:1], None)[0],
             "square": features.adpcm_encode_flat(np.where(
                 (np.arange(64 * K5) // 16) % 2, 32767, -32768).astype(
                     np.int16)),
             "silence": features.adpcm_encode_flat(np.zeros(64 * K5,
                                                            np.int16))}
    print(f"  ADPCM wires prepared in {time.perf_counter() - t:.2f} s (the "
          f"C++ encoder built on first use)", flush=True)
    k5 = {}
    errs5 = []
    for name, buf in wires.items():
        nb5 = len(buf) // (3 + K5 // 2)
        d = torch.from_numpy(buf).to(dev)
        got = adpcm_k.adpcm_decode_flat(d, nb5)
        ref = adpcm_k.adpcm_decode_flat_plain(d, nb5)
        same = got.shape == (nb5 * K5,) and torch.equal(got, ref)
        # a shape mismatch counts as NaN; np.max keeps any NaN
        errs5.append(float((got - ref).abs().max())
                     if got.shape == ref.shape else float("nan"))
        fails.check(same, f"K5 ADPCM decode {name} (nb={nb5}): bit-exact "
                          f"against its twin")
        k5[name] = (d, nb5)
    d32, nb32 = k5["b32"]
    d1, nb1 = k5["b1"]
    # the host encoder on the same batch (warm; the int16 flat buffer as
    # _prep fills it, encoded alone)
    flat32 = np.zeros(nb32 * K5, np.int16)
    cat = np.concatenate(wavs)
    flat32[:len(cat)] = cat
    enc = []
    for _ in range(5):
        t = time.perf_counter()
        features.adpcm_encode_flat(flat32)
        enc.append((time.perf_counter() - t) * 1e3)
    bound5, by5 = _bound_ms((3 + K5 // 2 + 4 * K5) * nb32,
                            12 * K5 * nb32)
    kernels["adpcm"] = dict(
        name="K5 ADPCM wire decode", route="cuda",
        source="chinese_asr_tpu_torch/csrc/adpcm.cu",
        replaces="chinese_asr_tpu/audio/features.py:500",
        max_abs_err=float(np.max(errs5)),
        ms=_time_ms(torch, lambda: adpcm_k.adpcm_decode_flat(d32, nb32), 50),
        ms_b1=_time_ms(torch, lambda: adpcm_k.adpcm_decode_flat(d1, nb1), 50),
        plain_ms=_time_ms(torch,
                          lambda: adpcm_k.adpcm_decode_flat_plain(d32, nb32),
                          3, warmup=1),
        bound_ms=bound5, bound_by=by5, library_ms=None,
        host_encode_ms=float(np.median(enc)), blocks=nb32, blocks_b1=nb1,
        shape=f"wire uint8 [{nb32} x {3 + K5 // 2}] -> [{nb32 * K5}] f32")
    print(f"K5: {kernels['adpcm']['ms']:.4f} ms for {nb32} blocks (B=32), "
          f"{kernels['adpcm']['ms_b1']:.4f} ms for {nb1} (B=1); bound "
          f"{bound5:.5f} ms ({by5}); twin {kernels['adpcm']['plain_ms']:.2f} "
          f"ms; the C++ host encoder {np.median(enc):.2f} ms on the same "
          f"batch", flush=True)
    del k5, d32, d1, wires
    print(f"phase 2e: {time.time() - t2e:.1f} s", flush=True)
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
            arpa3 = arpa                # phase 4b's ranks read it again
        else:
            os.remove(arpa)
        lm_asrs[lm_order] = a

    # mode, ASR, batch, fused stage 1, the kernels that must run: each with
    # its exact launches per batch (4 encoder layers, 40 decode steps, as
    # random weights never stop early, 3 K7 products a f32 step, one ADPCM
    # decode) or None for "> 0"
    any3 = dict.fromkeys(("logmel.launches", "lstm.launches", "topk.launches",
                          "attention.launches", "gemm.launches"))
    beam = {"logmel.launches": 1, "lstm.launches": 4, "topk.launches": 40,
            "attention.launches": 40, "gemm.launches": 120}
    # bf16: K7's three products a step left to ``x @ w + b``, counted
    beam16 = {"logmel.launches": 1, "lstm.bf16_launches": 4,
              "topk.launches": 40, "attention.launches": 40,
              "gemm.fallbacks": 120}
    runs_spec = (
        ("beam_bw16", ASR(bw=16, cfg=cfg, seed=0), wavs, False, beam),  # cuda
        ("greedy", ASR(bw=None, cfg=cfg, seed=0), wavs, False,
         dict.fromkeys(("logmel.launches", "lstm.launches",
                        "gemm.launches"))),
        ("beam_bw16_b128", ASR(bw=16, cfg=cfg, seed=0), wavs128, False, beam),
        ("beam_bw16_lm2", lm_asrs[3], wavs, False, any3),
        ("beam_bw16_lm2_fused", lm_asrs[3], wavs, True,
         dict.fromkeys(("logmel.launches", "lstm.launches",
                        "topk.fused_launches", "attention.launches",
                        "gemm.launches"))),
        ("beam_bw16_lm2_o5", lm_asrs[5], wavs, False, any3),
        ("beam_bw16_lm1", lm_asrs["first"], wavs, False, any3),
        ("beam_bw16_bf16", ASR(bw=16, cfg=cfg, seed=0,
                               compute_dtype="bfloat16"), wavs, False,
         beam16),
        ("beam_bw16_b128_bf16", ASR(bw=16, cfg=cfg, seed=0,
                                    compute_dtype="bfloat16"), wavs128,
         False, beam16),
        ("beam_bw16_mulaw", ASR(bw=16, cfg=cfg, seed=0, wire="mulaw"), wavs,
         False, beam),
        ("beam_bw16_adpcm", asr_adpcm, wavs, False,
         {**beam, "adpcm.launches": 1})) + tuple(
        (mode, ASR(bw=16, cfg=ecfg, seed=0), wavs128, False,
         _encoder_need(ecfg, blocks, per_block))
        for mode, ecfg, blocks, per_block in (
            (mode, _cell_config(Config, name), blocks, per_block)
            for mode, name, blocks, per_block in ENCODER_RUNS))
    # the bf16 and lossy-wire runs, reported against the f32 flat wire's
    lossy_suffixes = ("_bf16", "_mulaw", "_adpcm")
    t3_lossy = 0.0
    # each kernel's launch counter and the run its count is read from:
    # K1-K3 the main path's, K4 the fused LM path's, K8 the Conformer's
    # (the flagship's BiLSTM runs no subsampling)
    launches_from = {
        "logmel": ("logmel.launches", "beam_bw16"),
        "lstm": ("lstm.launches", "beam_bw16"),
        "lstm_bf16": ("lstm.bf16_launches", "beam_bw16_bf16"),
        "topk": ("topk.launches", "beam_bw16"),
        "topk_fused": ("topk.fused_launches", "beam_bw16_lm2_fused"),
        "adpcm": ("adpcm.launches", "beam_bw16_adpcm"),
        "attention": ("attention.launches", "beam_bw16"),
        "lstm_bwd": ("lstm.bwd_launches", "training"),
        "lstm_bwd_bf16": ("lstm.bwd_bf16_launches", "training bf16"),
        "gemm": ("gemm.launches", "beam_bw16"),
        "subsample": ("subsample.launches", ENCODER_RUNS[0][0])}
    paths, texts_of = {}, {}
    for mode, asr, batch, fused, need in runs_spec:
        t_run = time.time()
        paths[mode], t1 = _main_run(np, torch, fails, gpu, counters, mode,
                                    asr, batch, fused, need,
                                    cfg.audio.sample_rate)
        texts_of[mode] = t1
        c1 = paths[mode]["launches"]
        for n in kernels:
            ctr, run = launches_from[n]
            if run == mode:
                kernels[n]["launches"] = c1[ctr]
        if mode.endswith(lossy_suffixes):
            paths[mode]["wire"] = _wire_cost(np, torch, asr, batch)
            base = texts_of["beam_bw16_b128" if len(batch) == 128
                            else "beam_bw16"]
            paths[mode]["rows_differ_from_f32_flat"] = sum(
                a != b for a, b in zip(t1, base))
            print(f"{mode}: wire {json.dumps(paths[mode]['wire'])}; "
                  f"{paths[mode]['rows_differ_from_f32_flat']} of "
                  f"{len(batch)} transcripts differ from the f32 flat "
                  f"wire's (report only: random weights)", flush=True)
            t3_lossy += time.time() - t_run
    kernels["subsample"]["launches_ebranchformer"] = \
        paths[ENCODER_RUNS[1][0]]["launches"]["subsample.launches"]
    paths["beam_bw16"]["wire"] = _wire_cost(np, torch, runs_spec[0][1], wavs)
    print(f"beam_bw16: wire {json.dumps(paths['beam_bw16']['wire'])}; the "
          f"bf16 and lossy-wire runs took {t3_lossy:.1f} s", flush=True)
    lm1 = paths["beam_bw16_lm1"]["launches"]
    kernels["topk"]["launches_lm1"] = lm1["topk.launches"]
    print(f"beam_bw16_lm1: K3 launched {kernels['topk']['launches_lm1']} times "
          f"per batch (k=20 proposals), K4 {lm1['topk.fused_launches']}",
          flush=True)
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
    golden_spec = dict(cfg=gcfg.to_json(), chars="的一是不了人我在" * 3,
                       ckpt=os.path.join(gold, "model.ckpt"),
                       lm=os.path.join(gold, "lm.arpa"), paths=gpaths,
                       expected=expected)
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
    # bf16 and the lossy wires on the golden shard: the card against the
    # CPU port, through K2-bf16 and K5; bf16 also with cuBLAS's
    # reduced-precision bf16 reductions flipped (report only)
    t3c = time.time()
    matmul = torch.backends.cuda.matmul
    red = matmul.allow_bf16_reduced_precision_reduction
    golden_lossy = {}
    for name, kw in (("bf16", dict(compute_dtype="bfloat16")),
                     ("mulaw", dict(wire="mulaw")),
                     ("adpcm", dict(wire="adpcm"))):
        k2 = "lstm.bf16_launches" if name == "bf16" else "lstm.launches"
        for mode, bw in (("greedy", None), ("beam_bw4", 4)):
            def golden_asr(**more):
                return ASR(ckpt_path=os.path.join(gold, "model.ckpt"),
                           cfg=gcfg, vocab=gvocab, bw=bw, **kw, **more)
            before = {n: getattr(m, a) for n, (m, a) in counters.items()}
            card = golden_asr().transcribe_files(gpaths)
            ran = {n: getattr(m, a) - before[n]
                   for n, (m, a) in counters.items()}
            cpu = golden_asr(device="cpu").transcribe_files(gpaths)
            fails.check(card == cpu and ran[k2] > 0
                        and (ran["adpcm.launches"] > 0) == (name == "adpcm"),
                        f"golden shard {mode} {name} on the card (through "
                        f"{k2}{' and K5' if name == 'adpcm' else ''}) equals "
                        f"the CPU port; equals expected.json: "
                        f"{card == expected[mode]}")
            golden_lossy[f"{name}_{mode}"] = dict(
                equals_cpu=card == cpu, equals_expected=card == expected[mode])
            if name == "bf16":
                matmul.allow_bf16_reduced_precision_reduction = not red
                flipped = golden_asr().transcribe_files(gpaths)
                matmul.allow_bf16_reduced_precision_reduction = red
                golden_lossy[f"{name}_{mode}"]["same_when_reduction_flipped"] \
                    = flipped == card
    paths["golden_lossy"] = golden_lossy
    print(f"golden shard, bf16 and lossy wires (allow_bf16_reduced_precision"
          f"_reduction default {red}): {json.dumps(golden_lossy)}; "
          f"{time.time() - t3c:.1f} s", flush=True)


    golden = (gold, gcfg, gvocab, gpaths, expected)

    # ---- phase 3g: the compiled decode entry points against the eager loop --
    t3g = time.time()
    paths["graphs"] = _phase_graphs(np, torch, fails, ASR, gpu, runs_spec,
                                    texts_of, golden, cfg, wavs)
    del lm_asrs, runs_spec
    print(f"phase 3g: {time.time() - t3g:.1f} s", flush=True)

    # ---- phase 3d: the HTTP server at full width ----------------------------
    t3d = time.time()
    paths["serving"] = _phase_serving(np, torch, fails, ASR, cfg, wavs,
                                      counters, gpu, golden)
    print(f"phase 3d: {time.time() - t3d:.1f} s", flush=True)

    # ---- phase 3e: the other entry points on the card -----------------------
    t3e = time.time()
    paths.update(_phase_entry_points(np, torch, fails, ASR, cfg, wavs,
                                     wavs128, rng, counters, gpu, golden,
                                     build.BUILD_DIR))
    print(f"phase 3e: {time.time() - t3e:.1f} s", flush=True)

    # ---- phase 3f: the encoder families and variants at full width ----------
    t3f = time.time()
    paths["families"] = _phase_families(np, torch, fails, ASR, cfg, wavs,
                                        rng, dev, counters, gpu,
                                        build.BUILD_DIR)
    for n in ("logmel", "topk", "lstm", "attention"):
        kernels[n]["launches_families"] = {
            run: paths["families"][run]["kernel_launches"][launches_from[n][0]]
            for run, _ in FAMILY_RUNS}
    print(f"phase 3f: {time.time() - t3f:.1f} s", flush=True)
    from chinese_asr_tpu_torch.utils import graphs
    graphs.clear()          # the decode programs of the phases above

    # ---- phase 4: training at full width ------------------------------------
    t4 = time.time()
    paths["training"] = _phase_training(np, torch, fails, dev, gpu, counters,
                                        build.BUILD_DIR)
    for n, run in (("lstm_bwd", paths["training"]),
                   ("lstm_bwd_bf16", paths["training"]["bf16"])):
        kernels[n]["launches"] = run["kernel_launches"][launches_from[n][0]]
        kernels[n]["launches_per_step"] = kernels[n]["launches"] // run["steps"]
    print(f"phase 4: {time.time() - t4:.1f} s", flush=True)

    # ---- phase 4b: the mesh -------------------------------------------------
    t4b = time.time()
    paths["mesh"] = _phase_mesh(np, torch, fails, gpu, dev, cfg, wavs,
                                texts_of, arpa3, build.BUILD_DIR,
                                golden_spec)
    os.remove(arpa3)
    mesh_runs = paths["mesh"]["gloo_2x2"]
    for n in kernels:
        ctr = launches_from[n][0]
        kernels[n]["launches_mesh_2x2_rank0"] = {
            "beam_bw16": mesh_runs["beam_bw16"]["launches"][ctr],
            "train_f32": mesh_runs["train_float32"]["launches"][ctr],
            "train_bf16": mesh_runs["train_bfloat16"]["launches"][ctr]}
    print(f"phase 4b: {time.time() - t4b:.1f} s", flush=True)

    # ---- phase 5: report -----------------------------------------------------
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
