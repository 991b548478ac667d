"""PyTorch port, the Conformer encoder (``models/conformer.py``, its ops in
``ops/conv.py`` and ``ops/self_attention.py``) against the benchmark's
plain reference of the family (``port_bench/encoders/conformer.py``), at
tiny widths (d 32, 2 blocks, 4 heads, FFN 64, an even depthwise kernel
of 8) on seeded random weights drawn by the benchmark
(``port_bench/lib/weights.py``), which both sides take.  The JAX package
has no Conformer, so nothing here compares against JAX.

Tolerances: the encoder's output 1e-5 absolute (float32 on both sides,
its sums in other orders, compounded over 2 blocks of unit-scale
LayerNorm outputs: the differences read ~1e-6); a padded row against
the row alone 1e-5 (the same rounding from GEMMs of other shapes);
padding exactly 0; the positional term against its brute-force loop
1e-5; the beam as the cell's ``correct`` compares it (the same tokens,
scores within 1e-4); the train step's loss 1e-5 relative and each
gradient within 1e-4 of the largest entry of that leaf's reference
gradient, or of the median leaf's where that is larger (float32 backward
through BatchNorm on batch statistics: the depthwise conv's bias, just
before the norm, gets a gradient of rounding alone; the widest gap reads
8e-6 of that scale)."""

import copy
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch.data.dataset import Batch
from chinese_asr_tpu_torch.models import conformer as tconf
from chinese_asr_tpu_torch.models import encoder as tenc
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.ops import conv as tconv
from chinese_asr_tpu_torch.ops import self_attention as tsa
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
from chinese_asr_tpu_torch.train import optim
from chinese_asr_tpu_torch.train.trainer import Trainer
from port_bench import encoders
from port_bench.lib import common, offline, traffic, weights
from port_bench.reference import las as ref
from port_bench.tests.conftest import TINY_SEED, tiny_config, tiny_mix

CONFIG = "las_conformer_l_f32"
PREC = ref.Precision()


def _cfg(**encoder):
    cfg = tiny_config(common.load("configs", CONFIG))
    cfg["encoder"].update(encoder)
    return cfg


def _feats(cfg, lens, seed=0):
    g = torch.Generator().manual_seed(seed)
    T = max(lens)
    x = torch.randn(len(lens), T, 80, generator=g)
    lens = torch.tensor(lens)
    x[torch.arange(T)[None] >= lens[:, None]] = 0.0
    return x, lens


def test_the_tiny_config_is_the_one_asked():
    enc = _cfg()["encoder"]
    assert (enc["hidden_size"], enc["num_layers"], enc["self_attn_heads"],
            enc["ffn_size"]) == (32, 2, 4, 64)
    assert enc["ks"] % 2 == 0
    full = common.load("configs", CONFIG)["encoder"]
    assert (full["hidden_size"], full["num_layers"], full["self_attn_heads"],
            full["ffn_size"], full["ks"]) == (512, 17, 8, 2048, 32)


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_the_programs_tree_is_the_references_layout(width):
    """``init_params`` makes the tree, leaf by leaf in path and shape,
    that the benchmark draws from the family's layout; at full width
    the encoder holds Conformer (L)'s ~115 M parameters (subsampling 7.4
    M, a block 6.3 M)."""
    cfg = common.load("configs", CONFIG)
    if width == "tiny":
        cfg = tiny_config(cfg)
    pcfg = offline.port_config(cfg)
    got = {"/".join(map(str, p)): tuple(t.shape)
           for p, t in las.tree_paths(
               las.init_params(pcfg) if width == "tiny" else
               {"encoder": tenc.init_encoder(torch.Generator(), pcfg)})}
    want = {"/".join(map(str, p)): tuple(s)
            for p, s, _ in encoders.of(cfg).layout(cfg)}
    assert {k: v for k, v in got.items() if k.startswith("encoder/")} == want
    if width == "full":
        n = sum(math.prod(s) for s in want.values())
        sub = sum(math.prod(s) for k, s in want.items()
                  if k.startswith("encoder/subsample/"))
        assert 114e6 < n < 116e6 and 7.3e6 < sub < 7.5e6
        assert 6.2e6 < (n - sub) / 17 < 6.4e6


# ---- (a), (b): the encoder ------------------------------------------------
def test_encoder_matches_the_reference():
    """(a) output, lens and the decoder's zero start."""
    cfg = _cfg()
    params = weights.make_params(cfg, TINY_SEED, "cpu")
    x, lens = _feats(cfg, [61, 40, 23, 9])
    r, rl, (h, c) = encoders.of(cfg).encode(PREC, params, x, lens, cfg)
    eb = las.encode(params, offline.port_config(cfg), x, lens)
    n = tconv.subsample_out_len(lens)
    assert torch.equal(rl, n) and n.tolist() == [14, 9, 5, 1]
    torch.testing.assert_close(eb.enc_out, r, atol=1e-5, rtol=0)
    assert eb.init_cell_state is None
    assert not h.any() and not c.any()


def test_a_padded_batch_equals_each_row_alone():
    """(b) each row's output on its own frames, padding exactly 0."""
    cfg = _cfg()
    pcfg = offline.port_config(cfg)
    params = weights.make_params(cfg, TINY_SEED + 1, "cpu")["encoder"]
    x, lens = _feats(cfg, [57, 31, 12], seed=1)
    out = tenc.apply_encoder(params, pcfg, x, lens)
    for b in range(len(lens)):
        n = int(lens[b])
        alone = tenc.apply_encoder(params, pcfg, x[b:b + 1, :n], lens[b:b + 1])
        m = int(out.out_lens[b])
        assert alone.out.shape[1] == m
        torch.testing.assert_close(out.out[b, :m], alone.out[0], atol=1e-5,
                                   rtol=0)
        assert not out.out[b, m:].any()


@pytest.mark.parametrize("K", [2, 4, 5, 31, 32])
def test_depthwise_conv_pads_as_torch_same(K):
    g = torch.Generator().manual_seed(K)
    x, w, b = (torch.randn(2, 9, 6, generator=g), torch.randn(K, 6, generator=g),
               torch.randn(6, generator=g))
    lens = torch.tensor([9, 5])
    got = tconv.depthwise_conv1d_same(x, w, b, lens)
    xm = x * (torch.arange(9)[None, :, None] < lens[:, None, None])
    want = torch.nn.functional.conv1d(xm.transpose(1, 2), w.t()[:, None], b,
                                      padding="same", groups=6)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("L", [1, 2, 7])
def test_rel_shift_puts_distance_i_minus_j_at_i_j(L):
    H, B = 3, 2
    M = 2 * L - 1
    bd = torch.randn(H, B, L, M)
    got = tsa.rel_shift(bd)
    for i in range(L):
        for j in range(L):
            assert torch.equal(got[:, :, i, j], bd[:, :, i, L - 1 - i + j].T)
    table = tsa.rel_pos_table(L, 6, torch.float32, "cpu")
    assert torch.allclose(table[L - 1], torch.tensor([0.0, 1.0] * 3))


# ---- (c): the reference's positional term ----------------------------------
def test_the_references_position_term_equals_a_brute_force_loop():
    """(c) at L = 5: (q_i + v_h) . (R_{i-j} W_pos)_h by a loop over (i,
    j), R from ``math.sin`` / ``math.cos`` of the distance."""
    fam = encoders.load("CONFORMER")
    g = torch.Generator().manual_seed(3)
    B, L, H, dk = 2, 5, 2, 4
    D = H * dk
    q = torch.randn(B, L, H, dk, generator=g)
    p = {"w_pos": torch.randn(D, D, generator=g),
         "pos_v": torch.randn(H, dk, generator=g)}
    got = fam.position_term(PREC, p, q)
    want = torch.zeros(B, H, L, L, dtype=torch.float64)
    for i in range(L):
        for j in range(L):
            R = torch.tensor([
                (math.sin if k % 2 == 0 else math.cos)(
                    (i - j) / 10000 ** (2 * (k // 2) / D)) for k in range(D)],
                dtype=torch.float64)
            pos = (R @ p["w_pos"].double()).reshape(H, dk)
            for b in range(B):
                for h in range(H):
                    want[b, h, i, j] = (q[b, i, h].double()
                                        + p["pos_v"][h].double()) @ pos[h]
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=0)


# ---- (d): the beam through ASR --------------------------------------------
def test_asr_beam_matches_the_reference_beam():
    """(d) ``ASR(bw=4).transcribe_wavs`` on a few short wavs, through the
    chunk pipeline, judged as the cell's ``correct`` judges it: the same
    hypotheses as the reference's own beam, the same scores."""
    cfg = _cfg()
    cfg["beam_width"] = 4
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    cell = copy.deepcopy(common.load(
        "workloads", "las_conformer_l_f32.offline_aishell_b128"))
    cell["check"]["sample"] = 5
    run = offline.Driver(cell, cfg, mix, TINY_SEED, device="cpu")
    run.setup()
    run.call()
    got = run.check()
    assert got["score_gap"] < 1e-4
    assert got["best_gap"] == got["hyp_mismatch"] == got["text_mismatch"] == 0


# ---- (e): a train step ------------------------------------------------------
def _ref_loss(cfg, params, x, lens, tin, tout, tl):
    """``reference/las.py`` ``train_loss`` with the encoder on batch
    statistics (``train=True``)."""
    enc, elens, state = encoders.of(cfg).encode(PREC, params, x, lens, cfg,
                                                train=True)
    dec = ref.Decoder(PREC, params, enc, elens, state, 1)
    logp = torch.stack([dec.step(tin[:, t]) for t in range(tin.shape[1])], 1)
    ls, V = cfg["train"]["label_smooth"], logp.shape[-1]
    tgt = logp.gather(-1, tout[..., None])[..., 0]
    per = -(1 - ls) * tgt - ls / (V - 1) * (logp.sum(-1) - tgt)
    mask = (torch.arange(tin.shape[1])[None] < tl[:, None]).float()
    return (per * mask).sum() / mask.sum()


def test_a_fit_step_matches_the_references_autograd(tmp_path):
    """(e) one ``Trainer.fit`` step (Adam): its loss, and every gradient as
    Adam's first moment holds it (less the weight decay), against the
    reference's autograd with BatchNorm on batch statistics; the running
    statistics move by 0.9 running + 0.1 the batch's (unbiased
    variance), as ``ops/conv.py`` defines it."""
    cfg = _cfg()
    params = weights.make_params(cfg, TINY_SEED + 2, "cpu")
    pcfg = offline.port_config(cfg).with_(
        "train", num_eval_steps=0, save_dir=str(tmp_path)).replace(
            verbose=False)
    x, lens = _feats(cfg, [48, 37, 20], seed=2)
    g = torch.Generator().manual_seed(4)
    S = 5
    text = torch.randint(4, 64, (3, S - 1), generator=g)
    tin = torch.cat([torch.full((3, 1), 1), text], 1)
    tout = torch.cat([text, torch.full((3, 1), 2)], 1)
    tl = torch.tensor([5, 4, 3])
    tr = Trainer(pcfg, params, device="cpu")
    before = copy.deepcopy(tr.params)
    tape = []
    tenc.apply_encoder(before["encoder"], pcfg, x, lens, train=True,
                       bn_updates=tape)
    kept = {}
    step_fn = tr._step_fn

    def keep(p, o, batch, gen):
        out = step_fn(p, o, batch, gen)
        kept["loss"] = float(out[2]["loss"])
        kept["mu"] = {k[3:]: v.clone() for k, v in out[1].items()
                      if k.startswith("mu/")}
        return out

    tr._step_fn = keep
    tr.fit(lambda: iter([Batch(x, lens, tin, tout, tl)]), max_steps=1)
    flat = {n: t.detach().clone().requires_grad_(True)
            for n, t in ref.leaves(params).items()}
    loss = _ref_loss(cfg, ref._tree_like(params, flat), x, lens, tin, tout,
                     tl)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()),
                                               allow_unused=True)))
    assert kept["loss"] == pytest.approx(loss.item(), rel=1e-5)
    wd = cfg["train"]["l2_decay"]
    p0 = optim.flatten(before)
    peak = {n: float(grads[n].abs().max()) for n in kept["mu"]}
    floor = sorted(peak.values())[len(peak) // 2]
    checked = 0
    for n, mu in kept["mu"].items():
        got = mu / (1 - 0.9) - wd * p0[n]
        torch.testing.assert_close(got, grads[n], rtol=0, msg=n,
                                   atol=1e-4 * max(peak[n], floor))
        checked += 1
    assert checked == len(grads) - 2 * len(tape)     # the running stats
    assert len(tape) == cfg["encoder"]["num_layers"]
    for i, (_, m, v, count) in enumerate(tape):
        blk = tr.params["encoder"]["blocks"][i]["conv"]
        old = before["encoder"]["blocks"][i]["conv"]
        torch.testing.assert_close(blk["bn_mean"], 0.9 * old["bn_mean"]
                                   + 0.1 * m, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(blk["bn_var"], 0.9 * old["bn_var"]
                                   + 0.1 * v * count / (count - 1),
                                   atol=1e-6, rtol=1e-5)
        assert not torch.equal(blk["bn_mean"], old["bn_mean"])


# ---- (f): the counter and the span -----------------------------------------
def test_blocks_counted_and_the_eager_encode_spanned():
    """(f) a 17-block configuration counts 17 blocks in a call of one
    chunk, and on the CPU the encoder runs in one ``asr.encode`` span."""
    cfg = _cfg(num_layers=17)
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    wavs, _ = traffic.corpus(mix, TINY_SEED, "cpu")
    pcfg = offline.port_config(cfg)
    asr = tapi.ASR(cfg=pcfg, bw=2, device="cpu",
                   vocab=tapi._identity_vocab(pcfg.vocab.vocab_size))
    asr.params = weights.make_params(cfg, TINY_SEED, "cpu")
    before = tconf.blocks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        texts = asr.transcribe_wavs(wavs[:3], max_batch=3)
    assert len(texts) == 3
    assert tconf.blocks - before == 17
    spans = [e for e in prof.events() if e.name == "asr.encode"]
    assert len(spans) == 1


@pytest.mark.parametrize("slice_elems", [tconv.SUBSAMPLE_SLICE_ELEMS, 1])
def test_every_product_goes_through_linear(monkeypatch, slice_elems):
    """The encoder's products all go through ``ops/cuda/gemm.py``
    ``linear`` (on the card, K7): 8 a block and one for each of the
    subsampling's row slices (one, or a row each); on the CPU each is
    counted as a fallback to ``x @ w + b``."""
    monkeypatch.setattr(tconv, "SUBSAMPLE_SLICE_ELEMS", slice_elems)
    cfg = _cfg()
    pcfg = offline.port_config(cfg)
    params = weights.make_params(cfg, TINY_SEED, "cpu")["encoder"]
    x, lens = _feats(cfg, [61, 40, 23, 9])
    before = tgemm.launches, tgemm.fallbacks
    tenc.apply_encoder(params, pcfg, x, lens)
    slices = 1 if slice_elems > 1 else len(lens)
    assert (tgemm.launches - before[0], tgemm.fallbacks - before[1]) == (
        0, 8 * pcfg.encoder.num_layers + slices)


def test_the_program_and_the_reference_count_frames_alike():
    cfg = _cfg()
    fam = encoders.of(cfg)
    for n in [0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 100, 1268]:
        want = max(0, ((n - 1) // 2 - 1) // 2)
        assert fam.frames(n, cfg) == want
        assert int(tconv.subsample_out_len(torch.tensor([n]))) == want
