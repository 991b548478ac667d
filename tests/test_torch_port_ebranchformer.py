"""PyTorch port, the E-Branchformer encoder (``models/e_branchformer.py``,
its ops in ``ops/conv.py`` and ``ops/self_attention.py``) against the
benchmark's plain reference of the family
(``port_bench/encoders/e_branchformer.py``), at tiny widths (d 32, 2
blocks, 4 heads, FFN 64, cgMLP 96 with a depthwise kernel of 7, a merge
kernel of 5) on seeded random weights drawn by the benchmark
(``port_bench/lib/weights.py``), which both sides take.  The JAX package
has no E-Branchformer, so nothing here compares against JAX.

Tolerances: the encoder's output 1e-5 absolute (float32 on both sides,
its sums in other orders, compounded over 2 blocks of unit-scale
LayerNorm outputs: the differences read ~1e-6); a padded row against
the row alone 1e-5 (the same rounding from GEMMs of other shapes);
padding exactly 0; the cgMLP and the merge against float64 loops 1e-5
(float32 products of a few dozen terms of unit scale); the beam as the
cell's ``correct`` compares it (the same tokens, scores within 1e-4);
the train step's loss 1e-5 relative and each gradient within 1e-4 of
the largest entry of that leaf's reference gradient, or of the median
leaf's where that is larger (float32 backward in other orders)."""

import copy
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch.data.dataset import Batch
from chinese_asr_tpu_torch.models import e_branchformer as teb
from chinese_asr_tpu_torch.models import encoder as tenc
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.ops import conv as tconv
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
from chinese_asr_tpu_torch.train import optim
from chinese_asr_tpu_torch.train.trainer import Trainer
from port_bench import encoders
from port_bench.lib import common, offline, traffic, weights
from port_bench.reference import las as ref
from port_bench.tests.conftest import TINY_SEED, tiny_config, tiny_mix

CONFIG = "las_ebranchformer_l_f32"
PREC = ref.Precision()


def _cfg(**encoder):
    cfg = tiny_config(common.load("configs", CONFIG))
    cfg["encoder"].update(encoder)
    return cfg


def _feats(lens, seed=0):
    g = torch.Generator().manual_seed(seed)
    T = max(lens)
    x = torch.randn(len(lens), T, 80, generator=g)
    lens = torch.tensor(lens)
    x[torch.arange(T)[None] >= lens[:, None]] = 0.0
    return x, lens


def test_the_tiny_config_is_the_one_asked():
    enc = _cfg()["encoder"]
    assert (enc["hidden_size"], enc["num_layers"], enc["self_attn_heads"],
            enc["ffn_size"], enc["cgmlp_size"], enc["ks"],
            enc["merge_ks"]) == (32, 2, 4, 64, 96, 7, 5)
    full = common.load("configs", CONFIG)["encoder"]
    assert (full["hidden_size"], full["num_layers"], full["self_attn_heads"],
            full["ffn_size"], full["cgmlp_size"], full["ks"],
            full["merge_ks"]) == (512, 17, 8, 1024, 3072, 31, 31)


def test_the_full_width_encoder_has_the_published_parameter_count():
    """The program's tree at full width: 116,007,936 parameters (the
    paper's 148.9 M less ESPnet's decoder and CTC head): the subsampling
    7,346,176, a block 6,391,808, the final LayerNorm 1,024."""
    pcfg = offline.port_config(common.load("configs", CONFIG))
    tree = tenc.init_encoder(torch.Generator(), pcfg)
    count = lambda t: sum(v.numel() for _, v in las.tree_paths(t))
    assert count(tree) == 116_007_936
    assert count(tree["subsample"]) == 7_346_176
    assert count(tree["blocks"][0]) == 6_391_808
    assert tenc.encoder_output_size(pcfg) == 512


# ---- the encoder ------------------------------------------------------------
def test_encoder_matches_the_reference():
    """The output, lens and the decoder's zero start."""
    cfg = _cfg()
    params = weights.make_params(cfg, TINY_SEED, "cpu")
    x, lens = _feats([61, 40, 23, 9])
    r, rl, (h, c) = encoders.of(cfg).encode(PREC, params, x, lens, cfg)
    eb = las.encode(params, offline.port_config(cfg), x, lens)
    n = tconv.subsample_out_len(lens)
    assert torch.equal(rl, n) and n.tolist() == [14, 9, 5, 1]
    torch.testing.assert_close(eb.enc_out, r, atol=1e-5, rtol=0)
    assert eb.init_cell_state is None
    assert not h.any() and not c.any()


def test_a_padded_batch_equals_each_row_alone():
    """Each row's output on its own frames, padding exactly 0."""
    cfg = _cfg()
    pcfg = offline.port_config(cfg)
    params = weights.make_params(cfg, TINY_SEED + 1, "cpu")["encoder"]
    x, lens = _feats([57, 31, 12], seed=1)
    out = tenc.apply_encoder(params, pcfg, x, lens)
    for b in range(len(lens)):
        n = int(lens[b])
        alone = tenc.apply_encoder(params, pcfg, x[b:b + 1, :n], lens[b:b + 1])
        m = int(out.out_lens[b])
        assert alone.out.shape[1] == m
        torch.testing.assert_close(out.out[b, :m], alone.out[0], atol=1e-5,
                                   rtol=0)
        assert not out.out[b, m:].any()


# ---- the cgMLP and the merge against loops ----------------------------------
def _dw_loop(x, w, b, lens):
    """x [B, L, C] -> [B, L, C] in float64: out[t] = b + sum over taps k of
    x[t + k - (K - 1) // 2] w[k], frames outside [0, len) read as 0."""
    B, L, C = x.shape
    K = w.shape[0]
    y = b.double().expand(B, L, C).clone()
    for r in range(B):
        for t in range(L):
            for k in range(K):
                s = t + k - (K - 1) // 2
                if 0 <= s < int(lens[r]):
                    y[r, t] += x[r, s].double() * w[k].double()
    return y


def _ln64(x, scale, bias):
    x = x.double()
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * scale.double() + bias.double()


def _block_params(seed):
    """Block 0 of the tiny configuration, drawn by the benchmark."""
    return weights.make_params(_cfg(), TINY_SEED + seed,
                               "cpu")["encoder"]["blocks"][0]


def test_the_cgmlp_branch_equals_a_loop():
    """At L = 5: LN, Linear d -> C, erf GELU, the first half times the
    second's LayerNorm and depthwise conv, Linear C / 2 -> d, in float64
    with the conv as a loop over frames and taps."""
    p = _block_params(3)["cgmlp"]
    g = torch.Generator().manual_seed(3)
    x, lens = torch.randn(2, 5, 32, generator=g), torch.tensor([5, 3])
    got = teb.cgmlp(p, x, lens)
    h = _ln64(x, p["ln_scale"], p["ln_bias"]) @ p["w1"].double() \
        + p["b1"].double()
    h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
    r, gate = h[..., :48], _ln64(h[..., 48:], p["gate_ln_scale"],
                                 p["gate_ln_bias"])
    gate = _dw_loop(gate, p["dw_w"], p["dw_b"], lens)
    want = (r * gate) @ p["w2"].double() + p["b2"].double()
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=0)


def test_the_merge_with_and_without_the_concatenation_equals_a_loop():
    """At L = 5: Linear 2d -> d of m + DWConv(m), m = [g, c], as the
    program computes it (one product over the concatenation) and as two
    halves convolved and multiplied apart, both against a float64 loop."""
    p = _block_params(4)["merge"]
    gen = torch.Generator().manual_seed(4)
    g, c = torch.randn(2, 5, 32, generator=gen), torch.randn(2, 5, 32,
                                                             generator=gen)
    lens = torch.tensor([5, 2])
    m = torch.cat([g, c], -1)
    want = (m.double() + _dw_loop(m, p["dw_w"], p["dw_b"], lens)) \
        @ p["w"].double() + p["b"].double()
    got = teb.merge(p, g, c, lens)
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=0)
    halves = []
    for half, cols in ((g, slice(0, 32)), (c, slice(32, 64))):
        dw = tconv.depthwise_conv1d_same(half, p["dw_w"][:, cols],
                                         p["dw_b"][cols], lens)
        halves.append((half + dw.transpose(1, 2)) @ p["w"][cols])
    apart = halves[0] + halves[1] + p["b"]
    torch.testing.assert_close(apart.double(), want, atol=1e-5, rtol=0)


# ---- the beam through ASR ---------------------------------------------------
def test_asr_beam_matches_the_reference_beam():
    """``ASR(bw=4).transcribe_wavs`` on a few short wavs, through the chunk
    pipeline, judged as the cell's ``correct`` judges it: the same
    hypotheses as the reference's own beam, the same scores."""
    cfg = _cfg()
    cfg["beam_width"] = 4
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    cell = copy.deepcopy(common.load(
        "workloads", CONFIG + ".offline_aishell_b128"))
    cell["check"]["sample"] = 5
    run = offline.Driver(cell, cfg, mix, TINY_SEED, device="cpu")
    run.setup()
    run.call()
    got = run.check()
    assert got["score_gap"] < 1e-4
    assert got["best_gap"] == got["hyp_mismatch"] == got["text_mismatch"] == 0


# ---- a train step -----------------------------------------------------------
def test_a_fit_step_matches_the_references_autograd(tmp_path):
    """One ``Trainer.fit`` step (Adam): its loss, and every gradient as
    Adam's first moment holds it (less the weight decay), against the
    autograd of ``reference/las.py`` ``train_loss``."""
    cfg = _cfg()
    params = weights.make_params(cfg, TINY_SEED + 2, "cpu")
    pcfg = offline.port_config(cfg).with_(
        "train", num_eval_steps=0, save_dir=str(tmp_path)).replace(
            verbose=False)
    x, lens = _feats([48, 37, 20], seed=2)
    g = torch.Generator().manual_seed(4)
    S = 5
    text = torch.randint(4, 64, (3, S - 1), generator=g)
    tin = torch.cat([torch.full((3, 1), 1), text], 1)
    tout = torch.cat([text, torch.full((3, 1), 2)], 1)
    tl = torch.tensor([5, 4, 3])
    tr = Trainer(pcfg, params, device="cpu")
    before = copy.deepcopy(tr.params)
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
    feats = [x[b, :int(lens[b])] for b in range(len(lens))]
    loss = ref.train_loss(PREC, ref._tree_like(params, flat), feats, tin,
                          tout, tl, cfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert kept["loss"] == pytest.approx(loss.item(), rel=1e-5)
    wd = cfg["train"]["l2_decay"]
    p0 = optim.flatten(before)
    peak = {n: float(grads[n].abs().max()) for n in kept["mu"]}
    floor = sorted(peak.values())[len(peak) // 2]
    assert set(kept["mu"]) == set(grads)
    for n, mu in kept["mu"].items():
        got = mu / (1 - 0.9) - wd * p0[n]
        torch.testing.assert_close(got, grads[n], rtol=0, msg=n,
                                   atol=1e-4 * max(peak[n], floor))
    assert any(n.startswith("encoder/blocks/1/merge/") for n in grads)


# ---- the counter, the span and the products ---------------------------------
def test_blocks_counted_and_the_eager_encode_spanned():
    """A 17-block configuration counts 17 blocks in a call of one chunk,
    and on the CPU the encoder runs in one ``asr.encode`` span."""
    cfg = _cfg(num_layers=17)
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    wavs, _ = traffic.corpus(mix, TINY_SEED, "cpu")
    pcfg = offline.port_config(cfg)
    asr = tapi.ASR(cfg=pcfg, bw=2, device="cpu",
                   vocab=tapi._identity_vocab(pcfg.vocab.vocab_size))
    asr.params = weights.make_params(cfg, TINY_SEED, "cpu")
    before = teb.blocks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        texts = asr.transcribe_wavs(wavs[:3], max_batch=3)
    assert len(texts) == 3
    assert teb.blocks - before == 17
    spans = [e for e in prof.events() if e.name == "asr.encode"]
    assert len(spans) == 1


@pytest.mark.parametrize("slice_elems", [tconv.SUBSAMPLE_SLICE_ELEMS, 1])
def test_every_product_goes_through_linear(monkeypatch, slice_elems):
    """The encoder's products all go through ``ops/cuda/gemm.py``
    ``linear`` (on the card, K7): 9 a block and one for each of the
    subsampling's row slices (one, or a row each); on the CPU each is
    counted as a fallback to ``x @ w + b``."""
    monkeypatch.setattr(tconv, "SUBSAMPLE_SLICE_ELEMS", slice_elems)
    cfg = _cfg()
    pcfg = offline.port_config(cfg)
    params = weights.make_params(cfg, TINY_SEED, "cpu")["encoder"]
    x, lens = _feats([61, 40, 23, 9])
    before = tgemm.launches, tgemm.fallbacks, teb.blocks
    tenc.apply_encoder(params, pcfg, x, lens)
    slices = 1 if slice_elems > 1 else len(lens)
    assert teb.blocks - before[2] == pcfg.encoder.num_layers
    assert (tgemm.launches - before[0], tgemm.fallbacks - before[1]) == (
        0, 9 * pcfg.encoder.num_layers + slices)
