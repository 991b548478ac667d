"""PyTorch port, the config variants: GRU / RNN decoders, Luong wiring
(``attn_type="L"``), several attention heads with ``map_enc`` and
``linear_map``, unidirectional and GRU encoders and the learned decoder
init, through the decoder step, greedy, beam and the train step against
the JAX package (params carried by ``params_from_numpy``, the same numpy
features fed to both, JAX on the CPU); every config JAX accepts through
``ASR`` and ``Trainer``; checkpoints of a BatchNorm family with a GRU
decoder and Luong wiring; the reference-format export.

Tolerances, as tests/test_torch_port_decode.py and
tests/test_torch_port_train.py hold them: one decoder step 1e-5; scores
accumulated over a decode 1e-4; tokens, lengths, n-best slots and the
stop step exactly; the train step's loss 2e-5 relative, grad norm 1e-4
relative, params 2e-5 absolute.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.decode import greedy as jgreedy
from chinese_asr_tpu.models import decoder as jdec
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.train import optim as joptim
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.api import ASR
from chinese_asr_tpu_torch.data import audio_io, dataset
from chinese_asr_tpu_torch.data.dataset import Batch as TBatch
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.decode import greedy as tgreedy
from chinese_asr_tpu_torch.models import decoder as tdec
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train import step as tstep
from chinese_asr_tpu_torch.train.trainer import Trainer
from chinese_asr_tpu_torch.utils import checkpoint as tck
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import N, T, jax_params_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_STEP = 1e-5
ATOL_SCORE = 1e-4

# name -> {config section: fields}, on tests/test_config_variants.py's
# small config
VARIANTS = {
    "gru_decoder": dict(decoder=dict(decoder_type="GRU"),
                        encoder=dict(encoder_type="GRU")),
    "rnn_tanh_decoder": dict(decoder=dict(decoder_type="RNN_TANH")),
    "luong": dict(attention=dict(attn_type="L", attn_hidden_size=20)),
    "heads4_map_linear": dict(attention=dict(heads=4, map_enc=True,
                                             linear_map=True)),
    "luong_heads_relu_init": dict(
        attention=dict(attn_type="L", attn_hidden_size=12, heads=2,
                       map_enc=True),
        decoder=dict(decoder_type="RNN_RELU", init_cell_state_as_param=True),
        encoder=dict(encoder_type="SELF_ATTENTION")),
    "unidirectional": dict(encoder=dict(bidirectional=False,
                                        hidden_size=32)),
}


def small(m, **over):
    cfg = (m.Config()
           .with_("audio", n_mels=8, delta_delta=False, downsample=False)
           .with_("encoder", hidden_size=16, num_layers=2)
           .with_("decoder", hidden_size=32, embed_dim=12)
           .with_("attention", attn_size=8)
           .with_("vocab", max_num_words=16)
           .with_("decode", max_len=6)
           .with_("train", label_smooth=0.1, base_lr=3e-3, l2_decay=1e-4))
    for sec, kw in over.items():
        cfg = cfg.with_(sec, **kw)
    return cfg


def both(name, seed=0):
    """(jax cfg, torch cfg, jax params, torch params) of a variant; the
    learned init state (zeros at init) is moved off zero."""
    cj, ct = small(jcfg, **VARIANTS[name]), small(tcfg, **VARIANTS[name])
    jp = jax.jit(lambda k: jlas.init_params(k, cj))(
        jax.random.PRNGKey(seed))
    if "init_state" in jp["decoder"]:
        rs = np.random.RandomState(seed)
        jp["decoder"]["init_state"] = [
            jnp.asarray(0.3 * rs.randn(*e.shape), jnp.float32)
            for e in jp["decoder"]["init_state"]]
    return cj, ct, jp, tlas.params_from_numpy(jax_params_numpy(jp))


def make_feats(cfg, B=3, T_=11, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
    lens = np.array([T_, T_ - 3, 4][:B], np.int32)
    x[np.arange(T_)[None, :] >= lens[:, None]] = 0.0
    return x, lens


def close(got, ref, atol, msg=""):
    np.testing.assert_allclose(N(got), N(ref), rtol=0, atol=atol, err_msg=msg)


def assert_state_close(ts, js):
    jl = jax.tree_util.tree_leaves(js)
    tl = jax.tree_util.tree_leaves(ts)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        close(a, b, ATOL_STEP)


# --------------------------------------------------------------------------
# the decoder step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("beam", [False, True])
def test_decoder_step_matches_jax(name, beam):
    """The encode prologue (its initial cell state included), then one
    decoder step from it with a given token and attentional state."""
    cj, ct, jp, tp = both(name)
    x, lens = make_feats(cj)
    k = 3 if beam else 1
    B = x.shape[0]
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cj.vocab.vocab_size, B * k).astype(np.int32)
    teb = tlas.encode(tp, ct, T(x), T(lens))
    ctx = tdec.attn_hidden_width(ct.attention, teb.values.shape[-1])
    ahs = rng.standard_normal((B * k, ctx)).astype(np.float32)
    jfn = jdec.decoder_step_beam if beam else jdec.decoder_step
    tfn = tdec.decoder_step_beam if beam else tdec.decoder_step

    def jax_side(p, x, lens, tok, ahs):
        eb = jlas.encode(p, cj, x, lens)
        if eb.init_cell_state is None:
            z = jnp.zeros((B * k, cj.decoder.hidden_size))
            cell = None if not beam else [
                (z, z) if cj.decoder.decoder_type == "LSTM" else z
            ] * cj.decoder.num_layers
        else:
            cell = jax.tree_util.tree_map(
                lambda e: jnp.repeat(e, k, axis=0), eb.init_cell_state)
        return eb, jfn(p["decoder"], p["attention"], cj.decoder,
                       cj.attention, eb.mask, eb.keys, eb.values, tok, cell,
                       ahs)

    jeb, jo = jax.jit(jax_side)(jp, *map(jnp.asarray, (x, lens, tok, ahs)))
    close(teb.enc_out, jeb.enc_out, ATOL_STEP)
    close(teb.values, jeb.values, ATOL_STEP)
    assert (teb.init_cell_state is None) == (jeb.init_cell_state is None)
    if teb.init_cell_state is None:
        tcell = None if not beam else tdec.zero_cell_state(ct.decoder, T(x),
                                                           B * k)
    else:
        assert_state_close(teb.init_cell_state, jeb.init_cell_state)
        tcell = jax.tree_util.tree_map(
            lambda e: e.repeat_interleave(k, dim=0), teb.init_cell_state)
    to = tfn(tp["decoder"], tp["attention"], ct.decoder, ct.attention,
             teb.mask, teb.keys, teb.values, T(tok).long(), tcell, T(ahs))
    for f in ("logit", "attn_hidden_state", "alignment"):
        close(getattr(to, f), getattr(jo, f), ATOL_STEP, f"{name} {f}")
    assert_state_close(to.cell_state, jo.cell_state)
    if cj.decoder.decoder_type != "LSTM":
        assert all(isinstance(s, torch.Tensor) for s in to.cell_state)


# --------------------------------------------------------------------------
# greedy and beam
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_and_beam_match_jax(name):
    cj, ct, jp, tp = both(name, seed=2)
    x, lens = make_feats(cj, seed=3)
    jr = jgreedy.greedy_decode_jit(jp, cj, jnp.asarray(x), jnp.asarray(lens))
    tr = tgreedy.greedy_decode(tp, ct, T(x), T(lens))
    np.testing.assert_array_equal(N(tr.tokens), N(jr.tokens))
    np.testing.assert_array_equal(N(tr.final_lens), N(jr.final_lens))
    np.testing.assert_array_equal(N(tr.finished), N(jr.finished))
    close(tr.scores, jr.scores, ATOL_SCORE)
    close(tr.alignments, jr.alignments, ATOL_SCORE)     # first head's
    bw = 3
    jb = jbeam.beam_decode_jit(jp, cj, bw, jnp.asarray(x), jnp.asarray(lens))
    tb = tbeam.beam_decode(tp, ct, bw, T(x), T(lens))
    assert tb.l_final == int(jb.l_final)
    np.testing.assert_array_equal(N(tb.fin_count), N(jb.fin_count))
    js, ts = N(jb.fin_scores), N(tb.fin_scores)
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), finite)
    close(ts[finite], js[finite], ATOL_SCORE)
    np.testing.assert_array_equal(N(tb.fin_tokens)[finite],
                                  N(jb.fin_tokens).astype(np.int32)[finite])
    np.testing.assert_array_equal(N(tb.live_tokens),
                                  N(jb.live_tokens).astype(np.int32))
    close(tb.live_scores, jb.live_scores, ATOL_SCORE)
    jsel = jbeam.select_best(jb, cj.decode.length_weight)
    tsel = tbeam.select_best(tb, ct.decode.length_weight)
    for f in ("tokens", "lens", "finished"):
        np.testing.assert_array_equal(N(getattr(tsel, f)),
                                      N(getattr(jsel, f)), err_msg=f)
    close(tsel.scores, jsel.scores, ATOL_SCORE)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
def make_batch(cfg, seed=0, B=4, T_=9, S=6):
    """tests/test_torch_port_train.py's ragged numpy batch."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
    feat_lens = np.full(B, T_, np.int32)
    feat_lens[1:] = rng.randint(T_ // 2, T_ + 1, B - 1)
    feats[np.arange(T_)[None, :] >= feat_lens[:, None]] = 0.0
    text_lens = np.full(B, S, np.int32)
    text_lens[1:] = rng.randint(2, S + 1, B - 1)
    text = rng.randint(4, cfg.vocab.vocab_size, size=(B, S - 1))
    tin = np.concatenate([np.full((B, 1), cfg.vocab.sos), text], axis=1)
    tout = np.concatenate([text, np.full((B, 1), cfg.vocab.eos)], axis=1)
    for b in range(B):
        tout[b, text_lens[b] - 1] = cfg.vocab.eos
        tout[b, text_lens[b]:] = cfg.vocab.pad
        tin[b, text_lens[b]:] = cfg.vocab.pad
    return (feats, feat_lens, tin.astype(np.int32), tout.astype(np.int32),
            text_lens)


@pytest.mark.parametrize("name,opt", [("gru_decoder", "ADAM"),
                                      ("heads4_map_linear", "ADAM"),
                                      ("luong_heads_relu_init", "SGD")])
def test_train_step_matches_jax(name, opt):
    """Two updates with the clip acting: loss, grad norm and every
    parameter after each step.  The self-attention encoder steps with
    SGD: its key bias has a zero gradient up to rounding (a softmax does
    not see a shift shared by all its scores), and Adam's normalization
    would turn that rounding noise into a full-lr step of either sign."""
    cj, ct, jp, tp = both(name, seed=4)
    cj = cj.with_("train", clip=0.1, optimizer=opt)
    ct = ct.with_("train", clip=0.1, optimizer=opt)
    tx_j = joptim.make_optimizer(cj.train, jp)
    tx_t = toptim.make_optimizer(ct.train)
    oj, ot = tx_j.init(jp), tx_t.init(tp)
    step_j = jax.jit(lambda p, o, b: jstep.train_step(p, o, cj, tx_j, b))
    for i in range(2):
        nb = make_batch(cj, seed=20 + i)
        jp, oj, mj = step_j(jp, oj, jstep.Batch(*map(jnp.asarray, nb)))
        tp, ot, mt = tstep.train_step(tp, ot, ct, tx_t, TBatch(*map(T, nb)))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        for (path, a), (_, b) in zip(tlas.tree_paths(tp),
                                     tlas.tree_paths(jax_params_numpy(jp))):
            np.testing.assert_allclose(N(a), b, rtol=0, atol=2e-5,
                                       err_msg=str(path))


# --------------------------------------------------------------------------
# every config JAX accepts, through ASR and Trainer
# --------------------------------------------------------------------------
ENCODER_TYPES = ["LSTM", "GRU", "RNN_TANH", "RNN_RELU", "CNN1D", "CNN2D",
                 "CNN1D_RNN", "CNN1D_SELF_ATTENTION", "SELF_ATTENTION",
                 "SELF_LOCAL_ATTENTION", "CRNN", "DCNN"]
CONFIGS = ([dict(encoder=dict(encoder_type=et)) for et in ENCODER_TYPES]
           + [dict(decoder=dict(decoder_type=dt))
              for dt in ("GRU", "RNN_TANH", "RNN_RELU")]
           + [dict(attention=dict(attn_type="L", attn_hidden_size=20)),
              dict(attention=dict(heads=2, map_enc=True, linear_map=True))])


def _tiny(**over):
    cfg = (tcfg.Config()
           .with_("audio", n_mels=8, delta_delta=True, downsample=False)
           .with_("encoder", hidden_size=16, num_layers=2, ks=3,
                  stride=(2, 2), self_attn_heads=2, ffn_size=24,
                  conv_channels=4, dcnn_middle=1, ws=5)
           .with_("decoder", hidden_size=16, embed_dim=8)
           .with_("attention", attn_size=8)
           .with_("vocab", max_num_words=16)
           .with_("decode", max_len=5)
           .with_("train", base_lr=1e-3))
    for sec, kw in over.items():
        cfg = cfg.with_(sec, **kw)
    return cfg


@pytest.mark.parametrize("over", CONFIGS,
                         ids=lambda o: "-".join(str(v) for d in o.values()
                                                for v in d.values()))
def test_every_config_runs_through_asr_and_trainer(over, tmp_path):
    """None of them raises: greedy and beam transcripts through ``ASR``,
    one ``Trainer`` step with a finite loss, on the CPU."""
    cfg = _tiny(**over).with_("train", save_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(n) * 3000).astype(np.int16)
            for n in (6000, 3500)]
    for bw in (None, 2):
        texts = ASR(cfg=cfg, device="cpu", bw=bw, seed=1).transcribe_wavs(
            wavs)
        assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    tr = Trainer(cfg, tlas.init_params(cfg, seed=1), device="cpu")
    nb = make_batch(cfg, B=2, T_=12, S=4)
    p, o, m = tr._step_fn(tr.params, tr.opt_state, TBatch(*map(T, nb)),
                          None)
    assert np.isfinite(float(m["loss"])) and not bool(m["skipped"])


def test_only_multi_device_raises_not_implemented():
    """No NotImplementedError is left on a config JAX accepts: the mesh,
    the last one (multi-device decoding and training), is ported
    (tests/test_torch_port_mesh.py)."""
    pkg = os.path.join(ROOT, "chinese_asr_tpu_torch")
    hits = []
    for path in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True):
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if "NotImplementedError" in line:
                    hits.append((os.path.relpath(path, pkg), line.strip()))
    assert hits == [], hits
    with open(os.path.join(pkg, "api.py"), encoding="utf-8") as f:
        api = f.read()
    assert not re.search(r"if mesh is not None:\s+raise", api)
    for p in ("models/encoder.py", "models/attention.py", "ops/rnn.py"):
        with open(os.path.join(pkg, p), encoding="utf-8") as f:
            assert "encoder-families slice" not in f.read()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def test_bn_family_fits_checkpoints_and_transcribes(tmp_path):
    """CNN1D_RNN (a BatchNorm front and a GRU stack) with a GRU decoder
    and Luong wiring: ``Trainer.fit`` moves the running stats and writes a
    checkpoint, which ``ASR`` loads and the JAX package reads leaf for
    leaf."""
    from chinese_asr_tpu.utils.checkpoint import load_checkpoint as jload

    rng = np.random.RandomState(0)
    texts = ["abcd", "efgh", "abef", "cdgh"]
    utts = []
    for i, t in enumerate(texts):
        p = str(tmp_path / f"u{i}.wav")
        audio_io.write_wav(p, (0.1 * rng.randn(4000 + 800 * i)
                               ).astype(np.float32))
        utts.append(dataset.Utterance(p, t))
    mpath = str(tmp_path / "m.tsv")
    dataset.write_manifest(mpath, utts)
    vocab = Vocab.build(texts, max_num_words=8)
    cfg = (_tiny(encoder=dict(encoder_type="CNN1D_RNN"),
                 decoder=dict(decoder_type="GRU"),
                 attention=dict(attn_type="L", attn_hidden_size=12))
           .with_("audio", n_mels=8, delta_delta=False)
           .with_("vocab", max_num_words=8)
           .with_("train", batch_size=2, eval_batch_size=2, epochs=1,
                  num_eval_steps=100, save_dir=str(tmp_path / "ckpt")))
    params0 = tlas.init_params(cfg, seed=0)
    tr = Trainer(cfg, params0, vocab=vocab, device="cpu")

    def loader(fn):
        return lambda: dataset.batches_to_device(fn(mpath, cfg, vocab), cfg,
                                                 "cpu")

    tr.fit(loader(dataset.make_train_loader), loader(dataset.make_eval_loader),
           max_steps=2)
    front = tr.params["encoder"]["front"]["convs"][0]
    assert not torch.equal(front["bn_mean"],
                           params0["encoder"]["front"]["convs"][0]["bn_mean"])
    [ck] = glob.glob(str(tmp_path / "ckpt" / "step-2_wer-*.ckpt"))
    payload = tck.load_checkpoint(ck)
    for (path, a), (_, b) in zip(tlas.tree_paths(payload["params"]),
                                 tlas.tree_paths(tr.params)):
        np.testing.assert_array_equal(a, N(b), err_msg=str(path))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jload(ck)["params"])[0],
            tlas.tree_paths(payload["params"])):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    wav = audio_io.read_wav(str(tmp_path / "u0.wav"))[0]
    for bw in (None, 2):
        out = ASR(ckpt_path=ck, cfg=cfg, vocab=vocab, bw=bw,
                  device="cpu").transcribe_wavs([wav])
        assert len(out) == 1 and isinstance(out[0], str)


def test_reference_export_matches_jax_and_round_trips(tmp_path):
    """GRU encoder, GRU decoder, Luong wiring, 2 heads with map_enc and
    linear_map, learned init: the port's reference-format state dicts
    equal JAX's, and the .ckpt re-imports bit for bit; the non-RNN
    families raise in both, as JAX's export does."""
    over = dict(encoder=dict(encoder_type="GRU"),
                decoder=dict(decoder_type="GRU",
                             init_cell_state_as_param=True),
                attention=dict(attn_type="L", attn_hidden_size=12, heads=2,
                               map_enc=True, linear_map=True))
    cj, ct = small(jcfg, **over), small(tcfg, **over)
    jp = jax.jit(lambda k: jlas.init_params(k, cj))(jax.random.PRNGKey(5))
    tp = tlas.params_from_numpy(jax_params_numpy(jp))
    for js, ts in zip(jlas.params_to_torch_state(jp, cj),
                      tlas.params_to_torch_state(tp, ct)):
        assert sorted(js) == sorted(ts)
        for k in js:
            np.testing.assert_array_equal(ts[k], np.asarray(js[k]),
                                          err_msg=k)
    path = tlas.save_torch_checkpoint(str(tmp_path / "m.ckpt"), tp, ct)
    back = tlas.load_torch_checkpoint(path, ct)
    jback = jlas.load_torch_checkpoint(path, cj)
    for (p, a), (_, b), (_, c) in zip(tlas.tree_paths(back),
                                      tlas.tree_paths(tp),
                                      tlas.tree_paths(
                                          jax_params_numpy(jback))):
        np.testing.assert_array_equal(N(a), N(b), err_msg=str(p))
        np.testing.assert_array_equal(N(a), c, err_msg=str(p))
    cnn = small(tcfg, encoder=dict(encoder_type="CNN1D"))
    with pytest.raises(ValueError, match="RNN encoder family only"):
        tlas.params_to_torch_state(tlas.init_params(cnn), cnn)
    assert tlstm.launches == 0                        # the CPU takes twins
