"""PyTorch port: multi-device decoding and training (``parallel/
sharding.py``) on torch.distributed, on real gloo groups of spawned CPU
ranks at meshes (2,1), (1,2), (2,2) and JAX's (4,2).

Each mesh shape is one group of ranks (``parallel/launch.py``) that runs
the jobs of ``tests/torch_port_mesh_ranks.py`` once; the tests read its
results.  Every group has a deadline: on expiry its ranks are killed and
the test fails.  The oracles:

* the port on one device, the same job with ``mesh=None`` on the same
  inputs: held exactly on tokens, finished counts and lengths, and
  elsewhere at tests/test_sharding.py's bounds -- decode scores rtol 1e-5
  atol 1e-6, f32 loss rtol 1e-5, params after a step rtol 2e-4 atol 2e-5,
  bf16 loss rtol 1e-2;
* the JAX package on the same numpy inputs and weights: greedy through
  ``sharding.make_sharded_greedy`` on the suite's virtual CPU devices, the
  rest through JAX's single-device functions (JAX's own tests hold its
  sharded programs equal to those);
* the golden shard's ``expected.json`` in all five modes.

The train steps use ragged batches (each data shard holds another number
of target tokens, so a mean of the shards' means would differ from the
global mean) and a clip below the gradient norm (it acts on every step).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.decode import lm_fused as jlmf
from chinese_asr_tpu.lm.device_ngram import DeviceNgramLM as JDLM
from chinese_asr_tpu.parallel import sharding as jsharding
from chinese_asr_tpu.train import optim as joptim
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.parallel import launch

import torch_port_mesh_ranks as ranks
from test_lm_binary import ARPA_TRI
from test_lm_fused import random_trigram_arpa
from test_torch_port_train import make_batch, small
from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths

SHAPES = [(2, 1), (1, 2), (2, 2), (4, 2)]
SCORE = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=2e-4, atol=2e-5)
DEADLINE_S = 240.0


def _cfgs(module, **train):
    """tests/test_train.py's SMALL (L2 on), a clip below the gradient
    norm, short decodes."""
    return small(module, clip=0.1, **train).with_("decode", max_len=10)


def _bn_cfg(module):
    """A CNN1D encoder (BatchNorm) at test width; SGD, since a conv bias
    before a BatchNorm takes a zero gradient up to rounding, which ADAM
    turns into a full-lr step of random sign (ROADMAP Queue 3)."""
    return (module.Config()
            .with_("audio", n_mels=8, delta_delta=True, downsample=False)
            .with_("encoder", encoder_type="CNN1D", hidden_size=16,
                   num_layers=2, ks=3, norm="BN")
            .with_("decoder", hidden_size=16, embed_dim=8)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=16)
            .with_("train", optimizer="SGD", base_lr=0.05, momentum=0.9))


def _lm_cfg(module):
    """tests/test_lm_fused.py's SMALL (V = 12)."""
    return (module.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=5))


def _int16_wavs(seed, lens):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 6000).clip(-32768, 32767).astype(np.int16)
            for n in lens]


class World:
    """The inputs of every job, each mesh's results (one group of ranks a
    shape, run at first use) and the single device's."""

    def __init__(self, root):
        self.root = str(root)
        cfg = _cfgs(tcfg)
        self.cfg = cfg
        self.params = tlas.params_to_numpy(tlas.init_params(cfg, 2))
        rng = np.random.RandomState(0)
        B, T_ = 8, 9
        self.feats = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
        self.lens = rng.randint(5, T_ + 1, B).astype(np.int32)
        self.lens[0] = T_
        self.feats[np.arange(T_)[None, :] >= self.lens[:, None]] = 0.0
        self.batches = [make_batch(cfg, seed=10 + i, B=8) for i in range(2)]

        bn = _bn_cfg(tcfg)
        self.bn_cfg = bn
        self.bn_params = tlas.params_to_numpy(tlas.init_params(bn, 4))
        self.bn_batches = [make_batch(bn, seed=30 + i, B=8, T_=13)
                           for i in range(2)]

        lm = _lm_cfg(tcfg)
        self.lm_cfg = lm
        # seed 8: weights under which 7 of the 8 rows finish (35 slots)
        self.lm_params = tlas.params_to_numpy(tlas.init_params(lm, 8))
        rng = np.random.RandomState(31)
        self.lm_arpa = random_trigram_arpa(root, rng, 31)
        self.lm_feats = rng.randn(8, 7, lm.audio.feat_dim).astype(np.float32)
        self.lm_lens = np.full(8, 7, np.int32)
        self.tri = os.path.join(self.root, "tri.arpa")
        with open(self.tri, "w", encoding="utf-8") as f:
            f.write(ARPA_TRI)
        # the golden shard as a 7-utterance manifest (a batch that does not
        # divide the data axis) and as one long wav of 18 s
        from chinese_asr_tpu_torch.data import audio_io, dataset
        with open(os.path.join(GOLD, "expected.json"),
                  encoding="utf-8") as f:
            texts = json.load(f)["texts"]
        paths = golden_wav_paths()
        self.manifest = os.path.join(self.root, "golden.tsv")
        dataset.write_manifest(self.manifest, [
            dataset.Utterance(p, t) for p, t in zip(paths + paths[:1],
                                                    texts + texts[:1])])
        self.long_wav = os.path.join(self.root, "long.wav")
        audio_io.write_wav(self.long_wav, np.concatenate(
            [audio_io.read_wav(p, 16000)[0] for p in paths]))
        self._runs, self._single = {}, {}

    def jobs(self, shape):
        cj = self.cfg.to_json()
        decode = dict(cfg_json=cj, params_np=self.params, feats=self.feats,
                      lens=self.lens, bw=2)
        train = dict(cfg_json=cj, params_np=self.params,
                     batches=self.batches)
        jobs = {"mesh_info": {}, "decode": decode, "train": train}
        if shape == (2, 1):
            jobs["train:bn"] = dict(cfg_json=self.bn_cfg.to_json(),
                                    params_np=self.bn_params,
                                    batches=self.bn_batches)
        if shape == (2, 2):
            wavs = _int16_wavs(0, (1700, 900, 2400, 1300, 800, 2000, 1500,
                                   600, 1100))
            lm_wavs = _int16_wavs(1, (1500, 900, 1900, 700, 1200))
            golden = golden_cfg(tcfg)
            jobs.update({
                "train:one": dict(train, batches=self.batches[:1]),
                "train:bf16": dict(
                    cfg_json=self.cfg.with_(
                        "train", compute_dtype="bfloat16").to_json(),
                    params_np=self.params, batches=self.batches[:1]),
                "train:ss": dict(
                    cfg_json=self.cfg.with_("train", ss=0.5).to_json(),
                    params_np=self.params, batches=self.batches,
                    ss_seed=5),
                "trainer": dict(
                    cfg_json=self.cfg.with_(
                        "train", batch_size=8, eval_batch_size=5, epochs=1,
                        num_eval_steps=-1).to_json(),
                    params_np=self.params,
                    batches=self.batches + [make_batch(self.cfg, seed=12,
                                                       B=8)],
                    eval_batch=make_batch(self.cfg, seed=20, B=5),
                    save_dir=os.path.join(self.root, "ck_mesh")),
                "asr:greedy": dict(cfg_json=cj, wavs=wavs, bw=None),
                "asr:greedy_chunked": dict(cfg_json=cj, wavs=wavs, bw=None,
                                           max_batch=5),
                "asr:beam": dict(cfg_json=cj, wavs=wavs, bw=2),
                "asr:beam_chunked": dict(cfg_json=cj, wavs=wavs, bw=2,
                                         max_batch=5),
                "asr:wire_adpcm": dict(cfg_json=cj, wavs=wavs, bw=None,
                                       wire="adpcm"),
                "asr:wire_mulaw": dict(cfg_json=cj, wavs=wavs, bw=None,
                                       wire="mulaw"),
                "asr:wire_mulaw_mixed": dict(
                    cfg_json=cj, wavs=wavs[:6] + [wavs[6] / 32768.0]
                    + wavs[7:], bw=None, wire="mulaw"),
                "asr:second": dict(cfg_json=cj, wavs=lm_wavs, bw=2,
                                   lm_path=self.tri, lm_mode="second"),
                "asr:second_host": dict(cfg_json=cj, wavs=lm_wavs, bw=2,
                                        lm_path=self.tri,
                                        lm_mode="second_host"),
                "asr:first": dict(cfg_json=cj, wavs=lm_wavs, bw=2,
                                  lm_path=self.tri, lm_mode="first",
                                  lm_topn=6),
                "fused": dict(cfg_json=self.lm_cfg.to_json(),
                              params_np=self.lm_params, feats=self.lm_feats,
                              lens=self.lm_lens, arpa=self.lm_arpa,
                              vocab_words="abcdefgh" * 3, bw=2, topn=6),
                "golden": dict(cfg_json=golden.to_json(),
                               ckpt_path=os.path.join(GOLD, "model.ckpt"),
                               lm_path=os.path.join(GOLD, "lm.arpa"),
                               vocab_words=CHARS * 3,
                               files=golden_wav_paths()),
                "entries": dict(cfg_json=golden.to_json(),
                                ckpt_path=os.path.join(GOLD, "model.ckpt"),
                                vocab_words=CHARS * 3,
                                wav_path=golden_wav_paths()[0],
                                long_path=self.long_wav,
                                manifest=self.manifest,
                                lm_path=os.path.join(GOLD, "lm.arpa")),
                "errors": dict(cfg_json=self.cfg.with_(
                    "vocab", max_num_words=9).to_json(),
                    params_np=tlas.params_to_numpy(tlas.init_params(
                        self.cfg.with_("vocab", max_num_words=9), 0))),
            })
        return list(jobs.items())

    def run(self, shape):
        """Every rank's results on this mesh (one group, at first use)."""
        if shape not in self._runs:
            dp, mp = shape
            self._runs[shape] = launch.run_ranks(
                ranks.suite, dp * mp, args=(dp, mp, self.jobs(shape)),
                timeout_s=DEADLINE_S, threads=1)
        return self._runs[shape]

    def single(self, name, shape=(2, 2)):
        """The job on one device (``mesh=None``), in this process."""
        if name not in self._single:
            kw = dict(self.jobs(shape))[name]
            if name == "trainer":
                kw = dict(kw, save_dir=os.path.join(self.root, "ck_single"))
            self._single[name] = getattr(ranks, name.split(":")[0])(None,
                                                                   **kw)
        return self._single[name]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("mesh"))


def _jax_params(params_np):
    return jax.tree_util.tree_map(jnp.asarray, params_np)


def _assert_same_rows(got, want, exact, close=()):
    for k in exact:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in close:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SCORE)


def _assert_params(got, want):
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAMS)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shape(world, shape):
    dp, mp = shape
    for r, out in enumerate(world.run(shape)):
        info = out["mesh_info"]
        assert info["shape"] == shape and info["names"] == ("data", "model")
        assert info["backend"] == "gloo" and info["world"] == dp * mp
        assert info["rank"] == r


def _spec_leaves(tree, path=()):
    """(path, spec) of a ``param_pspecs`` tree (its leaves are tuples)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield "/".join(map(str, path)), tree


def test_param_pspecs_match_jax(world):
    """The layout: ``proj_w`` by columns, ``proj_b`` and ``embedding`` by
    rows over the model axis, every other leaf replicated, as JAX's
    ``param_pspecs`` gives it."""
    from chinese_asr_tpu_torch.parallel import sharding as tsharding

    got = dict(_spec_leaves(tsharding.param_pspecs(
        tlas.params_from_numpy(world.params), world.cfg)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jsharding.param_pspecs(_jax_params(world.params), _cfgs(jcfg)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}
    assert got == want
    assert {n for n, v in got.items() if v} == {
        "decoder/proj_w", "decoder/proj_b", "decoder/embedding"}


def test_serving_refuses_a_mesh():
    """Serving over a mesh is not ported: ``MicroBatcher`` refuses an
    ``ASR(mesh=)`` (here a 1x1 mesh in this process)."""
    import torch.distributed as dist

    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.serve import MicroBatcher

    try:
        asr = ASR(cfg=golden_cfg(tcfg), device="cpu", mesh="auto")
        with pytest.raises(ValueError, match="serving over a mesh"):
            MicroBatcher(asr)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shard_errors(world):
    """A vocab that does not divide the model axis (V = 13, mp = 2) and a
    batch that does not divide the data axis (B = 3, dp = 2) raise
    ``ValueError``, the latter with JAX's message."""
    for out in world.run((2, 2)):
        err = out["errors"]
        assert "vocab dim (13) does not divide the model axis (2)" \
            in err["vocab"]
        assert err["batch"].startswith(
            "batch size 3 does not divide the data axis (2)")
        assert "drop_last=True" in err["batch"]


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_greedy_matches_single_device_and_jax(world, shape):
    want = world.single("decode")["greedy"]
    for out in world.run(shape):
        _assert_same_rows(out["decode"]["greedy"], want,
                          ("tokens", "final_lens", "finished"),
                          ("scores",))
    dp, mp = shape
    cj = _cfgs(jcfg).with_("mesh", data_parallel=dp, model_parallel=mp)
    jmesh = jsharding.make_mesh(cj, devices=jax.devices()[:dp * mp])
    jp = _jax_params(world.params)
    run = jsharding.make_sharded_greedy(cj, jp, jmesh)
    jr = run(jsharding.shard_params(jp, cj, jmesh), jnp.asarray(world.feats),
             jnp.asarray(world.lens))
    got = world.run(shape)[0]["decode"]["greedy"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(jr.tokens))
    np.testing.assert_array_equal(got["final_lens"],
                                  np.asarray(jr.final_lens))


@pytest.fixture(scope="module")
def jax_beam(world):
    return jbeam.beam_decode_jit(_jax_params(world.params), _cfgs(jcfg), 2,
                                 jnp.asarray(world.feats),
                                 jnp.asarray(world.lens))


@pytest.mark.parametrize("shape", SHAPES)
def test_beam_matches_single_device_and_jax(world, jax_beam, shape):
    want = world.single("decode")
    for out in world.run(shape):
        got = out["decode"]
        _assert_same_rows(got["beam"], want["beam"],
                          ("live_tokens", "fin_count", "fin_tokens",
                           "fin_lens", "l_final"),
                          ("fin_scores", "live_scores"))
        _assert_same_rows(got["best"], want["best"],
                          ("tokens", "lens", "finished"), ("scores",))
    got = world.run(shape)[0]["decode"]["beam"]
    np.testing.assert_array_equal(got["live_tokens"],
                                  np.asarray(jax_beam.live_tokens))
    np.testing.assert_array_equal(got["fin_count"],
                                  np.asarray(jax_beam.fin_count))
    np.testing.assert_allclose(got["fin_scores"],
                               np.asarray(jax_beam.fin_scores), **SCORE)


def test_lm_fused_matches_single_device_and_jax(world):
    """The LM-driven first pass over replicated tables (bw 2, topn 6)."""
    want = world.single("fused")
    for out in world.run((2, 2)):
        _assert_same_rows(out["fused"], want,
                          ("fin_tokens", "live_tokens", "fin_count",
                           "l_final"), ("fin_scores", "live_scores"))
    vocab = JVocab.build(["abcdefgh" * 3], max_num_words=8)
    dlm = JDLM.from_arpa(world.lm_arpa)
    jr = jlmf.lm_fused_decode_jit(
        _jax_params(world.lm_params), _lm_cfg(jcfg), 2,
        jnp.asarray(world.lm_feats), jnp.asarray(world.lm_lens), dlm,
        jnp.asarray(dlm.token_id_table(vocab)), topn=6)
    got = world.run((2, 2))[0]["fused"]
    assert got["fin_count"].sum() > 0
    np.testing.assert_array_equal(got["fin_tokens"],
                                  np.asarray(jr.fin_tokens))
    np.testing.assert_array_equal(got["live_tokens"],
                                  np.asarray(jr.live_tokens))
    np.testing.assert_allclose(got["fin_scores"], np.asarray(jr.fin_scores),
                               **SCORE)


@pytest.mark.parametrize("mode", ["greedy", "greedy_chunked", "beam",
                                  "beam_chunked"])
def test_asr_pads_to_the_data_axis_and_chunks(world, mode):
    """9 wavs on dp = 2: one one-sample wav pads the call and its
    transcript is dropped; ``max_batch=5`` is clamped to 4, so the chunks
    equal the single device's at ``max_batch=4``."""
    name = f"asr:{mode}"
    want = world.single(name)["texts"]
    if mode.endswith("chunked"):
        kw = dict(dict(world.jobs((2, 2)))[name], max_batch=4)
        want = ranks.asr(None, **kw)["texts"]
    for out in world.run((2, 2)):
        assert len(out[name]["texts"]) == 9
        assert out[name]["texts"] == want


@pytest.mark.parametrize("wire", ["adpcm", "mulaw", "mulaw_mixed"])
def test_asr_lossy_wires_equal_one_device(world, wire):
    """A rank ships its rows over the wire the whole chunk takes on one
    device: over ADPCM, whose blocks span rows, it codes the whole chunk's
    buffer and featurizes its rows' span; a float wav in the chunk puts
    every rank on the float32 flat wire, also a rank whose own rows are
    int16.  The features of the 9 wavs (the mesh pads them with a tenth)
    and the transcripts equal one device's."""
    name = f"asr:wire_{wire}"
    want = world.single(name)
    for out in world.run((2, 2)):
        assert out[name]["texts"] == want["texts"]
        assert len(out[name]["feats"]) == len(want["feats"]) == 1
        np.testing.assert_allclose(out[name]["feats"][0][:9],
                                   want["feats"][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["second", "second_host", "first"])
def test_asr_lm_modes(world, mode):
    """The LM second pass, device and host, and the LM-driven first pass:
    5 wavs padded to 6, equal to the single device; device == host."""
    name = f"asr:{mode}"
    for out in world.run((2, 2)):
        assert out[name]["texts"] == world.single(name)["texts"]
        if mode == "second_host":
            assert out[name]["texts"] == out["asr:second"]["texts"]


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)["modes"]


@pytest.mark.parametrize("mode", ["greedy", "beam_bw4", "lm_second",
                                  "lm_second_host", "lm_first"])
def test_golden_shard_through_a_mesh(world, expected, mode):
    """V = 12 splits into 6 a model rank; 6 wavs into 3 a data rank."""
    for out in world.run((2, 2)):
        assert out["golden"][mode] == expected[mode]


@pytest.mark.parametrize("entry", ["bytes", "long", "eval_greedy",
                                   "eval_beam", "eval_lm_second",
                                   "eval_lm_first"])
def test_entry_points_on_a_mesh(world, entry):
    """``transcribe_bytes`` and ``transcribe_long`` (over
    ``transcribe_wavs``) and ``evaluate_manifest`` (7 utterances, a batch
    padded to the data axis) on the golden model over (2,2), equal to one
    device."""
    want = world.single("entries")[entry]
    for out in world.run((2, 2)):
        assert out["entries"][entry] == want
    if entry == "eval_beam":
        assert want[1] == 7 and want[0] == 0.0     # the overfit model


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's first train step on the first batch, single device."""
    cj = _cfgs(jcfg)
    jp = _jax_params(world.params)
    tx = joptim.make_optimizer(cj.train, jp)
    p, _, m = jax.jit(lambda p, o, b: jstep.train_step(p, o, cj, tx, b))(
        jp, tx.init(jp), jstep.Batch(*map(jnp.asarray, world.batches[0])))
    return m, jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_f32(world, jax_step, shape):
    """Two ADAM steps on ragged batches with the clip acting: the loss (the
    global batch's), the clip's global norm and the params equal the
    single device's; the first step equals JAX's."""
    want = world.single("train")
    for out in world.run(shape):
        got = out["train"]
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)
            assert g["grad_norm"] > 0.1                  # the clip acts
            assert g["num_tokens"] == w["num_tokens"]
            np.testing.assert_allclose(g["accuracy"], w["accuracy"],
                                       rtol=1e-6)
        _assert_params(got["params"], want["params"])
    jm, _ = jax_step
    got = world.run(shape)[0]["train"]["metrics"][0]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)


def test_train_step_f32_params_match_jax(world, jax_step):
    """One step's params on (2,2) against JAX's, on every rank."""
    _, jp = jax_step
    flat_j = {"/".join(map(str, k)): v for k, v in tlas.tree_paths(jp)}
    for out in world.run((2, 2)):
        _assert_params(out["train:one"]["params"], flat_j)


def test_train_step_bf16(world, jax_step):
    """Mixed precision on (2,2): the loss within bf16's bound (rtol 1e-2)
    of the single device's bf16 step and of JAX's step (f32 here: XLA:CPU
    compiles bf16 slowly, and tests/test_torch_port_train_bf16.py holds the
    port's bf16 step against JAX's), the master params float32."""
    want = world.single("train:bf16")
    jm, _ = jax_step
    for out in world.run((2, 2)):
        got = out["train:bf16"]
        loss = got["metrics"][0]["loss"]
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, want["metrics"][0]["loss"],
                                   rtol=1e-2)
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-2)
        assert got["dtypes"] == ["torch.float32"]


def test_scheduled_sampling_draws_the_global_coins(world):
    """ss = 0.5: every rank draws the global [S, B] coins from the seeded
    generator and keeps its columns, so two steps equal the single
    device's (and differ from teacher forcing)."""
    want = world.single("train:ss")
    for out in world.run((2, 2)):
        got = out["train:ss"]
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        _assert_params(got["params"], want["params"])
    assert abs(want["metrics"][1]["loss"]
               - world.single("train")["metrics"][1]["loss"]) > 1e-4


def test_batchnorm_statistics_on_a_mesh(world):
    """A CNN1D encoder (BatchNorm) on (2,1): two SGD steps, each data shard
    half the batch; the normalisation and the running statistics take the
    global batch's mean and variance (unbiased with the global n), equal
    to the single device's."""
    want = world.single("train:bn", shape=(2, 1))
    for out in world.run((2, 1)):
        got = out["train:bn"]
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        _assert_params(got["params"], want["params"])
        stats = [n for n in want["params"] if n.endswith(("bn_mean",
                                                          "bn_var"))]
        assert stats
        for n in stats:
            np.testing.assert_allclose(got["params"][n], want["params"][n],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
            assert not np.allclose(want["params"][n],
                                   0.0 if n.endswith("mean") else 1.0)


def test_trainer_on_a_mesh(world):
    """``Trainer(mesh=)``: three steps, an eval of 5 rows (padded to 6),
    a checkpoint by rank 0; the loss, the CER and the params equal the
    single-device trainer's."""
    want = world.single("trainer")
    for out in world.run((2, 2)):
        got = out["trainer"]
        assert got["step"] == want["step"] == 3
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["best_wer"] == want["best_wer"]
        _assert_params(got["params"], want["params"])


def test_mesh_checkpoint_loads_on_one_device(world):
    """Rank 0's checkpoint holds the whole model in the single-device
    format: its params equal the mesh's gathered params, it loads in a
    single-device ``ASR`` and transcribes as the single-device trainer's
    checkpoint does."""
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

    got = world.run((2, 2))[0]["trainer"]
    payload = load_checkpoint(got["ckpt"])
    flat = {"/".join(map(str, k)): np.asarray(v)
            for k, v in tlas.tree_paths(payload["params"])}
    for n, v in got["params"].items():
        np.testing.assert_array_equal(flat[n], v, err_msg=n)
    assert payload["opt_state"]["mu/decoder/proj_w"].shape \
        == flat["decoder/proj_w"].shape
    wavs = _int16_wavs(3, (1600, 900, 1300))
    texts = [ASR(ckpt_path=p, cfg=world.cfg, bw=2, wav_bucket=800,
                 device="cpu").transcribe_wavs(wavs)
             for p in (got["ckpt"], world.single("trainer")["ckpt"])]
    assert texts[0] == texts[1]


# --------------------------------------------------------------------------
# the CLI under torchrun, and the dry run
# --------------------------------------------------------------------------
def test_train_cli_mesh_auto_under_torchrun(tmp_path):
    """``--mesh auto`` on 2 CPU ranks through ``torch.distributed.run`` for
    2 steps (drop_last loader): rank 0 reports the single-device CLI's
    loss and writes the checkpoint."""
    from test_torch_port_trainer import _write_cli_corpus

    man, cfg_json = _write_cli_corpus(tmp_path, n=6)
    args = ["--train-manifest", man, "--config", cfg_json, "--batch-size",
            "2", "--epochs", "1", "--max-steps", "2", "--seed", "0",
            "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    runs = {}
    for name, pre, extra in (
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2"],
             ["--mesh", "auto"]),
            ("single", [sys.executable], [])):
        save = str(tmp_path / name)
        r = subprocess.run(pre + ["-m", "chinese_asr_tpu_torch.train"] + args
                           + extra + ["--save-dir", save], env=env, cwd=root,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-3000:]
        done = [ln for ln in r.stderr.splitlines() if ln.startswith("done:")]
        assert len(done) == 1, r.stderr[-3000:]           # rank 0's line
        assert any(c.startswith("step-2_wer-") for c in os.listdir(save))
        runs[name] = done
    assert runs["mesh"] == runs["single"], runs


def test_train_cli_loaders_use_the_trainers_device(tmp_path, monkeypatch):
    """On a mesh the ``Trainer`` places the params on the rank's card,
    ``cuda:{local_rank % device_count}``; the CLI's train and eval
    loaders upload to that device, not to the one ``--device`` names."""
    import types

    import torch

    from chinese_asr_tpu_torch.data import dataset
    from chinese_asr_tpu_torch.train import __main__ as cli
    from chinese_asr_tpu_torch.train import trainer as trainer_mod
    from test_torch_port_trainer import _write_cli_corpus

    rank_dev = torch.device("meta")     # stands for another rank's card
    seen = []

    class RankTrainer:
        def __init__(self, cfg, params, vocab, device=None, mesh=None):
            self.device, self.mesh, self.rank = rank_dev, None, 0

        def fit(self, train_loader_fn, eval_loader_fn, max_steps=None):
            train_loader_fn(), eval_loader_fn()
            return types.SimpleNamespace(step=0, loss=0.0, best_wer=1.0)

    monkeypatch.setattr(trainer_mod, "Trainer", RankTrainer)
    monkeypatch.setattr(dataset, "batches_to_device",
                        lambda loader, cfg, device: seen.append(device))
    man, cfg_json = _write_cli_corpus(tmp_path, n=2)
    assert cli.main(["--train-manifest", man, "--eval-manifest", man,
                     "--config", cfg_json, "--device", "cpu"]) == 0
    assert seen == [rank_dev, rank_dev]


@pytest.mark.parametrize("entry", ["function", "cli"])
def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                          entry):
    """Like every entry point of the port, the dry run defaults to the
    card and raises without one; ``device_type="cpu"`` / ``--device cpu``
    asks for the CPU."""
    import torch

    from chinese_asr_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        if entry == "function":
            dryrun.dryrun_multichip(2, timeout_s=60)
        else:
            dryrun.main(["--ranks", "2"])


def test_dryrun_multichip():
    """The port's ``dryrun_multichip`` on 4 CPU ranks (a 2 x 2 mesh)."""
    from chinese_asr_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, "cpu", timeout_s=DEADLINE_S)
    assert line.startswith("dryrun_multichip ok: mesh=(2x2)")
    assert "beam_decode ok (bw=2, 153 finished hyps" in line


def test_a_failing_rank_fails_the_group():
    """A rank's exception reaches the caller with its traceback, and the
    ranks waiting on it in a collective are killed."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch.run_ranks(ranks.fail_on_rank_1, 2, timeout_s=60)
