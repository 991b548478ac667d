"""PyTorch port, the trainer: ``Trainer.fit`` with eval, checkpoint and
resume on the corpus of tests/test_trainer.py, the train CLI on the CPU,
``chinese_asr_tpu.v1`` checkpoints across both packages (a JAX trainer
checkpoint read with jax, jaxlib and optax blocked), the observability
helpers and the batched edit distance.

Checkpoints are compared exactly: params round-trip as float32 numpy
arrays, and transcripts of the golden model are string-equal.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.api import ASR as JASR
from chinese_asr_tpu.data import audio_io
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.ops.edit_distance_jax import \
    batched_edit_distance as j_edit
from chinese_asr_tpu.ops.metrics import edit_distance
from chinese_asr_tpu.train.trainer import Trainer as JTrainer
from chinese_asr_tpu.utils import checkpoint as jck
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.api import ASR as TASR
from chinese_asr_tpu_torch.data import dataset
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops.edit_distance import (batched_cer,
                                                     batched_edit_distance)
from chinese_asr_tpu_torch.train.trainer import Trainer
from chinese_asr_tpu_torch.utils import checkpoint as tck
from chinese_asr_tpu_torch.utils.observe import (EMA, Duration,
                                                 MetricsLogger,
                                                 alignment_to_image,
                                                 batch_alignment_images,
                                                 rand_disp_list)
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, N, golden_cfg, golden_wav_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(tmp_path, config_module=tcfg):
    """tests/test_trainer.py's small config."""
    return (config_module.Config()
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=6)
            .with_("train", batch_size=2, eval_batch_size=2, epochs=5,
                   num_eval_steps=4, base_lr=1e-3,
                   save_dir=str(tmp_path / "ckpt")))


@pytest.fixture()
def corpus(tmp_path):
    """tests/test_trainer.py:33-45."""
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
    return mpath, Vocab.build(texts, max_num_words=8)


def _loaders(mpath, cfg, vocab):
    def train_loader():
        return dataset.batches_to_device(
            dataset.make_train_loader(mpath, cfg, vocab), cfg, "cpu")

    def eval_loader():
        return dataset.batches_to_device(
            dataset.make_eval_loader(mpath, cfg, vocab), cfg, "cpu")

    return train_loader, eval_loader


def _golden():
    cfg = golden_cfg(tcfg)
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    return cfg, vocab


def _jvocab():
    return JVocab.build([CHARS * 3], max_num_words=8)


def _golden_params_numpy():
    return tck.load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]


# --------------------------------------------------------------------------
# Trainer.fit
# --------------------------------------------------------------------------
def test_fit_eval_checkpoint_resume(tmp_path, corpus):
    mpath, vocab = corpus
    cfg = small(tmp_path)
    assert len(vocab) == cfg.vocab.vocab_size
    tr = Trainer(cfg, tlas.init_params(cfg, 0), vocab, device="cpu")
    train_loader, eval_loader = _loaders(mpath, cfg, vocab)
    tv = tr.fit(train_loader, eval_loader, max_steps=8)
    assert tv.step == 8 and np.isfinite(tv.loss) and np.isfinite(tv.best_wer)
    cks = glob.glob(os.path.join(cfg.train.save_dir, "step-*_wer-*.ckpt"))
    assert len(cks) == 2                   # at step 4 and at max_steps
    log = open(os.path.join(cfg.train.save_dir, "metrics.jsonl")).read()
    assert "train/loss" in log and "eval/wer" in log \
        and "eval/alignment0" in log and "eval/sample" in log

    tr2 = Trainer(cfg, tlas.init_params(cfg, 1), vocab, device="cpu")
    assert tr2.resume()
    assert tr2.tv == tr.tv
    for a, b in zip(tlas.tree_leaves(tr.params), tlas.tree_leaves(tr2.params)):
        assert torch.equal(a, b)
    assert tr2.opt_state.keys() == tr.opt_state.keys()
    for k in tr.opt_state:
        assert torch.equal(tr.opt_state[k], tr2.opt_state[k]), k
    # and it trains on from there
    tv2 = tr2.fit(train_loader, None, max_steps=10)
    assert tv2.step == 10 and np.isfinite(tv2.loss)


def test_loss_decreases_overfit(tmp_path, corpus):
    mpath, vocab = corpus
    cfg = small(tmp_path).with_("train", base_lr=5e-3, num_eval_steps=-1,
                                epochs=10, save_dir=str(tmp_path / "ck2"))
    tr = Trainer(cfg, tlas.init_params(cfg, 0), vocab, device="cpu")
    _, eval_loader = _loaders(mpath, cfg, vocab)     # fixed order
    losses = []
    orig = tr._step_fn

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        losses.append(float(out[2]["loss"]))
        return out

    tr._step_fn = wrapped
    tr.fit(eval_loader, None, max_steps=20)
    assert len(losses) == 20 and losses[-1] < 0.7 * losses[0], losses


def test_trainer_raises_for_later_slices_and_without_a_gpu(tmp_path,
                                                          monkeypatch):
    cfg = small(tmp_path)
    # bf16 training builds on the CPU with float32 masters and optimizer
    # state (the forward and backward cast inside loss_fn)
    tr = Trainer(cfg.with_("train", compute_dtype="bfloat16"),
                 tlas.init_params(cfg, 0), device="cpu")
    assert all(t.dtype == torch.float32 for t in tlas.tree_leaves(tr.params))
    assert all(v.dtype == torch.float32 for v in tr.opt_state.values()
               if v.is_floating_point())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tlas.init_params(cfg, 0))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def _write_cli_corpus(tmp_path, n=6):
    """tests/test_train_cli.py's corpus."""
    rng = np.random.RandomState(0)
    utts = []
    texts = ["你好", "好的", "你说", "说好", "的你", "好好"]
    for i in range(n):
        p = str(tmp_path / f"c{i}.wav")
        audio_io.write_wav(p, (0.1 * rng.randn(8000)).astype(np.float32))
        utts.append(dataset.Utterance(p, texts[i % len(texts)]))
    man = str(tmp_path / "train.tsv")
    dataset.write_manifest(man, utts)
    cfg_json = str(tmp_path / "cfg.json")
    with open(cfg_json, "w") as f:
        f.write(tcfg.Config()
                .with_("encoder", hidden_size=16, num_layers=1)
                .with_("decoder", hidden_size=32, embed_dim=12)
                .with_("attention", attn_size=8).to_json())
    return man, cfg_json


def test_train_cli_end_to_end_and_resume(tmp_path, capsys):
    from chinese_asr_tpu_torch.train.__main__ import main

    man, cfg_json = _write_cli_corpus(tmp_path)
    save = str(tmp_path / "ckpt")
    args = ["--train-manifest", man, "--eval-manifest", man, "--config",
            cfg_json, "--batch-size", "3", "--epochs", "1", "--max-steps",
            "2", "--save-dir", save, "--remat", "--seed", "0", "--device",
            "cpu"]
    assert main(args) == 0
    cks = sorted(os.listdir(save))
    assert [c for c in cks if c.startswith("step-2_wer-")], cks
    assert "done: step 2" in capsys.readouterr().err
    args[args.index("--max-steps") + 1] = "3"
    args[args.index("--epochs") + 1] = "2"
    assert main(args + ["--resume"]) == 0
    assert "done: step 3" in capsys.readouterr().err
    # --bf16 trains on the CPU and writes a float32 checkpoint that ASR
    # loads; --mesh auto (a 1x1 mesh in one process) trains
    bf_save = str(tmp_path / "ckpt_bf16")
    args[args.index("--save-dir") + 1] = bf_save
    assert main(args + ["--bf16"]) == 0
    assert "done: step 3" in capsys.readouterr().err
    [ck] = [os.path.join(bf_save, c) for c in os.listdir(bf_save)
            if c.startswith("step-3_wer-")]
    payload = tck.load_checkpoint(ck)
    assert tcfg.Config.from_json(payload["config_json"]).train \
        .compute_dtype == "bfloat16"
    assert all(np.asarray(a).dtype == np.float32
               for a in tlas.tree_leaves(payload["params"]))
    asr = TASR(ckpt_path=ck, cfg=tcfg.Config.from_json(payload["config_json"]),
               bw=2, device="cpu")
    texts = asr.transcribe_wavs([audio_io.read_wav(
        os.path.join(tmp_path, "c0.wav"))[0]])
    assert len(texts) == 1 and isinstance(texts[0], str)
    assert main(args + ["--mesh=auto"]) == 0
    assert "done: step" in capsys.readouterr().err


def test_train_cli_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    from chinese_asr_tpu_torch.train.__main__ import main

    man, cfg_json = _write_cli_corpus(tmp_path, n=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--train-manifest", man, "--config", cfg_json,
              "--max-steps", "1", "--save-dir", str(tmp_path / "ck")])


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------
def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    """The golden model, one port train step later, written by the port's
    Trainer: the JAX package's load_checkpoint reads it (no torch class in
    the pickle), and both packages' ASR transcribe the golden shard alike
    from it, greedy and beam."""
    cfg, vocab = _golden()
    cfg = cfg.with_("train", save_dir=str(tmp_path / "ck"), base_lr=1e-4)
    tr = Trainer(cfg, tlas.params_from_numpy(_golden_params_numpy()), vocab,
                 device="cpu")
    wavs = [audio_io.read_wav(p, 16000)[0] for p in golden_wav_paths()[:4]]
    mat, lens = np.zeros((4, max(map(len, wavs))), np.float32), []
    for i, w in enumerate(wavs):
        mat[i, :len(w)] = w
        lens.append(len(w))
    from chinese_asr_tpu_torch.audio import features
    feats, flens = features.featurize_batch(T_(mat), T_(np.array(lens)),
                                            cfg.audio)
    ids = [vocab.encode(t) for t in ("的一是", "不了", "人我在", "的的")]
    S = 4
    ti = np.zeros((4, S), np.int32)
    to = np.zeros((4, S), np.int32)
    tl = np.zeros(4, np.int32)
    for i, t in enumerate(ids):
        ti[i, 0], ti[i, 1:1 + len(t)] = cfg.vocab.sos, t
        to[i, :len(t)], to[i, len(t)] = t, cfg.vocab.eos
        tl[i] = len(t) + 1
    batch = dataset.Batch(feats, flens, T_(ti), T_(to), T_(tl))
    tr.params, tr.opt_state, _ = tr._step_fn(tr.params, tr.opt_state, batch,
                                             None)
    tr.tv.step, tr.tv.loss = 1, 0.5
    path = tr._eval_and_checkpoint(None)
    assert os.path.basename(path) == "step-1_wer-0.50000.ckpt"

    payload = jck.load_checkpoint(path)
    assert payload["train_var"].step == 1
    for a, b in zip(jax.tree_util.tree_leaves(payload["params"]),
                    tlas.tree_leaves(tr.params)):
        assert a.dtype == np.float32 and np.array_equal(a, N(b))
    assert [n for n, _, _ in tck.view_ckpt(path)] == \
        [n for n, _, _ in jck.view_ckpt(path)]
    jcfg_ = golden_cfg(jcfg)
    for bw in (None, 4):
        want = JASR(ckpt_path=path, cfg=jcfg_, vocab=_jvocab(), bw=bw
                    ).transcribe_files(golden_wav_paths())
        got = TASR(ckpt_path=path, cfg=cfg, vocab=vocab, bw=bw, device="cpu"
                   ).transcribe_files(golden_wav_paths())
        assert got == want and any(want)


def T_(a):
    return torch.tensor(np.asarray(a))


def _jax_trainer_checkpoint(tmp_path):
    """The golden model saved by the JAX Trainer (its optax state and
    TrainVar included)."""
    cfg = golden_cfg(jcfg).with_("train", save_dir=str(tmp_path / "jck"))
    params = jax.tree_util.tree_map(jnp.asarray, _golden_params_numpy())
    tr = JTrainer(cfg, params, _jvocab())
    tr.tv.step, tr.tv.loss = 3, 0.25
    tr._eval_and_checkpoint(None)
    return tr.ckpt.latest_checkpoint(), tr


_BLOCKED_LOAD = r"""
import json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
from chinese_asr_tpu_torch.api import ASR
from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint
sys.path.insert(0, "tests")
from torch_port_util import CHARS, golden_cfg, golden_wav_paths
from chinese_asr_tpu_torch import config
from chinese_asr_tpu_torch.vocab import Vocab
payload = load_checkpoint(sys.argv[1])
asr = ASR(ckpt_path=sys.argv[1], cfg=golden_cfg(config),
          vocab=Vocab.build([CHARS * 3], max_num_words=8), device="cpu")
print(json.dumps({"train_var": payload["train_var"],
                  "opt_state": type(payload["opt_state"]).__name__,
                  "texts": asr.transcribe_files(golden_wav_paths())}))
"""


def test_jax_trainer_checkpoint_loads_without_optax(tmp_path):
    """A checkpoint of the JAX Trainer pickles optax classes in its
    opt_state.  With jax, jaxlib and optax blocked, the port reads it and
    ASR transcribes with it as the JAX package does."""
    path, _ = _jax_trainer_checkpoint(tmp_path)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, path],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["train_var"]["step"] == 3
    assert got["opt_state"].startswith("Inject")      # optax classes
    want = JASR(ckpt_path=path, cfg=golden_cfg(jcfg), vocab=_jvocab()
                ).transcribe_files(golden_wav_paths())
    assert got["texts"] == want
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        assert want == json.load(f)["modes"]["greedy"]


def test_jax_trainer_checkpoint_resumes_in_the_port(tmp_path, capsys):
    path, jtr = _jax_trainer_checkpoint(tmp_path)
    cfg, vocab = _golden()
    tr = Trainer(cfg.with_("train", save_dir=str(tmp_path / "ck")),
                 tlas.init_params(cfg, 5), vocab, device="cpu")
    assert tr.resume(path)
    assert "optimizer state starts fresh" in capsys.readouterr().err
    assert tr.tv.step == 3 and tr.tv.lr == jtr.tv.lr
    for a, b in zip(tlas.tree_leaves(tr.params),
                    jax.tree_util.tree_leaves(jtr.params)):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    fresh = tr.tx.init(tr.params)
    assert all(torch.equal(tr.opt_state[k], fresh[k]) for k in fresh)


def test_torch_state_export_matches_jax(tmp_path):
    cfg, _ = _golden()
    pn = _golden_params_numpy()
    pt = tlas.params_from_numpy(pn)
    enc_t, dec_t = tlas.params_to_torch_state(pt, cfg)
    enc_j, dec_j = jlas.params_to_torch_state(
        jax.tree_util.tree_map(jnp.asarray, pn), golden_cfg(jcfg))
    for a, b in ((enc_t, enc_j), (dec_t, dec_j)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    path = tlas.save_torch_checkpoint(str(tmp_path / "ref.ckpt"), pt, cfg)
    back = tlas.load_torch_checkpoint(path, cfg)
    for a, b in zip(tlas.tree_leaves(pt), tlas.tree_leaves(back)):
        assert torch.equal(a, b)
    assert tlas.count_params(pt) == jlas.count_params(pn)


def test_checkpoint_manager_best_latest_and_keep(tmp_path):
    m = tck.CheckpointManager(str(tmp_path), keep=1)
    params = {"w": np.zeros(2, np.float32)}
    m.save(100, 0.5, params)
    m.save(200, 0.3, params)
    m.save(300, 0.4, params)
    assert m.latest_checkpoint().endswith("step-300_wer-0.40000.ckpt")
    assert m.best_checkpoint().endswith("step-200_wer-0.30000.ckpt")
    assert sorted(os.listdir(tmp_path)) == ["step-200_wer-0.30000.ckpt",
                                            "step-300_wer-0.40000.ckpt"]
    assert tck.view_ckpt(m.best_checkpoint()) == [("['w']", (2,),
                                                   "float32")]


# --------------------------------------------------------------------------
# observability (tests/test_trainer.py) and the edit distance
# (tests/test_edit_distance_jax.py)
# --------------------------------------------------------------------------
def test_duration_and_ema():
    d = Duration()
    with d:
        pass
    assert d.seconds >= 0 and ":" in str(d)
    e = EMA(0.5)
    assert e.update(2.0) == 2.0
    assert e.update(4.0) == pytest.approx(3.0)


def test_metrics_logger_alignment_images_and_profiler(tmp_path):
    m = MetricsLogger(str(tmp_path))
    m.scalar("a", 1.5, 1)
    m.text("b", "hello", 2)
    m.image("c", np.zeros((3, 4), np.uint8), 3)
    m.close()
    assert len(open(m.path).read().strip().split("\n")) == 3
    assert os.path.exists(os.path.join(str(tmp_path), "images", "c-3.npy"))
    a = np.random.RandomState(0).rand(6, 9).astype(np.float32)
    img = alignment_to_image(a, feat_len=7, text_len=4)
    assert img.shape == (4, 7) and img.dtype == np.uint8 and img.max() == 255
    assert len(batch_alignment_images(a[None], [7], [4])) == 1
    disp = rand_disp_list(["x", "y"], ["p", "q"], n=2)
    assert len(disp) == 2 and "pred" in disp[0]


def _pack(seqs, width):
    out = np.zeros((len(seqs), width), np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


def test_edit_distance_matches_host_and_jax():
    rng = np.random.RandomState(0)
    for trial in range(5):
        B = 8
        preds = [list(rng.randint(4, 20, size=rng.randint(0, 12)))
                 for _ in range(B)]
        refs = [list(rng.randint(4, 20, size=rng.randint(1, 12)))
                for _ in range(B)]
        p, pl = _pack(preds, max(1, max(len(x) for x in preds)))
        r, rl = _pack(refs, max(len(x) for x in refs))
        got = N(batched_edit_distance(*map(T_, (p, pl, r, rl))))
        want = np.asarray(j_edit(*map(jnp.asarray, (p, pl, r, rl))))
        np.testing.assert_array_equal(got, want)
        for b in range(B):
            assert got[b] == edit_distance("".join(map(chr, preds[b])),
                                           "".join(map(chr, refs[b])))


def test_edit_distance_known_values():
    p, pl = _pack([[1, 2, 3], [1, 2, 3], []], 3)
    r, rl = _pack([[1, 2, 3], [1, 4, 3], [5, 6]], 3)
    args = tuple(map(T_, (p, pl, r, rl)))
    np.testing.assert_array_equal(N(batched_edit_distance(*args)), [0, 1, 2])
    np.testing.assert_allclose(N(batched_cer(*args)), [0.0, 1 / 3, 1.0])


def test_train_modules_import_no_jax():
    code = ("import sys, chinese_asr_tpu_torch.train.__main__, "
            "chinese_asr_tpu_torch.train.trainer, "
            "chinese_asr_tpu_torch.ops.edit_distance, "
            "chinese_asr_tpu_torch.utils.observe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'chinese_asr_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
