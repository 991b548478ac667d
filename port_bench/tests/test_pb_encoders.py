"""The encoder family seam (``port_bench/encoders``): the flagship's
weights as they were drawn before the seam, the reference's front end
against the program's for every layout of its flags, the stop on a
family with no module, and a configuration with another encoder added
in new files alone, in a copy of the benchmark."""

import argparse
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from port_bench import encoders, run
from port_bench.lib import common, faults, offline, traffic, weights
from port_bench.reference import las as ref
from port_bench.roofline import common as rc
from port_bench.roofline import shapes
from port_bench.tests.conftest import TINY_SEED, tiny_config, tiny_mix

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _digest(tree):
    out = []
    for path, t in sorted(ref.leaves(tree).items()):
        a = t.numpy().astype(np.float64)
        out.append([path, list(t.shape), float(a.sum()), float((a * a).sum())])
    return out


@pytest.mark.parametrize("name", ["las_blstm_f32", "las_blstm_bf16"])
@pytest.mark.parametrize("width", ["full", "tiny"])
def test_the_flagships_weights_are_drawn_as_before(name, width):
    """Every leaf's path, shape, sum and sum of squares as the draw
    before the family seam made them (``fixtures/params_digest.json``)."""
    with open(os.path.join(FIXTURES, "params_digest.json")) as f:
        want = json.load(f)["digest"][name][width]
    cfg = common.load("configs", name)
    if width == "tiny":
        cfg = tiny_config(cfg)
    got = _digest(weights.make_params(cfg, TINY_SEED, "cpu"))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert g[2:] == pytest.approx(w[2:], rel=1e-12, abs=1e-12), g[0]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("downsample", [True, False])
@pytest.mark.parametrize("delta_delta", [True, False])
def test_reference_features_follow_the_programs_flags(delta_delta,
                                                      downsample, normalize):
    """``reference.las.features`` against the program's featurizer with
    the front end's flags set each way: the same frames and layout.  The
    two transforms differ by float32 rounding, which the log raises to
    3e-4 at the most on raw log-mels up to 17; a frame or channel out of
    place differs by O(1)."""
    from chinese_asr_tpu_torch.audio.features import featurize_batch
    cfg = common.load("configs", "las_blstm_f32")
    cfg["audio"].update(delta_delta=delta_delta, downsample=downsample,
                        normalize=normalize)
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    wavs, _ = traffic.corpus(mix, TINY_SEED, "cpu")
    batch = np.zeros((len(wavs), max(len(w) for w in wavs)), np.int16)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    feats, lens = featurize_batch(
        torch.from_numpy(batch), torch.tensor([len(w) for w in wavs]),
        offline.port_config(cfg).audio, norm_eps=1e-6)
    assert feats.shape[2] == shapes.feature_width(cfg["audio"])
    for i, w in enumerate(wavs):
        r = ref.features(w, cfg["audio"], ref.Precision(), "cpu")
        assert r.shape[0] == int(lens[i]) == shapes.encoder_frames(
            len(w), cfg["audio"])
        torch.testing.assert_close(r, feats[i, :r.shape[0]], atol=1e-3,
                                   rtol=0)


def test_a_family_without_a_module_stops_before_set_up():
    cfg = common.load("configs", "las_blstm_f32")
    cfg["encoder"]["encoder_type"] = "NO_SUCH_FAMILY"
    want = os.path.join("port_bench", "encoders", "no_such_family.py")
    with pytest.raises(SystemExit, match=want):
        encoders.of(cfg)
    cell = common.load("workloads", "las_blstm_f32.offline_aishell_b128")
    mix = common.load("traffic", cell["traffic"])
    with pytest.raises(SystemExit, match=want):
        offline.Driver(cell, cfg, mix, TINY_SEED, device="cpu")


@pytest.mark.parametrize("init", [1, "one", ("forget",), ("bias", 4), None])
def test_an_init_of_no_known_form_is_refused(init, monkeypatch):
    """A family's ``init`` that is not a float std, "zeros", "ones" or
    ("forget", H) stops the draw, naming the tensor, where it would
    otherwise be drawn as zeros."""
    cfg = tiny_config(common.load("configs", "las_blstm_f32"))
    family = encoders.of(cfg)
    layout = list(family.layout(cfg))
    path, shape, _ = layout[0]
    layout[0] = (path, shape, init)
    monkeypatch.setattr(family, "layout", lambda c: layout)
    with pytest.raises(ValueError, match=re.escape(repr(path))):
        weights.make_params(cfg, TINY_SEED, "cpu")


# ---- a configuration with another encoder, in new files alone -----------
CONFIG = "las_cnn1d_f32"
CELL = CONFIG + ".offline_aishell_b128"


@pytest.fixture
def added(tmp_path, monkeypatch, tiny):
    """A copy of the benchmark to which a CNN1D configuration is added as
    a change that adds a configuration may add it: new files (the family
    module, the configuration, the workload), entries appended to
    ``BENCHMARK.json``, and the cell's name appended to the lists of the
    metrics it reports.  The harness then finds everything by name in
    the copy."""
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(common.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), root)
    shutil.copy(os.path.join(FIXTURES, "cnn1d.py"),
                bench / "encoders" / "cnn1d.py")
    with open(bench / "configs" / "las_blstm_f32.json") as f:
        cfg = json.load(f)
    cfg["encoder"] = {"encoder_type": "CNN1D", "hidden_size": 512,
                      "num_layers": 5, "residual": True,
                      "bidirectional": True, "skip_step": 0, "norm": "BN",
                      "ks": 3, "stride": [2, 2, 2, 1, 1], "act": "RELU"}
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    with open(bench / "workloads"
              / "las_blstm_f32.offline_aishell_b128.json") as f:
        cell = dict(json.load(f), config=CONFIG)
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    with open(root / "BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": CONFIG, "source": cfg["source"],
                         "file": f"port_bench/configs/{CONFIG}.json",
                         "reduced": [], "why": "another encoder family"})
    b["workloads"].append({"name": CELL, "config": CONFIG,
                           "traffic": cell["traffic"], "chips": 1,
                           "why": cell["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("audio_s_per_s", "mfu.offline"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(common, "BENCH", str(bench))
    monkeypatch.setattr(common, "ROOT", str(root))
    return bench


def _run():
    args = argparse.Namespace(workload=CELL, seed=TINY_SEED, seconds=0.5,
                              trace=0)
    return run.run_cell(args, device="cpu")


def test_a_new_family_runs_from_new_files_alone(added):
    family = encoders.load("CNN1D")
    assert family.__file__ == str(added / "encoders" / "cnn1d.py")
    result, checks = _run()
    assert result["correct"], checks
    assert {"audio_s_per_s", "setup_s"} <= set(result["metrics"])
    with faults.FAULTS["answer_altered"]():
        result, checks = _run()
    assert not result["correct"], checks


def test_mfu_counts_the_new_familys_flops(added):
    """``mfu.offline`` on a hand-built record: the family's FLOPs and
    output frames, and the shared decoder's products, by hand."""
    cfg = common.load("configs", CONFIG)
    family = encoders.of(cfg)
    lens = [16000, 24000, 40000]
    steps, window_s = 40, 0.5
    rec = {"kind": "offline", "cfg": cfg,
           "kernels": {"K3": {"names": ["topk_k3"]}},
           "trace": {"work": [{"lens": lens, "N": 40000}],
                     "kernels": {"topk_k3_kernel": [0.01, steps]},
                     "window_s": window_s}}
    es, Hd = cfg["encoder"]["hidden_size"], cfg["decoder"]["hidden_size"]
    E, A = cfg["decoder"]["embed_dim"], cfg["attention"]["attn_size"]
    V, k = cfg["vocab"]["max_num_words"] + 4, cfg["beam_width"]
    want = 0.0
    for n in lens:
        F = shapes.encoder_frames(n, cfg["audio"])
        L = family.frames(F, cfg)
        step = (2 * (E + es) * 4 * Hd + 2 * Hd * 4 * Hd + 2 * Hd * A
                + 2 * L * A + 2 * L * es + 2 * (Hd + es) * V)
        want += family.flops(cfg, F) + 2 * L * es * A + k * steps * step
    peak = rc.peaks()["flops_per_s"]["float32"]
    assert common.reader("mfu.offline")(rec) == pytest.approx(
        100.0 * want / (window_s * peak), rel=1e-12)
