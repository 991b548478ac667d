"""The plain reference against the port on the CPU at tiny widths: the
port's served hypotheses score as the reference scores them, the
reference's beam search finds the port's hypotheses, and three training
steps agree."""

import copy

import pytest
import torch

from port_bench.lib import common, offline, train, weights
from port_bench.reference import las as ref
from port_bench.tests.conftest import TINY_SEED, tiny_config, tiny_mix

OFFLINE = "las_blstm_f32.offline_aishell_b128"
TRAIN = "las_blstm_f32.train_aishell_b256"


def _offline(precision="float32"):
    cell = copy.deepcopy(common.load("workloads", OFFLINE))
    cell["check"]["sample"] = 4
    cfg = tiny_config(common.load("configs", "las_blstm_f32"))
    cfg["precision"] = precision
    mix = tiny_mix(common.load("traffic", "aishell_offline_b128"))
    d = offline.Driver(cell, cfg, mix, TINY_SEED, device="cpu")
    d.setup()
    d.window(0.01)
    return d, cell, cfg, mix


def test_served_hypotheses_score_as_the_reference_scores_them():
    d, *_ = _offline()
    got = d.check()
    assert got["score_gap"] < 1e-4
    assert got["text_mismatch"] == 0


def test_reference_beam_finds_the_ports_hypotheses():
    d, cell, cfg, _ = _offline()
    picks = d.sample(4)
    port = [d.produced(c, i) for c, i in picks]
    prm = weights.tree_map(lambda t: t.float(), d.served)
    prec = ref.Precision("float32")
    with torch.no_grad():
        feats = [ref.features(d.wavs[i], cfg["audio"], prec, "cpu")
                 for _, i in picks]
        enc, lens, st = ref.encode(prec, prm, feats)
        out = ref.beam_search(prec, prm, enc, lens, st, cfg["beam_width"],
                              cfg["decode"]["max_len"], 1, 2, 1.5)
    for (toks, fin, score), p in zip(out, port):
        assert toks == p["tokens"] and fin == p["finished"]
        assert score == pytest.approx(p["score"], abs=1e-4)


def test_bf16_port_stays_near_the_reference():
    d, *_ = _offline("bfloat16")
    got = d.check()
    assert got["score_gap"] < 0.2 and got["text_mismatch"] == 0


def test_three_training_steps_agree():
    cell = common.load("workloads", TRAIN)
    cfg = tiny_config(common.load("configs", "las_blstm_f32"))
    mix = tiny_mix(common.load("traffic", "aishell_train_b256"))
    d = train.Driver(cell, cfg, mix, TINY_SEED, device="cpu")
    d.setup()
    got = d.check()
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["update_gap"] < 1e-3
