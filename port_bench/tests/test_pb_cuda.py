"""On the card, at a size a test run holds: the float32 cells' TF32
control and the bfloat16 cell's fp8 control come out not correct by the
cells' limits."""

import pytest

from port_bench.lib import common, offline, train
from port_bench.tests.conftest import TINY_SEED


@pytest.mark.cuda
@pytest.mark.parametrize("cell,precision", [
    ("las_blstm_f32.offline_aishell_b128", "tf32"),
    ("las_blstm_bf16.offline_aishell_b128", "fp8"),
    ("las_blstm_f32.train_aishell_b256", "tf32")])
def test_the_control_is_not_correct_on_the_card(card, cell, precision):
    c = common.load("workloads", cell)
    cfg = common.load("configs", c["config"])
    mix = common.load("traffic", c["traffic"])
    mix = dict(mix, lengths=dict(mix["lengths"], count=256))
    if mix["kind"] == "offline":
        c = dict(c, check=dict(c["check"], sample=8))
        got = offline.control(c, cfg, mix, TINY_SEED, precision, card)
    else:
        mix = dict(mix, batch_size=32)
        got = train.control(c, cfg, mix, TINY_SEED, precision, card)
    ok, checks = common.judge(got, c["check"]["limits"])
    assert not ok, checks
